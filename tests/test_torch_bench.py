"""The port's bench (``indy_plenum_tpu_torch/tools/bench.py``) against the
reference's root ``bench.py``, on the CPU.

- ``_bench_ordered`` on both packages at n=4, ``batches=1``: one
  instance, f+1 instances with host accounting, a depth-4 resident ring,
  and a (4,) member mesh (the reference's ``Mesh`` of 4 host devices
  against ``make_fabric_mesh(["cpu"] * 4, (4,))``): equal on every field
  that no wall clock builds.
- the CLI: ``python -m indy_plenum_tpu_torch.tools.bench geo --device
  cpu`` in a process of its own prints the compact line last; a cell that
  raises is named in ``errors`` and ``main`` returns 1; without a card and
  without ``--device cpu`` ``main`` raises before any cell runs.

The fixed-size cells are in ``tests/test_torch_bench_cells.py``. The
reference's ``bench.py`` is loaded from its path as a module, in this
process (``tests/conftest.py`` has given JAX its 8 host devices).
"""
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from indy_plenum_tpu_torch.tools import bench  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the ordered cells' fields that no wall clock builds (chip_smoke.J_ORDERED)
ORDERED_FIELDS = ("metric", "n_validators", "num_instances", "txns_ordered",
                  "ordered_hash", "device_flushes",
                  "device_dispatches_per_ordered_batch", "readbacks",
                  "readback_bytes_total", "resident_depth", "resident_ticks",
                  "readbacks_deferred", "backups_ordered_upto", "shards",
                  "mesh_shape", "eval_mode", "flush_occupancy",
                  "phase_latency", "critical_path", "shard_occupancy")


def load_reference_bench():
    """The root ``bench.py`` as a module."""
    name = "_ref_bench"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def ordered_fields(rec):
    out = {k: rec.get(k) for k in ORDERED_FIELDS}
    e2e = dict(rec["e2e_latency"])
    out["e2e_latency"] = e2e
    gov = rec.get("governor")
    out["governor"] = gov
    return out


def _reference_mesh(tiles):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:tiles]), ("members",))


def _port_mesh(tiles):
    from indy_plenum_tpu_torch.tpu.quorum import make_fabric_mesh

    return make_fabric_mesh(["cpu"] * tiles, (tiles,))


ORDERED_CASES = {
    "one_instance": dict(n=4, k=1),
    "f_plus_1_host_accounting": dict(n=4, k=2, host_accounting=True),
    "resident_depth_4": dict(n=4, k=1, resident_depth=4),
    "mesh_4": dict(n=4, k=1, mesh=4),
}


@pytest.mark.parametrize("case", sorted(ORDERED_CASES))
def test_bench_ordered_matches_reference(case):
    spec = dict(ORDERED_CASES[case])
    n, k, tiles = spec.pop("n"), spec.pop("k"), spec.pop("mesh", None)
    ref = load_reference_bench()
    want = ref._bench_ordered(
        n, k, batches=1, metric="m", note="compare",
        mesh=_reference_mesh(tiles) if tiles else None, **spec)
    got = bench._bench_ordered(
        n, k, batches=1, metric="m", note="compare",
        mesh=_port_mesh(tiles) if tiles else None, device="cpu", **spec)
    assert got.keys() == want.keys()
    assert ordered_fields(got) == ordered_fields(want)
    assert got["txns_ordered"] == 320
    if k > 1:
        assert got["backups_ordered_upto"] == want["backups_ordered_upto"]
        assert "accounting_note" in got


def test_cli_prints_the_compact_line_last(tmp_path):
    """The CLI on a cheap cell, in a process of its own, on the CPU."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "indy_plenum_tpu_torch.tools.bench", "geo",
         "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["metric"] == "geo_edge_read_p99_speedup"
    for key in ("value", "unit", "vs_baseline"):
        assert key in last
    assert "errors" not in last
    # one cell is the headline itself: the extras digest appears with two
    full = json.loads(proc.stderr.strip().splitlines()[-1])
    assert full["metric"] == last["metric"]
    assert full["phase_b"]["edge"]["ordered_hash"] \
        == full["phase_b"]["no_edge"]["ordered_hash"]


def test_cli_extras_digest_over_two_cells(monkeypatch, capsys):
    """Two cells through ``main``: the headline is the first, the second
    rides in ``extras`` as [value, vs_baseline, occupancy, the readback
    contract, the residency triple], as the reference's digest builds
    it."""
    def cell_a(device):
        return {"metric": "a", "value": 1.0, "unit": "u",
                "vs_baseline": 0.5}

    def cell_b(device):
        return {"metric": "b", "value": 2.0, "unit": "u", "vs_baseline": 1.5,
                "flush_occupancy": 0.25, "eval_mode": "device",
                "readback_bytes_per_readback": 8.0,
                "readback_overlap_fraction": 1.0, "resident_depth": 4,
                "resident_ticks": 3, "readbacks_deferred": 2}

    monkeypatch.setattr(bench, "BENCHES", {"ordered": cell_a,
                                           "geo": cell_b})
    assert bench.main(["all", "--device", "cpu"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metric"] == "a"
    assert last["extras"] == {"b": [2.0, 1.5, 0.25, ["device", 8.0, 1.0],
                                    [4, 3, 2]]}


def test_a_cell_that_raises_makes_main_exit_1(monkeypatch, capsys):
    def broken(device):
        raise AssertionError("planted failure")

    monkeypatch.setitem(bench.BENCHES, "geo", broken)
    assert bench.main(["geo", "--device", "cpu"]) == 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["errors"] == ["geo"]
    assert last["metric"] == "bench_failed"
    with open(os.path.join(os.path.dirname(bench.__file__),
                           "BENCH_FULL.json")) as fh:
        full = json.load(fh)
    assert full["errors"] == {"geo": "AssertionError: planted failure"}


def test_without_a_card_main_raises_before_any_cell(monkeypatch):
    import torch

    from indy_plenum_tpu_torch.utils.torch_env import NoCudaDevice

    ran = []
    monkeypatch.setitem(bench.BENCHES, "geo", lambda device: ran.append(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        bench.main(["geo"])
    assert not ran


def test_cell_names_and_sizes_match_the_reference():
    ref = load_reference_bench()
    src = open(os.path.join(ROOT, "bench.py")).read()
    start = src.index("benches = {")
    cells = re.findall(r'"(\w+)": (\w+),', src[start:src.index("}", start)])
    assert len(cells) == 18
    assert [(name, fn.__name__) for name, fn in bench.BENCHES.items()] \
        == cells
    for _name, fn_name in cells:
        assert callable(getattr(ref, fn_name))
    assert bench.BASELINE_CPU_VERIFIES_PER_SEC \
        == ref.BASELINE_CPU_VERIFIES_PER_SEC
    assert bench.ESTIMATED_REFERENCE_ORDERED_TXNS_PER_SEC_N64 \
        == ref.ESTIMATED_REFERENCE_ORDERED_TXNS_PER_SEC_N64


def test_spread_matches_the_reference():
    ref = load_reference_bench()
    for times in ([0.3, 0.1, 0.2], [0.4, 0.1, 0.3, 0.2], [0.01] * 5):
        assert bench._spread(times) == ref._spread(times)


def test_mesh_tiles_on_the_cpu():
    import torch

    tiles = bench._mesh_tiles(torch.device("cpu"))
    assert tiles == [torch.device("cpu")] * bench.MESH_TILES
    mesh = _port_mesh(4)
    assert not mesh.split
