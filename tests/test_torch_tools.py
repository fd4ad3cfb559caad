"""The port's operator tools against the reference's scripts, on the CPU.

- ``tools.trace_tool``: every view of ``scripts/trace_tool.py`` on the
  same dumps (a telemetry pool with regions, a laned pool, the two merged)
  prints the same bytes, and ``--chrome`` writes the same file.
- ``tools.chaos_run``: ``--list`` prints the same text; a traced run on the
  tick plane writes, under the same default file name, the reference's
  report but for ``replay_command``'s program name and the wall-clock
  ``device.flush_time`` series; the port's ``replay_command``, run with
  ``--device cpu``, writes that report again.
- ``tools.ingress_run``: the same seeded record but for ``wall_s`` and
  ``read_qps``; its ``--trace-out`` dump goes through the trace tool.
- ``tools.profile_rbft``: the same record but for the walls, the rates
  and the hotspots (cProfile's, which name each package's own functions).
- ``tools.graft_entry``: ``fn(*args)`` equals the reference's jitted
  ``entry()``, and ``dryrun_multichip(4)`` on four CPU tiles gives the
  reference's step on the dry run's operands.

Each reference script is loaded from its path, as a module, in this
process (``tests/conftest.py`` has given JAX its 8 host devices).
"""
import functools
import importlib.util
import json
import os
import shlex
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from indy_plenum_tpu_torch.tools import chaos_run  # noqa: E402
from indy_plenum_tpu_torch.tools import graft_entry  # noqa: E402
from indy_plenum_tpu_torch.tools import ingress_run  # noqa: E402
from indy_plenum_tpu_torch.tools import profile_rbft  # noqa: E402
from indy_plenum_tpu_torch.tools import trace_tool  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PROGRAM = "python scripts/chaos_run.py "
PORT_PROGRAM = "python -m indy_plenum_tpu_torch.tools.chaos_run "
# host wall-clock series of a chaos report
WALL_METRICS = ("device.flush_time", "auth.batch_time")


def load_script(path):
    """A reference script as a module (its ``main`` reads ``sys.argv``)."""
    name = "_ref_" + os.path.basename(path)[:-3]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def run_ref(script, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [script] + list(argv))
    rc = load_script(script).main()
    return rc, capsys.readouterr().out


def run_port(tool, argv, capsys):
    rc = tool.main(list(argv))
    return rc, capsys.readouterr().out


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- trace_tool -------------------------------------------------------------

@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Two port dumps: a telemetry pool whose clients sit in two regions,
    and a laned pool of two lanes."""
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.lanes import LanedPool
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    out = tmp_path_factory.mktemp("dumps")
    pool = SimPool(4, seed=5, config=getConfig({
        "Max3PCBatchSize": 4, "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.1, "TelemetryWindowSec": 2.0,
        "RegionCount": 2}), device_quorum=True, trace=True, device="cpu")
    for i in range(16):
        pool.submit_request(i, region=i % 2)
    pool.run_for(10)
    pool.telemetry.finalize(pool.timer.get_current_time())
    a = str(out / "pool.jsonl")
    pool.trace.dump(a)
    laned = LanedPool(lanes=2, n_nodes=4, seed=6, config=getConfig({
        "Max3PCBatchSize": 4, "Max3PCBatchWait": 0.05, "CHK_FREQ": 2,
        "LOG_SIZE": 6, "QuorumTickInterval": 0.05}), device_quorum=True,
        trace=True, device="cpu")
    for i in range(12):
        laned.submit_request(i)
    laned.run_for(10)
    laned.seal_flush()
    b = str(out / "laned.jsonl")
    laned.trace.dump(b)
    return {"pool": a, "laned": b, "dir": out}


def _first_digest(path):
    from indy_plenum_tpu_torch.observability.trace import load_jsonl

    for ev in load_jsonl(path):
        if ev["name"] == "req.ingress" and ev.get("key"):
            return ev["key"][0][:10]
    raise AssertionError("no request in the dump")


TRACE_VIEWS = {
    "report": ("pool", []),
    "phases": ("pool", ["--phases"]),
    "critical_path": ("pool", ["--critical-path"]),
    "overlap": ("pool", ["--overlap"]),
    "rollups": ("pool", ["--rollups"]),
    "journeys": ("pool", ["--journeys"]),
    "journeys_region": ("pool", ["--journeys", "--region", "1"]),
    "node": ("pool", ["--phases", "--critical-path", "--node", "node1"]),
    "json": ("pool", ["--json"]),
    "journey": ("pool", ["--journey", "DIGEST"]),
    "journey_json": ("pool", ["--journey", "DIGEST", "--json"]),
    "journey_missing": ("pool", ["--journey", "ffffffffffff"]),
    "laned_journeys_lane": ("laned", ["--journeys", "--lane", "1"]),
    "laned_report": ("laned", []),
    "merged_journeys": ("both", ["--journeys", "--json"]),
}


@pytest.mark.parametrize("view", sorted(TRACE_VIEWS))
def test_trace_tool_view_matches_reference(view, dumps, monkeypatch,
                                           capsys):
    which, flags = TRACE_VIEWS[view]
    paths = ([dumps["pool"], dumps["laned"]] if which == "both"
             else [dumps[which]])
    flags = [_first_digest(dumps["pool"]) if f == "DIGEST" else f
             for f in flags]
    want = run_ref("scripts/trace_tool.py", paths + flags, monkeypatch,
                   capsys)
    got = run_port(trace_tool, paths + flags, capsys)
    assert got == want
    assert got[1] or view == "journey_missing"


def test_trace_tool_chrome_matches_reference(dumps, monkeypatch, capsys):
    ref_out = str(dumps["dir"] / "ref_chrome.json")
    port_out = str(dumps["dir"] / "port_chrome.json")
    want = run_ref("scripts/trace_tool.py",
                   [dumps["pool"], "--phases", "--chrome", ref_out],
                   monkeypatch, capsys)
    got = run_port(trace_tool, [dumps["pool"], "--phases", "--chrome",
                                port_out], capsys)
    assert got[0] == want[0] == 0
    assert got[1] == want[1].replace(ref_out, port_out)
    with open(ref_out) as fa, open(port_out) as fb:
        chrome = json.load(fb)
        assert fa.read() == json.dumps(chrome, separators=(",", ":"))
    assert chrome["traceEvents"]


# --- chaos_run --------------------------------------------------------------

CHAOS_FLAGS = ["--seed", "7", "--scenario", "f_crash_partition",
               "--device-quorum", "--tick", "0.05", "--adaptive-tick",
               "--trace"]
CHAOS_REPORT = "chaos_f_crash_partition_7.json"


def _chaos_record(path):
    with open(path) as fh:
        rec = json.load(fh)
    for key in WALL_METRICS:
        rec["metrics"].pop(key, None)
    return rec


def test_chaos_list_matches_reference(monkeypatch, capsys):
    want = run_ref("scripts/chaos_run.py", ["--list"], monkeypatch, capsys)
    got = run_port(chaos_run, ["--list"], capsys)
    assert got == want and want[0] == 0
    assert len(got[1].splitlines()) == 17


def test_chaos_report_and_its_replay(tmp_path, monkeypatch, capsys):
    for side in ("ref", "port", "replay"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    want_rc, want_out = run_ref("scripts/chaos_run.py", CHAOS_FLAGS,
                                monkeypatch, capsys)
    monkeypatch.chdir(tmp_path / "port")
    got_rc, got_out = run_port(chaos_run, CHAOS_FLAGS + ["--device", "cpu"],
                               capsys)
    assert got_rc == want_rc == 0
    assert got_out == want_out.replace(REF_PROGRAM, PORT_PROGRAM)
    want = _chaos_record(tmp_path / "ref" / CHAOS_REPORT)
    got = _chaos_record(tmp_path / "port" / CHAOS_REPORT)
    command = got.pop("replay_command")
    assert command.startswith(PORT_PROGRAM)
    assert command[len(PORT_PROGRAM):] == \
        want.pop("replay_command")[len(REF_PROGRAM):]
    assert got == want
    traces = [(tmp_path / side / (CHAOS_REPORT + ".trace.jsonl")).read_text()
              for side in ("ref", "port")]
    assert traces[0] and traces[0] == traces[1]
    # the port's replay command, on the CPU, writes its report again
    monkeypatch.chdir(tmp_path / "replay")
    argv = shlex.split(command)[3:]
    assert run_port(chaos_run, argv + ["--device", "cpu"], capsys)[0] == 0
    again = _chaos_record(tmp_path / "replay" / CHAOS_REPORT)
    assert again.pop("replay_command") == command
    assert again == got


# --- ingress_run ------------------------------------------------------------

INGRESS_FLAGS = ["--nodes", "4", "--rate", "60", "--duration", "0.5",
                 "--settle", "2", "--capacity", "3", "--read-fraction",
                 "0.5", "--keys", "256", "--seed", "7", "--json"]


def _ingress_record(out):
    rec = json.loads(out.strip().splitlines()[-1])
    rec.pop("wall_s")
    rec["reads"].pop("read_qps", None)
    return rec


def test_ingress_run_matches_reference(tmp_path, monkeypatch, capsys):
    dump = str(tmp_path / "ingress.jsonl")
    _, want = run_ref("scripts/ingress_run.py", INGRESS_FLAGS, monkeypatch,
                      capsys)
    rc, got = run_port(ingress_run, INGRESS_FLAGS + ["--device", "cpu",
                                                     "--trace-out", dump],
                       capsys)
    want, got = _ingress_record(want), _ingress_record(got)
    assert rc == 0 and got.pop("trace_file") == dump
    assert got == want
    assert want["admission"]["shed"] > 0
    assert want["ordered"] > 0 and want["reads"]["verified"] > 0
    # the dump goes through the trace tool
    rc, text = run_port(trace_tool, [dump, "--journeys"], capsys)
    assert rc == 0 and "journeys:" in text


# --- profile_rbft -----------------------------------------------------------

PROFILE_CASES = {
    "baseline": ["4", "1", "20", "--json"],
    "mesh_resident": ["4", "1", "20", "--json", "--no-baseline", "--mesh",
                      "4", "--resident-depth", "4"],
    "fabric_traced": ["4", "2", "20", "--json", "--no-baseline", "--mesh",
                      "2x2", "--trace", "--trace-out", "TRACE"],
}
# the walls, the rates built from them, and cProfile's hotspots
PROFILE_WALL = ("wall_s", "txns_per_sec", "hotspots_top20_cumulative",
                "trace_file")


def _profile_record(out):
    rec = json.loads(out.strip().splitlines()[-1])
    for key in PROFILE_WALL:
        rec.pop(key, None)
    return rec


@pytest.mark.parametrize("case", sorted(PROFILE_CASES))
def test_profile_rbft_matches_reference(case, tmp_path, monkeypatch,
                                        capsys):
    argv = [str(tmp_path / "trace.jsonl") if a == "TRACE" else a
            for a in PROFILE_CASES[case]]
    _, want = run_ref("scripts/profile_rbft.py", argv, monkeypatch, capsys)
    _, got = run_port(profile_rbft, argv + ["--device", "cpu"], capsys)
    hot = json.loads(got.strip().splitlines()[-1])[
        "hotspots_top20_cumulative"]
    assert len(hot) == 20
    assert any("indy_plenum_tpu_torch" in h["func"] or "pool.py" in h["func"]
               for h in hot)
    assert _profile_record(got) == _profile_record(want)


# --- graft_entry ------------------------------------------------------------

def _assert_step_equal(jstate, jev, jok, record):
    """The reference's single-plane results against the port's (1, ...)
    member."""
    for name, a in zip(jstate._fields, jstate):
        assert np.array_equal(np.asarray(a), record["state"][name][0]), name
    for name, a in zip(jev._fields, jev):
        assert np.array_equal(np.asarray(a), record["events"][name][0]), \
            name
    assert np.array_equal(np.asarray(jok), record["ok"])


def test_graft_entry_matches_reference():
    import __graft_entry__ as graft

    fn, args = graft.entry()
    want = jax.jit(fn)(*args)
    pfn, pargs = graft_entry.entry("cpu")
    state, events, ok = pfn(*pargs)
    _assert_step_equal(*want, graft_entry._step_record(state, events, ok))
    assert bool(ok.all())


def test_graft_dryrun_on_four_tiles_matches_reference(capsys):
    from indy_plenum_tpu.tpu import quorum as jq
    from indy_plenum_tpu.tpu.step import fused_step as jax_fused_step

    record = graft_entry.dryrun_multichip(4, "cpu")
    text = capsys.readouterr().out
    for check in ("OK: tiles=4", "consensus OK", "fabric OK", "resident OK"):
        assert check in text
    n_validators, (state, words, pk, rb, s, h) = \
        graft_entry.dryrun_inputs(4, "cpu")
    # the same operands through the reference's step
    entries = [(jq.PREPARE, i % n_validators, i % 16) for i in range(4)]
    entries[0] = (jq.PREPREPARE, 0, 0)
    want = jax.jit(functools.partial(jax_fused_step,
                                     n_validators=n_validators))(
        jq.init_state(n_validators, 16, 2), jq.pack_messages(entries, 4),
        *(a.numpy() for a in (pk, rb, s, h)))
    _assert_step_equal(*want, record["step"])
    assert record["resident"]["ordered_hash"] == \
        record["member_mesh"]["ordered_hash"]
