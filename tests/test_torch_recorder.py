"""The port's recorder and replayer against the JAX package's.

The reference's recorder test (``tests/test_metrics_recorder.py:72``):
node2 of ``NodePool(4, seed=82)`` is recorded while signed NYMs are sent
round-robin to the pool, the log is dumped to a file and loaded back, and
replayed into a fresh node on a fresh ``MockTimer``. Here the same run
goes through both packages (the port with ``device="cpu"``, the plain
versions of the kernels):

- node2's recorded entries are equal between the packages, entry for
  entry, and the dumped files are byte-equal;
- the port's replay equals the port's live node2, which equals the JAX
  package's replay: ordered digests, domain ledger root, committed domain
  state head;
- a Y2-shaped case: ``chip_smoke.run_replay_y("cpu", "Y2")``, the
  everything-on pool replayed into a node with a standalone CPU vote
  plane that ticks on its own timer (K7 and K8's slide counted);
- attaching a recorder twice records once.
"""
import importlib
import json

import pytest

pytest.importorskip("jax")

import chip_smoke  # noqa: E402

JAX, PORT = "indy_plenum_tpu", "indy_plenum_tpu_torch"
WRITES = 6  # the reference test's


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fingerprint(node):
    pkg = type(node).__module__.split(".")[0]
    lid = importlib.import_module(f"{pkg}.common.constants").DOMAIN_LEDGER_ID
    db = node.boot.db
    return {"ordered": list(node.ordered_digests),
            "domain_root": db.get_ledger(lid).root_hash,
            "state_head": db.get_state(lid).committed_head_hash}


def record_and_replay(pkg, tmp_path, attach_twice=False):
    """The reference test's run through ``pkg``: the recorder, the
    dumped file's bytes, node2's live fingerprint and its replay's."""
    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")

    kw = {"device": "cpu"} if pkg == PORT else {}
    recorder_mod = mod("recorder")
    pool = mod("simulation.node_pool").NodePool(4, seed=82, **kw)
    recorder = recorder_mod.Recorder()
    recorder.attach(pool.node("node2"))
    if attach_twice:
        recorder.attach(pool.node("node2"))
    for i in range(WRITES):
        pool.submit_to(f"node{i % 4}", pool.make_nym_request())
    pool.run_for(25)
    live = fingerprint(pool.node("node2"))

    path = tmp_path / f"{pkg}.rec"
    recorder.dump(str(path))
    raw = path.read_bytes()
    loaded = recorder_mod.Recorder.load(str(path))

    timer = mod("simulation.mock_timer").MockTimer(start_time=1_700_000_000.0)
    fresh = mod("server.node").Node(
        "node2", list(pool.validators), timer,
        mod("recorder.recorder").ReplayNetwork(), config=pool.config,
        domain_genesis=[dict(t) for t in pool._domain_genesis],
        seed_keys=dict(pool._seed_keys), **kw)
    fresh.start()
    recorder_mod.Replayer(loaded).replay_into(fresh, timer)
    timer.advance(30)
    return {"recorder": recorder, "loaded": loaded, "raw": raw,
            "live": live, "replay": fingerprint(fresh)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recorder")
    # the port's recorder is attached twice: it must record once
    return {JAX: record_and_replay(JAX, tmp),
            PORT: record_and_replay(PORT, tmp, attach_twice=True)}


def test_recorded_entries_equal_between_packages(runs):
    ref, port = runs[JAX], runs[PORT]
    assert ref["recorder"].entries
    assert len(port["recorder"].entries) == len(ref["recorder"].entries)
    for got, want in zip(port["recorder"].entries, ref["recorder"].entries):
        assert got == want
    assert port["loaded"].entries == ref["loaded"].entries


def test_dumped_files_byte_equal(runs):
    raw = runs[PORT]["raw"]
    assert raw == runs[JAX]["raw"]
    lines = raw.decode().splitlines()
    assert len(lines) == len(runs[PORT]["recorder"].entries)
    kinds = {json.loads(line)[1] for line in lines}
    assert kinds == {"net", "client"}


def test_replay_equals_live_and_reference(runs):
    port, ref = runs[PORT], runs[JAX]
    assert len(port["live"]["ordered"]) == WRITES
    assert port["replay"] == port["live"]
    assert port["live"] == ref["replay"] == ref["live"]


def test_attaching_twice_records_once(runs):
    """The port's recorder was attached twice, the reference's once: the
    entries are equal (above), and node2's own share of the round-robin
    writes is recorded once each."""
    client = [e for e in runs[PORT]["recorder"].entries if e[1] == "client"]
    assert len(client) == sum(1 for i in range(WRITES) if i % 4 == 2)
    assert len({json.dumps(e[3], sort_keys=True) for e in client}) \
        == len(client)


def test_replay_y2_with_standalone_plane():
    """Phase Y2's CPU rehearsal: V2a's pool (BLS, f+1 instances, pool
    genesis, the grouped plane on a tick, CHK_FREQ 5) recorded at node2
    across two stable checkpoints and replayed into a node with its own
    standalone plane; ``run_replay_y`` raises unless the replay gives the
    live node's fingerprint."""
    rec = chip_smoke.run_replay_y("cpu", "Y2")
    assert rec["ordered_count"] == chip_smoke.Y2_WRITES
    assert rec["stable_checkpoint"] >= 10
    launches = rec["launches"]
    assert launches["quorum_step"] > 0 and launches["window_slide"] > 0
    assert launches["ed25519_verify"] == rec["drains"] > 0
    assert rec["entries"] > 0 and len(rec["recording"]) == 64
