"""The state-proof plane in the port against the JAX package.

- ``SparseMerkleState.generate_state_proof`` (wire bytes and the tuple
  form) byte-equal to the JAX state's for members and non-members, at the
  committed and at a historical root; ``verify_state_proof`` verdicts
  equal, tampered and malformed proofs included.
- The seven state-proof tests of the reference (``tests/test_state_proofs
  .py``: seeded batch verify, the pairing meter, window capture with the
  client's verify and its tamper cases, mid-window serving and window GC,
  a view change mid-window, read backpressure, the proof trace marks) run
  on both packages on the same seeds, and their records are compared:
  replies field by field, ``verify_proved_read`` verdicts, ``PAIRINGS``
  deltas (each package's own counter), shed hashes and trace marks.

Both pools commit with ``StateCommitBatchMode="host"`` (the JAX pool's
device waves would compile on XLA:CPU); the port runs with
``device="cpu"``.
"""
import copy
import dataclasses
import hashlib
import importlib
import random

import pytest

pytest.importorskip("jax")

PACKAGES = ("indy_plenum_tpu", "indy_plenum_tpu_torch")


class _Pkg:
    """One package's surface for the scripts below."""

    def __init__(self, name):
        self.name = name
        self.port = name.endswith("_torch")
        mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
        self.bc = mod("crypto.bls.bls_crypto")
        self.proofs = mod("proofs")
        self.read_service = mod("ingress.read_service")
        self.client = mod("client.state_proof")
        self.config = mod("config")
        self.pool = mod("simulation.pool")
        self.timer = mod("simulation.mock_timer")
        self.metrics = mod("common.metrics_collector")
        self.constants = mod("common.constants")
        self.smt = mod("state.sparse_merkle_state")

    @property
    def kw(self):
        return {"device": "cpu"} if self.port else {}

    def pairings(self):
        return self.bc.PAIRINGS.snapshot()

    def window_pool(self, seed, trace=False, n_batches=5):
        config = self.config.getConfig({
            "CHK_FREQ": 5, "LOG_SIZE": 15, "Max3PCBatchSize": 1,
            "Max3PCBatchWait": 0.05, "StateCommitBatchMode": "host"})
        pool = self.pool.SimPool(4, seed=seed, config=config,
                                 real_execution=True, bls=True, trace=trace,
                                 **self.kw)
        for i in range(n_batches):
            pool.submit_request(i)
        pool.run_for(15)
        assert pool.honest_nodes_agree()
        return pool


def _both(script):
    """The script's record on the JAX package and on the port."""
    return [script(_Pkg(name)) for name in PACKAGES]


def _reply(r):
    return dataclasses.asdict(r)


def _keys(pool):
    return {name: pk for name, (kp, pk, pop) in pool.bls_keys.items()}


def _delta(before, after):
    return tuple(a - b for a, b in zip(after, before))


# ---------------------------------------------------------------------
# SMT proofs
# ---------------------------------------------------------------------


def _smt_script(p):
    st = p.smt.SparseMerkleState(commit_mode="host", **p.kw)
    rng = random.Random(3)
    keys = [b"key-%d" % rng.randrange(10**6) for _ in range(60)]
    st.apply_batch([(k, b"v" + k) for k in keys[:40]])
    st.commit()
    old_root = st.committed_head_hash
    st.apply_batch([(k, b"w" + k) for k in keys[20:50]])
    st.commit()
    root = st.committed_head_hash
    out = []
    for key in keys[::3] + [b"never-written", b""]:
        value = st.get(key, is_committed=True)
        wire = st.generate_state_proof(key)
        raw = st.generate_state_proof(key, serialize=False)
        hist = st.generate_state_proof(key, root=old_root)
        out.append((key, value, wire, raw, hist,
                    p.smt.verify_state_proof(root, key, value, wire),
                    p.smt.verify_state_proof(root, key, value, raw),
                    p.smt.verify_state_proof(old_root, key,
                                             st.get_for_root_hash(
                                                 old_root, key), hist),
                    p.smt.verify_state_proof(root, key, b"forged", wire),
                    p.smt.verify_state_proof(old_root, key, value, wire)))
    wire = st.generate_state_proof(keys[0])
    flipped = bytearray(wire)
    flipped[-1] ^= 1
    bitmap, packed = st.generate_state_proof(keys[0], serialize=False)
    bad = [bytes(flipped), wire[:-1], b"\x93garbage", 42, (bitmap[:-1],
           packed), (bitmap, packed[:-1]), (bitmap, [b"x"])]
    out.append([p.smt.verify_state_proof(root, keys[0],
                                         st.get(keys[0]), b)
                for b in bad])
    out.append([p.smt.verify_state_proof(r, keys[0], st.get(keys[0]), wire)
                for r in (b"short", root[:-1], "str-root", None)])
    return out


def test_state_proofs_match_jax():
    want, got = _both(_smt_script)
    assert got == want
    assert all(row[5] and row[6] and row[7] for row in got[:-2])
    assert not any(row[8] for row in got[:-2] if row[1] is not None)
    assert not any(got[-2]) and not any(got[-1])


# ---------------------------------------------------------------------
# the reference's state-proof tests, as parity
# ---------------------------------------------------------------------


def _batch_script(p):
    kps = [p.bc.BlsKeyPair(hashlib.sha256(b"sp%d" % i).digest())
           for i in range(4)]
    pks = [kp.pk_b58 for kp in kps]
    items = []
    for j in range(6):
        msg = b"window-%d" % j
        items.append((p.bc.BlsCryptoVerifier.aggregate_sigs(
            [p.bc.BlsCryptoSigner(kp).sign(msg) for kp in kps]), msg, pks))
    bad = list(items)
    bad[2] = (bad[2][0], b"forged", bad[2][2])
    bad2 = list(items)
    bad2[0] = ("not-a-sig!", bad2[0][1], bad2[0][2])
    out = []
    for batch in (items, bad, bad2, items):
        before = p.pairings()
        verdicts = p.proofs.verify_multi_sigs_batch(batch, seed=9)
        out.append((verdicts, _delta(before, p.pairings())))
    out.append(all(p.proofs.verify_multi_sigs_batch(items)))
    return out


def test_seeded_batch_verify_matches_jax():
    want, got = _both(_batch_script)
    assert got == want
    assert got[0] == ([True] * 6, (1, 2))
    assert got[1][0] == [True, True, False, True, True, True]
    assert got[2][0][0] is False and got[-1] is True


def _meter_script(p):
    kp = p.bc.BlsKeyPair(hashlib.sha256(b"meter").digest())
    sig = p.bc.BlsCryptoSigner(kp).sign(b"msg")
    out = []
    for fn, args in ((p.bc.BlsCryptoVerifier.verify_sig,
                      (sig, b"msg", kp.pk_b58)),
                     (p.bc.BlsCryptoVerifier.verify_multi_sig,
                      (sig, b"msg", [kp.pk_b58])),
                     (p.bc.BlsCryptoVerifier.verify_pop,
                      (kp.pop(), kp.pk_b58))):
        before = p.pairings()
        out.append((fn(*args), _delta(before, p.pairings())))
    return out


def test_pairing_meter_matches_jax():
    want, got = _both(_meter_script)
    assert got == want == [(True, (1, 2))] * 3


def _tampered(verify, reply, keys):
    """Every tamper case of the reference's client test, as verdicts."""
    out = []

    def check(t, *args, **kw):
        out.append(bool(verify(t, keys, *args, **kw)))

    check(reply, 3)
    check(reply, 5)
    t = copy.deepcopy(reply)
    t.root = bytes([t.root[0] ^ 1]) + t.root[1:]
    check(t, 3)
    t = copy.deepcopy(reply)
    t.multi_sig = dict(t.multi_sig)
    t.multi_sig["signature"] = t.multi_sig["signature"][:-2] + "ab"
    check(t, 3)
    parts = reply.multi_sig["participants"]
    for new in (parts + [parts[0]], parts[:2], parts[:3] + ["intruder"],
                parts[:-1] + sorted(set(keys) - set(parts))[:1]):
        t = copy.deepcopy(reply)
        t.multi_sig = dict(t.multi_sig, participants=new)
        check(t, 3)
    ts = reply.multi_sig["value"]["timestamp"]
    check(reply, 3, now=ts + 10, max_age=300)
    check(reply, 3, now=ts + 1000, max_age=300)
    for field, value in (("leaf", b"forged"), ("path", ["not-bytes"]),
                         ("root", "a-str-root"),
                         ("multi_sig", {"garbage": True})):
        t = copy.deepcopy(reply)
        setattr(t, field, value)
        check(t, 3)
    return out


def _capture_script(p):
    pool = p.window_pool(seed=31)
    node = pool.nodes[0]
    rs = pool.make_read_service("node0")
    for i in range(6):
        rs.submit(i)
    before = p.pairings()
    out = rs.drain()
    serve = _delta(before, p.pairings())
    verdicts = _tampered(p.client.verify_proved_read, out[0], _keys(pool))
    return {"windows": node.proof_cache.windows(),
            "counters": node.proof_cache.counters(),
            "replies": [_reply(r) for r in out], "serve_pairings": serve,
            "attached": rs.proofs_attached_total,
            "service": rs.counters(), "verdicts": verdicts}


def test_window_capture_and_client_verify_match_jax():
    want, got = _both(_capture_script)
    assert got == want
    assert got["windows"] == [(0, 5)] and got["serve_pairings"] == (0, 0)
    assert got["attached"] == 6
    assert all(r["verified"] and r["multi_sig"] and r["window"] == (0, 5)
               for r in got["replies"])
    assert got["verdicts"][0] is True and got["verdicts"][1] is False
    assert got["verdicts"][-6] is True
    assert sum(got["verdicts"]) == 2


def _gc_script(p):
    pool = p.window_pool(seed=33)
    node = pool.nodes[0]
    rs = pool.make_read_service("node0")
    keys = _keys(pool)
    first = rs.read_one(0)
    ledger = node.boot.db.get_ledger(p.constants.DOMAIN_LEDGER_ID)
    for i in range(5, 7):
        pool.submit_request(i)
    pool.run_for(10)
    mid = rs.read_one(3)
    record = {"first": _reply(first), "mid": _reply(mid),
              "ledger_size": ledger.size,
              "windows_mid": node.proof_cache.windows(),
              "mid_ok": p.client.verify_proved_read(mid, keys, 3)}
    for i in range(7, 16):
        pool.submit_request(i)
    pool.run_for(25)
    fresh = rs.read_one(3)
    record.update(
        windows=node.proof_cache.windows(),
        depth=node.proof_cache.depth, fresh=_reply(fresh),
        fresh_ok=p.client.verify_proved_read(fresh, keys, 3),
        old_ok=p.client.verify_proved_read(mid, keys, 3),
        ordered=pool.ordered_hash())
    return record


def test_mid_window_serving_and_window_gc_match_jax():
    want, got = _both(_gc_script)
    assert got == want
    assert got["ledger_size"] > got["first"]["tree_size"]
    assert got["mid"]["window"] == (0, 5) and got["mid_ok"]
    assert (0, 5) not in got["windows"] and (0, 15) in got["windows"]
    assert got["depth"] == 2 and got["fresh_ok"] and got["old_ok"]


def _view_change_script(p):
    pool = p.window_pool(seed=35)
    keys = _keys(pool)
    primary = pool.nodes[0].data.primaries[0]
    surviving = next(n.name for n in pool.nodes if n.name != primary)
    rs = pool.make_read_service(surviving)
    before_vc = rs.read_one(2)
    pool.network.disconnect(primary)
    pool.run_for(pool.config.ToleratePrimaryDisconnection + 10)
    node = pool.node(surviving)
    after_vc = rs.read_one(2)
    for i in range(100, 106):
        pool.submit_request(i)
    pool.run_for(25)
    fresh = rs.read_one(2)
    return {"view": node.data.view_no, "windows": node.proof_cache.windows(),
            "replies": [_reply(r) for r in (before_vc, after_vc, fresh)],
            "verdicts": [p.client.verify_proved_read(r, keys, 3)
                         for r in (before_vc, after_vc, fresh)],
            "ordered": pool.ordered_hash()}


def test_view_change_mid_window_matches_jax():
    want, got = _both(_view_change_script)
    assert got == want
    assert got["view"] >= 1 and all(got["verdicts"])
    assert any(w[1] > 5 and w[0] >= 1 for w in got["windows"])


def _backpressure_script(p):
    timer = p.timer.MockTimer()
    metrics = p.metrics.MetricsCollector()
    rs = p.read_service.ReadService(
        p.read_service.StaticCorpusBacking(64, seed=1), mode="host",
        clock=timer.get_current_time, metrics=metrics, capacity=8, seed=5,
        **p.kw)
    verdicts = [rs.submit(i) for i in range(20)]
    out = rs.drain()
    names = p.metrics.MetricsName
    depth = metrics.stat(names.READ_QUEUE_DEPTH)
    return {"verdicts": verdicts, "shed_hash": rs.shed_hash(),
            "served": [_reply(r) for r in out], "counters": rs.counters(),
            "shed_metric": metrics.stat(names.READ_SHED).total,
            "depth_last": depth.last,
            "ingress_shed": metrics.stat(names.INGRESS_SHED)}


def test_read_backpressure_matches_jax():
    want, got = _both(_backpressure_script)
    assert got == want
    assert got["counters"]["shed"] == 12 and len(got["served"]) == 8
    assert got["ingress_shed"] is None


def _trace_script(p):
    pool = p.window_pool(seed=41, trace=True)
    rs = pool.make_read_service("node0")
    for i in range(4):
        rs.submit(i)
    rs.drain()
    events = pool.trace.events()
    return {"hash": pool.trace.trace_hash(),
            "proof_marks": [ev for ev in events if ev["cat"] == "proof"]}


def test_proof_trace_marks_match_jax():
    want, got = _both(_trace_script)
    assert got == want
    names = {ev["name"] for ev in got["proof_marks"]}
    assert names == {"proof.window_signed", "proof.cache_hit"}
    assert {tuple(ev["key"]) for ev in got["proof_marks"]
            if ev["name"] == "proof.window_signed"} == {(0, 5)}


def test_smoke_phase_p_reads_match_jax():
    """``chip_smoke.py`` phase P's 4,096 proof-attached reads, with the
    port on the CPU (K10's plain version): every reply equal to the JAX
    service's over the same window, no pairing on either serve path, and
    the client's checks pass."""
    import chip_smoke as cs

    jax_pkg = _Pkg("indy_plenum_tpu")
    signers = [jax_pkg.bc.BlsCryptoSigner(jax_pkg.bc.BlsKeyPair(
        hashlib.sha256(b"bench-proof-%d" % i).digest())) for i in range(4)]
    got = cs.proof_reads_p("cpu", signers)
    backing = jax_pkg.read_service.StaticCorpusBacking(cs.P_READS, seed=11)
    value = jax_pkg.bc.MultiSignatureValue(
        ledger_id=1, state_root_hash="bench-state-root",
        pool_state_root_hash="",
        txn_root_hash=got["replies"][0].multi_sig["value"]["txn_root_hash"],
        timestamp=1_700_000_000)
    ms = jax_pkg.bc.MultiSignature.from_dict(got["replies"][0].multi_sig)
    assert ms.value == value and ms.value.serialize() == value.serialize()
    cache = jax_pkg.proofs.CheckpointProofCache(
        None, lambda: (backing.tree_size, backing.root),
        lambda: "bench-state-root")
    cache.install(jax_pkg.proofs.ProofWindow(
        window=(0, 100), tree_size=backing.tree_size, root=backing.root,
        state_root_b58="bench-state-root", multi_sig=ms,
        multi_sig_dict=ms.as_dict(), captured_at=0.0))
    service = jax_pkg.read_service.ReadService(backing, mode="host",
                                               proof_cache=cache)
    for i in range(cs.P_READS):
        service.submit(i)
    before = jax_pkg.pairings()
    want = service.drain()
    assert jax_pkg.pairings() == before and got["serve_pairings"] == 0
    assert [_reply(r) for r in got["replies"]] == [_reply(r) for r in want]
    keys = {f"node{i}": s.pk for i, s in enumerate(signers)}
    client = cs.check_proof_reads(got, got, keys)
    assert client["client_verified"] == cs.P_SAMPLE
