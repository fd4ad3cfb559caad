"""The geo plane in the port against the JAX package.

The region latency matrix in the pool and ``proofs/edge_cache.py``
(``EdgeProofCache`` and ``GeoReadFabric``), the same inputs through both
packages (the reference's ``tests/test_geo.py``):

- the pool's region wiring (``RegionCount``): regions, cross-region
  deliveries, ``ordered_hash`` and the journeys' regions block, and the
  opt-in (no matrix at ``RegionCount`` 0);
- the edge cache's laws: replicate and serve, window smear refused, the
  LRU and window bounds, invalidation on master seals only;
- the poison kinds: every tampered reply (leaf, root, signature) fails
  the client's verification, per seed alike in both packages;
- the fabric: one pairing a signed window, the WAN fallback with no
  edge, poison caught and answered by the origin, freshness at the
  bound, clock skew, a window the origin evicted; its counters equal, and
  the port's origin also in ``mode="device"`` (K10's plain version).
"""
import dataclasses
import hashlib
import importlib
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")

TS0 = 1_700_000_000


def _side(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root, sp=mod("client.state_proof"), bus=mod("common.event_bus"),
        internal=mod("common.messages.internal_messages"),
        getConfig=mod("config").getConfig, bc=mod("crypto.bls.bls_crypto"),
        rs=mod("ingress.read_service"), causal=mod("observability.causal"),
        proofs=mod("proofs"), edge=mod("proofs.edge_cache"),
        SimPool=mod("simulation.pool").SimPool,
        net=mod("simulation.sim_network"), b58=mod("utils.base58"),
        pool_kwargs={} if root == "indy_plenum_tpu" else {"device": "cpu"})


JAX = _side("indy_plenum_tpu")
PORT = _side("indy_plenum_tpu_torch")
SIDES = (JAX, PORT)


def _both(fn, *args, **kwargs):
    want, got = (fn(side, *args, **kwargs) for side in SIDES)
    assert got == want
    return got


def _signed_window(side, backing, signers, names, window=(0, 100), ts=TS0):
    bc = side.bc
    value = bc.MultiSignatureValue(
        ledger_id=1, state_root_hash="geo-state-root",
        pool_state_root_hash="",
        txn_root_hash=side.b58.b58encode(backing.root), timestamp=ts)
    msg = value.serialize()
    agg = bc.BlsCryptoVerifier.aggregate_sigs([s.sign(msg) for s in signers])
    ms = bc.MultiSignature(signature=agg, participants=list(names),
                           value=value)
    return side.proofs.ProofWindow(
        window=tuple(window), tree_size=backing.tree_size,
        root=backing.root, state_root_b58="geo-state-root",
        multi_sig=ms, multi_sig_dict=ms.as_dict(), captured_at=0.0)


class _Corpus:
    """The reference's synthetic origin: static corpus, 4 BLS signers,
    one installed signed window, a settable virtual clock; ``mode`` and
    ``kw`` choose the origin's verify path."""

    def __init__(self, side, n=64, seed=11, keep=2, ts=TS0, mode="host",
                 **kw):
        self.side = side
        self.backing = side.rs.StaticCorpusBacking(n, seed=seed)
        kps = [side.bc.BlsKeyPair(hashlib.sha256(b"geo-%d" % i).digest())
               for i in range(4)]
        self.signers = [side.bc.BlsCryptoSigner(kp) for kp in kps]
        self.names = ["node%d" % i for i in range(4)]
        self.keys = dict(zip(self.names, (kp.pk_b58 for kp in kps)))
        self.clockval = [float(ts) + 10.0]
        self.cache = side.proofs.CheckpointProofCache(
            bls_replica=None,
            root_provider=lambda: (self.backing.tree_size,
                                   self.backing.root),
            state_root_provider=lambda: "geo-state-root", keep=keep)
        self.cache.install(_signed_window(
            side, self.backing, self.signers, self.names, ts=ts))
        self.origin = side.rs.ReadService(
            self.backing, mode=mode, proof_cache=self.cache,
            clock=lambda: self.clockval[0], **{**side.pool_kwargs, **kw})

    def replies(self, n=None):
        for i in range(n if n is not None else self.backing.tree_size):
            self.origin.submit(i)
        return self.origin.drain()

    def edge(self, region, **kw):
        kw.setdefault("keep_windows", 2)
        kw.setdefault("max_entries", 4096)
        return self.side.edge.EdgeProofCache(region=region, **kw)

    def fabric(self, edges, seed=5, max_age=300.0, n_regions=3):
        return self.side.edge.GeoReadFabric(
            self.origin, self.side.net.RegionLatencyMatrix(
                n_regions, seed=7, intra_band=(0.01, 0.05),
                wan_band=(0.08, 0.25)),
            self.keys, min_participants=3, n_regions=n_regions,
            origin_region=0, edges=edges, seed=seed,
            clock=lambda: self.clockval[0], max_age=max_age)


def _reply(r):
    return None if r is None else dataclasses.asdict(r)


# --- the region matrix and the pool's wiring ------------------------------


def test_region_matrix_matches_jax():
    def matrix(side, seed):
        m = side.net.RegionLatencyMatrix(4, seed=seed,
                                         intra_band=(0.01, 0.05),
                                         wan_band=(0.08, 0.25))
        return (m.as_dict(), m.band(1, 3), m.band(3, 1),
                m.band(2, 2) is m.intra_band, m.band(None, 1) is m.intra_band)

    a = _both(matrix, 13)
    assert a != _both(matrix, 14)
    assert all(0.08 <= lo < hi <= 0.25 for lo, hi in a[0].values())
    assert a[1] == a[2] and a[3] and a[4]


def _regions(side, region_count, seed=9, trace=False):
    over = {"Max3PCBatchSize": 2, "Max3PCBatchWait": 0.05}
    if region_count:
        over["RegionCount"] = region_count
    pool = side.SimPool(4, seed=seed, config=side.getConfig(over),
                        trace=trace, **side.pool_kwargs)
    for i in range(8):
        pool.submit_request(i, region=(i % 3) if region_count else None)
    pool.run_for(10)
    out = {"regions": pool.regions, "ordered_hash": pool.ordered_hash(),
           "network": pool.network.counters(),
           "matrix": (pool.region_matrix.as_dict()
                      if pool.region_matrix is not None else None),
           "agree": pool.honest_nodes_agree(),
           "ordered": min(len(nd.ordered_digests) for nd in pool.nodes)}
    if trace:
        out["journeys"] = side.causal.journey_summary(pool.trace.events())
        out["trace_hash"] = pool.trace.trace_hash()
    return out


@pytest.mark.parametrize("region_count", [0, 3])
def test_pool_region_wiring_matches_jax(region_count):
    got = _both(_regions, region_count, trace=True)
    assert got["agree"] and got["ordered"] >= 8
    if region_count:
        assert got["regions"] == {"node0": 0, "node1": 1, "node2": 2,
                                  "node3": 0}
        assert got["network"]["cross_region"] > 0
        assert got["journeys"]["regions"]["journeys_per_region"] == \
            {"0": 3, "1": 3, "2": 2}
    else:
        assert got["matrix"] is None and got["regions"] == {}
        assert "cross_region" not in got["network"]
        assert "regions" not in got["journeys"]


def test_pool_region_default_read_region_matches_jax():
    def reads(side):
        over = {"Max3PCBatchSize": 2, "Max3PCBatchWait": 0.05,
                "RegionCount": 3, "StateCommitBatchMode": "host"}
        pool = side.SimPool(4, seed=21, config=side.getConfig(over),
                            real_execution=True, trace=True,
                            **side.pool_kwargs)
        for i in range(6):
            pool.submit_request(i, region=i % 3)
        pool.run_for(10)
        service = pool.make_read_service("node1", mode="host")
        for i in range(3):
            service.submit(i)
        replies = service.drain()
        js = side.causal.journey_summary(pool.trace.events())
        return ([_reply(r) for r in replies], service.region,
                js["regions"], pool.ordered_hash())

    _, region, regions, _ = _both(reads)
    assert region == 1 and "read_e2e_per_region" in regions


# --- the edge cache --------------------------------------------------------


def _edge_case(side, name):
    c = _Corpus(side)
    replies = c.replies()
    if name == "serve":
        edge = c.edge(1)
        stored = (edge.replicate((0, 100), replies),
                  edge.replicate((101, 200), replies))
        served = [edge.get(i) for i in (5, 64 + 5, 10_000)]
        return (stored, [_reply(r) for r in served],
                served[0] is replies[5], edge.counters())
    if name == "store":
        edge = c.edge(0, max_entries=64)
        verdicts = [edge.store(replies[0]),
                    edge.store(dataclasses.replace(replies[1], window=None)),
                    edge.store(dataclasses.replace(replies[2],
                                                   multi_sig=None))]
        return verdicts, edge.counters()
    if name == "bounds":
        small = c.edge(0, max_entries=16)
        small.replicate((0, 100), replies)
        windows = c.edge(0)
        for k in range(4):
            windows.replicate((k * 100, k * 100 + 99), replies[:1])
        return (small.counters(), small.get(63) is not None,
                small.get(0) is None, windows.counters(),
                [(r.name, r.entries(), r.bound)
                 for r in small.sized_resources()])
    if name == "seals":
        bus = side.bus.InternalBus()
        edge = c.edge(2, bus=bus)
        edge.replicate((0, 100), replies[:8])
        edge.replicate((101, 200), replies[:0])
        trail = [edge.counters()]
        stab = side.internal.CheckpointStabilized
        bus.send(stab(inst_id=1, last_stable_3pc=(0, 10)))
        trail.append(edge.counters())
        bus.send(stab(inst_id=0, last_stable_3pc=(0, 10)))
        trail.append(edge.counters())
        return trail
    raise KeyError(name)


@pytest.mark.parametrize("name", ["serve", "store", "bounds", "seals"])
def test_edge_cache_laws_match_jax(name):
    got = _both(_edge_case, name)
    if name == "serve":
        assert got[0] == (64, 0) and got[2]
        assert got[3]["hits"] == 3 and got[3]["hit_rate"] == 1.0
    if name == "store":
        assert got[0] == [True, False, False]
    if name == "bounds":
        assert got[0]["entries"] == 16 and got[0]["entries_evicted"] == 48
        assert got[1] and got[2]
        assert got[3]["windows_held"] == 2 == got[3]["windows_evicted"]
    if name == "seals":
        assert got[1]["invalidations"] == 0 and got[2]["invalidations"] == 1
        assert got[2]["windows_held"] == 1


def test_edge_bounds_must_be_positive_in_both():
    for side in SIDES:
        for kw in ({"keep_windows": 0}, {"max_entries": -1}):
            with pytest.raises(ValueError):
                side.edge.EdgeProofCache(
                    region=0, **{"keep_windows": 2, "max_entries": 64, **kw})


def _poison(side, seed, n=48):
    c = _Corpus(side)
    replies = c.replies()
    edge = c.edge(1).poison(seed=seed)
    edge.replicate((0, 100), replies)
    kinds, verdicts = [], []
    for i in range(n):
        tampered, clean = edge.get(i), replies[i]
        if tampered.leaf != clean.leaf:
            kinds.append("leaf")
        elif tampered.root != clean.root:
            kinds.append("root")
        else:
            kinds.append("signature")
        verdicts.append((side.sp.verify_proved_read(
            tampered, c.keys, min_participants=3),
            side.sp.verify_read_binding(tampered)))
    clean_ok = side.sp.verify_proved_read(replies[0], c.keys,
                                          min_participants=3)
    tampered_total = edge.counters()["tampered"]
    edge._poison_rng = None
    return (kinds, verdicts, clean_ok, tampered_total,
            edge.get(0) is replies[0],
            [_reply(edge.poison(seed).get(i)) for i in range(4)])


@pytest.mark.parametrize("seed", [3, 4])
def test_poison_kinds_fail_verification_as_jax(seed):
    kinds, verdicts, clean_ok, tampered, pristine, _ = _both(_poison, seed)
    assert set(kinds) == {"leaf", "root", "signature"}
    assert not any(full for full, _ in verdicts)
    assert clean_ok and tampered == 48 and pristine


def test_read_binding_is_pairing_free_as_jax():
    def binding(side):
        c = _Corpus(side)
        replies = c.replies(4)
        before = side.bc.PAIRINGS.checks
        ok = side.sp.verify_read_binding(replies[0])
        spent = side.bc.PAIRINGS.checks - before
        bad = [side.sp.verify_read_binding(dataclasses.replace(
                   replies[1], leaf=b"\x00" + bytes(replies[1].leaf[1:]))),
               side.sp.verify_read_binding(dataclasses.replace(
                   replies[2], root=b"\x00" + bytes(replies[2].root[1:]))),
               side.sp.verify_read_binding(dataclasses.replace(
                   replies[3], multi_sig=None))]
        return ok, spent, bad

    assert _both(binding) == (True, 0, [False, False, False])


# --- the fabric --------------------------------------------------------------


def _fabric(side, case, mode="host", **kw):
    c = _Corpus(side, keep=1 if case == "evicted" else 2, mode=mode, **kw)
    replies = c.replies()
    before = side.bc.PAIRINGS.checks
    out = []
    if case == "amortize":
        edges = {r: c.edge(r) for r in range(3)}
        for e in edges.values():
            e.replicate((0, 100), replies)
        fabric = c.fabric(edges)
        for client in range(150):
            fabric.submit(client, client * 7)
        out.append(fabric.drain())
    elif case == "wan":
        fabric = c.fabric(edges=None)
        for client in range(90):
            fabric.submit(client, client)
        out.append(fabric.drain())
    elif case == "poison":
        poisoned = c.edge(1).poison(seed=3)
        poisoned.replicate((0, 100), replies)
        fabric = c.fabric({1: poisoned})
        for k in range(40):
            fabric.submit(3 * k + 1, k)
        out.append(fabric.drain())
    elif case == "max_age":
        reply = replies[0]
        ts = reply.multi_sig["value"]["timestamp"]
        fabric = c.fabric(edges=None, max_age=300.0)
        out.append([side.sp.verify_proved_read(
            reply, c.keys, min_participants=3, now=ts + d, max_age=300.0)
            for d in (300.0, 300.001)])
        out.append([fabric._stale(reply, ts + d) for d in (300.0, 300.001)])
    elif case == "skew":
        edge = c.edge(1)
        edge.replicate((0, 100), replies)
        fabric = c.fabric({1: edge}, max_age=300.0)
        c.clockval[0] = replies[0].multi_sig["value"]["timestamp"] - 120.0
        fabric.submit(1, 0)
        out.append(fabric.drain())
    elif case == "evicted":
        edge = c.edge(1)
        edge.replicate((0, 100), replies)
        c.cache.install(_signed_window(side, c.backing, c.signers, c.names,
                                       window=(101, 200), ts=TS0 + 200))
        out.append(c.cache.get((0, 100)) is None)
        fabric = c.fabric({1: edge}, max_age=300.0)
        fabric.submit(1, 7)
        out.append(fabric.drain())
        c.clockval[0] = TS0 + 301.0
        fabric.submit(1, 7)
        out.append(fabric.drain())
    counters = fabric.counters()
    spent = side.bc.PAIRINGS.checks - before
    return ([[_reply(r) for r in o] if isinstance(o, list)
             and o and not isinstance(o[0], bool) else o for o in out],
            counters, spent)


FABRIC_CASES = ("amortize", "wan", "poison", "max_age", "skew", "evicted")


@pytest.mark.parametrize("case", FABRIC_CASES)
def test_fabric_matches_jax(case):
    out, ctr, spent = _both(_fabric, case)
    if case == "amortize":
        assert len(out[0]) == 150 and ctr["edge_hit_rate"] == 1.0
        assert ctr["edge_serve_pairings"] == 0 and spent == 1
        assert all(b["latency_p99"] <= 0.05 for b in ctr["regions"].values())
    if case == "wan":
        assert ctr["edge_served"] == 0 and ctr["origin_served"] == 90
        assert ctr["regions"]["1"]["latency_p99"] >= 0.08
        assert ctr["regions"]["0"]["latency_p99"] <= 0.05
    if case == "poison":
        assert ctr["verify_caught"] == ctr["origin_served"] == 40
        assert len(out[0]) == 40 and ctr["verify_failures"] == 0
    if case == "max_age":
        assert out == [[True, False], [False, True]]
    if case == "skew":
        assert ctr["edge_served"] == 1 and ctr["stale_fallbacks"] == 0
    if case == "evicted":
        assert out[0] is True
        assert out[1][0]["window"] == (0, 100)
        assert out[2][0]["window"] == (101, 200)
        assert ctr["stale_fallbacks"] == 1 and ctr["origin_served"] == 1


@pytest.mark.parametrize("case", ["wan", "poison", "evicted"])
def test_fabric_device_origin_matches_host(case):
    """The port's origin in ``mode="device"``: its drains fold the proofs
    with K10's plain version and answer as the host loop does."""
    assert _fabric(PORT, case, mode="device", device="cpu") == \
        _fabric(PORT, case)


def test_smoke_phase_w_matches_bench_geo():
    """``chip_smoke.py`` phase W on the CPU (the twin its card run is held
    against; the origin in ``mode="device"``, K10's plain version) equals
    ``bench.py``'s ``bench_geo`` on the JAX package, whose origin serves
    on the host: the ordering and barrier arms' virtual times and
    fingerprints, the edge arms' fabric counters and write fingerprints;
    the smoke's laws hold."""
    import bench
    import chip_smoke as cs

    got = cs.run_geo_w("cpu")
    want = bench.bench_geo()
    cs.check_geo(got)
    for kind in ("ordering", "barrier"):
        for arm in ("off", "on"):
            mine, ref = got["phase_a"][kind][arm], want["phase_a"][kind][arm]
            for key in set(ref) & set(mine):
                # the bench rounds its virtual seconds to 3 places
                value = round(mine[key], 3) if key.endswith("_sim_s") \
                    else mine[key]
                assert value == ref[key], (kind, arm, key)
    for mine_key, ref_key in (("edges", "edge"), ("no_edges", "no_edge")):
        mine, ref = got["phase_b"][mine_key], want["phase_b"][ref_key]
        for key in ("fabric", "journey_hash", "shed_hash", "ordered_hash",
                    "reads", "global_write_e2e_p99"):
            assert mine[key] == ref[key], (mine_key, key)
