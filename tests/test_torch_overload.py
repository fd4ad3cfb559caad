"""The overload plane in the port against the JAX package.

``ingress/workload.py`` and ``ingress/retry.py`` and the pool's closed
loop, the same inputs through both packages (the reference's
``tests/test_overload.py``, less its monitor-snapshot tests: the monitor
is not part of the port):

- the profiles: the arrival stream of every profile kind, the profile
  checks and the config knobs;
- the retry law (``RetryPolicy`` over the port's catchup ``RetryLaw``),
  ``RetryDriver``'s closed loop and budget, ``retry_hash``;
- admission with re-offers: the fairness cap and the same-instant cohort;
- the governor's hold under retry pressure;
- the seeder's token bucket;
- a closed-loop pool (a same-instant burst far past capacity, signed, the
  port with ``device="cpu"``): ``shed_hash``, ``retry_hash``,
  ``ordered_hash``, ``trace_hash`` and the causal journeys' retry hop.
"""
import importlib
import random
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")


def _side(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    ingress = mod("ingress")
    return SimpleNamespace(
        root=root, ingress=ingress, getConfig=mod("config").getConfig,
        MockTimer=mod("simulation.mock_timer").MockTimer,
        metrics=mod("common.metrics_collector"),
        governor=mod("tpu.governor"),
        seeder=mod("server.catchup.seeder_service"),
        msgs=mod("common.messages.node_messages"),
        SimPool=mod("simulation.pool").SimPool,
        causal=mod("observability.causal"),
        pool_kwargs={} if root == "indy_plenum_tpu" else {"device": "cpu"})


JAX = _side("indy_plenum_tpu")
PORT = _side("indy_plenum_tpu_torch")
SIDES = (JAX, PORT)


class _Req:
    def __init__(self, digest: str):
        self.digest = digest


def _both(fn, *args, **kwargs):
    want, got = (fn(side, *args, **kwargs) for side in SIDES)
    assert got == want
    return got


# --- workload profiles -----------------------------------------------------


def _arrivals(side, spec_kw, profile_kw=None):
    timer = side.MockTimer()
    log = []
    spec = side.ingress.WorkloadSpec(
        **spec_kw, profile=(side.ingress.WorkloadProfile(**profile_kw)
                            if profile_kw is not None else None))
    gen = side.ingress.WorkloadGenerator(spec)
    gen.start(timer,
              on_write=lambda c, k: log.append(
                  ("w", c, k, round(timer.get_current_time(), 9))),
              on_read=lambda c, k: log.append(
                  ("r", c, k, round(timer.get_current_time(), 9))))
    timer.advance(spec.duration + 1.0)
    return log, gen.counters()


PROFILES = {
    "none": (dict(n_clients=10_000, rate=60.0, duration=6.0, seed=5),
             None),
    "steady": (dict(n_clients=10_000, rate=60.0, duration=6.0, seed=5),
               dict(kind="steady")),
    "flash": (dict(n_clients=10_000, rate=50.0, duration=10.0, seed=7,
                   read_fraction=0.25, n_keys=4096),
              dict(kind="flash", peak=8.0, flash_at=4.0,
                   flash_duration=2.0)),
    "diurnal": (dict(n_clients=10_000, rate=60.0, duration=20.0, seed=9),
                dict(kind="diurnal", period=20.0, trough=0.2, peak=3.0)),
    "bench_flash": (dict(n_clients=250_000, rate=100.0, duration=9.0,
                         read_fraction=0.25, n_keys=4096, seed=37),
                    dict(kind="flash", peak=8.0, flash_at=3.0,
                         flash_duration=1.5)),
}


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_profile_arrivals_match_jax(name):
    spec_kw, profile_kw = PROFILES[name]
    log, counters = _both(_arrivals, spec_kw, profile_kw)
    assert counters["arrivals"] == len(log) > 0
    if name == "flash":  # the spike dwarfs the baseline, as the reference
        times = [t for *_, t in log]
        spike = sum(1 for t in times if 4.0 <= t < 6.0)
        before = sum(1 for t in times if t < 4.0)
        assert spike / 2.0 > 3.0 * (before / 4.0)
    if name == "steady":
        assert log == _arrivals(PORT, *PROFILES["none"])[0]


def test_profile_checks_and_knobs_match_jax():
    for kw in (dict(kind="tsunami"), dict(kind="diurnal", period=0.0),
               dict(kind="flash", peak=-1.0),
               dict(kind="flash", flash_duration=0.0)):
        for side in SIDES:
            with pytest.raises(ValueError):
                side.ingress.WorkloadProfile(**kw)

    def knobs(side):
        config = side.getConfig({"WorkloadProfilePeak": 5.5,
                                 "WorkloadProfileFlashAt": 1.0,
                                 "WorkloadProfileFlashDuration": 0.5})
        out = []
        for kind in ("steady", "diurnal", "flash"):
            p = side.ingress.WorkloadProfile.from_config(kind, config)
            out.append([p.multiplier(t / 4.0) for t in range(0, 120)])
        return out

    got = _both(knobs)
    assert got[2][3] == pytest.approx(1.0) and got[2][4] == 5.5
    assert got[2][6] == pytest.approx(1.0)


# --- retry law and driver ---------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(base=0.5, mult=2.0, max_delay=3.0, jitter_frac=0.5, seed=3,
         max_attempts=3),
    dict(base=0.2, seed=7, max_attempts=1),
    dict(base=1.25, mult=3.0, max_delay=60.0, jitter_frac=1.0, seed=2**40,
         max_attempts=10)])
def test_retry_policy_matches_jax(kw):
    def law(side):
        p = side.ingress.RetryPolicy(**kw)
        return ([p.delay(key, a) for key in ("req-x", "req-y", "d0")
                 for a in range(0, 12)],
                [p.exhausted(a) for a in range(0, 12)])

    delays, _ = _both(law)
    assert delays[1] <= delays[2]
    for side in SIDES:
        with pytest.raises(ValueError):
            side.ingress.RetryPolicy(base=0.5, max_attempts=0)
        with pytest.raises(ValueError):
            side.ingress.RetryPolicy(base=0.0)


def test_retry_policy_from_config_matches_jax():
    def law(side):
        config = side.getConfig({"IngressRetryMax": 4,
                                 "IngressRetryBase": 0.2,
                                 "IngressRetryBackoffMult": 2.0,
                                 "IngressRetryBackoffMax": 2.0})
        p = side.ingress.RetryPolicy.from_config(config, seed=37)
        return [p.delay("k%d" % i, a) for i in range(4) for a in range(6)]

    _both(law)


def _driver_budget(side):
    timer = side.MockTimer()
    metrics = side.metrics.MetricsCollector()
    offered = []
    policy = side.ingress.RetryPolicy(base=0.2, mult=2.0, max_delay=1.0,
                                      jitter_frac=0.0, seed=1,
                                      max_attempts=2)
    driver = side.ingress.RetryDriver(
        policy, timer, lambda req, cid: offered.append(
            (req.digest, cid, round(timer.get_current_time(), 9))),
        metrics=metrics)
    req = _Req("d0")
    trail = []
    for advance in (0.25, 0.5, 5.0):
        driver.on_shed(req, "c1", "queue_full")
        trail.append(driver.outstanding)
        timer.advance(advance)
        trail.append((len(offered), driver.outstanding))
    names = side.metrics.MetricsName
    return (offered, trail, driver.exhausted_total, driver.counters(),
            metrics.stat(names.INGRESS_RETRIES).total,
            metrics.stat(names.INGRESS_RETRY_EXHAUSTED).total,
            driver.retry_hash(), sorted(driver.retried_digests))


def test_retry_driver_closed_loop_and_budget_match_jax():
    offered, _, exhausted, counters, retries, spent, *_ = \
        _both(_driver_budget)
    assert [o[:2] for o in offered] == [("d0", "c1")] * 2
    assert (exhausted, retries, spent) == (1, 2, 1)
    assert counters["exhausted"] == 1


def _storm_hash(side, seed, digests):
    timer = side.MockTimer()
    driver = side.ingress.RetryDriver(
        side.ingress.RetryPolicy(base=0.2, seed=seed, max_attempts=3),
        timer, lambda req, cid: None)
    for d in digests:
        driver.on_shed(_Req(d), None, "queue_full")
    timer.advance(10.0)
    return driver.retry_hash()


def test_retry_hash_is_canonical_and_matches_jax():
    digests = [f"d{i}" for i in range(12)]
    first = _both(_storm_hash, 7, digests)
    assert first == _both(_storm_hash, 7, list(reversed(digests)))
    assert first != _both(_storm_hash, 7, digests[:-1])


def test_retry_sized_resources_match_jax():
    def sizes(side):
        timer = side.MockTimer()
        driver = side.ingress.RetryDriver(
            side.ingress.RetryPolicy(base=0.5, seed=1, max_attempts=3),
            timer, lambda req, cid: None)
        for i in range(5):
            driver.on_shed(_Req(f"d{i}"), None, "queue_full")
        return [(r.name, r.entries(), r.bound, r.entry_bytes, r.ring)
                for r in driver.sized_resources()]

    assert _both(sizes)


# --- admission with re-offers ----------------------------------------------


def _fairness(side):
    clock = [0.0]
    ac = side.ingress.AdmissionController(capacity=10, per_client_cap=2,
                                          seed=0, clock=lambda: clock[0])
    for i in range(4):
        ac.offer(_Req(f"hot-{i}"), client_id="hot")
    _, shed0 = ac.drain()
    clock[0] = 1.0
    for i in range(2):
        ac.offer(_Req(f"hot-new-{i}"), client_id="hot")
    verdicts = [ac.offer(req, client_id=cid) for req, cid, _ in shed0]
    batch, shed = ac.drain()
    return ([(r.digest, c, w) for r, c, w in shed0], verdicts,
            [r.digest for r in batch], [(r.digest, c, w) for r, c, w in shed],
            ac.shed_total, ac.shed_hash())


def test_reoffers_count_against_the_fairness_cap_as_jax():
    shed0, verdicts, _, shed, total, _ = _both(_fairness)
    assert [c for _, c, _ in shed0] == ["hot", "hot"]
    assert verdicts == [False, False] and total == 4
    assert {w for *_, w in shed} == {"client_cap"}


def _cohort(side, order_seed):
    fresh = [f"fresh-{i}" for i in range(8)]
    retried = [f"retry-{i}" for i in range(8)]
    ac = side.ingress.AdmissionController(capacity=5, seed=3)
    offers = [(d, None) for d in fresh] + [(d, "rc") for d in retried]
    random.Random(order_seed).shuffle(offers)
    for d, cid in offers:
        ac.offer(_Req(d), client_id=cid)
    batch, _ = ac.drain()
    return sorted(r.digest for r in batch), sorted(ac.shed_digests)


def test_same_instant_cohort_with_retries_matches_jax():
    kept_a, shed_a = _both(_cohort, 1)
    assert (kept_a, shed_a) == _both(_cohort, 2)
    assert not set(kept_a) & set(shed_a)


def test_backpressure_queue_frac_matches_jax():
    def fracs(side):
        sig = side.ingress.BackpressureSignal
        return (sig(queue_depth=5, capacity=0).queue_frac,
                sig().queue_frac,
                sig(queue_depth=8, capacity=16).queue_frac)

    assert _both(fracs) == (0.0, 0.0, 0.5)


# --- the governor's hold ---------------------------------------------------


def _governor(side, **kw):
    defaults = dict(interval=0.05, min_interval=0.0125, max_interval=0.2,
                    alpha=0.3, occupancy_low=0.02, occupancy_high=0.85,
                    widen=1.5, narrow=0.5)
    defaults.update(kw)
    return side.governor.DispatchGovernor(**defaults)


def _hold(side):
    sig = side.ingress.BackpressureSignal
    g = _governor(side)
    trail = []
    for _ in range(4):
        g.feed_backpressure(sig(queue_depth=60, capacity=64, shed_delta=9))
        g.observe(votes=8, capacity=16, dispatches=1)
        trail.append((g.interval, g.ewma))
    for _ in range(14):
        g.feed_backpressure(sig(retry_pressure=12))
        g.observe(votes=0, capacity=16, dispatches=0)
        trail.append((g.interval, g.ewma))
    g.feed_backpressure(sig())
    g.observe(votes=0, capacity=16, dispatches=0)
    trail.append((g.interval, g.ewma))
    lee = _governor(side)
    lee.feed_backpressure(sig(leeching=True, retry_pressure=5))
    lee.observe(votes=8, capacity=16, dispatches=1)
    lee2 = _governor(side)
    lee2.feed_backpressure(sig(queue_depth=64, capacity=64, leeching=True,
                               retry_pressure=5))
    lee2.observe(votes=8, capacity=16, dispatches=1)
    return (trail, g.backpressure_holds, g.trajectory_summary(),
            lee.interval, lee2.interval)


def test_governor_hold_under_retry_pressure_matches_jax():
    trail, holds, summary, widened, narrowed = _both(_hold)
    assert [i for i, _ in trail[4:18]] == [0.0125] * 14
    assert holds >= 1 and "backpressure_holds" in summary
    assert trail[-1][0] > 0.0125
    assert widened > 0.05 > narrowed


# --- the seeder's token bucket ---------------------------------------------


class _FakeNet:
    def __init__(self):
        self.sent = []

    def subscribe(self, *a, **k):
        pass

    def send(self, msg, dst=None):
        self.sent.append((msg, dst))


class _FakeLedger:
    size = 1000
    root_hash = b"\x00" * 32

    def get_by_seq_no(self, s):
        return {"seq": s}

    def audit_path(self, s, till):
        return [b"\x01" * 32]


class _FakeDB:
    def get_ledger(self, lid):
        return _FakeLedger()


def _throttle(side, case):
    timer = side.MockTimer(start_time=1_700_000_000.0)
    metrics = side.metrics.MetricsCollector()
    net = _FakeNet()
    rate, burst = {"defer": (40.0, 10), "dedupe": (20.0, 10),
                   "unservable": (40.0, 10), "off": (0.0, 10),
                   "epoch": (40.0, 10)}[case]
    cfg = side.getConfig({"CatchupSeederThrottleTxnsPerSec": rate,
                          "CatchupSeederThrottleBurst": burst})
    s = side.seeder.SeederService(net, _FakeDB(), own_name="n0",
                                  timer=timer, config=cfg, metrics=metrics)

    def req(start, end, till=1000):
        return side.msgs.CatchupReq(ledgerId=1, seqNoStart=start,
                                    seqNoEnd=end, catchupTill=till)

    trail = []
    if case in ("defer", "off"):
        for i in range(30 if case == "defer" else 20):
            s.process_catchup_req(req(i * 10 + 1, i * 10 + 10), "peer")
        for step in (0.0, 1.0, 10.0):
            timer.advance(step)
            trail.append(len(net.sent))
    elif case == "dedupe":
        s.process_catchup_req(req(1, 10), "peer")
        for _ in range(6):
            s.process_catchup_req(req(11, 20), "peer")
        trail.append(len(s._deferred))
        timer.advance(5.0)
    elif case == "unservable":
        s.process_catchup_req(req(50, 40), "peer")
        s.process_catchup_req(req(2000, 2010, till=0), "peer")
        trail.append((len(net.sent), s._tokens))
        s.process_catchup_req(req(1, 5000), "peer")
        s.process_catchup_req(req(1, 5), "peer")
        timer.advance(0.2)
    else:
        s._tokens = 9.999998
        for i in range(3):
            s.process_catchup_req(req(i * 10 + 1, i * 10 + 10), "peer")
        timer.advance(2.0)
    names = side.metrics.MetricsName
    stats = [metrics.stat(n) for n in (names.CATCHUP_SEEDER_DEFERRED,
                                       names.CATCHUP_SEEDER_TXNS)]
    return (trail, len(net.sent), s.deferred_total, s.served_txns,
            len(s._deferred), [st.total if st else None for st in stats],
            [(repr(m), dst) for m, dst in net.sent])


@pytest.mark.parametrize("case", ["defer", "dedupe", "unservable", "off",
                                  "epoch"])
def test_seeder_throttle_matches_jax(case):
    trail, sent, deferred, served, queued, stats, _ = \
        _both(_throttle, case)
    assert queued == 0
    if case == "defer":
        assert trail[0] == 1 and sent == 30 and deferred == 29
        assert stats == [29, 300]
    if case == "off":
        assert sent == 20 and deferred == 0


# --- the closed loop in a pool ---------------------------------------------


def _storm_pool(side, seed=17):
    config = side.getConfig({
        "Max3PCBatchSize": 10, "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.05, "QuorumTickAdaptive": True,
        "IngressQueueCapacity": 8,
        "IngressRetryMax": 3, "IngressRetryBase": 0.2,
        "IngressRetryBackoffMax": 2.0,
    })
    pool = side.SimPool(n_nodes=4, seed=seed, config=config,
                        device_quorum=True, shadow_check=False,
                        sign_requests=True, trace=True, **side.pool_kwargs)
    for i in range(40):
        pool.submit_request(i, client_id=f"c{i % 5}")
    for _ in range(30):
        pool.run_for(0.5)
    assert pool.honest_nodes_agree()
    return pool


_STORMS = {}


def _storm(side):
    if side.root not in _STORMS:
        _STORMS[side.root] = _storm_pool(side)
    return _STORMS[side.root]


def test_closed_loop_pool_matches_jax():
    want, got = _storm(JAX), _storm(PORT)
    assert got.admission.shed_hash() == want.admission.shed_hash()
    assert got.retry.retry_hash() == want.retry.retry_hash()
    assert got.ordered_hash() == want.ordered_hash()
    assert got.trace.trace_hash(exclude_cats=("dispatch",)) == \
        want.trace.trace_hash(exclude_cats=("dispatch",))
    assert got.admission.counters() == want.admission.counters()
    assert got.retry.counters() == want.retry.counters()
    assert got.governor.trajectory_summary() == \
        want.governor.trajectory_summary()
    # the reference's closed-loop contract, on the port
    adm, retry = got.admission, got.retry
    assert adm.shed_total > 0 and retry.reoffers_total > 0
    assert len(set(got.nodes[0].ordered_digests)) == 40
    assert retry.exhausted_total == 0
    names = PORT.metrics.MetricsName
    readmitted = got.metrics.stat(names.INGRESS_RETRY_ADMITTED)
    assert int(readmitted.total) == len(retry.retried_digests)
    marks = [ev for ev in got.trace.events() if ev["name"] == "req.retry"]
    assert len(marks) == retry.reoffers_total
    assert {ev["key"][0] for ev in marks} == retry.retried_digests


def test_closed_loop_journeys_carry_the_retry_hop_as_jax():
    want_events = _storm(JAX).trace.events()
    got_events = _storm(PORT).trace.events()
    js = PORT.causal.journey_summary(got_events)
    assert js == JAX.causal.journey_summary(want_events)
    assert js["retried"] == len(_storm(PORT).retry.retried_digests)
    assert js["shed"] == 0 and js["complete"] == js["count"] == 40
    assert "retry" in js["hop_percentiles"]
    built = PORT.causal.build_journeys(got_events)
    retried = [j for j in built["journeys"] if j.get("retries")]
    assert retried
    for j in retried:
        hops = {h["hop"]: h for h in j["hops"]}
        assert hops["retry"]["t0"] >= hops["admission"]["t0"]


def test_closed_loop_pool_replays():
    again = _storm_pool(PORT)
    first = _storm(PORT)
    assert again.retry.retry_hash() == first.retry.retry_hash()
    assert again.admission.shed_hash() == first.admission.shed_hash()
    assert again.trace.trace_hash() == first.trace.trace_hash()
