"""The telemetry plane and the day soak in the port against the JAX
package.

``observability/telemetry.py`` and ``simulation/soak.py`` (the
reference's ``tests/test_telemetry.py``, less its monitor-snapshot test:
the monitor is not part of the port), the same inputs through both
packages:

- the resource ledger: current, running and window high-water, bound
  violations, snapshots;
- the plane: window rolls and counter deltas, ``telemetry_hash`` and its
  ring, the bound-violation, leak, drift and latency-creep laws, flight
  dumps and roll marks;
- armed pools (the port with ``device="cpu"``): the registered
  resources (``sized_resources`` of the trace ring, metrics, admission,
  retry, proof caches, SMT states and read backings), the rollup rows and
  ``telemetry_hash``;
- the day soak on the (4,) fabric (the reference's ticked arm; the port
  builds the fabric on its one device): a small slice unmarked, the
  reference's two slow slices marked slow as theirs are; ``fingerprint``,
  ``telemetry_hash`` and ``hourly_ordered`` equal.
"""
import importlib
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")


def _side(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root, tel=mod("observability.telemetry"),
        trace=mod("observability.trace"), getConfig=mod("config").getConfig,
        SimPool=mod("simulation.pool").SimPool, soak=mod("simulation.soak"),
        scb=mod("simulation.state_commit_bench"),
        pool_kwargs={} if root == "indy_plenum_tpu" else {"device": "cpu"})


JAX = _side("indy_plenum_tpu")
PORT = _side("indy_plenum_tpu_torch")
SIDES = (JAX, PORT)


def _both(fn, *args, **kwargs):
    want, got = (fn(side, *args, **kwargs) for side in SIDES)
    assert got == want
    return got


class FakeClock:
    def __init__(self, start=0.0):
        self.now = start

    def __call__(self):
        return self.now


def _plane(side, ledger=None, trace=None, **kw):
    kw.setdefault("window_sec", 1.0)
    kw.setdefault("leak_grace", 0)
    kw.setdefault("drift_lag", 1)
    return side.tel.TelemetryPlane(ledger or side.tel.ResourceLedger(),
                                   t0=0.0, trace=trace, **kw)


def _state(plane):
    return {"windows": list(plane.windows), "completed": plane.completed,
            "anomalies": list(plane.anomalies),
            "anomaly_count": plane.anomaly_count,
            "hash": plane.telemetry_hash, "snapshot": plane.snapshot()}


# --- the resource ledger ---------------------------------------------------


def _ledger(side):
    ledger = side.tel.ResourceLedger()
    box = []
    ledger.register(side.tel.SizedResource("box", lambda: len(box),
                                           bound=8))
    trail = []
    for n in (3, 7, 2):
        del box[:]
        box.extend(range(n))
        trail.append(ledger.sample())
    trail += [ledger.current("box"), ledger.high_water("box"),
              ledger.window_high_water()]
    ledger.reset_window()
    ledger.sample()
    trail += [ledger.window_high_water(), ledger.high_water("box"),
              ledger.snapshot(), list(ledger.names)]
    with pytest.raises(ValueError):
        ledger.register(side.tel.SizedResource("box", lambda: 0))
    over = side.tel.ResourceLedger()
    over.register(side.tel.SizedResource("small", lambda: 5, bound=3))
    over.register(side.tel.SizedResource("free", lambda: 10 ** 6))
    trail.append(over.sample())
    return trail


def test_resource_ledger_matches_jax():
    trail = _both(_ledger)
    assert trail[3:6] == [2, 7, {"box": 7}]
    assert trail[6] == {"box": 2} and trail[8]["box"]["approx_bytes"] == 128
    assert trail[-1] == ["small entries=5 over bound=3"]


# --- the plane's rolls and laws -------------------------------------------


def _case(side, name):
    tel = side.tel
    if name == "rolls":
        plane = _plane(side)
        total = [0]
        plane.add_counter("ordered", lambda: total[0])
        plane.add_gauge("g", lambda: 0.25)
        total[0] = 4
        plane.pulse(0.5)
        total[0] = 10
        plane.pulse(2.0)
        return _state(plane)
    if name == "hash":
        out = []
        for values in ([5, 7, 3], [5, 7, 3], [5, 7, 4]):
            plane = _plane(side)
            total = [0]
            plane.add_counter("ordered", lambda: total[0])
            for w, v in enumerate(values):
                total[0] += v
                plane.finalize(float(w + 1))
            out.append(plane.telemetry_hash)
        return out
    if name == "ring":
        out = []
        for n in (12, 11):
            plane = _plane(side, keep=4)
            for w in range(n):
                plane.pulse(float(w + 1))
            out.append(_state(plane))
        return out
    if name == "bound":
        ledger = tel.ResourceLedger()
        size = [0]
        ledger.register(tel.SizedResource("leaky", lambda: size[0], bound=3))
        plane = _plane(side, ledger)
        size[0] = 5
        plane.pulse(1.0)
        plane.pulse(2.0)
        return _state(plane)
    if name == "leak":
        ledger = tel.ResourceLedger()
        size = [0]
        ledger.register(tel.SizedResource("grow", lambda: size[0]))
        plane = _plane(side, ledger, leak_windows=3, leak_grace=2)
        for delta in [1] * 6 + [0] + [1] * 3:
            size[0] += delta
            plane.pulse(float(plane.completed + 1))
        return _state(plane)
    if name == "rings_exempt":
        ledger = tel.ResourceLedger()
        grow = [0]
        ledger.register(tel.SizedResource("flagged.ring", lambda: grow[0],
                                          bound=1000, ring=True))
        ledger.register(tel.SizedResource("unflagged.ramp",
                                          lambda: grow[0], bound=1000))
        plane = _plane(side, ledger=ledger, leak_windows=2, leak_grace=0)
        for w in range(10):
            grow[0] += 7
            plane.pulse(float(w + 1))
        return _state(plane)
    if name == "drift":
        plane = _plane(side, leak_grace=4, drift_frac=0.5, drift_lag=1)
        total = [0]
        plane.add_counter("ordered", lambda: total[0])
        for delta in (400, 40, 100, 100, 100, 100, 10, 5, 100, 10):
            total[0] += delta
            plane.pulse(float(plane.completed + 1))
        return _state(plane)
    if name == "creep":
        plane = _plane(side, leak_windows=3, leak_grace=0)
        for v in (0.1, 0.2, 0.3, 0.4):
            plane.observe_latency(v)
            plane.pulse(float(plane.completed + 1))
        return _state(plane)
    if name == "dumps":
        clock = FakeClock()
        rec = side.trace.TraceRecorder(clock, capacity=256)
        ledger = tel.ResourceLedger()
        size = [0]
        ledger.register(tel.SizedResource("grow", lambda: size[0]))
        plane = _plane(side, ledger, trace=rec, leak_windows=2,
                       leak_grace=0)
        for w in range(4):
            size[0] += 1
            clock.now = float(w + 1)
            plane.pulse(clock.now)
        return _state(plane), list(rec.dumps), rec.events()
    raise KeyError(name)


CASES = ("rolls", "hash", "ring", "bound", "leak", "rings_exempt", "drift",
         "creep", "dumps")


@pytest.mark.parametrize("name", CASES)
def test_plane_matches_jax(name):
    got = _both(_case, name)
    if name == "rolls":
        assert got["completed"] == 2
        assert [r["counters"]["ordered"] for r in got["windows"]] == [10, 0]
    if name == "hash":
        assert got[0] == got[1] != got[2]
    if name == "ring":
        assert len(got[0]["windows"]) == 4 and got[0]["completed"] == 12
        assert got[0]["hash"] != got[1]["hash"]
    if name == "bound":
        assert got["snapshot"]["bound_violations"] == ["leaky"]
    if name == "leak":
        leaks = [a for a in got["anomalies"]
                 if a["law"] == "resource_leak"]
        assert len(leaks) == 2 and leaks[0]["window"] == 4
    if name == "rings_exempt":
        assert [a["resource"] for a in got["anomalies"]
                if a["law"] == "resource_leak"] == ["unflagged.ramp"]
    if name == "drift":
        assert sum(a["law"] == "throughput_drift"
                   for a in got["anomalies"]) == 2
    if name == "creep":
        assert [a["streak"] for a in got["anomalies"]
                if a["law"] == "latency_creep"] == [3]
    if name == "dumps":
        assert [d["reason"] for d in got[1]] == ["telemetry.resource_leak"]


def test_plane_unarmed_and_checked_as_jax():
    for side in SIDES:
        config = side.getConfig()
        assert config.TelemetryWindowSec == 0.0
        assert side.tel.TelemetryPlane.from_config(
            config, side.tel.ResourceLedger(), 0.0) is None
        with pytest.raises(ValueError):
            _plane(side, window_sec=0.0)
        pool = side.SimPool(4, seed=3, **side.pool_kwargs)
        assert pool.telemetry is None and pool.resource_ledger is None


# --- armed pools -------------------------------------------------------------


def _armed(side, real_execution, n_reqs=25, run_s=20):
    config = side.getConfig({
        "Max3PCBatchWait": 0.1, "Max3PCBatchSize": 10,
        "TelemetryWindowSec": 1.0, "TelemetryLeakGraceWindows": 2,
        "StateCommitBatchMode": "host"})
    pool = side.SimPool(n_nodes=4, seed=29, config=config, trace=True,
                        real_execution=real_execution, **side.pool_kwargs)
    for i in range(n_reqs):
        pool.submit_request(i)
    pool.run_for(run_s)
    assert pool.honest_nodes_agree()
    if real_execution:
        service = pool.make_read_service("node0", mode="host")
        for i in range(4):
            service.submit(i)
        service.drain()
    pool.telemetry.finalize(pool.timer.get_current_time())
    rolls = [e for e in pool.trace.events() if e["name"] == "telemetry.roll"]
    return {"names": list(pool.resource_ledger.names),
            "ledger": pool.resource_ledger.snapshot(),
            "plane": _state(pool.telemetry),
            "ordered_hash": pool.ordered_hash(),
            "tap": pool._telemetry_tap.ordered_txns(), "rolls": len(rolls)}


@pytest.mark.parametrize("real_execution", [False, True],
                         ids=["simulated", "executed"])
def test_armed_pool_rollups_match_jax(real_execution):
    got = _both(_armed, real_execution)
    snap = got["plane"]["snapshot"]
    assert snap["windows"] >= 10 and snap["bound_violations"] == []
    names = got["names"]
    assert "trace.ring" in names and "telemetry.windows" in names
    assert any(n.startswith("node0.") for n in names)
    if real_execution:
        assert "node0.state.node_cache" in names
        assert "node0.read_backing1.path_cache" in names
    total = sum(r["counters"]["ordered"] for r in got["plane"]["windows"])
    assert total == got["tap"] and got["rolls"] == snap["windows"]
    assert _armed(PORT, real_execution)["plane"]["hash"] == \
        got["plane"]["hash"]


# --- the day soak on the (4,) fabric ----------------------------------------


def _soak(side, **kw):
    out = side.soak._day_soak_once(**kw, **side.pool_kwargs)
    return {k: out[k] for k in (
        "fingerprint", "telemetry_hash", "hourly_ordered", "ordered_total",
        "arrivals", "windows", "anomalies", "unexplained",
        "bound_violations", "chaos", "agree", "flat_high_water",
        "first_high_water", "last_high_water", "throughput_drift",
        "device_arm")}


def test_day_soak_small_slice_matches_jax():
    """A small slice of the day under both chaos legs: 1.5 hours, 120
    keys, a crash at 0.4 h for 0.2 h and a view change at 0.9 h."""
    got = _both(_soak, hours=1.5, rate=0.1, seed=17, n_keys=120,
                crash_hour=0.4, crash_hours=0.2, vc_hour=0.9,
                rebalance_tick=0, window_sec=600.0)
    assert got["device_arm"] and got["agree"]
    assert got["chaos"]["crash"]["ok"] and got["chaos"]["view_change"]["ok"]
    assert got["bound_violations"] == [] and got["hourly_ordered"]


def test_soak_high_water_matches_jax():
    def hw(side):
        pool = side.SimPool(4, seed=3, config=side.getConfig({
            "TelemetryWindowSec": 2.0, "Max3PCBatchWait": 0.1}),
            **side.pool_kwargs)
        for i in range(12):
            pool.submit_request(i)
            pool.run_for(1.0)
        pool.telemetry.finalize(pool.timer.get_current_time())
        return side.scb.soak_high_water(pool, per_hour=2, slack_frac=0.2)

    first, last, flat = _both(hw)
    assert set(first) == set(last) and flat in (True, False)


@pytest.mark.slow
def test_day_soak_slice_bit_identical_and_clean_as_jax():
    """The reference's slow slice (chaos pushed out of range), through both
    packages and replayed on the port."""
    kw = dict(hours=2.0, rate=0.1, seed=17, n_keys=200, crash_hour=99.0,
              crash_hours=1.0, vc_hour=99.0, rebalance_tick=0,
              window_sec=600.0)
    got = _both(_soak, **kw)
    assert _soak(PORT, **kw) == got
    assert got["agree"] and got["flat_high_water"]
    assert got["anomalies"] == 0 or not got["unexplained"]
    assert got["bound_violations"] == [] and got["throughput_drift"] == 0.0


@pytest.mark.slow
def test_day_soak_synthetic_leak_is_caught_as_jax():
    def leak(side):
        rec = side.soak._day_soak_once(
            hours=4.0, rate=0.1, seed=17, n_keys=200, crash_hour=99.0,
            crash_hours=1.0, vc_hour=99.0, rebalance_tick=0,
            window_sec=600.0, synthetic_leak=True, **side.pool_kwargs)
        return rec["unexplained"], rec["flat_high_water"], rec["fingerprint"]

    unexplained, flat, _ = _both(leak)
    assert any(a["law"] == "resource_leak"
               and a.get("resource") == "soak.synthetic_leak"
               for a in unexplained)
    assert not flat


@pytest.mark.slow
def test_smoke_phase_s_matches_jax():
    """``chip_smoke.py`` phase S on the CPU (the twin its card run is held
    against): ``bench.py``'s 6-hour day-soak slice on the (4,) fabric
    equals the JAX package's on every compared field, and passes the
    smoke's checks."""
    import chip_smoke as cs

    got = cs.run_soak_s("cpu")
    base = JAX.getConfig()
    want = JAX.soak._day_soak_once(
        cs.S_HOURS, base.SoakRate, cs.S_SEED, base.SoakKeys,
        window_sec=600.0, rebalance_tick=base.SoakRebalanceTick,
        **cs.S_LEGS)
    assert {k: got[k] for k in cs.S_COMPARE} == \
        {k: want[k] for k in cs.S_COMPARE}
    cs.check_soak(got)


def test_state_soak_matches_jax():
    """``state_commit_bench.run_state_soak``, the state plane's soak arm,
    whose flatness law (``soak_high_water``) the day soak shares: a
    quarter-hour diurnal slice, the same record in both packages."""
    def soak(side):
        out = side.scb.run_state_soak(
            hours=0.25, rate=0.6, seed=11, n_keys=40, period=450.0,
            sample_every=150.0, repeats=1, **side.pool_kwargs)
        out.pop("wall_s")
        return out

    got = _both(soak)
    assert got["agree"] and got["arrivals"] > 0
