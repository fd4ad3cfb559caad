"""The chaos plane in the port against the JAX package.

- Every one of the 17 registered scenarios at seed 7, the port with
  ``device="cpu"``: every ``ChaosReport`` field equal to the JAX run's,
  the replay command and the host's wall-clock series aside (the port's
  replay names its own chaos CLI, ``python -m indy_plenum_tpu_torch.tools
  .chaos_run``, the reference's its ``scripts/chaos_run.py``; the flags
  after the program are the same). ``f_crash_catchup_under_saturation`` needs
  the tick plane and signs its requests, whose verify's plain version is
  slow on the CPU: at full size it is marked slow, as the reference's
  test of it is, and a smaller workload of it runs unmarked.
- ``f_crash_gc_catchup`` traced: ``trace_hash``, the flight recorder and
  the causal journeys equal; the catchup arcs on the tick-batched dispatch
  plane (``device_quorum``, tick 0.05, the adaptive governor) equal the
  JAX runs too, but for ``device.flush_time``, a host wall-clock series.
- ``f_crash_partition`` through the port's member mesh and 2-axis fabric
  (one device) and through a depth-4 residency ring orders as the JAX
  run on one device at depth 1, and replays.
- The three scenarios that came with the workload planes (lanes,
  overload, geo) run: what raises there is the reference's own argument
  checks; the other argument checks are the reference's too.
- The port's full ``observability/causal.py``: ``build_journeys``,
  ``journey_summary``, ``journey_hash`` and ``journey_for`` on one trace,
  equal to the reference's.
"""
import pytest

pytest.importorskip("jax")

from indy_plenum_tpu.chaos import run_scenario as jax_run  # noqa: E402
from indy_plenum_tpu.observability import causal as jax_causal  # noqa: E402
from indy_plenum_tpu_torch.chaos import SCENARIOS  # noqa: E402
from indy_plenum_tpu_torch.chaos import run_scenario as port_run  # noqa: E402
from indy_plenum_tpu_torch.observability import causal as port_causal  # noqa: E402,E501

LATER = {"lane_partition": "lanes",
         "f_crash_catchup_under_saturation": "overload",
         "edge_cache_poisoning": "geo"}
SATURATION = "f_crash_catchup_under_saturation"
RUNNABLE = [name for name in SCENARIOS if name != SATURATION]
TICK = dict(device_quorum=True, quorum_tick_interval=0.05,
            quorum_tick_adaptive=True)
# host wall-clock series: the fields two runs never share
WALL_METRICS = ("device.flush_time", "auth.batch_time")


def _record(report):
    out = report.as_dict()
    assert out.pop("replay_command")
    for key in WALL_METRICS:
        out["metrics"].pop(key, None)
    return out


def _pair(name, **kw):
    want = jax_run(name, 7, **kw)
    got = port_run(name, 7, device="cpu", **kw)
    return want, got


def test_registries_match():
    from indy_plenum_tpu.chaos import SCENARIOS as JAX_SCENARIOS

    assert list(SCENARIOS) == list(JAX_SCENARIOS)
    assert len(RUNNABLE) == 16 and len(SCENARIOS) == 17
    for name, sc in SCENARIOS.items():
        ref = JAX_SCENARIOS[name]
        assert sc.plan(7).as_dicts() == ref.plan(7).as_dicts()
        assert (sc.real_execution, sc.bls, sc.expect_fail) == \
            (ref.real_execution, ref.bls, ref.expect_fail)


@pytest.mark.parametrize("name", RUNNABLE)
def test_scenario_matches_jax(name):
    want, got = _pair(name)
    assert _record(got) == _record(want)
    assert got.verdict_as_expected


def test_traced_catchup_matches_jax():
    want, got = _pair("f_crash_gc_catchup", trace=True)
    assert got.trace_hash == want.trace_hash
    assert got.journeys == want.journeys
    assert got.flight_recorder == want.flight_recorder
    assert _record(got) == _record(want)
    assert got.failed == []
    assert got.catchup["proof_read"]["verified"] is True
    assert got.journeys["complete"] == got.journeys["count"] > 0


@pytest.mark.parametrize("name", ["f_crash_gc_catchup", "f_crash_partition",
                                  "byzantine_seeder_catchup"])
def test_tick_plane_arcs_match_jax(name):
    want, got = _pair(name, trace=True, **TICK)
    assert _record(got) == _record(want)
    assert got.trace_hash == want.trace_hash
    assert got.failed == [] and got.metrics["device.flush"]["count"] > 0
    program = "python -m indy_plenum_tpu_torch.tools.chaos_run "
    assert got.replay_command.startswith(program)
    assert got.replay_command[len(program):] == \
        want.replay_command[len("python scripts/chaos_run.py "):]


@pytest.mark.parametrize("name", sorted(LATER))
def test_later_slice_scenarios_raise(name):
    """The three scenarios whose slices have landed no longer raise
    ``NotImplementedError``: what raises is the reference's own argument
    checks, alike in both runners, and each scenario's verdicts hold on
    the port (its whole report is held in ``test_scenario_matches_jax``,
    and for the saturating one in the cases below)."""
    for run in (jax_run, port_run):
        extra = {} if run is jax_run else {"device": "cpu"}
        if name == "lane_partition":
            for kw in (dict(host_eval=True), dict(resident_depth=4, **TICK),
                       dict(mesh=object(), **TICK)):
                with pytest.raises(ValueError, match="laned"):
                    run(name, 7, **kw, **extra)
        elif name == SATURATION:
            with pytest.raises(ValueError, match="tick-batched"):
                run(name, 7, **extra)
    if name == "edge_cache_poisoning":
        report = port_run(name, 7, device="cpu")
        verdicts = {r["name"]: r["verdict"] for r in report.invariants}
        assert verdicts["edge_poisoning"] == "PASS"
        assert verdicts["edge_honest_serve"] == "PASS"
        poisoned = report.edge["poisoned"]
        assert poisoned["tampered"] == poisoned["caught"] > 0
        assert report.edge["honest"]["edge_serve_pairings"] == 0


SAT_TICK = dict(device_quorum=True, quorum_tick_interval=0.1,
                quorum_tick_adaptive=True)


def _saturation_pair(seed, **smaller):
    """The saturating scenario through both runners; ``smaller`` replaces
    fields of the registered scenario (the same in both packages)."""
    import dataclasses

    from indy_plenum_tpu.chaos import get_scenario as jax_get
    from indy_plenum_tpu_torch.chaos import get_scenario as port_get

    want = jax_run(dataclasses.replace(jax_get(SATURATION), **smaller),
                   seed, trace=True, **SAT_TICK)
    got = port_run(dataclasses.replace(port_get(SATURATION), **smaller),
                   seed, trace=True, device="cpu", **SAT_TICK)
    return want, got


def _check_saturation(want, got):
    assert _record(got) == _record(want)
    assert got.trace_hash == want.trace_hash
    assert got.verdict_as_expected and not got.failed
    ing = got.ingress
    assert ing["shed_hash"] == want.ingress["shed_hash"]
    assert ing["retry_hash"] == want.ingress["retry_hash"]
    assert ing["admission"]["shed"] > 0 and ing["retry"]["reoffers"] > 0
    assert got.catchup["txns_leeched"] > 0


def test_saturation_scenario_small_workload_matches_jax():
    """The saturating scenario with a half-second crowd of 4 writes/s: the
    whole report, ``shed_hash``, ``retry_hash`` and the trace equal the
    JAX run's, and its recovery verdicts hold."""
    _check_saturation(*_saturation_pair(
        7, workload_duration=0.5, workload_rate=4.0))


@pytest.mark.slow
def test_saturation_scenario_matches_jax():
    """The reference's slow case (seed 11, the tick plane at 0.1, traced)
    at full size: the flash crowd sheds, the retries re-offer, the seeder
    throttle defers, and both runners write the same report."""
    want, got = _saturation_pair(11)
    _check_saturation(want, got)
    assert got.ingress["seeder_throttle"]["deferred"] > 0


def test_run_scenario_checks_its_dispatch_arguments():
    """The reference's argument checks (the card requirement itself is an
    entry point of ``tests/test_torch_isolation.py``)."""
    for kw, match in ((dict(quorum_tick_interval=0.05), "device_quorum"),
                      (dict(quorum_tick_adaptive=True), "tick interval"),
                      (dict(resident_depth=4), "tick-batched"),
                      (dict(mesh=object()), "device_quorum")):
        for run in (jax_run, port_run):
            extra = {} if run is jax_run else {"device": "cpu"}
            with pytest.raises(ValueError, match=match):
                run("f_crash_partition", 7, **kw, **extra)


def test_causal_journeys_match_jax():
    report = port_run("ic_storm_mid_catchup", 7, device="cpu", trace=True)
    ref = jax_run("ic_storm_mid_catchup", 7, trace=True)
    assert report.trace_hash == ref.trace_hash
    # one event list through both packages' journey builders
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    pool = SimPool(4, seed=7, trace=True, device="cpu",
                   config=getConfig({"Max3PCBatchWait": 0.1,
                                     "Max3PCBatchSize": 3}))
    for i in range(9):
        pool.submit_request(i)
    pool.run_for(8)
    events = pool.trace.events()
    got = port_causal.build_journeys(events)
    want = jax_causal.build_journeys(events)
    assert got == want and got["journeys"]
    assert port_causal.journey_hash(got["journeys"]) == \
        jax_causal.journey_hash(want["journeys"])
    summary = port_causal.journey_summary(events)
    assert summary == jax_causal.journey_summary(events)
    assert summary["complete"] == summary["count"] == 9
    digest = got["journeys"][0]["digest"]
    assert port_causal.journey_for(events, digest[:12]) == \
        jax_causal.journey_for(events, digest[:12])
    assert report.journeys == ref.journeys


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
def test_mesh_arcs_order_as_jax(shape):
    """The reference's mesh chaos cases (``tests/test_mesh_dispatch.py``,
    ``tests/test_quorum_fabric.py``): ``f_crash_partition`` through the
    port's member mesh and 2-axis fabric on one device orders exactly as
    the JAX run on one device, every invariant holds, and the traced
    fabric run replays to the same ``trace_hash``."""
    from indy_plenum_tpu_torch.tpu.quorum import make_fabric_mesh

    mesh = make_fabric_mesh(["cpu"] * 4, shape)
    want = jax_run("f_crash_partition", 7, **TICK)
    got = port_run("f_crash_partition", 7, device="cpu", mesh=mesh,
                   trace=True, **TICK)
    assert got.verdict_as_expected and not got.failed
    assert got.ordered_hash_per_node == want.ordered_hash_per_node
    assert got.invariants == want.invariants
    assert got.dispatch_mode["mesh"] == "x".join(map(str, shape))
    assert got.replay_command.endswith(
        " --mesh " + "x".join(map(str, shape)) + " --trace")
    replay = port_run("f_crash_partition", 7, device="cpu", mesh=mesh,
                      trace=True, **TICK)
    assert replay.trace_hash == got.trace_hash


def test_smoke_phase_x_on_cpu_matches_jax():
    """``chip_smoke.py`` phase X's arm on the CPU: the record it compares
    between the card and the CPU equals the JAX run's, and the dispatches
    it counts for the card's K7 / K8 launches are one K7 a flush."""
    import chip_smoke as cs

    with cs.plain_dispatches() as counted:
        report, record, _, recover = cs.run_chaos_x(
            "cpu", "byzantine_seeder_catchup")
    want = _record(jax_run("byzantine_seeder_catchup", cs.X_SEED,
                           trace=True, **cs.X_TICK))
    want.pop("trace_file")
    assert record == want
    assert counted["quorum_step"] == report.metrics["device.flush"]["count"]
    assert counted["window_slide"] > 0 and recover > 0


@pytest.mark.parametrize("name", [
    "lane_partition", "edge_cache_poisoning",
    pytest.param(SATURATION, marks=pytest.mark.slow)])
def test_smoke_phase_x_workload_arms_on_cpu_match_jax(name):
    """``chip_smoke.py`` phase X's workload arms on the CPU (the twins the
    card's runs are held against): the record equals the JAX run's, and
    the dispatches counted for the card's K7 are one a flush."""
    import chip_smoke as cs

    with cs.plain_dispatches() as counted:
        report, record, _, _ = cs.run_chaos_x("cpu", name)
    want = _record(jax_run(name, cs.X_SEED, trace=True, **cs.X_TICK))
    want.pop("trace_file")
    assert record == want
    assert report.verdict_as_expected and not report.failed
    assert counted["quorum_step"] == report.metrics["device.flush"]["count"]
    assert counted["window_slide"] > 0


def test_resident_arc_orders_as_jax():
    """The reference's residency chaos case (``tests/test_residency.py``,
    ``test_chaos_f_crash_partition_under_residency``): through a depth-4
    ring every invariant passes, the replay names the depth, and the
    port orders as the JAX run at depth 1 (the JAX ring's staging race,
    ROADMAP Queue 3, keeps its own depth-4 run out of the comparison)."""
    tick = dict(TICK, quorum_tick_interval=0.1)
    got = port_run("f_crash_partition", 7, device="cpu", resident_depth=4,
                   **tick)
    want = jax_run("f_crash_partition", 7, **tick)
    assert got.failed == [] and got.verdict_as_expected
    assert got.dispatch_mode["resident"] == 4
    assert " --resident-depth 4" in got.replay_command
    assert got.ordered_hash_per_node == want.ordered_hash_per_node
