"""The virtual-day soak gate's twin against ``scripts/check_dispatch_
budget.py``'s, on the CPU (``tests/torch_gates.py``), cut through the
script's own ``--soak-hours`` to one virtual hour: the day's two same-seed
runs on the (4,) fabric and the fixed 4-hour leak arm.

Both packages take the ticked arm on a (4,) fabric (the reference because
``tests/conftest.py`` gives JAX 8 host devices, the twin on tiles of its
one device), so both arm the forced rebalance leg; its
``SoakRebalanceTick`` (5,000 two-second ticks) falls after a one-hour day,
so in both the leg is armed and never planned and both verdicts FAIL on
that leg alone, with equal messages and exit codes. Everything else in
the record is equal too: the hourly tallies, the telemetry hash chain, the
fingerprint, the anomalies, and the leak arm catching its planted leak.
A day long enough for the leg (three virtual hours and more) runs in the
slow case."""
import pytest

pytest.importorskip("jax")

from torch_gates import assert_gate_matches  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _check(rec):
    soak = rec["soak_gate"]
    assert soak["soak"]["deterministic"] and soak["soak"]["agree"]
    assert soak["soak"]["device_arm"]
    assert soak["soak"]["anomalies_unexplained"] == 0
    assert soak["leak_arm"]["caught"]
    assert soak["rebalance_leg"] == "ran"
    return soak


def test_one_hour_soak_gate_matches_reference(monkeypatch, capsys):
    rec = assert_gate_matches(
        ["--only", "soak", "--soak-hours", "1"], monkeypatch, capsys,
        verdict="day soak: forced-rebalance leg never planned")
    leg = _check(rec)["soak"]["chaos"]["rebalance"]
    assert leg["armed"] and not leg["planned"]


@pytest.mark.slow
def test_three_hour_soak_gate_matches_reference(monkeypatch, capsys):
    """Three virtual hours: the forced rebalance plans inside the day and
    both verdicts PASS (the reference's arm alone takes minutes)."""
    rec = assert_gate_matches(
        ["--only", "soak", "--soak-hours", "3"], monkeypatch, capsys)
    assert _check(rec)["soak"]["chaos"]["rebalance"]["ok"]
