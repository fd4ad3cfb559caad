"""The overload gate's twin against ``scripts/check_dispatch_budget.py``'s,
on the CPU (``tests/torch_gates.py``).

The gate has no size flags: its flash-crowd arm (n=6, a queue of 10, 80
signed writes/s with a 10x crowd) and its chaos arc
(``f_crash_catchup_under_saturation`` at full size) are the reference's.
Its JAX side alone takes about two minutes here, and the port's plain
Ed25519 verify (about a second a drain on the CPU) over twenty, so the
parity case at full size is marked slow. In tier-1 the twin runs alone
with a smaller arm and arc set on the module (``OVERLOAD_ARM``,
``OVERLOAD_CHAOS``): its verdict PASSes, and the gate's own second runs
(the retry arm's and the chaos arc's) replay the first ones'
fingerprints. The plain verify sets this case's time too (about two
minutes).
"""
import dataclasses

import pytest

pytest.importorskip("jax")

from torch_gates import assert_gate_matches, run_port  # noqa: E402

# a smaller flash-crowd arm for the twin alone: the gate's marks at 1 s
# and 5 s stay inside it
SMALL_ARM = {"n_nodes": 4, "capacity": 2, "base_rate": 2.0, "duration": 7.0,
             "flash_at": 2.5, "flash_dur": 1.0, "peak": 12.0}
# the saturating scenario's half-second crowd of 4 writes/s
# (tests/test_torch_chaos.py's small workload)
SMALL_CHAOS = {"workload_duration": 0.5, "workload_rate": 4.0}


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.slow
def test_overload_gate_matches_reference(monkeypatch, capsys):
    rec = assert_gate_matches(["--only", "overload"], monkeypatch,
                              capsys)["overload_gate"]
    assert rec["deterministic"] and rec["chaos"]["verdicts_pass"]


def test_overload_gate_small_arm_passes_and_replays(monkeypatch, capsys):
    from indy_plenum_tpu_torch.chaos import get_scenario
    from indy_plenum_tpu_torch.tools import check_dispatch_budget as port

    monkeypatch.setattr(port, "OVERLOAD_ARM", SMALL_ARM)
    monkeypatch.setattr(port, "OVERLOAD_CHAOS", dataclasses.replace(
        get_scenario("f_crash_catchup_under_saturation"), **SMALL_CHAOS))
    rc, rec = run_port(["--only", "overload"], capsys)
    assert rc == 0 and rec["verdict"] == "PASS", rec["verdict"]
    gate = rec["overload_gate"]
    assert gate["deterministic"] and gate["chaos"]["replay_identical"]
    assert gate["open_loop"]["shed"] > 0 and gate["retry_storm"]["reoffers"]
    assert gate["chaos"]["seeder_throttle"]["deferred"] > 0
