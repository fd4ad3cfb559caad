"""The state gate's twin against ``scripts/check_dispatch_budget.py``'s,
on the CPU (``tests/torch_gates.py``): the sequential, host and ``auto``
commit arms on a 2,000-key state, 3 windows of 256 writes, and the
virtual-time soak arm over half an hour, reduced through the script's own
``--state-*`` flags. Both verdicts PASS; the per-window roots, the hashes
per commit, the soak's tallies, high-water and fingerprint are equal; the
arms' timings are the wall fields set aside. The ``auto`` arm's split of
its hashes between host and device waves follows the offload policy's
timed probes (``perf_counter``), so only its total is held equal. The
twin's ``auto`` arm walks its device plans through K11's plain version,
which is what costs most of its time here."""
import pytest

pytest.importorskip("jax")

from torch_gates import assert_gate_matches  # noqa: E402

STATE = ["--only", "state", "--state-keys", "2000", "--state-windows", "3",
         "--state-soak-hours", "0.5"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _auto_total(rec):
    """The ``auto`` arm's wave hashes, host and device, taken out of the
    stripped record: their split is timed, their sum is not."""
    auto = rec["state_gate"]["arms"]["auto"]
    return auto.pop("wave_host_hashes") + auto.pop("wave_device_hashes")


def test_state_gate_matches_reference(monkeypatch, capsys):
    rec = assert_gate_matches(STATE, monkeypatch, capsys,
                              steered=_auto_total)["state_gate"]
    assert rec["roots_identical"] and rec["hash_reduction"] >= 3.0
    assert rec["soak"]["deterministic"] and rec["soak"]["flat_high_water"]
