"""The ingress gate's twin against ``scripts/check_dispatch_budget.py``'s,
on the CPU (``tests/torch_gates.py``), cut through the script's own
flags: n=4, one instance, a 0.2 s tick, an admission queue of 4, a
half-second window at 12 and at 120 signed writes/s. Equal records and
verdicts (PASS). The overload gate, also signed, has its own file.
"""
import pytest

pytest.importorskip("jax")

from torch_gates import REDUCED, assert_gate_matches  # noqa: E402

INGRESS = REDUCED + ["--only", "ingress", "--tick", "0.2",
                     "--ingress-duration", "0.5", "--ingress-capacity", "4",
                     "--ingress-rate", "120", "--ingress-unsat-rate", "12"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_ingress_gate_matches_reference(monkeypatch, capsys):
    rec = assert_gate_matches(INGRESS, monkeypatch, capsys)["ingress_gate"]
    assert rec["saturated"]["shed"] > 0 and rec["unsaturated"]["shed"] == 0
    assert rec["shed_deterministic"] and rec["ordered_deterministic"]
