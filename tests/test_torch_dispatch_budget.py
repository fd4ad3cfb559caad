"""The gate suite's twin against ``scripts/check_dispatch_budget.py``, on
the CPU: each gate through both ``main``s on one seed (``--only GATE``),
the twin with ``--device cpu``, at reduced sizes through the script's own
flags. The verdicts and exit codes are equal, and so are the records
outside the wall-clock fields (``tests/torch_gates.py``).

This file holds the dispatch budget alone, the static gate and the gates
whose arms take seconds: governor, sharded, fabric, tracing, readback,
lanes, latency, proof, catchup, geo and residency, and one run of the
sharded, fabric, tracing, lanes, latency and readback gates together (the
reuse of arms between gates in ``main``). The ingress and overload gates,
the state gate and the soak gate have files of their own.

The static gate lints each package with its own analyzer: both pass, both
``findings_hash``es replay, and the records have the same keys; the
counts and the hash are each package's own.
"""
import pytest

pytest.importorskip("jax")

from torch_gates import (  # noqa: E402
    REDUCED,
    assert_gate_matches,
    reference,
    run_port,
    run_reference,
)

CHEAP = ["governor", "sharded", "fabric", "trace", "readback", "lanes",
         "latency", "proof", "catchup", "geo", "residency"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_gate_registry_and_flags_match_reference(capsys):
    from indy_plenum_tpu_torch.tools import check_dispatch_budget as port

    ref = reference()
    assert list(port.GATES) == list(ref.GATES)
    assert port.GATES == ref.GATES
    assert len(port.GATES) + 1 == 17  # the dispatch budget always runs
    want = vars(port.build_parser().parse_args([]))
    assert want.pop("device") is None
    assert port.main(["--list-gates"]) == 0
    listed = capsys.readouterr().out
    assert [line.split()[0] for line in listed.splitlines()] == \
        list(ref.GATES)
    # every flag and default of the reference, nothing moved
    import argparse

    parsed = {}

    def grab(self, args=None, namespace=None):
        parsed.update(vars(orig(self, [], namespace)))
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            ref.main()
    finally:
        argparse.ArgumentParser.parse_args = orig
    assert parsed == want


def test_dispatch_budget_alone_matches_reference(monkeypatch, capsys):
    rec = assert_gate_matches(["--only", ""], monkeypatch, capsys)
    assert not any(key.endswith("_gate") for key in rec)
    assert rec["device_dispatches_per_ordered_batch"] <= 25.0


@pytest.mark.parametrize("gate", CHEAP)
def test_gate_matches_reference(gate, monkeypatch, capsys):
    rec = assert_gate_matches(REDUCED + ["--only", gate], monkeypatch,
                              capsys)
    name = "tracing" if gate == "trace" else gate
    assert f"{name}_gate" in rec or f"{name}_gates" in rec


def test_gates_reusing_arms_match_reference(monkeypatch, capsys):
    """``main``'s reuse: the sharded gate's runs are the fabric's 1-axis
    arm and the tracing and readback gates' base, the tracing gate's
    traced run and the lanes gate's 4-lane arm ride into the latency
    gate."""
    rec = assert_gate_matches(
        REDUCED + ["--only", "sharded,fabric,trace,lanes,latency,readback"],
        monkeypatch, capsys)
    assert rec["fabric_gate"]["one_axis"] == \
        rec["sharded_gate"]["mesh_sharded"]
    assert rec["tracing_gate"]["untraced"] == \
        rec["sharded_gate"]["single_device"]
    assert rec["latency_gate"]["traced"] == rec["tracing_gate"]["traced"]


def test_static_gate_passes_on_each_package(monkeypatch, capsys):
    want_rc, want = run_reference(["--only", "static"], monkeypatch, capsys)
    got_rc, got = run_port(["--only", "static"], capsys)
    assert got_rc == want_rc == 0
    assert got["verdict"] == want["verdict"] == "PASS"
    a, b = want["static_gate"], got["static_gate"]
    assert set(a) == set(b)
    assert a["replay_identical"] and b["replay_identical"]
    assert b["unsuppressed"] == 0 and b["files_analyzed"] > 150
    assert set(b["rules"]) == set(a["rules"])
