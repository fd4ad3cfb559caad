"""Run one gate of ``scripts/check_dispatch_budget.py`` and of its twin,
``indy_plenum_tpu_torch.tools.check_dispatch_budget``, on the same flags
and compare their records (the helpers of ``tests/test_torch_dispatch_
budget*.py``).

The reference script is loaded from its path as a module in the test
process: its import-time device provisioning finds the 8 host devices
``tests/conftest.py`` preset, and its ``main`` reads ``sys.argv``. Each
``main`` prints the run as one JSON line (``--json``); the twin runs with
``--device cpu``.
"""
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SCRIPT = os.path.join(ROOT, "scripts", "check_dispatch_budget.py")
# the cheap reduced shape: the sharded, tracing, readback, latency and
# residency gates at n=4 with one instance, the lanes gate at 10 txns a lane
REDUCED = ["--sharded-nodes", "4", "--sharded-instances", "1",
           "--lanes-txns", "10"]
# fields built from time.perf_counter (the state arms' elapsed_s and
# commits_per_sec, the proof gate's timed verifies and their ratio)
WALL_KEYS = {"wall_s", "wall_ratio", "per_root_64_s", "batch_64_s",
             "batch_speedup", "populate_s", "leeched_txns_per_wall_sec",
             "commits_per_sec", "elapsed_s"}
REF_CHAOS = "python scripts/chaos_run.py "
PORT_CHAOS = "python -m indy_plenum_tpu_torch.tools.chaos_run "


def reference():
    name = "_ref_check_dispatch_budget"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, REF_SCRIPT)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def run_reference(argv, monkeypatch, capsys):
    """The reference's ``main`` on ``argv``, its vote groups staging each
    word block in a fresh host buffer (``copy_staging``: the JAX ring's
    staging race, ROADMAP Queue 3, otherwise lets a queued slot's words
    land in another under CPU load, and the residency gate then fails on
    the JAX side alone)."""
    from test_torch_resident import copy_staging

    copy_staging(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["check_dispatch_budget.py"]
                        + list(argv) + ["--json"])
    rc = reference().main()
    return rc, _last_json(capsys.readouterr().out)


def run_port(argv, capsys):
    from indy_plenum_tpu_torch.tools import check_dispatch_budget as port

    rc = port.main(list(argv) + ["--json", "--device", "cpu"])
    return rc, _last_json(capsys.readouterr().out)


def strip_wall(obj):
    """``obj`` without its wall-clock fields, and with each chaos
    ``replay_command`` cut to its flags (the program names differ)."""
    if isinstance(obj, dict):
        out = {}
        for key, value in obj.items():
            if key in WALL_KEYS:
                continue
            if key == "replay_command":
                for program in (REF_CHAOS, PORT_CHAOS):
                    if value.startswith(program):
                        value = "chaos_run " + value[len(program):]
                assert value.startswith("chaos_run "), value
            out[key] = strip_wall(value)
        return out
    if isinstance(obj, list):
        return [strip_wall(v) for v in obj]
    return obj


def assert_gate_matches(argv, monkeypatch, capsys, verdict="PASS",
                        steered=None):
    """Both packages on ``argv``: equal exit codes, equal verdicts, equal
    records outside the wall fields; returns the port's record.
    ``steered(record)`` takes out of a stripped record the fields that a
    wall-clock probe steers (and checks what they must keep)."""
    want_rc, want = run_reference(argv, monkeypatch, capsys)
    got_rc, got = run_port(argv, capsys)
    assert got["verdict"] == want["verdict"]
    assert got_rc == want_rc
    a, b = strip_wall(got), strip_wall(want)
    if steered is not None:
        assert steered(a) == steered(b)
    assert a == b
    if verdict == "PASS":
        assert got["verdict"] == "PASS" and got_rc == 0
    else:
        assert got["verdict"].startswith("FAIL: " + verdict), got["verdict"]
    return got
