"""The benchmark's own tests, on the CPU (the kernels' plain versions)
unless marked ``cuda``. Run from the checkout's root:

    python -m pytest port_bench/tests -q

A tiny cell (4 nodes, 3 x 3 clients, half reads, one write in three
forged, a checkpoint every 5 batches) is added as new files to a copy of
the benchmark in a temporary folder, as a later change would add one.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench import spec
from port_bench.faults import FAULTS
from port_bench.reference.check import CHECKS, judge
from port_bench.run import run_cell

ROOT = spec.ROOT
CHECKOUT = spec.checkout_of()
TINY = "tiny-4.mixed"
SEED = 2**33 + 5  # past 32 bits, as the driver's seeds are
SECONDS = 8.0


def _tiny_copy(dest) -> str:
    """A copy of the benchmark with the tiny cell added as new files;
    returns the copy's ``port_bench`` folder."""
    root = os.path.join(str(dest), "port_bench")
    shutil.copytree(ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(ROOT, "configs", "local-4.json")))
    cfg["name"] = "tiny-4"
    cfg["config"].update(CHK_FREQ=5, LOG_SIZE=15)
    cfg["check"] = {"auth_sample": 8, "read_sample": 200}
    json.dump(cfg, open(os.path.join(root, "configs", "tiny-4.json"), "w"))
    mix = {"clients": 3, "outstanding": 3,
           "read_fraction": 0.5, "zipf_theta": 0.99, "corrupt_every": 3,
           "populate_batch_writes": 2, "populate_batches_max": 30,
           "warmup_writes": 2, "max_writes_per_s": 400}
    json.dump(mix, open(os.path.join(root, "traffic", "mixed.json"), "w"))
    bench["configs"].append({"name": "tiny-4", "source": "tests",
                             "file": "port_bench/configs/tiny-4.json",
                             "reduced": ["CHK_FREQ"], "why": "tests"})
    bench["workloads"].append({"name": TINY, "config": "tiny-4",
                               "traffic": "mixed", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "proved_reads_per_s":
            m["workloads"].append(TINY)
    json.dump(bench, open(os.path.join(str(dest), "BENCHMARK.json"), "w"))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def sound(tiny):
    return run_cell(TINY, SEED, SECONDS, False, device="cpu", root=tiny)


def test_tiny_run_gives_a_well_formed_correct_line(sound):
    line, checks, info, record = sound
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"proved_reads_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] >= 0 and m["unit"]
    assert line["attempted"] == info["writes_sent"] + info["reads_sent"] > 0
    assert set(checks) == set(CHECKS) and not any(checks.values())
    json.loads(json.dumps(line))
    # the window drove every layer the check covers
    assert any(w["corrupt"] for w in record["writes"])
    assert any(w["outcome"] == "acked" for w in record["writes"])
    assert any(r is not None and r["multi_sig"] for r in record["reads"])


@pytest.mark.parametrize("what", ["verdict", "root", "audit_path",
                                  "reply", "state"])
def test_a_corrupted_output_makes_correct_false(sound, what):
    record = copy.deepcopy(sound[3])
    if what == "verdict":
        w = next(w for w in record["writes"] if w["corrupt"])
        w["nacks"].clear()
        w["acks"] = 1
        expect = "auth"
    elif what == "root":
        record["nodes"][1]["root"] = bytes(32)
        expect = "ledger"
    elif what == "audit_path":
        r = next(r for r in record["reads"] if r is not None and r["path"])
        r["path"][0] = bytes([r["path"][0][0] ^ 1]) + r["path"][0][1:]
        record["read_sample"] = len(record["reads"])
        expect = "reads"
    elif what == "reply":
        w = next(w for w in record["writes"] if w["outcome"] == "acked")
        w["quorum"] = (w["quorum"][0] + 1,) + tuple(w["quorum"][1:])
        expect = "replies"
    else:
        record["nodes"][2]["state_root"] = bytes(32)
        expect = "state"
    assert judge(record)[expect] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_planted_under_the_window_makes_correct_false(tiny, fault):
    line, checks, _, _ = run_cell(TINY, SEED + 1, SECONDS, False,
                                  device="cpu", root=tiny,
                                  tamper=FAULTS[fault])
    assert line["correct"] is False, checks


def test_added_config_mix_and_metric_are_found_by_name(tmp_path):
    root = _tiny_copy(tmp_path)
    with open(os.path.join(root, "metrics", "added_metric.py"), "w") as fh:
        fh.write("def read(run):\n    return run.seconds * 2\n")
    bench = json.load(open(os.path.join(str(tmp_path), "BENCHMARK.json")))
    bench["per_layer"].append({"name": "added_metric", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "client view",
                               "moves": "proved_reads_per_s",
                               "workloads": [TINY]})
    json.dump(bench, open(os.path.join(str(tmp_path), "BENCHMARK.json"),
                          "w"))
    c = spec.cell(TINY, root=root)
    assert c.config["name"] == "tiny-4" and c.traffic["clients"] == 3
    assert [m["name"] for m in c.per_layer] == ["added_metric"]
    read = spec.reader("added_metric", root=root)
    assert read(type("V", (), {"seconds": 1.5})()) == 3.0
    with pytest.raises(KeyError):
        spec.cell("no-such.cell", root=root)


def _top_names(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=CHECKOUT, capture_output=True, text=True, check=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    names = _top_names(
        "import glob, os\n"
        "import port_bench.run, port_bench.control\n"
        "import port_bench.reference.check, port_bench.roofline\n"
        "from port_bench import spec\n"
        "for p in glob.glob(os.path.join(spec.ROOT, 'metrics', '*.py')):\n"
        "    spec.reader(os.path.basename(p)[:-3])\n"
        "from port_bench.loop import build_pool\n"
        "import json\n"
        "cfg = json.load(open('port_bench/configs/local-4.json'))\n"
        "build_pool(cfg, 1, 'cpu')\n"
        "from port_bench.trace import Tracer\nTracer().install()\n"
        "from port_bench.run import forbidden_modules\n"
        "assert forbidden_modules() == [], forbidden_modules()\n")
    assert not names & {"jax", "jaxlib", "flax", "indy_plenum_tpu"}
    assert "indy_plenum_tpu_torch" in names
    # the reference imports nothing of the program
    ref = _top_names("import port_bench.reference.check")
    assert not ref & {"indy_plenum_tpu_torch", "torch", "jax",
                      "indy_plenum_tpu"}


def test_without_a_card_the_run_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "local-4.reads", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_in_a_folder_of_only_the_benchmark_the_run_prints_no_result(
        tmp_path):
    shutil.copytree(ROOT, os.path.join(str(tmp_path), "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "local-4.reads", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=str(tmp_path), capture_output=True, text=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_cell_on_the_card_is_correct(card):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "local-4.reads", "--seed", str(SEED), "--seconds", "5",
         "--trace", "1"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
