"""Where a cell's files are: ``BENCHMARK.json`` names the cells, the
configurations and the metrics; each configuration, traffic mix and
per-layer metric is a file of its own under this folder, found by name.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))


def checkout_of(root: str = ROOT) -> str:
    """The checkout holding ``BENCHMARK.json``: this folder's parent."""
    return os.path.dirname(root)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(checkout_of(root), "BENCHMARK.json")) as fh:
        return json.load(fh)


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def cell(name: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration file (the
    ``file`` of its ``configs`` entry), its traffic mix
    (``traffic/<traffic>.json``) and the metrics it reports."""
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {', '.join(sorted(work))})")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(os.path.join(checkout_of(root), cfg["file"]))
    traffic = _load_json(os.path.join(root, "traffic",
                                      w["traffic"] + ".json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def reader(metric: str, root: str = ROOT) -> Callable:
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(root, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(metrics: List[dict], root: str = ROOT) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"], root) for m in metrics}
