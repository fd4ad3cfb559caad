"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python -m port_bench.run --workload local-4.reads --seed 7 \\
        --seconds 30 --trace 0

Set-up (all of it in ``setup_s``): load the kernel library and the BN254
extension (built into the checkout on first use), build the pool from the
seed, sign every write the window may send, and order the cell's warm-up
(the read population through 3PC, one batch of writes). The window runs
the mix's closed-loop clients for ``--seconds`` of wall time; with
``--trace 1`` under ``torch.profiler``. After the window, untimed: the
writes and reads still in flight are answered, ``memory_peak_bytes`` is
read, the pool's outputs are taken as plain data and the pool freed, and
the plain reference judges them (``reference/check.py``). The last line
of standard output is the result; the last lines of standard error are
the numbers compared, each beside its limit.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "indy_plenum_tpu")
LIMITS = {"auth": 0, "order": 0, "ledger": 0, "state": 0, "replies": 0,
          "lost": 0, "reads": 0, "multisig": 0}
ANSWER_WAIT_S = 60.0  # how long past the close an answer may come


class RunView:
    """What a metric reader sees: the window's wall time, its clients'
    requests, the program's counters as deltas over the window, and the
    trace of a traced run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def stat(self, name: str):
        """(count, total) of the program's metric ``name`` in the window."""
        return self.stats.get(name, (0, 0.0))


def _stats(metrics) -> Dict[str, tuple]:
    return {name: (s["count"], s["sum"])
            for name, s in metrics.summary().items()}


def _delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, tuple):
            b = b or (0, 0.0)
            out[k] = (v[0] - b[0], v[1] - b[1])
        else:
            out[k] = v - (b or 0)
    return out


def _counters(pool) -> dict:
    from indy_plenum_tpu_torch.crypto.bls.bls_crypto import PAIRINGS
    from indy_plenum_tpu_torch.utils.kernel_build import launch_counts

    return {"stats": _stats(pool.metrics), "launches": dict(launch_counts()),
            "pairings": PAIRINGS.pairings,
            "batches": len(pool.nodes[0].ordered_log)}


def _order_burst(pool, writes, step_s: float, wall_cap_s: float = 120.0):
    """Set-up: send ``writes`` to every node at once and step the pool
    until every node has ordered the valid ones; drop the answers."""
    target = [len(nd.ordered_digests) + sum(not w.corrupt for w in writes)
              for nd in pool.nodes]
    for w in writes:
        for nd in pool.nodes:
            nd.submit_client_request(w.req, "setup")
    t_cap = time.perf_counter() + wall_cap_s
    while any(len(nd.ordered_digests) < t
              for nd, t in zip(pool.nodes, target)):
        if time.perf_counter() > t_cap:
            raise RuntimeError("set-up: a warm-up batch did not order")
        pool.run_for(step_s)
    for nd in pool.nodes:
        nd.client_outbox = []


def _populate(pool, mix: dict, writes: list, step_s: float) -> int:
    """Order the read population through 3PC, ``populate_batch_writes`` a
    batch, until every node serves a stabilized window with the pool's
    multi-signature (the first checkpoint: ``CHK_FREQ`` batches)."""
    k = mix["populate_batch_writes"]
    for rnd in range(mix["populate_batches_max"]):
        if all(nd.proof_cache.attach(0) is not None for nd in pool.nodes):
            return rnd
        _order_burst(pool, writes[rnd * k:(rnd + 1) * k], step_s)
    raise RuntimeError("set-up: no stabilized proof window after "
                       f"{mix['populate_batches_max']} batches")


def _warm_reads(pool, mix: dict, space: int, draws) -> None:
    """Set-up: one drain per node at the window's drain size, so the
    proof verify's offload policy has calibrated before the window."""
    per_node = -(-mix["clients"] * mix["outstanding"] // len(pool.nodes))
    for nd in pool.nodes:
        for _ in range(per_node):
            nd.read_service.submit(draws.zipf_bounded(mix["zipf_theta"],
                                                      space))
        nd.read_service.drain()


def _record(pool, loop, setup_writes, config: dict, seed: int) -> dict:
    """The pool's outputs and the clients' requests as plain data."""
    from indy_plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID

    nodes = []
    for nd in pool.nodes:
        ledger = nd.boot.db.get_ledger(DOMAIN_LEDGER_ID)
        state = nd.boot.db.get_state(DOMAIN_LEDGER_ID)
        nodes.append({
            "name": nd.name,
            "leaves": [bytes(ledger.get_serialized(s))
                       for s in range(1, ledger.size + 1)],
            "root": bytes(ledger.root_hash),
            "state_root": bytes(state.committed_head_hash),
            "ordered": list(nd.ordered_digests)})
    writes = [{"payload": w.payload, "signature": w.signature,
               "corrupt": w.corrupt, "outcome": w.outcome,
               "quorum": w.quorum, "replies": dict(w.replies),
               "nacks": dict(w.nacks), "acks": w.acks}
              for w in loop.sent]
    sent_before = [{"payload": w.payload, "signature": w.signature,
                    "corrupt": w.corrupt} for w in setup_writes]
    reads = [None if r.served is None else {
        "index": r.served.index, "leaf": bytes(r.served.leaf),
        "root": bytes(r.served.root), "path": list(r.served.path),
        "tree_size": r.served.tree_size, "verified": r.served.verified,
        "multi_sig": r.served.multi_sig} for r in loop.reads]
    n = len(pool.nodes)
    return {"n": n, "f": (n - 1) // 3, "names": list(pool.validators),
            "nodes": nodes, "writes": writes, "setup_writes": sent_before,
            "reads": reads,
            "reads_unanswered": sum(r.served is None for r in loop.reads),
            "genesis": 1 + (n if config["with_pool_genesis"] else 0),
            "trustee_seed": bytes.fromhex(config["trustee_seed"]),
            "max_batch": config["config"]["Max3PCBatchSize"],
            "auth_sample": config["check"]["auth_sample"],
            "read_sample": config["check"]["read_sample"],
            "sample_seed": seed}


def _top(pairs: dict, k: int = 10) -> List[list]:
    return [[name, s] for name, s in
            sorted(pairs.items(), key=lambda kv: -kv[1])[:k]]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Optional[str] = None,
             t0: Optional[float] = None, tamper=None):
    """Run one cell; returns (result line, compared numbers, info, the
    record the reference judged). ``tamper(pool, loop)`` (the control and
    the fault tests of ``faults.py``) breaks the program after set-up."""
    from . import spec
    from .generator import Draws
    from .loop import (
        ClosedLoop,
        Signer,
        build_pool,
        make_writes,
        presign_count,
        settle,
    )
    from .reference.check import judge
    from .trace import WINDOW_SPAN, Tracer

    t0 = T0 if t0 is None else t0
    c = spec.cell(name, **({"root": root} if root else {}))
    cfg, mix = c.config, c.traffic
    if mix.get("kind", "closed_loop") != "closed_loop":
        raise ValueError(f"{name}: only closed-loop traffic runs here, "
                         f"not {mix['kind']!r}")
    metrics = c.per_layer if trace else c.end_to_end
    readers = spec.readers(metrics, **({"root": root} if root else {}))

    import torch
    from indy_plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID
    # importing it builds or loads the BN254 extension
    from indy_plenum_tpu_torch.crypto.bls import bls_crypto  # noqa: F401
    from indy_plenum_tpu_torch.server.client_authn import (
        warm_device_auth_path,
    )

    warm_device_auth_path(device)  # the kernel library, built or loaded
    tracer = Tracer()
    if trace:
        tracer.install()
    span = ((lambda s: torch.profiler.record_function(s)) if trace
            else (lambda s: contextlib.nullcontext()))

    step_s = cfg["config"]["QuorumTickInterval"]
    pool = build_pool(cfg, seed, device)
    signer = Signer(bytes.fromhex(cfg["trustee_seed"]))
    if signer.identifier != pool.trustee.identifier:
        raise RuntimeError("the configuration's trustee is not the pool's")
    writes = make_writes(presign_count(mix, seconds), Draws(seed, 1), signer,
                         first_req_id=1_000_000,
                         corrupt_every=mix.get("corrupt_every", 0))
    setup_writes = make_writes(
        mix.get("populate_batch_writes", 0) * mix.get(
            "populate_batches_max", 0) + mix["warmup_writes"],
        Draws(seed, 2), signer, first_req_id=1)
    loop = ClosedLoop(pool, mix, Draws(seed, 3), writes, span)
    info = {"cell": name, "seed": seed}
    if mix.get("read_fraction", 0.0) > 0:
        info["populate_batches"] = _populate(pool, mix, setup_writes, step_s)
        loop.read_space = min(nd.proof_cache.current().tree_size
                              for nd in pool.nodes)
        _warm_reads(pool, mix, loop.read_space, Draws(seed, 4))
    _order_burst(pool, setup_writes[-mix["warmup_writes"]:], step_s)
    if device != "cpu":
        torch.cuda.synchronize()
    # set-up's objects live as long as the pool: out of the collector's
    # generations, so a full collection in the window walks only the
    # window's own garbage
    gc.collect()
    gc.freeze()

    before = _counters(pool)
    if tamper is not None:
        tamper(pool, loop)
    if trace:
        tracer.start()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    with span(WINDOW_SPAN):
        loop.start(t_start)
        while time.perf_counter() < deadline:
            loop.iterate(step_s)
        t_end = time.perf_counter()
    if trace:
        if device != "cpu":
            torch.cuda.synchronize()
        tracer.stop()
    gc.unfreeze()
    after = _counters(pool)
    memory_peak = (torch.cuda.max_memory_allocated() if device != "cpu"
                   else 0)
    reduced = tracer.reduce() if trace else None

    # untimed: every answer still due, then the pool's outputs
    answered = settle(loop, step_s, ANSWER_WAIT_S,
                      lambda: loop.outstanding() == 0)
    forged = [w for w in loop.sent if w.corrupt]

    def converged():
        """Every node's ledger at one size, every forgery rejected by
        every node."""
        return len({nd.boot.db.get_ledger(DOMAIN_LEDGER_ID).size
                    for nd in pool.nodes}) == 1 and all(
            len(w.nacks) == len(pool.nodes) for w in forged)

    settle(loop, step_s, ANSWER_WAIT_S, converged)
    record = _record(pool, loop, setup_writes, cfg, seed)
    view = RunView(
        seconds=t_end - t_start, setup_s=t_start - t0, t_start=t_start,
        t_end=t_end, writes=list(loop.sent), reads=list(loop.reads),
        stats=_delta(after["stats"], before["stats"]),
        launches=_delta(after["launches"], before["launches"]),
        pairings=after["pairings"] - before["pairings"],
        batches=after["batches"] - before["batches"], trace=reduced)
    info.update(window_s=view.seconds, writes_sent=len(loop.sent),
                writes_presigned=len(writes), reads_sent=len(loop.reads),
                batches=view.batches, answered_in_time=answered,
                launches=view.launches)
    attempted = len(loop.sent) + len(loop.reads)
    failed = (sum(1 for w in loop.sent if not w.corrupt
                  and w.outcome != "acked")
              + sum(1 for r in loop.reads if r.served is None
                    or not r.served.verified
                    or r.served.multi_sig is None))
    values = {}
    for m in metrics:
        v = readers[m["name"]](view)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    kind = (torch.cuda.get_device_name(0) if device != "cpu" else "cpu")
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": kind,
           "count": c.chips, "memory_peak_bytes": memory_peak}
    if reduced is not None:
        dev.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
    del pool, loop, view
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    checks = judge(record)
    line = {"correct": all(checks[k] <= LIMITS[k] for k in checks),
            "attempted": attempted, "failed": failed, "metrics": values,
            "device": dev}
    if reduced is not None:
        line["breakdown"] = {"device_ops": _top(reduced.kernel_s),
                             "idle_gaps": _top(reduced.idle_gaps)}
    line["checks"] = {k: {"value": v, "limit": LIMITS[k]}
                      for k, v in checks.items()}
    return line, checks, info, record


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative whole number")

    from . import spec

    need = spec.cell(args.workload).chips
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"port_bench: needs {need} CUDA card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 3
    line, checks, info, _ = run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace))
    found = forbidden_modules()
    if found:
        print("port_bench: the run loaded " + ", ".join(found)
              + ": the port must run without JAX or the JAX package",
              file=sys.stderr)
        return 4
    print("info " + json.dumps(info, default=str), file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v} limit {LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
