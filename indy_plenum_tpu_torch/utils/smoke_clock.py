"""Seconds of each check in ``chip_smoke.py``'s phase 2 (the kernels
against their plain versions), for finding which check moves the
script's clock between two checkouts. Run this one file by its path from
each checkout's root, in turns (parent, change, change, parent):

    python3 <checkout>/indy_plenum_tpu_torch/utils/smoke_clock.py --tag change

It imports the port and ``chip_smoke.py`` of the checkout it runs from
(the current directory) and calls phase 2's checks in the order and with
the seed that ``chip_smoke.main`` uses, each timed from a synchronized
card to a synchronized card on the host's clock (the kernel build before
them is timed apart). One JSON line: ``build_s``, ``check_s`` (seconds a
check), their sum ``phase_s``, ``failed`` (a check that raised, with its
error) and the card's name and power limit. It exits non-zero without a
card, or when a check failed.
"""
from __future__ import annotations

# da: allow-file[device-sync,nondet-source] -- a measuring tool: its clocks and syncs time kernels for a report and never feed a result

import argparse
import json
import os
import sys
import time

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", required=True)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("smoke_clock: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import resolve_device, \
        set_deterministic

    set_deterministic()
    dev = resolve_device()
    out = {"tag": args.tag, "card": cs._nvidia_smi(), "check_s": {}}
    t0 = time.perf_counter()
    kb.library()
    out["build_s"] = time.perf_counter() - t0

    def clock(name, fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            result = fn(*a, **k)
        except Exception as exc:  # a check this checkout cannot run
            out.setdefault("failed", {})[name] = repr(exc)[:200]
            return None
        torch.cuda.synchronize()
        out["check_s"][name] = time.perf_counter() - t0
        return result

    rng = np.random.RandomState(20261016)
    signers, reqs = clock("signed_requests", cs.make_signed_requests,
                          seed=64)
    clock("sha512_and_mod_l", cs.check_sha512_and_mod_l, dev, rng)
    clock("verify", cs.check_verify, dev, signers, reqs, rng)
    clock("quorum", cs.check_quorum, dev, rng)
    clock("quorum_shapes", cs.check_quorum_shapes, dev, rng)
    clock("window_a", cs.check_window, dev, rng, cs.N_VALIDATORS,
          cs.N_VALIDATORS, cs.LOG_SIZE, cs.N_CHECKPOINTS, cs.CHK_FREQ)
    clock("window_b", cs.check_window, dev, rng,
          cs.B_NODES * cs.B_INSTANCES, cs.B_NODES, cs.B_LOG_SIZE,
          cs.B_LOG_SIZE // cs.B_CHK_FREQ, cs.B_CHK_FREQ)
    clock("sha256", cs.check_sha256, dev, rng)
    corpus = clock("audit_corpus", cs.audit_corpus)
    clock("audit", cs.check_audit, dev, corpus, rng)
    clock("resident_a", cs.check_resident, dev, rng, cs.N_VALIDATORS,
          cs.N_VALIDATORS, cs.LOG_SIZE, cs.N_CHECKPOINTS, cs.CHK_FREQ)
    clock("resident_b", cs.check_resident, dev, rng,
          cs.B_NODES * cs.B_INSTANCES, cs.B_NODES, cs.B_LOG_SIZE,
          cs.B_LOG_SIZE // cs.B_CHK_FREQ, cs.B_CHK_FREQ)
    clock("resident_odd", cs.check_resident, dev, rng, 6, 7, 40, 2, 5,
          w=32)
    fused = clock("fused_inputs", cs.fused_inputs, rng, cs.N_VALIDATORS,
                  cs.LOG_SIZE, cs.DRAIN)
    clock("fused", cs.check_fused, dev, rng, fused)
    clock("fabric", cs.check_fabric, dev, rng)
    clock("resident_tile", cs.check_resident_tile, dev, rng)
    clock("ring_rotate", cs.check_ring_rotate, dev, rng)
    clock("sharded_fused", cs.check_sharded_fused, dev, fused)
    clock("commit_plan", cs.commit_plan, dev)
    out["phase_s"] = sum(out["check_s"].values())
    print(json.dumps(out), flush=True)
    return 1 if "failed" in out else 0


if __name__ == "__main__":
    sys.exit(main())
