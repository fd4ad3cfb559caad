"""Phase M of ``chip_smoke.py`` alone. Run from the root of a checkout, on
the card (or on every card of the machine):

    python3 indy_plenum_tpu_torch/utils/phase_m_probe.py [--kernels]

It imports the port and ``chip_smoke.py`` of the checkout it runs from
(the current directory) and builds the kernel library. With ``--kernels``
it holds phase M's kernels against their plain versions
(``chip_smoke.check_split``: M1, and M2 where the machine has two or more
cards) and prints their kernels rows (``chip_smoke.split_report``), with
no pool. Without it, it starts phase M's CPU twins in worker processes,
runs what phase M is held against (phase H's one-state (4, 2) arms at
depth 1 and 4, phase R's forced arms on (4, 2) and (8,)), then
``chip_smoke.phase_m`` and the rows, each main-path run between launch
counters set to 0 and read after, as ``chip_smoke.main`` does, each held
to ``chip_smoke.PATH_KERNELS``. Output: the phase's lines, then one JSON
line with the build seconds, the launches summed, the rows and the
card's name and power limit. It exits non-zero without a card or when a
part fails, and stops every process it starts.
"""
from __future__ import annotations

# da: allow-file[device-sync,nondet-source] -- a measuring tool: its clocks and syncs time the phase for a report and never feed a result

import json
import os
import sys
import time

import numpy as np


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("phase_m_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import resolve_device, \
        set_deterministic

    set_deterministic()
    dev = resolve_device()
    card = cs._nvidia_smi()
    t0 = time.perf_counter()
    kb.library()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(20261018)
    inputs = cs.fused_inputs(rng, cs.N_VALIDATORS, cs.LOG_SIZE, cs.DRAIN)
    launches = {name: 0 for name in kb.LAUNCHES}
    errs = {}
    twins = None
    try:
        if "--kernels" in argv:
            count, _ = cs.m_cards()
            for layout in ["m1"] + (["m2"] if count >= 2 else []):
                t1 = time.perf_counter()
                got = cs.check_split(dev, rng, inputs, layout)
                for name, err in got.items():
                    errs[name] = max(errs.get(name, 0), err)
                cs._line("check_split", layout=layout, max_abs_err=got,
                         seconds=time.perf_counter() - t1, card=card)
        else:
            twins = cs._twin_pool()
            jobs = cs.submit_m_twins(twins)

            def on_card(tag, fn, *args):
                torch.cuda.synchronize()
                kb.reset_launch_counts()
                t1 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                got = kb.launch_counts()
                missing = [k for k in cs.PATH_KERNELS.get(tag, ())
                           if got[k] <= 0]
                if missing:
                    raise AssertionError(f"{tag} never launched {missing}: "
                                         f"{got}")
                for name, n in got.items():
                    launches[name] += n
                return out, got, wall

            fabric_h = {}
            for arm, depth in (("fabric4x2", 1), ("fabric4x2_resident", 4)):
                fabric_h[arm] = on_card(f"fabric_{arm}", cs.run_pool_h,
                                        None, cs.M_H_SHAPE, depth)[0]
            rebalance_r = {
                "x".join(map(str, shape)): on_card(
                    "rebalance_forced", cs.run_pool_r, None, shape,
                    cs.R_FORCE_TICK)[0]
                for shape in cs.R_SHAPES}
            errs, _ = cs.phase_m(on_card, card, jobs, dev, inputs, fabric_h,
                                 rebalance_r, rng)
        for name in ("resident_partials", "resident_home", "ring_peer",
                     "sharded_fused_split"):
            errs.setdefault(name, 0)
        rows, call_ms, moves = cs.split_report(dev, rng, launches, errs,
                                               inputs)
    finally:
        if twins is not None:
            cs._stop_twins(twins)
    print(json.dumps({
        "build_s": build_s, "nvcc_s": kb.last_build_seconds,
        "launches": {k: v for k, v in launches.items() if v},
        "kernels": rows, "call_ms": call_ms, "moves": moves,
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
