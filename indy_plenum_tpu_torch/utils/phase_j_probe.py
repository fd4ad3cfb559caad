"""Phase J of ``chip_smoke.py`` alone. Run from the root of a checkout, on
the card:

    python3 indy_plenum_tpu_torch/utils/phase_j_probe.py

It imports the port and ``chip_smoke.py`` of the checkout it runs from
(the current directory), builds the kernel library, starts phase J's CPU
twins and phase O's two (which ``saturation``'s flash-crowd arms are held
against) in ``chip_smoke.TWIN_WORKERS`` worker processes, then runs
``chip_smoke.phase_j`` with each main-path run between launch counters
set to 0 and read after, as ``chip_smoke.main`` does, each held to
``chip_smoke.PATH_KERNELS``. Output: the phase's lines, then one JSON line
with the build seconds, the phase's seconds, the launches summed and the
card's name and power limit. It exits non-zero without a card or when a
part fails.
"""
from __future__ import annotations

# da: allow-file[device-sync,nondet-source] -- a measuring tool: its clocks and syncs time the phase for a report and never feed a result

import json
import os
import sys
import time


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("phase_j_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import set_deterministic

    set_deterministic()
    card = cs._nvidia_smi()
    twins = cs._twin_pool()
    try:
        jobs = {}
        for retry in (True, False):
            jobs[f"o_{retry}"] = twins.submit(cs._timed, cs.run_overload_o,
                                              "cpu", retry)
        for cell in cs.J_CELLS:
            jobs[f"j_{cell}"] = twins.submit(cs.twin_bench_j, cell)
        t0 = time.perf_counter()
        kb.library()
        build_s = time.perf_counter() - t0
        launches = {name: 0 for name in kb.LAUNCHES}

        def on_card(tag, fn, *args):
            torch.cuda.synchronize()
            kb.reset_launch_counts()
            t1 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            got = kb.launch_counts()
            missing = [k for k in cs.PATH_KERNELS[tag] if got[k] <= 0]
            if missing:
                raise AssertionError(f"{tag} never launched {missing}: "
                                     f"{got}")
            for name, count in got.items():
                launches[name] += count
            return out, got, wall

        summary = cs.phase_j(on_card, card, jobs)
    finally:
        cs._stop_twins(twins)
    print(json.dumps({
        "build_s": build_s, "phase_s": summary["phase_s"],
        "launches": {k: v for k, v in launches.items() if v},
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
