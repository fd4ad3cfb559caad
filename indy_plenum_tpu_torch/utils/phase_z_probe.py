"""Phase Z of ``chip_smoke.py`` alone, with K11 timed around each part.
Run from the root of a checkout, on the card:

    python3 indy_plenum_tpu_torch/utils/phase_z_probe.py

It imports the port and ``chip_smoke.py`` of the checkout it runs from
(the current directory), builds the kernel library and runs
``chip_smoke.phase_z`` part by part: Z1, Z2's three scenarios, Z3 and Z4,
each main-path run between launch counters set to 0 and read after, as
``chip_smoke.main`` does, and each held to ``chip_smoke.PATH_KERNELS``.
Before the first part and after each one it times K11 on
``chip_smoke.commit_plan`` (three readings of ``chip_smoke._kernel_ms``,
behind a spin) and reads the card's SM clock, power and throttle
reasons: it says whether the socket phase leaves the card slower for the
kernels the smoke times after it. Output: each part's record (the phase's
own fields), then one JSON line with the build seconds, the K11 readings,
the clocks, the launches summed and the card's name and power limit.
It exits non-zero without a card or when a part fails.
"""
from __future__ import annotations

# da: allow-file[device-sync,nondet-source] -- a measuring tool: its clocks and syncs time kernels for a report and never feed a result

import json
import os
import subprocess
import sys
import time


def _clocks() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("phase_z_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from indy_plenum_tpu_torch.tpu import sha256 as s2
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import resolve_device

    dev = resolve_device()
    card = cs._nvidia_smi()
    t0 = time.perf_counter()
    kb.library()
    build_s = time.perf_counter() - t0
    refs, lits, offs, _, _ = cs.commit_plan(dev)
    refs_t = torch.from_numpy(np.array(refs)).to(dev)
    lits_t = torch.from_numpy(np.array(lits)).to(dev)

    def k11_ms():
        return [cs._kernel_ms(
            lambda: s2.merkle_plan_hash(refs_t, lits_t, offs), 20)
            for _ in range(3)]

    launches = {name: 0 for name in kb.LAUNCHES}

    def on_card(tag, fn, *args):
        torch.cuda.synchronize()
        kb.reset_launch_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        got = kb.launch_counts()
        missing = [k for k in cs.PATH_KERNELS[tag] if got[k] <= 0]
        if missing:
            raise AssertionError(f"{tag} never launched {missing}")
        for name, count in got.items():
            launches[name] += count
        return out

    readings = {"before": (k11_ms(), _clocks())}
    parts = [("Z1", "socket_z1", cs.run_socket_z1, ())]
    parts += [(f"Z2 {sc}", f"socket_z2_{sc}", cs.run_membership_z2, (sc,))
              for sc in cs.Z2_SCENARIOS]
    parts += [("Z3", "socket_z3", cs.run_cli_z3, ()),
              ("Z4", None, cs.run_processes_z4, ())]
    for name, tag, fn, args in parts:
        if tag is None:
            rec = fn(None, *args)
            for k, v in rec["launches"].items():
                launches[k] += v
        else:
            rec = on_card(tag, fn, None, *args)
        print(json.dumps({"part": name, **rec}, default=str), flush=True)
        readings[f"after {name}"] = (k11_ms(), _clocks())
    print(json.dumps({
        "build_s": build_s,
        "k11_ms": {k: v[0] for k, v in readings.items()},
        "clocks": {k: v[1] for k, v in readings.items()},
        "launches": {k: v for k, v in launches.items() if v},
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
