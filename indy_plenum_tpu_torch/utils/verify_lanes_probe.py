"""K-c's launch variants on one card, side by side: the lanes of a warp
that share a signature (2 or 4) and where the table of multiples of -A
lives (shared or local memory). The port's library launches one variant
(``csrc/ed25519.cu``); this probe builds all four from
``csrc/probe/ed25519_variants.cu`` into a library of its own. Run from the
root of a checkout:

    python3 indy_plenum_tpu_torch/utils/verify_lanes_probe.py \\
        [--other-csrc DIR]

One JSON line:

- ``ptxas``: what ``nvcc -Xptxas -v`` reports (registers, stack, spill
  stores and loads) for each kernel of the variants' source, and of
  ``DIR/ed25519.cu`` where ``--other-csrc`` names another checkout's
  sources (the kernel before its redesign);
- ``device_ms``: each variant's device time behind a spin
  (``chip_smoke._kernel_ms``) at the ingress drain's 8,192 signatures
  (``chip_smoke.verify_inputs``: RFC vectors, signed requests, planted
  faults) and at ``bench.py``'s 32,768 (the drain four times);
- ``max_abs_err``: each variant against the plain version at 8,192, at
  32,768 and on the batches of 1, 3 and 7 at the drain's head (groups
  past the batch), bit-equal or the script fails;
- the card's name and power limit.

It exits non-zero without a card or ``nvcc``.
"""
from __future__ import annotations

# da: allow-file[device-sync,nondet-source] -- a measuring tool: its clocks and syncs time kernels for a report and never feed a result

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

VARIANTS = ((4, True), (4, False), (2, True), (2, False))


def _variants_source() -> str:
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    return os.path.join(kb.CSRC_DIR, "probe", "ed25519_variants.cu")


def variant_launcher():
    """``ed25519_verify_variant_launch`` of the variants' own library,
    built once per source into the kernel build directory."""
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import KERNEL_BUILD_DIR

    src = _variants_source()
    digest = hashlib.sha256(kb.source_hash().encode())
    with open(src, "rb") as fh:
        digest.update(fh.read())
    target = os.path.join(KERNEL_BUILD_DIR, "libed25519_variants_"
                          f"{digest.hexdigest()[:16]}.so")
    if not os.path.exists(target):
        os.makedirs(KERNEL_BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [kb.find_nvcc(), *kb.NVCC_FLAGS, "-shared", "-o", tmp, src,
             "-I", kb.CSRC_DIR], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise kb.KernelBuildError(
                f"nvcc failed on {src}: {proc.stderr[-2000:]}")
        os.replace(tmp, target)
    fn = ctypes.CDLL(target).ed25519_verify_variant_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_variant(launcher, tensors, lanes: int, shared: bool):
    """One variant on (pk, R, S, h) CUDA tensors -> (B,) bool verdicts."""
    import torch
    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    dev = tensors[0].device
    ok = torch.empty(tensors[0].shape[0], dtype=torch.bool, device=dev)
    code = launcher(*[t.data_ptr() for t in tensors], ok.data_ptr(),
                    ted._kernel_consts(dev).data_ptr(), tensors[0].shape[0],
                    lanes, int(shared),
                    torch.cuda.current_stream(dev).cuda_stream)
    kb.check(code, "ed25519_verify_variant")
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other-csrc", default=None)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("verify_lanes_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.sass_count import ptxas_report

    nvcc = kb.find_nvcc()
    out = {"card": cs._nvidia_smi(),
           "ptxas": {"this": ptxas_report(_variants_source(), nvcc)}}
    if args.other_csrc:
        out["ptxas"]["other"] = ptxas_report(
            os.path.join(args.other_csrc, "ed25519.cu"), nvcc)
    dev = torch.device("cuda")
    launcher = variant_launcher()
    rng = np.random.RandomState(20261016)
    signers, reqs = cs.make_signed_requests(seed=64)
    _, arrays = cs.verify_inputs(signers, reqs, rng, cs.DRAIN)
    drain = [torch.from_numpy(a).to(dev) for a in arrays]
    big = [t.repeat(cs.BENCH_VERIFY_BATCH // cs.DRAIN, 1) for t in drain]
    plain = ted.verify_kernel_plain(*drain)

    out["device_ms"], out["max_abs_err"] = {}, {}
    for lanes, shared in VARIANTS:
        tag = f"{lanes}_lanes_{'shared' if shared else 'local'}"

        def run(tensors):
            return run_variant(launcher, tensors, lanes, shared)

        pairs = [(run(drain), plain), (run(big), plain.repeat(4))]
        for n in (1, 3, 7):
            pairs.append((run([t[:n].contiguous() for t in drain]),
                          plain[:n]))
        err = cs._max_abs_err(pairs)
        out["max_abs_err"][tag] = err
        if err:
            raise AssertionError(f"K-c variant {tag} differs from plain")
        out["device_ms"][tag] = {"8192": cs._kernel_ms(lambda: run(drain),
                                                       10),
                                 "32768": cs._kernel_ms(lambda: run(big), 5)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
