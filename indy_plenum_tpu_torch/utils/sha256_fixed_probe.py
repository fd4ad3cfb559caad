"""K12's forms on one card, side by side: SHA-256 of fixed-length rows,
the port's kernel (``csrc/sha256.cu`` ``sha256_fixed_kernel``: each
thread's words from aligned 32-bit loads of its row, the next block's in
flight, padding word-wise, unrolled rounds) at every block size and in
its other round and load forms, beside the forms it was measured against: the block's rows staged
into shared memory by 16-byte loads (rolled or unrolled rounds, with and
without the next block in flight) and the form it replaced (one byte load
a padded byte, unrolled rounds). This probe builds them from
``csrc/probe/sha256_fixed_variants.cu`` into a library of its own. Run
from the root of a checkout:

    python3 indy_plenum_tpu_torch/utils/sha256_fixed_probe.py \\
        [--other-csrc DIR]

One JSON line:

- ``ptxas``: what ``nvcc -Xptxas -v`` reports (registers, stack, spill
  stores and loads) for each kernel of the variants' source, and of
  ``DIR/sha256.cu`` where ``--other-csrc`` names another checkout's
  sources;
- ``sass``: each K12 kernel's instruction count, integer ALU
  instructions (``sass_count.int_alu``) and its funnel shifts, byte
  permutes, shared and global loads, for the variants and for
  ``DIR/sha256.cu``;
- ``device_ms``: each form's device time behind a spin
  (``chip_smoke._kernel_ms``) on 4,096 seeded 64-byte rows at 32, 64,
  128 and 256 threads a block, on 4,096 rows of 55, 119 and 200 bytes
  (1, 2 and 4 blocks) at each block size, and on one 64-byte row alone
  (the chain floor, 32 threads);
- ``max_abs_err``: each form at each block size against the plain
  version at every length of ``chip_smoke.SHA_LENGTHS`` and at 57 bytes
  from a base one byte past a 16-byte boundary, bit-equal or the script
  fails;
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

# form: the replaced kernel, then staged words and words loaded from the
# row x unrolled / rolled rounds x the next block in flight
# (csrc/probe/sha256_fixed_variants.cu); "direct_unrolled_pipelined" is
# the port's kernel's body at any block size
FORMS = {"bytes": 0, "unrolled": 1, "rolled": 2, "rolled_pipelined": 3,
         "unrolled_pipelined": 4, "direct_unrolled": 5, "direct_rolled": 6,
         "direct_unrolled_pipelined": 7, "direct_rolled_pipelined": 8}
THREADS = (32, 64, 128, 256)
ROWS = 4096
LENGTHS = (64, 55, 119, 200)
SASS_OPS = ("SHF", "LOP3", "IADD3", "PRMT", "LDS", "LDG", "STS", "BAR")


def _variants_source() -> str:
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    return os.path.join(kb.CSRC_DIR, "probe", "sha256_fixed_variants.cu")


def variant_launcher():
    """``sha256_fixed_variant_launch`` of the variants' own library, built
    once per source into the kernel build directory."""
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import KERNEL_BUILD_DIR

    src = _variants_source()
    digest = hashlib.sha256(kb.source_hash().encode())
    with open(src, "rb") as fh:
        digest.update(fh.read())
    target = os.path.join(KERNEL_BUILD_DIR, "libsha256_fixed_variants_"
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
    fn = ctypes.CDLL(target).sha256_fixed_variant_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_form(launcher, msgs, form: int, threads: int):
    """One form on (B, L) uint8 rows -> (B, 32) uint8."""
    import torch
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    batch, length = msgs.shape
    out = torch.empty((batch, 32), dtype=torch.uint8, device=msgs.device)
    code = launcher(msgs.data_ptr(), out.data_ptr(), batch, length, threads,
                    form, torch.cuda.current_stream(msgs.device).cuda_stream)
    kb.check(code, "sha256_fixed_variant")
    return out


def fixed_sass(source: str) -> dict:
    """{K12 kernel: instructions, int_alu and SASS_OPS counts}."""
    from indy_plenum_tpu_torch.utils.sass_count import count, disassemble, \
        int_alu

    return {kernel: dict({"instructions": sum(hist.values()),
                          "int_alu": int_alu(hist)},
                         **{op: hist.get(op, 0) for op in SASS_OPS})
            for kernel, hist in count(disassemble(source)).items()
            if "sha256_fixed" in kernel}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other-csrc", default=None)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sha256_fixed_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from indy_plenum_tpu_torch.tpu import sha256 as s2
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.sass_count import ptxas_report

    nvcc = kb.find_nvcc()
    src = _variants_source()
    out = {"card": cs._nvidia_smi(), "ptxas": {"this": ptxas_report(src,
                                                                    nvcc)},
           "sass": {"this": fixed_sass(src)},
           "ops_64b_counted": cs.SHA256_64B_OPS}
    if args.other_csrc:
        other = os.path.join(args.other_csrc, "sha256.cu")
        out["ptxas"]["other"] = ptxas_report(other, nvcc)
        out["sass"]["other"] = fixed_sass(other)
    dev = torch.device("cuda")
    launcher = variant_launcher()
    rng = np.random.RandomState(12)
    timed = {length: torch.from_numpy(rng.randint(
        0, 256, (ROWS, length)).astype(np.uint8)).to(dev)
        for length in LENGTHS}
    checks = {f"{length}": torch.from_numpy(rng.randint(
        0, 256, (1024, length)).astype(np.uint8)).to(dev)
        for length in cs.SHA_LENGTHS}
    # 57-byte rows whose base sits one byte past a 16-byte boundary
    raw = torch.from_numpy(rng.randint(0, 256, 1024 * 57 + 16).astype(
        np.uint8)).to(dev)
    checks["57_off1"] = raw[1:1 + 1024 * 57].view(1024, 57)
    plain = {k: s2.sha256_fixed_plain(t) for k, t in checks.items()}
    one = timed[64][:1].contiguous()
    out["device_ms"], out["max_abs_err"] = {}, {}
    for tag, form in FORMS.items():
        out["device_ms"][tag], out["max_abs_err"][tag] = {}, {}
        for threads in THREADS:
            err = cs._max_abs_err([(run_form(launcher, t, form, threads),
                                    plain[k]) for k, t in checks.items()])
            out["max_abs_err"][tag][threads] = err
            if err:
                raise AssertionError(f"K12 form {tag} at {threads} threads "
                                     "differs from plain")
            for length, t in timed.items():
                out["device_ms"][tag][f"{length}_t{threads}"] = \
                    cs._kernel_ms(lambda: run_form(launcher, t, form,
                                                   threads), 20)
        out["device_ms"][tag]["1"] = cs._kernel_ms(
            lambda: run_form(launcher, one, form, 32), 20)
    for digest, row in zip(run_form(launcher, checks["64"], 7, 32).cpu()
                           .numpy()[:64], checks["64"].cpu().numpy()):
        if digest.tobytes() != hashlib.sha256(row.tobytes()).digest():
            raise AssertionError("K12 disagrees with hashlib")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
