"""K-a's forms on one card, side by side: SHA-512 over the ingress drain's
padded blocks, the port's kernel (``csrc/sha512.cu``
``sha512_blocks_kernel``: rounds 16..79 rolled, 16-byte loads with the
next block in flight) beside the forms it was measured against: every
round unrolled, 8-byte loads when a block starts, and the form it
replaced (constants staged from an operand into shared memory, 8-byte
loads). This probe builds them from ``csrc/probe/sha512_variants.cu``
into a library of its own. Run from the root of a checkout:

    python3 indy_plenum_tpu_torch/utils/sha512_probe.py [--other-csrc DIR]

One JSON line:

- ``ptxas``: what ``nvcc -Xptxas -v`` reports (registers, stack, spill
  stores and loads) for each kernel of the variants' source, and of
  ``DIR/sha512.cu`` where ``--other-csrc`` names another checkout's
  sources;
- ``sass``: each SHA-512 kernel's instruction count, integer ALU
  instructions (``sass_count.int_alu``) and its funnel shifts, 3-input
  logic ops, adds, shared and global loads, for the variants and for
  ``DIR/sha512.cu``; K-a's hand count (``chip_smoke.SHA512_OPS_PER_BLOCK``)
  is per block, the SASS per kernel body;
- ``device_ms``: each form's device time behind a spin
  (``chip_smoke._kernel_ms``) at the drain's 8,192 messages of 2 blocks
  and at ``bench.py``'s 32,768 (the drain four times), at 32, 64, 128 and
  256 threads a block, and on one message alone (the chain floor, 32
  threads);
- ``max_abs_err``: each form at each block size against the plain version
  on the drain, bit-equal or the script fails;
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

# form: the replaced kernel, then unrolled / rolled rounds x 8-byte loads
# / the next block in flight (csrc/probe/sha512_variants.cu); the last is
# the port's kernel
FORMS = {"staged": 0, "unrolled": 1, "rolled": 2, "unrolled_pipelined": 3,
         "rolled_pipelined": 4}
THREADS = (32, 64, 128, 256)
SASS_OPS = ("SHF", "LOP3", "IADD3", "PRMT", "LDS", "LDG", "STG", "BAR")


def _variants_source() -> str:
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    return os.path.join(kb.CSRC_DIR, "probe", "sha512_variants.cu")


def variant_launcher():
    """``sha512_variant_launch`` of the variants' own library, built once
    per source into the kernel build directory."""
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import KERNEL_BUILD_DIR

    src = _variants_source()
    digest = hashlib.sha256(kb.source_hash().encode())
    with open(src, "rb") as fh:
        digest.update(fh.read())
    target = os.path.join(KERNEL_BUILD_DIR, "libsha512_variants_"
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
    fn = ctypes.CDLL(target).sha512_variant_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_form(launcher, blocks, counts, consts, form: int, threads: int):
    """One form on (B, NB, 128) blocks and (B,) counts -> (B, 64) uint8."""
    import torch
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    batch, nb, _ = blocks.shape
    out = torch.empty((batch, 64), dtype=torch.uint8, device=blocks.device)
    code = launcher(blocks.data_ptr(), counts.data_ptr(), out.data_ptr(),
                    consts.data_ptr(), batch, nb, threads, form,
                    torch.cuda.current_stream(blocks.device).cuda_stream)
    kb.check(code, "sha512_variant")
    return out


def sha_sass(source: str) -> dict:
    """{SHA-512 kernel: instructions, int_alu and SASS_OPS counts}."""
    from indy_plenum_tpu_torch.utils.sass_count import count, disassemble, \
        int_alu

    return {kernel: dict({"instructions": sum(hist.values()),
                          "int_alu": int_alu(hist)},
                         **{op: hist.get(op, 0) for op in SASS_OPS})
            for kernel, hist in count(disassemble(source)).items()
            if "sha512" in kernel}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other-csrc", default=None)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sha512_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from indy_plenum_tpu_torch.tpu import sha512 as s5
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.sass_count import ptxas_report

    nvcc = kb.find_nvcc()
    src = _variants_source()
    out = {"card": cs._nvidia_smi(), "ptxas": {"this": ptxas_report(src,
                                                                    nvcc)},
           "sass": {"this": sha_sass(src)},
           "ops_per_block_counted": cs.SHA512_OPS_PER_BLOCK}
    if args.other_csrc:
        other = os.path.join(args.other_csrc, "sha512.cu")
        out["ptxas"]["other"] = ptxas_report(other, nvcc)
        out["sass"]["other"] = sha_sass(other)
    dev = torch.device("cuda")
    launcher = variant_launcher()
    consts = torch.from_numpy(s5._as_int64(s5._K64 + s5._H064)).to(dev)
    signers, reqs = cs.make_signed_requests(seed=64)
    _, arrays = cs.verify_inputs(signers, reqs, np.random.RandomState(7),
                                 cs.DRAIN)
    blocks_np, counts_np = cs.sha_drain_blocks(arrays, reqs)
    big_n = cs.BENCH_VERIFY_BATCH // cs.DRAIN
    shapes = {
        str(cs.DRAIN): (torch.from_numpy(blocks_np).to(dev),
                        torch.from_numpy(counts_np).to(dev)),
        str(cs.BENCH_VERIFY_BATCH): (
            torch.from_numpy(blocks_np).to(dev).repeat(big_n, 1, 1),
            torch.from_numpy(counts_np).to(dev).repeat(big_n)),
        "1": (torch.from_numpy(blocks_np[:1]).to(dev),
              torch.from_numpy(counts_np[:1]).to(dev))}
    plain = s5.sha512_blocks_plain(*shapes[str(cs.DRAIN)])
    out["device_ms"], out["max_abs_err"] = {}, {}
    for tag, form in FORMS.items():
        out["device_ms"][tag], out["max_abs_err"][tag] = {}, {}
        for threads in THREADS:
            got = run_form(launcher, *shapes[str(cs.DRAIN)], consts, form,
                           threads)
            err = cs._max_abs_err([(got, plain)])
            out["max_abs_err"][tag][threads] = err
            if err:
                raise AssertionError(f"K-a form {tag} at {threads} threads "
                                     "differs from plain")
            for shape in (str(cs.DRAIN), str(cs.BENCH_VERIFY_BATCH)):
                out["device_ms"][tag][f"{shape}_t{threads}"] = cs._kernel_ms(
                    lambda: run_form(launcher, *shapes[shape], consts, form,
                                     threads), 20)
        out["device_ms"][tag]["1"] = cs._kernel_ms(
            lambda: run_form(launcher, *shapes["1"], consts, form, 32), 20)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
