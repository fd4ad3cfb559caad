"""K10's compression variants on one card, side by side: the audit-path
fold (``csrc/sha256.cu`` ``audit_fold_kernel``) with its node hash's two
compressions rolled (48 scheduled rounds as three loop iterations of 16:
the library's) or fully unrolled (the form K11 keeps). This probe
builds both from ``csrc/probe/audit_fold_variants.cu`` into a library of
its own. Run from the root of a checkout:

    python3 indy_plenum_tpu_torch/utils/audit_fold_probe.py \\
        [--other-csrc DIR]

One JSON line:

- ``ptxas``: what ``nvcc -Xptxas -v`` reports (registers, stack, spill
  stores and loads) for each kernel of the variants' source, and of
  ``DIR/sha256.cu`` where ``--other-csrc`` names another checkout's
  sources (the kernel before its redesign);
- ``sass``: each fold kernel's SASS instruction count and its funnel
  shifts (``SHF``: six rotates a round and four a scheduled word, so
  their count says how many round bodies the code holds), for the
  variants and for ``DIR/sha256.cu``;
- ``device_ms``: each variant's device time behind a spin
  (``chip_smoke._kernel_ms``) on one 4,096-proof chunk of the
  catchup-proof tree (17 levels, indexed) and on one proof of it alone
  (the dependent chain: one thread's 17 node hashes and the launch);
- ``max_abs_err``: each variant against the plain version on the chunk,
  bit-equal or the script fails;
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


def _variants_source() -> str:
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    return os.path.join(kb.CSRC_DIR, "probe", "audit_fold_variants.cu")


def variant_launcher():
    """``audit_fold_variant_launch`` of the variants' own library, built
    once per source into the kernel build directory."""
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import KERNEL_BUILD_DIR

    src = _variants_source()
    digest = hashlib.sha256(kb.source_hash().encode())
    with open(src, "rb") as fh:
        digest.update(fh.read())
    target = os.path.join(KERNEL_BUILD_DIR, "libaudit_fold_variants_"
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
    fn = ctypes.CDLL(target).audit_fold_variant_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_variant(launcher, args, rolled: bool, threads: int):
    """One variant on the indexed fold's CUDA operands -> (B,) bool."""
    import torch
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    dev = args[0].device
    batch = args[0].shape[0]
    ok = torch.empty(batch, dtype=torch.uint8, device=dev)
    code = launcher(*[t.data_ptr() for t in args], ok.data_ptr(), batch,
                    args[3].shape[1], threads, int(rolled),
                    torch.cuda.current_stream(dev).cuda_stream)
    kb.check(code, "audit_fold_variant")
    return ok.bool()


def fold_sass(source: str) -> dict:
    """{fold kernel: (instructions, SHF)} of one source's SASS."""
    from indy_plenum_tpu_torch.utils.sass_count import count, disassemble

    return {kernel: (sum(hist.values()), hist.get("SHF", 0))
            for kernel, hist in count(disassemble(source)).items()
            if "audit_fold_kernel" in kernel}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other-csrc", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("audit_fold_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from indy_plenum_tpu_torch.server.catchup import catchup_rep_service \
        as crs
    from indy_plenum_tpu_torch.tpu import sha256 as s2
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.sass_count import ptxas_report

    nvcc = kb.find_nvcc()
    src = _variants_source()
    out = {"card": cs._nvidia_smi(), "ptxas": {"this": ptxas_report(src,
                                                                    nvcc)},
           "sass": {"this": fold_sass(src)}}
    if args.other_csrc:
        other = os.path.join(args.other_csrc, "sha256.cu")
        out["ptxas"]["other"] = ptxas_report(other, nvcc)
        out["sass"]["other"] = fold_sass(other)
    dev = torch.device("cuda")
    launcher = variant_launcher()
    chunk = crs._ChunkedDeviceVerify.CHUNK
    tree, leaf_data, indices, paths = cs.audit_corpus(count=chunk)
    t = cs._fold_inputs(dev, leaf_data, indices, paths,
                        [tree.tree_size] * chunk, [tree.root_hash] * chunk)
    idx = [t[k] for k in ("leaf", "index", "table", "path_idx", "path_len",
                          "tree_size", "root")]
    one = [a if a is t["table"] else a[:1] for a in idx]
    plain = s2.verify_audit_paths_indexed_plain(*idx)
    out["device_ms"], out["max_abs_err"] = {}, {}
    for rolled in (True, False):
        tag = "rolled" if rolled else "unrolled"

        def run(operands):
            return run_variant(launcher, operands, rolled, s2.AUDIT_THREADS)

        err = cs._max_abs_err([(run(idx), plain)])
        out["max_abs_err"][tag] = err
        if err:
            raise AssertionError(f"K10 variant {tag} differs from plain")
        out["device_ms"][tag] = {
            f"{chunk}": cs._kernel_ms(lambda: run(idx), 20),
            "1": cs._kernel_ms(lambda: run(one), 20)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
