"""Build and load the port's CUDA kernels (one shared library, plain C ABI).

Every ``.cu`` under ``indy_plenum_tpu_torch/csrc/`` is compiled by its own
``nvcc -c`` process (all started together), then linked into one shared
library that :mod:`ctypes` loads. No PyTorch headers are included, so a
cold build takes seconds. The library lands in
``utils.torch_env.KERNEL_BUILD_DIR`` under a name derived from the hash of
the sources and flags: an edited source is rebuilt at its next first use,
an unchanged one is loaded as it is.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception. Each kernel wrapper
counts its launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

# da: allow-file[nondet-source] -- a measuring tool: the build's wall clock is reported (last_build_seconds) and never feeds a result

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

from .torch_env import KERNEL_BUILD_DIR

CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# launches per kernel wrapper: a wrapper adds one where it launches its
# kernel, and nowhere else (the plain versions never count)
LAUNCHES: Dict[str, int] = {
    "sha512_blocks": 0,
    "reduce_mod_l": 0,
    "ed25519_verify": 0,
    "quorum_step": 0,
    "resident_step": 0,
    "fused_step": 0,
    "window_slide": 0,
    "window_zero": 0,
    "sha256_fixed": 0,
    "merkle_node_hash": 0,
    "audit_paths": 0,
    "audit_paths_indexed": 0,
    "fabric_step": 0,
    "resident_tile": 0,
    "sharded_fused_step": 0,
    "ring_shift": 0,
    "rotate_merge": 0,
    # the per-tile layout (tpu/quorum.py TileState): the tile kernel's
    # partials mode (non-home tiles) and home form (the decide), K1's
    # peer form and the split K14's verifies (K-c on each validator tile)
    "resident_partials": 0,
    "resident_home": 0,
    "ring_peer": 0,
    "sharded_fused_split": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/*.cu's extern "C" entry points
_SIGNATURES = {
    # blocks, n_blocks, out, batch, nb, stream
    "sha512_blocks_launch": (_P, _P, _P, _I, _I, _P),
    # h, out, Barrett constants (L, mu), batch, stream
    "reduce_mod_l_launch": (_P, _P, _P, _I, _P),
    # pk, R, S, h, ok, consts, batch, stream
    "ed25519_verify_launch": (_P, _P, _P, _P, _P, _P, _I, _P),
    "fused_step_launch": (
        # pk, R, S, h, ok, consts, batch (as ed25519_verify)
        _P, _P, _P, _P, _P, _P, _I,
        # state (as quorum_step), words (1, B), N, S, C, n_validators,
        # delta_cap
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        # the output allocation (as quorum_step), the stream's ticket,
        # the stream
        _P, _P, _P),
    "quorum_step_launch": (
        # state: pp, prepare, commit, checkpoint, ordered, acked, frontier
        _P, _P, _P, _P, _P, _P, _P,
        # words, M, N, S, C, W, n_validators, delta_cap, compact
        _P, _I, _I, _I, _I, _I, _I, _I, _I,
        # the one output allocation (events, compact record, frontier
        # snapshot: quorum_common.cuh events_at), then the stream
        _P, _P),
    "fabric_step_launch": (
        # state (as quorum_step), words
        _P, _P, _P, _P, _P, _P, _P, _P,
        # M, N, S, C, W, v, cluster blocks, n_validators, delta_cap,
        # compact
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        # the output allocation (as quorum_step), then the stream
        _P, _P),
    "resident_tile_launch": (
        # state (as quorum_step), slides (k, M), words (k, M, W)
        _P, _P, _P, _P, _P, _P, _P, _P, _P,
        # k, M, N, S, C, W, v, cluster blocks, n_validators, delta_cap
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        # the output allocation (as quorum_step), then the stream
        _P, _P),
    "resident_partials_launch": (
        # state (as quorum_step), slides (k, M) or null, words, verdict
        # bytes (M, W) or null
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        # k, M, N, S, C, W, row0, cluster blocks
        _I, _I, _I, _I, _I, _I, _I, _I,
        # the tile's (M, 2S + C) int32 partials (this card or a peer's),
        # then the stream
        _P, _P),
    "resident_home_launch": (
        # state (as quorum_step), slides (k, M) or null, words, verdict
        # bytes (M, W) or null
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        # k, M, N, S, C, W, cluster blocks, n_validators, delta_cap,
        # compact
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        # the other tiles' (n, M, 2S + C) int32 partials or null, n
        _P, _I,
        # the output allocation (as quorum_step), then the stream
        _P, _P),
    # device ordinal, peer ordinal: cudaDeviceEnablePeerAccess
    "enable_peer_access": (_I, _I),
    # S, C, K13's instantiation (0/1), host int out: the blocks one SM
    # holds
    "resident_tile_occupancy": (_I, _I, _I, _P),
    # host table of (src, dst, row_bytes) per leaf, leaves, rows,
    # shift_rows, stream
    "ring_shift_launch": (_P, _I, _I, _I, _P),
    # host table of (a, b, dst, row_bytes) per leaf, leaves, rows,
    # shard_rows, s, stream
    "rotate_merge_launch": (_P, _I, _I, _I, _I, _P),
    # state (as quorum_step), device deltas or mask, M, N, S, C, stream
    "window_slide_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _P),
    "window_zero_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _P),
    # state (as quorum_step), host int32 (row, delta) pairs, n_pairs, N,
    # S, C, stream
    "window_slide_pairs_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _P),
    # state (as quorum_step), host int32 rows of the reset members,
    # n_rows, N, S, C, stream
    "window_zero_rows_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _P),
    # msg, out, batch, msg_len, stream
    "sha256_fixed_launch": (_P, _P, _I, _I, _P),
    # refs, literals, out, host level offsets, n_levels, blocks, stream
    "merkle_plan_launch": (_P, _P, _P, _P, _I, _I, _P),
    # leaf, index, path, path_len, tree_size, root, ok, batch, depth,
    # threads a block, stream
    "audit_paths_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # leaf, index, table, path_idx, path_len, tree_size, root, ok, batch,
    # depth, threads a block, stream
    "audit_paths_indexed_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing, or a source did not compile or link."""


class KernelLaunchError(RuntimeError):
    """A kernel's launch was refused (``cudaGetLastError() != 0``)."""


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    candidates.append(NVCC_DEFAULT)
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the "
            "CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def source_hash() -> str:
    """Hash of every ``.cu``/``.cuh`` source and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                       + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(verbose: bool = False) -> str:
    """Compile every source in parallel and link the shared library;
    returns its path. Raises :class:`KernelBuildError`."""
    global last_build_seconds
    nvcc = find_nvcc()
    os.makedirs(KERNEL_BUILD_DIR, exist_ok=True)
    target = os.path.join(KERNEL_BUILD_DIR,
                          f"libindy_kernels_{source_hash()}.so")
    if os.path.exists(target):
        return target
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="build_", dir=KERNEL_BUILD_DIR)
    try:
        procs = []
        objs = []
        for src in _sources():
            obj = os.path.join(
                work, os.path.basename(src).replace(".cu", ".o"))
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, _run(cmd)))
        failures = []
        logs = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failures.append(f"{os.path.basename(src)}:\n{out}")
        if failures:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
        tmp_lib = os.path.join(work, "lib.so")
        link = _run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_lib])
        out, _ = link.communicate()
        if link.returncode != 0:
            raise KernelBuildError("nvcc link failed:\n" + out)
        os.replace(tmp_lib, target)  # atomic: a reader never sees half
        if verbose:
            print("".join(logs))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    last_build_seconds = time.perf_counter() - t0
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


_PEERS = set()  # (device, peer) ordinals whose access is enabled


def enable_peer_access(dev: int, peer: int) -> None:
    """Let kernels on card ``dev`` read card ``peer``'s memory (once per
    pair and process); raises :class:`KernelLaunchError` on any CUDA
    error. A card is its own peer."""
    if dev == peer or (dev, peer) in _PEERS:
        return
    check(library().enable_peer_access(dev, peer),
          f"enable_peer_access({dev}, {peer})")
    _PEERS.add((dev, peer))


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise KernelLaunchError(
            f"{name}: CUDA error {code} at launch")
