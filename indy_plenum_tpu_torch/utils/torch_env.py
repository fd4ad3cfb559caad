"""Device choice and deterministic flags for the port.

Counterpart of ``indy_plenum_tpu/utils/jax_env.py``: where the JAX package
provisions XLA's host platform, the port picks its torch device. The rule
is the same for every entry point (``CoreAuthNr``, ``VotePlaneGroup``,
``DeviceVotePlane``, ``batch_verify``):

- no ``device`` argument means the CUDA card;
- without a CUDA device that raises; nothing carries on quietly on the CPU;
- ``device="cpu"`` runs the plain PyTorch versions of every kernel (the
  CPU tests and the reference side of ``chip_smoke.py``).
"""
from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

# where utils.kernel_build puts the compiled kernel library: inside the
# package, listed in .gitignore, rebuilt when the sources' hash changes
KERNEL_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_kernel_build")


class NoCudaDevice(RuntimeError):
    """A CUDA entry point was asked for, and this process has no card."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the plain versions. Raises
    :class:`NoCudaDevice` when CUDA is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDevice(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_deterministic() -> None:
    """Deterministic flags for reference runs: no TF32 anywhere, no
    cuDNN autotuning, and PyTorch's deterministic algorithms (warn-only,
    so an op without a deterministic CUDA implementation reports itself
    instead of aborting a run). The port's own arithmetic is integer and
    exact; the flags keep any float helper reproducible too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)



def parse_mesh_shape(spec) -> tuple:
    """Parse a ``--mesh`` value into a fabric mesh shape: ``"8"`` ->
    ``(8,)`` (member-sharded), ``"4x2"`` -> ``(4, 2)`` (the member x
    validator fabric). Raises ValueError on anything else. Copy of
    ``indy_plenum_tpu/utils/jax_env.py:parse_mesh_shape``."""
    dims = tuple(int(p) for p in str(spec).lower().split("x"))
    if not 1 <= len(dims) <= 2 or any(d < 1 for d in dims):
        raise ValueError(f"mesh shape must be M or MxV with dims >= 1: "
                         f"{spec!r}")
    return dims


def mesh_devices(shape) -> int:
    """Tile count a fabric mesh shape needs (the reference's device
    count)."""
    n = 1
    for d in shape:
        n *= d
    return n
