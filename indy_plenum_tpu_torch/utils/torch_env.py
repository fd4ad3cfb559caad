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
from typing import List, Optional, Sequence, Union

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
        elif dev.index >= torch.cuda.device_count():
            raise ValueError(f"{dev}: this process sees "
                             f"{torch.cuda.device_count()} card(s)")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_list(device: DeviceLike = None,
                count: Optional[int] = None) -> List[torch.device]:
    """The devices a fabric mesh can take, the counterpart of
    ``jax.devices()``: every visible card (``cuda:0`` .. ``cuda:n-1``;
    :class:`NoCudaDevice` without one), or ``count`` (default 1) times
    the CPU when ``device="cpu"``, which a mesh built with ``split=True``
    spreads its tiles over (the CPU tests' stand-in for several cards).
    ``count`` with cards asks for that many of them, and raises when
    fewer are visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * (1 if count is None else int(count))
    resolve_device(dev)
    have = torch.cuda.device_count()
    want = have if count is None else int(count)
    if want > have:
        raise ValueError(f"{want} cards asked for, {have} visible")
    return [torch.device("cuda", i) for i in range(want)]


def require_peer_access(devices: Sequence[torch.device]) -> None:
    """Raise ``RuntimeError`` unless every pair of distinct cards in
    ``devices`` can read each other's memory
    (``cudaDeviceCanAccessPeer``). A fabric's cross-card moves (partial
    counts, verdicts, ring steps) run card to card or not at all: never
    through the host. CPU devices and repeats of one card need nothing."""
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(
                    f"cuda:{a} cannot read cuda:{b}'s memory (no peer "
                    "access): a fabric over these cards would route "
                    "through the host")


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
