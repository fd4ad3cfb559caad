"""Member-plane migration between fabric blocks: the ring shift (K1).

Port of ``indy_plenum_tpu/tpu/ring_exchange.py``. The reference moves
whole member-shard blocks of the vote planes one ring step along mesh
axis 0, device to device: ``ring_shift_reference`` (``:47``, a
``lax.ppermute``) is the oracle and a Pallas RDMA ring permute
(``_ring_kernel`` ``:67``, ``pl.pallas_call`` ``:101``, the repo's only
Pallas kernel) the TPU path.

In the one-device layout every block of the fabric lives on ONE device
(see :class:`~indy_plenum_tpu_torch.tpu.quorum.FabricMesh`), and member
blocks are contiguous rows of each member-stacked leaf, so moving block b
to block (b + shift) mod m is a roll of the member axis by shift x R rows.
:func:`ring_shift_plain` is that roll in PyTorch; :func:`ring_shift_planes`
launches K1 (``csrc/ring.cu`` ``ring_shift_kernel``: every leaf in one
launch, out of place, any dtype, any shift, either mesh rank) for CUDA
tensors and raises for anything but the CPU or a card. The reference's
off-TPU fallback to the ppermute path has no counterpart: a CUDA tensor
reaches the kernel or the call raises. :func:`ring_shift_rows` is the same
roll by any number of rows, the one-device rotation of
:func:`~.rebalance.rotate_planes`.

In the per-tile layout (a :class:`~indy_plenum_tpu_torch.tpu.quorum.
TileState`) tile (i, j) moves whole to tile ((i + shift) mod m, j): K1's
peer form (:func:`peer_copy`), the counterpart of the reference's RDMA
kernel (``:67``), launched on each destination tile's device with its
leaf table pointing at the source tile on the ring neighbour's device,
read through peer access; on one card the same launch reads local
pointers.

``states`` is any member-leading tensor or tuple of them (a
:class:`~indy_plenum_tpu_torch.tpu.quorum.VoteState` stack included);
state carried per member on the host (h, mirrors) is the caller's to
rotate.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import kernel_build as kb
from .quorum import (FabricMesh, TileState, VoteState, as_fabric,
                     check_tiles, on_device)


def leaves_of(states):
    """(list of leaves, rebuild(list) -> the same structure)."""
    if isinstance(states, torch.Tensor):
        return [states], lambda ls: ls[0]
    cls = type(states)
    if hasattr(states, "_fields"):  # a NamedTuple such as VoteState
        return list(states), lambda ls: cls(*ls)
    return list(states), lambda ls: cls(ls)


def _block_rows(leaves, mesh: FabricMesh) -> int:
    rows = leaves[0].shape[0]
    if any(x.shape[0] != rows for x in leaves):
        raise ValueError("ring shift: every leaf leads with the member axis")
    if rows % mesh.m_shards:
        raise ValueError(f"ring shift: {rows} member rows do not split into "
                         f"{mesh.m_shards} blocks")
    return rows // mesh.m_shards


def ring_shift_plain(states, mesh: FabricMesh, shift: int = 1):
    """The plain version of K1 (the reference's ``ring_shift_reference``):
    member block b of every leaf moves to block (b + shift) mod m, a roll
    of the member axis by ``shift`` x R rows; new tensors."""
    mesh = as_fabric(mesh)
    leaves, rebuild = leaves_of(states)
    r = _block_rows(leaves, mesh)
    return rebuild([torch.roll(x, shift * r, dims=0) for x in leaves])


def _ring_kernel(leaves, rows: int, shift_rows: int):
    """One ``ring_shift_kernel`` launch rolling every leaf by
    ``shift_rows`` rows."""
    dev = leaves[0].device
    outs, table = [], []
    for x in leaves:
        if x.device != dev or not x.is_contiguous() or x.shape[0] != rows:
            raise ValueError(f"ring shift: every leaf must be a contiguous "
                             f"tensor of {rows} member rows on {dev}")
        out = torch.empty_like(x)
        outs.append(out)
        table += [x.data_ptr(), out.data_ptr(),
                  x.element_size() * (x.numel() // rows)]
    host = np.array(table, np.int64)
    code = kb.library().ring_shift_launch(
        host.ctypes.data, len(leaves), rows, shift_rows,
        torch.cuda.current_stream(dev).cuda_stream)
    kb.check(code, "ring_shift")
    kb.LAUNCHES["ring_shift"] += 1
    return outs


def ring_shift_rows(states, rows: int):
    """K1 as a roll of the member axis by ``rows`` rows (row r's plane
    moves to row ``(r + rows) % M``) of every leaf, out of place; a roll
    by a multiple of M returns ``states`` itself. CPU tensors take
    ``torch.roll``; CUDA tensors launch ``ring_shift_kernel`` once for
    every leaf, or raise."""
    leaves, rebuild = leaves_of(states)
    total = leaves[0].shape[0]
    if int(rows) % total == 0:
        return states
    dev = leaves[0].device.type
    if dev == "cpu":
        return rebuild([torch.roll(x, int(rows), dims=0) for x in leaves])
    if dev != "cuda":
        raise ValueError(f"ring shift: unsupported device {leaves[0].device}")
    return rebuild(_ring_kernel(leaves, total, int(rows) % total))


def peer_copy_plain(tile: VoteState, dev) -> VoteState:
    """The plain version of K1's peer form: every leaf of ``tile`` copied
    to ``dev``."""
    return VoteState(*[x.to(dev, copy=True) for x in tile])


def peer_copy(tile: VoteState, dev: torch.device) -> VoteState:
    """K1's peer form: a new tile on ``dev`` holding ``tile``'s leaves. CPU
    tensors take :func:`peer_copy_plain`; on the card it is ONE
    ``ring_shift_kernel`` launch (offset 0: one linear segment a leaf) on
    ``dev``, its leaf table pointing at ``tile`` on its own card, read
    through peer access (enabled once a pair). The launch waits for
    ``tile``'s card's current stream, and that stream waits for the
    launch before any later work there (the source may be freed or
    rewritten then)."""
    src = tile.frontier.device
    if src.type == "cpu":
        return peer_copy_plain(tile, dev)
    if src.type != "cuda" or dev.type != "cuda":
        raise ValueError(f"ring peer copy: {src} -> {dev}")
    rows = tile.frontier.shape[0]
    for x in tile:
        if x.device != src or not x.is_contiguous() or x.shape[0] != rows:
            raise ValueError(f"ring peer copy: every leaf a contiguous "
                             f"tensor of {rows} member rows on {src}")
    kb.enable_peer_access(dev.index, src.index)
    outs = [torch.empty_like(x, device=dev) for x in tile]
    with on_device(dev):
        stream = torch.cuda.current_stream(dev)
        if src != dev:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(src))
            stream.wait_event(ready)
        table = []
        for x, out in zip(tile, outs):
            table += [x.data_ptr(), out.data_ptr(),
                      x.element_size() * (x.numel() // rows)]
        host = np.array(table, np.int64)
        code = kb.library().ring_shift_launch(
            host.ctypes.data, len(outs), rows, 0, stream.cuda_stream)
        kb.check(code, "ring_peer")
        kb.LAUNCHES["ring_peer"] += 1
        if src != dev:
            done = torch.cuda.Event()
            done.record(stream)
            torch.cuda.current_stream(src).wait_event(done)
    return VoteState(*outs)


def ring_shift_tiles(states: TileState, mesh: FabricMesh,
                     shift: int = 1) -> TileState:
    """The ring shift of the per-tile layout: tile (i, j) -> tile ((i +
    shift) mod m, j), each by :func:`peer_copy` onto the destination
    tile's device; a new TileState."""
    check_tiles(mesh, states)
    m, v = states.m, states.v
    moved = [None] * len(states.tiles)
    for i in range(m):
        d = (i + shift) % m
        for j in range(v):
            moved[d * v + j] = peer_copy(states.tile(i, j),
                                         mesh.tile_device(d, j))
    return TileState(moved, v)


def ring_shift_planes(states, mesh: FabricMesh, shift: int = 1):
    """K1: migrate member blocks ``shift`` ring steps along mesh axis 0 (the
    reference's dispatcher, ``ring_exchange.py:127``). A shift that is a
    multiple of m is the identity and returns ``states`` itself
    (``:134-135``). In the per-tile layout ``states`` is a TileState and
    the shift :func:`ring_shift_tiles`. Otherwise CPU tensors take
    :func:`ring_shift_plain`; CUDA tensors launch ``ring_shift_kernel``
    once for every leaf, or raise."""
    mesh = as_fabric(mesh)
    if shift % mesh.m_shards == 0:
        return states
    if mesh.split:
        return ring_shift_tiles(states, mesh, shift)
    leaves, _ = leaves_of(states)
    r = _block_rows(leaves, mesh)
    if leaves[0].device.type == "cpu":
        return ring_shift_plain(states, mesh, shift)
    return ring_shift_rows(states, shift * r)
