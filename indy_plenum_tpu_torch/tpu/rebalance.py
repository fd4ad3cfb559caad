"""Occupancy-driven member-plane rebalancing for the vote fabric.

Port of ``indy_plenum_tpu/tpu/rebalance.py``. :class:`RebalancePolicy` is
the reference's (``:44-182``), copied: a deterministic skew-threshold /
dwell law over the governor's per-cell occupancy EWMAs that plans a
ROTATION of the member planes along mesh axis 0, in device rows, which the
:class:`~indy_plenum_tpu_torch.tpu.vote_plane.VotePlaneGroup` executes at
its next checkpoint-boundary slide (the barrier where the residency ring
is drained). Its docstrings are the reference's; its arithmetic is
unchanged, so a seeded run plans the same rotations in both packages.

:func:`rotate_planes` (``:184-221``) moves every member plane ``rows``
rows. The reference runs the ring shift (K1) by b and by b + 1 for ``rows
= b R + s``, then the shard-local merge (K15): new local row r takes the b
arm's row r - s when r >= s, the (b + 1) arm's row r - s + R otherwise.
The per-tile layout runs that shape: two K1 shifts of the tiles (K1's
peer form), then :func:`rotate_merge` (K15, ``csrc/ring.cu``
``rotate_merge_kernel``) on every tile, on its device. In the one-device
layout every tile lives in one state, so the rotation is one K1 roll of
every leaf by ``rows`` rows (:func:`~.ring_exchange.ring_shift_rows`);
:func:`rotate_planes_plain` keeps the reference's arms and merge there.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import kernel_build as kb
from .quorum import TileState, as_fabric, on_device
from .ring_exchange import (leaves_of, ring_shift_plain, ring_shift_planes,
                            ring_shift_rows)


class RebalancePolicy:
    """Deterministic skew-threshold/dwell law over per-cell occupancy.

    ``observe(shard_ewmas)`` is called once per tick with the governor's
    flattened occupancy-EWMA grid (cell ``i * v_shards + j`` = member
    block i x validator block j) and returns the planned rotation in
    device ROWS (0 = no plan). After a plan, a cooldown window mutes the
    law while the post-rotation EWMAs re-learn the new placement —
    without it the stale pre-rotation transient would immediately
    re-trigger. ``force_tick`` (the testing/chaos hook behind the
    ``RebalanceForceTick`` knob) plans one rotation unconditionally at
    exactly that tick ordinal, so digest-identity arms can rebalance
    deterministically without engineering a hot shard."""

    def __init__(self, m_shards: int, shard_rows: int, v_shards: int = 1,
                 threshold: float = 0.0, dwell: int = 8,
                 force_tick: int = 0, cooldown: Optional[int] = None):
        if m_shards < 1 or shard_rows < 1 or v_shards < 1:
            raise ValueError("mesh shape must be positive")
        self._m = int(m_shards)
        self._rows = int(shard_rows)
        self._v = int(v_shards)
        self._threshold = float(threshold)
        self._dwell = max(1, int(dwell))
        self._force = int(force_tick)
        self._cool_len = (4 * self._dwell if cooldown is None
                          else max(0, int(cooldown)))
        self._tick = 0
        self._over = 0       # consecutive over-threshold ticks
        self._cooldown = 0   # ticks left before the law re-arms
        self.last_skew = 0.0
        self.planned = 0     # rotations this policy has planned

    @property
    def threshold(self) -> float:
        return self._threshold

    @property
    def dwell(self) -> int:
        return self._dwell

    @property
    def shard_rows(self) -> int:
        return self._rows

    def block_heat(self, shard_ewmas: Sequence[float]) -> List[float]:
        """Fold the flattened occupancy grid into per-member-block heat
        (mean over each block's validator cells — rotation moves member
        planes, so the member axis is the one the plan can change)."""
        return [
            sum(shard_ewmas[i * self._v:(i + 1) * self._v]) / self._v
            for i in range(self._m)]

    @staticmethod
    def skew(block_heat: Sequence[float]) -> float:
        """Hottest/median block heat (median of an even count is the
        mean of the middle two) — THE skew every surface reports."""
        heats = sorted(block_heat)
        n = len(heats)
        med = (heats[n // 2] if n % 2
               else (heats[n // 2 - 1] + heats[n // 2]) / 2.0)
        return max(heats) / max(med, 1e-9)

    def plan(self, block_heat: Sequence[float]) -> int:
        """Rotation (in device rows) minimizing the predicted hottest
        block, 0 if no rotation strictly improves it. A shift of ``s``
        rows re-partitions the member sequence so new block k holds the
        last ``s % R`` rows of old block ``k - s//R - 1`` and the first
        ``R - s%R`` rows of old block ``k - s//R`` — heat splits
        proportionally (rows within a block are not individually
        metered; the uniform split is the unbiased estimate). Smallest
        winning ``s`` ties-break, so plans are deterministic."""
        heat = list(block_heat)
        n_blocks = len(heat)
        rows = self._rows
        best_s, best_max = 0, max(heat)
        for s in range(1, n_blocks * rows):
            b0, r = divmod(s, rows)
            w_hi = (rows - r) / rows
            w_lo = r / rows
            pred = max(
                w_hi * heat[(k - b0) % n_blocks]
                + w_lo * heat[(k - b0 - 1) % n_blocks]
                for k in range(n_blocks))
            if pred < best_max - 1e-12:
                best_s, best_max = s, pred
        return best_s

    def observe(self, shard_ewmas: Optional[Sequence[float]]) -> int:
        """One tick of the law; returns the planned rotation in device
        rows (0 almost always)."""
        self._tick += 1
        if self._cooldown > 0:
            self._cooldown -= 1
            return 0
        heat = None
        if shard_ewmas is not None \
                and len(shard_ewmas) == self._m * self._v:
            heat = self.block_heat(shard_ewmas)
            self.last_skew = self.skew(heat)
        if self._force and self._tick == self._force:
            self._over = 0
            self._cooldown = self._cool_len
            s = self.plan(heat) if heat else 0
            if not s:
                s = max(1, self._rows // 2)  # forced arm always rotates
            self.planned += 1
            return s
        if self._threshold <= 0 or heat is None or self._m < 2:
            return 0
        if self.last_skew > self._threshold:
            self._over += 1
        else:
            self._over = 0
        if self._over >= self._dwell:
            self._over = 0
            self._cooldown = self._cool_len
            s = self.plan(heat)
            if s:
                self.planned += 1
            return s
        return 0

    @classmethod
    def from_config(cls, config, vote_group) -> Optional["RebalancePolicy"]:
        """The composition-root constructor: None unless the group is
        member-sharded AND a trigger is armed (skew law or force hook) —
        the common path pays nothing."""
        if vote_group is None or getattr(vote_group, "_m_shards", 1) < 2:
            return None
        if (config.RebalanceSkewThreshold <= 0
                and config.RebalanceForceTick <= 0):
            return None
        return cls(vote_group._m_shards, vote_group._shard_rows,
                   vote_group._v_shards,
                   threshold=config.RebalanceSkewThreshold,
                   dwell=config.RebalanceDwellTicks,
                   force_tick=config.RebalanceForceTick)


def _merge_rows(leaves, shard_rows: int):
    rows = leaves[0].shape[0]
    if any(x.shape[0] != rows for x in leaves) or rows % shard_rows:
        raise ValueError(f"rotate merge: leaves of {rows} member rows in "
                         f"shards of {shard_rows}")
    return rows


def rotate_merge_plain(a, b, s: int, shard_rows: int):
    """The plain version of K15: per leaf, new row k R + r takes ``a``'s
    row k R + r - s when r >= s, ``b``'s row k R + r - s + R otherwise
    (0 < s < R); new tensors."""
    la, rebuild = leaves_of(a)
    lb, _ = leaves_of(b)
    rows = _merge_rows(la, shard_rows)
    dev = la[0].device
    g = torch.arange(rows, device=dev)
    r = g % shard_rows
    src = g - r + (r - s) % shard_rows
    take_a = r >= s
    out = []
    for x, y in zip(la, lb):
        hit = take_a.view((-1,) + (1,) * (x.dim() - 1))
        out.append(torch.where(hit, x[src], y[src]))
    return rebuild(out)


def _merge_kernel(la, lb, rebuild, s: int, shard_rows: int):
    rows = _merge_rows(la, shard_rows)
    dev = la[0].device
    outs, table = [], []
    for x, y in zip(la, lb):
        if x.device != dev or y.device != dev or not x.is_contiguous() \
                or not y.is_contiguous() or x.shape != y.shape \
                or x.dtype != y.dtype:
            raise ValueError(f"rotate merge: the arms' leaves must be "
                             f"contiguous twins on {dev}")
        out = torch.empty_like(x)
        outs.append(out)
        table += [x.data_ptr(), y.data_ptr(), out.data_ptr(),
                  x.element_size() * (x.numel() // rows)]
    host = np.array(table, np.int64)
    code = kb.library().rotate_merge_launch(
        host.ctypes.data, len(la), rows, shard_rows, s,
        torch.cuda.current_stream(dev).cuda_stream)
    kb.check(code, "rotate_merge")
    kb.LAUNCHES["rotate_merge"] += 1
    return rebuild(outs)


def rotate_merge(a, b, s: int, shard_rows: int):
    """K15, the rotation's shard-local merge of the two ring-shift arms
    (0 < s < ``shard_rows``). CPU tensors take
    :func:`rotate_merge_plain`; CUDA tensors launch
    ``rotate_merge_kernel`` (``csrc/ring.cu``) once for every leaf, or
    raise."""
    la, rebuild = leaves_of(a)
    lb, _ = leaves_of(b)
    if len(la) != len(lb):
        raise ValueError("rotate merge: the arms differ in leaves")
    dev = la[0].device.type
    if dev == "cpu":
        return rotate_merge_plain(a, b, s, shard_rows)
    if dev != "cuda":
        raise ValueError(f"rotate merge: unsupported device {la[0].device}")
    return _merge_kernel(la, lb, rebuild, s, shard_rows)


def rotate_planes(states, mesh, rows: int, shard_rows: int):
    """Rotate every member plane ``rows`` device rows along the member
    axis (row r's plane moves to row ``(r + rows) % M``), out of place.

    In the per-tile layout (``states`` a TileState) this is the
    reference's shape: ``rows = b R + s`` splits into the ring shifts by
    ``b`` and ``b + 1`` (:func:`~.ring_exchange.ring_shift_planes`, K1's
    peer form), merged on every tile by K15 (:func:`rotate_merge`, on the
    tile's device). In the one-device layout, on a mesh or without one, it
    is ONE roll of every leaf by ``rows`` rows, one K1 launch
    (:func:`~.ring_exchange.ring_shift_rows`), where the reference's
    shape takes two ring shifts and the merge
    (:func:`rotate_planes_plain`). A rotation by a multiple of M returns
    ``states`` itself."""
    mesh = as_fabric(mesh)
    if mesh is not None and mesh.split:
        return _rotate_tiles(states, mesh, rows, shard_rows)
    if mesh is not None:
        leaves, _ = leaves_of(states)
        _merge_rows(leaves, shard_rows)
    return ring_shift_rows(states, rows)


def _rotate_tiles(states: TileState, mesh, rows: int,
                  shard_rows: int) -> TileState:
    if states.rows != shard_rows:
        raise ValueError(f"rotate planes: tiles of {states.rows} members, "
                         f"shards of {shard_rows}")
    b0, s = divmod(int(rows), int(shard_rows))
    shifted = ring_shift_planes(states, mesh, b0)
    if s == 0:
        return shifted
    shifted_up = ring_shift_planes(states, mesh, b0 + 1)
    merged = []
    for a, b in zip(shifted.tiles, shifted_up.tiles):
        with on_device(a.frontier.device):
            merged.append(rotate_merge(a, b, s, shard_rows))
    return TileState(merged, states.v)


def rotate_planes_plain(states, mesh, rows: int, shard_rows: int):
    """The plain version of :func:`rotate_planes` on any device, in the
    reference's shape: on a mesh, ``rows = b R + s`` splits into the ring
    shifts by ``b`` and ``b + 1``
    (:func:`~.ring_exchange.ring_shift_plain`) merged shard-locally
    (:func:`rotate_merge_plain`); without one, the merge alone with m = 1,
    both arms the state and R = M."""
    mesh = as_fabric(mesh)
    if mesh is None:
        leaves, _ = leaves_of(states)
        total = leaves[0].shape[0]
        s = int(rows) % total
        return states if s == 0 else rotate_merge_plain(states, states, s,
                                                        total)
    b0, s = divmod(int(rows), int(shard_rows))
    shifted = ring_shift_plain(states, mesh, b0)
    if s == 0:
        return shifted
    return rotate_merge_plain(shifted, ring_shift_plain(states, mesh,
                                                        b0 + 1),
                              s, shard_rows)
