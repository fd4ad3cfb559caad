"""The device quorum plane: dense vote tensors, one fused step per dispatch.

Port of the unsharded part of ``indy_plenum_tpu/tpu/quorum.py``. Votes live
in dense uint8 tensors with a leading MEMBER axis M (= nodes x protocol
instances, independent planes stepped together):

    prepare_votes, commit_votes : (M, N_validators, LOG_SIZE_slots)
    preprepare_seen, ordered    : (M, LOG_SIZE_slots)
    checkpoint_votes            : (M, N_validators, n_checkpoint_slots)

Slots are watermark-relative (slot = ppSeqNo - h - 1). Thresholds follow
the reference's ``plenum/server/quorums.py``: f = (n-1)//3, prepare quorum
n-f-1 (the primary sends no PREPARE), commit/checkpoint quorum n-f. The
caller records its OWN votes too (the vote-inclusion contract of the JAX
module).

:func:`step_compact` (K-d, reference ``quorum.py:284`` as the grouped
``compile_plan.plan_for`` step runs it) decodes a (M, W) block of packed
vote words, scatters, evaluates quorums, advances the in-order frontier and
emits the compact deltas - in ONE launch of ``csrc/quorum.cu`` for CUDA
tensors, or in its plain PyTorch version (:func:`step_plain`) for CPU
tensors. The state is updated IN PLACE (the reference donates it).
:func:`slide_state` and :func:`zero_members` (K8, reference
``quorum.py:358`` ``slide_state`` and ``compile_plan.py:83`` ``_zero_body``)
are the window's rare-path ops, the checkpoint slide and the view-change
zero: ``csrc/window.cu`` kernels for CUDA tensors (none when no member
slides or resets), their plain versions (:func:`slide_plain`,
:func:`zero_plain`) for CPU tensors, the state in place either way.
:func:`resident_step` (K9, reference ``compile_plan.py:100``
``resident_plan_for``) chains k (slide, scatter) slots and evaluates
once, in one launch of ``csrc/resident_tile.cu``'s cluster kernel at one
validator tile; its plain version is :func:`resident_step_plain`, built like
:func:`step_plain` from the scatter and decide halves (:func:`scatter_plain`,
:func:`decide_plain`, the reference's ``scatter_batch``/``eval_compact``).

The member x validator fabric (reference ``quorum.py:59-73``,
``:145-190``, ``:306-342``, ``:402``) has two layouts, both named by a
:class:`FabricMesh` (m member blocks x v validator blocks):

- the one-device layout (a device list that repeats one device): every
  tile lives in one member-stacked :class:`VoteState`, its validator rows
  padded to a multiple of v, so tile (i, j) is member rows ``[i R, (i+1)
  R)`` x validator rows ``[j V, (j+1) V)``. :func:`fabric_step` (K13,
  reference ``step_compact_local`` ``:306`` under ``compile_plan.py:
  201-245``) scatters each tile's own senders, sums the tiles' column
  counts (the reference's ``psum`` over the validator axis) in the
  cluster's shared memory and decides; its plain version is
  :func:`fabric_step_plain`. :func:`resident_tile_step` is K9 per tile
  (``compile_plan.py:141-173``): the slides and scatters of k ring slots
  restricted to each tile's rows, then K13's decide. Both are one launch
  of ``csrc/resident_tile.cu``'s cluster kernel (K13 at k = 1, no slide).
- the per-tile layout (a list naming distinct devices, or ``split=True``):
  a :class:`TileState`, tile (i, j) a VoteState of its own on its own
  device. :func:`tiles_step` runs the tile kernel's partials mode on
  each tile (i, j > 0) (:func:`split_partials`), which stores its
  partial counts on the block's home tile's device, then its home form
  on the home tile (i, 0) (:func:`split_home`), which adds them to its
  own and decides: the reference's psum as stores and a sum, v launches
  a block.

:func:`make_sharded_step` (``:402``) is the fabric step on one plane
without the compact record, in either layout.

Words are uint32 bit patterns carried in int32 tensors; the plain version
decodes them in int64 lanes masked to 0xFFFFFFFF (CPU torch has no uint32
shifts).
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import kernel_build as kb
from ..utils.torch_env import require_peer_access, resolve_device

# message kinds in the packed device format
PREPREPARE = 0
PREPARE = 1
COMMIT = 2
CHECKPOINT = 3

# the quorum fabric's axis names: axis 0 blocks the member axis M, axis 1
# (when present) each plane's validator axis N (reference quorum.py:55)
FABRIC_AXES = ("members", "validators")

# fixed per-step delta capacity: a step whose newly reached certs exceed it
# reports the TRUE count and the host falls back to one full-events
# readback for that step
ORDER_DELTA_CAP = 16


class VoteState(NamedTuple):
    """Member-stacked vote tensors (slots are h-relative). ``ordered`` is
    the cumulative commit-quorum mask; ``prepared_acked`` remembers which
    prepare certs were already reported; ``frontier`` is the length of the
    leading run of ``ordered`` (monotone within a window epoch)."""

    preprepare_seen: torch.Tensor  # (M, S) uint8
    prepare_votes: torch.Tensor  # (M, N, S) uint8
    commit_votes: torch.Tensor  # (M, N, S) uint8
    checkpoint_votes: torch.Tensor  # (M, N, C) uint8
    ordered: torch.Tensor  # (M, S) uint8
    prepared_acked: torch.Tensor  # (M, S) uint8
    frontier: torch.Tensor  # (M,) int32


class MsgBatch(NamedTuple):
    """Decoded vote words, (M, W) each."""

    kind: torch.Tensor  # int64, one of the four kinds
    sender: torch.Tensor  # int64 validator index
    slot: torch.Tensor  # int64 h-relative slot (or checkpoint slot)
    valid: torch.Tensor  # bool - invalid entries are padding


class QuorumEvents(NamedTuple):
    prepared: torch.Tensor  # (M, S) bool - prepare cert reached
    newly_ordered: torch.Tensor  # (M, S) bool - commit cert newly reached
    ordered: torch.Tensor  # (M, S) bool - cumulative
    stable_checkpoints: torch.Tensor  # (M, C) bool
    prepare_counts: torch.Tensor  # (M, S) int32
    commit_counts: torch.Tensor  # (M, S) int32


class CompactEvents(NamedTuple):
    """The per-step readback: ascending slot lists padded with S (the
    window size), plus the TRUE delta counts (> cap means overflow)."""

    frontier: torch.Tensor  # (M,) int32
    new_prepared: torch.Tensor  # (M, D) int32
    n_prepared: torch.Tensor  # (M,) int32
    new_committed: torch.Tensor  # (M, D) int32
    n_committed: torch.Tensor  # (M,) int32
    stable: torch.Tensor  # (M, C) uint8


class FabricMesh(NamedTuple):
    """The fabric's tile grid (the port of ``make_fabric_mesh``'s
    ``Mesh``): ``shape`` is (m,) or (m, v), ``axis_names`` the
    reference's names for its axes. ``tile_devices`` is None in the
    one-device layout, where ``device`` holds every tile in one
    member-stacked state; otherwise it names one device per tile, tile
    (i, j) on ``tile_devices[i * v + j]`` (the per-tile layout,
    :class:`TileState`), and ``device`` is tile 0's."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    tile_devices: Optional[Tuple[torch.device, ...]] = None

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    @property
    def m_shards(self) -> int:
        """Member blocks (mesh axis 0)."""
        return self.shape[0]

    @property
    def v_shards(self) -> int:
        """Validator blocks (mesh axis 1; 1 on a 1-axis mesh)."""
        return self.shape[1] if len(self.shape) > 1 else 1

    @property
    def split(self) -> bool:
        """True for the per-tile layout."""
        return self.tile_devices is not None

    @property
    def grid(self) -> Tuple[int, int]:
        """(member blocks, validator blocks) of the tiles: a
        ``("validators",)`` mesh is one member block of ``shape[0]``
        validator tiles (the sharded steps' plane)."""
        if self.axis_names == ("validators",):
            return 1, self.shape[0]
        return self.m_shards, self.v_shards

    def tile_device(self, i: int, j: int = 0) -> torch.device:
        """The device of tile (i, j)."""
        if self.tile_devices is None:
            return self.device
        return self.tile_devices[i * self.grid[1] + j]

    def home(self, i: int) -> torch.device:
        """The device of member block i's home tile (i, 0)."""
        return self.tile_device(i, 0)


def make_fabric_mesh(devices, shape, axis_names=None,
                     split: bool = False) -> FabricMesh:
    """The fabric mesh from a device list and a 1- or 2-dim ``shape``:
    ``(8,)`` member blocks only, ``(4, 2)`` the member x validator grid.
    The shape checks are the reference's (``quorum.py:66-73``): one or two
    dims, each >= 1, and at least as many devices as tiles; tile (i, j)
    takes ``devices[i * v + j]``. A list that repeats one device
    (``["cuda:0"] * 8``) builds the one-device layout, unless ``split``;
    a list that names two or more distinct devices, or any list with
    ``split=True``, builds the per-tile layout: every tile its own tensors
    on its own device (``["cpu"] * 8`` with ``split=True`` is how the CPU
    tests and a one-card run reach it). Every device is resolved as an
    entry point resolves its own: a card this process does not see
    raises, and so does a list that mixes the CPU with cards, or two
    cards without peer access between them (the cross-card moves never
    route through the host). ``axis_names`` defaults to
    :data:`FABRIC_AXES` (``("validators",)`` gives the 1-D mesh of
    :func:`make_sharded_step`)."""
    shape = tuple(int(d) for d in shape)
    if not 1 <= len(shape) <= 2 or any(d < 1 for d in shape):
        raise ValueError(f"fabric mesh shape must be (M,) or (M, V): {shape}")
    n_dev = 1
    for d in shape:
        n_dev *= d
    devices = list(devices)
    if len(devices) < n_dev:
        raise ValueError(
            f"fabric mesh {shape} needs {n_dev} devices, have {len(devices)}")
    tiles = [resolve_device(d) for d in devices[:n_dev]]
    if len({d.type for d in tiles}) != 1:
        raise ValueError("a fabric's tiles lie all on the CPU or all on "
                         f"cards: {sorted(map(str, set(tiles)))}")
    names = tuple(axis_names) if axis_names is not None \
        else FABRIC_AXES[:len(shape)]
    if len(names) != len(shape):
        raise ValueError(f"one axis name per mesh dim: {names}")
    if len(set(tiles)) == 1 and not split:
        return FabricMesh(shape, names, tiles[0])
    require_peer_access(tiles)
    return FabricMesh(shape, names, tiles[0], tuple(tiles))


def as_fabric(mesh) -> Optional[FabricMesh]:
    """``mesh`` as a :class:`FabricMesh` (None stays None); anything else
    is refused - the port's fabric is built by :func:`make_fabric_mesh`."""
    if mesh is None or isinstance(mesh, FabricMesh):
        return mesh
    raise TypeError(f"the port's mesh is a FabricMesh (make_fabric_mesh), "
                    f"not {type(mesh).__name__}")


def init_state(n_validators: int, log_size: int, n_checkpoints: int,
               n_members: int = 1, device="cpu") -> VoteState:
    m, n, s, c = n_members, n_validators, log_size, n_checkpoints

    def z(*shape, dtype=torch.uint8):
        return torch.zeros(shape, dtype=dtype, device=device)

    return VoteState(
        preprepare_seen=z(m, s), prepare_votes=z(m, n, s),
        commit_votes=z(m, n, s), checkpoint_votes=z(m, n, c),
        ordered=z(m, s), prepared_acked=z(m, s),
        frontier=z(m, dtype=torch.int32))


def clone_state(state: VoteState) -> VoteState:
    return VoteState(*[t.clone() for t in state])


def unpack_words(words: torch.Tensor) -> MsgBatch:
    """Decode word-packed votes: valid(1) | kind(2) | sender(13) | slot(16)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return MsgBatch(kind=(w >> 29) & 0x3, sender=(w >> 16) & 0x1FFF,
                    slot=w & 0xFFFF, valid=(w >> 31) != 0)


def delta_width(log_size: int, delta_cap: int) -> int:
    """Slot-list width D of the compact record (the reference's
    ``jnp.sort(idx)[:cap]`` keeps min(cap, S) entries)."""
    return min(int(delta_cap), int(log_size))


def _delta_slots(newly: torch.Tensor, width: int):
    """(M, S) bool -> ((M, D) ascending slot ids padded with S, (M,) count)."""
    s = newly.shape[-1]
    ids = torch.arange(s, dtype=torch.int32, device=newly.device)
    idx = torch.where(newly, ids, torch.full_like(ids, s))
    return (torch.sort(idx, dim=-1).values[..., :width].contiguous(),
            newly.sum(dim=-1, dtype=torch.int32))


def scatter_plain(state: VoteState, words: torch.Tensor,
                  ok: Optional[torch.Tensor] = None, row_offset: int = 0,
                  local_rows: Optional[int] = None, row_base: int = 0,
                  preprepare: bool = True) -> None:
    """The plain version of the scatter half (reference ``scatter_batch``,
    ``quorum.py:322``): decode (M, W) vote words and store 1 into the hit
    planes, ``state`` in place. ``ok`` ((M, W) bool, optional) drops the
    words whose verdict is False, as K14's ``valid &= ok``.
    ``row_offset``/``local_rows`` restrict the per-validator planes to one
    validator tile's rows ``[row_offset, row_offset + local_rows)`` (the
    reference's ``_scatter_local``, ``:145-173``): a sender outside them is
    dropped, a PRE-PREPARE hits whatever its sender. ``row_base`` is the
    global validator index of the planes' first row (a tile of the
    per-tile layout holds only its own rows); without ``preprepare`` no
    PRE-PREPARE is stored (a tile that is not its block's home)."""
    n_rows, s = state.prepare_votes.shape[1:]
    c = state.checkpoint_votes.shape[-1]
    if local_rows is None:
        local_rows = n_rows + row_base - row_offset
    msgs = unpack_words(words)
    valid = msgs.valid if ok is None else msgs.valid & ok.to(torch.bool)
    member = torch.arange(words.shape[0], device=words.device).unsqueeze(-1)
    member = member.expand_as(msgs.slot)
    slot_ok = msgs.slot < s
    cslot_ok = msgs.slot < c
    mine = valid & (msgs.sender >= row_offset) \
        & (msgs.sender < row_offset + local_rows)
    row = msgs.sender - row_base

    def scatter(plane, hit, slots):
        plane[member[hit], row[hit], slots[hit]] = 1

    scatter(state.prepare_votes, (msgs.kind == PREPARE) & mine & slot_ok,
            msgs.slot)
    scatter(state.commit_votes, (msgs.kind == COMMIT) & mine & slot_ok,
            msgs.slot)
    scatter(state.checkpoint_votes,
            (msgs.kind == CHECKPOINT) & mine & cslot_ok, msgs.slot)
    if preprepare:
        # PRE-PREPARE is per slot, not per validator: no sender bound
        pp_hit = (msgs.kind == PREPREPARE) & valid & slot_ok
        state.preprepare_seen[member[pp_hit], msgs.slot[pp_hit]] = 1


def decide_plain(state: VoteState, prep_counts: torch.Tensor,
                 comm_counts: torch.Tensor, chk_counts: torch.Tensor,
                 n_validators: int, delta_cap: int = ORDER_DELTA_CAP,
                 compact: bool = True) -> Tuple[QuorumEvents, CompactEvents]:
    """The decide half of the eval, from column counts ((M, S), (M, S),
    (M, C) int32): thresholds from the REAL ``n_validators``, events, and
    with ``compact`` the frontier and compact deltas; ``state`` in place.
    The one decide path of K7, K9 and K13 (``csrc/quorum_common.cuh``
    ``decide_slots``, ``decide_checkpoints``, ``compact_member``)."""
    s = state.prepare_votes.shape[-1]
    f = (n_validators - 1) // 3
    prepare_q = n_validators - f - 1
    commit_q = n_validators - f
    pp = state.preprepare_seen.bool()
    prepared = pp & (prep_counts >= prepare_q)
    commit_ok = pp & (comm_counts >= commit_q) & prepared
    was = state.ordered.bool()
    newly = commit_ok & ~was
    ordered = was | commit_ok
    stable = chk_counts >= commit_q
    new_prep = prepared & ~state.prepared_acked.bool()
    width = delta_width(s, delta_cap)
    p_slots, p_n = _delta_slots(new_prep, width)
    c_slots, c_n = _delta_slots(newly, width)
    lead = torch.cumprod(ordered.to(torch.int32), dim=-1).sum(
        dim=-1, dtype=torch.int32)
    frontier = torch.maximum(state.frontier, lead)
    state.ordered.copy_(ordered)
    if compact:
        state.prepared_acked.copy_(prepared)
        state.frontier.copy_(frontier)
    events = QuorumEvents(prepared=prepared, newly_ordered=newly,
                          ordered=ordered, stable_checkpoints=stable,
                          prepare_counts=prep_counts,
                          commit_counts=comm_counts)
    return events, CompactEvents(
        frontier=frontier, new_prepared=p_slots, n_prepared=p_n,
        new_committed=c_slots, n_committed=c_n,
        stable=stable.to(torch.uint8))


def step_plain(state: VoteState, words: torch.Tensor, n_validators: int,
               delta_cap: int = ORDER_DELTA_CAP, compact: bool = True,
               ok: Optional[torch.Tensor] = None
               ) -> Tuple[QuorumEvents, CompactEvents]:
    """The plain version of K-d on any device: scatter + quorum eval (+
    frontier and compact deltas when ``compact``), ``state`` in place;
    ``ok`` masks words as :func:`scatter_plain` does. It is K13's plain
    version on one validator tile."""
    return fabric_step_plain(state, words, n_validators, 1, delta_cap,
                             compact, ok)


def resident_step_plain(states: VoteState, slides, words_seq,
                        n_validators: int,
                        delta_cap: int = ORDER_DELTA_CAP
                        ) -> Tuple[QuorumEvents, CompactEvents]:
    """The plain version of K9, the reference's unsharded resident body
    (``compile_plan.py:119-126``): for each slot k, slide by ``slides[k]``
    ((k, M) deltas) then scatter ``words_seq[k]`` ((M, W) words); then one
    eval with the compact deltas. ``states`` in place. It is the tiled
    K9's plain version on one validator tile."""
    return resident_tile_plain(states, slides, words_seq, n_validators, 1,
                               delta_cap)


def _state_ptrs(state: VoteState, dev: torch.device, what: str) -> list:
    """The state leaves' pointers, each leaf checked to be a contiguous
    tensor on ``dev`` (one pass)."""
    ptrs = []
    for name, t in zip(VoteState._fields, state):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: state.{name} must be a contiguous "
                             f"tensor on {dev}")
        ptrs.append(t.data_ptr())
    if state.frontier.dtype != torch.int32:
        raise ValueError(f"{what}: frontier must be int32")
    return ptrs


def _check_words(state: VoteState, words: torch.Tensor, dims: int,
                 what: str) -> list:
    """Check the (M, W) or (k, M, W) words against the state; returns the
    state's pointers."""
    if words.dtype != torch.int32 or words.dim() != dims \
            or not words.is_contiguous():
        shape = "(M, W)" if dims == 2 else "(k, M, W)"
        raise ValueError(f"{what}: words must be a contiguous {shape} "
                         "int32 tensor of uint32 bit patterns")
    if words.shape[-2] != state.frontier.shape[0]:
        raise ValueError(f"{what}: one word row per member")
    return _state_ptrs(state, words.device, what)


def _outputs(state: VoteState, width: int
             ) -> Tuple[torch.Tensor, QuorumEvents, CompactEvents]:
    """Device outputs of a K7/K9/K13 launch, carved from ONE allocation in
    the order ``csrc/quorum_common.cuh`` ``events_at`` writes them: int32
    prepare and commit counts, new_prepared, n_prepared, new_committed,
    n_committed and the frontier snapshot, then the prepared, newly and
    ordered bytes and the stable flags twice (events, compact). Returns
    the allocation (its pointer is the kernel's one output operand) and
    the views. The snapshot is the kernel's copy of the frontier, never
    the live state."""
    m, _, s = state.prepare_votes.shape
    c = state.checkpoint_votes.shape[-1]
    ms, md = m * s, m * width
    n_int = 2 * ms + 2 * md + 3 * m
    nbytes = 4 * n_int + 3 * ms + 2 * m * c
    buf = torch.empty(nbytes + (-nbytes) % 4, dtype=torch.uint8,
                      device=state.frontier.device)
    i32, flags = buf.view(torch.int32), buf.view(torch.bool)
    at = 4 * n_int  # the first byte past the int32 part
    events = QuorumEvents(
        prepared=flags.as_strided((m, s), (s, 1), at),
        newly_ordered=flags.as_strided((m, s), (s, 1), at + ms),
        ordered=flags.as_strided((m, s), (s, 1), at + 2 * ms),
        stable_checkpoints=flags.as_strided((m, c), (c, 1), at + 3 * ms),
        prepare_counts=i32.as_strided((m, s), (s, 1), 0),
        commit_counts=i32.as_strided((m, s), (s, 1), ms))
    comp = CompactEvents(
        frontier=i32.as_strided((m,), (1,), 2 * ms + 2 * md + 2 * m),
        new_prepared=i32.as_strided((m, width), (width, 1), 2 * ms),
        n_prepared=i32.as_strided((m,), (1,), 2 * ms + md),
        new_committed=i32.as_strided((m, width), (width, 1),
                                     2 * ms + md + m),
        n_committed=i32.as_strided((m,), (1,), 2 * ms + 2 * md + m),
        stable=buf.as_strided((m, c), (c, 1), at + 3 * ms + m * c))
    return buf, events, comp


def _step_kernel(state: VoteState, words: torch.Tensor, n_validators: int,
                 delta_cap: int, compact: bool
                 ) -> Tuple[QuorumEvents, CompactEvents]:
    """One ``quorum_step_kernel`` launch, and nothing else on the card
    (the outputs are one allocation; the kernel writes the frontier
    snapshot)."""
    ptrs = _check_words(state, words, 2, "quorum step")
    m_count, n_rows, s = state.prepare_votes.shape
    c = state.checkpoint_votes.shape[-1]
    width = delta_width(s, delta_cap)
    buf, events, comp = _outputs(state, width)
    code = kb.library().quorum_step_launch(
        *ptrs, words.data_ptr(), m_count, n_rows, s, c, words.shape[1],
        n_validators, width, 1 if compact else 0, buf.data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream)
    kb.check(code, "quorum_step")
    kb.LAUNCHES["quorum_step"] += 1
    return events, comp


def _dispatch(state, words, n_validators, delta_cap, compact):
    if words.device.type == "cpu":
        return step_plain(state, words, n_validators, delta_cap, compact)
    if words.device.type != "cuda":
        raise ValueError(f"quorum step: unsupported device {words.device}")
    return _step_kernel(state, words, n_validators, delta_cap, compact)


def step_compact(state: VoteState, words: torch.Tensor, n_validators: int,
                 delta_cap: int = ORDER_DELTA_CAP
                 ) -> Tuple[QuorumEvents, CompactEvents]:
    """K-d: the fused ordering-fast-path step over (M, W) vote words.
    ``n_validators`` is the REAL validator count (thresholds). Updates
    ``state`` in place and returns (events, compact). CPU tensors take
    the plain version; CUDA tensors launch ``quorum_step_kernel`` or
    raise."""
    return _dispatch(state, words, n_validators, delta_cap, True)


def step(state: VoteState, words: torch.Tensor, n_validators: int
         ) -> QuorumEvents:
    """Scatter + quorum eval without the fast path's carried state
    (``prepared_acked``/``frontier`` untouched) - the reference's
    ``quorum.step``, used by a standalone plane in host-eval mode."""
    events, _ = _dispatch(state, words, n_validators, ORDER_DELTA_CAP,
                          False)
    return events


def resident_step(states: VoteState, slides: torch.Tensor,
                  words: torch.Tensor, n_validators: int,
                  delta_cap: int = ORDER_DELTA_CAP
                  ) -> Tuple[QuorumEvents, CompactEvents]:
    """K9: k ring slots in one step. ``slides`` (k, M) window deltas, each
    applied before its slot's scatter; ``words`` (k, M, W) vote words;
    then one quorum eval with the compact deltas. Updates ``states`` in
    place and returns (events, compact). CPU tensors take
    :func:`resident_step_plain`; CUDA tensors launch
    ``resident_tile_kernel`` (``csrc/resident_tile.cu`` at one validator
    tile: a cluster of :func:`tile_cluster_blocks` blocks a member) or
    raise, counted under ``resident_step``. Host ``slides`` cross to the
    card without a blocking copy."""
    if words.device.type == "cpu":
        return resident_step_plain(states, slides, words, n_validators,
                                   delta_cap)
    if words.device.type != "cuda":
        raise ValueError(f"resident step: unsupported device {words.device}")
    return _resident_tile_kernel(states, slides, words, n_validators, 1,
                                 delta_cap, counter="resident_step")


# --- the member x validator fabric (K13, tiled K9) --------------------------


def _tile_rows(state: VoteState, v_shards: int) -> int:
    n_rows = state.prepare_votes.shape[1]
    if v_shards < 1 or n_rows % v_shards:
        raise ValueError(f"fabric: {n_rows} validator rows do not split "
                         f"into {v_shards} tiles")
    return n_rows // v_shards


def tile_partials_plain(state: VoteState, v_shards: int):
    """Each validator tile's column counts: ((M, v, S), (M, v, S), (M, v,
    C)) int32 prepare, commit and checkpoint partials (the local sums the
    reference's ``psum`` reduces, ``quorum.py:186-190``)."""
    m_count, n_rows, s = state.prepare_votes.shape
    v_rows = _tile_rows(state, v_shards)

    def part(x):
        return x.view(m_count, v_shards, v_rows, x.shape[-1]).sum(
            dim=2, dtype=torch.int32)

    return (part(state.prepare_votes), part(state.commit_votes),
            part(state.checkpoint_votes))


def scatter_tiles_plain(state: VoteState, words: torch.Tensor,
                        v_shards: int,
                        ok: Optional[torch.Tensor] = None) -> None:
    """Every validator tile scatters its own senders (the reference's
    shard-local ``_scatter_local`` at each tile's row offset)."""
    v_rows = _tile_rows(state, v_shards)
    for j in range(v_shards):
        scatter_plain(state, words, ok, j * v_rows, v_rows)


def decide_partials_plain(state: VoteState, partials, n_validators: int,
                          delta_cap: int, compact: bool
                          ) -> Tuple[QuorumEvents, CompactEvents]:
    """K13's second half: sum the v partials, then decide."""
    return decide_plain(state, *[p.sum(dim=1, dtype=torch.int32)
                                 for p in partials],
                        n_validators, delta_cap, compact)


def fabric_step_plain(state: VoteState, words: torch.Tensor,
                      n_validators: int, v_shards: int,
                      delta_cap: int = ORDER_DELTA_CAP, compact: bool = True,
                      ok: Optional[torch.Tensor] = None
                      ) -> Tuple[QuorumEvents, CompactEvents]:
    """The plain version of K13 on any device: tile scatters, partial
    counts, their sum over the validator tiles, the decide; ``state`` in
    place. ``ok`` masks words as :func:`scatter_plain` does."""
    scatter_tiles_plain(state, words, v_shards, ok)
    return decide_partials_plain(state, tile_partials_plain(state, v_shards),
                                 n_validators, delta_cap, compact)


def _fabric_kernel(state: VoteState, words: torch.Tensor, n_validators: int,
                   v_shards: int, delta_cap: int, compact: bool,
                   blocks: Optional[int] = None
                   ) -> Tuple[QuorumEvents, CompactEvents]:
    dev = words.device
    ptrs = _check_words(state, words, 2, "fabric step")
    _tile_rows(state, v_shards)
    m_count, n_rows, s = state.prepare_votes.shape
    c = state.checkpoint_votes.shape[-1]
    width = delta_width(s, delta_cap)
    if blocks is None:
        blocks = _cluster_blocks(dev, n_rows, s, c, m_count, True)
    buf, events, comp = _outputs(state, width)
    code = kb.library().fabric_step_launch(
        *ptrs, words.data_ptr(), m_count, n_rows, s, c, words.shape[1],
        v_shards, blocks, n_validators, width, 1 if compact else 0,
        buf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kb.check(code, "fabric_step")
    kb.LAUNCHES["fabric_step"] += 1
    return events, comp


def fabric_step(state: VoteState, words: torch.Tensor, n_validators: int,
                v_shards: int, delta_cap: int = ORDER_DELTA_CAP,
                compact: bool = True
                ) -> Tuple[QuorumEvents, CompactEvents]:
    """K13: the grouped step over the fabric's tiles, ``state``'s validator
    rows cut into ``v_shards`` tiles. ``n_validators`` is the REAL
    validator count (thresholds); pad rows receive only what senders
    address them. Updates ``state`` in place and returns (events,
    compact); without ``compact`` neither ``prepared_acked`` nor the
    frontier moves (the reference's ``make_sharded_step``). CPU tensors
    take :func:`fabric_step_plain`; CUDA tensors launch
    ``resident_tile_kernel`` (``csrc/resident_tile.cu`` at one slot, no
    slide: a cluster of :func:`tile_cluster_blocks` blocks a member, no
    partial count in device memory) or raise."""
    if words.device.type == "cpu":
        return fabric_step_plain(state, words, n_validators, v_shards,
                                 delta_cap, compact)
    if words.device.type != "cuda":
        raise ValueError(f"fabric step: unsupported device {words.device}")
    return _fabric_kernel(state, words, n_validators, v_shards, delta_cap,
                          compact)


def resident_tile_plain(states: VoteState, slides, words_seq,
                        n_validators: int, v_shards: int,
                        delta_cap: int = ORDER_DELTA_CAP
                        ) -> Tuple[QuorumEvents, CompactEvents]:
    """The plain version of the tiled K9 (reference ``compile_plan.py:
    141-173``): for each slot, the slide, then every tile's scatter; then
    the tiles' partial counts, their sum and one decide with the compact
    deltas. ``states`` in place."""
    slides = torch.as_tensor(slides)
    for k in range(len(words_seq)):
        if bool((slides[k] != 0).any()):  # a zero slide is the identity
            slide_plain(states, slides[k])
        scatter_tiles_plain(states, words_seq[k], v_shards)
    return decide_partials_plain(states,
                                 tile_partials_plain(states, v_shards),
                                 n_validators, delta_cap, True)


TILE_CLUSTER_MAX = 8  # csrc/resident_tile.cu kMaxBlocks: portable clusters
TILE_RULE_MAX = 7  # the most blocks the rule picks: 8 led by 1% at most
TILE_BLOCK_BYTES = 16384  # bytes of each vote plane a block holds, at most
TILE_SLIDE_BYTES = 4096  # the same when a member may slide


def tile_cluster_blocks(n_rows: int, s: int, members: int, resident: int,
                        sliding: bool = False) -> int:
    """Blocks of the cluster a member of K9, the tiled K9 and K13 (one
    kernel): enough that none holds more than :data:`TILE_BLOCK_BYTES`
    of a vote plane (its ``n_rows`` x ``s`` bytes), or
    :data:`TILE_SLIDE_BYTES` when a member may slide in this consume, but
    no more than let every member's blocks run at once on a card that
    holds ``resident`` of the kernel's blocks; 1 to
    :data:`TILE_RULE_MAX`, never more than the rows. Each block pays fixed
    costs (it decodes every word of its member's slots, and the cluster
    meets twice), so past one wave, or past what the work needs, more
    blocks cost time. A slide is the work that needs them: ``slide_run``
    moves 4 KB of a block's rows (4 words of each of 256 threads) behind
    one barrier and the rest in serial stretches of ~1 us on an H100. At
    phase F1's consume (64 x 64 x 300) the rule picks 2 blocks without a
    slide (fastest of 1-8) and 5 with one (within 2% of the fastest);
    phase H's consume keeps 2 (from the wave), R's and F2's 1, K13 at H
    and G 2. Shapes other than these timed ones are held bit-equal on
    the card but were never timed."""
    per_block = TILE_SLIDE_BYTES if sliding else TILE_BLOCK_BYTES
    want = -(-n_rows * s // per_block)
    return max(1, min(want, TILE_RULE_MAX, n_rows,
                      resident // max(1, members)))


@functools.lru_cache(maxsize=None)
def _tile_resident(index: int, s: int, c: int, step: bool = False) -> int:
    """The blocks of the tiled K9 (of K13 with ``step``) that card
    ``index`` holds at once at S slots and C checkpoints: its SMs times
    the blocks one SM holds (the CUDA occupancy calculator, from the
    kernel's registers and shared memory)."""
    import ctypes

    per_sm = ctypes.c_int(0)
    kb.check(kb.library().resident_tile_occupancy(
        s, c, int(step), ctypes.addressof(per_sm)), "resident_tile")
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count * per_sm.value


def _cluster_blocks(dev: torch.device, n_rows: int, s: int, c: int,
                    m_count: int, step: bool, sliding: bool = False) -> int:
    """:func:`tile_cluster_blocks` on the card that holds ``dev``, for
    K13 (``step``) or the tiled K9 (K9 at one tile)."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return tile_cluster_blocks(n_rows, s, m_count,
                               _tile_resident(index, s, c, step), sliding)


def _resident_tile_kernel(states: VoteState, slides: torch.Tensor,
                          words: torch.Tensor, n_validators: int,
                          v_shards: int, delta_cap: int,
                          blocks: Optional[int] = None,
                          counter: str = "resident_tile"
                          ) -> Tuple[QuorumEvents, CompactEvents]:
    """One ``resident_tile_kernel`` launch (K9 at ``v_shards`` 1, the
    tiled K9 at any), counted under ``counter``; ``blocks`` forces the
    cluster size. Otherwise host ``slides`` that are all 0 take the rule's
    size without a slide; CUDA ``slides``, which the host cannot read
    without waiting for the card, take its size with one."""
    dev = words.device
    ptrs = _check_words(states, words, 3, "resident tile step")
    k, m_count, w = words.shape
    if tuple(slides.shape) != (k, m_count):
        raise ValueError("resident tile step: slides must be (k, M)")
    _tile_rows(states, v_shards)
    sliding = slides.device.type != "cpu" or bool(slides.any())
    slides = _to_card(slides, torch.int32, dev, "resident tile step")
    _, n_rows, s = states.prepare_votes.shape
    c = states.checkpoint_votes.shape[-1]
    width = delta_width(s, delta_cap)
    if blocks is None:
        blocks = _cluster_blocks(dev, n_rows, s, c, m_count, False,
                                 sliding)
    buf, events, comp = _outputs(states, width)
    code = kb.library().resident_tile_launch(
        *ptrs, slides.data_ptr(), words.data_ptr(), k, m_count, n_rows, s,
        c, w, v_shards, blocks, n_validators, width, buf.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kb.check(code, counter)
    kb.LAUNCHES[counter] += 1
    return events, comp


def resident_tile_step(states: VoteState, slides: torch.Tensor,
                       words: torch.Tensor, n_validators: int,
                       v_shards: int, delta_cap: int = ORDER_DELTA_CAP
                       ) -> Tuple[QuorumEvents, CompactEvents]:
    """The tiled K9: k ring slots over the fabric's tiles in one step.
    ``slides`` (k, M) window deltas, each applied before its slot's
    scatter; ``words`` (k, M, W); every tile slides and scatters its own
    rows, then the tiles' counts are summed and decided once. Updates
    ``states`` in place and returns (events, compact). CPU tensors take
    :func:`resident_tile_plain`; CUDA tensors launch
    ``resident_tile_kernel`` (``csrc/resident_tile.cu``: one launch, a
    cluster of :func:`tile_cluster_blocks` blocks a member) or raise."""
    if words.device.type == "cpu":
        return resident_tile_plain(states, slides, words, n_validators,
                                   v_shards, delta_cap)
    if words.device.type != "cuda":
        raise ValueError(f"resident tile step: unsupported device "
                         f"{words.device}")
    return _resident_tile_kernel(states, slides, words, n_validators,
                                 v_shards, delta_cap)


def make_sharded_step(mesh: FabricMesh, n_validators: int,
                      axis: str = "validators"):
    """One plane's step with its validator axis cut into the ``axis``
    tiles of ``mesh`` (reference ``quorum.py:402``): ``(state, words)`` ->
    (state, events), state updated in place, full events, no compact
    record (``prepared_acked`` and the frontier stay). In the one-device
    layout the state is one (1, N, S) VoteState and the step K13; in the
    per-tile layout it is a :class:`TileState` of the plane's v tiles
    (:meth:`TileState.split` of that VoteState over ``mesh``), the words
    (1, W) on any device, and the step :func:`tiles_step`.
    ``n_validators`` must split evenly over the tiles, as the reference
    asserts."""
    mesh = as_fabric(mesh)
    n_shards = mesh.axis_size(axis)
    if n_validators % n_shards:
        raise ValueError(f"{n_validators} validators on {n_shards} tiles")

    def sharded(state, words: torch.Tensor):
        if mesh.split:
            check_tiles(mesh, state)
            events, _ = tiles_step(state, tile_words(words, mesh, 1),
                                   n_validators, compact=False)
            return state, events[0]
        if words.device != mesh.device:
            raise ValueError(f"sharded step: words on {words.device}, "
                             f"mesh on {mesh.device}")
        events, _ = fabric_step(state, words, n_validators, n_shards,
                                compact=False)
        return state, events

    return sharded


# --- the per-tile layout ----------------------------------------------------


def on_device(dev: torch.device):
    """The context a launch on ``dev`` runs in: that card current (a
    kernel launches on the current card's stream), nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def move(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` copied to ``dev``: a local copy on one device, a peer copy
    between two cards (PyTorch orders it after ``t``'s writer and before
    the destination stream's next work with events on both cards'
    current streams). Data movement of the fabric, not a kernel."""
    out = torch.empty_like(t, device=dev)
    out.copy_(t, non_blocking=True)
    return out


class TileState:
    """The per-tile layout of a member-stacked vote state: tile (i, j) is a
    :class:`VoteState` of member block i's R members x validator block
    j's V rows, on the mesh's ``tile_device(i, j)``. The home tile (i, 0)
    holds the block's slot-axis leaves (``preprepare_seen``, ``ordered``,
    ``prepared_acked``, ``frontier``), as the one-card tiled kernel gives
    its first block the PRE-PREPAREs and the slot rows. Tiles (i, j > 0)
    carry slot-axis leaves of the same shape, so that K8, K1 and K15 move
    every tile as one VoteState, but no step writes or reads them (3 R S +
    4 R bytes a tile); :meth:`join` takes the homes'."""

    def __init__(self, tiles: Sequence[VoteState], v: int):
        self.tiles = tuple(tiles)
        self.v = int(v)
        if self.v < 1 or len(self.tiles) % self.v:
            raise ValueError(f"{len(self.tiles)} tiles in rows of {v}")
        self._reduce: dict = {}  # member block -> partials_buffer's list

    @property
    def m(self) -> int:
        """Member blocks."""
        return len(self.tiles) // self.v

    @property
    def rows(self) -> int:
        """Members a block (R)."""
        return self.tiles[0].frontier.shape[0]

    @property
    def v_rows(self) -> int:
        """Validator rows a tile (V)."""
        return self.tiles[0].prepare_votes.shape[1]

    def tile(self, i: int, j: int = 0) -> VoteState:
        return self.tiles[i * self.v + j]

    def home(self, i: int) -> VoteState:
        return self.tiles[i * self.v]

    def partials_buffer(self, i: int) -> list:
        """[member block i's (v - 1, R (2S + C)) int32 partials buffer on
        its home tile's device (made at first use; row
        :func:`partials_slot` (j, v) is tile (i, j)'s), the event of the
        last home launch that read it from another stream (None before
        one; :func:`tiles_step` sets it)]."""
        got = self._reduce.get(i)
        if got is None:
            home = self.home(i)
            size = self.rows * (2 * home.prepare_votes.shape[-1]
                                + home.checkpoint_votes.shape[-1])
            got = self._reduce[i] = [torch.empty(
                self.v - 1, size, dtype=torch.int32,
                device=home.frontier.device), None]
        return got

    @classmethod
    def init(cls, mesh: FabricMesh, n_validator_rows: int, log_size: int,
             n_checkpoints: int, n_members: int = 1) -> "TileState":
        """Zero tiles of an (n_members, n_validator_rows) state, each on
        its device; both counts must split evenly over the grid."""
        m, v = mesh.grid
        if n_members % m or n_validator_rows % v:
            raise ValueError(f"({n_members}, {n_validator_rows}) does not "
                             f"split over the tiles {m} x {v}")
        return cls([init_state(n_validator_rows // v, log_size,
                               n_checkpoints, n_members // m,
                               mesh.tile_device(i, j))
                    for i in range(m) for j in range(v)], v)

    @classmethod
    def split(cls, state: VoteState, mesh: FabricMesh) -> "TileState":
        """``state`` (a one-state VoteState, any device) cut into the
        mesh's tiles, each copied to its device."""
        m, v = mesh.grid
        n_members, n_rows = state.prepare_votes.shape[:2]
        if n_members % m or n_rows % v:
            raise ValueError(f"({n_members}, {n_rows}) does not split over "
                             f"the tiles {m} x {v}")
        r, vr = n_members // m, n_rows // v
        tiles = []
        for i in range(m):
            for j in range(v):
                part = [x[i * r:(i + 1) * r] if x.dim() < 3
                        else x[i * r:(i + 1) * r, j * vr:(j + 1) * vr]
                        for x in state]
                tiles.append(VoteState(*[move(x.contiguous(),
                                              mesh.tile_device(i, j))
                                         for x in part]))
        return cls(tiles, v)

    def clone(self) -> "TileState":
        return TileState([clone_state(t) for t in self.tiles], self.v)

    def join(self, device="cpu") -> VoteState:
        """The one-state VoteState the tiles stand for, on ``device``: the
        planes of every tile, the slot-axis leaves of the homes."""
        dev = torch.device(device)

        def cat_blocks(leaf):
            return torch.cat([self.home(i)[leaf].to(dev)
                              for i in range(self.m)])

        def cat_tiles(leaf):
            return torch.cat([torch.cat([self.tile(i, j)[leaf].to(dev)
                                         for j in range(self.v)], dim=1)
                              for i in range(self.m)])

        return VoteState(*[cat_tiles(k) if k in (1, 2, 3) else cat_blocks(k)
                           for k in range(len(VoteState._fields))])

    def to_numpy(self) -> VoteState:
        """:meth:`join` as numpy arrays."""
        return VoteState(*[x.numpy() for x in self.join("cpu")])


def check_tiles(mesh: FabricMesh, states, words=None) -> None:
    """``states`` is a :class:`TileState` on the mesh's grid, each tile on
    its device; each of ``words`` (one operand a tile) on its tile's."""
    if not isinstance(states, TileState):
        raise TypeError(f"the per-tile layout steps a TileState, not "
                        f"{type(states).__name__}")
    m, v = mesh.grid
    if (states.m, states.v) != (m, v):
        raise ValueError(f"tiles {states.m} x {states.v} on a {m} x {v} "
                         "mesh")
    for t, tile in enumerate(states.tiles):
        dev = mesh.tile_device(t // v, t % v)
        if tile.frontier.device != dev or (
                words is not None and words[t].device != dev):
            raise ValueError(f"tile {divmod(t, v)}: operand on "
                             f"{tile.frontier.device}, mesh tile on {dev}")


def tile_words(words: torch.Tensor, mesh: FabricMesh,
               rows: int) -> List[torch.Tensor]:
    """(..., M, W) words -> one operand a tile: member block i's ``rows``
    rows, copied to each of its tiles' devices."""
    m, v = mesh.grid
    out = []
    for i in range(m):
        block = words[..., i * rows:(i + 1) * rows, :].contiguous()
        out += [move(block, mesh.tile_device(i, j)) for j in range(v)]
    return out


def _partial_views(buf: torch.Tensor, rows: int, s: int, c: int):
    """A tile's partials: its (R, 2S + C) int32 allocation as the (R, S)
    prepare, (R, S) commit and (R, C) checkpoint counts."""
    rs = rows * s
    return (buf[:rs].view(rows, s), buf[rs:2 * rs].view(rows, s),
            buf[2 * rs:].view(rows, c))


def split_partials_plain(tile: VoteState, words: torch.Tensor, row0: int,
                        home: bool, slides=None,
                        ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of the tile kernel's partials mode on one tile of
    the per-tile layout: for each slot of ``words`` ((k, R, W) with
    ``slides`` (k, R); (R, W) without), the slide of the tile's rows
    (:func:`slide_plain`, the slot-axis rows only at ``home``), then the
    scatter of the words whose sender is one of the tile's validators
    ``[row0, row0 + V)`` (PRE-PREPAREs only at ``home``; ``ok`` drops
    words as :func:`scatter_plain` does); then the tile's column counts,
    one int32 allocation of (R, S) prepare, (R, S) commit and (R, C)
    checkpoint counts. ``tile`` in place."""
    seq = words if slides is not None else words.unsqueeze(0)
    if slides is not None:
        slides = torch.as_tensor(slides)
    for k in range(seq.shape[0]):
        if slides is not None and bool((slides[k] != 0).any()):
            slide_plain(tile, slides[k], home)
        scatter_plain(tile, seq[k], ok, row0, tile.prepare_votes.shape[1],
                      row_base=row0, preprepare=home)
    return torch.cat([tile.prepare_votes.sum(dim=1, dtype=torch.int32)
                      .flatten(),
                      tile.commit_votes.sum(dim=1, dtype=torch.int32)
                      .flatten(),
                      tile.checkpoint_votes.sum(dim=1, dtype=torch.int32)
                      .flatten()])


def _split_operands(tile: VoteState, words: torch.Tensor, slides, ok,
                    what: str):
    """Check one tile launch's operands: the state's pointers, (k, W),
    the slides' pointer (None without), whether a member may slide, the
    verdicts' pointer (None without)."""
    dev = words.device
    dims = 2 if slides is None else 3
    ptrs = _check_words(tile, words, dims, what)
    rows = tile.frontier.shape[0]
    k, w = (1, words.shape[1]) if slides is None else (words.shape[0],
                                                       words.shape[2])
    slides_ptr = ok_ptr = None
    sliding = False
    if slides is not None:
        if tuple(slides.shape) != (k, rows):
            raise ValueError(f"{what}: slides must be (k, R)")
        sliding = slides.device.type != "cpu" or bool(slides.any())
        slides = _to_card(slides, torch.int32, dev, what)
        slides_ptr = slides.data_ptr()
    if ok is not None:
        if slides is not None:
            raise ValueError(f"{what}: a verdict operand takes one slot "
                             "and no slides")
        if tuple(ok.shape) != (rows, w) or ok.device != dev:
            raise ValueError(f"{what}: ok must be (R, W) on {dev}")
        ok = ok.to(torch.uint8).contiguous()
        ok_ptr = ok.data_ptr()
    # the operands the pointers name live until the launch is enqueued
    return ptrs, (k, w), (slides, slides_ptr), sliding, (ok, ok_ptr)


def _split_partials_kernel(tile: VoteState, words: torch.Tensor, row0: int,
                           out: torch.Tensor, slides,
                           ok: Optional[torch.Tensor],
                           blocks: Optional[int] = None) -> torch.Tensor:
    """One ``resident_tile_kernel`` launch in its partials mode;
    ``blocks`` forces the cluster size."""
    dev = words.device
    ptrs, (k, w), (slides, slides_ptr), sliding, (ok, ok_ptr) = \
        _split_operands(tile, words, slides, ok, "tile partials")
    rows, n_rows, s = tile.prepare_votes.shape
    c = tile.checkpoint_votes.shape[-1]
    if out.dtype != torch.int32 or out.numel() != rows * (2 * s + c) \
            or not out.is_contiguous() or out.device.type != "cuda":
        raise ValueError("tile partials: out must be a contiguous (R, 2S "
                         "+ C) int32 tensor on a card")
    if blocks is None:
        blocks = _cluster_blocks(dev, n_rows, s, c, rows, slides is None,
                                 sliding)
    code = kb.library().resident_partials_launch(
        *ptrs, slides_ptr, words.data_ptr(), ok_ptr, k, rows, n_rows, s, c,
        w, row0, blocks, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kb.check(code, "resident_partials")
    kb.LAUNCHES["resident_partials"] += 1
    return out


def split_partials(tile: VoteState, words: torch.Tensor, row0: int,
                   out: torch.Tensor, slides=None,
                   ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tile kernel's partials mode on a non-home tile (its validator
    rows ``[row0, row0 + V)``, no slot-axis row): slides and scatters as
    :func:`split_partials_plain` says, ``tile`` in place, and stores the
    tile's partial counts into ``out`` (an (R, 2S + C) int32 tensor; on a
    card, the tile's own or one it has peer access to: its block's
    home's), which it returns. CPU tensors take
    :func:`split_partials_plain`; CUDA tensors launch
    ``resident_tile_kernel``'s partials mode (``csrc/resident_tile.cu``, a
    cluster of :func:`tile_cluster_blocks` blocks a member) on the current
    card, or raise."""
    if words.device.type == "cpu":
        return out.copy_(split_partials_plain(tile, words, row0, False,
                                              slides, ok))
    if words.device.type != "cuda":
        raise ValueError(f"tile partials: unsupported device {words.device}")
    return _split_partials_kernel(tile, words, row0, out, slides, ok)


def split_decide_plain(home: VoteState, partials, n_validators: int,
                       delta_cap: int = ORDER_DELTA_CAP,
                       compact: bool = True
                       ) -> Tuple[QuorumEvents, CompactEvents]:
    """The plain version of the decide from partials: the tiles' counts
    summed, then :func:`decide_plain` on the home tile, in place."""
    rows, _, s = home.prepare_votes.shape
    c = home.checkpoint_votes.shape[-1]
    views = [_partial_views(p, rows, s, c) for p in partials]
    return decide_plain(home, *[sum(v[k] for v in views) for k in range(3)],
                        n_validators, delta_cap, compact)


def split_home_plain(home: VoteState, words: torch.Tensor, partials,
                     n_validators: int, delta_cap: int = ORDER_DELTA_CAP,
                     compact: bool = True, slides=None,
                     ok: Optional[torch.Tensor] = None
                     ) -> Tuple[QuorumEvents, CompactEvents]:
    """The plain version of the home form: the home tile's own partials
    (:func:`split_partials_plain` at row 0 with the slot-axis rows), then
    :func:`split_decide_plain` of them and the other tiles' ``partials``
    (rows of (R, 2S + C) int32 counts, or None). ``home`` in place."""
    own = split_partials_plain(home, words, 0, True, slides, ok)
    others = [] if partials is None else list(partials)
    return split_decide_plain(home, [own] + others, n_validators, delta_cap,
                              compact)


def _split_home_kernel(home: VoteState, words: torch.Tensor, partials,
                       n_validators: int, delta_cap: int, compact: bool,
                       slides, ok: Optional[torch.Tensor],
                       blocks: Optional[int] = None
                       ) -> Tuple[QuorumEvents, CompactEvents]:
    """One ``resident_tile_kernel`` launch in its home form; ``blocks``
    forces the cluster size."""
    dev = words.device
    ptrs, (k, w), (slides, slides_ptr), sliding, (ok, ok_ptr) = \
        _split_operands(home, words, slides, ok, "tile home")
    rows, n_rows, s = home.prepare_votes.shape
    c = home.checkpoint_votes.shape[-1]
    n_parts, parts_ptr = 0, None
    if partials is not None and len(partials):
        if partials.device != dev or partials.dtype != torch.int32 \
                or not partials.is_contiguous() or partials.dim() != 2 \
                or partials.shape[1] != rows * (2 * s + c):
            raise ValueError(f"tile home: partials must be a contiguous "
                             f"(n, R (2S + C)) int32 tensor on {dev}")
        n_parts, parts_ptr = partials.shape[0], partials.data_ptr()
    if blocks is None:
        blocks = _cluster_blocks(dev, n_rows, s, c, rows, slides is None,
                                 sliding)
    width = delta_width(s, delta_cap)
    buf, events, comp = _outputs(home, width)
    code = kb.library().resident_home_launch(
        *ptrs, slides_ptr, words.data_ptr(), ok_ptr, k, rows, n_rows, s, c,
        w, blocks, n_validators, width, 1 if compact else 0, parts_ptr,
        n_parts, buf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kb.check(code, "resident_home")
    kb.LAUNCHES["resident_home"] += 1
    return events, comp


def split_home(home: VoteState, words: torch.Tensor, partials,
               n_validators: int, delta_cap: int = ORDER_DELTA_CAP,
               compact: bool = True, slides=None,
               ok: Optional[torch.Tensor] = None
               ) -> Tuple[QuorumEvents, CompactEvents]:
    """The home form on a block's home tile (its validator rows from 0,
    the slot-axis rows): K13's consume (the tiled K9's with ``slides``;
    ``ok`` masks words) on the tile's own rows, its counts summed with the
    other tiles' ``partials`` (an (n, R (2S + C)) int32 tensor on the
    home's device, as :func:`split_partials` stores them, or None), the
    quorums decided, the frontier and compact deltas (``compact``: as
    K13's flag), ``home`` in place. CPU tensors take
    :func:`split_home_plain`; CUDA tensors launch ``resident_tile_kernel``
    (``csrc/resident_tile.cu``, a cluster of :func:`tile_cluster_blocks`
    blocks a member, the decide spread over the cluster) on the current
    card, or raise."""
    if words.device.type == "cpu":
        return split_home_plain(home, words, partials, n_validators,
                                delta_cap, compact, slides, ok)
    if words.device.type != "cuda":
        raise ValueError(f"tile home: unsupported device {words.device}")
    return _split_home_kernel(home, words, partials, n_validators, delta_cap,
                              compact, slides, ok)


def partials_slot(j: int, v: int) -> int:
    """The row of its block's partials buffer that tile (i, j), 0 < j <
    v, stores into. The home form sums every row, so any one-to-one map of
    1..v-1 onto 0..v-2 gives the same step (the tests permute it)."""
    return j - 1


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev) if dev.type == "cuda" else None


def tiles_step(states: TileState, words: Sequence[torch.Tensor],
               n_validators: int, delta_cap: int = ORDER_DELTA_CAP,
               compact: bool = True, slides=None, ok=None
               ) -> Tuple[List[QuorumEvents], List[CompactEvents]]:
    """The fabric step of the per-tile layout (K13's, or the tiled K9's
    with ``slides``), v launches a member block: the partials mode on
    each tile (i, j > 0) (:func:`split_partials`; ``words`` one operand a
    tile, (R, W) or (k, R, W); ``slides`` the (k, M) window deltas; ``ok``
    one (R, W) verdict operand a tile), each storing its partials into
    its row of a (v - 1, R (2S + C)) int32 buffer on the home tile's
    device (a peer store between cards), then the home form on the home
    tile (i, 0) (:func:`split_home`), which adds them and decides. No
    partial is copied. ``states`` in place; returns each member block's
    events and compact record, on its home's device (the reference reads
    each block back from its own shard).

    Ordering, where a non-home tile's stream is not its home's (tiles on
    two cards): the home's launch waits on an event of each non-home
    launch of the step (its partials are in); the readback of its outputs
    follows it on the home's stream; and a non-home tile's next store
    into its row waits on an event of the block's previous home launch
    (which read the row: the write-after-read hazard across cards). On
    one stream, launch order is that order. No spin on another tile, no
    system-scope atomic."""
    m, v = states.m, states.v
    rows, v_rows = states.rows, states.v_rows
    events, compacts = [], []
    for i in range(m):
        home = states.home(i)
        hdev = home.frontier.device
        block = None if slides is None \
            else slides[:, i * rows:(i + 1) * rows]
        reduce = states.partials_buffer(i)
        parts, last_read = reduce
        home_stream = _stream(hdev)
        stored = []
        for j in range(1, v):
            t = i * v + j
            tile = states.tiles[t]
            dev = tile.frontier.device
            with on_device(dev):
                stream = _stream(dev)
                cross = stream is not None and stream != home_stream
                if cross:
                    kb.enable_peer_access(dev.index, hdev.index)
                    if last_read is not None:
                        stream.wait_event(last_read)
                split_partials(tile, words[t], j * v_rows,
                               parts[partials_slot(j, v)], block,
                               None if ok is None else ok[t])
                if cross:
                    done = torch.cuda.Event()
                    done.record(stream)
                    stored.append(done)
        with on_device(hdev):
            for done in stored:
                home_stream.wait_event(done)
            ev, comp = split_home(home, words[i * v], parts, n_validators,
                                  delta_cap, compact, block,
                                  None if ok is None else ok[i * v])
            if stored:
                reduce[1] = torch.cuda.Event()
                reduce[1].record(home_stream)
        events.append(ev)
        compacts.append(comp)
    return events, compacts


def join_blocks(blocks):
    """Per-block events or compact records (NamedTuples of one member
    block's rows each) as one NamedTuple of every member's rows, on the
    CPU."""
    cls = type(blocks[0])
    return cls(*[torch.cat([b[k].cpu() for b in blocks])
                 for k in range(len(cls._fields))])


def slide_tiles(states: TileState, deltas: torch.Tensor) -> None:
    """K8's slide on the per-tile layout: each tile slides its rows by its
    block's ``deltas`` (:func:`slide_state` on the tile's device; no
    launch for a tile whose block slides no member)."""
    rows = states.rows
    for t, tile in enumerate(states.tiles):
        d = deltas[(t // states.v) * rows:(t // states.v + 1) * rows]
        if d.device.type == "cpu" and not bool((d > 0).any()):
            continue
        with on_device(tile.frontier.device):
            slide_state(tile, d)


def zero_tiles(states: TileState, mask: torch.Tensor) -> None:
    """K8's zero on the per-tile layout: each tile zeroes the masked
    members of its block (:func:`zero_members` on the tile's device)."""
    rows = states.rows
    for t, tile in enumerate(states.tiles):
        part = mask[(t // states.v) * rows:(t // states.v + 1) * rows]
        if part.device.type == "cpu" and not bool((part != 0).any()):
            continue
        with on_device(tile.frontier.device):
            zero_members(tile, part)


def slide_plain(state: VoteState, deltas: torch.Tensor,
                home: bool = True) -> None:
    """The plain version of the window slide: roll each member's slot axis
    left by its ``deltas[m]`` (>= 0) and zero the vacated columns, in
    place. A zero delta is a strict identity; checkpoint votes clear where
    the delta is positive; the frontier slides with the window, clamped
    at 0. Without ``home`` (a tile of the per-tile layout that is not its
    block's home) only the validator planes move: the slot-axis rows and
    the frontier stay."""
    s = state.prepare_votes.shape[-1]
    d = deltas.to(device=state.frontier.device, dtype=torch.int64)
    cols = torch.arange(s, device=d.device)
    src = (cols.unsqueeze(0) + d.unsqueeze(1)) % s  # (M, S)
    keep = cols.unsqueeze(0) < (s - d.unsqueeze(1))

    def roll1(x):
        x.copy_(torch.where(keep, torch.gather(x, 1, src),
                            torch.zeros_like(x)))

    def roll2(x):
        idx = src.unsqueeze(1).expand_as(x)
        x.copy_(torch.where(keep.unsqueeze(1), torch.gather(x, 2, idx),
                            torch.zeros_like(x)))

    roll2(state.prepare_votes)
    roll2(state.commit_votes)
    state.checkpoint_votes.masked_fill_((d > 0).view(-1, 1, 1), 0)
    if not home:
        return
    roll1(state.preprepare_seen)
    roll1(state.ordered)
    roll1(state.prepared_acked)
    state.frontier.copy_(torch.clamp(state.frontier.to(torch.int64) - d,
                                     min=0))


def zero_plain(state: VoteState, mask: torch.Tensor) -> None:
    """The plain version of the view-change zero: every leaf row of the
    masked members, in place."""
    hit = mask.to(device=state.frontier.device, dtype=torch.bool)
    for x in state:
        x.masked_fill_(hit.view((-1,) + (1,) * (x.dim() - 1)), 0)


def _to_card(values: torch.Tensor, dtype, dev: torch.device,
             what: str) -> torch.Tensor:
    """A small operand on the card ``dev``. A host operand crosses from
    pinned memory without blocking the host (PyTorch's pinned allocator
    keeps the buffer until the copy is done); the copy runs on the current
    stream, ahead of the kernel."""
    if values.device.type == "cpu":
        values = values.to(dtype).pin_memory().to(dev, non_blocking=True)
    elif values.device != dev:
        raise ValueError(f"{what}: operand on {values.device}, state on "
                         f"{dev}")
    return values.to(dtype).contiguous()


def _window_launches(state: VoteState, values: torch.Tensor, dtype,
                     chunks, entries: Tuple[str, str], name: str) -> None:
    """K8's launches on a CUDA ``state`` for the (M,) per-member
    ``values``. CUDA ``values`` are read by the kernel on the card: one
    launch of ``entries[0]``. Host ``values`` are cut by ``chunks`` into
    int32 arrays that travel in the parameters of one ``entries[1]``
    launch each: no copy to the card, and no launch for no array. Each
    entry point takes (state, operand, count, N, S, C, stream)."""
    what = name.replace("_", " ")
    if values.dim() != 1 or values.shape[0] != state.frontier.shape[0]:
        raise ValueError(f"{what}: one entry per member")
    dev = state.frontier.device
    ptrs = _state_ptrs(state, dev, what)
    m_count, n_rows, s = state.prepare_votes.shape
    c = state.checkpoint_votes.shape[-1]
    if values.device.type != "cpu":
        operand = _to_card(values, dtype, dev, what)
        launches = [(entries[0], operand.data_ptr(), m_count)]
    else:
        arrays = chunks(values.numpy())  # alive until the last launch
        launches = [(entries[1], a.ctypes.data, len(a)) for a in arrays]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for entry, operand_ptr, count in launches:
        kb.check(getattr(kb.library(), entry)(
            *ptrs, operand_ptr, count, n_rows, s, c, stream), name)
        kb.LAUNCHES[name] += 1


def _window_device(state: VoteState) -> str:
    dev = state.frontier.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"window ops: unsupported device "
                         f"{state.frontier.device}")
    return dev


SLIDE_PAIRS_PER_LAUNCH = 256  # csrc/window.cu kMaxPairs


def slide_pair_chunks(deltas: np.ndarray,
                      per_launch: int = SLIDE_PAIRS_PER_LAUNCH):
    """The (row, delta) int32 pairs of a host slide, one (k, 2) array per
    launch of at most ``per_launch`` pairs: the rows whose delta is
    positive, in row order (a delta <= 0 is skipped, as the device-deltas
    kernel skips it). No pairs, no launch."""
    d = np.asarray(deltas).astype(np.int64)
    rows = np.flatnonzero(d > 0)
    pairs = np.stack([rows, d[rows]], axis=1).astype(np.int32)
    return [np.ascontiguousarray(pairs[i:i + per_launch])
            for i in range(0, len(pairs), per_launch)]


def slide_state(state: VoteState, deltas: torch.Tensor) -> None:
    """K8's slide: each member's window moves forward by its
    ``deltas[m]`` (>= 0), in place. CPU state takes :func:`slide_plain`;
    CUDA state launches a ``csrc/window.cu`` kernel or raises. Host
    ``deltas`` (the pool's) travel in the launch's parameters as the
    sliding members' (row, delta) pairs (:func:`slide_pair_chunks`): no
    copy to the card, no launch when no delta is positive. CUDA
    ``deltas`` are read by the kernel on the card."""
    if _window_device(state) == "cpu":
        slide_plain(state, deltas)
        return
    _window_launches(state, deltas, torch.int32, slide_pair_chunks,
                     ("window_slide_launch", "window_slide_pairs_launch"),
                     "window_slide")


ZERO_ROWS_PER_LAUNCH = 256  # csrc/window.cu kMaxZeroRows


def zero_row_chunks(mask: np.ndarray,
                    per_launch: int = ZERO_ROWS_PER_LAUNCH):
    """The int32 rows of a host zero's reset members (``mask`` nonzero), in
    row order, one array per launch of at most ``per_launch`` rows. No
    reset member, no launch."""
    rows = np.flatnonzero(np.asarray(mask) != 0).astype(np.int32)
    return [np.ascontiguousarray(rows[i:i + per_launch])
            for i in range(0, len(rows), per_launch)]


def zero_members(state: VoteState, mask: torch.Tensor) -> None:
    """K8's zero: every leaf row of the masked members (view reset), in
    place. CPU state takes :func:`zero_plain`; CUDA state launches a
    ``csrc/window.cu`` kernel or raises. A host ``mask`` (the pool's)
    travels in the launch's parameters as the reset members' rows
    (:func:`zero_row_chunks`): no copy to the card, a grid over those
    members only, no launch when the mask is empty. A CUDA ``mask`` is
    read by the kernel on the card."""
    if _window_device(state) == "cpu":
        zero_plain(state, mask)
        return
    _window_launches(state, mask != 0, torch.uint8, zero_row_chunks,
                     ("window_zero_launch", "window_zero_rows_launch"),
                     "window_zero")


# --- host packers (copies of the reference's) -------------------------------


def pack_vote(kind: int, sender: int, slot: int) -> int:
    """ONE vote -> its uint32 word (the wire layout's single definition).
    Bounds are enforced: an out-of-range value would silently alias
    another sender/slot bit-field."""
    if not (0 <= kind < 4 and 0 <= sender < 8192 and 0 <= slot < 65536):
        raise ValueError(
            f"vote field out of packed range: kind={kind} (<4), "
            f"sender={sender} (<8192), slot={slot} (<65536)")
    return 0x80000000 | (kind << 29) | (sender << 16) | slot


# the same (kind, sender, slot) triple recurs constantly (every node
# records node_j's PREPARE for slot s): memoize pool-wide
vote_word = functools.lru_cache(maxsize=1 << 18)(pack_vote)


def fill_words_row(row: np.ndarray, packed_words) -> None:
    """Write pre-packed uint32 vote ints into a zeroed row buffer."""
    row[: len(packed_words)] = np.fromiter(packed_words, np.uint32,
                                           len(packed_words))


def words_row(packed_words, max_batch: int) -> np.ndarray:
    """(already-packed uint32 vote ints) -> zero-padded (max_batch,) row."""
    out = np.zeros(max_batch, np.uint32)
    fill_words_row(out, packed_words)
    return out


def pack_words(entries, max_batch: int) -> np.ndarray:
    """Host helper: (kind, sender, slot) triples -> (max_batch,) uint32."""
    return words_row([pack_vote(k, s, sl) for k, s, sl in entries],
                     max_batch)


def words_tensor(words_u32: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 word array -> the int32 tensor the step takes (same bits)."""
    arr = np.ascontiguousarray(words_u32, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)
