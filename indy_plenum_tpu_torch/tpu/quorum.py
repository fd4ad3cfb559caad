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
zero: one launch each of ``csrc/window.cu`` for CUDA tensors, their plain
versions (:func:`slide_plain`, :func:`zero_plain`) for CPU tensors, the
state in place either way. :func:`resident_step` (K9, reference
``compile_plan.py:100`` ``resident_plan_for``) chains k (slide, scatter)
slots and evaluates once, in one launch of ``csrc/resident.cu``; its
plain version is :func:`resident_step_plain`, built like
:func:`step_plain` from the scatter and eval halves (:func:`scatter_plain`,
:func:`eval_plain`, the reference's ``scatter_batch``/``eval_compact``).

Words are uint32 bit patterns carried in int32 tensors; the plain version
decodes them in int64 lanes masked to 0xFFFFFFFF (CPU torch has no uint32
shifts).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import kernel_build as kb

# message kinds in the packed device format
PREPREPARE = 0
PREPARE = 1
COMMIT = 2
CHECKPOINT = 3

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
                  ok: Optional[torch.Tensor] = None) -> None:
    """The plain version of the scatter half (reference ``scatter_batch``,
    ``quorum.py:322``): decode (M, W) vote words and store 1 into the hit
    planes, ``state`` in place. ``ok`` ((M, W) bool, optional) drops the
    words whose verdict is False, as K14's ``valid &= ok``."""
    n_rows, s = state.prepare_votes.shape[1:]
    c = state.checkpoint_votes.shape[-1]
    msgs = unpack_words(words)
    valid = msgs.valid if ok is None else msgs.valid & ok.to(torch.bool)
    member = torch.arange(words.shape[0], device=words.device).unsqueeze(-1)
    member = member.expand_as(msgs.slot)
    slot_ok = msgs.slot < s
    cslot_ok = msgs.slot < c
    mine = valid & (msgs.sender < n_rows)

    def scatter(plane, hit, slots):
        plane[member[hit], msgs.sender[hit], slots[hit]] = 1

    scatter(state.prepare_votes, (msgs.kind == PREPARE) & mine & slot_ok,
            msgs.slot)
    scatter(state.commit_votes, (msgs.kind == COMMIT) & mine & slot_ok,
            msgs.slot)
    scatter(state.checkpoint_votes,
            (msgs.kind == CHECKPOINT) & mine & cslot_ok, msgs.slot)
    # PRE-PREPARE is per slot, not per validator: no sender bound
    pp_hit = (msgs.kind == PREPREPARE) & valid & slot_ok
    state.preprepare_seen[member[pp_hit], msgs.slot[pp_hit]] = 1


def eval_plain(state: VoteState, n_validators: int,
               delta_cap: int = ORDER_DELTA_CAP, compact: bool = True
               ) -> Tuple[QuorumEvents, CompactEvents]:
    """The plain version of the eval half (reference ``eval_compact``,
    ``quorum.py:342``): quorum eval over the current planes (+ frontier
    and compact deltas when ``compact``), ``state`` in place."""
    s = state.prepare_votes.shape[-1]
    f = (n_validators - 1) // 3
    prepare_q = n_validators - f - 1
    commit_q = n_validators - f
    prep_counts = state.prepare_votes.sum(dim=1, dtype=torch.int32)
    comm_counts = state.commit_votes.sum(dim=1, dtype=torch.int32)
    chk_counts = state.checkpoint_votes.sum(dim=1, dtype=torch.int32)
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
    ``ok`` masks words as :func:`scatter_plain` does."""
    scatter_plain(state, words, ok)
    return eval_plain(state, n_validators, delta_cap, compact)


def resident_step_plain(states: VoteState, slides, words_seq,
                        n_validators: int,
                        delta_cap: int = ORDER_DELTA_CAP
                        ) -> Tuple[QuorumEvents, CompactEvents]:
    """The plain version of K9, the reference's unsharded resident body
    (``compile_plan.py:119-126``): for each slot k, slide by ``slides[k]``
    ((k, M) deltas) then scatter ``words_seq[k]`` ((M, W) words); then one
    eval with the compact deltas. ``states`` in place."""
    slides = torch.as_tensor(slides)
    for k in range(len(words_seq)):
        if bool((slides[k] != 0).any()):  # a zero slide is the identity
            slide_plain(states, slides[k])
        scatter_plain(states, words_seq[k])
    return eval_plain(states, n_validators, delta_cap, True)


def _check_state(state: VoteState, dev: torch.device, what: str) -> None:
    for name, t in zip(VoteState._fields, state):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: state.{name} must be a contiguous "
                             f"tensor on {dev}")
    if state.frontier.dtype != torch.int32:
        raise ValueError(f"{what}: frontier must be int32")


def _check_words(state: VoteState, words: torch.Tensor, dims: int,
                 what: str) -> None:
    if words.dtype != torch.int32 or words.dim() != dims \
            or not words.is_contiguous():
        shape = "(M, W)" if dims == 2 else "(k, M, W)"
        raise ValueError(f"{what}: words must be a contiguous {shape} "
                         "int32 tensor of uint32 bit patterns")
    if words.shape[-2] != state.frontier.shape[0]:
        raise ValueError(f"{what}: one word row per member")
    _check_state(state, words.device, what)


def _outputs(state: VoteState, width: int, compact: bool
             ) -> Tuple[QuorumEvents, CompactEvents]:
    """Device outputs of a K7/K9 launch: the full events and the compact
    record (whose frontier is the live state's with ``compact``)."""
    m_count, _, s = state.prepare_votes.shape
    c = state.checkpoint_votes.shape[-1]
    dev = state.frontier.device

    def empty(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    events = QuorumEvents(
        prepared=empty(m_count, s, dtype=torch.bool),
        newly_ordered=empty(m_count, s, dtype=torch.bool),
        ordered=empty(m_count, s, dtype=torch.bool),
        stable_checkpoints=empty(m_count, c, dtype=torch.bool),
        prepare_counts=empty(m_count, s, dtype=torch.int32),
        commit_counts=empty(m_count, s, dtype=torch.int32))
    comp = CompactEvents(
        frontier=state.frontier if compact else empty(m_count,
                                                      dtype=torch.int32),
        new_prepared=empty(m_count, width, dtype=torch.int32),
        n_prepared=empty(m_count, dtype=torch.int32),
        new_committed=empty(m_count, width, dtype=torch.int32),
        n_committed=empty(m_count, dtype=torch.int32),
        stable=empty(m_count, c, dtype=torch.uint8))
    return events, comp


def _output_ptrs(events: QuorumEvents, comp: CompactEvents) -> list:
    return [t.data_ptr() for t in events] + [
        comp.new_prepared.data_ptr(), comp.n_prepared.data_ptr(),
        comp.new_committed.data_ptr(), comp.n_committed.data_ptr(),
        comp.stable.data_ptr()]


def _step_kernel(state: VoteState, words: torch.Tensor, n_validators: int,
                 delta_cap: int, compact: bool,
                 ok: Optional[torch.Tensor] = None,
                 counter: str = "quorum_step"
                 ) -> Tuple[QuorumEvents, CompactEvents]:
    """One ``quorum_step_kernel`` launch; ``ok`` ((M, W) bool or uint8 on
    the card, optional) is K14's per-word verdict operand, counted under
    ``counter``."""
    _check_words(state, words, 2, "quorum step")
    if ok is not None and (
            ok.device != words.device or not ok.is_contiguous()
            or ok.dtype not in (torch.bool, torch.uint8)
            or ok.numel() != words.numel()):
        raise ValueError("quorum step: ok must be a contiguous bool or "
                         "uint8 tensor with one verdict per word on "
                         f"{words.device}")
    m_count, n_rows, s = state.prepare_votes.shape
    c = state.checkpoint_votes.shape[-1]
    width = delta_width(s, delta_cap)
    events, comp = _outputs(state, width, compact)
    code = kb.library().quorum_step_launch(
        *[t.data_ptr() for t in state], words.data_ptr(),
        None if ok is None else ok.data_ptr(),
        m_count, n_rows, s, c, words.shape[1], n_validators, width,
        1 if compact else 0, *_output_ptrs(events, comp),
        torch.cuda.current_stream(words.device).cuda_stream)
    kb.check(code, counter)
    kb.LAUNCHES[counter] += 1
    if compact:
        # the frontier the host reads is a snapshot, not the live state
        comp = comp._replace(frontier=state.frontier.clone())
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


def _resident_kernel(states: VoteState, slides: torch.Tensor,
                     words: torch.Tensor, n_validators: int,
                     delta_cap: int) -> Tuple[QuorumEvents, CompactEvents]:
    dev = words.device
    _check_words(states, words, 3, "resident step")
    k, m_count, w = words.shape
    if tuple(slides.shape) != (k, m_count):
        raise ValueError("resident step: slides must be (k, M)")
    slides = _to_card(slides, torch.int32, dev, "resident step")
    _, n_rows, s = states.prepare_votes.shape
    c = states.checkpoint_votes.shape[-1]
    width = delta_width(s, delta_cap)
    events, comp = _outputs(states, width, True)
    code = kb.library().resident_step_launch(
        *[t.data_ptr() for t in states], slides.data_ptr(),
        words.data_ptr(), k, m_count, n_rows, s, c, w, n_validators, width,
        *_output_ptrs(events, comp),
        torch.cuda.current_stream(dev).cuda_stream)
    kb.check(code, "resident_step")
    kb.LAUNCHES["resident_step"] += 1
    return events, comp._replace(frontier=states.frontier.clone())


def resident_step(states: VoteState, slides: torch.Tensor,
                  words: torch.Tensor, n_validators: int,
                  delta_cap: int = ORDER_DELTA_CAP
                  ) -> Tuple[QuorumEvents, CompactEvents]:
    """K9: k ring slots in one step. ``slides`` (k, M) window deltas, each
    applied before its slot's scatter; ``words`` (k, M, W) vote words;
    then one quorum eval with the compact deltas. Updates ``states`` in
    place and returns (events, compact). CPU tensors take
    :func:`resident_step_plain`; CUDA tensors launch
    ``resident_step_kernel`` (``csrc/resident.cu``) or raise. Host
    ``slides`` cross to the card without a blocking copy."""
    if words.device.type == "cpu":
        return resident_step_plain(states, slides, words, n_validators,
                                   delta_cap)
    if words.device.type != "cuda":
        raise ValueError(f"resident step: unsupported device {words.device}")
    return _resident_kernel(states, slides, words, n_validators, delta_cap)


def slide_plain(state: VoteState, deltas: torch.Tensor) -> None:
    """The plain version of the window slide: roll each member's slot axis
    left by its ``deltas[m]`` (>= 0) and zero the vacated columns, in
    place. A zero delta is a strict identity; checkpoint votes clear where
    the delta is positive; the frontier slides with the window, clamped
    at 0."""
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

    roll1(state.preprepare_seen)
    roll2(state.prepare_votes)
    roll2(state.commit_votes)
    state.checkpoint_votes.masked_fill_((d > 0).view(-1, 1, 1), 0)
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


def _member_operand(state: VoteState, values: torch.Tensor, dtype,
                    what: str) -> torch.Tensor:
    """The (M,) per-member operand of a window kernel on the state's
    card."""
    if values.dim() != 1 or values.shape[0] != state.frontier.shape[0]:
        raise ValueError(f"window {what}: one entry per member")
    return _to_card(values, dtype, state.frontier.device, f"window {what}")


def _window_launch(state: VoteState, operand: torch.Tensor, entry: str,
                   name: str) -> None:
    dev = state.frontier.device
    _check_state(state, dev, f"window {name}")
    m_count, n_rows, s = state.prepare_votes.shape
    c = state.checkpoint_votes.shape[-1]
    code = getattr(kb.library(), entry)(
        *[t.data_ptr() for t in state], operand.data_ptr(),
        m_count, n_rows, s, c, torch.cuda.current_stream(dev).cuda_stream)
    kb.check(code, name)
    kb.LAUNCHES[name] += 1


def _window_device(state: VoteState) -> str:
    dev = state.frontier.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"window ops: unsupported device "
                         f"{state.frontier.device}")
    return dev


def slide_state(state: VoteState, deltas: torch.Tensor) -> None:
    """K8's slide: each member's window moves forward by its
    ``deltas[m]`` (>= 0), in place. CPU state takes :func:`slide_plain`;
    CUDA state launches ``slide_kernel`` (``csrc/window.cu``) or raises.
    Host ``deltas`` cross to the card without a blocking copy."""
    if _window_device(state) == "cpu":
        slide_plain(state, deltas)
        return
    _window_launch(state, _member_operand(state, deltas, torch.int32,
                                          "slide"),
                   "window_slide_launch", "window_slide")


def zero_members(state: VoteState, mask: torch.Tensor) -> None:
    """K8's zero: every leaf row of the masked members (view reset), in
    place. CPU state takes :func:`zero_plain`; CUDA state launches
    ``zero_kernel`` (``csrc/window.cu``) or raises."""
    if _window_device(state) == "cpu":
        zero_plain(state, mask)
        return
    _window_launch(state, _member_operand(state, mask != 0, torch.uint8,
                                          "zero"),
                   "window_zero_launch", "window_zero")


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
