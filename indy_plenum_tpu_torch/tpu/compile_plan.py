"""Execution plans for the grouped vote-plane step functions.

Port of the unsharded part of ``indy_plenum_tpu/tpu/compile_plan.py``
(``plan_for(None, ...)``, ``:186-199``). In JAX the plan decides how each
function compiles (``jit``/``pjit``/``shard_map``); PyTorch runs eagerly,
so here the plan only binds the three functions a
:class:`~indy_plenum_tpu_torch.tpu.vote_plane.VotePlaneGroup` runs:

- ``step(states, words)`` -> (states, events, compact): the fused quorum
  step (K-d, :func:`~indy_plenum_tpu_torch.tpu.quorum.step_compact`);
- ``slide(states, (M,) deltas)`` and ``zero(states, (M,) mask)``: the
  rare-path window ops (K8, reference ``_slide_body``/``_zero_body``,
  ``:83-97``): :func:`~indy_plenum_tpu_torch.tpu.quorum.slide_state` and
  :func:`~indy_plenum_tpu_torch.tpu.quorum.zero_members`, one
  ``csrc/window.cu`` launch each on the card.

All three update the state IN PLACE, which takes the place of the
reference's buffer donation (``compile_plan.py:54``), and return it so a
caller rebinding its state reads like the JAX code.
:func:`resident_plan_for` (``:99-173``) binds the residency ring's
consume, K9 (:func:`~indy_plenum_tpu_torch.tpu.quorum.resident_step`).
Member-sharded and 2-axis mesh plans (``compile_plan.py:201-245``) come
with the mesh slice of the port.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from ..utils.torch_env import DeviceLike, resolve_device
from . import quorum as q


class CompilePlan(NamedTuple):
    step: Callable
    slide: Callable
    zero: Callable


def _zero_body(states: q.VoteState, mask: torch.Tensor) -> q.VoteState:
    q.zero_members(states, mask)
    return states


def _slide_body(states: q.VoteState, deltas: torch.Tensor) -> q.VoteState:
    q.slide_state(states, deltas)
    return states


@functools.lru_cache(maxsize=None)
def resident_plan_for(mesh, n_validators: int, n_validator_rows: int,
                      delta_cap: int, n_slots: int, width: int,
                      device: DeviceLike = None) -> Callable:
    """The fused multi-slot consume of the residency ring (reference
    ``compile_plan.py:100``): ``step(states, slides, *words)`` -> (states,
    events, compact), where ``slides`` is (n_slots, M) int32 (per-slot
    window deltas, applied BEFORE that slot's scatter) and the words are
    ``n_slots`` (M, width) rows, or their (n_slots, M, width) stack as one
    operand. Quorums are evaluated once at the end, with the compact
    deltas; the state is updated in place. On the card the whole step is
    one K9 launch. Cached per the reference's key; runs on the card
    unless ``device="cpu"``."""
    if mesh is not None:
        raise NotImplementedError(
            "resident mesh plans (member-sharded and member x validator "
            "fabrics) come with the mesh slice of the port")
    if n_validator_rows != n_validators:
        raise ValueError("unsharded plans carry no pad validator rows")
    dev = resolve_device(device)

    def step(states: q.VoteState, slides, *words):
        block = (words[0] if len(words) == 1 and words[0].dim() == 3
                 else torch.stack(words))
        if tuple(block.shape[::2]) != (n_slots, width) \
                or block.device != dev:
            raise ValueError(f"resident plan: words must be {n_slots} "
                             f"slots of width {width} on {dev}")
        events, compact = q.resident_step(
            states, torch.as_tensor(slides), block, n_validators,
            delta_cap)
        return states, events, compact

    return step


@functools.lru_cache(maxsize=None)
def plan_for(mesh, n_validators: int, n_validator_rows: int,
             delta_cap: int) -> CompilePlan:
    """The plan for an unsharded group. ``n_validators`` is the REAL
    validator count (quorum thresholds); ``n_validator_rows`` the row
    count the state tensors carry (equal without a mesh)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh plans (member-sharded and member x validator fabrics) "
            "come with the mesh slice of the port")
    if n_validator_rows != n_validators:
        raise ValueError("unsharded plans carry no pad validator rows")

    def step(states: q.VoteState, words: torch.Tensor):
        events, compact = q.step_compact(states, words, n_validators,
                                         delta_cap)
        return states, events, compact

    return CompilePlan(step=step, slide=_slide_body, zero=_zero_body)
