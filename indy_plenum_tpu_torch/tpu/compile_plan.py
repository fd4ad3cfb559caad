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
caller rebinding its state reads like the JAX code. Member-sharded and
2-axis mesh plans (``compile_plan.py:201-245``) and the residency plan
(``resident_plan_for``) come with a later slice of the port.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

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
