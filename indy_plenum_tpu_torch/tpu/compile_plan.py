"""Execution plans for the grouped vote-plane step functions.

Port of ``indy_plenum_tpu/tpu/compile_plan.py``. In JAX the plan decides
how each function compiles for a mesh shape (``jit``/``pjit``/
``shard_map``); PyTorch runs eagerly, so here the plan binds the three
functions a :class:`~indy_plenum_tpu_torch.tpu.vote_plane.VotePlaneGroup`
runs, to the kernels that run them:

- ``step(states, words)`` -> (states, events, compact): the fused quorum
  step - K7 (:func:`~indy_plenum_tpu_torch.tpu.quorum.step_compact`)
  without a mesh, K13 (:func:`~indy_plenum_tpu_torch.tpu.quorum.
  fabric_step`) on the fabric (reference ``:201-245``, its ``shard_map``
  step);
- ``slide(states, (M,) deltas)`` and ``zero(states, (M,) mask)``: the
  rare-path window ops (K8, reference ``_slide_body``/``_zero_body``,
  ``:83-97``): :func:`~indy_plenum_tpu_torch.tpu.quorum.slide_state` and
  :func:`~indy_plenum_tpu_torch.tpu.quorum.zero_members`, one
  ``csrc/window.cu`` launch each on the card. The reference's pjit'd mesh
  versions are per-member maps over the member-stacked state, so on the
  one-device fabric K8 runs them over the padded state as it is, and in
  the per-tile layout on every tile's rows, on the tile's device
  (:func:`~indy_plenum_tpu_torch.tpu.quorum.slide_tiles`,
  :func:`~indy_plenum_tpu_torch.tpu.quorum.zero_tiles`).

A mesh in the per-tile layout (``FabricMesh.split``) takes the split
forms: the state is a :class:`~indy_plenum_tpu_torch.tpu.quorum.
TileState`, the words one operand a tile (or one (M, W) tensor, cut and
copied to the tiles), and the step
:func:`~indy_plenum_tpu_torch.tpu.quorum.tiles_step`: the tile kernel's
partials mode on each non-home tile, its counts stored on its block's
home tile's device, then the home form there (its own consume, the
stored counts added, the decide); its events and compact record come
back one member block at a time (lists).

``CompilePlan.strategy`` names what the port launches for each function
(``{"step": "k7" | "k13" | "k13_split", "slide": "k8" | "k8_tiles",
"zero": "k8" | "k8_tiles"}``) where the reference names its compilation
path; ``mesh_shape`` is the reference's: ``()`` unsharded, ``(m,)`` or
``(m, v)`` on the fabric.

All three update the state IN PLACE, which takes the place of the
reference's buffer donation (``compile_plan.py:54``), and return it so a
caller rebinding its state reads like the JAX code.
:func:`resident_plan_for` (``:99-173``) binds the residency ring's
consume: K9 (:func:`~indy_plenum_tpu_torch.tpu.quorum.resident_step`)
unsharded, the tiled K9 (:func:`~indy_plenum_tpu_torch.tpu.quorum.
resident_tile_step`) on the fabric; on the card both are one launch of
``csrc/resident_tile.cu``'s cluster kernel, K9 at one validator tile. In
the per-tile layout the consume is
:func:`~indy_plenum_tpu_torch.tpu.quorum.tiles_step` with the slides.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Tuple

import torch

from ..utils.torch_env import DeviceLike, resolve_device
from . import quorum as q


class CompilePlan(NamedTuple):
    step: Callable
    slide: Callable
    zero: Callable
    strategy: dict
    mesh_shape: Tuple[int, ...]


def _fabric_tiles(mesh, n_validator_rows: int) -> int:
    """The fabric's validator tile count, checked against the rows."""
    v = mesh.v_shards
    if n_validator_rows % v:
        raise ValueError(f"{n_validator_rows} validator rows on {v} tiles")
    return v


def _check_device(mesh, t: torch.Tensor) -> None:
    if t.device != mesh.device:
        raise ValueError(f"fabric plan: operand on {t.device}, mesh on "
                         f"{mesh.device}")


def _tile_operands(mesh, states, words, slots=None, width=None) -> list:
    """One word operand a tile of ``states`` (a TileState): ``words`` as
    given one a tile, or one tensor whose member rows are cut and copied
    to the tiles; each on its tile's device, (R, W) with one W for every
    tile, or (``slots``, R, ``width``)."""
    q.check_tiles(mesh, states)
    if isinstance(words, torch.Tensor):
        words = q.tile_words(words, mesh, states.rows)
    q.check_tiles(mesh, states, words)
    shape = ((states.rows, words[0].shape[-1]) if slots is None
             else (slots, states.rows, width))
    for w in words:
        if tuple(w.shape) != shape:
            raise ValueError(f"fabric plan: a tile's words must be {shape}, "
                             f"not {tuple(w.shape)}")
    return list(words)


def _zero_tiles(states, mask: torch.Tensor):
    q.zero_tiles(states, mask)
    return states


def _slide_tiles(states, deltas: torch.Tensor):
    q.slide_tiles(states, deltas)
    return states


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
    unless ``device="cpu"``. On a fabric ``mesh`` the step is the tiled
    K9 over the mesh's device, whose state carries ``n_validator_rows``
    (padded) rows; in the per-tile layout it is
    :func:`~indy_plenum_tpu_torch.tpu.quorum.tiles_step` with the slides
    over a TileState, the words one (n_slots, R, width) operand a tile
    (a list) or the stack as above, cut and copied to the tiles."""
    mesh = q.as_fabric(mesh)
    if mesh is None:
        if n_validator_rows != n_validators:
            raise ValueError("unsharded plans carry no pad validator rows")
        dev = resolve_device(device)
        v = None
    else:
        dev = mesh.device
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"resident plan: device {device}, mesh on "
                             f"{dev}")
        v = _fabric_tiles(mesh, n_validator_rows)

    def split(states, slides, *words):
        block = words[0] if len(words) == 1 else torch.stack(words)
        if isinstance(block, torch.Tensor) and block.dim() == 2:
            block = block.unsqueeze(0)  # one slot's (M, W) row
        tiles = _tile_operands(mesh, states, block, n_slots, width)
        events, compact = q.tiles_step(states, tiles, n_validators,
                                       delta_cap,
                                       slides=torch.as_tensor(slides))
        return states, events, compact

    if mesh is not None and mesh.split:
        return split

    def step(states: q.VoteState, slides, *words):
        block = (words[0] if len(words) == 1 and words[0].dim() == 3
                 else torch.stack(words))
        if tuple(block.shape[::2]) != (n_slots, width) \
                or block.device != dev:
            raise ValueError(f"resident plan: words must be {n_slots} "
                             f"slots of width {width} on {dev}")
        if v is None:
            events, compact = q.resident_step(
                states, torch.as_tensor(slides), block, n_validators,
                delta_cap)
        else:
            events, compact = q.resident_tile_step(
                states, torch.as_tensor(slides), block, n_validators, v,
                delta_cap)
        return states, events, compact

    return step


@functools.lru_cache(maxsize=None)
def plan_for(mesh, n_validators: int, n_validator_rows: int,
             delta_cap: int) -> CompilePlan:
    """The plan for a group. ``n_validators`` is the REAL validator count
    (quorum thresholds); ``n_validator_rows`` the row count the state
    tensors carry (equal without a mesh; padded to a multiple of the
    validator tiles on the fabric - pad rows never receive votes, so the
    summed counts are exact). In the per-tile layout the plan's functions
    take a TileState, and the step returns one events and one compact
    record a member block."""
    mesh = q.as_fabric(mesh)
    if mesh is None:
        if n_validator_rows != n_validators:
            raise ValueError("unsharded plans carry no pad validator rows")

        def step(states: q.VoteState, words: torch.Tensor):
            events, compact = q.step_compact(states, words, n_validators,
                                             delta_cap)
            return states, events, compact

        return CompilePlan(step=step, slide=_slide_body, zero=_zero_body,
                           strategy={"step": "k7", "slide": "k8",
                                     "zero": "k8"},
                           mesh_shape=())
    v = _fabric_tiles(mesh, n_validator_rows)
    if mesh.split:
        def split(states, words):
            tiles = _tile_operands(mesh, states, words)
            events, compact = q.tiles_step(states, tiles, n_validators,
                                           delta_cap)
            return states, events, compact

        return CompilePlan(step=split, slide=_slide_tiles, zero=_zero_tiles,
                           strategy={"step": "k13_split",
                                     "slide": "k8_tiles",
                                     "zero": "k8_tiles"},
                           mesh_shape=tuple(mesh.shape))

    def fabric(states: q.VoteState, words: torch.Tensor):
        _check_device(mesh, words)
        events, compact = q.fabric_step(states, words, n_validators, v,
                                        delta_cap)
        return states, events, compact

    return CompilePlan(step=fabric, slide=_slide_body, zero=_zero_body,
                       strategy={"step": "k13", "slide": "k8", "zero": "k8"},
                       mesh_shape=tuple(mesh.shape))
