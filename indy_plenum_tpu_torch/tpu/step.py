"""The fused device consensus step: Ed25519 batch verify -> quorum tally.

Port of ``indy_plenum_tpu/tpu/step.py:29-43`` (``fused_step``, K14), the
JAX package's "flagship step" that ``__graft_entry__.entry()`` exports:
verify a batch of signed votes and tally the survivors into one member's
vote tensors, returning the quorum events.

On the card it is ONE launch on the device's current stream
(``csrc/ed25519.cu`` ``fused_step_kernel``): K-c's verify, then in the
same kernel each signature group whose verdict holds stores its word's
1 into the member's planes, and the block that finishes last (a ticket
in device memory, one a stream) counts the columns and decides, as the
reference's one XLA program does. Word b carries the vote whose
signature is row b (the reference's "msgs batch length == signature
batch length"); the state is ONE member (M = 1). As the reference's
``q.step``, the step neither sets ``prepared_acked`` nor moves the
frontier.

:func:`make_sharded_fused_step` (reference ``step.py:46``) is the same
step on a 1-D validator fabric. In the one-device layout every tile lives
in the one state and the reference's ``all_gather`` of the verdicts
(``:62``) is the identity, so the tile split changes no count: it launches
the same kernel. In the per-tile layout it takes the reference's tile
split: each validator tile verifies its B / v share of the signatures
with K-c on its device, the verdicts are gathered to every tile by
copies, each non-home tile runs the tile kernel's partials mode with the
verdicts as its word mask over its own senders, storing its counts on
the home tile's device, and the home tile runs the home form with its
verdicts: its own senders, the stored counts added, the decide.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..crypto import ed25519 as ref
from ..utils import kernel_build as kb
from ..utils.torch_env import DeviceLike, resolve_device
from . import ed25519 as ted
from . import quorum as q


def fused_step_plain(state: q.VoteState, words: torch.Tensor,
                     pk: torch.Tensor, rb: torch.Tensor, s: torch.Tensor,
                     h: torch.Tensor, *, n_validators: int,
                     v_shards: int = 1
                     ) -> Tuple[q.VoteState, q.QuorumEvents, torch.Tensor]:
    """The plain version of K14, and with ``v_shards`` validator tiles of
    the sharded K14: :func:`~.ed25519.verify_kernel_plain`, then
    :func:`~.quorum.fabric_step_plain` without the compact record, the
    verdicts as its word mask. ``state`` in place."""
    ok = ted.verify_kernel_plain(pk, rb, s, h)
    events, _ = q.fabric_step_plain(state, words, n_validators, v_shards,
                                    compact=False, ok=ok.view(words.shape))
    return state, events, ok


_TICKETS = {}  # (device index, stream) -> the stream's K14 ticket


def _ticket(dev: torch.device, stream) -> torch.Tensor:
    """The one uint32 K14's blocks count on, one a stream (0 between
    calls: the last block resets it). Made once by a copy from the host,
    not by a kernel."""
    key = (dev.index, stream.cuda_stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32).to(dev)
    return _TICKETS[key]


def _fused_kernel(state: q.VoteState, words: torch.Tensor, pk: torch.Tensor,
                  rb: torch.Tensor, s: torch.Tensor, h: torch.Tensor,
                  n_validators: int, counter: str
                  ) -> Tuple[q.QuorumEvents, torch.Tensor]:
    """One ``fused_step_kernel`` launch, counted under ``counter``: the
    events (one output allocation, as K7's) and the (B,) verdicts."""
    dev = words.device
    ptrs = q._check_words(state, words, 2, "fused step")
    if state.frontier.shape[0] != 1:
        raise ValueError("fused step: the state is one member")
    sig = ted.kernel_operands(pk, rb, s, h, "fused step")
    if pk.device != dev:
        raise ValueError(f"fused step: signatures on {pk.device}, words "
                         f"on {dev}")
    _, n_rows, n_slots = state.prepare_votes.shape
    n_chk = state.checkpoint_votes.shape[-1]
    width = q.delta_width(n_slots, q.ORDER_DELTA_CAP)
    buf, events, _ = q._outputs(state, width)
    batch = pk.shape[0]
    ok = torch.empty(batch, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev)
    code = kb.library().fused_step_launch(
        *sig[:4], ok.data_ptr(), sig[4], batch, *ptrs, words.data_ptr(),
        n_rows, n_slots, n_chk, n_validators, width, buf.data_ptr(),
        _ticket(dev, stream).data_ptr(), stream.cuda_stream)
    kb.check(code, counter)
    kb.LAUNCHES[counter] += 1
    return events, ok


def fused_step(state: q.VoteState, words: torch.Tensor, pk: torch.Tensor,
               rb: torch.Tensor, s: torch.Tensor, h: torch.Tensor, *,
               n_validators: int, device: DeviceLike = None
               ) -> Tuple[q.VoteState, q.QuorumEvents, torch.Tensor]:
    """K14: verify B signed votes ((B, 32) uint8 pk, R, S and h = SHA-512
    mod L), keep the words whose signature holds, tally them into the
    (1, N, S) ``state`` and evaluate quorums. ``words`` is (1, B) int32.
    Returns (state, events, ok (B,) bool). Runs on the card unless
    ``device="cpu"``; operands elsewhere are moved there first (the state
    is updated in place when it already lies there). The CPU takes
    :func:`fused_step_plain`; on the card it is one ``fused_step_kernel``
    launch, counted under ``fused_step``."""
    dev = resolve_device(device)
    state = q.VoteState(*[t.to(dev) for t in state])
    words, pk, rb, s, h = [t.to(dev) for t in (words, pk, rb, s, h)]
    if words.dim() != 2 or words.shape[0] != 1 \
            or words.shape[1] != pk.shape[0]:
        raise ValueError("fused step: words must be (1, B), one per "
                         "signature")
    if dev.type == "cpu":
        return fused_step_plain(state, words, pk, rb, s, h,
                                n_validators=n_validators)
    events, ok = _fused_kernel(state, words, pk, rb, s, h, n_validators,
                               "fused_step")
    return state, events, ok


def split_fused_step(states: q.TileState, mesh: q.FabricMesh,
                     words: torch.Tensor, pk: torch.Tensor, rb: torch.Tensor,
                     s: torch.Tensor, h: torch.Tensor, *, n_validators: int
                     ) -> Tuple[q.QuorumEvents, torch.Tensor]:
    """The sharded K14 on the per-tile layout (one member block of v
    validator tiles): tile j verifies signatures ``[j B / v, (j + 1) B /
    v)`` with K-c on its device (counted under ``sharded_fused_split``),
    every tile gathers the v verdict slices by copies (the reference's
    ``all_gather``, ``step.py:62``), and :func:`~indy_plenum_tpu_torch.
    tpu.quorum.tiles_step` runs with the verdicts as each tile's word
    mask over its own senders (the partials mode on the non-home tiles,
    the home form deciding without the compact record). Returns the
    events and the
    (B,) verdicts on the home tile's device; ``states`` in place. The
    operands may lie on any device: each tile's share is copied to it."""
    q.check_tiles(mesh, states)
    v = states.v
    batch = pk.shape[0]
    per = batch // v
    oks = []
    for j in range(v):
        dev = mesh.tile_device(0, j)
        share = [q.move(t[j * per:(j + 1) * per].contiguous(), dev)
                 for t in (pk, rb, s, h)]
        with q.on_device(dev):
            oks.append(ted.verify_kernel(*share,
                                         counter="sharded_fused_split"))
    gathered = []
    for j in range(v):
        dev = mesh.tile_device(0, j)
        with q.on_device(dev):
            gathered.append(torch.cat([q.move(o, dev) for o in oks])
                            .view(1, batch))
    events, _ = q.tiles_step(states, q.tile_words(words, mesh, 1),
                             n_validators, compact=False, ok=gathered)
    return events[0], gathered[0].view(batch)


def make_sharded_fused_step(mesh: q.FabricMesh, n_validators: int,
                            axis: str = "validators"):
    """The fused step over ``mesh``'s ``axis`` tiles: returns ``(state,
    words, pk, rb, s, h)`` -> (state, events, ok), the operands as
    :func:`fused_step` takes them. The reference's sizes hold:
    ``n_validators``, the state's rows and the batch split evenly over
    the tiles. In the one-device layout the operands lie on the mesh's
    device; the CPU takes :func:`fused_step_plain`, and on the card it is
    the one ``fused_step_kernel`` launch :func:`fused_step` makes (the
    tiles share the card), counted under ``sharded_fused_step``. In the
    per-tile layout ``state`` is a TileState of the plane's tiles and the
    step :func:`split_fused_step`."""
    mesh = q.as_fabric(mesh)
    n_shards = mesh.axis_size(axis)
    if n_validators % n_shards:
        raise ValueError(f"{n_validators} validators on {n_shards} tiles")

    def sharded(state, words: torch.Tensor, pk: torch.Tensor,
                rb: torch.Tensor, s: torch.Tensor, h: torch.Tensor):
        if words.dim() != 2 or words.shape[0] != 1 \
                or words.shape[1] != pk.shape[0] \
                or pk.shape[0] % n_shards:
            raise ValueError("sharded fused step: words must be (1, B), "
                             "one per signature, B a multiple of the tiles")
        if mesh.split:
            events, ok = split_fused_step(state, mesh, words, pk, rb, s, h,
                                          n_validators=n_validators)
            return state, events, ok
        for t in (words, pk, rb, s, h, *state):
            if t.device != mesh.device:
                raise ValueError(f"sharded fused step: operand on "
                                 f"{t.device}, mesh on {mesh.device}")
        if mesh.device.type == "cpu":
            return fused_step_plain(state, words, pk, rb, s, h,
                                    n_validators=n_validators,
                                    v_shards=n_shards)
        q._tile_rows(state, n_shards)
        events, ok = _fused_kernel(state, words, pk, rb, s, h,
                                   n_validators, "sharded_fused_step")
        return state, events, ok

    return sharded


def example_inputs(batch: int = 8, n_validators: int = 8,
                   log_size: int = 16, n_checkpoints: int = 2,
                   seed: int = 0, device: DeviceLike = None):
    """(state, words, pk, rb, s, h): the twin of the reference's
    ``__graft_entry__._example_batch``/``entry()`` (``:15-47``), made with
    the port's own signer: ``batch`` seeded keys each sign a seeded
    32-byte message, and word i is validator i's PREPARE for slot i (both
    mod the shape). The default arguments are ``entry()``'s shape."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    pks, msgs, sigs = [], [], []
    for _ in range(batch):
        key_seed = rng.bytes(32)
        msg = rng.bytes(32)
        pks.append(ref.public_key(key_seed))
        msgs.append(msg)
        sigs.append(ref.sign(key_seed, msg))
    pk, rb, s, h, pre = ted.prepare_batch(pks, msgs, sigs)
    if not pre.all():
        raise AssertionError("example signatures failed the structural "
                             "checks")
    state = q.init_state(n_validators, log_size, n_checkpoints, 1, dev)
    entries = [(q.PREPARE, i % n_validators, i % log_size)
               for i in range(batch)]
    words = q.words_tensor(q.pack_words(entries, batch)[None, :], dev)
    return (state, words) + tuple(ted.to_device([pk, rb, s, h], dev))
