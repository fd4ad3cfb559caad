"""The fused device consensus step: Ed25519 batch verify -> quorum tally.

Port of ``indy_plenum_tpu/tpu/step.py:29-43`` (``fused_step``, K14), the
JAX package's "flagship step" that ``__graft_entry__.entry()`` exports:
verify a batch of signed votes and tally the survivors into one member's
vote tensors, returning the quorum events.

On the card it is two launches on the device's current stream, with no
host synchronisation between them: K-c (``ed25519_verify_launch``) writes
the verdicts ``ok`` to device memory, then K7 (``quorum_step_launch``)
takes them as its verdict operand and drops each word whose verdict is 0
while it decodes (``valid &= ok``). The reference fuses the two into one
XLA program; on the card the tally needs every verdict before any column
count, a grid-wide dependency between a one-thread-per-signature kernel
and a one-block-per-member kernel, which the stream order carries.

Word b carries the vote whose signature is row b (the reference's "msgs
batch length == signature batch length"); the state is ONE member (M = 1).
As the reference's ``q.step``, the step neither sets ``prepared_acked``
nor moves the frontier.

:func:`make_sharded_fused_step` (reference ``step.py:46``) is the same
step on a 1-D validator fabric: K-c over the whole batch (on one device
the reference's ``all_gather`` of the verdicts, ``:62``, is the identity),
then K13 (``csrc/resident_tile.cu``, one cluster launch) with the
verdicts as its ``ok`` operand, each block scattering its own senders.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..crypto import ed25519 as ref
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
    :func:`fused_step_plain`; on the card each launch counts: one
    ``ed25519_verify`` and one ``fused_step`` (the masked K7)."""
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
    ok = ted.verify_kernel(pk, rb, s, h)
    events, _ = q._step_kernel(state, words, n_validators,
                               q.ORDER_DELTA_CAP, False, ok=ok,
                               counter="fused_step")
    return state, events, ok


def make_sharded_fused_step(mesh: q.FabricMesh, n_validators: int,
                            axis: str = "validators"):
    """The fused step over ``mesh``'s ``axis`` tiles: returns ``(state,
    words, pk, rb, s, h)`` -> (state, events, ok), the operands as
    :func:`fused_step` takes them, on the mesh's device. The reference's
    sizes hold: ``n_validators`` and the batch split evenly over the
    tiles. The CPU takes :func:`fused_step_plain`; on the card K-c
    counts one ``ed25519_verify`` and the masked K13 one
    ``sharded_fused_step``."""
    mesh = q.as_fabric(mesh)
    n_shards = mesh.axis_size(axis)
    if n_validators % n_shards:
        raise ValueError(f"{n_validators} validators on {n_shards} tiles")

    def sharded(state: q.VoteState, words: torch.Tensor, pk: torch.Tensor,
                rb: torch.Tensor, s: torch.Tensor, h: torch.Tensor):
        if words.dim() != 2 or words.shape[0] != 1 \
                or words.shape[1] != pk.shape[0] \
                or pk.shape[0] % n_shards:
            raise ValueError("sharded fused step: words must be (1, B), "
                             "one per signature, B a multiple of the tiles")
        for t in (words, pk, rb, s, h, *state):
            if t.device != mesh.device:
                raise ValueError(f"sharded fused step: operand on "
                                 f"{t.device}, mesh on {mesh.device}")
        if mesh.device.type == "cpu":
            return fused_step_plain(state, words, pk, rb, s, h,
                                    n_validators=n_validators,
                                    v_shards=n_shards)
        ok = ted.verify_kernel(pk, rb, s, h)
        events, _ = q.fabric_step(state, words, n_validators, n_shards,
                                  compact=False, ok=ok,
                                  counter="sharded_fused_step")
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
