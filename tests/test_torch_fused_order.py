"""K14's order (``csrc/ed25519.cu`` ``fused_step_kernel``), modelled on
the CPU: each block of 16 signature groups runs in a seeded shuffled
order; in a block, each live group whose verdict holds stores its word's
1 into the member's planes (``qc::scatter_word`` over every row and
slot: PRE-PREPAREs whatever the sender, checkpoints bounded by C); a
group past the batch stores nothing; then ONE tail evaluation, as the
block that draws the last ticket makes it: the column counts over the
planes as they stand and the decide with compact off. Held bit-equal
(state, events, verdicts) to JAX's ``fused_step`` at the graft entry's
shape and at n = 16, S = 40, B = 64 with planted faults, and to the
port's ``fused_step_plain`` on 4 validator tiles (the sharded K14, whose
tile split changes no count on one card). Verdicts come from the port's
plain verify (computed once a batch): the model is of the order, not of
the field arithmetic."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from indy_plenum_tpu.tpu import quorum as jq  # noqa: E402
from indy_plenum_tpu.tpu.step import fused_step as jax_fused_step  # noqa: E402,E501
from indy_plenum_tpu_torch.crypto import ed25519 as ed  # noqa: E402
from indy_plenum_tpu_torch.tpu import ed25519 as ted  # noqa: E402
from indy_plenum_tpu_torch.tpu import quorum as tq  # noqa: E402
from indy_plenum_tpu_torch.tpu import step as tstep  # noqa: E402

SIGS_PER_BLOCK = 16  # csrc/ed25519.cu kSigsPerBlock
SEEDS = (0, 1, 2)


def scatter_word(state: tq.VoteState, w: int) -> None:
    """``qc::scatter_word`` at K14's arguments (member 0, rows [0, N),
    slots [0, S), both owner flags set)."""
    n, s = state.prepare_votes.shape[1:]
    c = state.checkpoint_votes.shape[-1]
    if not w >> 31:
        return
    kind, sender, slot = (w >> 29) & 3, (w >> 16) & 0x1FFF, w & 0xFFFF
    if kind == tq.PREPREPARE:
        if slot < s:
            state.preprepare_seen[0, slot] = 1
    elif sender < n:
        if kind == tq.PREPARE and slot < s:
            state.prepare_votes[0, sender, slot] = 1
        elif kind == tq.COMMIT and slot < s:
            state.commit_votes[0, sender, slot] = 1
        elif kind == tq.CHECKPOINT and slot < c:
            state.checkpoint_votes[0, sender, slot] = 1


def fused_order_model(state, words, ok, n_validators, seed):
    """The kernel's order on the CPU, given the (B,) verdicts: returns
    (state, events, ok)."""
    batch = words.shape[1]
    rng = np.random.RandomState(seed)
    grid = max(1, -(-batch // SIGS_PER_BLOCK))
    for block in rng.permutation(grid):
        for group in rng.permutation(SIGS_PER_BLOCK):
            item = int(block) * SIGS_PER_BLOCK + int(group)
            if item < batch and bool(ok[item]):
                scatter_word(state, int(words[0, item]) & 0xFFFFFFFF)
    counts = [p.sum(dim=1, dtype=torch.int32) for p in (
        state.prepare_votes, state.commit_votes, state.checkpoint_votes)]
    events, _ = tq.decide_plain(state, *counts, n_validators,
                                compact=False)
    return state, events, ok


def _assert_jax_equal(jstate, jev, jok, tstate, tev, tok):
    for fields, a_all, b_all in ((tq.VoteState._fields, jstate, tstate),
                                 (tq.QuorumEvents._fields, jev, tev)):
        for name, a, b in zip(fields, a_all, b_all):
            assert np.array_equal(np.asarray(a), b.numpy()[0]), name
    assert np.array_equal(np.asarray(jok), tok.numpy())


@functools.lru_cache(maxsize=None)
def _entry():
    fn, args = graft.entry()
    return jax.jit(fn)(*args)


@functools.lru_cache(maxsize=None)
def _verdicts(kind):
    """The port's plain verdicts on the entry's or the planted batch."""
    sig = tstep.example_inputs(device="cpu")[2:] if kind == "entry" \
        else ted.to_device(list(_planted()[1]), "cpu")
    return ted.verify_kernel_plain(*sig)


@functools.lru_cache(maxsize=None)
def _planted():
    """n = 16, S = 40, C = 2, B = 64 (``tests/test_torch_step.py``'s
    planted faults: one in eight bad) -> (entries, arrays, JAX result)."""
    n, s, c, batch = 16, 40, 2, 64
    rng = np.random.RandomState(14)
    seeds = [rng.bytes(32) for _ in range(n)]
    keys = [ed.public_key(sd) for sd in seeds]
    entries, pks, msgs, sigs = [], [], [], []
    for b in range(batch):
        slot = b % 6
        kind = jq.PREPREPARE if b % 16 == 0 else (
            jq.PREPARE if b % 2 else jq.COMMIT)
        sender = 0 if kind == jq.PREPREPARE else int(rng.randint(n))
        entries.append((kind, sender, slot))
        msg = int(jq.pack_vote(kind, sender, slot)).to_bytes(4, "little")
        sig = ed.sign(seeds[sender], msg)
        pk = keys[sender]
        fault = b % 8
        if fault == 3:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        elif fault == 5:
            pk = keys[(sender + 1) % n]
        elif fault == 7:
            msg = bytes([msg[0] ^ 2]) + msg[1:]
        pks.append(pk)
        msgs.append(msg)
        sigs.append(sig)
    pk, rb, sb, h, pre = ted.prepare_batch(pks, msgs, sigs)
    assert pre.all()
    jfn = jax.jit(functools.partial(jax_fused_step, n_validators=n))
    jres = jfn(jq.init_state(n, s, c), jq.pack_messages(entries, batch),
               *[jnp.asarray(a) for a in (pk, rb, sb, h)])
    return entries, (pk, rb, sb, h), jres


@pytest.mark.parametrize("seed", SEEDS)
def test_order_model_matches_jax_at_entry_shape(seed):
    inputs = tstep.example_inputs(device="cpu")
    got = fused_order_model(*inputs[:2], _verdicts("entry"),
                            n_validators=8, seed=seed)
    _assert_jax_equal(*_entry(), *got)
    assert bool(got[2].all())


@pytest.mark.parametrize("seed", SEEDS)
def test_order_model_matches_jax_with_planted_faults(seed):
    entries, arrays, jres = _planted()
    words = tq.words_tensor(tq.pack_words(entries, 64)[None, :])
    got = fused_order_model(tq.init_state(16, 40, 2), words,
                            _verdicts("planted"), n_validators=16,
                            seed=seed)
    _assert_jax_equal(*jres, *got)
    assert not bool(got[2].all()) and int(got[1].prepare_counts.sum()) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_order_model_matches_plain_on_four_tiles(seed):
    """The sharded K14's form: 16 validators on 4 tiles, from a state with
    earlier votes (the tail counts the planes as they stand), words with
    out-of-range senders and slots and invalid ones mixed in."""
    entries, arrays, _ = _planted()
    rng = np.random.RandomState(40 + seed)
    words_np = tq.pack_words(entries, 64)
    junk = rng.rand(64) < 0.2
    words_np = np.where(junk, rng.randint(0, 2 ** 32, 64, dtype=np.uint64)
                        .astype(np.uint32), words_np)[None, :]
    words = tq.words_tensor(words_np)
    state = tq.init_state(16, 40, 2)
    for plane in (state.prepare_votes, state.commit_votes):
        plane.copy_(torch.from_numpy(
            (rng.rand(*plane.shape) < 0.7).astype(np.uint8)))
    state.preprepare_seen.copy_(torch.from_numpy(
        (rng.rand(1, 40) < 0.5).astype(np.uint8)))
    shadow = tq.clone_state(state)
    sig = ted.to_device(list(arrays), "cpu")
    got = fused_order_model(state, words, _verdicts("planted"),
                            n_validators=16, seed=seed)
    want = tstep.fused_step_plain(shadow, words, *sig, n_validators=16,
                                  v_shards=4)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert torch.equal(got[2], want[2])
    assert int(got[1].ordered.sum()) > 0
