"""K14, the fused verify + quorum step: the port's ``fused_step`` (its
plain version, on the CPU) against the JAX package's ``fused_step`` on the
graft entry's shape (``__graft_entry__.entry()``) and on n = 16, S = 40,
B = 64 with planted bad signatures: the state, the events and the
verdicts are equal. JAX gets its ``MsgBatch`` from ``q.pack_messages``,
the port its words from ``pack_words``, on the same entries."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from indy_plenum_tpu.tpu import quorum as jq  # noqa: E402
from indy_plenum_tpu.tpu.step import fused_step as jax_fused_step  # noqa: E402,E501
from indy_plenum_tpu_torch.crypto import ed25519 as ed  # noqa: E402
from indy_plenum_tpu_torch.tpu import ed25519 as ted  # noqa: E402
from indy_plenum_tpu_torch.tpu import quorum as tq  # noqa: E402
from indy_plenum_tpu_torch.tpu import step as tstep  # noqa: E402


def _assert_equal(jstate, jev, jok, tstate, tev, tok):
    """JAX's single-plane results against the port's (1, ...) member."""
    for fields, a_all, b_all in ((tq.VoteState._fields, jstate, tstate),
                                 (tq.QuorumEvents._fields, jev, tev)):
        for name, a, b in zip(fields, a_all, b_all):
            assert np.array_equal(np.asarray(a), b.numpy()[0]), name
    assert np.array_equal(np.asarray(jok), tok.numpy())


def test_entry_shape_matches_jax():
    fn, args = graft.entry()
    jstate, jev, jok = jax.jit(fn)(*args)
    inputs = tstep.example_inputs(device="cpu")
    # the port's signer makes the reference's example batch byte for byte
    for a, b in zip(args[2:], inputs[2:]):
        assert np.array_equal(np.asarray(a), b.numpy())
    tstate, tev, tok = tstep.fused_step(*inputs, n_validators=8,
                                        device="cpu")
    _assert_equal(jstate, jev, jok, tstate, tev, tok)
    assert bool(tok.all())


def test_planted_faults_match_jax():
    """n = 16, S = 40, B = 64: each vote is validator i's PREPARE or
    COMMIT (or the PRE-PREPARE) on a slot, signed by i's seeded key over
    the vote's packed word; one in eight is planted bad (a flipped
    signature bit, a wrong key or a flipped message bit)."""
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
    jstate = jq.init_state(n, s, c)
    jfn = jax.jit(functools.partial(jax_fused_step, n_validators=n))
    jstate, jev, jok = jfn(jstate, jq.pack_messages(entries, batch),
                           *[jnp.asarray(a) for a in (pk, rb, sb, h)])
    words = tq.words_tensor(tq.pack_words(entries, batch)[None, :])
    tstate, tev, tok = tstep.fused_step(
        tq.init_state(n, s, c), words, *ted.to_device([pk, rb, sb, h],
                                                      "cpu"),
        n_validators=n, device="cpu")
    _assert_equal(jstate, jev, jok, tstate, tev, tok)
    expect = np.array([b % 8 not in (3, 5, 7) for b in range(batch)])
    assert np.array_equal(tok.numpy(), expect)
    assert int(tev.prepare_counts.sum()) > 0
