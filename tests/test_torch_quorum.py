"""The port's quorum step (plain version on the CPU), slide and zero,
bit-equal to the JAX package on seeded word streams: every VoteState leaf,
QuorumEvents and CompactEvents, including overflow steps (more newly
certified slots than the delta cap) and out-of-range fields."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from indy_plenum_tpu.tpu import compile_plan as jcp  # noqa: E402
from indy_plenum_tpu.tpu import quorum as jq  # noqa: E402
from indy_plenum_tpu_torch.tpu import compile_plan as tcp  # noqa: E402
from indy_plenum_tpu_torch.tpu import quorum as tq  # noqa: E402


def _words(kind, sender, slot, valid):
    return ((valid.astype(np.uint64) << 31) | (kind.astype(np.uint64) << 29)
            | (sender.astype(np.uint64) << 16)
            | slot.astype(np.uint64)).astype(np.uint32)


def _random_words(rng, m, w, n, s, c):
    """Votes with out-of-range senders and slots and invalid padding."""
    kind = rng.randint(0, 4, (m, w))
    sender = rng.randint(0, n + 3, (m, w))
    hi = np.where(kind == jq.CHECKPOINT, c + 2, s + 5)
    slot = (rng.rand(m, w) * hi).astype(np.int64)
    valid = rng.rand(m, w) < 0.9
    return _words(kind, sender, slot, valid)


def _wave_words(rng, m, w, n, s, slots, commits=True):
    """Full 3PC waves (PRE-PREPARE, n-1 PREPAREs, n COMMITs) for ``slots``
    in every member row, shuffled, zero-padded to ``w``."""
    out = np.zeros((m, w), np.uint32)
    for mi in range(m):
        row = []
        for sl in slots:
            row.append(jq.pack_vote(jq.PREPREPARE, 0, sl))
            row += [jq.pack_vote(jq.PREPARE, v, sl) for v in range(1, n)]
            if commits:
                row += [jq.pack_vote(jq.COMMIT, v, sl) for v in range(n)]
        rng.shuffle(row)
        assert len(row) <= w
        out[mi, :len(row)] = row
    return out


def _assert_same(jstate, jev, jcomp, tstate, tev, tcomp):
    for name, a, b in zip(tq.VoteState._fields, jstate, tstate):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    if jev is not None:
        for name, a, b in zip(tq.QuorumEvents._fields, jev, tev):
            assert np.array_equal(np.asarray(a), b.numpy()), name
        for name, a, b in zip(tq.CompactEvents._fields, jcomp, tcomp):
            assert np.asarray(a).dtype == b.numpy().dtype, name
            assert np.array_equal(np.asarray(a), b.numpy()), name


@pytest.mark.parametrize("n,s,m", [(4, 32, 3), (7, 64, 5), (16, 300, 2)])
def test_group_step_slide_zero_match_jax(n, s, m):
    c = max(1, s // 100) + 1
    w = 512
    rng = np.random.RandomState(n * 1000 + s)
    plan = jcp.plan_for(None, n, n, jq.ORDER_DELTA_CAP)
    tplan = tcp.plan_for(None, n, n, tq.ORDER_DELTA_CAP)
    proto = jq.init_state(n, s, c)
    jstate = jax.tree.map(lambda x: jnp.zeros((m,) + x.shape, x.dtype),
                          proto)
    tstate = tq.init_state(n, s, c, m)
    overflowed = False
    schedule = ["random", "wave20", "random", "commits", "slide", "random",
                "wave3", "zero", "random", "wave20"]
    base = 0
    for op in schedule:
        if op == "slide":
            d = rng.randint(0, 6, m).astype(np.int32)
            d[0] = 0  # a zero delta is a strict identity
            jstate = plan.slide(jstate, jnp.asarray(d))
            tstate = tplan.slide(tstate, torch.from_numpy(d))
            _assert_same(jstate, None, None, tstate, None, None)
            continue
        if op == "zero":
            mask = np.zeros(m, np.uint8)
            mask[-1] = 1
            jstate = plan.zero(jstate, jnp.asarray(mask))
            tstate = tplan.zero(tstate, torch.from_numpy(mask))
            _assert_same(jstate, None, None, tstate, None, None)
            continue
        if op == "random":
            words = _random_words(rng, m, w, n, s, c)
        elif op == "commits":  # commit certs for slots prepared earlier
            words = np.zeros((m, w), np.uint32)
            votes = [jq.pack_vote(jq.COMMIT, v, sl)
                     for sl in range(base, base + 3) for v in range(n)]
            words[:, :len(votes)] = votes
        else:
            count = 20 if op == "wave20" else 3
            count = min(count, (w // (2 * n + 1)), s - base)
            words = _wave_words(rng, m, w, n, s,
                                list(range(base, base + count)),
                                commits=op == "wave20")
            base = (base + count) % max(1, s - 20)
        jstate, jev, jcomp = plan.step(jstate, jnp.asarray(words))
        tstate, tev, tcomp = tplan.step(tstate, tq.words_tensor(words))
        _assert_same(jstate, jev, jcomp, tstate, tev, tcomp)
        overflowed |= bool((tcomp.n_committed > tq.ORDER_DELTA_CAP).any())
    if n <= 7:
        assert overflowed  # the 20-slot waves overflow the 16-slot cap


def test_standalone_step_matches_jax_step():
    """``quorum.step`` (no fast-path state) against the JAX ``step`` on
    one plane: events equal, prepared_acked and frontier untouched."""
    n, s, c = 7, 48, 2
    rng = np.random.RandomState(7)
    jstate = jq.init_state(n, s, c)
    tstate = tq.init_state(n, s, c, 1)
    for _ in range(4):
        words = _wave_words(rng, 1, 256, n, s, list(rng.choice(s, 5, False)))
        words[0, -40:] = _random_words(rng, 1, 40, n, s, c)[0]
        jstate, jev = jq.step(jstate, jq.unpack_words(jnp.asarray(words[0])),
                              n)
        tev = tq.step(tstate, tq.words_tensor(words), n)
        for name, a, b in zip(tq.QuorumEvents._fields, jev, tev):
            assert np.array_equal(np.asarray(a), b.numpy()[0]), name
        for name, a, b in zip(tq.VoteState._fields, jstate, tstate):
            assert np.array_equal(np.asarray(a), b.numpy()[0]), name


N, S, C = 16, 32, 4
F = (N - 1) // 3


def _np_oracle(entries):
    """The numpy oracle of tests/test_quorum_plane.py."""
    pp = np.zeros(S, bool)
    pv = np.zeros((N, S), bool)
    cv = np.zeros((N, S), bool)
    ck = np.zeros((N, C), bool)
    for k, snd, sl in entries:
        if k == jq.PREPREPARE:
            pp[sl] = True
        elif k == jq.PREPARE:
            pv[snd, sl] = True
        elif k == jq.COMMIT:
            cv[snd, sl] = True
        elif k == jq.CHECKPOINT:
            ck[snd, sl] = True
    prepared = pp & (pv.sum(0) >= N - F - 1)
    ordered = prepared & (cv.sum(0) >= N - F)
    stable = ck.sum(0) >= N - F
    return prepared, ordered, stable


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_matches_numpy_oracle(seed):
    rng = np.random.RandomState(seed)
    entries = []
    for _ in range(400):
        k = int(rng.choice([jq.PREPREPARE, jq.PREPARE, jq.COMMIT,
                            jq.CHECKPOINT]))
        entries.append((k, int(rng.randint(0, N)),
                        int(rng.randint(0, S if k != jq.CHECKPOINT else C))))
    words = tq.pack_words(entries, 512)[None, :]
    state = tq.init_state(N, S, C, 1)
    ev, comp = tq.step_compact(state, tq.words_tensor(words), N)
    prepared, ordered, stable = _np_oracle(entries)
    assert np.array_equal(ev.prepared.numpy()[0], prepared)
    assert np.array_equal(ev.ordered.numpy()[0], ordered)
    assert np.array_equal(ev.newly_ordered.numpy()[0], ordered)
    assert np.array_equal(ev.stable_checkpoints.numpy()[0], stable)
    assert int(comp.n_committed[0]) == int(ordered.sum())
    lead = int(np.cumprod(ordered).sum())
    assert int(comp.frontier[0]) == lead


def test_packers_match_reference():
    entries = [(0, 0, 5), (1, 3, 7), (2, 8191, 65535), (3, 2, 1)]
    assert np.array_equal(tq.pack_words(entries, 16),
                          jq.pack_words(entries, 16))
    with pytest.raises(ValueError):
        tq.pack_vote(1, 8192, 0)
    words = tq.words_tensor(tq.pack_words(entries, 8)[None, :])
    msgs = tq.unpack_words(words)
    assert msgs.kind[0, :4].tolist() == [0, 1, 2, 3]
    assert msgs.sender[0, :4].tolist() == [0, 3, 8191, 2]
    assert msgs.slot[0, :4].tolist() == [5, 7, 65535, 1]
    assert msgs.valid[0].tolist() == [True] * 4 + [False] * 4


def test_mesh_plans_raise():
    # a mesh naming a card this process lacks raises before any plan is
    # made; the per-tile layout's plan is the split one; a mesh that is
    # not the port's FabricMesh is refused
    with pytest.raises((RuntimeError, ValueError)):
        tcp.plan_for(tq.make_fabric_mesh(["cpu", "cuda:0"], (2,)), 4, 4, 16)
    split = tcp.plan_for(tq.make_fabric_mesh(["cpu"] * 2, (2,), split=True),
                         4, 4, 16)
    assert split.strategy["step"] == "k13_split"
    with pytest.raises(TypeError):
        tcp.plan_for(object(), 4, 4, 16)


def test_step_outputs_carve_one_allocation(monkeypatch):
    """The outputs of a K7 / K9 / K13 launch: views of ONE allocation in
    ``csrc/quorum_common.cuh`` ``events_at``'s order, disjoint and covering
    it, shaped and typed as the plain step's; the frontier snapshot is
    one of them, never the live state's storage. A K7 step is exactly one
    library call (a fake library on the CPU stands in for the card), with
    the allocation as its one output operand."""
    import types

    from indy_plenum_tpu_torch.utils import kernel_build as kb

    m, n, s, c = 3, 5, 30, 4
    state = tq.init_state(n, s, c, m)
    width = tq.delta_width(s, tq.ORDER_DELTA_CAP)
    buf, events, comp = tq._outputs(state, width)
    words = torch.zeros((m, 16), dtype=torch.int32)
    pev, pcomp = tq.step_plain(tq.clone_state(state), words, n)
    for got, want in zip(list(events) + list(comp),
                         list(pev) + list(pcomp)):
        assert got.shape == want.shape and got.dtype == want.dtype
    order = [events.prepare_counts, events.commit_counts,
             comp.new_prepared, comp.n_prepared, comp.new_committed,
             comp.n_committed, comp.frontier, events.prepared,
             events.newly_ordered, events.ordered,
             events.stable_checkpoints, comp.stable]
    assert len({id(v) for v in order}) == len(events) + len(comp)
    at = buf.data_ptr()
    for view in order:
        assert view.untyped_storage().data_ptr() \
            == buf.untyped_storage().data_ptr()
        assert view.is_contiguous() and view.data_ptr() == at
        at += view.numel() * view.element_size()
    assert 0 <= buf.data_ptr() + buf.numel() - at < 4  # padded to words
    assert comp.frontier.untyped_storage().data_ptr() \
        != state.frontier.untyped_storage().data_ptr()

    calls = []

    class FakeLibrary:
        def quorum_step_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(kb, "library", FakeLibrary)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setitem(kb.LAUNCHES, "quorum_step", 0)
    _, step_comp = tq._step_kernel(state, words, n, tq.ORDER_DELTA_CAP,
                                   True)
    assert len(calls) == 1 and kb.LAUNCHES["quorum_step"] == 1
    assert len(calls[0]) == len(kb._SIGNATURES["quorum_step_launch"])
    assert calls[0][-2] == step_comp.new_prepared.untyped_storage() \
        .data_ptr()
    assert step_comp.frontier.untyped_storage().data_ptr() == calls[0][-2]
