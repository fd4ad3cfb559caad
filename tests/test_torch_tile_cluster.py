"""The partition of the port's tiled resident step (the tiled K9,
``csrc/resident_tile.cu``), modelled in Python, against the port's plain
version (``resident_tile_plain``) and JAX's ``resident_plan_for(mesh)``;
the same kernel at one validator tile (K9, ``resident_step``) against
``resident_step_plain`` and the unsharded ``resident_plan_for(None, ...)``
of both packages; and at one slot with no slide and the compact record
optional (K13, ``fabric_step``) against ``fabric_step_plain`` and JAX's
fabric step (``plan_for(mesh)``: ``step_compact_local`` on a validator
axis) and ``make_sharded_step``, some cases with a per-word verdict
``ok``: the kernel takes the words with each dropped one's valid bit
cleared, ``fabric_step_plain`` the words and ``ok``.
K8's slide grid (``csrc/window.cu``: one run inside one plane a block,
moved by the same ``slide_run``) is modelled here too, against
``slide_plain`` and JAX's ``_slide_body``.

The model runs the kernel's cluster block by block: block b of B owns the
validator rows [b N / B, (b + 1) N / B), block 0 also the slot-axis rows,
the PRE-PREPAREs and the frontier. Each block runs every slot on its own
bytes (blocks run one after another here, in any order on the card: a
block never reads what another writes, which the model enforces by
poisoning every byte a load takes from outside the block's own run). A
slide moves a run a 4-byte aligned word at a time, as ``slide_run`` does:
two aligned loads joined by a funnel shift, columns walked thread by
thread without a division, whole-word stores inside the run and byte
stores at its ends, in stretches of 4 words a thread. After the last
slot each block counts its rows with ``chunk_counts``' packed 16-bit
lanes (flushed every 256 rows); the slot chunks (multiples of 4 slots)
must cover every slot once, and the chunk's owner sums the B partials;
block 0 sums the checkpoint partials. The decide is the one K7, K9 and
K13 share (``decide_plain``). Exact: the outputs are integers and bools.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from indy_plenum_tpu.tpu import compile_plan as jcp  # noqa: E402
from indy_plenum_tpu.tpu import quorum as jq  # noqa: E402
from indy_plenum_tpu_torch.tpu import compile_plan as tcp  # noqa: E402
from indy_plenum_tpu_torch.tpu import quorum as tq  # noqa: E402

THREADS = 256  # quorum_common.cuh kThreads
UNROLL = 4  # quorum_common.cuh kSlideUnroll
POISON = 0xA5  # what a load sees of any byte outside the block's run
M32 = 0xFFFFFFFF


def rows_of(rank, n_rows, blocks):
    lo = rank * n_rows // blocks
    return lo, (rank + 1) * n_rows // blocks - lo


def slot_chunk(rank, s, blocks):
    chunk = ((s + blocks - 1) // blocks + 3) & ~3
    lo = min(rank * chunk, s)
    return lo, min(lo + chunk, s)


def slide_run(buf, start, length, s, d):
    """``slide_run`` on the bytes [start, start + length) of ``buf`` (an
    allocation starting 4-byte aligned), rolled row by row left by d > 0.
    Returns the set of words written whole."""
    pre = start & 3
    base = start - pre
    end = start + length
    words = (pre + length + 3) >> 2
    keep = s - d if d < s else 0
    sh = 8 * (d & 3)
    hop = d & ~3
    whole = set()

    def byte(i):
        return int(buf[i]) if start <= i < end else POISON

    def word(i):
        return sum(byte(i + b) << (8 * b) for b in range(4))

    cols = [(4 * t - pre) % s for t in range(THREADS)]
    step = (4 * THREADS) % s
    for w0 in range(0, words, UNROLL * THREADS):
        vals = {}
        for t in range(THREADS):
            for u in range(UNROLL):
                w = w0 + u * THREADS + t
                x = 0
                if w < words and keep > 0:
                    src = base + 4 * w + hop
                    lo = word(src) if src < end else 0
                    hi = word(src + 4) if sh and src + 4 < end else 0
                    x = (((hi << 32) | lo) >> sh) & M32
                vals[(t, u)] = x
        # every read of the stretch above, then its writes
        for t in range(THREADS):
            for u in range(UNROLL):
                w = w0 + u * THREADS + t
                if w < words:
                    assert cols[t] == (4 * w - pre) % s
                    mask, c = 0, cols[t]
                    for b in range(4):
                        if c < keep:
                            mask |= 0xFF << (8 * b)
                        c = 0 if c + 1 == s else c + 1
                    x = vals[(t, u)] & mask
                    o = 4 * w - pre
                    if o >= 0 and o + 4 <= length:
                        whole.add(base + 4 * w)
                    for b in range(4):
                        if 0 <= o + b < length:
                            buf[base + 4 * w + b] = (x >> (8 * b)) & 0xFF
                cols[t] += step
                if cols[t] >= s:
                    cols[t] -= s
    return whole


def chunk_counts(pv, cv, m, n_rows, s, r0, nr):
    """``chunk_counts`` over rows [r0, r0 + nr) at every slot: packed byte
    sums two to a 32-bit lane, 16 bits each, flushed every 256 rows."""
    pc, cc = [0] * s, [0] * s
    words = (s + 3) // 4
    groups = THREADS // words if THREADS >= words else 1
    for t in range(groups * words):
        g = t // words
        if g >= nr:
            continue
        s0 = 4 * (t - g * words)
        tp, tc = [0] * 4, [0] * 4
        p02 = p13 = c02 = c13 = 0
        k = 0
        rows = list(range(g, nr, groups))
        for i, n in enumerate(rows):
            row = (m * n_rows + r0 + n) * s
            a = sum(int(pv[row + s0 + b]) << (8 * b) for b in range(4)
                    if s0 + b < s)
            c = sum(int(cv[row + s0 + b]) << (8 * b) for b in range(4)
                    if s0 + b < s)
            p02 += a & 0x00FF00FF
            p13 += (a >> 8) & 0x00FF00FF
            c02 += c & 0x00FF00FF
            c13 += (c >> 8) & 0x00FF00FF
            for lane in (p02, p13, c02, c13):  # no 16-bit field overflows
                assert lane <= M32 and (lane & 0xFFFF) < 0x10000
            k += 1
            if k == 256 or i == len(rows) - 1:
                tp = [tp[0] + (p02 & 0xFFFF), tp[1] + (p13 & 0xFFFF),
                      tp[2] + (p02 >> 16), tp[3] + (p13 >> 16)]
                tc = [tc[0] + (c02 & 0xFFFF), tc[1] + (c13 & 0xFFFF),
                      tc[2] + (c02 >> 16), tc[3] + (c13 >> 16)]
                p02 = p13 = c02 = c13 = k = 0
        for i in range(4):
            if s0 + i < s:
                pc[s0 + i] += tp[i]
                cc[s0 + i] += tc[i]
    return pc, cc


def scatter(st, m, words_row, n_rows, s, c, r0, nr, lead):
    """``scatter_member_rows`` over the block's rows [r0, r0 + nr)."""
    for w in (int(x) for x in words_row):
        if not w >> 31:
            continue
        kind, sender, slot = (w >> 29) & 3, (w >> 16) & 0x1FFF, w & 0xFFFF
        if kind == 0:
            if lead and slot < s:
                st["pp"][m * s + slot] = 1
        elif r0 <= sender < r0 + nr:
            if kind in (1, 2) and slot < s:
                plane = st["pv"] if kind == 1 else st["cv"]
                plane[(m * n_rows + sender) * s + slot] = 1
            elif kind == 3 and slot < c:
                st["ck"][(m * n_rows + sender) * c + slot] = 1


def model_consume(leaves, slides, words_seq, n_validators, blocks,
                  compact=True):
    """The kernel on every member: returns the final leaves (numpy) and
    (events, compact) from the decide. ``slides`` None slides nothing (K13);
    without ``compact`` the decide leaves prepared_acked and the
    frontier."""
    pp, pv, cv, ck, ordered, acked, frontier = [a.copy() for a in leaves]
    m_count, n_rows, s = pv.shape
    c = ck.shape[-1]
    st = {"pp": pp.reshape(-1), "pv": pv.reshape(-1), "cv": cv.reshape(-1),
          "ck": ck.reshape(-1), "ordered": ordered.reshape(-1),
          "acked": acked.reshape(-1)}
    pc = np.zeros((m_count, s), np.int32)
    cc = np.zeros((m_count, s), np.int32)
    kc = np.zeros((m_count, c), np.int32)
    for m in range(m_count):
        parts = []
        for rank in range(blocks):
            r0, nr = rows_of(rank, n_rows, blocks)
            lead = rank == 0
            for k in range(len(words_seq)):
                d = 0 if slides is None else int(slides[k][m])
                if d > 0:
                    run = (m * n_rows + r0) * s
                    slide_run(st["pv"], run, nr * s, s, d)
                    slide_run(st["cv"], run, nr * s, s, d)
                    if lead:
                        for name in ("pp", "ordered", "acked"):
                            slide_run(st[name], m * s, s, s, d)
                        frontier[m] = max(int(frontier[m]) - d, 0)
                    ck[m, r0:r0 + nr] = 0
                scatter(st, m, words_seq[k][m], n_rows, s, c, r0, nr, lead)
            part_p, part_c = chunk_counts(st["pv"], st["cv"], m, n_rows, s,
                                          r0, nr)
            part_k = [int(ck[m, r0:r0 + nr, x].sum()) for x in range(c)]
            parts.append((part_p, part_c, part_k))
        owned = []
        for rank in range(blocks):
            lo, hi = slot_chunk(rank, s, blocks)
            assert lo % 4 == 0 or lo == s
            owned += range(lo, hi)
            for slot in range(lo, hi):
                pc[m, slot] = sum(p[0][slot] for p in parts)
                cc[m, slot] = sum(p[1][slot] for p in parts)
        assert owned == list(range(s))  # each slot decided once
        kc[m] = [sum(p[2][x] for p in parts) for x in range(c)]
    state = tq.VoteState(*[torch.from_numpy(a) for a in
                           (pp, pv, cv, ck, ordered, acked, frontier)])
    events, comp = tq.decide_plain(state, torch.from_numpy(pc),
                                   torch.from_numpy(cc), torch.from_numpy(kc),
                                   n_validators, compact=compact)
    return state, events, comp


def _leaves(rng, m, n_rows, n_real, s, c):
    def bits(*shape):
        return (rng.rand(*shape) < 0.4).astype(np.uint8)

    leaves = [bits(m, s), bits(m, n_rows, s), bits(m, n_rows, s),
              bits(m, n_rows, c), bits(m, s), bits(m, s),
              rng.randint(0, s + 1, m).astype(np.int32)]
    for i in (1, 2, 3):
        leaves[i][:, n_real:] = 0
    return leaves


def _words(rng, m, w, n_rows, n_real, s, c):
    """Random words (some invalid, slots past S and C), a full wave of one
    slot for member 0, only pad-row senders for member 1 (when there are
    pad rows), and an all-invalid row for the last member."""
    kind = rng.randint(0, 4, (m, w))
    sender = rng.randint(0, n_rows + 2, (m, w))
    hi = np.where(kind == jq.CHECKPOINT, c + 2, s + 4)
    slot = (rng.rand(m, w) * hi).astype(np.int64)
    valid = rng.rand(m, w) < 0.85
    out = ((valid.astype(np.uint64) << 31) | (kind.astype(np.uint64) << 29)
           | (sender.astype(np.uint64) << 16)
           | slot.astype(np.uint64)).astype(np.uint32)
    wave = [jq.pack_vote(jq.PREPREPARE, 0, 3)]
    wave += [jq.pack_vote(jq.PREPARE, v, 3) for v in range(1, n_real)]
    wave += [jq.pack_vote(jq.COMMIT, v, 3) for v in range(n_real)]
    out[0, :min(w, len(wave))] = wave[:w]
    if n_rows > n_real:
        pads = rng.randint(n_real, n_rows, w)
        out[1] = [jq.pack_vote(int(rng.randint(1, 4)), int(p),
                               int(rng.randint(0, c))) for p in pads]
    out[-1] = out[-1] & 0x7FFFFFFF
    return out


# (mesh shape, members, real validators, rows, S, C, slots, width, B,
# K13's (ok, compact) or None for the tiled K9). A K13 case whose mesh
# is one validator axis (``("validators",)`` of v tiles, one member, no
# pad rows) is also held against JAX's ``make_sharded_step``.
CASES = {
    "v1_s15_k4_b4": ((8,), 8, 6, 6, 15, 3, 4, 32, 4, None),
    "v2_pad_s30_k2_b3": ((4, 2), 4, 5, 6, 30, 6, 2, 32, 3, None),
    "v4_pad_s20_k4_b8": ((2, 4), 2, 7, 8, 20, 4, 4, 24, 8, None),
    "v2_s15_k1_b5": ((4, 2), 4, 10, 10, 15, 3, 1, 32, 5, None),
    "v2_pad_s300_k2_b3": ((4, 2), 4, 5, 6, 300, 3, 2, 48, 3, None),
    "k13_v1_ok_b3": ((8,), 8, 6, 6, 15, 3, 1, 32, 3, (True, True)),
    "k13_v1_nocompact_b1": ((8,), 8, 6, 6, 15, 3, 1, 32, 1, (False, False)),
    "k13_v2_pad_ok_b4": ((4, 2), 4, 5, 6, 30, 6, 1, 32, 4, (True, True)),
    "k13_v2_pad_ok_nocompact_b3": ((4, 2), 4, 5, 6, 300, 3, 1, 48, 3,
                                   (True, False)),
    "k13_v4_pad_b8": ((2, 4), 2, 7, 8, 20, 4, 1, 24, 8, (False, True)),
    "k13_v4_pad_ok_nocompact_b2": ((2, 4), 2, 7, 8, 22, 4, 1, 24, 2,
                                   (True, False)),
    "k13_sharded_v2_ok_b3": ((2,), 1, 6, 6, 30, 4, 1, 48, 3,
                             (True, False)),
    "k13_sharded_v4_b8": ((4,), 1, 8, 8, 32, 4, 1, 64, 8, (False, False)),
}


def _check_k13(case, rng, leaves, shape, m, n, rows, s, c, w, blocks, v,
               use_ok, compact):
    """K13: one slot, no slide, ``ok`` and ``compact`` as the case says:
    the model on the words with every dropped one marked invalid (the
    reference's ``valid &= ok``, as the kernel gets them) against
    ``fabric_step_plain`` on the words and ``ok``, and JAX on the masked
    words."""
    # one member more than needed: the last one's row is all invalid
    words = _words(rng, m + 1, w, rows, n, s, c)[:m]
    ok = rng.rand(m, w) < 0.8 if use_ok else None
    jw = words if ok is None else np.where(ok, words, words & 0x7FFFFFFF)
    state, events, comp = model_consume(leaves, None, [jw], n, blocks,
                                        compact)
    plain_state = tq.VoteState(*[torch.from_numpy(a.copy())
                                 for a in leaves])
    pev, pcomp = tq.fabric_step_plain(
        plain_state, tq.words_tensor(words), n, v, compact=compact,
        ok=None if ok is None else torch.from_numpy(ok))
    ours = list(state) + list(events) + (list(comp) if compact else [])
    theirs = list(plain_state) + list(pev) + (list(pcomp) if compact
                                              else [])
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    if not compact:  # prepared_acked and the frontier as they were
        assert np.array_equal(state.prepared_acked.numpy(), leaves[5])
        assert np.array_equal(state.frontier.numpy(), leaves[6])
    jstate = jq.VoteState(*[jnp.asarray(a) for a in leaves])
    if case.startswith("k13_sharded"):
        from jax.sharding import Mesh

        assert m == 1 and rows == n and not compact
        jfn = jq.make_sharded_step(
            Mesh(np.array(jax.devices()[:v]), ("validators",)), n)
        jst, jev = jfn(jq.VoteState(*[x[0] for x in jstate]),
                       jq.unpack_words(jnp.asarray(jw[0])))
        for a_all, b_all in ((jst, state), (jev, events)):
            for a, b in zip(a_all, b_all):
                assert np.array_equal(np.asarray(a), b.numpy()[0])
        return events
    jplan = jcp.plan_for(jq.make_fabric_mesh(jax.devices()[:8], shape), n,
                         rows, jq.ORDER_DELTA_CAP)
    jst, jev, jcomp = jplan.step(jstate, jnp.asarray(jw))
    if not compact:  # the reference's full-events step keeps both
        jst = jst._replace(prepared_acked=jnp.asarray(leaves[5]),
                           frontier=jnp.asarray(leaves[6]))
    outs = [(jst, state), (jev, events)] + ([(jcomp, comp)] if compact
                                            else [])
    for a_all, b_all in outs:
        for a, b in zip(a_all, b_all):
            assert np.array_equal(np.asarray(a), b.numpy())
    return events


@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_model_matches_plain_and_jax(case):
    shape, m, n, rows, s, c, k, w, blocks, k13 = CASES[case]
    if k13 is not None and case.startswith("k13_sharded"):
        v = shape[0]  # one validator axis
    else:
        v = shape[1] if len(shape) > 1 else 1
    assert rows % v == 0 and 1 <= blocks <= rows
    assert k13 is not None or blocks > v
    kin = sorted(x for x in CASES if (CASES[x][-1] is None) == (k13 is None))
    rng = np.random.RandomState(kin.index(case) + (70 if k13 is None else 90))
    leaves = _leaves(rng, m, rows, n, s, c)
    if k13 is not None:
        assert k == 1
        events = _check_k13(case, rng, leaves, shape, m, n, rows, s, c, w,
                            blocks, v, *k13)
        assert int(events.ordered.sum()) > 0
        return
    mix = np.array([0, 1, 2, 3, 4, 5, s - 1, s, s + 3], np.int32)
    slides = mix[rng.randint(0, len(mix), (k, m))]
    slides[:, 0] = 0
    if k > 1:
        slides[1, -1] = 1 + (s - 2) // 2  # 0 < d < S on the invalid row
    words = [_words(rng, m, w, rows, n, s, c) for _ in range(k)]
    if k > 1:
        words[k - 1][:] = 0  # a slot of nothing but invalid words
    state, events, comp = model_consume(leaves, slides, words, n, blocks)
    plain_state = tq.VoteState(*[torch.from_numpy(a.copy())
                                 for a in leaves])
    pev, pcomp = tq.resident_tile_plain(
        plain_state, torch.from_numpy(slides),
        [tq.words_tensor(x) for x in words], n, v)
    for a, b in zip(list(state) + list(events) + list(comp),
                    list(plain_state) + list(pev) + list(pcomp)):
        assert torch.equal(a, b)
    jmesh = jq.make_fabric_mesh(jax.devices()[:8], shape)
    jstep = jcp.resident_plan_for(jmesh, n, rows, jq.ORDER_DELTA_CAP, k, w)
    jout = jstep(jq.VoteState(*[jnp.asarray(a) for a in leaves]),
                 jnp.asarray(slides), *[jnp.asarray(x) for x in words])
    for j_all, t_all in zip(jout, (state, events, comp)):
        for a, b in zip(j_all, t_all):
            assert np.array_equal(np.asarray(a), b.numpy())
    tstep = tcp.resident_plan_for(tq.make_fabric_mesh(["cpu"] * 8, shape),
                                  n, rows, tq.ORDER_DELTA_CAP, k, w, "cpu")
    assert tstep is not None
    assert int(events.ordered.sum()) > 0 or (slides > 0).any()


def test_slide_run_words_and_edges():
    """``slide_run`` alone on runs at every start offset mod 4, S % 4 of 0
    to 3, d of 1 to S + 1: equal to a row-by-row roll; the bytes around
    the run untouched; whole-word stores only inside the run."""
    rng = np.random.RandomState(5)
    for s in (4, 5, 6, 7, 13, 300):
        for nr in (1, 3):
            for start in range(4, 8):
                for d in sorted({1, 2, 3, 4, 5, s - 1, s, s + 1} - {0}):
                    if d < 1:
                        continue
                    buf = rng.randint(0, 256, start + nr * s + 9).astype(
                        np.uint8)
                    before = buf.copy()
                    whole = slide_run(buf, start, nr * s, s, d)
                    rows_in = before[start:start + nr * s].reshape(nr, s)
                    want = np.zeros_like(rows_in)
                    if d < s:
                        want[:, :s - d] = rows_in[:, d:]
                    got = buf[start:start + nr * s].reshape(nr, s)
                    assert np.array_equal(got, want), (s, nr, start, d)
                    assert np.array_equal(buf[:start], before[:start])
                    assert np.array_equal(buf[start + nr * s:],
                                          before[start + nr * s:])
                    for a in whole:
                        assert a % 4 == 0 and start <= a
                        assert a + 4 <= start + nr * s


def test_cluster_blocks_choice():
    """Enough blocks that none holds more than TILE_BLOCK_BYTES of a
    plane (TILE_SLIDE_BYTES when a member may slide), within one wave of
    the card (M x B blocks resident at once), B of 1 to TILE_RULE_MAX and
    at most the rows; the rows split with none empty."""
    resident = 132 * 4  # an H100's SMs x 4 blocks of 62 registers a thread
    for sliding, picks in (
            (False, {(256, 300, 256): 2, (64, 15, 64): 1, (64, 300, 64): 2,
                     (16, 30, 96): 1, (64, 300, 1): 2, (252, 30, 96): 1,
                     (256, 300, 64): 5, (8, 4096, 16): 2, (3, 4096, 1): 1,
                     (1024, 4096, 1): 7, (256, 300, 1024): 1}),
            (True, {(256, 300, 256): 2, (64, 15, 64): 1, (64, 300, 64): 5,
                    (16, 30, 96): 1, (64, 300, 1): 5, (252, 30, 96): 2,
                    (256, 300, 64): 7, (8, 4096, 16): 7, (3, 4096, 1): 3,
                    (1024, 4096, 1): 7, (256, 300, 1024): 1})):
        # phases H, R, F1, F2 and G first
        for (n, s, m), b in picks.items():
            assert tq.tile_cluster_blocks(n, s, m, resident, sliding) == b
        for n in (1, 5, 64, 256, 600):
            for s in (15, 300, 4096):
                for m in (1, 64, 256):
                    b = tq.tile_cluster_blocks(n, s, m, resident, sliding)
                    assert 1 <= b <= min(n, tq.TILE_RULE_MAX)
                    assert m * b <= resident or b == 1
                    assert b >= tq.tile_cluster_blocks(n, s, m, resident)
                    spans = [rows_of(r, n, b) for r in range(b)]
                    assert sum(nr for _, nr in spans) == n
                    assert all(nr >= 1 for _, nr in spans)
    assert tq.tile_cluster_blocks(64, 300, 64, resident) \
        == tq.tile_cluster_blocks(64, 300, 64, resident, False)


# K9 on the cluster kernel at one validator tile (the unsharded plan, no
# pad rows): (members, validators, S, C, slots, width, B); N odd in each
K9_CASES = {
    "k9_n7_s30_k4_b1": (6, 7, 30, 6, 4, 32, 1),
    "k9_n7_s30_k4_b2": (6, 7, 30, 6, 4, 32, 2),
    "k9_n5_s15_k2_b3": (4, 5, 15, 3, 2, 24, 3),
    "k9_n9_s300_k3_b3": (3, 9, 300, 3, 3, 48, 3),
}


@pytest.mark.parametrize("case", sorted(K9_CASES))
def test_k9_cluster_model_matches_plain_and_jax(case):
    """K9 (``resident_step`` on the card) is the cluster kernel at v = 1:
    the model at B blocks against ``resident_step_plain``, the port's
    unsharded ``resident_plan_for`` on the CPU and JAX's
    ``resident_plan_for(None, ...)``, with slides of every class, one
    member sliding by a checkpoint interval in the first slot and an
    all-invalid slot."""
    m, n, s, c, k, w, blocks = K9_CASES[case]
    assert n % 2 == 1 and 1 <= blocks <= n
    rng = np.random.RandomState(110 + sorted(K9_CASES).index(case))
    leaves = _leaves(rng, m, n, n, s, c)
    mix = np.array([0, 1, 2, 3, 5, s - 1, s, s + 3], np.int32)
    slides = mix[rng.randint(0, len(mix), (k, m))]
    slides[:, 0] = 0
    slides[0, 1] = max(1, s // 3)  # the pool's pattern: one member, one
    words = [_words(rng, m, w, n, n, s, c) for _ in range(k)]
    words[k - 1][:] = 0  # a slot of nothing but invalid words
    state, events, comp = model_consume(leaves, slides, words, n, blocks)
    ours = list(state) + list(events) + list(comp)
    assert int(events.ordered.sum()) > 0

    plain_state = tq.VoteState(*[torch.from_numpy(a.copy()) for a in leaves])
    pev, pcomp = tq.resident_step_plain(
        plain_state, torch.from_numpy(slides),
        tq.words_tensor(np.stack(words)), n)
    for a, b in zip(ours, list(plain_state) + list(pev) + list(pcomp)):
        assert torch.equal(a, b)

    tstep = tcp.resident_plan_for(None, n, n, tq.ORDER_DELTA_CAP, k, w,
                                  "cpu")
    tout = tstep(tq.VoteState(*[torch.from_numpy(a.copy()) for a in leaves]),
                 torch.from_numpy(slides),
                 *[tq.words_tensor(x) for x in words])
    for t_all, o_all in zip(tout, (state, events, comp)):
        for a, b in zip(t_all, o_all):
            assert torch.equal(a, b)

    jstep = jcp.resident_plan_for(None, n, n, jq.ORDER_DELTA_CAP, k, w)
    jout = jstep(jq.VoteState(*[jnp.asarray(a) for a in leaves]),
                 jnp.asarray(slides), *[jnp.asarray(x) for x in words])
    for j_all, o_all in zip(jout, (state, events, comp)):
        for a, b in zip(j_all, o_all):
            assert np.array_equal(np.asarray(a), b.numpy())


def slide_grid_blocks(n, s):
    """``csrc/window.cu``'s slide grid for one member: ``per`` validator
    rows a block (about one 4-byte word a thread), then blocks 0-2 on the
    three slot-axis rows and the row groups of the prepare and of the
    commit plane, each block ONE run inside one plane: (leaf, first row,
    rows) per block."""
    per = max(1, min(n, 4 * THREADS // s))
    groups = -(-n // per)
    out = [("pp", 0, 1), ("ordered", 0, 1), ("acked", 0, 1)]
    for plane in ("pv", "cv"):
        for g in range(groups):
            out.append((plane, g * per, min(per, n - g * per)))
    return out


@pytest.mark.parametrize("n,s,c", [(64, 300, 3), (16, 30, 6), (7, 13, 2),
                                   (5, 1100, 4)])
def test_window_slide_grid_model_matches_plain_and_jax(n, s, c):
    """K8's slide, the card's grid modelled: every block rolls one run
    that stays inside one plane with ``slide_run`` (bytes outside the run
    poisoned); the runs of a member cover its rows once. Sliding members
    of every delta class, in any block order, give ``slide_plain``'s and
    JAX's ``_slide_body``'s state."""
    rng = np.random.RandomState(n + s)
    m = 4
    leaves = _leaves(rng, m, n, n, s, c)
    deltas = np.array([0, 1 + s // 3, s, 3], np.int32)
    blocks = slide_grid_blocks(n, s)
    covered = {(leaf, r) for leaf, r0, nr in blocks
               for r in range(r0, r0 + nr)}
    assert len(covered) == 3 + 2 * n
    assert sum(nr for _, _, nr in blocks) == 3 + 2 * n
    pp, pv, cv, ck, ordered, acked, frontier = [a.copy() for a in leaves]
    flat = {"pp": pp.reshape(-1), "ordered": ordered.reshape(-1),
            "acked": acked.reshape(-1), "pv": pv.reshape(-1),
            "cv": cv.reshape(-1)}
    for i in rng.permutation(m * len(blocks)):
        member, b = divmod(int(i), len(blocks))
        leaf, r0, nr = blocks[b]
        d = int(deltas[member])
        if d <= 0:
            continue
        rows = 1 if leaf in ("pp", "ordered", "acked") else n
        slide_run(flat[leaf], (member * rows + r0) * s, nr * s, s, d)
        if (leaf, r0) == ("pp", 0):
            ck[member] = 0
            frontier[member] = max(int(frontier[member]) - d, 0)
    got = tq.VoteState(*[torch.from_numpy(a) for a in
                         (pp, pv, cv, ck, ordered, acked, frontier)])
    plain = tq.VoteState(*[torch.from_numpy(a.copy()) for a in leaves])
    tq.slide_plain(plain, torch.from_numpy(deltas))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    want = jcp._slide_body(jq.VoteState(*[jnp.asarray(a) for a in leaves]),
                           jnp.asarray(deltas))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
