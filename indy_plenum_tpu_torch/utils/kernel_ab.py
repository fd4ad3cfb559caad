"""A/B timing of the PyTorch + CUDA port's verify, SHA-512, mod-L,
quorum-step, resident-step, fused-step, slide, zero, ring, fixed-length
SHA-256 and commit-hash kernels, for comparing two
checkouts of the repo inside one call on one card. Run this one file by
its path from each checkout's root, in turns (parent, change, change,
parent):

    python3 <checkout>/indy_plenum_tpu_torch/utils/kernel_ab.py --tag change

It imports the port and ``chip_smoke.py`` of the checkout it runs from
(the current directory), and uses only what both the per-wave K11
(before its redesign) and the commit-plan K11 offer, so the same file
times either. One JSON line:

- K7 (64 x 64 x 300, W 128: phases A and 4), K9 (k = 4 slots of that
  group, zero slides on the card), K13 on (4, 2) and the tiled K9 at
  phase H's n = 256 (k = 4, no slide) and at phase R's shape (M = N =
  64, S = 15, C = 3, W = 128, k = 4 on (4, 2), one member in four
  sliding by 5 in the first slot): device
  ms per call behind a spin (``chip_smoke._kernel_ms``) and call ms (CUDA
  events around back-to-back calls, host included); where the checkout
  picks the tiled K9's cluster size (``tile_cluster_blocks``), both
  consumes at cluster sizes of 1, 2, 4 and 8 blocks too;
- K13 at phase H's shape on v = 1 (the (8,) mesh's step) beside K7 on
  the same state and words, and where the checkout can force K13's
  cluster size, on v = 1 and 2 at 1, 2, 4 and 8 blocks; where K13 still
  takes the verdicts as ``ok`` (a checkout whose sharded K14 is K-c then
  K13), K13 at phase G's shape with them, there also at each of 1 to 8
  blocks;
- K10 at a 4,096-proof chunk of the catchup-proof tree (17 levels),
  dense and indexed, one proof alone (its dependent-chain floor) and,
  where the checkout sets the block size, at 32, 64 and 128 threads;
- K-b (``reduce_mod_l``) on seeded digests at the drain's 8,192 rows and
  at 32,768;
- K11 per SMT commit of phase C's shape (320 new keys into 3,200): the
  call ms of the commit's hashing run as per-level waves
  (``merkle_node_hash`` at each device level's width, one call after
  another: host gaps included) and their device ms where K11 is the
  per-wave kernel; where the checkout has it, the device and call ms of
  ONE commit plan (``merkle_plan_hash``); and the
  wall ms of one ``apply_batch`` of those keys with device and with host
  waves, each the median of five fresh states on one populated tree;
- K-c (``ted.verify_kernel``) at the ingress drain's 8,192 signatures
  and at ``bench.py``'s 32,768, ``verify_kernel_full`` at 32,768 beside
  it, and K14 (``step.fused_step``) and the sharded K14 on 4 tiles on
  phase G's 8,192 signed votes, with K-c alone on those signatures, K14
  into a one-row, one-slot member (phase G's less it is K14's tail) and
  K7 on the good votes' words at phase G's shape (a parent's second
  launch): device ms behind the spin and call ms; and under
  ``fused_rounds_ms`` K14, K-c alone and the one-slot K14 again in four
  rounds that alternate them (K14's tail is K14 less K-c alone);
- K12 (``s2.sha256_fixed``) on 4,096 seeded rows of 64, 55, 119 and 200
  bytes and on one 64-byte row alone (its chain floor);
- K-a (``s5.sha512_blocks``) on the drain's padded blocks (2 a message)
  at 8,192 and 32,768 messages and on one message alone (its chain
  floor);
- K1 (``ring_shift_planes``, one ring step) and the rotation
  (``rotate_planes`` by R / 2) at phase H's state (M = N = 256, S = 300,
  C = 3, on (8,)) and at phase R's (M = N = 64, S = 15, C = 3, on (4,
  2)), beside two yardsticks of the same roll of every leaf:
  ``torch.roll`` and two ``Tensor.copy_`` slices a leaf into a buffer
  made once, and ``Tensor.clone`` of each leaf (the same bytes, no
  rotation);
- K9 (``q.resident_step``) at phase F1's consume (64 x 64 x 300, C 3)
  and F2's (96 x 16 x 30, C 6), k = 4 slots of 128 words, with no
  sliding member and with one sliding by the phase's ``CHK_FREQ`` in the
  first slot (host slides, as the ring passes them: the cluster size is
  picked from them, their copy timed too), and the cluster kernel at one
  validator tile, slides on the card, forced to each of 1 to 8 blocks at
  both (``resident_step_<shape>[_slide]_b<B>``; a
  parent that predates K9 on the cluster kernel times its tiled K9 at
  v = 1 there);
- K8's slide through ``q.slide_state`` with host deltas, one member
  sliding, and K8's zero through ``q.zero_members`` with a host mask of
  one member: at 64 x 64 x 300 (slide by ``CHK_FREQ``) and at phase B's
  shape (96 x 16 x 30, C 6; slide by 5), device and call ms; then ONE
  ``torch.profiler`` session (a second in one process has come back
  empty) over 20 such slides, 20 such zeros and 20 of K9's F1 consumes,
  tiled K9 consumes and K13 steps at phase H's shape, the device's work
  split by kernel name (a copy to the card shows as ``Memcpy HtoD``; K9,
  the tiled K9 and K13 each as one launch of ``resident_tile_kernel``, a
  parent's K9 as ``resident_step_kernel``, its zero as ``zero_kernel``
  after a copy of the mask);
- the card's name and power limit.

It exits non-zero without a card.
"""
from __future__ import annotations

# da: allow-file[device-sync,nondet-source] -- a measuring tool: its clocks and syncs time kernels for a report and never feed a result

import argparse
import json
import os
import sys
import time

import numpy as np


def _commit_inputs(n_keys, batch):
    """A populated state's key-value store and root, the writes of one
    commit, and the widths of its device levels (the waves of at least
    DEVICE_MIN_BATCH nodes, bottom up), recorded from a host commit."""
    from indy_plenum_tpu_torch.server.catchup.catchup_rep_service import \
        DEVICE_MIN_BATCH
    from indy_plenum_tpu_torch.state.sparse_merkle_state import \
        SparseMerkleState
    from indy_plenum_tpu_torch.storage.kv_store import \
        KeyValueStorageInMemory

    kv = KeyValueStorageInMemory()
    base = SparseMerkleState(kv=kv, commit_mode="host", device="cpu")
    base.apply_batch([(b"key%08d" % i, b"v%d" % i) for i in range(n_keys)])
    base.commit()
    writes = [(b"new%08d" % i, b"w%d" % i) for i in range(batch)]
    probe = SparseMerkleState(kv=kv, initial_root=base.committed_head_hash,
                              commit_mode="host", device="cpu")
    widths = []
    resolve = probe._resolve_waves

    def record(waves):
        widths.extend(len(w) for w in reversed(waves)
                      if len(w) >= DEVICE_MIN_BATCH)
        return resolve(waves)

    probe._resolve_waves = record
    probe.apply_batch(writes)
    return kv, base.committed_head_hash, writes, widths


def verify_and_fused(out, timed, cs, dev, rng):
    """K-c at 8,192 and 32,768, verify_kernel_full at 32,768, K14 at phase
    G's 8,192 votes, and its K13 half alone (with the verdicts as ``ok``)
    at the wrapper's cluster size and, where the checkout can force it, at
    each of 1 to 8 blocks."""
    import inspect

    import torch
    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import sha512 as s5
    from indy_plenum_tpu_torch.tpu import step as st

    signers, reqs = cs.make_signed_requests(seed=64)
    _, arrays = cs.verify_inputs(signers, reqs, rng, cs.DRAIN)
    sig = [torch.from_numpy(a).to(dev) for a in arrays]
    big_n = cs.BENCH_VERIFY_BATCH // cs.DRAIN
    big = [t.repeat(big_n, 1) for t in sig]
    msgs = [r.signing_bytes() for r in reqs]
    prefixes = [bytes(arrays[1][i]) + bytes(arrays[0][i])
                for i in range(cs.DRAIN)]
    blocks_np, counts_np = s5.pad_ed25519_messages(
        prefixes, [msgs[i % len(msgs)] for i in range(cs.DRAIN)],
        ted.max_blocks_for(msgs))
    blocks = torch.from_numpy(blocks_np).to(dev).repeat(big_n, 1, 1)
    counts = torch.from_numpy(counts_np).to(dev).repeat(big_n)
    timed("sha512_blocks_8192", lambda: s5.sha512_blocks(
        blocks[:cs.DRAIN], counts[:cs.DRAIN]), 20)
    timed("sha512_blocks_32768", lambda: s5.sha512_blocks(blocks, counts),
          20)
    one_block, one_count = blocks[:1].contiguous(), counts[:1].contiguous()
    timed("sha512_blocks_1", lambda: s5.sha512_blocks(one_block, one_count),
          20)
    timed("verify_8192", lambda: ted.verify_kernel(*sig), 5)
    timed("verify_32768", lambda: ted.verify_kernel(*big), 3)
    timed("verify_full_32768", lambda: ted.verify_kernel_full(
        big[0], big[1], big[2], blocks, counts), 3)
    out["verifies_per_s_32768"] = cs.BENCH_VERIFY_BATCH / (
        out["call_ms"]["verify_full_32768"] / 1e3)
    _, words_np, farrays, expect = cs.fused_inputs(rng, cs.N_VALIDATORS,
                                                   cs.LOG_SIZE, cs.DRAIN)
    words = q.words_tensor(words_np, dev)
    fsig = [torch.from_numpy(a).to(dev) for a in farrays]
    state = q.init_state(cs.N_VALIDATORS, cs.LOG_SIZE, cs.N_CHECKPOINTS, 1,
                         dev)
    timed("fused_step_8192", lambda: st.fused_step(
        state, words, *fsig, n_validators=cs.N_VALIDATORS, device=dev), 5)
    sharded = st.make_sharded_fused_step(
        q.make_fabric_mesh([dev] * 4, (4,), ("validators",)),
        cs.N_VALIDATORS)
    sstate = q.init_state(cs.N_VALIDATORS, cs.LOG_SIZE, cs.N_CHECKPOINTS,
                          1, dev)
    timed("sharded_fused_step_8192", lambda: sharded(sstate, words, *fsig),
          5)
    timed("verify_g", lambda: ted.verify_kernel(*fsig), 5)
    # K14 into a one-row, one-slot member: its verify and scatter with a
    # tail that has nothing to count (phase G's less it is the tail), and
    # K7 on the good votes' words at phase G's shape (the parent's second
    # launch)
    tiny = q.init_state(1, 1, 1, 1, dev)
    timed("fused_step_tiny", lambda: st.fused_step(
        tiny, words, *fsig, n_validators=cs.N_VALIDATORS, device=dev), 5)
    good = q.words_tensor(np.where(expect[None, :], words_np, 0), dev)
    kstate = q.init_state(cs.N_VALIDATORS, cs.LOG_SIZE, cs.N_CHECKPOINTS,
                          1, dev)
    timed("quorum_step_g", lambda: q.step(kstate, good, cs.N_VALIDATORS),
          20)
    # the three again in four rounds that alternate them in this process:
    # the tail is K14 less K-c alone, round by round
    rounds = {"fused_step_8192": lambda: st.fused_step(
        state, words, *fsig, n_validators=cs.N_VALIDATORS, device=dev),
        "verify_g": lambda: ted.verify_kernel(*fsig),
        "fused_step_tiny": lambda: st.fused_step(
            tiny, words, *fsig, n_validators=cs.N_VALIDATORS, device=dev)}
    out["fused_rounds_ms"] = {k: [] for k in rounds}
    for _ in range(4):
        for k, fn in rounds.items():
            out["fused_rounds_ms"][k].append(cs._kernel_ms(fn, 5))
    if "ok" not in inspect.signature(q.fabric_step).parameters:
        return
    # a parent's sharded K14 second half: K13 on 4 tiles with the verdicts
    ok = torch.from_numpy(expect[None, :]).to(dev)
    gstate = q.init_state(cs.N_VALIDATORS, cs.LOG_SIZE, cs.N_CHECKPOINTS,
                          1, dev)
    timed("fabric_step_g", lambda: q.fabric_step(
        gstate, words, cs.N_VALIDATORS, 4, compact=False, ok=ok), 20)
    for b in range(1, 9):
        timed(f"fabric_step_g_b{b}", lambda: q._fabric_kernel(
            gstate, words, cs.N_VALIDATORS, 4, q.ORDER_DELTA_CAP,
            False, ok, "fabric_step", b), 20)


def fixed_report(timed, dev, rng):
    """K12 on 4,096 seeded rows of 64, 55, 119 and 200 bytes, and one
    64-byte row alone (its chain floor)."""
    import torch
    from indy_plenum_tpu_torch.tpu import sha256 as s2

    for length in (64, 55, 119, 200):
        rows = torch.from_numpy(rng.randint(0, 256, (4096, length)).astype(
            np.uint8)).to(dev)
        timed(f"sha256_fixed_{length}", lambda: s2.sha256_fixed(rows), 20)
        if length == 64:
            one = rows[:1].contiguous()
            timed("sha256_fixed_1", lambda: s2.sha256_fixed(one), 20)


def _k13(q, state, words, n, v, compact, blocks):
    """K13 forced to ``blocks`` blocks a member, in either checkout's
    wrapper (one whose K13 took a verdict operand and a counter, or not)."""
    import inspect

    if "ok" in inspect.signature(q._fabric_kernel).parameters:
        return q._fabric_kernel(state, words, n, v, q.ORDER_DELTA_CAP,
                                compact, None, "fabric_step", blocks)
    return q._fabric_kernel(state, words, n, v, q.ORDER_DELTA_CAP, compact,
                            blocks)


def resident_report(timed, cs, dev, rng):
    """K9 at phase F1's consume (64 x 64 x 300, C 3) and at F2's (96 x 16
    x 30, C 6), k = 4 slots of 128 words, with no sliding member and with
    one sliding by the phase's checkpoint interval in the first slot;
    then both on every cluster size of 1 to 8 blocks (the cluster kernel
    at one validator tile, its size forced). The wrapper's rows pass host
    slides, as the ring does: it picks its cluster size from them, and
    their copy to the card and the host's pace between calls are in the
    row. The forced rows pass the slides on the card: the kernel alone."""
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q

    k, w = 4, cs.RESIDENT_WIDTH
    for tag, (m, n, s, c, d) in window_shapes(cs).items():
        votes = cs._random_votes(dev, rng, m, n, s, c)
        words = q.words_tensor(cs.resident_words(rng, k, m, w, n, s), dev)
        still = torch.zeros((k, m), dtype=torch.int32)
        one = still.clone()
        one[0, rng.randint(m)] = d
        for arm, slides in (("", still), ("_slide", one)):
            name = f"resident_step_{tag}{arm}"
            timed(name, lambda: q.resident_step(votes, slides, words, n), 20)
            on_card = slides.to(dev)
            for b in range(1, 9):
                timed(f"{name}_b{b}", lambda: q._resident_tile_kernel(
                    votes, on_card, words, n, 1, q.ORDER_DELTA_CAP, b), 20)


def window_shapes(cs):
    """The main path's two group shapes (M, N, S, C, checkpoint interval):
    phases A, F1 and 4, and phases B and F2."""
    return {"64x64x300": (cs.N_VALIDATORS, cs.N_VALIDATORS, cs.LOG_SIZE,
                          cs.N_CHECKPOINTS, cs.CHK_FREQ),
            "96x16x30": (cs.B_NODES * cs.B_INSTANCES, cs.B_NODES,
                         cs.B_LOG_SIZE, cs.B_LOG_SIZE // cs.B_CHK_FREQ,
                         cs.B_CHK_FREQ)}


def slide_report(out, timed, cs, dev, rng, consumes):
    """K8's slide with host deltas and K8's zero with a host mask (one
    member each) at the main path's two group shapes, then one profile of
    20 slides and 20 zeros at 64 x 64 x 300 and 20 calls of ``consumes``
    (K9 at phase F1's consume, the tiled K9's consume and K13's step at
    phase H's shape)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from indy_plenum_tpu_torch.tpu import quorum as q

    shapes = window_shapes(cs)
    for tag, (m, n, s, c, d) in shapes.items():
        votes = cs._random_votes(dev, rng, m, n, s, c)
        deltas = torch.zeros(m, dtype=torch.int32)
        deltas[rng.randint(m)] = d
        mask = torch.zeros(m, dtype=torch.bool)
        mask[rng.randint(m)] = True
        timed(f"slide_{tag}", lambda: q.slide_state(votes, deltas), 50)
        timed(f"zero_{tag}", lambda: q.zero_members(votes, mask), 50)
    m, n, s, c, d = shapes["64x64x300"]
    votes = cs._random_votes(dev, rng, m, n, s, c)
    deltas = torch.zeros(m, dtype=torch.int32)
    deltas[rng.randint(m)] = d
    mask = torch.zeros(m, dtype=torch.bool)
    mask[rng.randint(m)] = True
    calls = 20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            q.slide_state(votes, deltas)
        for _ in range(calls):
            q.zero_members(votes, mask)
        for _ in range(calls):
            consumes()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:64]
            count, us = split.get(key, (0, 0.0))
            split[key] = (count + 1, us + e.time_range.elapsed_us())
    out["profile"] = {
        "calls": calls,
        "device": {k: {"count": cnt, "us_per_call": us / calls}
                   for k, (cnt, us) in split.items()}}


def mod_l_report(timed, cs, dev, rng):
    """K-b at the drain's 8,192 rows and at 32,768."""
    import torch
    from indy_plenum_tpu_torch.tpu import sha512 as s5

    for batch in (cs.DRAIN, cs.BENCH_VERIFY_BATCH):
        digest = torch.from_numpy(rng.randint(0, 256, (batch, 64)).astype(
            np.uint8)).to(dev)
        timed(f"reduce_mod_l_{batch}", lambda: s5.reduce_mod_l(digest), 20)


def tile_report(timed, cs, dev, rng, fstate, ftile, fslides):
    """The tiled K9 at phase R's shape with slides and, where the checkout
    has a cluster size to pick, at both shapes on cluster sizes of 1, 2,
    4 and 8 blocks."""
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q

    n, s, k = 64, 15, 4
    c = s // 5
    rstate = cs.fabric_state(dev, rng, n, n, c, m=n, s=s)
    rwords = q.words_tensor(np.stack([cs.fabric_words(rng, n, 128, n, s, c)
                                      for _ in range(k)]), dev)
    rslides = torch.zeros((k, n), dtype=torch.int32)
    rslides[0, ::4] = 5
    timed("resident_tile_r",
          lambda: q.resident_tile_step(rstate, rslides, rwords, n, 2), 20)
    if hasattr(q, "tile_cluster_blocks"):
        fm = fstate.frontier.shape[0]
        for b in (1, 2, 4, 8):
            timed(f"resident_tile_b{b}", lambda: q._resident_tile_kernel(
                fstate, fslides, ftile, fm, 2, q.ORDER_DELTA_CAP, b), 20)
            timed(f"resident_tile_r_b{b}", lambda: q._resident_tile_kernel(
                rstate, rslides, rwords, n, 2, q.ORDER_DELTA_CAP, b), 20)


def ring_report(timed, cs, dev, rng, fstate):
    """K1 (one ring step) and the rotation (R / 2 rows) at phase H's state
    on (8,) and at phase R's on (4, 2), with ``torch.roll`` and two
    ``Tensor.copy_`` slices a leaf and ``Tensor.clone`` as yardsticks."""
    import torch
    from indy_plenum_tpu_torch.tpu import rebalance as rb
    from indy_plenum_tpu_torch.tpu import ring_exchange as rx

    n, s = 64, 15
    rstate = cs.fabric_state(dev, rng, n, n, s // 5, m=n, s=s)
    for tag, state, shape in (("h", fstate, (8,)), ("r", rstate, (4, 2))):
        mesh = cs.fabric_mesh(dev, shape)
        m = state.frontier.shape[0]
        r = m // shape[0]
        timed(f"ring_shift_{tag}",
              lambda: rx.ring_shift_planes(state, mesh, 1), 20)
        timed(f"rotate_planes_{tag}",
              lambda: rb.rotate_planes(state, mesh, r // 2, r), 20)
        timed(f"torch_roll_{tag}",
              lambda: [torch.roll(x, r, dims=0) for x in state], 20)
        bufs = [torch.empty_like(x) for x in state]

        def copies():
            for x, y in zip(state, bufs):
                y[r:].copy_(x[:m - r])
                y[:r].copy_(x[m - r:])

        timed(f"copy_slices_{tag}", copies, 20)
        timed(f"clone_{tag}", lambda: [x.clone() for x in state], 20)


def fabric_report(timed, cs, dev, fstate, fwords):
    """K13 at phase H's shape on v = 1 (the (8,) mesh's step) beside K7 on
    the same state and words and, where the checkout can force the
    cluster size, K13 on v = 1 and 2 at each of 1, 2, 4 and 8 blocks."""
    import inspect

    from indy_plenum_tpu_torch.tpu import quorum as q

    fm = fstate.frontier.shape[0]
    timed("fabric_step_v1", lambda: q.fabric_step(fstate, fwords, fm, 1), 20)
    timed("quorum_step_h", lambda: q.step_compact(fstate, fwords, fm), 20)
    if "blocks" not in inspect.signature(q._fabric_kernel).parameters:
        return
    for v in (1, 2):
        for b in (1, 2, 4, 8):
            timed(f"fabric_step_v{v}_b{b}", lambda: _k13(
                q, fstate, fwords, fm, v, True, b), 20)


def audit_report(timed, cs, dev):
    """K10 at one 4,096-proof chunk of the catchup-proof tree (17 levels),
    dense and indexed; one proof of it alone (the dependent-chain floor);
    where the checkout can set the block size, the chunk at 32, 64 and
    128 threads a block."""
    from indy_plenum_tpu_torch.server.catchup import catchup_rep_service \
        as crs
    from indy_plenum_tpu_torch.tpu import sha256 as s2

    chunk = crs._ChunkedDeviceVerify.CHUNK
    tree, leaf_data, indices, paths = cs.audit_corpus(count=chunk)
    t = cs._fold_inputs(dev, leaf_data, indices, paths,
                        [tree.tree_size] * chunk, [tree.root_hash] * chunk)
    dense = [t[k] for k in ("leaf", "index", "path", "path_len",
                            "tree_size", "root")]
    idx = [t[k] for k in ("leaf", "index", "table", "path_idx", "path_len",
                          "tree_size", "root")]
    one = [a if a is t["table"] else a[:1] for a in idx]
    if not (bool(s2.verify_audit_paths(*dense).all())
            and bool(s2.verify_audit_paths_indexed(*idx).all())):
        raise AssertionError("K10: a good proof failed")
    timed("audit_paths", lambda: s2.verify_audit_paths(*dense), 20)
    timed("audit_paths_indexed",
          lambda: s2.verify_audit_paths_indexed(*idx), 20)
    timed("audit_chain_1", lambda: s2.verify_audit_paths_indexed(*one), 20)
    if hasattr(s2, "_audit_indexed_kernel"):
        for th in (32, 64, 128):
            timed(f"audit_paths_indexed_t{th}",
                  lambda: s2._audit_indexed_kernel(*idx, th), 20)
            timed(f"audit_paths_t{th}",
                  lambda: s2._audit_dense_kernel(*dense, th), 20)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", required=True)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from indy_plenum_tpu_torch.state.sparse_merkle_state import \
        SparseMerkleState
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import sha256 as s2

    dev = torch.device("cuda")
    rng = np.random.RandomState(7)
    out = {"tag": args.tag, "card": cs._nvidia_smi(), "device_ms": {},
           "call_ms": {}}

    def timed(name, fn, reps):
        out["device_ms"][name] = cs._kernel_ms(fn, reps)
        out["call_ms"][name] = cs._cuda_ms(fn, reps)

    m = n = cs.N_VALIDATORS
    s, c, w = cs.LOG_SIZE, cs.N_CHECKPOINTS, 128
    state = q.init_state(n, s, c, m, dev)
    words = q.words_tensor(cs._wave_words(m, w, n, s, [10], rng), dev)
    timed("quorum_step", lambda: q.step_compact(state, words, n), 50)
    votes = cs._random_votes(dev, rng, m, n, s, c)
    slot_words = q.words_tensor(cs.resident_words(rng, 4, m, w, n, s), dev)
    slides = torch.zeros((4, m), dtype=torch.int32, device=dev)
    timed("resident_step",
          lambda: q.resident_step(votes, slides, slot_words, n), 20)
    fm, fw = cs.FABRIC_N, cs.FABRIC_W
    fstate = cs.fabric_state(dev, rng, fm, fm, c)
    fwords = q.words_tensor(cs.fabric_words(rng, fm, fw, fm, s, c), dev)
    ftile = q.words_tensor(np.stack([cs.fabric_words(rng, fm, fw, fm, s, c)
                                     for _ in range(4)]), dev)
    fslides = torch.zeros((4, fm), dtype=torch.int32, device=dev)
    timed("fabric_step", lambda: q.fabric_step(fstate, fwords, fm, 2), 20)
    timed("resident_tile",
          lambda: q.resident_tile_step(fstate, fslides, ftile, fm, 2), 20)
    tile_report(timed, cs, dev, rng, fstate, ftile, fslides)
    resident_report(timed, cs, dev, rng)
    fabric_report(timed, cs, dev, fstate, fwords)
    ring_report(timed, cs, dev, rng, fstate)
    audit_report(timed, cs, dev)
    mod_l_report(timed, cs, dev, rng)
    fixed_report(timed, dev, rng)

    verify_and_fused(out, timed, cs, dev, rng)

    def consumes():
        q.resident_step(votes, slides, slot_words, n)
        q.resident_tile_step(fstate, fslides, ftile, fm, 2)
        q.fabric_step(fstate, fwords, fm, 2)

    slide_report(out, timed, cs, dev, rng, consumes)

    kv, root, writes, widths = _commit_inputs(3200, 320)
    waves = [(torch.from_numpy(rng.randint(0, 256, (wd, 32)).astype(
        np.uint8)).to(dev), torch.from_numpy(rng.randint(
            0, 256, (wd, 32)).astype(np.uint8)).to(dev)) for wd in widths]

    def per_level():
        for left, right in waves:
            s2.merkle_node_hash(left, right)

    out["k11_levels"] = len(widths)
    out["k11_nodes"] = sum(widths)
    out["call_ms"]["k11_commit_per_level_waves"] = cs._cuda_ms(per_level, 3)
    if hasattr(s2, "merkle_plan_hash"):
        plan = cs.commit_plan(dev)
        refs = torch.from_numpy(np.array(plan[0])).to(dev)
        lits = torch.from_numpy(np.array(plan[1])).to(dev)
        timed("k11_commit_plan",
              lambda: s2.merkle_plan_hash(refs, lits, plan[2]), 10)
    else:  # the per-wave K11: its device time behind the spin too
        out["device_ms"]["k11_commit_per_level_waves"] = cs._kernel_ms(
            per_level, 3)
    for mode in ("device", "host"):
        walls = []
        for _ in range(5):
            st = SparseMerkleState(kv=kv, initial_root=root,
                                   commit_mode=mode, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.apply_batch(writes)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"commit_wall_ms_{mode}"] = float(np.median(walls))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
