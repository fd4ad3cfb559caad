"""Tests of the port that need a CUDA card (marked ``cuda``; each skips
without one, deciding inside the test). This file imports nothing of JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

- the window kernels (K8, ``csrc/window.cu``) against their plain versions
  at the main path's size, bit-equal, with the slide's and the zero's
  launch counts;
- the Ed25519 verify (K-c, ``csrc/ed25519.cu``) against its plain version
  at batches of 1, 3, 7, 8,192 and 32,768 and on the edge rows, and each
  of its four launch variants on the edge rows;
- the resident step (K9, ``csrc/resident_tile.cu`` at one validator
  tile, also at each cluster size) and the fused verify + quorum step
  (K14, ``csrc/ed25519.cu``, one launch a call, also twice back to back)
  against their plain versions at small shapes, bit-equal, and a small
  resident pool on the card against the same pool per tick;
- the SHA-256 kernels (K10-K12, ``csrc/sha256.cu``) against their plain
  versions, hashlib and the host MerkleVerifier, planted faults included;
  K12 also at 4,096 x 64 B, on unaligned rows and on two-round rows;
  K10 at each block size, a 17-shift proof, and a misaligned operand
  refused;
- K11's commit-plan kernel at ``chip_smoke.py``'s three plan shapes (a
  real 320-key commit, a plan whose levels loop over a full cluster, a
  one-level wave) and
  K7 at S = 30, 15 and 300, each one launch, bit-equal to plain;
- a small real-execution pool whose state waves run on the card against
  the same pool with host waves;
- a small signed pool on the card against the same pool on the CPU, through
  checkpoint slides and a view change: the same ordering, the same
  protocol timeline, and every kernel of the path launched;
- the fabric step (K13) and the tiled resident step, one cluster kernel
  (``csrc/resident_tile.cu``), the first also at every cluster size the
  report times it at, with dropped words and without the compact record;
  the ring shift and the rotation's merge (K1, K15, ``csrc/ring.cu``) and the sharded fused step against their
  plain versions, bit-equal, at ``chip_smoke.py``'s full-width shapes (the
  sharded step at n = 16; the tiled step also on its edge shapes), and
  h mod L (K-b) at 8,192 and 32,768 rows against plain and Python ints;
- the forced-rebalance pool (n = 64 on the (2, 2) fabric) on the card
  against the same pool on the CPU, and against its unforced arm;
- SHA-512 (K-a, ``csrc/sha512.cu``) on ragged rows,
  against its plain version and hashlib, and a misaligned view refused;
- the ring shift (K1) and the one-card rotation (one K1 launch, no merge)
  at phase R's state and on odd-sized leaves, and the merge (K15) called
  directly, each bit-equal to its plain version;
- the per-tile layout's kernels with every tile on the card (the tile
  kernel's partials mode and home form, K1's peer form, the rotation's
  K15, the split sharded K14) against their plain versions, a per-tile
  step's launches (v a block), and the forced-rebalance pool on a
  per-tile mesh against the CPU.
"""
import numpy as np
import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_window_kernels_match_plain(card):
    """``chip_smoke.py``'s K8 check: edge deltas, one sliding member,
    every member sliding, all deltas 0, device deltas, 520 sliding members
    (three launches); an empty mask (no launch), one member, every
    member, random members as a host and a CUDA mask, 520 members (three
    launches), at M = N = 64, S = 300."""
    import chip_smoke

    from indy_plenum_tpu_torch.utils import kernel_build as kb

    before = dict(kb.LAUNCHES)
    assert chip_smoke.check_window(
        card, np.random.RandomState(4), chip_smoke.N_VALIDATORS,
        chip_smoke.N_VALIDATORS, chip_smoke.LOG_SIZE,
        chip_smoke.N_CHECKPOINTS, chip_smoke.CHK_FREQ) == (0, 0)
    assert kb.LAUNCHES["window_slide"] == before["window_slide"] + 7
    assert kb.LAUNCHES["window_zero"] == before["window_zero"] + 7


@pytest.mark.cuda
def test_verify_kernel_matches_plain(card):
    """``chip_smoke.py``'s K-c check: the drain's 8,192 rows (RFC vectors,
    signed requests, planted faults), its first 1, 3 and 7 rows, the drain
    four times (32,768) and the edge rows, bit-equal to the plain
    version."""
    import chip_smoke

    signers, reqs = chip_smoke.make_signed_requests(seed=64)
    err, n_ok, n_rows = chip_smoke.check_verify(
        card, signers, reqs, np.random.RandomState(5))
    assert err == 0 and n_rows == chip_smoke.DRAIN and 0 < n_ok < n_rows


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,shared", [(2, 0), (2, 1), (4, 0), (4, 1)])
def test_verify_variants_match_plain_on_edge_rows(card, lanes, shared):
    """Every launch variant of K-c (``csrc/probe/ed25519_variants.cu``, the
    lane probe's library) on the edge rows: a good signature, y >= p, x = 0
    with the sign bit, no square root, S + L, and 61 rows whose
    undecompressible A fall in some groups of a warp and in every group of
    one warp (66 rows, no multiple of a block)."""
    import chip_smoke

    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.utils import verify_lanes_probe as probe

    arrays, _, _, expect = chip_smoke.verify_edge_inputs()
    t = [torch.from_numpy(a).to(card) for a in arrays]
    ok = probe.run_variant(probe.variant_launcher(), t, lanes, bool(shared))
    assert ok.cpu().numpy().tolist() == expect.tolist()
    assert torch.equal(ok, ted.verify_kernel_plain(*t))


def _pool_run(device):
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    cfg = getConfig({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 1,
                     "QuorumTickInterval": 0.05, "LOG_SIZE": 20,
                     "CHK_FREQ": 5})
    pool = SimPool(4, seed=7, config=cfg, device_quorum=True,
                   sign_requests=True, shadow_check=False, trace=True,
                   device=device)
    for i in range(12):
        pool.submit_request(i)
    pool.run_for(10)
    pool.network.disconnect(pool.nodes[0].data.primaries[0])
    pool.run_for(pool.config.ToleratePrimaryDisconnection + 10)
    for i in range(100, 106):
        pool.submit_request(i)
    pool.run_for(12)
    assert pool.honest_nodes_agree()
    return (pool.ordered_hash(), [nd.ordered_digests for nd in pool.nodes],
            [nd.data.view_no for nd in pool.nodes],
            pool.trace.trace_hash(exclude_cats=("dispatch",)))


@pytest.mark.cuda
def test_small_pool_on_card_matches_cpu(card):
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    kb.library()
    kb.reset_launch_counts()
    on_card = _pool_run(None)
    launches = kb.launch_counts()
    assert on_card == _pool_run("cpu")
    assert max(on_card[2]) >= 1
    for name in chip_smoke_path("pool_b"):
        assert launches[name] > 0, name


def chip_smoke_path(tag):
    import chip_smoke

    return chip_smoke.PATH_KERNELS[tag]


@pytest.mark.cuda
def test_sha256_kernels_match_plain(card):
    """``chip_smoke.py``'s K10-K12 checks at a small audit corpus."""
    import chip_smoke

    from indy_plenum_tpu_torch.utils import kernel_build as kb

    rng = np.random.RandomState(8)
    assert chip_smoke.check_sha256(card, rng) == (0, 0)
    before = dict(kb.LAUNCHES)
    corpus = chip_smoke.audit_corpus(4096, 1000, 1024)
    assert chip_smoke.check_audit(card, corpus, rng)[0] == 0
    assert kb.LAUNCHES["audit_paths"] > before["audit_paths"]
    assert kb.LAUNCHES["audit_paths_indexed"] \
        > before["audit_paths_indexed"]


@pytest.mark.cuda
def test_sha256_fixed_lengths_and_alignment(card):
    """K12 at ``chip_smoke.SHA_LENGTHS`` (1,024 rows each), at 4,096 x 64
    B, on rows of odd lengths whose base is not 4-byte aligned, and on
    rows longer than one round's stage (1,500 bytes: two rounds): bit-equal
    to the plain version and to hashlib, one launch a call."""
    import hashlib

    import chip_smoke

    from indy_plenum_tpu_torch.tpu import sha256 as s2
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    rng = np.random.RandomState(16)
    cases = [torch.from_numpy(rng.randint(0, 256, (1024, n)).astype(
        np.uint8)).to(card) for n in chip_smoke.SHA_LENGTHS]
    cases.append(torch.from_numpy(rng.randint(0, 256, (4096, 64)).astype(
        np.uint8)).to(card))
    for length, offset in ((57, 1), (63, 3), (119, 2), (1500, 5)):
        raw = torch.from_numpy(rng.randint(
            0, 256, 300 * length + 16).astype(np.uint8)).to(card)
        cases.append(raw[offset:offset + 300 * length].view(300, length))
    before = kb.LAUNCHES["sha256_fixed"]
    for msgs in cases:
        got = s2.sha256_fixed(msgs)
        assert torch.equal(got.cpu(), s2.sha256_fixed_plain(msgs).cpu())
        for row, dig in zip(msgs.cpu().numpy()[:64], got.cpu().numpy()):
            assert dig.tobytes() == hashlib.sha256(row.tobytes()).digest()
    assert kb.LAUNCHES["sha256_fixed"] == before + len(cases)


@pytest.mark.cuda
def test_audit_fold_block_sizes_and_alignment(card):
    """K10 at 32, 64, 96 and 128 threads a block, dense and indexed,
    against its plain version on proofs with planted faults (every fifth
    index off by one, every seventh leaf flipped); the last leaf of a
    2^17 + 1 tree (17 index shifts at its one level) verifies; a
    misaligned operand raises instead of launching."""
    import chip_smoke

    from indy_plenum_tpu_torch.ledger.compact_merkle_tree import \
        CompactMerkleTree
    from indy_plenum_tpu_torch.tpu import sha256 as s2

    tree, leaf_data, indices, paths = chip_smoke.audit_corpus(4096, 1000,
                                                              1000)
    indices = [i + (k % 5 == 0) for k, i in enumerate(indices)]
    leaf_data = [d[::-1] if k % 7 == 0 else d
                 for k, d in enumerate(leaf_data)]
    n = len(leaf_data)
    t = chip_smoke._fold_inputs(card, leaf_data, indices, paths,
                                [tree.tree_size] * n, [tree.root_hash] * n)
    dense = [t[k] for k in ("leaf", "index", "path", "path_len",
                            "tree_size", "root")]
    idx = [t[k] for k in ("leaf", "index", "table", "path_idx", "path_len",
                          "tree_size", "root")]
    want = s2.verify_audit_paths_plain(*dense).cpu()
    assert torch.equal(want, s2.verify_audit_paths_indexed_plain(*idx).cpu())
    assert 0 < int(want.sum()) < n
    for threads in (32, 64, 96, 128):
        assert torch.equal(s2._audit_dense_kernel(*dense, threads).cpu(),
                           want)
        assert torch.equal(s2._audit_indexed_kernel(*idx, threads).cpu(),
                           want)
    big = (1 << 17) + 1
    long_tree = CompactMerkleTree()
    long_tree.extend([b"%d" % i for i in range(big)])
    last = chip_smoke._fold_inputs(
        card, [b"%d" % (big - 1)], [big - 1],
        [long_tree.audit_path(big - 1)], [big], [long_tree.root_hash])
    assert bool(s2.verify_audit_paths_indexed(*[last[k] for k in (
        "leaf", "index", "table", "path_idx", "path_len", "tree_size",
        "root")]).all())
    skewed = torch.empty(n * 32 + 4, dtype=torch.uint8, device=card)
    skewed = skewed[4:].view(n, 32)
    skewed.copy_(t["leaf"])
    with pytest.raises(ValueError, match="16-byte aligned"):
        s2.verify_audit_paths_indexed(skewed, *idx[1:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        s2.verify_audit_paths(skewed, *dense[1:])


@pytest.mark.cuda
def test_state_waves_on_card_match_host_waves(card):
    from indy_plenum_tpu_torch.simulation.state_commit_bench import (
        run_commit_arms,
    )

    rec = run_commit_arms(n_keys=3000, windows=4, arms=("host", "device"))
    assert rec["roots_identical"]
    assert rec["arms"]["device"]["wave_device_hashes"] > 0


@pytest.mark.cuda
def test_resident_step_matches_plain(card):
    """``chip_smoke.py``'s K9 check at a small group (N = 7): k = 1, 2, 4,
    7 slots with edge slides and an empty slot, one sliding member with
    the cluster forced to 1, 2 and 4 blocks, and K9 at k = 1 against
    K7."""
    import chip_smoke

    from indy_plenum_tpu_torch.utils import kernel_build as kb

    before = kb.LAUNCHES["resident_step"]
    assert chip_smoke.check_resident(card, np.random.RandomState(9), 6, 7,
                                     40, 2, 5, w=32) == 0
    assert kb.LAUNCHES["resident_step"] == before + 8


@pytest.mark.cuda
def test_fused_step_matches_plain(card):
    """K14 at the graft entry's shape, twice back to back on one state and
    stream (the ticket resets), and on 256 signed votes with planted
    faults (``chip_smoke.check_fused`` builds the full-width operands at
    N = 64, S = 300): each call ONE ``fused_step`` launch, none of
    ``ed25519_verify``."""
    import chip_smoke

    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import step as st
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    rng = np.random.RandomState(10)
    inputs = chip_smoke.fused_inputs(rng, chip_smoke.N_VALIDATORS,
                                     chip_smoke.LOG_SIZE, 256)
    before = dict(kb.LAUNCHES)
    err, accepted, _ = chip_smoke.check_fused(card, rng, inputs)
    assert err == 0 and accepted == int(inputs[3].sum())
    assert kb.LAUNCHES["fused_step"] == before["fused_step"] + 3
    assert kb.LAUNCHES["ed25519_verify"] == before["ed25519_verify"]
    # two back-to-back calls on one stream, new votes in the second
    small = st.example_inputs(batch=16, n_validators=8, log_size=16,
                              seed=3, device=card)
    other = st.example_inputs(batch=16, n_validators=8, log_size=16,
                              seed=4, device=card)
    plain = q.clone_state(small[0])
    for args in (small, (small[0],) + other[1:]):
        got = st.fused_step(*args, n_validators=8, device=card)
        want = st.fused_step_plain(plain, *args[1:], n_validators=8)
        for a, b in list(zip(got[0], want[0])) + list(zip(got[1], want[1])):
            assert torch.equal(a.cpu(), b.cpu())
        assert torch.equal(got[2].cpu(), want[2].cpu())
    assert kb.LAUNCHES["fused_step"] == before["fused_step"] + 5
    assert kb.LAUNCHES["ed25519_verify"] == before["ed25519_verify"]



@pytest.mark.cuda
def test_resident_pool_on_card_orders_as_per_tick(card):
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    def run(depth, device):
        cfg = getConfig({"Max3PCBatchWait": 0.1, "QuorumTickInterval": 0.05,
                         "QuorumTickAdaptive": True, "Max3PCBatchSize": 1,
                         "CHK_FREQ": 5, "LOG_SIZE": 15,
                         "ResidentTickDepth": depth})
        pool = SimPool(4, seed=11, config=cfg, device_quorum=True,
                       shadow_check=False, device=device)
        for i in range(12):
            pool.submit_request(i)
        pool.run_for(30)
        assert pool.honest_nodes_agree()
        return pool

    kb.library()
    kb.reset_launch_counts()
    resident = run(4, None)
    launches = kb.launch_counts()
    assert resident.ordered_hash() == run(1, "cpu").ordered_hash()
    assert launches["resident_step"] > 0 and launches["window_slide"] == 0
    for node in resident.nodes:
        assert node.vote_plane.h == node.data.low_watermark


@pytest.mark.cuda
def test_fabric_kernels_match_plain(card):
    """``chip_smoke.py``'s K13, tiled K9, K1 and K15 checks at full width
    (M = N = 256, S = 300; the tiled K9 also on its edge shapes and every
    cluster size), and K-b at 8,192 and 32,768 rows with its edge values,
    against plain and Python ints."""
    import chip_smoke

    from indy_plenum_tpu_torch.tpu.quorum import TILE_CLUSTER_MAX
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    rng = np.random.RandomState(13)
    before = dict(kb.LAUNCHES)
    # K13: 3 shapes x (3 cases at the wrapper's cluster size + 2 at each
    # of K13_BLOCKS)
    assert chip_smoke.check_fabric(card, rng) == (
        0, 3 * (3 + 2 * len(chip_smoke.K13_BLOCKS)))
    # the tiled K9: each shape at k = 1, 2 and its own k, and at its own k
    # once more with every cluster size of 1 to 8 that its rows allow
    want = sum(len({1, 2, k}) + min(rows, TILE_CLUSTER_MAX)
               for _, _, _, rows, _, _, _, _, k in chip_smoke.TILE_SHAPES)
    assert want == 65
    assert chip_smoke.check_resident_tile(card, rng) == (0, want)
    assert chip_smoke.check_ring_rotate(card, rng) == (0, 0, 0)
    for batch in (8192, 32768):
        assert chip_smoke.check_mod_l(card, rng, batch) == 0
    for name in ("fabric_step", "resident_tile", "ring_shift",
                 "rotate_merge", "reduce_mod_l"):
        assert kb.LAUNCHES[name] > before[name], name


@pytest.mark.cuda
def test_sha512_ragged_rows_and_alignment(card):
    """K-a on 1,000 ragged rows (counts 0 .. 4 over 4 blocks, with garbage
    past each count; not a multiple of the block size), bit-equal to the
    plain version and to hashlib; a view 8 bytes off a 16-byte boundary
    raises instead of launching."""
    import hashlib

    from indy_plenum_tpu_torch.tpu import sha512 as s5
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    rng = np.random.RandomState(21)
    batch, nb = 1000, 4
    lengths = rng.randint(0, nb * 128 - 17, batch)
    msgs = [rng.bytes(int(n)) for n in lengths]
    blocks_np, counts_np = s5.pad_ed25519_messages([b""] * batch, msgs, nb)
    counts_np[:3] = [0, 0, 0]
    for i, c in enumerate(counts_np):
        blocks_np[i, c:] = 0xA5
    blocks = torch.from_numpy(blocks_np).to(card)
    counts = torch.from_numpy(counts_np).to(card)
    before = kb.LAUNCHES["sha512_blocks"]
    got = s5.sha512_blocks(blocks, counts)
    assert kb.LAUNCHES["sha512_blocks"] == before + 1
    assert torch.equal(got.cpu(), s5.sha512_blocks_plain(
        torch.from_numpy(blocks_np), torch.from_numpy(counts_np)))
    for row, m, c in zip(got.cpu().numpy(), msgs, counts_np):
        if c:
            assert row.tobytes() == hashlib.sha512(m).digest()
    skewed = torch.empty(blocks.numel() + 8, dtype=torch.uint8,
                         device=card)[8:].view(batch, nb, 128)
    skewed.copy_(blocks)
    with pytest.raises(ValueError, match="16-byte aligned"):
        s5.sha512_blocks(skewed, counts)


@pytest.mark.cuda
def test_ring_and_rotation_match_plain_at_phase_r(card):
    """K1 (a ring step, every shift) and the one-card rotation (every
    rows) at phase R's state (M = N = 64, S = 15, C = 3) on (4, 2), and
    K1 as a roll on odd-sized leaves (byte, 4-byte and 16-byte granules),
    bit-equal to plain; each rotation one K1 launch and no K15; K15
    called directly on the rotation's arms, bit-equal to its plain
    version; a leaf of other rows than the launch's raises."""
    import chip_smoke

    from indy_plenum_tpu_torch.tpu import rebalance as rb
    from indy_plenum_tpu_torch.tpu import ring_exchange as rx
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    rng = np.random.RandomState(22)
    m, n, s, c = chip_smoke.R_STATE
    state = chip_smoke.fabric_state(card, rng, n, n, c, m=m, s=s)
    mesh = chip_smoke.fabric_mesh(card, (4, 2))
    r = m // 4
    for shift in range(1, 6):
        got = rx.ring_shift_planes(state, mesh, shift)
        want = rx.ring_shift_plain(state, mesh, shift)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for rows in range(1, m):
        before = dict(kb.LAUNCHES)
        got = rb.rotate_planes(state, mesh, rows, r)
        assert kb.LAUNCHES["ring_shift"] == before["ring_shift"] + 1
        assert kb.LAUNCHES["rotate_merge"] == before["rotate_merge"]
        want = rb.rotate_planes_plain(state, mesh, rows, r)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        b0, sub = divmod(rows, r)
        if sub:
            arm_a = rx.ring_shift_plain(state, mesh, b0)
            arm_b = rx.ring_shift_plain(state, mesh, b0 + 1)
            got = rb.rotate_merge(arm_a, arm_b, sub, r)
            want = rb.rotate_merge_plain(arm_a, arm_b, sub, r)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    odd = chip_smoke.odd_leaves(card, rng)
    for rows in range(1, 37):
        got = rx.ring_shift_rows(odd, rows)
        for a, x in zip(got, odd):
            assert torch.equal(a, torch.roll(x, rows, dims=0))
    with pytest.raises(ValueError, match="member rows"):
        rx._ring_kernel(list(odd), 36, 1)


@pytest.mark.cuda
def test_sharded_fused_step_matches_plain(card):
    import chip_smoke

    from indy_plenum_tpu_torch.utils import kernel_build as kb

    inputs = chip_smoke.fused_inputs(np.random.RandomState(15), 16, 40, 64)
    before = dict(kb.LAUNCHES)
    assert chip_smoke.check_sharded_fused(card, inputs, 16, 40, 2) == 0
    # one launch a call, each form: the sharded K14 and the unsharded one
    # it is held against
    assert kb.LAUNCHES["sharded_fused_step"] \
        == before["sharded_fused_step"] + 1
    assert kb.LAUNCHES["fused_step"] == before["fused_step"] + 1
    assert kb.LAUNCHES["ed25519_verify"] == before["ed25519_verify"]


@pytest.mark.cuda
def test_rebalance_pool_on_card_matches_cpu(card):
    import chip_smoke

    from indy_plenum_tpu_torch.utils import kernel_build as kb

    kb.library()
    kb.reset_launch_counts()
    forced = chip_smoke.run_pool_r(None, (2, 2), chip_smoke.R_FORCE_TICK)
    launches = kb.launch_counts()
    unforced = chip_smoke.run_pool_r(None, (2, 2), 0)
    on_cpu = chip_smoke.run_pool_r("cpu", (2, 2), chip_smoke.R_FORCE_TICK)
    keys = ("ordered_hash", "trace_hash", "views", "ordered_min")
    for key in keys:
        assert forced[key] == unforced[key] == on_cpu[key], key
    assert forced["rebalances"] >= 1 and forced["row_shift"] != 0
    assert (forced["rebalances"], forced["row_shift"]) \
        == (on_cpu["rebalances"], on_cpu["row_shift"])
    for name in chip_smoke.PATH_KERNELS["rebalance_forced"]:
        assert launches[name] > 0, name


@pytest.mark.cuda
def test_plan_kernel_matches_plain(card):
    """K11 on a real 320-key commit plan of ~250 levels (a cluster of 4;
    the commit's root equals host waves, ``commit_plan`` asserts it), on
    a plan wider than 8 blocks of 256 threads (the threads loop) and on a
    one-level wave: one launch each, bit-equal to the plain version (the
    one-block path: ``test_sha256_kernels_match_plain``'s narrow
    waves)."""
    import chip_smoke

    from indy_plenum_tpu_torch.tpu import sha256 as s2
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    rng = np.random.RandomState(8)
    plans = [chip_smoke.commit_plan(card)[:3], chip_smoke.wide_plan(rng),
             (s2._wave_refs(320),
              rng.randint(0, 256, (640, 32)).astype(np.uint8), [0, 320])]
    for refs, lits, offs in plans:
        rt = torch.from_numpy(np.array(refs)).to(card)
        lt = torch.from_numpy(np.array(lits)).to(card)
        before = kb.LAUNCHES["merkle_node_hash"]
        got = s2.merkle_plan_hash(rt, lt, offs)
        torch.cuda.synchronize()
        assert kb.LAUNCHES["merkle_node_hash"] == before + 1
        assert torch.equal(got, s2.merkle_plan_hash_plain(rt, lt, offs))


@pytest.mark.cuda
@pytest.mark.parametrize("tag", ["B", "R", "A"])
def test_quorum_step_matches_plain_at_path_shapes(card, tag):
    """K7 at phase B's S = 30, phase R's S = 15 (rows not 4-byte aligned:
    the byte path) and phase A's S = 300 (the word path), from random
    vote states: one launch a step, state, events and compact record
    bit-equal to plain, with and without the compact record; the frontier
    snapshot never the live state."""
    import chip_smoke

    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    _, m, n, s, c, w = next(shape for shape in chip_smoke.K7_SHAPES
                            if shape[0] == tag)
    rng = np.random.RandomState(len(tag) + s)
    state = chip_smoke._random_votes(card, rng, m, n, s, c)
    for compact in (True, True, False):
        words = q.words_tensor(chip_smoke._random_words(rng, m, w, n, s),
                               card)
        shadow = q.clone_state(state)
        before = kb.LAUNCHES["quorum_step"]
        ev, comp = q._dispatch(state, words, n, q.ORDER_DELTA_CAP, compact)
        torch.cuda.synchronize()
        assert kb.LAUNCHES["quorum_step"] == before + 1
        pev, pcomp = q.step_plain(shadow, words, n, compact=compact)
        for got, want in zip(list(state) + list(ev) + list(comp),
                             list(shadow) + list(pev) + list(pcomp)):
            assert torch.equal(got.cpu(), want.cpu())
        assert comp.frontier.data_ptr() != state.frontier.data_ptr()


@pytest.mark.cuda
def test_split_kernels_match_plain(card):
    """Phase M's kernels on the per-tile layout with every tile on this
    card (``chip_smoke.check_split``: the partials mode storing into the
    home's buffer and the home form adding the stored partials, at v = 1,
    2 and 4 and every cluster size, K1's peer form, the per-tile step and
    rotation with K15, the split sharded K14), bit-equal to their plain
    versions; a (2, 4) per-tile step launches v kernels a block (v - 1
    partials-mode launches, one home form) and nothing else; then the
    forced-rebalance pool on a (2, 2) per-tile mesh on the card against
    the same pool on the CPU, the rotation two K1 peer shifts and K15."""
    import chip_smoke

    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    inputs = chip_smoke.fused_inputs(np.random.RandomState(16),
                                     chip_smoke.N_VALIDATORS,
                                     chip_smoke.LOG_SIZE, 512)
    errs = chip_smoke.check_split(card, np.random.RandomState(17), inputs)
    assert not any(errs.values()), errs
    rng = np.random.RandomState(18)
    mesh = q.make_fabric_mesh([card] * 8, (2, 4), split=True)
    state = chip_smoke.fabric_state(card, rng, 64, 64, 3, m=32, s=40)
    tiles = q.TileState.split(state, mesh)
    words = q.words_tensor(chip_smoke.fabric_words(rng, 32, 64, 64, 40, 3),
                           card)
    kb.reset_launch_counts()
    events, compact = q.tiles_step(tiles, q.tile_words(words, mesh, 16), 64)
    assert {k: n for k, n in kb.launch_counts().items() if n} == {
        "resident_partials": 6, "resident_home": 2}
    pev, pcomp = q.fabric_step_plain(state, words, 64, 4)
    for got, want in zip(list(tiles.join(card)) + list(q.join_blocks(events))
                         + list(q.join_blocks(compact)),
                         list(state) + list(pev) + list(pcomp)):
        assert torch.equal(got.cpu(), want.cpu())
    kb.reset_launch_counts()
    forced = chip_smoke.run_pool_r(None, (2, 2), chip_smoke.R_FORCE_TICK,
                                   "m1")
    launches = kb.launch_counts()
    on_cpu = chip_smoke.run_pool_r("cpu", (2, 2), chip_smoke.R_FORCE_TICK,
                                   "m1")
    for key in chip_smoke.M_R_COMPARE:
        assert forced[key] == on_cpu[key], key
    for name in chip_smoke.PATH_KERNELS["m1_rebalance"]:
        assert launches[name] > 0, name
