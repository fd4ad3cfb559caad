#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one card, at the n=64 size.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``indy_plenum_tpu_torch/csrc``, holds
each kernel bit-equal against its plain PyTorch version on the card, then
drives the signed write path through its entry points at the size of
``bench.py``'s n=64 cell (64 validators, one protocol instance, so 64
member planes; LOG_SIZE 300, CHK_FREQ 100):

1. build      - nvcc for sm_90a, seconds; the card's name and power limit;
2. kernels    - K-a SHA-512, K-b mod L, K-c Ed25519 verify, K-d quorum
                step, K8 window slide and zero, each against its plain
                version on the same inputs;
3. ingress    - 64 DID signers sign 1024 NYM requests, tiled with planted
                faults into one 8192-entry drain, then a 104-entry drain,
                through ``CoreAuthNr.authenticate_batch``; verdicts
                against the pure-Python oracle;
4. quorum     - 3PC waves of >= 400 slots with checkpoint slides through a
                pipelined ``VotePlaneGroup(64, ...)`` on the card and the
                same schedule on the CPU (plain versions): equal deltas,
                frontiers and counters; then the card run once more under
                ``torch.profiler`` for the device's busy and idle share;
A. pool       - ``bench.py``'s n=64 ordered-txns cell through the port's
                ``SimPool`` (64 validators, one instance, 3PC batches of
                320, adaptive tick), signed: 320 warm-up requests, then
                3,200 timed; the same seed on the CPU must order the same
                requests in the same order (``ordered_hash``);
B. pool       - n=16 with six RBFT instances (96 member planes), signed,
                adaptive tick, LOG_SIZE 30 / CHK_FREQ 5 so every member
                slides at least four times, and a primary disconnect that
                forces a view change (the view-change zero); card and CPU
                agree on ``ordered_hash``, the protocol timeline and every
                node's view;
5. report     - a ``kernels`` JSON line (launches of the main path's runs,
                K-a/K-b held against their plain versions at the drain's
                shapes, times, bounds), a times line, the card, and last
                ``{"ok": true, "device": {...}}``.

Each main-path run (phases 3, 4, A and B on the card) starts with every
launch counter at 0 and reads the counters right after; the ``kernels``
line's ``launches`` are their sums.

Any mismatch raises and the script exits non-zero. It imports nothing of
JAX. Without a CUDA device it exits non-zero before printing a result.
"""
from __future__ import annotations

import hashlib
import json
import random
import subprocess
import sys
import time

import numpy as np

N_VALIDATORS = 64
LOG_SIZE = 300
CHK_FREQ = 100
N_CHECKPOINTS = LOG_SIZE // CHK_FREQ
DRAIN = 8192  # the reference's largest ingress bucket
BENCH_VERIFY_BATCH = 32768  # bench.py's Ed25519 batch
N_SLOTS = 420  # 3PC slots driven in phase 4 (>= 320, four slides)
POOL_BATCH = 320  # bench.py _bench_ordered: 3PC batch size
POOL_BATCHES = 10  # bench.py bench_ordered_txns_n64: batches=10
# pool phase B: n=16 x 6 RBFT instances in a 30-slot window, checkpoints
# every 5, so its vote group is M = 96 members of N = 16 validators
B_NODES, B_INSTANCES, B_LOG_SIZE, B_CHK_FREQ = 16, 6, 30, 5

# Roofline inputs (H100 SXM). Memory: 3.35 TB/s (NVIDIA data sheet).
# Integer issue: 132 SMs x 64 INT32 lanes (Hopper white paper) x 1.98 GHz
# boost = 16.7e12 32-bit integer instructions per second; the kernels
# here do 64-bit integer work in 32-bit instructions.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer instructions per unit of work, counted from the CUDA
# sources (lower bounds: the dominant terms only):
# SHA-512, per 128-byte block: 80 rounds x ~38 (two 3-rotate sigmas, ch,
# maj, 7 64-bit adds, each 64-bit op = 2 instructions) + 64 schedule
# words x ~22 + 16 byte swaps x 2.
SHA512_OPS_PER_BLOCK = 80 * 38 + 64 * 22 + 32
# h mod L, per item, as a Barrett reduction on 64-bit limbs needs it
# (not the subtract ladder the kernel runs): q1 * mu (5 x 5 = 25
# products) and q3 * L mod 2^320 (14 products), each 64x64->128 product
# ~8 instructions + ~4 to accumulate, then two conditional 5-limb
# subtracts of ~6 instructions per limb.
MOD_L_OPS_PER_ITEM = 39 * (8 + 4) + 2 * 5 * 6
# Ed25519 verify, per signature, counted from csrc/ed25519.cu and
# fe25519.cuh: a field multiply is 25 64x64->128 products x 8
# instructions + ~110 for the 128-bit column sums and carries; a square
# 15 products + ~90. Decompress: 18 multiplies, 255 squares (pow_p58);
# a signature whose A fails to decompress stops there. The rest: x*y 1,
# table 127 multiplies, 64 windows x (32 multiplies + 16 squares),
# compress 13 multiplies + 254 squares (invert).
FE_MUL_OPS = 25 * 8 + 110
FE_SQR_OPS = 15 * 8 + 90
DECOMPRESS_OPS_PER_ITEM = 18 * FE_MUL_OPS + 255 * FE_SQR_OPS
VERIFY_OPS_PER_ITEM = (DECOMPRESS_OPS_PER_ITEM
                       + (1 + 127 + 64 * 32 + 13) * FE_MUL_OPS
                       + (64 * 16 + 254) * FE_SQR_OPS)


def _line(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``, without its wrapper's host cost
    (which CUDA events around back-to-back calls include once the kernel
    is shorter than the wrapper): the stream first spins in
    ``torch.cuda._sleep`` while the host enqueues the timed calls, so they
    run back to back. The spin grows until it outlasts the enqueueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 2e7  # about 10 ms at the H100's clock
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spun = torch.cuda.Event()
        torch.cuda._sleep(int(cycles))
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        hidden = not spun.query()  # still spinning: no host gap got in
        torch.cuda.synchronize()
        if hidden:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("the host could not enqueue the timed calls "
                         "ahead of the device")


def _max_abs_err(pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != "
                                 f"{tuple(b.shape)}")
        if a.numel():
            d = (a.to("cpu").long() - b.to("cpu").long()).abs().max()
            err = max(err, int(d))
    return err


# --- shared inputs -------------------------------------------------------------


def make_signed_requests(seed: int):
    """64 DID signers, 1024 distinct NYM-shaped requests (16 each)."""
    from indy_plenum_tpu_torch.common.constants import NYM, TARGET_NYM, \
        TXN_TYPE, VERKEY
    from indy_plenum_tpu_torch.common.request import Request
    from indy_plenum_tpu_torch.crypto.signers import DidSigner

    rng = random.Random(seed)
    signers = [DidSigner(bytes(rng.randrange(256) for _ in range(32)))
               for _ in range(N_VALIDATORS)]
    reqs = []
    for i in range(1024):
        target = signers[(i * 7 + 3) % len(signers)]
        req = Request(reqId=1_000_000 + i, operation={
            TXN_TYPE: NYM, TARGET_NYM: target.identifier,
            VERKEY: target.verkey})
        signers[i % len(signers)].sign_request(req)
        reqs.append(req)
    return signers, reqs


# --- phase 2: kernels against their plain versions ---------------------------


def check_sha512_and_mod_l(dev, rng):
    import torch
    from indy_plenum_tpu_torch.tpu import sha512 as s5

    batch, nb = 4096, 8
    blocks = torch.from_numpy(
        rng.randint(0, 256, (batch, nb, 128)).astype(np.uint8)).to(dev)
    counts = torch.from_numpy(
        rng.randint(0, nb + 1, batch).astype(np.int32)).to(dev)
    got = s5.sha512_blocks(blocks, counts)
    ref = s5.sha512_blocks_plain(blocks, counts)
    err_a = _max_abs_err([(got, ref)])
    # and the standard itself, on padded real messages
    msgs = [rng.bytes(int(n)) for n in rng.randint(0, 8 * 128 - 81, 64)]
    pb, pc = s5.pad_ed25519_messages([b""] * 64, msgs, 8)
    dig = s5.sha512_blocks(torch.from_numpy(pb).to(dev),
                           torch.from_numpy(pc).to(dev)).cpu().numpy()
    for row, m in zip(dig, msgs):
        if row.tobytes() != hashlib.sha512(m).digest():
            raise AssertionError("sha512_blocks disagrees with hashlib")
    L = s5.L
    edge = [0, 1, L - 1, L, L + 1, 2 * L, 5 * L, (1 << 512) - 1,
            ((1 << 512) - 1) // L * L]
    hs = np.concatenate([
        rng.randint(0, 256, (4096 - len(edge), 64)).astype(np.uint8),
        np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8)
                  for v in edge])])
    h = torch.from_numpy(hs).to(dev)
    red = s5.reduce_mod_l(h)
    err_b = _max_abs_err([(red, s5.reduce_mod_l_plain(h))])
    red_np = red.cpu().numpy()
    for i in range(len(hs) - len(edge), len(hs)):
        v = int.from_bytes(hs[i].tobytes(), "little") % L
        if int.from_bytes(red_np[i].tobytes(), "little") != v:
            raise AssertionError("reduce_mod_l disagrees with Python ints")
    if err_a or err_b:
        raise AssertionError(f"K-a/K-b differ from plain: {err_a} {err_b}")
    return err_a, err_b


RFC8032 = [  # (seed, message, signature), RFC 8032 section 7.1
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "", "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
         "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "72", "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
           "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


def verify_inputs(signers, reqs, rng, size):
    """(pk, R, S, h) arrays of ``size`` entries: the RFC vectors, then the
    signed requests tiled, with planted faults: flipped R, S, A and
    message bits, non-canonical A (y >= p) and S >= L (S + L)."""
    from indy_plenum_tpu_torch.crypto import ed25519 as ed
    from indy_plenum_tpu_torch.utils.base58 import b58decode

    rows, expect = [], []
    for seed_hex, msg_hex, sig_hex in RFC8032:
        seed = bytes.fromhex(seed_hex)
        msg, sig = bytes.fromhex(msg_hex), bytes.fromhex(sig_hex)
        if ed.sign(seed, msg) != sig:
            raise AssertionError("RFC 8032 signing vector mismatch")
        rows.append((ed.public_key(seed), msg, sig))
    by_id = {s.identifier: s for s in signers}
    base = [(by_id[r.identifier].verkey_raw, r.signing_bytes(),
             b58decode(r.signature)) for r in reqs]
    kinds = ("ok", "flip_r", "flip_s", "flip_a", "flip_m", "noncanon",
             "s_plus_l")
    i = 0
    while len(rows) < size:
        pk, msg, sig = base[i % len(base)]
        kind = kinds[i % len(kinds)] if i % 3 == 0 else "ok"
        bit = rng.randint(0, 256)
        if kind == "flip_r":
            sig = _flip(sig, bit)
        elif kind == "flip_s":
            sig = sig[:32] + _flip(sig[32:], bit % 252)
        elif kind == "flip_a":
            pk = _flip(pk, bit)
        elif kind == "flip_m":
            msg = _flip(msg, bit)
        elif kind == "noncanon":
            pk = (ed.P + (bit % 19)).to_bytes(32, "little")
        elif kind == "s_plus_l":
            s_int = int.from_bytes(sig[32:], "little") + ed.L
            sig = sig[:32] + s_int.to_bytes(32, "little")
        rows.append((pk, msg, sig))
        i += 1
    pk_a = np.stack([np.frombuffer(p, np.uint8) for p, _, _ in rows])
    r_a = np.stack([np.frombuffer(s[:32], np.uint8) for _, _, s in rows])
    s_a = np.stack([np.frombuffer(s[32:], np.uint8) for _, _, s in rows])
    h_a = np.stack([np.frombuffer((int.from_bytes(hashlib.sha512(
        s[:32] + p + m).digest(), "little") % ed.L).to_bytes(32, "little"),
        np.uint8) for p, m, s in rows])
    return rows, [np.ascontiguousarray(a) for a in (pk_a, r_a, s_a, h_a)]


def _flip(data: bytes, bit: int) -> bytes:
    bit %= 8 * len(data)
    out = bytearray(data)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


def check_verify(dev, signers, reqs, rng):
    import torch
    from indy_plenum_tpu_torch.crypto import ed25519 as ed
    from indy_plenum_tpu_torch.tpu import ed25519 as ted

    rows, arrays = verify_inputs(signers, reqs, rng, DRAIN)
    tensors = [torch.from_numpy(a).to(dev) for a in arrays]
    got = ted.verify_kernel(*tensors)
    ref = ted.verify_kernel_plain(*tensors)
    err = _max_abs_err([(got, ref)])
    got_np = got.cpu().numpy()
    if not got_np[:3].all():
        raise AssertionError("RFC 8032 vectors rejected")
    # the oracle on a sample (the curve check without the S < L rule)
    for i in list(range(3)) + list(rng.choice(len(rows), 48, False)):
        pk, msg, sig = rows[i]
        s_int = int.from_bytes(sig[32:], "little")
        expect = ed.verify(pk, msg, sig[:32] + (s_int % ed.L).to_bytes(
            32, "little")) if ed.decompress(pk) else False
        if bool(got_np[i]) != expect:
            raise AssertionError(f"verify verdict {i} != oracle")
    if err:
        raise AssertionError(f"K-c differs from plain: {err}")
    return err, int(got_np.sum()), len(rows)


def _wave_words(m, w, n, s, slots, rng):
    from indy_plenum_tpu_torch.tpu import quorum as q

    out = np.zeros((m, w), np.uint32)
    for mi in range(m):
        row = []
        for sl in slots:
            row.append(q.pack_vote(q.PREPREPARE, 0, sl))
            row += [q.pack_vote(q.PREPARE, v, sl) for v in range(1, n)]
            row += [q.pack_vote(q.COMMIT, v, sl) for v in range(n)]
        row = row[:w]
        rng.shuffle(row)
        out[mi, :len(row)] = row
    return out


def check_quorum(dev, rng):
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q

    m, n, s, c = N_VALIDATORS, N_VALIDATORS, LOG_SIZE, N_CHECKPOINTS
    state = q.init_state(n, s, c, m, dev)
    err = 0
    overflow = False
    steps = 0
    for step_i in range(12):
        w = 16 if step_i % 3 == 0 else 128
        kind = rng.randint(0, 4, (m, w))
        sender = rng.randint(0, n + 8, (m, w))
        slot = rng.randint(0, s + 20, (m, w))
        valid = rng.rand(m, w) < 0.9
        words = ((valid.astype(np.uint64) << 31)
                 | (kind.astype(np.uint64) << 29)
                 | (sender.astype(np.uint64) << 16)
                 | slot.astype(np.uint64)).astype(np.uint32)
        if step_i == 5:
            # fresh planes, 20 slots prepared with a commit short; then
            # completing all 20 at once orders > 16 in one step
            q.zero_members(state, torch.ones(m, dtype=torch.bool))
            pre = np.zeros((m, 4096), np.uint32)
            row = []
            for sl in range(100, 120):
                row.append(q.pack_vote(q.PREPREPARE, 0, sl))
                row += [q.pack_vote(q.PREPARE, v, sl) for v in range(1, n)]
                row += [q.pack_vote(q.COMMIT, v, sl) for v in range(n - 22)]
            pre[:, :len(row)] = row
            _step_pair(state, q.words_tensor(pre, dev), n)
            words = np.zeros((m, 128), np.uint32)
            words[:, :20] = [q.pack_vote(q.COMMIT, n - 22, sl)
                             for sl in range(100, 120)]
        if step_i == 8:
            words = _wave_words(m, 128, n, s, [200], rng)
        e, comp = _step_pair(state, q.words_tensor(words, dev), n)
        err = max(err, e)
        overflow |= bool((comp.n_committed > q.ORDER_DELTA_CAP).any())
        steps += 1
        if step_i in (6, 10):
            deltas = torch.from_numpy(
                rng.randint(0, 40, m).astype(np.int32)).to(dev)
            q.slide_state(state, deltas)
    if not overflow:
        raise AssertionError("no quorum step overflowed the delta cap")
    if err:
        raise AssertionError(f"K-d differs from plain: {err}")
    return err, steps


def _step_pair(state, words, n):
    """One kernel step on ``state`` and one plain step on a copy: every
    state leaf, event and compact output must be equal."""
    from indy_plenum_tpu_torch.tpu import quorum as q

    shadow = q.clone_state(state)
    ev, comp = q.step_compact(state, words, n)
    pev, pcomp = q.step_plain(shadow, words, n)
    err = _max_abs_err(list(zip(state, shadow)) + list(zip(ev, pev))
                       + list(zip(comp, pcomp)))
    return err, comp


def _random_votes(dev, rng, m, n, s, c):
    """A vote state of random 0/1 planes and frontiers in [0, S]."""
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q

    def bits(*shape):
        return torch.from_numpy(
            (rng.rand(*shape) < 0.4).astype(np.uint8)).to(dev)

    return q.VoteState(
        preprepare_seen=bits(m, s), prepare_votes=bits(m, n, s),
        commit_votes=bits(m, n, s), checkpoint_votes=bits(m, n, c),
        ordered=bits(m, s), prepared_acked=bits(m, s),
        frontier=torch.from_numpy(
            rng.randint(0, s + 1, m).astype(np.int32)).to(dev))


def check_window(dev, rng, m, n, s, c, chk_freq):
    """K8 against its plain versions on an (M, N, S, C) vote group: slides
    with the edge deltas (0, 1, S-1, S, > S), the pool's pattern (one
    member sliding by a checkpoint interval), every member sliding, and
    zeros under random masks."""
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q

    slides = [np.zeros(m, np.int32) for _ in range(3)]
    slides[0][:8] = [0, 1, s - 1, s, s + 1, 3 * s, chk_freq, 7]
    slides[1][rng.randint(m)] = chk_freq
    slides[2][:] = rng.randint(1, s, m)
    err_slide = err_zero = 0
    for deltas in slides:
        state = _random_votes(dev, rng, m, n, s, c)
        shadow = q.clone_state(state)
        q.slide_state(state, torch.from_numpy(deltas))
        q.slide_plain(shadow, torch.from_numpy(deltas))
        err_slide = max(err_slide, _max_abs_err(list(zip(state, shadow))))
    for p_hit in (0.1, 0.5, 1.0):
        state = _random_votes(dev, rng, m, n, s, c)
        shadow = q.clone_state(state)
        mask = torch.from_numpy((rng.rand(m) < p_hit).astype(np.uint8))
        q.zero_members(state, mask)
        q.zero_plain(shadow, mask)
        err_zero = max(err_zero, _max_abs_err(list(zip(state, shadow))))
    if err_slide or err_zero:
        raise AssertionError(f"K8 differs from plain: slide {err_slide}, "
                             f"zero {err_zero}")
    return err_slide, err_zero


# --- phase 3: ingress ---------------------------------------------------------


def run_ingress(dev, signers, reqs, rng):
    from indy_plenum_tpu_torch.common.request import Request
    from indy_plenum_tpu_torch.crypto.signers import DidSigner
    from indy_plenum_tpu_torch.server import client_authn as ca
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.base58 import b58decode, b58encode

    planted = []
    for i in range(128):
        src = reqs[i]
        req = Request.from_dict(src.as_dict())
        kind = i % 4
        if kind == 0:  # payload changed after signing
            req.operation = dict(req.operation, dest="evil")
        elif kind == 1:  # R bit flipped
            req.signature = b58encode(_flip(b58decode(req.signature), i))
        elif kind == 2:  # S bit flipped
            sig = b58decode(req.signature)
            req.signature = b58encode(sig[:32] + _flip(sig[32:], i))
        else:  # signer nobody registered
            DidSigner(bytes([i]) * 32).sign_request(req)
        planted.append(req)
    batch = [reqs[i % len(reqs)] for i in range(DRAIN - len(planted))]
    slots = rng.sample(range(DRAIN), len(planted))
    planted_at = {}
    for pos, req in zip(sorted(slots), planted):
        batch.insert(int(pos), req)
        planted_at[int(pos)] = req
    authnr = ca.CoreAuthNr(seed_keys={s.identifier: s.verkey
                                      for s in signers})
    ca.warm_device_auth_path()
    t0 = time.perf_counter()
    verdicts = authnr.authenticate_batch(batch)
    drain_s = time.perf_counter() - t0
    oracle = ca.CoreAuthNr(seed_keys={s.identifier: s.verkey
                                      for s in signers}, device="cpu")
    by_req = {}

    def check(drain, got, tag):
        for i, req in enumerate(drain):
            if id(req) not in by_req:  # the oracle, once per request
                try:
                    oracle.authenticate(req)
                    by_req[id(req)] = True
                except Exception:  # noqa: BLE001 - any rejection is False
                    by_req[id(req)] = False
            if bool(got[i]) != by_req[id(req)]:
                raise AssertionError(f"{tag} verdict {i} != oracle")

    check(batch, verdicts, "ingress")
    if any(verdicts[i] for i in planted_at):
        raise AssertionError("a planted request was accepted")
    if int(verdicts.sum()) != DRAIN - len(planted):
        raise AssertionError("a valid request was rejected")
    # a small drain hashes on the card too
    small = reqs[:96] + planted[:8]
    before = kb.launch_counts()
    small_verdicts = authnr.authenticate_batch(small)
    after = kb.launch_counts()
    check(small, small_verdicts, "small drain")
    if int(small_verdicts.sum()) != 96:
        raise AssertionError("small drain: planted/valid verdicts wrong")
    for name in ("sha512_blocks", "reduce_mod_l", "ed25519_verify"):
        if after[name] != before[name] + 1:
            raise AssertionError(f"small drain did not launch {name}")
    return {"entries": DRAIN, "accepted": int(verdicts.sum()),
            "planted_rejected": len(planted), "oracle_checked": len(by_req),
            "drain_s": drain_s, "small_drain_entries": len(small)}


# --- phase 4: quorum ----------------------------------------------------------


def run_quorum_schedule(device, validators):
    """Drive a pipelined VotePlaneGroup through 3PC waves as the ordering
    services record them. Per tick: the next slots' PRE-PREPARE and
    PREPAREs, the previous tick's slots' COMMITs. Slots divisible by 7
    hear from only n - f validators (f = 21 silent); slot 50 is held one
    COMMIT short of n - f for five ticks; slots 230..249 are held one
    COMMIT short until one tick completes all twenty (> 16 newly ordered
    in one step). Checkpoint votes follow the frontier; the window slides
    after stability. Returns the observation log and counters."""
    from indy_plenum_tpu_torch.tpu.vote_plane import VotePlaneGroup

    n = len(validators)
    f = (n - 1) // 3
    group = VotePlaneGroup(n, validators, LOG_SIZE, N_CHECKPOINTS,
                           pipelined=True, device=device)
    views = [group.view(i) for i in range(n)]
    for view in views:  # tick-batched: queries read the last snapshot
        view.defer_flush_on_query = True
    h = [0] * n
    front = [0] * n
    log = []
    next_pp = 1
    prev_slots = []
    held = {50: None}  # slot -> tick its last commit arrives
    burst = list(range(230, 250))
    burst_tick = None
    voted_chk = set()
    tick = 0
    t0 = time.perf_counter()
    while True:
        new_slots = []
        while (len(new_slots) < 2 and next_pp <= N_SLOTS
               and next_pp - min(h) < LOG_SIZE):
            new_slots.append(next_pp)
            next_pp += 1
        for pp in prev_slots:
            if pp in held and held[pp] is None:
                held[pp] = tick + 5
        for view in views:
            for pp in new_slots:
                live = validators[:n - f] if pp % 7 == 0 else validators
                view.record_preprepare(pp)
                for v in live[1:]:
                    view.record_prepare(v, pp)
            for pp in prev_slots:
                live = validators[:n - f] if pp % 7 == 0 else validators
                short = pp in held or pp in burst
                senders = live[:n - f - 1] if short else live
                for v in senders:
                    view.record_commit(v, pp)
            for pp, due in held.items():
                if due == tick:
                    view.record_commit(validators[n - f - 1], pp)
            if burst_tick == tick:
                for pp in burst:
                    view.record_commit(validators[n - f - 1], pp)
        if prev_slots and prev_slots[-1] >= burst[-1] and burst_tick is None:
            burst_tick = tick + 1
        prev_slots = new_slots
        group.flush()
        for mi, view in enumerate(views):
            d = view.poll_deltas()
            if d is not None:
                log.append((tick, mi, tuple(d.prepared), tuple(d.committed),
                            d.frontier))
                front[mi] = d.frontier
            boundary = h[mi] + CHK_FREQ
            if (mi, boundary) not in voted_chk \
                    and h[mi] + front[mi] >= boundary:
                for v in validators:
                    view.record_checkpoint_vote(v, boundary, CHK_FREQ)
                voted_chk.add((mi, boundary))
            if view.has_checkpoint_quorum(boundary, CHK_FREQ):
                view.slide_to(boundary)
                front[mi] = max(front[mi] - (boundary - h[mi]), 0)
                h[mi] = boundary
                log.append((tick, mi, "slide", boundary))
        tick += 1
        done = all(h[mi] + front[mi] >= N_SLOTS for mi in range(n))
        if done and not group.lagging and tick > 3:
            break
        if tick > 2000:
            raise AssertionError("phase 4 schedule did not converge")
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frontiers = [h[mi] + front[mi] for mi in range(n)]
    counters = {c: getattr(group, c) for c in (
        "flushes", "flush_votes_total", "flush_capacity_total",
        "readback_bytes_total", "readbacks", "readbacks_overlapped")}
    return log, frontiers, counters, wall, tick, h


def trace_quorum(validators, main_wall_s, main_log):
    """Phase 4's schedule once more on the card under ``torch.profiler``:
    the device's busy time is the union of its kernel and copy spans; the
    idle share is the rest of the traced run's wall time, and of the
    untraced main run's (the profiler slows the host, not the device).
    The traced run must reproduce the main run's deltas. A trace without
    device activity leaves the busy time and idle shares unmeasured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        log, _, _, wall, _, _ = run_quorum_schedule("cuda", validators)
    if log != main_log:
        raise AssertionError("the traced run of phase 4 differs")
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return {"device_spans": 0, "device_busy_ms": None,
                "traced_wall_s": wall, "idle_share_traced": None,
                "idle_share_main_run": None, "device_top": []}
    by_name = {}
    for e in device:
        count, total = by_name.get(e.name[:60], (0, 0.0))
        by_name[e.name[:60]] = (count + 1, total + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy_us = 0.0
    start, end = spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy_us += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy_us += end - start
    busy_s = busy_us / 1e6
    return {"device_spans": len(spans), "device_busy_ms": busy_s * 1e3,
            "traced_wall_s": wall, "idle_share_traced": 1 - busy_s / wall,
            "idle_share_main_run": 1 - busy_s / main_wall_s,
            "device_top": [{"name": name, "count": count,
                            "total_ms": total / 1e3,
                            "mean_us": total / count}
                           for name, (count, total) in top]}


# --- phases A and B: the pool ------------------------------------------------


def _pool_result(pool, wall_s, **extra):
    return dict(
        ordered_hash=pool.ordered_hash(),
        trace_hash=pool.trace.trace_hash(exclude_cats=("dispatch",)),
        views=[nd.data.view_no for nd in pool.nodes],
        ordered_min=min(len(nd.ordered_digests) for nd in pool.nodes),
        wall_s=wall_s, **extra)


def run_pool_a(device):
    """``bench.py``'s n=64 ordered-txns cell (``_bench_ordered(64, 1,
    batches=10)``: seed 11, 3PC batches of 320, batch wait 0.05, adaptive
    tick from 0.1, pipelined flush) with signed requests: 320 warm-up
    requests, then 3,200 timed. Ordered txns/sec is the bench's: requests
    ordered at every node in the timed window over its wall time."""
    from indy_plenum_tpu_torch.common.metrics_collector import MetricsName
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    config = getConfig({
        "Max3PCBatchSize": POOL_BATCH, "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.1, "QuorumTickAdaptive": True,
        "TraceNetReceivers": 4, "ResidentTickDepth": 1})
    pool = SimPool(n_nodes=N_VALIDATORS, seed=11, config=config,
                   device_quorum=True, sign_requests=True,
                   shadow_check=False, pipelined_flush=True, trace=True,
                   device=device)
    seq = [0]

    def submit(count):
        for _ in range(count):
            seq[0] += 1
            pool.submit_request(seq[0])

    def run_until(target):
        start = pool.timer.get_current_time()
        while min(len(nd.ordered_digests) for nd in pool.nodes) < target:
            if pool.timer.get_current_time() - start > 600:
                raise AssertionError(f"phase A stalled below {target}")
            pool.run_for(0.1)

    def seconds(name):  # host wall time the pool's meters have summed
        stat = pool.metrics.stat(name)
        return stat.total if stat is not None else 0.0

    submit(POOL_BATCH)
    run_until(POOL_BATCH)
    n_txns = POOL_BATCHES * POOL_BATCH
    sign_t0 = time.perf_counter()
    submit(n_txns)
    sign_s = time.perf_counter() - sign_t0
    flushes0 = pool.vote_group.flushes
    auth0 = seconds(MetricsName.AUTH_BATCH_TIME)
    flush0 = seconds(MetricsName.DEVICE_FLUSH_TIME)
    sim_t0 = pool.timer.get_current_time()
    t0 = time.perf_counter()
    run_until(POOL_BATCH + n_txns)
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sim = pool.timer.get_current_time() - sim_t0
    if not pool.honest_nodes_agree():
        raise AssertionError("phase A: honest nodes disagree")
    ordered = min(len(nd.ordered_digests) for nd in pool.nodes) - POOL_BATCH
    auth = pool.metrics.stat(MetricsName.AUTH_BATCH_SIZE)
    dispatches = pool.vote_group.flushes - flushes0
    return _pool_result(
        pool, wall, ordered=ordered, sim_s=sim,
        ordered_txns_per_s=ordered / wall,
        ordered_txns_per_sim_s=ordered / sim,
        dispatches=dispatches,
        dispatches_per_batch=dispatches / (ordered / POOL_BATCH),
        ingress_drains=auth.count, verify_rows=int(auth.total),
        # where the timed window's wall time went: the ingress drain
        # (host preparation + verify chain) and the tick's group flush
        # (staging, step, readback, absorb); the rest is the 3PC
        # services in Python. Signing the requests precedes the window.
        drain_s=seconds(MetricsName.AUTH_BATCH_TIME) - auth0,
        flush_s=seconds(MetricsName.DEVICE_FLUSH_TIME) - flush0,
        client_sign_s=sign_s,
        governor=pool.governor.trajectory_summary())


def run_pool_b(device):
    """The RBFT instance axis, window slides and a view change: n=16 with
    six instances (96 member planes), signed, adaptive tick, 3PC batches
    of one request in a 30-slot window with checkpoints every 5, then the
    master primary disconnected until the pool changes view."""
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    config = getConfig({
        "Max3PCBatchSize": 1, "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.05, "QuorumTickAdaptive": True,
        "LOG_SIZE": B_LOG_SIZE, "CHK_FREQ": B_CHK_FREQ})
    pool = SimPool(n_nodes=B_NODES, seed=29, config=config,
                   device_quorum=True, sign_requests=True,
                   shadow_check=False, num_instances=B_INSTANCES,
                   trace=True, device=device)
    group = pool.vote_group
    slides = [0] * len(group._members)
    resets = [0] * len(group._members)
    real_slide, real_reset = group.slide_member, group.reset_member

    def slide_member(member_idx, delta):
        slides[member_idx] += 1
        real_slide(member_idx, delta)

    def reset_member(member_idx):
        resets[member_idx] += 1
        real_reset(member_idx)

    group.slide_member, group.reset_member = slide_member, reset_member
    t0 = time.perf_counter()
    for i in range(24):
        pool.submit_request(i)
    pool.run_for(15)
    pool.network.disconnect(pool.nodes[0].data.primaries[0])
    pool.run_for(pool.config.ToleratePrimaryDisconnection + 10)
    for i in range(100, 106):
        pool.submit_request(i)
    pool.run_for(15)
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not pool.honest_nodes_agree():
        raise AssertionError("phase B: honest nodes disagree")
    return _pool_result(pool, wall, members=len(slides),
                        min_slides=min(slides), member_resets=sum(resets),
                        max_view=max(nd.data.view_no for nd in pool.nodes))


# --- phase 5: report ----------------------------------------------------------


def kernel_report(dev, signers, reqs, rng, launches, errs):
    import torch
    from indy_plenum_tpu_torch.crypto import ed25519 as ed
    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import sha512 as s5

    # the ingress drain's shapes: 8192 entries, 2 SHA-512 blocks each
    msgs = [r.signing_bytes() for r in reqs]
    nb = ted.max_blocks_for(msgs)
    rows, arrays = verify_inputs(signers, reqs, rng, DRAIN)
    pk, rb, sb, hb = [torch.from_numpy(a).to(dev) for a in arrays]
    # the verify kernel's work depends on the data: count the signatures
    # whose A decompresses (they run the whole check)
    decodes = {}
    for p, _, _ in rows:
        if p not in decodes:
            decodes[p] = ed.decompress(p) is not None
    n_full = sum(decodes[p] for p, _, _ in rows)
    prefixes = [bytes(arrays[1][i]) + bytes(arrays[0][i])
                for i in range(DRAIN)]
    blocks_np, counts_np = s5.pad_ed25519_messages(
        prefixes, [msgs[i % len(msgs)] for i in range(DRAIN)], nb)
    blocks = torch.from_numpy(blocks_np).to(dev)
    counts = torch.from_numpy(counts_np).to(dev)
    # K-a and K-b against their plain versions at these shapes
    digest = s5.sha512_blocks(blocks, counts)
    scalar = s5.reduce_mod_l(digest)
    err_a = _max_abs_err([(digest, s5.sha512_blocks_plain(blocks, counts))])
    err_b = _max_abs_err([(scalar, s5.reduce_mod_l_plain(digest))])
    if err_a or err_b:
        raise AssertionError(f"K-a/K-b differ from plain on the drain: "
                             f"{err_a} {err_b}")
    errs = dict(errs, sha512_blocks=max(errs["sha512_blocks"], err_a),
                reduce_mod_l=max(errs["reduce_mod_l"], err_b))

    def sha():
        return s5.sha512_blocks(blocks, counts)

    def modl():
        return s5.reduce_mod_l(digest)

    def ver():
        return ted.verify_kernel(pk, rb, sb, hb)

    t_sha = _kernel_ms(sha, 20)
    call_sha = _cuda_ms(sha, 20)
    t_sha_plain = _cuda_ms(lambda: s5.sha512_blocks_plain(blocks, counts),
                           1, 0)
    t_modl = _kernel_ms(modl, 20)
    call_modl = _cuda_ms(modl, 20)
    t_modl_plain = _cuda_ms(lambda: s5.reduce_mod_l_plain(digest), 1, 0)
    t_ver = _kernel_ms(ver, 5)
    call_ver = _cuda_ms(ver, 5)
    t_ver_plain = _cuda_ms(lambda: ted.verify_kernel_plain(pk, rb, sb, hb),
                           1, 0)

    m, n, s, c, w = (N_VALIDATORS, N_VALIDATORS, LOG_SIZE, N_CHECKPOINTS,
                     128)
    state = q.init_state(n, s, c, m, dev)
    words_np = _wave_words(m, w, n, s, [10], rng)
    words = q.words_tensor(words_np, dev)

    def quorum():
        return q.step_compact(state, words, n)

    t_q = _kernel_ms(quorum, 50)
    call_q = _cuda_ms(quorum, 50)
    t_q_plain = _cuda_ms(lambda: q.step_plain(state, words, n), 5)

    # K8 as the pool calls it: one member slides by a checkpoint interval
    # (host deltas, the others 0); one member zeroed (host mask)
    votes = _random_votes(dev, rng, m, n, s, c)
    deltas = torch.zeros(m, dtype=torch.int32)
    deltas[rng.randint(m)] = CHK_FREQ
    mask = torch.zeros(m, dtype=torch.bool)
    mask[rng.randint(m)] = True

    def slide():
        q.slide_state(votes, deltas)

    def zero():
        q.zero_members(votes, mask)

    t_slide = _kernel_ms(slide, 50)
    call_slide = _cuda_ms(slide, 50)
    t_slide_plain = _cuda_ms(lambda: q.slide_plain(votes, deltas), 5)
    t_zero = _kernel_ms(zero, 50)
    call_zero = _cuda_ms(zero, 50)
    t_zero_plain = _cuda_ms(lambda: q.zero_plain(votes, mask), 5)

    n_blocks = int(counts_np.sum())
    # K-d reads every plane once and writes only the vote bytes its words
    # hit (all of this wave's words are valid and in range), the ordered
    # and acked planes, the frontier, the events and the compact record
    state_bytes = m * (3 * s + 2 * n * s + n * c + 4)
    hits = int(((words_np >> 31) & 1).sum())
    events_bytes = m * (3 * s + c + 8 * s)
    width = q.delta_width(s, q.ORDER_DELTA_CAP)
    compact_bytes = m * (4 + 8 * width + 8 + c)
    quorum_bytes = (state_bytes + 4 * m * w + hits + m * (2 * s + 4)
                    + events_bytes + compact_bytes)
    # K8 moves bytes and computes nothing: the sliding member's rows read
    # where they survive (S - d columns) and written whole, its
    # checkpoint votes written, its frontier read and written, the deltas
    # read; the zero writes every leaf of the masked member, reads the mask
    leaf_rows = 2 * n + 3
    slide_bytes = (leaf_rows * (s - CHK_FREQ) + leaf_rows * s + n * c + 8
                   + 4 * m)
    zero_bytes = leaf_rows * s + n * c + 4 + m

    def bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    rows = [
        ("sha512_blocks", "indy_plenum_tpu_torch/csrc/sha512.cu",
         "indy_plenum_tpu/tpu/sha512.py:201", t_sha, t_sha_plain,
         bound(128 * n_blocks + 4 * DRAIN + 64 * DRAIN,
               n_blocks * SHA512_OPS_PER_BLOCK)),
        ("reduce_mod_l", "indy_plenum_tpu_torch/csrc/sha512.cu",
         "indy_plenum_tpu/tpu/sha512.py:249", t_modl, t_modl_plain,
         bound(DRAIN * (64 + 32), DRAIN * MOD_L_OPS_PER_ITEM)),
        ("ed25519_verify", "indy_plenum_tpu_torch/csrc/ed25519.cu",
         "indy_plenum_tpu/tpu/ed25519.py:165", t_ver, t_ver_plain,
         bound(DRAIN * (4 * 32 + 1),
               n_full * VERIFY_OPS_PER_ITEM
               + (DRAIN - n_full) * DECOMPRESS_OPS_PER_ITEM)),
        ("quorum_step", "indy_plenum_tpu_torch/csrc/quorum.cu",
         "indy_plenum_tpu/tpu/quorum.py:284", t_q, t_q_plain,
         bound(quorum_bytes, m * (10 * w + 2 * n * s + 12 * s))),
        ("window_slide", "indy_plenum_tpu_torch/csrc/window.cu",
         "indy_plenum_tpu/tpu/quorum.py:358", t_slide, t_slide_plain,
         bound(slide_bytes, 0)),
        ("window_zero", "indy_plenum_tpu_torch/csrc/window.cu",
         "indy_plenum_tpu/tpu/compile_plan.py:83", t_zero, t_zero_plain,
         bound(zero_bytes, 0)),
    ]
    out = []
    for name, src, replaces, ms, plain_ms, (bound_ms, bound_by) in rows:
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})

    # bench.py's Ed25519 metric: verify_kernel_full at 32768
    big = BENCH_VERIFY_BATCH // DRAIN
    bpk, brb, bsb, bhb = [t.repeat(big, 1) for t in (pk, rb, sb, hb)]
    bblocks = blocks.repeat(big, 1, 1)
    bcounts = counts.repeat(big)
    t_full = _cuda_ms(
        lambda: ted.verify_kernel_full(bpk, brb, bsb, bblocks, bcounts), 5)
    # the curve check alone at 4x the drain: how its time scales with load
    t_ver_big = _cuda_ms(lambda: ted.verify_kernel(bpk, brb, bsb, bhb), 5)
    return out, errs, {"verify_full_ms_32768": t_full,
                 "verify_ms_32768": t_ver_big,
                 "verifies_per_s": BENCH_VERIFY_BATCH / (t_full / 1e3),
                 "quorum_step_ms_64x128": t_q, "n_sha_blocks": n_blocks,
                 "call_ms": {"sha512_blocks": call_sha, "reduce_mod_l":
                             call_modl, "ed25519_verify": call_ver,
                             "quorum_step": call_q,
                             "window_slide": call_slide,
                             "window_zero": call_zero},
                 "verify_full_rows": n_full}


# the kernels each main-path run must launch
PATH_KERNELS = {
    "ingress": ("sha512_blocks", "reduce_mod_l", "ed25519_verify"),
    "quorum": ("quorum_step", "window_slide"),
    # 11 batches of 320: below one checkpoint interval, so no slide
    "pool_a": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
               "quorum_step"),
    "pool_b": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
               "quorum_step", "window_slide", "window_zero"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import resolve_device, \
        set_deterministic

    set_deterministic()
    dev = resolve_device()
    card = _nvidia_smi()
    t_start = time.perf_counter()

    # 1. build
    t0 = time.perf_counter()
    kb.library()
    build_s = time.perf_counter() - t0
    _line("build", seconds=build_s, nvcc_seconds=kb.last_build_seconds,
          card=card)

    # 2. kernels against their plain versions, on the card
    t0 = time.perf_counter()
    rng = np.random.RandomState(20261016)
    signers, reqs = make_signed_requests(seed=64)
    err_a, err_b = check_sha512_and_mod_l(dev, rng)
    err_c, n_ok, n_rows = check_verify(dev, signers, reqs, rng)
    err_d, q_steps = check_quorum(dev, rng)
    # K8 at the shapes the main path gives it: phase 4's and phase A's
    # group (64 x 64 x 300) and phase B's (96 x 16 x 30)
    err_slide, err_zero = check_window(
        dev, rng, N_VALIDATORS, N_VALIDATORS, LOG_SIZE, N_CHECKPOINTS,
        CHK_FREQ)
    b_slide, b_zero = check_window(
        dev, rng, B_NODES * B_INSTANCES, B_NODES, B_LOG_SIZE,
        B_LOG_SIZE // B_CHK_FREQ, B_CHK_FREQ)
    err_slide, err_zero = max(err_slide, b_slide), max(err_zero, b_zero)
    errs = {"sha512_blocks": err_a, "reduce_mod_l": err_b,
            "ed25519_verify": err_c, "quorum_step": err_d,
            "window_slide": err_slide, "window_zero": err_zero}
    _line("kernels", max_abs_err=errs, verify_accepted=n_ok,
          verify_rows=n_rows, quorum_steps=q_steps,
          phase_s=time.perf_counter() - t0, card=card)

    # 3, 4, A, B: the main path. Every launch counter is 0 just before
    # each run on the card and read just after; the sums are the
    # kernels line's launches
    launches = {name: 0 for name in kb.LAUNCHES}

    def on_card(tag, fn, *args):
        torch.cuda.synchronize()
        kb.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kb.launch_counts()
        for name in PATH_KERNELS[tag]:
            if got[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"{tag} path")
        for name, count in got.items():
            launches[name] += count
        return out, got, wall

    ingress, ingress_launches, ingress_s = on_card(
        "ingress", run_ingress, dev, signers, reqs, random.Random(3))
    _line("ingress", **ingress, launches=ingress_launches,
          phase_s=ingress_s, card=card)

    t0 = time.perf_counter()
    validators = [f"Node{i}" for i in range(N_VALIDATORS)]
    (glog, gfront, gcount, gwall, gticks, gh), quorum_launches, _ = \
        on_card("quorum", run_quorum_schedule, "cuda", validators)
    clog, cfront, ccount, _, cticks, _ = run_quorum_schedule(
        "cpu", validators)
    if glog != clog or gfront != cfront or gcount != ccount \
            or gticks != cticks:
        raise AssertionError("card and CPU runs of phase 4 differ")
    if any(fr != N_SLOTS for fr in gfront):
        raise AssertionError(f"frontiers end at {set(gfront)}, not "
                             f"{N_SLOTS}")
    slides = sum(1 for e in glog if e[2] == "slide") // N_VALIDATORS
    if slides < 3:
        raise AssertionError(f"only {slides} window slides")
    # a scripted vote schedule through the plane, not the pool's ordered
    # rate: no request flows through this phase
    plane_slots_per_s = N_SLOTS / gwall
    trace = trace_quorum(validators, gwall, glog)
    _line("quorum", slots=N_SLOTS, ticks=gticks, slides_per_member=slides,
          final_h=gh[0], wall_s=gwall,
          plane_ordered_slots_per_s=plane_slots_per_s,
          counters=gcount, delta_events=len(glog),
          launches=quorum_launches, phase_s=time.perf_counter() - t0,
          card=card)
    _line("quorum_trace", **trace, card=card)

    # A. the n=64 ordered-txns cell through the port's pool
    t0 = time.perf_counter()
    pool_a, a_launches, _ = on_card("pool_a", run_pool_a, None)
    cpu_a = run_pool_a("cpu")
    for key in ("ordered_hash", "trace_hash", "views", "ordered_min"):
        if pool_a[key] != cpu_a[key]:
            raise AssertionError(f"phase A: card and CPU differ on {key}")
    if pool_a["ordered"] != POOL_BATCHES * POOL_BATCH:
        raise AssertionError(f"phase A ordered {pool_a['ordered']}")
    _line("pool_a", **pool_a, launches=a_launches,
          cpu_wall_s=cpu_a["wall_s"], phase_s=time.perf_counter() - t0,
          card=card)

    # B. the instance axis, slides and a view change
    t0 = time.perf_counter()
    pool_b, b_launches, _ = on_card("pool_b", run_pool_b, None)
    cpu_b = run_pool_b("cpu")
    for key in ("ordered_hash", "trace_hash", "views", "min_slides",
                "member_resets"):
        if pool_b[key] != cpu_b[key]:
            raise AssertionError(f"phase B: card and CPU differ on {key}")
    if pool_b["min_slides"] < 4 or pool_b["max_view"] < 1:
        raise AssertionError("phase B: too few slides or no view change")
    _line("pool_b", **pool_b, launches=b_launches,
          cpu_wall_s=cpu_b["wall_s"], phase_s=time.perf_counter() - t0,
          card=card)

    # 5. report
    t0 = time.perf_counter()
    kernels, errs, times = kernel_report(dev, signers, reqs, rng, launches,
                                         errs)
    print(json.dumps({"kernels": kernels}), flush=True)
    plain = {k["name"]: k["plain_ms"] for k in kernels}
    print(json.dumps({"times": {
        "card": card, "verify_full_ms_32768": times["verify_full_ms_32768"],
        "verifies_per_s_32768": times["verifies_per_s"],
        "verify_rows_decompressed_of_8192": times["verify_full_rows"],
        "verify_kernel_ms_32768": times["verify_ms_32768"],
        "quorum_step_ms_64x128": times["quorum_step_ms_64x128"],
        "call_ms": times["call_ms"],
        "plane_ordered_slots_per_s": plane_slots_per_s,
        "pool_a_ordered_txns_per_s": pool_a["ordered_txns_per_s"],
        "pool_a_ordered_txns_per_sim_s": pool_a["ordered_txns_per_sim_s"],
        "plain_ms": plain, "report_s": time.perf_counter() - t0,
        "total_s": time.perf_counter() - t_start}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
