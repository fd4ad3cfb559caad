#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one card, at the n=64 and n=256
sizes.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``indy_plenum_tpu_torch/csrc``, holds
each kernel bit-equal against its plain PyTorch version on the card, then
drives the signed write path through its entry points at the size of
``bench.py``'s n=64 cell (64 validators, one protocol instance, so 64
member planes; LOG_SIZE 300, CHK_FREQ 100):

1. build      - nvcc for sm_90a, seconds, and the BN254 extension
                (``native/bn254/bn254c.c``, gcc); the card's name and
                power limit;
2. kernels    - K-a SHA-512 (ragged rows, a misaligned view refused), K-b mod L (at 8,192 and 32,768
                rows with
                its edge values, also against Python ints), K-c Ed25519
                verify (the drain,
                its first 1, 3 and 7 rows, the drain four times, the edge
                rows), K-d (K7) quorum step (from an empty state, and
                from random states at the shapes of phases A, B, H, C and
                R), K8 window slide (host and device deltas, 520 sliding
                members) and zero (host and device masks: none, one,
                every and 520 members), each against its plain version on
                the same inputs; K12 SHA-256 (11 padding-edge lengths) and K11
                (waves of 1 .. 65,536 as one-level plans, a real 320-key
                commit plan of ~250 levels, a plan whose levels loop over
                a full cluster)
                against their plain versions and hashlib; K10 audit fold, dense
                and indexed, on 16,384 proofs of a 131,072-leaf tree with
                planted faults, against the plain versions and the host
                MerkleVerifier, and a chunk with a 49+-level path; K9
                resident step at phase A's and B's group shapes and an odd
                N for k = 1, 2, 4 and 7 slots (edge slides, an empty
                slot), with one member sliding at 1, 2, 4 and 8 blocks a
                member, and against K7 at k = 1; K14 fused verify +
                quorum step (one launch a call) at the graft entry's shape,
                twice on one state, and on 8,192 signed votes with planted
                faults, against its plain version, the pure-Python oracle
                and K7 alone on the good votes; K13 fabric step at M = N =
                256, S = 300 on (8,) and (4, 2) and N = 250 on v = 4, with
                and without dropped words and the compact record, at the
                wrapper's cluster size and at 1, 2, 4 and 8 blocks, and
                against K7 at v = 1; the tiled K9
                at k = 1, 2, 4 on phase H's and R's shapes, v = 1, 2 and
                4, padded rows, S % 4 != 0, every slide class, and every
                cluster size of 1 to 8 blocks; K1 ring shift for every
                shift 1 .. m + 1 on (8,) and (4, 2), at phases H's and
                R's states and on odd-sized leaves; the one-card rotation
                (one K1 roll) against the reference's arms and merge, and
                K15's merge called on those arms, for 8 rotations on
                (8,), (4, 2) and without a mesh; the sharded K14 on 4
                validator tiles with phase G's votes;
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
F. residency  - phase A's config (F1) and phase B's (F2) at
                ``ResidentTickDepth`` 4, on the card only: each orders what
                its phase ordered (``ordered_hash``; F2 also every view,
                and every plane's h at its node's low watermark), every
                consume is K9 and every slide folds into it (no K8 slide);
                prints dispatches per ordered batch beside phase A's;
G. fused step - K14 at 8,192 signed votes into one 64 x 300 member through
                ``tpu/step.py``'s ``fused_step`` (one launch a call, no
                K-c launch of its own): votes/sec, K-c's share of the
                step's device time and the tail (the last block's count
                and decide); the same votes through the sharded K14 on 4
                validator tiles give the same result;
H. fabric     - ``bench.py``'s fabric cell (n=256, one instance, 320
                warm-up then 640 timed requests) in four arms on the card:
                one device (K7), the (8,) member mesh and the (4, 2)
                member x validator fabric (K13), and the fabric at
                ``ResidentTickDepth`` 4 (the tiled K9); one ``ordered_hash``
                for all four; per arm the wall, ordered txns/sec,
                dispatches per ordered batch, readbacks (overlapped, bytes
                per member block) and K13 launches;
R. rebalance  - the reference's forced-rebalance pool at n=64 (batches of
                one, CHK_FREQ 5, LOG_SIZE 15, depth 4, seed 23) on (4, 2)
                and (8,): ``RebalanceForceTick`` 12 against 0 gives the
                same ``ordered_hash`` and dispatch-free ``trace_hash``; the
                forced arm rotates at least once, each rotation one K1
                launch and no K15;
C. execution  - real execution at n=4 with two RBFT instances and
                phase A's config: signed NYMs executed into every node's
                ledgers and SMT states, 320 warm-up requests then 3,200
                timed, the state's device waves on the card as one K11
                commit plan per commit; the same seed with host waves,
                and with the default "auto" law (a fresh offload policy),
                must give the same ordering, ledger hashes and state and
                txn roots; prints ordered txns/sec, the share of the wall
                spent executing, the device commits (each one K11
                launch), their levels and mean width, and how many hashes
                "auto" put on the card;
D. reads      - proved reads over phase C's committed domain ledger
                (drains of 4,096 through ``make_read_service(mode=
                "device")``, K10 indexed), then the catchup-proof shape
                end to end and kernel only;
L. catchup    - ``bench.py``'s end-to-end catchup cell (n=4, seed 31,
                batches of 10, CHK_FREQ 10, LOG_SIZE 30): 30 warm-up
                requests, node3 disconnected while 150 more order, then
                reconnected and caught up by its leecher from a fresh
                offload policy, so the first domain slice (150 proofs)
                verifies through K10 indexed on the card inside the live
                pool (L1); L2 is L1 with the peer sent that slice
                altering one txn of its rep: the card's verdict rejects
                it (a CATCHUP_REP_WRONG suspicion), the slice is
                re-assigned and the round completes. Each arm again with
                ``device="cpu"`` on the same seed: equal ``ordered_hash``,
                ``trace_hash``, ledger hashes, roots, state heads and
                ``catchup_stats()``; K10's calls held against plain after
                the run; leeched txns per sim-second and wall-second,
                proofs on the card and on the host, K10 launches;
P. proofs     - the state-proof plane at BASELINE config 3's width (64
                validators, ``bench.py``'s ``bench_bls_multisig`` and
                ``bench_state_proofs``): aggregate + ``verify_multi_sig``
                cycles/sec, ``verify_multi_sigs_batch`` at 1, 16 and 64
                windows (seeded) and a forged window named; 4,096
                proof-attached reads over ``StaticCorpusBacking(4096)``
                through ``ReadService(mode="device", proof_cache=)`` (K10
                indexed, no pairing on the serve path), equal to the CPU's
                replies, ``verify_proved_read`` on a seeded sample with the
                pool's keys alone and on a tampered reply; then a real BLS
                pool (n=4, phase C's batches, CHK_FREQ 2) on the card and
                on the CPU until a proof window stabilizes: equal
                ordering, trace, ledgers, roots, BLS stores, a
                ``read_nym_with_proof`` and a proof-attached drain;
X. chaos      - ``f_crash_gc_catchup``, ``byzantine_seeder_catchup`` and
                ``f_crash_partition`` (seed 7) through ``run_scenario`` on
                the tick plane (tick 0.05, adaptive): the card's report
                equal to the CPU's (the host's wall-clock flush series
                aside), every invariant as designed, K7 / K8 launches
                equal to the dispatches the CPU run counted; the
                victim's recovery in virtual seconds; then the
                workload planes' scenarios ``lane_partition``,
                ``edge_cache_poisoning`` and
                ``f_crash_catchup_under_saturation`` the same way, their
                CPU twins in the worker processes;
O. overload   - ``bench.py``'s ``_run_overload``, the open-loop and the
                closed-loop (retry) arm: n=8, signed, an admission queue
                of 12, 100 writes/s with a crowd at 3.0 s for 1.5 s at
                8x over 9 s, 25% reads through ``ReadService(mode=
                "device")`` over ``StaticCorpusBacking(4096, seed=37)``
                (K10 indexed); ``shed_hash``, ``retry_hash``,
                ``ordered_hash``, the trace and the replies equal the CPU
                twin's; goodput, the first-attempt/retry split, the rates
                before and after the crowd;
N. lanes      - ``bench.py``'s ``bench_lanes``: 1 and 4 lanes of n=64
                (2 lanes too while the clock allows), 96 txns a lane in
                batches of 16, CHK_FREQ 2, LOG_SIZE 6, seed 17, each lane
                its own vote group (K7 a lane a tick, K8's slide); 4
                lanes >= 3.0x one lane in virtual time, no orphan
                journey, every journey with its lane and barrier hop; the
                4-lane arm's per-lane ``ordered_hash``es, sealed
                fingerprint and ``journey_hash`` equal the CPU twin's;
S. soak       - ``simulation/soak.py``'s day soak at ``bench.py``'s
                ``bench_day_soak`` slice (6 virtual hours, a crash at
                1.5 h for 0.5 h, a view change at 3 h, the forced
                rebalance at ``SoakRebalanceTick``) on the (4,) fabric
                (K13 each tick, K1 for the rotation): ``fingerprint``,
                ``telemetry_hash`` and the hourly tallies equal the CPU
                twin's; flat high-water, no unexplained anomaly, both
                chaos legs ok;
W. geo        - ``bench.py``'s ``bench_geo``: the ordering arms at n=6
                and the laned barrier arms with regions 0 and 3 (seed
                23), then the edge and no-edge read arms (n=4, BLS, real
                execution, 3 regions, 6 waves of 120 clients, seed 29)
                with the origin in ``mode="device"`` (K10 indexed): WAN
                costs virtual time, >= 90% edge hits at the intra-region
                p99, no pairing on the edge serve path, the arms'
                fingerprints equal and the whole record equal to the CPU
                twin's;
V. node       - the deployed validator node: real ``Node``s in
                ``simulation/node_pool.NodePool`` on the tick plane
                (0.05 s), traced. V1 is ``BASELINE.json`` configs[1]: 25
                nodes with full RBFT (f = 8, 9 instances, 225 member
                planes in one grouped K7 step), BLS, pool genesis, the
                reference's batching defaults; one client sends 3 bursts
                of 100 signed NYMs to every node (configs[1]'s 10,000
                pending requests cut for the clock: the CPU twin pays the
                plain verify in every node's drain), each drained in
                every node (K-a, K-b, K-c) and executed into every node's
                ledgers and SMT states (K11 under "auto"), then one node
                serves a GET_NYM the client verifies with the pool's BLS
                keys alone. V2a is configs[0], the 4-node everything-on
                pool (``tests/test_byzantine_node.py:90``) with 64 writes,
                so every member slides (K8). V2b is the throttled master
                (``tests/test_monitor_replicas.py:52`` on the device
                plane): every node's monitor votes it out, the view change
                zeroes the planes (K8), the 16 writes order under the new
                primary. Each arm's record (per node ordered digests,
                views, primaries, stable checkpoints, ledger and state
                roots, monitor votes and snapshots; client results; the
                dispatch-free ``trace_hash``) equals its CPU twin's, K-a,
                K-b and K-c launch once a drain, and K7 / K8 launches
                equal the dispatches the CPU twin counted;
Y. replay     - the recorder (``recorder/``): node2 of a live
                ``NodePool`` on the card is recorded from before the first
                write, its log dumped to a file and loaded back, and
                replayed into a fresh ``Node`` on a fresh ``MockTimer``
                with ``ReplayNetwork``, on the card. Y1 is the reference's
                recorder test (``NodePool(4, seed=82)``, the host quorum,
                30 signed NYMs round-robin: three batches); Y2 is V2a's
                pool with 48 writes (two stable checkpoints) replayed into
                a node with its own standalone ``DeviceVotePlane`` ticking
                on the node's timer (K7, K8's slide). Each replay gives the
                live node2's ordered digests, domain root and state head;
                the recorded file, the fingerprint and the replay's
                launches equal the CPU twin's (K-a/K-b/K-c once a drain,
                K7 / K8 as the CPU counted);
Z. sockets    - the deployed transport (``network/``, ``tools/``,
                ``cli/``) over real CurveZMQ sockets, ``zmq.has("curve")``
                required. Z1 is ``BASELINE.json`` configs[0]: a 4-node
                pool provisioned by ``generate_pool_config`` (fixed master
                seed, free ports) and run by ``run_pool`` on one Looper,
                BLS on; after ``warm_verify_kernel``, 1,000 trustee-signed
                NYMs from a socket client, at most 100 in flight, each
                with f+1 matching REPLYs; a forged signature REQNACKed; 16
                proved GET_NYMs verified with the pool's BLS keys alone; a
                VALIDATOR_INFO answered; every node's ledgers and state
                equal, no looper error, no rejected curve key; node1
                recorded from before the first write and replayed into a
                fresh node on the card on a ``MockTimer``, to node1's
                ordered digests, ledger roots and state root. Z2 runs the
                three scenarios of ``tests/test_socket_membership.py``
                (node3 frozen through 40 writes and caught up, its slice
                on K10 indexed; node4 added by a NODE txn; node3's key
                rotated), each ending with equal roots. Z3 is
                ``tests/test_cli.py``'s scripted session through
                ``PoolCli``. Z4 provisions with ``python -m
                indy_plenum_tpu_torch.tools.generate_pool``, runs one
                ``python -m indy_plenum_tpu_torch.tools.start_node``
                process per validator, orders 200 signed writes from a
                client here and SIGINTs every process, which must exit 0
                and leave its log. The pool runs on the wall clock (each
                3PC batch carries the primary's wall-clock ``ppTime``, and
                socket timing decides what arrives before which timer
                fires), so no CPU run can equal it record for record:
                phase Z has no CPU twin, and Z1's replay on a virtual
                timer is its deterministic check;
T. tools      - the operator entry points (``indy_plenum_tpu_torch/
                tools/``), each through its ``main`` as its command line
                calls it. T1 is ``check_dispatch_budget`` at its defaults
                with ``--only`` the sharded, fabric, tracing, readback,
                residency, latency, catchup, governor, lanes, proof and
                geo gates (the dispatch budget always runs): verdict PASS,
                and every field but the walls equal to the same command's
                CPU twin from the worker processes. T2 is ``chaos_run``
                on ``f_crash_gc_catchup`` (seed 7) on the tick plane
                (0.05), then its report's ``replay_command`` as a process
                of its own: the two reports and a CPU run's are equal but
                for the wall-clock flush series, and K7 / K8 launch as
                the CPU counted. T3 is ``ingress_run`` twice on one seed
                (n=16, signed, 400 writes/s for 3 s, a queue of 16, half
                reads): equal records but for the walls and
                ``read_qps``; its ``--trace-out`` dump through every
                ``trace_tool`` view, and ``--chrome`` JSON that loads. T4
                is ``profile_rbft`` (n=16, 6 instances, 960 txns) on four
                member tiles at depth 4, its top hotspots printed. T5 is
                ``graft_entry``: ``fn(*args)`` (K14) equal to its plain
                version on the same inputs, and ``dryrun_multichip(4)``'s
                sharded step equal to the step on one tile and to the CPU's
                dry run, its three pools ordering as the CPU's;
E. state      - ``run_commit_arms`` host vs device waves at the
                reference's state-bench delta and windows (delta 256, 20
                windows) over a 20,000-key state (the cell's 100,000 cut
                for the clock): equal per-window roots;
5. report     - a ``kernels`` JSON line (launches of the main path's runs,
                K-a/K-b held against their plain versions at the drain's
                shapes, times, bounds; K-a's one-message chain floor, K1
                and the one-card rotation also at phase R's state), a
                times line (with K11's and K10's
                dependent-chain floors, K10 at 32, 64 and 128 threads a
                block, K13 at v = 1 against K7), the card, and last
                ``{"ok": true, "device": {...}}``.

Each main-path run (phases 3, 4, A, B, F, G, H, R, C, D, L, P, X, O, N, S,
W, V, Y, Z, T and E on the card) starts with every launch counter at 0 and
reads the counters right after; the ``kernels`` line's ``launches`` are
their sums, with Z4's counted in its validator processes (each prints its
own at exit). The CPU twins of phases A, B, O, N, S, W, V, Y, X's workload
arms and T1 run in worker processes (``TWIN_WORKERS``, one torch thread
each) started with the script and stopped with it.

Any mismatch raises and the script exits non-zero. It imports nothing of
JAX. Without a CUDA device it exits non-zero before printing a result.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
# sources (lower bounds: the dominant terms only). sm_90a merges any
# 3-input logic into one LOP3 and two chained adds into one IADD3 (a
# 64-bit 3-input add is IADD3 + IADD3.X); a rotate is one funnel shift
# SHF per 32-bit word. ``python -m indy_plenum_tpu_torch.utils.sass_count``
# counts what the compiler emitted, to check these against.
# SHA-512, per 128-byte block: 80 rounds x 28 (two sigmas of 3 64-bit
# rotates = 6 SHF + 2 LOP3 each, ch and maj 2 LOP3 each, the 7 adds as 4
# 3-input 64-bit adds = 8) + 64 schedule words x 20 (two sigmas of 8, 3
# adds as 2 3-input 64-bit adds = 4) + 16 byte swaps x 2 + 8 final 64-bit
# adds x 2. Round 0 of a message's first block sees only the constant IV:
# two 64-bit adds, not 28 instructions.
SHA512_OPS_PER_BLOCK = 80 * 28 + 64 * 20 + 32 + 16
SHA512_IV_ROUND_SAVING = 28 - 4
# h mod L, per item, as the least Barrett reduction on 64-bit limbs
# needs it (b = 2^64, k = 4, mu = floor(2^512 / L)): q3 from the columns
# 3..8 of q1 * mu only (HAC 14.44: the dropped columns sum below 2^259, so
# q3 falls at most one further short, 19 of the 25 products), q3 * L mod
# 2^256 (10 products, since 3L < 2^256), h - q3 L over 4 limbs (2 each
# with the hardware's borrow chain), then two conditional 4-limb
# subtractions of L (~6 a limb: the subtraction and the select on two
# 32-bit halves, the borrow). A 64x64->128 product is 4 32-bit wide
# multiply-adds and ~4 carries, + ~4 to accumulate. The kernel
# (csrc/sha512.cu) does all 25 products and issues more a product: its
# SASS holds 154 IMAD.WIDE for 35 products and 754 integer instructions
# an item (utils/sass_count.py), its carries taken by compare and select.
MOD_L_OPS_PER_ITEM = (19 + 10) * (8 + 4) + 4 * 2 + 2 * 4 * 6
# Ed25519 verify, per signature, counted from csrc/ed25519.cu and
# fe25519.cuh: a field multiply is 25 64x64->128 products x 8
# instructions + ~110 for the 128-bit column sums and carries; a square
# 15 products + ~90. Decompress: 18 multiplies, 255 squares (pow_p58);
# a signature whose A fails to decompress stops there. The rest: x*y 1,
# table 127 multiplies, 64 windows x (32 multiplies + 16 squares),
# compress 13 multiplies + 254 squares (invert).
# SHA-256, per 64-byte compression, counted from csrc/sha256.cu: 64
# rounds x 14 (two Sigmas of 3 SHF + 1 LOP3, ch and maj 1 LOP3 each, the
# 7 adds as 4 IADD3) + 48 schedule words x 10 (two sigmas of 2 SHF + 1
# shift + 1 LOP3, 3 adds as 2 IADD3) + the 8 final adds. Constants fold:
# round 0 of a message's first compression sees only the constant IV (2
# instructions, not 14); the second block of H(0x01 || l || r) holds one
# variable word, so schedule words 16..37 cost 107 instead of 220; the
# padding block of a 64-byte message is all constant, so its schedule
# costs nothing.
SHA256_OPS_PER_COMPRESSION = 64 * 14 + 48 * 10 + 8
SHA256_IV_ROUND_SAVING = 14 - 2
SHA256_NODE_OPS = (2 * SHA256_OPS_PER_COMPRESSION - SHA256_IV_ROUND_SAVING
                   - (220 - 107))
SHA256_64B_OPS = (2 * SHA256_OPS_PER_COMPRESSION - SHA256_IV_ROUND_SAVING
                  - 48 * 10)
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


@contextlib.contextmanager
def _unfilled():
    """Time as a user's process runs: ``set_deterministic`` (PyTorch's
    deterministic algorithms) also fills every ``torch.empty`` on the card
    with a pattern, one more kernel writing each output a wrapper
    allocates, which a process without the flag never runs. The checks
    keep the fill (a byte a kernel leaves unwritten shows); the times are
    taken without it."""
    import torch.utils.deterministic as td

    before = td.fill_uninitialized_memory
    td.fill_uninitialized_memory = False
    try:
        yield
    finally:
        td.fill_uninitialized_memory = before


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    with _unfilled():
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

    with _unfilled():
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


def bound(nbytes, ops):
    """The least time the card could take, in ms, and what sets it: bytes
    over the memory rate or 32-bit integer instructions over the issue
    rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def step_work(m, n, s, c, words_np):
    """(bytes, 32-bit instructions) of one grouped quorum step over an
    (M, N, S, C) group and these (..., M, W) words: every plane read once,
    each valid word read and its hit written, the ordered and acked planes
    and the frontier written, the events and the compact record written;
    a few instructions per word and per vote byte counted."""
    from indy_plenum_tpu_torch.tpu import quorum as q

    state_bytes = m * (3 * s + 2 * n * s + n * c + 4)
    hits = int(((words_np >> 31) & 1).sum())
    events_bytes = m * (3 * s + c + 8 * s)
    width = q.delta_width(s, q.ORDER_DELTA_CAP)
    compact_bytes = m * (4 + 8 * width + 8 + c)
    nbytes = (state_bytes + 4 * words_np.size + hits + m * (2 * s + 4)
              + events_bytes + compact_bytes)
    return nbytes, 10 * words_np.size + m * (2 * n * s + 12 * s)


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
    """K-a on 4,133 ragged rows of 8 blocks (counts 0 .. 8; not a multiple
    of the block size) against its plain version; on padded real messages
    against hashlib; a view 8 bytes off a 16-byte boundary refused. K-b at
    8,192 and 32,768 rows."""
    import torch
    from indy_plenum_tpu_torch.tpu import sha512 as s5

    batch, nb = 4133, 8
    blocks = torch.from_numpy(
        rng.randint(0, 256, (batch, nb, 128)).astype(np.uint8)).to(dev)
    counts = rng.randint(0, nb + 1, batch).astype(np.int32)
    counts[:4] = [0, 1, nb - 1, nb]
    counts = torch.from_numpy(counts).to(dev)
    got = s5.sha512_blocks(blocks, counts)
    ref = s5.sha512_blocks_plain(blocks, counts)
    err_a = _max_abs_err([(got, ref)])
    skewed = torch.empty(batch * nb * 128 + 8, dtype=torch.uint8,
                         device=dev)[8:].view(batch, nb, 128)
    try:
        s5.sha512_blocks(skewed, counts)
    except ValueError:
        pass
    else:
        raise AssertionError("K-a took a view off a 16-byte boundary")
    # and the standard itself, on padded real messages
    msgs = [rng.bytes(int(n)) for n in rng.randint(0, 8 * 128 - 81, 64)]
    pb, pc = s5.pad_ed25519_messages([b""] * 64, msgs, 8)
    dig = s5.sha512_blocks(torch.from_numpy(pb).to(dev),
                           torch.from_numpy(pc).to(dev)).cpu().numpy()
    for row, m in zip(dig, msgs):
        if row.tobytes() != hashlib.sha512(m).digest():
            raise AssertionError("sha512_blocks disagrees with hashlib")
    err_b = max(check_mod_l(dev, rng, DRAIN),
                check_mod_l(dev, rng, BENCH_VERIFY_BATCH))
    if err_a or err_b:
        raise AssertionError(f"K-a/K-b differ from plain: {err_a} {err_b}")
    return err_a, err_b


def mod_l_edges():
    """Edge values of h mod L: around 0, L, 2L and 3L, a large multiple of
    L, 2^512 - 1, and just under and over the multiples of L nearest
    2^512."""
    from indy_plenum_tpu_torch.tpu import sha512 as s5

    L, top = s5.L, (1 << 512) - 1
    vals = [0, 1, L - 1, L, L + 1, 2 * L - 1, 2 * L, 3 * L - 1,
            (1 << 300) // L * L, top, 1 << 511, (1 << 256) - 1, 1 << 256,
            (1 << 192) - 1, 1 << 192, (1 << 256) * L - 1]
    for q in range(top // L - 3, top // L + 1):
        vals += [q * L - 1, q * L, q * L + 1]
    return [v for v in vals if v <= top]


def check_mod_l_ints(h_np, red_np, where):
    """Every row of K-b's output against Python's h % L."""
    from indy_plenum_tpu_torch.tpu import sha512 as s5

    for row, got in zip(h_np, red_np):
        if int.from_bytes(got.tobytes(), "little") != \
                int.from_bytes(row.tobytes(), "little") % s5.L:
            raise AssertionError(f"reduce_mod_l disagrees with Python ints "
                                 f"at {where}")


def check_mod_l(dev, rng, batch):
    """K-b on ``batch`` rows - the edge values, then seeded hashes - against
    its plain version (the reference's ladder) and Python's h % L on
    every row."""
    import torch
    from indy_plenum_tpu_torch.tpu import sha512 as s5

    edge = mod_l_edges()
    hs = np.concatenate([
        np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8)
                  for v in edge]),
        rng.randint(0, 256, (batch - len(edge), 64)).astype(np.uint8)])
    h = torch.from_numpy(hs).to(dev)
    red = s5.reduce_mod_l(h)
    err = _max_abs_err([(red, s5.reduce_mod_l_plain(h))])
    check_mod_l_ints(hs, red.cpu().numpy(), f"a batch of {batch}")
    if err:
        raise AssertionError(f"K-b differs from plain at {batch}: {err}")
    return err


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


def verify_edge_inputs():
    """The curve check's edge rows (a good signature, A with y >= p, A = (0,
    1) with the sign bit set, a y with no square root, S + L), then 61
    rows whose A fails to decompress in some groups of a warp and not in
    others, and in every group of one warp (rows 40-47): 66 rows, no
    multiple of a block's 16 signatures. Returns the (pk, R, S, h) arrays,
    the padded SHA-512 blocks and counts of R || A || M, and the expected
    verdicts."""
    from indy_plenum_tpu_torch.crypto import ed25519 as ed
    from indy_plenum_tpu_torch.tpu import sha512 as s5

    seed = bytes(range(1, 33))
    pk, msg = ed.public_key(seed), b"edge"
    sig = ed.sign(seed, msg)
    s_big = (int.from_bytes(sig[32:], "little") + ed.L).to_bytes(32,
                                                                "little")
    bad = ((ed.P + 1).to_bytes(32, "little"),
           (1 | (1 << 255)).to_bytes(32, "little"),
           (2).to_bytes(32, "little"))
    rows = [(pk, sig, True)] + [(b, sig, False) for b in bad] \
        + [(pk, sig[:32] + s_big, True)]
    for i in range(61):
        fail = i % 5 == 2 or 35 <= i < 43
        rows.append((bad[i % 3], sig, False) if fail else (pk, sig, True))
    pk_a = np.stack([np.frombuffer(p, np.uint8) for p, _, _ in rows])
    r_a = np.stack([np.frombuffer(g[:32], np.uint8) for _, g, _ in rows])
    s_a = np.stack([np.frombuffer(g[32:], np.uint8) for _, g, _ in rows])
    h_a = np.stack([np.frombuffer((int.from_bytes(hashlib.sha512(
        g[:32] + p + msg).digest(), "little") % ed.L).to_bytes(32, "little"),
        np.uint8) for p, g, _ in rows])
    blocks, counts = s5.pad_ed25519_messages(
        [g[:32] + p for p, g, _ in rows], [msg] * len(rows), 1)
    return ([np.ascontiguousarray(a) for a in (pk_a, r_a, s_a, h_a)],
            blocks, counts, np.array([ok for _, _, ok in rows]))


def check_verify_edges(dev):
    """K-c and the full chain on :func:`verify_edge_inputs`, against the
    plain version and the expected verdicts."""
    import torch
    from indy_plenum_tpu_torch.tpu import ed25519 as ted

    arrays, blocks, counts, expect = verify_edge_inputs()
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    got = ted.verify_kernel(*t)
    full = ted.verify_kernel_full(t[0], t[1], t[2],
                                  torch.from_numpy(blocks).to(dev),
                                  torch.from_numpy(counts).to(dev))
    err = _max_abs_err([(got, ted.verify_kernel_plain(*t)), (full, got)])
    if err or not np.array_equal(got.cpu().numpy(), expect):
        raise AssertionError(f"K-c on the edge rows: err {err}, verdicts "
                             f"{got.cpu().numpy().astype(int).tolist()}")
    return err


def check_verify(dev, signers, reqs, rng):
    """K-c against its plain version on the drain's 8,192 rows, on its
    first 1, 3 and 7 rows, on the drain four times (32,768) and on the edge
    rows; verdicts against the oracle on a sample."""
    import torch
    from indy_plenum_tpu_torch.crypto import ed25519 as ed
    from indy_plenum_tpu_torch.tpu import ed25519 as ted

    rows, arrays = verify_inputs(signers, reqs, rng, DRAIN)
    tensors = [torch.from_numpy(a).to(dev) for a in arrays]
    got = ted.verify_kernel(*tensors)
    ref = ted.verify_kernel_plain(*tensors)
    pairs = [(got, ref)]
    for n in (1, 3, 7):
        pairs.append((ted.verify_kernel(*[t[:n].contiguous()
                                          for t in tensors]), ref[:n]))
    big = BENCH_VERIFY_BATCH // DRAIN
    pairs.append((ted.verify_kernel(*[t.repeat(big, 1) for t in tensors]),
                  ref.repeat(big)))
    err = max(_max_abs_err(pairs), check_verify_edges(dev))
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
        words = _random_words(rng, m, w, n, s)
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


def check_quorum_shapes(dev, rng):
    """K7 against its plain version at every shape of ``K7_SHAPES``, from
    a random vote state: three compact steps of random words (some senders
    and slots out of range, ~10% invalid), then one step without the
    compact record. Every state leaf, event and compact output equal, the
    frontier snapshot a copy (never the live state's storage). Returns the
    largest error and the shapes checked."""
    from indy_plenum_tpu_torch.tpu import quorum as q

    err = 0
    for tag, m, n, s, c, w in K7_SHAPES:
        state = _random_votes(dev, rng, m, n, s, c)
        for step_i in range(4):
            words = q.words_tensor(_random_words(rng, m, w, n, s), dev)
            shadow = q.clone_state(state)
            compact = step_i < 3
            ev, comp = q._dispatch(state, words, n, q.ORDER_DELTA_CAP,
                                   compact)
            pev, pcomp = q.step_plain(shadow, words, n, compact=compact)
            if comp.frontier.untyped_storage().data_ptr() \
                    == state.frontier.untyped_storage().data_ptr():
                raise AssertionError(f"K7 {tag}: the frontier snapshot "
                                     "aliases the state")
            err = max(err, _max_abs_err(list(zip(state, shadow))
                                        + list(zip(ev, pev))
                                        + list(zip(comp, pcomp))))
    if err:
        raise AssertionError(f"K7 differs from plain: {err}")
    return err, [tag for tag, *_ in K7_SHAPES]


def _random_words(rng, m, w, n, s):
    """(M, W) vote words with out-of-range senders and slots and ~10%
    invalid padding."""
    kind = rng.randint(0, 4, (m, w))
    sender = rng.randint(0, n + 8, (m, w))
    slot = rng.randint(0, s + 20, (m, w))
    valid = rng.rand(m, w) < 0.9
    return ((valid.astype(np.uint64) << 31)
            | (kind.astype(np.uint64) << 29)
            | (sender.astype(np.uint64) << 16)
            | slot.astype(np.uint64)).astype(np.uint32)


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
    member sliding by a checkpoint interval), every member sliding, all
    deltas 0 (no launch, the state unchanged), the same edges as device
    deltas, and more sliding members than one launch's pairs (2 x 256 + 8
    members of N = 4, deltas 1 .. S + 1: three launches); zeros with an
    empty mask (no launch), one member (the pool's reset), every member,
    random members as a host and as a CUDA mask, and more members than
    one launch's rows (2 x 256 + 8 members of N = 4: three launches).
    Host deltas and masks make ceil(members / 256) launches, device ones
    one: 7 slide and 7 zero launches a call."""
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    slides = [np.zeros(m, np.int32) for _ in range(4)]
    slides[0][:8] = [0, 1, s - 1, s, s + 1, 3 * s, chk_freq, 7]
    slides[1][rng.randint(m)] = chk_freq
    slides[2][:] = rng.randint(1, s, m)
    wide = 2 * q.SLIDE_PAIRS_PER_LAUNCH + 8
    cases = [(m, n, d, False) for d in slides] \
        + [(m, n, slides[0], True),
           (wide, 4, (1 + np.arange(wide) % (s + 1)).astype(np.int32),
            False)]
    err_slide = err_zero = 0
    for mm, nn, deltas, on_card in cases:
        state = _random_votes(dev, rng, mm, nn, s, c)
        shadow = q.clone_state(state)
        before = kb.LAUNCHES["window_slide"]
        t = torch.from_numpy(deltas)
        q.slide_state(state, t.to(dev) if on_card else t)
        q.slide_plain(shadow, t)
        sliding = int((deltas > 0).sum())
        want = 1 if on_card else -(-sliding // q.SLIDE_PAIRS_PER_LAUNCH)
        if kb.LAUNCHES["window_slide"] - before != want:
            raise AssertionError(f"K8 slide of {sliding} members: "
                                 f"{kb.LAUNCHES['window_slide'] - before} "
                                 f"launches, not {want}")
        err_slide = max(err_slide, _max_abs_err(list(zip(state, shadow))))
    one = np.zeros(m, bool)
    one[rng.randint(m)] = True
    some = rng.rand(m) < 0.3
    some[0] = True
    wide = 2 * q.ZERO_ROWS_PER_LAUNCH + 8
    for mm, nn, mask, on_card in ((m, n, np.zeros(m, bool), False),
                                  (m, n, one, False),
                                  (m, n, np.ones(m, np.uint8), False),
                                  (m, n, some, False), (m, n, some, True),
                                  (wide, 4, np.ones(wide, bool), False)):
        state = _random_votes(dev, rng, mm, nn, s, c)
        shadow = q.clone_state(state)
        before = kb.LAUNCHES["window_zero"]
        t = torch.from_numpy(mask)
        q.zero_members(state, t.to(dev) if on_card else t)
        q.zero_plain(shadow, t)
        hits = int(np.count_nonzero(mask))
        want = 1 if on_card else -(-hits // q.ZERO_ROWS_PER_LAUNCH)
        if kb.LAUNCHES["window_zero"] - before != want:
            raise AssertionError(f"K8 zero of {hits} members: "
                                 f"{kb.LAUNCHES['window_zero'] - before} "
                                 f"launches, not {want}")
        err_zero = max(err_zero, _max_abs_err(list(zip(state, shadow))))
    if err_slide or err_zero:
        raise AssertionError(f"K8 differs from plain: slide {err_slide}, "
                             f"zero {err_zero}")
    return err_slide, err_zero


RESIDENT_SLOTS = (1, 2, 4, 7)  # K9's ring slots per consume, checked
RESIDENT_WIDTH = 128  # the group's slot width (flush_batch) at n <= 64
RESIDENT_BLOCKS = (1, 2, 4, 8)  # K9's cluster sizes, forced and checked


def resident_words(rng, k, m, w, n, s):
    """k slots of (M, W) words: full 3PC waves in the first slot (so
    quorums are reached), random votes after, and one all-empty slot."""
    words = np.stack([_random_words(rng, m, w, n, s) for _ in range(k)])
    per_slot = max(1, w // (2 * n))
    words[0] = _wave_words(m, w, n, s,
                           [int(x) for x in rng.randint(0, s, per_slot)],
                           rng)
    if k > 1:
        words[k // 2] = 0
    return words


def check_resident(dev, rng, m, n, s, c, chk_freq, w=RESIDENT_WIDTH):
    """K9 against its plain version on an (M, N, S, C) group with W-wide
    slots, k = 1, 2, 4 and 7: seeded vote states and words, slides mixing
    0, 1, the checkpoint interval, S - 1, S and 2S (host slides at even k,
    slides on the card at odd k), one all-empty slot and a member whose
    frontier is below its delta; every state leaf, event and compact
    output equal. Then the pool's slide pattern (k = 4, one
    member sliding by the checkpoint interval in the first slot) with the
    cluster forced to each of ``RESIDENT_BLOCKS`` up to N blocks, counted
    as K9's launches; then K9 with one zero-slide slot against K7 on the
    same state and words."""
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q

    mix = np.array([0, 1, chk_freq, s - 1, s, 2 * s], np.int32)
    err = 0
    for k in RESIDENT_SLOTS:
        state = _random_votes(dev, rng, m, n, s, c)
        state.frontier[m - 1] = 1  # below its delta
        shadow = q.clone_state(state)
        slides = mix[rng.randint(0, len(mix), (k, m))]
        slides[:, 0] = 0  # one member never slides
        slides[0, m - 1] = chk_freq
        words = q.words_tensor(resident_words(rng, k, m, w, n, s), dev)
        host = torch.from_numpy(slides)  # on the card at odd k
        ev, comp = q.resident_step(state, host.to(dev) if k % 2 else host,
                                   words, n)
        pev, pcomp = q.resident_step_plain(
            shadow, torch.from_numpy(slides).to(dev), words, n)
        err = max(err, _max_abs_err(list(zip(state, shadow))
                                    + list(zip(ev, pev))
                                    + list(zip(comp, pcomp))))
    for blocks in [b for b in RESIDENT_BLOCKS if b <= n]:
        state = _random_votes(dev, rng, m, n, s, c)
        shadow = q.clone_state(state)
        slides = torch.zeros((4, m), dtype=torch.int32)
        slides[0, rng.randint(m)] = chk_freq
        words = q.words_tensor(resident_words(rng, 4, m, w, n, s), dev)
        ev, comp = q._resident_tile_kernel(state, slides, words, n, 1,
                                           q.ORDER_DELTA_CAP, blocks,
                                           "resident_step")
        pev, pcomp = q.resident_step_plain(shadow, slides.to(dev), words, n)
        err = max(err, _max_abs_err(list(zip(state, shadow))
                                    + list(zip(ev, pev))
                                    + list(zip(comp, pcomp))))
    state = _random_votes(dev, rng, m, n, s, c)
    shadow = q.clone_state(state)
    words = q.words_tensor(resident_words(rng, 1, m, w, n, s)[0], dev)
    ev, comp = q.resident_step(state, torch.zeros((1, m), dtype=torch.int32),
                               words[None], n)
    kev, kcomp = q.step_compact(shadow, words, n)
    cross = _max_abs_err(list(zip(state, shadow)) + list(zip(ev, kev))
                         + list(zip(comp, kcomp)))
    if err or cross:
        raise AssertionError(f"K9 differs from plain ({err}) or from K7 "
                             f"({cross})")
    return err


def fused_inputs(rng, n, s, batch):
    """K14's operands at (N, S, B): vote b is the PRE-PREPARE, a PREPARE or
    a COMMIT of slot b // 2N in ``_wave_words``' layout, signed by its
    sender's seeded Ed25519 key over the vote's packed word (4 bytes,
    little-endian); every 16th vote is planted bad (a flipped signature
    bit, a wrong key or a flipped message bit, in turn). Returns the
    signed rows, the words, the (pk, R, S, h) arrays and the expected
    verdicts."""
    from indy_plenum_tpu_torch.crypto import ed25519 as ed
    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.tpu import quorum as q

    seeds = [rng.bytes(32) for _ in range(n)]
    keys = [ed.public_key(sd) for sd in seeds]
    rows, words, expect = [], [], []
    for b in range(batch):
        slot, pos = (b // (2 * n)) % s, b % (2 * n)
        kind, sender = ((q.PREPREPARE, 0) if pos == 0 else
                        (q.PREPARE, pos) if pos < n else (q.COMMIT, pos - n))
        word = q.pack_vote(kind, sender, slot)
        msg = word.to_bytes(4, "little")
        sig = ed.sign(seeds[sender], msg)
        pk = keys[sender]
        fault = (b // 16) % 3 if b % 16 == 7 else None
        if fault == 0:
            sig = _flip(sig, rng.randint(0, 256))
        elif fault == 1:
            pk = keys[(sender + 1) % n]
        elif fault == 2:
            msg = _flip(msg, rng.randint(0, 32))
        rows.append((pk, msg, sig))
        words.append(word)
        expect.append(fault is None)
    pk_a, r_a, s_a, h_a, pre = ted.prepare_batch(*zip(*rows))
    if not pre.all():
        raise AssertionError("K14 inputs: a structural check failed")
    return (rows, np.array(words, np.uint32)[None, :],
            [pk_a, r_a, s_a, h_a], np.array(expect))


def check_fused(dev, rng, inputs):
    """K14 against its plain version, on the graft entry's shape (n = 8,
    S = 16, C = 2, B = 8: ``step.example_inputs``), twice back to back on
    one state and stream (the second call finds the ticket the first
    reset), and on ``inputs`` (``fused_inputs`` at N = 64, S = 300, B =
    8,192, C = 3): state, events and verdicts equal; each call ONE
    ``fused_step`` launch and no ``ed25519_verify``; the verdicts equal
    the construction's and the pure-Python oracle's (every planted vote
    and 512 good ones); and the result equals K7 alone on the good votes'
    words."""
    import torch
    from indy_plenum_tpu_torch.crypto import ed25519 as ed
    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import step as st
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    def one_launch(fn, *args, **kwargs):
        before = kb.launch_counts()
        out = fn(*args, **kwargs)
        got = kb.launch_counts()
        if got["fused_step"] != before["fused_step"] + 1 \
                or got["ed25519_verify"] != before["ed25519_verify"]:
            raise AssertionError("K14: a call is not one fused_step launch")
        return out

    err = 0
    small = st.example_inputs(device=dev)
    plain_state = q.clone_state(small[0])
    # the plain version's verdicts once: fused_step_plain is this verify,
    # then fabric_step_plain with them
    want_ok = ted.verify_kernel_plain(*small[2:])
    for _ in range(2):
        got = one_launch(st.fused_step, *small, n_validators=8, device=dev)
        want, _ = q.fabric_step_plain(plain_state, small[1], 8, 1,
                                      compact=False,
                                      ok=want_ok.view(small[1].shape))
        if not bool(got[2].all()):
            raise AssertionError("K14: the graft entry's votes were "
                                 "rejected")
        err = max(err, _max_abs_err(list(zip(got[0], plain_state))
                                    + list(zip(got[1], want))
                                    + [(got[2], want_ok)]))
    rows, words_np, arrays, expect = inputs
    n, s, c = N_VALIDATORS, LOG_SIZE, N_CHECKPOINTS
    words = q.words_tensor(words_np, dev)
    sig = [torch.from_numpy(a).to(dev) for a in arrays]
    state, events, ok = one_launch(st.fused_step,
                                   q.init_state(n, s, c, 1, dev), words,
                                   *sig, n_validators=n, device=dev)
    pstate, pevents, pok = st.fused_step_plain(
        q.init_state(n, s, c, 1, dev), words, *sig, n_validators=n)
    err = max(err, _max_abs_err(list(zip(state, pstate))
                                + list(zip(events, pevents))
                                + [(ok, pok)]))
    ok_np = ok.cpu().numpy()
    if not np.array_equal(ok_np, expect):
        raise AssertionError("K14 verdicts differ from the planted faults")
    good_idx = np.nonzero(expect)[0]
    sample = np.concatenate([np.nonzero(~expect)[0], rng.choice(
        good_idx, min(512, len(good_idx)), replace=False)])
    for i in sample:
        if ed.verify(*rows[i]) != bool(ok_np[i]):
            raise AssertionError(f"K14 verdict {i} != oracle")
    good = q.words_tensor(np.where(expect[None, :], words_np, 0), dev)
    kstate = q.init_state(n, s, c, 1, dev)
    kevents = q.step(kstate, good, n)
    alone = _max_abs_err(list(zip(state, kstate))
                         + list(zip(events, kevents)))
    if err or alone:
        raise AssertionError(f"K14 differs from plain ({err}) or from K7 "
                             f"on the good votes ({alone})")
    if int(events.ordered.sum()) == 0:
        raise AssertionError("K14: no slot ordered")
    return err, int(ok_np.sum()), len(sample)


# --- slice 5: the fabric (K13, tiled K9), the ring (K1), the rotation (K15)

FABRIC_N = 256  # bench.py:524-570's fabric cell: n = 256, one instance
FABRIC_W = 512  # that group's flush_batch: 2N votes in a pow2 chunk
FABRIC_SHAPES = ((8,), (4, 2))  # the cell's member mesh and its fabric


def fabric_mesh(dev, shape):
    """The one-device fabric: every tile of ``shape`` on ``dev``."""
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.utils.torch_env import mesh_devices

    return q.make_fabric_mesh([dev] * mesh_devices(shape), shape)


def fabric_state(dev, rng, n_rows, n_real, c, m=FABRIC_N, s=LOG_SIZE):
    """Random planes on (m, n_rows, s, c), pad validator rows empty."""
    state = _random_votes(dev, rng, m, n_rows, s, c)
    for leaf in (state.prepare_votes, state.commit_votes,
                 state.checkpoint_votes):
        leaf[:, n_real:] = 0
    return state


def fabric_words(rng, m, w, n, s, c):
    """(M, W) words: a full 3PC wave of one slot (quorums fire), random
    votes with out-of-range senders and slots, and checkpoint votes."""
    words = _random_words(rng, m, w, n, s)
    wave = min(2 * n, w - 32)  # at W = 2N the wave drops 32 COMMITs
    words[:, :wave] = _wave_words(m, wave, n, s,
                                  [int(rng.randint(0, s))], rng)
    chk = rng.randint(0, n, (m, 32))
    words[:, -32:] = (0x80000000 | (3 << 29) | (chk << 16)
                      | rng.randint(0, c + 1, (m, 32)))
    return words


K13_BLOCKS = (1, 2, 4, 8)  # the cluster sizes K13 is held and timed at


def check_fabric(dev, rng):
    """K13 against its plain version at full width: M = N = 256, S = 300,
    C = 4 on (8,) and (4, 2), and N = 250 (padded to 252) on v = 4 with
    the path's C = 3; at the wrapper's cluster size plainly, with ~10% of
    the words dropped by a verdict and once without the compact record,
    then at each of ``K13_BLOCKS`` once plainly and once with dropped
    words and without the compact record; then K13 at v = 1 on an
    unpadded state against K7. A dropped word reaches the kernel with its
    valid bit cleared and the plain version as the word with its verdict
    ``ok`` False (``fabric_step_plain``'s mask): the two must agree.
    Every state leaf, event and compact output equal."""
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q

    m, s = FABRIC_N, LOG_SIZE
    err = checks = 0
    for shape, n, c in (((8,), FABRIC_N, 4), ((4, 2), FABRIC_N, 4),
                        ((2, 4), 250, N_CHECKPOINTS)):
        v = shape[1] if len(shape) > 1 else 1
        rows = -(-n // v) * v
        state = fabric_state(dev, rng, rows, n, c)
        cases = [(None, True, None), (0.9, True, None), (None, False, None)]
        cases += [(ok_p, compact, b) for b in K13_BLOCKS
                  for ok_p, compact in ((None, True), (0.9, False))]
        for ok_p, compact, blocks in cases:
            words = q.words_tensor(fabric_words(rng, m, FABRIC_W, n, s, c),
                                   dev)
            ok = None if ok_p is None else torch.from_numpy(
                rng.rand(m, FABRIC_W) < ok_p).to(dev)
            kwords = words if ok is None else torch.where(
                ok, words, words & 0x7FFFFFFF)
            shadow = q.clone_state(state)
            if blocks is None:
                ev, comp = q.fabric_step(state, kwords, n, v,
                                         compact=compact)
            else:
                ev, comp = q._fabric_kernel(state, kwords, n, v,
                                            q.ORDER_DELTA_CAP, compact,
                                            blocks)
            pev, pcomp = q.fabric_step_plain(shadow, words, n, v,
                                             compact=compact, ok=ok)
            outs = list(zip(state, shadow)) + list(zip(ev, pev))
            if compact:
                outs += list(zip(comp, pcomp))
            err = max(err, _max_abs_err(outs))
            checks += 1
        if int(ev.ordered.sum()) == 0:
            raise AssertionError(f"K13 on {shape}: no slot ordered")
    state = fabric_state(dev, rng, FABRIC_N, FABRIC_N, N_CHECKPOINTS)
    shadow = q.clone_state(state)
    words = q.words_tensor(fabric_words(rng, m, FABRIC_W, FABRIC_N, s,
                                        N_CHECKPOINTS), dev)
    ev, comp = q.fabric_step(state, words, FABRIC_N, 1)
    kev, kcomp = q.step_compact(shadow, words, FABRIC_N)
    cross = _max_abs_err(list(zip(state, shadow)) + list(zip(ev, kev))
                         + list(zip(comp, kcomp)))
    if err or cross:
        raise AssertionError(f"K13 differs from plain ({err}) or from K7 "
                             f"({cross})")
    return err, checks


R_NODES, R_SEED, R_FORCE_TICK = 64, 23, 12  # test_residency.py:155-171
R_LOG_SIZE, R_CHK_FREQ = 15, 5
# the tiled K9's shapes: (tag, M, real validators, rows, S, C, W, v, k);
# full width (phase H), phase R's (8,) and (4, 2) arms, phase B's S = 30
# with N padded to a multiple of v = 4, and a tile of one row a block
TILE_SHAPES = (
    ("h_v1", FABRIC_N, FABRIC_N, FABRIC_N, LOG_SIZE, N_CHECKPOINTS,
     FABRIC_W, 1, 4),
    ("h_v2", FABRIC_N, FABRIC_N, FABRIC_N, LOG_SIZE, N_CHECKPOINTS,
     FABRIC_W, 2, 4),
    ("r_v1", R_NODES, R_NODES, R_NODES, R_LOG_SIZE,
     R_LOG_SIZE // R_CHK_FREQ, RESIDENT_WIDTH, 1, 4),
    ("r_v2", R_NODES, R_NODES, R_NODES, R_LOG_SIZE,
     R_LOG_SIZE // R_CHK_FREQ, RESIDENT_WIDTH, 2, 4),
    ("pad_v4", 96, 250, 252, B_LOG_SIZE, B_LOG_SIZE // B_CHK_FREQ, 512, 4,
     4),
    ("small_v4", 16, 7, 8, 22, 4, 64, 4, 2),
)


def tile_case(dev, rng, m, n, rows, s, c, w, v, k):
    """A tiled K9 consume's operands: a seeded state (pad rows empty),
    (k, M) slides mixing 0, 1, 2, 3, 5, S - 1, S and S + 3 (member 0
    never slides, the last member by 0 < d < S in every slot), k slots of
    words with a quorum wave in the first; member 1 hit only in its pad
    rows (when there are any), the last member's words all invalid and,
    for k > 1, one slot of nothing but invalid words."""
    import torch

    state = fabric_state(dev, rng, rows, n, c, m=m, s=s)
    mix = np.array([0, 1, 2, 3, 5, s - 1, s, s + 3], np.int32)
    slides = mix[rng.randint(0, len(mix), (k, m))]
    slides[:, 0] = 0
    slides[:, -1] = 1 + (s - 2) // 2
    words = np.stack([fabric_words(rng, m, w, n, s, c) for _ in range(k)])
    if rows > n:
        kinds = rng.randint(1, 4, (k, w)).astype(np.uint32)
        pads = rng.randint(n, rows, (k, w)).astype(np.uint32)
        words[:, 1] = (0x80000000 | (kinds << 29) | (pads << 16)
                       | rng.randint(0, c, (k, w)).astype(np.uint32))
    words[:, -1] &= 0x7FFFFFFF
    if k > 1:
        words[k - 1] &= 0x7FFFFFFF
    return state, torch.from_numpy(slides), words


def check_resident_tile(dev, rng):
    """The tiled K9 against its plain version on ``TILE_SHAPES`` (v = 1, 2
    and 4, N padded, S % 4 != 0, slides of d = 0, 0 < d < S and d >= S, a
    member hit only in pad rows, all-invalid word rows) at k = 1, 2 and
    4, with the cluster the wrapper picks and with every cluster size
    of 1 to 8 blocks at the largest k; then phase H's consume (no
    slide).
    Every state leaf, event and compact output equal."""
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q

    err = checks = 0
    for tag, m, n, rows, s, c, w, v, k_top in TILE_SHAPES:
        for k in sorted({1, 2, k_top}):
            sizes = [None] + ([b for b in range(1, q.TILE_CLUSTER_MAX + 1)
                               if b <= rows] if k == k_top else [])
            for blocks in sizes:
                state, slides, words_np = tile_case(dev, rng, m, n, rows, s,
                                                    c, w, v, k)
                words = q.words_tensor(words_np, dev)
                shadow = q.clone_state(state)
                if blocks is None:
                    ev, comp = q.resident_tile_step(state, slides, words, n,
                                                    v)
                else:
                    ev, comp = q._resident_tile_kernel(
                        state, slides, words, n, v, q.ORDER_DELTA_CAP,
                        blocks)
                pev, pcomp = q.resident_tile_plain(
                    shadow, slides.to(dev), words, n, v)
                e = _max_abs_err(list(zip(state, shadow))
                                 + list(zip(ev, pev))
                                 + list(zip(comp, pcomp)))
                if e:
                    raise AssertionError(
                        f"tiled K9 differs from plain at {tag}, k={k}, "
                        f"blocks={blocks}: {e}")
                err, checks = max(err, e), checks + 1
    m, n, s, c = FABRIC_N, FABRIC_N, LOG_SIZE, N_CHECKPOINTS
    state = fabric_state(dev, rng, n, n, c)
    shadow = q.clone_state(state)
    words = q.words_tensor(np.stack([fabric_words(rng, m, FABRIC_W, n, s, c)
                                     for _ in range(4)]), dev)
    slides = torch.zeros((4, m), dtype=torch.int32)
    ev, comp = q.resident_tile_step(state, slides, words, n, 2)
    pev, pcomp = q.resident_tile_plain(shadow, slides, words, n, 2)
    err = max(err, _max_abs_err(list(zip(state, shadow)) + list(zip(ev, pev))
                                + list(zip(comp, pcomp))))
    if err or int(ev.ordered.sum()) == 0:
        raise AssertionError(f"tiled K9 differs from plain ({err}) or "
                             "ordered nothing at phase H's consume")
    return err, checks


# phase R's group state: M, N, S, C
R_STATE = (R_NODES, R_NODES, R_LOG_SIZE, R_LOG_SIZE // R_CHK_FREQ)


def odd_leaves(dev, rng, rows=37):
    """A small member-stacked state of odd-sized leaves: uint8 rows of 7
    bytes, float32 rows of 3, int32 scalars and uint8 rows of 48 bytes -
    K1's byte, 4-byte and 16-byte granules."""
    import torch

    return (torch.from_numpy(rng.randint(0, 256, (rows, 7)).astype(
        np.uint8)).to(dev),
        torch.from_numpy(rng.rand(rows, 3).astype(np.float32)).to(dev),
        torch.from_numpy(rng.randint(0, 99, rows).astype(np.int32)).to(dev),
        torch.from_numpy(rng.randint(0, 256, (rows, 4, 12)).astype(
            np.uint8)).to(dev))


def check_ring_rotate(dev, rng):
    """K1, the one-card rotation and K15, each against its plain version,
    bit-equal. K1 (``ring_shift_planes``) on every leaf of phase H's state
    (M = N = 256, S = 300, C = 3) for shifts 1 .. m + 1 on (8,) and (4,
    2), and of phase R's (M = N = 64, S = 15, C = 3) on the same meshes;
    K1 as a roll of any rows (``ring_shift_rows``) on odd-sized leaves at
    37 rows. The rotation (``rotate_planes``: one K1 roll) against
    ``rotate_planes_plain`` (the reference's arms and merge) and K15
    (``rotate_merge``, called on the real arms of the same rotation)
    against ``rotate_merge_plain``, for rows 1, R - 1, R, R + 1, M - 1
    and 3 random values on (8,), (4, 2) and without a mesh, at both
    states. Returns the errors (K1, K15, rotation)."""
    import torch
    from indy_plenum_tpu_torch.tpu import rebalance as rb
    from indy_plenum_tpu_torch.tpu import ring_exchange as rx

    err_ring = err_merge = err_rot = 0
    states = (fabric_state(dev, rng, FABRIC_N, FABRIC_N, N_CHECKPOINTS),
              fabric_state(dev, rng, R_STATE[1], R_STATE[1], R_STATE[3],
                           m=R_STATE[0], s=R_STATE[2]))
    for state in states:
        m_rows = state.frontier.shape[0]
        for shape in (None,) + FABRIC_SHAPES:
            mesh = None if shape is None else fabric_mesh(dev, shape)
            r = m_rows if shape is None else m_rows // shape[0]
            if shape is not None:
                for shift in range(1, shape[0] + 2):
                    got = rx.ring_shift_planes(state, mesh, shift)
                    want = rx.ring_shift_plain(state, mesh, shift)
                    err_ring = max(err_ring, _max_abs_err(zip(got, want)))
            rows = [1, r - 1, r, r + 1, m_rows - 1] + [
                int(x) for x in rng.randint(0, m_rows, 3)]
            for rot in rows:
                got = rb.rotate_planes(state, mesh, rot, r)
                want = rb.rotate_planes_plain(state, mesh, rot, r)
                err_rot = max(err_rot, _max_abs_err(zip(got, want)))
                b0, sub = divmod(rot % m_rows, r)
                if sub == 0:
                    continue
                if shape is None:
                    arm_a = arm_b = state
                else:
                    arm_a = rx.ring_shift_plain(state, mesh, b0)
                    arm_b = rx.ring_shift_plain(state, mesh, b0 + 1)
                got = rb.rotate_merge(arm_a, arm_b, sub, r)
                want = rb.rotate_merge_plain(arm_a, arm_b, sub, r)
                err_merge = max(err_merge, _max_abs_err(zip(got, want)))
    odd = odd_leaves(dev, rng)
    for rot in (1, 2, 18, 36, 37 + 5):
        got = rx.ring_shift_rows(odd, rot)
        want = [torch.roll(x, rot, dims=0) for x in odd]
        err_ring = max(err_ring, max(
            int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
            for a, b in zip(got, want)))
    if err_ring or err_merge or err_rot:
        raise AssertionError(f"K1 ({err_ring}), K15 ({err_merge}) or the "
                             f"rotation ({err_rot}) differs from plain")
    return err_ring, err_merge, err_rot


def check_sharded_fused(dev, inputs, n=N_VALIDATORS, s=LOG_SIZE,
                        c=N_CHECKPOINTS):
    """The sharded K14 on a 4-tile validator fabric against its plain
    version on ``inputs`` (``fused_inputs``; phase G's 8,192 signed votes
    at N = 64, S = 300, C = 3), one ``sharded_fused_step`` launch and no
    ``ed25519_verify``, and against the unsharded K14 on the same
    votes."""
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import step as st
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    _, words_np, arrays, expect = inputs
    words = q.words_tensor(words_np, dev)
    sig = [torch.from_numpy(a).to(dev) for a in arrays]
    mesh = q.make_fabric_mesh([dev] * 4, (4,), ("validators",))
    fn = st.make_sharded_fused_step(mesh, n)
    before = kb.launch_counts()
    state, events, ok = fn(q.init_state(n, s, c, 1, dev), words, *sig)
    got = kb.launch_counts()
    if got["sharded_fused_step"] != before["sharded_fused_step"] + 1 \
            or got["ed25519_verify"] != before["ed25519_verify"]:
        raise AssertionError("sharded K14: a call is not one launch")
    pstate, pevents, pok = st.fused_step_plain(
        q.init_state(n, s, c, 1, dev), words, *sig, n_validators=n,
        v_shards=4)
    ustate, uevents, uok = st.fused_step(q.init_state(n, s, c, 1, dev),
                                         words, *sig, n_validators=n,
                                         device=dev)
    err = _max_abs_err(list(zip(state, pstate)) + list(zip(events, pevents))
                       + [(ok, pok)])
    cross = _max_abs_err(list(zip(state, ustate))
                         + list(zip(events, uevents)) + [(ok, uok)])
    if err or cross or not np.array_equal(ok.cpu().numpy(), expect):
        raise AssertionError(f"sharded K14 differs from plain ({err}) or "
                             f"from K14 ({cross})")
    return err


# K10-K12: SHA-256, the node hash and the audit-path fold
SHA_LENGTHS = (0, 1, 55, 56, 63, 64, 65, 119, 120, 128, 200)
NODE_WAVES = (1, 31, 32, 33, 4096, 65536)
AUDIT_TREE = 131072  # bench.py bench_catchup_proofs: 2^17 seeded leaves
AUDIT_FIRST, AUDIT_PROOFS = 57344, 16384  # 16k consecutive proofs


def check_sha256(dev, rng):
    """K12 and K11 against their plain versions on the card and against
    hashlib: K12 at every padding edge (1,024 seeded messages a length)
    and on 57-byte rows from a base one byte past a 16-byte boundary, K11
    at wave widths around the offload floor (32) and at the large
    waves."""
    import torch
    from indy_plenum_tpu_torch.tpu import sha256 as s2

    err12 = 0
    for length in SHA_LENGTHS:
        msgs = rng.randint(0, 256, (1024, length)).astype(np.uint8)
        t = torch.from_numpy(msgs).to(dev)
        got = s2.sha256_fixed(t, length)
        err12 = max(err12, _max_abs_err([(got, s2.sha256_fixed_plain(t))]))
        got_np = got.cpu().numpy()
        for row, dig in zip(msgs, got_np):
            if dig.tobytes() != hashlib.sha256(row.tobytes()).digest():
                raise AssertionError(f"sha256_fixed disagrees with hashlib "
                                     f"at length {length}")
    raw = torch.from_numpy(rng.randint(0, 256, 1024 * 57 + 16).astype(
        np.uint8)).to(dev)
    odd = raw[1:1 + 1024 * 57].view(1024, 57)
    got = s2.sha256_fixed(odd)
    err12 = max(err12, _max_abs_err([(got, s2.sha256_fixed_plain(odd))]))
    for row, dig in zip(odd.cpu().numpy(), got.cpu().numpy()):
        if dig.tobytes() != hashlib.sha256(row.tobytes()).digest():
            raise AssertionError("sha256_fixed disagrees with hashlib on "
                                 "unaligned rows")
    err11 = 0
    for n in NODE_WAVES:
        left = rng.randint(0, 256, (n, 32)).astype(np.uint8)
        right = rng.randint(0, 256, (n, 32)).astype(np.uint8)
        lt, rt = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
        got = s2.merkle_node_hash(lt, rt)
        err11 = max(err11, _max_abs_err(
            [(got, s2.merkle_node_hash_plain(lt, rt))]))
        got_np = got.cpu().numpy()
        for a, b, dig in zip(left, right, got_np):
            if dig.tobytes() != hashlib.sha256(
                    b"\x01" + a.tobytes() + b.tobytes()).digest():
                raise AssertionError(f"merkle_node_hash disagrees with "
                                     f"hashlib at {n} pairs")
        # the host seam the SMT waves call
        seam = s2.merkle_node_hash_bytes(left, right, dev)
        if not np.array_equal(seam, got_np):
            raise AssertionError("merkle_node_hash_bytes differs")
    # K11's commit plans: a real 320-key commit of phase C's shape, a plan
    # whose levels loop over a full cluster and a one-level wave (the
    # narrow waves above take the one-block path)
    for i, (refs, lits, offs) in enumerate((
            commit_plan(dev)[:3], wide_plan(rng),
            (s2._wave_refs(320), rng.randint(0, 256, (640, 32)).astype(
                np.uint8), [0, 320]))):
        rt = torch.from_numpy(np.array(refs)).to(dev)
        lt = torch.from_numpy(np.array(lits)).to(dev)
        got = s2.merkle_plan_hash(rt, lt, offs)
        plain = []
        ms = _cuda_ms(lambda: plain.append(
            s2.merkle_plan_hash_plain(rt, lt, offs)), 1, 0)
        if i == 0:
            # the plain version takes ~30 s on the commit plan: the
            # report's K11 row reads this call's time
            _PLANS["commit_plain_ms"] = ms
        err11 = max(err11, _max_abs_err([(got, plain[0])]))
        seam = s2.merkle_plan_hash_bytes(refs, lits, offs, dev)
        if not np.array_equal(seam, got.cpu().numpy()):
            raise AssertionError("merkle_plan_hash_bytes differs")
    if err12 or err11:
        raise AssertionError(f"K12/K11 differ from plain: {err12} {err11}")
    return err12, err11


PLAN_TREE_KEYS = 3200  # phase C's domain state after its timed batches
K11_BLOCKS = (1, 2, 4, 8)  # one block, or clusters of 2, 4, 8
K11_SWEEP_WIDTHS = (32, 64, 128, 320, 1024)
_PLANS = {}


def commit_plan(dev, n_keys=PLAN_TREE_KEYS, batch=POOL_BATCH):
    """A real K11 commit plan: ``batch`` new keys (one 3PC batch of phase
    C) into a sparse-Merkle state of ``n_keys`` keys, as the state's
    device waves encode it. The commit runs on the card and must give the
    root host waves give. Returns (refs, literals, offsets, levels,
    widest); made once per process."""
    from indy_plenum_tpu_torch.state import sparse_merkle_state as smt
    from indy_plenum_tpu_torch.storage.kv_store import \
        KeyValueStorageInMemory

    if "commit" in _PLANS:
        return _PLANS["commit"]
    kv = KeyValueStorageInMemory()
    base = smt.SparseMerkleState(kv=kv, commit_mode="host", device="cpu")
    base.apply_batch([(b"key%08d" % i, b"v%d" % i) for i in range(n_keys)])
    base.commit()
    writes = [(b"new%08d" % i, b"w%d" % i) for i in range(batch)]
    captured = []
    encode = smt._plan_encode

    def capture(waves, run):
        plan = encode(waves, run)
        captured.append(plan)
        return plan

    roots = []
    smt._plan_encode = capture
    try:
        for mode in ("device", "host"):
            state = smt.SparseMerkleState(
                kv=kv, initial_root=base.committed_head_hash,
                commit_mode=mode, device=dev if mode == "device" else "cpu")
            roots.append(state.apply_batch(writes))
    finally:
        smt._plan_encode = encode
    if roots[0] != roots[1] or len(captured) != 1:
        raise AssertionError("K11 commit plan: device and host roots "
                             "differ")
    refs, lits, offs = captured[0]
    _PLANS["commit"] = (refs, lits, offs, len(offs) - 1,
                        int(np.diff(offs).max()))
    return _PLANS["commit"]


def wide_plan(rng, widths=(3000, 1500, 700, 40, 1), n_lits=4096):
    """A seeded plan wider than a full cluster's threads (8 x 256): each
    operand an earlier node (60%) or one of ``n_lits`` random literals."""
    refs, offs = [], [0]
    for w in widths:
        node = rng.rand(w, 2) < 0.6 if offs[-1] else np.zeros((w, 2), bool)
        earlier = rng.randint(0, max(offs[-1], 1), (w, 2))
        lit = -1 - rng.randint(0, n_lits, (w, 2))
        refs.append(np.where(node, earlier, lit))
        offs.append(offs[-1] + w)
    return (np.concatenate(refs).astype(np.int32),
            rng.randint(0, 256, (n_lits, 32)).astype(np.uint8), offs)


def chain_plan(levels, width=1):
    """``levels`` levels of ``width`` nodes, node j of each level hashing
    node j of the level below with a literal (the SMT's one-key paths):
    at width 1, one thread's dependent chain through the plan kernel."""
    refs = [[-1, -2]] * width
    for lv in range(1, levels):
        refs += [[(lv - 1) * width + j, -2] for j in range(width)]
    return (np.array(refs, np.int32),
            np.arange(64, dtype=np.uint8).reshape(2, 32),
            [lv * width for lv in range(levels + 1)])


def audit_corpus(n_leaves: int = AUDIT_TREE, first: int = AUDIT_FIRST,
                 count: int = AUDIT_PROOFS, seed: int = 5):
    """bench.py's catchup-proof shape by default: a 131,072-leaf
    CompactMerkleTree of seeded 64-byte leaves and 16,384 consecutive
    proofs from 57,344."""
    from indy_plenum_tpu_torch.ledger.compact_merkle_tree import \
        CompactMerkleTree

    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, (n_leaves, 64)).astype(np.uint8)
    leaves = [row.tobytes() for row in raw]
    tree = CompactMerkleTree()
    tree.extend(leaves)
    idx = list(range(first, first + count))
    return (tree, [leaves[i] for i in idx], idx,
            [tree.audit_path(i) for i in idx])


def _fold_inputs(dev, leaf_data, indices, paths, tree_sizes, roots):
    """Dense and indexed K10 operands, per-row tree sizes and roots."""
    import torch
    from indy_plenum_tpu_torch.server.catchup import catchup_rep_service \
        as crs

    n = len(leaf_data)
    packed = crs.pack_audit_batch(leaf_data, indices, paths, tree_sizes[0],
                                  roots[0])
    leaf, idx, table, path_idx, plen, _, _ = packed
    depth = path_idx.shape[1]
    dense = np.zeros((n, depth, 32), np.uint8)
    for i, p in enumerate(paths):
        if p:
            dense[i, :len(p)] = np.frombuffer(b"".join(p),
                                              np.uint8).reshape(-1, 32)
    ts = np.asarray(tree_sizes, np.int32)
    root = np.stack([np.frombuffer(r, np.uint8) for r in roots])
    to = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (leaf, idx, dense, table, path_idx, plen, ts, root)]
    return dict(zip(("leaf", "index", "path", "table", "path_idx",
                     "path_len", "tree_size", "root"), to))


def check_audit(dev, corpus, rng):
    """K10, dense and indexed, at the catchup-proof shape with planted
    faults (a flipped leaf byte, a wrong index, a path one node short, one
    node long, a wrong root), against the plain versions and the host
    MerkleVerifier; then a chunk holding a path deeper than 48 levels
    through ``verify_audit_paths_batch``: the whole chunk verifies
    False, as the reference's packing makes it."""
    from indy_plenum_tpu_torch.ledger.merkle_verifier import STH, \
        MerkleVerifier
    from indy_plenum_tpu_torch.server.catchup import catchup_rep_service \
        as crs
    from indy_plenum_tpu_torch.tpu import sha256 as s2

    tree, leaf_data, indices, paths = corpus
    n = len(leaf_data)
    leaf_data, indices, paths = list(leaf_data), list(indices), list(paths)
    sizes = [tree.tree_size] * n
    roots = [tree.root_hash] * n
    planted = {}
    for i in rng.choice(n, 600, replace=False):
        kind = len(planted) % 5
        if kind == 0:
            leaf_data[i] = _flip(leaf_data[i], int(rng.randint(512)))
        elif kind == 1:
            indices[i] = indices[i] + 1
        elif kind == 2:
            paths[i] = paths[i][:-1]
        elif kind == 3:
            paths[i] = paths[i] + [rng.bytes(32)]
        else:
            roots[i] = _flip(roots[i], int(rng.randint(256)))
        planted[int(i)] = kind
    verifier = MerkleVerifier()
    expect = np.array([verifier.verify_leaf_inclusion(
        d, i, p, STH(tree_size=s, sha256_root_hash=r))
        for d, i, p, s, r in zip(leaf_data, indices, paths, sizes, roots)])
    if expect[list(planted)].any() or not np.delete(
            expect, list(planted)).all():
        raise AssertionError("planted faults: host verifier verdicts wrong")
    t = _fold_inputs(dev, leaf_data, indices, paths, sizes, roots)
    dense = s2.verify_audit_paths(t["leaf"], t["index"], t["path"],
                                  t["path_len"], t["tree_size"], t["root"])
    dense_plain = s2.verify_audit_paths_plain(
        t["leaf"], t["index"], t["path"], t["path_len"], t["tree_size"],
        t["root"])
    indexed = s2.verify_audit_paths_indexed(
        t["leaf"], t["index"], t["table"], t["path_idx"], t["path_len"],
        t["tree_size"], t["root"])
    indexed_plain = s2.verify_audit_paths_indexed_plain(
        t["leaf"], t["index"], t["table"], t["path_idx"], t["path_len"],
        t["tree_size"], t["root"])
    for name, got in (("dense", dense), ("dense plain", dense_plain),
                      ("indexed", indexed),
                      ("indexed plain", indexed_plain)):
        if not np.array_equal(got.cpu().numpy(), expect):
            raise AssertionError(f"K10 {name} verdicts differ from the "
                                 f"host verifier")
    # a chunk holding a path deeper than 48 levels: None from the packer,
    # every verdict of the chunk False
    deep = list(corpus[3][:crs._ChunkedDeviceVerify.CHUNK])
    deep[7] = deep[7] + [b"\x00" * 32] * 40
    bad = crs.verify_audit_paths_batch(
        list(corpus[1][:len(deep)]), list(corpus[2][:len(deep)]), deep,
        tree.tree_size, tree.root_hash, mode="device", device=dev)
    if bad.any() or len(bad) != len(deep):
        raise AssertionError("a chunk with a 49+-level path verified")
    return 0, len(planted)


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


def run_pool_a(device, depth=1):
    """``bench.py``'s n=64 ordered-txns cell (``_bench_ordered(64, 1,
    batches=10)``: seed 11, 3PC batches of 320, batch wait 0.05, adaptive
    tick from 0.1, pipelined flush) with signed requests: 320 warm-up
    requests, then 3,200 timed. Ordered txns/sec is the bench's: requests
    ordered at every node in the timed window over its wall time.
    ``depth`` is ``ResidentTickDepth`` (phase F1 runs 4, the reference's
    residency sub-bench, ``bench.py:394``)."""
    from indy_plenum_tpu_torch.common.metrics_collector import MetricsName
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    config = getConfig({
        "Max3PCBatchSize": POOL_BATCH, "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.1, "QuorumTickAdaptive": True,
        "TraceNetReceivers": 4, "ResidentTickDepth": depth})
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
        resident_ticks=pool.vote_group.resident_ticks,
        readbacks_deferred=pool.vote_group.readbacks_deferred,
        governor=pool.governor.trajectory_summary())


def run_pool_b(device, depth=1):
    """The RBFT instance axis, window slides and a view change: n=16 with
    six instances (96 member planes), signed, adaptive tick, 3PC batches
    of one request in a 30-slot window with checkpoints every 5, then the
    master primary disconnected until the pool changes view. ``depth`` is
    ``ResidentTickDepth`` (phase F2 runs 4)."""
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    config = getConfig({
        "Max3PCBatchSize": 1, "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.05, "QuorumTickAdaptive": True,
        "LOG_SIZE": B_LOG_SIZE, "CHK_FREQ": B_CHK_FREQ,
        "ResidentTickDepth": depth})
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
                        max_view=max(nd.data.view_no for nd in pool.nodes),
                        planes_track_watermarks=all(
                            nd.vote_plane.h == nd.data.low_watermark
                            for nd in pool.nodes),
                        flushes=group.flushes,
                        resident_ticks=group.resident_ticks,
                        readbacks_deferred=group.readbacks_deferred)


# --- phases H and R: the fabric at full width, the rebalance ----------------

H_BATCHES = 2  # bench.py bench_fabric: n, batches = 256, 2
H_ARMS = (("single", None, 1), ("mesh8", (8,), 1),
          ("fabric4x2", (4, 2), 1), ("fabric4x2_resident", (4, 2), 4))
R_SHAPES = ((4, 2), (8,))


def run_pool_h(device, shape, depth):
    """``bench.py``'s fabric cell (``bench.py:524-570``: ``_bench_ordered
    (256, 1, batches=2)``, whose config is ``bench.py:154-200``): 256
    validators, one instance, seed 11, unsigned, 3PC batches of 320,
    batch wait 0.05, adaptive tick from 0.1, pipelined flush; 320 warm-up
    requests, then 640 timed. ``shape`` None is the one-device arm (K7),
    else the one-device fabric of that mesh shape (K13); ``depth`` is
    ``ResidentTickDepth``."""
    from indy_plenum_tpu_torch.common.metrics_collector import MetricsName
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    config = getConfig({
        "Max3PCBatchSize": POOL_BATCH, "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.1, "QuorumTickAdaptive": True,
        "TraceNetReceivers": 4, "ResidentTickDepth": depth})
    mesh = None if shape is None else fabric_mesh(device or "cuda", shape)
    pool = SimPool(n_nodes=FABRIC_N, seed=11, config=config,
                   device_quorum=True, shadow_check=False,
                   pipelined_flush=True, mesh=mesh, trace=True,
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
                raise AssertionError(f"phase H stalled below {target}")
            pool.run_for(0.1)

    group = pool.vote_group
    submit(POOL_BATCH)
    run_until(POOL_BATCH)
    n_txns = H_BATCHES * POOL_BATCH
    submit(n_txns)
    flushes0 = group.flushes
    stat = pool.metrics.stat(MetricsName.DEVICE_FLUSH_TIME)
    flush0 = stat.total if stat is not None else 0.0
    t0 = time.perf_counter()
    run_until(POOL_BATCH + n_txns)
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not pool.honest_nodes_agree():
        raise AssertionError("phase H: honest nodes disagree")
    ordered = min(len(nd.ordered_digests) for nd in pool.nodes) - POOL_BATCH
    dispatches = group.flushes - flushes0
    return dict(
        ordered_hash=pool.ordered_hash(), ordered=ordered, wall_s=wall,
        ordered_txns_per_s=ordered / wall, dispatches=dispatches,
        dispatches_per_batch=dispatches / (ordered / POOL_BATCH),
        flush_s=pool.metrics.stat(MetricsName.DEVICE_FLUSH_TIME).total
        - flush0,
        readbacks=group.readbacks,
        readbacks_overlapped=group.readbacks_overlapped,
        readback_bytes_total=group.readback_bytes_total,
        readback_bytes_per_shard=group.readback_bytes_per_shard,
        shards=group.shards, mesh_shape=list(group.mesh_shape),
        strategy=group.compile_strategy,
        resident_ticks=group.resident_ticks,
        readbacks_deferred=group.readbacks_deferred)


def run_pool_r(device, shape, force_tick):
    """The reference's forced-rebalance arm (``tests/test_residency.py:
    135-171``) at n=64: batches of one, CHK_FREQ 5, LOG_SIZE 15,
    ResidentTickDepth 4, seed 23, on the one-device fabric of ``shape``;
    ``force_tick`` 12 forces a rotation, 0 never rotates."""
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    config = getConfig({
        "Max3PCBatchWait": 0.1, "Max3PCBatchSize": 1,
        "QuorumTickInterval": 0.05, "CHK_FREQ": R_CHK_FREQ,
        "LOG_SIZE": R_LOG_SIZE,
        "ResidentTickDepth": 4, "RebalanceForceTick": force_tick})
    pool = SimPool(R_NODES, seed=R_SEED, config=config, device_quorum=True,
                   shadow_check=False, mesh=fabric_mesh(device or "cuda",
                                                        shape),
                   trace=True, device=device)
    t0 = time.perf_counter()
    for i in range(6):
        pool.submit_request(i)
    pool.run_for(5)
    for i in range(6, 12):
        pool.submit_request(i)
    pool.run_for(25)
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not pool.honest_nodes_agree():
        raise AssertionError("phase R: honest nodes disagree")
    group = pool.vote_group
    return _pool_result(pool, wall, rebalances=group.rebalances,
                        row_shift=group.row_shift, flushes=group.flushes,
                        resident_ticks=group.resident_ticks)


# --- phases F and G: residency, the fused step -------------------------------


def run_fused_g(dev, inputs):
    """K14 at full width through ``tpu/step.py``'s ``fused_step``: the
    8,192 signed votes of ``fused_inputs`` into a fresh (1, 64, 300)
    member, on the card."""
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import step as st

    _, words_np, arrays, expect = inputs
    words = q.words_tensor(words_np, dev)
    sig = [torch.from_numpy(a).to(dev) for a in arrays]
    state, events, ok = st.fused_step(
        q.init_state(N_VALIDATORS, LOG_SIZE, N_CHECKPOINTS, 1, dev), words,
        *sig, n_validators=N_VALIDATORS, device=dev)
    if not np.array_equal(ok.cpu().numpy(), expect):
        raise AssertionError("phase G: verdicts differ")
    # the same votes through the sharded K14 on a 4-tile validator fabric
    sharded = st.make_sharded_fused_step(
        q.make_fabric_mesh([dev] * 4, (4,), ("validators",)), N_VALIDATORS)
    sstate, sevents, sok = sharded(
        q.init_state(N_VALIDATORS, LOG_SIZE, N_CHECKPOINTS, 1, dev), words,
        *sig)
    if _max_abs_err(list(zip(state, sstate)) + list(zip(events, sevents))
                    + [(ok, sok)]):
        raise AssertionError("phase G: the sharded step differs")
    return {"votes": int(words_np.shape[1]), "accepted": int(expect.sum()),
            "ordered_slots": int(events.ordered.sum()),
            "prepared_slots": int(events.prepared.sum())}


def time_fused_g(dev, inputs):
    """Device time of one K14 call at phase G's shape behind the spin, of
    K-c alone on its signatures and of K14 into a one-row, one-slot
    member (the same verify and scatter, a tail with nothing to count),
    in three rounds that alternate the three, each the median of its
    rounds: votes/sec, K-c's share, the tail (K14 less K-c alone) and
    K14 less the one-slot K14 (the last block's count and decide)."""
    import torch
    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import step as st

    _, words_np, arrays, _ = inputs
    words = q.words_tensor(words_np, dev)
    sig = [torch.from_numpy(a).to(dev) for a in arrays]
    state = q.init_state(N_VALIDATORS, LOG_SIZE, N_CHECKPOINTS, 1, dev)
    tiny = q.init_state(1, 1, 1, 1, dev)
    runs = {"fused": lambda: st.fused_step(
        state, words, *sig, n_validators=N_VALIDATORS, device=dev),
        "verify": lambda: ted.verify_kernel(*sig),
        "one_slot": lambda: st.fused_step(
            tiny, words, *sig, n_validators=N_VALIDATORS, device=dev)}
    rounds = {k: [] for k in runs}
    for _ in range(3):
        for k, fn in runs.items():
            rounds[k].append(_kernel_ms(fn, 5))
    fused_ms, verify_ms, tiny_ms = [float(np.median(rounds[k]))
                                    for k in runs]
    return {"fused_ms": fused_ms, "verify_ms": verify_ms,
            "one_slot_ms": tiny_ms, "tail_ms": fused_ms - verify_ms,
            "over_one_slot_ms": fused_ms - tiny_ms, "rounds_ms": rounds,
            "votes_per_s": words_np.shape[1] / (fused_ms / 1e3),
            "verify_share": verify_ms / fused_ms}


# --- phases C, D and E: real execution, proved reads, the state -------------

C_NODES, C_INSTANCES = 4, 2  # a deployed 4-node pool: f + 1 = 2 instances

# bench.py's state cell populates 100,000 keys; the smoke populates
# 20,000 (host Python, ~1.8 ms a key) to keep its clock under 1,000 s
# with the workload phases; the delta and the windows are the cell's
E_KEYS, E_DELTA, E_WINDOWS = 20_000, 256, 20
D_DRAIN, D_DRAINS = 4096, 4

# K7 at the shapes the main path gives it: (M, N, S, C, W) of phases A/F1
# and 4, B/F2, H's one-device arm, C's n = 4 x 2 members, and phase R's
# 15-slot window (K7's unaligned-row path, S % 4 != 0, as phase B's)
K7_SHAPES = (
    ("A", N_VALIDATORS, N_VALIDATORS, LOG_SIZE, N_CHECKPOINTS, 128),
    ("B", B_NODES * B_INSTANCES, B_NODES, B_LOG_SIZE,
     B_LOG_SIZE // B_CHK_FREQ, 128),
    ("H", FABRIC_N, FABRIC_N, LOG_SIZE, N_CHECKPOINTS, FABRIC_W),
    ("C", C_NODES * C_INSTANCES, C_NODES, LOG_SIZE, N_CHECKPOINTS, 16),
    ("R", R_NODES, R_NODES, R_LOG_SIZE, R_LOG_SIZE // R_CHK_FREQ, 128))


def run_pool_c(device, mode):
    """Real execution on the card: ``bench.py``'s n=64 cell config (3PC
    batches of 320, batch wait 0.05, adaptive tick from 0.1, pipelined
    flush, seed 11) at n = 4 with two RBFT instances, signed NYM writes
    executed into every node's ledgers and SMT states, the state's hash
    waves placed by ``StateCommitBatchMode`` = ``mode``. 320 warm-up
    requests, then 3,200 timed."""
    from indy_plenum_tpu_torch.common.constants import AUDIT_LEDGER_ID, \
        DOMAIN_LEDGER_ID
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool
    from indy_plenum_tpu_torch.state import sparse_merkle_state
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    config = getConfig({
        "Max3PCBatchSize": POOL_BATCH, "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.1, "QuorumTickAdaptive": True,
        "TraceNetReceivers": 4, "ResidentTickDepth": 1,
        "StateCommitBatchMode": mode})
    pool = SimPool(n_nodes=C_NODES, seed=11, config=config,
                   device_quorum=True, sign_requests=True,
                   real_execution=True, num_instances=C_INSTANCES,
                   shadow_check=False, pipelined_flush=True, trace=True,
                   device=device)
    exec_s, wave_s = [0.0], [0.0]

    def timed(fn, acc):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[0] += time.perf_counter() - t0
        return wrapper

    for nd in pool.nodes:
        # the executor seam the services call, and inside it the state's
        # hash resolution (host waves and device commit plans, as the
        # mode places them)
        nd.executor.apply_batch = timed(nd.executor.apply_batch, exec_s)
        nd.executor.commit_batch = timed(nd.executor.commit_batch, exec_s)
        st = nd.boot.db.get_state(DOMAIN_LEDGER_ID)
        st._resolve_waves = timed(st._resolve_waves, wave_s)
    # the commit plans the states encode: one per commit that goes to the
    # card, each of its levels one former per-level wave
    plans = [0, 0]
    encode = sparse_merkle_state._plan_encode

    def counted(waves, run):
        plans[0] += 1
        plans[1] += len(run)
        return encode(waves, run)

    seq = [0]

    def submit(count):
        for _ in range(count):
            seq[0] += 1
            pool.submit_request(seq[0])

    def run_until(target):
        start = pool.timer.get_current_time()
        while min(len(nd.ordered_digests) for nd in pool.nodes) < target:
            if pool.timer.get_current_time() - start > 600:
                raise AssertionError(f"phase C stalled below {target}")
            pool.run_for(0.1)

    def states():
        return [nd.boot.db.get_state(DOMAIN_LEDGER_ID) for nd in pool.nodes]

    submit(POOL_BATCH)
    run_until(POOL_BATCH)
    n_txns = POOL_BATCHES * POOL_BATCH
    submit(n_txns)
    exec_s[0] = wave_s[0] = 0.0
    launches0 = kb.LAUNCHES["merkle_node_hash"]
    hashes0 = sum(st.wave_device_hashes for st in states())
    sim_t0 = pool.timer.get_current_time()
    sparse_merkle_state._plan_encode = counted
    try:
        t0 = time.perf_counter()
        run_until(POOL_BATCH + n_txns)
        if device != "cpu":
            import torch

            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sparse_merkle_state._plan_encode = encode
    sim = pool.timer.get_current_time() - sim_t0
    if not pool.honest_nodes_agree():
        raise AssertionError("phase C: honest nodes disagree")
    ordered = min(len(nd.ordered_digests) for nd in pool.nodes) - POOL_BATCH
    k11_launches = kb.LAUNCHES["merkle_node_hash"] - launches0
    if device != "cpu" and k11_launches != plans[0]:
        raise AssertionError(f"phase C: {k11_launches} K11 launches for "
                             f"{plans[0]} device commits")
    plan_hashes = sum(st.wave_device_hashes for st in states()) - hashes0
    node0 = pool.nodes[0].boot.db
    return pool, _pool_result(
        pool, wall, ordered=ordered, sim_s=sim,
        ordered_txns_per_s=ordered / wall,
        ordered_txns_per_sim_s=ordered / sim,
        execution_s=exec_s[0], execution_share=exec_s[0] / wall,
        wave_hashing_s=wave_s[0],
        device_commits=plans[0], device_levels=plans[1],
        k11_launches=k11_launches,
        mean_plan_width=plan_hashes / plans[1] if plans[1] else 0.0,
        mean_plan_levels=plans[1] / plans[0] if plans[0] else 0.0,
        wave_device_hashes=sum(st.wave_device_hashes for st in states()),
        wave_host_hashes=sum(st.wave_host_hashes for st in states()),
        ledger_hashes=[pool.ledger_hash(nd.name) for nd in pool.nodes],
        state_root=node0.get_state(DOMAIN_LEDGER_ID)
        .committed_head_hash.hex(),
        domain_txn_root=node0.get_ledger(DOMAIN_LEDGER_ID).root_hash.hex(),
        audit_txn_root=node0.get_ledger(AUDIT_LEDGER_ID).root_hash.hex(),
        roots_agree=len({(nd.boot.db.get_state(DOMAIN_LEDGER_ID)
                          .committed_head_hash,
                          nd.boot.db.get_ledger(DOMAIN_LEDGER_ID).root_hash,
                          nd.boot.db.get_ledger(AUDIT_LEDGER_ID).root_hash)
                         for nd in pool.nodes}) == 1)


def run_reads_d(pool, corpus, dev):
    """Proved reads on the card: drains of 4,096 seeded indices over phase
    C's committed domain ledger through ``make_read_service(mode=
    "device")``, then ``verify_audit_paths_batch`` at the catchup-proof
    shape, end to end (packing + transfer + kernel)."""
    from indy_plenum_tpu_torch.server.catchup import catchup_rep_service \
        as crs

    service = pool.make_read_service("node0", mode="device")
    rng = random.Random(17)
    served = verified = 0
    t0 = time.perf_counter()
    for _ in range(D_DRAINS):
        for _ in range(D_DRAIN):
            service.submit(rng.randrange(1 << 30))
        replies = service.drain()
        served += len(replies)
        verified += sum(r.verified for r in replies)
    reads_s = time.perf_counter() - t0
    if served != D_DRAIN * D_DRAINS or verified != served:
        raise AssertionError(f"phase D: {verified} of {served} reads "
                             f"verified")
    tree, leaf_data, indices, paths = corpus
    t0 = time.perf_counter()
    verdicts = crs.verify_audit_paths_batch(
        leaf_data, indices, paths, tree.tree_size, tree.root_hash,
        mode="device", device=dev)
    e2e_s = time.perf_counter() - t0
    if not verdicts.all():
        raise AssertionError("phase D: a catchup-shape proof failed")
    return {"ledger_size": service.backing.tree_size,
            "reads_served": served, "reads_verified": verified,
            "reads_per_s": served / reads_s,
            "proofs": len(leaf_data),
            "proofs_per_s_end_to_end": len(leaf_data) / e2e_s}


def catchup_kernel_rate(corpus, dev):
    """K10 alone at the catchup-proof shape: all 16,384 proofs packed into
    one launch, already on the card, device time behind a spin (timing
    launches, outside phase D's count)."""
    import torch
    from indy_plenum_tpu_torch.server.catchup import catchup_rep_service \
        as crs
    from indy_plenum_tpu_torch.tpu import sha256 as s2

    tree, leaf_data, indices, paths = corpus
    packed = crs.pack_audit_batch(leaf_data, indices, paths,
                                  tree.tree_size, tree.root_hash)
    args = [torch.from_numpy(a).to(dev) for a in packed]
    if not bool(s2.verify_audit_paths_indexed(*args).all()):
        raise AssertionError("catchup-shape proofs failed in one launch")
    kernel_ms = _kernel_ms(lambda: s2.verify_audit_paths_indexed(*args), 5)
    return {"kernel_ms_16384": kernel_ms,
            "proofs_per_s_kernel": len(leaf_data) / (kernel_ms / 1e3)}


# phase L: bench.py's end-to-end catchup cell (bench_catchup_e2e)
L_SEED, L_WARM, L_MISSED = 31, 30, 150
L_CONFIG = {"Max3PCBatchSize": 10, "Max3PCBatchWait": 0.1, "CHK_FREQ": 10,
            "LOG_SIZE": 30, "ConsistencyProofsTimeout": 1.0,
            "CatchupRequestTimeout": 1.5}
L_BEHIND = "node3"
L_DOMAIN, L_AUDIT = 1, 3  # DOMAIN_LEDGER_ID, AUDIT_LEDGER_ID in both packages
L_SIM_BUDGET = 120.0  # virtual seconds a stage of the run may take
L_ARMS = (("L1", False), ("L2", True))


def tamper_first_domain_rep(pool):
    """Phase L2's byzantine seeder: the peer that node3 sends its first
    domain ``CatchupReq`` alters one txn (an extra key) of the
    ``CatchupRep`` it answers with, once. Works on any pool whose nodes
    have a ``seeder`` (the message classes are taken from the messages).
    Returns the record ``{"peer": name, "altered": count}``."""
    import copy

    state = {"peer": None, "altered": 0}

    def spot(msg, frm, to):
        if state["peer"] is None and frm == L_BEHIND \
                and getattr(msg, "typename", None) == "CATCHUP_REQ" \
                and msg.ledgerId == L_DOMAIN:
            state["peer"] = to
        return None

    pool.network.add_delayer(spot)

    class Altering:
        def __init__(self, bus, name):
            self._bus, self._name = bus, name

        def send(self, msg, dst=None):
            if not state["altered"] and self._name == state["peer"] \
                    and getattr(msg, "typename", None) == "CATCHUP_REP" \
                    and msg.ledgerId == L_DOMAIN:
                txns = dict(msg.txns)
                first = min(txns, key=int)
                txn = copy.deepcopy(txns[first])
                txn["altered"] = True
                txns[first] = txn
                msg = type(msg)(ledgerId=msg.ledgerId, txns=txns,
                                auditPaths=msg.auditPaths,
                                catchupTill=msg.catchupTill)
                state["altered"] += 1
            return self._bus.send(msg, dst)

    for nd in pool.nodes:
        nd.seeder._network = Altering(nd.seeder._network, nd.name)
    return state


def run_catchup_l(device, tamper=False, missed=L_MISSED, make_pool=None):
    """``bench.py``'s end-to-end catchup cell through the port's pool:
    n = 4, seed 31, batches of 10, CHK_FREQ 10, LOG_SIZE 30; 30 warm-up
    requests, then node3 disconnected while ``missed`` more order; then
    reconnect, ``leecher.start()``, and run until node3's domain ledger
    reaches the honest size. The offload policy starts fresh, so the
    first domain slice at or above ``DEVICE_MIN_BATCH`` proofs verifies
    through K10 on ``device``. ``tamper`` (arm L2) makes the peer sent
    the first domain slice alter one txn of its rep: the verdict must
    reject it, and the slice is re-assigned. ``make_pool(config)`` builds
    another package's pool on the same script (the CPU tests pass the
    JAX package's); by default the port's on ``device``."""
    from indy_plenum_tpu_torch.server.catchup import catchup_rep_service \
        as crs
    from indy_plenum_tpu_torch.tpu import sha256 as s2
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    on_card = make_pool is None and device != "cpu"
    if make_pool is None:
        from indy_plenum_tpu_torch.config import getConfig
        from indy_plenum_tpu_torch.simulation.pool import SimPool

        def make_pool(config):
            return SimPool(4, seed=L_SEED, real_execution=True,
                           config=getConfig(config), trace=True,
                           device=device)

    pool = make_pool(dict(L_CONFIG))

    def size(nd):
        return nd.boot.db.get_ledger(L_DOMAIN).size

    def run_until(done, what):
        start = pool.timer.get_current_time()
        while not done():
            if pool.timer.get_current_time() - start > L_SIM_BUDGET:
                raise AssertionError(f"phase L: {what} stalled")
            pool.run_for(0.5)

    honest = [nd for nd in pool.nodes if nd.name != L_BEHIND]
    behind = pool.node(L_BEHIND)
    for i in range(L_WARM):
        pool.submit_request(i)
    run_until(lambda: min(size(nd) for nd in honest) >= L_WARM + 1,
              "warm-up")
    pool.network.disconnect(L_BEHIND)
    for i in range(L_WARM, L_WARM + missed):
        pool.submit_request(i)
    run_until(lambda: min(size(nd) for nd in honest)
              >= L_WARM + missed + 1, "ordering")
    honest_size = size(pool.node("node0"))
    if size(behind) >= honest_size:
        raise AssertionError(f"phase L: {L_BEHIND} is not behind")
    altered = tamper_first_domain_rep(pool) if tamper else None
    # the suspicions the leecher's rep services raise (each still goes
    # on to the node's bus as a RaisedSuspicion)
    suspicions = []

    def noted(sink):
        def note(ex):
            suspicions.append(ex.suspicion.code)
            return sink(ex)
        return note

    for svc in behind.leecher._rep_services.values():
        svc._suspicion = noted(svc._suspicion)
    pool.network.reconnect(L_BEHIND)
    # a fresh policy, as a new process has it: the first slice at or
    # above DEVICE_MIN_BATCH goes to the card
    crs.OFFLOAD_POLICY = crs._AdaptiveOffload()
    rows = {"dispatched": 0, "card": 0}
    dispatch, fold = crs.dispatch_audit_paths_batch, \
        s2.verify_audit_paths_indexed

    def counted_dispatch(leaf_data, *args, **kwargs):
        rows["dispatched"] += len(leaf_data)
        return dispatch(leaf_data, *args, **kwargs)

    captured = []  # the card's K10 calls, held against plain after

    def counted_fold(leaf, *args):
        rows["card"] += int(leaf.shape[0])
        out = fold(leaf, *args)
        if leaf.device.type == "cuda":
            captured.append(((leaf,) + args, out))
        return out

    leecher = behind.leecher
    stats0 = leecher.catchup_stats()
    k10_0 = kb.LAUNCHES["audit_paths_indexed"]
    crs.dispatch_audit_paths_batch = counted_dispatch
    s2.verify_audit_paths_indexed = counted_fold
    try:
        t0 = time.perf_counter()
        sim0 = pool.timer.get_current_time()
        leecher.start()
        run_until(lambda: size(behind) >= honest_size, "catchup")
        if on_card:
            import torch

            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sim = pool.timer.get_current_time() - sim0
    finally:
        crs.dispatch_audit_paths_batch = dispatch
        s2.verify_audit_paths_indexed = fold
    k10 = kb.LAUNCHES["audit_paths_indexed"] - k10_0
    # time to recover on the virtual clock: the round's started and
    # completed trace marks (the loop above steps 0.5 sim-s at a time)
    marks = {ev["name"]: ev["ts"] for ev in pool.trace.events()
             if ev.get("node") == L_BEHIND
             and ev["name"] in ("catchup.started", "catchup.completed")}
    stats = leecher.catchup_stats()
    delta = {key: stats[key] - stats0[key] for key in stats}
    if size(behind) != honest_size or delta["txns_leeched"] < missed \
            or delta["proofs_verified"] < delta["txns_leeched"] \
            or leecher.catchups_completed < 1 \
            or not behind.data.is_participating:
        raise AssertionError(f"phase L: catchup incomplete {stats}")
    nodes = pool.nodes
    roots = [(nd.boot.db.get_ledger(L_DOMAIN).root_hash.hex(),
              nd.boot.db.get_ledger(L_AUDIT).root_hash.hex())
             for nd in nodes]
    if len(set(roots)) != 1:
        raise AssertionError("phase L: roots diverge after catchup")
    return {
        "missed": missed, "honest_size": honest_size,
        "txns_leeched": delta["txns_leeched"],
        "proofs_verified": delta["proofs_verified"],
        "proofs_on_card": rows["card"],
        "proofs_on_host": rows["dispatched"] - rows["card"],
        "reps_rejected": delta["reps_rejected"], "retries": delta["retries"],
        "k10_launches": k10,
        "rep_wrong_suspicions": suspicions.count(40),
        "altered": altered,
        "recover_sim_s": marks["catchup.completed"]
        - marks["catchup.started"],
        "catchup_sim_s": sim, "catchup_wall_s": wall,
        "leeched_txns_per_sim_s": delta["txns_leeched"] / sim,
        "leeched_txns_per_recover_sim_s": delta["txns_leeched"]
        / (marks["catchup.completed"] - marks["catchup.started"]),
        "leeched_txns_per_wall_s": delta["txns_leeched"] / wall,
        "catchup_stats": stats,
        "ordered_hash": pool.ordered_hash(),
        "trace_hash": pool.trace.trace_hash(exclude_cats=("dispatch",)),
        "ledger_hashes": [pool.ledger_hash(nd.name) for nd in nodes],
        "domain_root": roots[0][0], "audit_root": roots[0][1],
        "state_heads": [[nd.boot.db.get_state(lid).committed_head_hash.hex()
                         for lid in (0, 1, 2)] for nd in nodes],
        "k10_calls": captured,
    }


# what phase L's card and CPU runs must agree on
L_COMPARE = ("ordered_hash", "trace_hash", "ledger_hashes", "domain_root",
             "audit_root", "state_heads", "catchup_stats", "txns_leeched",
             "proofs_verified", "reps_rejected", "retries",
             "rep_wrong_suspicions", "recover_sim_s")


def check_catchup_k10(calls):
    """K10's calls inside phase L's catchup, after the run: each call's
    verdicts against the plain version on the same inputs (0 = equal),
    and the first call (the first domain slice) timed behind the spin
    against its plain version. These launches come after the phase's
    counters were read."""
    import torch
    from indy_plenum_tpu_torch.tpu import sha256 as s2

    if not calls:
        raise AssertionError("phase L: no K10 call on the card")
    err = rejected = 0
    for args, out in calls:
        plain = s2.verify_audit_paths_indexed_plain(*(a.cpu() for a in args))
        err = max(err, int((out.cpu() != plain).sum()))
        rejected += int((~out.cpu()).sum())
    args = calls[0][0]
    return {"k10_max_abs_err": err, "k10_calls": len(calls),
            "k10_rejected_proofs": rejected,
            "k10_slice_proofs": int(args[0].shape[0]),
            "k10_slice_depth": int(args[3].shape[1]),
            "k10_slice_ms": _kernel_ms(
                lambda: s2.verify_audit_paths_indexed(*args), 20),
            "k10_slice_plain_ms": _cuda_ms(
                lambda: s2.verify_audit_paths_indexed_plain(*args), 1, 1)}


# phase P: the state-proof plane at full width (bench.py bench_bls_multisig
# and bench_state_proofs: BASELINE config 3's 64 validators)
P_VALIDATORS = 64
P_WINDOWS = (1, 16, 64)  # windows a combined pairing pass verifies
P_READS = 4096  # proof-attached reads of one drain
P_SAMPLE = 64  # replies a client verifies with the pool's keys alone
P_REPS = 5
P_SEED = 7  # the combination scalars' seed (bench_state_proofs')
P_POOL_CONFIG = {"Max3PCBatchSize": POOL_BATCH, "Max3PCBatchWait": 0.05,
                 "QuorumTickInterval": 0.1, "QuorumTickAdaptive": True,
                 "CHK_FREQ": 2, "LOG_SIZE": 6,
                 "StateCommitBatchMode": "host"}
P_POOL_TXNS = 3 * POOL_BATCH  # two batches stabilize a window, one more
P_POOL_READS = 1024


def _median(samples):
    return sorted(samples)[len(samples) // 2]


def bls_p():
    """Host work of the state-proof plane at 64 validators: one aggregate
    + ``verify_multi_sig`` over 64 shares (cycles/sec), then
    ``verify_multi_sigs_batch`` over 1, 16 and 64 windows (seeded), and
    the 64 windows again with one forged item, which the verdicts must
    name. Pairings are host work of the card's machine."""
    from indy_plenum_tpu_torch.crypto.bls.bls_crypto import (
        PAIRINGS, BlsCryptoSigner, BlsCryptoVerifier, BlsKeyPair)
    from indy_plenum_tpu_torch.proofs import verify_multi_sigs_batch

    kps = [BlsKeyPair(hashlib.sha256(b"bench-proof-%d" % i).digest())
           for i in range(P_VALIDATORS)]
    signers = [BlsCryptoSigner(kp) for kp in kps]
    pks = [kp.pk_b58 for kp in kps]
    msg = b"multi-sig-value|ledger:1|state-root|txn-root|ts:1700000000"
    shares = [s.sign(msg) for s in signers]

    def cycle():
        agg = BlsCryptoVerifier.aggregate_sigs(shares)
        if not BlsCryptoVerifier.verify_multi_sig(agg, msg, pks):
            raise AssertionError("phase P: a 64-share aggregate failed")

    cycle()  # the subgroup checks of the keys, once
    times = []
    for _ in range(P_REPS):
        t0 = time.perf_counter()
        cycle()
        times.append(time.perf_counter() - t0)
    cycle_s = _median(times)
    items = []
    for j in range(max(P_WINDOWS)):
        m = b"proof-window-root-%d" % j
        items.append((BlsCryptoVerifier.aggregate_sigs(
            [s.sign(m) for s in signers]), m, pks))
    batch = {}
    for k in P_WINDOWS:
        before = PAIRINGS.snapshot()
        if not all(verify_multi_sigs_batch(items[:k], seed=P_SEED)):
            raise AssertionError(f"phase P: a batch of {k} failed")
        pairs = PAIRINGS.pairings - before[1]
        times = []
        for _ in range(P_REPS):
            t0 = time.perf_counter()
            verify_multi_sigs_batch(items[:k], seed=P_SEED)
            times.append(time.perf_counter() - t0)
        batch[k] = {"ms": _median(times) * 1e3,
                    "windows_per_s": k / _median(times),
                    "miller_loops": pairs}
    bad = random.Random(15).randrange(len(items))
    forged = list(items)
    forged[bad] = (items[bad][0], b"proof-window-forged", pks)
    verdicts = verify_multi_sigs_batch(forged, seed=P_SEED)
    if [i for i, ok in enumerate(verdicts) if not ok] != [bad]:
        raise AssertionError(f"phase P: the forged window {bad} was not "
                             f"the one named")
    return {"validators": P_VALIDATORS, "cycle_ms": cycle_s * 1e3,
            "cycles_per_s": 1.0 / cycle_s, "batch": batch,
            "forged_window": bad}, signers


def proof_reads_p(device, signers):
    """``P_READS`` proof-attached reads over ``StaticCorpusBacking(4096,
    seed=11)`` through ``ReadService(mode="device", proof_cache=)``: one
    pre-verified window with the 64 signers' multi-signature; the serve
    path makes no pairing check. Returns the replies, the counts and the
    wall of the timed (second) drain."""
    from indy_plenum_tpu_torch.crypto.bls.bls_crypto import (
        PAIRINGS, BlsCryptoVerifier, MultiSignature, MultiSignatureValue)
    from indy_plenum_tpu_torch.ingress.read_service import (
        ReadService, StaticCorpusBacking)
    from indy_plenum_tpu_torch.proofs import CheckpointProofCache, \
        ProofWindow
    from indy_plenum_tpu_torch.utils.base58 import b58encode

    backing = StaticCorpusBacking(P_READS, seed=11)
    value = MultiSignatureValue(
        ledger_id=1, state_root_hash="bench-state-root",
        pool_state_root_hash="", txn_root_hash=b58encode(backing.root),
        timestamp=1_700_000_000)
    agg = BlsCryptoVerifier.aggregate_sigs(
        [s.sign(value.serialize()) for s in signers])
    ms = MultiSignature(signature=agg, participants=[
        "node%d" % i for i in range(len(signers))], value=value)
    cache = CheckpointProofCache(
        bls_replica=None,
        root_provider=lambda: (backing.tree_size, backing.root),
        state_root_provider=lambda: "bench-state-root")
    cache.install(ProofWindow(
        window=(0, 100), tree_size=backing.tree_size, root=backing.root,
        state_root_b58="bench-state-root", multi_sig=ms,
        multi_sig_dict=ms.as_dict(), captured_at=0.0))
    service = ReadService(backing, mode="device", proof_cache=cache,
                          device=device)
    drains = []
    checks0 = PAIRINGS.checks
    for _ in range(2):  # the first fills the audit-path cache
        for i in range(P_READS):
            service.submit(i)
        t0 = time.perf_counter()
        replies = service.drain()
        if device != "cpu":
            import torch

            torch.cuda.synchronize()
        drains.append((replies, time.perf_counter() - t0))
    return {"replies": drains[0][0], "serve_pairings":
            PAIRINGS.checks - checks0, "wall_s": drains[1][1],
            "attached": service.proofs_attached_total,
            "cache": cache.counters()}


def check_proof_reads(got, cpu, keys):
    """Phase P's reads: every reply verified with the window's
    multi-signature, no pairing on the serve path, the client's
    ``verify_proved_read`` on a seeded sample (the pool's keys only) and
    on one tampered reply, and the card's replies equal to the CPU's
    field by field."""
    import dataclasses

    from indy_plenum_tpu_torch.client.state_proof import verify_proved_read
    from indy_plenum_tpu_torch.crypto.bls.bls_crypto import PAIRINGS

    replies = got["replies"]
    if len(replies) != P_READS or got["serve_pairings"] \
            or not all(r.verified and r.multi_sig and r.window == (0, 100)
                       for r in replies):
        raise AssertionError("phase P: a read without its window proof")
    if [dataclasses.asdict(r) for r in replies] != \
            [dataclasses.asdict(r) for r in cpu["replies"]]:
        raise AssertionError("phase P: card and CPU replies differ")
    quorum = len(keys) - (len(keys) - 1) // 3  # n - f co-signers
    sample = random.Random(19).sample(range(P_READS), P_SAMPLE)
    before = PAIRINGS.checks
    t0 = time.perf_counter()
    ok = sum(verify_proved_read(replies[i], keys, quorum) for i in sample)
    client_s = time.perf_counter() - t0
    tampered = dataclasses.replace(replies[sample[0]], leaf=b"forged")
    if ok != P_SAMPLE or verify_proved_read(tampered, keys, quorum):
        raise AssertionError("phase P: the client's verdicts are wrong")
    return {"client_verified": ok,
            "client_pairings": PAIRINGS.checks - before,
            "client_ms_per_read": client_s / P_SAMPLE * 1e3}


def run_pool_p(device):
    """A real BLS pool: n = 4, ``device_quorum``, real execution, phase
    C's batches (320, wait 0.05, adaptive tick from 0.1) with CHK_FREQ 2,
    three batches of NYMs, until every node holds a proof window; then
    ``read_nym_with_proof`` from node1 and a proof-attached drain of
    ``P_POOL_READS`` through ``make_read_service("node0",
    mode="device")``. Returns what the card and CPU runs must agree on."""
    import dataclasses

    from indy_plenum_tpu_torch.client.state_proof import (
        verify_proved_read, verify_proved_reply)
    from indy_plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    pool = SimPool(n_nodes=4, seed=11, config=getConfig(P_POOL_CONFIG),
                   device_quorum=True, real_execution=True, bls=True,
                   trace=True, device=device)
    for i in range(P_POOL_TXNS):
        pool.submit_request(i)
    t0 = time.perf_counter()
    start = pool.timer.get_current_time()
    while min(len(nd.ordered_digests) for nd in pool.nodes) < P_POOL_TXNS \
            or any(nd.proof_cache.current() is None for nd in pool.nodes):
        if pool.timer.get_current_time() - start > 120:
            raise AssertionError("phase P: no proof window stabilized")
        pool.run_for(0.1)
    order_s = time.perf_counter() - t0
    keys = {name: pk for name, (kp, pk, pop) in pool.bls_keys.items()}
    nym = pool.node("node1").read_nym_with_proof(pool.trustee.identifier)
    service = pool.make_read_service("node0", mode="device")
    rng = random.Random(23)
    for _ in range(P_POOL_READS):
        service.submit(rng.randrange(1 << 20))
    replies = service.drain()
    if not all(r.verified and r.multi_sig for r in replies) \
            or not verify_proved_read(replies[0], keys, 3) \
            or not verify_proved_reply(nym, keys, 3):
        raise AssertionError("phase P: a pool reply does not verify")
    if not pool.honest_nodes_agree():
        raise AssertionError("phase P: honest nodes disagree")
    return {
        "ordered": min(len(nd.ordered_digests) for nd in pool.nodes),
        "order_wall_s": order_s,
        "windows": [nd.proof_cache.windows() for nd in pool.nodes],
        "ordered_hash": pool.ordered_hash(),
        "trace_hash": pool.trace.trace_hash(exclude_cats=("dispatch",)),
        "ledger_hashes": [pool.ledger_hash(nd.name) for nd in pool.nodes],
        "state_roots": [nd.boot.db.get_state(
            DOMAIN_LEDGER_ID).committed_head_hash.hex()
            for nd in pool.nodes],
        "bls_stores": [list(nd.bls_replica.store._kv.iterator())
                       for nd in pool.nodes],
        "nym": nym.as_dict(),
        "replies": [dataclasses.asdict(r) for r in replies]}


# what phase P's pool arms must agree on (the walls aside)
P_COMPARE = ("ordered", "windows", "ordered_hash", "trace_hash",
             "ledger_hashes", "state_roots", "bls_stores", "nym", "replies")

# phase X: chaos arcs on the tick-batched dispatch plane (the reference's
# tests/test_chaos.py:380 arm), seed 7, each on the card and on the CPU
X_SEED = 7
X_TICK = {"device_quorum": True, "quorum_tick_interval": 0.05,
          "quorum_tick_adaptive": True}
X_ARMS = ("f_crash_gc_catchup", "byzantine_seeder_catchup",
          "f_crash_partition")
# the workload planes' scenarios; their CPU twins run in worker processes
X_NEW_ARMS = ("lane_partition", "edge_cache_poisoning",
              "f_crash_catchup_under_saturation")
# host wall-clock series: the fields a card run and a CPU run never share
X_WALL_METRICS = ("device.flush_time", "auth.batch_time")


@contextlib.contextmanager
def plain_dispatches():
    """Count, on the CPU, the launches the card's wrappers would make for
    K7 (one a step), K8's slide and zero (one per chunk of host pairs or
    rows, none for an empty one): the plain versions, patched for the
    block's length."""
    from indy_plenum_tpu_torch.tpu import quorum as q

    counts = {"quorum_step": 0, "window_slide": 0, "window_zero": 0}
    step, slide, zero = q.step_plain, q.slide_plain, q.zero_plain

    def counted_step(*args, **kwargs):
        counts["quorum_step"] += 1
        return step(*args, **kwargs)

    def counted_slide(state, deltas):
        counts["window_slide"] += len(q.slide_pair_chunks(deltas.numpy()))
        return slide(state, deltas)

    def counted_zero(state, mask):
        counts["window_zero"] += len(q.zero_row_chunks(
            (mask != 0).numpy()))
        return zero(state, mask)

    q.step_plain, q.slide_plain, q.zero_plain = \
        counted_step, counted_slide, counted_zero
    try:
        yield counts
    finally:
        q.step_plain, q.slide_plain, q.zero_plain = step, slide, zero


def run_chaos_x(device, name):
    """One chaos arm through the port's ``run_scenario`` on the tick
    plane, traced; the report's record (the replay command and the
    host's wall-clock flush series aside), its wall, and for a catchup
    arc the victim's recovery in virtual seconds: from its restart to its
    first completed catchup round after it."""
    import os
    import tempfile

    from indy_plenum_tpu_torch.chaos import run_scenario
    from indy_plenum_tpu_torch.observability.trace import load_jsonl

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.jsonl")
        t0 = time.perf_counter()
        report = run_scenario(name, X_SEED, trace=True, trace_out=path,
                              device=device, **X_TICK)
        wall = time.perf_counter() - t0
        events = load_jsonl(path)
    record = report.as_dict()
    for key in ("replay_command", "trace_file"):
        record.pop(key)
    for key in X_WALL_METRICS:
        record["metrics"].pop(key, None)
    recover = None
    for victim in report.catchup.get("restarted_nodes", ()):
        restart = next(t for t, what in report.trace
                       if what.startswith("end CrashFault")
                       and f"node={victim}" in what)
        done = min(ev["ts"] for ev in events
                   if ev["name"] == "catchup.completed"
                   and ev.get("node") == victim and ev["ts"] >= restart)
        recover = done - restart
    return report, record, wall, recover


def phase_p(on_card, card):
    """Phase P: the state-proof plane at full width. BLS at 64 validators
    (host pairings), 4,096 proof-attached reads through K10 indexed with
    no pairing on the serve path, then a real BLS pool; the card's runs
    and the CPU's agree. ``on_card(tag, fn, *args)`` is ``main``'s
    counted run."""
    t0 = time.perf_counter()
    bls, signers = bls_p()
    keys_p = {f"node{i}": s.pk for i, s in enumerate(signers)}
    reads_p, p_launches, _ = on_card("proofs_p", proof_reads_p, None,
                                     signers)
    cpu_reads_p = proof_reads_p("cpu", signers)
    client_p = check_proof_reads(reads_p, cpu_reads_p, keys_p)
    pool_p, pool_p_launches, pool_p_s = on_card("pool_p", run_pool_p, None)
    t_cpu = time.perf_counter()
    cpu_pool_p = run_pool_p("cpu")
    cpu_pool_p_s = time.perf_counter() - t_cpu
    for key in P_COMPARE:
        if pool_p[key] != cpu_pool_p[key]:
            raise AssertionError(f"phase P: card and CPU pools differ on "
                                 f"{key}")
    proofs_p = dict(
        bls, reads=P_READS, reads_wall_s=reads_p["wall_s"],
        reads_per_s=P_READS / reads_p["wall_s"],
        cpu_reads_wall_s=cpu_reads_p["wall_s"],
        serve_pairings=reads_p["serve_pairings"],
        proofs_attached=reads_p["attached"], cache=reads_p["cache"],
        **client_p)
    _line("proofs_p", **proofs_p, launches=p_launches, card=card)
    _line("pool_p", ordered=pool_p["ordered"], windows=pool_p["windows"],
          ordered_hash=pool_p["ordered_hash"],
          order_wall_s=pool_p["order_wall_s"], arm_s=pool_p_s,
          cpu_order_wall_s=cpu_pool_p["order_wall_s"],
          cpu_arm_s=cpu_pool_p_s, reads=len(pool_p["replies"]),
          launches=pool_p_launches, phase_s=time.perf_counter() - t0,
          card=card)
    return proofs_p


def phase_x(on_card, card):
    """Phase X: each chaos arc of ``X_ARMS`` on the tick plane, on the
    card and on the CPU: equal reports, and the card's K7 and K8 launches
    equal to the dispatches the CPU run counted."""
    t0 = time.perf_counter()
    chaos_x = {}
    for name in X_ARMS:
        (report, record, wall, recover), x_launches, _ = on_card(
            f"chaos_{name}", run_chaos_x, None, name)
        with plain_dispatches() as counted:
            _, cpu_record, cpu_wall, _ = run_chaos_x("cpu", name)
        diff = sorted(k for k in record if record[k] != cpu_record[k])
        if diff:
            raise AssertionError(f"phase X {name}: card and CPU reports "
                                 f"differ on {diff}")
        if report.failed or not report.verdict_as_expected:
            raise AssertionError(f"phase X {name}: {report.invariants}")
        if any(x_launches[k] != n for k, n in counted.items()) \
                or x_launches["quorum_step"] != \
                report.metrics["device.flush"]["count"]:
            raise AssertionError(f"phase X {name}: launches {x_launches} "
                                 f"against the CPU's {counted}")
        chaos_x[name] = {
            "wall_s": wall, "cpu_wall_s": cpu_wall,
            "recover_sim_s": recover,
            "virtual_seconds": report.virtual_seconds,
            "quorum_step": x_launches["quorum_step"],
            "window_slide": x_launches["window_slide"],
            "window_zero": x_launches["window_zero"]}
        catchup = report.catchup
        _line("chaos_x", arm=name, **chaos_x[name],
              invariants={r["name"]: r["verdict"]
                          for r in report.invariants},
              txns_leeched=catchup.get("txns_leeched"),
              reps_rejected=catchup.get("reps_rejected"),
              proof_read=catchup.get("proof_read"),
              trace_hash=report.trace_hash, launches=x_launches,
              cpu_counted=counted, card=card)
    _line("chaos_x_summary", phase_s=time.perf_counter() - t0, card=card)
    return chaos_x


# --- the workload planes: phases O, N, S and W, and phase X's new arms ------
#
# Each new phase runs on the card in this process and on the CPU in a
# worker process of ``_twin_pool``: the CPU twins' plain versions (signed
# ingress above all, whose plain verify takes seconds a drain) would
# otherwise hold the card's timeline back by many minutes. The twins are
# submitted when the script starts and read after the kernels line, where
# each phase's card record is held against its twin.

TWIN_WORKERS = 6


def _twin_init():
    import torch

    torch.set_num_threads(1)


def _twin_pool():
    """The worker processes for the CPU twins (spawned, one torch thread
    each); ``main`` shuts the pool down, so every process it starts
    ends with it."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        max_workers=TWIN_WORKERS,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_twin_init)


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def _sim_until(pool, done, budget, step, what):
    """Run ``pool`` in ``step`` virtual seconds until ``done()``, failing
    past ``budget`` virtual seconds: a virtual guard, so the card's run
    and the CPU's stop at the same instant."""
    start = pool.timer.get_current_time()
    while not done():
        if pool.timer.get_current_time() - start > budget:
            raise AssertionError(f"{what} stalled")
        pool.run_for(step)


def _digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()


# phase O: the overload plane, bench.py:1235 _run_overload (both arms)
O_SEED = 37
O_NODES, O_CAPACITY, O_KEYS = 8, 12, 4096
O_BASE_RATE, O_DURATION = 100.0, 9.0
O_FLASH_AT, O_FLASH_DUR, O_PEAK = 3.0, 1.5, 8.0
O_COMPARE = ("shed_hash", "retry_hash", "ordered_hash", "trace_hash",
             "replies_hash", "arrivals", "admission", "retries",
             "retry_admitted", "first_attempt_admitted", "ordered",
             "pre_spike_rate", "post_spike_rate", "reads_verified",
             "governor", "sim_elapsed_s")


def run_overload_o(device, retry):
    """One flash-crowd arm of ``bench.py``'s ``_run_overload``: n=8,
    signed, an admission queue of 12, 100 writes/s with a crowd at 3.0 s
    for 1.5 s at 8x over 9 s, 25% reads through ``ReadService(mode=
    "device")`` over ``StaticCorpusBacking(4096, seed=37)`` (K10
    indexed). ``retry`` arms the closed loop. The bench's wall-clock
    guards are virtual ones here, so the card and the CPU stop alike."""
    from indy_plenum_tpu_torch.common.metrics_collector import MetricsName
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.ingress import (
        ReadService,
        StaticCorpusBacking,
        WorkloadGenerator,
        WorkloadProfile,
        WorkloadSpec,
    )
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    warm = O_CAPACITY - 8
    config = getConfig({
        "Max3PCBatchSize": 40, "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.1, "QuorumTickAdaptive": True,
        "IngressQueueCapacity": O_CAPACITY,
        "IngressRetryMax": 4 if retry else 0,
        "IngressRetryBase": 0.2, "IngressRetryBackoffMult": 2.0,
        "IngressRetryBackoffMax": 2.0})
    pool = SimPool(n_nodes=O_NODES, seed=O_SEED, config=config,
                   device_quorum=True, shadow_check=False,
                   sign_requests=True, trace=True, trace_capacity=1 << 20,
                   device=device)
    reads = ReadService(StaticCorpusBacking(O_KEYS, seed=O_SEED),
                        clock=pool.timer.get_current_time,
                        metrics=pool.metrics, trace=pool.trace,
                        mode="device", device=device)

    def min_ordered():
        return min(len(nd.ordered_digests) for nd in pool.nodes)

    for i in range(warm):
        pool.submit_request(2_000_000 + i, client_id="warm")
    _sim_until(pool, lambda: min_ordered() >= warm, 300.0, 0.5,
               "phase O's warm-up")
    for i in range(64):
        reads.submit(i)
    replies = list(reads.drain())
    reads.reset_serve_meters()
    seq = [0]

    def on_write(client, key):
        seq[0] += 1
        pool.submit_request(seq[0], client_id="c%d" % client)

    gen = WorkloadGenerator(WorkloadSpec(
        n_clients=250_000, rate=O_BASE_RATE, duration=O_DURATION,
        read_fraction=0.25, n_keys=O_KEYS, seed=O_SEED,
        profile=WorkloadProfile(kind="flash", peak=O_PEAK,
                                flash_at=O_FLASH_AT,
                                flash_duration=O_FLASH_DUR)))
    gen.start(pool.timer, on_write,
              on_read=lambda client, key: reads.submit(key))
    ordered0 = min_ordered()
    sim_t0 = pool.timer.get_current_time()
    wall_t0 = time.perf_counter()
    samples = {}
    marks = (1.0, O_FLASH_AT, O_FLASH_AT + O_FLASH_DUR, 6.5, O_DURATION)
    elapsed = 0.0
    while (elapsed < O_DURATION + 8.0 or pool.admission.depth
           or (pool.retry is not None and pool.retry.outstanding)):
        if elapsed > 600.0:
            raise AssertionError("phase O: the queue never drained")
        pool.run_for(0.5)
        elapsed += 0.5
        replies += reads.drain()
        for m in marks:
            if m <= elapsed and m not in samples:
                samples[m] = min_ordered()
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    wall_s = time.perf_counter() - wall_t0
    sim_elapsed = pool.timer.get_current_time() - sim_t0
    if not pool.honest_nodes_agree():
        raise AssertionError("phase O: honest nodes disagree")
    adm = pool.admission
    pre = (samples[O_FLASH_AT] - samples[1.0]) / (O_FLASH_AT - 1.0)
    post = (samples[O_DURATION] - samples[6.5]) / (O_DURATION - 6.5)
    readmitted = pool.metrics.stat(MetricsName.INGRESS_RETRY_ADMITTED)
    readmitted_n = int(readmitted.total) if readmitted else 0
    adm_counters = adm.counters()
    adm_counters["offered"] -= warm
    adm_counters["admitted"] -= warm
    ordered = min_ordered() - ordered0
    return {
        "retry": bool(retry), "arrivals": gen.counters(),
        "admission": adm_counters,
        "shed_fraction": adm.shed_total / max(adm_counters["offered"], 1),
        "ordered": ordered, "ordered_per_sim_s": ordered / sim_elapsed,
        "pre_spike_rate": pre, "post_spike_rate": post,
        "recovery_ratio": post / pre if pre else None,
        "retry_admitted": readmitted_n,
        "first_attempt_admitted": adm_counters["admitted"] - readmitted_n,
        "retries": pool.retry.counters() if pool.retry else None,
        "retry_hash": pool.retry.retry_hash() if pool.retry else None,
        "shed_hash": adm.shed_hash(), "ordered_hash": pool.ordered_hash(),
        "trace_hash": pool.trace.trace_hash(),
        "replies_hash": _digest([(r.index, r.leaf, r.root, r.path,
                                  r.tree_size, r.verified)
                                 for r in replies]),
        "reads_served": reads.served_total,
        "reads_verified": reads.verified_total,
        "read_proofs_per_s": (reads.served_total / reads.serve_wall_s
                              if reads.serve_wall_s else 0.0),
        "governor": pool.governor.trajectory_summary(),
        "sim_elapsed_s": sim_elapsed, "wall_s": wall_s,
        "goodput_per_sim_s": ordered / sim_elapsed}



# phase N: ordering lanes, bench.py:600 _run_laned / :692 bench_lanes
N_PER_LANE, N_TXNS_PER_LANE, N_SEED, N_BATCH = 64, 96, 17, 16
N_ARMS = (1, 4, 2)  # 2 lanes last: run while the clock allows
N_COMPARE = ("ordered_hash_per_lane", "sealed_fingerprint", "journey_hash",
             "journeys", "router_distribution", "sealed_window",
             "seal_pads", "ordered_per_sim_sec", "sim_elapsed_s")


def run_laned_n(device, lanes):
    """One laned arm of ``bench.py``'s ``_run_laned``: ``lanes`` lanes of
    n=64 (each its own vote group on the one device: K7 a lane a tick,
    K8's slide at CHK_FREQ 2), 96 txns a lane after a warm-up of one
    batch a lane, then a seal flush; ordered txns per virtual second."""
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.lanes import LanedPool
    from indy_plenum_tpu_torch.observability.causal import journey_summary

    config = getConfig({
        "Max3PCBatchSize": N_BATCH, "Max3PCBatchWait": 0.05,
        "CHK_FREQ": 2, "LOG_SIZE": 6, "QuorumTickInterval": 0.1,
        "QuorumTickAdaptive": True, "TraceNetReceivers": 4})
    pool = LanedPool(lanes=lanes, n_nodes=N_PER_LANE, seed=N_SEED,
                     config=config, device_quorum=True, trace=True,
                     device=device)
    seq = [0]

    def submit(count):
        for _ in range(count):
            pool.submit_request(seq[0])
            seq[0] += 1

    warm = N_BATCH * lanes
    submit(warm)
    _sim_until(pool, lambda: pool.ordered_total() >= warm, 600.0, 0.1,
               f"phase N's {lanes}-lane warm-up")
    total = N_TXNS_PER_LANE * lanes
    sim_t0 = pool.timer.get_current_time()
    t0 = time.perf_counter()
    submit(total)
    _sim_until(pool, lambda: pool.ordered_total() >= warm + total, 600.0,
               0.1, f"phase N's {lanes}-lane arm")
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sim_elapsed = pool.timer.get_current_time() - sim_t0
    if not pool.honest_nodes_agree():
        raise AssertionError(f"phase N {lanes} lanes: nodes disagree")
    pads = pool.seal_flush()
    js = journey_summary(pool.trace.events())
    lanes_js = js.get("lanes") or {}
    return {
        "lanes": lanes, "n_per_lane": N_PER_LANE, "txns_ordered": total,
        "ordered_per_sim_sec": total / sim_elapsed,
        "sim_elapsed_s": sim_elapsed, "wall_s": wall,
        "ordered_per_wall_sec": total / wall,
        "router_distribution": list(pool.router.distribution),
        "ordered_hash_per_lane": pool.ordered_hashes(),
        "sealed_window": pool.barrier.sealed_window,
        "sealed_fingerprint": pool.sealed_fingerprint, "seal_pads": pads,
        "journey_hash": js["journey_hash"],
        "journeys": {
            "count": js["count"], "complete": js["complete"],
            "orphan_spans": js["orphan_spans"],
            "with_lane": lanes_js.get("with_lane", 0),
            "with_barrier_hop": lanes_js.get("with_barrier_hop", 0)}}



def check_laned_arm(arm):
    j = arm["journeys"]
    if j["orphan_spans"] or not (j["complete"] == j["count"]
                                 == j["with_lane"]
                                 == j["with_barrier_hop"]) or not j["count"]:
        raise AssertionError(f"phase N {arm['lanes']} lanes: journeys {j}")


# phase S: the day soak on the (4,) fabric (bench.py:1944 bench_day_soak)
S_HOURS = 6.0  # the bench's own slice; its legs at their hours
S_LEGS = {"crash_hour": 1.5, "crash_hours": 0.5, "vc_hour": 3.0}
S_SEED = 17
S_COMPARE = ("fingerprint", "telemetry_hash", "hourly_ordered",
             "ordered_total", "arrivals", "windows", "anomalies",
             "unexplained", "chaos", "first_high_water", "last_high_water",
             "flat_high_water", "throughput_drift", "agree")


def run_soak_s(device, hours=S_HOURS):
    """``simulation/soak.py``'s ``_day_soak_once`` at the config's
    ``SoakRate`` 0.1 and ``SoakKeys`` 400, seed 17, 600 s windows, the
    forced rebalance at ``SoakRebalanceTick``; the crash and view-change
    legs at the bench's hours, scaled by ``hours / 6``."""
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.soak import _day_soak_once

    base = getConfig()
    scale = hours / S_HOURS
    t0 = time.perf_counter()
    out = _day_soak_once(
        hours, base.SoakRate, S_SEED, base.SoakKeys,
        S_LEGS["crash_hour"] * scale, S_LEGS["crash_hours"] * scale,
        S_LEGS["vc_hour"] * scale, base.SoakRebalanceTick,
        window_sec=600.0, device=device)
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    return out



def check_soak(rec):
    chaos = rec["chaos"]
    if not (rec["flat_high_water"] and rec["agree"] and rec["device_arm"]
            and rec["anomalies_unexplained"] == 0
            and chaos["crash"]["ok"] and chaos["view_change"]["ok"]):
        raise AssertionError(f"phase S: {rec}")


# phase W: the geo plane, bench.py:1994 bench_geo (phases A and B)
W_SEED_A, W_SEED_B = 23, 29
W_WAVES, W_CLIENTS = 6, 120
W_INTRA_HI = 0.05


def _geo_ordering_arm(device, region_count):
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.observability.causal import journey_summary
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    config = getConfig({"Max3PCBatchSize": 4, "Max3PCBatchWait": 0.05,
                        "OrderingStallTimeout": 4.0,
                        "RegionCount": region_count})
    pool = SimPool(n_nodes=6, seed=W_SEED_A, config=config, trace=True,
                   device=device)
    sim_t0 = pool.timer.get_current_time()
    for i in range(48):
        pool.submit_request(i, region=(i % 3) if region_count else None)
    _sim_until(pool, lambda: min(len(nd.ordered_digests)
                                 for nd in pool.nodes) >= 48,
               300.0, 0.25, f"phase W regions={region_count}")
    if not pool.honest_nodes_agree():
        raise AssertionError("phase W: honest nodes disagree")
    order_s = pool.timer.get_current_time() - sim_t0
    primary = pool.nodes[0].data.primaries[0]
    pool.network.disconnect(primary)
    survivors = [nd for nd in pool.nodes if nd.name != primary]
    sim_t1 = pool.timer.get_current_time()
    for i in range(6):
        pool.submit_request(48 + i, region=(i % 3) if region_count else None)
    _sim_until(pool, lambda: all(nd.data.view_no >= 1
                                 and not nd.data.waiting_for_new_view
                                 for nd in survivors),
               300.0, 0.25, f"phase W's view change, regions="
               f"{region_count}")
    js = journey_summary(pool.trace.events())
    return {"regions": region_count, "order_48_sim_s": order_s,
            "view_change_sim_s": pool.timer.get_current_time() - sim_t1,
            "write_e2e_p99": ((js.get("e2e") or {}).get("write")
                              or {}).get("p99"),
            "cross_region_msgs": pool.network.counters().get(
                "cross_region", 0),
            "ordered_hash": pool.ordered_hash(),
            "journey_hash": js["journey_hash"]}


def _geo_barrier_arm(device, region_count):
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.lanes import LanedPool

    config = getConfig({"Max3PCBatchSize": 4, "Max3PCBatchWait": 0.05,
                        "CHK_FREQ": 2, "LOG_SIZE": 6,
                        "RegionCount": region_count})
    pool = LanedPool(lanes=2, n_nodes=4, seed=W_SEED_A, config=config,
                     device=device)
    sim_t0 = pool.timer.get_current_time()
    for i in range(32):
        pool.submit_request(i)
    _sim_until(pool, lambda: pool.ordered_total() >= 32, 300.0, 0.25,
               "phase W's laned arm")
    return {"regions": region_count,
            "sealed_window": pool.barrier.sealed_window,
            "seals": pool.barrier.seals,
            "seal_32_sim_s": pool.timer.get_current_time() - sim_t0,
            "sealed_fingerprint": pool.sealed_fingerprint,
            "ordered_hashes": pool.ordered_hashes()}


def _geo_edge_arm(device, use_edges):
    """``bench_geo``'s phase B arm: n=4 with BLS and real execution, 3
    regions; the origin (node0) serves in ``mode="device"``: its drains,
    the edges' replication included, fold their proofs with K10
    indexed."""
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.crypto.bls.bls_crypto import PAIRINGS
    from indy_plenum_tpu_torch.observability.causal import journey_summary
    from indy_plenum_tpu_torch.proofs.edge_cache import (
        EdgeProofCache,
        GeoReadFabric,
    )
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    config = getConfig({"Max3PCBatchSize": 1, "Max3PCBatchWait": 0.05,
                        "CHK_FREQ": 5, "LOG_SIZE": 15, "RegionCount": 3})
    pool = SimPool(n_nodes=4, seed=W_SEED_B, config=config,
                   real_execution=True, bls=True, trace=True, device=device)
    for i in range(12):
        pool.submit_request(i, region=i % 3)
    _sim_until(pool, lambda: (min(len(nd.ordered_digests)
                                  for nd in pool.nodes) >= 12
                              and pool.nodes[0].proof_cache.current()
                              is not None),
               300.0, 0.25, "phase W's edge arm")
    origin = pool.make_read_service("node0", mode="device")
    entry = origin.proof_cache.current()
    keys = {name: pk for name, (kp, pk, pop) in pool.bls_keys.items()}
    quorum = len(pool.validators) - (len(pool.validators) - 1) // 3
    edges = {}
    replicated = []
    if use_edges:
        for i in range(entry.tree_size):
            origin.submit(i)
        replicated = origin.drain()
        edges = {r: EdgeProofCache(region=r,
                                   clock=pool.timer.get_current_time)
                 for r in range(3)}
        for edge in edges.values():
            if edge.replicate(entry.window, replicated) != entry.tree_size:
                raise AssertionError("phase W: an edge refused the window")
    origin.reset_serve_meters()
    fabric = GeoReadFabric(
        origin, pool.region_matrix, keys, min_participants=quorum,
        n_regions=3, origin_region=0, edges=edges, seed=W_SEED_B,
        clock=pool.timer.get_current_time)
    pairings0 = PAIRINGS.checks
    served = []
    t0 = time.perf_counter()
    for wave in range(W_WAVES):
        for client in range(W_CLIENTS):
            fabric.submit(client, (7 * client + wave) % entry.tree_size)
        out = fabric.drain()
        if len(out) != W_CLIENTS:
            raise AssertionError(f"phase W wave {wave}: {len(out)} served")
        served += out
        pool.run_for(1.0)
    wall = time.perf_counter() - t0
    js = journey_summary(pool.trace.events())
    return {"edges": bool(use_edges), "reads": W_WAVES * W_CLIENTS,
            "fabric": fabric.counters(),
            "pairings": PAIRINGS.checks - pairings0,
            "global_write_e2e_p99": ((js.get("e2e") or {}).get("write")
                                     or {}).get("p99"),
            "journey_hash": js["journey_hash"],
            "shed_hash": origin.shed_hash(),
            "ordered_hash": pool.ordered_hash(),
            "replies_hash": _digest([dataclasses.astuple(r)
                                     for r in replicated + served]),
            "wall_s": wall}


def run_geo_w(device):
    """``bench.py``'s ``bench_geo``: phase A's ordering arms (n=6, regions
    0 and 3) and laned barrier arms, phase B's edge and no-edge arms."""
    t0 = time.perf_counter()
    phase_a = {
        "ordering": {"off": _geo_ordering_arm(device, 0),
                     "on": _geo_ordering_arm(device, 3)},
        "barrier": {"off": _geo_barrier_arm(device, 0),
                    "on": _geo_barrier_arm(device, 3)}}
    phase_b = {"edges": _geo_edge_arm(device, True),
               "no_edges": _geo_edge_arm(device, False)}
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    return {"phase_a": phase_a, "phase_b": phase_b,
            "wall_s": time.perf_counter() - t0}



def check_geo(rec):
    """``bench_geo``'s laws: WAN costs virtual time on the ordering and
    barrier arms; >= 90% edge hits at the intra-region p99 with zero
    pairings on the edge serve path; the no-edge arm pays the WAN band;
    the edge tier moves no write-plane bit."""
    from indy_plenum_tpu_torch.config import getConfig

    a, b = rec["phase_a"], rec["phase_b"]
    if not (a["ordering"]["on"]["order_48_sim_s"]
            > a["ordering"]["off"]["order_48_sim_s"]
            and a["barrier"]["on"]["seal_32_sim_s"]
            > a["barrier"]["off"]["seal_32_sim_s"]
            and a["ordering"]["on"]["cross_region_msgs"] > 0):
        raise AssertionError(f"phase W: WAN cost no virtual time: {a}")
    fb = b["edges"]["fabric"]
    if fb["edge_hit_rate"] < 0.90 or fb["edge_serve_pairings"] != 0 \
            or any(blk["latency_p99"] > W_INTRA_HI
                   for blk in fb["regions"].values()):
        raise AssertionError(f"phase W: edge tier {fb}")
    wan_floor = getConfig().RegionWanMinLatency
    nb = b["no_edges"]["fabric"]
    if any(nb["regions"][r]["latency_p99"] < wan_floor for r in ("1", "2")):
        raise AssertionError(f"phase W: no-edge arm below WAN: {nb}")
    for key in ("ordered_hash", "journey_hash", "shed_hash"):
        if b["edges"][key] != b["no_edges"][key]:
            raise AssertionError(f"phase W: the edge tier moved {key}")


def _geo_record(rec):
    """What the card and the CPU must share: everything but walls."""
    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items() if k != "wall_s"}
        return obj

    return strip(rec)


def twin_chaos(name):
    t0 = time.perf_counter()
    with plain_dispatches() as counted:
        _, record, wall, recover = run_chaos_x("cpu", name)
    return (record, wall, recover, dict(counted)), \
        time.perf_counter() - t0


def _twin(jobs, key):
    """A CPU twin's result and its seconds, waiting for it if it is
    still running; ``wait_s`` is how long the card's timeline waited."""
    t0 = time.perf_counter()
    out, seconds = jobs[key].result()
    return out, seconds, time.perf_counter() - t0


def card_x_new(on_card, card):
    """Phase X's arms of the workload planes (``X_NEW_ARMS``) on the card;
    ``check_x_new`` holds them against their CPU twins."""
    runs = {}
    for name in X_NEW_ARMS:
        t0 = time.perf_counter()
        runs[name] = on_card(f"chaos_{name}", run_chaos_x, None, name)
        _line("chaos_x_card", arm=name, phase_s=time.perf_counter() - t0,
              card=card)
    return runs


def check_x_new(runs, card, jobs):
    """Each workload arm of phase X against its CPU twin: equal reports
    and K7 / K8 launches equal to the dispatches the CPU run counted."""
    t0 = time.perf_counter()
    chaos_x = {}
    for name in X_NEW_ARMS:
        (report, record, wall, recover), x_launches, _ = runs[name]
        (cpu_record, cpu_wall, _, counted), cpu_s, wait_s = _twin(
            jobs, f"x_{name}")
        diff = sorted(k for k in record if record[k] != cpu_record[k])
        if diff:
            raise AssertionError(f"phase X {name}: card and CPU reports "
                                 f"differ on {diff}")
        if report.failed or not report.verdict_as_expected:
            raise AssertionError(f"phase X {name}: {report.invariants}")
        if any(x_launches[k] != n for k, n in counted.items()):
            raise AssertionError(f"phase X {name}: launches {x_launches} "
                                 f"against the CPU's {counted}")
        chaos_x[name] = {
            "wall_s": wall, "cpu_wall_s": cpu_wall, "cpu_twin_s": cpu_s,
            "twin_wait_s": wait_s, "recover_sim_s": recover,
            "virtual_seconds": report.virtual_seconds,
            "quorum_step": x_launches["quorum_step"],
            "window_slide": x_launches["window_slide"],
            "window_zero": x_launches["window_zero"]}
        _line("chaos_x", arm=name, **chaos_x[name],
              invariants={r["name"]: r["verdict"]
                          for r in report.invariants},
              txns_leeched=report.catchup.get("txns_leeched"),
              lanes=report.lanes or None,
              ingress={k: v for k, v in (report.ingress or {}).items()
                       if k in ("admission", "retry", "shed_hash",
                                "retry_hash", "seeder_throttle")} or None,
              edge=report.edge or None,
              trace_hash=report.trace_hash, launches=x_launches,
              cpu_counted=counted, card=card)
    _line("chaos_x_new_summary", check_s=time.perf_counter() - t0,
          card=card)
    return chaos_x


def card_o(on_card, card):
    """Phase O's open-loop and closed-loop arms on the card."""
    t0 = time.perf_counter()
    runs = {}
    for retry in (False, True):
        tag = "overload_o_retry" if retry else "overload_o_open"
        runs[retry] = on_card(tag, run_overload_o, None, retry)
    _line("overload_o_card", phase_s=time.perf_counter() - t0, card=card)
    return runs


def check_o(runs, card, jobs):
    """Phase O: each arm equal to its CPU twin on every fingerprint and
    count; sheds, verified reads and (closed loop) re-offers."""
    t0 = time.perf_counter()
    arms = {}
    for retry in (False, True):
        res, o_launches, _ = runs[retry]
        cpu, cpu_s, wait_s = _twin(jobs, f"o_{retry}")
        diff = [k for k in O_COMPARE if res[k] != cpu[k]]
        if diff:
            raise AssertionError(f"phase O retry={retry}: card and CPU "
                                 f"differ on {diff}")
        if res["admission"]["shed"] <= 0 or res["reads_verified"] <= 0 \
                or (retry and res["retries"]["reoffers"] <= 0):
            raise AssertionError(f"phase O retry={retry}: {res}")
        arms[retry] = res
        _line("overload_o", **res, launches=o_launches,
              cpu_wall_s=cpu["wall_s"], cpu_twin_s=cpu_s,
              twin_wait_s=wait_s, card=card)
    closed, open_ = arms[True], arms[False]
    summary = {
        "goodput_open": open_["ordered"], "goodput_retry": closed["ordered"],
        "goodput_per_sim_s_retry": closed["goodput_per_sim_s"],
        "first_attempt_admitted": closed["first_attempt_admitted"],
        "retry_admitted": closed["retry_admitted"],
        "post_spike_rate_retry": closed["post_spike_rate"],
        "post_spike_rate_open": open_["post_spike_rate"],
        "recovery_ratio_retry": closed["recovery_ratio"],
        "wall_s": {"open": open_["wall_s"], "retry": closed["wall_s"]},
        "check_s": time.perf_counter() - t0}
    _line("overload_o_summary", **summary, card=card)
    return summary


N_TWO_LANE_BEFORE_S = 700.0  # run the 2-lane arm only before this clock


def card_n(on_card, card, t_start):
    """Phase N's arms of 1 and 4 lanes on the card, and 2 lanes while the
    smoke's clock allows."""
    t0 = time.perf_counter()
    runs = {}
    for lanes in N_ARMS:
        if lanes == 2 and time.perf_counter() - t_start \
                > N_TWO_LANE_BEFORE_S:
            _line("laned_n", lanes=2, skipped="the smoke's clock",
                  clock_s=time.perf_counter() - t_start, card=card)
            continue
        runs[lanes] = on_card(f"laned_n_{lanes}", run_laned_n, None, lanes)
    _line("laned_n_card", phase_s=time.perf_counter() - t0, card=card)
    return runs


def check_n(runs, card, jobs):
    """Phase N: ``bench_lanes``' laws (4 lanes >= 3.0x one lane in virtual
    time, every journey whole, with its lane and barrier hop) and the
    4-lane arm equal to its CPU twin."""
    t0 = time.perf_counter()
    arms = {}
    for lanes, (res, n_launches, _) in runs.items():
        check_laned_arm(res)
        arms[lanes] = res
        extra = {}
        if lanes == 4:
            cpu, cpu_s, wait_s = _twin(jobs, "n_4")
            diff = [k for k in N_COMPARE if res[k] != cpu[k]]
            if diff:
                raise AssertionError(f"phase N 4 lanes: card and CPU "
                                     f"differ on {diff}")
            extra = {"cpu_wall_s": cpu["wall_s"], "cpu_twin_s": cpu_s,
                     "twin_wait_s": wait_s}
        _line("laned_n", **res, launches=n_launches, **extra, card=card)
    speedup_4 = arms[4]["ordered_per_sim_sec"] / \
        arms[1]["ordered_per_sim_sec"]
    if speedup_4 < 3.0:
        raise AssertionError(f"phase N: 4 lanes {speedup_4:.3f}x one lane")
    summary = {
        "ordered_per_sim_sec": {str(k): a["ordered_per_sim_sec"]
                                for k, a in arms.items()},
        "ordered_per_wall_sec": {str(k): a["ordered_per_wall_sec"]
                                 for k, a in arms.items()},
        "speedup_4_lanes": speedup_4,
        "wall_s": {str(k): a["wall_s"] for k, a in arms.items()},
        "check_s": time.perf_counter() - t0}
    _line("laned_n_summary", **summary, card=card)
    return summary


def card_s(on_card, card):
    """Phase S's day soak on the (4,) fabric on the card."""
    t0 = time.perf_counter()
    run = on_card("soak_s", run_soak_s, None, S_HOURS)
    _line("soak_s_card", phase_s=time.perf_counter() - t0, card=card)
    return run


def check_s(run, card, jobs):
    """Phase S: equal to its CPU twin on ``fingerprint``,
    ``telemetry_hash`` and the hourly tallies; flat high-water, no
    unexplained anomaly, both legs ok."""
    t0 = time.perf_counter()
    res, s_launches, _ = run
    cpu, cpu_s, wait_s = _twin(jobs, "s")
    diff = [k for k in S_COMPARE if res[k] != cpu[k]]
    if diff:
        raise AssertionError(f"phase S: card and CPU differ on {diff}")
    check_soak(res)
    keep = ("hours", "rate", "n_keys", "arrivals", "ordered_total",
            "hourly_ordered", "throughput_drift", "flat_high_water",
            "windows", "anomalies", "anomalies_unexplained", "chaos",
            "agree", "telemetry_hash", "fingerprint", "wall_s")
    summary = {k: res[k] for k in keep}
    summary.update(cpu_wall_s=cpu["wall_s"], cpu_twin_s=cpu_s,
                   twin_wait_s=wait_s, check_s=time.perf_counter() - t0)
    _line("soak_s", **summary, legs=S_LEGS, launches=s_launches, card=card)
    return summary


def card_w(on_card, card):
    """Phase W's ``bench_geo`` phases A and B on the card."""
    t0 = time.perf_counter()
    run = on_card("geo_w", run_geo_w, None)
    _line("geo_w_card", phase_s=time.perf_counter() - t0, card=card)
    return run


def check_w(run, card, jobs):
    """Phase W: ``bench_geo``'s laws, and every fingerprint and counter
    equal to the CPU twin's."""
    t0 = time.perf_counter()
    res, w_launches, _ = run
    check_geo(res)
    cpu, cpu_s, wait_s = _twin(jobs, "w")
    if _geo_record(res) != _geo_record(cpu):
        raise AssertionError("phase W: card and CPU differ")
    b = res["phase_b"]
    summary = {
        "order_48_sim_s": {k: a["order_48_sim_s"] for k, a in
                           res["phase_a"]["ordering"].items()},
        "view_change_sim_s": {k: a["view_change_sim_s"] for k, a in
                              res["phase_a"]["ordering"].items()},
        "seal_32_sim_s": {k: a["seal_32_sim_s"] for k, a in
                          res["phase_a"]["barrier"].items()},
        "edge_hit_rate": b["edges"]["fabric"]["edge_hit_rate"],
        "edge_serve_pairings": b["edges"]["fabric"]["edge_serve_pairings"],
        "edge_p99": max(blk["latency_p99"] for blk in
                        b["edges"]["fabric"]["regions"].values()),
        "wan_p99": max(b["no_edges"]["fabric"]["regions"][r]["latency_p99"]
                       for r in ("1", "2")),
        "reads_wall_s": {"edges": b["edges"]["wall_s"],
                         "no_edges": b["no_edges"]["wall_s"]},
        "wall_s": res["wall_s"], "cpu_wall_s": cpu["wall_s"],
        "cpu_twin_s": cpu_s, "twin_wait_s": wait_s,
        "check_s": time.perf_counter() - t0}
    _line("geo_w", **summary, fabric=b["edges"]["fabric"],
          launches=w_launches, card=card)
    return summary


# --- phase V: the deployed validator node ----------------------------------
#
# Real Nodes (``server/node.py``) in ``simulation/node_pool.NodePool``: a
# client's write enters the nodes it is sent to, is verified in each
# node's ingress drain (K-a, K-b, K-c), spreads by PROPAGATE to the f+1
# finalisation quorum, orders by 3PC on the grouped (node x instance)
# vote plane (K7 a tick, K8's slide at a stable checkpoint and its zero
# at a view change) and executes into every node's ledgers and SMT
# states (K11 under the "auto" law). Every arm runs traced, on the card
# and in a CPU twin, and the two records are held equal.

V1_NODES = 25  # BASELINE.json configs[1]: a 25-node pool, full RBFT
V1_SEED = 25
# configs[1]'s 10,000 pending client requests, cut for the smoke's clock:
# the CPU twin pays the plain Ed25519 verify in every node's drain
V1_BURSTS, V1_BURST = 3, 100
# the reference's batching defaults (Max3PCBatchSize 100, Max3PCBatchWait
# 0.25, CHK_FREQ 100, LOG_SIZE 300, PropagateBatchWait 0.1), tick-batched
V1_CONFIG = {"QuorumTickInterval": 0.05}
V1_READ_NODE = "node7"
# tests/test_byzantine_node.py:90, the "everything on" pool, with more
# writes than its 24 so that every member slides several times
V2A_SEED = 203
V2A_CONFIG = {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 4,
              "PropagateBatchWait": 0.05, "QuorumTickInterval": 0.05,
              "CHK_FREQ": 5, "LOG_SIZE": 15,
              "ThroughputWindowSize": 5, "ThroughputMinCnt": 4}
V2A_WRITES = 64
# tests/test_monitor_replicas.py:52, the throttled master (its instance-0
# PRE-PREPAREs held 60 s), on the device plane and tick-batched
V2B_SEED = 12
V2B_CONFIG = {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 2,
              "PropagateBatchWait": 0.05,
              "ThroughputWindowSize": 2, "ThroughputMinCnt": 4,
              "PerfCheckFreq": 2.0, "DELTA": 0.4,
              "ToleratePrimaryDisconnection": 10_000.0,
              "NewViewTimeout": 10_000.0, "QuorumTickInterval": 0.05}
V2B_WRITES = 16
V2B_DELAY = 60.0
V_SIM_BUDGET = 120.0  # virtual seconds a stage of an arm may take
V_COMPARE = ("ordered", "ordered_counts", "views", "primaries",
             "stable_checkpoints", "roots", "client", "replied",
             "degradation_votes", "monitor", "trace_hash", "flushes",
             "agree", "drains", "entries")


def node_record(pool, client=None, digests=()):
    """The fingerprint of a ``NodePool`` run that a card run and its CPU
    twin (or the port's pool and the reference's) must share: per node
    the ordered digests, view, primaries and stable checkpoint, every
    ledger's size and root and every state's committed head, the
    monitor's degradation votes and snapshot; the client's results; the
    trace without its dispatch category; the group's flushes."""
    def roots(nd):
        db = nd.boot.db
        out = {}
        for lid in sorted(db.ledger_ids):
            ledger, state = db.get_ledger(lid), db.get_state(lid)
            out[lid] = (ledger.size, ledger.root_hash.hex(),
                        state.committed_head_hash.hex()
                        if state is not None else None)
        return out

    nodes = pool.nodes
    results = [client.result(d) for d in digests] if client else []
    return {
        "ordered": [_digest(nd.ordered_digests) for nd in nodes],
        "ordered_counts": [len(nd.ordered_digests) for nd in nodes],
        "views": [nd.data.view_no for nd in nodes],
        "primaries": [list(nd.data.primaries) for nd in nodes],
        "stable_checkpoints": [nd.data.stable_checkpoint for nd in nodes],
        "roots": [roots(nd) for nd in nodes],
        "client": _digest(results),
        "replied": sum(r is not None for r in results),
        "degradation_votes": [nd.monitor.degradation_votes
                              for nd in nodes],
        "monitor": [nd.monitor.snapshot() for nd in nodes],
        "trace_hash": (pool.trace.trace_hash(exclude_cats=("dispatch",))
                       if pool.trace.enabled else None),
        "flushes": (pool.vote_group.flushes
                    if pool.vote_group is not None else 0),
        "agree": pool.honest_nodes_agree(),
    }


def _count_drains(nodes):
    """Count the nodes' device verifies (one a drain with an entry)."""
    counts = {"drains": 0, "entries": 0}
    for nd in nodes:
        verify = nd.authnr._verify_entries

        def counted(pks, msgs, sigs, verify=verify):
            counts["drains"] += 1
            counts["entries"] += len(pks)
            return verify(pks, msgs, sigs)

        nd.authnr._verify_entries = counted
    return counts


def _ordered_all(pool, target):
    return lambda: min(len(nd.ordered_digests) for nd in pool.nodes) \
        >= target


def run_node_v1(device, bursts=V1_BURSTS, burst=V1_BURST):
    """V1: ``BASELINE.json`` configs[1] through real Nodes. 25 nodes, f =
    8, f+1 = 9 instances (225 member planes in one grouped step), BLS,
    pool genesis, the reference's batching defaults on a 0.05 s tick; one
    client sends ``bursts`` bursts of ``burst`` signed NYMs to every node
    and each burst orders everywhere before the next; then one node
    serves a GET_NYM that the client verifies with the pool's BLS keys
    alone. The SMT commits run under the "auto" law from a fresh
    policy."""
    from indy_plenum_tpu_torch.common.constants import (
        GET_NYM,
        TARGET_NYM,
        TXN_TYPE,
    )
    from indy_plenum_tpu_torch.common.request import Request
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.node_pool import NodePool
    from indy_plenum_tpu_torch.state import sparse_merkle_state

    sparse_merkle_state._WAVE_OFFLOAD = None
    t0 = time.perf_counter()
    pool = NodePool(V1_NODES, seed=V1_SEED, config=getConfig(V1_CONFIG),
                    device_quorum=True, bls=True, num_instances=0,
                    with_pool_genesis=True, trace=True, device=device)
    build_s = time.perf_counter() - t0
    drains = _count_drains(pool.nodes)
    client = pool.make_client()
    digests = []
    sim0 = pool.timer.get_current_time()
    t0 = time.perf_counter()
    for _ in range(bursts):
        for _ in range(burst):
            digests.append(client.submit_write(pool.make_nym_request()))
        _sim_until(pool, _ordered_all(pool, len(digests)), V_SIM_BUDGET,
                   V1_CONFIG["QuorumTickInterval"], "phase V1")
    order_sim_s = pool.timer.get_current_time() - sim0
    order_wall_s = time.perf_counter() - t0
    pool.pump_client(client)
    dest = client.result(digests[-1])["txn"]["data"]["dest"]
    read = Request(identifier="reader", reqId=1, operation={
        TXN_TYPE: GET_NYM, TARGET_NYM: dest})
    rd = client.submit_read(read, to=V1_READ_NODE)
    pool.pump_client(client)
    proved = client.proved_reads.get(rd)
    rec = node_record(pool, client, digests)
    rec.update(
        nodes=V1_NODES, instances=pool.num_instances,
        member_planes=V1_NODES * pool.num_instances, writes=len(digests),
        read_dest=proved.get("dest") if proved else None,
        read_proved=proved is not None and proved.get("dest") == dest,
        ordered_txns_per_sim_s=len(digests) / order_sim_s,
        order_sim_s=order_sim_s, order_wall_s=order_wall_s,
        build_s=build_s, **drains)
    return rec


def run_node_v2a(device, writes=V2A_WRITES):
    """V2a: ``BASELINE.json`` configs[0], the 4-node local pool with
    everything on (``tests/test_byzantine_node.py:90``: BLS, f+1
    instances, pool genesis, the device plane on a 0.05 s tick, CHK_FREQ
    5, LOG_SIZE 15), ``writes`` signed NYMs from one client to every
    node; then a proved GET_NYM from node3."""
    from indy_plenum_tpu_torch.common.constants import (
        GET_NYM,
        TARGET_NYM,
        TXN_TYPE,
    )
    from indy_plenum_tpu_torch.common.request import Request
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.node_pool import NodePool

    t0 = time.perf_counter()
    pool = NodePool(4, seed=V2A_SEED, config=getConfig(V2A_CONFIG),
                    device_quorum=True, bls=True, num_instances=0,
                    with_pool_genesis=True, trace=True, device=device)
    drains = _count_drains(pool.nodes)
    client = pool.make_client()
    digests = [client.submit_write(pool.make_nym_request())
               for _ in range(writes)]
    _sim_until(pool, _ordered_all(pool, writes), V_SIM_BUDGET, 1.0,
               "phase V2a")
    pool.run_for(5.0)
    pool.pump_client(client)
    dest = client.result(digests[0])["txn"]["data"]["dest"]
    rd = client.submit_read(Request(identifier="reader", reqId=5000,
                                    operation={TXN_TYPE: GET_NYM,
                                               TARGET_NYM: dest}),
                            to="node3")
    pool.pump_client(client)
    rec = node_record(pool, client, digests)
    rec.update(writes=writes, read_proved=rd in client.proved_reads,
               backups=[len(nd.replicas.backups) for nd in pool.nodes],
               wall_s=time.perf_counter() - t0, **drains)
    return rec


def run_node_v2b(device, writes=V2B_WRITES):
    """V2b: the monitor arm (``tests/test_monitor_replicas.py:52``): n=4,
    f+1 instances, node0's instance-0 PRE-PREPAREs held ``V2B_DELAY``
    seconds, so the master primary is alive but slow; every node's
    monitor compares the master's throughput with the backup's and votes
    it out, the view change zeroes the members' planes, and the writes,
    each sent to one node as the reference's test sends them, order under
    the new master primary."""
    from indy_plenum_tpu_torch.common.messages.node_messages import (
        PrePrepare,
    )
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.node_pool import NodePool

    t0 = time.perf_counter()
    pool = NodePool(4, seed=V2B_SEED, config=getConfig(V2B_CONFIG),
                    num_instances=0, device_quorum=True, trace=True,
                    device=device)
    old_primary = pool.nodes[0].data.primaries[0]

    def throttle(msg, frm, to):
        if isinstance(msg, PrePrepare) and frm == old_primary \
                and msg.instId == 0:
            return V2B_DELAY
        return None

    pool.network.add_delayer(throttle)
    drains = _count_drains(pool.nodes)
    for i in range(writes):
        pool.submit_to(f"node{i % 4}", pool.make_nym_request())
    sim0 = pool.timer.get_current_time()
    _sim_until(pool, lambda: all(nd.data.view_no >= 1
                                 for nd in pool.nodes),
               V_SIM_BUDGET, 0.25, "phase V2b view change")
    voted_out_sim_s = pool.timer.get_current_time() - sim0
    _sim_until(pool, _ordered_all(pool, writes), V_SIM_BUDGET, 1.0,
               "phase V2b ordering")
    rec = node_record(pool)
    rec.update(writes=writes, old_primary=old_primary,
               new_primary=pool.nodes[1].data.primaries[0],
               voted_out_sim_s=voted_out_sim_s,
               wall_s=time.perf_counter() - t0, **drains)
    return rec


V_ARMS = (("V1", run_node_v1), ("V2a", run_node_v2a),
          ("V2b", run_node_v2b))


def twin_node(arm):
    """A phase V arm with ``device="cpu"``, counting the launches the
    card's K7 / K8 wrappers would make."""
    fn = dict(V_ARMS)[arm]
    t0 = time.perf_counter()
    with plain_dispatches() as counted:
        rec = fn("cpu")
    return (rec, dict(counted)), time.perf_counter() - t0


def card_v(on_card, card):
    """Phase V's arms on the card; ``check_v`` holds each against its CPU
    twin."""
    runs = {}
    for arm, fn in V_ARMS:
        t0 = time.perf_counter()
        runs[arm] = on_card(f"node_{arm}", fn, None)
        _line("node_v_card", arm=arm, phase_s=time.perf_counter() - t0,
              card=card)
    return runs


def _check_v_arm(arm, rec):
    """The arm's own claims, on the card's record."""
    writes = rec["writes"]
    n = len(rec["views"])
    if rec["ordered_counts"] != [writes] * n or not rec["agree"]:
        raise AssertionError(f"phase {arm}: ordered {rec['ordered_counts']}")
    if any(r != rec["roots"][0] for r in rec["roots"]):
        raise AssertionError(f"phase {arm}: the nodes' roots differ")
    if arm == "V1" and (rec["replied"] != writes or not rec["read_proved"]
                        or rec["member_planes"] != 225):
        raise AssertionError(f"phase V1: replies {rec['replied']}, proved "
                             f"read {rec['read_proved']}")
    if arm == "V2a" and (rec["replied"] != writes or not rec["read_proved"]
                         or min(rec["stable_checkpoints"]) < 15
                         or min(rec["backups"]) < 1):
        raise AssertionError(f"phase V2a: replies {rec['replied']}, "
                             f"stable {rec['stable_checkpoints']}")
    if arm == "V2b" and (min(rec["degradation_votes"]) <= 0
                         or min(rec["views"]) < 1
                         or rec["new_primary"] == rec["old_primary"]):
        raise AssertionError(f"phase V2b: votes {rec['degradation_votes']}, "
                             f"views {rec['views']}, primary "
                             f"{rec['new_primary']}")


def check_v(runs, card, jobs):
    """Phase V: each arm's claims on the card, its record equal to its
    CPU twin's on ``V_COMPARE``, K-a/K-b/K-c launched once a drain, and
    K7 / K8 launches equal to the dispatches the CPU run counted."""
    t0 = time.perf_counter()
    arms = {}
    for arm, _ in V_ARMS:
        rec, v_launches, wall = runs[arm]
        (cpu, counted), cpu_s, wait_s = _twin(jobs, f"v_{arm}")
        _check_v_arm(arm, rec)
        diff = [k for k in V_COMPARE if rec[k] != cpu[k]]
        if diff:
            raise AssertionError(f"phase {arm}: card and CPU differ on "
                                 f"{diff}")
        if any(v_launches[k] != rec["drains"] for k in (
                "sha512_blocks", "reduce_mod_l", "ed25519_verify")):
            raise AssertionError(f"phase {arm}: {rec['drains']} drains "
                                 f"made {v_launches}")
        if any(v_launches[k] != c for k, c in counted.items()) \
                or v_launches["quorum_step"] != rec["flushes"]:
            raise AssertionError(f"phase {arm}: launches {v_launches} "
                                 f"against the CPU's {counted}")
        keep = {k: v for k, v in rec.items()
                if k not in ("ordered", "primaries", "roots", "monitor",
                             "views", "ordered_counts",
                             "stable_checkpoints", "degradation_votes")}
        arms[arm] = dict(keep, wall_s=wall, cpu_twin_s=cpu_s,
                         twin_wait_s=wait_s,
                         launches={k: v_launches[k] for k in (
                             "sha512_blocks", "reduce_mod_l",
                             "ed25519_verify", "quorum_step",
                             "window_slide", "window_zero",
                             "merkle_node_hash")})
        _line("node_v", arm=arm, **arms[arm],
              views=sorted(set(rec["views"])),
              stable_checkpoints=sorted(set(rec["stable_checkpoints"])),
              degradation_votes=rec["degradation_votes"],
              primaries=rec["primaries"][0], cpu_counted=counted,
              card=card)
    _line("node_v_summary", check_s=time.perf_counter() - t0, card=card)
    return arms


# --- phase Y: a recorded node replayed on the card --------------------------
#
# ``recorder/``: node2 of a live NodePool is recorded (every message and
# client request it took in, on the virtual clock), the log is dumped to a
# file and loaded back, and replayed into a fresh Node built on a fresh
# MockTimer with ``ReplayNetwork`` (its sends go nowhere). The replay must
# order what the live node ordered, into the same domain ledger and state:
# a node is a function of its genesis, its config and its timed inputs.
# The replayed node's ingress drains run K-a, K-b and K-c; in Y2 its own
# standalone vote plane runs K7 each tick and K8's slide at each stable
# checkpoint.

Y_SEED = 82  # tests/test_metrics_recorder.py:72
Y1_WRITES = 30  # three 3PC batches at the default Max3PCBatchSize of 10
Y2_WRITES = 48  # twelve batches of 4 at CHK_FREQ 5: two stable checkpoints
Y_TAIL_S = 5.0  # virtual seconds the live pool runs on past its last order
Y_KERNELS = ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
             "quorum_step", "window_slide", "window_zero")
Y_PATH = {"Y1": ("sha512_blocks", "reduce_mod_l", "ed25519_verify"),
          "Y2": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
                 "quorum_step", "window_slide")}
Y_COMPARE = ("recording", "entries", "bytes", "writes", "ordered",
             "ordered_count", "domain_root", "state_head",
             "stable_checkpoint", "drains", "entries_verified", "launches")


def _replay_fingerprint(node):
    """What a replay must reproduce: the ordered digests, the domain
    ledger's root and the domain state's committed head."""
    from indy_plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID

    db = node.boot.db
    return {"ordered": _digest(node.ordered_digests),
            "ordered_count": len(node.ordered_digests),
            "domain_root": db.get_ledger(DOMAIN_LEDGER_ID).root_hash.hex(),
            "state_head": db.get_state(
                DOMAIN_LEDGER_ID).committed_head_hash.hex(),
            "stable_checkpoint": node.data.stable_checkpoint}


def run_replay_y(device, arm):
    """Phase Y, one arm. Y1 is the reference's recorder test
    (``tests/test_metrics_recorder.py:72``): ``NodePool(4, seed=82)`` on
    the host quorum, ``Y1_WRITES`` signed NYMs sent round-robin, one to a
    node. Y2 is phase V2a's pool (BLS, f+1 instances, pool genesis, the
    grouped plane on a 0.05 s tick, CHK_FREQ 5, LOG_SIZE 15) with
    ``Y2_WRITES`` writes from a client to every node, replayed into a
    node with a standalone ``DeviceVotePlane`` on the same device that
    ticks on the node's own timer. The recorder is attached to node2
    before the first write; the log goes through a file; the replay must
    give the live node2's fingerprint, or this raises. The replay's
    launches: on the card the launch counters' growth, on the CPU the
    dispatches ``plain_dispatches`` counts and one verify a drain."""
    import os
    import tempfile

    import torch

    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.recorder import Recorder, Replayer
    from indy_plenum_tpu_torch.recorder.recorder import ReplayNetwork
    from indy_plenum_tpu_torch.server.node import Node
    from indy_plenum_tpu_torch.simulation.mock_timer import MockTimer
    from indy_plenum_tpu_torch.simulation.node_pool import NodePool
    from indy_plenum_tpu_torch.tpu.vote_plane import DeviceVotePlane
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import resolve_device

    dev = resolve_device(device)
    t0 = time.perf_counter()
    if arm == "Y1":
        pool = NodePool(4, seed=Y_SEED, device=dev)
    else:
        pool = NodePool(4, seed=V2A_SEED, config=getConfig(V2A_CONFIG),
                        device_quorum=True, bls=True, num_instances=0,
                        with_pool_genesis=True, device=dev)
    start = pool.timer.get_current_time()
    recorder = Recorder()
    recorder.attach(pool.node("node2"))
    if arm == "Y1":
        writes = Y1_WRITES
        for i in range(writes):
            pool.submit_to(f"node{i % 4}", pool.make_nym_request())
    else:
        writes = Y2_WRITES
        client = pool.make_client()
        for _ in range(writes):
            client.submit_write(pool.make_nym_request())
    _sim_until(pool, _ordered_all(pool, writes), V_SIM_BUDGET, 1.0,
               f"phase {arm} live")
    pool.run_for(Y_TAIL_S)
    live = _replay_fingerprint(pool.node("node2"))
    live_sim_s = pool.timer.get_current_time() - start
    record_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "node2.rec")
        recorder.dump(path)
        with open(path, "rb") as fh:
            raw = fh.read()
        loaded = Recorder.load(path)
    if len(loaded.entries) != len(recorder.entries):
        raise AssertionError(f"phase {arm}: {len(recorder.entries)} entries "
                             f"recorded, {len(loaded.entries)} loaded")

    t0 = time.perf_counter()
    timer = MockTimer(start_time=start)
    extra = {}
    if arm == "Y2":
        config = pool.config
        extra = dict(
            vote_plane=DeviceVotePlane(
                list(pool.validators), log_size=config.LOG_SIZE,
                n_checkpoints=max(1, config.LOG_SIZE // config.CHK_FREQ),
                device=dev),
            bls_keys=pool.bls_keys, num_instances=0,
            pool_genesis=[dict(t) for t in pool.pool_genesis])
    fresh = Node("node2", list(pool.validators), timer, ReplayNetwork(),
                 config=pool.config,
                 domain_genesis=[dict(t) for t in pool._domain_genesis],
                 seed_keys=dict(pool._seed_keys), device=dev, **extra)
    drains = _count_drains([fresh])
    fresh.start()
    Replayer(loaded).replay_into(fresh, timer)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        before = kb.launch_counts()
        timer.advance(live_sim_s)
        torch.cuda.synchronize()
        after = kb.launch_counts()
        launches = {k: after[k] - before[k] for k in Y_KERNELS}
    else:
        with plain_dispatches() as counted:
            timer.advance(live_sim_s)
        launches = dict(counted, **{k: drains["drains"] for k in (
            "sha512_blocks", "reduce_mod_l", "ed25519_verify")})
    replay_s = time.perf_counter() - t0
    got = _replay_fingerprint(fresh)
    if got != live:
        raise AssertionError(f"phase {arm}: the replay gave {got}, the "
                             f"live node2 {live}")
    if live["ordered_count"] != writes:
        raise AssertionError(f"phase {arm}: node2 ordered "
                             f"{live['ordered_count']} of {writes}")
    missing = [k for k in Y_PATH[arm] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"phase {arm}: the replay never launched "
                             f"{missing}: {launches}")
    return dict(got, arm=arm, writes=writes, entries=len(recorder.entries),
                bytes=len(raw), recording=hashlib.sha256(raw).hexdigest(),
                drains=drains["drains"], entries_verified=drains["entries"],
                launches=launches, live_sim_s=live_sim_s, record_s=record_s,
                replay_s=replay_s)


Y_ARMS = ("Y1", "Y2")


def twin_replay(arm):
    """A phase Y arm with ``device="cpu"``."""
    return _timed(run_replay_y, "cpu", arm)


def card_y(on_card, card):
    """Phase Y's arms on the card; ``check_y`` holds each against its CPU
    twin."""
    runs = {}
    for arm in Y_ARMS:
        t0 = time.perf_counter()
        runs[arm] = on_card(f"replay_{arm}", run_replay_y, None, arm)
        _line("replay_y_card", arm=arm, phase_s=time.perf_counter() - t0,
              card=card)
    return runs


def check_y(runs, card, jobs):
    """Phase Y: each arm's record on the card equal to its CPU twin's on
    ``Y_COMPARE`` (the recorded file byte for byte, the replay's ordered
    digests, domain root and state head, its drains, and its launches
    against the CPU's counted dispatches and drains), and K-a/K-b/K-c
    launched once a drain of the replay."""
    t0 = time.perf_counter()
    arms = {}
    for arm in Y_ARMS:
        rec, y_launches, wall = runs[arm]
        cpu, cpu_s, wait_s = _twin(jobs, f"y_{arm}")
        diff = [k for k in Y_COMPARE if rec[k] != cpu[k]]
        if diff:
            raise AssertionError(f"phase {arm}: card and CPU differ on "
                                 f"{diff}: {[(rec[k], cpu[k]) for k in diff]}")
        if any(rec["launches"][k] != rec["drains"] for k in (
                "sha512_blocks", "reduce_mod_l", "ed25519_verify")):
            raise AssertionError(f"phase {arm}: {rec['drains']} drains "
                                 f"made {rec['launches']}")
        arms[arm] = {
            "entries": rec["entries"], "bytes": rec["bytes"],
            "ordered": rec["ordered_count"],
            "domain_root": rec["domain_root"][:16],
            "state_head": rec["state_head"][:16],
            "ordered_digests": rec["ordered"][:16],
            "stable_checkpoint": rec["stable_checkpoint"],
            "replay_launches": rec["launches"], "run_launches": y_launches,
            "drains": rec["drains"], "record_s": rec["record_s"],
            "replay_s": rec["replay_s"], "wall_s": wall,
            "cpu_record_s": cpu["record_s"], "cpu_replay_s": cpu["replay_s"],
            "cpu_twin_s": cpu_s, "twin_wait_s": wait_s}
    _line("Y", arms=arms, check_s=time.perf_counter() - t0, card=card)
    return arms


# --- phase Z: the deployed transport over real sockets -----------------------
#
# ``network/`` (the CurveZMQ ROUTER stack, the client-facing listener, the
# pool client), ``tools/`` (provisioning, ``build_node``, ``run_pool``,
# the ``python -m`` node runner) and ``cli/``. The pool runs on the wall
# clock: the primary stamps each 3PC batch with wall seconds (``ppTime``),
# and the socket timings decide what arrives before which timer fires, so
# no run on the CPU can equal a run on the card record for record. Phase
# Z therefore has no CPU twin. Its deterministic check is the recorder:
# node1 is recorded during Z1 and replayed into a fresh node on the card
# on a virtual timer, which must order what the live node1 ordered, into
# the same ledgers and state. Every node's ingress drain runs K-a, K-b and
# K-c; Z2's restarted node verifies its leeched slice with K10 indexed;
# the SMT commits run K11 where the "auto" law sends them to the card.
# Liveness waits use the reference's budget (``run_until(..., timeout=
# 30)``) and no check reads a duration.

Z_SEED = hashlib.sha256(b"chip-smoke-phase-z").digest()
Z_TIMEOUT = 30.0  # tests/test_client_socket.py's liveness budget
Z1_WRITES = 1000  # BASELINE.json configs[0]'s NYM write load, 100 in flight
Z_IN_FLIGHT = 100
Z1_READS = 16  # proved GET_NYMs of written NYMs, round-robin over nodes
Z2_FAST = {"Max3PCBatchWait": 0.05, "Max3PCBatchSize": 10,
           "PropagateBatchWait": 0.02, "ConsistencyProofsTimeout": 1.0,
           "CatchupTransactionsTimeout": 1.5}  # test_socket_membership.py
Z2_SEED = b"\x31" * 32  # tests/test_socket_membership.py's master seed
# txns the stopped node misses: one catchup slice of at least
# DEVICE_MIN_BATCH (32) proofs, so a fresh offload policy verifies it on
# the card (K10 indexed)
Z2_MISSED = 40
Z2_SCENARIOS = ("restart", "add_node", "rotate_key")
Z4_WRITES = 200
Z_PORT_LO = 24000  # below the ephemeral range, above the reference's


def _free_port_block(n, _next=[Z_PORT_LO]):
    """The first of ``n`` consecutive ports that a test bind finds free;
    successive calls move on, so a pool just closed lends no port to the
    next one."""
    import socket

    start = _next[0]
    while start + n < 32768:
        for port in range(start, start + n):
            with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
                try:
                    sock.bind(("127.0.0.1", port))
                except OSError:
                    start = port + 1
                    break
        else:
            _next[0] = start + n
            return start
    raise RuntimeError(f"no {n} free ports from {Z_PORT_LO}")


def _z_nym(trustee, tag, req_id, role=None):
    """A trustee-signed NYM for the DID seeded by ``tag``."""
    from indy_plenum_tpu_torch.common.constants import (
        NYM,
        ROLE,
        TARGET_NYM,
        TXN_TYPE,
        VERKEY,
    )
    from indy_plenum_tpu_torch.common.request import Request
    from indy_plenum_tpu_torch.crypto.signers import DidSigner

    target = DidSigner(hashlib.sha256(tag).digest())
    op = {TXN_TYPE: NYM, TARGET_NYM: target.identifier,
          VERKEY: target.verkey}
    if role is not None:
        op[ROLE] = role
    req = Request(identifier=trustee.identifier, reqId=req_id, operation=op)
    trustee.sign_request(req)
    return req, target


def _write_all(looper, client, reqs, in_flight=Z_IN_FLIGHT,
               stall=Z_TIMEOUT):
    """Submit ``reqs`` with at most ``in_flight`` outstanding, each to
    every node, until each has f+1 matching REPLYs; raises when no write
    completes for ``stall`` seconds or one is rejected. Returns the wall
    seconds from the first submit to the last result."""
    queue = list(reqs)
    pending = []
    t0 = time.perf_counter()
    while queue or pending:
        while queue and len(pending) < in_flight:
            pending.append(client.submit_write(queue.pop(0)))

        def progressed():
            return any(client.result(d) is not None
                       or client.is_rejected(d) for d in pending)

        if not looper.run_until(progressed, timeout=stall):
            raise AssertionError(f"no write completed in {stall} s; "
                                 f"{len(pending)} pending, {len(queue)} "
                                 f"queued")
        for digest in [d for d in pending
                       if client.result(d) is not None
                       or client.is_rejected(d)]:
            client.take_result(digest)  # raises on a rejected write
            pending.remove(digest)
    return time.perf_counter() - t0


def _socket_fingerprint(node):
    """Ordered digests, every ledger's root and the domain state's
    committed head of one node."""
    from indy_plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID

    db = node.boot.db
    return {"ordered": _digest(list(node.ordered_digests)),
            "ordered_count": len(node.ordered_digests),
            "ledger_roots": {str(lid): db.get_ledger(lid).root_hash.hex()
                             for lid in db.ledger_ids},
            "state_root": db.get_state(
                DOMAIN_LEDGER_ID).committed_head_hash.hex()}


def _bls_keys_of(directory, name):
    """The ``bls_keys`` ``tools.local_pool.build_node`` gives ``name``."""
    from indy_plenum_tpu_torch.bls.factory import generate_bls_keys
    from indy_plenum_tpu_torch.tools.local_pool import (
        load_pool_info,
        load_secret_seed,
    )

    info = load_pool_info(directory)
    own, _, _ = generate_bls_keys(
        load_secret_seed(directory, name, key="bls_seed"))
    return {peer: (own if peer == name else None, rec["bls_key"],
                   rec["bls_pop"]) for peer, rec in info["nodes"].items()}


def _genesis_of(directory):
    import os

    from indy_plenum_tpu_torch.ledger.genesis import load_genesis_file
    from indy_plenum_tpu_torch.tools.local_pool import (
        DOMAIN_GENESIS,
        POOL_GENESIS,
    )

    return (load_genesis_file(os.path.join(directory, POOL_GENESIS)),
            load_genesis_file(os.path.join(directory, DOMAIN_GENESIS)))


def _close_pool(looper, nodes, stacks, extra=()):
    looper.shutdown()
    for node in nodes:
        with contextlib.suppress(Exception):
            node.stop()
        surface = getattr(node, "client_surface", None)
        if surface is not None:
            with contextlib.suppress(Exception):
                surface.close()
    for stack in [*stacks, *extra]:
        with contextlib.suppress(Exception):
            stack.close()


def _all_handshaken(stacks, n):
    return lambda: all(sum(s.peer_states.values()) >= n - 1
                       for s in stacks)


def run_socket_z1(device, writes=Z1_WRITES, reads=Z1_READS):
    """Phase Z1: ``BASELINE.json`` configs[0], a provisioned 4-node pool
    (``generate_pool_config`` with a fixed master seed, free ports) run by
    ``run_pool`` on one Looper over CurveZMQ sockets, BLS on, and a
    socket client (``build_client``). After ``warm_verify_kernel``:
    ``writes`` trustee-signed NYMs, at most ``Z_IN_FLIGHT`` in flight,
    each with f+1 matching REPLYs; a forged signature REQNACKed by more
    than f nodes; ``reads`` proved GET_NYMs of written NYMs, each verified
    by the client against the pool's BLS keys alone; a VALIDATOR_INFO
    action answered by node1. Every node must order every write into equal
    ledgers and state, with no looper error and no rejected curve key.
    node1 is recorded from before the first write; its log goes through a
    file and is replayed into a fresh node on ``device`` on a MockTimer,
    which must give node1's ordered digests, ledger roots and state
    root."""
    import os
    import shutil
    import tempfile

    from indy_plenum_tpu_torch.common.constants import (
        GET_NYM,
        TARGET_NYM,
        TXN_TYPE,
        VALIDATOR_INFO,
    )
    from indy_plenum_tpu_torch.common.request import Request
    from indy_plenum_tpu_torch.common.serializers.serialization import \
        unpackb
    from indy_plenum_tpu_torch.crypto.signers import DidSigner
    from indy_plenum_tpu_torch.recorder import Recorder, Replayer
    from indy_plenum_tpu_torch.recorder.recorder import ReplayNetwork
    from indy_plenum_tpu_torch.server.node import Node
    from indy_plenum_tpu_torch.simulation.mock_timer import MockTimer
    from indy_plenum_tpu_torch.tools import build_client, \
        generate_pool_config
    from indy_plenum_tpu_torch.tools.local_pool import (
        load_pool_info,
        load_secret_seed,
        run_pool,
        warm_verify_kernel,
    )
    from indy_plenum_tpu_torch.utils.torch_env import resolve_device

    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="z1-pool-")
    generate_pool_config(tmp, n_nodes=4, base_port=_free_port_block(8),
                         master_seed=Z_SEED)
    validators = load_pool_info(tmp)["validators"]
    looper, nodes, stacks = run_pool(tmp, device=dev)
    client_stack = None
    try:
        trustee = DidSigner(load_secret_seed(tmp, "trustee"))
        client, client_stack = build_client(tmp, "z1-client")
        looper.add(client_stack)
        if not looper.run_until(_all_handshaken(stacks, 4), Z_TIMEOUT):
            raise AssertionError(f"phase Z1: handshakes pending: "
                                 f"{[s.peer_states for s in stacks]}")
        t0 = time.perf_counter()
        warm_verify_kernel(nodes[0], trustee)
        warm_s = time.perf_counter() - t0
        recorder = Recorder()
        start = looper.timer.get_current_time()
        recorder.attach(nodes[1])
        drains = _count_drains(nodes)
        reqs = [_z_nym(trustee, b"z1-nym-%d" % i, i + 1)[0]
                for i in range(writes)]
        write_s = _write_all(looper, client, reqs)
        if not looper.run_until(
                lambda: all(len(n.ordered_digests) >= writes
                            for n in nodes), Z_TIMEOUT):
            raise AssertionError(f"phase Z1: ordered "
                                 f"{[len(n.ordered_digests) for n in nodes]}"
                                 f" of {writes}")

        forged, _ = _z_nym(trustee, b"z1-forged", writes + 1)
        forged.operation["evil"] = True  # the signature no longer covers it
        fd = client.submit_write(forged)
        if not looper.run_until(lambda: client.is_rejected(fd), Z_TIMEOUT):
            raise AssertionError("phase Z1: the forged write was not "
                                 "REQNACKed by more than f nodes")
        nacks = dict(client.pending[fd].nacks)
        if client.result(fd) is not None \
                or not all("signature" in r for r in nacks.values()):
            raise AssertionError(f"phase Z1: forged write: {nacks}")

        step = max(1, writes // reads)
        read_digests = {}
        for i in range(reads):
            dest = reqs[i * step].operation[TARGET_NYM]
            read = Request(identifier="z1-reader", reqId=10_000 + i,
                           operation={TXN_TYPE: GET_NYM, TARGET_NYM: dest})
            read_digests[client.submit_read(
                read, to=validators[i % len(validators)])] = reqs[i * step]
        if not looper.run_until(
                lambda: all(client.result(d) is not None
                            for d in read_digests), Z_TIMEOUT):
            raise AssertionError("phase Z1: a proved read went unanswered")
        for digest, req in read_digests.items():
            res = client.proved_reads.get(digest)
            if res is None or res["dest"] != req.operation[TARGET_NYM] \
                    or unpackb(res["data"])["verkey"] != \
                    req.operation["verkey"]:
                raise AssertionError(f"phase Z1: proved read {res}")

        info = Request(identifier=trustee.identifier, reqId=writes + 2,
                       operation={TXN_TYPE: VALIDATOR_INFO,
                                  "timestamp": time.time()})
        trustee.sign_request(info)
        vd = client.submit_action(info, to="node1")
        if not looper.run_until(lambda: client.result(vd) is not None,
                                Z_TIMEOUT):
            raise AssertionError("phase Z1: VALIDATOR_INFO unanswered")
        status = client.result(vd)["data"]
        if status["name"] != "node1" or status["is_participating"] is not True:
            raise AssertionError(f"phase Z1: VALIDATOR_INFO {status}")

        prints = [_socket_fingerprint(n) for n in nodes]
        same = {k: len({json.dumps(p[k]) for p in prints})
                for k in ("ordered", "ledger_roots", "state_root")}
        if any(v != 1 for v in same.values()):
            raise AssertionError(f"phase Z1: the nodes differ: {prints}")
        live = prints[1]
        live_s = looper.timer.get_current_time() - start
        rejected = sum(s.rejected_unknown_key for s in stacks)
        if looper.errors or rejected:
            raise AssertionError(f"phase Z1: {looper.errors} looper errors,"
                                 f" {rejected} rejected curve keys")
        dropped = sum(s.dropped for s in stacks)

        path = os.path.join(tmp, "node1.rec")
        recorder.dump(path)
        loaded = Recorder.load(path)
        pool_genesis, domain_genesis = _genesis_of(tmp)
        t0 = time.perf_counter()
        timer = MockTimer(start_time=start)
        fresh = Node("node1", list(validators), timer, ReplayNetwork(),
                     config=nodes[1].config, pool_genesis=pool_genesis,
                     domain_genesis=domain_genesis,
                     seed_keys={load_pool_info(tmp)["trustee_did"]:
                                load_pool_info(tmp)["trustee_verkey"]},
                     bls_keys=_bls_keys_of(tmp, "node1"), device=dev)
        fresh.start()
        Replayer(loaded).replay_into(fresh, timer)
        timer.advance(live_s)
        replay_s = time.perf_counter() - t0
        got = _socket_fingerprint(fresh)
        if got != live:
            raise AssertionError(f"phase Z1: the replay gave {got}, the "
                                 f"live node1 {live}")
        return {"writes": writes, "ordered": live["ordered_count"],
                "ordered_writes_per_wall_s": writes / write_s,
                "write_s": write_s, "warm_s": warm_s, "reads": reads,
                "forged_nacks": len(nacks), "dropped": dropped,
                "looper_errors": looper.errors,
                "rejected_unknown_key": rejected,
                "drains": drains["drains"],
                "entries_verified": drains["entries"],
                "recorded_entries": len(recorder.entries),
                "replay_s": replay_s, "replay_equal": True,
                "domain_root": live["ledger_roots"]["1"][:16],
                "state_root": live["state_root"][:16]}
    finally:
        _close_pool(looper, nodes, stacks,
                    [client_stack] if client_stack is not None else [])
        shutil.rmtree(tmp, ignore_errors=True)


def _z2_order(looper, nodes, trustee, tag, req_id, entry=0):
    """One write into ``nodes[entry]``; every node orders one more."""
    req, _ = _z_nym(trustee, tag, req_id)
    want = {n.name: len(n.ordered_digests) + 1 for n in nodes}
    nodes[entry].submit_client_request(req, client_id="cli")
    if not looper.run_until(
            lambda: all(len(n.ordered_digests) >= want[n.name]
                        for n in nodes), Z_TIMEOUT):
        raise AssertionError(f"phase Z2: ordered "
                             f"{[len(n.ordered_digests) for n in nodes]}")
    return req


def _z2_domain(node):
    from indy_plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID

    ledger = node.boot.db.get_ledger(DOMAIN_LEDGER_ID)
    return ledger.size, ledger.root_hash.hex()


def _z2_stack(directory, name, seed, config, bind_port=0):
    """A validator built by hand over its own stack (the joining or
    rotated node of tests/test_socket_membership.py)."""
    from indy_plenum_tpu_torch.network import ZStack
    from indy_plenum_tpu_torch.tools.local_pool import load_pool_info

    info = load_pool_info(directory)
    stack = ZStack(name, seed, bind_port=bind_port,
                   max_batch=config.OUTGOING_BATCH_SIZE,
                   msg_len_limit=config.MSG_LEN_LIMIT)
    for peer, rec in info["nodes"].items():
        if peer == name:
            continue
        key = rec["transport_public"].encode()
        stack.allow_peer(peer, key)
        stack.connect(peer, (rec["node_ip"], rec["node_port"]), key)
    return stack, info


def run_membership_z2(device, scenario, missed=Z2_MISSED):
    """Phase Z2, one scenario of ``tests/test_socket_membership.py`` on a
    provisioned 4-node pool (the test's master seed and config, free
    ports) over sockets: ``restart`` (node3 frozen while ``missed`` writes
    order, then back through catchup, its leeched slice verified from a
    fresh offload policy: K10 indexed on the card), ``add_node`` (a
    steward NYM, then a steward-signed NODE txn adds node4, which catches
    up and orders with the pool) and ``rotate_key`` (node3 down, a NODE
    txn rotates its transport key, every survivor restarts that
    connection and drops the old key, node3 rejoins under the new key).
    Each ends with one more write ordered by every member and every
    member's domain ledger root equal. Returns the sizes, the root and the
    sizes of the catchup slices verified."""
    import os
    import shutil
    import tempfile

    from indy_plenum_tpu_torch.bls.factory import generate_bls_keys
    from indy_plenum_tpu_torch.common.constants import (
        ALIAS,
        BLS_KEY,
        BLS_KEY_PROOF,
        NODE,
        NODE_IP,
        NODE_PORT,
        SERVICES,
        STEWARD,
        TARGET_NYM,
        TRANSPORT_VERKEY,
        TXN_TYPE,
        VALIDATOR,
    )
    from indy_plenum_tpu_torch.common.request import Request
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.crypto.signers import DidSigner
    from indy_plenum_tpu_torch.network import ZStackNetwork
    from indy_plenum_tpu_torch.network.keys import curve_keypair_from_seed
    from indy_plenum_tpu_torch.server.catchup import catchup_rep_service \
        as crs
    from indy_plenum_tpu_torch.server.node import Node
    from indy_plenum_tpu_torch.tools import generate_pool_config
    from indy_plenum_tpu_torch.tools.local_pool import (
        load_pool_info,
        load_secret_seed,
        run_pool,
        warm_verify_kernel,
    )
    from indy_plenum_tpu_torch.utils.torch_env import resolve_device

    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="z2-pool-")
    generate_pool_config(tmp, n_nodes=4, base_port=_free_port_block(8),
                         master_seed=Z2_SEED)
    config = getConfig(dict(Z2_FAST))
    looper, nodes, stacks = run_pool(tmp, config=config, device=dev)
    extra_nodes, extra_stacks = [], []
    slices = []
    dispatch = crs.dispatch_audit_paths_batch

    def counted(leaf_data, *args, **kw):
        slices.append(len(leaf_data))
        return dispatch(leaf_data, *args, **kw)

    crs.dispatch_audit_paths_batch = counted
    try:
        trustee = DidSigner(load_secret_seed(tmp, "trustee"))
        warm_verify_kernel(nodes[0], trustee)
        _z2_order(looper, nodes, trustee, b"z2-%s-0" % scenario.encode(), 1)
        members = list(nodes)
        if scenario == "restart":
            behind, behind_stack = nodes[3], stacks[3]
            looper.remove(behind_stack)  # the process freezes
            live = nodes[:3]
            for i in range(missed):
                req, _ = _z_nym(trustee, b"z2-restart-%d" % i, i + 2)
                live[0].submit_client_request(req, client_id="cli")
            if not looper.run_until(
                    lambda: all(len(n.ordered_digests) >= missed + 1
                                for n in live), Z_TIMEOUT):
                raise AssertionError("phase Z2 restart: the live nodes "
                                     "did not order the missed writes")
            if _z2_domain(behind)[0] >= _z2_domain(live[0])[0]:
                raise AssertionError("phase Z2 restart: node3 not behind")
            # a fresh offload policy, as a restarted process has it
            crs.OFFLOAD_POLICY = crs._AdaptiveOffload()
            looper.add(behind_stack)
            behind.leecher.start()
            if not looper.run_until(
                    lambda: behind.leecher.catchups_completed >= 1
                    and _z2_domain(behind) == _z2_domain(live[0]),
                    Z_TIMEOUT):
                raise AssertionError(f"phase Z2 restart: "
                                     f"{_z2_domain(behind)} against "
                                     f"{_z2_domain(live[0])}")
            tail_entry = 0
        elif scenario == "add_node":
            node4_seed = hashlib.sha256(b"membership-node4-seed").digest()
            node4_public, _ = curve_keypair_from_seed(node4_seed)
            kp4, bls_pk4, bls_pop4 = generate_bls_keys(
                hashlib.sha256(b"membership-node4-bls").digest())
            stack4, info = _z2_stack(tmp, "node4", node4_seed, config)
            extra_stacks.append(stack4)
            req_steward, steward4 = _z_nym(trustee, b"z2-steward4", 2,
                                           role=STEWARD)
            nodes[1].submit_client_request(req_steward, client_id="cli")
            if not looper.run_until(
                    lambda: all(n.get_nym_data(steward4.identifier)
                                is not None for n in nodes), Z_TIMEOUT):
                raise AssertionError("phase Z2 add_node: steward NYM")
            node_txn = Request(
                identifier=steward4.identifier, reqId=1,
                operation={TXN_TYPE: NODE, TARGET_NYM: "nym-node4",
                           "data": {ALIAS: "node4",
                                    NODE_IP: stack4.ha[0],
                                    NODE_PORT: stack4.ha[1],
                                    SERVICES: [VALIDATOR],
                                    BLS_KEY: bls_pk4,
                                    BLS_KEY_PROOF: bls_pop4,
                                    TRANSPORT_VERKEY: node4_public.decode()}})
            steward4.sign_request(node_txn)
            nodes[2].submit_client_request(node_txn, client_id="cli")
            if not looper.run_until(
                    lambda: all(len(n.data.validators) == 5 for n in nodes),
                    Z_TIMEOUT):
                raise AssertionError("phase Z2 add_node: NODE txn")
            if not all(n.data.quorums.n == 5 for n in nodes) \
                    or not all("node4" in s.connected_peers
                               for s in stacks):
                raise AssertionError("phase Z2 add_node: quorums or "
                                     "transports not extended")
            net4 = ZStackNetwork(stack4)
            pool_genesis, domain_genesis = _genesis_of(tmp)
            bls_keys = {peer: (None, rec["bls_key"], rec["bls_pop"])
                        for peer, rec in info["nodes"].items()}
            bls_keys["node4"] = (kp4, bls_pk4, bls_pop4)
            node4 = Node("node4", list(info["validators"]), looper.timer,
                         net4, config=config, pool_genesis=pool_genesis,
                         domain_genesis=domain_genesis,
                         seed_keys={info["trustee_did"]:
                                    info["trustee_verkey"]},
                         bls_keys=bls_keys, device=dev)
            extra_nodes.append(node4)
            net4.mark_connected(set(info["validators"]))
            node4.on_membership_changed_hook = net4.membership_hook
            node4.start()
            looper.add(stack4)
            node4.leecher.start()
            if not looper.run_until(
                    lambda: node4.leecher.catchups_completed >= 1
                    and len(node4.data.validators) == 5, Z_TIMEOUT):
                raise AssertionError("phase Z2 add_node: node4 catchup")
            if _z2_domain(node4) != _z2_domain(nodes[0]):
                raise AssertionError("phase Z2 add_node: node4's root")
            members = nodes + [node4]
            tail_entry = 2
        elif scenario == "rotate_key":
            victim, victim_stack = nodes[3], stacks[3]
            old_key = victim_stack.public_key
            port = load_pool_info(tmp)["nodes"]["node3"]["node_port"]
            looper.remove(victim_stack)
            looper.remove(victim.client_surface)
            victim.stop()
            victim_stack.close()
            victim.client_surface.close()
            new_seed = hashlib.sha256(b"node3-rotated-seed").digest()
            new_public, _ = curve_keypair_from_seed(new_seed)
            steward3 = DidSigner(hashlib.sha256(Z2_SEED + b"steward-3")
                                 .digest())
            rotate = Request(
                identifier=steward3.identifier, reqId=1,
                operation={TXN_TYPE: NODE, TARGET_NYM: "nym-node3",
                           "data": {ALIAS: "node3",
                                    TRANSPORT_VERKEY: new_public.decode()}})
            steward3.sign_request(rotate)
            survivors, survivor_stacks = nodes[:3], stacks[:3]
            nodes[0].submit_client_request(rotate, client_id="cli")
            if not looper.run_until(
                    lambda: all(s._allowed.get(new_public) == "node3"
                                for s in survivor_stacks), Z_TIMEOUT):
                raise AssertionError("phase Z2 rotate_key: new key not "
                                     "admitted")
            if any(old_key in s._allowed for s in survivor_stacks):
                raise AssertionError("phase Z2 rotate_key: old key kept")
            new_stack, info = _z2_stack(tmp, "node3", new_seed, config,
                                        bind_port=port)
            extra_stacks.append(new_stack)
            net3 = ZStackNetwork(new_stack)
            pool_genesis, domain_genesis = _genesis_of(tmp)
            node3 = Node("node3", list(info["validators"]), looper.timer,
                         net3, config=config, pool_genesis=pool_genesis,
                         domain_genesis=domain_genesis,
                         seed_keys={info["trustee_did"]:
                                    info["trustee_verkey"]},
                         bls_keys=_bls_keys_of(tmp, "node3"), device=dev)
            extra_nodes.append(node3)
            net3.mark_connected(set(info["validators"]) - {"node3"})
            node3.on_membership_changed_hook = net3.membership_hook
            node3.start()
            looper.add(new_stack)
            node3.leecher.start()
            if not looper.run_until(
                    lambda: node3.leecher.catchups_completed >= 1
                    and _z2_domain(node3)[0] == _z2_domain(nodes[0])[0],
                    Z_TIMEOUT):
                raise AssertionError("phase Z2 rotate_key: node3 catchup")
            members = survivors + [node3]
            tail_entry = 0
        else:
            raise ValueError(scenario)
        _z2_order(looper, members, trustee,
                  b"z2-%s-tail" % scenario.encode(), 70, entry=tail_entry)
        domains = {n.name: _z2_domain(n) for n in members}
        if len(set(domains.values())) != 1:
            raise AssertionError(f"phase Z2 {scenario}: {domains}")
        if looper.errors:
            raise AssertionError(f"phase Z2 {scenario}: {looper.errors} "
                                 f"looper errors")
        size, root = domains[members[0].name]
        return {"scenario": scenario, "members": len(members),
                "domain_size": size, "domain_root": root[:16],
                "audit_slices": slices, "looper_errors": looper.errors}
    finally:
        crs.dispatch_audit_paths_batch = dispatch
        _close_pool(looper, nodes + extra_nodes, stacks, extra_stacks)
        shutil.rmtree(tmp, ignore_errors=True)


# the scripted session of tests/test_cli.py, with ``start pool`` on a
# directory provisioned on free ports (``new pool`` provisions at 9700)
Z3_CHECKS = ("pool of 4 provisioned", "4 validators up", "NYM alice ->",
             "(f+1 quorum)", "NYM alice: dest=", "(proved read)",
             "unknown alias 'nobody'", "unknown command", "pool stopped")


def run_cli_z3(device):
    """Phase Z3: the scripted session of ``tests/test_cli.py`` through the
    port's ``PoolCli`` on ``device``; its output checked as that test
    checks it. Returns the session's line count and the checks passed."""
    import io
    import os
    import shutil
    import tempfile

    from indy_plenum_tpu_torch.cli import PoolCli
    from indy_plenum_tpu_torch.tools import generate_pool_config

    tmp = tempfile.mkdtemp(prefix="z3-cli-")
    try:
        new_dir, run_dir = os.path.join(tmp, "new"), os.path.join(tmp, "run")
        generate_pool_config(run_dir, n_nodes=4,
                             base_port=_free_port_block(8))
        out = io.StringIO()
        cli = PoolCli(out=out, device=device)
        session = ["help", f"new pool {new_dir} 4", f"start pool {run_dir}",
                   "status", "send nym alice", "get nym alice",
                   "get nym nobody", "bogus command"]
        errors = []

        def lines():
            for line in session:
                yield line + "\n"
            errors.append(cli._looper.errors)  # before `exit` drops it
            yield "exit\n"

        cli.repl(stdin=lines())
        text = out.getvalue()
        missing = [c for c in Z3_CHECKS if c not in text]
        if missing or "error:" in text or errors != [0] \
                or not os.path.isfile(os.path.join(new_dir,
                                                   "pool_info.json")):
            raise AssertionError(f"phase Z3: missing {missing}, looper "
                                 f"errors {errors} in {text!r}")
        return {"lines": len(text.splitlines()), "checks": len(Z3_CHECKS),
                "looper_errors": errors[0],
                "text_sha256": hashlib.sha256(text.encode()).hexdigest()
                [:16]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _read_line(proc, timeout):
    """One stdout line of ``proc`` within ``timeout`` seconds, or None."""
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        if not sel.select(timeout):
            return None
        return proc.stdout.readline()
    finally:
        sel.close()


def _await_domain_sizes(looper, client, trustee, names, target, req_id):
    """Poll every node with VALIDATOR_INFO until its domain ledger holds
    ``target`` txns; returns the sizes, raises after ``Z_TIMEOUT``."""
    from indy_plenum_tpu_torch.common.constants import (
        TXN_TYPE,
        VALIDATOR_INFO,
    )
    from indy_plenum_tpu_torch.common.request import Request

    sizes = {name: 0 for name in names}
    deadline = time.monotonic() + Z_TIMEOUT
    while time.monotonic() < deadline:
        asked = {}
        for name in names:
            if sizes[name] >= target:
                continue
            info = Request(identifier=trustee.identifier, reqId=req_id,
                           operation={TXN_TYPE: VALIDATOR_INFO,
                                      "timestamp": time.time()})
            req_id += 1
            trustee.sign_request(info)
            asked[name] = client.submit_action(info, to=name)
        if not asked:
            return sizes
        looper.run_until(lambda: all(client.result(d) is not None
                                     for d in asked.values()),
                         max(0.0, deadline - time.monotonic()))
        for name, digest in asked.items():
            res = client.take_result(digest)
            if res is not None:
                sizes[name] = res["data"]["ledger_sizes"]["1"]
        if any(sizes[name] < target for name in names):
            looper.run_for(0.2)
    raise AssertionError(f"phase Z4: domain ledger sizes {sizes}, not "
                         f"{target}")


def _stop_nodes(procs):
    """SIGINT every node process; each must exit within ``Z_TIMEOUT``.
    Returns each one's exit code (None: killed) and its last stdout line
    parsed (the node's stop record)."""
    import signal

    for proc in procs.values():
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
    stops = {}
    for name, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=Z_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            stops[name] = {"rc": None, "record": None}
            continue
        last = out.strip().splitlines()[-1] if out.strip() else ""
        stops[name] = {"rc": proc.returncode,
                       "record": json.loads(last)
                       if last.startswith("{") else None}
    return stops


def run_processes_z4(device, writes=Z4_WRITES):
    """Phase Z4: the reference's deployment form. ``python -m
    indy_plenum_tpu_torch.tools.generate_pool`` provisions a directory
    (the phase's master seed, free ports); four ``python -m
    indy_plenum_tpu_torch.tools.start_node DIR nodeI`` processes run the
    validators (``--device cpu`` when ``device`` is "cpu"); a client in
    this process orders ``writes`` signed NYMs with f+1 replies and waits
    until every node's domain ledger holds them. Then every process gets
    SIGINT and must exit 0 within ``Z_TIMEOUT``, leaving its log under
    ``DIR/logs/``; each prints its ordered count, domain root and kernel
    launches, which are returned summed, with each node's."""
    import os
    import shutil
    import tempfile

    from indy_plenum_tpu_torch.common.looper import Looper
    from indy_plenum_tpu_torch.crypto.signers import DidSigner
    from indy_plenum_tpu_torch.tools import build_client
    from indy_plenum_tpu_torch.tools.local_pool import (
        load_pool_info,
        load_secret_seed,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="z4-pool-")
    extra = ["--device", "cpu"] if str(device) == "cpu" else []
    procs = {}
    try:
        gen = subprocess.run(
            [sys.executable, "-m",
             "indy_plenum_tpu_torch.tools.generate_pool", tmp, "4",
             str(_free_port_block(8)), Z_SEED.hex()],
            cwd=root, capture_output=True, text=True, timeout=120)
        if gen.returncode != 0:
            raise AssertionError(f"phase Z4: generate_pool: {gen.stderr}")
        names = load_pool_info(tmp)["validators"]
        looper = Looper()
        client_stack = None
        try:
            for name in names:
                with open(os.path.join(tmp, f"{name}.stderr"), "w") as err:
                    procs[name] = subprocess.Popen(
                        [sys.executable, "-m",
                         "indy_plenum_tpu_torch.tools.start_node", tmp,
                         name, *extra], cwd=root, stdout=subprocess.PIPE,
                        stderr=err, text=True)
            t0 = time.perf_counter()
            for name, proc in procs.items():
                line = _read_line(proc, 120.0)
                if not line or "listening" not in line:
                    raise AssertionError(f"phase Z4: {name} did not "
                                         f"start: {line!r}")
            start_s = time.perf_counter() - t0
            trustee = DidSigner(load_secret_seed(tmp, "trustee"))
            client, client_stack = build_client(tmp, "z4-client")
            looper.add(client_stack)
            reqs = [_z_nym(trustee, b"z4-nym-%d" % i, i + 1)[0]
                    for i in range(writes)]
            write_s = _write_all(looper, client, reqs)
            # f+1 replies leave up to f nodes still committing: ask each
            # node for its domain ledger's size before stopping it
            sizes = _await_domain_sizes(looper, client, trustee, names,
                                        5 + writes, writes + 1)
        finally:
            looper.shutdown()
            if client_stack is not None:
                client_stack.close()
            stops = _stop_nodes(procs)
        bad = {name: s for name, s in stops.items()
               if s["rc"] != 0 or s["record"] is None
               or not os.path.isfile(os.path.join(tmp, "logs",
                                                  f"{name}.log"))}
        if bad:
            stderr = {}
            for name in bad:
                with open(os.path.join(tmp, f"{name}.stderr")) as fh:
                    stderr[name] = fh.read()[-2000:]
            raise AssertionError(f"phase Z4: {bad} {stderr}")
        records = {name: s["record"] for name, s in stops.items()}
        if any(r["ordered"] < writes or r["looper_errors"]
               for r in records.values()) \
                or len({r["domain_root"] for r in records.values()}) != 1:
            raise AssertionError(f"phase Z4: {records}")
        launches = {}
        for rec in records.values():
            for k, v in rec["launches"].items():
                launches[k] = launches.get(k, 0) + v
        return {"writes": writes,
                "ordered": {n: r["ordered"] for n, r in records.items()},
                "domain_sizes": sizes,
                "domain_root": records[names[0]]["domain_root"][:16],
                "ordered_writes_per_wall_s": writes / write_s,
                "write_s": write_s, "start_s": start_s,
                "exit_codes": {n: s["rc"] for n, s in stops.items()},
                "node_launches": {n: {k: v for k, v in r["launches"].items()
                                      if v} for n, r in records.items()},
                "launches": launches}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


Z_PATH = ("sha512_blocks", "reduce_mod_l", "ed25519_verify")


def phase_z(on_card, card):
    """Phase Z on the card: Z1, Z2's three scenarios, Z3 and Z4, one line.
    Returns Z4's launches, made in the validator processes, for the
    kernels line (``on_card`` counts those of this process)."""
    import zmq

    t0 = time.perf_counter()
    version, curve = zmq.zmq_version(), bool(zmq.has("curve"))
    if not curve:
        raise AssertionError(f"phase Z: libzmq {version} has no CURVE")
    z1, z1_launches, z1_wall = on_card("socket_z1", run_socket_z1, None)
    z2 = {}
    for scenario in Z2_SCENARIOS:
        res, got, wall = on_card(f"socket_z2_{scenario}", run_membership_z2,
                                 None, scenario)
        z2[scenario] = dict(res, launches={k: v for k, v in got.items()
                                           if v}, wall_s=wall)
    if z2["restart"]["launches"].get("audit_paths_indexed", 0) < 1:
        raise AssertionError(f"phase Z2: K10 indexed never verified the "
                             f"restarted node's slice: {z2['restart']}")
    z3, z3_launches, z3_wall = on_card("socket_z3", run_cli_z3, None)
    t4 = time.perf_counter()
    z4 = run_processes_z4(None)
    z4_wall = time.perf_counter() - t4
    for name, got in z4["node_launches"].items():
        if any(got.get(k, 0) <= 0 for k in Z_PATH):
            raise AssertionError(f"phase Z4: {name} launched {got}")
    phase_s = time.perf_counter() - t0
    _line("Z", zmq_version=version, curve=curve,
          z1=dict(z1, launches={k: v for k, v in z1_launches.items() if v},
                  wall_s=z1_wall),
          z2=z2,
          z3=dict(z3, launches={k: v for k, v in z3_launches.items() if v},
                  wall_s=z3_wall),
          z4=dict(z4, wall_s=z4_wall), phase_s=phase_s, card=card)
    return z4["launches"], z1, z4, phase_s


# --- phase T: the operator entry points on the card ------------------------
#
# The port's ``python -m`` twins of ``scripts/`` and ``__graft_entry__.py``
# (``indy_plenum_tpu_torch/tools/``), each called through its ``main`` as a
# user's command line would, its stdout read back.

# T1: the gate suite at its defaults, these gates (the dispatch budget
# always runs); the ingress, overload, state and soak gates run in the full
# suite (utils/gate_suite.py, PERF.md), not in the smoke
T_GATES = ("sharded", "fabric", "trace", "readback", "residency", "latency",
           "catchup", "governor", "lanes", "proof", "geo")
# fields a gate builds from time.perf_counter (tests/torch_gates.py)
T_WALL_KEYS = {"wall_s", "wall_ratio", "per_root_64_s", "batch_64_s",
               "batch_speedup", "populate_s", "leeched_txns_per_wall_sec",
               "commits_per_sec", "elapsed_s"}
# T2: one chaos arc on the tick plane, and its replay command
T_CHAOS = ["--seed", "7", "--scenario", "f_crash_gc_catchup",
           "--device-quorum", "--tick", "0.05"]
# T3: the ingress tool at n=16, signed, a short window (two runs)
T_INGRESS = ["--nodes", "16", "--rate", "400", "--duration", "3",
             "--settle", "3", "--capacity", "16", "--read-fraction", "0.5",
             "--keys", "4096", "--seed", "7", "--json"]
T_TRACE_VIEWS = ([], ["--phases"], ["--critical-path"], ["--overlap"],
                 ["--rollups"], ["--journeys"], ["--json"])
# T4: the profiler's default pool (n=16, 6 instances) on four member tiles
# at depth 4, 960 txns after its warm-up batch
T_PROFILE = ["16", "6", "960", "--json", "--no-baseline", "--mesh", "4",
             "--resident-depth", "4"]
T_TILES = 4  # T5: dryrun_multichip's validator tiles


def _tool_main(tool, argv):
    """``tool.main(argv)`` with its stdout (and stderr) captured: (exit
    code, stdout)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool.main(list(argv))
    return rc, out.getvalue()


def _wall_sum(obj):
    """The ``wall_s`` fields of a gate's record, summed over its arms."""
    if isinstance(obj, dict):
        return sum(v if k == "wall_s" else _wall_sum(v)
                   for k, v in obj.items()
                   if k == "wall_s" or isinstance(v, (dict, list)))
    if isinstance(obj, list):
        return sum(_wall_sum(v) for v in obj)
    return 0.0


def _strip_wall(obj):
    if isinstance(obj, dict):
        return {k: _strip_wall(v) for k, v in obj.items()
                if k not in T_WALL_KEYS}
    if isinstance(obj, list):
        return [_strip_wall(v) for v in obj]
    return obj


def run_gates_t(device):
    """T1: ``tools.check_dispatch_budget --only T_GATES --json`` on
    ``device`` (``None``: the card); the record and its exit code."""
    from indy_plenum_tpu_torch.tools import check_dispatch_budget as cdb

    argv = ["--only", ",".join(T_GATES), "--json"]
    if device is not None:
        argv += ["--device", device]
    rc, out = _tool_main(cdb, argv)
    return rc, json.loads(out.strip().splitlines()[-1])


def twin_gates():
    t0 = time.perf_counter()
    return run_gates_t("cpu"), time.perf_counter() - t0


def _chaos_report(path):
    with open(path) as fh:
        rec = json.load(fh)
    for key in X_WALL_METRICS:
        rec["metrics"].pop(key, None)
    return rec


def run_chaos_t(device, workdir):
    """T2: ``tools.chaos_run`` on ``T_CHAOS`` in ``workdir`` (the default
    report file name); its exit code and report."""
    import os

    from indy_plenum_tpu_torch.tools import chaos_run

    argv = list(T_CHAOS) + (["--device", device] if device else [])
    here = os.getcwd()
    os.chdir(workdir)
    try:
        rc, out = _tool_main(chaos_run, argv)
    finally:
        os.chdir(here)
    report = os.path.join(workdir, "chaos_f_crash_gc_catchup_7.json")
    return rc, out, report


def run_ingress_t(device, trace_out=None):
    """T3: ``tools.ingress_run`` on ``device`` (``None``: the card); its
    JSON record."""
    from indy_plenum_tpu_torch.tools import ingress_run

    argv = list(T_INGRESS) + (["--trace-out", trace_out] if trace_out
                              else []) + (["--device", device] if device
                                          else [])
    rc, out = _tool_main(ingress_run, argv)
    if rc != 0:
        raise AssertionError(f"phase T3: ingress_run exited {rc}")
    return json.loads(out.strip().splitlines()[-1])


def _ingress_fields(rec):
    """T3's record without its walls (``*wall_s``) and ``read_qps``."""
    rec = {k: v for k, v in rec.items()
           if not k.endswith("wall_s") and k != "trace_file"}
    rec["reads"] = {k: v for k, v in rec["reads"].items()
                    if k != "read_qps"}
    return rec


def run_profile_t(device):
    """T4: ``tools.profile_rbft`` on ``T_PROFILE`` on ``device`` (``None``:
    the card); its JSON record and the first rows of the profile it prints
    sorted by own time (``tottime``)."""
    import io

    from indy_plenum_tpu_torch.tools import profile_rbft

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        profile_rbft.main(list(T_PROFILE) + (["--device", device] if device
                                             else []))
    text = err.getvalue()
    own = text[text.index("Ordered by: internal time"):].splitlines()
    head = next(i for i, line in enumerate(own) if "tottime" in line)
    rows = [" ".join(line.split()) for line in own[head + 1:head + 13]
            if line.strip()]
    return json.loads(out.getvalue().strip().splitlines()[-1]), rows


def run_graft_t(device):
    """T5: ``graft_entry.entry()`` on ``device`` (``None``: the card)
    against its plain version on the same inputs, and
    ``dryrun_multichip(T_TILES)`` against the step on one tile of the
    device and the CPU's dry run."""
    from indy_plenum_tpu_torch.tools import graft_entry as ge
    from indy_plenum_tpu_torch.tpu.step import fused_step

    fn, args = ge.entry(device)
    card = ge._step_record(*fn(*args))
    pfn, pargs = ge.entry("cpu")
    plain = ge._step_record(*pfn(*pargs))
    with contextlib.redirect_stdout(sys.stderr):
        dry = ge.dryrun_multichip(T_TILES, device)
        cpu_dry = ge.dryrun_multichip(T_TILES, "cpu")
    n_validators, one = ge.dryrun_inputs(T_TILES, device)
    one_tile = ge._step_record(*fused_step(*one, n_validators=n_validators,
                                           device=device))
    return card, plain, dry, cpu_dry, one_tile


def _records_equal(a, b):
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) if not isinstance(a[k], dict)
        else _records_equal(a[k], b[k]) for k in a)


def phase_t(on_card, card, jobs):
    """Phase T: T1-T5 on the card, one line each and a summary; returns
    the phase's launches (counted by ``on_card``) and its seconds."""
    import os
    import shlex
    import tempfile

    from indy_plenum_tpu_torch.tools import trace_tool

    t0 = time.perf_counter()
    t_launches = {}

    def counted(tag, fn, *args):
        out, got, wall = on_card(tag, fn, *args)
        for name, n in got.items():
            t_launches[name] = t_launches.get(name, 0) + n
        return out, got, wall

    # T1: the gates on the card, against the CPU twin of the same command
    (rc, gates), t1_launches, t1_wall = counted("gates_t1", run_gates_t,
                                                None)
    (cpu_rc, cpu_gates), cpu_s, wait_s = _twin(jobs, "t1")
    if rc != 0 or gates["verdict"] != "PASS":
        raise AssertionError(f"phase T1: {gates['verdict']}")
    a, b = _strip_wall(gates), _strip_wall(cpu_gates)
    diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
    if cpu_rc != rc or diff:
        raise AssertionError(f"phase T1: card and CPU gates differ on "
                             f"{diff}")
    _line("T1", gates=list(T_GATES), verdict=gates["verdict"],
          arm_wall_s={k: _wall_sum(v) for k, v in gates.items()
                       if k.endswith(("_gate", "_gates"))},
          dispatches_per_batch=gates["device_dispatches_per_ordered_batch"],
          sharded_dispatches_per_batch=gates["sharded_gate"][
              "mesh_sharded"]["device_dispatches_per_ordered_batch"],
          residency_dispatches_per_batch=gates["residency_gate"][
              "resident"]["device_dispatches_per_ordered_batch"],
          e2e_p99=gates["latency_gate"]["e2e"]["p99"],
          proof_batch_speedup=gates["proof_gate"]["batch_speedup"],
          wall_s=t1_wall, cpu_twin_s=cpu_s, twin_wait_s=wait_s,
          launches={k: v for k, v in t1_launches.items() if v}, card=card)

    # T2: a chaos arc through the CLI, then its replay command as a process
    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("card", "replay", "cpu"):
            os.mkdir(os.path.join(tmp, sub))
        (rc, text, path), t2_launches, t2_wall = counted(
            "chaos_t2", run_chaos_t, None, os.path.join(tmp, "card"))
        report = _chaos_report(path)
        command = report["replay_command"]
        if rc != 0 or not command.startswith(
                "python -m indy_plenum_tpu_torch.tools.chaos_run "):
            raise AssertionError(f"phase T2: exit {rc}, {command}")
        t_replay = time.perf_counter()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.run([sys.executable] + shlex.split(command)[1:],
                              cwd=os.path.join(tmp, "replay"), env=env,
                              capture_output=True, text=True, timeout=300)
        replay_s = time.perf_counter() - t_replay
        if proc.returncode != 0:
            raise AssertionError(f"phase T2: the replay exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        again = _chaos_report(os.path.join(
            tmp, "replay", os.path.basename(path)))
        with plain_dispatches() as cpu_counted:
            cpu_rc, _, cpu_path = run_chaos_t("cpu", os.path.join(tmp, "cpu"))
        cpu_report = _chaos_report(cpu_path)
    if again != report or cpu_report != report or cpu_rc != 0:
        raise AssertionError("phase T2: the replay or the CPU run differs "
                             "from the card's report")
    if any(t2_launches[k] != n for k, n in cpu_counted.items()):
        raise AssertionError(f"phase T2: launches {t2_launches} against the "
                             f"CPU's {cpu_counted}")
    _line("T2", command=command, invariants={
        r["name"]: r["verdict"] for r in report["invariants"]},
        wall_s=t2_wall, replay_s=replay_s, cpu_counted=dict(cpu_counted),
        launches={k: v for k, v in t2_launches.items() if v}, card=card)

    # T3: the ingress tool twice on one seed; its dump through every view
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "ingress.jsonl")
        first, t3_launches, t3_wall = counted("ingress_t3", run_ingress_t,
                                              None)
        second, _, _ = counted("ingress_t3", run_ingress_t, None, dump)
        if _ingress_fields(first) != _ingress_fields(second):
            raise AssertionError("phase T3: two same-seed ingress runs "
                                 "differ")
        views = {}
        for flags in T_TRACE_VIEWS:
            rc, text = _tool_main(trace_tool, [dump] + flags)
            if rc != 0 or not text:
                raise AssertionError(f"phase T3: trace_tool {flags} exited "
                                     f"{rc}")
            views[" ".join(flags) or "report"] = len(text)
        chrome = os.path.join(tmp, "chrome.json")
        rc, _ = _tool_main(trace_tool, [dump, "--phases", "--chrome",
                                        chrome])
        with open(chrome) as fh:
            chrome_events = len(json.load(fh)["traceEvents"])
        if rc != 0 or not chrome_events:
            raise AssertionError("phase T3: the Chrome trace is empty")
    _line("T3", ordered=first["ordered"], admission=first["admission"],
          shed_hash=first["shed_hash"], ordered_hash=first["ordered_hash"],
          ordered_per_sim_second=first["ordered_per_sim_second"],
          ingress_to_finalised=first["ingress_to_finalised"],
          reads=first["reads"], wall_s=[first["wall_s"], second["wall_s"]],
          trace_views_bytes=views, chrome_events=chrome_events,
          launches={k: v for k, v in t3_launches.items() if v}, card=card)

    # T4: the profiler on four member tiles at depth 4
    (prof, own), t4_launches, t4_wall = counted("profile_t4", run_profile_t,
                                                None)
    if prof["txns_ordered"] < int(T_PROFILE[2]) or not prof["residency"] \
            or prof["shards"] != 4:
        raise AssertionError(f"phase T4: {prof}")
    _line("T4_hotspots", cumulative=[
        {k: h[k] for k in ("func", "ncalls", "tottime_s", "cumtime_s")}
        for h in prof["hotspots_top20_cumulative"][:12]],
        own_time=own, card=card)
    _line("T4", **{k: prof[k] for k in (
        "n_nodes", "instances", "txns_ordered", "wall_s", "txns_per_sec",
        "device_dispatches_per_ordered_batch", "shards", "mesh_shape",
        "residency")}, launches={k: v for k, v in t4_launches.items() if v},
        phase_wall_s=t4_wall, card=card)

    # T5: the graft entry and the dry run over four tiles
    (card5, plain5, dry, cpu_dry, one_tile), t5_launches, t5_wall = \
        counted("graft_t5", run_graft_t, None)
    if not _records_equal(card5, plain5) or not card5["ok"].all():
        raise AssertionError("phase T5: entry() differs from its plain "
                             "version")
    if not _records_equal(dry["step"], one_tile) \
            or not _records_equal(dry["step"], cpu_dry["step"]):
        raise AssertionError("phase T5: the dry run on four tiles differs "
                             "from one tile or from the CPU")
    for key in ("member_mesh", "fabric", "resident"):
        if dry[key]["ordered_hash"] != cpu_dry[key]["ordered_hash"]:
            raise AssertionError(f"phase T5: the {key} pool differs from "
                                 f"the CPU's")
    _line("T5", entry_ok=int(card5["ok"].sum()), dry_tiles=T_TILES,
          dry_ok=int(dry["step"]["ok"].sum()),
          pools={k: dry[k]["ordered_hash"][:16]
                 for k in ("member_mesh", "fabric", "resident")},
          wall_s=t5_wall,
          launches={k: v for k, v in t5_launches.items() if v}, card=card)
    phase_s = time.perf_counter() - t0
    _line("T", phase_s=phase_s,
          launches={k: v for k, v in t_launches.items() if v}, card=card)
    return t_launches, phase_s


def run_state_e(dev):
    """The state at the reference's state-bench delta: ``run_commit_arms``
    with arms host and device on the card (``E_KEYS`` keys, delta 256, 20
    windows, seed 7, 32 hot keys at 0.9); per-window roots must be
    identical across the arms (the function asserts it)."""
    from indy_plenum_tpu_torch.simulation.state_commit_bench import \
        run_commit_arms

    rec = run_commit_arms(n_keys=E_KEYS, delta=E_DELTA, windows=E_WINDOWS,
                          seed=7, hot_keys=32, hot_frac=0.9,
                          arms=("host", "device"), device=dev)
    if not rec["roots_identical"] \
            or rec["arms"]["device"]["wave_device_hashes"] <= 0 \
            or rec["arms"]["host"]["wave_device_hashes"] != 0:
        raise AssertionError(f"phase E: {rec}")
    return rec


# --- phase 5: report ----------------------------------------------------------


def sha_drain_blocks(arrays, reqs):
    """K-a's operands at the ingress drain: each row's R || A || M padded
    into blocks (``verify_inputs``' arrays, the requests' signing bytes
    in turn): (8,192, 2, 128) uint8 and the counts."""
    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.tpu import sha512 as s5

    msgs = [r.signing_bytes() for r in reqs]
    n = len(arrays[0])
    prefixes = [bytes(arrays[1][i]) + bytes(arrays[0][i]) for i in range(n)]
    return s5.pad_ed25519_messages(
        prefixes, [msgs[i % len(msgs)] for i in range(n)],
        ted.max_blocks_for(msgs))


def kernel_report(dev, signers, reqs, rng, launches, errs):
    import torch
    from indy_plenum_tpu_torch.crypto import ed25519 as ed
    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import sha512 as s5

    # the ingress drain's shapes: 8192 entries, 2 SHA-512 blocks each
    rows, arrays = verify_inputs(signers, reqs, rng, DRAIN)
    pk, rb, sb, hb = [torch.from_numpy(a).to(dev) for a in arrays]
    # the verify kernel's work depends on the data: count the signatures
    # whose A decompresses (they run the whole check)
    decodes = {}
    for p, _, _ in rows:
        if p not in decodes:
            decodes[p] = ed.decompress(p) is not None
    n_full = sum(decodes[p] for p, _, _ in rows)
    blocks_np, counts_np = sha_drain_blocks(arrays, reqs)
    blocks = torch.from_numpy(blocks_np).to(dev)
    counts = torch.from_numpy(counts_np).to(dev)
    # K-a and K-b against their plain versions at these shapes
    digest = s5.sha512_blocks(blocks, counts)
    scalar = s5.reduce_mod_l(digest)
    err_a = _max_abs_err([(digest, s5.sha512_blocks_plain(blocks, counts))])
    err_b = _max_abs_err([(scalar, s5.reduce_mod_l_plain(digest))])
    check_mod_l_ints(digest.cpu().numpy(), scalar.cpu().numpy(),
                     "the drain")
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
    # K-a's chain floor: one message of the drain alone
    one_block, one_count = blocks[:1].contiguous(), counts[:1].contiguous()
    t_sha_one = _kernel_ms(lambda: s5.sha512_blocks(one_block, one_count),
                           20)
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
    # the library's zero: masked_fill_ of each leaf by a mask on the card
    hit = mask.to(dev)

    def fill():
        for x in votes:
            x.masked_fill_(hit.view((-1,) + (1,) * (x.dim() - 1)), 0)

    lib_zero = _kernel_ms(fill, 50)

    n_blocks = int(counts_np.sum())
    # K8 moves bytes and computes nothing: the sliding member's rows read
    # where they survive (S - d columns) and written whole, its
    # checkpoint votes written, its frontier read and written, the deltas
    # read; the zero writes every leaf of the reset member (its row, like
    # the host mask it comes from, travels in the launch's parameters)
    leaf_rows = 2 * n + 3
    slide_bytes = (leaf_rows * (s - CHK_FREQ) + leaf_rows * s + n * c + 8
                   + 4 * m)
    zero_bytes = leaf_rows * s + n * c + 4

    rows = [
        ("sha512_blocks", "indy_plenum_tpu_torch/csrc/sha512.cu",
         "indy_plenum_tpu/tpu/sha512.py:201", t_sha, t_sha_plain,
         bound(128 * n_blocks + 4 * DRAIN + 64 * DRAIN,
               n_blocks * SHA512_OPS_PER_BLOCK
               - DRAIN * SHA512_IV_ROUND_SAVING)),
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
         bound(*step_work(m, n, s, c, words_np))),
        ("window_slide", "indy_plenum_tpu_torch/csrc/window.cu",
         "indy_plenum_tpu/tpu/quorum.py:358", t_slide, t_slide_plain,
         bound(slide_bytes, 0)),
        ("window_zero", "indy_plenum_tpu_torch/csrc/window.cu",
         "indy_plenum_tpu/tpu/compile_plan.py:83", t_zero, t_zero_plain,
         bound(zero_bytes, 0)),
    ]
    library = {"window_zero": lib_zero}
    out = []
    for name, src, replaces, ms, plain_ms, (bound_ms, bound_by) in rows:
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": library.get(name)})
    out[0].update(chain_floor_ms=t_sha_one)

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


K10_THREADS = (32, 64, 128)  # K10's block sizes timed in the report


def sha256_report(dev, corpus, rng, launches, errs):
    """K10-K12 rows of the kernels line at the main path's shapes: K11 at
    one commit plan of phase C's shape (320 new keys into 3,200: ~250
    levels of <= 320 nodes, ``commit_plan``), K10 at one 4,096-proof chunk
    of the catchup-proof corpus (the chunk ``_ChunkedDeviceVerify``
    launches; phase D's drains are the same size), K12 at 4,096 64-byte
    messages (not on the main path: its compression runs inside K10/K11);
    on K12's row its one-message chain floor and 4,096 rows of 55, 119 and
    200 bytes. Beside K11's row: the same plan on one block and on clusters of 2, 4
    and 8 blocks, 250-level chain plans of 32 .. 1,024 nodes a level the
    same ways (where the block/cluster cut belongs), one 320-pair wave
    (the per-wave form's shape), and one thread's chain through 256
    one-node levels, whose time per level times the plan's levels is the
    dependent-chain floor. Beside K10's rows: one proof of the chunk
    alone (K10's dependent-chain floor: one thread's 17 node hashes and
    the launch) and the chunk at 32, 64 and 128 threads a block."""
    import torch
    from indy_plenum_tpu_torch.server.catchup import catchup_rep_service \
        as crs
    from indy_plenum_tpu_torch.tpu import sha256 as s2

    chunk = crs._ChunkedDeviceVerify.CHUNK
    msgs = torch.from_numpy(
        rng.randint(0, 256, (chunk, 64)).astype(np.uint8)).to(dev)
    wave = 320
    left = torch.from_numpy(
        rng.randint(0, 256, (wave, 32)).astype(np.uint8)).to(dev)
    right = torch.from_numpy(
        rng.randint(0, 256, (wave, 32)).astype(np.uint8)).to(dev)
    prefs, plits, poffs, plevels, pwidest = commit_plan(dev)
    prt = torch.from_numpy(np.array(prefs)).to(dev)
    plt = torch.from_numpy(np.array(plits)).to(dev)
    n_nodes = prefs.shape[0]
    crefs, clits, coffs = chain_plan(256)
    crt = torch.from_numpy(crefs).to(dev)
    clt = torch.from_numpy(clits).to(dev)
    tree, leaf_data, indices, paths = corpus
    t = _fold_inputs(dev, leaf_data[:chunk], indices[:chunk], paths[:chunk],
                     [tree.tree_size] * chunk, [tree.root_hash] * chunk)
    dense_args = [t[k] for k in ("leaf", "index", "path", "path_len",
                                 "tree_size", "root")]
    idx_args = [t[k] for k in ("leaf", "index", "table", "path_idx",
                               "path_len", "tree_size", "root")]
    # the same chunk's verdicts, kernel against plain, once more
    for fn, plain, args in (
            (s2.verify_audit_paths, s2.verify_audit_paths_plain,
             dense_args),
            (s2.verify_audit_paths_indexed,
             s2.verify_audit_paths_indexed_plain, idx_args)):
        if not torch.equal(fn(*args).cpu(), plain(*args).cpu()):
            raise AssertionError("K10 chunk differs from plain")
    fns = {
        "sha256_fixed": (lambda: s2.sha256_fixed(msgs),
                         lambda: s2.sha256_fixed_plain(msgs)),
        "merkle_node_hash": (
            lambda: s2.merkle_plan_hash(prt, plt, poffs),
            lambda: s2.merkle_plan_hash_plain(prt, plt, poffs)),
        "audit_paths": (lambda: s2.verify_audit_paths(*dense_args),
                        lambda: s2.verify_audit_paths_plain(*dense_args)),
        "audit_paths_indexed": (
            lambda: s2.verify_audit_paths_indexed(*idx_args),
            lambda: s2.verify_audit_paths_indexed_plain(*idx_args)),
    }
    levels = int(t["path_len"].sum())  # two compressions a level
    depth = t["path_idx"].shape[1]
    n_table = t["table"].shape[0]
    fold_bytes = chunk * (32 + 4 + 4 + 4 + 32 + 1)
    work = {  # (bytes moved once, 32-bit instructions)
        "sha256_fixed": (chunk * (64 + 32), chunk * SHA256_64B_OPS),
        "merkle_node_hash": (n_nodes * (8 + 32) + plits.size,
                             n_nodes * SHA256_NODE_OPS),
        "audit_paths": (fold_bytes + chunk * depth * 32,
                        levels * SHA256_NODE_OPS),
        "audit_paths_indexed": (fold_bytes + chunk * depth * 4
                                + n_table * 32,
                                levels * SHA256_NODE_OPS),
    }
    replaces = {
        "sha256_fixed": "indy_plenum_tpu/tpu/sha256.py:103",
        "merkle_node_hash": "indy_plenum_tpu/tpu/sha256.py:325",
        "audit_paths": "indy_plenum_tpu/tpu/sha256.py:273",
        "audit_paths_indexed": "indy_plenum_tpu/tpu/sha256.py:295",
    }
    rows, call_ms, shapes = [], {}, {
        "sha256_fixed": f"{chunk} x 64 B",
        "merkle_node_hash": f"one commit plan: {n_nodes} nodes in "
                            f"{plevels} levels, widest {pwidest}, "
                            f"{plits.shape[0]} literals",
        "audit_paths": f"{chunk} proofs x {depth} levels",
        "audit_paths_indexed": f"{chunk} proofs x {depth} levels, "
                               f"{n_table} table rows"}
    for name, (fn, plain) in fns.items():
        ms = _kernel_ms(fn, 20)
        call_ms[name] = _cuda_ms(fn, 20)
        # one call, as the other reports time a plain version; K11's on
        # the commit plan is phase 2's (check_sha256), ~30 s a call
        plain_ms = (_PLANS["commit_plain_ms"] if name == "merkle_node_hash"
                    else _cuda_ms(plain, 1, 0))
        bound_ms, bound_by = bound(*work[name])
        rows.append({"name": name, "route": "cuda",
                     "source": "indy_plenum_tpu_torch/csrc/sha256.cu",
                     "replaces": replaces[name], "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    # K12: one 64-byte message alone (its dependent-chain floor) and 4,096
    # rows of 55, 119 and 200 bytes (1, 2 and 4 blocks)
    one_msg = msgs[:1].contiguous()
    k12_row = next(r for r in rows if r["name"] == "sha256_fixed")
    k12_row["chain_floor_ms"] = _kernel_ms(
        lambda: s2.sha256_fixed(one_msg), 20)
    k12_row["lengths_ms"] = {}
    for length in (55, 119, 200):
        rows_l = torch.from_numpy(rng.randint(
            0, 256, (chunk, length)).astype(np.uint8)).to(dev)
        k12_row["lengths_ms"][length] = _kernel_ms(
            lambda: s2.sha256_fixed(rows_l), 20)
    poffs32 = np.asarray(poffs, np.int32)
    chain_ms = _kernel_ms(lambda: s2.merkle_plan_hash(crt, clt, coffs), 20)

    def by_blocks(refs_t, lits_t, offs32, reps):
        return {blocks: _kernel_ms(lambda: s2._plan_launch(
            refs_t, lits_t, offs32, blocks), reps)
            for blocks in K11_BLOCKS}

    # the block/cluster cut: 250-level chain plans at widths around it
    sweep = {}
    for width in K11_SWEEP_WIDTHS:
        srefs, slits, soffs = chain_plan(250, width)
        sweep[width] = by_blocks(torch.from_numpy(srefs).to(dev),
                                 torch.from_numpy(slits).to(dev),
                                 np.asarray(soffs, np.int32), 5)
    k11 = {"plan_ms": {r["name"]: r for r in rows}["merkle_node_hash"]["ms"],
           "plan_blocks_ms": by_blocks(prt, plt, poffs32, 10),
           "chain_plans_blocks_ms": sweep,
           "wave_320_ms": _kernel_ms(
               lambda: s2.merkle_node_hash(left, right), 20),
           "wave_320_call_ms": _cuda_ms(
               lambda: s2.merkle_node_hash(left, right), 20),
           "chain_level_ms": chain_ms / 256,
           "chain_floor_ms": chain_ms / 256 * plevels,
           "plan_levels": plevels, "plan_nodes": n_nodes,
           "plan_widest": pwidest}
    # K10: its dependent-chain floor, one proof of the chunk's first (one
    # thread, no barrier), and the chunk at each block size
    one = [a if a is t["table"] else a[:1] for a in idx_args]
    k10 = {"chain_levels": int(t["path_len"][0]),
           "chain_floor_ms": _kernel_ms(
               lambda: s2.verify_audit_paths_indexed(*one), 20),
           "indexed_threads_ms": {th: _kernel_ms(
               lambda: s2._audit_indexed_kernel(*idx_args, th), 20)
               for th in K10_THREADS},
           "dense_threads_ms": {th: _kernel_ms(
               lambda: s2._audit_dense_kernel(*dense_args, th), 20)
               for th in K10_THREADS},
           "threads": s2.AUDIT_THREADS}
    return rows, call_ms, shapes, k11, k10


def residency_report(dev, rng, launches, errs, inputs):
    """K9 and K14 rows of the kernels line. K9 at phase F1's consume: a
    (64, 64, 300, 3) group, k = 4 slots of 128 words (phase A's waves and
    votes), no slide (F1's 11 batches stay below a checkpoint); beside it
    the same consume with one member sliding by ``CHK_FREQ`` in the first
    slot (the slide fold's pattern), and the cluster size the wrapper
    picks for each from host slides, as the ring passes them. K9's ms
    times that launch with the slides already on the card (the kernel
    alone); its call ms times ``q.resident_step`` with host slides (their
    copy to the card included). K14 at
    phase G's 8,192 signed votes into one (64, 300) member. Bounds: K9's
    bytes are the words and slides read, the planes read once for the
    eval and the step's writes (``step_work``), and 2 x (2N + 3) x S + N x
    C for each sliding member (none here); K14's is K-c's bound at B plus
    K7's at (1, N, S) with B words."""
    import torch
    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import step as st

    m, n, s, c, w, k = (N_VALIDATORS, N_VALIDATORS, LOG_SIZE,
                        N_CHECKPOINTS, RESIDENT_WIDTH, 4)
    state = _random_votes(dev, rng, m, n, s, c)
    words_np = resident_words(rng, k, m, w, n, s)
    words = q.words_tensor(words_np, dev)
    slides = torch.zeros((k, m), dtype=torch.int32)
    sliding = int((slides != 0).any(dim=0).sum())
    slides_one = slides.clone()
    slides_one[0, rng.randint(m)] = CHK_FREQ
    blocks = q._cluster_blocks(dev, n, s, c, m, False, sliding > 0)
    blocks_one = q._cluster_blocks(dev, n, s, c, m, False, True)

    def launch(on_card, b):
        return lambda: q._resident_tile_kernel(
            state, on_card, words, n, 1, q.ORDER_DELTA_CAP, b,
            "resident_step")

    def resident():
        return q.resident_step(state, slides, words, n)

    _, words_g, arrays, _ = inputs
    batch = words_g.shape[1]
    gwords = q.words_tensor(words_g, dev)
    sig = [torch.from_numpy(a).to(dev) for a in arrays]
    gstate = q.init_state(n, s, c, 1, dev)

    def fused():
        return st.fused_step(gstate, gwords, *sig, n_validators=n,
                             device=dev)

    rows, call_ms = [], {}
    nbytes, ops = step_work(m, n, s, c, words_np)
    nbytes += 4 * k * m + sliding * (2 * (2 * n + 3) * s + n * c)
    kc_ms, kc_by = bound(batch * (4 * 32 + 1), batch * VERIFY_OPS_PER_ITEM)
    k7_ms, _ = bound(*step_work(1, n, s, c, words_g))
    for name, fn, call, plain, (bound_ms, bound_by), src, replaces in (
            ("resident_step", launch(slides.to(dev), blocks), resident,
             lambda: q.resident_step_plain(state, slides.to(dev), words,
                                           n),
             bound(nbytes, ops),
             "indy_plenum_tpu_torch/csrc/resident_tile.cu",
             "indy_plenum_tpu/tpu/compile_plan.py:100"),
            ("fused_step", fused, fused,
             lambda: st.fused_step_plain(gstate, gwords, *sig,
                                         n_validators=n),
             (kc_ms + k7_ms, kc_by),
             "indy_plenum_tpu_torch/csrc/ed25519.cu",
             "indy_plenum_tpu/tpu/step.py:29")):
        ms = _kernel_ms(fn, 20 if name == "resident_step" else 5)
        call_ms[name] = _cuda_ms(call, 20 if name == "resident_step"
                                 else 5)
        plain_ms = _cuda_ms(plain, 1, 0)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    kc_alone = _kernel_ms(lambda: ted.verify_kernel(*sig), 5)
    one_sliding = _kernel_ms(launch(slides_one.to(dev), blocks_one), 20)
    return rows, call_ms, {"resident_step": f"k={k} x {m} x {w} words, "
                           f"{m} x {n} x {s}, {sliding} sliding, "
                           f"{blocks} blocks a member ({blocks_one} with "
                           f"one sliding)",
                           "resident_step_one_sliding_ms": one_sliding,
                           "fused_step": f"{batch} votes, 1 x {n} x {s}",
                           "fused_step_verify_ms": kc_alone}


def state_bytes(m, n, s, c):
    """Bytes of a member-stacked VoteState of (M, N, S, C)."""
    return m * (3 * s + 2 * n * s + n * c + 4)


def fabric_report(dev, rng, launches, errs, inputs):
    """The rows of slice 5's kernels, at the main path's shapes: K13 at
    phase H's (4, 2) step (M = N = 256, S = 300, C = 3, W = 512, v = 2);
    the tiled K9 at its resident arm's consume (k = 4 slots, no slide);
    K1 (one ring step of every leaf on (8,)) and K15 (the merge of a
    rotation by R / 2 on (8,)) on phase H's state; the sharded K14 at
    phase G's 8,192 votes on 4 tiles. Bounds (bytes) count the work, not
    a design's traffic: K13 is ``step_work``, the tiled K9 ``step_work``
    of its k slots' words plus the slides read; K1 reads and writes every
    leaf once (its library call: ``torch.roll`` of each leaf by shift x R
    rows, behind the spin as the kernels);
    K15 reads one arm's row for each row it writes and writes the state
    (K1's bytes); the sharded K14 is K-c's bound plus K13's at (1, N, S)
    with B words. The one-card rotation (``rotate_planes`` by R / 2 on
    (8,), one K1 roll; its plain version the reference's arms and merge)
    is a row of its own, with K1's bound and library call. K1 and the
    rotation are also timed at phase R's state (M = N = 64, S = 15, C =
    3; one ring step and R / 2 on (4, 2)), under ``phase_r``. Also K13 at
    v = 1 (the (8,) member mesh's step) against K7 on the same state and
    words, alternated three times in one call."""
    import torch
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import rebalance as rb
    from indy_plenum_tpu_torch.tpu import ring_exchange as rx
    from indy_plenum_tpu_torch.tpu import step as st

    m, n, s, c, w, k, v = (FABRIC_N, FABRIC_N, LOG_SIZE, N_CHECKPOINTS,
                           FABRIC_W, 4, 2)
    state = fabric_state(dev, rng, n, n, c)
    words_np = fabric_words(rng, m, w, n, s, c)
    words = q.words_tensor(words_np, dev)
    slot_words_np = np.stack([fabric_words(rng, m, w, n, s, c)
                              for _ in range(k)])
    slot_words = q.words_tensor(slot_words_np, dev)
    slides = torch.zeros((k, m), dtype=torch.int32, device=dev)
    mesh8 = fabric_mesh(dev, (8,))
    r = m // 8
    arm_a = rx.ring_shift_planes(state, mesh8, 0)
    arm_b = rx.ring_shift_planes(state, mesh8, 1)
    leaf_bytes = state_bytes(m, n, s, c)

    _, words_g, arrays, _ = inputs
    batch = words_g.shape[1]
    gwords = q.words_tensor(words_g, dev)
    sig = [torch.from_numpy(a).to(dev) for a in arrays]
    gstate = q.init_state(N_VALIDATORS, s, c, 1, dev)
    sharded = st.make_sharded_fused_step(
        q.make_fabric_mesh([dev] * 4, (4,), ("validators",)), N_VALIDATORS)
    kc_ms, kc_by = bound(batch * (4 * 32 + 1), batch * VERIFY_OPS_PER_ITEM)
    g_bytes, g_ops = step_work(1, N_VALIDATORS, s, c, words_g)
    k13g_ms, _ = bound(g_bytes, g_ops)
    nb, ops = step_work(m, n, s, c, words_np)
    nb_t, ops_t = step_work(m, n, s, c, slot_words_np)
    rows = [
        ("fabric_step",
         lambda: q.fabric_step(state, words, n, v),
         lambda: q.fabric_step_plain(state, words, n, v),
         bound(nb, ops), "indy_plenum_tpu_torch/csrc/resident_tile.cu",
         "indy_plenum_tpu/tpu/quorum.py:306", 20),
        ("resident_tile",
         lambda: q.resident_tile_step(state, slides, slot_words, n, v),
         lambda: q.resident_tile_plain(state, slides, slot_words, n, v),
         bound(nb_t + 4 * k * m, ops_t),
         "indy_plenum_tpu_torch/csrc/resident_tile.cu",
         "indy_plenum_tpu/tpu/compile_plan.py:141", 20),
        ("ring_shift",
         lambda: rx.ring_shift_planes(state, mesh8, 1),
         lambda: rx.ring_shift_plain(state, mesh8, 1),
         bound(2 * leaf_bytes, 0), "indy_plenum_tpu_torch/csrc/ring.cu",
         "indy_plenum_tpu/tpu/ring_exchange.py:101", 20),
        ("rotate_merge",
         lambda: rb.rotate_merge(arm_a, arm_b, r // 2, r),
         lambda: rb.rotate_merge_plain(arm_a, arm_b, r // 2, r),
         bound(2 * leaf_bytes, 0), "indy_plenum_tpu_torch/csrc/ring.cu",
         "indy_plenum_tpu/tpu/rebalance.py:184", 20),
        ("rotate_planes",
         lambda: rb.rotate_planes(state, mesh8, r // 2, r),
         lambda: rb.rotate_planes_plain(state, mesh8, r // 2, r),
         bound(2 * leaf_bytes, 0),
         "indy_plenum_tpu_torch/tpu/rebalance.py (csrc/ring.cu)",
         "indy_plenum_tpu/tpu/rebalance.py:184", 20),
        ("sharded_fused_step",
         lambda: sharded(gstate, gwords, *sig),
         lambda: st.fused_step_plain(
             gstate, gwords, *sig, n_validators=N_VALIDATORS, v_shards=4),
         (kc_ms + k13g_ms, kc_by),
         "indy_plenum_tpu_torch/csrc/ed25519.cu",
         "indy_plenum_tpu/tpu/step.py:46", 5),
    ]
    tile_blocks = q._cluster_blocks(dev, n, s, c, m, False, True)
    k13_blocks = q._cluster_blocks(dev, n, s, c, m, True)
    library = {"ring_shift": _kernel_ms(
        lambda: [torch.roll(x, r, dims=0) for x in state], 20),
        "rotate_planes": _kernel_ms(
        lambda: [torch.roll(x, r // 2, dims=0) for x in state], 20)}
    out, call_ms = [], {}
    for name, fn, plain, (bound_ms, bound_by), src, replaces, reps in rows:
        ms = _kernel_ms(fn, reps)
        call_ms[name] = _cuda_ms(fn, reps)
        plain_ms = _cuda_ms(plain, 1, 0)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": library.get(name)})
    # K1 and the rotation at phase R's state, on its (4, 2) fabric
    rm, rn, rs, rc = R_STATE
    rstate = fabric_state(dev, rng, rn, rn, rc, m=rm, s=rs)
    mesh42 = fabric_mesh(dev, (4, 2))
    rr = rm // 4
    r_bound = bound(2 * state_bytes(rm, rn, rs, rc), 0)
    for row, fn, plain, lib in (
            (out[2], lambda: rx.ring_shift_planes(rstate, mesh42, 1),
             lambda: rx.ring_shift_plain(rstate, mesh42, 1), rr),
            (out[4], lambda: rb.rotate_planes(rstate, mesh42, rr // 2, rr),
             lambda: rb.rotate_planes_plain(rstate, mesh42, rr // 2, rr),
             rr // 2)):
        row["phase_r"] = {
            "ms": _kernel_ms(fn, 20), "call_ms": _cuda_ms(fn, 20),
            "plain_ms": _cuda_ms(plain, 1, 0), "bound_ms": r_bound[0],
            "bound_by": r_bound[1],
            "library_ms": _kernel_ms(
                lambda: [torch.roll(x, lib, dims=0) for x in rstate], 20)}
    v1 = {"k13_v1_ms": [], "k7_ms": [], "k13_v1_call_ms": [],
          "k7_call_ms": []}
    for _ in range(3):
        for tag, fn in (("k13_v1", lambda: q.fabric_step(state, words, n, 1)),
                        ("k7", lambda: q.step_compact(state, words, n))):
            v1[f"{tag}_ms"].append(_kernel_ms(fn, 20))
            v1[f"{tag}_call_ms"].append(_cuda_ms(fn, 20))
    return out, call_ms, v1, {
        "fabric_step": f"{m} x {n} x {s}, v={v}, {w} words, "
                       f"{k13_blocks} blocks a member",
        "resident_tile": f"k={k} x {m} x {w} words, {m} x {n} x {s}, v={v}, "
                         f"{tile_blocks} blocks a member",
        "ring_shift": f"every leaf of {m} x {n} x {s}, (8,), shift 1",
        "rotate_merge": f"every leaf of {m} x {n} x {s}, R={r}, s={r // 2}",
        "rotate_planes": f"every leaf of {m} x {n} x {s}, (8,), "
                         f"{r // 2} rows; phase_r: {rm} x {rn} x {rs}, "
                         f"(4, 2), {rr // 2} rows (K1: one ring step)",
        "sharded_fused_step": f"{batch} votes, 1 x {N_VALIDATORS} x {s}, "
                              "v=4"}


# the kernels each main-path run must launch
PATH_KERNELS = {
    "ingress": ("sha512_blocks", "reduce_mod_l", "ed25519_verify"),
    # K11 once per SMT commit; 11 batches stay below a checkpoint: no slide
    "pool_c": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
               "quorum_step", "merkle_node_hash"),
    # the default "auto" law asks its policy once per commit; a fresh
    # policy with no measurement tries the card first
    "pool_c_auto": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
                    "quorum_step", "merkle_node_hash"),
    "reads_d": ("audit_paths_indexed",),
    # a fresh offload policy sends the first domain slice (150 proofs,
    # at or above DEVICE_MIN_BATCH) to the card; L2's too, and it rejects
    "catchup_L1": ("audit_paths_indexed",),
    "catchup_L2": ("audit_paths_indexed",),
    "state_e": ("merkle_node_hash",),
    # phase P: the proof-attached drain is K10 indexed (mode "device");
    # the BLS pool's tick plane slides at CHK_FREQ 2, its drain is K10
    "proofs_p": ("audit_paths_indexed",),
    "pool_p": ("quorum_step", "window_slide", "audit_paths_indexed"),
    # phase X: the catchup arcs slide at CHK_FREQ 2 and leech 18 txns
    # (below DEVICE_MIN_BATCH: their proofs stay on the host); the
    # partition arc orders below a checkpoint and changes view (a zero)
    "chaos_f_crash_gc_catchup": ("quorum_step", "window_slide"),
    "chaos_byzantine_seeder_catchup": ("quorum_step", "window_slide"),
    "chaos_f_crash_partition": ("quorum_step", "window_zero"),
    "quorum": ("quorum_step", "window_slide"),
    # 11 batches of 320: below one checkpoint interval, so no slide
    "pool_a": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
               "quorum_step"),
    "pool_b": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
               "quorum_step", "window_slide", "window_zero"),
    # residency: every consume is K9 (K7 only for a cold start with an
    # empty ring), slides folded in, the view change's zero still K8
    "pool_f1": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
                "resident_step"),
    "pool_f2": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
                "resident_step", "window_zero"),
    # K14 is one launch a call: no ed25519_verify of its own
    "fused_g": ("fused_step", "sharded_fused_step"),
    # phase H: K7 on one device, K13 on the fabric, the tiled K9 with
    # residency (K13 for its cold start); 3 batches: no slide
    "fabric_single": ("quorum_step",),
    "fabric_mesh8": ("fabric_step",),
    "fabric_fabric4x2": ("fabric_step",),
    "fabric_fabric4x2_resident": ("resident_tile",),
    # phase R: the forced arm rotates (one K1 roll a rotation, no K15);
    # both arms run the tiled K9 and slide inside it
    "rebalance_forced": ("resident_tile", "ring_shift"),
    "rebalance_unforced": ("resident_tile",),
    # phase X's workload arms: four lanes of K7 with slides at CHK_FREQ 2;
    # the BLS pool's slides; the saturating crowd's signed ingress
    "chaos_lane_partition": ("quorum_step", "window_slide"),
    "chaos_edge_cache_poisoning": ("quorum_step", "window_slide"),
    "chaos_f_crash_catchup_under_saturation": (
        "sha512_blocks", "reduce_mod_l", "ed25519_verify", "quorum_step",
        "window_slide"),
    # phase O: signed ingress, K7 a tick, the reads' K10 indexed; CHK_FREQ
    # 100 with batches of 40: no slide
    "overload_o_open": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
                        "quorum_step", "audit_paths_indexed"),
    "overload_o_retry": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
                         "quorum_step", "audit_paths_indexed"),
    # phase N: K7 a lane a tick, K8's slide at CHK_FREQ 2
    "laned_n_1": ("quorum_step", "window_slide"),
    "laned_n_2": ("quorum_step", "window_slide"),
    "laned_n_4": ("quorum_step", "window_slide"),
    # phase S: the (4,) fabric's K13 each tick, the forced rotation's K1
    "soak_s": ("fabric_step", "ring_shift"),
    # phase W: the origin's drains in mode "device"
    "geo_w": ("audit_paths_indexed",),
    # phase V: every node's drain, K7 a tick, the backups' planes zeroed
    # when the replicas are built; V1's first wide commit is K11 (a fresh
    # "auto" policy tries the card first); V2a slides at CHK_FREQ 5; V2b's
    # view change zeroes
    "node_V1": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
                "quorum_step", "window_zero", "merkle_node_hash"),
    "node_V2a": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
                 "quorum_step", "window_slide", "window_zero"),
    "node_V2b": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
                 "quorum_step", "window_zero"),
    # phase Y: the live pool and the replayed node2; Y1 orders on the host
    # quorum, Y2's live pool on the grouped plane and its replay on a
    # standalone plane that slides at CHK_FREQ 5
    "replay_Y1": ("sha512_blocks", "reduce_mod_l", "ed25519_verify"),
    "replay_Y2": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
                  "quorum_step", "window_slide"),
    # phase Z: every node's drain over sockets (the deployed node builds no
    # vote plane: its quorum is the host's); the restarted node's leeched
    # slice is K10 indexed from a fresh offload policy
    "socket_z1": Z_PATH,
    "socket_z2_restart": Z_PATH + ("audit_paths_indexed",),
    "socket_z2_add_node": Z_PATH,
    "socket_z2_rotate_key": Z_PATH,
    "socket_z3": Z_PATH,
    # phase T: T1's gates order on K7 (one device), K13 (the member mesh
    # and the fabric), K9 (the resident arm), the tiled K9 and K1 (the
    # residency gate's forced migration on four member tiles); T2's arc
    # slides at CHK_FREQ 2; T3 is the signed ingress path; T4 the tiled K9
    # on four member tiles at depth 4 (K13 for its cold start); T5 K14 and
    # the sharded K14, then the dry run's pools
    "gates_t1": ("quorum_step", "fabric_step", "resident_step",
                 "resident_tile", "ring_shift"),
    "chaos_t2": ("quorum_step", "window_slide"),
    "ingress_t3": ("sha512_blocks", "reduce_mod_l", "ed25519_verify",
                   "quorum_step"),
    "profile_t4": ("resident_tile",),
    "graft_t5": ("fused_step", "sharded_fused_step", "fabric_step",
                 "resident_tile"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    twins = _twin_pool()
    try:
        return _main(twins)
    finally:
        _stop_twins(twins)


def _stop_twins(twins):
    """Cancel what has not started and end every worker process."""
    twins.shutdown(wait=False, cancel_futures=True)
    for proc in list((getattr(twins, "_processes", None) or {}).values()):
        if proc.is_alive():
            proc.terminate()
        proc.join(timeout=30)


def submit_twins(twins):
    """The CPU twins of phases A, B, O, N, S, W, V, Y, X's workload arms
    and T1, longest first: they run in the worker processes while the card
    runs the phases before their checks."""
    jobs = {}
    for retry in (True, False):
        jobs[f"o_{retry}"] = twins.submit(_timed, run_overload_o, "cpu",
                                          retry)
    jobs["v_V1"] = twins.submit(twin_node, "V1")
    jobs["x_f_crash_catchup_under_saturation"] = twins.submit(
        twin_chaos, "f_crash_catchup_under_saturation")
    jobs["a"] = twins.submit(_timed, run_pool_a, "cpu")
    jobs["b"] = twins.submit(_timed, run_pool_b, "cpu")
    for name in ("lane_partition", "edge_cache_poisoning"):
        jobs[f"x_{name}"] = twins.submit(twin_chaos, name)
    jobs["n_4"] = twins.submit(_timed, run_laned_n, "cpu", 4)
    jobs["s"] = twins.submit(_timed, run_soak_s, "cpu", S_HOURS)
    jobs["w"] = twins.submit(_timed, run_geo_w, "cpu")
    for arm in ("V2a", "V2b"):
        jobs[f"v_{arm}"] = twins.submit(twin_node, arm)
    for arm in Y_ARMS:
        jobs[f"y_{arm}"] = twins.submit(twin_replay, arm)
    jobs["t1"] = twins.submit(twin_gates)
    return jobs


def _main(twins) -> int:
    import torch

    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import resolve_device, \
        set_deterministic

    set_deterministic()
    dev = resolve_device()
    card = _nvidia_smi()
    t_start = time.perf_counter()
    jobs = submit_twins(twins)

    # 1. build
    t0 = time.perf_counter()
    kb.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from indy_plenum_tpu_torch.crypto.bls import bn254_native  # noqa: F401
    _line("build", seconds=build_s, nvcc_seconds=kb.last_build_seconds,
          bn254_seconds=time.perf_counter() - t0, card=card)

    # 2. kernels against their plain versions, on the card
    t0 = time.perf_counter()
    rng = np.random.RandomState(20261016)
    signers, reqs = make_signed_requests(seed=64)
    err_a, err_b = check_sha512_and_mod_l(dev, rng)
    err_c, n_ok, n_rows = check_verify(dev, signers, reqs, rng)
    err_d, q_steps = check_quorum(dev, rng)
    # K7 from random states at every shape the main path gives it
    err_d_shapes, k7_shapes = check_quorum_shapes(dev, rng)
    err_d = max(err_d, err_d_shapes)
    # K8 at the shapes the main path gives it: phase 4's and phase A's
    # group (64 x 64 x 300) and phase B's (96 x 16 x 30)
    err_slide, err_zero = check_window(
        dev, rng, N_VALIDATORS, N_VALIDATORS, LOG_SIZE, N_CHECKPOINTS,
        CHK_FREQ)
    b_slide, b_zero = check_window(
        dev, rng, B_NODES * B_INSTANCES, B_NODES, B_LOG_SIZE,
        B_LOG_SIZE // B_CHK_FREQ, B_CHK_FREQ)
    err_slide, err_zero = max(err_slide, b_slide), max(err_zero, b_zero)
    # K10-K12: digests against plain and hashlib, verdicts against plain
    # and the host MerkleVerifier (planted faults included)
    err_k12, err_k11 = check_sha256(dev, rng)
    corpus = audit_corpus()
    err_k10, n_planted = check_audit(dev, corpus, rng)
    # K9 at phase A's / F1's group, at phase B's / F2's and at an odd N,
    # each also at 1, 2, 4 and 8 blocks a member; K14 at the graft entry's
    # shape and at full width (phase G's votes)
    err_k9 = max(check_resident(dev, rng, N_VALIDATORS, N_VALIDATORS,
                                LOG_SIZE, N_CHECKPOINTS, CHK_FREQ),
                 check_resident(dev, rng, B_NODES * B_INSTANCES, B_NODES,
                                B_LOG_SIZE, B_LOG_SIZE // B_CHK_FREQ,
                                B_CHK_FREQ),
                 check_resident(dev, rng, 6, 7, 40, 2, 5, w=32))
    fused = fused_inputs(rng, N_VALIDATORS, LOG_SIZE, DRAIN)
    err_k14, k14_accepted, k14_oracle = check_fused(dev, rng, fused)
    # K13, the tiled K9, K1, K15 and the sharded K14 at full width
    err_k13, k13_checks = check_fabric(dev, rng)
    err_tile, tile_checks = check_resident_tile(dev, rng)
    err_k1, err_k15, err_rot = check_ring_rotate(dev, rng)
    err_sk14 = check_sharded_fused(dev, fused)
    errs = {"sha512_blocks": err_a, "reduce_mod_l": err_b,
            "ed25519_verify": err_c, "quorum_step": err_d,
            "resident_step": err_k9, "fused_step": err_k14,
            "window_slide": err_slide, "window_zero": err_zero,
            "sha256_fixed": err_k12, "merkle_node_hash": err_k11,
            "audit_paths": err_k10, "audit_paths_indexed": err_k10,
            "fabric_step": err_k13, "resident_tile": err_tile,
            "ring_shift": err_k1, "rotate_merge": err_k15,
            "rotate_planes": err_rot, "sharded_fused_step": err_sk14}
    _line("kernels", max_abs_err=errs, verify_accepted=n_ok,
          verify_rows=n_rows, quorum_steps=q_steps, quorum_shapes=k7_shapes,
          k11_plans={"levels": commit_plan(dev)[3],
                     "widest": commit_plan(dev)[4]},
          audit_planted_faults=n_planted, resident_slots=RESIDENT_SLOTS,
          fused_votes=DRAIN, fused_accepted=k14_accepted,
          fused_oracle_checked=k14_oracle, fabric_checks=k13_checks,
          tile_checks=tile_checks,
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
    cpu_a, _, a_wait_s = _twin(jobs, "a")
    for key in ("ordered_hash", "trace_hash", "views", "ordered_min"):
        if pool_a[key] != cpu_a[key]:
            raise AssertionError(f"phase A: card and CPU differ on {key}")
    if pool_a["ordered"] != POOL_BATCHES * POOL_BATCH:
        raise AssertionError(f"phase A ordered {pool_a['ordered']}")
    _line("pool_a", **pool_a, launches=a_launches,
          cpu_wall_s=cpu_a["wall_s"], twin_wait_s=a_wait_s,
          phase_s=time.perf_counter() - t0, card=card)

    # B. the instance axis, slides and a view change
    t0 = time.perf_counter()
    pool_b, b_launches, _ = on_card("pool_b", run_pool_b, None)
    cpu_b, _, b_wait_s = _twin(jobs, "b")
    for key in ("ordered_hash", "trace_hash", "views", "min_slides",
                "member_resets"):
        if pool_b[key] != cpu_b[key]:
            raise AssertionError(f"phase B: card and CPU differ on {key}")
    if pool_b["min_slides"] < 4 or pool_b["max_view"] < 1:
        raise AssertionError("phase B: too few slides or no view change")
    _line("pool_b", **pool_b, launches=b_launches,
          cpu_wall_s=cpu_b["wall_s"], twin_wait_s=b_wait_s,
          phase_s=time.perf_counter() - t0, card=card)

    # F. residency at full width: phases A's and B's configs at depth 4,
    # card only, each held against its phase (whose CPU twin ran above)
    t0 = time.perf_counter()
    pool_f1, f1_launches, _ = on_card("pool_f1", run_pool_a, None, 4)
    if pool_f1["ordered_hash"] != pool_a["ordered_hash"] \
            or pool_f1["ordered"] != POOL_BATCHES * POOL_BATCH:
        raise AssertionError("phase F1: residency changed the ordering")
    if f1_launches["window_slide"] != 0:
        raise AssertionError("phase F1: a slide was not folded into K9")
    _line("pool_f1", **pool_f1, launches=f1_launches,
          a_dispatches_per_batch=pool_a["dispatches_per_batch"],
          quorum_step_launches=f1_launches["quorum_step"],
          phase_s=time.perf_counter() - t0, card=card)
    t0 = time.perf_counter()
    pool_f2, f2_launches, _ = on_card("pool_f2", run_pool_b, None, 4)
    for key in ("ordered_hash", "views"):
        if pool_f2[key] != pool_b[key]:
            raise AssertionError(f"phase F2: residency changed {key}")
    if not pool_f2["planes_track_watermarks"] \
            or f2_launches["window_slide"] != 0 \
            or pool_f2["min_slides"] < 4:
        raise AssertionError(f"phase F2: {pool_f2} {f2_launches}")
    _line("pool_f2", **pool_f2, launches=f2_launches,
          b_flushes=pool_b["flushes"], phase_s=time.perf_counter() - t0,
          card=card)

    # G. the fused verify + quorum step at full width
    t0 = time.perf_counter()
    fused_g, g_launches, _ = on_card("fused_g", run_fused_g, dev, fused)
    if g_launches["ed25519_verify"] or g_launches["fused_step"] != 1 \
            or g_launches["sharded_fused_step"] != 1:
        raise AssertionError(f"phase G: K14 is not one launch a call: "
                             f"{g_launches}")
    fused_g.update(time_fused_g(dev, fused))
    _line("fused_g", **fused_g, launches=g_launches,
          phase_s=time.perf_counter() - t0, card=card)

    # H. bench.py's fabric cell at full width: one device (K7), the (8,)
    # member mesh and the (4, 2) fabric (K13), and the fabric at depth 4
    # (the tiled K9), all on the one card; one ordering for all four
    t0 = time.perf_counter()
    fabric_h = {}
    for arm, shape, depth in H_ARMS:
        res, h_launches, _ = on_card(f"fabric_{arm}", run_pool_h, None,
                                     shape, depth)
        res["k13_launches"] = (h_launches["fabric_step"]
                               + h_launches["resident_tile"])
        fabric_h[arm] = res
        _line("fabric_h", arm=arm, **res, launches=h_launches, card=card)
    hashes = {res["ordered_hash"] for res in fabric_h.values()}
    if len(hashes) != 1 or any(res["ordered"] != H_BATCHES * POOL_BATCH
                               for res in fabric_h.values()):
        raise AssertionError(f"phase H: the arms differ: {fabric_h}")
    _line("fabric_h_summary", ordered_hash=hashes.pop(),
          phase_s=time.perf_counter() - t0, card=card)

    # R. a forced rebalance (one K1 roll) against the unforced arm, n=64,
    # on the (4, 2) fabric and the (8,) mesh
    t0 = time.perf_counter()
    rebalance_r = {}
    rotations = 0
    for shape in R_SHAPES:
        forced, r_launches, _ = on_card("rebalance_forced", run_pool_r,
                                        None, shape, R_FORCE_TICK)
        plain_arm, u_launches, _ = on_card("rebalance_unforced",
                                           run_pool_r, None, shape, 0)
        for key in ("ordered_hash", "trace_hash", "views", "ordered_min"):
            if forced[key] != plain_arm[key]:
                raise AssertionError(f"phase R {shape}: the forced arm "
                                     f"differs on {key}")
        if forced["rebalances"] < 1 or forced["row_shift"] == 0 \
                or plain_arm["rebalances"] != 0 \
                or u_launches["ring_shift"] or u_launches["rotate_merge"]:
            raise AssertionError(f"phase R {shape}: {forced} {plain_arm}")
        # one K1 launch a rotation and no merge: the one-card roll
        if r_launches["ring_shift"] != forced["rebalances"] \
                or r_launches["rotate_merge"]:
            raise AssertionError(f"phase R {shape}: {forced['rebalances']} "
                                 f"rotations made {r_launches}")
        rotations += r_launches["ring_shift"]
        rebalance_r["x".join(map(str, shape))] = forced
        _line("rebalance_r", mesh=list(shape), **forced,
              unforced_wall_s=plain_arm["wall_s"], launches=r_launches,
              unforced_launches=u_launches, card=card)
    _line("rebalance_r_summary", phase_s=time.perf_counter() - t0,
          card=card)

    # C. real execution: device waves on the card, then host waves; the
    # two runs must agree on every ordering fingerprint and root
    t0 = time.perf_counter()
    (pool_c, c_dev), c_launches, _ = on_card("pool_c", run_pool_c, None,
                                              "device")
    _, c_host = run_pool_c(None, "host")
    for key in ("ordered_hash", "trace_hash", "views", "ordered_min",
                "ledger_hashes", "state_root", "domain_txn_root",
                "audit_txn_root"):
        if c_dev[key] != c_host[key]:
            raise AssertionError(f"phase C: device and host waves differ "
                                 f"on {key}")
    if c_dev["ordered"] != POOL_BATCHES * POOL_BATCH \
            or not c_dev["roots_agree"] \
            or c_dev["wave_device_hashes"] <= 0 \
            or c_host["wave_device_hashes"] != 0:
        raise AssertionError(f"phase C: {c_dev}")
    # and under the default law ("auto"), from a fresh policy as a new
    # process has it: the device run above fed the process-wide one
    from indy_plenum_tpu_torch.state import sparse_merkle_state
    sparse_merkle_state._WAVE_OFFLOAD = None
    (_, c_auto), c_auto_launches, _ = on_card("pool_c_auto", run_pool_c,
                                              None, "auto")
    for key in ("ordered_hash", "ledger_hashes", "state_root",
                "domain_txn_root", "audit_txn_root"):
        if c_auto[key] != c_dev[key]:
            raise AssertionError(f"phase C: auto waves differ on {key}")
    _line("pool_c", **c_dev, launches=c_launches,
          host_waves_wall_s=c_host["wall_s"],
          host_waves_execution_s=c_host["execution_s"],
          host_waves_hashing_s=c_host["wave_hashing_s"],
          host_waves_ordered_txns_per_s=c_host["ordered_txns_per_s"],
          auto_wall_s=c_auto["wall_s"],
          auto_ordered_txns_per_s=c_auto["ordered_txns_per_s"],
          auto_wave_hashing_s=c_auto["wave_hashing_s"],
          auto_device_commits=c_auto["device_commits"],
          auto_wave_device_hashes=c_auto["wave_device_hashes"],
          auto_wave_host_hashes=c_auto["wave_host_hashes"],
          auto_launches=c_auto_launches,
          phase_s=time.perf_counter() - t0, card=card)

    # D. proved reads over phase C's committed domain ledger
    t0 = time.perf_counter()
    reads, d_launches, _ = on_card("reads_d", run_reads_d, pool_c, corpus,
                                   dev)
    reads.update(catchup_kernel_rate(corpus, dev))
    _line("reads_d", **reads, launches=d_launches,
          phase_s=time.perf_counter() - t0, card=card)
    del pool_c

    # L. catchup: bench.py's end-to-end cell on the card and with
    # device="cpu" on the same seed (L1), then with one byzantine seeder
    # (L2); K10 verifies the leeched slices inside the live pool
    from indy_plenum_tpu_torch.server.catchup.catchup_rep_service import \
        DEVICE_MIN_BATCH
    t0 = time.perf_counter()
    catchup_l = {}
    for arm, tamper in L_ARMS:
        t_arm = time.perf_counter()
        res, l_launches, _ = on_card(f"catchup_{arm}", run_catchup_l, None,
                                     tamper)
        arm_s = time.perf_counter() - t_arm
        res.update(check_catchup_k10(res.pop("k10_calls")))
        t_cpu = time.perf_counter()
        cpu = run_catchup_l("cpu", tamper)
        cpu_s = time.perf_counter() - t_cpu
        cpu.pop("k10_calls")
        for key in L_COMPARE:
            if res[key] != cpu[key]:
                raise AssertionError(f"phase {arm}: card and CPU differ "
                                     f"on {key}")
        if res["k10_launches"] < 1 or res["k10_max_abs_err"] \
                or res["proofs_on_card"] < DEVICE_MIN_BATCH:
            raise AssertionError(f"phase {arm}: {res}")
        if tamper and (res["reps_rejected"] < 1
                       or res["k10_rejected_proofs"] < 1
                       or res["rep_wrong_suspicions"] < 1
                       or res["altered"]["altered"] != 1):
            raise AssertionError(f"phase {arm}: the altered rep was not "
                                 f"rejected: {res}")
        errs["audit_paths_indexed"] = max(errs["audit_paths_indexed"],
                                          res["k10_max_abs_err"])
        catchup_l[arm] = res
        _line("catchup_l", arm=arm, **{k: v for k, v in res.items()
                                       if k not in ("state_heads",
                                                    "ledger_hashes")},
              launches=l_launches, arm_s=arm_s,
              cpu_catchup_wall_s=cpu["catchup_wall_s"], cpu_arm_s=cpu_s,
              card=card)
    _line("catchup_l_summary", phase_s=time.perf_counter() - t0, card=card)

    # P. the state-proof plane at full width; X. chaos arcs on the tick
    # plane
    proofs_p = phase_p(on_card, card)
    chaos_x = phase_x(on_card, card)

    # O, N, S, W and X's workload arms: the workload planes at the
    # reference's widths on the card; each is held against its CPU twin
    # from the worker processes after the report, while the last twins
    # finish
    x_new_runs = card_x_new(on_card, card)
    o_runs = card_o(on_card, card)
    n_runs = card_n(on_card, card, t_start)
    s_run = card_s(on_card, card)
    rotations += s_run[1]["ring_shift"]  # the soak's rebalance: one K1 roll
    w_run = card_w(on_card, card)
    # V. the deployed validator node: real Nodes, 25 with full RBFT, the
    # 4-node local pool and the monitor voting out a slow master
    v_runs = card_v(on_card, card)
    # Y. node2 of a live pool recorded, and replayed into a fresh node
    y_runs = card_y(on_card, card)
    # Z. the deployed transport: a provisioned pool over CurveZMQ sockets,
    # membership over sockets, the CLI, one process per validator (whose
    # launches are counted in those processes)
    z4_launches, socket_z1, socket_z4, z_s = phase_z(on_card, card)
    for name, count in z4_launches.items():
        launches[name] += count
    # T. the operator entry points (tools/): the gate suite against its CPU
    # twin, the chaos CLI and its replay command, the ingress tool and
    # the trace tool, the profiler, the graft entry
    t_launches, t_s = phase_t(on_card, card, jobs)

    # E. the state at the reference's state-bench size
    t0 = time.perf_counter()
    state_e, e_launches, _ = on_card("state_e", run_state_e, dev)
    _line("state_e", **state_e, launches=e_launches,
          phase_s=time.perf_counter() - t0, card=card)

    # 5. report
    t0 = time.perf_counter()
    kernels, errs, times = kernel_report(dev, signers, reqs, rng, launches,
                                         errs)
    sha_rows, sha_call_ms, sha_shapes, k11, k10 = sha256_report(
        dev, corpus, rng, launches, errs)
    kernels += sha_rows
    times["call_ms"].update(sha_call_ms)
    res_rows, res_call_ms, res_shapes = residency_report(
        dev, rng, launches, errs, fused)
    kernels += res_rows
    times["call_ms"].update(res_call_ms)
    fab_rows, fab_call_ms, k13_v1, fab_shapes = fabric_report(
        dev, rng, dict(launches, rotate_planes=rotations), errs, fused)
    kernels += fab_rows
    times["call_ms"].update(fab_call_ms)
    print(json.dumps({"kernels": kernels}), flush=True)
    report_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chaos_x.update(check_x_new(x_new_runs, card, jobs))
    overload_o = check_o(o_runs, card, jobs)
    laned_n = check_n(n_runs, card, jobs)
    soak_s = check_s(s_run, card, jobs)
    geo_w = check_w(w_run, card, jobs)
    node_v = check_v(v_runs, card, jobs)
    replay_y = check_y(y_runs, card, jobs)
    _line("workload_checks", check_s=time.perf_counter() - t0, card=card)
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
        "pool_c_ordered_txns_per_s": c_dev["ordered_txns_per_s"],
        "pool_c_execution_share": c_dev["execution_share"],
        "reads_d_proofs_per_s_end_to_end":
            reads["proofs_per_s_end_to_end"],
        "reads_d_proofs_per_s_kernel": reads["proofs_per_s_kernel"],
        "sha256_shapes": sha_shapes,
        "k11_plan": k11,
        "k10_fold": k10,
        "residency_shapes": res_shapes,
        "pool_f1_ordered_txns_per_s": pool_f1["ordered_txns_per_s"],
        "dispatches_per_batch": {"pool_a": pool_a["dispatches_per_batch"],
                                 "pool_f1": pool_f1["dispatches_per_batch"]},
        "fused_g_votes_per_s": fused_g["votes_per_s"],
        "fabric_shapes": fab_shapes,
        "k13_v1_vs_k7_256x256x300": k13_v1,
        "fabric_h": {arm: {key: res[key] for key in (
            "wall_s", "ordered_txns_per_s", "dispatches_per_batch",
            "readbacks", "readbacks_overlapped", "readback_bytes_per_shard",
            "k13_launches")} for arm, res in fabric_h.items()},
        "rebalance_r": {mesh: {key: res[key] for key in (
            "wall_s", "rebalances", "row_shift")}
            for mesh, res in rebalance_r.items()},
        "fused_g_verify_share": fused_g["verify_share"],
        "fused_g_tail_ms": fused_g["tail_ms"],
        "catchup_l": {arm: {key: res[key] for key in (
            "leeched_txns_per_sim_s", "leeched_txns_per_wall_s",
            "recover_sim_s", "catchup_wall_s", "proofs_on_card",
            "proofs_on_host", "k10_launches", "k10_slice_ms", "reps_rejected", "retries")}
            for arm, res in catchup_l.items()},
        "proofs_p": {key: proofs_p[key] for key in (
            "cycles_per_s", "batch", "reads_per_s", "client_ms_per_read",
            "serve_pairings")},
        "chaos_x": chaos_x,
        "overload_o": overload_o, "laned_n": laned_n, "soak_s": soak_s,
        "geo_w": geo_w,
        "node_v": {arm: {key: res[key] for key in (
            "wall_s", "cpu_twin_s", "drains", "writes", "launches")}
            for arm, res in node_v.items()},
        "node_v1_ordered_txns_per_sim_s":
            node_v["V1"]["ordered_txns_per_sim_s"],
        "replay_y": {arm: {key: res[key] for key in (
            "record_s", "replay_s", "cpu_twin_s", "replay_launches")}
            for arm, res in replay_y.items()},
        "socket_z": {"z1_ordered_writes_per_wall_s":
                     socket_z1["ordered_writes_per_wall_s"],
                     "z4_ordered_writes_per_wall_s":
                     socket_z4["ordered_writes_per_wall_s"],
                     "z1_replay_s": socket_z1["replay_s"], "phase_s": z_s},
        "phase_t": {"phase_s": t_s,
                    "launches": {k: v for k, v in t_launches.items() if v}},
        "plain_ms": plain, "report_s": report_s,
        "total_s": time.perf_counter() - t_start}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
