"""The port's flagship step and its multichip dry run, as entry points.

- ``entry()``: ``(fn, args)``, where ``fn`` is the flagship step (K14, the
  fused Ed25519 verify + quorum tally, ``tpu/step.fused_step``) and
  ``args`` its example operands on the device: 8 validators, LOG_SIZE 16,
  2 checkpoints, a batch of 8 signed votes from ``RandomState(0)`` keys.
- ``dryrun_multichip(n)``: the sharded step (``make_sharded_fused_step``)
  over ``n`` validator tiles, then live pools on ``n`` member tiles, on the
  2-axis member x validator fabric and with depth-4 residency.

Twin of ``__graft_entry__.py``. The reference's mesh is ``n`` XLA devices
and it re-executes itself in a subprocess with ``XLA_FLAGS`` when the
process has fewer; here every tile lives on the one device, so there is no
subprocess and no flag. Everything runs on the CUDA card unless
``device="cpu"`` (``--device cpu``) asks for the plain versions; without a
card and without ``device="cpu"`` the calls raise ``NoCudaDevice``.

Usage (from the root of a checkout):
    python -m indy_plenum_tpu_torch.tools.graft_entry [--tiles 4] \
        [--device cpu]
"""
# da: allow-file[device-sync] -- the dry run's product IS the step's outputs read back once, after the step, for the caller to hold against a reference; no tick loop runs here
from __future__ import annotations

import argparse
import functools
import sys

import numpy as np

def entry(device=None):
    """(fn, example_args) where fn is the flagship step, K14."""
    from ..tpu.step import example_inputs, fused_step
    from ..utils.torch_env import resolve_device

    dev = resolve_device(device)
    n_validators, log_size, n_chk, batch = 8, 16, 2, 8
    args = example_inputs(batch=batch, n_validators=n_validators,
                          log_size=log_size, n_checkpoints=n_chk, device=dev)
    fn = functools.partial(fused_step, n_validators=n_validators, device=dev)
    return fn, args


def dryrun_inputs(n_devices: int, device=None):
    """The reference dryrun's step operands: ``2n`` validators, LOG_SIZE
    16, 2 checkpoints, one signature a tile, word 0 the PRE-PREPARE and
    word i validator i's PREPARE for slot i (``__graft_entry__.py:123-
    145``). Returns ``(n_validators, (state, words, pk, rb, s, h))``."""
    from ..tpu import quorum as q
    from ..tpu.step import example_inputs
    from ..utils.torch_env import resolve_device

    dev = resolve_device(device)
    n_validators = n_devices * 2  # 2 validator rows per tile
    log_size, n_chk = 16, 2
    batch = n_devices  # one signature per tile
    state, _, pk, rb, s, h = example_inputs(
        batch=batch, n_validators=n_validators, log_size=log_size,
        n_checkpoints=n_chk, device=dev)
    entries = [(q.PREPARE, i % n_validators, i % log_size)
               for i in range(batch)]
    entries[0] = (q.PREPREPARE, 0, 0)
    words = q.words_tensor(q.pack_words(entries, batch)[None, :], dev)
    return n_validators, (state, words, pk, rb, s, h)


def _step_record(state, events, ok) -> dict:
    return {"state": {k: t.cpu().numpy()
                      for k, t in zip(type(state)._fields, state)},
            "events": {k: t.cpu().numpy()
                       for k, t in zip(type(events)._fields, events)},
            "ok": ok.cpu().numpy()}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded consensus step over ``n_devices`` validator tiles, then
    three live pools on tiles of the same device (the reference's checks,
    ``__graft_entry__.py:107-267``); returns the step's outputs (numpy) and
    each pool's figures."""
    from ..config import getConfig
    from ..simulation.pool import SimPool
    from ..tpu.quorum import make_fabric_mesh
    from ..tpu.step import make_sharded_fused_step
    from ..utils.torch_env import resolve_device

    dev = resolve_device(device)
    mesh = make_fabric_mesh([dev] * n_devices, (n_devices,),
                            axis_names=("validators",))
    n_validators, (state, words, pk, rb, s, h) = dryrun_inputs(
        n_devices, dev)
    log_size, batch = state.prepare_votes.shape[-1], n_devices
    stepper = make_sharded_fused_step(mesh, n_validators)
    new_state, events, ok = stepper(state, words, pk, rb, s, h)
    record = {"step": _step_record(new_state, events, ok)}
    ok_np = record["step"]["ok"]
    assert ok_np.shape == (batch,)
    assert ok_np.all(), "dryrun batch should verify"
    assert record["step"]["events"]["prepare_counts"].shape[-1] == log_size
    print(f"dryrun_multichip OK: tiles={n_devices} on {dev}, "
          f"batch={batch}, verified={int(ok_np.sum())}/{batch}")

    # second check: a LIVE consensus pool ordering with the grouped vote
    # tensors split into member tiles (tpu/vote_plane.py's mesh mode) -
    # the full protocol stack, not just the fused kernel
    cfg = getConfig({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 3,
                     "QuorumTickInterval": 0.05,
                     "QuorumTickAdaptive": True})
    members = make_fabric_mesh([dev] * n_devices, (n_devices,))
    pool = SimPool(n_devices, seed=9, config=cfg, device_quorum=True,
                   shadow_check=False, mesh=members, device=dev)
    n_txns = 3
    for i in range(n_txns):
        pool.submit_request(i)
    pool.run_for(25)
    ordered = [len(n.ordered_digests) for n in pool.nodes]
    assert all(c == n_txns for c in ordered), ordered
    assert pool.honest_nodes_agree()
    group = pool.vote_group
    assert group.shards == n_devices, (group.shards, n_devices)
    shard_occ = group.shard_occupancy
    assert any(occ > 0 for occ in shard_occ), shard_occ
    assert pool.governor is not None and pool.governor.ticks > 0
    record["member_mesh"] = {"ordered_hash": pool.ordered_hash(),
                             "flushes": group.flushes,
                             "shard_occupancy": shard_occ}
    print(f"dryrun_multichip consensus OK: {n_devices} validators ordered "
          f"{n_txns} txns with the grouped vote plane on {n_devices} member "
          f"tiles ({group.flushes} flushes, per-tile occupancy "
          f"{shard_occ})")

    # third check: the 2-axis quorum fabric (member x validator grid)
    # through the same live pool - per-tile counters must cover the full
    # grid and the per-tile pipelined readback must account every byte
    if n_devices < 2:
        print("dryrun_multichip fabric SKIPPED: 2-axis grid needs >= 2 "
              "tiles")
        return record
    m_axis = max(n_devices // 2, 1)
    fabric = make_fabric_mesh([dev] * (m_axis * 2), (m_axis, 2))
    pool2 = SimPool(n_devices, seed=9, config=cfg, device_quorum=True,
                    shadow_check=False, mesh=fabric, device=dev)
    for i in range(n_txns):
        pool2.submit_request(i)
    pool2.run_for(25)
    assert all(len(n.ordered_digests) == n_txns for n in pool2.nodes)
    assert pool2.honest_nodes_agree()
    g2 = pool2.vote_group
    assert g2.mesh_shape == (m_axis, 2), g2.mesh_shape
    assert g2.shards == m_axis * 2, g2.shards
    assert len(g2.flush_votes_per_shard) == g2.shards
    assert sum(g2.flush_votes_per_shard) == g2.flush_votes_total > 0
    assert abs(sum(g2.flush_capacity_per_shard)
               - g2.flush_capacity_total) < 1e-6 * g2.flush_capacity_total
    assert sum(g2.readback_bytes_per_shard) == g2.readback_bytes_total > 0
    assert g2.readbacks_overlapped > 0
    record["fabric"] = {"ordered_hash": pool2.ordered_hash(),
                        "mesh_shape": list(g2.mesh_shape),
                        "shard_occupancy": g2.shard_occupancy,
                        "readback_bytes_per_shard":
                            list(g2.readback_bytes_per_shard)}
    print(f"dryrun_multichip fabric OK: {m_axis}x2 member x validator grid "
          f"ordered {n_txns} txns (per-cell occupancy "
          f"{g2.shard_occupancy}, readback bytes/tile "
          f"{g2.readback_bytes_per_shard})")

    # fourth check: multi-tick device residency over the same member
    # tiles - the ordering must be bit-identical to the per-tick pool
    cfg_res = getConfig({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 3,
                         "QuorumTickInterval": 0.05,
                         "QuorumTickAdaptive": True,
                         "ResidentTickDepth": 4})
    pool3 = SimPool(n_devices, seed=9, config=cfg_res, device_quorum=True,
                    shadow_check=False,
                    mesh=make_fabric_mesh([dev] * n_devices, (n_devices,)),
                    device=dev)
    for i in range(n_txns):
        pool3.submit_request(i)
    pool3.run_for(25)
    assert all(len(n.ordered_digests) == n_txns for n in pool3.nodes)
    assert pool3.honest_nodes_agree()
    assert pool3.ordered_hash() == pool.ordered_hash(), \
        "resident ordering diverged from the per-tick mesh run"
    g3 = pool3.vote_group
    assert g3.resident_depth == 4
    assert g3.resident_ticks > 0, "ring never accumulated a tick"
    assert g3.readbacks_deferred > 0, "ring never deferred a readback"
    assert g3.flushes < group.flushes, (g3.flushes, group.flushes)
    record["resident"] = {"ordered_hash": pool3.ordered_hash(),
                          "flushes": g3.flushes,
                          "resident_ticks": g3.resident_ticks,
                          "readbacks_deferred": g3.readbacks_deferred}
    print(f"dryrun_multichip resident OK: depth-4 ring ordered {n_txns} "
          f"txns bit-identical to per-tick ({g3.flushes} vs "
          f"{group.flushes} flushes, {g3.resident_ticks} resident ticks, "
          f"{g3.readbacks_deferred} readbacks deferred)")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m indy_plenum_tpu_torch.tools.graft_entry",
        description="run entry() once, then dryrun_multichip(tiles)")
    ap.add_argument("--tiles", type=int, default=4,
                    help="validator tiles of the sharded step (all on the "
                         "one device)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    from ..utils.torch_env import NoCudaDevice

    try:
        fn, fargs = entry(args.device)
    except NoCudaDevice as exc:
        ap.error(str(exc))
    _, _, ok = fn(*fargs)
    assert bool(np.asarray(ok.cpu()).all())
    print("entry OK")
    dryrun_multichip(args.tiles, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
