"""Ordering lanes: keyspace-partitioned write path under one barrier.

Public surface:

- :class:`~indy_plenum_tpu_torch.lanes.router.LaneRouter` /
  :func:`~indy_plenum_tpu_torch.lanes.router.route_key` — the deterministic
  key→lane law;
- :class:`~indy_plenum_tpu_torch.lanes.barrier.CrossLaneBarrier` — the
  cross-lane checkpoint barrier (sealed windows + fingerprint chain);
- :class:`~indy_plenum_tpu_torch.lanes.pool.LanedPool` /
  :func:`~indy_plenum_tpu_torch.lanes.pool.lane_meshes` — K full ordering
  lanes on one clock/recorder/barrier, each optionally on its own
  fabric-mesh slice.
"""
from .barrier import CrossLaneBarrier
from .pool import LanedPool, lane_meshes, lane_seed
from .router import LaneRouter, route_key

__all__ = ["CrossLaneBarrier", "LanedPool", "LaneRouter", "lane_meshes",
           "lane_seed", "route_key"]
