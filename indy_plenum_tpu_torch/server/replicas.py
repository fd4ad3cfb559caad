"""Backup protocol instances: the parallel half of RBFT.

Reference: plenum/server/replicas.py (`Replicas`) + plenum/server/replica.py
(the per-instance `Replica`). The pool runs f+1 protocol instances over the
SAME finalised requests under DIFFERENT primaries (round-robin offset by
instance id); only the master's (inst 0) ordering executes, the backups
exist so the :class:`~indy_plenum_tpu_torch.server.monitor.Monitor` has a live
baseline to judge the master against — a slow-but-alive byzantine master
primary is caught because some backup keeps ordering at full speed.

Each backup bundles its own ConsensusSharedData / StashingRouter /
OrderingService / CheckpointService on a PRIVATE internal bus (its Ordered
events feed the monitor, never the executor), sharing the node's external
bus; instance isolation is by ``instId`` filtering in the services. On a
view change backups are torn down and rebuilt for the new view (reference:
Replicas.remove_replica/grow on view change), restarting their
measurements with the new primaries.

TPU note: with a ``vote_plane_factory`` the backups' quorum tallies ride
the device plane's (node x instance) member axis
(tpu.vote_plane.VotePlaneGroup) in the SAME vmapped dispatch as the
master's — the RBFT instance axis is a leading tensor dimension, so the
monitor's baseline is measured against an equally-fast tally path (SURVEY
§2.6 TPU mapping). Without a factory, backups fall back to host dicts.

Copy of ``indy_plenum_tpu/server/replicas.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional

from ..common.event_bus import ExternalBus, InternalBus
from ..common.messages.internal_messages import RequestPropagates
from ..common.messages.node_messages import Ordered
from ..common.request import Request
from ..common.stashing_router import StashingRouter
from ..common.timer import TimerService
from .consensus.checkpoint_service import CheckpointService
from .consensus.consensus_shared_data import ConsensusSharedData
from .consensus.ordering_service import OrderingService

logger = logging.getLogger(__name__)


class BackupReplica:
    """One backup instance's service bundle."""

    def __init__(self,
                 node_name: str,
                 validators: List[str],
                 inst_id: int,
                 view_no: int,
                 primaries: List[str],
                 timer: TimerService,
                 external_bus: ExternalBus,
                 config,
                 requests_pool,
                 on_ordered: Callable[[Ordered], None],
                 forward_request_propagates: Optional[Callable] = None,
                 vote_plane=None,
                 demux=None):
        self.inst_id = inst_id
        self.data = ConsensusSharedData(
            node_name, validators, inst_id=inst_id, is_master=False,
            log_size=config.LOG_SIZE)
        self.data.view_no = view_no
        self.data.primaries = list(primaries)
        self.internal_bus = InternalBus()
        # with a demux (Instance3PCDemux), inbound 3PC traffic reaches
        # THIS instance's router via one O(1) instId hop instead of every
        # instance running its router over every message — without it
        # (demux=None, the pre-round-5 shape) the stasher subscribes the
        # shared external bus directly
        self._demux = demux
        buses = [self.internal_bus] if demux is not None \
            else [self.internal_bus, external_bus]
        self.stasher = StashingRouter(limit=1000, buses=buses)
        if demux is not None:
            demux.register(inst_id, self.stasher)
        self.requests_pool = requests_pool
        self.vote_plane = vote_plane
        self.ordering = OrderingService(
            data=self.data, timer=timer, bus=self.internal_bus,
            network=external_bus, stasher=self.stasher,
            executor=None, requests=requests_pool, config=config,
            vote_plane=vote_plane)
        self.checkpoints = CheckpointService(
            data=self.data, bus=self.internal_bus,
            network=external_bus, stasher=self.stasher, config=config,
            vote_plane=vote_plane)
        self._on_ordered = on_ordered
        self.internal_bus.subscribe(Ordered, self._handle_ordered)
        if forward_request_propagates is not None:
            self.internal_bus.subscribe(RequestPropagates,
                                        forward_request_propagates)

    def _handle_ordered(self, ordered: Ordered, *args) -> None:
        self.requests_pool.mark_ordered(ordered.reqIdr)
        self._on_ordered(ordered)

    def start(self) -> None:
        self.ordering.start()

    def stop(self) -> None:
        self.ordering.stop()
        if self._demux is not None:
            self._demux.unregister(self.inst_id)
        self.stasher.unsubscribe_all()


class Replicas:
    """Grow/shrink/rebuild the backup instances of one node."""

    def __init__(self,
                 node_name: str,
                 validators: List[str],
                 timer: TimerService,
                 external_bus: ExternalBus,
                 config,
                 make_requests_pool: Callable[[], object],
                 on_backup_ordered: Callable[[int, Ordered], None],
                 forward_request_propagates: Optional[Callable] = None,
                 num_instances: Optional[int] = None,
                 vote_plane_factory: Optional[Callable] = None,
                 demux=None):
        self._node_name = node_name
        # a list, or a zero-arg provider of the CURRENT validator set —
        # rebuilt backups must see live membership, not the boot-time list
        self._validators = (validators if callable(validators)
                            else (lambda: validators))
        self._timer = timer
        self._external_bus = external_bus
        self._config = config
        self._make_requests_pool = make_requests_pool
        self._on_backup_ordered = on_backup_ordered
        self._forward_request_propagates = forward_request_propagates
        # inst_id -> DeviceVotePlane view: backups' tallies ride the SAME
        # vmapped (node x instance) group dispatch as the master's (SURVEY
        # §2.6's TPU mapping: instances = leading axis on the vote tensors)
        self._vote_plane_factory = vote_plane_factory
        self._demux = demux
        # instance count the NODE was sized for (monitor slots, primaries
        # list length) — not re-derived here, or the two could disagree
        self._num_instances = (
            num_instances if num_instances is not None
            else config.replicas_count(len(self._validators())))
        self.backups: List[BackupReplica] = []

    @property
    def num_instances(self) -> int:
        return self._num_instances

    def build(self, view_no: int, primaries: List[str]) -> None:
        """(Re)create backups for ``view_no`` with CURRENT membership."""
        self.teardown()
        for inst_id in range(1, self._num_instances):
            plane = None
            if self._vote_plane_factory is not None:
                plane = self._vote_plane_factory(inst_id)
                if plane is not None:
                    # a rebuilt instance must not inherit the old view's
                    # votes (the master's plane resets on view change too)
                    plane.reset(h=0)
            replica = BackupReplica(
                self._node_name, self._validators(), inst_id, view_no,
                primaries, self._timer, self._external_bus, self._config,
                requests_pool=self._make_requests_pool(),
                on_ordered=lambda o, i=inst_id: self._on_backup_ordered(i, o),
                forward_request_propagates=self._forward_request_propagates,
                vote_plane=plane,
                demux=self._demux)
            replica.start()
            self.backups.append(replica)
        logger.debug("%s built %d backup instance(s) for view %d",
                     self._node_name, len(self.backups), view_no)

    def teardown(self) -> None:
        for replica in self.backups:
            replica.stop()
        self.backups.clear()

    def enqueue_finalised(self, request: Request) -> None:
        for replica in self.backups:
            replica.requests_pool.enqueue(request)
            replica.ordering.on_request_finalised()
