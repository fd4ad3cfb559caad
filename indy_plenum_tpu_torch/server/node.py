"""The Node: composition root of one validator.

Reference: plenum/server/node.py (`Node`) — there a ~4000-line god class;
here a thin composition root that OWNS the seams the simulation previously
faked (SimRequestsPool's shared-pool fiction): client ingress with
device-batched authentication, PROPAGATE dissemination with per-node f+1
finalisation, replay protection, execution with Reply emission, and the
full consensus service stack.

Ingress pipeline (the north-star hot path):
    client request -> replay check (ReqIdrToTxn) -> auth queue ->
    [one device batch per PropagateBatchWait tick:
     CoreAuthNr.authenticate_batch] -> Propagator.propagate ->
    f+1 PROPAGATE quorum -> finalised -> NodeRequestsPool ->
    OrderingService 3PC -> Ordered -> execute/commit -> Reply.

Verkey resolution is STATE-BACKED: CoreAuthNr reads the signer's NYM from
the domain SMT (NymHandler.get_nym_data), so an identity written by a
committed NYM txn can authenticate follow-up requests with no static key
material beyond the genesis seed.

Copy of ``indy_plenum_tpu/server/node.py``, with its imports bound to the
port. ``device`` reaches every device object the node builds: the ingress
drain's Ed25519 batch verify (``CoreAuthNr``), the SMT states' hash waves
(``LedgersBootstrap``), the leecher's audit-path folds and the proved-read
service. It is the CUDA card unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions; without a card the node
raises. The vote planes come in built (``vote_plane``,
``backup_vote_plane_factory``) on their own device.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Optional

from ..common.constants import DOMAIN_LEDGER_ID, POOL_LEDGER_ID
from ..common.event_bus import InternalBus
from ..common.messages.internal_messages import (
    CatchupFinished,
    MissingMessage,
    RequestPropagates,
)
from ..common.messages.node_messages import (
    Ordered,
    Propagate,
    Reply,
    RequestAck,
    RequestNack,
)
from ..common.exceptions import InvalidClientRequest
from ..common.metrics_collector import MetricsCollector, MetricsName
from ..common.request import Request
from ..common.stashing_router import StashingRouter
from ..common.txn_util import get_from, get_req_id
from ..common.timer import RepeatingTimer, TimerService
from ..config import Config, getConfig
from ..observability.trace import _NO_SPAN
from ..storage.req_id_to_txn import ReqIdrToTxn
from ..utils.torch_env import DeviceLike, resolve_device
from .client_authn import CoreAuthNr
from .consensus.checkpoint_service import CheckpointService
from .consensus.consensus_shared_data import ConsensusSharedData
from .consensus.message_req_service import MessageReqService
from .consensus.ordering_service import OrderingService, RequestsPool
from .consensus.primary_connection_monitor_service import (
    PrimaryConnectionMonitorService,
)
from .consensus.primary_selector import (
    RoundRobinConstantNodesPrimariesSelector,
)
from .consensus.view_change_service import ViewChangeService
from .consensus.view_change_trigger_service import ViewChangeTriggerService
from .ledgers_bootstrap import LedgersBootstrap, NodeStorage
from .propagator import Propagator
from .request_managers.write_request_manager import NodeExecutor

logger = logging.getLogger(__name__)


class NodeRequestsPool(RequestsPool):
    """Per-INSTANCE finalised-request queues (replaces the simulation's
    shared-pool fiction). Requests are pinned here until this instance
    orders them: the master may execute and GC the propagator's copy while
    a backup instance is still ordering the same request independently."""

    def __init__(self, propagator: Propagator, classify,
                 bound: Optional[int] = None):
        self._propagator = propagator
        self._classify = classify  # Request -> ledger_id
        self._bound = bound  # drop-oldest cap (backup instances)
        self._queues: Dict[int, List[str]] = {}
        self._by_digest: Dict[str, Request] = {}

    def enqueue(self, request: Request) -> None:
        lid = self._classify(request)
        if lid is None:
            lid = DOMAIN_LEDGER_ID
        q = self._queues.setdefault(lid, [])
        q.append(request.digest)
        self._by_digest[request.digest] = request
        if self._bound is not None and len(q) > self._bound:
            dropped = q.pop(0)
            self._by_digest.pop(dropped, None)

    def pop_ready(self, ledger_id: int, max_count: int) -> List[Request]:
        q = self._queues.get(ledger_id, [])
        take, self._queues[ledger_id] = q[:max_count], q[max_count:]
        return [self._by_digest.get(d) or self._propagator.get(d)
                for d in take]

    def get(self, digest: str) -> Optional[Request]:
        return self._by_digest.get(digest) or self._propagator.get(digest)

    def has_ready(self, ledger_id: int) -> bool:
        return bool(self._queues.get(ledger_id))

    def ledger_ids_with_ready(self) -> List[int]:
        return [lid for lid, q in self._queues.items() if q]

    def mark_ordered(self, digests) -> None:
        gone = set(digests)
        for lid, q in self._queues.items():
            self._queues[lid] = [d for d in q if d not in gone]
        for d in gone:
            self._by_digest.pop(d, None)


class Node:
    """One validator: ingress + propagation + consensus + execution."""

    def __init__(self,
                 name: str,
                 validators: List[str],
                 timer: TimerService,
                 network,  # provides create_peer(name) -> ExternalBus
                 config: Optional[Config] = None,
                 storage: Optional[NodeStorage] = None,
                 pool_genesis: Optional[List[Dict]] = None,
                 domain_genesis: Optional[List[Dict]] = None,
                 seed_keys: Optional[Dict[str, str]] = None,
                 bls_keys=None,
                 vote_plane=None,
                 drive_quorum_ticks: bool = True,
                 num_instances: int = 1,
                 metrics=None,
                 backup_vote_plane_factory=None,
                 trace=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.name = name
        self.config = config or getConfig()
        self.timer = timer
        # injectable: pass a NullMetricsCollector to disable collection,
        # or a shared collector to aggregate across components
        self.metrics = metrics if metrics is not None else MetricsCollector()
        # consensus flight recorder: a pool composition injects its
        # shared virtual-clock recorder (deterministic traces); a
        # standalone deployed node builds its own on perf_counter when
        # config enables it (real durations, no determinism claim)
        from ..observability.trace import NULL_TRACE, TraceRecorder

        if trace is not None:
            self.trace = trace
        elif self.config.TraceRecorderEnabled:
            import time as _time

            self.trace = TraceRecorder(
                _time.perf_counter,
                capacity=self.config.TraceRecorderCapacity, node=name)
        else:
            self.trace = NULL_TRACE
        # f+1 protocol instances (RBFT): instance i's primary is offset i
        # in the round-robin; only the master (inst 0) executes
        if num_instances <= 0:
            num_instances = self.config.replicas_count(len(validators))
        self.num_instances = num_instances
        self.data = ConsensusSharedData(
            name, validators, inst_id=0, is_master=True,
            log_size=self.config.LOG_SIZE)
        selector = RoundRobinConstantNodesPrimariesSelector(validators)
        self.data.primaries = selector.select_primaries(0, num_instances)

        self.internal_bus = InternalBus()
        self.external_bus = network.create_peer(name)
        self.stasher = StashingRouter(
            limit=1000, buses=[self.internal_bus, self.external_bus])
        # 3PC traffic is demuxed by instId BEFORE any router runs: the
        # master's per-instance services get their own router (registered
        # as instance 0) and backups register theirs, so an inbound
        # PREPARE costs one dict hop + one router pass, not one pass per
        # live instance (reference: Node.sendToReplica)
        from .instance_demux import Instance3PCDemux

        self.demux = Instance3PCDemux(self.external_bus)
        self.stasher3pc = StashingRouter(
            limit=1000, buses=[self.internal_bus])
        self.demux.register(0, self.stasher3pc)

        # --- persistence + execution -----------------------------------
        self.boot = LedgersBootstrap(
            storage=storage, pool_genesis=pool_genesis,
            domain_genesis=domain_genesis, config=self.config,
            device=device).build()
        self.boot.write_manager.metrics = self.metrics
        self.executor = NodeExecutor(
            self.boot.write_manager,
            get_view_info=lambda: (self.data.view_no,
                                   list(self.data.primaries)))
        self.req_idr_to_txn = ReqIdrToTxn()
        from .request_managers.read_request_manager import (
            ReadRequestManager,
        )

        self.read_manager = ReadRequestManager(
            self.boot.db, bls_multi_sig_getter=self._find_multi_sig)
        from .request_managers.action_request_manager import (
            ActionRequestManager,
        )

        self.restart_requested = False

        def _restart_sink():
            self.restart_requested = True  # composition reacts (test flag
            # in-process; a deployment wires a process-exit/systemd hook)

        self.action_manager = ActionRequestManager(
            node_status_provider=self.node_status,
            get_nym_data=self.boot.nym_handler.get_nym_data,
            timer=timer, restart_sink=_restart_sink)
        from collections import deque

        self._seen_action_digests = deque(maxlen=1000)

        # --- ingress: state-backed authn + propagation ------------------
        self.authnr = CoreAuthNr(verkey_source=self.boot.nym_handler,
                                 seed_keys=seed_keys, device=device)
        self.propagator = Propagator(
            name, lambda: self.data.quorums, self.external_bus,
            on_finalised=self._on_request_finalised,
            on_needs_auth=self._enqueue_for_auth,
            is_already_committed=lambda r: self.req_idr_to_txn
            .get_by_payload_digest(r.payload_digest) is not None,
            is_validator=lambda s: s in self.data.validators)
        self.requests_pool = NodeRequestsPool(
            self.propagator,
            classify=self.boot.write_manager.ledger_id_for_request)
        self.stasher.subscribe(Propagate, self.propagator.process_propagate)
        # _auth_queue holds RELAYED propagates (consensus traffic — never
        # shed); with admission control on, CLIENT writes queue in the
        # bounded AdmissionController instead and overflow sheds
        # deterministically (ingress plane, README "Ingress plane")
        self._auth_queue: List[Request] = []
        self.admission = None
        if self.config.IngressQueueCapacity > 0:
            from ..ingress.admission import AdmissionController

            self.admission = AdmissionController(
                capacity=self.config.IngressQueueCapacity,
                per_client_cap=self.config.IngressPerClientCap,
                seed=self.config.IngressShedSeed,
                clock=timer.get_current_time)
        # client message surface: digest -> client id, and the outbound
        # client messages (REQACK/REQNACK/REPLY) a transport would deliver
        self._req_clients: Dict[str, str] = {}
        self.client_outbox: List[tuple] = []  # (client_id, message)
        self.replies: Dict[str, Reply] = {}  # digest -> Reply

        # --- BLS --------------------------------------------------------
        self.bls_replica = None
        if bls_keys is not None:
            from ..bls.factory import create_bls_bft_replica
            from ..common.messages.internal_messages import RaisedSuspicion
            from ..utils.base58 import b58encode

            own_kp, pool_keys = bls_keys[name], {
                n: (pk, pop) for n, (kp, pk, pop) in bls_keys.items()}

            def pool_root():
                return b58encode(self.boot.db.get_state(
                    POOL_LEDGER_ID).committed_head_hash)

            def bls_suspicion(ex):
                self.internal_bus.send(RaisedSuspicion(inst_id=0, ex=ex))

            self.bls_replica = create_bls_bft_replica(
                name, own_kp[0], pool_keys,
                pool_state_root_provider=pool_root,
                suspicion_sink=bls_suspicion)

        # --- state-proof plane ------------------------------------------
        # per stabilized checkpoint window, cache the pool's BLS
        # multi-sig over the committed domain roots (consensus already
        # aggregated it) and serve externally-verifiable reads against
        # that window via a proof-attaching ReadService. The client
        # reply surface still serves SMT reads (read_manager); wiring
        # ReadService into it is the ROADMAP phase-2 item — the service
        # here is the bench/scripts/pool surface.
        self.proof_cache = None
        self.read_service = None
        if self.bls_replica is not None \
                and self.config.StateProofCacheWindows > 0:
            from ..ingress.read_service import LedgerBacking, ReadService
            from ..proofs import CheckpointProofCache

            self.proof_cache = CheckpointProofCache.for_domain(
                self.boot.db, self.bls_replica, bus=self.internal_bus,
                keep=self.config.StateProofCacheWindows,
                clock=timer.get_current_time,
                metrics=self.metrics, trace=self.trace, node=name)
            self.read_service = ReadService(
                LedgerBacking(self.boot.db.get_ledger(DOMAIN_LEDGER_ID),
                              bus=self.internal_bus),
                clock=timer.get_current_time, metrics=self.metrics,
                trace=self.trace, proof_cache=self.proof_cache,
                capacity=self.config.IngressReadQueueCapacity,
                seed=self.config.IngressShedSeed, device=device)

        # --- consensus services -----------------------------------------
        self.ordering = OrderingService(
            data=self.data, timer=timer, bus=self.internal_bus,
            network=self.external_bus, stasher=self.stasher3pc,
            executor=self.executor, requests=self.requests_pool,
            config=self.config, vote_plane=vote_plane,
            bls=self.bls_replica, trace=self.trace)
        self.checkpoints = CheckpointService(
            data=self.data, bus=self.internal_bus,
            network=self.external_bus, stasher=self.stasher3pc,
            config=self.config, vote_plane=vote_plane)
        self.view_changer = ViewChangeService(
            data=self.data, timer=timer, bus=self.internal_bus,
            network=self.external_bus, stasher=self.stasher,
            checkpoint_values_provider=self.checkpoints.own_checkpoint_values,
            config=self.config)
        self.vc_trigger = ViewChangeTriggerService(
            data=self.data, timer=timer, bus=self.internal_bus,
            network=self.external_bus, stasher=self.stasher,
            config=self.config)
        self.primary_monitor = PrimaryConnectionMonitorService(
            data=self.data, timer=timer, bus=self.internal_bus,
            network=self.external_bus, config=self.config)
        self.message_req = MessageReqService(
            data=self.data, bus=self.internal_bus,
            network=self.external_bus, ordering_service=self.ordering,
            view_change_service=self.view_changer,
            propagator=self.propagator)

        # --- pool membership from the pool ledger ------------------------
        from .pool_manager import PoolManager

        self.pool_manager = PoolManager(
            name, self.data,
            bls_key_register=(self.bls_replica.key_register
                              if self.bls_replica else None),
            on_membership_changed=self._on_membership_changed)
        self.pool_manager.init_from_ledger(
            self.boot.db.get_ledger(POOL_LEDGER_ID))
        # composition hook: transports / vote planes react to membership
        self.on_membership_changed_hook: Optional[Callable] = None

        # --- catchup ----------------------------------------------------
        from ..common.messages.internal_messages import RaisedSuspicion
        from .catchup import NodeLeecherService, SeederService

        self.seeder = SeederService(
            self.external_bus, self.boot.db, own_name=name,
            timer=timer, config=self.config, metrics=self.metrics)

        def catchup_suspicion(ex):
            self.internal_bus.send(RaisedSuspicion(inst_id=0, ex=ex))

        self.leecher = NodeLeecherService(
            data=self.data, bus=self.internal_bus,
            network=self.external_bus, timer=timer, bootstrap=self.boot,
            config=self.config, suspicion_sink=catchup_suspicion,
            metrics=self.metrics, trace=self.trace, device=device)

        # --- RBFT: monitor + backup instances ----------------------------
        from ..common.messages.internal_messages import (
            ViewChangeFinished,
            ViewChangeStarted,
        )
        from .monitor import Monitor
        from .replicas import Replicas

        self.monitor = Monitor(name, timer, self.internal_bus, self.config,
                               num_instances=num_instances,
                               metrics=self.metrics, trace=self.trace)
        # backup pools are bounded drop-oldest: a stalled backup primary
        # must read as a SLOW instance, not as unbounded node memory
        self.replicas = Replicas(
            name, lambda: self.data.validators, timer, self.external_bus,
            self.config,
            make_requests_pool=lambda: NodeRequestsPool(
                self.propagator,
                classify=self.boot.write_manager.ledger_id_for_request,
                bound=10 * self.config.LOG_SIZE),
            on_backup_ordered=self._on_backup_ordered,
            forward_request_propagates=self._on_request_propagates,
            num_instances=num_instances,
            vote_plane_factory=backup_vote_plane_factory,
            demux=self.demux)
        if num_instances > 1:
            self.replicas.build(0, self.data.primaries)
        self.internal_bus.subscribe(ViewChangeStarted,
                                    self._on_view_change_started)
        self.internal_bus.subscribe(ViewChangeFinished,
                                    self._on_view_change_finished)

        # --- execution + client replies ---------------------------------
        self.ordered_log: List[Ordered] = []
        self.executed_upto = self.executor.committed_seq()
        self.internal_bus.subscribe(Ordered, self._on_ordered)
        self.internal_bus.subscribe(CatchupFinished,
                                    self._on_catchup_finished)
        self.internal_bus.subscribe(RequestPropagates,
                                    self._on_request_propagates)
        # bounded byzantine-evidence log (observability; the view-change
        # vote on primary-convicting codes lives in the trigger service)
        from collections import deque

        self.suspicions = deque(maxlen=1000)
        self.internal_bus.subscribe(RaisedSuspicion,
                                    self._on_raised_suspicion)

        self._ingress_timer = RepeatingTimer(
            timer, self.config.PropagateBatchWait, self._flush_auth_queue,
            active=False)
        # tick-batched quorum mode for a standalone vote plane; a pool
        # composition that shares a grouped plane drives ticks itself.
        # Over the zstack transport this tick is the deployed node's
        # dispatch barrier: the Looper drains every pending socket read
        # (handlers enqueue signed ingress + record votes) BEFORE timer
        # events fire, so the tick always evaluates a drained transport.
        self._quorum_tick_timer = None
        self._dispatch_governor = None
        if (drive_quorum_ticks and vote_plane is not None
                and self.config.QuorumTickInterval > 0):
            vote_plane.defer_flush_on_query = True
            from ..tpu.governor import DispatchGovernor

            self._dispatch_governor = DispatchGovernor.from_config(
                self.config, metrics=self.metrics, trace=self.trace)
            interval = (self._dispatch_governor.interval
                        if self._dispatch_governor
                        else self.config.QuorumTickInterval)
            # barrier: deliveries due at the tick instant drain first, so
            # the tick evaluates a complete delivery set (dispatch plane)
            self._quorum_tick_timer = RepeatingTimer(
                timer, interval, self._quorum_tick,
                active=False, barrier=True)
        self.vote_plane = vote_plane

        # --- notifier: operator events -> pluggable sinks ----------------
        from .notifier import NotifierService

        self.notifier = NotifierService(name, self.internal_bus,
                                        timer=timer)

        # --- observers: committed batches pushed to read replicas --------
        from .observer import ObserverRegistry

        self.observer_registry = ObserverRegistry(
            self.external_bus, find_multi_sig=self._find_multi_sig)

        # --- plugins (LAST: entries get a fully constructed node) -------
        from ..plugins import load_plugins

        load_plugins(self, self.config.PluginModules)

    # ------------------------------------------------------------------

    def start(self) -> None:
        self.ordering.start()
        self._ingress_timer.start()
        if self.num_instances > 1:
            if not self.replicas.backups:  # restart after stop()
                self.replicas.build(self.data.view_no, self.data.primaries)
            self.monitor.start()
        if self._quorum_tick_timer is not None:
            self._quorum_tick_timer.start()

    def stop(self) -> None:
        self.ordering.stop()
        self._ingress_timer.stop()
        self.monitor.stop()
        self.replicas.teardown()
        if self._quorum_tick_timer is not None:
            self._quorum_tick_timer.stop()
        # teardown flush: a KV-backed collector loses up to
        # flush_every - 1 events otherwise (no-op on the plain collector)
        self.metrics.close()

    def install_signal_handlers(self,
                                dump_dir: Optional[str] = None) -> bool:
        """Deployed-node flight dump on ``SIGUSR2``: an operator can
        snapshot the ring on a LIVE node (``kill -USR2 <pid>``) without
        stopping it — the handler rides the existing ``trigger_dump``
        path (a ``flight.signal`` mark + bounded ring-tail snapshot) and,
        with ``dump_dir``, writes the full JSONL dump for ``trace_tool``.

        Deliberately NOT called by Node.__init__: only process entry
        points (``scripts/start_node.py``) install handlers — SimPool /
        NodePool / tests must never mutate process-global signal state.
        Returns False (and installs nothing) off the main thread or on
        platforms without SIGUSR2."""
        import signal
        import threading

        if not hasattr(signal, "SIGUSR2") \
                or threading.current_thread() is not threading.main_thread():
            return False

        def _on_usr2(signum, frame):
            self.trace.trigger_dump("signal", node=self.name)
            if dump_dir is not None and self.trace.enabled:
                self.trace.dump(os.path.join(
                    dump_dir, f"{self.name}.flight.jsonl"))

        signal.signal(signal.SIGUSR2, _on_usr2)
        return True

    def _quorum_tick(self) -> None:
        # dispatch-plane order: drain the signed-request ingress (one
        # device auth batch), scatter buffered votes (one grouped device
        # step), then evaluate quorums against the fresh snapshot
        trace_on = self.trace.enabled
        if trace_on:
            with self.trace.span("tick.drain", node=self.name):
                signal = self._flush_auth_queue()
        else:
            signal = self._flush_auth_queue()
        plane = self.vote_plane
        before = (plane.flushes, plane.flush_votes_total,
                  plane.flush_capacity_total, plane.readback_bytes_total)
        plane.sync()
        dispatches = plane.flushes - before[0]
        self.metrics.add_event(MetricsName.DEVICE_DISPATCHES_PER_TICK,
                               dispatches)
        # ordering fast path: the tick's actual device->host transfer —
        # O(newly certified + frontier) in device-eval mode, the full
        # event matrix under the host_eval fallback
        readback_bytes = plane.readback_bytes_total - before[3]
        self.metrics.add_event(MetricsName.DEVICE_READBACK_BYTES,
                               readback_bytes)
        self.metrics.add_event(MetricsName.DEVICE_READBACK_COMPACT,
                               0 if plane.host_eval else 1)
        if trace_on:
            # ring order matters: overlap_report closes a tick bucket at
            # each tick.flush mark, so the readback must precede it
            self.trace.record(
                "flush.readback", cat="dispatch", node=self.name,
                args={"bytes": readback_bytes, "overlapped": False})
            self.trace.record(
                "tick.flush", cat="dispatch", node=self.name,
                args={"dispatches": dispatches,
                      "votes": plane.flush_votes_total - before[1]})
        if self._dispatch_governor is not None:
            if signal is not None:
                # the tick's ingress pressure joins the occupancy the
                # governor already observes (same law as the pool driver)
                self._dispatch_governor.feed_backpressure(signal)
            self._quorum_tick_timer.update_interval(
                self._dispatch_governor.observe(
                    plane.flush_votes_total - before[1],
                    plane.flush_capacity_total - before[2], dispatches,
                    inflight=plane.lagging))
            if trace_on:
                self.trace.record(
                    "tick.governor", cat="dispatch", node=self.name,
                    args={"interval": round(
                        self._dispatch_governor.interval, 9)})
        with self.trace.span("tick.eval", node=self.name,
                             args={"nodes": 1}) if trace_on else _NO_SPAN:
            self.ordering.service_quorum_tick()
            self.checkpoints.service_quorum_tick()
            for backup in self.replicas.backups:
                if backup.vote_plane is not None:
                    backup.ordering.service_quorum_tick()
                    backup.checkpoints.service_quorum_tick()

    # ------------------------------------------------------------------
    # client ingress
    # ------------------------------------------------------------------

    def _find_multi_sig(self, state_root_b58: str) -> Optional[dict]:
        if self.bls_replica is None:
            return None
        found = self.bls_replica.store.get(state_root_b58)
        return found.as_dict() if found else None

    def submit_client_request(self, req: Request,
                              client_id: Optional[str] = None) -> bool:
        """Entry point a client transport calls. Returns False iff the
        request was NACKed synchronously (replay/bad read); authentication
        of writes is asynchronous (device-batched on the ingress tick).
        Reads are served immediately by THIS node — the reply carries the
        proof material that makes one answer trustworthy."""
        if self.action_manager.is_action(req.txn_type):
            return self._handle_action_request(req, client_id)
        if self.read_manager.is_read(req.txn_type):
            if not self.data.is_participating:
                # fail closed: while catching up (or after a FAILED catchup
                # with convicted history) our committed state is not
                # trustworthy — never answer reads from it
                self._to_client(client_id, RequestNack(
                    identifier=req.identifier, reqId=req.reqId,
                    reason="node is catching up; reads unavailable"))
                return False
            try:
                result = self.read_manager.handle(req)
            except InvalidClientRequest as ex:
                self._to_client(client_id, RequestNack(
                    identifier=req.identifier, reqId=req.reqId,
                    reason=str(ex)))
                return False
            except Exception:  # noqa: BLE001 — reads are unauthenticated;
                # a malformed one must NACK, never crash the ingress path
                logger.exception("%s: read request failed", self.name)
                self._to_client(client_id, RequestNack(
                    identifier=req.identifier, reqId=req.reqId,
                    reason="malformed read request"))
                return False
            result.update(identifier=req.identifier, reqId=req.reqId)
            self._to_client(client_id, Reply(result=result))
            return True
        # replay check FIRST: a client retrying an already-committed write
        # (lost REPLY) must learn its fate even while writes are disabled
        seen = self.req_idr_to_txn.get_by_payload_digest(req.payload_digest)
        if seen is not None:
            lid, seq = seen
            self._to_client(client_id, RequestNack(
                identifier=req.identifier, reqId=req.reqId,
                reason=f"already processed: ledger {lid} seqNo {seq}"))
            return False
        # pool-wide write switch (config ledger, POOL_CONFIG): when a
        # trustee disabled writes, every node NACKs write ingress — except
        # POOL_CONFIG itself, or the pool could never be re-enabled
        from ..common.constants import POOL_CONFIG

        if req.txn_type != POOL_CONFIG \
                and not self.boot.pool_config_handler.writes_enabled():
            self._to_client(client_id, RequestNack(
                identifier=req.identifier, reqId=req.reqId,
                reason="pool writes are disabled (POOL_CONFIG)"))
            return False
        if client_id is not None:
            self._req_clients[req.digest] = client_id
        if self.trace.enabled:
            # rid: the "identifier|reqId" pair the wire-level PROPAGATE
            # marks carry (the envelope never sees the digest) — the
            # causal plane's ingress->propagate join key
            self.trace.record("req.ingress", cat="req", node=self.name,
                              key=(req.digest,),
                              args={"rid": "%s|%s" % (req.identifier,
                                                      req.reqId)})
        if self.admission is not None:
            # bounded ingress: the shed decision is made NOW (drop-newest,
            # seeded tiebreak); the client's NACK and the shed accounting
            # ride the next auth flush so the hot path stays one offer call
            return self.admission.offer(req, client_id)
        self._auth_queue.append(req)
        return True

    def _handle_action_request(self, req: Request,
                               client_id: Optional[str]) -> bool:
        """Actions are privileged and rare: authenticate synchronously
        (host path), authorize by role, execute immediately."""

        def nack(reason: str) -> bool:
            self._to_client(client_id, RequestNack(
                identifier=req.identifier, reqId=req.reqId, reason=reason))
            return False

        try:
            verified = self.authnr.authenticate(req)
        except Exception:  # noqa: BLE001 — any auth failure is a NACK
            return nack("signature verification failed")
        if req.identifier not in verified:
            # the AUTHOR must be among the verified signers: authorization
            # reads request.identifier's role, and a multi-sig endorsement
            # by someone else must not let an attacker borrow a privileged
            # identifier (privilege escalation found in review)
            return nack("author did not sign the request")
        # replay protection: actions never hit the ledger dedup, so a
        # captured signed POOL_RESTART would otherwise be replayable
        # forever — require a fresh node-clock timestamp and reject
        # digests seen inside the freshness window
        ts = req.operation.get("timestamp")
        now = self.timer.get_current_time()
        window = self.config.ActionFreshnessWindow
        if not isinstance(ts, (int, float)) or not (
                now - window <= ts <= now + window):
            return nack("action needs a fresh 'timestamp' (node clock, "
                        f"within {window}s)")
        if req.digest in self._seen_action_digests:
            return nack("action replayed")
        self._seen_action_digests.append(req.digest)
        try:
            result = self.action_manager.handle(req)
        except InvalidClientRequest as ex:  # incl. Unauthorized subclass
            return nack(str(ex))
        except Exception:  # noqa: BLE001
            logger.exception("%s: action request failed", self.name)
            return nack("malformed action request")
        result.update(identifier=req.identifier, reqId=req.reqId)
        self._to_client(client_id, Reply(result=result))
        return True

    def node_status(self) -> Dict[str, Any]:
        """VALIDATOR_INFO payload: the operational snapshot."""
        ledgers = {}
        for lid in self.boot.db.ledger_ids:
            ledger = self.boot.db.get_ledger(lid)
            if ledger is not None:
                ledgers[str(lid)] = ledger.size
        return {
            "name": self.name,
            "view_no": self.data.view_no,
            "last_ordered_3pc": list(self.data.last_ordered_3pc),
            "stable_checkpoint": self.data.stable_checkpoint,
            "validators": list(self.data.validators),
            "primaries": list(self.data.primaries),
            "is_participating": self.data.is_participating,
            "ledger_sizes": ledgers,
            "num_instances": self.num_instances,
            "metrics": self.metrics.summary(),
            "recent_events": list(self.notifier.events)[-20:],
        }

    def _enqueue_for_auth(self, req: Request) -> None:
        """Relayed PROPAGATE whose request we haven't authenticated."""
        self._auth_queue.append(req)

    def _flush_auth_queue(self):
        """ONE device batch authenticates everything queued this tick.

        With admission control on, the tick's sheds settle here too —
        under the dedicated ``req.shed`` trace event / ``ingress.shed``
        metric and a client NACK, never under ``AUTH_BATCH_*`` (those
        stats measure only work the device actually verified) — and the
        drain returns the tick's :class:`~indy_plenum_tpu_torch
        .ingress.admission.BackpressureSignal` (pre-drain depth, sheds,
        leeching) so the standalone quorum tick can feed the dispatch
        governor the same pressure the pool-level driver does. Returns
        ``None`` when admission is off."""
        batch, self._auth_queue = self._auth_queue, []
        signal = None
        if self.admission is not None:
            from ..ingress.admission import BackpressureSignal

            depth = self.admission.depth
            admitted, shed = self.admission.drain()
            signal = BackpressureSignal(
                queue_depth=depth,
                capacity=self.admission.capacity,
                shed_delta=len(shed),
                leeching=not self.data.is_participating)
            self.metrics.add_event(MetricsName.INGRESS_QUEUE_DEPTH, depth)
            if admitted:
                self.metrics.add_event(MetricsName.INGRESS_ADMITTED,
                                       len(admitted))
            if shed:
                self.metrics.add_event(MetricsName.INGRESS_SHED,
                                       len(shed))
                for req, _cid, reason in shed:
                    if self.trace.enabled:
                        self.trace.record("req.shed", cat="req",
                                          node=self.name,
                                          key=(req.digest,),
                                          args={"reason": reason})
                    self._to_client(
                        self._req_clients.pop(req.digest, None),
                        RequestNack(
                            identifier=req.identifier, reqId=req.reqId,
                            reason="ingress overloaded: request shed "
                                   f"({reason})"))
            # client writes first, then relayed propagates: both verify
            # in the same device batch either way
            batch = admitted + batch
        if not batch:
            return signal
        if self.trace.enabled:
            # journey hop boundary: admission wait ends, auth batch
            # begins — one mark per request entering the device batch
            for req in batch:
                self.trace.record("req.admitted", cat="req",
                                  node=self.name, key=(req.digest,))
        self.metrics.add_event(MetricsName.AUTH_BATCH_SIZE, len(batch))
        with self.metrics.measure_time(MetricsName.AUTH_BATCH_TIME):
            verdicts = self.authnr.authenticate_batch(batch)
        for req, ok in zip(batch, verdicts):
            client = self._req_clients.get(req.digest)
            if not ok:
                state = self.propagator.requests.get(req.digest)
                if state is not None:
                    state.auth_pending = False
                self._to_client(client, RequestNack(
                    identifier=req.identifier, reqId=req.reqId,
                    reason="signature verification failed"))
                continue
            self._to_client(client, RequestAck(
                identifier=req.identifier, reqId=req.reqId))
            self.propagator.propagate(req, sender_client=client)
        return signal

    def _to_client(self, client_id: Optional[str], msg) -> None:
        if client_id is None:
            return  # relayed request: no client of ours is waiting on it
        self.client_outbox.append((client_id, msg))

    # ------------------------------------------------------------------
    # propagation -> ordering
    # ------------------------------------------------------------------

    def _on_request_finalised(self, request: Request) -> None:
        self.requests_pool.enqueue(request)
        self.ordering.on_request_finalised()
        self.monitor.request_finalised(request.digest)
        if self.trace.enabled:
            self.trace.record("req.finalised", cat="req", node=self.name,
                              key=(request.digest,))
        self.replicas.enqueue_finalised(request)

    def _on_backup_ordered(self, inst_id: int, ordered: Ordered) -> None:
        self.metrics.add_event(MetricsName.BACKUP_ORDERED,
                               len(ordered.reqIdr))
        self.monitor.requests_ordered(inst_id, list(ordered.reqIdr))

    def _on_membership_changed(self, validators: List[str],
                               registry: Dict[str, dict],
                               set_changed: bool = True) -> None:
        """A committed NODE txn changed the pool. ``set_changed`` is False
        for record-only changes (key/address rotation): those rewire the
        transport but must NOT tear down backup instances or reset the
        monitor — a stream of rotation txns would otherwise keep the
        degradation detector's baselines permanently empty."""
        if set_changed:
            primary = self.data.primary_name
            if primary is not None and primary not in validators:
                # the master primary was demoted: it must not keep minting
                # batches the pool accepts — vote it out now (reference:
                # plenum starts a view change when the primary leaves the
                # set)
                from ..common.messages.internal_messages import (
                    VoteForViewChange,
                )
                from .suspicion_codes import Suspicions

                logger.info("%s: primary %s demoted -> vote view change",
                            self.name, primary)
                self.internal_bus.send(VoteForViewChange(
                    suspicion=Suspicions.PRIMARY_DEMOTED))
            if self.num_instances > 1 and self.replicas.backups:
                # live backup instances still hold the old validator set
                # (and would discard the new member's votes) — rebuild
                self.replicas.build(self.data.view_no, self.data.primaries)
                self.monitor.reset(self.num_instances)
        if self.on_membership_changed_hook is not None:
            self.on_membership_changed_hook(validators, registry)

    def _on_raised_suspicion(self, msg, *args) -> None:
        ex = msg.ex
        self.suspicions.append((getattr(ex, "node", None),
                                getattr(ex, "suspicion", None)))

    def _on_view_change_started(self, msg, *args) -> None:
        # backups' votes are void in the new view; they rebuild at finish
        self.replicas.teardown()

    def _on_view_change_finished(self, msg, *args) -> None:
        self.monitor.reset(self.num_instances)
        if self.num_instances > 1:
            self.replicas.build(msg.view_no, self.data.primaries)

    def _on_request_propagates(self, msg: RequestPropagates) -> None:
        """Ordering saw a PRE-PREPARE referencing requests we lack: fetch
        peers' PROPAGATEs (digest-authenticated on the way back)."""
        for digest in msg.bad_requests:
            self.internal_bus.send(MissingMessage(
                msg_type="PROPAGATE", key=digest,
                inst_id=self.data.inst_id, dst=None))

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def _on_ordered(self, ordered: Ordered, *args) -> None:
        self.requests_pool.mark_ordered(ordered.reqIdr)
        self.monitor.requests_ordered(0, list(ordered.reqIdr))
        if ordered.ppSeqNo <= self.executed_upto:
            return  # already executed (re-ordered after view change)
        self.executed_upto = ordered.ppSeqNo
        self.ordered_log.append(ordered)
        self.metrics.add_event(MetricsName.ORDERED_BATCH_SIZE,
                               len(ordered.reqIdr))
        with self.metrics.measure_time(MetricsName.COMMIT_TIME):
            staged = self.executor.commit_batch(ordered.ppSeqNo)
        if self.trace.enabled:
            self.trace.record(
                "3pc.executed", node=self.name,
                key=(ordered.viewNo, ordered.ppSeqNo, ordered.digest))
        if staged is None:
            return
        if self.trace.enabled:
            # the executed -> durable-state-root hop (STATE_PHASE joins
            # this to 3pc.executed per (view, seq) in phase_durations)
            state = self.boot.db.get_state(staged.ledger_id)
            self.trace.record(
                "state.commit", cat="state", node=self.name,
                key=(ordered.viewNo, ordered.ppSeqNo),
                args={"ledger": staged.ledger_id,
                      "hashes": state.hashes_total if state is not None
                      else 0})
        ledger = self.boot.db.get_ledger(staged.ledger_id)
        valid = list(staged.batch.valid_digests)
        first_seq = ledger.size - len(valid) + 1
        committed_txns: List[Dict] = []
        for offset, digest in enumerate(valid):
            seq_no = first_seq + offset
            txn = ledger.get_by_seq_no(seq_no)
            committed_txns.append(txn)
            if staged.ledger_id == POOL_LEDGER_ID:
                # membership authority: committed NODE txns reconfigure
                self.pool_manager.process_committed_txn(txn)
            req = self.propagator.get(digest)
            payload_digest = req.payload_digest if req is not None else digest
            self.req_idr_to_txn.add(
                digest, payload_digest, staged.ledger_id, seq_no)
            reply = Reply(result=dict(
                txn,
                identifier=get_from(txn),
                reqId=get_req_id(txn),
                stateRootHash=ordered.stateRootHash,
                txnRootHash=ordered.txnRootHash))
            self.replies[digest] = reply
            self._to_client(self._req_clients.pop(digest, None), reply)
        self.propagator.gc(list(ordered.reqIdr))
        # read replicas get every committed batch (each-batch sync policy)
        self.observer_registry.push_batch(
            staged.ledger_id, ordered.ppSeqNo, ordered.ppTime,
            committed_txns, ordered.stateRootHash, ordered.txnRootHash)

    def _on_catchup_finished(self, msg: CatchupFinished, *args) -> None:
        self.executed_upto = max(self.executed_upto,
                                 msg.last_caught_up_3pc[1])
        # txns fetched during catchup bypassed the execution hook; the
        # pool ledger may carry membership changes we haven't absorbed
        self.pool_manager.refresh_from_ledger(
            self.boot.db.get_ledger(POOL_LEDGER_ID))

    # ------------------------------------------------------------------

    @property
    def ordered_digests(self) -> List[str]:
        out: List[str] = []
        for o in self.ordered_log:
            out.extend(o.reqIdr)
        return out

    def get_nym_data(self, did: str) -> Optional[Dict[str, Any]]:
        return self.boot.nym_handler.get_nym_data(did, is_committed=True)
