"""Simulated consensus pool: N full replica stacks on one virtual clock.

Reference pattern: plenum/test/simulation/ — ReplicaServices exchanging
messages through an in-memory network under a seeded random schedule.
Each simulated node wires the real consensus services (ordering,
checkpoint, view change, trigger, primary monitor, message-req) exactly as
the production Replica does; only the executor and request source are
simple in-memory fakes. This is the tier-5 harness AND the integration
surface for consensus changes.

Copy of ``indy_plenum_tpu/simulation/pool.py``, with its imports bound to
the port. The pool's device work (the ingress drain's Ed25519 batch verify
and the grouped quorum step, window slide and view-change zero) runs on
the CUDA card unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions. What later slices of the port bring
raises ``NotImplementedError``: real execution (ledgers, catchup, state
proofs and ``make_read_service``), BLS, a device mesh, the region latency
matrix, the closed-loop retry driver, the telemetry plane and multi-tick
device residency (``ResidentTickDepth > 1``). The ordering lanes' seams
(a shared timer, metrics collector and trace ring, the cross-lane
checkpoint barrier, the lane tick driver), the router spies and the
closed-loop retry seam are left out: the lanes and overload slices bring
them with their callers.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

from ..common.constants import DOMAIN_LEDGER_ID
from ..common.event_bus import InternalBus
from ..common.metrics_collector import MetricsCollector
from ..common.messages.node_messages import Ordered
from ..common.request import Request
from ..common.stashing_router import StashingRouter
from ..config import Config, getConfig
from ..server.consensus.checkpoint_service import CheckpointService
from ..server.consensus.consensus_shared_data import ConsensusSharedData
from ..server.consensus.message_req_service import MessageReqService
from ..server.consensus.ordering_service import (
    Executor,
    OrderingService,
    RequestsPool,
)
from ..server.consensus.primary_connection_monitor_service import (
    PrimaryConnectionMonitorService,
)
from ..server.consensus.primary_selector import (
    RoundRobinConstantNodesPrimariesSelector,
)
from ..server.consensus.view_change_service import ViewChangeService
from ..server.consensus.view_change_trigger_service import (
    ViewChangeTriggerService,
)
from ..utils.torch_env import DeviceLike
from .mock_timer import MockTimer
from .sim_network import SimNetwork


def _later_slice(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} comes with the {slice_name} slice of the port")


class SimExecutor(Executor):
    """Deterministic fake execution: roots = rolling sha256 over digests.

    Emulates the uncommitted-state behaviour of the real WriteRequestManager:
    batches apply speculatively (LIFO-revertible) and, per the Executor
    contract, an apply at or below the committed height returns the
    memoized historical roots without touching state.
    """

    def __init__(self):
        self.committed_chain = "genesis"
        self._committed_seq = 0
        self.roots_by_seq: Dict[int, str] = {}
        self.batch_chains: List[str] = []  # uncommitted chain tips

    def _root(self, chain: str) -> str:
        from ..utils.base58 import b58encode

        return b58encode(hashlib.sha256(chain.encode()).digest())

    def apply_batch(self, reqs, ledger_id, pp_time, pp_seq_no):
        if pp_seq_no <= self._committed_seq:
            root = self.roots_by_seq[pp_seq_no]
            return root, root
        tip = self.batch_chains[-1] if self.batch_chains \
            else self.committed_chain
        new_tip = hashlib.sha256(
            (tip + "".join(r.digest for r in reqs)).encode()).hexdigest()
        self.batch_chains.append(new_tip)
        root = self._root(new_tip)
        return root, root

    def revert_batches(self, ledger_id, count):
        count = min(count, len(self.batch_chains))
        if count:
            del self.batch_chains[len(self.batch_chains) - count:]

    def committed_seq(self) -> int:
        return self._committed_seq

    def commit_batch(self, pp_seq_no) -> None:
        if pp_seq_no <= self._committed_seq:
            return
        assert self.batch_chains, "commit with nothing staged"
        self.committed_chain = self.batch_chains.pop(0)
        self._committed_seq = pp_seq_no
        self.roots_by_seq[pp_seq_no] = self._root(self.committed_chain)


class SimRequestsPool(RequestsPool):
    """Finalised requests, shared across all nodes (propagation abstracted)."""

    def __init__(self):
        self._by_digest: Dict[str, Request] = {}
        self._queues: Dict[str, List[str]] = {}  # per node name

    def register_node(self, name: str) -> None:
        self._queues[name] = []

    def add_finalised(self, req: Request) -> None:
        self._by_digest[req.digest] = req
        for q in self._queues.values():
            q.append(req.digest)

    def view_for(self, name: str) -> "NodeRequestsView":
        return NodeRequestsView(self, name)


class NodeRequestsView(RequestsPool):
    def __init__(self, pool: SimRequestsPool, name: str):
        self._pool = pool
        self._name = name

    def pop_ready(self, ledger_id, max_count):
        q = self._pool._queues[self._name]
        take, self._pool._queues[self._name] = q[:max_count], q[max_count:]
        return [self._pool._by_digest[d] for d in take]

    def mark_ordered(self, digests) -> None:
        """Ordered requests leave the pending queue on EVERY node — the
        new primary after a view change must not re-propose them."""
        gone = set(digests)
        q = self._pool._queues[self._name]
        self._pool._queues[self._name] = [d for d in q if d not in gone]

    def get(self, digest):
        return self._pool._by_digest.get(digest)

    def has_ready(self, ledger_id):
        return bool(self._pool._queues[self._name])

    def ledger_ids_with_ready(self):
        return [DOMAIN_LEDGER_ID] if self.has_ready(DOMAIN_LEDGER_ID) else []


class SimNode:
    """One simulated validator: the full consensus service stack."""

    def __init__(self, name: str, validators: List[str], timer: MockTimer,
                 network: SimNetwork, requests: SimRequestsPool,
                 config: Config, device_quorum: bool = False,
                 domain_genesis: Optional[list] = None,
                 storage=None, bls_keys=None,
                 shadow_check: Optional[bool] = None,
                 vote_plane=None, trace=None, metrics=None,
                 device: DeviceLike = None):
        if domain_genesis is not None or storage is not None:
            raise _later_slice("real execution (ledgers, SMT state)",
                               "SHA-256/real-execution")
        if bls_keys is not None:
            raise _later_slice("BLS multi-signatures", "BLS")
        # shadow_check default: on whenever the device plane decides, so
        # tests continuously prove host/device equivalence. The bench turns
        # it off to run the device plane as the SOLE quorum authority.
        # Tick-batched mode is incompatible with shadow checks by design:
        # the device snapshot is deliberately one tick stale while the host
        # dicts are live, so equivalence asserts would fire spuriously.
        if shadow_check is None:
            shadow_check = device_quorum and config.QuorumTickInterval == 0
        if shadow_check and config.QuorumTickInterval > 0:
            raise ValueError(
                "shadow_check cannot be combined with QuorumTickInterval>0:"
                " deferred device snapshots intentionally lag the host"
                " tallies")
        self.name = name
        self.config = config
        from ..observability.trace import NULL_TRACE

        # pool-shared flight recorder (virtual-clock timestamps): the
        # executed mark below completes each batch's 3PC lifecycle
        self.trace = trace if trace is not None else NULL_TRACE
        self.data = ConsensusSharedData(
            name, validators, inst_id=0, is_master=True,
            log_size=config.LOG_SIZE)
        selector = RoundRobinConstantNodesPrimariesSelector(validators)
        self.data.primaries = selector.select_primaries(0, 1)

        self.internal_bus = InternalBus()
        self.external_bus = network.create_peer(name)
        self.stasher = StashingRouter(
            limit=1000, buses=[self.internal_bus, self.external_bus])
        # instId demux (same wiring as the production Node): per-instance
        # 3PC traffic takes one dict hop to ONE router — k instances must
        # not each run their router over every inbound message
        from ..server.instance_demux import Instance3PCDemux

        self.demux = Instance3PCDemux(self.external_bus)
        self.stasher3pc = StashingRouter(
            limit=1000, buses=[self.internal_bus])
        self.demux.register(0, self.stasher3pc)
        self.executor = SimExecutor()
        self.requests_view = requests.view_for(name)

        self.vote_plane = vote_plane
        if device_quorum and self.vote_plane is None:
            from ..tpu.vote_plane import DeviceVotePlane

            self.vote_plane = DeviceVotePlane(
                validators, log_size=config.LOG_SIZE,
                n_checkpoints=max(1, config.LOG_SIZE // config.CHK_FREQ),
                device=device)

        self.bls_replica = None
        self.ordering = OrderingService(
            data=self.data, timer=timer, bus=self.internal_bus,
            network=self.external_bus, stasher=self.stasher3pc,
            executor=self.executor, requests=self.requests_view,
            config=config, vote_plane=self.vote_plane,
            shadow_check=shadow_check, bls=self.bls_replica,
            trace=self.trace)
        self.checkpoints = CheckpointService(
            data=self.data, bus=self.internal_bus,
            network=self.external_bus, stasher=self.stasher3pc,
            config=config,
            vote_plane=self.vote_plane, shadow_check=shadow_check)
        self.view_changer = ViewChangeService(
            data=self.data, timer=timer, bus=self.internal_bus,
            network=self.external_bus, stasher=self.stasher,
            checkpoint_values_provider=self.checkpoints.own_checkpoint_values,
            config=config)
        self.vc_trigger = ViewChangeTriggerService(
            data=self.data, timer=timer, bus=self.internal_bus,
            network=self.external_bus, stasher=self.stasher, config=config)
        self.primary_monitor = PrimaryConnectionMonitorService(
            data=self.data, timer=timer, bus=self.internal_bus,
            network=self.external_bus, config=config)
        self.message_req = MessageReqService(
            data=self.data, bus=self.internal_bus,
            network=self.external_bus, ordering_service=self.ordering,
            view_change_service=self.view_changer)

        # execution: commit batches as they order (the Node's job);
        # re-ordered duplicates after a view change are skipped by seqNo
        self.ordered_log: List[Ordered] = []
        self.executed_upto = 0
        self.internal_bus.subscribe(Ordered, self._on_ordered)
        from ..common.messages.internal_messages import CatchupFinished

        self.internal_bus.subscribe(CatchupFinished, self._on_catchup_finished)
        self.ordering.start()

    def _on_ordered(self, ordered: Ordered, *args) -> None:
        self.requests_view.mark_ordered(ordered.reqIdr)
        if ordered.ppSeqNo <= self.executed_upto:
            return  # already executed (re-ordered after view change)
        self.executed_upto = ordered.ppSeqNo
        self.ordered_log.append(ordered)
        self.executor.commit_batch(ordered.ppSeqNo)
        if self.trace.enabled:
            self.trace.record(
                "3pc.executed", node=self.name,
                key=(ordered.viewNo, ordered.ppSeqNo, ordered.digest))

    def _on_catchup_finished(self, msg, *args) -> None:
        # batches at/below the caught-up point were executed THROUGH the
        # ledger fetch, not through Ordered
        self.executed_upto = max(self.executed_upto,
                                 msg.last_caught_up_3pc[1])

    @property
    def ordered_digests(self) -> List[str]:
        out = []
        for o in self.ordered_log:
            out.extend(o.reqIdr)
        return out


class SimPool:
    def __init__(self, n_nodes: int = 4, seed: int = 0,
                 config: Optional[Config] = None,
                 device_quorum: bool = False,
                 real_execution: bool = False,
                 sign_requests: bool = False,
                 bls: bool = False,
                 shadow_check: Optional[bool] = None,
                 num_instances: int = 1,
                 mesh=None,
                 host_accounting: bool = False,
                 pipelined_flush: bool = True,
                 host_eval: bool = False,
                 trace: bool = False,
                 trace_capacity: Optional[int] = None,
                 device: DeviceLike = None):
        if real_execution:
            raise _later_slice("real execution (ledgers, SMT state, "
                               "catchup)", "SHA-256/real-execution")
        if bls:
            raise _later_slice("BLS multi-signatures", "BLS")
        if mesh is not None:
            raise _later_slice("a device mesh", "mesh")
        self.config = config or getConfig(
            {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 10})
        self.seed = seed
        self.timer = MockTimer(start_time=1_700_000_000.0)
        self.metrics = MetricsCollector()
        # consensus flight recorder: one pool-shared ring on the VIRTUAL
        # clock, so a seeded run (chaos and mesh runs included) dumps a
        # bit-identical trace — checkable like ordered_hash()
        from ..observability.trace import NULL_TRACE, TraceRecorder

        self.trace = (TraceRecorder(
            self.timer.get_current_time,
            capacity=trace_capacity or self.config.TraceRecorderCapacity)
            if trace else NULL_TRACE)
        # geo plane (RegionCount > 0): node i lives in region i % R and
        # cross-region deliveries draw from the seeded WAN pair band.
        # Strictly opt-in — RegionCount=0 builds the exact pre-geo
        # network (no matrix, same rng sequence, same fingerprints).
        if self.config.RegionCount > 0:
            raise _later_slice("the region latency matrix", "geo")
        if self.config.TelemetryWindowSec > 0:
            raise _later_slice("the telemetry plane", "telemetry")
        self.regions: Dict[str, int] = {}
        self.region_matrix = None
        # causal tracing plane: the network stamps net.send/net.recv
        # marks on the same recorder, so cross-node journeys carry
        # measured (delayer-inclusive) per-hop network latency
        self.network = SimNetwork(
            self.timer, seed=seed, metrics=self.metrics,
            trace=self.trace,
            trace_receivers=self.config.TraceNetReceivers,
            regions=self.regions or None,
            region_matrix=self.region_matrix)
        self.validators = [f"node{i}" for i in range(n_nodes)]
        # RBFT: f+1 parallel protocol instances (0 = auto f+1); backup
        # instances get their own finalised-request queue per (node, inst)
        if num_instances <= 0:
            num_instances = self.config.replicas_count(n_nodes)
        self.num_instances = num_instances
        self.requests = SimRequestsPool()
        for name in self.validators:
            self.requests.register_node(name)
            for inst in range(1, num_instances):
                self.requests.register_node(f"{name}#{inst}")

        self.sign_requests = sign_requests
        self.trustee = None
        self.authnr = None
        self.domain_genesis = None
        if sign_requests:
            from ..common.constants import (
                TARGET_NYM,
                TRUSTEE,
                TXN_PAYLOAD,
                TXN_PAYLOAD_DATA,
                VERKEY,
            )
            from ..crypto.signers import DidSigner
            from ..ledger.genesis import genesis_nym_txn
            from ..server.client_authn import CoreAuthNr

            self.trustee = DidSigner(b"\x09" * 32)
            self.domain_genesis = [genesis_nym_txn(
                self.trustee.identifier, self.trustee.verkey, role=TRUSTEE)]
            # the ingress gate trusts the identities the domain genesis
            # names (node-state backed resolution arrives with the Node
            # composition)
            nyms = [txn[TXN_PAYLOAD][TXN_PAYLOAD_DATA]
                    for txn in self.domain_genesis]
            self.authnr = CoreAuthNr(
                seed_keys={nym[TARGET_NYM]: nym[VERKEY] for nym in nyms},
                device=device)
        self._ingress: List[Request] = []
        # admission control (ingress plane): a bounded auth queue with
        # the deterministic shed policy replaces the unbounded _ingress
        # list. The controller's tiebreak is seeded with the POOL seed,
        # so a seeded saturation run replays to the byte-identical shed
        # set (admission.shed_hash(), checkable like ordered_hash).
        self.admission = None
        if sign_requests and self.config.IngressQueueCapacity > 0:
            from ..ingress.admission import AdmissionController

            self.admission = AdmissionController(
                capacity=self.config.IngressQueueCapacity,
                per_client_cap=self.config.IngressPerClientCap,
                seed=seed, clock=self.timer.get_current_time)
        # closed-loop retry (overload robustness plane): shed requests
        # come BACK on a seeded backoff through the same admission path
        if self.admission is not None and self.config.IngressRetryMax > 0:
            raise _later_slice("the closed-loop retry driver",
                               "overload-retry")
        self.bls_keys = None

        # all nodes share ONE stacked device plane (member axis vmapped):
        # votes for the whole pool ride a single dispatch per flush
        from .quorum_driver import drive_group_ticks, make_vote_group

        self.vote_group = None
        if device_quorum:
            # the group shares the pool's collector so the dispatch-plane
            # numbers (device.flush / dispatches_per_tick / occupancy)
            # land where bench and chaos reports already look
            self.vote_group = make_vote_group(
                n_nodes, self.validators, self.config,
                num_instances=num_instances, mesh=mesh,
                pipelined=pipelined_flush, metrics=self.metrics,
                host_eval=host_eval, device=device)
            self.vote_group.trace = self.trace

        k = num_instances
        self.nodes: List[SimNode] = [
            SimNode(name, self.validators, self.timer, self.network,
                    self.requests, self.config, device_quorum=device_quorum,
                    bls_keys=self.bls_keys, shadow_check=shadow_check,
                    vote_plane=(self.vote_group.view(i * k)
                                if self.vote_group else None),
                    trace=self.trace, metrics=self.metrics, device=device)
            for i, name in enumerate(self.validators)]
        self.network.connect_all()

        # backup instances (RBFT): each node i runs instances 1..k-1 over
        # the shared external bus; device mode puts them on the group's
        # (node x instance) member axis, same vmapped dispatch as masters
        if k > 1:
            import types

            from ..server.consensus.primary_selector import (
                RoundRobinConstantNodesPrimariesSelector as _Sel,
            )
            from ..server.replicas import BackupReplica

            primaries_k = _Sel(self.validators).select_primaries(0, k)
            tick_mode = self.config.QuorumTickInterval > 0
            for i, node in enumerate(self.nodes):
                node.data.primaries = list(primaries_k)
                backups = []
                for inst in range(1, k):
                    plane = None
                    if self.vote_group is not None:
                        plane = self.vote_group.view(i * k + inst)
                        plane.defer_flush_on_query = tick_mode
                    replica = BackupReplica(
                        node.name, self.validators, inst, 0, primaries_k,
                        self.timer, node.external_bus, self.config,
                        requests_pool=self.requests.view_for(
                            f"{node.name}#{inst}"),
                        on_ordered=lambda o: None,
                        vote_plane=plane,
                        demux=node.demux)
                    replica.start()
                    backups.append(replica)
                # the shape quorum_driver's tick expects (Node.replicas)
                node.replicas = types.SimpleNamespace(backups=backups)

        # per-host CPU accounting: the simulation runs all n validators'
        # host loops serially in ONE process, so wall-clock understates a
        # deployed pool by ~n. With accounting on, each node's OWN work
        # (its inbound message handling including the sends it triggers,
        # its per-instance tick evaluation, and the FULL shared device
        # flush — conservative: a real node flushes only its own
        # num_instances-member plane) accumulates in host_seconds[name];
        # the busiest node bounds a deployed pool's throughput.
        self.host_seconds: Optional[Dict[str, float]] = None
        if host_accounting:
            self.host_seconds = {n.name: 0.0 for n in self.nodes}
            for nd in self.nodes:
                self._install_accounting(nd)

        # tick-batched quorum mode: ONE group flush per tick serves the
        # whole pool; services evaluate against that snapshot and votes
        # recorded during the wave buffer for the next tick. Signed
        # ingress rides the same tick: requests submitted during the
        # interval get ONE device batch verify at tick start.
        self._last_ingress_depth = 0
        self._last_ingress_shed = 0
        self._quorum_tick_timer = drive_group_ticks(
            self.timer, self.config, self.vote_group, self.nodes,
            accounting=self.host_seconds,
            ingress=(self._ingress_tick if self.authnr is not None
                     else None),
            trace=self.trace)
        # adaptive tick mode: the governor's interval trajectory is a
        # first-class observable (bench digests, determinism tests)
        self.governor = getattr(self._quorum_tick_timer, "governor", None)
        # occupancy-driven rebalance policy: the reference builds one only
        # for a member-sharded group, which the port does not have yet
        self.rebalance = None
        self.resource_ledger = None
        self.telemetry = None

    def _install_accounting(self, node: "SimNode") -> None:
        import time as _time

        acct = self.host_seconds
        name = node.name
        inflight = [False]  # MessageRep re-injection nests process_incoming

        def timed_call(inner):
            def wrapper(*args, **kwargs):
                if inflight[0]:
                    return inner(*args, **kwargs)
                inflight[0] = True
                # da: allow[nondet-source] -- per-node host-CPU accounting for profile_rbft; protocol time rides MockTimer, acct never feeds consensus
                t0 = _time.perf_counter()
                try:
                    return inner(*args, **kwargs)
                finally:
                    inflight[0] = False
                    # da: allow[nondet-source] -- accounting close (see t0 above)
                    acct[name] += _time.perf_counter() - t0
            return wrapper

        bus = node.external_bus
        bus.process_incoming = timed_call(bus.process_incoming)
        # timer-driven work is real host cost too: the primary's batch
        # build + PRE-PREPARE broadcast runs off the batch timer, not off
        # any inbound message (_on_batch_timer resolves send_3pc_batch on
        # self at CALL time, so instance-attribute wrapping takes effect)
        node.ordering.send_3pc_batch = timed_call(node.ordering.send_3pc_batch)
        replicas = getattr(node, "replicas", None)
        for backup in (replicas.backups if replicas else ()):
            backup.ordering.send_3pc_batch = timed_call(
                backup.ordering.send_3pc_batch)

    def node(self, name: str) -> SimNode:
        return next(n for n in self.nodes if n.name == name)

    @property
    def primary(self) -> SimNode:
        return self.node(self.nodes[0].data.primaries[0])

    def submit_request(self, seq: int,
                       client_id: Optional[str] = None,
                       region: Optional[int] = None) -> Request:
        # client_id: the ingress plane's virtual-client identity — the
        # admission controller's per-client fairness cap keys on it
        # (None = anonymous, outside any cap)
        req = Request(identifier="client1", reqId=seq,
                      operation={"type": "1", "v": seq})
        if self.trace.enabled:
            # geo plane: the submitting client's home region rides the
            # ingress mark into the journey table (None = unstamped —
            # single-region dumps keep their exact bytes)
            self.trace.record(
                "req.ingress", cat="req", key=(req.digest,),
                args={"region": region} if region is not None else None)
        if self.sign_requests:
            self.trustee.sign_request(req)
            if self.admission is not None:
                self.admission.offer(req, client_id)
            else:
                self._ingress.append(req)
        else:
            self.requests.add_finalised(req)
            if self.trace.enabled:
                self.trace.record("req.finalised", cat="req",
                                  key=(req.digest,))
        return req

    def submit_tampered_request(self, seq: int) -> Request:
        """Signed, then payload mutated: the device verify must reject it."""
        assert self.sign_requests
        req = self.submit_request(seq)
        req.operation["evil"] = True  # signature no longer covers payload
        return req

    def flush_ingress(self):
        """The node-ingress pipeline stand-in: device-batch-verify pending
        signed requests; only verified ones become finalised. Returns the
        verdict vector (test observability). In tick-batched mode the
        dispatch-plane tick calls this automatically, so every request
        submitted during the interval rides ONE Ed25519 device dispatch.

        With admission control on, the drain also settles the tick's shed
        accounting: shed requests land under the DEDICATED ``req.shed``
        trace event and ``ingress.shed`` metric — never under the
        ``AUTH_BATCH_*`` hot-path stats, which measure only work the
        device actually verified."""
        from ..common.metrics_collector import MetricsName

        trace_on = self.trace.enabled
        if self.admission is not None:
            self._last_ingress_depth = self.admission.depth
            batch, shed = self.admission.drain()
            self._last_ingress_shed = len(shed)
            self.metrics.add_event(MetricsName.INGRESS_QUEUE_DEPTH,
                                   self._last_ingress_depth)
            if batch:
                self.metrics.add_event(MetricsName.INGRESS_ADMITTED,
                                       len(batch))
            if trace_on:
                # journey hop boundary: admission wait ends (and the
                # auth device batch begins) at the tick's drain instant
                for req in batch:
                    self.trace.record("req.admitted", cat="req",
                                      key=(req.digest,))
            if shed:
                self.metrics.add_event(MetricsName.INGRESS_SHED,
                                       len(shed))
                if trace_on:
                    for req, _cid, reason in shed:
                        self.trace.record("req.shed", cat="req",
                                          key=(req.digest,),
                                          args={"reason": reason})
        else:
            batch, self._ingress = self._ingress, []
        if not batch:
            return []
        self.metrics.add_event(MetricsName.AUTH_BATCH_SIZE, len(batch))
        with self.metrics.measure_time(MetricsName.AUTH_BATCH_TIME):
            verdicts = self.authnr.authenticate_batch(batch)
        if trace_on:
            self.trace.record("tick.auth", cat="dispatch",
                              args={"batch": len(batch),
                                    "ok": int(sum(bool(v)
                                                  for v in verdicts))})
        for req, ok in zip(batch, verdicts):
            if ok:
                self.requests.add_finalised(req)
                if trace_on:
                    self.trace.record("req.finalised", cat="req",
                                      key=(req.digest,))
        return list(verdicts)

    def _ingress_tick(self):
        """The dispatch tick's ingress drain. With admission control on,
        returns the tick's :class:`~indy_plenum_tpu_torch.ingress.admission
        .BackpressureSignal` (pre-drain queue depth, sheds, leeching) —
        the quorum driver hands it to the dispatch governor, closing the
        "widen while leeching" loop. Without admission this is just
        ``flush_ingress``."""
        self.flush_ingress()
        if self.admission is None:
            return None
        from ..ingress.admission import BackpressureSignal

        return BackpressureSignal(
            queue_depth=self._last_ingress_depth,
            capacity=self.admission.capacity,
            shed_delta=self._last_ingress_shed,
            leeching=any(not nd.data.is_participating
                         for nd in self.nodes))

    def make_read_service(self, name: str = "node0", mode: str = "host",
                          capacity: int = 0,
                          region: Optional[int] = None):
        """Proof-serving reads need real execution and the state-proof
        plane, which later slices of the port bring."""
        raise _later_slice("make_read_service (proved reads)",
                           "SHA-256/real-execution")

    def run_for(self, seconds: float) -> None:
        self.timer.advance(seconds)

    def honest_nodes_agree(self) -> bool:
        logs = [tuple(n.ordered_digests) for n in self.nodes]
        lengths = {len(l) for l in logs}
        shortest = min(lengths)
        return all(l[:shortest] == logs[0][:shortest] for l in logs)

    def ordered_hash(self) -> str:
        """sha256 of node0's ordered-digest sequence — THE pool-ordering
        fingerprint (callers assert honest_nodes_agree first, so one
        node identifies the pool). bench.py's sharded sub-bench and
        check_dispatch_budget's sharded gate compare runs on it."""
        return hashlib.sha256(
            "|".join(self.nodes[0].ordered_digests).encode()).hexdigest()
