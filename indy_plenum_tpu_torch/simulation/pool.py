"""Simulated consensus pool: N full replica stacks on one virtual clock.

Reference pattern: plenum/test/simulation/ — ReplicaServices exchanging
messages through an in-memory network under a seeded random schedule.
Each simulated node wires the real consensus services (ordering,
checkpoint, view change, trigger, primary monitor, message-req) exactly as
the production Replica does; only the executor and request source are
simple in-memory fakes. This is the tier-5 harness AND the integration
surface for consensus changes.

Copy of ``indy_plenum_tpu/simulation/pool.py``, with its imports bound to
the port. The pool's device work (the ingress drain's Ed25519 batch verify,
the grouped quorum step, window slide and view-change zero, and with real
execution the SMT commit's hash waves and the proved reads' audit-path
folds) runs on the CUDA card unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions. With ``real_execution``
every node executes through its own ledgers and SMT states
(``LedgersBootstrap`` + ``NodeExecutor``) and runs the catchup plane:
every node seeds (``SeederService``), and a ``NodeLeecherService``
consumes ``NeedMasterCatchup`` and verifies the fetched txns' audit
proofs on the pool's device (K10); without it, ``SimExecutor`` fakes the
roots. With ``bls`` every node co-signs its roots (``BlsBftReplica``) and,
with real execution, captures each stabilized window's multi-signature in
its ``proof_cache``, so proved reads verify with nothing but the pool's
BLS keys. With ``ResidentTickDepth > 1`` the vote group runs its
multi-tick residency ring (one fused device step per up to that many
ticks, checkpoint slides folded in). ``mesh`` (a ``FabricMesh`` from
``tpu.quorum.make_fabric_mesh`` whose first home tile is the pool's
device) runs the vote group as the member x validator fabric, in one
state on that device or with every tile on its own device (the per-tile
layout), and with
``RebalanceSkewThreshold`` or ``RebalanceForceTick`` armed
``pool.rebalance`` plans member-plane rotations. The workload planes ride
the same pool: the closed-loop retry driver (``IngressRetryMax``), the
region latency matrix (``RegionCount``), the telemetry plane and its
resource ledger (``TelemetryWindowSec``), the router spies (``spy``) and
the ordering lanes' seams (a shared timer, metrics collector and trace
ring, the cross-lane checkpoint barrier, ``drive_ticks=False`` for the
lane tick of ``lanes/pool.py``), all host code around the same kernels.
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
                 barrier=None, lane: int = 0,
                 device: DeviceLike = None):
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
        self.boot = None
        if domain_genesis is not None:
            # real execution: ledgers + SMT states + audit spine per node
            from ..server.ledgers_bootstrap import LedgersBootstrap
            from ..server.request_managers.write_request_manager import (
                NodeExecutor,
            )

            self.boot = LedgersBootstrap(
                storage=storage, domain_genesis=domain_genesis,
                config=config, device=device).build()
            self.boot.write_manager.metrics = metrics
            self.executor = NodeExecutor(
                self.boot.write_manager,
                get_view_info=lambda: (self.data.view_no,
                                       list(self.data.primaries)))
        else:
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
        if bls_keys is not None:
            from ..bls.factory import create_bls_bft_replica
            from ..utils.base58 import b58encode

            own_kp, pool_keys = bls_keys[name], {
                n: (pk, pop) for n, (kp, pk, pop) in bls_keys.items()}

            def pool_root():
                if self.boot is None:
                    return ""
                from ..common.constants import POOL_LEDGER_ID

                return b58encode(self.boot.db.get_state(
                    POOL_LEDGER_ID).committed_head_hash)

            def bls_suspicion(ex):
                from ..common.messages.internal_messages import (
                    RaisedSuspicion,
                )

                self.internal_bus.send(RaisedSuspicion(inst_id=0, ex=ex))

            self.bls_replica = create_bls_bft_replica(
                name, own_kp[0], pool_keys,
                pool_state_root_provider=pool_root,
                suspicion_sink=bls_suspicion)

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
            vote_plane=self.vote_plane, shadow_check=shadow_check,
            barrier=barrier, lane=lane)
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

        # state-proof plane: per stabilized checkpoint window, capture
        # the pool's BLS multi-sig over the committed roots (already
        # aggregated by consensus) so proved reads attach it for free —
        # rides the same CheckpointStabilized hook as LedgerBacking
        self.proof_cache = None
        if self.boot is not None and self.bls_replica is not None \
                and config.StateProofCacheWindows > 0:
            from ..proofs import CheckpointProofCache

            self.proof_cache = CheckpointProofCache.for_domain(
                self.boot.db, self.bls_replica, bus=self.internal_bus,
                keep=config.StateProofCacheWindows,
                clock=timer.get_current_time,
                metrics=metrics, trace=self.trace, node=name)

        # catchup plane (requires real ledgers): every node seeds; the
        # leecher consumes NeedMasterCatchup from the checkpoint service,
        # and verifies the fetched slices' audit proofs on ``device``
        self.seeder = None
        self.leecher = None
        if self.boot is not None:
            from ..server.catchup import NodeLeecherService, SeederService

            self.seeder = SeederService(
                self.external_bus, self.boot.db, own_name=name,
                timer=timer, config=config, metrics=metrics)

            def catchup_suspicion(ex):
                from ..common.messages.internal_messages import (
                    RaisedSuspicion,
                )

                self.internal_bus.send(RaisedSuspicion(inst_id=0, ex=ex))

            self.leecher = NodeLeecherService(
                data=self.data, bus=self.internal_bus,
                network=self.external_bus, timer=timer, bootstrap=self.boot,
                config=config, suspicion_sink=catchup_suspicion,
                metrics=metrics, trace=self.trace, device=device)

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
        staged = self.executor.commit_batch(ordered.ppSeqNo)
        if self.trace.enabled:
            self.trace.record(
                "3pc.executed", node=self.name,
                key=(ordered.viewNo, ordered.ppSeqNo, ordered.digest))
            if staged is not None and self.boot is not None:
                # executed -> durable-state-root hop (STATE_PHASE join)
                state = self.boot.db.get_state(staged.ledger_id)
                self.trace.record(
                    "state.commit", cat="state", node=self.name,
                    key=(ordered.viewNo, ordered.ppSeqNo),
                    args={"ledger": staged.ledger_id,
                          "hashes": state.hashes_total
                          if state is not None else 0})

    def _on_catchup_finished(self, msg, *args) -> None:
        # batches at/below the caught-up point were executed THROUGH the
        # ledger fetch, not through Ordered
        self.executed_upto = max(self.executed_upto,
                                 msg.last_caught_up_3pc[1])

    def read_nym_with_proof(self, did: str):
        """Proved read from THIS node alone (requires real_execution+bls):
        value + SMT inclusion proof + the pool's multi-sig over the root."""
        from ..client.state_proof import StateProofReply
        from ..common.constants import DOMAIN_LEDGER_ID
        from ..utils.base58 import b58encode

        state = self.boot.db.get_state(DOMAIN_LEDGER_ID)
        root = state.committed_head_hash
        key = did.encode()
        value = state.get(key, is_committed=True)
        proof = state.generate_state_proof(key, root=root, serialize=True)
        ms = None
        if self.bls_replica is not None:
            found = self.bls_replica.store.get(b58encode(root))
            ms = found.as_dict() if found else None
        return StateProofReply(key=key, value=value, root=root,
                               proof=proof, multi_sig_dict=ms)

    @property
    def ordered_digests(self) -> List[str]:
        out = []
        for o in self.ordered_log:
            out.extend(o.reqIdr)
        return out

    @property
    def committed_request_digests(self) -> List[str]:
        """The committed domain ledger's request-digest sequence — the
        ordering fingerprint that COVERS catchup: a node that leeched a
        range never saw its ``Ordered`` events, but the fetched txns
        carry the original request digests in their metadata, so the
        ledger sequence is bit-comparable across survivors and
        freshly-caught-up nodes. Requires real execution."""
        from ..common.constants import DOMAIN_LEDGER_ID
        from ..common.txn_util import get_digest

        ledger = self.boot.db.get_ledger(DOMAIN_LEDGER_ID)
        return [get_digest(ledger.get_by_seq_no(s)) or ""
                for s in range(1, ledger.size + 1)]


class _TelemetryTap:
    """The telemetry plane's deterministic consensus tap: per-node
    executed-txn tallies (mirroring :meth:`SimNode._on_ordered`'s
    re-order dedupe so the count means *executed*, not delivered), e2e
    latency samples (virtual pre-prepare -> executed seconds), and the
    window pulses that roll rollup boundaries — all driven by internal
    bus events at virtual instants, so every series replays
    byte-identically per seed."""

    def __init__(self, plane, clock):
        self.plane = plane
        self.clock = clock
        self.txns: Dict[str, int] = {}
        self._upto: Dict[str, int] = {}

    def attach(self, node) -> None:
        from ..common.messages.internal_messages import CheckpointStabilized

        self.txns[node.name] = 0
        self._upto[node.name] = 0
        node.internal_bus.subscribe(
            Ordered,
            lambda o, *a, _n=node.name: self._on_ordered(_n, o))
        node.internal_bus.subscribe(CheckpointStabilized,
                                    self._on_stabilized)

    def _on_ordered(self, name: str, ordered) -> None:
        if ordered.ppSeqNo <= self._upto[name]:
            return  # re-ordered after view change; already executed
        self._upto[name] = ordered.ppSeqNo
        self.txns[name] += len(ordered.reqIdr)
        now = self.clock()
        self.plane.observe_latency(now - ordered.ppTime)
        self.plane.pulse(now)

    def _on_stabilized(self, msg, *args) -> None:
        if msg.inst_id != 0:
            return  # master instance only, like the proof cache
        self.plane.pulse(self.clock())

    def ordered_txns(self) -> int:
        """Pool progress = the max per-node tally: a crashed node's
        stalled counter (its gap arrives via catchup, not Ordered) must
        not read as pool throughput loss."""
        return max(self.txns.values()) if self.txns else 0


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
                 spy: bool = False,
                 trace: bool = False,
                 trace_capacity: Optional[int] = None,
                 timer: Optional[MockTimer] = None,
                 metrics: Optional[MetricsCollector] = None,
                 trace_recorder=None,
                 drive_ticks: bool = True,
                 barrier=None,
                 lane: int = 0,
                 device: DeviceLike = None):
        # injection seams (ordering lanes, lanes/pool.py): a LanedPool
        # composes K SimPools as lanes on ONE shared timer / metrics
        # collector / flight-recorder ring (each lane recording through
        # its LaneTraceView), with the cross-lane checkpoint barrier
        # threaded into every lane's CheckpointService and the pool-level
        # tick replaced by the multi-lane driver (drive_ticks=False).
        self.config = config or getConfig(
            {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 10})
        self.seed = seed
        self.timer = timer if timer is not None \
            else MockTimer(start_time=1_700_000_000.0)
        self.metrics = metrics if metrics is not None else MetricsCollector()
        self.lane = lane
        # consensus flight recorder: one pool-shared ring on the VIRTUAL
        # clock, so a seeded run (chaos and mesh runs included) dumps a
        # bit-identical trace — checkable like ordered_hash()
        from ..observability.trace import NULL_TRACE, TraceRecorder

        if trace_recorder is not None:
            self.trace = trace_recorder
        else:
            self.trace = (TraceRecorder(
                self.timer.get_current_time,
                capacity=trace_capacity
                or self.config.TraceRecorderCapacity)
                if trace else NULL_TRACE)
        # geo plane (RegionCount > 0): node i lives in region i % R and
        # cross-region deliveries draw from the seeded WAN pair band.
        # Strictly opt-in — RegionCount=0 builds the exact pre-geo
        # network (no matrix, same rng sequence, same fingerprints).
        self.regions: Dict[str, int] = {}
        self.region_matrix = None
        if self.config.RegionCount > 0:
            from .sim_network import RegionLatencyMatrix

            self.regions = {f"node{i}": i % self.config.RegionCount
                            for i in range(n_nodes)}
            self.region_matrix = RegionLatencyMatrix(
                self.config.RegionCount,
                self.config.RegionLatencySeed or seed,
                intra_band=(0.01, 0.05),
                wan_band=(self.config.RegionWanMinLatency,
                          self.config.RegionWanMaxLatency))
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

        self.real_execution = real_execution
        self.sign_requests = sign_requests
        self.device = device
        self.trustee = None
        self.authnr = None
        domain_genesis = None
        if real_execution or sign_requests:
            from ..common.constants import TRUSTEE
            from ..crypto.signers import DidSigner
            from ..ledger.genesis import genesis_nym_txn

            self.trustee = DidSigner(b"\x09" * 32)
            domain_genesis = [genesis_nym_txn(
                self.trustee.identifier, self.trustee.verkey, role=TRUSTEE)]
        if sign_requests:
            from ..server.client_authn import CoreAuthNr

            # the ingress gate: genesis identities via seed_keys (node-state
            # backed resolution arrives with the Node composition)
            self.authnr = CoreAuthNr(seed_keys={
                self.trustee.identifier: self.trustee.verkey}, device=device)
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
        # come BACK on a seeded backoff — the drain hands each tick's
        # sheds to the RetryDriver, which re-offers them through the
        # same admission path (fairness cap and shed cohort included).
        # Seeded with the POOL seed like the shed tiebreak, so the
        # retry storm replays byte-identically (retry_hash).
        self.retry = None
        if self.admission is not None and self.config.IngressRetryMax > 0:
            from ..ingress.retry import RetryDriver, RetryPolicy

            self.retry = RetryDriver(
                RetryPolicy.from_config(self.config, seed=seed),
                self.timer, self._retry_offer,
                metrics=self.metrics, trace=self.trace)

        self.bls_keys = None
        if bls:
            from ..bls.factory import generate_bls_keys

            self.bls_keys = {
                name: generate_bls_keys(
                    hashlib.sha256(b"sim-bls-" + name.encode()).digest())
                for name in self.validators}

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
                    domain_genesis=domain_genesis if real_execution else None,
                    bls_keys=self.bls_keys, shadow_check=shadow_check,
                    vote_plane=(self.vote_group.view(i * k)
                                if self.vote_group else None),
                    trace=self.trace, metrics=self.metrics,
                    barrier=barrier, lane=lane, device=device)
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
        # spy instrumentation (reference: plenum/test/testable.py): every
        # node's routers record (msg, sender, verdict, sim-time) — tests
        # can assert exact processing counts, not just end states. Query
        # via pool.spy_of(name, inst_id).
        self._spies: Dict[tuple, object] = {}
        if spy:
            from ..common.stashing_router import RouterSpy

            clock = self.timer.get_current_time
            for nd in self.nodes:
                for st, key in ((nd.stasher3pc, (nd.name, 0, "3pc")),
                                (nd.stasher, (nd.name, 0, "other"))):
                    st.spy = RouterSpy(clock=clock)
                    self._spies[key] = st.spy
                replicas = getattr(nd, "replicas", None)
                for backup in (replicas.backups if replicas else ()):
                    backup.stasher.spy = RouterSpy(clock=clock)
                    self._spies[(nd.name, backup.inst_id, "3pc")] = \
                        backup.stasher.spy

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
        # drive_ticks=False: a composing driver (the multi-lane tick in
        # quorum_driver.drive_lane_ticks) owns the pool-level tick
        self._quorum_tick_timer = drive_group_ticks(
            self.timer, self.config, self.vote_group, self.nodes,
            accounting=self.host_seconds,
            ingress=(self._ingress_tick if self.authnr is not None
                     else None),
            trace=self.trace) if drive_ticks else None
        # adaptive tick mode: the governor's interval trajectory is a
        # first-class observable (bench digests, determinism tests)
        self.governor = getattr(self._quorum_tick_timer, "governor", None)
        # occupancy-driven rebalance policy (None unless sharded + armed)
        self.rebalance = getattr(self._quorum_tick_timer, "rebalance", None)
        # long-horizon telemetry plane (observability/telemetry.py):
        # TelemetryWindowSec > 0 registers every bounded structure in ONE
        # resource ledger and rolls windowed series off deterministic
        # consensus pulses; unarmed pools pay nothing (no ledger, no bus
        # subscribers). Pools that delegate their tick (drive_ticks=False,
        # the multi-lane composition) leave arming to the composer.
        self.resource_ledger = None
        self.telemetry = None
        self._telemetry_tap = None
        self._read_backing_seq = 0
        if drive_ticks and self.config.TelemetryWindowSec > 0:
            self._arm_telemetry()

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

    def spy_of(self, name: str, inst_id: int = 0, router: str = "3pc"):
        """The RouterSpy for ``name``'s instance router (pool built with
        spy=True); ``router``: "3pc" (ordering/checkpoint traffic) or
        "other" (view change / instance change / message req)."""
        return self._spies[(name, inst_id, router)]

    @property
    def primary(self) -> SimNode:
        return self.node(self.nodes[0].data.primaries[0])

    def build_request(self, seq: int) -> Request:
        """Construct (but do not submit) the pool's standard request for
        ``seq`` — the seam the lane router needs: a LanedPool builds the
        request first, routes it by its key, THEN submits it to the
        owning lane (``submit_built``)."""
        if self.real_execution:
            from ..common.constants import NYM, TARGET_NYM, TXN_TYPE, VERKEY
            from ..crypto.signers import DidSigner

            target = DidSigner(hashlib.sha256(
                b"sim-target-%d" % seq).digest())
            req = Request(
                identifier=self.trustee.identifier, reqId=seq,
                operation={TXN_TYPE: NYM, TARGET_NYM: target.identifier,
                           VERKEY: target.verkey})
            req.target_signer = target  # test convenience
        else:
            req = Request(identifier="client1", reqId=seq,
                          operation={"type": "1", "v": seq})
        return req

    def submit_request(self, seq: int,
                       client_id: Optional[str] = None,
                       region: Optional[int] = None) -> Request:
        # client_id: the ingress plane's virtual-client identity — the
        # admission controller's per-client fairness cap keys on it
        # (None = anonymous, outside any cap)
        return self.submit_built(self.build_request(seq), client_id,
                                 region=region)

    def submit_built(self, req: Request,
                     client_id: Optional[str] = None,
                     region: Optional[int] = None) -> Request:
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

    def _retry_offer(self, req: Request,
                     client_id: Optional[str] = None) -> None:
        """The retry driver's re-offer seam: the SAME request (already
        signed, ``req.ingress`` already marked at first arrival)
        re-enters the bounded queue like any arrival — it competes in
        the same-instant shed cohort and counts against its client's
        fairness cap (no retry-based cap evasion)."""
        self.admission.offer(req, client_id)

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
            if self.retry is not None and batch:
                # the goodput split: admitted work that needed >= 1
                # retry vs first-attempt admissions
                readmitted = sum(
                    1 for req in batch
                    if req.digest in self.retry.retried_digests)
                if readmitted:
                    self.metrics.add_event(
                        MetricsName.INGRESS_RETRY_ADMITTED, readmitted)
            if shed:
                self.metrics.add_event(MetricsName.INGRESS_SHED,
                                       len(shed))
                if trace_on:
                    for req, _cid, reason in shed:
                        self.trace.record("req.shed", cat="req",
                                          key=(req.digest,),
                                          args={"reason": reason})
                if self.retry is not None:
                    # the closed loop: this tick's sheds schedule their
                    # seeded-backoff re-offers on the virtual timer
                    for req, cid, reason in shed:
                        self.retry.on_shed(req, cid, reason)
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
                         for nd in self.nodes),
            # re-offers still waiting on the timer: load the pool owes
            # itself — holds the governor's narrow between shed bursts
            retry_pressure=(self.retry.outstanding
                            if self.retry is not None else 0))

    def _arm_telemetry(self) -> None:
        """Build the resource ledger + telemetry plane and register every
        bounded structure the pool composed: trace rings, metrics
        histograms, admission queue, retry cohort, per-node proof caches,
        SMT node caches / dirty overlays, staged write batches and
        request queues. Series: ordered txns (the tap's max-node tally),
        shed/retry counters, governor occupancy EWMA."""
        from ..observability.telemetry import (
            ResourceLedger,
            SizedResource,
            TelemetryPlane,
        )

        ledger = ResourceLedger()
        plane = TelemetryPlane.from_config(
            self.config, ledger, t0=self.timer.get_current_time(),
            metrics=self.metrics, trace=self.trace)
        self.resource_ledger = ledger
        self.telemetry = plane
        if self.trace.enabled:
            ledger.register_all(self.trace.sized_resources())
        ledger.register_all(self.metrics.sized_resources())
        if self.admission is not None:
            ledger.register_all(self.admission.sized_resources())
        if self.retry is not None:
            ledger.register_all(self.retry.sized_resources())
        for nd in self.nodes:
            p = nd.name + "."
            ledger.register(SizedResource(
                p + "requests_queue",
                (lambda _q=self.requests._queues, _n=nd.name:
                 len(_q.get(_n, ()))),
                bound=None, entry_bytes=64))
            if nd.proof_cache is not None:
                ledger.register_all(
                    nd.proof_cache.sized_resources(p + "proof_cache."))
            if nd.boot is not None:
                state = nd.boot.db.get_state(DOMAIN_LEDGER_ID)
                if state is not None and hasattr(state, "sized_resources"):
                    ledger.register_all(
                        state.sized_resources(p + "state."))
                wm = nd.boot.write_manager
                if hasattr(wm, "_staged"):
                    ledger.register(SizedResource(
                        p + "staged_batches",
                        (lambda _w=wm: len(_w._staged)),
                        bound=None, entry_bytes=256))
        tap = _TelemetryTap(plane, self.timer.get_current_time)
        for nd in self.nodes:
            tap.attach(nd)
        self._telemetry_tap = tap
        plane.add_counter("ordered", tap.ordered_txns)
        plane.add_counter(
            "shed", lambda: (self.admission.shed_total
                             if self.admission is not None else 0))
        plane.add_counter(
            "retry", lambda: (self.retry.reoffers_total
                              if self.retry is not None else 0))
        plane.add_gauge(
            "occupancy_ewma",
            lambda: (float(self.governor.ewma)
                     if self.governor is not None else 0.0))

    def make_read_service(self, name: str = "node0", mode: str = "host",
                          capacity: int = 0,
                          region: Optional[int] = None):
        """A proof-serving :class:`~indy_plenum_tpu_torch.ingress
        .read_service.ReadService` over ``name``'s committed domain ledger
        (requires real_execution): the backing rides the node's
        checkpoint-stabilized hook and, when the node runs the state-proof
        plane, replies carry the pool's window multi-signature.
        ``capacity`` bounds the read queue (seeded with the POOL seed,
        like the write side); ``region`` (default: the serving node's pool
        region, when the geo plane is armed) tags the read-journey marks
        so causal summaries segregate read e2e per region. The service
        verifies on the pool's device."""
        from ..ingress.read_service import LedgerBacking, ReadService

        node = self.node(name)
        assert node.boot is not None, "make_read_service needs real ledgers"
        if region is None:
            region = self.regions.get(name)
        backing = LedgerBacking(
            node.boot.db.get_ledger(DOMAIN_LEDGER_ID),
            bus=node.internal_bus)
        if self.resource_ledger is not None:
            # telemetry armed: late-built read backings join the ledger
            # too (ordinal-prefixed — a bench may build several per node)
            self._read_backing_seq += 1
            self.resource_ledger.register_all(backing.sized_resources(
                f"{name}.read_backing{self._read_backing_seq}."))
        return ReadService(
            backing, clock=self.timer.get_current_time,
            metrics=self.metrics, trace=self.trace, mode=mode,
            proof_cache=node.proof_cache, capacity=capacity,
            seed=self.config.IngressShedSeed or self.seed, name=name,
            region=region, device=self.device)

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

    def ledger_hash(self, name: str) -> str:
        """sha256 of ``name``'s committed domain-ledger request-digest
        sequence (real execution only) — the per-node ordering
        fingerprint that stays comparable ACROSS CATCHUP: a node that
        leeched a GC'd range has the identical ledger sequence as the
        survivors even though its ``ordered_log`` skips the leeched
        middle."""
        return hashlib.sha256("|".join(
            self.node(name).committed_request_digests).encode()).hexdigest()
