"""Full-stack simulated pool: real Node composition roots on a sim network.

Unlike :mod:`indy_plenum_tpu_torch.simulation.pool` (which wires the
consensus services directly and abstracts request dissemination into one
shared pool), every validator here is a real
:class:`~indy_plenum_tpu_torch.server.node.Node`: client requests enter
ONE node, get device-batch authenticated, spread via PROPAGATE to the f+1
finalisation quorum, order through 3PC, execute against real ledgers/SMT
state, and produce client Replies. This is the integration surface for
the Node/Propagator layer.

Copy of ``indy_plenum_tpu/simulation/node_pool.py``, with its imports
bound to the port. The pool's device work (every node's ingress drain
through the Ed25519 batch verify, the grouped quorum step over the (node x
instance) member planes, the window slide and view-change zero, the SMT
commits' hash waves) runs on the CUDA card unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions; without
a card the pool raises. ``mesh`` is a ``FabricMesh`` from
``tpu.quorum.make_fabric_mesh`` whose first home tile is the pool's
device.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

from ..common.constants import TRUSTEE
from ..common.metrics_collector import MetricsCollector
from ..common.request import Request
from ..config import Config, getConfig
from ..crypto.signers import DidSigner
from ..ledger.genesis import genesis_nym_txn
from ..server.node import Node
from ..utils.torch_env import DeviceLike, resolve_device
from .mock_timer import MockTimer
from .sim_network import SimNetwork


class NodePool:
    def __init__(self, n_nodes: int = 4, seed: int = 0,
                 config: Optional[Config] = None,
                 device_quorum: bool = False,
                 bls: bool = False,
                 num_instances: int = 1,
                 with_pool_genesis: bool = False,
                 mesh=None,
                 host_eval: bool = False,
                 trace: bool = False,
                 device: DeviceLike = None):
        # num_instances: 1 = master only; 0 = auto f+1 (full RBFT)
        # mesh: run the grouped vote plane's (node x instance) member
        # axis as the member x validator fabric on the pool's one device
        self.device = resolve_device(device)
        self.config = config or getConfig(
            {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 10,
             "PropagateBatchWait": 0.05})
        # simulation contract (config.IngressShedSeed): sim pools seed
        # the shed tiebreak from the POOL seed so the shed set replays
        # with the run; an explicit IngressShedSeed in the config wins.
        # replace(), not in-place: the caller's config may build other
        # pools and must not inherit this pool's seed
        if self.config.IngressQueueCapacity > 0 \
                and not self.config.IngressShedSeed:
            import dataclasses

            self.config = dataclasses.replace(
                self.config, IngressShedSeed=seed)
        self.timer = MockTimer(start_time=1_700_000_000.0)
        self.metrics = MetricsCollector()
        # pool-shared flight recorder on the virtual clock (deterministic
        # dumps); every Node's services + Monitor share it
        from ..observability.trace import NULL_TRACE, TraceRecorder

        self.trace = (TraceRecorder(
            self.timer.get_current_time,
            capacity=self.config.TraceRecorderCapacity)
            if trace else NULL_TRACE)
        # causal tracing plane: PROPAGATE fan-out and 3PC waves between
        # real Node compositions stamp net.send/net.recv on the shared
        # recorder — journeys join them across nodes
        self.network = SimNetwork(
            self.timer, seed=seed, metrics=self.metrics,
            trace=self.trace,
            trace_receivers=self.config.TraceNetReceivers)
        self.validators = [f"node{i}" for i in range(n_nodes)]

        self.trustee = DidSigner(b"\x09" * 32)
        domain_genesis = [genesis_nym_txn(
            self.trustee.identifier, self.trustee.verkey, role=TRUSTEE)]
        seed_keys = {self.trustee.identifier: self.trustee.verkey}

        # pool genesis: one NODE txn per initial validator, owned by one
        # steward each (membership-from-ledger mode; the PoolManager takes
        # over the validator registry)
        self.stewards: Dict[str, DidSigner] = {}
        self.pool_genesis = None
        self._domain_genesis = domain_genesis
        self._seed_keys = seed_keys
        if with_pool_genesis:
            from ..common.constants import STEWARD
            from ..ledger.genesis import genesis_node_txn

            self.pool_genesis = []
            for i, name in enumerate(self.validators):
                steward = DidSigner(hashlib.sha256(
                    b"pool-steward-%d" % i).digest())
                self.stewards[name] = steward
                domain_genesis.append(genesis_nym_txn(
                    steward.identifier, steward.verkey, role=STEWARD))
                self.pool_genesis.append(genesis_node_txn(
                    node_nym=f"nym-{name}", alias=name,
                    steward_did=steward.identifier,
                    node_port=9700 + 2 * i, client_port=9701 + 2 * i))

        self.bls_keys = None
        if bls:
            from ..bls.factory import generate_bls_keys

            self.bls_keys = {
                name: generate_bls_keys(
                    hashlib.sha256(b"sim-bls-" + name.encode()).digest())
                for name in self.validators}

        from .quorum_driver import drive_group_ticks, make_vote_group

        # resolve the instance count the same way Node does, so the
        # (node x instance) group axis matches the replicas actually built
        resolved_instances = (num_instances if num_instances > 0
                              else self.config.replicas_count(n_nodes))
        self.num_instances = resolved_instances
        self.vote_group = None
        if device_quorum:
            self.vote_group = make_vote_group(
                n_nodes, self.validators, self.config,
                num_instances=resolved_instances, mesh=mesh,
                metrics=self.metrics, host_eval=host_eval, device=self.device)
            self.vote_group.trace = self.trace

        tick_mode = self.config.QuorumTickInterval > 0

        def backup_plane_factory(node_idx: int):
            if self.vote_group is None:
                return None

            def factory(inst_id: int):
                plane = self.vote_group.view(
                    node_idx * resolved_instances + inst_id)
                plane.defer_flush_on_query = tick_mode
                return plane

            return factory

        self.nodes: List[Node] = []
        for i, name in enumerate(self.validators):
            plane = (self.vote_group.view(i * resolved_instances)
                     if self.vote_group else None)
            node = Node(
                name, self.validators, self.timer, self.network,
                config=self.config, domain_genesis=domain_genesis,
                pool_genesis=([dict(t) for t in self.pool_genesis]
                              if self.pool_genesis else None),
                seed_keys=dict(seed_keys), bls_keys=self.bls_keys,
                vote_plane=plane, num_instances=num_instances,
                drive_quorum_ticks=False,  # the pool drives group ticks
                # shared collector: the dispatch-plane numbers the pool
                # tick records are then visible in every node's
                # Monitor.snapshot() (and node metrics aggregate pool-wide)
                metrics=self.metrics,
                backup_vote_plane_factory=backup_plane_factory(i),
                trace=self.trace, device=self.device)
            self.nodes.append(node)
        self.network.connect_all()
        for node in self.nodes:
            node.start()

        _shed_seen: Dict[str, int] = {}

        def drain_auth_queues():
            # ingress rides the dispatch tick: each node's queued signed
            # requests get one device auth batch before votes scatter
            # (the per-node PropagateBatchWait timer still covers the
            # per-message mode and sub-interval bursts). With admission
            # control on, the drain aggregates the pool's backpressure —
            # the BUSIEST node's queue depth, the tick's total sheds, and
            # whether anyone is leeching — for the dispatch governor.
            depth = shed = 0
            bounded = False
            for nd in self.nodes:
                adm = nd.admission
                if adm is not None:
                    bounded = True
                    depth = max(depth, adm.depth)
                    # sheds since the LAST tick (offer-time sheds
                    # included, not just ones settled by this flush)
                    prev = _shed_seen.get(nd.name, 0)
                    nd._flush_auth_queue()
                    shed += adm.shed_total - prev
                    _shed_seen[nd.name] = adm.shed_total
                else:
                    nd._flush_auth_queue()
            if not bounded:
                return None
            from ..ingress.admission import BackpressureSignal

            return BackpressureSignal(
                queue_depth=depth,
                capacity=self.config.IngressQueueCapacity,
                shed_delta=shed,
                leeching=any(not nd.data.is_participating
                             for nd in self.nodes))

        self._quorum_tick_timer = drive_group_ticks(
            self.timer, self.config, self.vote_group, self.nodes,
            ingress=drain_auth_queues, trace=self.trace)
        self.governor = getattr(self._quorum_tick_timer, "governor", None)

        self._req_seq = 0

    def add_node(self, name: str) -> Node:
        """Spin up a validator that the pool has ALREADY admitted via a
        committed NODE txn; it bootstraps from genesis and catches up the
        ledgers (including the NODE txn that admitted it)."""
        validators = list(self.nodes[0].data.validators)
        assert name in validators, f"{name} not in the committed membership"
        node = Node(
            name, validators, self.timer, self.network,
            config=self.config,
            domain_genesis=[dict(t) for t in self._domain_genesis],
            pool_genesis=([dict(t) for t in self.pool_genesis]
                          if self.pool_genesis else None),
            seed_keys=dict(self._seed_keys),
            num_instances=1, drive_quorum_ticks=False,
            device=self.device)
        self.nodes.append(node)
        if name not in self.validators:
            self.validators.append(name)
        self.network.connect_all()
        node.start()
        node.leecher.start()  # fetch everything committed before we joined
        return node

    # ------------------------------------------------------------------

    def node(self, name: str) -> Node:
        return next(n for n in self.nodes if n.name == name)

    @property
    def primary(self) -> Node:
        return self.node(self.nodes[0].data.primaries[0])

    def make_nym_request(self, seq: Optional[int] = None,
                         signer: Optional[DidSigner] = None) -> Request:
        """A signed NYM write creating a fresh target identity."""
        from ..common.constants import NYM, TARGET_NYM, TXN_TYPE, VERKEY

        if seq is None:
            self._req_seq += 1
            seq = self._req_seq
        signer = signer or self.trustee
        target = DidSigner(hashlib.sha256(
            b"pool-target-%d" % seq).digest())
        req = Request(
            identifier=signer.identifier, reqId=seq,
            operation={TXN_TYPE: NYM, TARGET_NYM: target.identifier,
                       VERKEY: target.verkey})
        signer.sign_request(req)
        req.target_signer = target  # test convenience
        return req

    def submit_to(self, node_name: str, req: Request,
                  client_id: str = "client1") -> bool:
        """Client sends a request to exactly ONE node (the real topology)."""
        return self.node(node_name).submit_client_request(req, client_id)

    def make_client(self, name: str = "client1"):
        """A pool client wired to the sim nodes (direct-call transport)."""
        from ..client.client import Client

        static_bls = {}
        if self.bls_keys is not None:
            static_bls = {n: pk
                          for n, (kp, pk, pop) in self.bls_keys.items()}

        def live_bls_keys():
            # static sim keys + any keys the pool registry carries (a
            # node admitted by NODE txn brings its BLS key through it)
            from ..common.constants import BLS_KEY

            out = dict(static_bls)
            for alias, rec in self.nodes[0].pool_manager.registry.items():
                if rec.get(BLS_KEY):
                    out[alias] = rec[BLS_KEY]
            return out

        return Client(
            name, lambda: list(self.nodes[0].data.validators),
            send=lambda req, node, cid: self.node(node)
            .submit_client_request(req, client_id=cid),
            pool_bls_keys=live_bls_keys,
            now_provider=self.timer.get_current_time)

    def pump_client(self, client) -> None:
        """Deliver queued node->client messages to ``client``."""
        for node in self.nodes:
            keep = []
            for cid, msg in node.client_outbox:
                if cid == client.name:
                    client.process_node_message(node.name, msg)
                else:
                    keep.append((cid, msg))
            node.client_outbox = keep

    def run_for(self, seconds: float) -> None:
        self.timer.advance(seconds)

    def honest_nodes_agree(self) -> bool:
        logs = [tuple(n.ordered_digests) for n in self.nodes]
        shortest = min(len(l) for l in logs)
        return all(l[:shortest] == logs[0][:shortest] for l in logs)
