"""Provision and run a local validator pool (the CLI's working parts).

Reference: the reference's init utilities + scripts
(plenum/common/keygen_utils.py, scripts/generate_indy_pool_transactions,
scripts/start_plenum_node). ``generate_pool_config`` writes a directory a
human can inspect: per-node seeds, transport keys and addresses, the
trustee seed, and pool/domain genesis files (one JSON txn per line, the
reference's format). ``build_node`` reopens that directory and assembles
one validator over the authenticated ZMQ transport; ``run_pool`` drives
any number of them on one Looper (in-process pool; production runs one
process per node with the same pieces: ``python -m
indy_plenum_tpu_torch.tools.start_node``).

Copy of ``indy_plenum_tpu/tools/local_pool.py``, with its imports bound to
the port. ``build_node``, ``run_pool`` and ``warm_verify_kernel`` take a
``device``: the validators' kernels (the ingress drain's Ed25519 verify,
the SMT commit waves, the catchup proof folds) run on the CUDA card unless
the caller passes ``device="cpu"``, which runs their plain PyTorch
versions; without a card they raise before any socket is bound.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

from ..common.constants import STEWARD, TRUSTEE
from ..common.looper import Looper
from ..config import Config, getConfig
from ..crypto.signers import DidSigner
from ..ledger.genesis import (
    dump_genesis_file,
    genesis_node_txn,
    genesis_nym_txn,
    load_genesis_file,
)
from ..network import ZStack, ZStackNetwork, curve_keypair_from_seed
from ..server.node import Node
from ..utils.torch_env import DeviceLike, resolve_device

POOL_GENESIS = "pool_genesis.jsonl"
DOMAIN_GENESIS = "domain_genesis.jsonl"
POOL_INFO = "pool_info.json"  # PUBLIC: addresses + public keys only
KEYS_DIR = "keys"  # PRIVATE: one secret file per identity — a deployment
#                    copies pool_info.json to every host but each node's
#                    keys/<name>.json ONLY to that node's host


def generate_pool_config(directory: str, n_nodes: int = 4,
                         base_port: int = 9700,
                         master_seed: Optional[bytes] = None) -> Dict:
    """Write keys + genesis for an n-node pool; returns the pool info.

    ``master_seed`` defaults to fresh randomness (os.urandom) — a fixed
    seed makes every derived secret publicly recomputable, so it exists
    only for reproducible test fixtures.
    """
    os.makedirs(directory, exist_ok=True)
    keys_dir = os.path.join(directory, KEYS_DIR)
    os.makedirs(keys_dir, exist_ok=True)
    if master_seed is None:
        # da: allow[nondet-source] -- master-key generation for a REAL local pool: entropy by design; reproducible fixtures pass master_seed explicitly
        master_seed = os.urandom(32)

    def derive(tag: str) -> bytes:
        return hashlib.sha256(master_seed + tag.encode()).digest()

    trustee = DidSigner(derive("trustee"))
    domain = [genesis_nym_txn(trustee.identifier, trustee.verkey,
                              role=TRUSTEE)]
    pool = []
    nodes = {}
    for i in range(n_nodes):
        name = f"node{i}"
        steward = DidSigner(derive(f"steward-{i}"))
        node_seed = derive(f"node-{i}")
        public, _secret = curve_keypair_from_seed(node_seed)
        # the client listener's curve identity (shared derivation with
        # ClientZStack — see network/keys.py)
        from ..network.keys import client_stack_keypair_from_seed

        client_public, _ = client_stack_keypair_from_seed(node_seed)
        # BLS signing identity: public key + proof of possession go into
        # the pool genesis NODE txn (reference: init_bls_keys)
        from ..bls.factory import generate_bls_keys

        _kp, bls_pk, bls_pop = generate_bls_keys(derive(f"bls-{i}"))
        domain.append(genesis_nym_txn(steward.identifier, steward.verkey,
                                      role=STEWARD))
        pool.append(genesis_node_txn(
            node_nym=f"nym-{name}", alias=name,
            steward_did=steward.identifier,
            node_port=base_port + 2 * i, client_port=base_port + 2 * i + 1,
            blskey=bls_pk, blskey_pop=bls_pop,
            transport_verkey=public.decode()))
        nodes[name] = {
            "transport_public": public.decode(),
            "client_public": client_public.decode(),
            "node_ip": "127.0.0.1",
            "node_port": base_port + 2 * i,
            "client_ip": "127.0.0.1",
            "client_port": base_port + 2 * i + 1,
            "bls_key": bls_pk,
            "bls_pop": bls_pop,
        }
        _write_secret(os.path.join(keys_dir, f"{name}.json"),
                      {"seed": node_seed.hex(),
                       "bls_seed": derive(f"bls-{i}").hex()})
    _write_secret(os.path.join(keys_dir, "trustee.json"),
                  {"seed": derive("trustee").hex()})
    info = {
        "trustee_did": trustee.identifier,
        "trustee_verkey": trustee.verkey,
        "validators": [f"node{i}" for i in range(n_nodes)],
        "nodes": nodes,
    }
    dump_genesis_file(os.path.join(directory, POOL_GENESIS), pool)
    dump_genesis_file(os.path.join(directory, DOMAIN_GENESIS), domain)
    with open(os.path.join(directory, POOL_INFO), "w") as fh:
        json.dump(info, fh, indent=2, sort_keys=True)
    return info


def _write_secret(path: str, payload: Dict) -> None:
    """Owner-only (0600) secret files, like ssh/indy keygen tooling."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as fh:
        json.dump(payload, fh)


def load_secret_seed(directory: str, name: str, key: str = "seed") -> bytes:
    with open(os.path.join(directory, KEYS_DIR, f"{name}.json")) as fh:
        return bytes.fromhex(json.load(fh)[key])


def load_pool_info(directory: str) -> Dict:
    with open(os.path.join(directory, POOL_INFO)) as fh:
        return json.load(fh)


def build_node(directory: str, name: str, looper: Looper,
               config: Optional[Config] = None,
               device: DeviceLike = None) -> Tuple[Node, ZStack]:
    """Reopen a provisioned directory and assemble one validator on
    ``device`` (the card unless ``"cpu"``)."""
    device = resolve_device(device)
    info = load_pool_info(directory)
    record = info["nodes"][name]
    config = config or getConfig(
        {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 100,
         "PropagateBatchWait": 0.05})
    node_seed = load_secret_seed(directory, name)
    # ONE collector per validator, shared by transport and node: HWM drops
    # (zstack.dropped) land in the same summary as auth/commit timings.
    # The default "kv" type persists snapshots (stats + histograms) under
    # the node directory so a restarted validator keeps its history —
    # Node.stop() closes it, flushing the final partial window.
    if config.METRICS_COLLECTOR_TYPE == "kv":
        from ..common.metrics_collector import KvMetricsCollector
        from ..storage.kv_store import initKeyValueStorage

        metrics = KvMetricsCollector(initKeyValueStorage(
            config.KVStorageType, directory, f"metrics_{name}"))
    else:
        from ..common.metrics_collector import MetricsCollector

        metrics = MetricsCollector()
    stack = ZStack(name, node_seed,
                   bind_host=record["node_ip"],
                   bind_port=record["node_port"],
                   max_batch=config.OUTGOING_BATCH_SIZE,
                   msg_len_limit=config.MSG_LEN_LIMIT,
                   metrics=metrics)
    for peer, rec in info["nodes"].items():
        if peer == name:
            continue
        key = rec["transport_public"].encode()
        stack.allow_peer(peer, key)
        stack.connect(peer, (rec["node_ip"], rec["node_port"]), key)
    net = ZStackNetwork(stack)

    # BLS: own keypair from the secret file, pool publics from pool info
    bls_keys = None
    if all("bls_key" in rec for rec in info["nodes"].values()):
        from ..bls.factory import generate_bls_keys

        own_kp, _, _ = generate_bls_keys(
            load_secret_seed(directory, name, key="bls_seed"))
        bls_keys = {
            peer: (own_kp if peer == name else None,
                   rec["bls_key"], rec["bls_pop"])
            for peer, rec in info["nodes"].items()}

    node = Node(
        name, list(info["validators"]), looper.timer, net, config=config,
        pool_genesis=load_genesis_file(
            os.path.join(directory, POOL_GENESIS)),
        domain_genesis=load_genesis_file(
            os.path.join(directory, DOMAIN_GENESIS)),
        seed_keys={info["trustee_did"]: info["trustee_verkey"]},
        bls_keys=bls_keys, metrics=metrics, device=device)
    net.mark_connected(set(info["validators"]) - {name})
    # committed NODE txns rewire the transport (KIT semantics): new
    # members get connected, departed ones dropped, rotated keys restart
    node.on_membership_changed_hook = net.membership_hook
    # causal tracing plane: the transport stamps net.send/net.recv marks
    # (and piggybacks the ~trc context on the envelope) on the node's
    # recorder — NULL_TRACE unless config.TraceRecorderEnabled
    stack.trace = node.trace

    # the client-facing listener (reference: the node's client stack)
    from ..network.client_stack import ClientZStack, NodeClientSurface

    client_stack = ClientZStack(
        name, node_seed, bind_host=record.get("client_ip", "127.0.0.1"),
        bind_port=record.get("client_port", 0),
        msg_len_limit=config.MSG_LEN_LIMIT)
    node.client_surface = NodeClientSurface(node, client_stack)
    return node, stack


def run_pool(directory: str, names: Optional[List[str]] = None,
             config: Optional[Config] = None,
             device: DeviceLike = None
             ) -> Tuple[Looper, List[Node], List[ZStack]]:
    """Assemble + start validators on one Looper (in-process pool), all on
    ``device`` (the card unless ``"cpu"``)."""
    device = resolve_device(device)
    info = load_pool_info(directory)
    names = names or list(info["validators"])
    looper = Looper()
    nodes, stacks = [], []
    for name in names:
        node, stack = build_node(directory, name, looper, config=config,
                                 device=device)
        node.start()
        looper.add(stack)
        looper.add(node.client_surface)
        nodes.append(node)
        stacks.append(stack)
    return looper, nodes, stacks


def build_client(directory: str, name: str = "client1",
                 now_provider=None):
    """A pool client over real sockets: Client logic + PoolClientStack
    transport wired together. Pump ``client.stack.service()`` (or add the
    returned stack to a Looper) to move messages."""
    import time as _time

    from ..client.client import Client
    from ..network.client_stack import PoolClientStack

    info = load_pool_info(directory)
    nodes = {
        node_name: ((rec.get("client_ip", "127.0.0.1"),
                     rec["client_port"]),
                    rec["client_public"].encode())
        for node_name, rec in info["nodes"].items()
        if "client_port" in rec and "client_public" in rec}
    stack = PoolClientStack(name, nodes)
    bls_keys = {n: rec["bls_key"] for n, rec in info["nodes"].items()
                if "bls_key" in rec}
    client = Client(
        name, list(info["validators"]),
        send=lambda req, node_name, _cid: stack.send(req, node_name),
        pool_bls_keys=bls_keys,
        now_provider=now_provider or _time.time)
    stack.on_message = client.process_node_message
    client.stack = stack
    return client, stack


def warm_verify_kernel(node, signer) -> None:
    """Pay the verify path's first-use costs BEFORE real traffic: on the
    card, load the kernel library (``utils/kernel_build.library()`` builds
    it with nvcc when the sources' hash has no build yet, which takes
    seconds) and run one drain of one signed request through the node's
    authenticator on its device (K-a, K-b and K-c once each), so neither
    the build nor the first launch eats a write's quorum timeout. One
    definition for the CLI, the smoke and test fixtures; the library is
    loaded once a process, so warming any one node warms them all. On
    ``device="cpu"`` the drain runs the plain versions."""
    import hashlib

    from ..common.constants import NYM, TARGET_NYM, TXN_TYPE, VERKEY
    from ..common.request import Request
    from ..crypto.signers import DidSigner
    from ..utils import kernel_build

    if node.device.type == "cuda":
        kernel_build.library()
    probe = DidSigner(hashlib.sha256(b"warm-verify-kernel").digest())
    req = Request(identifier=signer.identifier, reqId=1,
                  operation={TXN_TYPE: NYM, TARGET_NYM: probe.identifier,
                             VERKEY: probe.verkey})
    signer.sign_request(req)
    node.authnr.authenticate_batch([req])
