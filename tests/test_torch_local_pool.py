"""The port's pool provisioning and a provisioned pool over real sockets,
against the JAX package.

- Provisioning: the same master seed through both packages'
  ``generate_pool_config`` (and through ``python -m
  indy_plenum_tpu_torch.tools.generate_pool``) writes byte-identical
  ``pool_info.json``, genesis files and ``keys/*.json``, the keys
  owner-only.
- A provisioned 4-node pool of the port on ``device="cpu"`` over CurveZMQ
  sockets (``chip_smoke.run_socket_z1``, phase Z1 at a CPU size): signed
  writes with f+1 replies, a forged signature REQNACKed, proved GET_NYMs
  verified with the pool's BLS keys alone, VALIDATOR_INFO, every node's
  ledgers and state equal, node1 recorded and replayed into a fresh port
  node to the same ordered digests, ledger roots and state root.
- A mixed pool: two JAX nodes and two port nodes from one provisioned
  directory (the JAX verify warmed first) order three signed writes sent
  by the port's socket client; all four domain roots are equal. A port
  node recorded over those sockets replays through the JAX package's
  ``Replayer`` to the same ordered digests and roots.
- Without a card, ``build_node`` and ``run_pool`` raise before binding a
  socket.

Ports come from ``torch_socket_ports.free_port_block`` (a slice per xdist
worker, clear of the fixed ranges the JAX package's socket tests bind).
"""
import hashlib
import importlib
import os
import subprocess
import sys
import time

import pytest

pytest.importorskip("jax")
pytest.importorskip("zmq")

import chip_smoke  # noqa: E402
from torch_socket_ports import free_port_block  # noqa: E402

JAX, PORT = "indy_plenum_tpu", "indy_plenum_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = b"\x07" * 32
KNOBS = {"Max3PCBatchWait": 0.05, "Max3PCBatchSize": 10,
         "PropagateBatchWait": 0.02}


def mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


@pytest.fixture(autouse=True)
def one_torch_thread_and_free_ports(monkeypatch):
    import torch

    monkeypatch.setattr(chip_smoke, "_free_port_block", free_port_block)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tree(directory):
    out = {}
    for dirpath, _, files in os.walk(directory):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, directory)] = (
                    fh.read(), os.stat(path).st_mode & 0o777)
    return out


def test_provisioning_is_byte_identical(tmp_path):
    trees = {}
    for pkg in (JAX, PORT):
        mod(pkg, "tools").generate_pool_config(
            str(tmp_path / pkg), n_nodes=4, base_port=9700,
            master_seed=SEED)
        trees[pkg] = tree(str(tmp_path / pkg))
    out = subprocess.run(
        [sys.executable, "-m", "indy_plenum_tpu_torch.tools.generate_pool",
         str(tmp_path / "cli"), "4", "9700", SEED.hex()],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "pool of 4 validators provisioned" in out.stdout
    trees["cli"] = tree(str(tmp_path / "cli"))
    names = sorted(trees[JAX])
    assert names == ["domain_genesis.jsonl", "keys/node0.json",
                     "keys/node1.json", "keys/node2.json", "keys/node3.json",
                     "keys/trustee.json", "pool_genesis.jsonl",
                     "pool_info.json"]
    for pkg in (PORT, "cli"):
        assert sorted(trees[pkg]) == names
        for name in names:
            assert trees[pkg][name][0] == trees[JAX][name][0], (pkg, name)
            if name.startswith("keys/"):
                assert trees[pkg][name][1] == 0o600, (pkg, name)


def test_provisioned_socket_pool_on_cpu():
    rec = chip_smoke.run_socket_z1("cpu", writes=6, reads=2)
    assert rec["ordered"] == 6 and rec["replay_equal"]
    assert rec["forged_nacks"] >= 2
    assert rec["looper_errors"] == 0 and rec["rejected_unknown_key"] == 0
    assert rec["drains"] > 0


def _run_until(loopers, done, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if done():
            return True
        if sum(lp._pump_once() for lp in loopers) == 0:
            time.sleep(0.002)
    return done()


def _fingerprint(node):
    pkg = type(node).__module__.split(".")[0]
    constants = mod(pkg, "common.constants")
    db = node.boot.db
    return {"ordered": list(node.ordered_digests),
            "ledger_roots": {lid: db.get_ledger(lid).root_hash
                             for lid in db.ledger_ids},
            "state_root": db.get_state(
                constants.DOMAIN_LEDGER_ID).committed_head_hash}


def test_mixed_pool_and_replay_through_reference(tmp_path):
    directory = str(tmp_path / "pool")
    mod(PORT, "tools").generate_pool_config(
        directory, n_nodes=4, base_port=free_port_block(8),
        master_seed=b"\x41" * 32)
    packages = {"node0": JAX, "node1": JAX, "node2": PORT, "node3": PORT}
    loopers = {pkg: mod(pkg, "common.looper").Looper()
               for pkg in (JAX, PORT)}
    nodes, stacks, closers = {}, {}, []
    for name, pkg in packages.items():
        config = mod(pkg, "config").getConfig(KNOBS)
        kw = {"device": "cpu"} if pkg == PORT else {}
        node, stack = mod(pkg, "tools.local_pool").build_node(
            directory, name, loopers[pkg], config=config, **kw)
        nodes[name], stacks[name] = node, stack
        closers += [node.client_surface, stack]
    recorder = mod(PORT, "recorder").Recorder()
    try:
        for name, node in nodes.items():
            node.start()
            loopers[packages[name]].add(stacks[name])
            loopers[packages[name]].add(node.client_surface)
        lp = mod(PORT, "tools.local_pool")
        trustee = mod(PORT, "crypto.signers").DidSigner(
            lp.load_secret_seed(directory, "trustee"))
        jax_trustee = mod(JAX, "crypto.signers").DidSigner(
            lp.load_secret_seed(directory, "trustee"))
        # the JAX verify compiles on XLA:CPU: outside every liveness wait
        mod(JAX, "tools.local_pool").warm_verify_kernel(nodes["node0"],
                                                        jax_trustee)
        lp.warm_verify_kernel(nodes["node2"], trustee)
        start = loopers[PORT].timer.get_current_time()
        recorder.attach(nodes["node2"])
        client, client_stack = lp.build_client(directory, "mixed-client")
        closers.append(client_stack)
        loopers[PORT].add(client_stack)
        digests = []
        for i in range(3):
            req, _ = chip_smoke._z_nym(trustee, b"mixed-%d" % i, i + 1)
            digests.append(client.submit_write(req))
        ok = _run_until(loopers.values(), lambda: all(
            client.result(d) is not None for d in digests)
            and all(len(n.ordered_digests) == 3 for n in nodes.values()))
        assert ok, [len(n.ordered_digests) for n in nodes.values()]
        prints = {name: _fingerprint(n) for name, n in nodes.items()}
        assert len({repr(p) for p in prints.values()}) == 1, prints
        assert all(lpr.errors == 0 for lpr in loopers.values())
        assert all(s.rejected_unknown_key == 0 for s in stacks.values())
        live_s = loopers[PORT].timer.get_current_time() - start
    finally:
        for lp_ in loopers.values():
            lp_.shutdown()
        for node in nodes.values():
            node.stop()
        for closer in closers:
            closer.close()

    # node2 (a port node) replayed through the JAX package's Replayer
    path = str(tmp_path / "node2.rec")
    recorder.dump(path)
    jrec = mod(JAX, "recorder")
    loaded = jrec.Recorder.load(path)
    assert len(loaded.entries) == len(recorder.entries) > 0
    jlp = mod(JAX, "tools.local_pool")
    jgen = mod(JAX, "ledger.genesis")
    info = jlp.load_pool_info(directory)
    own, _, _ = mod(JAX, "bls.factory").generate_bls_keys(
        jlp.load_secret_seed(directory, "node2", key="bls_seed"))
    bls_keys = {peer: (own if peer == "node2" else None, rec["bls_key"],
                       rec["bls_pop"]) for peer, rec in info["nodes"].items()}
    timer = mod(JAX, "simulation.mock_timer").MockTimer(start_time=start)
    fresh = mod(JAX, "server.node").Node(
        "node2", list(info["validators"]), timer,
        mod(JAX, "recorder.recorder").ReplayNetwork(),
        config=mod(JAX, "config").getConfig(KNOBS),
        pool_genesis=jgen.load_genesis_file(
            os.path.join(directory, jlp.POOL_GENESIS)),
        domain_genesis=jgen.load_genesis_file(
            os.path.join(directory, jlp.DOMAIN_GENESIS)),
        seed_keys={info["trustee_did"]: info["trustee_verkey"]},
        bls_keys=bls_keys)
    fresh.start()
    jrec.Replayer(loaded).replay_into(fresh, timer)
    timer.advance(live_s)
    assert _fingerprint(fresh) == prints["node2"]


def test_build_node_and_run_pool_raise_without_cuda(tmp_path, monkeypatch):
    import socket

    import torch

    from indy_plenum_tpu_torch.common.looper import Looper
    from indy_plenum_tpu_torch.tools import (
        build_node,
        generate_pool_config,
        run_pool,
    )
    from indy_plenum_tpu_torch.utils.torch_env import NoCudaDevice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = free_port_block(8)
    generate_pool_config(str(tmp_path), n_nodes=4, base_port=base,
                         master_seed=SEED)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(NoCudaDevice):
            build_node(str(tmp_path), "node0", Looper(), **kw)
        with pytest.raises(NoCudaDevice):
            run_pool(str(tmp_path), **kw)
    # nothing was bound on the way to the raise
    for port in range(base, base + 8):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", port))
