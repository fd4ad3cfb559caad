"""The port stands alone, and never hides the card.

- Every module of ``indy_plenum_tpu_torch`` and ``chip_smoke.py`` imports
  with ``jax``, ``indy_plenum_tpu``, ``msgpack`` and ``cryptography`` made
  unimportable (a subprocess: this test process has imported jax already,
  through conftest); the card's machine has none of them. Importing a
  module starts nothing (``cli.__main__`` guards its REPL).
- Without CUDA, an entry point built without ``device="cpu"`` raises, one
  asked for ``device="cuda"`` raises instead of running the plain
  versions, and a kernel wrapper given a tensor on neither the CPU nor a
  card raises.
- The kernel build raises when ``nvcc`` is missing, and the ctypes
  signatures match the CUDA sources' C entry points.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "indy_plenum_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
            mod = rel[:-3].replace(os.sep, ".")
            mods.append(mod[:-len(".__init__")]
                        if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_without_jax_or_reference():
    mods = _port_modules()
    for mod in ("tpu.vote_plane", "simulation.pool",
                "server.consensus.ordering_service", "config", "tpu.sha256",
                "server.ledgers_bootstrap", "ingress.read_service",
                "tpu.step", "tpu.compile_plan"):
        assert "indy_plenum_tpu_torch." + mod in mods
    for mod in ("tpu.ring_exchange", "tpu.rebalance"):
        assert "indy_plenum_tpu_torch." + mod in mods
    for mod in ("utils.native_build", "crypto.bls.bn254",
                "crypto.bls.bn254_native", "crypto.bls.bls_crypto", "bls",
                "bls.bls_bft_replica", "proofs.batch_verify",
                "proofs.checkpoint_cache", "client.state_proof",
                "observability.causal", "chaos.runner", "chaos.scenarios"):
        assert "indy_plenum_tpu_torch." + mod in mods
    for mod in ("ingress.workload", "ingress.retry", "lanes", "lanes.router",
                "lanes.barrier", "lanes.pool", "observability.telemetry",
                "simulation.soak", "proofs.edge_cache",
                "storage.file_stores"):
        assert "indy_plenum_tpu_torch." + mod in mods
    for mod in ("storage.req_id_to_txn", "plugins", "plugins.loader",
                "server.throughput_measurement", "server.monitor",
                "server.propagator", "server.notifier", "server.observer",
                "server.pool_manager",
                "server.request_managers.read_request_manager",
                "server.request_managers.action_request_manager",
                "server.node", "client.wallet", "client.client",
                "simulation.node_pool"):
        assert "indy_plenum_tpu_torch." + mod in mods
    for mod in ("analysis", "analysis.__main__", "analysis.core",
                "analysis.pragmas", "analysis.rules_config",
                "analysis.rules_determinism", "analysis.rules_device",
                "analysis.rules_hotpath", "analysis.rules_ordering",
                "common.looper", "common.log", "recorder",
                "recorder.recorder"):
        assert "indy_plenum_tpu_torch." + mod in mods
    for mod in ("network", "network.keys", "network.zstack",
                "network.client_stack", "tools", "tools.local_pool",
                "tools.start_node", "tools.generate_pool", "cli", "cli.cli",
                "cli.__main__"):
        assert "indy_plenum_tpu_torch." + mod in mods
    for mod in TOOLS + ("tools.trace_tool", "utils.phase_t_probe"):
        assert "indy_plenum_tpu_torch." + mod in mods
    assert os.path.isfile(os.path.join(PKG, "analysis", "baseline.json"))
    for src in ("resident_tile.cu", "quorum_common.cuh", "quorum.cu",
                "window.cu", "ring.cu"):
        assert os.path.isfile(os.path.join(PKG, "csrc", src)), src
    blocked = ("jax", "indy_plenum_tpu", "msgpack", "cryptography")
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and"
        f" (m.split('.')[0] in {blocked!r})]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "import chip_smoke; sys.exit(chip_smoke.main())"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# the operator entry points that run kernels: each needs the card unless
# ``--device cpu`` (the trace tool launches none and takes no device)
TOOLS = ("tools.check_dispatch_budget", "tools.chaos_run",
         "tools.ingress_run", "tools.profile_rbft", "tools.graft_entry")
TOOL_ARGV = {"tools.check_dispatch_budget": ["--only", "", "--json"],
             "tools.chaos_run": ["--scenario", "f_crash_partition"],
             "tools.ingress_run": ["--json"],
             "tools.profile_rbft": ["4", "1", "20", "--json"],
             "tools.graft_entry": []}


@pytest.mark.parametrize("mod", TOOLS)
def test_tools_exit_without_a_card(mod, no_cuda, tmp_path, monkeypatch,
                                   capsys):
    """Without CUDA and without ``--device cpu`` a tool exits non-zero
    before it builds a pool (argparse's error exit), and prints no
    result; its command-line-only listings still work."""
    import importlib

    monkeypatch.chdir(tmp_path)
    tool = importlib.import_module("indy_plenum_tpu_torch." + mod)
    with pytest.raises(SystemExit) as exc:
        tool.main(TOOL_ARGV[mod])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
    from indy_plenum_tpu_torch.tools import graft_entry
    from indy_plenum_tpu_torch.utils.torch_env import NoCudaDevice

    with pytest.raises(NoCudaDevice):
        graft_entry.entry()
    with pytest.raises(NoCudaDevice):
        graft_entry.dryrun_multichip(4)


def test_tool_listings_need_no_card(no_cuda, capsys):
    from indy_plenum_tpu_torch.tools import chaos_run, check_dispatch_budget

    assert chaos_run.main(["--list"]) == 0
    assert check_dispatch_budget.main(["--list-gates"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 17 + 16


def _entry_points(device_kw):
    import numpy as np

    from indy_plenum_tpu_torch.ingress.read_service import (
        ReadService,
        StaticCorpusBacking,
    )
    from indy_plenum_tpu_torch.server.catchup.catchup_rep_service import (
        verify_audit_paths_batch,
    )
    from indy_plenum_tpu_torch.server.client_authn import CoreAuthNr
    from indy_plenum_tpu_torch.state.sparse_merkle_state import (
        SparseMerkleState,
    )
    from indy_plenum_tpu_torch.tpu.sha256 import merkle_node_hash_bytes
    from indy_plenum_tpu_torch.chaos import run_scenario
    from indy_plenum_tpu_torch.lanes import LanedPool, lane_meshes
    from indy_plenum_tpu_torch.server.node import Node
    from indy_plenum_tpu_torch.server.observer import Observer
    from indy_plenum_tpu_torch.simulation.mock_timer import MockTimer
    from indy_plenum_tpu_torch.simulation.node_pool import NodePool
    from indy_plenum_tpu_torch.simulation.pool import SimPool
    from indy_plenum_tpu_torch.simulation.sim_network import SimNetwork
    from indy_plenum_tpu_torch.simulation.soak import _day_soak_once
    from indy_plenum_tpu_torch.simulation.state_commit_bench import (
        run_state_soak,
    )
    from indy_plenum_tpu_torch.tpu.ed25519 import batch_verify
    from indy_plenum_tpu_torch.tpu.compile_plan import resident_plan_for
    from indy_plenum_tpu_torch.tpu.step import example_inputs, fused_step
    from indy_plenum_tpu_torch.tpu.vote_plane import (
        DeviceVotePlane,
        VotePlaneGroup,
    )

    validators = ["a", "b", "c", "d"]

    def k14():
        inputs = example_inputs(batch=2, n_validators=4, device="cpu")
        return fused_step(*inputs, n_validators=4, **device_kw)

    def fabric_mesh():
        from indy_plenum_tpu_torch.tpu.quorum import make_fabric_mesh

        return make_fabric_mesh([device_kw.get("device", "cuda")] * 8,
                                (2, 2))

    def node():
        timer = MockTimer()
        return Node("a", validators, timer, SimNetwork(timer), **device_kw)

    return {
        "CoreAuthNr": lambda: CoreAuthNr(**device_kw),
        "VotePlaneGroup": lambda: VotePlaneGroup(
            4, validators, 32, 2, **device_kw),
        "VotePlaneGroup.resident": lambda: VotePlaneGroup(
            4, validators, 32, 2, resident_depth=4, **device_kw),
        "resident_plan_for": lambda: resident_plan_for(
            None, 4, 4, 16, 2, 16, **device_kw),
        "fused_step": k14,
        "VotePlaneGroup.fabric": lambda: VotePlaneGroup(
            4, validators, 32, 2, mesh=fabric_mesh(), **device_kw),
        "SimPool.fabric": lambda: SimPool(
            4, device_quorum=True, mesh=fabric_mesh(), **device_kw),
        "DeviceVotePlane": lambda: DeviceVotePlane(
            validators, 32, 2, **device_kw),
        "batch_verify": lambda: batch_verify(
            [b"\x00" * 32], [b""], [b"\x00" * 64], **device_kw),
        "SimPool.device_quorum": lambda: SimPool(
            4, device_quorum=True, **device_kw),
        "SimPool.sign_requests": lambda: SimPool(
            4, sign_requests=True, **device_kw),
        "SimPool.real_execution": lambda: SimPool(
            4, real_execution=True, **device_kw),
        "SimPool.bls": lambda: SimPool(
            4, real_execution=True, bls=True, **device_kw),
        "run_scenario": lambda: run_scenario(
            "f_crash_partition", 7, **device_kw),
        "run_scenario.lanes": lambda: run_scenario(
            "lane_partition", 7, **device_kw),
        "LanedPool": lambda: LanedPool(2, device_quorum=True, **device_kw),
        "lane_meshes": lambda: lane_meshes(2, (2,), **device_kw),
        "day_soak": lambda: _day_soak_once(
            0.05, 0.1, 17, 10, 99.0, 1.0, 99.0, 0, **device_kw),
        "run_state_soak": lambda: run_state_soak(
            hours=0.05, n_keys=10, period=90.0, sample_every=30.0,
            repeats=1, **device_kw),
        "SparseMerkleState": lambda: SparseMerkleState(**device_kw),
        "ReadService": lambda: ReadService(StaticCorpusBacking(8),
                                           **device_kw),
        "verify_audit_paths_batch": lambda: verify_audit_paths_batch(
            [b"x"], [0], [[]], 1, b"\x00" * 32, **device_kw),
        "merkle_node_hash_bytes": lambda: merkle_node_hash_bytes(
            np.zeros((2, 32), np.uint8), np.zeros((2, 32), np.uint8),
            **device_kw),
        "Node": node,
        "NodePool": lambda: NodePool(4, **device_kw),
        "NodePool.device_quorum": lambda: NodePool(
            4, device_quorum=True, num_instances=0, **device_kw),
        "Observer": lambda: Observer("o", SimNetwork(MockTimer()),
                                     **device_kw),
    }


ENTRY_POINTS = ["CoreAuthNr", "VotePlaneGroup", "VotePlaneGroup.resident",
                "resident_plan_for", "fused_step", "VotePlaneGroup.fabric",
                "SimPool.fabric", "DeviceVotePlane",
                "batch_verify", "SimPool.device_quorum",
                "SimPool.sign_requests", "SimPool.real_execution",
                "SimPool.bls", "run_scenario", "run_scenario.lanes",
                "LanedPool", "lane_meshes", "day_soak", "run_state_soak",
                "SparseMerkleState", "ReadService",
                "verify_audit_paths_batch", "merkle_node_hash_bytes",
                "Node", "NodePool", "NodePool.device_quorum", "Observer"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
@pytest.mark.parametrize("device_kw", [{}, {"device": "cuda"}],
                         ids=["default", "cuda"])
def test_entry_points_raise_without_cuda(no_cuda, name, device_kw):
    from indy_plenum_tpu_torch.utils.torch_env import NoCudaDevice

    with pytest.raises(NoCudaDevice):
        _entry_points(device_kw)[name]()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_run_on_explicit_cpu(no_cuda, name):
    _entry_points({"device": "cpu"})[name]()


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version: anything else must be a
    CUDA tensor that launches the kernel, or the wrapper raises."""
    from indy_plenum_tpu_torch.tpu import ed25519 as ted
    from indy_plenum_tpu_torch.tpu import quorum as q
    from indy_plenum_tpu_torch.tpu import sha256 as s2
    from indy_plenum_tpu_torch.tpu import sha512 as s5

    meta = torch.device("meta")
    with pytest.raises(ValueError):
        s5.sha512_blocks(torch.empty((2, 1, 128), dtype=torch.uint8,
                                     device=meta),
                         torch.empty(2, dtype=torch.int32, device=meta))
    with pytest.raises(ValueError):
        s5.reduce_mod_l(torch.empty((2, 64), dtype=torch.uint8,
                                    device=meta))
    b32 = torch.empty((2, 32), dtype=torch.uint8, device=meta)
    with pytest.raises(ValueError):
        ted.verify_kernel(b32, b32, b32, b32)
    state = q.init_state(4, 16, 2, 2, device=meta)
    with pytest.raises(ValueError):
        q.step_compact(state, torch.empty((2, 16), dtype=torch.int32,
                                          device=meta), 4)
    with pytest.raises(ValueError):
        q.resident_step(state, torch.zeros((1, 2), dtype=torch.int32),
                        torch.empty((1, 2, 16), dtype=torch.int32,
                                    device=meta), 4)
    with pytest.raises(ValueError):
        q.fabric_step(state, torch.empty((2, 16), dtype=torch.int32,
                                         device=meta), 4, 2)
    with pytest.raises(ValueError):
        q.resident_tile_step(state, torch.zeros((1, 2), dtype=torch.int32),
                             torch.empty((1, 2, 16), dtype=torch.int32,
                                         device=meta), 4, 2)
    with pytest.raises(ValueError):
        q.slide_state(state, torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        q.zero_members(state, torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError):
        s2.sha256_fixed(torch.empty((2, 8), dtype=torch.uint8, device=meta))
    with pytest.raises(ValueError):
        s2.merkle_node_hash(b32, b32)
    i32 = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        s2.verify_audit_paths(
            b32, i32, torch.empty((2, 3, 32), dtype=torch.uint8,
                                  device=meta), i32, i32, b32)
    with pytest.raises(ValueError):
        s2.verify_audit_paths_indexed(
            b32, i32, b32, torch.empty((2, 3), dtype=torch.int32,
                                       device=meta), i32, i32, b32)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kb, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    with pytest.raises(kb.KernelBuildError):
        kb.build()
    with pytest.raises(kb.KernelBuildError):
        kb.library()


def test_ctypes_signatures_match_cuda_sources():
    """Every extern "C" entry point in csrc/*.cu has the argument list the
    loader declares (pointer vs int, in order) - a mismatch corrupts the
    call instead of failing it."""
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    found = {}
    for name in os.listdir(kb.CSRC_DIR):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(kb.CSRC_DIR, name)) as fh:
            src = fh.read()
        for fn, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src):
            kinds = []
            for p in params.split(","):
                kinds.append(kb._P if "*" in p else kb._I)
            found[fn] = tuple(kinds)
    assert found == {k: tuple(v) for k, v in kb._SIGNATURES.items()}
    # K10-K12 live in csrc/sha256.cu: every sha256_*/audit_* entry point
    # the loader declares is defined there, with the declared arguments
    with open(os.path.join(kb.CSRC_DIR, "sha256.cu")) as fh:
        sha_src = fh.read()
    sha_entries = {fn for fn in kb._SIGNATURES
                   if fn.startswith(("sha256_", "audit_", "merkle_"))}
    assert sha_entries == {"sha256_fixed_launch", "merkle_plan_launch",
                           "audit_paths_launch", "audit_paths_indexed_launch"}
    for fn in sha_entries:
        assert f'extern "C" int {fn}(' in sha_src, fn
    # K9 is resident_tile.cu's kernel at one validator tile (no
    # csrc/resident.cu); K8's host zero passes its rows in the launch;
    # K14 is one kernel of ed25519.cu (verify and tally), so K7 and K13
    # take no verdict operand: the words are followed by M
    assert not os.path.exists(os.path.join(kb.CSRC_DIR, "resident.cu"))
    assert "resident_step_launch" not in kb._SIGNATURES
    with open(os.path.join(kb.CSRC_DIR, "window.cu")) as fh:
        window = fh.read()
    for fn in ("window_slide_pairs_launch", "window_zero_rows_launch"):
        assert f'extern "C" int {fn}(' in window, fn
    with open(os.path.join(kb.CSRC_DIR, "quorum.cu")) as fh:
        assert "const void* words, int M" in fh.read()
    with open(os.path.join(kb.CSRC_DIR, "resident_tile.cu")) as fh:
        assert "const void* words, int M" in fh.read()
    with open(os.path.join(kb.CSRC_DIR, "ed25519.cu")) as fh:
        assert 'extern "C" int fused_step_launch(' in fh.read()
    assert kb._SIGNATURES["quorum_step_launch"][7:9] == (kb._P, kb._I)
    assert kb._SIGNATURES["fabric_step_launch"][7:9] == (kb._P, kb._I)
    assert set(kb.LAUNCHES) == {"sha512_blocks", "reduce_mod_l",
                                "ed25519_verify", "quorum_step",
                                "resident_step", "fused_step",
                                "window_slide", "window_zero",
                                "sha256_fixed", "merkle_node_hash",
                                "audit_paths", "audit_paths_indexed",
                                "fabric_step", "resident_tile",
                                "sharded_fused_step", "ring_shift",
                                "rotate_merge"}
    # K13 and the tiled K9 are one cluster kernel's two entry points; no
    # partial counts and no second kernel anywhere; K1 and K15 are
    # csrc/ring.cu
    assert not os.path.exists(os.path.join(kb.CSRC_DIR, "fabric.cu"))
    with open(os.path.join(kb.CSRC_DIR, "resident_tile.cu")) as fh:
        tile = fh.read()
    for fn in ("resident_tile_launch", "fabric_step_launch"):
        assert f'extern "C" int {fn}(' in tile, fn
    assert tile.count("__global__") == 1
    for name in os.listdir(kb.CSRC_DIR):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(kb.CSRC_DIR, name)) as fh:
                src = fh.read()
            for gone in ("fabric_tile_kernel", "fabric_decide",
                         "tile_partials", "resident_step_kernel",
                         "slide_rows", "eval_member"):
                assert gone not in src, (name, gone)
    with open(os.path.join(kb.CSRC_DIR, "ring.cu")) as fh:
        ring = fh.read()
    for fn in ("ring_shift_launch", "rotate_merge_launch"):
        assert f'extern "C" int {fn}(' in ring, fn


def test_source_hash_tracks_sources_and_build_dir_is_ignored():
    from indy_plenum_tpu_torch.utils import kernel_build as kb
    from indy_plenum_tpu_torch.utils.torch_env import KERNEL_BUILD_DIR

    assert re.fullmatch(r"[0-9a-f]{16}", kb.source_hash())
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        ignored = fh.read().split()
    rel = os.path.relpath(KERNEL_BUILD_DIR, ROOT) + "/"
    assert rel in ignored
    notes = ("Replaces", "bounds", "Design")
    for name in os.listdir(kb.CSRC_DIR):
        if name.endswith(".cu"):
            with open(os.path.join(kb.CSRC_DIR, name)) as fh:
                head = fh.read(4000)
            for note in notes:
                assert note in head, (name, note)
