"""The port stands alone, and never hides the card.

- Every module of ``indy_plenum_tpu_torch`` and ``chip_smoke.py`` imports
  with ``jax`` and ``indy_plenum_tpu`` made unimportable (a subprocess:
  this test process has imported jax already, through conftest).
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
                "server.consensus.ordering_service", "config"):
        assert "indy_plenum_tpu_torch." + mod in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['indy_plenum_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and"
        " (m.split('.')[0] in ('jax', 'indy_plenum_tpu'))]\n"
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


def _entry_points(device_kw):
    from indy_plenum_tpu_torch.server.client_authn import CoreAuthNr
    from indy_plenum_tpu_torch.simulation.pool import SimPool
    from indy_plenum_tpu_torch.tpu.ed25519 import batch_verify
    from indy_plenum_tpu_torch.tpu.vote_plane import (
        DeviceVotePlane,
        VotePlaneGroup,
    )

    validators = ["a", "b", "c", "d"]
    return {
        "CoreAuthNr": lambda: CoreAuthNr(**device_kw),
        "VotePlaneGroup": lambda: VotePlaneGroup(
            4, validators, 32, 2, **device_kw),
        "DeviceVotePlane": lambda: DeviceVotePlane(
            validators, 32, 2, **device_kw),
        "batch_verify": lambda: batch_verify(
            [b"\x00" * 32], [b""], [b"\x00" * 64], **device_kw),
        "SimPool.device_quorum": lambda: SimPool(
            4, device_quorum=True, **device_kw),
        "SimPool.sign_requests": lambda: SimPool(
            4, sign_requests=True, **device_kw),
    }


ENTRY_POINTS = ["CoreAuthNr", "VotePlaneGroup", "DeviceVotePlane",
                "batch_verify", "SimPool.device_quorum",
                "SimPool.sign_requests"]


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
        q.slide_state(state, torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        q.zero_members(state, torch.ones(2, dtype=torch.bool))


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
    assert set(kb.LAUNCHES) == {"sha512_blocks", "reduce_mod_l",
                                "ed25519_verify", "quorum_step",
                                "window_slide", "window_zero"}


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
