"""The port's CLI and node runner (``indy_plenum_tpu_torch/cli/``,
``tools/start_node.py``) on the CPU.

- The scripted session of ``tests/test_cli.py`` through the port's
  ``PoolCli(device="cpu")``, its output checked as that test checks it:
  ``new pool`` provisions one directory (its files checked: genesis
  counts, owner-only keys), ``start pool`` runs a directory provisioned on
  free ports, so nothing binds the 9700 that ``tests/test_cli.py`` uses.
- ``python -m indy_plenum_tpu_torch.cli --device cpu`` reads a session
  from stdin; importing ``cli.__main__`` starts nothing.
- Four ``python -m indy_plenum_tpu_torch.tools.start_node DIR nodeI
  --device cpu`` processes (``chip_smoke.run_processes_z4``, phase Z4 at
  a CPU size) order signed writes from a socket client, then exit 0 on
  SIGINT, each leaving its log under ``DIR/logs/``.
- Without a card, ``PoolCli()`` and ``start_node`` without ``--device
  cpu`` refuse to run, binding nothing.
"""
import io
import os
import socket
import subprocess
import sys

import pytest

pytest.importorskip("zmq")

import chip_smoke  # noqa: E402
from torch_socket_ports import free_port_block  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread_and_free_ports(monkeypatch):
    import torch

    monkeypatch.setattr(chip_smoke, "_free_port_block", free_port_block)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_scripted_session(tmp_path):
    from indy_plenum_tpu_torch.cli import PoolCli
    from indy_plenum_tpu_torch.ledger.genesis import load_genesis_file
    from indy_plenum_tpu_torch.tools import generate_pool_config

    new_dir, run_dir = tmp_path / "new", tmp_path / "run"
    generate_pool_config(str(run_dir), n_nodes=4,
                         base_port=free_port_block(8))
    out = io.StringIO()
    cli = PoolCli(out=out, device="cpu")
    session = [
        "help",
        f"new pool {new_dir} 4",
        f"start pool {run_dir}",
        "status",
        "send nym alice",
        "get nym alice",
        "get nym nobody",
        "bogus command",
        "exit",
    ]
    cli.repl(stdin=iter(line + "\n" for line in session))
    text = out.getvalue()
    for want in chip_smoke.Z3_CHECKS:
        assert want in text, (want, text)
    assert text.count("error:") == 0
    assert "node3: view 0, ordered 0, participating True" in text
    # what `new pool` wrote
    assert len(load_genesis_file(str(new_dir / "pool_genesis.jsonl"))) == 4
    assert len(load_genesis_file(str(new_dir / "domain_genesis.jsonl"))) \
        == 5  # trustee + 4 stewards
    keys = sorted(os.listdir(new_dir / "keys"))
    assert keys == ["node0.json", "node1.json", "node2.json", "node3.json",
                    "trustee.json"]
    for name in keys:
        assert os.stat(new_dir / "keys" / name).st_mode & 0o777 == 0o600


def test_cli_runs_as_a_module_and_its_main_imports_cleanly():
    out = subprocess.run(
        [sys.executable, "-m", "indy_plenum_tpu_torch.cli", "--device",
         "cpu"], input="help\nstatus\nexit\n", cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "commands:" in out.stdout and "no pool running" in out.stdout
    assert "pool stopped" in out.stdout
    # importing __main__ (the isolation test imports every module) must
    # neither read stdin nor exit
    code = ("import sys, importlib\n"
            "class NoStdin:\n"
            "    def __iter__(self): raise AssertionError('read stdin')\n"
            "    def readline(self): raise AssertionError('read stdin')\n"
            "sys.stdin = NoStdin()\n"
            "importlib.import_module('indy_plenum_tpu_torch.cli.__main__')\n"
            "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"


def test_start_node_processes_order_and_exit_on_sigint():
    rec = chip_smoke.run_processes_z4("cpu", writes=5)
    assert set(rec["exit_codes"].values()) == {0}
    assert set(rec["ordered"].values()) == {5}
    assert set(rec["domain_sizes"].values()) == {10}


def test_cli_and_start_node_refuse_without_a_card(tmp_path, monkeypatch):
    import torch

    from indy_plenum_tpu_torch.cli import PoolCli
    from indy_plenum_tpu_torch.tools import generate_pool_config
    from indy_plenum_tpu_torch.tools.start_node import main as start_node
    from indy_plenum_tpu_torch.utils.torch_env import NoCudaDevice

    base = free_port_block(8)
    generate_pool_config(str(tmp_path), n_nodes=4, base_port=base,
                         master_seed=b"\x07" * 32)
    # the process entry point, with no card visible to it
    out = subprocess.run(
        [sys.executable, "-m", "indy_plenum_tpu_torch.tools.start_node",
         str(tmp_path), "node0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "NoCudaDevice" in out.stderr and "listening" not in out.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(NoCudaDevice):
            PoolCli(out=io.StringIO(), **kw)
    with pytest.raises(NoCudaDevice):
        start_node([str(tmp_path), "node0"])
    with pytest.raises(NoCudaDevice):
        start_node([str(tmp_path), "node0", "--device", "cuda"])
    assert not os.path.exists(tmp_path / "logs")
    for port in range(base, base + 8):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", port))
