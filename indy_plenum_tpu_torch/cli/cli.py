"""Interactive CLI: provision, run and talk to a local pool from a REPL.

Reference: plenum/cli/ (`PlenumCli` — `new node`, `new client`, `send
NYM`, status commands; marked semi-legacy upstream but part of the §2.8
surface). This is the operational analog over this package's real
stack: pools provisioned by tools/local_pool, validators on one Looper
over real CurveZMQ sockets, a socket client with f+1 write quorums and
proved reads.

Commands (also `help`):
    new pool <dir> [n]      provision keys + genesis for an n-node pool
    start pool <dir>        start the validators in-process + a client
    status                  per-node view/height/connection summary
    send nym <alias>        trustee-signed NYM for a fresh DID
    get nym <alias>         proved read of an earlier alias
    stop | exit             stop the pool and leave

Scriptable: ``python -m indy_plenum_tpu_torch.cli [--device cpu]`` reads
commands from stdin, so tests and operators can pipe a session.

Copy of ``indy_plenum_tpu/cli/cli.py`` over the port's tools. The pool's
validators run their kernels on the CUDA card unless the CLI is built
with ``device="cpu"`` (``--device cpu``); without a card ``PoolCli()``
raises.
"""
from __future__ import annotations

import hashlib
import shlex
import sys
import time
from typing import Optional


class PoolCli:
    def __init__(self, out=None, device=None):
        from ..utils.torch_env import resolve_device

        self._device = resolve_device(device)
        self._out = out or sys.stdout
        self._looper = None
        self._nodes = []
        self._stacks = []
        self._client = None
        self._trustee = None
        self._aliases = {}  # alias -> DidSigner (targets we created)
        # da: allow[nondet-source] -- interactive CLI seeds req ids from the wall clock; seeded runs drive SimPool/NodePool, never the CLI
        self._req_id = int(time.time()) % 1_000_000

    def _print(self, text: str) -> None:
        print(text, file=self._out)

    # --- commands -------------------------------------------------------

    def do_new_pool(self, directory: str, n: str = "4") -> None:
        from ..tools.local_pool import generate_pool_config

        generate_pool_config(directory, n_nodes=int(n))
        self._print(f"pool of {n} provisioned in {directory}")

    def do_start_pool(self, directory: str) -> None:
        from ..crypto.signers import DidSigner
        from ..tools.local_pool import (
            build_client,
            load_secret_seed,
            run_pool,
        )

        if self._nodes:
            self._print("a pool is already running; `stop` it first")
            return
        self._looper, self._nodes, self._stacks = run_pool(
            directory, device=self._device)
        self._client, client_stack = build_client(directory, "cli-client")
        self._looper.add(client_stack)
        self._trustee = DidSigner(load_secret_seed(directory, "trustee"))
        self._looper.run_until(
            lambda: all(len(s.connected_peers) >= len(self._nodes) - 1
                        for s in self._stacks), timeout=30)
        # warm the signature-verify path BEFORE the first real write: the
        # kernel library's load (a build, the first time) and first launch
        # would otherwise eat the write's quorum timeout
        self._print("warming signature kernels...")
        from ..tools.local_pool import warm_verify_kernel

        warm_verify_kernel(self._nodes[0], self._trustee)
        connected = all(len(s.connected_peers) >= len(self._nodes) - 1
                        for s in self._stacks)
        if connected:
            self._print(
                f"{len(self._nodes)} validators up; client connected "
                f"as cli-client (trustee {self._trustee.identifier})")
        else:
            self._print(
                "WARNING: pool started but not fully connected "
                "(some handshakes pending) — writes may stall; "
                "check `status`")

    def do_status(self) -> None:
        if not self._nodes:
            self._print("no pool running")
            return
        for node in self._nodes:
            self._print(
                f"  {node.name}: view {node.data.view_no}, "
                f"ordered {len(node.ordered_digests)}, "
                f"participating {node.data.is_participating}")

    def do_send_nym(self, alias: str) -> None:
        from ..common.constants import NYM, TARGET_NYM, TXN_TYPE, VERKEY
        from ..common.request import Request
        from ..crypto.signers import DidSigner

        if self._client is None:
            self._print("no pool running")
            return
        target = DidSigner(hashlib.sha256(
            b"cli-nym-" + alias.encode()).digest())
        self._req_id += 1
        req = Request(identifier=self._trustee.identifier,
                      reqId=self._req_id,
                      operation={TXN_TYPE: NYM,
                                 TARGET_NYM: target.identifier,
                                 VERKEY: target.verkey})
        self._trustee.sign_request(req)
        digest = self._client.submit_write(req)
        res = self._await_result(digest)
        if res is not None:
            # alias registered only once the write is CONFIRMED — a
            # timed-out write must not make `get nym` consult a NYM
            # that was never committed
            self._aliases[alias] = target
            self._print(f"NYM {alias} -> {target.identifier} written "
                        f"(f+1 quorum)")
        # rejection/timeout already reported by _await_result

    def do_get_nym(self, alias: str) -> None:
        from ..common.constants import GET_NYM, TARGET_NYM, TXN_TYPE
        from ..common.request import Request

        if self._client is None:
            self._print("no pool running")
            return
        target = self._aliases.get(alias)
        if target is None:
            self._print(f"unknown alias {alias!r} (send nym {alias} first)")
            return
        self._req_id += 1
        req = Request(identifier=self._trustee.identifier,
                      reqId=self._req_id,
                      operation={TXN_TYPE: GET_NYM,
                                 TARGET_NYM: target.identifier})
        digest = self._client.submit_read(req)
        res = self._await_result(digest)
        if res is None:
            self._print(f"get nym {alias}: no verifiable reply")
        elif res.get("data") is None:
            # a proved ABSENCE is a valid verified answer, not a hit
            self._print(f"NYM {alias}: provably absent")
        else:
            self._print(f"NYM {alias}: dest={res.get('dest')} "
                        f"(proved read)")

    def _await_result(self, digest: str, timeout: float = 60.0):
        """Poll to completion OR rejection; retires the request either
        way (take_result — pending must not grow for a long session)
        and surfaces NACK evidence instead of mislabelling it a
        timeout."""
        from ..client.client import RequestRejected

        self._looper.run_until(
            lambda: (self._client.result(digest) is not None
                     or self._client.is_rejected(digest)),
            timeout=timeout)
        try:
            res = self._client.take_result(digest)
        except RequestRejected as rej:
            self._print(f"request rejected by the pool: {rej.nacks}")
            return None
        if res is None:
            self._client.retire(digest)
            self._print("no quorum within timeout")
        return res

    def do_stop(self) -> None:
        if self._looper is not None:
            self._looper.shutdown()  # stop prodables before sockets close
        for node in self._nodes:
            node.stop()
            node.client_surface.close()
        for stack in self._stacks:
            stack.close()
        if self._client is not None:
            self._client.stack.close()
        self._nodes, self._stacks, self._client = [], [], None
        self._looper = self._trustee = None
        self._aliases.clear()  # a later pool must not resolve old aliases
        self._print("pool stopped")

    HELP = (
        "commands: new pool <dir> [n] | start pool <dir> | status | "
        "send nym <alias> | get nym <alias> | stop | exit")

    # --- dispatch -------------------------------------------------------

    def run_command(self, line: str) -> bool:
        """One command; returns False when the session should end."""
        parts = shlex.split(line.strip())
        if not parts:
            return True
        cmd = parts[0].lower()
        try:
            if cmd == "exit":
                self.do_stop()
                return False
            if cmd == "help":
                self._print(self.HELP)
            elif cmd == "new" and parts[1:2] == ["pool"]:
                self.do_new_pool(*parts[2:])
            elif cmd == "start" and parts[1:2] == ["pool"]:
                self.do_start_pool(*parts[2:])
            elif cmd == "status":
                self.do_status()
            elif cmd == "send" and parts[1:2] == ["nym"]:
                self.do_send_nym(*parts[2:])
            elif cmd == "get" and parts[1:2] == ["nym"]:
                self.do_get_nym(*parts[2:])
            elif cmd == "stop":
                self.do_stop()
            else:
                self._print(f"unknown command: {line.strip()!r} — try "
                            "`help`")
        except Exception as exc:  # noqa: BLE001 — a REPL must not die on
            # a failed command; the operator sees the error and continues
            self._print(f"error: {exc}")
        return True

    def repl(self, stdin=None) -> None:
        stdin = stdin or sys.stdin
        self._print("indy-plenum-tpu cli — `help` for commands")
        for line in stdin:
            if not self.run_command(line):
                return
        self.do_stop()  # EOF: clean shutdown


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m indy_plenum_tpu_torch.cli",
        description="Provision, run and talk to a local pool; commands "
                    "are read from stdin.")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    PoolCli(device=args.device).repl()
    return 0


if __name__ == "__main__":
    sys.exit(main())
