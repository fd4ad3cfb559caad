"""Run one validator from a provisioned pool directory.

Usage (from the root of a checkout):
    python -m indy_plenum_tpu_torch.tools.start_node DIR NODE_NAME
    python -m indy_plenum_tpu_torch.tools.start_node DIR NODE_NAME \
        --device cpu

Twin of ``scripts/start_node.py`` (reference analog:
scripts/start_plenum_node), one process per validator; peers may live on
other hosts as long as ``pool_info.json`` carries their reachable
addresses. The validator's kernels run on the CUDA card (the default) or,
with ``--device cpu``, as their plain PyTorch versions; without a card
and without ``--device cpu`` it exits non-zero before binding a socket.

Logging follows the config's ``log*`` knobs into ``DIR/logs/NAME.log``.
``kill -USR2 <pid>`` writes a flight dump of the node's trace ring there;
SIGINT or SIGTERM stops the node, its looper and its sockets, prints one
JSON line (ordered count, domain ledger root, looper errors, the kernel
launches of this process) and exits 0.
"""
import argparse
import json
import os
import signal
import sys


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m indy_plenum_tpu_torch.tools.start_node",
        description="Run one validator of a provisioned pool directory.")
    ap.add_argument("directory")
    ap.add_argument("name")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)

    from ..common.constants import DOMAIN_LEDGER_ID
    from ..common.log import setup_logging
    from ..common.looper import Looper
    from ..config import getConfig
    from ..server.client_authn import warm_device_auth_path
    from ..utils import kernel_build
    from ..utils.torch_env import resolve_device
    from .local_pool import build_node

    device = resolve_device(args.device)
    directory, name = args.directory, args.name
    config = getConfig()
    setup_logging(
        level=config.logLevel,
        log_file=os.path.join(directory, "logs", f"{name}.log"),
        max_bytes=config.logRotationMaxBytes,
        backup_count=config.logRotationBackupCount,
        when=config.logRotationWhen,
        interval=config.logRotationInterval)
    looper = Looper()
    node, stack = build_node(directory, name, looper, device=device)
    # load the kernel library BEFORE joining consensus: the first ingress
    # drain must not stall the protocol thread on a build
    warm_device_auth_path(device)
    node.start()
    # operator flight dump: `kill -USR2 <pid>` snapshots the trace ring
    # (flight.signal mark) and writes <logs>/<name>.flight.jsonl without
    # stopping the node; only the process entry point installs handlers
    node.install_signal_handlers(
        dump_dir=os.path.join(directory, "logs"))
    signal.signal(signal.SIGTERM, _interrupt)
    looper.add(stack)
    looper.add(node.client_surface)
    print(f"{name} listening on {stack.ha[0]}:{stack.ha[1]} "
          f"(clients: {node.client_surface.stack.ha[1]}) on {device} "
          f"- ^C to stop", flush=True)
    try:
        while True:
            looper.run_for(3600)
    except KeyboardInterrupt:
        pass
    finally:
        node.stop()
        looper.shutdown()
        stack.close()
        node.client_surface.close()
    print(json.dumps({"node": name, "stopped": True,
                      "ordered": len(node.ordered_digests),
                      "domain_root": node.boot.db.get_ledger(
                          DOMAIN_LEDGER_ID).root_hash.hex(),
                      "looper_errors": looper.errors,
                      "launches": kernel_build.launch_counts()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
