"""Free TCP ports for the port's socket tests (a helper, not a test file).

A provisioned pool writes fixed ports into ``pool_info.json``, so its
tests must choose them. The JAX package's socket tests bind fixed ranges
(``tests/test_plugins_tools.py`` from 17700, ``tests/test_client_socket.py``
from 17800, ``tests/test_socket_membership.py`` from 17900, the CLI's
``new pool`` default from 9700), and the tier-1 run puts test files on
several xdist workers at once. Each worker here takes its own slice of
20000-31999, below the kernel's ephemeral range (32768 and up, where
outgoing connections and ``bind_port=0`` listeners land), and hands out
blocks of it in turn, each port checked free by a test bind.
"""
import os
import socket

_LO, _SLICE, _SLICES = 20000, 1500, 8
_cursor = {}


def _worker_slice():
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    index = int(worker[2:]) if worker.startswith("gw") and \
        worker[2:].isdigit() else _SLICES - 1
    lo = _LO + (index % _SLICES) * _SLICE
    return lo, lo + _SLICE


def _free(port: int) -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        try:
            sock.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def free_port_block(n: int) -> int:
    """The first of ``n`` consecutive free ports in this worker's slice;
    successive calls move on through the slice (wrapping around), so a
    pool that has just closed does not hand its ports to the next one."""
    lo, hi = _worker_slice()
    start = _cursor.get(lo, lo)
    for _ in range(2 * (hi - lo)):
        if start + n > hi:
            start = lo
        bad = next((p for p in range(start, start + n) if not _free(p)),
                   None)
        if bad is None:
            _cursor[lo] = start + n
            return start
        start = bad + 1
    raise RuntimeError(f"no {n} free ports in {lo}-{hi}")
