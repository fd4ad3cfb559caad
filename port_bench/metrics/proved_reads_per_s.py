"""Reads served inside the window with an audit path the node verified and
the pool's BLS multi-signature over its root, over the window's wall
seconds."""
from port_bench.readers import proved_in_window


def read(run):
    return len(proved_in_window(run)) / run.seconds
