"""Percent of the window's wall time in the nodes' ingress auth drains (the
program's auth.batch_time)."""
from port_bench.readers import time_share


def read(run):
    return time_share(run, "auth.batch_time")
