"""Percent of the window's wall time in the grouped vote plane's flushes
(the program's device.flush_time)."""
from port_bench.readers import time_share


def read(run):
    return time_share(run, "device.flush_time")
