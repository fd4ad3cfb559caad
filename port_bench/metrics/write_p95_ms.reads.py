"""95th percentile of the wall time from a write's send to its f+1-th
matching reply, over every write acknowledged in the window."""
from port_bench.readers import acked_in_window, latency_p95_ms


def read(run):
    return latency_p95_ms(acked_in_window(run))
