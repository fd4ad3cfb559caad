"""95th percentile of the wall time from a read's submit to its serving
drain, over every proved read served in the window."""
from port_bench.readers import latency_p95_ms, proved_in_window


def read(run):
    return latency_p95_ms(proved_in_window(run))
