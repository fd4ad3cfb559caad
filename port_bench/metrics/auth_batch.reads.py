"""Mean requests in one node's ingress auth drain (the program's
auth.batch_size)."""
from port_bench.readers import mean


def read(run):
    return mean(run, "auth.batch_size")
