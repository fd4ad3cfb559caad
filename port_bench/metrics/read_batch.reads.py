"""Mean reads in one read-service drain (the program's
ingress.read_batch_size)."""
from port_bench.readers import mean


def read(run):
    return mean(run, "ingress.read_batch_size")
