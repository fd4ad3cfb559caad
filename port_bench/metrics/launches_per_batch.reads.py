"""Quorum-layer kernel launches (K7, K8's slide and zero, K9) over the
master instance's 3PC batches ordered in the window."""
from port_bench.readers import per_batch

KERNELS = ("quorum_step", "resident_step", "window_slide", "window_zero")


def read(run):
    return per_batch(run, sum(run.launches.get(k, 0) for k in KERNELS))
