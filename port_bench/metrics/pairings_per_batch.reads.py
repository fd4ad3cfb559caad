"""BLS pairings computed over the master instance's 3PC batches ordered in
the window."""
from port_bench.readers import per_batch


def read(run):
    return per_batch(run, run.pairings)
