"""Mean requests in a 3PC batch as the nodes execute it (the program's
3pc.ordered_batch_size)."""
from port_bench.readers import mean


def read(run):
    return mean(run, "3pc.ordered_batch_size")
