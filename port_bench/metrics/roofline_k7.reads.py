"""K7 (quorum_step_kernel): the frozen bound of the window's launches over
their device time in the trace, in percent."""
from port_bench.readers import roofline


def read(run):
    return roofline(run, "k7")
