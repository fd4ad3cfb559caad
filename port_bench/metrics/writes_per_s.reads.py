"""Signed NYM writes whose client holds f+1 matching replies inside the
window, over the window's wall seconds."""
from port_bench.readers import acked_in_window


def read(run):
    return len(acked_in_window(run)) / run.seconds
