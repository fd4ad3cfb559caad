"""Percent of the traced window in which no operation ran on the card."""
from port_bench.readers import idle_share


def read(run):
    return idle_share(run)
