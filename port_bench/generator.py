"""Seeded traffic draws for the benchmark's closed-loop clients.

One stream a purpose, every draw from it, so one seed replays the same
sequence (the discipline of the program's generator,
``indy_plenum_tpu_torch/ingress/workload.py``). That generator's Zipf
draw needs an exponent above 1; YCSB's Zipfian (theta = 0.99 over a
bounded key space, Cooper et al., SoCC 2010) does not, so
:meth:`Draws.zipf_bounded` draws it by the inverse of its distribution
function. The stream is numpy's PCG64 (``default_rng``), which takes
any non-negative seed: the benchmark's seeds run past 2**32.
"""
from __future__ import annotations

import numpy as np


class Draws:
    def __init__(self, seed: int, stream: int = 0):
        self._rng = np.random.default_rng([int(seed), int(stream)])
        self._cdf = {}

    def zipf_bounded(self, theta: float, n: int) -> int:
        """Index in [0, n) with P(k) proportional to 1 / (k + 1)^theta."""
        cdf = self._cdf.get((theta, n))
        if cdf is None:
            w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta
            cdf = self._cdf[(theta, n)] = np.cumsum(w) / w.sum()
        return int(min(np.searchsorted(cdf, self._rng.random()), n - 1))

    def permutation(self, n: int) -> list:
        """The numbers 0 .. n - 1 in a seeded order."""
        return [int(i) for i in self._rng.permutation(n)]

    def integer(self, n: int) -> int:
        return int(self._rng.integers(n))

    def bytes(self, n: int) -> bytes:
        return self._rng.bytes(n)
