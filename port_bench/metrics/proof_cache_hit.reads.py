"""Percent of the reads served in the window that found a stabilized
window's multi-signature in the proof cache (the program's
proof.cache_hit and proof.cache_miss, counted in reads)."""


def read(run):
    hits = run.stat("proof.cache_hit")[1]
    misses = run.stat("proof.cache_miss")[1]
    total = hits + misses
    return 100.0 * hits / total if total else None
