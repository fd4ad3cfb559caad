"""Seconds from the start of the process to the window: imports, the kernel
library and the BN254 extension (built on first use), the pool, the
clients' signing, the read population and the warm-up batch."""


def read(run):
    return run.setup_s
