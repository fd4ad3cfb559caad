"""Operational tooling: pool provisioning + node runner (CLI back-end).

Copy of ``indy_plenum_tpu/tools/__init__.py``: the same exports.
"""
from .local_pool import (
    build_client,
    build_node,
    generate_pool_config,
    run_pool,
)

__all__ = ["build_client", "build_node", "generate_pool_config", "run_pool"]
