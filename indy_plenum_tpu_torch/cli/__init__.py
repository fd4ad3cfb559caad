"""The pool CLI (copy of ``indy_plenum_tpu/cli/__init__.py``)."""
from .cli import PoolCli, main  # noqa: F401
