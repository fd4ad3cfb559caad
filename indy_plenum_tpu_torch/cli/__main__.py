"""``python -m indy_plenum_tpu_torch.cli``: the pool CLI's REPL on stdin.

Copy of ``indy_plenum_tpu/cli/__main__.py``, with the call guarded so that
importing this module starts nothing.
"""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
