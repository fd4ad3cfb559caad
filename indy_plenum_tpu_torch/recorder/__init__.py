"""Message recording + deterministic replay (reference: plenum/recorder/).

Copy of ``indy_plenum_tpu/recorder/__init__.py``.
"""
from .recorder import Recorder, Replayer

__all__ = ["Recorder", "Replayer"]
