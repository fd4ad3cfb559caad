"""Logging subsystem: namespaced loggers + time-and-size rotation.

Reference: stp_core/common/log.py (``getlogger``) and
stp_core/common/logging/TimeAndSizeRotatingFileHandler.py. A long-running
validator needs bounded on-disk logs: the handler rolls over when EITHER
the active file exceeds ``max_bytes`` OR the time interval elapses —
whichever comes first — keeping ``backup_count`` rotated files.
``setup_logging`` applies the config's verbosity and attaches the handler
process-wide; libraries keep using stdlib ``logging`` so nothing in the
package needs to import this module to be captured.

Copy of ``indy_plenum_tpu/common/log.py``; ``getlogger`` names the
port's namespace.
"""
from __future__ import annotations

import logging
import logging.handlers
import os
import time
from typing import Optional

DEFAULT_FORMAT = ("%(asctime)s | %(levelname)-8s | %(name)s "
                  "(%(filename)s:%(lineno)d) | %(message)s")


class TimeAndSizeRotatingFileHandler(
        logging.handlers.TimedRotatingFileHandler):
    """Rolls over on size OR time, whichever trips first."""

    def __init__(self, filename: str, when: str = "h", interval: int = 1,
                 backup_count: int = 10, max_bytes: int = 10 * 1024 * 1024,
                 **kwargs):
        super().__init__(filename, when=when, interval=interval,
                         backupCount=backup_count, **kwargs)
        self.max_bytes = max_bytes

    def shouldRollover(self, record) -> bool:  # noqa: N802 — stdlib API
        if super().shouldRollover(record):
            return True
        if self.max_bytes <= 0:
            return False
        if self.stream is None:
            self.stream = self._open()
        msg = f"{self.format(record)}\n"
        self.stream.seek(0, 2)
        return self.stream.tell() + len(msg) >= self.max_bytes

    def rotation_filename(self, default_name: str) -> str:
        """Size-triggered rollovers within one time bucket must not
        collide (TimedRotatingFileHandler names by time only, so two
        rollovers in the same second would silently overwrite)."""
        name = default_name
        counter = 0
        while os.path.exists(name):
            counter += 1
            name = f"{default_name}.{counter}"
        return name

    def doRollover(self) -> None:  # noqa: N802 — stdlib API
        super().doRollover()
        self._prune_backups()

    def _prune_backups(self) -> None:
        """Own pruning: the stdlib deletion regex does not match the
        uniquified same-bucket names, so without this the backups would
        grow unbounded — the exact failure this handler exists to stop."""
        if self.backupCount <= 0:
            return
        directory = os.path.dirname(self.baseFilename)
        base = os.path.basename(self.baseFilename)
        backups = sorted(
            (f for f in os.listdir(directory)
             if f.startswith(base + ".")),
            key=lambda f: os.path.getmtime(os.path.join(directory, f)))
        while len(backups) > self.backupCount:
            try:
                os.unlink(os.path.join(directory, backups.pop(0)))
            except OSError:  # pragma: no cover — raced with an external
                pass  # cleaner; a leftover file is not worth crashing for


def getlogger(name: Optional[str] = None) -> logging.Logger:
    """The reference's accessor: module loggers under one namespace."""
    return logging.getLogger(name or "indy_plenum_tpu_torch")


def setup_logging(level: str = "INFO",
                  log_file: Optional[str] = None,
                  max_bytes: int = 10 * 1024 * 1024,
                  backup_count: int = 10,
                  when: str = "h",
                  interval: int = 1,
                  logger: Optional[logging.Logger] = None
                  ) -> Optional[TimeAndSizeRotatingFileHandler]:
    """Apply verbosity + attach the rotating file handler.

    Returns the handler (None when ``log_file`` is not given) so a
    composition can detach it on shutdown. Idempotent enough for tests:
    a second call with the same file replaces the previous handler.
    """
    root = logger if logger is not None else logging.getLogger()
    root.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    if log_file is None:
        return None
    os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
    for h in list(root.handlers):
        if isinstance(h, TimeAndSizeRotatingFileHandler) \
                and getattr(h, "baseFilename", None) == os.path.abspath(
                    log_file):
            root.removeHandler(h)
            h.close()
    handler = TimeAndSizeRotatingFileHandler(
        log_file, when=when, interval=interval,
        backup_count=backup_count, max_bytes=max_bytes, utc=True)
    formatter = logging.Formatter(DEFAULT_FORMAT)
    # UTC everywhere: %(asctime)s goes through the FORMATTER's converter
    # (a converter on the handler is read by nothing), and utc=True keeps
    # rollover filenames consistent — cross-node log correlation breaks
    # the moment hosts disagree on timezone
    formatter.converter = time.gmtime
    handler.setFormatter(formatter)
    root.addHandler(handler)
    return handler
