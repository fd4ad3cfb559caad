"""The port's event loop and logging (``common/looper.py``,
``common/log.py``) against the JAX package's.

- The same prodables and ``QueueTimer`` callbacks on an injected clock
  through both packages' ``Looper``: the same pump order (every transport
  before any due timer event), the same ``errors`` count when a prodable
  or a timer callback raises, the same ``run_until`` results, and the
  same ``shutdown``.
- ``TimeAndSizeRotatingFileHandler`` rolls over on size and prunes to the
  same file names as the reference's; ``setup_logging`` applies the
  config's level, and replaces its own handler on a second call.
"""
import importlib
import logging
import logging.handlers
import os
import time

import pytest

JAX, PORT = "indy_plenum_tpu", "indy_plenum_tpu_torch"
PACKAGES = (JAX, PORT)


def mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


class Clock:
    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now


class Transport:
    """A prodable that drains ``pending`` reads into ``log``."""

    def __init__(self, name, log, fail_on=()):
        self.name, self.log, self.fail_on = name, log, set(fail_on)
        self.pending = 0
        self.pumps = 0
        self.started = self.stopped = 0

    def start(self):
        self.started += 1

    def stop(self):
        self.stopped += 1

    def prod(self):
        self.pumps += 1
        if self.pumps in self.fail_on:
            self.log.append(f"{self.name}:raise")
            raise RuntimeError(f"{self.name} failed")
        done, self.pending = self.pending, 0
        if done:
            self.log.append(f"{self.name}:drain{done}")
        return done


class Serviced:
    """A prodable with only ``service`` (the zstack shape)."""

    def __init__(self, log):
        self.log = log

    def service(self):
        self.log.append("svc")
        return 0


def scenario(pkg):
    """Two transports, a service-only prodable and timer callbacks on an
    injected clock; one transport and one callback raise once. Returns
    the event log of four pumps, the work and errors after each, the
    run_until results (their pump counts ride the host's clock) and the
    transports' start and stop counts."""
    clock = Clock()
    log = []
    timer = mod(pkg, "common.timer").QueueTimer(clock)
    looper = mod(pkg, "common.looper").Looper(timer=timer, idle_sleep=0.0)
    a = Transport("a", log)
    b = Transport("b", log, fail_on=(3,))
    for p in (a, b, Serviced(log)):
        looper.add(p)

    def tick(tag):
        def fire():
            log.append(f"timer:{tag}")
        return fire

    def boom():
        log.append("timer:boom")
        raise ValueError("callback failed")

    errors = []
    timer.schedule(0.0, tick("t0"))
    a.pending, b.pending = 2, 1
    errors.append((looper._pump_once(), looper.errors))
    timer.schedule(1.0, tick("t1"), barrier=True)
    timer.schedule(1.0, tick("t2"))
    a.pending = 3
    clock.now += 1.0
    errors.append((looper._pump_once(), looper.errors))
    timer.schedule(0.0, boom)
    timer.schedule(0.5, tick("after_boom"))
    b.pending = 4
    errors.append((looper._pump_once(), looper.errors))
    clock.now += 1.0
    errors.append((looper._pump_once(), looper.errors))

    pumped = list(log)
    a.pending = 1
    drained = looper.run_until(lambda: a.pending == 0, timeout=5.0)
    never = looper.run_until(lambda: False, timeout=0.02)
    looper.remove(b)
    looper.shutdown()
    return {"log": pumped, "errors": errors, "run_until": (drained, never),
            "final_errors": looper.errors,
            "lifecycle": [(t.started, t.stopped) for t in (a, b)]}


@pytest.fixture(scope="module")
def scenarios():
    return {pkg: scenario(pkg) for pkg in PACKAGES}


def test_pump_order_matches_reference(scenarios):
    port, ref = scenarios[PORT], scenarios[JAX]
    # transports drain before the due timer events of the same pass, and
    # a barrier event fires after a plain one due at the same instant
    first = port["log"][:4]
    assert first == ["a:drain2", "b:drain1", "svc", "timer:t0"]
    second = port["log"][4:8]
    assert second == ["a:drain3", "svc", "timer:t2", "timer:t1"]
    assert port["log"] == ref["log"]


def test_errors_count_matches_reference(scenarios):
    port, ref = scenarios[PORT], scenarios[JAX]
    assert port["errors"] == ref["errors"]
    # the raising transport, then the raising callback, each counted once
    assert [e for _, e in port["errors"]] == [0, 0, 2, 2]
    assert "timer:after_boom" in port["log"]
    assert port["final_errors"] == ref["final_errors"] == 2


def test_run_until_and_shutdown_match_reference(scenarios):
    port, ref = scenarios[PORT], scenarios[JAX]
    assert port["run_until"] == ref["run_until"] == (True, False)
    assert port["lifecycle"] == ref["lifecycle"] == [(1, 1), (1, 0)]


def test_deployed_clock_is_epoch_aligned():
    for pkg in PACKAGES:
        looper = mod(pkg, "common.looper").Looper()
        assert abs(looper.timer.get_current_time() - time.time()) < 5.0


# --- logging ----------------------------------------------------------------


@pytest.fixture
def frozen_clock(monkeypatch):
    """Hold the handlers' clock, so rollovers come from size alone and
    the time-bucket suffix is one for both packages."""
    monkeypatch.setattr(logging.handlers.time, "time",
                        lambda: 1_700_000_000.0)


def roll(pkg, directory, records=60, max_bytes=300, backups=3):
    log_mod = mod(pkg, "common.log")
    path = os.path.join(directory, "node.log")
    handler = log_mod.TimeAndSizeRotatingFileHandler(
        path, when="h", interval=1, backup_count=backups,
        max_bytes=max_bytes, utc=True)
    handler.setFormatter(logging.Formatter("%(message)s"))
    logger = logging.getLogger(f"rotation-{pkg}")
    logger.propagate = False
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        for i in range(records):
            logger.info("a log line long enough to force rollovers %04d", i)
            # the prune orders backups by mtime: keep each file's last
            # write a few clock ticks of the file system after the last
            time.sleep(0.004)
    finally:
        logger.removeHandler(handler)
        handler.close()
    return sorted(os.listdir(directory))


def test_rotating_handler_rolls_and_prunes_like_reference(tmp_path,
                                                          frozen_clock):
    names = {}
    for pkg in PACKAGES:
        directory = tmp_path / pkg
        directory.mkdir()
        names[pkg] = roll(pkg, str(directory))
    assert names[PORT] == names[JAX]
    assert "node.log" in names[PORT]
    # pruned to backup_count rotated files beside the live one
    assert len(names[PORT]) == 1 + 3


def test_rotation_filename_uniquified_like_reference(tmp_path):
    for pkg in PACKAGES:
        handler = mod(pkg, "common.log").TimeAndSizeRotatingFileHandler(
            str(tmp_path / f"{pkg}.log"), max_bytes=100)
        try:
            base = str(tmp_path / "taken")
            open(base, "w").close()
            open(base + ".1", "w").close()
            assert handler.rotation_filename(base) == base + ".2"
        finally:
            handler.close()


@pytest.mark.parametrize("level", ["WARNING", "DEBUG"])
def test_setup_logging_applies_config_level(tmp_path, level):
    seen = []
    for pkg in PACKAGES:
        log_mod = mod(pkg, "common.log")
        config = mod(pkg, "config").getConfig({"logLevel": level})
        logger = logging.getLogger(f"setup-{pkg}-{level}")
        path = str(tmp_path / pkg / "v.log")
        handler = log_mod.setup_logging(
            level=config.logLevel, log_file=path,
            max_bytes=config.logRotationMaxBytes,
            backup_count=config.logRotationBackupCount,
            when=config.logRotationWhen,
            interval=config.logRotationInterval, logger=logger)
        again = log_mod.setup_logging(level=config.logLevel, log_file=path,
                                      logger=logger)
        try:
            rotating = [h for h in logger.handlers if isinstance(
                h, log_mod.TimeAndSizeRotatingFileHandler)]
            seen.append((logger.level, len(rotating),
                         handler.backupCount, again.max_bytes))
            assert rotating == [again]
        finally:
            logger.removeHandler(again)
            again.close()
    assert seen[0] == seen[1]
    assert seen[1][0] == getattr(logging, level)


def test_getlogger_namespaces():
    assert mod(PORT, "common.log").getlogger().name == PORT
    assert mod(JAX, "common.log").getlogger().name == JAX
    assert mod(PORT, "common.log").getlogger("x.y").name == "x.y"
