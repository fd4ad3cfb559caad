"""The port's analyzer (``indy_plenum_tpu_torch.analysis``) against the
reference's, and the port package held clean by it.

- Every fixture source of ``tests/test_static_analysis.py``, copied into
  one parametrised list: for the five rules the port copies
  (``nondet-source``, ``hash-id-flow``, ``unordered-fingerprint``,
  ``trace-guard``, ``config-knob``) and the pragma self-lint, the port's
  analyzer gives the reference's (rule, line, col, suppression) on every
  fixture, the fixture's path mapped from ``indy_plenum_tpu/`` to
  ``indy_plenum_tpu_torch/``.
- The retargeted rules on torch fixtures: ``device-sync`` flags
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``torch.cuda.synchronize()``, an event's ``.synchronize()``,
  ``np.asarray`` over a tensor and a tainted ``float()`` outside
  ``tpu/vote_plane.py`` / ``tpu/quorum.py``; ``buffer-donation`` flags
  ``torch.from_numpy`` / ``torch.as_tensor`` over a persistent buffer and
  an unguarded ``non_blocking`` copy from one, and passes the fresh, the
  forced-copy and the event-guarded forms.
- The port package is clean, its ``findings_hash`` is byte-identical
  across runs, every pragma has a reason, the shipped baseline is empty,
  and a missing path fails closed.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from indy_plenum_tpu import analysis as ref
from indy_plenum_tpu_torch import analysis as port
from indy_plenum_tpu_torch.analysis.rules_config import ConfigKnobRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "indy_plenum_tpu_torch")
SHARED = ("nondet-source", "hash-id-flow", "unordered-fingerprint",
          "trace-guard", "config-knob", "pragma")


def src(text):
    return textwrap.dedent(text)


def to_port(path):
    if path.startswith("indy_plenum_tpu/"):
        return "indy_plenum_tpu_torch/" + path[len("indy_plenum_tpu/"):]
    return path


_HOT = "indy_plenum_tpu/tpu/fake_plane.py"
_SERVER = "indy_plenum_tpu/server/fake.py"

# (name, source, path) of every single-module fixture of
# tests/test_static_analysis.py
FIXTURES = [
    ("wall_clock_alias", src("""
        import time as _t

        def f():
            return _t.perf_counter()
    """), "fixture.py"),
    ("from_import_and_datetime", src("""
        from time import monotonic
        from datetime import datetime

        def f():
            return monotonic(), datetime.now()
    """), "fixture.py"),
    ("unseeded_rng", src("""
        import random
        import numpy as np

        def bad():
            return random.Random(), np.random.RandomState(), \\
                random.randint(0, 4), np.random.rand(3)

        def good(seed):
            return random.Random(seed), np.random.RandomState(seed)
    """), "fixture.py"),
    ("pragma_with_reason", src("""
        import time

        def f():
            t0 = time.perf_counter()  # da: allow[nondet-source] -- wall meter
            return t0
    """), "fixture.py"),
    ("standalone_pragma", src("""
        import time

        def f():
            # da: allow[nondet-source] -- wall meter spanning a long call
            t0 = time.perf_counter()
            return t0
    """), "fixture.py"),
    ("file_level_pragma", src("""
        # da: allow-file[nondet-source] -- deployed-clock module
        import time

        def f():
            return time.time()

        def g():
            return time.monotonic()
    """), "fixture.py"),
    ("crypto_allowlist", src("""
        import os

        def keygen():
            return os.urandom(32)
    """), "indy_plenum_tpu/crypto/newkeys.py"),
    ("docstring_grammar", src('''
        import time

        def f():
            """Examples: # da: allow[nondet-source] -- quoted"""
            return time.time()
    '''), "fixture.py"),
    ("missing_reason", src("""
        import time

        def f():
            return time.time()  # da: allow[nondet-source]
    """), "fixture.py"),
    ("unknown_rule", src("""
        x = 1  # da: allow[no-such-rule] -- because
    """), "fixture.py"),
    ("hash_into_sink", src("""
        import hashlib

        def fingerprint(items):
            h = hash(tuple(items))
            return hashlib.sha256(str(h).encode()).hexdigest()
    """), "fixture.py"),
    ("dunder_hash", src("""
        class K:
            def __hash__(self):
                return hash((self.a, self.b))
    """), "fixture.py"),
    ("plain_hash_no_sink", src("""
        def bucket(key, n):
            return hash(key) % n
    """), "fixture.py"),
    ("set_iteration_in_hash_fn", src("""
        import hashlib

        def ordered_hash(digests):
            acc = hashlib.sha256()
            for d in set(digests):
                acc.update(d)
            return acc.hexdigest()
    """), "fixture.py"),
    ("sorted_wrapper", src("""
        import hashlib

        def ordered_hash(digests):
            acc = hashlib.sha256()
            for d in sorted(set(digests)):
                acc.update(d)
            return acc.hexdigest()
    """), "fixture.py"),
    ("dict_values_and_named_set", src("""
        def trace_hash(by_node):
            seen = set()
            rows = [v for v in by_node.values()]
            rows += [s for s in seen]
            return my_hash(rows)
    """), "fixture.py"),
    ("non_fingerprint_fn", src("""
        def drain(pending):
            for p in set(pending):
                p.fire()
    """), "fixture.py"),
    ("trace_unguarded", src("""
        def flush(self):
            self.trace.record("flush.dispatch", cat="dispatch",
                              args={"votes": self.votes})
    """), _HOT),
    ("trace_guarded_if_and_name", src("""
        def flush(self):
            if self.trace.enabled:
                self.trace.record("a", args={"v": 1 + 1})
            trace_on = self.trace.enabled
            if trace_on:
                self.trace.record("b", args={"v": self.x * 2})
    """), _HOT),
    ("trace_ifexp_span", src("""
        def tick(self, _NO_SPAN):
            with self.trace.span("tick.eval",
                                 args={"n": len(self.nodes)}) \\
                    if self.trace.enabled else _NO_SPAN:
                pass
    """), _HOT),
    ("trace_early_exit", src("""
        def mark(self, key):
            if not self.trace.enabled:
                return
            self.trace.record("m", key=(key, self.view_no))
    """), _HOT),
    ("trace_constant_args", src("""
        def tick(self):
            self.trace.record("tick.drain", cat="dispatch")
    """), _HOT),
    ("trace_out_of_scope", src("""
        def report(self):
            self.trace.record("chaos.fault", args={"k": [1, 2]})
    """), "indy_plenum_tpu/chaos/fake.py"),
    ("jax_sync_calls", src("""
        import jax
        import jax.numpy as jnp
        import numpy as np

        def readback(dev):
            host = np.asarray(dev)
            full = jax.device_get(dev)
            dev.block_until_ready()
            return host, full
    """), _SERVER),
    ("jax_float_coercion", src("""
        import jax.numpy as jnp

        def occupancy(votes, cap):
            frac = jnp.sum(votes) / cap
            return float(frac)
    """), _SERVER),
    ("jax_sanctioned_vote_plane", src("""
        import jax
        import numpy as np

        def absorb(dev):
            return np.asarray(jax.device_get(dev))
    """), "indy_plenum_tpu/tpu/vote_plane.py"),
    ("jax_non_jax_module", src("""
        import numpy as np

        def pack(rows):
            return np.asarray(rows)
    """), "indy_plenum_tpu/ledger/fake.py"),
    ("jax_persistent_buffer", src("""
        import jax.numpy as jnp

        def stage(self):
            return jnp.asarray(self._scatter_buf)
    """), _HOT),
    ("jax_local_alias_of_buffer", src("""
        import jax.numpy as jnp

        def stage(self):
            buf = self._bufs[64]
            buf[:] = 0
            return jnp.asarray(buf)
    """), _HOT),
    ("jax_fresh_and_forced_copy", src("""
        import jax.numpy as jnp
        import numpy as np

        def stage(self, words):
            fresh = np.zeros((4, 64), np.uint32)
            return jnp.asarray(fresh), jnp.array(self._buf), \\
                jnp.asarray(words_row(words))
    """), _HOT),
    ("unrelated_enabled_flag", src("""
        def flush(self):
            if self.metrics.enabled:
                self.trace.record("a", args={"v": self.x + 1})
    """), _HOT),
    ("inverted_guard", src("""
        def flush(self):
            off = not self.trace.enabled
            if off:
                self.trace.record("a", args={"v": self.x + 1})
    """), _HOT),
    ("negated_if_else_branch", src("""
        def flush(self):
            if not self.trace.enabled:
                pass
            else:
                self.trace.record("a", args={"v": self.x + 1})
    """), _HOT),
    ("bare_relative_tpu_import", src("""
        import numpy as np
        from . import ed25519 as ted

        def readback(batch):
            return np.asarray(ted.verify_kernel_full(batch))
    """), "indy_plenum_tpu/tpu/staging.py"),
    ("streaming_hashlib_update", src("""
        import hashlib

        def ordered_hash(items):
            h = hash(tuple(items))
            acc = hashlib.sha256()
            acc.update(str(h).encode())
            return acc.hexdigest()
    """), "fixture.py"),
    ("trailing_knob_pragma", src("""
        from dataclasses import dataclass

        @dataclass
        class Config:
            KnobA: int = 1  # da: allow[config-knob] -- read by scripts
            KnobB: int = 2
    """), "fakepkg/config.py"),
    ("nested_function_scopes", src("""
        import hashlib

        def outer(items):
            h = hash(items[0])

            def inner(xs):
                g = hash(xs)
                return hashlib.sha256(str(g).encode())
            return inner, h
    """), "fixture.py"),
]

_CONFIG_FIXTURE = src("""
    from dataclasses import dataclass

    @dataclass
    class Config:
        KnobUsed: int = 1
        KnobOrphan: int = 2
        KnobPragmad: int = 3  # da: allow[config-knob] -- read by external scripts
""")
KNOB_CONSUMERS = [
    ("unknown_read_and_orphan", src("""
        def f(config):
            return config.KnobUsed + config.KnobTypo
    """)),
    ("getattr_read", src("""
        def f(config):
            return getattr(config, "KnobOrphan", None)
    """)),
    ("plain_read", "def f(config):\n    return config.KnobUsed\n"),
]


def shared_hits(report):
    return [(f.rule, f.line, f.col, f.suppressed) for f in report.findings
            if f.rule in SHARED]


@pytest.mark.parametrize("name,source,path", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_shared_rules_match_reference(name, source, path):
    want = shared_hits(ref.analyze_source(source, path=path))
    got = shared_hits(port.analyze_source(source, path=to_port(path)))
    assert got == want


@pytest.mark.parametrize("name,consumer", KNOB_CONSUMERS,
                         ids=[k[0] for k in KNOB_CONSUMERS])
def test_config_knob_matches_reference(name, consumer):
    def run(pkg):
        return pkg.Analyzer(pkg.make_rules()).analyze_modules([
            pkg.ModuleInfo.from_source(_CONFIG_FIXTURE,
                                       path="fakepkg/config.py"),
            pkg.ModuleInfo.from_source(consumer, path="fakepkg/user.py")])

    want, got = shared_hits(run(ref)), shared_hits(run(port))
    assert got == want
    assert any(rule == "config-knob" for rule, *_ in want) \
        or name == "plain_read"


def test_fixture_list_covers_every_shared_rule():
    seen = set()
    for _, source, path in FIXTURES:
        seen.update(f.rule for f in port.analyze_source(
            source, path=to_port(path)).findings)
    assert set(SHARED) - {"config-knob"} <= seen


def test_knob_registry_matches_reference():
    from indy_plenum_tpu.analysis.rules_config import ConfigKnobRule as Ref

    tables = []
    for pkg, rule in ((ref, Ref()), (port, ConfigKnobRule())):
        pkg.Analyzer([rule]).analyze_modules([
            pkg.ModuleInfo.from_source(_CONFIG_FIXTURE,
                                       path="fakepkg/config.py"),
            pkg.ModuleInfo.from_source(KNOB_CONSUMERS[2][1],
                                       path="fakepkg/user.py")])
        tables.append(rule.render_registry())
    assert tables[0] == tables[1]
    assert "| `KnobUsed` | `1` |" in tables[1]


# --- device-sync, retargeted at torch ---------------------------------------

_PORT_SERVER = "indy_plenum_tpu_torch/server/fake.py"


def flagged(report, rule):
    return [(f.line, f.message.split(" — ")[0]) for f in report.unsuppressed
            if f.rule == rule]


SYNC_FORMS = [
    ("item", "return t.item()"),
    ("tolist", "return t.tolist()"),
    ("cpu", "return t.cpu()"),
    ("numpy", "return t.numpy()"),
    ("to_cpu", 'return t.to("cpu")'),
    ("to_cpu_kw", 'return t.to(device="cpu")'),
    ("to_torch_device_cpu", 'return t.to(torch.device("cpu"))'),
    ("cuda_synchronize", "torch.cuda.synchronize()"),
    ("event_synchronize", "event.synchronize()"),
    ("np_asarray_tainted", "x = torch.zeros(3)\n    return np.asarray(x)"),
    ("np_array_torch_expr", "return np.array(torch.ones(2))"),
    ("float_tainted", "frac = torch.sum(t) / 4\n    return float(frac)"),
    ("int_torch_expr", "return int(torch.count_nonzero(t))"),
    ("bool_tainted", "ok = torch.all(t)\n    return bool(ok)"),
]


@pytest.mark.parametrize("name,body", SYNC_FORMS,
                         ids=[s[0] for s in SYNC_FORMS])
def test_device_sync_flags_torch_form(name, body):
    code = ("import numpy as np\nimport torch\n\n\n"
            f"def readback(t, event):\n    {body}\n")
    rep = port.analyze_source(code, path=_PORT_SERVER)
    hits = flagged(rep, "device-sync")
    assert len(hits) == 1, hits
    assert hits[0][0] == 5 + len(body.splitlines())  # the body's last line


def test_device_sync_module_scope_flagged():
    rep = port.analyze_source(src("""
        import torch

        TABLE = torch.arange(8).tolist()
    """), path=_PORT_SERVER)
    hits = [f for f in rep.unsuppressed if f.rule == "device-sync"]
    assert len(hits) == 1 and "module scope" in hits[0].message


def test_device_sync_passing_forms():
    rep = port.analyze_source(src("""
        import numpy as np
        import torch

        def stay(t, rows, dev, n):
            host = np.asarray(rows)
            moved = t.to(dev)
            scale = float(n)
            return host, moved, scale, t.sum(dim=0)
    """), path=_PORT_SERVER)
    assert not flagged(rep, "device-sync")


@pytest.mark.parametrize("path", ["indy_plenum_tpu_torch/tpu/vote_plane.py",
                                  "indy_plenum_tpu_torch/tpu/quorum.py"])
def test_device_sync_sanctioned_modules_exempt(path):
    rep = port.analyze_source(src("""
        import torch

        def absorb(t, event):
            event.synchronize()
            return t.cpu().numpy(), t.tolist(), t.item()
    """), path=path)
    assert not [f for f in rep.findings if f.rule == "device-sync"]


def test_device_sync_out_of_scope_module_exempt():
    rep = port.analyze_source(src("""
        import numpy as np

        def pack(rows):
            return np.asarray(rows).tolist()
    """), path="indy_plenum_tpu_torch/ledger/fake.py")
    assert not [f for f in rep.findings if f.rule == "device-sync"]


@pytest.mark.parametrize("path,imports", [
    ("indy_plenum_tpu_torch/tpu/staging.py", "from . import ed25519 as ted"),
    ("indy_plenum_tpu_torch/server/fake_authn.py",
     "from ..tpu import ed25519 as ted"),
])
def test_device_sync_scope_without_torch_import(path, imports):
    """A tpu/ sibling, or a module that imports a tpu kernel wrapper,
    gets device tensors back without importing torch itself."""
    rep = port.analyze_source(src(f"""
        import numpy as np
        {imports}

        def readback(batch):
            return ted.verify_kernel_full(batch).cpu().numpy()
    """), path=path)
    assert len(flagged(rep, "device-sync")) == 2


def test_device_sync_pragma_suppresses():
    rep = port.analyze_source(src("""
        import torch

        def verdicts(ok):
            # da: allow[device-sync] -- auth verdicts MUST resolve before admission decides this batch
            return ok.cpu().numpy()
    """), path=_PORT_SERVER)
    hits = [f for f in rep.findings if f.rule == "device-sync"]
    assert len(hits) == 2 and all(f.suppressed == "pragma" for f in hits)


# --- buffer-donation, retargeted at torch -----------------------------------

_PORT_HOT = "indy_plenum_tpu_torch/tpu/fake_plane.py"

DONATION_FLAGGED = [
    ("from_numpy_self_attr", src("""
        import torch

        def stage(self):
            return torch.from_numpy(self.buf)
    """)),
    ("as_tensor_self_attr_row", src("""
        import torch

        def stage(self):
            return torch.as_tensor(self._bufs[64])
    """)),
    ("from_numpy_local_alias", src("""
        import torch

        def stage(self):
            buf = self._bufs[64]
            buf[:] = 0
            return torch.from_numpy(buf)
    """)),
    ("copy_from_pinned_unguarded", src("""
        import torch

        def stage(self, rows):
            self._view[:] = rows
            self._dev.copy_(self._host, non_blocking=True)
            return self._dev
    """)),
    ("to_from_pinned_unguarded", src("""
        import torch

        def stage(self, dev):
            host = self._host[3]
            return host.to(dev, non_blocking=True)
    """)),
    ("trace_record_is_not_an_event", src("""
        import torch

        def stage(self):
            self._dev.copy_(self._host, non_blocking=True)
            self.trace.record("stage", args={"n": 1})
    """)),
]

DONATION_CLEAN = [
    ("fresh_per_call_array", src("""
        import numpy as np
        import torch

        def stage(self, words):
            fresh = np.zeros((4, 64), np.uint32)
            return torch.from_numpy(fresh), torch.as_tensor(words_row(words))
    """)),
    ("forced_copy", src("""
        import torch

        def stage(self):
            return torch.tensor(self.buf), torch.from_numpy(self.buf.copy())
    """)),
    ("clone_first", src("""
        import torch

        def stage(self, dev):
            return self._host.clone().to(dev, non_blocking=True)
    """)),
    ("blocking_copy", src("""
        import torch

        def stage(self):
            self._dev.copy_(self._host)
    """)),
    ("ring_behind_its_event", src("""
        import torch

        def stage(self, pos, rows):
            if self._copied[pos] is not None:
                self._copied[pos].synchronize()
            self._view[pos] = rows
            self._dev[pos].copy_(self._host[pos], non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
            self._copied[pos] = event
    """)),
    ("device_to_pinned_host", src("""
        import torch

        def fetch(self, out):
            self.host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
    """)),
]


@pytest.mark.parametrize("name,code", DONATION_FLAGGED,
                         ids=[d[0] for d in DONATION_FLAGGED])
def test_buffer_donation_flags(name, code):
    rep = port.analyze_source(code, path=_PORT_HOT)
    assert len(flagged(rep, "buffer-donation")) == 1


@pytest.mark.parametrize("name,code", DONATION_CLEAN,
                         ids=[d[0] for d in DONATION_CLEAN])
def test_buffer_donation_passes(name, code):
    rep = port.analyze_source(code, path=_PORT_HOT)
    assert not [f for f in rep.findings if f.rule == "buffer-donation"]


def test_buffer_donation_needs_torch():
    rep = port.analyze_source(src("""
        import numpy as np

        def stage(self):
            return np.asarray(self.buf)
    """), path=_PORT_HOT)
    assert not [f for f in rep.findings if f.rule == "buffer-donation"]


def test_staging_ring_passes_behind_its_event():
    """The vote plane's pinned staging (``_Staging``, ``_Ring``) copies
    ``non_blocking`` from persistent host rows and passes the rule on
    the event it records behind each copy: with the event taken out of
    the source, the same rows are flagged."""
    path = os.path.join(PKG, "tpu", "vote_plane.py")
    with open(path) as fh:
        source = fh.read()
    rel = "indy_plenum_tpu_torch/tpu/vote_plane.py"
    assert source.count("non_blocking=True)") >= 2
    assert not [f for f in port.analyze_source(source, path=rel).findings
                if f.rule == "buffer-donation"]
    stripped = source.replace(".record(", ".noted(").replace(
        ".synchronize()", ".noted()")
    hits = [f for f in port.analyze_source(stripped, path=rel).findings
            if f.rule == "buffer-donation"]
    assert len(hits) == 2


# --- the port package under its own analyzer --------------------------------


@pytest.fixture(scope="module")
def package_reports():
    """Two analyses of the port package with the shipped rules and
    baseline; the first one's config-knob rule keeps its registry."""
    rules = port.make_rules()
    first = port.Analyzer(rules).analyze_paths(
        [PKG], baseline_keys=port.load_baseline(port.DEFAULT_BASELINE))
    knobs = next(r for r in rules if isinstance(r, ConfigKnobRule))
    return first, port.analyze_paths([PKG]), knobs


def test_package_is_clean(package_reports):
    report = package_reports[0]
    pretty = "\n".join(f.render() for f in report.unsuppressed)
    assert not report.unsuppressed, f"new static findings:\n{pretty}"
    assert report.files_analyzed > 150


def test_findings_hash_byte_identical_across_runs(package_reports):
    r1, r2, _ = package_reports
    assert r1.findings_hash == r2.findings_hash
    assert [f.to_dict() for f in r1.findings] \
        == [f.to_dict() for f in r2.findings]


def test_every_pragma_has_a_reason(package_reports):
    suppressed = [f for f in package_reports[0].findings if f.suppressed]
    assert suppressed
    for f in suppressed:
        assert f.suppressed == "pragma" and f.reason, f


def test_triaged_syncs_carry_the_reference_reasons(package_reports):
    reasons = {(f.path, f.rule): f.reason for f in package_reports[0].findings
               if f.suppressed}
    authn = reasons[("indy_plenum_tpu_torch/server/client_authn.py",
                     "device-sync")]
    assert authn.startswith("auth verdicts MUST resolve before admission")
    verify = reasons[("indy_plenum_tpu_torch/tpu/ed25519.py", "device-sync")]
    assert "verify_batch is the kernel's OWN blocking entry point" in verify
    for tool in ("kernel_ab.py", "smoke_clock.py", "sha256_fixed_probe.py"):
        assert "measuring tool" in reasons[(
            f"indy_plenum_tpu_torch/utils/{tool}", "device-sync")]


def test_knobs_of_unported_readers_name_them(package_reports):
    """The nine knobs whose readers were still to port carried a pragma
    naming them; the readers are ported now (``tools/local_pool.py``,
    ``tools/start_node.py``), so the knobs carry no pragma and the rule
    finds each one read there."""
    rule = package_reports[2]
    for knob in ("OUTGOING_BATCH_SIZE", "MSG_LEN_LIMIT", "KVStorageType",
                 "METRICS_COLLECTOR_TYPE"):
        assert rule.knob_defs[knob].pragma_reason == ""
        assert any(p.endswith("tools/local_pool.py")
                   for p in rule.registry[knob]), rule.registry[knob]
    for knob in ("logLevel", "logRotationMaxBytes", "logRotationBackupCount",
                 "logRotationWhen", "logRotationInterval"):
        assert rule.knob_defs[knob].pragma_reason == ""
        assert any(p.endswith("tools/start_node.py")
                   for p in rule.registry[knob]), rule.registry[knob]
    assert not [k for k in rule.knob_defs.values() if "waits for"
                in k.pragma_reason]


def test_shipped_baseline_is_empty():
    assert port.load_baseline(port.DEFAULT_BASELINE) == set()
    with open(port.DEFAULT_BASELINE) as fh:
        assert json.load(fh) == {"findings": []}


def test_baseline_round_trip(tmp_path):
    mod = tmp_path / "pkg" / "mod.py"
    mod.parent.mkdir()
    mod.write_text("import time\n\n"
                   "def f():\n    return time.time()\n")
    first = port.analyze_paths([str(mod.parent)])
    assert len(first.unsuppressed) == 1
    bl = tmp_path / "baseline.json"
    port.write_baseline(str(bl),
                        [f.baseline_key() for f in first.unsuppressed])
    second = port.analyze_paths([str(mod.parent)], baseline_path=str(bl))
    assert not second.unsuppressed
    assert second.findings[0].suppressed == "baseline"


def test_single_file_anchors_at_package_root():
    """A one-file run names the module as the package walk does, so the
    path-scoped rules and their pragmas apply the same."""
    rel = "indy_plenum_tpu_torch/server/client_authn.py"
    report = port.analyze_paths([os.path.join(REPO, rel)])
    assert report.findings and not report.unsuppressed
    assert {f.path for f in report.findings} == {rel}


def test_rule_catalog_matches_reference():
    assert port.ALL_RULES == ref.ALL_RULES


# --- the CLI ----------------------------------------------------------------


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "indy_plenum_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, timeout=120)


def test_cli_lints_the_port_by_default():
    proc = _run_cli("--json")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr
    data = json.loads(proc.stdout)
    assert data["unsuppressed"] == 0 and data["files_analyzed"] > 150
    assert all(f["path"].startswith("indy_plenum_tpu_torch/")
               for f in data["findings"])


def test_cli_missing_path_fails_closed():
    proc = _run_cli("no/such/package")
    assert proc.returncode != 0
    assert "does not exist" in proc.stderr + proc.stdout


def test_cli_exit_1_on_finding_and_write_baseline(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text("import torch\n\n"
                   "def f(t):\n    return t.item()\n")
    proc = _run_cli(str(bad))
    assert proc.returncode == 1 and "device-sync" in proc.stdout
    bl = tmp_path / "bl.json"
    proc = _run_cli(str(bad), "--write-baseline", str(bl))
    assert proc.returncode == 0 and bl.exists()
    proc = _run_cli(str(bad), "--baseline", str(bl), "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_list_rules_and_rule_filter():
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    for name in SHARED + ("device-sync", "buffer-donation"):
        assert name in proc.stdout
    proc = _run_cli(PKG, "--rule", "nondet-source", "--json")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr
