"""Rules: device-sync discipline & staging-buffer aliasing.

Copy of ``indy_plenum_tpu/analysis/rules_device.py``, retargeted at the
port's PyTorch idioms. The rule names stay, so a pragma reads the same in
both packages.

``device-sync`` — the ordering fast path and the pipelined readbacks
exist so the device→host round-trip overlaps a tick of host work. ONE
stray synchronizing call — ``.item()``, ``.tolist()``, ``.cpu()`` or
``.numpy()`` on a device tensor, ``.to("cpu")``, ``torch.cuda
.synchronize()`` or an event's / stream's ``.synchronize()``,
``np.asarray`` over a tensor, or an implicit ``float()``/``int()``/
``bool()`` coercion of a tensor value — re-serializes the pipeline and
silently defeats the contract. Host↔device traffic is sanctioned only
inside the readback modules (``tpu/vote_plane.py``, ``tpu/quorum.py``);
every other module that imports torch or a tpu kernel wrapper (and
every module under ``tpu/``) must either stay on-device or carry a
pragma naming why its sync is deliberate (e.g. the auth batch must
resolve before admission decides).

``buffer-donation`` — the staging-buffer corruption hazard: a reusable
staging buffer (an attribute that outlives the call) handed to the
device without a copy aliases live in-flight dispatch memory — the next
host write corrupts a vote word mid-flight. In PyTorch it takes two
forms: ``torch.from_numpy`` / ``torch.as_tensor`` over a persistent
numpy buffer SHARES its memory; and a ``non_blocking=True`` copy
(``dst.copy_(src, non_blocking=True)`` or ``src.to(dev,
non_blocking=True)``) from a persistent pinned host tensor returns
before the copy lands, so a host rewrite before it completes races the
DMA. Reused buffers must cross with a forced copy (``torch.tensor``, a
``.clone()`` first), or — for the pinned non-blocking copy — be
rewritten only behind a CUDA event the function records or waits on
(the vote plane's staging ring: a row is rewritten only after the event
behind its last copy has completed). Only FRESH per-call buffers may
take the zero-copy path.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from .core import (
    Finding,
    ModuleInfo,
    Rule,
    iter_scope,
    resolve_call_name,
)

__all__ = ["DeviceSyncRule", "BufferDonationRule"]

# tensor methods whose result lives on the host: each waits for the
# producing kernel (and, for a CUDA tensor, copies device -> host)
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_COERCIONS = ("float", "int", "bool")


def _touches_torch(expr: ast.AST, imports) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name):
            canon = imports.get(sub.id, "")
            if canon == "torch" or canon.startswith("torch."):
                return True
    return False


def _torch_tainted_names(fn, imports) -> Set[str]:
    """Names assigned from expressions that touch torch — one-hop
    intra-function taint, enough for the float()/int() coercion check."""
    tainted: Set[str] = set()
    for node in iter_scope(fn):
        if not isinstance(node, ast.Assign):
            continue
        if _touches_torch(node.value, imports):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    tainted.add(tgt.id)
    return tainted


def _is_cpu_target(node: ast.AST, imports) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    if isinstance(node, ast.Call) and node.args \
            and resolve_call_name(node.func, imports) == "torch.device":
        return _is_cpu_target(node.args[0], imports)
    return False


class DeviceSyncRule(Rule):
    name = "device-sync"
    summary = ("host<->device synchronization outside the sanctioned "
               "readback modules (defeats pipelined readbacks)")

    # the two modules whose JOB is the device->host boundary
    ALLOWLIST = (
        "indy_plenum_tpu_torch/tpu/vote_plane.py",
        "indy_plenum_tpu_torch/tpu/quorum.py",
    )

    def check_module(self, module: ModuleInfo) -> List[Finding]:
        if module.path in self.ALLOWLIST:
            return []
        if not self._in_scope(module):
            return []
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            tainted = _torch_tainted_names(fn, module.imports)
            for node in iter_scope(fn):
                if not isinstance(node, ast.Call):
                    continue
                msg = self._classify(node, module, tainted)
                if msg is not None:
                    findings.append(Finding(
                        rule=self.name, path=module.path,
                        line=node.lineno, col=node.col_offset,
                        message=msg + " — a sync outside vote_plane/"
                                "quorum stalls the pipelined-readback "
                                "contract; move it behind the compact "
                                "readback or pragma why this boundary "
                                "crossing is deliberate"))
        # module-level code (import-time table building etc.) is checked
        # too: walk calls not inside any function
        fn_calls = {id(n) for f in ast.walk(module.tree)
                    if isinstance(f, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                    for n in ast.walk(f) if isinstance(n, ast.Call)}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and id(node) not in fn_calls:
                msg = self._classify(node, module, set())
                if msg is not None:
                    findings.append(Finding(
                        rule=self.name, path=module.path,
                        line=node.lineno, col=node.col_offset,
                        message=msg + " at module scope — import-time "
                                "host<->device traffic; pragma if this "
                                "is deliberate table building"))
        return findings

    @staticmethod
    def _in_scope(module: ModuleInfo) -> bool:
        """Modules importing torch directly, any tpu kernel wrapper
        (``from ..tpu import ed25519`` hands back device tensors too),
        or living under tpu/ themselves (siblings get kernels via bare
        ``from . import ...`` imports)."""
        if module.path.startswith("indy_plenum_tpu_torch/tpu/"):
            return True
        if module.imports_module("torch"):
            return True
        for canon in module.imports.values():
            if canon.startswith("tpu.") or ".tpu." in canon \
                    or canon.endswith(".tpu"):
                return True
        return False

    @staticmethod
    def _classify(node: ast.Call, module: ModuleInfo,
                  tainted: Set[str]) -> Optional[str]:
        imports = module.imports
        canon = resolve_call_name(node.func, imports)
        if canon == "torch.cuda.synchronize":
            return "torch.cuda.synchronize() blocks on every stream"
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _SYNC_METHODS and not node.args:
                return (f".{attr}() waits for the tensor's producer and "
                        "copies it to host memory")
            if attr == "synchronize":
                return ".synchronize() blocks on an event or a stream"
            if attr == "to":
                targets = list(node.args[:1]) + [
                    kw.value for kw in node.keywords
                    if kw.arg == "device"]
                if any(_is_cpu_target(t, imports) for t in targets):
                    return ".to('cpu') copies the tensor to host memory"
        if canon in ("numpy.asarray", "numpy.array") and node.args:
            arg = node.args[0]
            if any(isinstance(sub, ast.Name) and sub.id in tainted
                   for sub in ast.walk(arg)) \
                    or _touches_torch(arg, imports):
                return (f"np.{canon.split('.')[1]}() over a tensor pulls "
                        "it to host memory")
        if isinstance(node.func, ast.Name) \
                and node.func.id in _COERCIONS and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Name) and arg.id in tainted:
                return (f"{node.func.id}('{arg.id}') implicitly syncs a "
                        "tensor value to host")
            if _touches_torch(arg, imports):
                return (f"{node.func.id}(...) over a torch expression "
                        "implicitly syncs to host")
        return None


def _is_self_attr_load(node: ast.AST) -> bool:
    while isinstance(node, ast.Subscript):
        node = node.value
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _is_reused_buffer(arg: ast.AST, attr_aliases: Set[str]) -> bool:
    node = arg
    while isinstance(node, ast.Subscript):
        node = node.value
    if _is_self_attr_load(node):
        return True
    return isinstance(node, ast.Name) and node.id in attr_aliases


def _is_non_blocking(node: ast.Call) -> bool:
    return any(kw.arg == "non_blocking"
               and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in node.keywords)


def _event_names(fn, imports) -> Set[str]:
    """Names bound from ``torch.cuda.Event(...)`` in this function."""
    names: Set[str] = set()
    for node in iter_scope(fn):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call) \
                and resolve_call_name(node.value.func, imports) \
                == "torch.cuda.Event":
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    names.add(tgt.id)
    return names


def _guards_with_event(fn, imports) -> bool:
    """Does this function record or wait on a CUDA event (or block on a
    stream)? Then a rewrite of its staging rows waits for the copy."""
    events = _event_names(fn, imports)
    for node in iter_scope(fn):
        if not isinstance(node, ast.Call):
            continue
        if resolve_call_name(node.func, imports) == "torch.cuda.synchronize":
            return True
        if not isinstance(node.func, ast.Attribute):
            continue
        attr = node.func.attr
        if attr in ("synchronize", "wait_event", "wait_stream",
                    "record_event"):
            return True
        if attr in ("record", "wait", "query"):
            recv = node.func.value
            while isinstance(recv, ast.Subscript):
                recv = recv.value
            term = (recv.attr if isinstance(recv, ast.Attribute)
                    else recv.id if isinstance(recv, ast.Name) else "")
            if term in events or "event" in term.lower():
                return True
    return False


class BufferDonationRule(Rule):
    name = "buffer-donation"
    summary = ("torch.from_numpy / torch.as_tensor over a reusable "
               "staging buffer, or an unguarded non_blocking copy from "
               "one (shared memory: reused buffers need a forced copy or "
               "a CUDA event)")

    def check_module(self, module: ModuleInfo) -> List[Finding]:
        if not module.imports_module("torch"):
            return []
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # names bound from self-attributes in this function: a
            # local alias of a persistent buffer is still the buffer
            attr_aliases: Set[str] = set()
            for node in iter_scope(fn):
                if isinstance(node, ast.Assign) \
                        and _is_self_attr_load(node.value):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            attr_aliases.add(tgt.id)
            guarded = None  # computed on the first non_blocking copy
            for node in iter_scope(fn):
                if not isinstance(node, ast.Call):
                    continue
                canon = resolve_call_name(node.func, module.imports)
                if canon in ("torch.from_numpy", "torch.as_tensor") \
                        and node.args \
                        and _is_reused_buffer(node.args[0], attr_aliases):
                    findings.append(Finding(
                        rule=self.name, path=module.path,
                        line=node.lineno, col=node.col_offset,
                        message=f"{canon}(...) over a persistent buffer "
                                "shares its memory, so the reused buffer "
                                "aliases in-flight dispatch data — use "
                                "torch.tensor(...) (forced copy) or "
                                ".copy() first for buffers that outlive "
                                "the call"))
                    continue
                if not (isinstance(node.func, ast.Attribute)
                        and _is_non_blocking(node)):
                    continue
                if node.func.attr == "copy_" and node.args:
                    src = node.args[0]
                elif node.func.attr == "to":
                    src = node.func.value
                else:
                    continue
                if not _is_reused_buffer(src, attr_aliases):
                    continue
                if guarded is None:
                    guarded = _guards_with_event(fn, module.imports)
                if not guarded:
                    findings.append(Finding(
                        rule=self.name, path=module.path,
                        line=node.lineno, col=node.col_offset,
                        message=f".{node.func.attr}(..., non_blocking="
                                "True) from a persistent host buffer in "
                                "a function that neither records nor "
                                "waits on a CUDA event — the next host "
                                "write can land before the copy does; "
                                "record an event behind the copy and "
                                "wait on it before rewriting, or copy "
                                "from a fresh tensor"))
        return findings
