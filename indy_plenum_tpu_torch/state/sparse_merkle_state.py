"""Authenticated key/value state as a binary sparse Merkle tree (SMT).

Replaces the reference's Merkle Patricia Trie (state/trie/pruning_trie.py)
with a TPU-friendly fixed-depth structure:

- path = sha256(key): 256 bits, one tree level per bit;
- empty subtrees use precomputed per-level default hashes and are never
  stored, so storage is O(written keys * 256) content-addressed nodes;
- nodes are content-addressed (hash -> (left, right) / leaf payload) in a
  KeyValueStorage, which makes every historical root remain readable —
  committed vs uncommitted heads are just two root pointers, and
  ``revert_to_head`` is a pointer assignment (the reference's
  revertToHead walks and prunes; here old roots are free);
- a state proof for a key is the 256 sibling hashes, compressed with a
  bitmap marking defaults (typically ~10 non-default siblings), and
  verification is a fixed 256-step hash fold — batchable on device.

Leaf hash = H(0x00 || path || value); node hash = H(0x01 || l || r);
default leaf = H(b"") per level 256, defaults[l] = H(0x01||d||d) upward.

Batched state commit (the O(delta) plane): :meth:`SparseMerkleState
.apply_batch` applies a whole write set in ONE bottom-up tree walk —
last-write-wins dedupe per key, entries sorted by path bits, the touched
subtree rebuilt level by level so each distinct internal node on any
updated path is hashed exactly once per batch (a Jellyfish-style batched
version commit; the sequential ``set()`` loop pays ``writes x 256``
hashes instead). The wide per-level hash waves go to the device SHA-256
kernel together, as one commit plan
(:func:`indy_plenum_tpu_torch.tpu.sha256.merkle_plan_hash`), under the same
MEASURED host-vs-device offload policy as catchup proof verification
(``DEVICE_MIN_BATCH`` / ``_AdaptiveOffload`` in
``server/catchup/catchup_rep_service.py``) — the policy decides the
placement, the resulting root is bit-identical either way.
:meth:`begin_batch` / :meth:`flush_batch` expose the same walk as a
write-buffering overlay for ``WriteRequestManager.apply_batch`` (reads
at ``is_committed=False`` see the pending writes, so dynamic validation
inside a 3PC batch observes earlier requests in the same batch exactly
as it would under sequential application).

Copy of ``indy_plenum_tpu/state/sparse_merkle_state.py``, with its
imports bound to the port. The device waves of a commit run as ONE K11
commit plan (``tpu/sha256.py`` ``merkle_plan_hash_bytes``: one upload, one
launch over every level, one readback) on the state's ``device``: the CUDA
card unless the caller passes ``device="cpu"`` (the kernel's plain
version). A failed launch raises; nothing falls back to the host
quietly. State proofs (``generate_state_proof`` and the client-side
``verify_state_proof``) are host work, in the wire format of the
reference (the port's own msgpack encoder and decoder, byte-equal to
``msgpack``); the resource-ledger registration (``sized_resources``)
comes with the telemetry slice.
"""
from __future__ import annotations

import hashlib
from array import array
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

from ..common.serializers.serialization import packb, unpackb
from ..storage.kv_store import KeyValueStorage, KeyValueStorageInMemory
from ..utils.torch_env import DeviceLike, resolve_device
from .state import State

DEPTH = 256
_LEAF_PREFIX = b"\x00"
_NODE_PREFIX = b"\x01"

# defaults mirrored from the config knobs (StateNodeCacheSize /
# StateCommitBatch*) so a bare SparseMerkleState() behaves like a
# config-built one; LedgersBootstrap threads the live knob values in
DEFAULT_NODE_CACHE_SIZE = 65536
DEFAULT_COMMIT_BATCH_MIN = 4
DEFAULT_COMMIT_MODE = "auto"

# the state plane keeps its OWN adaptive offload policy instance: the
# catchup plane's EMAs are nanoseconds per PROOF (~a 48-level fold per
# sample) while these are nanoseconds per single node hash — sharing one
# EMA pair would compare incommensurable units. The class (and the
# DEVICE_MIN_BATCH floor) is the catchup plane's, so the selection LAW
# is identical; only the measurements are local.
_WAVE_OFFLOAD = None


def _wave_offload_policy():
    global _WAVE_OFFLOAD
    if _WAVE_OFFLOAD is None:
        from ..server.catchup.catchup_rep_service import _AdaptiveOffload

        _WAVE_OFFLOAD = _AdaptiveOffload()
    return _WAVE_OFFLOAD


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _defaults() -> List[bytes]:
    """defaults[level] = hash of an empty subtree whose root is at level.

    level DEPTH = leaves; level 0 = tree root.
    """
    out = [b""] * (DEPTH + 1)
    out[DEPTH] = _h(b"")
    for level in range(DEPTH - 1, -1, -1):
        out[level] = _h(_NODE_PREFIX + out[level + 1] + out[level + 1])
    return out


DEFAULTS = _defaults()
EMPTY_ROOT = DEFAULTS[0]


def _path_bits(key: bytes) -> List[int]:
    digest = _h(key)
    return [(digest[i // 8] >> (7 - i % 8)) & 1 for i in range(DEPTH)]


def _bit(digest: bytes, level: int) -> int:
    return (digest[level >> 3] >> (7 - (level & 7))) & 1


class _PlanNode:
    """One touched internal node of a batched update, awaiting its wave
    hash. ``left``/``right`` are either concrete 32-byte hashes
    (untouched subtrees, defaults, leaf hashes) or child plan nodes."""

    __slots__ = ("left", "right", "hash", "index")

    def __init__(self, left, right):
        self.left = left
        self.right = right
        self.hash = None
        self.index = -1  # position in a device commit plan


def _plan_encode(waves: List[List[_PlanNode]], run: List[int]):
    """The levels ``run`` (bottom up, each level's nodes in wave order) as
    a K11 commit plan, in one walk over the nodes: each node gets its plan
    index; each operand becomes an int32 reference, the child's index for
    a planned child, else ``-(1 + i)`` into the deduplicated literals
    (siblings, defaults, leaf hashes). Returns refs (n, 2) int32, the
    literals (L, 32) uint8 and the n_levels + 1 level offsets."""
    import numpy as np

    refs = array("i")
    append = refs.append
    lits: List[bytes] = []
    lit_index: Dict[bytes, int] = {}
    offsets = [0]
    n = 0
    for level in run:
        for pn in waves[level]:
            pn.index = n
            n += 1
            # unrolled over the two operands: this loop is the commit's
            # per-node host cost on the device path
            left, right = pn.left, pn.right
            if left.__class__ is _PlanNode:
                append(left.index)
            else:
                j = lit_index.get(left)
                if j is None:
                    j = lit_index[left] = len(lits)
                    lits.append(left)
                append(~j)
            if right.__class__ is _PlanNode:
                append(right.index)
            else:
                j = lit_index.get(right)
                if j is None:
                    j = lit_index[right] = len(lits)
                    lits.append(right)
                append(~j)
        offsets.append(n)
    return (np.frombuffer(refs, np.int32).reshape(-1, 2),
            np.frombuffer(b"".join(lits), np.uint8).reshape(-1, 32),
            offsets)


class SparseMerkleState(State):
    def __init__(self, kv: Optional[KeyValueStorage] = None,
                 initial_root: Optional[bytes] = None,
                 node_cache_size: int = DEFAULT_NODE_CACHE_SIZE,
                 commit_batch_enabled: bool = True,
                 commit_batch_min: int = DEFAULT_COMMIT_BATCH_MIN,
                 commit_mode: str = DEFAULT_COMMIT_MODE,
                 device: DeviceLike = None):
        if commit_mode not in ("host", "device", "auto"):
            raise ValueError(f"unknown commit_mode {commit_mode!r}")
        # where the device waves run: the card unless device="cpu"
        self.device = resolve_device(device)
        self._kv = kv if kv is not None else KeyValueStorageInMemory()
        # write-buffer: uncommitted nodes stay in memory; commit() flushes
        # them to the KV backend in one atomic batch (a crash between
        # batches loses only uncommitted state, as with the reference)
        self._dirty: dict[bytes, bytes] = {}
        # bounded LRU fronting the KV store: content-addressed nodes are
        # immutable, so entries never invalidate — hot-key paths stop
        # re-fetching ~256 nodes per touch (StateNodeCacheSize knob;
        # 0 disables)
        self._cache: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._cache_size = int(node_cache_size)
        # batch overlay (begin_batch/flush_batch): key -> value-or-None
        # in insertion order; None = no batch open
        self._pending: Optional[Dict[bytes, Optional[bytes]]] = None
        self._commit_batch_enabled = bool(commit_batch_enabled)
        self._commit_batch_min = int(commit_batch_min)
        self.commit_mode = commit_mode
        # meters (deterministic: wave sizes are a pure function of the
        # write set, independent of host/device placement)
        self.hashes_total = 0       # tree hashes: leaves + internal nodes
        self.batches_applied = 0
        self.batch_writes_total = 0  # writes buffered into batches
        self.batch_keys_total = 0    # distinct keys after dedupe
        self.cache_hits = 0
        self.cache_misses = 0
        # placement meters (NOT deterministic across modes — report-only)
        self.wave_host_hashes = 0
        self.wave_device_hashes = 0
        root = initial_root or self._load_root() or EMPTY_ROOT
        self._committed_root = root
        self._root = root

    # --- persistence of the committed head pointer ---------------------

    _ROOT_KEY = b"\xffROOT"

    def _load_root(self) -> Optional[bytes]:
        try:
            return self._kv.get(self._ROOT_KEY)
        except KeyError:
            return None

    def _store_root(self) -> None:
        self._kv.put(self._ROOT_KEY, self._committed_root)

    # --- node store ----------------------------------------------------

    def _put_node(self, data: bytes) -> bytes:
        h = _h(data)
        self._dirty[b"n" + h] = data
        return h

    def _get_node(self, h: bytes) -> bytes:
        key = b"n" + h
        node = self._dirty.get(key)
        if node is not None:
            return node
        cache = self._cache
        node = cache.get(key)
        if node is not None:
            self.cache_hits += 1
            cache.move_to_end(key)
            return node
        self.cache_misses += 1
        node = self._kv.get(key)
        if self._cache_size > 0:
            cache[key] = node
            if len(cache) > self._cache_size:
                cache.popitem(last=False)
        return node

    @property
    def node_cache_len(self) -> int:
        return len(self._cache)

    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    # --- core update ---------------------------------------------------

    def _update(self, root: bytes, key: bytes,
                value: Optional[bytes]) -> bytes:
        bits = _path_bits(key)
        path_digest = _h(key)
        # walk down, recording siblings
        siblings: List[bytes] = []
        node = root
        for level in range(DEPTH):
            if node == DEFAULTS[level]:
                siblings.extend(DEFAULTS[l + 1] for l in range(level, DEPTH))
                node = DEFAULTS[DEPTH]
                break
            raw = self._get_node(node)
            left, right = raw[1:33], raw[33:65]
            if bits[level] == 0:
                siblings.append(right)
                node = left
            else:
                siblings.append(left)
                node = right
        # new leaf
        if value is None:
            new = DEFAULTS[DEPTH]
        else:
            leaf_data = _LEAF_PREFIX + path_digest + value
            new = self._put_node(leaf_data)
            self.hashes_total += 1
        # walk back up
        for level in range(DEPTH - 1, -1, -1):
            sibling = siblings[level]
            if bits[level] == 0:
                data = _NODE_PREFIX + new + sibling
            else:
                data = _NODE_PREFIX + sibling + new
            new = _h(data)
            if new != DEFAULTS[level]:
                self._dirty[b"n" + new] = data
        self.hashes_total += DEPTH
        return new

    def _lookup(self, root: bytes, key: bytes) -> Optional[bytes]:
        bits = _path_bits(key)
        path_digest = _h(key)
        node = root
        for level in range(DEPTH):
            if node == DEFAULTS[level]:
                return None
            raw = self._get_node(node)
            left, right = raw[1:33], raw[33:65]
            node = left if bits[level] == 0 else right
        if node == DEFAULTS[DEPTH]:
            return None
        raw = self._get_node(node)
        assert raw[:1] == _LEAF_PREFIX and raw[1:33] == path_digest
        return raw[33:]

    # --- batched update (one tree walk per write set) -------------------

    def apply_batch(self, items: Iterable[Tuple[bytes, Optional[bytes]]]
                    ) -> bytes:
        """Apply many ``(key, value-or-None)`` writes in ONE bottom-up
        tree walk; returns (and installs) the new working root.

        Last-write-wins dedupe per key first — sequentially applying the
        same sequence ends at the tree holding each key's final value,
        so the batched root is bit-identical to the ``set()``/
        ``remove()`` loop (asserted by the ``state_gate`` and the
        property tests). Entries are then sorted by path digest (= path
        bit order) and the touched subtree is rebuilt bottom-up: each
        distinct internal node on any updated path is hashed exactly
        once, collected into per-level waves and resolved by
        :meth:`_resolve_waves` (host SHA, or one device commit plan under
        the measured offload policy — identical digests either way).
        """
        final: Dict[bytes, Optional[bytes]] = {}
        n_writes = 0
        for key, value in items:
            n_writes += 1
            final[key] = value
        if not final:
            return self._root
        self.batches_applied += 1
        self.batch_writes_total += n_writes
        self.batch_keys_total += len(final)
        if len(final) < self._commit_batch_min:
            # tiny deltas: the plan/wave machinery costs more than it
            # saves (prefix sharing needs siblings to share with)
            for key, value in final.items():
                self._root = self._update(self._root, key, value)
            return self._root
        entries: List[Tuple[bytes, bytes]] = []
        for key, value in final.items():
            digest = _h(key)
            if value is None:
                leaf = DEFAULTS[DEPTH]
            else:
                leaf = self._put_node(_LEAF_PREFIX + digest + value)
                self.hashes_total += 1
            entries.append((digest, leaf))
        entries.sort()
        waves: List[List[_PlanNode]] = [[] for _ in range(DEPTH)]
        root = self._build(self._root, 0, entries, 0, len(entries), waves)
        if isinstance(root, _PlanNode):
            self._resolve_waves(waves)
            root = root.hash
        self._root = root
        return root

    def _build(self, node: bytes, level: int,
               entries: List[Tuple[bytes, bytes]], lo: int, hi: int,
               waves: List[List[_PlanNode]]):
        """Plan the rebuild of the subtree rooted at ``node`` (level
        ``level``) under ``entries[lo:hi]``; returns a concrete hash
        (untouched / unchanged) or a :class:`_PlanNode`."""
        if hi == lo:
            return node
        if level == DEPTH:
            # one leaf slot; dedupe guarantees a single entry
            return entries[hi - 1][1]
        if hi - lo == 1 and node == DEFAULTS[level]:
            # empty subtree, one entry: the whole descending chain has
            # default siblings — build it iteratively (this is ~all of
            # the nodes in a populate-from-empty batch)
            digest, leaf = entries[lo]
            if leaf == DEFAULTS[DEPTH]:
                return node  # removing from an empty subtree: no-op
            cur = leaf
            for lvl in range(DEPTH - 1, level - 1, -1):
                d = DEFAULTS[lvl + 1]
                pn = _PlanNode(cur, d) if _bit(digest, lvl) == 0 \
                    else _PlanNode(d, cur)
                waves[lvl].append(pn)
                cur = pn
            return cur
        if node == DEFAULTS[level]:
            left = right = DEFAULTS[level + 1]
        else:
            raw = self._get_node(node)
            left, right = raw[1:33], raw[33:65]
        # entries are sorted by digest and share the first `level` bits:
        # binary-search the 0/1 boundary at this level's bit
        a, b = lo, hi
        while a < b:
            mid = (a + b) // 2
            if _bit(entries[mid][0], level):
                b = mid
            else:
                a = mid + 1
        new_left = self._build(left, level + 1, entries, lo, a, waves)
        new_right = self._build(right, level + 1, entries, a, hi, waves)
        if new_left is left and new_right is right:
            return node  # rewrites of identical values: subtree unchanged
        if not isinstance(new_left, _PlanNode) \
                and not isinstance(new_right, _PlanNode) \
                and new_left == left and new_right == right:
            return node
        pn = _PlanNode(new_left, new_right)
        waves[level].append(pn)
        return pn

    def _resolve_waves(self, waves: List[List[_PlanNode]]) -> None:
        """Hash the planned nodes bottom-up (children at level+1 are
        resolved before level runs).

        A level is never wider than the one below it (every touched
        node's parent is touched), so the levels of at least
        DEVICE_MIN_BATCH nodes are one run at the bottom of the plan. In
        'device' mode that run is ONE commit plan through K11
        (:meth:`_resolve_plan`); in 'auto' mode the measured policy is
        asked once per commit for the whole run, and its device time is
        noted per hash. The narrower levels above the run, and every
        level in 'host' mode, hash on the host, one wave per level (the
        run's levels too when 'auto' picks the host, noting the host
        time). Digests are bit-identical on either path - only
        nanoseconds move.
        """
        levels = [lv for lv in range(DEPTH - 1, -1, -1) if waves[lv]]
        run = 0
        policy = None
        if self.commit_mode != "host":
            from ..server.catchup.catchup_rep_service import (
                DEVICE_MIN_BATCH,
            )

            while run < len(levels) \
                    and len(waves[levels[run]]) >= DEVICE_MIN_BATCH:
                run += 1
            if run:
                policy = _wave_offload_policy()
                if self.commit_mode == "device" or policy.use_device():
                    self._resolve_plan(waves, levels[:run], policy)
                    levels, run = levels[run:], 0
        for i, level in enumerate(levels):
            self._resolve_level_host(waves[level], level,
                                     policy if i < run else None)

    def _resolve_level_host(self, wave: List[_PlanNode], level: int,
                            policy) -> None:
        """One level's wave through the host SHA loop; ``policy`` (None
        below the device floor) notes the host time per hash."""
        import time as _time

        pairs: List[Tuple[bytes, bytes]] = []
        for pn in wave:
            left, right = pn.left, pn.right
            if isinstance(left, _PlanNode):
                left = left.hash
            if isinstance(right, _PlanNode):
                right = right.hash
            pairs.append((left, right))
        # da: allow[nondet-source] -- perf_counter here (and below) feeds the offload policy's host EMA only: placement steering, never results/fingerprints
        t0 = _time.perf_counter()
        prefix = _NODE_PREFIX
        sha = hashlib.sha256
        digests = [sha(prefix + left + right).digest()
                   for left, right in pairs]
        if policy is not None:
            dt = _time.perf_counter() - t0  # da: allow[nondet-source] -- offload-policy host EMA close (see t0 above)
            policy.note_host(dt * 1e9 / len(pairs))
        self.wave_host_hashes += len(pairs)
        default = DEFAULTS[level]
        dirty = self._dirty
        for pn, (left, right), digest in zip(wave, pairs, digests):
            pn.hash = digest
            if digest != default:
                dirty[b"n" + digest] = _NODE_PREFIX + left + right
        self.hashes_total += len(wave)

    def _resolve_plan(self, waves: List[List[_PlanNode]], run: List[int],
                      policy) -> None:
        """The levels ``run`` (bottom up) as one commit plan on the
        state's device (:func:`_plan_encode`): one
        :func:`~indy_plenum_tpu_torch.tpu.sha256.merkle_plan_hash_bytes`
        call resolves them all (one upload, one K11 launch, one
        readback)."""
        import time as _time

        from ..tpu.sha256 import merkle_plan_hash_bytes

        if self.commit_mode == "auto" and policy.host_ns is None:
            # one-time calibration: the policy cannot compare modes until
            # it has a host sample (same idiom as catchup's proof verify;
            # the sampled digests are discarded - the plan below
            # recomputes them, keeping results placement-independent).
            # The bottom level's operands are all concrete hashes.
            sample = waves[run[0]][:256]
            # da: allow[nondet-source] -- one-time host-calibration timing for the offload policy; sampled digests are discarded
            t0 = _time.perf_counter()
            for pn in sample:
                _h(_NODE_PREFIX + pn.left + pn.right)
            dt = _time.perf_counter() - t0  # da: allow[nondet-source] -- host-calibration EMA close (see t0 above)
            policy.note_host(dt * 1e9 / len(sample))
        refs, literals, offsets = _plan_encode(waves, run)
        n = offsets[-1]
        # da: allow[nondet-source] -- the plan's blocking time feeds the offload policy's device EMA only
        t0 = _time.perf_counter()
        digests = merkle_plan_hash_bytes(refs, literals, offsets,
                                         self.device).tobytes()
        dt = _time.perf_counter() - t0  # da: allow[nondet-source] -- device-plan EMA close (see t0 above)
        policy.note_device(dt * 1e9 / n)
        self.wave_device_hashes += n
        dirty = self._dirty
        i = 0
        for level in run:
            default = DEFAULTS[level]
            wave = waves[level]
            for pn in wave:
                digest = digests[i:i + 32]
                i += 32
                pn.hash = digest
                if digest != default:
                    left, right = pn.left, pn.right
                    if left.__class__ is _PlanNode:
                        left = left.hash
                    if right.__class__ is _PlanNode:
                        right = right.hash
                    dirty[b"n" + digest] = _NODE_PREFIX + left + right
            self.hashes_total += len(wave)

    # --- batch overlay (WriteRequestManager's per-3PC-batch seam) -------

    def begin_batch(self) -> bool:
        """Start buffering writes for a one-walk commit; returns whether
        batch mode engaged (False = the knob disabled it and writes
        apply sequentially as before). While a batch is open,
        ``get(is_committed=False)`` consults the pending overlay first,
        so dynamic validation sees earlier writes of the same batch."""
        if not self._commit_batch_enabled:
            return False
        if self._pending is None:
            self._pending = {}
        return True

    def flush_batch(self) -> bytes:
        """Apply everything buffered since :meth:`begin_batch` via ONE
        :meth:`apply_batch` walk; returns the new working root."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            if pending:
                self.apply_batch(pending.items())
        return self._root

    def discard_batch(self) -> None:
        self._pending = None

    @property
    def in_batch(self) -> bool:
        return self._pending is not None

    @property
    def pending_writes(self) -> int:
        return len(self._pending) if self._pending is not None else 0

    # --- State API -----------------------------------------------------

    def set(self, key: bytes, value: bytes) -> None:
        if self._pending is not None:
            self._pending[key] = value
            return
        self._root = self._update(self._root, key, value)

    def remove(self, key: bytes) -> None:
        if self._pending is not None:
            self._pending[key] = None
            return
        self._root = self._update(self._root, key, None)

    def get(self, key: bytes, is_committed: bool = False) -> Optional[bytes]:
        if not is_committed and self._pending is not None \
                and key in self._pending:
            return self._pending[key]
        root = self._committed_root if is_committed else self._root
        return self._lookup(root, key)

    def get_for_root_hash(self, root: bytes, key: bytes) -> Optional[bytes]:
        return self._lookup(root, key)

    def commit(self, root_hash: Optional[bytes] = None) -> None:
        """Advance the committed head.

        With ``root_hash`` given, only the committed pointer moves — the
        working head stays at the tip, so later staged (pipelined) batches
        survive committing an earlier one. Without it, everything staged
        becomes committed (head == tip).
        """
        self.flush_batch()
        self._committed_root = root_hash if root_hash is not None \
            else self._root
        if root_hash is None:
            self._root = self._committed_root
        if self._dirty:
            self._kv.do_batch(list(self._dirty.items()))
            self._dirty.clear()
        self._store_root()

    def revert_to_head(self) -> None:
        self._pending = None
        self._root = self._committed_root

    def set_head_hash(self, root: bytes) -> None:
        """Move the working head to a known root (LIFO batch revert: nodes
        are content-addressed, so any recorded root remains reachable).
        An open write buffer is DISCARDED — this is the exception/revert
        path, and the buffered writes belong to the abandoned batch."""
        self._pending = None
        self._root = root

    @property
    def head_hash(self) -> bytes:
        if self._pending:
            self.flush_batch()
        return self._root

    @property
    def committed_head_hash(self) -> bytes:
        return self._committed_root

    # --- proofs --------------------------------------------------------

    def generate_state_proof(self, key: bytes, root: Optional[bytes] = None,
                             serialize: bool = True):
        """Proof of (non-)membership: bitmap + non-default siblings.

        Returns msgpack bytes when ``serialize`` (wire format for
        state-proof replies), else the (bitmap, siblings) tuple.
        """
        if self._pending:
            self.flush_batch()
        root = root if root is not None else self._committed_root
        bits = _path_bits(key)
        siblings: List[bytes] = []
        node = root
        for level in range(DEPTH):
            if node == DEFAULTS[level]:
                siblings.extend(DEFAULTS[l + 1] for l in range(level, DEPTH))
                break
            raw = self._get_node(node)
            left, right = raw[1:33], raw[33:65]
            if bits[level] == 0:
                siblings.append(right)
                node = left
            else:
                siblings.append(left)
                node = right
        bitmap = bytearray(DEPTH // 8)
        packed: List[bytes] = []
        for level, sib in enumerate(siblings):
            if sib != DEFAULTS[level + 1]:
                bitmap[level // 8] |= 1 << (7 - level % 8)
                packed.append(sib)
        proof = (bytes(bitmap), packed)
        if serialize:
            return packb([proof[0], proof[1]])
        return proof


def verify_state_proof(root: bytes, key: bytes, value: Optional[bytes],
                       proof) -> bool:
    """Client-side scalar verification (host oracle for the device kernel).

    The proof (and often the root) is UNTRUSTED wire input: any
    malformed shape — undecodable msgpack, a short root, non-bytes path
    elements, wrong-length siblings or bitmap — verifies ``False``
    instead of raising (parity with ``verify_proved_read``; a byzantine
    replier must not crash the client)."""
    try:
        if isinstance(proof, (bytes, bytearray)):
            bitmap, packed = unpackb(bytes(proof))
        else:
            bitmap, packed = proof
        if not isinstance(root, (bytes, bytearray)) or len(root) != 32:
            return False
        if not isinstance(key, (bytes, bytearray)):
            return False
        if not isinstance(bitmap, (bytes, bytearray)) \
                or len(bitmap) != DEPTH // 8:
            return False
        if not all(isinstance(sib, (bytes, bytearray)) and len(sib) == 32
                   for sib in packed):
            return False
        bits = _path_bits(bytes(key))
        path_digest = _h(bytes(key))
        siblings = []
        it = iter(packed)
        for level in range(DEPTH):
            if bitmap[level // 8] & (1 << (7 - level % 8)):
                try:
                    siblings.append(bytes(next(it)))
                except StopIteration:
                    return False
            else:
                siblings.append(DEFAULTS[level + 1])
        if value is None:
            node = DEFAULTS[DEPTH]
        else:
            node = _h(_LEAF_PREFIX + path_digest + bytes(value))
        for level in range(DEPTH - 1, -1, -1):
            if bits[level] == 0:
                node = _h(_NODE_PREFIX + node + siblings[level])
            else:
                node = _h(_NODE_PREFIX + siblings[level] + node)
        return node == bytes(root)
    except Exception:  # noqa: BLE001 — untrusted wire input: any shape error is a failed proof
        return False


# API-compat alias: the reference calls its concrete state PruningState
PruningState = SparseMerkleState
