"""The file-backed stores in the port against the JAX package.

``storage/file_stores.py`` (``TextFileStore``, ``ChunkedFileStore``) and
``initKeyValueStorage``'s ``text_file`` and ``chunked_file`` kinds: the
same operations on the JAX and the port stores, each in a directory of
its own, leave the same contents, iteration order and files on disk,
across a reopen, a compaction, a ledger's writes and truncation, and the
refusals (out-of-order appends, a batch with a gap). Host storage: there
is no device path.
"""
import importlib
import os
import random
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")


def _side(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root, fs=mod("storage.file_stores"), kv=mod("storage.kv_store"),
        Ledger=mod("ledger.ledger").Ledger,
        Tree=mod("ledger.compact_merkle_tree").CompactMerkleTree)


JAX = _side("indy_plenum_tpu")
PORT = _side("indy_plenum_tpu_torch")


def _both(tmp_path, fn, *args):
    want = fn(JAX, str(tmp_path / "jax"), *args)
    got = fn(PORT, str(tmp_path / "port"), *args)
    assert got == want
    return got


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _text(side, root, seed):
    rng = random.Random(seed)
    store = side.fs.TextFileStore(root, "kv")
    trail = []
    for _ in range(60):
        key = b"k%02d" % rng.randrange(20)
        if rng.random() < 0.25:
            store.remove(key)
        else:
            store.put(key, rng.randbytes(6))
    store.do_batch([(b"k01", None), (b"z", b"last"), (b"a", b"first")])
    trail += [store.size, list(store.iterator()),
              list(store.iterator(b"k05", b"k15", include_value=False)),
              store.has_key(b"k01"), store.get(b"a")]
    store.close()
    reopened = side.fs.TextFileStore(root, "kv")
    trail += [reopened.size, list(reopened.iterator())]
    reopened.compact()
    trail += [list(reopened.iterator()), _files(root)]
    reopened.close()
    return trail


@pytest.mark.parametrize("seed", [2, 9])
def test_text_file_store_matches_jax(tmp_path, seed):
    trail = _both(tmp_path, _text, seed)
    assert trail[1] == trail[6] == trail[7]
    assert trail[4] == b"first" and trail[3] is False


def _chunked(side, root, chunk_size):
    store = side.fs.ChunkedFileStore(root, "domain", chunk_size=chunk_size)
    ledger = side.Ledger(tree=side.Tree(), txn_store=store)
    for i in range(10):
        ledger.add({"k": i})
    trail = [store.size, sorted(os.listdir(os.path.join(root, "domain"))),
             ledger.root_hash]
    ledger.reset_to(6)
    trail.append(store.size)
    for i in range(6, 10):
        ledger.add({"k": i})
    trail += [ledger.root_hash, list(store.iterator()),
              list(store.iterator((2).to_bytes(8, "big"),
                                  (7).to_bytes(8, "big")))]
    reopened = side.fs.ChunkedFileStore(root, "domain", chunk_size=999)
    trail += [reopened.size, reopened._chunk_size,
              list(reopened.iterator()), _files(root)]
    for bad in (lambda: store.put((20).to_bytes(8, "big"), b"x"),
                lambda: store.remove((3).to_bytes(8, "big")),
                lambda: store.do_batch([((11).to_bytes(8, "big"), b"a"),
                                        ((13).to_bytes(8, "big"), b"b")])):
        with pytest.raises(ValueError):
            bad()
    trail += [store.size, _files(root)]
    store.drop()
    trail.append(os.path.exists(os.path.join(root, "domain")))
    return trail


@pytest.mark.parametrize("chunk_size", [4, 3, 1000])
def test_chunked_file_store_matches_jax(tmp_path, chunk_size):
    trail = _both(tmp_path, _chunked, chunk_size)
    assert trail[0] == 10 and trail[3] == 6 and trail[2] == trail[4]
    assert trail[7] == 10 and trail[8] == chunk_size
    if chunk_size == 4:
        assert [f for f in trail[1] if f.endswith(".chunk")] == \
            ["000000.chunk", "000001.chunk", "000002.chunk"]
    assert trail[11] == 10 and trail[12] == trail[10]


@pytest.mark.parametrize("kind", ["text_file", "chunked_file"])
def test_init_kv_storage_file_kinds_match_jax(tmp_path, kind):
    def run(side, root):
        store = side.kv.initKeyValueStorage(kind, root, "db")
        for seq in range(1, 6):
            store.put(seq.to_bytes(8, "big"), b"v%d" % seq)
        out = [type(store).__name__, store.size, list(store.iterator()),
               _files(root)]
        store.close()
        return out

    got = _both(tmp_path, run)
    assert got[0] == {"text_file": "TextFileStore",
                      "chunked_file": "ChunkedFileStore"}[kind]
