"""The comparison that decides ``correct``: the pool's outputs after the
window, judged against what the benchmark's clients sent.

:func:`judge` takes the run's record as plain data (no object of the
program): every node's committed domain-ledger leaves, ledger root, state
root and ordered digests; every write sent (its signing payload,
signature, whether the client corrupted it, and every node's replies,
acknowledgements and rejections); the proved reads served. It returns one
count of mismatches for each guarantee; each must be 0.

- ``auth``: a write the reference's Ed25519 rejects that any node
  accepted, or that not every node rejected; a write it accepts that any
  node rejected. All corrupted writes and a seeded sample of the others
  are verified here; the rest are valid by construction.
- ``order``: nodes whose ordered log differs from the first node's.
- ``ledger``: nodes whose leaves or root differ from the reference's (the
  RFC 6962 root of the leaves); leaves that are not, in order, the
  genesis NYMs and then NYMs the clients sent validly signed (in set-up
  or in the window), each once, with their seqNo, digest and signature.
- ``state``: nodes whose committed state root differs from the root of
  the reference's sparse Merkle tree after every leaf's NYM record.
- ``replies``: acknowledged writes whose f+1 matching reply does not name
  the write's seqNo, txnTime and digest, a ledger root the reference had
  within one batch after it and the state root that goes with it; replies
  of any node that differ from the quorum's.
- ``lost``: acknowledged writes not on the ledger; writes and reads never
  answered.
- ``reads``: served reads (a seeded sample) whose leaf, root or audit
  path does not check against the reference's ledger, or that the node
  did not mark verified.
- ``multisig``: multi-signatures attached to reads whose signed roots are
  not the reference's at that size, with fewer than n - f participants,
  or that fail the BLS pairing check with the keys the reference derives.
"""
from __future__ import annotations

import hashlib
import json
import random
from typing import Dict, List

from . import bls, ed25519, merkle
from .b58 import b58decode, b58encode
from .msgpack import packb, signing_bytes
from .smt import SparseMerkleTree

CHECKS = ("auth", "order", "ledger", "state", "replies", "lost", "reads",
          "multisig")
DOMAIN_LEDGER_ID = 1


def _digest(payload: dict) -> str:
    return hashlib.sha256(signing_bytes(payload)).hexdigest()


def _sample(items: list, k: int, seed: int) -> list:
    if len(items) <= k:
        return list(items)
    return random.Random(seed).sample(items, k)


def _trustee_ok(txn: dict, seed: bytes) -> bool:
    pk = ed25519.public_key(seed)
    data = txn["txn"]["data"]
    return (data.get("dest") == b58encode(pk[:16])
            and data.get("verkey") == "~" + b58encode(pk[16:]))


def _content(txns: List[dict], writes: List[dict], genesis: int,
             trustee_seed: bytes) -> tuple:
    """Mismatched leaves, and reqId -> (seqNo, txnTime) of the writes
    (set-up's and the window's)."""
    bad = 0
    by_req = {w["payload"]["reqId"]: w for w in writes}
    placed: Dict[int, tuple] = {}
    if len(txns) < genesis or not _trustee_ok(txns[0], trustee_seed):
        bad += 1
    for pos, txn in enumerate(txns):
        seq = pos + 1
        md = txn.get("txnMetadata") or {}
        body = txn.get("txn") or {}
        if md.get("seqNo") != seq or body.get("type") != "1":
            bad += 1
            continue
        if pos < genesis:
            continue
        meta = body.get("metadata") or {}
        w = by_req.get(meta.get("reqId"))
        if w is None or w["corrupt"] or meta["reqId"] in placed:
            bad += 1
            continue
        op = w["payload"]["operation"]
        sigs = (txn.get("reqSignature") or {}).get("values") or [{}]
        if (meta.get("from") != w["payload"]["identifier"]
                or meta.get("digest") != _digest(w["payload"])
                or body.get("data") != {"dest": op["dest"],
                                        "verkey": op["verkey"]}
                or sigs[0].get("value") != w["signature"]):
            bad += 1
            continue
        placed[meta["reqId"]] = (seq, md.get("txnTime"))
    return bad, placed


def _state_roots(txns: List[dict], sizes) -> Dict[int, bytes]:
    """The state root after the first ``s`` leaves, for each wanted s:
    a NYM's record is {verkey, role, seqNo, txnTime}, verkey and role
    kept from the existing record where the txn leaves them out."""
    tree, records, out = SparseMerkleTree(), {}, {}
    wanted = set(sizes)
    if 0 in wanted:
        out[0] = tree.root
    for pos, txn in enumerate(txns):
        data = txn["txn"]["data"]
        dest = data["dest"]
        old = records.get(dest, {})
        rec = {"verkey": data.get("verkey", old.get("verkey")),
               "role": data.get("role", old.get("role")),
               "seqNo": txn["txnMetadata"]["seqNo"],
               "txnTime": txn["txnMetadata"].get("txnTime")}
        records[dest] = rec
        tree.set(dest.encode(), packb(rec))
        if pos + 1 in wanted:
            out[pos + 1] = tree.root
    return out


def judge(record: dict) -> Dict[str, int]:
    n, f = record["n"], record["f"]
    nodes, writes = record["nodes"], record["writes"]
    reads = [r for r in record["reads"] if r is not None]
    seed = record["sample_seed"]
    out = {name: 0 for name in CHECKS}

    leaves = nodes[0]["leaves"]
    txns = [json.loads(leaf) for leaf in leaves]
    roots = merkle.PrefixRoots(leaves)
    size_of = {root: size for size, root in enumerate(roots.roots)}

    # ordering and the ledger, node by node
    for nd in nodes:
        if nd["ordered"] != nodes[0]["ordered"]:
            out["order"] += 1
        if nd["leaves"] != leaves or nd["root"] != roots.root(len(leaves)):
            out["ledger"] += 1
    bad, placed = _content(txns, record["setup_writes"] + writes,
                           record["genesis"],
                           record["trustee_seed"])
    out["ledger"] += bad

    # replies, and the sizes whose state roots they name
    want = {len(leaves)} | {r["tree_size"] for r in reads}
    reply_size: Dict[int, int] = {}
    for w in writes:
        if w["outcome"] != "acked":
            continue
        root = w["quorum"][2]
        try:
            size = size_of.get(b58decode(root)) if root else None
        except (KeyError, ValueError):
            size = None
        if size is not None:
            reply_size[w["payload"]["reqId"]] = size
            want.add(size)
    state = _state_roots(txns, want)
    for nd in nodes:
        if nd["state_root"] != state[len(leaves)]:
            out["state"] += 1
    for w in writes:
        req_id = w["payload"]["reqId"]
        if w["outcome"] is None:
            out["lost"] += 1
            continue
        if w["outcome"] != "acked":
            continue
        if req_id not in placed:
            out["lost"] += 1
            continue
        seq, txn_time = placed[req_id]
        q_seq, q_time, _, q_state, q_digest = w["quorum"]
        size = reply_size.get(req_id)
        if (q_seq != seq or q_time != txn_time
                or q_digest != _digest(w["payload"]) or size is None
                or not seq <= size < seq + record["max_batch"]
                or q_state != b58encode(state[size])):
            out["replies"] += 1
        out["replies"] += sum(1 for fp in w["replies"].values()
                              if fp != w["quorum"])

    # authentication verdicts
    pk = ed25519.public_key(record["trustee_seed"])
    checked = set(id(w) for w in _sample(
        [w for w in writes if not w["corrupt"]], record["auth_sample"],
        seed))
    for w in writes:
        if w["corrupt"] or id(w) in checked:
            ok = ed25519.verify(pk, signing_bytes(w["payload"]),
                                b58decode(w["signature"]))
        else:
            ok = True
        accepted = not w["nacks"] and (w["acks"] > 0 or bool(w["replies"]))
        rejected = len(w["nacks"]) == n and not w["replies"] \
            and w["acks"] == 0
        if (ok and not accepted) or (not ok and not rejected):
            out["auth"] += 1

    # proved reads
    out["lost"] += record["reads_unanswered"]
    keys = {}
    seen_sigs = {}
    for r in _sample(reads, record["read_sample"], seed):
        size = r["tree_size"]
        ref = roots.root(size) if 0 < size <= len(leaves) else None
        if (ref is None or r["root"] != ref or not r["verified"]
                or not 0 <= r["index"] < size
                or r["leaf"] != leaves[r["index"]]
                or not merkle.verify_inclusion(r["leaf"], r["index"], size,
                                               r["path"], ref)):
            out["reads"] += 1
        ms = r["multi_sig"]
        if ms is None:
            continue
        key = (ms["signature"], size)
        if key in seen_sigs:
            continue
        value = ms["value"]
        good = (ref is not None
                and value["ledger_id"] == DOMAIN_LEDGER_ID
                and value["txn_root_hash"] == b58encode(ref)
                and value["state_root_hash"] == b58encode(
                    state.get(size, b"")))
        if good:
            for p in ms["participants"]:
                if p not in keys and p in record["names"]:
                    keys[p] = bls.public_key(bls.key_seed(p))
            good = bls.verify_multi_sig(ms, keys, n - f)
        seen_sigs[key] = good
        out["multisig"] += 0 if good else 1
    return out
