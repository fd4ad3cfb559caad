"""Faults planted in the program after set-up, for the control and the
fault tests: each breaks one guarantee the configuration states, and the
run's ``correct`` has to come out false.

- ``auth_off`` (the control of a mix with forged writes): every node accepts
  every signature unverified.
- ``live_tip`` (the control of the reads cell): reads are served against
  the live ledger tip under the last stabilized window's multi-signature,
  skipping the window pin.
- ``half_batch``: each auth drain verifies its first half and passes the
  rest.
- ``state_frozen``: one node's NYM execution leaves its state unchanged.
- ``reply_altered``: one node's replies name the next seqNo.
- ``path_altered``: every served read's first audit-path node has one
  bit flipped.

``python -m port_bench.control`` runs a cell with one of them on the card.
"""
from __future__ import annotations

import numpy as np


def auth_off(pool, loop) -> None:
    for nd in pool.nodes:
        nd.authnr.authenticate_batch = lambda reqs: np.ones(len(reqs), bool)


def half_batch(pool, loop) -> None:
    for nd in pool.nodes:
        real = nd.authnr.authenticate_batch

        def half(reqs, real=real):
            k = len(reqs) // 2
            head = real(reqs[:k]) if k else np.zeros(0, bool)
            return np.concatenate([head, np.ones(len(reqs) - k, bool)])

        nd.authnr.authenticate_batch = half


def state_frozen(pool, loop) -> None:
    # the last node: a primary of no instance in either pool
    pool.nodes[-1].boot.nym_handler.update_state = \
        lambda txn, prev_result, request=None, is_committed=False: None


def reply_altered(pool, loop) -> None:
    node = pool.nodes[-1]
    real = node._to_client

    def altered(client_id, msg):
        if msg.typename == "REPLY":
            result = dict(msg.result)
            md = dict(result["txnMetadata"])
            md["seqNo"] += 1
            result["txnMetadata"] = md
            msg = type(msg)(result=result)
        real(client_id, msg)

    node._to_client = altered


def path_altered(pool, loop) -> None:
    for nd in pool.nodes:
        rs = nd.read_service
        real = rs.drain

        def drain(real=real):
            out = real()
            for r in out:
                if r.path:
                    first = bytes([r.path[0][0] ^ 1]) + r.path[0][1:]
                    r.path = [first] + list(r.path[1:])
            return out

        rs.drain = drain


def live_tip(pool, loop) -> None:
    import dataclasses

    for nd in pool.nodes:
        cache, backing = nd.proof_cache, nd.read_service.backing
        real = cache.attach

        def attach(batch=1, real=real, backing=backing):
            entry = real(batch)
            if entry is None:
                return None
            backing.refresh()
            return dataclasses.replace(entry, tree_size=backing.tree_size,
                                       root=backing.root)

        cache.attach = attach


FAULTS = {f.__name__: f for f in (auth_off, live_tip, half_batch,
                                  state_frozen, reply_altered, path_altered)}
