"""Every inter-node wire message as a typed, validated class.

Reference: plenum/common/messages/node_messages.py (PrePrepare, Prepare,
Commit, Checkpoint, ViewChange, NewView, InstanceChange, Propagate,
LedgerStatus, ConsistencyProof, CatchupReq, CatchupRep, MessageReq,
MessageRep, Ordered, Batch). Field names follow
:class:`indy_plenum_tpu_torch.common.constants.f`.

BatchID convention (reference plenum/server/consensus/batch_id.py): a 4-list
``[view_no, pp_view_no, pp_seq_no, pp_digest]`` — ``pp_view_no`` is the view
the batch's PRE-PREPARE was originally created in (survives re-ordering
across view changes), ``view_no`` the view it is being ordered in.

Copy of ``indy_plenum_tpu/common/messages/node_messages.py``, with its
imports bound to the port.
"""
from __future__ import annotations

from .fields import (
    AnyField,
    Base58Field,
    BooleanField,
    EnumField,
    FixedLengthTupleField,
    IntegerField,
    IterableField,
    LedgerIdField,
    LimitedLengthStringField,
    MapField,
    MerkleRootField,
    NonEmptyStringField,
    NonNegativeNumberField,
    ProtocolVersionField,
    SerializedValueField,
    SignatureField,
    TimestampField,
)
from .message_base import MessageBase, node_message_registry

_DIGEST = LimitedLengthStringField(max_length=512)
_SENDER = LimitedLengthStringField(max_length=256)

BATCH_ID_FIELD = FixedLengthTupleField((
    NonNegativeNumberField(),  # view_no
    NonNegativeNumberField(),  # pp_view_no
    NonNegativeNumberField(),  # pp_seq_no
    LimitedLengthStringField(max_length=512),  # pp_digest
))

CHECKPOINT_VALUE_FIELD = FixedLengthTupleField((
    NonNegativeNumberField(),  # view_no
    NonNegativeNumberField(),  # pp_seq_no
    LimitedLengthStringField(max_length=512),  # digest
))


def register(cls):
    return node_message_registry.register(cls)


@register
class Propagate(MessageBase):
    typename = "PROPAGATE"
    schema = (
        ("request", AnyField()),  # full client request dict
        ("senderClient", LimitedLengthStringField(max_length=256,
                                                  nullable=True)),
    )


@register
class PrePrepare(MessageBase):
    typename = "PREPREPARE"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField()),
        ("ppSeqNo", NonNegativeNumberField()),
        ("ppTime", TimestampField()),
        ("reqIdr", IterableField(_DIGEST)),  # ordered request digests
        ("discarded", NonNegativeNumberField()),
        ("digest", _DIGEST),
        ("ledgerId", LedgerIdField()),
        ("stateRootHash", MerkleRootField(nullable=True)),
        ("txnRootHash", MerkleRootField(nullable=True)),
        ("sub_seq_no", NonNegativeNumberField()),
        ("final", BooleanField()),
        ("poolStateRootHash", MerkleRootField(nullable=True, optional=True)),
        ("auditTxnRootHash", MerkleRootField(nullable=True, optional=True)),
        ("blsMultiSig", AnyField(optional=True, nullable=True)),
        ("originalViewNo", NonNegativeNumberField(optional=True,
                                                  nullable=True)),
    )


@register
class Prepare(MessageBase):
    typename = "PREPARE"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField()),
        ("ppSeqNo", NonNegativeNumberField()),
        ("ppTime", TimestampField()),
        ("digest", _DIGEST),
        ("stateRootHash", MerkleRootField(nullable=True)),
        ("txnRootHash", MerkleRootField(nullable=True)),
        ("auditTxnRootHash", MerkleRootField(nullable=True, optional=True)),
    )


@register
class Commit(MessageBase):
    typename = "COMMIT"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField()),
        ("ppSeqNo", NonNegativeNumberField()),
        ("blsSig", LimitedLengthStringField(max_length=512, optional=True,
                                            nullable=True)),
        ("blsSigs", MapField(NonEmptyStringField(),
                             LimitedLengthStringField(max_length=512),
                             optional=True, nullable=True)),
    )


@register
class Checkpoint(MessageBase):
    typename = "CHECKPOINT"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField()),
        ("seqNoStart", NonNegativeNumberField()),
        ("seqNoEnd", NonNegativeNumberField()),
        ("digest", _DIGEST),
    )


@register
class InstanceChange(MessageBase):
    typename = "INSTANCE_CHANGE"
    schema = (
        ("viewNo", NonNegativeNumberField()),
        ("reason", IntegerField()),  # suspicion code
    )


@register
class ViewChange(MessageBase):
    typename = "VIEW_CHANGE"
    schema = (
        ("viewNo", NonNegativeNumberField()),
        ("stableCheckpoint", NonNegativeNumberField()),
        ("prepared", IterableField(BATCH_ID_FIELD)),
        ("preprepared", IterableField(BATCH_ID_FIELD)),
        ("checkpoints", IterableField(CHECKPOINT_VALUE_FIELD)),
    )


@register
class ViewChangeAck(MessageBase):
    typename = "VIEW_CHANGE_ACK"
    schema = (
        ("viewNo", NonNegativeNumberField()),
        ("name", _SENDER),  # whose VIEW_CHANGE is being acked
        ("digest", _DIGEST),
    )


@register
class NewView(MessageBase):
    typename = "NEW_VIEW"
    schema = (
        ("viewNo", NonNegativeNumberField()),
        # [(sender, view_change_digest)] the primary built the view from
        ("viewChanges", IterableField(FixedLengthTupleField(
            (_SENDER, _DIGEST)))),
        ("checkpoint", CHECKPOINT_VALUE_FIELD),
        ("batches", IterableField(BATCH_ID_FIELD)),
        ("primary", _SENDER),
    )


@register
class Ordered(MessageBase):
    typename = "ORDERED"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField()),
        ("ppSeqNo", NonNegativeNumberField()),
        ("ppTime", TimestampField()),
        ("reqIdr", IterableField(_DIGEST)),
        ("discarded", NonNegativeNumberField()),
        ("ledgerId", LedgerIdField()),
        ("stateRootHash", MerkleRootField(nullable=True)),
        ("txnRootHash", MerkleRootField(nullable=True)),
        ("auditTxnRootHash", MerkleRootField(nullable=True, optional=True)),
        ("primaries", IterableField(_SENDER, optional=True, nullable=True)),
        ("originalViewNo", NonNegativeNumberField(optional=True,
                                                  nullable=True)),
        ("digest", _DIGEST.__class__(max_length=512, optional=True,
                                     nullable=True)),
    )


@register
class LedgerStatus(MessageBase):
    typename = "LEDGER_STATUS"
    schema = (
        ("ledgerId", LedgerIdField()),
        ("txnSeqNo", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField(nullable=True)),
        ("ppSeqNo", NonNegativeNumberField(nullable=True)),
        ("merkleRoot", MerkleRootField()),
        ("protocolVersion", ProtocolVersionField()),
        # True marks a fork-point PROBE: "what is your root at this
        # size?" — a question, not an assertion about the sender's own
        # ledger. Receivers must answer probes (SeederService) but never
        # count them as status evidence (divergence/tip votes), or a
        # diverged prober's corrupt prefix root would masquerade as a
        # genuine accusation against healthy nodes.
        ("probe", BooleanField(optional=True)),
    )


@register
class ConsistencyProof(MessageBase):
    typename = "CONSISTENCY_PROOF"
    schema = (
        ("ledgerId", LedgerIdField()),
        ("seqNoStart", NonNegativeNumberField()),
        ("seqNoEnd", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField(nullable=True)),
        ("ppSeqNo", NonNegativeNumberField(nullable=True)),
        ("oldMerkleRoot", MerkleRootField()),
        ("newMerkleRoot", MerkleRootField()),
        ("hashes", IterableField(NonEmptyStringField())),
    )


@register
class CatchupReq(MessageBase):
    typename = "CATCHUP_REQ"
    schema = (
        ("ledgerId", LedgerIdField()),
        ("seqNoStart", NonNegativeNumberField()),
        ("seqNoEnd", NonNegativeNumberField()),
        ("catchupTill", NonNegativeNumberField()),
    )


@register
class CatchupRep(MessageBase):
    """Txn range + per-txn audit paths.

    TPU-first redesign: the reference's CatchupRep carries one consistency
    proof per rep, verified by an incremental host-side tree fold; here
    EVERY txn carries its own audit path against the quorum-agreed target
    root, so one vmapped device kernel call
    (:func:`indy_plenum_tpu_torch.tpu.sha256.verify_audit_paths`) verifies the
    whole slice — BASELINE config 5's batched proof verification.
    """

    typename = "CATCHUP_REP"
    schema = (
        ("ledgerId", LedgerIdField()),
        # seqNo(str, msgpack keys) -> txn
        ("txns", MapField(NonEmptyStringField(), AnyField())),
        # seqNo(str) -> [b58 sibling hashes], leaf->root at size catchupTill
        ("auditPaths", MapField(NonEmptyStringField(),
                                IterableField(NonEmptyStringField()))),
        ("catchupTill", NonNegativeNumberField()),
    )


@register
class ObservedData(MessageBase):
    """One committed batch pushed to a non-validator observer.

    Reference: plenum/server/observer/ (``ObservedData`` + the
    each-batch sync policy). Proof-carrying redesign: the attached pool
    BLS multi-signature co-signs BOTH the state root and the txn root of
    the batch, so an observer holding the pool's BLS keys can trust ONE
    validator's push — it re-applies the txns and checks its own
    recomputed roots against the co-signed ones. Without BLS an observer
    falls back to f+1 identical pushes from distinct validators.
    """

    typename = "OBSERVED_DATA"
    schema = (
        ("ledgerId", LedgerIdField()),
        ("ppSeqNo", NonNegativeNumberField()),
        ("ppTime", TimestampField()),
        ("txns", IterableField(AnyField())),
        ("stateRootHash", MerkleRootField(nullable=True)),
        ("txnRootHash", MerkleRootField(nullable=True)),
        ("multiSignature", AnyField(optional=True, nullable=True)),
    )


@register
class Reply(MessageBase):
    """Node -> client: the committed txn for an executed request
    (reference: plenum/common/messages/node_messages.py Reply)."""

    typename = "REPLY"
    schema = (
        ("result", AnyField()),  # the committed txn incl. seqNo + roots
    )


@register
class RequestAck(MessageBase):
    """Node -> client: request accepted into propagation."""

    typename = "REQACK"
    schema = (
        ("identifier", LimitedLengthStringField(max_length=256,
                                                nullable=True)),
        ("reqId", NonNegativeNumberField()),
    )


@register
class RequestNack(MessageBase):
    """Node -> client: request rejected at ingress (bad signature, replay)."""

    typename = "REQNACK"
    schema = (
        ("identifier", LimitedLengthStringField(max_length=256,
                                                nullable=True)),
        ("reqId", NonNegativeNumberField()),
        ("reason", LimitedLengthStringField(max_length=512)),
    )


@register
class MessageReq(MessageBase):
    typename = "MESSAGE_REQUEST"
    schema = (
        ("msg_type", NonEmptyStringField()),
        ("params", MapField(NonEmptyStringField(), AnyField())),
    )


@register
class MessageRep(MessageBase):
    typename = "MESSAGE_RESPONSE"
    schema = (
        ("msg_type", NonEmptyStringField()),
        ("params", MapField(NonEmptyStringField(), AnyField())),
        ("msg", AnyField(nullable=True)),
    )


@register
class Batch(MessageBase):
    """Transport-level envelope coalescing several messages to one remote.

    Reference: plenum/common/batched.py -- outgoing messages per event-loop
    flush are packed into one signed Batch.
    """

    typename = "BATCH"
    schema = (
        ("messages", IterableField(SerializedValueField())),
        ("signature", SignatureField(nullable=True)),
    )


@register
class BlsMultiSigMsg(MessageBase):
    """Carrier for a BLS multi-signature value (attached to PRE-PREPAREs)."""

    typename = "BLS_MULTI_SIG"
    schema = (
        ("signature", NonEmptyStringField()),
        ("participants", IterableField(_SENDER)),
        ("value", AnyField()),  # MultiSignatureValue dict
    )


# --- BatchID helpers -------------------------------------------------------

def batch_id(view_no: int, pp_view_no: int, pp_seq_no: int,
             pp_digest: str) -> list:
    return [view_no, pp_view_no, pp_seq_no, pp_digest]


def bid_view(b) -> int:
    return b[0]


def bid_pp_view(b) -> int:
    return b[1]


def bid_seq(b) -> int:
    return b[2]


def bid_digest(b) -> str:
    return b[3]
