"""Protocol constants: ledger ids, txn types, roles, field names.

Reference: plenum/common/constants.py and plenum/common/types.py (the ``f``
field-name container). Values are semantically equivalent but independently
chosen where the reference's exact wire values are historical accidents.

Copy of ``indy_plenum_tpu/common/constants.py``, with its imports bound to
the port.
"""
from __future__ import annotations

# --- ledger ids (ordering matters: audit first in catchup) ---------------
POOL_LEDGER_ID = 0
DOMAIN_LEDGER_ID = 1
CONFIG_LEDGER_ID = 2
AUDIT_LEDGER_ID = 3

VALID_LEDGER_IDS = (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID,
                    AUDIT_LEDGER_ID)

# catchup order: audit pins the target sizes of the others (SURVEY.md §3.3)
CATCHUP_ORDER = (AUDIT_LEDGER_ID, POOL_LEDGER_ID, CONFIG_LEDGER_ID,
                 DOMAIN_LEDGER_ID)

# --- transaction types ----------------------------------------------------
NYM = "1"  # domain: identity CRUD
NODE = "0"  # pool: validator membership
GET_TXN = "3"
POOL_CONFIG = "111"  # config: pool-wide protocol parameters
WRITES = "writes"  # POOL_CONFIG field: pool accepts write requests
AUDIT = "2"  # audit ledger txn (one per 3PC batch)
GET_NYM = "105"
# action types (executed immediately on the receiving node, never written
# to a ledger; reference: plenum's ActionReqManager)
POOL_RESTART = "118"
VALIDATOR_INFO = "119"

# --- roles ----------------------------------------------------------------
TRUSTEE = "0"
STEWARD = "2"
IDENTITY_OWNER = None  # a NYM with no role

# --- NYM txn fields -------------------------------------------------------
TARGET_NYM = "dest"
VERKEY = "verkey"
ROLE = "role"
ALIAS = "alias"

# --- NODE txn data fields -------------------------------------------------
NODE_IP = "node_ip"
NODE_PORT = "node_port"
CLIENT_IP = "client_ip"
CLIENT_PORT = "client_port"
# the node's CurveZMQ transport public key, carried in NODE txn data so
# membership changes can rewire transports (the reference derives curve
# keys from the node verkey; an explicit field is the honest equivalent
# for our from-seed curve keys)
TRANSPORT_VERKEY = "transport_verkey"
SERVICES = "services"
BLS_KEY = "blskey"
BLS_KEY_PROOF = "blskey_pop"
VALIDATOR = "VALIDATOR"

# --- audit txn fields -----------------------------------------------------
AUDIT_TXN_VIEW_NO = "viewNo"
AUDIT_TXN_PP_SEQ_NO = "ppSeqNo"
AUDIT_TXN_LEDGERS_SIZE = "ledgerSize"
AUDIT_TXN_LEDGER_ROOT = "ledgerRoot"
AUDIT_TXN_STATE_ROOT = "stateRoot"
AUDIT_TXN_PRIMARIES = "primaries"
AUDIT_TXN_DIGEST = "digest"

# --- txn envelope fields --------------------------------------------------
TXN_TYPE = "type"
TXN_PAYLOAD = "txn"
TXN_PAYLOAD_DATA = "data"
TXN_PAYLOAD_METADATA = "metadata"
TXN_PAYLOAD_METADATA_FROM = "from"
TXN_PAYLOAD_METADATA_REQ_ID = "reqId"
TXN_PAYLOAD_METADATA_DIGEST = "digest"
TXN_METADATA = "txnMetadata"
TXN_METADATA_SEQ_NO = "seqNo"
TXN_METADATA_TIME = "txnTime"
TXN_SIGNATURE = "reqSignature"
TXN_VERSION = "ver"

CURRENT_TXN_VERSION = "1"

# --- misc protocol --------------------------------------------------------
CURRENT_PROTOCOL_VERSION = 2
GENESIS_FILE_SUFFIX = "_genesis"


class f:
    """Wire field names (reference: plenum/common/types.py ``f``)."""

    IDENTIFIER = "identifier"
    REQ_ID = "reqId"
    OPERATION = "operation"
    SIGNATURE = "signature"
    SIGNATURES = "signatures"  # multi-sig endorsements
    DIGEST = "digest"
    PROTOCOL_VERSION = "protocolVersion"
    VIEW_NO = "viewNo"
    INST_ID = "instId"
    PP_SEQ_NO = "ppSeqNo"
    PP_TIME = "ppTime"
    REQ_IDRS = "reqIdr"
    DISCARDED = "discarded"
    STATE_ROOT = "stateRootHash"
    TXN_ROOT = "txnRootHash"
    LEDGER_ID = "ledgerId"
    SEQ_NO_START = "seqNoStart"
    SEQ_NO_END = "seqNoEnd"
    CATCHUP_TILL = "catchupTill"
    TXNS = "txns"
    CONS_PROOF = "consProof"
    MERKLE_ROOT = "merkleRoot"
    OLD_MERKLE_ROOT = "oldMerkleRoot"
    NEW_MERKLE_ROOT = "newMerkleRoot"
    HASHES = "hashes"
    RESULT = "result"
    REASON = "reason"
    MSG = "msg"
    SENDER = "sender"
    BLS_SIG = "blsSig"
    BLS_MULTI_SIG = "blsMultiSig"
    AUDIT_TXN_ROOT = "auditTxnRootHash"
    PRIMARIES = "primaries"
    CHECKPOINTS = "checkpoints"
    STABLE_CHECKPOINT = "stableCheckpoint"
    PREPARED = "prepared"
    PREPREPARED = "preprepared"
    BATCHES = "batches"
    VIEW_CHANGES = "viewChanges"
    TIMESTAMP = "timestamp"
