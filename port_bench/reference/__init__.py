"""The benchmark's plain reference: what a served NYM write, a committed
ledger, a state root and a proved read must be, worked out again from the
requests the benchmark's clients sent.

Plain Python and hashlib only. Nothing here imports the program under
test (``indy_plenum_tpu_torch``), the JAX package or JAX; the program's
outputs (ledger leaves, replies, proved reads) reach :mod:`.check` as
plain bytes and dicts, to be judged.
"""
