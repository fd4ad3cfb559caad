"""BLS signatures over BN254: the native backend and its affine oracle.

Copy of ``indy_plenum_tpu/crypto/bls/``: ``bn254`` (the pure-Python
oracle), ``bn254_native`` (the C extension ``native/bn254/bn254c.c``,
built on first import) and ``bls_crypto`` (sign, verify, aggregate and
the multi-signature value objects). The reference's projective
pure-Python backend (``bn254_fast.py``) is not ported: the port runs the
native backend only, and a failed build raises.
"""
