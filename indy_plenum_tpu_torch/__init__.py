"""PyTorch + CUDA port of the signed-write device plane of ``indy_plenum_tpu``.

The JAX package beside this one is the reference. This package imports
``torch``, numpy and the standard library only: whatever it needs from the
JAX package it keeps as its own copy, and each copy's docstring names the
file it came from.

What is here (the first slice of the port):

- ingress authentication: ``server.client_authn.CoreAuthNr`` batch-verifies
  signed requests with hand-written CUDA kernels for SHA-512, mod-L and the
  Ed25519 double-scalar check (``tpu.sha512``, ``tpu.ed25519``);
- the grouped quorum step: ``tpu.vote_plane.VotePlaneGroup`` scatters every
  member's votes and evaluates quorums in one CUDA kernel per dispatch
  (``tpu.quorum``), reading back only the compact deltas.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version. CUDA sources live under ``csrc/`` and are built with ``nvcc`` at
first use (``utils.kernel_build``).
"""
