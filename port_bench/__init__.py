"""The benchmark of the PyTorch and CUDA port (``indy_plenum_tpu_torch``):
signed NYM writes and proved reads through a pool of real validator
``Node``s on one card. ``python -m port_bench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json``.
"""
