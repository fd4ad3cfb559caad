"""Tests of the port that need a CUDA card (marked ``cuda``; each skips
without one, deciding inside the test). This file imports nothing of JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

- the window kernels (K8, ``csrc/window.cu``) against their plain versions
  at the main path's size, bit-equal;
- a small signed pool on the card against the same pool on the CPU, through
  checkpoint slides and a view change: the same ordering, the same
  protocol timeline, and every kernel of the path launched.
"""
import numpy as np
import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_window_kernels_match_plain(card):
    """``chip_smoke.py``'s K8 check: edge deltas, one sliding member,
    every member sliding, random masks, at M = N = 64, S = 300."""
    import chip_smoke

    from indy_plenum_tpu_torch.utils import kernel_build as kb

    before = dict(kb.LAUNCHES)
    assert chip_smoke.check_window(card, np.random.RandomState(4)) == (0, 0)
    assert kb.LAUNCHES["window_slide"] == before["window_slide"] + 3
    assert kb.LAUNCHES["window_zero"] == before["window_zero"] + 3


def _pool_run(device):
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    cfg = getConfig({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 1,
                     "QuorumTickInterval": 0.05, "LOG_SIZE": 20,
                     "CHK_FREQ": 5})
    pool = SimPool(4, seed=7, config=cfg, device_quorum=True,
                   sign_requests=True, shadow_check=False, trace=True,
                   device=device)
    for i in range(12):
        pool.submit_request(i)
    pool.run_for(10)
    pool.network.disconnect(pool.nodes[0].data.primaries[0])
    pool.run_for(pool.config.ToleratePrimaryDisconnection + 10)
    for i in range(100, 106):
        pool.submit_request(i)
    pool.run_for(12)
    assert pool.honest_nodes_agree()
    return (pool.ordered_hash(), [nd.ordered_digests for nd in pool.nodes],
            [nd.data.view_no for nd in pool.nodes],
            pool.trace.trace_hash(exclude_cats=("dispatch",)))


@pytest.mark.cuda
def test_small_pool_on_card_matches_cpu(card):
    from indy_plenum_tpu_torch.utils import kernel_build as kb

    kb.library()
    kb.reset_launch_counts()
    on_card = _pool_run(None)
    launches = kb.launch_counts()
    assert on_card == _pool_run("cpu")
    assert max(on_card[2]) >= 1
    for name, count in launches.items():
        assert count > 0, name
