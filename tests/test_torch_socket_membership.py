"""Catchup, membership change and key rotation over real sockets, on the
port with ``device="cpu"``: the three scenarios of
``tests/test_socket_membership.py`` (the test's master seed and config) as
``chip_smoke.run_membership_z2`` runs them on the card in phase Z2.

- ``restart``: node3 is frozen while the pool orders 40 writes, comes
  back and catches up; the leeched domain slice (40 proofs, at least
  ``DEVICE_MIN_BATCH``) goes through the K10 path from a fresh offload
  policy, here its plain version;
- ``add_node``: a steward NYM, then a steward-signed NODE txn adds node4;
  every transport connects to it, quorums extend to n=5, node4 catches up;
- ``rotate_key``: node3 goes down, a NODE txn rotates its transport key,
  every survivor drops the old key and admits the new one, node3 rejoins
  under it.

Each scenario ends with one more write ordered by every member and every
member's domain ledger root equal. Ports come from
``torch_socket_ports.free_port_block``.
"""
import pytest

pytest.importorskip("zmq")

import chip_smoke  # noqa: E402
from torch_socket_ports import free_port_block  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread_and_free_ports(monkeypatch):
    import torch

    monkeypatch.setattr(chip_smoke, "_free_port_block", free_port_block)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("scenario", chip_smoke.Z2_SCENARIOS)
def test_membership_over_sockets(scenario):
    from indy_plenum_tpu_torch.server.catchup.catchup_rep_service import \
        DEVICE_MIN_BATCH

    rec = chip_smoke.run_membership_z2("cpu", scenario)
    assert rec["looper_errors"] == 0
    if scenario == "restart":
        assert rec["members"] == 4
        assert rec["domain_size"] == 5 + 1 + chip_smoke.Z2_MISSED + 1
        assert max(rec["audit_slices"]) >= DEVICE_MIN_BATCH
    elif scenario == "add_node":
        assert rec["members"] == 5
        # trustee + 4 stewards, a write, the steward NYM, the tail
        assert rec["domain_size"] == 5 + 3
    else:
        assert rec["members"] == 4
        assert rec["domain_size"] == 5 + 2
