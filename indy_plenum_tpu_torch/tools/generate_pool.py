"""Provision a local validator pool: keys + genesis files.

Usage (from the root of a checkout):
    python -m indy_plenum_tpu_torch.tools.generate_pool DIR [N_NODES] \
        [BASE_PORT] [SEED_HEX]

Twin of ``scripts/generate_pool.py`` (reference analog:
scripts/generate_indy_pool_transactions). Secrets land under DIR/keys/ -
copy pool_info.json + genesis to every host, but each keys/<node>.json
ONLY to that node's host. SEED_HEX (64 hex chars) makes provisioning
reproducible; omit it for fresh randomness. The same seed writes the same
files as the JAX package's script, byte for byte.
"""
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    from .local_pool import generate_pool_config

    directory = argv[0]
    n = int(argv[1]) if len(argv) > 1 else 4
    base_port = int(argv[2]) if len(argv) > 2 else 9700
    seed = bytes.fromhex(argv[3]) if len(argv) > 3 else None
    info = generate_pool_config(directory, n_nodes=n, base_port=base_port,
                                master_seed=seed)
    print(f"pool of {n} validators provisioned in {directory}")
    for name, rec in sorted(info["nodes"].items()):
        print(f"  {name}: {rec['node_ip']}:{rec['node_port']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
