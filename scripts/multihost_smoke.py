"""Multi-process smoke: the row-partitioned solver over a 2-process mesh.

Launches N jax.distributed processes (CPU backend, 4 virtual devices each) so
the global mesh spans process boundaries — the code path a multi-host run
takes (``jax.distributed.initialize`` + a global ``Mesh``; the reference is
single-threaded and has none).

Each process builds the same instance, solves with ``raw=True`` (sharded
output stays device-resident; the decomposition is replicated and host-
readable), and process 0 checks the replicated scalars against a
single-process oracle value passed in by the launcher.

Usage (what tests/test_multihost.py drives):
    python scripts/multihost_smoke.py --num-processes 2 --process-id $I \
        --coordinator localhost:12345 --expect-bnorm <oracle>
"""

import argparse
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--expect-bnorm", type=float, default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.devices_per_process)
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import numpy as np

    from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh
    from two_pass_lanczos_tpu.utils.data_loader import KKTArrays

    assert jax.process_count() == args.num_processes
    ndev = len(jax.devices())
    assert ndev == args.num_processes * args.devices_per_process, ndev

    rng = np.random.default_rng(11)
    m, p = 4000, 300
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1.0, 3.0, m).astype(np.float32)
    b = rng.standard_normal(m + p).astype(np.float32)

    mesh = make_mesh(ndev)
    arrays = KKTArrays(quad_costs=d.astype(np.float64), arc_u=u, arc_v=v,
                       num_nodes=p, num_arcs=m)
    solver = ShardedSparseOperator.from_kkt_arrays(arrays, mesh,
                                                   dtype=np.float32)
    x, dec = solver.solve_fAb(b, k=12, f="inv", method="two_pass", raw=True)

    # replicated outputs are host-readable on every process
    b_norm = float(dec.b_norm)
    steps = int(dec.steps_taken)
    assert steps == 12, steps
    for shard in x.addressable_shards:
        assert np.all(np.isfinite(np.asarray(shard.data)))
    if args.expect_bnorm is not None:
        rel = abs(b_norm - args.expect_bnorm) / args.expect_bnorm
        assert rel < 1e-5, (b_norm, args.expect_bnorm)

    # the capability layer over process boundaries: SLQ on the sharded
    # path returns replicated scalars, host-readable everywhere
    # (tr A^2 = ||A||_F^2 Hutchinson samples; exact check is the
    # launcher's job, finiteness + replication is this smoke's)
    slq = solver.slq_trace(lambda t: t * t, k=4, num_probes=2,
                           key=jax.random.key(0))
    slq_est = float(slq.estimate)
    assert np.isfinite(slq_est), slq_est

    if args.process_id == 0:
        print(f"MULTIHOST_OK bnorm={b_norm!r} steps={steps} "
              f"slq={slq_est!r}")
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
