"""Record the collective traffic of the distributed design.

Runs on a virtual CPU mesh of 8 devices (the collective instructions XLA
emits are facts about the mesh, not the backend):

1. per-step collective instructions + bytes from the COMPILED HLO of the
   row-partitioned solve (``ShardedSparseOperator``);
2. the nnz-balance table of the snake row partition;
3. virtual-mesh solve wall times at ndev in {1, 2, 4, 8} (CPU-backend
   times — relative sanity only, not a device measurement).

Usage::

    python scripts/collective_audit.py --arcs 500000

(the script forces the CPU backend + 8 virtual devices itself).
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arcs", type=int, default=500_000)
    ap.add_argument("--k", type=int, default=30)
    ap.add_argument("--rho", type=int, default=3)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    import numpy as np
    from jax.sharding import Mesh

    from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
    from two_pass_lanczos_tpu.parallel.sharded import ShardedSparseOperator
    from two_pass_lanczos_tpu.utils.collectives import collectives_in_hlo

    inst = generate_mcf_instance(args.arcs, rho=args.rho, instance_id=1)
    n = inst.num_arcs + inst.num_nodes
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)

    mesh8 = Mesh(np.array(jax.devices()[:8]), ("rows",))

    # --- 1. collective table from compiled HLO (8 devices) ---
    op = ShardedSparseOperator.from_kkt_arrays(inst, mesh8, dtype=np.float64)
    txt = op._solver(args.k, "inv", "two_pass").lower(
        op.local_blocks, op._prepare_b(b)).compile().as_text()
    generic = [vars(o) | {"bytes_out": o.bytes_out}
               for o in collectives_in_hlo(txt)]
    gather_step = max(o["bytes_out"] // o["count"] for o in generic
                      if o["kind"] == "all-gather")
    print(json.dumps({
        "instance": {"arcs": inst.num_arcs, "nodes": inst.num_nodes, "n": n},
        "collectives": generic,
        "per_step_all_gather_bytes": gather_step,
    }))

    # --- 2. nnz balance ---
    per = op.nnz_per_device
    print(json.dumps({
        "nnz_per_device": per.tolist(),
        "imbalance_max_over_mean": round(float(per.max() / per.mean()), 5),
    }))

    # --- 3. virtual-mesh wall times (relative sanity only) ---
    times = {}
    for ndev in (1, 2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:ndev]), ("rows",))
        o = ShardedSparseOperator.from_kkt_arrays(inst, mesh, dtype=np.float64)
        o.solve_fAb(b, k=args.k, f="inv", method="two_pass")  # compile
        t0 = time.perf_counter()
        o.solve_fAb(b, k=args.k, f="inv", method="two_pass")
        times[ndev] = round(time.perf_counter() - t0, 3)
    print(json.dumps({"virtual_mesh_solve_s": times,
                      "note": "CPU-backend wall times; collectives are "
                              "memcpy on a virtual mesh — use the HLO byte "
                              "table for traffic"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
