"""Multi-process scaling check: per-step time and nnz/s of the
row-partitioned solve (``ShardedSparseOperator``) over an N-process
``jax.distributed`` mesh.

* launched WITHOUT ``--process-id`` it is the orchestrator — it spawns N
  worker processes of itself, collects their JSON, computes the efficiency
  table, and prints one JSON line per N;
* launched WITH ``--process-id`` it is one worker: it joins the
  ``jax.distributed`` mesh, builds the instance, and times the solve.

The script is CPU-only: every worker uses the CPU backend with virtual
devices, so the numbers are CORRECTNESS-GRADE ONLY (collectives are
memcpys; ``meaningful: false`` in the JSON). Several JAX processes cannot
share a GPU (each reserves most of its memory), and one process drives
every card of a host anyway — the four-card measurement is
``chip_smoke.py --four-cards``. ``--output`` additionally writes the
records to a JSON artifact (the committed one lives at
``results/scaling_virtual.json``).

Usage:

    python scripts/scaling_bench.py --processes 1 2 --arcs 100000 --k 50

JSON schema (one line per N):

    {"metric": "scaling_generic_nproc<N>", "seconds_per_step": float,
     "nnz_per_s": float, "efficiency_vs_1proc": float|null,
     "arcs": int, "k": int, "ndev": int, "meaningful": false}
"""

import argparse
import json
import os
import subprocess
import sys
import time

# the package root (scripts/ is one level down); workers are spawned with
# this on PYTHONPATH so the artifact runs from any cwd without installation
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def _env():
    e = dict(os.environ)
    e["JAX_PLATFORMS"] = "cpu"
    e["PYTHONPATH"] = _ROOT + os.pathsep + e.get("PYTHONPATH", "")
    return e


def worker(args) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.devices_per_process)
    if args.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    import numpy as np

    from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
    from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh

    inst = generate_mcf_instance(args.arcs, rho=3, instance_id=1)
    m, p = inst.num_arcs, inst.num_nodes
    n = m + p
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n).astype(np.float32)
    ndev = len(jax.devices())
    mesh = make_mesh(ndev)
    nnz = 5 * m
    out = {}

    def timed(run):
        jax.block_until_ready(run())  # compile
        t0 = time.perf_counter()
        reps = max(args.reps, 1)
        for _ in range(reps):
            jax.block_until_ready(run())
        return (time.perf_counter() - t0) / reps

    # row partition (all-gather overlapped with the owned SpMV)
    op = ShardedSparseOperator.from_kkt_arrays(inst, mesh, dtype=np.float32)

    def run_generic():
        return op.solve_fAb(b, k=args.k, f="inv", method="two_pass", raw=True)

    t_gen = timed(run_generic)
    out["generic"] = dict(seconds_per_step=t_gen / (2 * args.k),
                          nnz_per_s=nnz * 2 * args.k / t_gen)

    if args.process_id == 0 or args.num_processes == 1:
        print("SCALING_RESULT " + json.dumps(
            dict(ndev=ndev, nproc=max(args.num_processes, 1),
                 backend=jax.default_backend(), **out)))
    if args.num_processes > 1:
        jax.distributed.shutdown()
    return 0


def orchestrate(args) -> int:
    results = {}
    for nproc in args.processes:
        if nproc == 1:
            cmd = [sys.executable, __file__, "--process-id", "0",
                   "--num-processes", "1"]
            procs = None
        else:
            cmd = None
            procs = []
            for pid in range(nproc):
                procs.append(subprocess.Popen(
                    [sys.executable, __file__,
                     "--process-id", str(pid),
                     "--num-processes", str(nproc),
                     "--coordinator", f"localhost:{args.port}",
                     "--devices-per-process",
                     str(args.devices_per_process),
                     "--arcs", str(args.arcs), "--k", str(args.k),
                     "--reps", str(args.reps)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, env=_env()))
        if procs is None:
            proc = subprocess.run(
                cmd + ["--arcs", str(args.arcs), "--k", str(args.k),
                       "--reps", str(args.reps),
                       "--devices-per-process",
                       str(args.devices_per_process)],
                capture_output=True, text=True, env=_env())
            outs = [proc.stdout]
            rc = proc.returncode
            errs = [proc.stderr]
        else:
            outs, errs, rc = [], [], 0
            for pr in procs:
                so, se = pr.communicate(timeout=args.timeout)
                outs.append(so)
                errs.append(se)
                rc |= pr.returncode
        if rc:
            sys.stderr.write("worker failure at N=%d:\n%s\n"
                             % (nproc, "\n".join(errs)[-3000:]))
            return 1
        for so in outs:
            for line in so.splitlines():
                if line.startswith("SCALING_RESULT "):
                    results[nproc] = json.loads(line.split(" ", 1)[1])
    base = results.get(min(results))
    records = []
    for nproc in sorted(results):
        d = results[nproc]["generic"]
        base_rate = base["generic"]["nnz_per_s"] if base else None
        eff = (d["nnz_per_s"] / (base_rate * nproc / min(results))
               if base_rate else None)
        records.append({
            "metric": f"scaling_generic_nproc{nproc}",
            "seconds_per_step": round(d["seconds_per_step"], 7),
            "nnz_per_s": round(d["nnz_per_s"], 1),
            "efficiency_vs_1proc": round(eff, 4) if eff else None,
            "arcs": args.arcs, "k": args.k, "ndev": results[nproc]["ndev"],
            "meaningful": False,
        })
    for rec in records:
        print(json.dumps(rec))
    note = {"note": "CPU virtual mesh: correctness-grade only — collectives"
                    " are memcpys, not a device measurement"}
    print(json.dumps(note))
    records.append(note)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({
                "command": " ".join(sys.argv),
                "host": {"physical_cores": os.cpu_count(),
                         "backend": "cpu",
                         "devices_per_process": args.devices_per_process},
                "records": records,
            }, f, indent=1)
            f.write("\n")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--coordinator", default="localhost:8476")
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--arcs", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--output", default=None,
                    help="also write the orchestrator's JSON records here")
    ap.add_argument("--port", type=int, default=8476)
    ap.add_argument("--timeout", type=int, default=900)
    args = ap.parse_args()
    if args.process_id is not None:
        return worker(args)
    return orchestrate(args)


if __name__ == "__main__":
    sys.exit(main())
