"""Accuracy vs analytic ground truth (reference ``src/bin/stability.rs``).

Synthetic diagonal A with a controlled spectrum per (function, scenario);
b is seeded random; ground truth ``x_true_i = f(λ_i)·b_i``; both variants run
per k and the CSV schema matches ``results/accuracy_*.csv`` exactly:
``k,relative_error_standard,relative_error_two_pass,relative_solution_deviation``.

Example (reproduces ``accuracy_exp_well-conditioned.csv``)::

    python -m two_pass_lanczos_tpu.experiments.stability \
        --function exp --scenario well-conditioned --size 10000 \
        --k-min 10 --k-max 200 --k-step 10 --output accuracy.csv
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--function", choices=["exp", "inv"], required=True)
    p.add_argument(
        "--scenario", choices=["well-conditioned", "ill-conditioned"], required=True
    )
    p.add_argument("--size", type=int, default=10_000, help="problem dimension n")
    p.add_argument("--k-min", type=int, default=10)
    p.add_argument("--k-max", type=int, default=200)
    p.add_argument("--k-step", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", required=True)
    p.add_argument("--cpu-f64", action="store_true",
                   help="pin the CPU (the reference's own platform); f64 "
                        "runs on the default backend either way")
    p.add_argument("--precision", choices=["native", "df"], default="native",
                   help="'df' runs both variants through the double-float "
                        "path (algorithms/df.py) in f32 arithmetic")
    return p


def main(argv=None) -> int:
    from two_pass_lanczos_tpu.experiments.common import setup_cli, force_cpu_f64, write_csv, log

    args = build_parser().parse_args(argv)
    setup_cli()
    if args.cpu_f64:
        force_cpu_f64()
    elif args.precision == "native":
        import jax

        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    import two_pass_lanczos_tpu as tpl
    from two_pass_lanczos_tpu.models.synthetic import create_diagonal_problem

    op, eigs = create_diagonal_problem(args.size, args.scenario, args.function)
    rng = np.random.default_rng(args.seed)
    b = rng.standard_normal(args.size)
    f_scalar = np.exp if args.function == "exp" else (lambda lam: 1.0 / lam)
    x_true = f_scalar(eigs) * b
    x_true_norm = np.linalg.norm(x_true)

    if args.precision == "df":
        from two_pass_lanczos_tpu.algorithms.df import (
            DFDiagonalOperator, solve_fAb_df)

        op_df = DFDiagonalOperator.from_f64(eigs)

        def run(k, method):
            return solve_fAb_df(op_df, b, k=k, f=args.function, method=method)
    else:
        solver = (tpl.make_exp_solver() if args.function == "exp"
                  else tpl.make_inv_solver())
        b_dev = jnp.asarray(b, dtype=op.dtype)

        def run(k, method):
            fn = tpl.lanczos if method == "one_pass" else tpl.lanczos_two_pass
            return np.asarray(fn(op, b_dev, k, solver))

    rows = []
    for k in range(args.k_min, args.k_max + 1, args.k_step):
        x_std = run(k, "one_pass")
        x_2p = run(k, "two_pass")
        err_std = np.linalg.norm(x_std - x_true) / x_true_norm
        err_2p = np.linalg.norm(x_2p - x_true) / x_true_norm
        dev = np.linalg.norm(x_std - x_2p) / max(np.linalg.norm(x_std), 1e-300)
        log.info("k=%d err_std=%.3e err_2p=%.3e dev=%.3e", k, err_std, err_2p, dev)
        rows.append((k, err_std, err_2p, dev))

    write_csv(
        args.output,
        ["k", "relative_error_standard", "relative_error_two_pass",
         "relative_solution_deviation"],
        rows,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
