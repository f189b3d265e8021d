"""Basis-stability study (reference ``src/bin/orthogonality.rs``).

Uses the low-level API: ``lanczos_standard`` for the stored basis V_k and the
basis-returning second pass for the regenerated V′_k (dummy y_k of ones,
reference ``orthogonality.rs:190-197``). Metrics and CSV schema match
``results/orthogonality_*.csv``:
``k,ortho_loss_standard,ortho_loss_regenerated,basis_drift_fro,solution_deviation_l2``.
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
    p.add_argument("--size", type=int, default=10_000)
    p.add_argument("--k-min", type=int, default=20)
    p.add_argument("--k-max", type=int, default=1000)
    p.add_argument("--k-step", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", required=True)
    p.add_argument("--cpu-f64", action="store_true",
                   help="pin the CPU (the reference's own platform); f64 "
                        "runs on the default backend either way")
    return p


def main(argv=None) -> int:
    from two_pass_lanczos_tpu.experiments.common import setup_cli, force_cpu_f64, write_csv, log

    args = build_parser().parse_args(argv)
    setup_cli()
    if args.cpu_f64:
        force_cpu_f64()
    else:
        import jax

        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    import two_pass_lanczos_tpu as tpl
    from two_pass_lanczos_tpu.algorithms.two_pass import lanczos_pass_two_with_basis
    from two_pass_lanczos_tpu.models.synthetic import create_diagonal_problem

    op, _ = create_diagonal_problem(args.size, args.scenario, args.function)
    rng = np.random.default_rng(args.seed)
    b = jnp.asarray(rng.standard_normal(args.size), dtype=op.dtype)

    rows = []
    for k in range(args.k_min, args.k_max + 1, args.k_step):
        decomp, v_std = tpl.lanczos_standard(op, b, k)
        s = decomp.steps()
        y_dummy = jnp.ones((k,), dtype=op.dtype)
        x_std, _ = _solution_from_basis(v_std, y_dummy)
        x_regen, v_regen = lanczos_pass_two_with_basis(op, b, decomp, y_dummy)

        vs = np.asarray(v_std)[:s]
        vr = np.asarray(v_regen)[:s]
        eye = np.eye(s)
        ortho_std = np.linalg.norm(eye - vs @ vs.T)
        ortho_regen = np.linalg.norm(eye - vr @ vr.T)
        drift = np.linalg.norm(vs - vr)
        sol_dev = np.linalg.norm(np.asarray(x_std) - np.asarray(x_regen))
        log.info("k=%d ortho=%.3e drift=%.3e", k, ortho_std, drift)
        rows.append((k, ortho_std, ortho_regen, drift, sol_dev))

    write_csv(
        args.output,
        ["k", "ortho_loss_standard", "ortho_loss_regenerated", "basis_drift_fro",
         "solution_deviation_l2"],
        rows,
    )
    return 0


def _solution_from_basis(v_k, y):
    # HIGHEST so the measured curves reflect algorithmic error, not input
    # rounding (on a GPU the default f32 dot precision is TF32)
    import jax
    import jax.numpy as jnp

    x = jnp.einsum("kn,k->n", v_k, y.astype(v_k.dtype),
                   precision=jax.lax.Precision.HIGHEST)
    return x, None


if __name__ == "__main__":
    raise SystemExit(main())
