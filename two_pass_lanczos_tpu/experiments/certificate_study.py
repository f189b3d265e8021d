"""Error-certificate study: the Gauss–Radau bracket vs the true error.

Beyond the reference: it stores (α, β) (``src/algorithms/mod.rs:94-108``)
but ships no error estimator — its experiments measure error only against
precomputed ground truth. This CLI publishes the practical alternative:
per step j of ONE f = inv run on the SPD controlled spectrum (the
``inv / well-conditioned`` stability scenario, λ ∈ [0.1, 100]), the
rigorous Golub–Meurant bracket from the coefficients alone

    ‖b‖·√(G_s − G_j)  ≤  ‖x − x_j‖_A  ≤  ‖b‖·√(U_j − G_j)

(:func:`spectrum.a_norm_error_history`) next to the TRUE A-norm error
(computed from the analytic diagonal ground truth) and the lagged-update
*estimate* (:func:`convergence.update_norm`, the criterion users apply
when no rigorous bound exists).

CSV schema (guarded by ``test_results_integrity.py``)::

    j,lower_bound,upper_bound,true_error_a_norm,lagged_update_estimate

All error columns are ABSOLUTE A-norm quantities for the same run (divide
by ``true_error_a_norm``'s j=1 row or ‖x‖_A to normalize); the lagged
estimate is the 2-norm-based relative criterion scaled by ‖x_s‖ for
comparability (its own natural units).
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=2000)
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--lag", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", required=True)
    return p


def main(argv=None) -> int:
    from two_pass_lanczos_tpu.experiments.common import (
        log,
        setup_cli,
        write_csv,
    )

    args = build_parser().parse_args(argv)
    setup_cli()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from two_pass_lanczos_tpu.algorithms.core import pass_one_scan
    from two_pass_lanczos_tpu.convergence import update_norm
    from two_pass_lanczos_tpu.functions import host_f_tk_solve
    from two_pass_lanczos_tpu.models.synthetic import create_diagonal_problem
    from two_pass_lanczos_tpu.spectrum import a_norm_error_history

    op, eigs = create_diagonal_problem(
        args.size, "well-conditioned", "inv", dtype=jnp.float64)
    lambda_min = float(np.min(eigs))
    rng = np.random.default_rng(args.seed)
    b_np = rng.standard_normal(args.size)
    b = jnp.asarray(b_np, jnp.float64)
    x_true = b_np / eigs

    decomp, basis = pass_one_scan(op.matvec, b, args.k, emit_basis=True)
    v = np.asarray(basis, np.float64)
    alphas = np.asarray(decomp.alphas_valid(), np.float64)
    betas = np.asarray(decomp.betas_valid(), np.float64)
    b_norm = float(decomp.b_norm)
    s = int(decomp.steps_taken)

    js, lows, ups = a_norm_error_history(
        decomp, lambda_min=lambda_min, stride=args.stride)

    rows = []
    for j, lo, up in zip(js, lows, ups):
        j = int(j)
        # the step-j iterate from the shared basis: x_j = ‖b‖·V_jᵀ·y_j
        y_j = host_f_tk_solve(alphas[:j], betas[: j - 1], "inv") * b_norm
        x_j = v[:j].T @ y_j
        err = x_true - x_j
        true_a = float(np.sqrt(np.sum(eigs * err * err)))
        est = update_norm(alphas[:j], betas[: j - 1], "inv", lag=args.lag)
        est_abs = (est * float(np.linalg.norm(x_j))
                   if np.isfinite(est) else float("inf"))
        rows.append((j, float(lo), float(up), true_a, est_abs))
        log.info("j=%3d  lower=%.3e  true=%.3e  upper=%.3e  lagged=%.3e",
                 j, lo, true_a, up, est_abs)

    # the history must cover every step of the stride grid up to s-1
    assert list(js) == list(range(1, s, args.stride)), (len(js), s)
    write_csv(
        args.output,
        ["j", "lower_bound", "upper_bound", "true_error_a_norm",
         "lagged_update_estimate"],
        rows,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
