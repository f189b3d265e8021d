"""Forward-instability study: plain vs reorthogonalized one-pass (f32).

Beyond the reference: its report *documents* the large-k orthogonality
collapse of the plain three-term recurrence (the phenomenon behind
``src/bin/orthogonality.rs`` and the f64 requirement of
``src/bin/stability.rs``) but ships no fix. This CLI publishes the
comparison that motivates ``reorth=True`` (``algorithms/reorth.py``): per
k, the one-pass solve is run twice from the same seeded b — the plain
recurrence and the CGS2-reorthogonalized one — in the dtype where the
instability actually lives (f32; ``--dtype
f64`` reproduces the "both fine" control).

CSV schema (new artifact, guarded by ``test_results_integrity.py``)::

    k,relative_error_plain,relative_error_reorth,relative_error_selective,
    ortho_defect_plain,ortho_defect_reorth,ortho_defect_selective,
    reorth_steps_selective

where ``relative_error_*`` is vs the analytic diagonal ground truth
(f64 host arithmetic), ``ortho_defect_*`` is ``max|V·Vᵀ − I|`` over the
executed steps, and ``reorth_steps_selective`` counts the CGS2 sweeps the
ω-recurrence actually fired (out of k — the selective variant's cost
story next to its accuracy story).
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
    p.add_argument("--size", type=int, default=2000)
    p.add_argument("--k-min", type=int, default=20)
    p.add_argument("--k-max", type=int, default=400)
    p.add_argument("--k-step", type=int, default=20)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sweeps", type=int, default=2)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32",
                   help="f32 (default) exhibits the instability; f64 is the "
                        "control where both variants coincide")
    p.add_argument("--cpu", action="store_true",
                   help="pin the CPU instead of the default backend")
    p.add_argument("--output", required=True)
    return p


def main(argv=None) -> int:
    from two_pass_lanczos_tpu.experiments.common import (
        setup_cli, write_csv, log,
    )

    args = build_parser().parse_args(argv)
    setup_cli()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from two_pass_lanczos_tpu.algorithms.one_pass import pass_one_scan
    from two_pass_lanczos_tpu.algorithms.reorth import (
        pass_one_scan_reorth,
        pass_one_scan_selective,
    )
    from two_pass_lanczos_tpu.functions import padded_f_e1
    from two_pass_lanczos_tpu.models.synthetic import create_diagonal_problem

    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64
    op, eigs = create_diagonal_problem(
        args.size, args.scenario, args.function, dtype=dtype)
    rng = np.random.default_rng(args.seed)
    b_np = rng.standard_normal(args.size)
    b = jnp.asarray(b_np, dtype)

    f_scalar = np.exp if args.function == "exp" else (lambda e: 1.0 / e)
    x_true = f_scalar(eigs) * b_np
    true_norm = np.linalg.norm(x_true)

    def run(k: int, variant: str):
        sweeps_fired = 0
        if variant == "reorth":
            decomp, basis = pass_one_scan_reorth(
                op.matvec, b, k, sweeps=args.sweeps)
        elif variant == "selective":
            decomp, basis, nre = pass_one_scan_selective(
                op.matvec, b, k, sweeps=args.sweeps)
            sweeps_fired = int(nre)
        else:
            decomp, basis = pass_one_scan(op.matvec, b, k, emit_basis=True)
        y = padded_f_e1(decomp, args.function) * decomp.b_norm
        # HIGHEST so the published curves measure algorithmic error, not
        # input rounding (the default f32 dot precision is TF32 on a GPU)
        x = jnp.einsum("kn,k->n", basis, y.astype(basis.dtype),
                       precision=jax.lax.Precision.HIGHEST)
        s = int(decomp.steps_taken)
        v = np.asarray(basis, np.float64)[:s]
        defect = float(np.max(np.abs(v @ v.T - np.eye(s)))) if s else 0.0
        err = float(
            np.linalg.norm(np.asarray(x, np.float64) - x_true) / true_norm)
        return err, defect, sweeps_fired

    rows = []
    for k in range(args.k_min, args.k_max + 1, args.k_step):
        err_p, def_p, _ = run(k, "plain")
        err_r, def_r, _ = run(k, "reorth")
        err_s, def_s, nre = run(k, "selective")
        log.info("k=%d plain err=%.3e defect=%.3e | reorth err=%.3e "
                 "defect=%.3e | selective err=%.3e defect=%.3e sweeps=%d/%d",
                 k, err_p, def_p, err_r, def_r, err_s, def_s, nre, k)
        rows.append((k, err_p, err_r, err_s, def_p, def_r, def_s, nre))

    write_csv(
        args.output,
        ["k", "relative_error_plain", "relative_error_reorth",
         "relative_error_selective", "ortho_defect_plain",
         "ortho_defect_reorth", "ortho_defect_selective",
         "reorth_steps_selective"],
        rows,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
