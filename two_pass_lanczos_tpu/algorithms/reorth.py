"""Fully reorthogonalized one-pass Lanczos (beyond-reference capability).

The reference deliberately ships the plain three-term recurrence with no
reorthogonalization (``src/algorithms/mod.rs:167-212``; its report studies
the resulting orthogonality loss rather than fixing it). That is the right
parity choice — and it leaves the known forward-instability limit in place:
any f32 Lanczos loses orthogonality on indefinite/clustered spectra by
k ≈ 100, after which f(A)b error stagnates or grows (documented in
REPORT.md and the verify notes).

This module is the opt-in fix for the one-pass variant, where the basis is
stored anyway: classical Gram-Schmidt against the full stored basis, done
``sweeps`` times per step ("twice is enough", Kahan–Parlett — CGS2 restores
orthogonality to working precision). Expressed as a compiled scan:

* the (k, n) basis lives in the scan **carry** — XLA aliases the carry
  across iterations, so it is ONE buffer updated in place by
  ``dynamic_update_index_in_dim``, not k copies;
* each sweep is two (k, n) contractions — ``proj = conj(V)·w`` and
  ``w -= Vᵀ·proj`` — i.e. GEMVs over the *entire* fixed-shape basis.
  Rows beyond the current step are zero and contribute nothing, which
  keeps the scan body shape-static (no data-dependent slicing);
* the classical α correction folds ``proj[j]`` (the residual component
  along v_j after the explicit α·v_j subtraction) back into α, so T_k
  stays the Rayleigh–Ritz projection of A onto the *orthogonalized* basis.

Cost: 2·sweeps extra basis GEMVs per step ≈ O(k²n) total, vs O(kn) for the
plain recurrence — the standard full-reorthogonalization trade. Memory is
unchanged (the one-pass variant already stores V_k).

Not offered for the two-pass variant: pass two regenerates the basis from
(α, β) precisely so that no O(nk) state exists; reorthogonalizing would
require that state, which is exactly the one-pass variant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from two_pass_lanczos_tpu.algorithms.core import (
    LanczosCarry,
    LanczosDecomposition,
    breakdown_tolerance,
    init_carry,
    l2_norm,
    lanczos_recurrence_step,
    zero_tolerance,
)

__all__ = [
    "pass_one_scan_reorth",
    "make_pass_one_step_reorth",
    "pass_one_scan_selective",
]


def _real_dtype(dtype):
    return jnp.finfo(dtype).dtype


def make_pass_one_step_reorth(matvec, dtype, *, sweeps: int = 2,
                              reduce_sum=None):
    """Scan-step factory: plain recurrence + ``sweeps`` CGS sweeps.

    The carry is ``(LanczosCarry, basis)`` with ``basis`` of shape (k, n);
    at entry to step j rows [0, j) hold v_1..v_j and row j is written with
    v_{j+1} (= ``carry.v_curr``) before the projections, so w is
    orthogonalized against every Lanczos vector produced so far.

    ``reduce_sum`` finishes partial reductions across devices (works on the
    (k,)-shaped projection vector as well as scalars — ``lax.psum`` is
    elementwise), so the same step distributes under ``shard_map`` with the
    basis row-sharded along n.
    """
    tol = breakdown_tolerance(dtype)
    rdt = _real_dtype(dtype)

    def step(carry, j):
        lc, basis = carry
        executed = jnp.logical_not(lc.done)
        dt = lc.v_curr.dtype

        # Enter v_{j+1} into row j (frozen after breakdown/stop so later
        # projections and the emitted basis keep zeros beyond steps_taken).
        row = jnp.where(executed, lc.v_curr, basis[j])
        basis = jax.lax.dynamic_update_index_in_dim(basis, row, j, 0)

        # Identical leading FP sequence to the plain recurrence
        # (core.lanczos_recurrence_step), then the CGS sweeps before ‖w‖.
        w = matvec(lc.v_curr)
        w = w - lc.beta_prev.astype(dt) * lc.v_prev
        alpha_partial = jnp.real(jnp.vdot(lc.v_curr, w))
        if reduce_sum is not None:
            alpha_partial = reduce_sum(alpha_partial)
        alpha = alpha_partial.astype(rdt)
        w = w - alpha.astype(dt) * lc.v_curr

        for s in range(sweeps):
            # HIGHEST: DEFAULT f32 dot precision is TF32 on a GPU, which would
            # cap the orthogonality defect near 1e-3 — exactly what these
            # sweeps exist to remove. Scoped per-einsum (not a module-wide
            # context) so the plain-recurrence ops above keep their exact
            # FP sequence (core.py's bitwise contracts).
            proj = jnp.einsum("kn,n->k", jnp.conj(basis), w,
                              precision=jax.lax.Precision.HIGHEST)
            if reduce_sum is not None:
                proj = reduce_sum(proj)
            w = w - jnp.einsum("kn,k->n", basis, proj.astype(dt),
                               precision=jax.lax.Precision.HIGHEST)
            if s == 0:
                # classical correction: the residual component along v_{j+1}
                alpha = alpha + jnp.real(proj[j]).astype(rdt)

        beta = l2_norm(w, reduce_sum)
        breakdown = beta <= jnp.asarray(tol, rdt)
        advance = jnp.logical_and(executed, jnp.logical_not(breakdown))

        alpha_out = jnp.where(executed, alpha, jnp.zeros((), rdt))
        beta_out = jnp.where(advance, beta, jnp.zeros((), rdt))

        inv_beta = jnp.where(advance, 1.0 / beta, jnp.zeros((), rdt))
        v_next = w * inv_beta.astype(dt)

        new_lc = LanczosCarry(
            v_prev=jnp.where(advance, lc.v_curr, lc.v_prev),
            v_curr=jnp.where(advance, v_next, lc.v_curr),
            beta_prev=jnp.where(advance, beta, lc.beta_prev),
            done=jnp.logical_or(lc.done, breakdown),
            steps=lc.steps + executed.astype(jnp.int32),
        )
        return (new_lc, basis), (alpha_out, beta_out)

    return step


def pass_one_scan_reorth(matvec, b: jax.Array, k: int, *, sweeps: int = 2,
                         reduce_sum=None):
    """Reorthogonalized pass one: ``k`` steps as one ``lax.scan``.

    Same contract as ``pass_one_scan(..., emit_basis=True)`` — returns
    ``(decomposition, basis)`` with basis row i = v_{i+1}, zeros beyond
    ``steps_taken`` — but the emitted basis is orthonormal to working
    precision regardless of k and the (α, β) are the projections onto that
    orthonormal basis.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    b_norm = l2_norm(b, reduce_sum)
    lc0 = init_carry(b, b_norm, zero_tolerance(b.dtype))
    basis0 = jnp.zeros((k,) + b.shape, b.dtype)
    step = make_pass_one_step_reorth(
        matvec, b.dtype, sweeps=sweeps, reduce_sum=reduce_sum
    )
    (lc, basis), (alphas, betas) = jax.lax.scan(
        step, (lc0, basis0), jnp.arange(k)
    )
    decomp = LanczosDecomposition(
        alphas=alphas, betas=betas, steps_taken=lc.steps, b_norm=b_norm
    )
    return decomp, basis


# ---------------------------------------------------------------------------
# Selective reorthogonalization (Parlett–Scott / Simon ω-recurrence)
# ---------------------------------------------------------------------------

def _shift_left(x):
    return jnp.concatenate([x[1:], jnp.zeros((1,), x.dtype)])


def _shift_right(x):
    return jnp.concatenate([jnp.zeros((1,), x.dtype), x[:-1]])


def make_pass_one_step_selective(matvec, dtype, *, sweeps: int = 2,
                                 reduce_sum=None):
    """Scan-step factory: plain recurrence + CGS sweeps ONLY when the
    ω-recurrence predicts orthogonality loss above √ε.

    Simon ("Analysis of the symmetric Lanczos algorithm with
    reorthogonalization methods", 1984) showed ω_{j,i} = ⟨v_j, v_i⟩ obeys
    a computable three-term recurrence driven by (α, β) alone:

        β_j·ω_{j+1,i} = β_i·ω_{j,i+1} + (α_i − α_j)·ω_{j,i}
                        + β_{i−1}·ω_{j,i−1} − β_{j−1}·ω_{j−1,i}

    (0-based; plus an ε·‖T‖ noise floor per step). Monitoring costs O(k)
    scalar work per step; a CGS2 sweep fires only when
    max_i |ω_{j+1,i}| > √ε, and the Parlett–Scott pairing also sweeps the
    following step (a single sweep leaves the *next* vector contaminated
    through the recurrence). Between sweeps the FP sequence is IDENTICAL
    to the plain recurrence — a run that never triggers is bit-equal to
    ``pass_one_scan(emit_basis=True)``.

    The carry holds the (k, n) basis (aliased in place, as in the full-
    reorth step), the two ω rows, and the (α, β) history the recurrence
    reads. Under ``shard_map`` the ω bookkeeping is replicated scalar math;
    only the CGS projections and norms reduce via ``reduce_sum``.
    """
    tol = breakdown_tolerance(dtype)
    rdt = _real_dtype(dtype)
    eps = float(jnp.finfo(rdt).eps)
    thresh = eps**0.5

    def step(carry, j):
        lc, basis, om_prev, om_curr, ah, bh, anorm, force, nre = carry
        executed = jnp.logical_not(lc.done)
        dt = lc.v_curr.dtype
        k1 = om_curr.shape[0]  # k + 1
        idx = jnp.arange(k1)

        # Enter v_j into row j (frozen after breakdown/stop).
        row = jnp.where(executed, lc.v_curr, basis[j])
        basis = jax.lax.dynamic_update_index_in_dim(basis, row, j, 0)

        # THE plain recurrence — shared with core so "identical leading FP
        # sequence to the plain scan" holds structurally, not by keeping
        # two hand-written copies in sync.
        alpha, beta_tent, w = lanczos_recurrence_step(
            matvec, lc.v_curr, lc.v_prev, lc.beta_prev, reduce_sum)
        safe_beta = jnp.where(beta_tent > 0, beta_tent, jnp.ones((), rdt))
        anorm = jnp.maximum(
            anorm, jnp.abs(alpha) + beta_tent + lc.beta_prev)

        # ω-recurrence for i <= j-1 (+ ε·‖T‖ noise floor, conservative)
        num = (bh * _shift_left(om_curr)
               + (ah - alpha) * om_curr
               + _shift_right(bh * om_curr)
               - lc.beta_prev * om_prev)
        noise = eps * anorm / safe_beta
        # inflate the MAGNITUDE (sign-symmetric; sign(0) -> +1): the ε·‖T‖
        # rounding floor must grow |ω| regardless of its sign
        sgn = jnp.where(num < 0, -1.0, 1.0).astype(num.dtype)
        om_next = jnp.where(idx < j, num / safe_beta + sgn * noise, 0.0)
        om_trigger = jnp.max(jnp.abs(om_next)) > jnp.asarray(thresh, rdt)
        do_reorth = jnp.logical_and(
            executed, jnp.logical_or(om_trigger, force))

        def with_reorth(args):
            w_in, alpha_in, om_in = args
            w_r, alpha_r = w_in, alpha_in
            for s in range(sweeps):
                # HIGHEST for the same reason as the full-reorth sweeps:
                # bf16-class DEFAULT would floor the defect near 1e-3.
                proj = jnp.einsum("kn,n->k", jnp.conj(basis), w_r,
                                  precision=jax.lax.Precision.HIGHEST)
                if reduce_sum is not None:
                    proj = reduce_sum(proj)
                w_r = w_r - jnp.einsum("kn,k->n", basis, proj.astype(dt),
                                       precision=jax.lax.Precision.HIGHEST)
                if s == 0:
                    alpha_r = alpha_r + jnp.real(proj[j]).astype(rdt)
            # orthogonality restored to working precision for i <= j
            om_r = jnp.where(idx <= j, jnp.asarray(eps, rdt), 0.0)
            return w_r, alpha_r, om_r

        def without_reorth(args):
            return args

        w, alpha, om_next = jax.lax.cond(
            do_reorth, with_reorth, without_reorth, (w, alpha, om_next))

        # local-orthogonality levels for the two newest entries
        om_next = jnp.where(idx == j, jnp.asarray(eps, rdt), om_next)
        om_next = jnp.where(idx == j + 1, jnp.ones((), rdt), om_next)

        beta = jax.lax.cond(do_reorth, lambda w_: l2_norm(w_, reduce_sum),
                            lambda _: beta_tent, w)
        breakdown = beta <= jnp.asarray(tol, rdt)
        advance = jnp.logical_and(executed, jnp.logical_not(breakdown))

        alpha_out = jnp.where(executed, alpha, jnp.zeros((), rdt))
        beta_out = jnp.where(advance, beta, jnp.zeros((), rdt))

        inv_beta = jnp.where(advance, 1.0 / beta, jnp.zeros((), rdt))
        v_next = w * inv_beta.astype(dt)

        new_lc = LanczosCarry(
            v_prev=jnp.where(advance, lc.v_curr, lc.v_prev),
            v_curr=jnp.where(advance, v_next, lc.v_curr),
            beta_prev=jnp.where(advance, beta, lc.beta_prev),
            done=jnp.logical_or(lc.done, breakdown),
            steps=lc.steps + executed.astype(jnp.int32),
        )
        ah = jnp.where(idx == j, alpha_out, ah)
        bh = jnp.where(idx == j, beta_out, bh)
        new_carry = (
            new_lc, basis, jnp.where(executed, om_curr, om_prev),
            jnp.where(executed, om_next, om_curr), ah, bh, anorm,
            # Parlett–Scott pairing: an ω-triggered sweep forces one more
            # at the next step; a forced sweep does not re-force.
            jnp.logical_and(executed, om_trigger),
            nre + do_reorth.astype(jnp.int32),
        )
        return new_carry, (alpha_out, beta_out)

    return step


def pass_one_scan_selective(matvec, b: jax.Array, k: int, *,
                            sweeps: int = 2, reduce_sum=None):
    """Selectively reorthogonalized pass one: ``k`` steps as one scan.

    Same contract as :func:`pass_one_scan_reorth` — returns
    ``(decomposition, basis, reorth_steps)`` where ``reorth_steps`` (an
    int32 scalar array) counts the steps on which a CGS sweep actually
    fired: 0 on well-behaved spectra (then the run is bit-identical to the
    plain recurrence), up to k when the spectrum forces full
    reorthogonalization. Semi-orthogonality (defect ≲ √ε) is maintained
    throughout, which is the Simon condition for (α, β) to be accurate to
    working precision.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    b_norm = l2_norm(b, reduce_sum)
    lc0 = init_carry(b, b_norm, zero_tolerance(b.dtype))
    basis0 = jnp.zeros((k,) + b.shape, b.dtype)
    rdt = _real_dtype(b.dtype)
    om0 = jnp.zeros((k + 1,), rdt).at[0].set(1.0)  # ω_{0,0} = 1
    carry0 = (
        lc0, basis0, jnp.zeros((k + 1,), rdt), om0,
        jnp.zeros((k + 1,), rdt), jnp.zeros((k + 1,), rdt),
        jnp.zeros((), rdt), jnp.asarray(False),
        jnp.zeros((), jnp.int32),
    )
    step = make_pass_one_step_selective(
        matvec, b.dtype, sweeps=sweeps, reduce_sum=reduce_sum)
    carry, (alphas, betas) = jax.lax.scan(step, carry0, jnp.arange(k))
    lc = carry[0]
    decomp = LanczosDecomposition(
        alphas=alphas, betas=betas, steps_taken=lc.steps, b_norm=b_norm)
    return decomp, carry[1], carry[8]
