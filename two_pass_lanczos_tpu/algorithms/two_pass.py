"""Two-pass Lanczos: O(n) memory, 2k matvecs.

Reference parity: ``src/algorithms/lanczos_two_pass.rs``. Pass one runs the
recurrence keeping only scalars (``lanczos_pass_one``, reference ``:65-110``);
pass two regenerates the basis on the fly from the *stored* α/β — never
recomputing an inner product — and accumulates ``x_k = Σ y_j·v_j``
(``lanczos_pass_two_impl``, reference ``:206-309``).

The replay is numerically faithful: each reconstruction step applies exactly
the floating-point sequence of the first pass (matvec → axpy(β_prev) →
axpy(α) → reciprocal-multiply by stored β), so the regenerated basis is
bit-identical to pass one's implicit basis (reference ``tex/report.tex:492``;
``basis_drift_fro == 0`` in every published orthogonality CSV).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from two_pass_lanczos_tpu.algorithms.core import (
    LanczosDecomposition,
    pass_one_scan,
    zero_tolerance,
)
from two_pass_lanczos_tpu.operators import LinearOperator

__all__ = ["lanczos_pass_one", "lanczos_pass_two", "lanczos_pass_two_with_basis"]


def lanczos_pass_one(operator: LinearOperator, b: jax.Array, k: int) -> LanczosDecomposition:
    """First pass: k recurrence steps, vectors discarded, scalars kept.

    O(n) memory — the scan carry holds exactly three n-vectors, the direct
    analogue of the reference's ``v_prev``/``v_curr``/``work`` cycling
    (``src/algorithms/lanczos_two_pass.rs:84-102``).
    """
    decomp, _ = pass_one_scan(operator.matvec, b, k, emit_basis=False)
    return decomp


def _reconstruction_scan(
    matvec,
    b: jax.Array,
    decomposition: LanczosDecomposition,
    y_k: jax.Array,
    *,
    emit_basis: bool,
):
    """Shared pass-two scan.

    Scan step ``j`` (0-based, ``j = 0..k-2``) regenerates v_{j+2}:

        ``w = A·v_{j+1} − β_j·v_j − α_{j+1}·v_{j+1}``;  ``v_{j+2} = w·(1/β_{j+1})``

    using stored ``α_{j+1} = alphas[j]``, ``β_j = betas[j-1]`` (0 for j=0) and
    ``β_{j+1} = betas[j]``, then accumulates ``x += y[j+1]·v_{j+2}``.
    Steps with ``j ≥ steps_taken − 1`` are masked to no-ops, preserving the
    reference's truncation semantics under a fixed-length scan.

    ``y_k`` may be a single ``(k,)`` vector or a stacked ``(nf, k)`` batch —
    several matrix functions evaluated from the SAME decomposition. The
    basis regeneration (the expensive part: all the matvecs) is shared; only
    the per-step accumulate fans out, so nf functions cost k matvecs instead
    of nf·k. The regeneration arithmetic is independent of ``y``, hence each
    slice of the batched result is bit-identical to its single-``f`` run.
    """
    k = decomposition.k_max
    rdt = decomposition.alphas.dtype
    dt = b.dtype
    steps = decomposition.steps_taken

    # Zero-b is an *input* check (reference src/algorithms/mod.rs:270-276),
    # not a magnitude cutoff: gate v1 on zero_tolerance (underflow boundary),
    # exactly as core.init_carry does. Using
    # breakdown_tolerance here (1000*eps ~ 1.2e-4 in f32) silently zeroed
    # valid small-norm f32 inputs.
    tol = zero_tolerance(dt)
    b_norm = decomposition.b_norm
    zero_b = b_norm <= jnp.asarray(tol, rdt)
    inv_norm = jnp.where(zero_b, jnp.zeros((), rdt), 1.0 / b_norm)
    v1 = b * inv_norm.astype(dt)

    # y padded/masked to length k: entries >= steps contribute nothing.
    # (idx broadcasts over a leading nf axis when y_k is a (nf, k) stack.)
    idx = jnp.arange(k)
    y_full = jnp.where(idx < steps, y_k.astype(dt), jnp.zeros((), dt))

    # products, not dots: an einsum here would be a K=1 dot_general, which
    # a GPU may run in TF32 for f32
    x0 = y_full[..., 0, None] * v1

    alphas = decomposition.alphas
    betas = decomposition.betas
    beta_prevs = jnp.concatenate([jnp.zeros((1,), rdt), betas[:-1]])

    if k == 1:
        basis = v1[None, :] if emit_basis else None
        return x0, basis

    js = jnp.arange(k - 1)
    # scan iterates the leading axis: per-step y slice of shape () or (nf,)
    y_steps = jnp.moveaxis(y_full[..., 1:], -1, 0)
    xs = (alphas[: k - 1], beta_prevs[: k - 1], betas[: k - 1], y_steps, js)

    def step(carry, x):
        v_prev, v_curr, x_acc = carry
        alpha_j, beta_prev, beta_j, y_next, j = x
        active = j < steps - 1

        w = matvec(v_curr)
        w = w - beta_prev.astype(dt) * v_prev
        w = w - alpha_j.astype(dt) * v_curr
        inv_beta = jnp.where(active, 1.0 / jnp.where(beta_j > 0, beta_j, 1.0), 0.0)
        v_next = w * inv_beta.astype(dt)

        # y_next is already zero beyond `steps`, and v_next is zeroed when
        # inactive, so the accumulate is naturally masked.
        x_acc = x_acc + y_next[..., None] * v_next

        v_prev_n = jnp.where(active, v_curr, v_prev)
        v_curr_n = jnp.where(active, v_next, v_curr)
        # emitted rows beyond steps_taken are zero, matching the pass-one
        # basis convention (core.pass_one_scan)
        out = jnp.where(active, v_next, jnp.zeros_like(v_next)) \
            if emit_basis else None
        return (v_prev_n, v_curr_n, x_acc), out

    carry0 = (jnp.zeros_like(b), v1, x0)
    (_, _, x_k), vs = jax.lax.scan(step, carry0, xs)

    if emit_basis:
        basis = jnp.concatenate([v1[None, :], vs], axis=0)  # (k, n)
    else:
        basis = None
    return x_k, basis


def lanczos_pass_two(
    operator: LinearOperator,
    b: jax.Array,
    decomposition: LanczosDecomposition,
    y_k: jax.Array,
) -> jax.Array:
    """Second pass: reconstruct ``x_k = Σ y_j v_j`` with O(n) memory.

    Reference parity: ``lanczos_pass_two`` (``src/algorithms/lanczos_two_pass.rs:128``).
    """
    x_k, _ = _reconstruction_scan(operator.matvec, b, decomposition, y_k, emit_basis=False)
    return x_k


def lanczos_pass_two_with_basis(
    operator: LinearOperator,
    b: jax.Array,
    decomposition: LanczosDecomposition,
    y_k: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Second pass that additionally returns the regenerated basis (k, n).

    Test-only capability matching ``lanczos_pass_two_with_basis``
    (``src/algorithms/lanczos_two_pass.rs:149``); used by the orthogonality
    experiment and the reconstruction-stability property test.
    """
    x_k, basis = _reconstruction_scan(operator.matvec, b, decomposition, y_k, emit_basis=True)
    return x_k, basis
