"""Block Lanczos: f(A)·B for a block of right-hand sides, one shared space.

The reference iterates a single vector (``src/algorithms/mod.rs:167-212``);
:func:`slq.lanczos_pass_one_batched` already batches INDEPENDENT
recurrences. This module adds the genuinely coupled variant: one block
Krylov space K_k(A, B) = span{B, AB, …, A^{k−1}B} with B ∈ 𝔽^{n×p}
(𝔽 = ℝ or ℂ; A self-adjoint, like the single-vector paths),

    A·V_j = V_{j−1}·B_{j−1}ᴴ + V_j·A_j + V_{j+1}·B_j

(V_j orthonormal n×p blocks; A_j Hermitian p×p; B_j upper-triangular
with real positive diagonal from the QR of the residual block). What it
buys over p independent runs:

* **clustered/degenerate spectra**: a block of width p resolves
  eigenvalue multiplicities ≤ p that a single-vector Krylov space is
  blind to — fewer block steps than the worst single-vector k;
* **matmul shape**: every update is an (n, p)×(p, p) or (p, n)×(n, p)
  matmul and the matvec runs on a whole block — tall-skinny matmuls use
  an accelerator far better than p separate GEMV streams;
* **shared matvec stream**: sparse A is read once per block step for all
  p vectors.

Structure: the whole pass is one ``lax.scan``; the basis blocks
(k, n, p) live in the scan outputs; the p×p QR per step is
``jnp.linalg.qr`` (tiny, device-side). Breakdown = the residual block
dropping rank: detected via min |diag R| ≤ 1000·ε·‖·‖ (the library's
breakdown convention scaled to blocks) and handled the library way —
graceful truncation via a done flag (no in-jit exception), full-rank
steps only. Partial-rank deflation is out of scope (documented).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from two_pass_lanczos_tpu.algorithms.core import (
    breakdown_tolerance,
    f32_matmul_precision,
)
from two_pass_lanczos_tpu.operators import LinearOperator

__all__ = ["BlockDecomposition", "block_pass_one", "block_pass_two",
           "block_padded_f_e1", "solve_fAb_block", "solve_fAb_block_jit"]

FSpec = Union[str, Callable[[np.ndarray], np.ndarray]]


class BlockDecomposition(NamedTuple):
    """Block tridiagonal T_k and bookkeeping (fixed shapes, jit-safe).

    * ``a_blocks`` — (k, p, p) diagonal blocks A_j (Hermitian; real
      symmetric in the real case), zeros beyond ``steps_taken``.
    * ``b_blocks`` — (k, p, p) sub-diagonal blocks B_j (upper-triangular;
      ``b_blocks[j]`` couples block j and j+1). ``b_blocks[steps-1]`` is
      the final residual R like the single-vector convention keeps β_k.
    * ``r0`` — (p, p) upper-triangular factor of the initial QR, B = V₁·r0
      (the block analogue of ‖b‖).
    * ``steps_taken`` — int32 scalar, number of full-rank block steps.
    """

    a_blocks: jax.Array
    b_blocks: jax.Array
    r0: jax.Array
    steps_taken: jax.Array


def _adj(m):
    """Conjugate transpose (the adjoint). On real arrays ``conj`` is the
    identity and XLA elides it — the real path's FP sequence is
    unchanged."""
    return jnp.conj(m).T


def _r_pos(w):
    """The R factor of the reduced QR with a POSITIVE (real) diagonal —
    makes the factorization unique and the p = 1 case equal to the β > 0
    normalization of the single-vector recurrence. Only R is needed: the
    next block is formed as ``W·R⁻¹`` (a triangular solve), NOT as QR's Q,
    so that pass two can replay the identical instruction sequence from
    the stored R (the block analogue of the single-vector
    reciprocal-multiply convention, ``src/algorithms/mod.rs:312-316``).

    Complex case: each row is rotated by the conjugate phase of its
    diagonal entry (the unit-modulus analogue of the sign flip), leaving
    a real positive diagonal; on real inputs the phase IS the sign and
    the multiply is the same exact ±1 scaling as before."""
    r = jnp.linalg.qr(w, mode="r")
    d = jnp.diagonal(r)
    mag = jnp.abs(d)
    safe = jnp.where(mag == 0, jnp.ones_like(mag), mag)
    phase = jnp.where(mag == 0, jnp.ones_like(d), d / safe.astype(d.dtype))
    return jnp.conj(phase)[:, None] * r


def _right_tri_solve(w, r):
    """``W·R⁻¹`` for upper-triangular R — the block normalization.
    Uses the algebraic transpose (X·R = W ⇔ Rᵀ·Xᵀ = Wᵀ), valid over
    ℝ and ℂ alike — no conjugation enters."""
    from jax.scipy.linalg import solve_triangular

    return solve_triangular(r.T, w.T, lower=True).T


def _block_recurrence_body(block_mv, v_prev, v_curr, b_prev):
    """One block orthogonalization: shared VERBATIM by pass one and pass
    two so the replay's FP sequence is identical by construction (the
    block analogue of ``core.make_pass_one_step`` backing both passes).

    Self-adjoint-generic: projections are adjoints (``VᴴW``), the
    recurrence subtracts ``V_{j−1}·B_{j−1}ᴴ``, and the Ritz block is
    Hermitian-symmetrized — on real inputs every ``conj`` folds away.

    Returns ``(w, a_j)`` — the unnormalized next block and the diagonal
    projection block (Hermitian-symmetrized, CGS-corrected)."""
    w = block_mv(v_curr)
    w = w - v_prev @ _adj(b_prev)
    a_j = _adj(v_curr) @ w
    a_j = 0.5 * (a_j + _adj(a_j))  # exact Hermitian-symmetry of the Ritz block
    w = w - v_curr @ a_j
    # one CGS re-sweep against the two live blocks keeps local block
    # orthogonality at working precision (the block analogue of the
    # classical correction; cheap: four p×p GEMMs)
    c_prev = _adj(v_prev) @ w
    c_curr = _adj(v_curr) @ w
    w = w - v_prev @ c_prev - v_curr @ c_curr
    a_j = a_j + 0.5 * (c_curr + _adj(c_curr))
    return w, a_j


@f32_matmul_precision
def block_pass_one(matvec, b_block: jax.Array, k: int, *,
                   emit_basis: bool = True):
    """``k`` block recurrence steps as one ``lax.scan``.

    ``matvec`` maps (n,) → (n,) (vmapped internally over the block).
    Returns ``(BlockDecomposition, basis)`` with ``basis`` of shape
    (k, n, p), block row j = V_{j+1}, zeros beyond ``steps_taken`` —
    or ``basis=None`` with ``emit_basis=False`` (O(n·p) memory, pass one
    of the two-pass variant). A rank-deficient initial B (or zero B)
    yields ``steps_taken == 0``.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    if b_block.ndim != 2:
        raise ValueError(f"b_block must be (n, p), got shape {b_block.shape}")
    n, p = b_block.shape
    if p < 1 or p > n:
        raise ValueError(f"block width p={p} must be in [1, n={n}]")
    rdt = b_block.dtype
    tol = breakdown_tolerance(rdt)

    def block_mv(v):  # (n, p) -> (n, p)
        return jax.vmap(matvec, in_axes=1, out_axes=1)(v)

    def rank_ok(r, ref_scale):
        # RELATIVE rank test: smallest QR diagonal vs the larger of the
        # factor's own scale and the reference scale. No absolute floor —
        # an ε-absolute cut would reject perfectly valid small-norm blocks
        # in f32/bf16 (the zero_tolerance rationale, core.py). A zero
        # block gives scale 0 and is rejected (min 0 > 0 is false).
        diag = jnp.abs(jnp.diagonal(r))
        scale = jnp.maximum(jnp.max(diag), ref_scale)
        return jnp.min(diag) > tol * scale

    r0 = _r_pos(b_block)
    # real dtype: the rank test compares |diag| magnitudes
    from two_pass_lanczos_tpu.algorithms.core import _real_dtype

    ok0 = rank_ok(r0, jnp.zeros((), _real_dtype(rdt)))
    v0 = jnp.where(ok0, _right_tri_solve(b_block, r0), 0.0)

    def step(carry, _):
        v_prev, v_curr, b_prev, done, steps = carry
        executed = jnp.logical_not(done)
        w, a_j = _block_recurrence_body(block_mv, v_prev, v_curr, b_prev)
        b_j = _r_pos(w)
        full_rank = rank_ok(b_j, jnp.max(jnp.abs(jnp.diagonal(a_j))))
        advance = jnp.logical_and(executed, full_rank)
        safe_b = jnp.where(full_rank, b_j, jnp.eye(p, dtype=rdt))
        v_next = _right_tri_solve(w, safe_b)

        a_out = jnp.where(executed, a_j, jnp.zeros_like(a_j))
        b_out = jnp.where(advance, b_j, jnp.zeros_like(b_j))
        v_out = (jnp.where(executed, v_curr, jnp.zeros_like(v_curr))
                 if emit_basis else jnp.zeros((0,), rdt))

        sel = advance
        carry = (
            jnp.where(sel, v_curr, v_prev),
            jnp.where(sel, v_next, v_curr),
            jnp.where(sel, b_j, b_prev),
            jnp.logical_or(done, jnp.logical_not(full_rank)),
            steps + executed.astype(jnp.int32),
        )
        return carry, (a_out, b_out, v_out)

    carry0 = (jnp.zeros_like(v0), v0, jnp.zeros((p, p), rdt),
              jnp.logical_not(ok0), jnp.zeros((), jnp.int32))
    carry, (a_blocks, b_blocks, basis) = jax.lax.scan(
        step, carry0, None, length=k)
    decomp = BlockDecomposition(
        a_blocks=a_blocks, b_blocks=b_blocks,
        r0=jnp.where(ok0, r0, jnp.zeros_like(r0)), steps_taken=carry[4])
    return decomp, (basis if emit_basis else None)


@f32_matmul_precision
def block_pass_two(matvec, b_block: jax.Array, decomp: BlockDecomposition,
                   y_blocks: jax.Array, *, emit_basis: bool = False):
    """Regenerate the block basis from the stored decomposition and
    accumulate ``X = Σ_j V_{j+1}·Y_j`` — O(n·p) memory, no stored basis.

    The two-pass contract, block edition: pass one normalizes with
    ``W·R⁻¹`` (triangular solve against the SAME R stored in
    ``b_blocks``), so this replay executes the same operation sequence.
    Honest caveat vs the single-vector drift == 0 guarantee: the two
    passes are separately compiled programs, and XLA's scheduling of the
    (n, p)×(p, p) GEMMs is not bitwise-reproducible across programs (the
    single-vector path's scalar reductions are) — measured drift is
    ≤ ~1 ulp/step, pinned at ≤ 1e-12 absolute over 25 f64 steps
    (``tests/test_block.py::test_pass_two_replay_matches_pass_one``).
    Like the single-vector pass two
    (``src/algorithms/lanczos_two_pass.rs``), the QR factorizations are
    NOT recomputed; the p×p projections are (they feed the replayed
    orthogonalization).

    ``y_blocks`` has shape (k, p, q) — q solution columns per basis block
    (q = p for f(A)·B). Returns ``x`` of shape (n, q), plus the
    regenerated basis when ``emit_basis=True`` (testing hook).
    """
    n, p = b_block.shape
    rdt = b_block.dtype
    steps = decomp.steps_taken

    def block_mv(v):
        return jax.vmap(matvec, in_axes=1, out_axes=1)(v)

    r0 = decomp.r0
    ok0 = steps > 0
    safe_r0 = jnp.where(ok0, r0, jnp.eye(p, dtype=rdt))
    v0 = jnp.where(ok0, _right_tri_solve(b_block, safe_r0), 0.0)

    def step(carry, inputs):
        v_prev, v_curr, b_prev, x_acc = carry
        j, b_j, y_j = inputs
        executed = j < steps
        x_acc = x_acc + jnp.where(
            executed, v_curr @ y_j.astype(rdt), jnp.zeros_like(x_acc))
        emit = (jnp.where(executed, v_curr, jnp.zeros_like(v_curr))
                if emit_basis else jnp.zeros((0,), rdt))
        w, _ = _block_recurrence_body(block_mv, v_prev, v_curr, b_prev)
        advance = j + 1 < steps  # the final block needs no successor
        safe_b = jnp.where(advance, b_j, jnp.eye(p, dtype=rdt))
        v_next = _right_tri_solve(w, safe_b)
        carry = (
            jnp.where(advance, v_curr, v_prev),
            jnp.where(advance, v_next, v_curr),
            jnp.where(advance, b_j, b_prev),
            x_acc,
        )
        return carry, emit

    q = y_blocks.shape[-1]
    carry0 = (jnp.zeros_like(v0), v0, jnp.zeros((p, p), rdt),
              jnp.zeros((n, q), rdt))
    k = decomp.a_blocks.shape[0]
    (_, _, _, x), emitted = jax.lax.scan(
        step, carry0, (jnp.arange(k), decomp.b_blocks, y_blocks))
    if emit_basis:
        return x, emitted
    return x


def _assemble_t(decomp: BlockDecomposition) -> np.ndarray:
    """Dense (s·p, s·p) Hermitian block tridiagonal on the host
    (s = steps); f64 for real decompositions, c128 for complex."""
    s = int(decomp.steps_taken)
    p = decomp.r0.shape[0]
    cdt = (np.complex128 if np.iscomplexobj(np.asarray(decomp.a_blocks))
           else np.float64)
    a = np.asarray(decomp.a_blocks, cdt)
    b = np.asarray(decomp.b_blocks, cdt)
    t = np.zeros((s * p, s * p), cdt)
    for j in range(s):
        t[j * p:(j + 1) * p, j * p:(j + 1) * p] = a[j]
        if j + 1 < s:
            # A V_j = ... + V_{j+1} B_j  =>  T[j+1, j] block = B_j
            t[(j + 1) * p:(j + 2) * p, j * p:(j + 1) * p] = b[j]
            t[j * p:(j + 1) * p, (j + 1) * p:(j + 2) * p] = b[j].conj().T
    return t


@f32_matmul_precision
def solve_fAb_block(
    operator: LinearOperator, b_block, k: int, f: FSpec = "exp",
    method: str = "one_pass",
) -> jax.Array:
    """``f(A)·B`` for B of shape (n, p) from ONE block Krylov space:
    x = V_k · f(T_k) · E₁ · R₀ with E₁ the first block column.

    k block steps = k shared (block) matvecs for all p RHS — and, unlike
    the vmapped independent runs, multiplicity-p eigenvalue clusters are
    resolved. The projected f(T_k) is evaluated host-side in f64 via the
    dense eigendecomposition of the (s·p, s·p) block tridiagonal (s·p is
    small), the same division of labor as the host solvers. Zero or
    rank-deficient B returns zeros (the library's graceful convention).

    ``method``: ``"one_pass"`` stores the (k, n, p) basis and contracts
    once; ``"two_pass"`` stores only the (k, p, p) coefficient blocks and
    replays the basis (O(n·p) memory, 2k block matvecs) — the library's
    namesake memory/time trade, block edition. The replay matches pass
    one to working precision (~1 ulp/step — see :func:`block_pass_two`;
    the single-vector path's bitwise drift == 0 guarantee does not
    extend to separately compiled GEMM programs).
    """
    from two_pass_lanczos_tpu.spectrum import _f_of_theta  # shared dispatch

    if method not in ("one_pass", "two_pass"):
        raise ValueError(f"unknown method {method!r}")
    if not callable(f):
        _f_of_theta(np.ones(1), f)  # reject unknown strings before any work
    b_block = jnp.asarray(b_block)
    emit = method == "one_pass"
    decomp, basis = block_pass_one(operator.matvec, b_block, k,
                                   emit_basis=emit)
    s = int(decomp.steps_taken)
    if s == 0:
        return jnp.zeros_like(b_block)
    p = b_block.shape[1]
    t = _assemble_t(decomp)
    lam, q = np.linalg.eigh(t)
    flam = _f_of_theta(lam, f)
    e1 = np.zeros((s * p, p))
    e1[:p, :p] = np.eye(p)
    y = (q * flam) @ (q.conj().T @ (e1 @ np.asarray(decomp.r0, t.dtype)))
    y_pad = np.zeros((k, p, p), t.dtype)
    y_pad[:s] = y.reshape(s, p, p)
    y_dev = jnp.asarray(y_pad, b_block.dtype)
    if method == "two_pass":
        return block_pass_two(operator.matvec, b_block, decomp, y_dev)
    return jnp.einsum("knp,kpq->nq", basis[:s], y_dev[:s])


@f32_matmul_precision
def block_padded_f_e1(decomp: BlockDecomposition, f: FSpec) -> jax.Array:
    """Fully-jittable ``Y = f(T_pad)·E₁·R₀`` on the padded block
    decomposition — the block analogue of :func:`functions.padded_f_e1`.

    Identity padding beyond ``steps_taken`` makes T_pad block-diagonal
    ``[T_s, I]``; E₁ lives entirely in the leading block, so the padded
    rows of Y are EXACT zeros and breakdown costs no accuracy. The
    (k·p, k·p) eigendecomposition runs device-side in the working dtype
    (the jittable trade — the host :func:`solve_fAb_block` evaluates the
    projected solve in f64). Returns shape ``(k, p, p)``.
    """
    a = decomp.a_blocks
    bb = decomp.b_blocks
    k, p, _ = a.shape
    steps = decomp.steps_taken
    cdt = a.dtype
    jj = jnp.arange(k)
    a_pad = jnp.where((jj < steps)[:, None, None], a, jnp.eye(p, dtype=cdt))
    # sub-diagonal block j couples blocks j and j+1: valid while j+1 < s
    b_pad = jnp.where((jj + 1 < steps)[:, None, None], bb,
                      jnp.zeros_like(bb))
    t4 = jnp.zeros((k, p, k, p), cdt)
    ar = jnp.arange(k)
    t4 = t4.at[ar, :, ar, :].set(a_pad)
    if k > 1:
        ar1 = jnp.arange(k - 1)
        sub = b_pad[: k - 1]
        t4 = t4.at[ar1 + 1, :, ar1, :].set(sub)
        t4 = t4.at[ar1, :, ar1 + 1, :].set(
            jnp.conj(jnp.swapaxes(sub, 1, 2)))
    t = t4.reshape(k * p, k * p)
    lam, q = jnp.linalg.eigh(t)
    from two_pass_lanczos_tpu.slq import _f_of_theta as _f_dev

    flam = _f_dev(lam, f).astype(lam.dtype)
    e1r0 = jnp.zeros((k * p, p), cdt).at[:p].set(decomp.r0)
    y = ((q * flam) @ (jnp.conj(q).T @ e1r0)).reshape(k, p, p)
    # explicit mask (guards against eigensolver noise on degenerate pads)
    return jnp.where((jj < steps)[:, None, None], y, jnp.zeros((), y.dtype))


@f32_matmul_precision
def solve_fAb_block_jit(
    operator: LinearOperator, b_block, *, k: int, f: FSpec = "exp",
    method: str = "one_pass",
) -> jax.Array:
    """Fully-jittable ``f(A)·B`` — the block analogue of
    :func:`solvers.solve_fAb`: fixed shapes end-to-end, safe inside
    larger jitted programs (the host-orchestrated
    :func:`solve_fAb_block` evaluates the tiny projected solve in f64
    instead — the same division of labor as the single-vector pair).
    """
    if method not in ("one_pass", "two_pass"):
        raise ValueError(f"unknown method {method!r}")
    if not callable(f):
        from two_pass_lanczos_tpu.spectrum import _f_of_theta

        _f_of_theta(np.ones(1), f)  # reject unknown strings before any work
    b_block = jnp.asarray(b_block)
    emit = method == "one_pass"
    decomp, basis = block_pass_one(operator.matvec, b_block, k,
                                   emit_basis=emit)
    y = block_padded_f_e1(decomp, f)
    if emit:
        return jnp.einsum("knp,kpq->nq", basis, y.astype(basis.dtype))
    return block_pass_two(operator.matvec, b_block, decomp,
                          y.astype(b_block.dtype))
