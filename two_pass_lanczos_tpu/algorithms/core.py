"""Core Lanczos recurrence, expressed as compiled scans.

The reference implements the three-term recurrence as a stateful iterator with
explicit workspace cycling (reference ``src/algorithms/mod.rs:167-341``:
``lanczos_recurrence_step`` + ``LanczosIteration`` with ``mem::swap`` vector
cycling). Under XLA the same discipline falls out of ``jax.lax.scan``: the
carry *is* the three-vector workspace, buffers are donated/reused by the
compiler, and the hot loop is compiled once regardless of ``k``.

Breakdown handling: ``lax.scan`` is fixed-length, so early termination is
expressed with a ``done`` flag carried through the scan — once ``beta`` falls
below the breakdown tolerance, every subsequent step freezes the state and
emits zeros, and ``steps_taken`` records how many steps actually executed.
This reproduces the reference's graceful-truncation semantics
(``src/algorithms/lanczos.rs:108-113``) without leaving compiled code.

Exact-replay guarantee: both passes apply the identical floating-point
sequence — ``w = A·v``; ``w -= β_prev·v_prev``; ``w -= α·v_curr``;
``v_next = w · (1/β)`` (reciprocal-multiply, not division) — so pass two's
regenerated basis is bit-identical to pass one's implicit basis, matching the
reference's ``basis_drift_fro == 0`` property (``tex/report.tex:492``,
``src/algorithms/lanczos_two_pass.rs:176-199,287-293``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "breakdown_tolerance",
    "zero_tolerance",
    "LanczosDecomposition",
    "LanczosCarry",
    "lanczos_recurrence_step",
    "make_pass_one_step",
    "pass_one_scan",
    "init_carry",
    "l2_norm",
    "f32_matmul_precision",
]


def f32_matmul_precision(fn):
    """Trace ``fn`` under ``jax.default_matmul_precision("float32")``.

    At ``Precision.DEFAULT`` a GPU runs f32 matrix products in TF32, which
    keeps ~3 decimal digits regardless of the f32 storage dtype. CPU dots
    are exact-dtype, so CPU tests cannot catch the gap. Every GEMM-heavy
    capability path (block QR recurrence, CGS2 sweeps, basis contractions)
    must trace under this decorator. f64/CPU paths are unaffected, and the
    single-vector recurrence uses elementwise products and reductions only,
    so its bit-exact replay contract is untouched.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped


def breakdown_tolerance(dtype) -> float:
    """Breakdown tolerance: ``1000 · ε`` of the *real* dtype.

    The reference hardcodes ``1000 · ε_f64`` for all field types
    (``src/algorithms/mod.rs:140-143``); we generalize to the working real
    dtype so that f32/bf16 paths detect breakdown at a meaningful scale
    (for f64 the value is identical to the reference's).
    """
    real = jnp.finfo(dtype).dtype  # finfo of complex dtype reports real eps
    return float(np.finfo(real).eps) * 1000.0


def zero_tolerance(dtype) -> float:
    """Threshold below which ``b`` is treated as the zero vector.

    Deliberately near the underflow boundary (1000x the smallest normal of
    the real dtype) rather than 1000·ε: an absolute ε-based cut would reject
    perfectly valid small-norm inputs in f32/bf16 (1000·ε_bf16 ≈ 7.8!), while
    v₁ = b/‖b‖ is well-defined for any normal-range norm. For f64 both
    thresholds accept/reject the same practical inputs as the reference's
    check (``src/algorithms/mod.rs:270-276``).
    """
    real = jnp.finfo(dtype).dtype
    return float(np.finfo(real).tiny) * 1000.0


def _real_dtype(dtype):
    return jnp.finfo(dtype).dtype


def l2_norm(x: jax.Array, reduce_sum=None) -> jax.Array:
    """L2 norm returning the real dtype of ``x`` (works for complex).

    ``reduce_sum`` finishes a partial sum across devices (e.g.
    ``lambda s: lax.psum(s, axis)`` under ``shard_map``); identity by default.
    """
    s = jnp.sum(jnp.real(x * jnp.conj(x)))
    if reduce_sum is not None:
        s = reduce_sum(s)
    return jnp.sqrt(s).astype(_real_dtype(x.dtype))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class LanczosDecomposition:
    """Scalar output of a Lanczos pass — the complete definition of T_k.

    Reference parity: ``LanczosDecomposition`` (``src/algorithms/mod.rs:94-108``)
    with fixed-shape storage:

    * ``alphas``: shape ``(k,)``; entries ``[steps_taken:]`` are zero padding.
    * ``betas``:  shape ``(k,)``; ``betas[j]`` is β_{j+1}. Valid off-diagonal
      entries of T_k are ``betas[:steps_taken-1]``; if the iteration ran the
      full ``k`` steps without breakdown, ``betas[steps_taken-1]`` holds the
      residual norm β_k (the reference discards it; we keep it because the
      Lanczos-relation property test needs β_k·v_{k+1}).
    * ``steps_taken``: int32 scalar, number of executed steps.
    * ``b_norm``: ‖b‖₂ in the real dtype.

    This object is a pytree: it can cross jit boundaries, be checkpointed, or
    be shipped between pass one and pass two arbitrarily — the same
    "cloneable capture of pass-one state" role the reference struct plays.
    """

    alphas: jax.Array
    betas: jax.Array
    steps_taken: jax.Array
    b_norm: jax.Array

    def tree_flatten(self):
        return (self.alphas, self.betas, self.steps_taken, self.b_norm), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # ---- host-side convenience accessors (concrete values only) ----
    @property
    def k_max(self) -> int:
        return int(self.alphas.shape[0])

    def steps(self) -> int:
        return int(self.steps_taken)

    def alphas_valid(self) -> np.ndarray:
        """α₁..α_steps as a NumPy array (reference ``alphas`` field)."""
        return np.asarray(self.alphas)[: self.steps()]

    def betas_valid(self) -> np.ndarray:
        """β₁..β_{steps-1} as a NumPy array (reference ``betas`` field,
        always length ``steps_taken - 1``)."""
        s = self.steps()
        return np.asarray(self.betas)[: max(s - 1, 0)]

    def beta_last(self) -> float:
        """β_steps — the final residual norm (0.0 after breakdown)."""
        s = self.steps()
        if s == 0:
            return 0.0
        return float(np.asarray(self.betas)[s - 1])


class LanczosCarry(NamedTuple):
    """Scan carry: the 3-vector workspace + progress flags."""

    v_prev: jax.Array
    v_curr: jax.Array
    beta_prev: jax.Array
    done: jax.Array  # bool scalar
    steps: jax.Array  # int32 scalar


def init_carry(b: jax.Array, b_norm: jax.Array, tol: float = None) -> LanczosCarry:
    """Initial state: v₁ = b·(1/‖b‖), v₀ = 0, β₀ = 0.

    A zero input (‖b‖ ≤ zero_tolerance) starts the scan in the ``done``
    state so that ``steps_taken == 0`` — the jit-safe encoding of the
    reference's ``InputError`` (``src/algorithms/mod.rs:270-276``);
    host-level APIs convert it back to an exception.
    """
    rdt = _real_dtype(b.dtype)
    if tol is None:
        tol = zero_tolerance(b.dtype)
    zero_b = b_norm <= jnp.asarray(tol, rdt)
    inv_norm = jnp.where(zero_b, jnp.zeros((), rdt), 1.0 / b_norm)
    v1 = b * inv_norm.astype(b.dtype)
    return LanczosCarry(
        v_prev=jnp.zeros_like(b),
        v_curr=v1,
        beta_prev=jnp.zeros((), rdt),
        done=zero_b,
        steps=jnp.zeros((), jnp.int32),
    )


def lanczos_recurrence_step(
    matvec,
    v_curr: jax.Array,
    v_prev: jax.Array,
    beta_prev: jax.Array,
    reduce_sum=None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One fully-orthogonalized recurrence step.

    Returns ``(alpha, beta, w)`` where ``w`` is the *unnormalized* next
    vector. Mirrors reference ``lanczos_recurrence_step``
    (``src/algorithms/mod.rs:167-212``) with the identical operation order:

    1. ``w = A·v_curr``                      (the dominant SpMV)
    2. ``w -= β_prev·v_prev``                (first orthogonalization)
    3. ``α = Re(v_currᴴ·w)``                 (diagonal coefficient)
    4. ``w -= α·v_curr``                     (second orthogonalization)
    5. ``β = ‖w‖₂``                          (off-diagonal coefficient)
    """
    dt = v_curr.dtype
    w = matvec(v_curr)
    w = w - beta_prev.astype(dt) * v_prev
    alpha_partial = jnp.real(jnp.vdot(v_curr, w))
    if reduce_sum is not None:
        alpha_partial = reduce_sum(alpha_partial)
    alpha = alpha_partial.astype(_real_dtype(dt))
    w = w - alpha.astype(dt) * v_curr
    beta = l2_norm(w, reduce_sum)
    return alpha, beta, w


def make_pass_one_step(matvec, dtype, *, emit_basis: bool, reduce_sum=None):
    """Scan-step factory for the pass-one recurrence.

    Shared by :func:`pass_one_scan` (single fixed-length scan) and the
    chunked early-stopping drivers (:mod:`two_pass_lanczos_tpu.algorithms
    .chunked`) so both paths execute the *identical* floating-point sequence
    — the chunked run's coefficients are bit-equal to the monolithic scan's.
    """
    tol = breakdown_tolerance(dtype)
    rdt = _real_dtype(dtype)

    def step(carry: LanczosCarry, _):
        executed = jnp.logical_not(carry.done)
        alpha, beta, w = lanczos_recurrence_step(
            matvec, carry.v_curr, carry.v_prev, carry.beta_prev, reduce_sum
        )
        breakdown = beta <= jnp.asarray(tol, rdt)
        advance = jnp.logical_and(executed, jnp.logical_not(breakdown))

        alpha_out = jnp.where(executed, alpha, jnp.zeros((), rdt))
        beta_out = jnp.where(advance, beta, jnp.zeros((), rdt))

        # v_next = w · (1/β): reciprocal-multiply to match the reference's
        # normalization exactly (``src/algorithms/mod.rs:312-316``).
        inv_beta = jnp.where(advance, 1.0 / beta, jnp.zeros((), rdt))
        v_next = w * inv_beta.astype(w.dtype)

        sel = advance
        new_carry = LanczosCarry(
            v_prev=jnp.where(sel, carry.v_curr, carry.v_prev),
            v_curr=jnp.where(sel, v_next, carry.v_curr),
            beta_prev=jnp.where(sel, beta, carry.beta_prev),
            done=jnp.logical_or(carry.done, breakdown),
            steps=carry.steps + executed.astype(jnp.int32),
        )
        if emit_basis:
            v_emit = jnp.where(executed, carry.v_curr, jnp.zeros_like(carry.v_curr))
            out = (alpha_out, beta_out, v_emit)
        else:
            out = (alpha_out, beta_out)
        return new_carry, out

    return step


def pass_one_scan(matvec, b: jax.Array, k: int, *, emit_basis: bool, reduce_sum=None):
    """Run ``k`` recurrence steps as one ``lax.scan``.

    Returns ``(decomposition, basis_or_none)`` where ``basis`` has shape
    ``(k, n)`` with row ``i`` equal to v_{i+1} (zeros beyond ``steps_taken``).

    This single function backs both the one-pass algorithm
    (``emit_basis=True`` — the O(nk) variant, reference
    ``src/algorithms/lanczos.rs:55-156``) and pass one of the two-pass
    algorithm (``emit_basis=False`` — scalars only, O(n) memory, reference
    ``src/algorithms/lanczos_two_pass.rs:65-110``).
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    b_norm = l2_norm(b, reduce_sum)
    carry0 = init_carry(b, b_norm, zero_tolerance(b.dtype))
    step = make_pass_one_step(
        matvec, b.dtype, emit_basis=emit_basis, reduce_sum=reduce_sum
    )
    carry, outs = jax.lax.scan(step, carry0, None, length=k)
    alphas, betas = outs[0], outs[1]
    decomp = LanczosDecomposition(
        alphas=alphas, betas=betas, steps_taken=carry.steps, b_norm=b_norm
    )
    basis = outs[2] if emit_basis else None
    return decomp, basis
