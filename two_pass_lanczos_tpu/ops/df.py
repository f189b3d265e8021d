"""Double-float (two-float) arithmetic: near-f64 precision from f32 hardware.

SURVEY §7 hard part 5: where native f64 is unavailable or emulated, the
high-precision path represents every value as an unevaluated sum
``hi + lo`` of two f32 (a "double-float", ~49-bit effective mantissa vs
f64's 53) and computes with error-free transformations:

* ``two_sum``   — Knuth's branch-free exact addition (6 flops);
* ``two_prod``  — compensated product via a 12-bit MANTISSA-MASK split
  (integer ops; every partial product of the split pieces is exact in f32,
  making the transform immune to the compiler's FMA contraction — see
  :func:`_split` for why Dekker's multiplicative split cannot be used);
* ``df_*``      — double-float add/mul/div/sqrt built on those (Dekker 1971,
  Bailey's ddfun conventions).

All operations are elementwise code — branch-free, fully jittable,
shardable under ``shard_map`` — and are safe under XLA because XLA does not
reassociate floating-point arithmetic (the transformations depend on exact
IEEE f32 rounding of each step).

Used by :mod:`two_pass_lanczos_tpu.algorithms.df` (compensated Lanczos pass,
validated against the CPU f64 oracle).

Representation: a pair ``(hi, lo)`` of equal-shape f32 arrays with
``|lo| <= ulp(hi)/2`` (normalized). Matrix data originating in f64 is split
exactly via :func:`df_from_f64`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "DF",
    "two_sum",
    "fast_two_sum",
    "two_prod",
    "df_from_f64",
    "df_to_f64",
    "df_zeros_like",
    "df_add",
    "df_add_f32",
    "df_sub",
    "df_neg",
    "df_mul",
    "df_mul_f32",
    "df_div",
    "df_sqrt",
    "df_sum",
    "df_dot",
    "df_norm",
]

def _ob(x):
    """Optimization barrier guarding error-free transformations.

    XLA's algebraic simplifier applies non-IEEE-exact reassociations like
    ``(a + b) - a → b`` and ``e - ((s + e) - s) → 0`` in some fusion
    contexts (observed on CPU with scalar/broadcast operands: it zeroed the
    ``fast_two_sum`` error term, silently degrading double-float results to
    ~f32 accuracy). Every EFT intermediate that could complete such a
    pattern is routed through ``lax.optimization_barrier`` so the rewrite
    cannot see it. The barrier emits no computation — it only pins the
    value. Pinned by ``tests/test_df.py::test_eft_survives_jit_fusion``.
    """
    return jax.lax.optimization_barrier(x)


class DF(NamedTuple):
    """A double-float value/array: the unevaluated exact sum ``hi + lo``."""

    hi: jax.Array
    lo: jax.Array


def two_sum(a, b) -> Tuple[jax.Array, jax.Array]:
    """Exact addition: returns (s, e) with s = fl(a+b) and a+b = s+e."""
    s = _ob(a + b)
    bb = _ob(s - a)
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b) -> Tuple[jax.Array, jax.Array]:
    """Exact addition assuming |a| >= |b| (3 flops)."""
    s = _ob(a + b)
    e = b - (s - a)
    return s, e


def _split(a):
    """Split ``a`` into a 12-bit-significand head and a ≤12-bit tail by
    MASKING the low 12 mantissa bits (integer ops).

    Why not Veltkamp's ``t = 4097·a; hi = t − (t − a)``: XLA CPU's LLVM
    backend contracts mul→sub chains into FMAs *per use site* (fusion
    duplicates expressions), so a rounded product can be observed unrounded
    by one consumer and rounded by another — which silently breaks any EFT
    whose algebra depends on ``fl(x·y)`` (measured: two-float results
    degraded to ~f32). Masking uses no FP rounding at all, so no compiler
    transform can perturb it, and every partial product of two 12-bit heads
    or tails is EXACT in f32 (≤24-bit results) — making the whole
    ``two_prod`` immune to FMA contraction."""
    bits = jax.lax.bitcast_convert_type(a, jnp.int32)
    hi = jax.lax.bitcast_convert_type(
        jnp.bitwise_and(bits, jnp.int32(-4096)), jnp.float32)  # ~0xFFF
    return hi, a - hi


def two_prod(a, b) -> Tuple[jax.Array, jax.Array]:
    """Compensated multiplication: returns (p, e) with p + e = a·b up to
    O(2⁻⁴⁸)·|a·b| (the two roundings in the tail recombination; all four
    partial products are exact — see :func:`_split`). FMA-contraction-proof
    by construction."""
    ah, al = _split(a)
    bh, bl = _split(b)
    p0 = ah * bh  # exact: 12b × 12b
    t1 = ah * bl  # exact
    t2 = al * bh  # exact
    r2 = al * bl  # exact
    s1, e1 = two_sum(t1, t2)
    s2, e2 = two_sum(p0, s1)
    return fast_two_sum(s2, (e1 + e2) + r2)


# ---------------------------------------------------------------------------
# Construction / conversion
# ---------------------------------------------------------------------------

def df_from_f64(x) -> DF:
    """Split f64 (NumPy, host) data exactly into (hi, lo) f32 pairs."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DF(jnp.asarray(hi), jnp.asarray(lo))


def df_to_f64(x: DF) -> np.ndarray:
    """Recombine to f64 on the host (for validation against the oracle)."""
    return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)


def df_zeros_like(x) -> DF:
    z = jnp.zeros_like(x if not isinstance(x, DF) else x.hi)
    return DF(z, z)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

def df_add(x: DF, y: DF) -> DF:
    """Double-float addition (Knuth 2Sum based, ~20 flops)."""
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = fast_two_sum(s, e)
    e = e + f
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_add_f32(x: DF, a) -> DF:
    s, e = two_sum(x.hi, a)
    e = e + x.lo
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_mul_f32(x: DF, a) -> DF:
    p, e = two_prod(x.hi, a)
    e = e + x.lo * a
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_div(x: DF, y: DF) -> DF:
    """Double-float division (one Newton correction on the f32 quotient)."""
    q1 = x.hi / y.hi
    r = df_add(x, df_neg(df_mul_f32(y, q1)))
    q2 = r.hi / y.hi
    r2 = df_add(r, df_neg(df_mul_f32(y, q2)))
    q3 = r2.hi / y.hi
    s, e = two_sum(q1, q2)
    e = e + q3
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_sqrt(x: DF) -> DF:
    """Double-float square root (Karp–Markstein style correction).

    Domain: x > 0 (the Lanczos β² is positive until breakdown; callers mask
    non-positive inputs themselves)."""
    safe_hi = jnp.where(x.hi > 0, x.hi, jnp.ones_like(x.hi))
    s = jnp.sqrt(safe_hi)
    # residual r = x - s*s computed exactly, correction = r / (2s)
    p, e = two_prod(s, s)
    r = df_add(x, DF(-p, -e))
    c = r.hi / (2.0 * s)
    hi, lo = fast_two_sum(s, c)
    zero = jnp.zeros_like(hi)
    pos = x.hi > 0
    return DF(jnp.where(pos, hi, zero), jnp.where(pos, lo, zero))


# ---------------------------------------------------------------------------
# Reductions (compensated)
# ---------------------------------------------------------------------------

def _df_pairwise_reduce(hi, lo):
    """Log-depth pairwise df_add fold over the leading axis (shape (m, ...)
    -> scalar pair): each combine step is a full double-float addition, so
    the reduction error is O(eps²·log m)."""
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    m = hi.shape[0]
    # pad to a power of two with exact zeros
    size = 1 << max((m - 1).bit_length(), 0)
    if size != m:
        hi = jnp.concatenate([hi, jnp.zeros(size - m, hi.dtype)])
        lo = jnp.concatenate([lo, jnp.zeros(size - m, lo.dtype)])
    while hi.shape[0] > 1:
        h = hi.shape[0] // 2
        s = df_add(DF(hi[:h], lo[:h]), DF(hi[h:], lo[h:]))
        hi, lo = s.hi, s.lo
    return DF(hi[0], lo[0])


def df_sum(x: DF, reduce_sum=None) -> DF:
    """Compensated sum of all elements; ``reduce_sum`` finishes a partial
    sum across devices (applied to hi and lo separately — the cross-device
    combine is a plain f32 psum of two streams, which keeps ~2eps accuracy
    for device counts << 1/eps)."""
    s = _df_pairwise_reduce(x.hi, x.lo)
    if reduce_sum is not None:
        s = DF(reduce_sum(s.hi), reduce_sum(s.lo))
        s = DF(*fast_two_sum(s.hi, s.lo))
    return s


def df_dot(x: DF, y: DF, reduce_sum=None) -> DF:
    """Compensated inner product: elementwise df_mul then pairwise df_add."""
    p = df_mul(x, y)
    return df_sum(p, reduce_sum)


def df_norm(x: DF, reduce_sum=None) -> DF:
    return df_sqrt(df_dot(x, x, reduce_sum))
