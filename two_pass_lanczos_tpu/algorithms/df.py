"""Compensated-precision (double-float) Lanczos: near-f64 accuracy from f32.

SURVEY §7 hard part 5: the reference runs everything in f64; on hardware
without fast f64 (where this path began), plain f32 coefficients
diverge from the f64 oracle by O(1) at k≈100 on indefinite spectra (forward
instability amplifies per-step rounding ~exponentially). This module runs
the *entire* recurrence — matvec, orthogonalization axpys, inner products,
normalization — in double-float arithmetic (:mod:`two_pass_lanczos_tpu.ops
.df`, ~49-bit effective mantissa), so the per-step rounding that instability
amplifies is ~2⁻⁴⁹ instead of 2⁻²⁴. Validated against the CPU f64 oracle at
k=200 on the inv/ill-conditioned spectrum (``tests/test_df.py``). A GPU
with f64 in hardware (the H100) needs none of this: run in f64.

Everything is elementwise code under ``lax.scan`` — jittable, shardable. The projected f(T_k)e₁ solve recombines (hi, lo) → f64 on the
host exactly as the plain path hands f64 scalars to the user closure.

Cost: a df matvec/axpy is ~10-20 f32 flops per element vs 1 — but the
Lanczos hot loop is bandwidth/gather-bound, not flop-bound, so the
end-to-end slowdown is far below the flop ratio.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from two_pass_lanczos_tpu.ops.df import (
    DF,
    df_add,
    two_prod,
    df_div,
    df_dot,
    df_from_f64,
    df_mul,
    df_mul_f32,
    df_neg,
    df_norm,
    df_sub,
    df_to_f64,
    df_zeros_like,
)

__all__ = [
    "DF_EPS",
    "df_breakdown_tolerance",
    "DFDiagonalOperator",
    "DFKKTOperator",
    "DFDecomposition",
    "lanczos_pass_one_df",
    "lanczos_standard_df",
    "lanczos_pass_two_df",
    "lanczos_pass_two_with_basis_df",
    "solve_fAb_df",
]

#: effective machine epsilon of a normalized double-float (2⁻⁴⁹).
DF_EPS = 2.0 ** -49


def df_breakdown_tolerance() -> float:
    """1000·ε of the double-float format (the reference's 1000·ε rule,
    ``src/algorithms/mod.rs:140-143``, applied to the working precision)."""
    return 1000.0 * DF_EPS


# ---------------------------------------------------------------------------
# Double-float operators
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DFDiagonalOperator:
    """Diagonal operator in double-float (the stability-scenario oracle
    problems, reference ``src/bin/stability.rs:98-157``)."""

    diag: DF

    def tree_flatten(self):
        return (self.diag,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(diag=children[0])

    @classmethod
    def from_f64(cls, diag):
        return cls(diag=df_from_f64(diag))

    @property
    def shape(self):
        n = self.diag.hi.shape[0]
        return (n, n)

    def matvec_df(self, x: DF) -> DF:
        return df_mul(self.diag, x)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DFKKTOperator:
    """Structure-aware KKT operator ``[[D, Eᵀ], [E, 0]]`` in double-float.

    * arc rows: ``y_a = d ⊙ x_a + (x_n[u] − x_n[v])`` — df multiply plus df
      gathers (a gather is exact: it moves hi and lo unchanged);
    * node rows: ``y_n = E x_a`` — a *compensated segmented sum*: arc values
      are gathered into a dense ``(p, K)`` per-node table (host-built index
      map, K = max degree) and folded pairwise with full df additions, so
      the scatter accumulates with O(ε²·log K) error instead of the O(√K·ε)
      of a plain f32 ``segment_sum``.
    """

    d: DF
    arc_u: jax.Array
    arc_v: jax.Array
    #: (p, K) int32 arc index per (node, slot), -1 padding -> index m (zero)
    node_arcs_u: jax.Array
    node_arcs_v: jax.Array
    num_nodes: int

    def tree_flatten(self):
        return (self.d, self.arc_u, self.arc_v, self.node_arcs_u,
                self.node_arcs_v), (self.num_nodes,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, num_nodes=aux[0])

    @classmethod
    def from_f64(cls, quad_costs, arc_u, arc_v, num_nodes):
        arc_u = np.asarray(arc_u, np.int64)
        arc_v = np.asarray(arc_v, np.int64)
        m = len(arc_u)
        p = int(num_nodes)

        # The dense (p, K) table is O(p · max_degree): on hub-heavy graphs
        # (star-like topologies) that is O(n·m) and OOMs long before the
        # instance itself is large. Guard with a clear error instead of an
        # opaque allocation failure.
        MAX_TABLE_ENTRIES = 1 << 26  # 256 MB of int32 per endpoint table

        def table(key):
            counts = np.bincount(key, minlength=p)
            k_max = max(int(counts.max()), 1)
            k_pad = 1 << (k_max - 1).bit_length()  # pow2: clean pairwise fold
            if p * k_pad > MAX_TABLE_ENTRIES:
                raise ValueError(
                    f"DFKKTOperator.from_f64: dense segmented-sum table would"
                    f" be {p} nodes x {k_pad} slots (max degree {k_max}) ="
                    f" {p * k_pad} int32 entries, over the"
                    f" {MAX_TABLE_ENTRIES}-entry cap. For this hub-heavy"
                    f" topology use the f64 KKTOperator"
                    f" (make_kkt_operator(..., dtype=jnp.float64)), which"
                    f" needs no table, on a device with f64 arithmetic.")
            tab = np.full((p, k_pad), m, np.int32)  # m = zero pad slot
            order = np.argsort(key, kind="stable")
            ks = key[order]
            rank = np.arange(m) - np.concatenate(
                [[0], np.cumsum(counts)])[:-1][ks]
            tab[ks, rank] = order.astype(np.int32)
            return jnp.asarray(tab)

        return cls(
            d=df_from_f64(quad_costs),
            arc_u=jnp.asarray(arc_u, jnp.int32),
            arc_v=jnp.asarray(arc_v, jnp.int32),
            node_arcs_u=table(arc_u),
            node_arcs_v=table(arc_v),
            num_nodes=p,
        )

    @property
    def num_arcs(self):
        return self.d.hi.shape[0]

    @property
    def shape(self):
        n = self.num_arcs + self.num_nodes
        return (n, n)

    def _segsum(self, xa_pad: DF, tab) -> DF:
        vals = DF(xa_pad.hi[tab], xa_pad.lo[tab])  # (p, K) exact gather
        hi, lo = vals.hi, vals.lo
        k = hi.shape[1]  # power of two by construction (table())
        while k > 1:
            h = k // 2
            s = df_add(DF(hi[:, :h], lo[:, :h]), DF(hi[:, h:k], lo[:, h:k]))
            hi, lo = s.hi, s.lo
            k = h
        return DF(hi[:, 0], lo[:, 0])

    def matvec_df(self, x: DF) -> DF:
        m = self.num_arcs
        xa = DF(x.hi[:m], x.lo[:m])
        xn = DF(x.hi[m:], x.lo[m:])
        # arc rows
        gu = DF(xn.hi[self.arc_u], xn.lo[self.arc_u])
        gv = DF(xn.hi[self.arc_v], xn.lo[self.arc_v])
        ya = df_add(df_mul(self.d, xa), df_sub(gu, gv))
        # node rows: compensated segmented sums (pad slot m holds exact 0)
        zero = jnp.zeros((1,), xa.hi.dtype)
        xa_pad = DF(jnp.concatenate([xa.hi, zero]),
                    jnp.concatenate([xa.lo, zero]))
        yn = df_sub(self._segsum(xa_pad, self.node_arcs_u),
                    self._segsum(xa_pad, self.node_arcs_v))
        return DF(jnp.concatenate([ya.hi, yn.hi]),
                  jnp.concatenate([ya.lo, yn.lo]))


# ---------------------------------------------------------------------------
# Double-float Lanczos passes
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DFDecomposition:
    """Pass-one output with double-float coefficients (padded to length k)."""

    alphas: DF
    betas: DF
    steps_taken: jax.Array
    b_norm: DF

    def tree_flatten(self):
        return (self.alphas, self.betas, self.steps_taken, self.b_norm), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def steps(self) -> int:
        return int(self.steps_taken)

    def alphas_f64(self) -> np.ndarray:
        """α₁..α_steps recombined to f64 (for the projected solve/oracle)."""
        return df_to_f64(self.alphas)[: self.steps()]

    def betas_f64(self) -> np.ndarray:
        """β₁..β_{steps-1} recombined to f64."""
        return df_to_f64(self.betas)[: max(self.steps() - 1, 0)]


def _as_df(b) -> DF:
    if isinstance(b, DF):
        return b
    b = np.asarray(b)
    if b.dtype == np.float64:
        return df_from_f64(b)
    z = jnp.zeros_like(jnp.asarray(b, jnp.float32))
    return DF(jnp.asarray(b, jnp.float32), z)


def lanczos_pass_one_df(operator, b, k: int) -> DFDecomposition:
    """Pass one entirely in double-float (O(n) memory, scalars kept).

    Same structure as ``core.pass_one_scan`` (masked fixed-length scan,
    reference op order ``src/algorithms/mod.rs:167-212``), every operation
    replaced by its error-free-compensated counterpart.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    b = _as_df(b)
    alphas, betas, steps, b_norm, _ = _pass_one_df_jit(operator, b, k, False)
    return DFDecomposition(alphas=alphas, betas=betas, steps_taken=steps,
                           b_norm=b_norm)


def lanczos_standard_df(operator, b, k: int):
    """One-pass in double-float: returns ``(DFDecomposition, basis)`` with
    ``basis`` a DF pair of shape (k, n), row i = v_{i+1} (the O(nk)
    variant — reference ``src/algorithms/lanczos.rs:55-156`` — at df
    precision)."""
    if k < 1:
        raise ValueError("k must be >= 1")
    b = _as_df(b)
    alphas, betas, steps, b_norm, basis = _pass_one_df_jit(operator, b, k,
                                                           True)
    decomp = DFDecomposition(alphas=alphas, betas=betas, steps_taken=steps,
                             b_norm=b_norm)
    return decomp, basis


@functools.partial(jax.jit, static_argnums=(2, 3))
def _pass_one_df_jit(op, b, k, emit_basis):
    # module-level jit: a closure-local @jax.jit would retrace+recompile the
    # whole df scan on every call (measured ~3.5 s/call at n=256)
    tol = jnp.float32(df_breakdown_tolerance())
    b_norm = df_norm(b)
    # zero-b gate at the underflow boundary (matches core.zero_tolerance
    # for f32: 1000 x smallest normal)
    zero_b = b_norm.hi <= jnp.float32(1000.0 * np.finfo(np.float32).tiny)
    inv_n = df_div(DF(jnp.float32(1.0), jnp.float32(0.0)), b_norm)
    inv_n = DF(jnp.where(zero_b, 0.0, inv_n.hi),
               jnp.where(zero_b, 0.0, inv_n.lo))
    v1 = df_mul(b, DF(jnp.broadcast_to(inv_n.hi, b.hi.shape),
                      jnp.broadcast_to(inv_n.lo, b.lo.shape)))

    def bscal(s: DF, shape):
        return DF(jnp.broadcast_to(s.hi, shape), jnp.broadcast_to(s.lo, shape))

    def step(carry, _):
        vp, vc, beta_prev, done, steps = carry
        executed = jnp.logical_not(done)
        w = op.matvec_df(vc)
        w = df_sub(w, df_mul(bscal(beta_prev, vp.hi.shape), vp))
        alpha = df_dot(vc, w)
        w = df_sub(w, df_mul(bscal(alpha, vc.hi.shape), vc))
        beta = df_norm(w)
        breakdown = beta.hi <= tol
        advance = jnp.logical_and(executed, jnp.logical_not(breakdown))

        def msk(s: DF, cond):
            return DF(jnp.where(cond, s.hi, 0.0), jnp.where(cond, s.lo, 0.0))

        alpha_out = msk(alpha, executed)
        beta_out = msk(beta, advance)
        inv_b = df_div(DF(jnp.float32(1.0), jnp.float32(0.0)), beta)
        inv_b = msk(inv_b, advance)
        v_next = df_mul(w, bscal(inv_b, w.hi.shape))

        def sel(a, b_, cond=advance):
            return DF(jnp.where(cond, a.hi, b_.hi), jnp.where(cond, a.lo, b_.lo))

        new = (sel(vc, vp), sel(v_next, vc),
               sel(beta, beta_prev),
               jnp.logical_or(done, breakdown),
               steps + executed.astype(jnp.int32))
        if emit_basis:
            # row = v_{j+1} (the vector entering this step), zeros once done
            v_emit = msk(vc, executed)
            return new, (alpha_out, beta_out, v_emit)
        return new, (alpha_out, beta_out)

    carry0 = (df_zeros_like(b), v1,
              DF(jnp.float32(0.0), jnp.float32(0.0)), zero_b,
              jnp.zeros((), jnp.int32))
    carry, outs = jax.lax.scan(step, carry0, None, length=k)
    alphas, betas = outs[0], outs[1]
    basis = outs[2] if emit_basis else None
    return alphas, betas, carry[4], b_norm, basis


def lanczos_pass_two_df(operator, b, decomp: DFDecomposition, y_f64) -> DF:
    """Pass two in double-float: replay from the stored df β (never
    recomputing inner products — the reference's bit-faithful-replay design,
    ``src/algorithms/lanczos_two_pass.rs:176-199``, at df precision)."""
    b = _as_df(b)
    k = decomp.alphas.hi.shape[0]
    y = df_from_f64(np.pad(np.asarray(y_f64, np.float64),
                           (0, k - len(np.asarray(y_f64)))))
    x, _ = _pass_two_df_jit(operator, b, decomp, y, False)
    return x


def lanczos_pass_two_with_basis_df(operator, b, decomp: DFDecomposition,
                                   y_f64):
    """df pass two that also returns the regenerated basis as a DF pair of
    shape (k, n) — rows beyond ``steps_taken`` zeroed (the test-only
    capability of reference ``lanczos_pass_two_with_basis``, at df
    precision; used by the df property harness)."""
    b = _as_df(b)
    k = decomp.alphas.hi.shape[0]
    y = df_from_f64(np.pad(np.asarray(y_f64, np.float64),
                           (0, k - len(np.asarray(y_f64)))))
    return _pass_two_df_jit(operator, b, decomp, y, True)


@functools.partial(jax.jit, static_argnums=(4,))
def _pass_two_df_jit(op, b, decomp, y, emit_basis):
    k = decomp.alphas.hi.shape[0]
    steps = decomp.steps_taken
    inv_n = df_div(DF(jnp.float32(1.0), jnp.float32(0.0)), decomp.b_norm)
    shape = b.hi.shape

    def bscal(s: DF):
        return DF(jnp.broadcast_to(s.hi, shape), jnp.broadcast_to(s.lo, shape))

    v1 = df_mul(b, bscal(inv_n))
    idx = jnp.arange(k)
    ym = DF(jnp.where(idx < steps, y.hi, 0.0),
            jnp.where(idx < steps, y.lo, 0.0))
    x0 = df_mul(bscal(DF(ym.hi[0], ym.lo[0])), v1)
    if k == 1:
        basis = DF(v1.hi[None, :], v1.lo[None, :]) if emit_basis else None
        return x0, basis

    bp = DF(jnp.concatenate([jnp.zeros((1,), jnp.float32),
                             decomp.betas.hi[:-1]]),
            jnp.concatenate([jnp.zeros((1,), jnp.float32),
                             decomp.betas.lo[:-1]]))
    xs = (DF(decomp.alphas.hi[:k - 1], decomp.alphas.lo[:k - 1]),
          DF(bp.hi[:k - 1], bp.lo[:k - 1]),
          DF(decomp.betas.hi[:k - 1], decomp.betas.lo[:k - 1]),
          DF(ym.hi[1:], ym.lo[1:]),
          jnp.arange(k - 1))

    def step(carry, xrow):
        vp, vc, x_acc = carry
        alpha_j, beta_p, beta_j, y_next, j = xrow
        active = j < steps - 1
        w = op.matvec_df(vc)
        w = df_sub(w, df_mul(bscal(beta_p), vp))
        w = df_sub(w, df_mul(bscal(alpha_j), vc))
        safe = DF(jnp.where(beta_j.hi > 0, beta_j.hi, 1.0), beta_j.lo)
        inv_b = df_div(DF(jnp.float32(1.0), jnp.float32(0.0)), safe)
        inv_b = DF(jnp.where(active, inv_b.hi, 0.0),
                   jnp.where(active, inv_b.lo, 0.0))
        v_next = df_mul(w, bscal(inv_b))
        x_acc = df_add(x_acc, df_mul(bscal(y_next), v_next))

        def sel(a, b_):
            return DF(jnp.where(active, a.hi, b_.hi),
                      jnp.where(active, a.lo, b_.lo))

        out = None
        if emit_basis:
            out = (jnp.where(active, v_next.hi, 0.0),
                   jnp.where(active, v_next.lo, 0.0))
        return (sel(vc, vp), sel(v_next, vc), x_acc), out

    (_, _, x_k), outs = jax.lax.scan(step, (df_zeros_like(b), v1, x0), xs)
    basis = None
    if emit_basis:
        basis = DF(jnp.concatenate([v1.hi[None, :], outs[0]], axis=0),
                   jnp.concatenate([v1.lo[None, :], outs[1]], axis=0))
    return x_k, basis


def solve_fAb_df(operator, b, *, k: int, f="inv",
                 method: str = "two_pass") -> np.ndarray:
    """f(A)·b in double-float; returns x as f64 (hi+lo recombined).

    ``method`` ∈ {"one_pass", "two_pass"}. The projected k×k solve runs on
    the host in f64 (tiny), exactly like the reference hands f64 (α, β) to
    the user closure.
    """
    if method == "one_pass":
        decomp, basis = lanczos_standard_df(operator, b, k)
    elif method == "two_pass":
        decomp = lanczos_pass_one_df(operator, b, k)
        basis = None
    else:
        raise ValueError(f"unknown method {method!r}")
    steps = decomp.steps()
    if steps == 0:
        n = operator.shape[0]
        return np.zeros(n)
    from two_pass_lanczos_tpu.functions import host_f_tk_solve

    y = host_f_tk_solve(decomp.alphas_f64(), decomp.betas_f64(), f)
    b_norm = float(df_to_f64(DF(decomp.b_norm.hi, decomp.b_norm.lo)))
    if method == "one_pass":
        k_full = decomp.alphas.hi.shape[0]
        y_full = np.zeros(k_full)
        y_full[:steps] = y * b_norm
        x = _gemv_df_jit(basis, df_from_f64(y_full))
        return df_to_f64(x)
    x = lanczos_pass_two_df(operator, b, decomp, y * b_norm)
    return df_to_f64(x)


@jax.jit
def _gemv_df_jit(basis: DF, y: DF) -> DF:
    """x = Vᵀ·y in double-float: elementwise df products, pairwise df fold
    over the k axis (basis stored (k, n))."""
    ph, pe = two_prod(basis.hi, y.hi[:, None])
    pe = pe + (basis.hi * y.lo[:, None] + basis.lo * y.hi[:, None])
    h, l = ph, pe
    r = h.shape[0]
    xh = xl = None
    while r > 1:
        if r % 2:
            if xh is None:
                xh, xl = h[r - 1:r], l[r - 1:r]
            else:
                s2 = df_add(DF(xh, xl), DF(h[r - 1:r], l[r - 1:r]))
                xh, xl = s2.hi, s2.lo
            r -= 1
        half = r // 2
        s2 = df_add(DF(h[:half], l[:half]), DF(h[half:r], l[half:r]))
        h, l = s2.hi, s2.lo
        r = half
    if xh is not None:
        s2 = df_add(DF(h, l), DF(xh, xl))
        h, l = s2.hi, s2.lo
    return DF(h[0], l[0])
