"""Sparse matrix–vector products with a fixed order of summation.

The reference library delegates its SpMV to faer's native sparse kernels
(reference ``src/algorithms/mod.rs:177`` — ``operator.apply``). Here the
product is an XLA gather followed by a *deterministic* row reduction.

Why deterministic: the two-pass algorithm regenerates pass one's basis in
pass two, and the contract is that the two agree bit for bit
(``basis_drift_fro == 0``). A scatter-add (``y.at[rows].add``) lowers to
atomics on the GPU, whose order — and therefore whose rounding — changes
from call to call, so two matvecs of the same vector differ in the last
bits and the replay breaks. The row sums here are instead taken by
:class:`RowSums`: each row's entries are cut into fixed-width chunks,
every chunk is summed by a plain reduction, and rows that span several
chunks are summed again, level by level. Every shape and every order of
summation is fixed on the host when the operator is built.

Layouts:

* **SortedCOO**: nonzeros sorted by row, plus the :class:`RowSums` plan that
  reduces them.
* **Structure-aware KKT matvec**: the KKT matrix ``A = [[D, Eᵀ], [E, 0]]``
  (reference ``src/utils/data_loader.rs:211-258``) is never materialized:
  ``E`` is a node–arc incidence matrix with exactly one ``+1`` (row ``u_j``)
  and one ``-1`` (row ``v_j``) per column, so the arc block is two gathers and
  the node block is two row reductions, one over arcs grouped by tail and one
  over arcs grouped by head.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "RowSums",
    "build_row_sums",
    "row_sums",
    "stacked_row_sums",
    "gather_entries",
    "SortedCOO",
    "csr_from_triplets",
    "coo_spmv",
    "incidence_sums",
    "kkt_matvec",
]

#: Chunk widths are powers of two in this range (see ``_chunk_width``).
_MIN_WIDTH, _MAX_WIDTH = 4, 256


def _chunk_width(run_lengths: np.ndarray) -> int:
    """The chunk width for a level: the median run length rounded up to a
    power of two, within ``[4, 256]``. Half the runs then fit one chunk, and
    padding stays under half of the slots for runs near the median."""
    runs = run_lengths[run_lengths > 0]
    med = int(np.median(runs)) if runs.size else 1
    w = 1 << max(med - 1, 0).bit_length()
    return int(min(max(w, _MIN_WIDTH), _MAX_WIDTH))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class RowSums:
    """A fixed plan for summing runs of entries into rows.

    Level 0 — a ``(C0, W0)`` table of up to ``W0`` entries of one row per
    chunk — is held by the caller in the form it gathers (arc indices,
    column/value pairs) and reduced by :func:`row_sums`. ``levels`` are the
    later ``(C, W)`` tables: chunks of the previous level's chunk sums, for
    the rows that still have more than one. Out-of-range indices mark
    padding and read as zero. ``out`` gives, for each row, the position of
    its total in the concatenation of all levels' chunk sums (out of range
    for an empty row).
    """

    levels: Tuple[jax.Array, ...]
    out: jax.Array

    def tree_flatten(self):
        return (self.levels, self.out), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, out = children
        return cls(levels=tuple(levels), out=out)


def _plan_levels(counts: np.ndarray, widths=None):
    """Host-side chunk tables for rows with ``counts[r]`` consecutive entries.

    Returns ``(levels, out_level, out_local)``: one ``(C, W)`` table per
    level, and for each row the level and chunk that hold its total
    (level -1 for an empty row). ``widths`` fixes the width of the first
    levels (later ones take the widest); without it each level's width
    follows its run lengths.
    """
    counts = np.asarray(counts, dtype=np.int64)
    n_rows = counts.shape[0]
    levels = []
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    n_src = int(counts.sum())  # level 0 reads entries, later levels sums
    active = np.nonzero(counts > 0)[0]  # rows still being reduced
    run, run_start = counts[active], starts[active]
    out_level = np.full(n_rows, -1, dtype=np.int64)
    out_local = np.zeros(n_rows, dtype=np.int64)
    while True:
        level = len(levels)
        if widths is None:
            w = _chunk_width(run)
        else:
            w = int(widths[level]) if level < len(widths) else _MAX_WIDTH
        nchunk = -(-run // w)
        total = int(nchunk.sum())
        first_chunk = np.concatenate([[0], np.cumsum(nchunk)[:-1]]).astype(np.int64)
        owner = np.repeat(np.arange(run.size), nchunk)
        local = np.arange(total) - first_chunk[owner]
        pos = run_start[owner][:, None] + local[:, None] * w + np.arange(w)[None, :]
        end = (run_start + run)[owner][:, None]
        idx = np.where(pos < end, pos, n_src).reshape(total, w)
        if total == 0:  # no entries at all: one chunk of padding
            idx, total = np.full((1, w), n_src), 1
        levels.append(idx)
        done = nchunk == 1
        out_level[active[done]] = level
        out_local[active[done]] = first_chunk[done]
        # rows with several chunks go on to the next level over their sums
        keep = ~done
        active, run, run_start = active[keep], nchunk[keep], first_chunk[keep]
        n_src = total
        if active.size == 0:
            return levels, out_level, out_local


def _flat_out(out_level, out_local, sizes) -> np.ndarray:
    """Positions of the row totals in the concatenated level sums."""
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return np.where(out_level >= 0, offsets[out_level] + out_local, offsets[-1])


def build_row_sums(counts) -> Tuple[RowSums, np.ndarray]:
    """Plan the row sums of ``len(counts)`` rows whose entries are stored
    row after row, ``counts[r]`` of them for row ``r``.

    Returns ``(plan, level0_positions)``: the device plan, and its level-0
    table of entry positions (``sum(counts)`` marks padding), which the
    caller replaces by what the matvec gathers.
    """
    levels, out_level, out_local = _plan_levels(counts)
    out = _flat_out(out_level, out_local, [a.shape[0] for a in levels])
    plan = RowSums(
        levels=tuple(jnp.asarray(a, jnp.int32) for a in levels[1:]),
        out=jnp.asarray(out, jnp.int32),
    )
    return plan, levels[0]


def stacked_row_sums(counts_per_device):
    """One :class:`RowSums` plan per device, padded to common shapes and
    stacked on a leading device axis, so that ``shard_map`` can hand each
    device its own plan (``parallel/sharded.py``).

    Returns ``(plan, level0_positions)`` with ``level0_positions`` a list of
    per-device ``(C0, W0)`` tables of entry positions (see
    :func:`gather_entries` for what marks padding).
    """
    widths = [a.shape[1] for a in
              _plan_levels(np.concatenate(counts_per_device))[0]]
    plans = [_plan_levels(c, widths) for c in counts_per_device]
    depth = max(len(p[0]) for p in plans)
    widths = widths + [_MAX_WIDTH] * (depth - len(widths))
    sizes = [max(p[0][lv].shape[0] if lv < len(p[0]) else 0 for p in plans)
             for lv in range(depth)]
    level0, levels, outs = [], [[] for _ in range(depth - 1)], []
    for tables, out_level, out_local in plans:
        padded = []
        for lv in range(depth):
            t = tables[lv] if lv < len(tables) else np.zeros((0, widths[lv]), np.int64)
            fill = sizes[lv - 1] if lv else -1  # reads as zero
            pad = np.full((sizes[lv] - t.shape[0], widths[lv]), fill)
            padded.append(np.concatenate([t, pad]).astype(np.int64))
        level0.append(padded[0])
        for lv in range(1, depth):
            levels[lv - 1].append(padded[lv])
        outs.append(_flat_out(out_level, out_local, sizes))
    plan = RowSums(
        levels=tuple(jnp.asarray(np.stack(t), jnp.int32) for t in levels),
        out=jnp.asarray(np.stack(outs), jnp.int32),
    )
    return plan, level0


def gather_entries(pos: np.ndarray, n: int, *arrays):
    """Host-side: each array's entries at the level-0 positions ``pos``, and
    zero where ``pos`` lies outside ``[0, n)`` (padding)."""
    real = (pos >= 0) & (pos < n)
    safe = np.where(real, pos, 0)
    return [np.where(real, a[safe] if n else 0, 0).astype(a.dtype)
            for a in arrays]


def row_sums(plan: RowSums, chunks: jax.Array) -> jax.Array:
    """Reduce level-0 chunk values ``(C0, W0)`` to one sum per row.

    Every reduction runs over a fixed axis of a fixed shape, so the result
    is the same in every call, on every backend.
    """
    s = jnp.sum(chunks, axis=1)
    sums = [s]
    for idx in plan.levels:
        s = jnp.sum(s.at[idx].get(mode="fill", fill_value=0), axis=1)
        sums.append(s)
    flat = jnp.concatenate(sums) if len(sums) > 1 else s
    return flat.at[plan.out].get(mode="fill", fill_value=0)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SortedCOO:
    """Sparse matrix laid out for a deterministic row-sum matvec.

    ``ell_cols`` and ``ell_vals`` hold the entries, sorted by row, as the
    level-0 chunks of ``plan`` (padding has column 0 and value 0); they and
    the plan are the only device arrays, and all that :func:`coo_spmv`
    reads. ``triplets`` keeps the row-sorted ``(rows, cols, vals)`` on the
    host for host-side consumers (:meth:`todense`, the row partition of
    ``parallel/sharded.py``). It is not a pytree leaf, so a copy that went
    through a JAX transformation has none.
    """

    ell_cols: jax.Array  # int32 (C0, W0)
    ell_vals: jax.Array  # dtype (C0, W0)
    plan: RowSums
    shape: Tuple[int, int]
    nnz: int  # true number of nonzeros
    triplets: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
        dataclasses.field(default=None, compare=False, repr=False)

    def tree_flatten(self):
        return (self.ell_cols, self.ell_vals, self.plan), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        ell_cols, ell_vals, plan = children
        shape, nnz = aux
        return cls(ell_cols=ell_cols, ell_vals=ell_vals, plan=plan,
                   shape=shape, nnz=nnz)

    @property
    def dtype(self):
        return self.ell_vals.dtype

    def host_triplets(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.triplets is None:
            raise ValueError(
                "this SortedCOO carries no host triplets: use the matrix "
                "returned by csr_from_triplets, outside jit")
        return self.triplets

    def todense(self) -> jax.Array:
        rows, cols, vals = self.host_triplets()
        out = np.zeros(self.shape, dtype=vals.dtype)
        np.add.at(out, (rows, cols), vals)
        return jnp.asarray(out)


def csr_from_triplets(
    n_rows: int,
    n_cols: int,
    rows,
    cols,
    vals,
    dtype=None,
    sum_duplicates: bool = True,
) -> SortedCOO:
    """Build a :class:`SortedCOO` from triplets (host-side, NumPy).

    Duplicate ``(row, col)`` entries are summed, matching the semantics of
    faer's ``try_new_from_triplets`` used by the reference loader
    (``src/utils/data_loader.rs:150-152``).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    if dtype is not None:
        vals = vals.astype(dtype)
    if rows.shape != cols.shape or rows.shape != vals.shape:
        raise ValueError("rows/cols/vals must have identical shapes")
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError("row index out of bounds")
    if cols.size and (cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError("col index out of bounds")

    if sum_duplicates and rows.size:
        # Collapse duplicates by linear index, preserving exact summation on host.
        lin = rows * np.int64(n_cols) + cols
        order = np.argsort(lin, kind="stable")
        lin_s = lin[order]
        vals_s = vals[order]
        uniq, start = np.unique(lin_s, return_index=True)
        summed = np.add.reduceat(vals_s, start) if vals_s.size else vals_s
        rows = (uniq // n_cols).astype(np.int64)
        cols = (uniq % n_cols).astype(np.int64)
        vals = summed
    else:
        order = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]

    nnz = int(rows.size)
    vals = vals.astype(vals.dtype if vals.size else np.dtype(dtype or np.float64))
    rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    plan, pos = build_row_sums(np.bincount(rows, minlength=n_rows))
    ell_cols, ell_vals = gather_entries(pos, nnz, cols, vals)
    return SortedCOO(
        ell_cols=jnp.asarray(ell_cols),
        ell_vals=jnp.asarray(ell_vals),
        plan=plan,
        shape=(int(n_rows), int(n_cols)),
        nnz=nnz,
        triplets=(rows, cols, vals),
    )


def coo_spmv(a: SortedCOO, x: jax.Array) -> jax.Array:
    """``y = A @ x`` for a row-sorted COO matrix: one gather–multiply over the
    level-0 chunks, then the fixed-order row sums of ``a.plan``."""
    prod = a.ell_vals.astype(x.dtype) * x.at[a.ell_cols].get(
        mode="promise_in_bounds")
    return row_sums(a.plan, prod)


def incidence_sums(endpoints, num_nodes: int) -> Tuple[RowSums, jax.Array]:
    """Plan ``y[i] = Σ_{j: endpoints[j] = i} x[j]`` (host-side, NumPy).

    Returns ``(plan, arcs)`` where ``arcs`` is the level-0 table of arc
    indices, with ``len(endpoints)`` marking padding.
    """
    endpoints = np.asarray(endpoints, dtype=np.int64)
    m = endpoints.shape[0]
    order = np.argsort(endpoints, kind="stable")
    plan, pos = build_row_sums(np.bincount(endpoints, minlength=num_nodes))
    real = (pos >= 0) & (pos < m)
    arcs = np.full(pos.shape, m, dtype=np.int64)
    arcs[real] = order[pos[real]]
    return plan, jnp.asarray(arcs, jnp.int32)


def kkt_matvec(
    d: jax.Array,
    arc_u: jax.Array,
    arc_v: jax.Array,
    x: jax.Array,
    tails: Tuple[RowSums, jax.Array],
    heads: Tuple[RowSums, jax.Array],
) -> jax.Array:
    """Structure-aware matvec for the KKT matrix ``A = [[D, Eᵀ], [E, 0]]``.

    ``x = [x_a (num_arcs), x_n (num_nodes)]`` with the arc block first,
    matching the reference assembly (``src/utils/data_loader.rs:222-249``:
    D occupies rows/cols ``0..m``, E rows are shifted by ``num_arcs``).

    * top block:    ``y_a = d ⊙ x_a + x_n[u] − x_n[v]``    (D·x_a + Eᵀ·x_n)
    * bottom block: ``y_n = Σ_{u_j=i} x_a[j] − Σ_{v_j=i} x_a[j]``  (E·x_a)

    ``arc_u``/``arc_v`` are the 0-based tail/head node indices per arc;
    the incidence convention is ``E[u_j, j] = +1``, ``E[v_j, j] = -1``
    (reference ``src/utils/data_loader.rs:120-133``).

    The node block is summed by the fixed plans ``tails`` and ``heads``
    (from :func:`incidence_sums` over ``arc_u`` and ``arc_v``), so the
    product is bitwise reproducible on every backend.
    """
    m = d.shape[0]
    x_a = x[:m]
    x_n = x[m:]
    y_a = (
        d * x_a
        + x_n.at[arc_u].get(mode="promise_in_bounds")
        - x_n.at[arc_v].get(mode="promise_in_bounds")
    )
    (t_plan, t_arcs), (h_plan, h_arcs) = tails, heads
    y_n = (row_sums(t_plan, x_a.at[t_arcs].get(mode="fill", fill_value=0))
           - row_sums(h_plan, x_a.at[h_arcs].get(mode="fill", fill_value=0)))
    # Keeps XLA from fusing the node sums into the concatenation below:
    # fused, that kernel took ~100 us a step on an H100 at 500k arcs,
    # three times the rest of the step.
    y_n = jax.lax.optimization_barrier(y_n)
    return jnp.concatenate([y_a, y_n])
