"""Row partitioning of sparse operators across a device mesh.

The KKT matrix is pathologically unbalanced for naive contiguous row splits:
arc rows carry exactly 3 nonzeros while node rows carry the node degree
(~2·arcs/nodes, i.e. hundreds); a contiguous split hands one device nearly
half the nnz. Since the Lanczos iteration is invariant under a symmetric
permutation ``P·A·Pᵀ`` (solve with ``P·b``, unpermute the result), we balance
by *permuting rows* so each equal-size vector shard carries near-equal nnz:

* sort rows by nnz descending,
* deal them to devices in serpentine (snake) order — the classic LPT-style
  balance guarantee with exactly equal row counts per device,
* sort each device's rows ascending (gather locality), and concatenate into
  the global permutation.

This keeps the *vector* sharding uniform (what ``shard_map`` needs) while the
*work* sharding is balanced (what the SpMV needs).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from two_pass_lanczos_tpu.ops.spmv import gather_entries, stacked_row_sums

__all__ = ["RowPartition", "snake_partition", "build_local_blocks_split"]


class RowPartition(NamedTuple):
    """A symmetric-permutation row partition.

    ``perm[i]`` is the original row index placed at permuted position ``i``;
    positions ``[d·rows_per : (d+1)·rows_per)`` live on device ``d``.
    ``n_orig ≤ n_pad = ndev · rows_per`` (phantom zero rows pad the tail).
    """

    perm: np.ndarray  # (n_pad,) int64
    inv_perm: np.ndarray  # (n_pad,) int64
    rows_per: int
    ndev: int
    n_orig: int
    nnz_per_dev: np.ndarray  # (ndev,) int64 — diagnostics

    @property
    def n_pad(self) -> int:
        return self.rows_per * self.ndev


def snake_partition(nnz_per_row: np.ndarray, ndev: int) -> RowPartition:
    """Balance rows over ``ndev`` devices by serpentine dealing."""
    n_orig = int(nnz_per_row.shape[0])
    rows_per = -(-n_orig // ndev)
    n_pad = rows_per * ndev
    counts = np.zeros(n_pad, dtype=np.int64)
    counts[:n_orig] = nnz_per_row
    order = np.argsort(-counts, kind="stable")

    bins = np.empty((ndev, rows_per), dtype=np.int64)
    for idx in range(n_pad):
        rnd, pos = divmod(idx, ndev)
        dev = pos if rnd % 2 == 0 else ndev - 1 - pos
        bins[dev, rnd] = order[idx]
    bins.sort(axis=1)  # ascending original ids within each device

    perm = bins.reshape(-1)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(n_pad)
    nnz_per_dev = counts[bins].sum(axis=1)
    return RowPartition(
        perm=perm,
        inv_perm=inv_perm,
        rows_per=rows_per,
        ndev=ndev,
        n_orig=n_orig,
        nnz_per_dev=nnz_per_dev,
    )


def build_local_blocks_split(rows, cols, vals, part: RowPartition):
    """Per-device local blocks split into OWNED-column and REMOTE-column
    parts (SURVEY §7 stage 5: halo exchange *overlapped with* the
    diagonal-block SpMV).

    The owned part touches only columns this device's vector shard already
    holds, so it is data-independent of the ``all_gather`` — XLA's
    latency-hiding scheduler can run the collective concurrently with it,
    and the remote part applies once the gathered vector lands.

    Returns two ``(cols, vals, plan)`` triples, each stacked on a leading
    device axis: the entries laid out as the level-0 chunks of a
    fixed-order row-sum plan (``ops.spmv.stacked_row_sums``), so every
    local product is bitwise reproducible.

    * owned: ``cols`` index the *local* shard (0..rows_per-1);
    * remote: ``cols`` index the all-gathered vector.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    pos_r = part.inv_perm[rows]
    pos_c = part.inv_perm[cols]
    dev = pos_r // part.rows_per
    lrow = pos_r - dev * part.rows_per
    owned = (pos_c // part.rows_per) == dev

    order = np.lexsort((lrow, dev))
    dev, lrow, pos_c, vals, owned = (
        dev[order], lrow[order], pos_c[order], vals[order], owned[order])

    def pack(mask, local_cols: bool):
        d_m, lrow_m, pos_m, val_m = dev[mask], lrow[mask], pos_c[mask], vals[mask]
        cvals = (pos_m - d_m * part.rows_per) if local_cols else pos_m
        starts = np.searchsorted(d_m, np.arange(part.ndev + 1))
        per_dev = [slice(starts[d], starts[d + 1]) for d in range(part.ndev)]
        plan, level0 = stacked_row_sums(
            [np.bincount(lrow_m[s], minlength=part.rows_per) for s in per_dev])
        lc, lv = zip(*(gather_entries(pos, s.stop - s.start, cvals[s], val_m[s])
                       for pos, s in zip(level0, per_dev)))
        return (np.stack(lc).astype(np.int32), np.stack(lv).astype(vals.dtype),
                plan)

    return pack(owned, True), pack(~owned, False)
