"""Row-sharded sparse operator and distributed f(A)·b solves.

Execution model (BASELINE.json north star): the operator's rows and every
n-vector are sharded over a 1-D mesh axis; each Lanczos step inside the
jitted ``lax.scan`` does

1. ``all_gather`` of the current Krylov vector over the mesh axis (the
   remote-segment exchange), **overlapped with**
2. the OWNED-column part of the local row-block SpMV (fixed-order row
   sums, so every step is bitwise reproducible) — the local triplets
   are split host-side into owned-column (reads only this device's shard,
   data-independent of the collective, so XLA's latency-hiding scheduler
   runs them concurrently) and remote-column parts; the remote part applies
   once the gathered vector lands (SURVEY §7 stage 5),
3. the two scalar reductions (α dot product, β norm) as cross-device
   ``psum``s of local partials.

The whole two-pass pipeline — pass one, the replicated k×k projected solve,
and the reconstruction pass — lives inside **one** ``shard_map`` under one
``jit``, so XLA schedules collectives and compute together.

Numerical note: per-device-count reduction orders differ, so N-device results
match 1-device results to rounding tolerance (validated by tests), while the
two-pass exact-replay property (drift == 0) holds *within* any fixed device
count — the same guarantee the reference offers on one thread.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from two_pass_lanczos_tpu.algorithms.core import (
    LanczosCarry,
    LanczosDecomposition,
    f32_matmul_precision,
    init_carry,
    l2_norm,
    make_pass_one_step,
    pass_one_scan,
    zero_tolerance,
)
from two_pass_lanczos_tpu.algorithms.two_pass import _reconstruction_scan
from two_pass_lanczos_tpu.functions import padded_f_e1


def _stacked_y_local(decomp, f):
    """``f(T)e₁`` for one function spec or a tuple of them (multi-f: a
    ``(nf, k)`` stack from the same decomposition)."""
    multi = isinstance(f, tuple)
    fs = f if multi else (f,)
    y = jnp.stack([padded_f_e1(decomp, fi) for fi in fs])
    return y if multi else y[0]
from two_pass_lanczos_tpu.parallel.partition import (
    RowPartition,
    build_local_blocks_split,
    snake_partition,
)
from two_pass_lanczos_tpu.ops.spmv import SortedCOO, row_sums

__all__ = ["ShardedSparseOperator"]


def _local_matvec(blocks, x_local, axis):
    """y_local = (local row block of A) @ x, with x sharded over ``axis``.

    ``blocks = ((cols, vals, plan) owned, (cols, vals, plan) remote)`` —
    owned-column part (local column ids) and remote-column part
    (gathered-vector column ids), each reduced by its fixed row-sum plan.
    The owned product depends only on ``x_local``, NOT on the
    ``all_gather`` result: the collective and the diagonal-block SpMV are
    data-independent, which is what lets the compiler overlap them
    (asserted structurally by ``tests/test_collectives.py``)."""
    (c_o, v_o, plan_o), (c_r, v_r, plan_r) = blocks
    x_full = lax.all_gather(x_local, axis, tiled=True)
    owned = row_sums(plan_o, v_o * x_local.at[c_o].get(mode="promise_in_bounds"))
    remote = row_sums(plan_r, v_r * x_full.at[c_r].get(mode="promise_in_bounds"))
    return owned + remote


def _device_blocks(blocks):
    """Strip the sharded leading device axis from every block array."""
    return jax.tree.map(lambda a: a[0], blocks)


class ShardedSparseOperator:
    """A symmetric sparse operator row-partitioned over a 1-D device mesh.

    Build from COO triplets (or a :class:`SortedCOO`); rows are permuted for
    nnz balance (see ``partition.snake_partition``), vectors are padded to
    ``rows_per · ndev`` and sharded.

    Distribution is transparent at the API surface: ``solve_fAb`` accepts and
    returns ordinary (original-order, unpadded) vectors.
    """

    def __init__(
        self,
        n: int,
        rows,
        cols,
        vals,
        mesh: Mesh,
        axis: str = "rows",
        dtype=None,
    ):
        self.mesh = mesh
        self.axis = axis
        ndev = mesh.devices.size
        vals = np.asarray(vals)
        if dtype is not None:
            vals = vals.astype(dtype)
        self.dtype = vals.dtype

        nnz_per_row = np.bincount(np.asarray(rows, dtype=np.int64), minlength=n)
        self.part: RowPartition = snake_partition(nnz_per_row, ndev)
        owned, remote = build_local_blocks_split(rows, cols, vals, self.part)

        blk_sharding = NamedSharding(mesh, P(axis))
        self.local_blocks = jax.device_put((owned, remote), blk_sharding)
        self.vec_sharding = NamedSharding(mesh, P(axis))
        self._solve_cache = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_coo(cls, coo: SortedCOO, mesh: Mesh, axis: str = "rows"):
        rows, cols, vals = coo.host_triplets()
        return cls(coo.shape[0], rows, cols, vals, mesh, axis)

    @classmethod
    def from_kkt_arrays(cls, arrays, mesh: Mesh, axis: str = "rows", dtype=np.float64):
        """Directly from loader output — assembles the 5m KKT triplets."""
        m, p = arrays.num_arcs, arrays.num_nodes
        j = np.arange(m, dtype=np.int64)
        au = arrays.arc_u.astype(np.int64) + m
        av = arrays.arc_v.astype(np.int64) + m
        rows = np.concatenate([j, au, av, j, j])
        cols = np.concatenate([j, j, j, au, av])
        ones = np.ones(m, dtype=dtype)
        vals = np.concatenate([arrays.quad_costs.astype(dtype), ones, -ones, ones, -ones])
        return cls(m + p, rows, cols, vals, mesh, axis, dtype=dtype)

    # ------------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        n = self.part.n_orig
        return (n, n)

    @property
    def nnz_per_device(self) -> np.ndarray:
        return self.part.nnz_per_dev

    def _prepare_b(self, b) -> jax.Array:
        b = np.asarray(b)
        if b.shape[0] != self.part.n_orig:
            raise ValueError(f"b has length {b.shape[0]}, operator is {self.part.n_orig}")
        bp = np.zeros(self.part.n_pad, dtype=self.dtype)
        bp[: self.part.n_orig] = b
        bp = bp[self.part.perm]
        # make_array_from_callback materializes only each process's
        # addressable shards, so the same code runs single-process and
        # multi-host (a plain device_put of the full array cannot)
        return jax.make_array_from_callback(
            bp.shape, self.vec_sharding, lambda idx: bp[idx])

    def _restore_x(self, x_perm) -> np.ndarray:
        # last axis is the (padded, permuted) row axis; a leading nf axis
        # (multi-f solves) passes through untouched
        x = np.asarray(x_perm)[..., self.part.inv_perm]
        return x[..., : self.part.n_orig]

    # ------------------------------------------------------------------
    def _build_solve(self, k: int, f, method: str, reorth: bool = False):
        axis = self.axis

        def run(blocks, b_local):
            blocks = _device_blocks(blocks)
            matvec = lambda x: _local_matvec(blocks, x, axis)
            reduce_sum = lambda s: lax.psum(s, axis)
            if reorth == "selective":
                # ω bookkeeping is replicated scalar math; only the CGS
                # projections and norms psum across the mesh
                from two_pass_lanczos_tpu.algorithms.reorth import (
                    pass_one_scan_selective,
                )

                decomp, basis, _ = pass_one_scan_selective(
                    matvec, b_local, k, reduce_sum=reduce_sum
                )
            elif reorth:
                # basis rows are n-sharded like every Krylov vector; the
                # CGS projections psum (k,)-shaped partials per sweep
                from two_pass_lanczos_tpu.algorithms.reorth import (
                    pass_one_scan_reorth,
                )

                decomp, basis = pass_one_scan_reorth(
                    matvec, b_local, k, reduce_sum=reduce_sum
                )
            else:
                emit = method == "one_pass"
                decomp, basis = pass_one_scan(
                    matvec, b_local, k, emit_basis=emit, reduce_sum=reduce_sum
                )
            # replicated k×k solve on every device; a tuple f evaluates a
            # stack of functions from the same decomposition (multi-f)
            y = _stacked_y_local(decomp, f)
            y = (y * decomp.b_norm).astype(b_local.dtype)
            if method == "one_pass":
                # HIGHEST — same rationale as solvers._gemv_reconstruct
                x_local = jnp.einsum("kn,...k->...n", basis, y,
                                     precision=jax.lax.Precision.HIGHEST)
            else:
                x_local, _ = _reconstruction_scan(
                    matvec, b_local, decomp, y, emit_basis=False
                )
            return (x_local, decomp.alphas, decomp.betas,
                    decomp.steps_taken, decomp.b_norm)

        x_spec = P(None, axis) if isinstance(f, tuple) else P(axis)
        shmapped = jax.shard_map(
            run,
            mesh=self.mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=(x_spec, P(), P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(shmapped)

    def _solver(self, k: int, f, method: str, reorth: bool = False):
        key = (k, f, method, reorth)
        if key not in self._solve_cache:
            self._solve_cache[key] = self._build_solve(k, f, method, reorth)
        return self._solve_cache[key]

    # -- chunked pass one (live early-stop callback) --------------------

    def _build_p1_init(self):
        axis = self.axis

        def run(blocks, b_local):
            del blocks  # same signature as the chunk for symmetry
            rs = lambda s: lax.psum(s, axis)
            b_norm = l2_norm(b_local, rs)
            c = init_carry(b_local, b_norm, zero_tolerance(b_local.dtype))
            return c.v_prev, c.v_curr, c.beta_prev, c.done, c.steps, b_norm

        shmapped = jax.shard_map(
            run, mesh=self.mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(), P(), P(), P()),
            check_vma=False)
        return jax.jit(shmapped)

    def _build_p1_chunk(self, chunk: int):
        axis = self.axis

        def run(blocks, vp, vc, bp, done, steps):
            blocks = _device_blocks(blocks)
            matvec = lambda x: _local_matvec(blocks, x, axis)
            rs = lambda s: lax.psum(s, axis)
            step = make_pass_one_step(matvec, vc.dtype, emit_basis=False,
                                      reduce_sum=rs)
            carry0 = LanczosCarry(vp, vc, bp, done, steps)
            carry, outs = lax.scan(step, carry0, None, length=chunk)
            return (carry.v_prev, carry.v_curr, carry.beta_prev,
                    carry.done, carry.steps, outs[0], outs[1])

        shmapped = jax.shard_map(
            run, mesh=self.mesh,
            in_specs=(P(axis),
                      P(axis), P(axis), P(), P(), P()),
            out_specs=(P(axis), P(axis), P(), P(), P(), P(), P()),
            check_vma=False)
        return jax.jit(shmapped)

    def _build_p2_finish(self, k2: int, f):
        """Pass two compiled at scan length ``k2`` — an early stop at step s
        pays exactly s reconstruction matvecs per device."""
        axis = self.axis

        def run(blocks, b_local, alphas, betas, steps, b_norm):
            blocks = _device_blocks(blocks)
            matvec = lambda x: _local_matvec(blocks, x, axis)
            decomp = LanczosDecomposition(
                alphas=alphas, betas=betas, steps_taken=steps, b_norm=b_norm)
            y = _stacked_y_local(decomp, f)
            y = (y * b_norm).astype(b_local.dtype)
            x_local, _ = _reconstruction_scan(
                matvec, b_local, decomp, y, emit_basis=False)
            return x_local

        shmapped = jax.shard_map(
            run, mesh=self.mesh,
            in_specs=(P(axis), P(axis),
                      P(), P(), P(), P()),
            out_specs=P(None, axis) if isinstance(f, tuple) else P(axis),
            check_vma=False)
        return jax.jit(shmapped)

    def pass_one_chunked(self, b, k: int, callback=None, chunk: int = 16):
        """Pass one with a live per-iteration callback over the mesh — the
        reference's in-loop ``LanczosCallback`` break-out
        (``src/algorithms/mod.rs:69-86``) on the generic row partition.

        Between ``chunk``-step compiled launches the replicated (α, β, steps) are
        read back and ``callback(s, None, (alphas[:s], betas[:s-1]))`` is
        replayed per iteration; a stop at step s costs at most
        ceil(s/chunk)·chunk matvecs per device. Returns
        ``(decomposition, stopped)``.
        """
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        b_local = self._prepare_b(b)
        if "p1_init" not in self._solve_cache:
            self._solve_cache["p1_init"] = self._build_p1_init()
        vp, vc, bp, done, steps_a, b_norm = self._solve_cache["p1_init"](
            self.local_blocks, b_local)
        rdt = np.dtype(self.dtype)
        alphas = np.zeros(k, rdt)
        betas = np.zeros(k, rdt)
        visited = 0
        stopped = False
        self._last_p1_launches = 0
        remaining = k
        while remaining > 0:
            c = min(chunk, remaining)
            key = ("p1_chunk", c)
            if key not in self._solve_cache:
                self._solve_cache[key] = self._build_p1_chunk(c)
            (vp, vc, bp, done, steps_a, a_c, b_c) = self._solve_cache[key](
                self.local_blocks, vp, vc, bp, done, steps_a)
            self._last_p1_launches += 1
            remaining -= c
            steps_now = int(np.asarray(steps_a))
            got = steps_now - visited
            if got > 0:
                alphas[visited:steps_now] = np.asarray(a_c)[:got]
                betas[visited:steps_now] = np.asarray(b_c)[:got]
            if callback is not None:
                for s in range(visited + 1, steps_now + 1):
                    if not callback(s, None, (alphas[:s], betas[: s - 1])):
                        visited = s
                        stopped = True
                        break
                else:
                    visited = steps_now
            else:
                visited = steps_now
            if stopped or bool(np.asarray(done)) or steps_now >= k:
                break
        steps = visited
        alphas[steps:] = 0.0
        betas[max(steps - 1, 0) if stopped else steps:] = 0.0
        decomp = LanczosDecomposition(
            alphas=jnp.asarray(alphas), betas=jnp.asarray(betas),
            steps_taken=jnp.asarray(steps, jnp.int32),
            b_norm=jnp.asarray(b_norm))
        return decomp, stopped

    def solve_fAb(self, b, *, k: int, f="exp", method: str = "two_pass",
                  raw: bool = False, callback=None, callback_chunk: int = 16,
                  reorth: bool = False):
        """Distributed f(A)·b. Returns ``(x, decomposition)``.

        ``x`` is a NumPy array in original row order; the decomposition's
        (α, β, steps) are replica-identical device arrays. Multi-host runs
        must use ``raw=True`` (``x`` stays the sharded, row-permuted device
        array — unpacking requires every shard to be process-addressable);
        the decomposition is replicated and host-readable everywhere.

        ``callback`` (two_pass only) enables in-run early stopping via
        :meth:`pass_one_chunked`; a stop at step s runs a pass two compiled
        at scan length s, so the solve pays ceil(s/chunk)·chunk + s matvecs
        per device instead of 2k.

        ``f`` may be a tuple of function specs — all evaluated from one
        decomposition for one run's matvecs (``x`` gains a leading nf axis).

        ``reorth=True`` (one-pass only, beyond the reference) runs the
        fully reorthogonalized recurrence (``algorithms/reorth.py``) with
        the basis row-sharded along n — each CGS sweep psums one
        (k,)-vector of projection partials per step.
        """
        from two_pass_lanczos_tpu.solvers import reorth_mode

        reorth = reorth_mode(reorth) or False  # normalize; reject typos
        if reorth:
            if method != "one_pass":
                raise ValueError(
                    "reorth= requires method='one_pass' (the stored "
                    "basis it orthogonalizes against is the one-pass state)")
            if callback is not None:
                raise ValueError(
                    "reorth= is not supported together with callback=")
        if callback is not None:
            if method != "two_pass":
                raise ValueError(
                    "callback early stopping is implemented for the "
                    "two_pass method")
            decomp, _stopped = self.pass_one_chunked(
                b, k, callback=callback, chunk=callback_chunk)
            steps = int(np.asarray(decomp.steps_taken))
            k2 = max(steps, 1)
            self._last_p2_len = k2
            key = ("p2_finish", k2, f)
            if key not in self._solve_cache:
                self._solve_cache[key] = self._build_p2_finish(k2, f)
            # truncated views compile the finish at length k2 while the
            # returned decomposition keeps the uniform length-k arrays
            x_perm = self._solve_cache[key](
                self.local_blocks, self._prepare_b(b),
                decomp.alphas[:k2], decomp.betas[:k2],
                decomp.steps_taken, decomp.b_norm)
            if raw:
                return x_perm, decomp
            return self._restore_x(x_perm), decomp
        b_local = self._prepare_b(b)
        x_perm, alphas, betas, steps, b_norm = self._solver(
            k, f, method, reorth)(self.local_blocks, b_local)
        if raw:
            return x_perm, LanczosDecomposition(
                alphas=alphas, betas=betas, steps_taken=steps, b_norm=b_norm)
        # b_norm is the device-side psum norm that actually scaled x — the
        # returned decomposition replays bit-consistently with the result
        decomp = LanczosDecomposition(
            alphas=alphas, betas=betas, steps_taken=steps, b_norm=b_norm,
        )
        return self._restore_x(x_perm), decomp

    # ------------------------------------------------------------------
    @f32_matmul_precision  # CGS2/restart GEMMs — see core.f32_matmul_precision
    def eigsh(self, nev: int = 6, *, which: str = "LA", ncv=None,
              tol: float = 1e-8, maxiter: int = 100, v0=None, key=None,
              _restore_vectors: bool = True):
        """Distributed thick-restart Lanczos eigenpairs over the row
        partition — :func:`eigen.eigsh` with the (ncv+1, n) basis
        column-sharded along the mesh axis.

        Per expansion step: one local SpMV (+ halo all_gather) and two
        CGS2 sweeps whose (ncv+1,) projection partials psum across the
        mesh; the ncv×ncv Rayleigh–Ritz ``eigh`` is replicated per device
        (the `_stacked_y_local` pattern). Random injections past invariant
        subspaces are masked to the valid (non-padded) rows — the row
        padding's spurious zero eigenvalues can never enter the Krylov
        space — and decorrelated per device by folding in ``axis_index``.
        Returns :class:`eigen.EigshResult` with eigenvectors restored to
        original row order (single-process meshes; the eigenvalues and
        residuals are replicated and host-readable everywhere).
        """
        from two_pass_lanczos_tpu.eigen import (
            EigshResult,
            _eigsh_driver,
            _expand_and_ritz,
            _ritz_vectors,
            _thick_restart,
            eigsh_thickness,
            validate_eigsh_params,
        )

        n = self.part.n_orig
        ncv = validate_eigsh_params(n, nev, ncv, which, maxiter)
        ell = eigsh_thickness(nev, ncv)
        axis = self.axis
        rdt = np.dtype(self.dtype)
        if key is None:
            key = jax.random.key(0)
        key, sub = jax.random.split(key)
        if v0 is None:
            v0 = jax.random.normal(sub, (n,), rdt)
        v0 = np.asarray(v0, rdt)
        if float(np.linalg.norm(v0)) == 0.0:
            raise ValueError("v0 must be nonzero")
        b_local = self._prepare_b(v0)  # padded, permuted, sharded P(axis)
        valid = (self.part.perm < n).astype(rdt)
        # multi-host-safe materialization (same reason as _prepare_b)
        valid_local = jax.make_array_from_callback(
            valid.shape, self.vec_sharding, lambda idx: valid[idx])

        ck = ("eigsh", ncv)
        if ck not in self._solve_cache:

            def init(b_loc):
                nrm = l2_norm(b_loc, lambda s: lax.psum(s, axis))
                v = jnp.zeros((ncv + 1,) + b_loc.shape, b_loc.dtype)
                return v.at[0].set(b_loc / nrm.astype(b_loc.dtype))

            def cycle(blocks, v, h, start, k_in, mask_loc):
                blocks = _device_blocks(blocks)
                matvec = lambda x: _local_matvec(blocks, x, axis)
                rs = lambda s: lax.psum(s, axis)
                fold = lambda kk: jax.random.fold_in(
                    kk, lax.axis_index(axis))
                return _expand_and_ritz(
                    matvec, v, h, start, k_in,
                    reduce_sum=rs, inject_mask=mask_loc, inject_fold=fold)

            self._solve_cache[ck] = (
                jax.jit(jax.shard_map(
                    init, mesh=self.mesh,
                    in_specs=(P(axis),), out_specs=P(None, axis),
                    check_vma=False)),
                jax.jit(jax.shard_map(
                    cycle, mesh=self.mesh,
                    in_specs=(P(axis), P(None, axis),
                              P(), P(), P(), P(axis)),
                    out_specs=(P(None, axis), P(), P(), P(), P(), P()),
                    check_vma=False)),
                jax.jit(jax.shard_map(
                    _thick_restart, mesh=self.mesh,
                    in_specs=(P(None, axis), P(), P(), P()),
                    out_specs=(P(None, axis), P()),
                    check_vma=False)),
                jax.jit(jax.shard_map(
                    _ritz_vectors, mesh=self.mesh,
                    in_specs=(P(None, axis), P(), P()),
                    out_specs=P(None, axis),
                    check_vma=False)),
            )
        init_f, cycle_f, restart_f, ritzvec_f = self._solve_cache[ck]

        v_basis = init_f(b_local)
        h_proj = jnp.zeros((ncv, ncv), rdt)
        theta, vectors_d, resid, restarts, converged = _eigsh_driver(
            lambda v, h, s, k: cycle_f(self.local_blocks, v, h, s, k,
                                       valid_local),
            restart_f, ritzvec_f, v_basis, h_proj,
            nev=nev, ell=ell, which=which, tol=tol, maxiter=maxiter, key=key)
        return EigshResult(
            eigenvalues=theta,
            # eigenvector restoration fetches the row-sharded global
            # array — single-process meshes only (docstring); internal
            # eigenvalue-only callers (estimate_interval) skip it so the
            # multi-host path never touches non-addressable shards
            eigenvectors=(self._restore_x(vectors_d)
                          if _restore_vectors else None),
            residual_norms=resid,
            restarts=restarts,
            converged=converged,
        )

    # ------------------------------------------------------------------
    def slq_trace(self, f="inv", *, k: int = 50, num_probes: int = 16,
                  key, probe: str = "rademacher"):
        """Distributed stochastic Lanczos quadrature ``tr f(A)`` — the
        :func:`slq.slq_trace` estimator with every probe's recurrence
        running over the row partition.

        All ``num_probes`` recurrences execute as one vmapped scan INSIDE
        one ``shard_map``: the per-step collectives batch across probes
        (one (m,)-shaped psum per reduction instead of m scalar psums),
        and the m quadratures are one replicated batched ``eigh``. Probes
        are drawn host-side in original row order, so the estimate matches
        the single-device estimator for the same key up to reduction
        rounding. The row padding stays zero through the recurrence and
        contributes nothing.
        """
        from two_pass_lanczos_tpu.slq import (
            _draw_probes,
            _f_of_theta,
            batched_quadratic_form,
            slq_stats,
        )

        if num_probes < 1:
            raise ValueError("num_probes must be >= 1")
        if not callable(f):
            _f_of_theta(jnp.ones(1), f)  # reject unknown strings early
        n = self.part.n_orig
        rdt = np.dtype(self.dtype)
        probes = np.asarray(_draw_probes(key, num_probes, n, rdt, probe))
        decomp = self._slq_pass_one(probes, k)
        return slq_stats(batched_quadratic_form(decomp, f))

    def slq_spectral_density(self, grid, *, sigma=None, k: int = 50,
                             num_probes: int = 16, key,
                             probe: str = "gaussian"):
        """Distributed smoothed spectral density (DOS): the unit probes'
        pass one runs over the row partition (one vmapped scan inside one
        shard_map, like :meth:`slq_trace`); the KDE half is the shared
        :func:`slq.dos_from_decomposition` on the replicated
        decomposition."""
        from two_pass_lanczos_tpu.slq import (
            _draw_probes,
            dos_from_decomposition,
            validate_dos_params,
        )

        grid, sigma = validate_dos_params(grid, sigma, num_probes)
        rdt = np.dtype(self.dtype)
        probes = np.asarray(_draw_probes(
            key, num_probes, self.part.n_orig, rdt, probe))
        probes = probes / np.linalg.norm(probes, axis=1, keepdims=True)
        decomp = self._slq_pass_one(probes.astype(rdt), k)
        return dos_from_decomposition(
            decomp, grid.astype(rdt), jnp.asarray(sigma, rdt))

    def _slq_pass_one(self, probes: np.ndarray, k: int):
        """Batched pass one for (m, n) host probes over the row
        partition; returns the replicated stacked decomposition."""
        num_probes, n = probes.shape
        rdt = np.dtype(self.dtype)
        # pad + permute each probe row, shard as (m, n_pad) over the axis
        pp = np.zeros((num_probes, self.part.n_pad), rdt)
        pp[:, :n] = probes
        pp = pp[:, self.part.perm]
        probes_sharded = jax.make_array_from_callback(
            pp.shape, NamedSharding(self.mesh, P(None, self.axis)),
            lambda idx: pp[idx])

        ck = ("slq", k, num_probes)
        if ck not in self._solve_cache:
            axis = self.axis

            def run(blocks, probes_local):
                blocks = _device_blocks(blocks)
                matvec = lambda x: _local_matvec(blocks, x, axis)
                rs = lambda s: lax.psum(s, axis)

                def solo(b_loc):
                    return pass_one_scan(matvec, b_loc, k,
                                         emit_basis=False, reduce_sum=rs)[0]

                decomp = jax.vmap(solo)(probes_local)
                return decomp.alphas, decomp.betas, decomp.steps_taken, \
                    decomp.b_norm

            self._solve_cache[ck] = jax.jit(jax.shard_map(
                run, mesh=self.mesh,
                in_specs=(P(axis), P(None, axis)),
                out_specs=(P(), P(), P(), P()),
                check_vma=False))
        alphas, betas, steps, b_norm = self._solve_cache[ck](
            self.local_blocks, probes_sharded)
        return LanczosDecomposition(alphas=alphas, betas=betas,
                                    steps_taken=steps, b_norm=b_norm)


    def slq_trace_adaptive(self, f="inv", *, k: int = 50, key,
                           probe: str = "rademacher",
                           target_rel_stderr: float = 0.01,
                           batch: int = 8, max_probes: int = 512):
        """:meth:`slq_trace` with the probe count chosen adaptively —
        the shared :func:`slq.adaptive_probe_loop` driver drawing
        ``batch`` probes per round through THIS tier's kernel path until
        the sample standard error certifies ``target_rel_stderr`` (or
        ``max_probes``). One compiled shape per distinct batch size."""
        from two_pass_lanczos_tpu.slq import adaptive_probe_loop

        return adaptive_probe_loop(
            lambda sub, take: self.slq_trace(
                f, k=k, num_probes=take, key=sub, probe=probe).samples,
            key, batch=batch, max_probes=max_probes,
            target_rel_stderr=target_rel_stderr)

    # ------------------------------------------------------------------
    @f32_matmul_precision  # block GEMMs/Grams — see core.f32_matmul_precision
    def solve_fAb_block(self, b_block, *, k: int, f="exp", raw: bool = False):
        """Distributed block Lanczos f(A)·B over the row partition.

        The single-device :func:`algorithms.block.block_pass_one` uses
        Householder QR for the block normalization, which has no
        distributed form; here the tall-skinny factorization is
        **CholeskyQR2** (Yamamoto et al. 2015) — two rounds of
        ``R = chol(psum(WᵀW))ᵀ; V = W·R⁻¹`` — whose only collectives are
        p×p Gram psums, the block-width analogue of the scalar β psum.
        Two rounds restore orthonormality to working precision for any
        block the rank test admits; the sign convention (positive chol
        diagonal) matches the single-device positive-diagonal R, so the
        two implementations agree to rounding (pinned at {1,2,8}
        devices). Rank breakdown (NaN cholesky or a relative diagonal
        collapse) truncates gracefully via ``steps_taken``, like every
        other path. The projected f(T) solve is the shared host-side
        block solver. Multi-host: ``raw=True`` (see :meth:`solve_fAb`).
        """
        from two_pass_lanczos_tpu.algorithms.block import (
            _assemble_t,
            BlockDecomposition,
        )
        from two_pass_lanczos_tpu.spectrum import _f_of_theta

        if not callable(f):
            _f_of_theta(np.ones(1), f)
        if k < 1:
            raise ValueError("k must be >= 1")
        b_block = np.asarray(b_block)
        if b_block.ndim != 2:
            raise ValueError(f"b_block must be (n, p), got {b_block.shape}")
        n, p = b_block.shape
        if n != self.part.n_orig:
            raise ValueError(
                f"b_block has {n} rows, operator is {self.part.n_orig}")
        if p < 1 or p > n:
            raise ValueError(f"block width p={p} must be in [1, n={n}]")
        rdt = np.dtype(self.dtype)
        if (np.iscomplexobj(b_block)
                and not np.issubdtype(rdt, np.complexfloating)):
            raise TypeError(
                "complex b_block with a real operator; build the "
                "ShardedSparseOperator with complex vals for a "
                "Hermitian A (the block path is self-adjoint-generic)")
        bp = np.zeros((self.part.n_pad, p), rdt)
        bp[:n] = b_block
        bp = bp[self.part.perm]
        b_sharded = jax.make_array_from_callback(
            bp.shape, NamedSharding(self.mesh, P(self.axis, None)),
            lambda idx: bp[idx])

        ck = ("block", k, p)
        if ck not in self._solve_cache:
            axis = self.axis
            from two_pass_lanczos_tpu.algorithms.core import (
                breakdown_tolerance,
            )

            tol = breakdown_tolerance(rdt)

            def run(blocks, b_loc):
                blocks = _device_blocks(blocks)
                matvec = lambda x: _local_matvec(blocks, x, axis)
                block_mv = jax.vmap(matvec, in_axes=1, out_axes=1)
                rs = lambda s: lax.psum(s, axis)

                def chol_qr2(w, ref_scale):
                    """Distributed tall-skinny QR: (V, R, ok).

                    ``ref_scale`` is the external scale for the rank test
                    (the single-device ``rank_ok`` contract,
                    ``algorithms/block.py``): an invariant-subspace
                    residual W ~ ε‖A‖ is pure rounding noise whose OWN
                    diagonal ratio is O(1) — only comparison against the
                    recurrence scale max|diag(a_j)| detects it.
                    """
                    def one_round(v_in):
                        g = rs(jnp.conj(v_in).T @ v_in)  # Gram = VᴴV
                        c = jnp.linalg.cholesky(g)  # lower; R = cᴴ
                        ok_r = jnp.logical_not(jnp.any(jnp.isnan(c)))
                        safe_c = jnp.where(ok_r, c, jnp.eye(p, dtype=v_in.dtype))
                        # V = W·R⁻¹ ⇔ Rᵀ·Vᵀ = Wᵀ with Rᵀ = (cᴴ)ᵀ = conj(c)
                        # (conj folds away on real dtypes)
                        from jax.scipy.linalg import solve_triangular

                        v_out = solve_triangular(
                            jnp.conj(safe_c), v_in.T, lower=True).T
                        return v_out, jnp.conj(safe_c).T, ok_r

                    v1, r1, ok1 = one_round(w)
                    v2, r2, ok2 = one_round(v1)
                    r = r2 @ r1
                    diag = jnp.abs(jnp.diagonal(r))
                    scale = jnp.maximum(jnp.max(diag), ref_scale)
                    full = jnp.min(diag) > tol * scale
                    return v2, r, jnp.logical_and(
                        jnp.logical_and(ok1, ok2), full)

                from two_pass_lanczos_tpu.algorithms.core import (
                    _real_dtype,
                )

                # real dtype: the rank test compares |diag| magnitudes
                v0, r0, ok0 = chol_qr2(
                    b_loc, jnp.zeros((), _real_dtype(b_loc.dtype)))
                v0 = jnp.where(ok0, v0, 0.0)

                def step(carry, _):
                    v_prev, v_curr, b_prev, done, steps = carry
                    executed = jnp.logical_not(done)
                    adj = lambda m: jnp.conj(m).T  # identity on real
                    w = block_mv(v_curr)
                    w = w - v_prev @ adj(b_prev)
                    a_j = rs(adj(v_curr) @ w)
                    a_j = 0.5 * (a_j + adj(a_j))
                    w = w - v_curr @ a_j
                    c_prev = rs(adj(v_prev) @ w)
                    c_curr = rs(adj(v_curr) @ w)
                    w = w - v_prev @ c_prev - v_curr @ c_curr
                    a_j = a_j + 0.5 * (c_curr + adj(c_curr))
                    v_next, b_j, ok = chol_qr2(
                        w, jnp.max(jnp.abs(jnp.diagonal(a_j))))
                    advance = jnp.logical_and(executed, ok)
                    a_out = jnp.where(executed, a_j, jnp.zeros_like(a_j))
                    b_out = jnp.where(advance, b_j, jnp.zeros_like(b_j))
                    v_out = jnp.where(executed, v_curr,
                                      jnp.zeros_like(v_curr))
                    carry = (
                        jnp.where(advance, v_curr, v_prev),
                        jnp.where(advance, v_next, v_curr),
                        jnp.where(advance, b_j, b_prev),
                        jnp.logical_or(done, jnp.logical_not(ok)),
                        steps + executed.astype(jnp.int32),
                    )
                    return carry, (a_out, b_out, v_out)

                carry0 = (jnp.zeros_like(v0), v0,
                          jnp.zeros((p, p), b_loc.dtype),
                          jnp.logical_not(ok0), jnp.zeros((), jnp.int32))
                carry, (a_b, b_b, basis) = lax.scan(
                    step, carry0, None, length=k)
                r0 = jnp.where(ok0, r0, jnp.zeros_like(r0))
                return a_b, b_b, r0, carry[4], basis

            self._solve_cache[ck] = jax.jit(jax.shard_map(
                run, mesh=self.mesh,
                in_specs=(P(axis), P(axis, None)),
                out_specs=(P(), P(), P(), P(), P(None, axis, None)),
                check_vma=False))
        a_b, b_b, r0, steps, basis = self._solve_cache[ck](
            self.local_blocks, b_sharded)
        decomp = BlockDecomposition(a_blocks=a_b, b_blocks=b_b, r0=r0,
                                    steps_taken=steps)
        s = int(steps)
        self._last_block_steps = s  # diagnostic (cf. _last_p1_launches)
        if s == 0:  # zero / rank-deficient B: graceful zeros
            return jnp.zeros_like(b_sharded) if raw else np.zeros((n, p), rdt)
        t = _assemble_t(decomp)
        lam, q = np.linalg.eigh(t)
        flam = _f_of_theta(lam, f)
        e1 = np.zeros((s * p, p))
        e1[:p, :p] = np.eye(p)
        y = (q * flam) @ (q.conj().T @ (e1 @ np.asarray(r0, t.dtype)))
        y_pad = np.zeros((k, p, p), t.dtype)
        y_pad[:s] = y.reshape(s, p, p)
        x = jnp.einsum("knp,kpq->nq", basis, jnp.asarray(y_pad, rdt))
        if raw:
            return x
        return self._restore_x(np.asarray(x).T).T

    # ------------------------------------------------------------------
    def estimate_interval(self, *, margin: float = 0.05, tol: float = 1e-3,
                          key=None):
        """Spectral interval [a, b] ⊇ spec(A) via two 1-eigenpair runs of
        the DISTRIBUTED :meth:`eigsh` (LA + SA), widened by the residual
        norms plus ``margin`` — the mesh counterpart of
        :func:`algorithms.chebyshev.estimate_interval` (same widening
        helper, so the padding semantics are identical)."""
        from two_pass_lanczos_tpu.algorithms.chebyshev import (
            interval_from_extremes,
        )

        if key is None:
            key = jax.random.key(0)
        k_lo, k_hi = jax.random.split(key)
        ncv = min(20, self.part.n_orig)
        hi = self.eigsh(nev=1, which="LA", tol=tol, ncv=ncv, key=k_hi,
                        _restore_vectors=False)
        lo = self.eigsh(nev=1, which="SA", tol=tol, ncv=ncv, key=k_lo,
                        _restore_vectors=False)
        return interval_from_extremes(hi, lo, margin)

    def chebyshev_fAb(self, b, f, *, degree: int = 100, interval=None,
                      raw: bool = False):
        """Distributed Chebyshev-expansion f(A)·b: ``degree`` local SpMVs
        under one ``shard_map``-ped scan, O(n/ndev) memory per device and
        ZERO collectives beyond the matvec's own halo exchange (the
        three-term recurrence has no inner products — unlike Lanczos'
        2 psums per step).

        ``interval`` must contain spec(A); ``None`` estimates it with
        :meth:`estimate_interval` (two distributed 1-eigenpair ``eigsh``
        runs — pass a cached/known interval to skip that cost on repeated
        solves). The row padding is invariant under the recurrence
        (padded entries of b are zero and A's padded rows are empty), so
        the padded operator's spurious zero eigenvalues never contribute.
        Multi-host runs must use ``raw=True``.
        """
        from two_pass_lanczos_tpu.algorithms.chebyshev import (
            chebyshev_coefficients,
            chebyshev_scan,
            validate_interval_for_f,
        )

        if interval is None:
            interval = self.estimate_interval()
        a_lo, a_hi = float(interval[0]), float(interval[1])
        validate_interval_for_f(f, a_lo, a_hi)
        rdt = np.dtype(self.dtype)
        cs = jnp.asarray(chebyshev_coefficients(f, interval, degree), rdt)
        scale = jnp.asarray(
            [2.0 / (a_hi - a_lo), (a_hi + a_lo) / (a_hi - a_lo)], rdt)

        key = ("chebyshev", degree)
        if key not in self._solve_cache:
            axis = self.axis

            def run(blocks, b_local, cs_rep, scale_rep):
                blocks = _device_blocks(blocks)
                matvec = lambda x: _local_matvec(blocks, x, axis)
                return chebyshev_scan(matvec, b_local, cs_rep, scale_rep)

            self._solve_cache[key] = jax.jit(jax.shard_map(
                run, mesh=self.mesh,
                in_specs=(P(axis), P(axis), P(), P()),
                out_specs=P(axis),
                check_vma=False))
        x_perm = self._solve_cache[key](
            self.local_blocks, self._prepare_b(b), cs, scale)
        if raw:
            return x_perm
        return self._restore_x(x_perm)

    # ------------------------------------------------------------------
    def matvec_distributed(self, x, raw: bool = False):
        """One distributed SpMV (for tests/benchmarks); original order
        in/out. Multi-host runs must pass ``raw=True`` (the permuted sharded
        device array is returned; unpacking needs every shard
        process-addressable)."""
        axis = self.axis

        if "matvec" not in self._solve_cache:  # compile once, reuse per call

            def run(blocks, x_local):
                blocks = _device_blocks(blocks)
                return _local_matvec(blocks, x_local, axis)

            self._solve_cache["matvec"] = jax.jit(
                jax.shard_map(
                    run,
                    mesh=self.mesh,
                    in_specs=(P(axis), P(axis)),
                    out_specs=P(axis),
                    check_vma=False,
                )
            )
        y = self._solve_cache["matvec"](self.local_blocks, self._prepare_b(x))
        if raw:
            return y
        return self._restore_x(y)
