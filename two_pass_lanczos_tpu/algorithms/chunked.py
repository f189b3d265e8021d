"""In-run early stopping: chunked pass one with a live per-iteration callback.

The reference invokes a ``LanczosCallback`` inside the hot loop and *breaks
out of it* when the callback returns false, so an early stop skips the
remaining matvecs (``src/algorithms/lanczos.rs:93-113``,
``src/algorithms/mod.rs:69-86``). A single compiled ``lax.scan`` cannot host
a Python callback, so this module runs pass one as a host-driven sequence of
compiled *chunks* of ``chunk`` steps each:

* every chunk is one ``lax.scan`` over the **identical** step function used
  by :func:`~two_pass_lanczos_tpu.algorithms.core.pass_one_scan` (shared via
  :func:`~two_pass_lanczos_tpu.algorithms.core.make_pass_one_step`), so the
  computed coefficients are bit-equal to the monolithic scan's;
* between chunks the carry scalars (and, for the one-pass variant, the new
  basis rows) are read back and the user callback is replayed *per
  iteration* with the reference's exact view contract —
  ``callback(steps_taken, V_1..steps or None, (alphas[:s], betas[:s-1]))``
  returning ``True`` to continue (the basis view excludes v_{s+1}, which the
  reference writes only *after* the callback, and the callback fires even on
  the breakdown step, both matching ``lanczos.rs:86-113``);
* a stop at iteration ``s`` executes at most ``ceil(s/chunk)·chunk`` matvecs
  — the remaining ``k − ⌈s/chunk⌉·chunk`` matvecs never run, unlike the
  post-hoc :func:`~two_pass_lanczos_tpu.observability.replay_iterations`
  route which always pays all ``k``.

Cost model: each chunk boundary costs one host round-trip (a launch and a
small readback) plus, with ``emit_basis``, a (chunk, n)
basis transfer. Pick ``chunk`` to balance callback latency against the
per-chunk overhead; ``chunk=1`` reproduces the reference's per-iteration
cadence exactly. The fully-jitted :func:`~two_pass_lanczos_tpu.solvers
.solve_fAb` path remains available when no live callback is needed.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from two_pass_lanczos_tpu.algorithms.core import (
    LanczosDecomposition,
    init_carry,
    l2_norm,
    make_pass_one_step,
    zero_tolerance,
)
from two_pass_lanczos_tpu.operators import LinearOperator

__all__ = ["lanczos_pass_one_chunked", "lanczos_standard_chunked"]


@partial(jax.jit, static_argnums=(2, 3))
def _run_chunk(operator, carry, chunk: int, emit_basis: bool):
    step = make_pass_one_step(
        operator.matvec, carry.v_curr.dtype, emit_basis=emit_basis
    )
    return jax.lax.scan(step, carry, None, length=chunk)


def _chunked_pass_one(
    operator: LinearOperator,
    b,
    k: int,
    callback: Optional[Callable],
    chunk: int,
    emit_basis: bool,
):
    if k < 1:
        raise ValueError("k must be >= 1")
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    b = jnp.asarray(b)
    rdt = jnp.finfo(b.dtype).dtype
    b_norm = l2_norm(b)
    carry = init_carry(b, b_norm, zero_tolerance(b.dtype))

    rdt_np = np.dtype(rdt)
    a_all = np.zeros(k, dtype=rdt_np)  # filled incrementally per chunk
    b_all = np.zeros(k, dtype=rdt_np)
    # host basis buffer filled incrementally: each chunk's rows transfer
    # device->host exactly ONCE (a naive re-concatenate per boundary costs
    # O(k^2/chunk) transfer bytes)
    v_all = np.zeros((k, b.shape[0]), dtype=b.dtype) if (
        emit_basis and callback is not None) else None
    basis_parts = []
    filled = 0
    steps_prev = 0
    stop_at = None  # callback-requested stop (iteration index, 1-based)
    remaining = k
    while remaining > 0:
        c = min(chunk, remaining)
        carry, outs = _run_chunk(operator, carry, c, emit_basis)
        a_all[filled:filled + c] = np.asarray(outs[0])
        b_all[filled:filled + c] = np.asarray(outs[1])
        if emit_basis:
            basis_parts.append(outs[2])  # stays on device for the output
            if v_all is not None:
                v_all[filled:filled + c] = np.asarray(outs[2])
        filled += c
        remaining -= c
        steps_now = int(carry.steps)

        if callback is not None and steps_now > steps_prev:
            for s in range(steps_prev + 1, steps_now + 1):
                v_view = v_all[:s] if v_all is not None else None
                if not callback(s, v_view, (a_all[:s], b_all[: s - 1])):
                    stop_at = s
                    break
            if stop_at is not None:
                break
        steps_prev = steps_now
        if bool(carry.done):
            break

    executed = int(carry.steps)
    steps_final = stop_at if stop_at is not None else executed
    alphas = np.zeros(k, dtype=rdt)
    betas = np.zeros(k, dtype=rdt)
    alphas[:steps_final] = a_all[:steps_final]
    # keep the residual β at [steps_final-1] (the full-run convention of
    # LanczosDecomposition: the Lanczos-relation property needs β_k)
    betas[:steps_final] = b_all[:steps_final]

    decomp = LanczosDecomposition(
        alphas=jnp.asarray(alphas),
        betas=jnp.asarray(betas),
        steps_taken=jnp.asarray(steps_final, jnp.int32),
        b_norm=b_norm,
    )

    basis = None
    if emit_basis:
        rows = jnp.concatenate(basis_parts, axis=0)  # (ran, n), ran <= k
        if rows.shape[0] < k:
            rows = jnp.pad(rows, ((0, k - rows.shape[0]), (0, 0)))
        # zero rows beyond the stop point (chunk overshoot steps are valid
        # iterations but excluded by the early stop, like the reference's
        # right-sized copy at lanczos.rs:135-145)
        basis = jnp.where(
            (jnp.arange(k) < steps_final)[:, None], rows, jnp.zeros((), b.dtype)
        )
    return decomp, basis


def lanczos_pass_one_chunked(
    operator: LinearOperator,
    b,
    k: int,
    callback: Optional[Callable] = None,
    *,
    chunk: int = 16,
) -> LanczosDecomposition:
    """Pass one (scalars only, O(n) memory) with a live early-stop callback.

    ``callback(steps_taken, None, (alphas, betas)) -> bool`` is invoked after
    every iteration (replayed at chunk boundaries); returning ``False`` stops
    the iteration — at most the current chunk finishes, the remaining
    matvecs are skipped. Coefficients are bit-identical to
    :func:`~two_pass_lanczos_tpu.algorithms.two_pass.lanczos_pass_one`.
    """
    decomp, _ = _chunked_pass_one(operator, b, k, callback, chunk, False)
    return decomp


def lanczos_standard_chunked(
    operator: LinearOperator,
    b,
    k: int,
    callback: Optional[Callable] = None,
    *,
    chunk: int = 16,
) -> Tuple[LanczosDecomposition, jax.Array]:
    """One-pass Lanczos (basis stored) with a live early-stop callback.

    The callback receives the reference's exact view —
    ``callback(steps_taken, V[:steps_taken], (alphas, betas))`` — and a
    ``False`` return stops the loop in-run (reference
    ``src/algorithms/lanczos.rs:93-113``). Returns ``(decomposition, basis)``
    with ``basis`` of static shape ``(k, n)``, rows beyond ``steps_taken``
    zeroed.
    """
    decomp, basis = _chunked_pass_one(operator, b, k, callback, chunk, True)
    return decomp, basis
