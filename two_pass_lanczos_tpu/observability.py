"""Observability: iteration callbacks, profiling, speed-of-light accounting.

Reference parity and adaptation to compiled scans:

* **Per-iteration callback** — the reference invokes a ``LanczosCallback``
  with ``(k, V_k view, T_k view)`` inside the hot loop with early-stop
  (``src/algorithms/mod.rs:69-86``, ``lanczos.rs:93-106``). A Python callback
  inside a compiled ``lax.scan`` would force a host sync per step, so the
  equivalent here is **post-hoc replay**: :func:`replay_iterations` feeds the
  callback the same ``(k, V_k, T_k)`` views reconstructed from the scan
  outputs at zero extra device compute, and :func:`find_stopping_point`
  returns the step where the callback would have stopped (usable to truncate
  the decomposition before the projected solve and pass two — which is
  exactly the effect early stopping has in the reference).
* **Profiling** — ``jax.profiler`` trace contexts replacing the reference's
  ``Instant``-based timing (``tradeoff.rs:267-287``).
* **Speed-of-light model** — the per-matvec byte accounting: achieved nnz/s
  against the device-memory bandwidth bound of the device it ran on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
from typing import Callable, Optional

import numpy as np

from two_pass_lanczos_tpu.algorithms.core import LanczosDecomposition

__all__ = [
    "replay_iterations",
    "find_stopping_point",
    "truncate_decomposition",
    "trace",
    "PEAK_HBM_BYTES_PER_S",
    "peak_hbm_bandwidth",
    "card_line",
    "SoLReport",
    "kkt_spmv_sol",
]


def replay_iterations(
    decomposition: LanczosDecomposition,
    callback: Callable,
    basis: Optional[np.ndarray] = None,
) -> int:
    """Invoke ``callback(k, v_k, (alphas, betas))`` for k = 1..steps_taken.

    ``v_k`` is the (k, n) basis prefix if ``basis`` was captured (one-pass),
    else None. Returns the number of iterations visited: the callback returns
    False to stop early, mirroring the reference's contract.
    """
    steps = decomposition.steps()
    alphas = decomposition.alphas_valid()
    betas = decomposition.betas_valid()
    b_np = np.asarray(basis) if basis is not None else None
    visited = 0
    for k in range(1, steps + 1):
        visited = k
        v_view = b_np[:k] if b_np is not None else None
        if not callback(k, v_view, (alphas[:k], betas[: max(k - 1, 0)])):
            break
    return visited


def find_stopping_point(decomposition: LanczosDecomposition, callback: Callable) -> int:
    """Steps after which the callback would have stopped the iteration."""
    return replay_iterations(decomposition, callback)


def truncate_decomposition(
    decomposition: LanczosDecomposition, steps: int
) -> LanczosDecomposition:
    """Truncate to ``steps`` iterations (early-stop semantics): padding
    zeroed, ``steps_taken`` clamped. Shapes stay static."""
    import jax.numpy as jnp

    k = decomposition.k_max
    steps = int(min(steps, decomposition.steps()))
    i = jnp.arange(k)
    return LanczosDecomposition(
        alphas=jnp.where(i < steps, decomposition.alphas, 0),
        betas=jnp.where(i < steps - 1, decomposition.betas, 0),
        steps_taken=jnp.asarray(steps, jnp.int32),
        b_norm=decomposition.b_norm,
    )


@contextlib.contextmanager
def trace(name: str, enabled: bool = True):
    """``jax.profiler.TraceAnnotation`` context (no-op when disabled)."""
    if not enabled:
        yield
        return
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


# ---------------------------------------------------------------------------
# Speed-of-light accounting
# ---------------------------------------------------------------------------

#: Published device-memory bandwidth, bytes/s, keyed by ``device_kind``.
#: NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_hbm_bandwidth(device_kind: str) -> float:
    """The published memory bandwidth of ``device_kind`` (a
    ``jax.Device.device_kind``); a device missing from the table is an
    error, never a default."""
    try:
        return PEAK_HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(
            f"no published memory bandwidth for device kind {device_kind!r}; "
            f"known: {sorted(PEAK_HBM_BYTES_PER_S)}") from None


def card_line() -> str:
    """``name, power.limit`` of the first GPU, as ``nvidia-smi`` reports
    them; a card below its maximum power limit runs slower under load, so
    every timing is printed beside this line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi printed nothing"


@dataclasses.dataclass
class SoLReport:
    nnz: int
    bytes_per_matvec: int
    sol_seconds: float
    achieved_seconds: float

    @property
    def sol_fraction(self) -> float:
        return self.sol_seconds / self.achieved_seconds

    @property
    def achieved_nnz_per_s(self) -> float:
        return self.nnz / self.achieved_seconds

    def __str__(self):
        return (
            f"SpMV: {self.nnz} nnz, {self.bytes_per_matvec / 1e6:.1f} MB/matvec, "
            f"SoL {self.sol_seconds * 1e6:.1f} us, achieved "
            f"{self.achieved_seconds * 1e6:.1f} us "
            f"({self.sol_fraction:.1%} of speed of light, "
            f"{self.achieved_nnz_per_s / 1e9:.2f} Gnnz/s)"
        )


def kkt_spmv_sol(
    num_arcs: int,
    num_nodes: int,
    achieved_seconds: float,
    device_kind: str,
    dtype_bytes: int = 4,
) -> SoLReport:
    """*Ideal-layout* speed-of-light bound for the structure-aware KKT matvec
    on ``device_kind``.

    Minimum device-memory traffic any single-ordering layout could achieve:
    the five per-arc streams (u, v int32 reads = 4B·2; d, x_a reads + y_a
    write = value bytes·3) plus the node vector in/out (negligible).
    """
    per_arc = 2 * 4 + 3 * dtype_bytes  # u, v int32 + d, x_a, y_a values
    bytes_total = num_arcs * per_arc + 2 * num_nodes * dtype_bytes
    nnz = 5 * num_arcs
    return SoLReport(
        nnz=nnz,
        bytes_per_matvec=bytes_total,
        sol_seconds=bytes_total / peak_hbm_bandwidth(device_kind),
        achieved_seconds=achieved_seconds,
    )
