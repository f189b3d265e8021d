"""Chip smoke: drive the f(A)·b main path once on one GPU, at full width.

The system computes x = f(A)·b by one-pass or two-pass Lanczos. Its main
path is ``make_kkt_operator`` → ``solve_fAb`` on the reference's headline
instance: the netgen-style min-cost-flow KKT system with 500k arcs and rho=3
(n = 501,155), two-pass f=inv at k=500 in f64, plus the same family at 5M
arcs. Instances are generated from a seed; nothing is downloaded.

Phases (each an importable function with its sizes as parameters, so the
CPU tests run every phase at a tiny size):

1. ``phase_matvec``   — the KKT and sparse matvecs against a host
   ``scipy.sparse`` CSR reference in f64 (and the KKT one in f32);
2. ``phase_replay``   — two-pass replay is bitwise: pass two regenerates
   pass one's basis exactly, for ``KKTOperator`` and ``SparseOperator``,
   and a repeated solve gives the same bits;
3. ``phase_headline`` — two-pass and one-pass inv at 500k/k=500 agree, and
   two-pass at 5M/k=100 is finite;
4. ``phase_accuracy`` — the reference's stability scenarios against
   analytic truth, compared with the CPU-published ``results/accuracy_*``;
5. ``phase_f32``      — f32 against f64 (no f32 product runs in TF32).

``--four-cards`` runs only ``phase_four_cards``: the 5M-arc two-pass solve
on a flat 4-card mesh (``ShardedSparseOperator``) against the one-card
solve, with bitwise replay inside the sharded path.

Usage::

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # four cards of one host

Exits non-zero, printing no result, when JAX finds no GPU or any check
fails. The last line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from two_pass_lanczos_tpu.observability import card_line

RESULTS = Path(__file__).resolve().parent / "results"

#: f64 matvec against scipy: both sum the same few terms per row in
#: different orders, so they differ by rounding, ~1e-16 relative.
TOL_MATVEC_F64 = 1e-12
#: f32 matvec against the f64 reference: one f32 rounding per term. The
#: matvec has elementwise products only (no dot, so no TF32 question).
TOL_MATVEC_F32 = 1e-5
#: two-pass against one-pass x in f64: the same coefficients and, by the
#: replay contract, the same basis; only the order of the final sum over
#: the k basis vectors differs.
TOL_ONE_VS_TWO_PASS = 1e-10
#: GPU f64 error against the CPU-published f64 error at the same k: the
#: two runs differ only in rounding (summation order), which the Lanczos
#: recurrence can amplify near the ill-conditioned inv transition.
ACCURACY_FACTOR = 10.0
#: Relative errors below this are machine-precision noise in f64 and are
#: compared as equal.
ACCURACY_FLOOR = 1e-13
#: f32 against f64 coefficients (α, β) at k=30, as one vector: f32 rounding
#: amplified by 30 steps of the recurrence on an indefinite spectrum reads
#: ~3e-6 on the CPU; a product in TF32 (10-bit mantissa) would read ~1e-3.
TOL_F32_COEFFS = 1e-5
#: f32 against f64 ``f(T)e1`` (exp) from the same T_k: a 30x30 f32
#: eigendecomposition. On an H100 the QR eigensolver (``eigh_qr``) reads
#: 7.2e-6 and the GPU's default Jacobi ``eigh`` read 9.9e-5, so the limit
#: sits between them: a return to Jacobi (or TF32, ~1e-3) fails.
TOL_F32_PROJECTED = 3e-5
#: Sharded (4 cards) against one-card x in f64: the row partition sums each
#: row and every dot product in another order (NCCL all-reduce across
#: cards, other chunking within one), so the two agree to rounding
#: amplified by k=100 steps of the recurrence.
TOL_SHARDED = 1e-8


class CheckFailed(RuntimeError):
    """A phase could not produce the quantity it checks."""


def _check(results: list, name: str, value: float, tol: float,
           ok: bool = None, **extra):
    """Record one check; ``ok`` defaults to ``value <= tol``."""
    ok = bool(value <= tol) if ok is None else bool(ok)
    results.append(dict(check=name, value=float(value), tol=float(tol),
                        ok=ok, **extra))


def _rel(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-300))


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _median_time(fn, reps: int = 3) -> float:
    import jax

    jax.block_until_ready(fn())  # compile / warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def kkt_instance(arcs: int):
    """The netgen-style rho=3 instance with ``arcs`` arcs (instance id 1)."""
    from two_pass_lanczos_tpu.models.generator import generate_mcf_instance

    return generate_mcf_instance(arcs, rho=3, instance_id=1)


def _arrays(inst):
    from two_pass_lanczos_tpu.utils.data_loader import KKTArrays

    return KKTArrays(quad_costs=inst.quad_costs, arc_u=inst.arc_u,
                     arc_v=inst.arc_v, num_nodes=inst.num_nodes,
                     num_arcs=inst.num_arcs)


def scipy_kkt(inst):
    """Host f64 CSR of ``A = [[D, Eᵀ], [E, 0]]`` — the plain reference."""
    import scipy.sparse as sp

    m, p = inst.num_arcs, inst.num_nodes
    cols = np.arange(m)
    e = sp.csr_matrix(
        (np.r_[np.ones(m), -np.ones(m)],
         (np.r_[inst.arc_u, inst.arc_v], np.r_[cols, cols])), shape=(p, m))
    return sp.bmat([[sp.diags(inst.quad_costs), e.T], [e, None]],
                   format="csr")


def phase_matvec(arcs=(500_000, 5_000_000), sparse_arcs=500_000, seed=0):
    import jax
    import jax.numpy as jnp

    import two_pass_lanczos_tpu as tpl
    from two_pass_lanczos_tpu.models.kkt import kkt_sorted_coo

    out = []
    mv = jax.jit(lambda op, x: op.matvec(x))
    for a in arcs:
        inst = kkt_instance(a)
        ref_a = scipy_kkt(inst)
        x = np.random.default_rng(seed).standard_normal(ref_a.shape[0])
        y_ref = ref_a @ x
        for dt, tol in ((jnp.float64, TOL_MATVEC_F64),
                        (jnp.float32, TOL_MATVEC_F32)):
            op = tpl.make_kkt_operator(inst.quad_costs, inst.arc_u,
                                       inst.arc_v, inst.num_nodes, dtype=dt)
            y = mv(op, jnp.asarray(x, dt))
            _check(out, f"kkt matvec {jnp.dtype(dt).name} arcs={a}",
                   _rel(y, y_ref), tol)
        if a == sparse_arcs:
            sop = tpl.SparseOperator(kkt_sorted_coo(_arrays(inst)))
            _check(out, f"sparse matvec float64 arcs={a}",
                   _rel(mv(sop, jnp.asarray(x)), y_ref), TOL_MATVEC_F64)
    return out


def _replay_bits(op, b, k: int):
    """Pass one with its basis, then pass two regenerating it."""
    import jax

    import two_pass_lanczos_tpu as tpl
    from two_pass_lanczos_tpu.functions import padded_f_e1

    decomp, v1 = jax.jit(tpl.lanczos_standard, static_argnums=2)(op, b, k)
    if int(decomp.steps_taken) != k:
        raise CheckFailed("breakdown in the replay problem")
    y = (padded_f_e1(decomp, "inv") * decomp.b_norm).astype(b.dtype)
    _, v2 = jax.jit(tpl.lanczos_pass_two_with_basis)(op, b, decomp, y)
    return _bits_equal(v1, v2), _rel(v2, v1)


def phase_replay(arcs=500_000, k=500, seed=1):
    import jax.numpy as jnp

    import two_pass_lanczos_tpu as tpl
    from two_pass_lanczos_tpu.models.kkt import kkt_sorted_coo

    inst = kkt_instance(arcs)
    n = inst.num_arcs + inst.num_nodes
    b = jnp.asarray(np.random.default_rng(seed).standard_normal(n))
    ops = {
        "KKTOperator": tpl.make_kkt_operator(
            inst.quad_costs, inst.arc_u, inst.arc_v, inst.num_nodes,
            dtype=jnp.float64),
        "SparseOperator": tpl.SparseOperator(kkt_sorted_coo(_arrays(inst))),
    }
    out = []
    for name, op in ops.items():
        same, drift = _replay_bits(op, b, k)
        _check(out, f"{name} pass-two basis == pass-one basis (k={k})",
               drift, 0.0, ok=same)
        x1 = tpl.solve_fAb(op, b, k=k, f="inv", method="two_pass")
        x2 = tpl.solve_fAb(op, b, k=k, f="inv", method="two_pass")
        _check(out, f"{name} repeated two-pass solve, same bits",
               _rel(x2, x1), 0.0, ok=_bits_equal(x1, x2))
    return out


def _build_operator(inst):
    """``make_kkt_operator`` in f64 and its wall time: the host-side
    summation plans plus the copy to the device (set-up, not solve time)."""
    import jax
    import jax.numpy as jnp

    import two_pass_lanczos_tpu as tpl

    t0 = time.perf_counter()
    op = jax.block_until_ready(tpl.make_kkt_operator(
        inst.quad_costs, inst.arc_u, inst.arc_v, inst.num_nodes,
        dtype=jnp.float64))
    return op, time.perf_counter() - t0


def phase_headline(arcs=500_000, k=500, big_arcs=5_000_000, big_k=100,
                   seed=1):
    import jax.numpy as jnp

    import two_pass_lanczos_tpu as tpl

    out = []
    inst = kkt_instance(arcs)
    op, build = _build_operator(inst)
    b = jnp.asarray(np.random.default_rng(seed).standard_normal(
        inst.num_arcs + inst.num_nodes))
    xs, secs = {}, {}
    for method in ("two_pass", "one_pass"):
        def solve(method=method):
            return tpl.solve_fAb(op, b, k=k, f="inv", method=method)
        secs[method] = _median_time(solve)
        xs[method] = np.asarray(solve())
        _check(out, f"{method} inv arcs={arcs} k={k} finite",
               float(np.isfinite(xs[method]).all()), 1.0,
               ok=np.isfinite(xs[method]).all(), seconds=secs[method],
               operator_build_seconds=build)
    _check(out, f"two_pass vs one_pass arcs={arcs} k={k}",
           _rel(xs["two_pass"], xs["one_pass"]), TOL_ONE_VS_TWO_PASS)

    big = kkt_instance(big_arcs)
    op_big, build_big = _build_operator(big)
    b_big = jnp.asarray(np.random.default_rng(seed).standard_normal(
        big.num_arcs + big.num_nodes))

    def solve_big():
        return tpl.solve_fAb(op_big, b_big, k=big_k, f="inv",
                             method="two_pass")

    t_big = _median_time(solve_big)
    x_big = np.asarray(solve_big())
    _check(out, f"two_pass inv arcs={big_arcs} k={big_k} finite",
           float(np.isfinite(x_big).all()), 1.0,
           ok=np.isfinite(x_big).all(), seconds=t_big,
           operator_build_seconds=build_big)
    return out


def published_errors(fn: str, scenario: str) -> dict:
    """``k -> (standard, two-pass)`` relative errors of the CPU-f64 run."""
    path = RESULTS / f"accuracy_{fn}_{scenario}-conditioned.csv"
    with open(path) as fh:
        return {int(r["k"]): (float(r["relative_error_standard"]),
                              float(r["relative_error_two_pass"]))
                for r in csv.DictReader(fh)}


def phase_accuracy(n=10_000, ks=(100, 200), seed=42, published=None):
    """The stability scenarios (reference ``src/bin/stability.rs``) with the
    seed and solvers of ``experiments/stability.py``; ``published`` maps
    ``(fn, scenario)`` to the reference errors (default: the CSVs, which
    were computed at n=10,000)."""
    import jax.numpy as jnp

    import two_pass_lanczos_tpu as tpl
    from two_pass_lanczos_tpu.models.synthetic import create_diagonal_problem

    out = []
    for fn in ("inv", "exp"):
        solver = tpl.make_inv_solver() if fn == "inv" else tpl.make_exp_solver()
        f_scalar = (lambda lam: 1.0 / lam) if fn == "inv" else np.exp
        for scenario in ("well", "ill"):
            op, eigs = create_diagonal_problem(n, f"{scenario}-conditioned", fn)
            b = np.random.default_rng(seed).standard_normal(n)
            x_true = f_scalar(eigs) * b
            ref = (published or {}).get((fn, scenario)) or \
                published_errors(fn, scenario)
            for k in ks:
                for col, run in enumerate((tpl.lanczos, tpl.lanczos_two_pass)):
                    x = np.asarray(run(op, jnp.asarray(b, op.dtype), k, solver))
                    err = _rel(x, x_true)
                    want = ref[k][col]
                    lo, hi = sorted((max(err, ACCURACY_FLOOR),
                                     max(want, ACCURACY_FLOOR)))
                    variant = "one_pass" if col == 0 else "two_pass"
                    _check(out, f"{fn}/{scenario} {variant} k={k} error "
                                f"ratio to CPU f64 ({err:.3e} vs {want:.3e})",
                           hi / lo, ACCURACY_FACTOR)
    return out


def phase_f32(arcs=500_000, nodes=1155, k=30, seed=0):
    """f32 against f64 on the random KKT of the verify recipe
    (d ~ U[1, 3], uniform endpoints) at real width."""
    import jax.numpy as jnp

    import two_pass_lanczos_tpu as tpl
    from two_pass_lanczos_tpu.functions import padded_f_e1

    rng = np.random.default_rng(seed)
    u = rng.integers(0, nodes, arcs).astype(np.int32)
    v = ((u + 1 + rng.integers(0, nodes - 1, arcs)) % nodes).astype(np.int32)
    d = rng.uniform(1.0, 3.0, arcs)
    b = rng.standard_normal(arcs + nodes)
    dec = {}
    for dt in (jnp.float32, jnp.float64):
        op = tpl.make_kkt_operator(d, u, v, nodes, dtype=dt)
        dec[dt] = tpl.lanczos_pass_one(op, jnp.asarray(b, dt), k)
    c32 = np.r_[np.asarray(dec[jnp.float32].alphas, np.float64),
                np.asarray(dec[jnp.float32].betas, np.float64)]
    c64 = np.r_[np.asarray(dec[jnp.float64].alphas),
                np.asarray(dec[jnp.float64].betas)]
    out = []
    _check(out, f"f32 vs f64 coefficients k={k}", _rel(c32, c64),
           TOL_F32_COEFFS)
    # the projected solve from the SAME (f32) coefficients, in f32 vs f64
    d32 = dec[jnp.float32]
    d64 = type(d32)(*(jnp.asarray(a, jnp.float64)
                      if a.dtype == jnp.float32 else a
                      for a in (d32.alphas, d32.betas, d32.steps_taken,
                                d32.b_norm)))
    _check(out, f"f32 vs f64 f(T)e1 (exp) k={k}",
           _rel(padded_f_e1(d32, "exp"), padded_f_e1(d64, "exp")),
           TOL_F32_PROJECTED)
    return out


def _sharded_replay(sop, b, k: int):
    """Pass one (basis kept) and pass two (basis regenerated) under one
    ``shard_map`` on ``sop``'s mesh; returns whether the bases are equal."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from two_pass_lanczos_tpu.algorithms.core import pass_one_scan
    from two_pass_lanczos_tpu.algorithms.two_pass import _reconstruction_scan
    from two_pass_lanczos_tpu.functions import padded_f_e1
    from two_pass_lanczos_tpu.parallel.sharded import (
        _device_blocks,
        _local_matvec,
    )

    axis = sop.axis

    def run(blocks, b_local):
        blocks = _device_blocks(blocks)
        matvec = lambda x: _local_matvec(blocks, x, axis)  # noqa: E731
        decomp, v1 = pass_one_scan(matvec, b_local, k, emit_basis=True,
                                   reduce_sum=lambda s: lax.psum(s, axis))
        y = (padded_f_e1(decomp, "inv") * decomp.b_norm).astype(b_local.dtype)
        _, v2 = _reconstruction_scan(matvec, b_local, decomp, y,
                                     emit_basis=True)
        same = jnp.all(v1 == v2).astype(jnp.int32)
        return lax.pmin(same, axis)  # equal on every device

    fn = jax.jit(jax.shard_map(run, mesh=sop.mesh, in_specs=(P(axis), P(axis)),
                               out_specs=P(), check_vma=False))
    return bool(fn(sop.local_blocks, sop._prepare_b(b)))


def phase_four_cards(arcs=5_000_000, k=100, n_devices=4, seed=1):
    import jax.numpy as jnp

    import two_pass_lanczos_tpu as tpl
    from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh

    inst = kkt_instance(arcs)
    b = np.random.default_rng(seed).standard_normal(
        inst.num_arcs + inst.num_nodes)
    out = []
    op = tpl.make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                               inst.num_nodes, dtype=jnp.float64)
    b_dev = jnp.asarray(b)

    def one_card():
        return tpl.solve_fAb(op, b_dev, k=k, f="inv", method="two_pass")

    t_one = _median_time(one_card)
    x_one = np.asarray(one_card())
    sop = ShardedSparseOperator.from_kkt_arrays(_arrays(inst),
                                                make_mesh(n_devices))
    b_sharded = sop._prepare_b(b)
    solver = sop._solver(k, "inv", "two_pass")

    def sharded():
        return solver(sop.local_blocks, b_sharded)

    t_sh = _median_time(sharded)
    x_sh, _ = sop.solve_fAb(b, k=k, f="inv", method="two_pass")
    x_sh2, _ = sop.solve_fAb(b, k=k, f="inv", method="two_pass")
    _check(out, f"sharded ({n_devices} cards) vs one card, arcs={arcs} k={k}",
           _rel(x_sh, x_one), TOL_SHARDED, seconds_one_card=t_one,
           seconds_sharded=t_sh)
    _check(out, "sharded repeated solve, same bits", _rel(x_sh2, x_sh), 0.0,
           ok=_bits_equal(x_sh, x_sh2))
    _check(out, f"sharded pass-two basis == pass-one basis (k={k})", 0.0,
           0.0, ok=_sharded_replay(sop, b, k))
    return out


PHASES = (phase_matvec, phase_replay, phase_headline, phase_accuracy,
          phase_f32)


def run_phases(phases, card: str) -> bool:
    """Run each phase, print each check beside the card; True if all pass."""
    all_ok = True
    for phase in phases:
        t0 = time.perf_counter()
        results = phase()
        wall = time.perf_counter() - t0
        for r in results:
            extra = {key: val for key, val in r.items()
                     if key not in ("check", "value", "tol", "ok")}
            print(f"[{'ok' if r['ok'] else 'FAIL'}] {phase.__name__}: "
                  f"{r['check']}: {r['value']:.3e} (tol {r['tol']:.1e})"
                  + (f" {extra}" if extra else ""), flush=True)
            all_ok &= r["ok"]
        print(f"{phase.__name__}: {wall:.1f} s wall on {card}", flush=True)
    return all_ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)

    from two_pass_lanczos_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    import jax

    jax.config.update("jax_enable_x64", True)
    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py: JAX backend is {jax.default_backend()!r}, "
              "not a GPU; nothing was run", file=sys.stderr)
        return 2
    devices = jax.devices()
    if args.four_cards and len(devices) < 4:
        print(f"chip_smoke.py: --four-cards needs 4 GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    print(f"compile cache: {cache}", flush=True)
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')}", flush=True)
    phases = (phase_four_cards,) if args.four_cards else PHASES
    if not run_phases(phases, card):
        print("chip_smoke.py: a check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
