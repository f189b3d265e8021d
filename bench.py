"""Headline timing: two-pass f(A)b, k=500, 500k-arc rho=3 KKT system, f64.

Reference baseline: 5.28 s on one Xeon core (``BASELINE.md`` — scalability
k=500, n=501,155, two-pass). Times the user path — ``make_kkt_operator`` then
``solve_fAb`` from a device-resident b — on one GPU, each sample ended by
``block_until_ready``; compilation and the host-side operator build (the
summation plans) are reported apart as set-up, beside the cost of new arc
costs through ``with_costs``, which reuses the plans. Prints one
JSON line that names the device; ``vs_baseline`` is the speedup factor
(>1 = faster than the reference).

Exits non-zero, printing no result, when JAX finds no GPU: a CPU timing is
not a measurement of this system. The full benchmark (cells, percentiles,
traces) is ROADMAP A1.
"""

import json
import sys
import time

import numpy as np

REFERENCE_S = 5.28  # reference two-pass @ k=500, n=501,155 (BASELINE.md)


def main() -> int:
    from two_pass_lanczos_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    jax.config.update("jax_enable_x64", True)
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench.py: no GPU (JAX platform {devices[0].platform!r}); "
              "refusing to report a time", file=sys.stderr)
        return 2
    import jax.numpy as jnp

    import two_pass_lanczos_tpu as tpl
    from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
    from two_pass_lanczos_tpu.observability import card_line

    arcs, rho, k = 500_000, 3, 500
    inst = generate_mcf_instance(arcs, rho=rho, instance_id=1)
    t0 = time.perf_counter()
    op = jax.block_until_ready(tpl.make_kkt_operator(
        inst.quad_costs, inst.arc_u, inst.arc_v, inst.num_nodes,
        dtype=jnp.float64))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(op.with_costs(inst.quad_costs))
    with_costs_s = time.perf_counter() - t0
    n = inst.num_arcs + inst.num_nodes
    b = jnp.asarray(np.random.default_rng(0).standard_normal(n))

    def run():
        return tpl.solve_fAb(op, b, k=k, f="inv", method="two_pass")

    t0 = time.perf_counter()
    x = jax.block_until_ready(run())
    setup_s = time.perf_counter() - t0
    if not bool(jnp.all(jnp.isfinite(x))):
        print("bench.py: non-finite solution", file=sys.stderr)
        return 1
    samples = []
    for _ in range(6):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        samples.append(time.perf_counter() - t0)
    t = float(np.median(samples))
    record = dict(
        metric=f"two_pass_inv_k{k}_arcs{arcs}_rho{rho}_f64_wallclock",
        value=t,
        unit="s",
        vs_baseline=REFERENCE_S / t,
        samples=samples,
        compile_and_first_run_s=setup_s,
        operator_build_s=build_s,
        with_costs_s=with_costs_s,
        device={"platform": devices[0].platform,
                "kind": devices[0].device_kind, "count": len(devices)},
        card=card_line(),
    )
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
