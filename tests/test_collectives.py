"""Pin the per-step collective traffic of the distributed design.

Extracted from the compiled HLO on the 8-virtual-device CPU mesh (the
collective instructions XLA emits are mesh facts, not backend facts): the
row partition (`ShardedSparseOperator`) does exactly one full-vector
all-gather per pass per step — O(n) bytes — plus scalar psums.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu.utils.collectives import (
    collective_bytes,
    collectives_in_hlo,
)

ARCS = 20_000


@pytest.fixture(scope="module")
def mesh8():
    return Mesh(np.array(jax.devices()[:8]), ("rows",))


@pytest.fixture(scope="module")
def inst():
    return generate_mcf_instance(ARCS, rho=3, instance_id=1)


def _compiled_text(jitted, *args):
    return jitted.lower(*args).compile().as_text()


def test_generic_path_collectives(mesh8, inst):
    from two_pass_lanczos_tpu.parallel.sharded import ShardedSparseOperator

    op = ShardedSparseOperator.from_kkt_arrays(inst, mesh8, dtype=np.float64)
    b = np.random.default_rng(0).standard_normal(inst.num_arcs + inst.num_nodes)
    solver = op._solver(8, "inv", "two_pass")
    txt = _compiled_text(solver, op.local_blocks, op._prepare_b(b))
    ops = collectives_in_hlo(txt)
    gathers = [o for o in ops if o.kind == "all-gather"]
    # one all-gather of the full padded vector per pass (pass one + pass two)
    assert sum(o.count for o in gathers) == 2, ops
    n_pad = op.part.n_pad
    for o in gathers:
        assert o.shape == (n_pad,), o
    # scalar psums only besides that (alpha, beta^2, b-norm)
    vec_reduces = [o for o in ops if o.kind == "all-reduce" and o.shape != ()]
    assert not vec_reduces, ops


def test_nnz_balance(mesh8, inst):
    """The snake partition balances nnz, not rows: max/mean < 1.02 on the
    KKT instance across 8 devices (recorded table in PERF.md)."""
    from two_pass_lanczos_tpu.parallel.sharded import ShardedSparseOperator

    op = ShardedSparseOperator.from_kkt_arrays(inst, mesh8, dtype=np.float64)
    per = op.nnz_per_device
    assert per.sum() == 5 * inst.num_arcs
    assert per.max() / per.mean() < 1.02, per


def test_generic_matvec_overlaps_halo_with_owned_spmv(mesh8, inst):
    """SURVEY §7 stage 5: the all-gather (halo exchange) must be
    data-independent of the owned-column SpMV so the scheduler can overlap
    them. Asserted structurally on the traced jaxpr: the owned row sums
    consume no value derived from the all_gather, while the remote row
    sums do."""
    from two_pass_lanczos_tpu.parallel.sharded import (
        ShardedSparseOperator, _device_blocks, _local_matvec)

    op = ShardedSparseOperator.from_kkt_arrays(inst, mesh8, dtype=np.float64)

    def run(blocks, x_local):
        return _local_matvec(_device_blocks(blocks), x_local, "rows")

    shmapped = jax.shard_map(
        run, mesh=mesh8,
        in_specs=(jax.sharding.PartitionSpec("rows"),
                  jax.sharding.PartitionSpec("rows")),
        out_specs=jax.sharding.PartitionSpec("rows"), check_vma=False)
    x = np.zeros(op.part.n_pad)
    jaxpr = jax.make_jaxpr(shmapped)(op.local_blocks, x)

    def find_inner(jx):
        for eqn in jx.eqns:
            for v in eqn.params.values():
                inner = getattr(v, "jaxpr", v)
                if hasattr(inner, "eqns"):
                    names = [e.primitive.name for e in inner.eqns]
                    if "all_gather" in names:
                        return inner
        return jx.jaxpr

    inner = find_inner(jaxpr)
    tainted = set()
    sum_taint = []
    for eqn in inner.eqns:
        deps = any(getattr(v, "count", None) is not None and v in tainted
                   for v in eqn.invars)
        if eqn.primitive.name == "all_gather" or deps:
            tainted.update(eqn.outvars)
        if eqn.primitive.name == "reduce_sum":
            sum_taint.append(deps)
    assert len(sum_taint) >= 2, sum_taint
    assert sum_taint[0] is False, "owned SpMV depends on the all-gather"
    assert sum_taint[-1] is True, "remote part must consume the gather"


def test_generic_split_matvec_matches_dense(mesh8, inst):
    """Owned+remote split must reproduce the full SpMV (same triplets, two
    fixed-order row reductions instead of one)."""
    from two_pass_lanczos_tpu.parallel.sharded import ShardedSparseOperator

    op = ShardedSparseOperator.from_kkt_arrays(inst, mesh8, dtype=np.float64)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(inst.num_arcs + inst.num_nodes)
    y = op.matvec_distributed(x)
    m = inst.num_arcs
    d = inst.quad_costs
    yt = np.zeros_like(y)
    yt[:m] = d * x[:m] + x[m + inst.arc_u] - x[m + inst.arc_v]
    np.add.at(yt, m + inst.arc_u, x[:m])
    np.add.at(yt, m + inst.arc_v, -x[:m])
    assert np.allclose(y, yt, rtol=1e-12, atol=1e-12)
