"""Matrix-free linear operators.

The reference's central abstraction is faer's ``matrix_free::LinOp`` — every
algorithm takes an operator defined only by its action (reference
``src/lib.rs:8-9``, ``src/algorithms/mod.rs:30``). The JAX equivalent
is a *pytree-registered callable*: a small dataclass carrying device arrays,
whose ``matvec`` is pure jnp and therefore traceable under ``jax.jit`` /
``lax.scan`` / ``shard_map``. Operators can be passed as jit arguments (they
flatten into their arrays) or closed over — both compile to the same HLO.

Implementations:

* :class:`DenseOperator`    — dense symmetric A, matmul matvec.
* :class:`DiagonalOperator` — diagonal A (stability/orthogonality scenarios).
* :class:`SparseOperator`   — generic sparse A in sorted-COO layout.
* :class:`KKTOperator`      — structure-aware ``[[D, Eᵀ], [E, 0]]`` operator.
* :class:`CallableOperator` — wraps any jit-compatible ``matvec`` closure.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from two_pass_lanczos_tpu.errors import DimensionMismatchError, InputError
from two_pass_lanczos_tpu.ops.spmv import (
    SortedCOO,
    coo_spmv,
    incidence_sums,
    kkt_matvec,
)


__all__ = [
    "LinearOperator",
    "DenseOperator",
    "DiagonalOperator",
    "SparseOperator",
    "KKTOperator",
    "make_kkt_operator",
    "CallableOperator",
    "as_operator",
]


def _is_concrete(a) -> bool:
    """True for host arrays and committed device arrays, False for tracers."""
    return isinstance(a, np.ndarray) or (
        isinstance(a, jax.Array) and not isinstance(a, jax.core.Tracer))


class LinearOperator:
    """Protocol: anything with ``.shape``, ``.dtype`` and ``.matvec(x)``."""

    shape: Tuple[int, int]

    def matvec(self, x: jax.Array) -> jax.Array:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.matvec(x)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Dense (symmetric/Hermitian) operator; the matvec is a matmul."""

    a: jax.Array

    def tree_flatten(self):
        return (self.a,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(a=children[0])

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    def matvec(self, x):
        return self.a @ x


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DiagonalOperator(LinearOperator):
    """Diagonal operator; used by the synthetic spectrum scenarios
    (reference ``src/bin/stability.rs:98-157``)."""

    diag: jax.Array

    def tree_flatten(self):
        return (self.diag,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(diag=children[0])

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    def matvec(self, x):
        return self.diag * x


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SparseOperator(LinearOperator):
    """Generic sparse operator over a row-sorted COO matrix."""

    mat: SortedCOO

    def tree_flatten(self):
        return (self.mat,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(mat=children[0])

    @property
    def shape(self):
        return self.mat.shape

    @property
    def dtype(self):
        return self.mat.dtype

    def matvec(self, x):
        return coo_spmv(self.mat, x)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class KKTOperator(LinearOperator):
    """Structure-aware KKT operator ``A = [[D, Eᵀ], [E, 0]]``.

    Never materializes A: holds the diagonal ``d`` of D (quadratic arc costs)
    and the arc endpoint index arrays of the incidence matrix E. Matches the
    block layout assembled by the reference loader
    (``src/utils/data_loader.rs:211-258``): arc block first, node block after.

    ``tails`` and ``heads`` are the fixed plans that sum the node block
    (``ops.spmv.incidence_sums``), built on the host from the endpoint
    arrays when the operator is created. They make every matvec bitwise
    reproducible, which keeps two-pass replay exact on the GPU. So the
    endpoints must be concrete (host or device arrays, not tracers); the
    costs ``d`` may be traced. To change the costs without rebuilding the
    plans — inside ``jit`` too — use :meth:`with_costs`.
    """

    d: jax.Array  # (num_arcs,) quadratic costs
    arc_u: jax.Array  # (num_arcs,) int32 tail nodes (E[u,j] = +1)
    arc_v: jax.Array  # (num_arcs,) int32 head nodes (E[v,j] = -1)
    num_nodes: int
    tails: Optional[tuple] = None
    heads: Optional[tuple] = None

    def __post_init__(self):
        if self.tails is not None and self.heads is not None:
            return
        if not (_is_concrete(self.arc_u) and _is_concrete(self.arc_v)):
            raise InputError(
                "KKTOperator needs concrete arc endpoints to plan its "
                "node-block sums; build it outside jit (make_kkt_operator) "
                "and pass new costs through op.with_costs(d)")
        object.__setattr__(self, "tails", incidence_sums(
            np.asarray(self.arc_u), self.num_nodes))
        object.__setattr__(self, "heads", incidence_sums(
            np.asarray(self.arc_v), self.num_nodes))

    def tree_flatten(self):
        return ((self.d, self.arc_u, self.arc_v, self.tails, self.heads),
                (self.num_nodes,))

    @classmethod
    def tree_unflatten(cls, aux, children):
        d, arc_u, arc_v, tails, heads = children
        obj = object.__new__(cls)  # skip __post_init__: leaves may be tracers
        for name, val in (("d", d), ("arc_u", arc_u), ("arc_v", arc_v),
                          ("num_nodes", aux[0]), ("tails", tails),
                          ("heads", heads)):
            object.__setattr__(obj, name, val)
        return obj

    def with_costs(self, d) -> "KKTOperator":
        """The same network with arc costs ``d``: the endpoints and the
        summation plans are reused, so this costs nothing on the host and
        works on traced ``d`` (an interior-point loop changes only ``d``)."""
        d = jnp.asarray(d, dtype=self.d.dtype)
        if d.shape != self.d.shape:
            raise DimensionMismatchError(self.d.shape[0], d.shape[0],
                                         "arc costs")
        return dataclasses.replace(self, d=d)

    @property
    def num_arcs(self):
        return self.d.shape[0]

    @property
    def shape(self):
        n = self.d.shape[0] + self.num_nodes
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def nnz(self):
        # D has m entries, E and Eᵀ have 2m each.
        return 5 * self.d.shape[0]

    def matvec(self, x):
        return kkt_matvec(self.d, self.arc_u, self.arc_v, x,
                          tails=self.tails, heads=self.heads)


def make_kkt_operator(quad_costs, arc_u, arc_v, num_nodes,
                      dtype=None) -> "KKTOperator":
    """KKT operator from host arrays: costs cast to ``dtype``, endpoints to
    int32, and the node block's fixed summation plans built once here
    (O(m log m) on the host; reuse them with ``op.with_costs(d)``)."""
    return KKTOperator(
        d=jnp.asarray(quad_costs, dtype=dtype),
        arc_u=jnp.asarray(arc_u, dtype=jnp.int32),
        arc_v=jnp.asarray(arc_v, dtype=jnp.int32),
        num_nodes=int(num_nodes),
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CallableOperator(LinearOperator):
    """Wraps an arbitrary jit-compatible ``matvec`` closure.

    The closure is static (part of the pytree structure); any arrays it needs
    must be captured at trace time.
    """

    fn: Callable[[jax.Array], jax.Array]
    n: int
    _dtype: object = jnp.float64

    def tree_flatten(self):
        return (), (self.fn, self.n, self._dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        fn, n, dtype = aux
        return cls(fn=fn, n=n, _dtype=dtype)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self._dtype

    def matvec(self, x):
        return self.fn(x)


def as_operator(a) -> LinearOperator:
    """Coerce an array / SortedCOO / callable-with-shape to a LinearOperator."""
    if isinstance(a, LinearOperator):
        return a
    if isinstance(a, SortedCOO):
        return SparseOperator(a)
    arr = jnp.asarray(a)
    if arr.ndim == 2:
        return DenseOperator(arr)
    if arr.ndim == 1:
        return DiagonalOperator(arr)
    raise TypeError(f"cannot interpret {type(a)!r} as a linear operator")
