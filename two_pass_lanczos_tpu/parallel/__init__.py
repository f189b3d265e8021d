"""Distribution over device meshes: partitioning, sharded operators, collectives.

The reference is entirely sequential (every faer call passes ``Par::Seq`` —
SURVEY §2 checklist); this package *adds* the distributed dimension specified
by BASELINE.json's north star: 1-D row partition of the operator across
devices/hosts, Krylov vectors sharded over the same axis, per-step α/β
reductions as cross-device ``psum``s, and the remote vector segments obtained
by all-gather inside the jitted scan.
"""

from two_pass_lanczos_tpu.parallel.mesh import make_mesh, initialize_distributed
from two_pass_lanczos_tpu.parallel.partition import snake_partition, RowPartition
from two_pass_lanczos_tpu.parallel.sharded import ShardedSparseOperator

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "snake_partition",
    "RowPartition",
    "ShardedSparseOperator",
]
