"""Distributed execution: device mesh, halo exchange, row-sharded matrices.

JAX replacement for the reference's MPI domain decomposition
(hypre ParCSR row partitioning + halo exchange; ref: SURVEY §2.9):
a 1-D ``jax.sharding.Mesh`` over the ``rows`` axis, ``shard_map``-ped SpMV
with precomputed ``ppermute`` halo schedules, and XLA-inserted ``psum``
reductions for the Krylov dot products.
"""

from .mesh import make_mesh, rows_sharding
from .dist_matrix import DistEllMatrix

__all__ = ["make_mesh", "rows_sharding", "DistEllMatrix"]
