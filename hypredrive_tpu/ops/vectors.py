"""Vector reductions for Krylov solvers.

Plain jnp ops: under jit with sharded arrays XLA fuses these and inserts
the cross-device reductions automatically — the replacement for hypre's
MPI_Allreduce dot products (ref: SURVEY §2.9).  Every contraction
states ``Precision.HIGHEST`` so a float32 dot never runs in a reduced
(TF32) mode on a GPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.vdot(a, b, precision=HIGHEST)


def norm2(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(dot(a, a))
