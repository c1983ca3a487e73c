"""(l1-)Jacobi and hybrid Gauss-Seidel preconditioners.

The reference realizes ``jacobi``/``gauss-seidel`` as BoomerAMG configured
with max_levels=1 and a single relaxation (ref: src/internal/precon.c:
256-289).  On device the natural equivalents:

* jacobi / l1-jacobi — pure diagonal scaling (elementwise).
* gauss-seidel — hybrid ℓ1-GS: true GS is sequential, so we use the
  reference's own GPU answer (ℓ1-scaled smoothing, hypre relax types
  13/14/18) — here implemented as ℓ1-Jacobi sweeps, which is what hypre
  falls back to on devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Preconditioner


def _jacobi_apply(state, r):
    d_inv, sweeps, A = state
    z = d_inv * r

    def body(_, z):
        # extra sweeps: z += D⁻¹(r − A z)
        return z + d_inv * (r - A.matvec(z))

    return jax.lax.fori_loop(0, sweeps - 1, body, z)


class JacobiPrecon(Preconditioner):
    method = "jacobi"
    apply_fn = staticmethod(_jacobi_apply)

    def setup(self, system):
        A = system.A
        if self.args.get("l1", True):
            d = A.row_l1_norms()
        else:
            d = A.diagonal()
        d_inv = jnp.where(d != 0, 1.0 / d, 1.0)
        sweeps = max(1, int(self.args.get("max_iter", 1)))
        self.state = (d_inv, jnp.int32(sweeps), A)
        self.is_setup = True


class GaussSeidelPrecon(Preconditioner):
    """Hybrid ℓ1-GS ≈ ℓ1-Jacobi sweeps (device-friendly)."""

    method = "gauss-seidel"
    apply_fn = staticmethod(_jacobi_apply)

    def setup(self, system):
        A = system.A
        d = A.row_l1_norms()
        d_inv = jnp.where(d != 0, 1.0 / d, 1.0)
        sweeps = max(1, int(self.args.get("sweeps", 1))
                     * int(self.args.get("max_iter", 1)))
        self.state = (d_inv, jnp.int32(sweeps), A)
        self.is_setup = True
