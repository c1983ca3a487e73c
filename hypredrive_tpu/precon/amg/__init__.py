"""BoomerAMG-equivalent algebraic multigrid (native implementation).

Setup (host): strength graph → PMIS/HMIS coarsening → interpolation →
Galerkin RAP.  Solve (device): V/W cycles with ℓ1-Jacobi / Chebyshev
smoothers and a dense coarse solve.
"""

from .precon import AMGPrecon

__all__ = ["AMGPrecon"]
