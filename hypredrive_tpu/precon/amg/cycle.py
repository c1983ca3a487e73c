"""Device V/W cycles (jit-safe, levels unrolled at trace time).

The cycle is a pure function of the AMGState pytree; level count and
smoother kinds live in pytree aux, so XLA compiles one fused program for
the whole cycle: smoothers are SpMV+AXPY chains, grid transfers are the
same SpMV, and the coarsest solve applies an exact inverse.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ...ops.vectors import HIGHEST
from .hierarchy import AMGState, AMGLevel, GS_TRI_ITERS


def _tri_jacobi(d_inv, T, r):
    """z ≈ (D + T)⁻¹ r by Jacobi iteration (T strictly triangular) —
    the SpMV-shaped triangular solve (ref: ilu.h tri_solve=off,
    lower/upper_jac_iters)."""
    z = d_inv * r
    for _ in range(GS_TRI_ITERS):
        z = d_inv * (r - T.matvec(z))
    return z


def _smooth(level: AMGLevel, x, b, sweeps: int, phase: str = "pre",
            zero_guess: bool = False):
    """sweeps × (x += B(b − Ax)) with the level's smoother.

    ``phase`` matters only for the AIR F/C schedule (ref: amg.c:986-1015):
    the down cycle relaxes all points, the up cycle relaxes F-points with
    a trailing C-point sweep when there are more than two sweeps.

    ``zero_guess`` marks x == 0 on entry: the first sweep's residual is
    then just b, saving one A-matvec per level per cycle (hypre's own
    relax-on-zero-guess fast path; the pre-smooth of every cycle level
    starts from e₀ = 0).
    """
    if sweeps <= 0:
        return x

    def resid(x, first):
        # b − A·x, with A·0 elided on the first sweep of a zero guess
        if first and zero_guess:
            return b
        return b - A.matvec(x)

    A = level.A
    kind = level.smoother
    arrays = level.smooth_arrays
    if phase == "post" and level.up_smoother is not None:
        # independent post smoother (ref amg.c down_type/up_type)
        kind = level.up_smoother
        arrays = level.up_arrays
    if kind == "fsai":
        # complex smoother (ref: amg.c:441-457): x += ω Gᵀ G (b − A x);
        # ω = 1/λmax(GᵀG·A) keeps the sweep contractive (hypre FSAI
        # eig_max_iters smoothing scale)
        G, GT, omega = arrays
        for i in range(sweeps):
            x = x + omega * GT.matvec(G.matvec(resid(x, i == 0)))
        return x
    if kind in ("gs-fwd", "gs-bwd", "gs-sym"):
        # hybrid Gauss-Seidel: x += (D+L)⁻¹(b−Ax) with Jacobi-iterated
        # triangular solves (ref: amg.c relax types 3/4/6/8/13/14/89)
        d_inv, L, U = arrays
        for i in range(sweeps):
            if kind in ("gs-fwd", "gs-sym"):
                x = x + _tri_jacobi(d_inv, L, resid(x, i == 0))
            if kind in ("gs-bwd", "gs-sym"):
                x = x + _tri_jacobi(d_inv, U,
                                    resid(x, i == 0 and kind == "gs-bwd"))
        return x
    if kind.startswith("cf-"):
        # relaxation.order = 1 (hypre BoomerAMGSetRelaxOrder): CF
        # relaxation — C points first then F on the down sweep, F first
        # then C on the up sweep, each half-sweep against the refreshed
        # residual (ref: amg.c:895, hypre par_relax.c CF schedule)
        d_inv, fmask = arrays
        cmask = 1.0 - fmask
        first, second = ((fmask, cmask) if phase == "post"
                         else (cmask, fmask))
        for k in range(sweeps):
            x = x + first * d_inv * resid(x, k == 0)
            x = x + second * d_inv * resid(x, False)
        return x
    if kind.startswith("air-"):
        d_inv, fmask = arrays
        for k in range(sweeps):
            if phase == "post":
                mask = (1.0 - fmask) if (sweeps > 2 and k == sweeps - 1) \
                    else fmask
            else:
                mask = 1.0
            x = x + mask * d_inv * resid(x, k == 0)
        return x
    if kind == "chebyshev":
        d_inv, theta, delta, rhos = arrays
        order = rhos.shape[0]
        for i in range(sweeps):
            # Chebyshev on the residual equation A e = r, x += e
            r = resid(x, i == 0)
            z = d_inv * r / theta
            d = z
            rho_prev = rhos[0]
            for k in range(1, order):
                rk = d_inv * (r - A.matvec(z))
                d = rhos[k] * rho_prev * d + (2.0 * rhos[k] / delta) * rk
                z = z + d
                rho_prev = rhos[k]
            x = x + z
        return x
    (d_inv,) = arrays
    for i in range(sweeps):
        x = x + d_inv * resid(x, i == 0)
    return x


def _cycle(state: AMGState, lvl: int, b):
    """One multigrid cycle on level lvl for A_l e = b, e₀ = 0."""
    levels = state.levels
    level = levels[lvl]
    if lvl == len(levels) - 1:
        if hasattr(state.coarse_inv, "matvec"):     # diagonal inverse
            return state.coarse_inv.matvec(b)
        z = jnp.dot(state.coarse_inv, b, precision=HIGHEST)
        if state.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from ...parallel.mesh import ROWS_AXIS

            z = jax.lax.with_sharding_constraint(
                z, NamedSharding(state.mesh, P(ROWS_AXIS)))
        return z

    # named scopes label the HLO ops so profiler traces group device
    # time per level/phase (the Caliper-region analogue; see
    # scripts/profile_solve.py + scripts/analyze_caliper.py)
    with jax.named_scope(f"amg_L{lvl}_pre"):
        x = jnp.zeros_like(b)
        x = _smooth(level, x, b, level.pre_sweeps, phase="pre",
                    zero_guess=True)
        r = b - level.A.matvec(x)
    with jax.named_scope(f"amg_L{lvl}_restrict"):
        rc = level.R.matvec(r)
    ec = _cycle(state, lvl + 1, rc)
    if state.cycle_type == 1 and lvl + 1 < len(levels) - 1:
        # W-cycle: second coarse visit
        rc2 = rc - levels[lvl + 1].A.matvec(ec)
        ec = ec + _cycle(state, lvl + 1, rc2)
    with jax.named_scope(f"amg_L{lvl}_post"):
        x = x + level.P.matvec(ec)
        x = _smooth(level, x, b, level.post_sweeps, phase="post")
    return x


def amg_apply(state: AMGState, r):
    """z ≈ A⁻¹ r: max_iter cycles (preconditioner default 1)."""
    z = _cycle(state, 0, r)
    for _ in range(state.max_iter - 1):
        resid = r - state.levels[0].A.matvec(z)
        z = z + _cycle(state, 0, resid)
    return z
