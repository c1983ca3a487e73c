"""BiCGSTAB (van der Vorst), preconditioned.

Option parity: ref src/internal/bicgstab.c:16-24.  Convergence on
||r||₂ ≤ max(rtol·||b||₂, atol), matching the hypre BiCGSTAB contract.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Solver, jitted_core
from ..ops.vectors import dot, norm2


def _bicgstab_core(matvec, precon, b, x0, rtol, atol, max_iter: int):
    dtype = b.dtype
    r0 = b - matvec(x0)
    r_hat = r0  # shadow residual
    r_norm0 = norm2(r0)
    b_norm = norm2(b)
    denom = jnp.where(b_norm > 0, b_norm, jnp.where(r_norm0 > 0, r_norm0, 1.0))
    threshold = jnp.maximum(rtol * denom, atol)
    history0 = jnp.full(max_iter + 1, jnp.nan, dtype=dtype).at[0].set(r_norm0)

    def cond(c):
        x, r, p, v, rho, alpha, omega, i, norm, done, hist = c
        return jnp.logical_and(i < max_iter, jnp.logical_not(done))

    def body(c):
        x, r, p, v, rho, alpha, omega, i, norm, done, hist = c
        rho_new = dot(r_hat, r)
        beta = jnp.where(
            jnp.logical_and(rho != 0, omega != 0),
            (rho_new / rho) * (alpha / omega), 0.0)
        p = r + beta * (p - omega * v)
        p_hat = precon(p)
        v = matvec(p_hat)
        rhv = dot(r_hat, v)
        alpha = jnp.where(rhv != 0, rho_new / rhv, 0.0)
        s = r - alpha * v
        s_hat = precon(s)
        t = matvec(s_hat)
        tt = dot(t, t)
        omega = jnp.where(tt != 0, dot(t, s) / tt, 0.0)
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        norm = norm2(r)
        hist = hist.at[i + 1].set(norm)
        done = jnp.logical_or(norm <= threshold, omega == 0.0)
        return (x, r, p, v, rho_new, alpha, omega, i + 1, norm, done, hist)

    zeros = jnp.zeros_like(b)
    one = jnp.asarray(1.0, dtype)
    init = (x0, r0, zeros, zeros, one, one, one, jnp.int32(0),
            r_norm0, r_norm0 <= threshold, history0)
    x, r, p, v, rho, alpha, omega, iters, norm, done, history = \
        jax.lax.while_loop(cond, body, init)
    return x, iters, norm, done, history


class BiCGSTABSolver(Solver):
    method = "bicgstab"

    def solve_core(self, A, pstate, b, x0):
        a = self.args
        statics = (int(a.max_iter),)
        core = jitted_core(_bicgstab_core, type(A).matvec, self._precon_fn,
                           statics)
        rtol = jnp.asarray(a.relative_tol, b.dtype)
        atol = jnp.asarray(a.absolute_tol, b.dtype)
        return core(A, self._precon_state, b, x0, rtol, atol)
