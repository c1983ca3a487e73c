"""Preconditioned conjugate gradient.

Option surface parity with the reference PCG args (ref: src/internal/
pcg.c:16-27 / include/internal/pcg.h:21-32): max_iter, two_norm,
relative/absolute/residual/conv_fac tolerances, rel_change, recompute_res.

Algorithm follows the classical PCG recurrence (hypre_PCGSolve semantics):
convergence on ||r||₂ ≤ max(rtol·||b||₂, atol) when two_norm (the
reference default), else on the M-inner-product norm √⟨r,z⟩.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .base import Solver, jitted_core
from ..ops.vectors import dot, norm2


def _pcg_core(matvec, precon, b, x0, rtol, atol,
              max_iter: int, two_norm: bool, recompute_res: int):
    dtype = b.dtype
    r = b - matvec(x0)
    z = precon(r)
    gamma0 = dot(r, z)
    b_norm = norm2(b)
    r_norm0 = norm2(r) if two_norm else jnp.sqrt(
        jnp.abs(gamma0))
    # hypre semantics: if ||b|| == 0, scale by ||r0|| instead
    denom = jnp.where(b_norm > 0, b_norm, jnp.where(r_norm0 > 0, r_norm0, 1.0))
    threshold = jnp.maximum(rtol * denom, atol)

    history0 = jnp.full(max_iter + 1, jnp.nan, dtype=dtype).at[0].set(r_norm0)

    def cond(carry):
        x, r, z, p, gamma, i, norm, done, hist = carry
        return jnp.logical_and(i < max_iter, jnp.logical_not(done))

    def body(carry):
        x, r, z, p, gamma, i, norm, done, hist = carry
        s = matvec(p)
        sp = dot(s, p)
        # guard against breakdown
        alpha = jnp.where(sp != 0, gamma / sp, 0.0)
        x = x + alpha * p
        r = r - alpha * s
        # optional exact-residual recomputation (ref: recompute_res option)
        if recompute_res:
            r = jax.lax.cond(
                (i + 1) % recompute_res == 0,
                lambda _: b - matvec(x), lambda _: r, None)
        z = precon(r)
        gamma_new = dot(r, z)
        beta = jnp.where(gamma != 0, gamma_new / gamma, 0.0)
        p = z + beta * p
        norm = norm2(r) if two_norm else jnp.sqrt(
            jnp.abs(gamma_new))
        hist = hist.at[i + 1].set(norm)
        done = norm <= threshold
        return (x, r, z, p, gamma_new, i + 1, norm, done, hist)

    init = (x0, r, z, z, gamma0, jnp.int32(0), r_norm0,
            r_norm0 <= threshold, history0)
    x, r, z, p, gamma, iters, norm, done, history = jax.lax.while_loop(
        cond, body, init)
    return x, iters, norm, done, history


class PCGSolver(Solver):
    method = "pcg"

    def solve_core(self, A, pstate, b, x0):
        a = self.args
        statics = (int(a.max_iter), bool(a.two_norm), int(a.recompute_res))
        core = jitted_core(_pcg_core, type(A).matvec, self._precon_fn, statics)
        rtol = jnp.asarray(a.relative_tol, b.dtype)
        atol = jnp.asarray(a.absolute_tol, b.dtype)
        return core(A, self._precon_state, b, x0, rtol, atol)
