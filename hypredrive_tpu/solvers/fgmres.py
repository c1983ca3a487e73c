"""Flexible GMRES (right-preconditioned; preconditioner may change per
iteration — required for nested-Krylov MGR components).

Option parity: ref src/internal/fgmres.c:16-23.  Keeps the Z basis
(preconditioned directions) alongside V, so x is reconstructed from Z and
a varying preconditioner is sound (Saad's FGMRES).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Solver, jitted_core
from ..ops.vectors import HIGHEST, dot, norm2


def _fgmres_core(matvec, precon, b, x0, rtol, atol, max_iter: int, m: int):
    dtype = b.dtype
    n = b.shape[0]

    b_norm = norm2(b)
    r0 = b - matvec(x0)
    r0_norm = norm2(r0)
    denom = jnp.where(b_norm > 0, b_norm, jnp.where(r0_norm > 0, r0_norm, 1.0))
    threshold = jnp.maximum(rtol * denom, atol)
    history0 = jnp.full(max_iter + 1, jnp.nan, dtype=dtype).at[0].set(r0_norm)

    def cycle(x, total_iters, hist):
        r = b - matvec(x)
        beta = norm2(r)
        V0 = jnp.zeros((m + 1, n), dtype).at[0].set(
            jnp.where(beta > 0, r / beta, r))
        Z0 = jnp.zeros((m, n), dtype)
        H0 = jnp.zeros((m + 1, m), dtype)
        cs0 = jnp.zeros(m, dtype)
        sn0 = jnp.zeros(m, dtype)
        g0 = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def cond(c):
            V, Z, H, cs, sn, g, j, norm, done, hist = c
            return jnp.logical_and(j < m, jnp.logical_not(done))

        def body(c):
            V, Z, H, cs, sn, g, j, norm, done, hist = c
            z = precon(V[j])
            Z = Z.at[j].set(z)
            w = matvec(z)

            def mgs_step(i, carry):
                w, H = carry
                h = jnp.where(i <= j, dot(V[i], w), 0.0)
                w = w - h * V[i]
                H = H.at[i, j].set(h)
                return (w, H)

            w, H = jax.lax.fori_loop(0, m, mgs_step, (w, H))
            h_next = norm2(w)
            H = H.at[j + 1, j].set(h_next)
            V = V.at[j + 1].set(jnp.where(h_next > 0, w / h_next, w))

            def rot_step(i, Hcol):
                t = cs[i] * Hcol[i] + sn[i] * Hcol[i + 1]
                Hcol = Hcol.at[i + 1].set(-sn[i] * Hcol[i] + cs[i] * Hcol[i + 1])
                Hcol = Hcol.at[i].set(t)
                return Hcol

            Hcol = jax.lax.fori_loop(0, j, rot_step, H[:, j])
            d = jnp.sqrt(Hcol[j] ** 2 + Hcol[j + 1] ** 2)
            c_new = jnp.where(d > 0, Hcol[j] / d, 1.0)
            s_new = jnp.where(d > 0, Hcol[j + 1] / d, 0.0)
            Hcol = Hcol.at[j].set(c_new * Hcol[j] + s_new * Hcol[j + 1])
            Hcol = Hcol.at[j + 1].set(0.0)
            H = H.at[:, j].set(Hcol)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            g = g.at[j + 1].set(-s_new * g[j])
            g = g.at[j].set(c_new * g[j])
            norm = jnp.abs(g[j + 1])
            hist = hist.at[total_iters + j + 1].set(norm)
            done = norm <= threshold
            return (V, Z, H, cs, sn, g, j + 1, norm, done, hist)

        init = (V0, Z0, H0, cs0, sn0, g0, jnp.int32(0), beta,
                beta <= threshold, hist)
        V, Z, H, cs, sn, g, j, norm, done, hist = jax.lax.while_loop(
            cond, body, init)

        def back_sub(k, y):
            kk = m - 1 - k
            rhs = g[kk] - jnp.dot(H[kk, :], y, precision=HIGHEST)
            yk = jnp.where(jnp.logical_and(kk < j, H[kk, kk] != 0),
                           rhs / H[kk, kk], 0.0)
            return y.at[kk].set(yk)

        y = jax.lax.fori_loop(0, m, back_sub, jnp.zeros(m, dtype))
        dx = jnp.einsum("k,kn->n", y, Z, precision=HIGHEST)
        return x + dx, j, norm, hist

    def outer_cond(c):
        x, total, norm, done, hist = c
        return jnp.logical_and(total < max_iter, jnp.logical_not(done))

    def outer_body(c):
        x, total, norm, done, hist = c
        x, j, _, hist = cycle(x, total, hist)
        total = total + j
        r = b - matvec(x)
        norm = norm2(r)
        done = jnp.logical_or(norm <= threshold, j == 0)
        return (x, total, norm, done, hist)

    init = (x0, jnp.int32(0), r0_norm, r0_norm <= threshold, history0)
    x, iters, norm, done, history = jax.lax.while_loop(
        outer_cond, outer_body, init)
    return x, iters, norm, done, history


class FGMRESSolver(Solver):
    method = "fgmres"

    def solve_core(self, A, pstate, b, x0):
        a = self.args
        statics = (int(a.max_iter), int(a.krylov_dim))
        core = jitted_core(_fgmres_core, type(A).matvec, self._precon_fn,
                           statics)
        rtol = jnp.asarray(a.relative_tol, b.dtype)
        atol = jnp.asarray(a.absolute_tol, b.dtype)
        return core(A, self._precon_state, b, x0, rtol, atol)
