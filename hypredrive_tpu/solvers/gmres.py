"""Restarted GMRES(m), left-preconditioned (hypre convention).

Option parity with the reference GMRES args (ref: src/internal/
gmres.c:16-27): min_iter, max_iter, krylov_dim, relative/absolute/
conv_fac tolerances, skip_real_res_check, rel_change.

Implementation: modified Gram-Schmidt Arnoldi over M⁻¹A with Givens
rotations; all buffers have static shape (krylov_dim+1, n).  Convergence
is tested on the rotation-estimated residual; on inner convergence the
true (preconditioned) residual is recomputed and checked unless
``skip_real_res_check`` (ref: hypre GMRES real-residual guard).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from .base import Solver, jitted_core
from ..ops.vectors import HIGHEST, dot, norm2


def _gmres_core(matvec, precon, b, x0, rtol, atol,
                max_iter: int = 300, m: int = 30,
                skip_real_res_check: bool = False, *,
                num_tags: int = 0, xref=None, tags=None):
    """``num_tags`` > 0 activates tagged reference-solution error
    tracking: per inner iteration the current iterate is reconstructed
    (small back-substitution + basis combination) and its per-dof-block
    error norms vs ``xref`` are recorded (ref: hypredrv_GMRESSet-
    RefSolution src/internal/gmres.c:80-103; hypre's tagged inner
    product over dofmap tags, src/HYPREDRV.c:693-726)."""
    dtype = b.dtype
    n = b.shape[0]

    def block_err(xk):
        e = xk - xref
        ss = jax.ops.segment_sum(e * e, tags, num_segments=num_tags)
        return jnp.sqrt(ss)

    # hypre convention: the convergence contract is on the TRUE residual
    # (epsilon = max(a_tol, r_tol*||b||) with unpreconditioned norms;
    # the refOutput goldens land just under r_tol in true rel-res even
    # for MGR preconditioners whose M^-1 norm underestimates the true
    # residual 20x).  The inner Givens estimate tracks the
    # PRECONDITIONED residual, so each restart cycle converts the
    # remaining true-residual reduction into preconditioned units via
    # the cycle-start ratio and the outer real-residual check (true
    # units) has the final word.
    b_norm = norm2(b)
    rt0 = b - matvec(x0)
    r0_norm = norm2(rt0)
    denom = jnp.where(b_norm > 0, b_norm, jnp.where(r0_norm > 0, r0_norm, 1.0))
    threshold = jnp.maximum(rtol * denom, atol)

    history0 = jnp.full(max_iter + 1, jnp.nan, dtype=dtype).at[0].set(r0_norm)
    nt = max(1, num_tags)
    ehist0 = jnp.full((max_iter + 1, nt), jnp.nan, dtype=dtype)
    if num_tags > 0:
        ehist0 = ehist0.at[0].set(block_err(x0))

    def arnoldi_cycle(x, total_iters, r_true_norm, hist, ehist):
        """One restart cycle; returns updated x, iters, residual estimate."""
        r = precon(b - matvec(x))
        beta = norm2(r)
        # inner threshold: shrink the preconditioned estimate by the
        # factor the TRUE residual still needs (plus the floor of an
        # absolute-zero beta)
        factor = jnp.where(r_true_norm > 0, threshold / r_true_norm, 1.0)
        inner_threshold = beta * jnp.minimum(factor, 1.0)
        V0 = jnp.zeros((m + 1, n), dtype)
        V0 = V0.at[0].set(jnp.where(beta > 0, r / beta, r))
        H0 = jnp.zeros((m + 1, m), dtype)
        cs0 = jnp.zeros(m, dtype)
        sn0 = jnp.zeros(m, dtype)
        g0 = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def cond(c):
            V, H, cs, sn, g, j, norm, done, hist, ehist = c
            return jnp.logical_and(j < m, jnp.logical_not(done))

        def body(c):
            V, H, cs, sn, g, j, norm, done, hist, ehist = c
            w = precon(matvec(V[j]))
            # modified Gram-Schmidt against all basis vectors (masked ≥ j+1)
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

            # apply previous Givens rotations to column j
            def rot_step(i, Hcol):
                t = cs[i] * Hcol[i] + sn[i] * Hcol[i + 1]
                Hcol = Hcol.at[i + 1].set(-sn[i] * Hcol[i] + cs[i] * Hcol[i + 1])
                Hcol = Hcol.at[i].set(t)
                return Hcol

            Hcol = jax.lax.fori_loop(0, j, rot_step, H[:, j])
            # new rotation to zero H[j+1, j]
            denom_r = jnp.sqrt(Hcol[j] ** 2 + Hcol[j + 1] ** 2)
            c_new = jnp.where(denom_r > 0, Hcol[j] / denom_r, 1.0)
            s_new = jnp.where(denom_r > 0, Hcol[j + 1] / denom_r, 0.0)
            Hcol = Hcol.at[j].set(c_new * Hcol[j] + s_new * Hcol[j + 1])
            Hcol = Hcol.at[j + 1].set(0.0)
            H = H.at[:, j].set(Hcol)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            g = g.at[j + 1].set(-s_new * g[j])
            g = g.at[j].set(c_new * g[j])
            norm = jnp.abs(g[j + 1])
            hist = hist.at[total_iters + j + 1].set(norm)
            if num_tags > 0:
                # reconstruct the current iterate (small masked
                # back-substitution on the updated Hessenberg) and log
                # the per-block error vs xref
                def bs(k, y):
                    kk = m - 1 - k
                    rhs_v = g[kk] - jnp.dot(H[kk, :], y, precision=HIGHEST)
                    yk = jnp.where(
                        jnp.logical_and(kk <= j, H[kk, kk] != 0),
                        rhs_v / H[kk, kk], 0.0)
                    return y.at[kk].set(yk)

                y_j = jax.lax.fori_loop(0, m, bs, jnp.zeros(m, dtype))
                dx_j = jnp.einsum("k,kn->n", y_j, V[:m],
                                  precision=HIGHEST)
                ehist = ehist.at[total_iters + j + 1].set(
                    block_err(x + dx_j))
            done = norm <= inner_threshold
            return (V, H, cs, sn, g, j + 1, norm, done, hist, ehist)

        init = (V0, H0, cs0, sn0, g0, jnp.int32(0), beta,
                beta <= inner_threshold, hist, ehist)
        V, H, cs, sn, g, j, norm, done, hist, ehist = jax.lax.while_loop(
            cond, body, init)

        # back-substitution on the j×j upper-triangular system (masked to m)
        def back_sub(k, y):
            # iterate k = m-1 .. 0; only active for k < j
            kk = m - 1 - k
            rhs = g[kk] - jnp.dot(H[kk, :], y, precision=HIGHEST)
            yk = jnp.where(jnp.logical_and(kk < j, H[kk, kk] != 0),
                           rhs / H[kk, kk], 0.0)
            return y.at[kk].set(yk)

        y = jax.lax.fori_loop(0, m, back_sub, jnp.zeros(m, dtype))
        dx = jnp.einsum("k,kn->n", y, V[:m], precision=HIGHEST)
        return x + dx, j, norm, done, hist, ehist

    def outer_cond(c):
        x, total, norm, done, hist, ehist = c
        return jnp.logical_and(total < max_iter, jnp.logical_not(done))

    def outer_body(c):
        x, total, norm, done, hist, ehist = c
        x, j, norm_est, conv_inner, hist, ehist = arnoldi_cycle(
            x, total, norm, hist, ehist)
        total = total + j
        if skip_real_res_check:
            # trust the inner estimate: the cycle ran until it shrank by
            # the factor the true residual still needed (ref: hypre
            # skip_real_r_norm_check)
            norm = norm_est
            done = conv_inner
        else:
            # real-residual check in TRUE units (ref: hypre GMRES
            # "false convergence" guard — continue when the actual
            # residual has not met epsilon)
            r = b - matvec(x)
            norm = norm2(r)
            done = norm <= threshold
        # no progress this cycle → breakdown, stop
        done = jnp.logical_or(done, j == 0)
        return (x, total, norm, done, hist, ehist)

    init = (x0, jnp.int32(0), r0_norm, r0_norm <= threshold, history0,
            ehist0)
    x, iters, norm, done, history, ehist = jax.lax.while_loop(
        outer_cond, outer_body, init)
    if num_tags > 0:
        return x, iters, norm, done, history, ehist
    return x, iters, norm, done, history


class GMRESSolver(Solver):
    method = "gmres"

    def solve_core(self, A, pstate, b, x0):
        a = self.args
        statics = (int(a.max_iter), int(a.krylov_dim),
                   bool(a.get("skip_real_res_check", False)))
        rtol = jnp.asarray(a.relative_tol, b.dtype)
        atol = jnp.asarray(a.absolute_tol, b.dtype)
        sysobj = getattr(self, "_system", None)
        xref = getattr(sysobj, "xref", None) if sysobj is not None else None
        if xref is not None:
            # tagged reference-solution error tracking (ref:
            # hypredrv_GMRESSetRefSolution + vector tags from the
            # dofmap, src/HYPREDRV.c:693-726); one tag when no dofmap
            dofmap = getattr(sysobj, "dofmap", None)
            if dofmap is not None:
                tags = jnp.asarray(np.asarray(dofmap), jnp.int32)
                nt = int(np.asarray(dofmap).max()) + 1
            else:
                tags = jnp.zeros(b.shape[0], jnp.int32)
                nt = 1
            core = _tagged_core(type(A).matvec, self._precon_fn,
                                statics, nt)
            return core(A, pstate, b, x0, rtol, atol,
                        jnp.asarray(xref, b.dtype), tags)
        core = jitted_core(_gmres_core, type(A).matvec, self._precon_fn,
                           statics)
        return core(A, self._precon_state, b, x0, rtol, atol)


@lru_cache(maxsize=64)
def _tagged_core(matvec_fn, precon_fn, statics, num_tags):
    def wrapped(A, pstate, b, x0, rtol, atol, xref, tags):
        mv = lambda v: matvec_fn(A, v)
        pc = lambda r: precon_fn(pstate, r)
        return _gmres_core(mv, pc, b, x0, rtol, atol, *statics,
                           num_tags=num_tags, xref=xref, tags=tags)
    return jax.jit(wrapped)
