"""Chebyshev polynomial smoother/preconditioner.

Option parity with the reference Chebyshev args (ref: src/internal/
cheby.c:16-21): order, eig_est (CG/power iterations for the λmax
estimate), scale (diagonal scaling), fraction (target interval lower end
= fraction·λmax).

Device design: apply is ``order`` fused SpMV+AXPY steps — an ideal device
smoother (no sequential dependencies within a sweep); this is the
relaxation the AMG hierarchy prefers on device, mirroring the reference's
own GPU guidance (cheby/l1-Jacobi over GS).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .base import Preconditioner
from ..ops.vectors import norm2


def estimate_lambda_max(A, d_inv, iters: int = 10, seed: int = 0):
    """Power iteration on D⁻¹A for the largest eigenvalue (hypre estimates
    via CG; power iteration is equivalent for the smoother's purposes and
    maps to pure SpMVs)."""
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    v = jnp.asarray(rng.standard_normal(n), dtype=A.dtype)

    def body(_, carry):
        v, lam = carry
        w = d_inv * A.matvec(v)
        lam = norm2(w)
        v = w / jnp.maximum(lam, 1e-30)
        return (v, lam)

    _, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.asarray(1.0, A.dtype)))
    return lam


def cheby_coefficients(lam_max: float, fraction: float, order: int):
    """Three-term recurrence factors for the interval
    [fraction·λmax, λmax]."""
    lam_min = fraction * lam_max
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta if delta > 0 else 1.0
    rhos = np.zeros(max(order, 1))
    rho = 1.0 / sigma
    rhos[0] = rho
    for k in range(1, order):
        rho = 1.0 / (2.0 * sigma - rho)
        rhos[k] = rho
    return theta, delta, rhos


def _cheby_apply(state, r):
    """z ≈ A⁻¹ r by `order` Chebyshev steps on D⁻¹A (z₀ = 0)."""
    A, d_inv, theta, delta, rhos = state
    order = rhos.shape[0]  # static

    z = d_inv * r / theta
    d = z

    def body(k, carry):
        z, d, rho_prev = carry
        rho = rhos[k]
        resid = d_inv * (r - A.matvec(z))
        d = rho * rho_prev * d + (2.0 * rho / delta) * resid
        z = z + d
        return (z, d, rho)

    z, d, _ = jax.lax.fori_loop(1, order, body, (z, d, rhos[0]))
    return z


class ChebyshevPrecon(Preconditioner):
    method = "chebyshev"
    apply_fn = staticmethod(_cheby_apply)

    def setup(self, system):
        A = system.A
        order = int(self.args.get("order", 2))
        fraction = float(self.args.get("fraction", 0.3))
        eig_iters = int(self.args.get("eig_est", 10))
        scale = bool(self.args.get("scale", True))
        if scale:
            diag = A.diagonal()
            d_inv = jnp.where(diag != 0, 1.0 / diag, 1.0)
        else:
            d_inv = jnp.ones(A.shape[0], dtype=A.dtype)
        lam_max = float(estimate_lambda_max(A, d_inv, eig_iters))
        lam_max *= 1.1  # safety margin (hypre pads its estimate similarly)
        theta, delta, rhos = cheby_coefficients(lam_max, fraction, order)
        self.state = (
            A, d_inv,
            jnp.asarray(theta, A.dtype), jnp.asarray(delta, A.dtype),
            jnp.asarray(rhos, A.dtype),
        )
        self.is_setup = True


def make_cheby_state(A, order: int, fraction: float, eig_iters: int = 10,
                     scale: bool = True):
    """Build Chebyshev state for use as an AMG level smoother."""
    if scale:
        diag = A.diagonal()
        d_inv = jnp.where(diag != 0, 1.0 / diag, 1.0)
    else:
        d_inv = jnp.ones(A.shape[0], dtype=A.dtype)
    lam_max = float(estimate_lambda_max(A, d_inv, eig_iters)) * 1.1
    theta, delta, rhos = cheby_coefficients(lam_max, fraction, order)
    return (A, d_inv, jnp.asarray(theta, A.dtype), jnp.asarray(delta, A.dtype),
            jnp.asarray(rhos, A.dtype))
