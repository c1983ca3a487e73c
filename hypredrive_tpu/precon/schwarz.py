"""Additive / restricted-additive Schwarz.

Reference: src/internal/schwarz.c — variants mp/ad/ras-*/as-* with local
solvers iluk/ilut/spdirect (ref vocab schwarz.c:44-70).

Design: subdomains are contiguous row blocks extended by ``overlap``
sparsity rings.  All local solves are *batched dense inverses* applied
as one (nblk, m, m) × (nblk, m) batched matmul —
the spdirect local solver; the iluk/ilut variants use the same dense
apply (exact local solves, a strictly stronger preconditioner with the
same sparsity footprint at these subdomain sizes).  ``ras-*`` variants
write back only owned rows (restricted); ``as-*`` add overlapped
contributions.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from .base import Preconditioner
from ..ops.vectors import HIGHEST
from ..core.errors import HypredrvError, ErrorCode


def _schwarz_apply(state, r):
    inv, ext_idx, own_mask, weight = state
    r_ext = r[ext_idx]                                  # (nblk, m) gather
    z_ext = jnp.einsum("bij,bj->bi", inv, r_ext,        # batched solve
                       precision=HIGHEST)
    contrib = jnp.where(own_mask, z_ext, 0.0) * weight
    z = jnp.zeros_like(r)
    z = z.at[ext_idx.ravel()].add(contrib.ravel())
    return z


def _local_ilu_inverse(sub: sp.csr_matrix, local_solver: str,
                       fill: int, droptol: float, max_nnz: int
                       ) -> np.ndarray:
    """Dense M⁻¹ ≈ (LU)⁻¹ of one subdomain from its iluk/ilut factors
    (ref: schwarz.c local_solver_type; hypre factors each domain and
    back-solves — here the approximate factors are inverted once at
    setup so the apply stays a batched matmul)."""
    import scipy.sparse.linalg as spla

    k = sub.shape[0]
    if local_solver == "ilut":
        lu = spla.spilu(sp.csc_matrix(sub), drop_tol=droptol,
                        fill_factor=max(1.0, max_nnz / max(
                            1.0, sub.nnz / k)),
                        permc_spec="NATURAL", diag_pivot_thresh=0.0)
    else:                                   # iluk
        lu = spla.spilu(sp.csc_matrix(sub), drop_tol=1e-12,
                        fill_factor=max(1.0, 1.0 + 2.0 * fill),
                        permc_spec="NATURAL", diag_pivot_thresh=0.0)
    from scipy.linalg import solve_triangular

    Ld = np.asarray(lu.L.todense())
    Ud = np.asarray(lu.U.todense())
    eye = np.eye(k)
    z = solve_triangular(Ld, eye, lower=True, unit_diagonal=False)
    return solve_triangular(Ud, z, lower=False)


def build_schwarz(A_host: sp.csr_matrix, block_size: int = 64,
                  overlap: int = 1, restricted: bool = True,
                  relax_weight: float = 1.0, dtype=jnp.float64,
                  local_solver: str = "spdirect", fill: int = 0,
                  droptol: float = 1e-2, max_nnz: int = 1000):
    A = sp.csr_matrix(A_host)
    A.sort_indices()
    n = A.shape[0]
    block_size = max(4, min(block_size, n))
    nblk = (n + block_size - 1) // block_size

    ext_sets = []
    own_sets = []
    G = A  # sparsity graph
    for b in range(nblk):
        lo, hi = b * block_size, min((b + 1) * block_size, n)
        owned = np.arange(lo, hi)
        ext = owned
        for _ in range(max(0, overlap)):
            nbr = np.unique(G[ext].indices)
            ext = np.union1d(ext, nbr)
        ext_sets.append(ext)
        own_sets.append(owned)

    m = max(len(e) for e in ext_sets)
    ext_idx = np.zeros((nblk, m), dtype=np.int32)
    own_mask = np.zeros((nblk, m), dtype=bool)
    dense = np.zeros((nblk, m, m))
    for b, (ext, owned) in enumerate(zip(ext_sets, own_sets)):
        k = len(ext)
        ext_idx[b, :k] = ext
        # pad slots repeat the first index with masked contribution
        ext_idx[b, k:] = ext[0] if k else 0
        if restricted:
            own_mask[b, :k] = np.isin(ext, owned)
        else:
            own_mask[b, :k] = True
        sub = sp.csr_matrix(A[ext][:, ext])
        if local_solver in ("iluk", "ilut") and k > 1:
            dense[b, :k, :k] = _local_ilu_inverse(
                sub, local_solver, fill, droptol, max_nnz)
            dense[b, k:, k:] = np.eye(m - k)
        else:
            dense[b, :k, :k] = sub.todense()
            dense[b, k:, k:] = np.eye(m - k)
    if local_solver in ("iluk", "ilut"):
        inv = dense                  # blocks already hold (LU)⁻¹
    else:
        inv = np.linalg.inv(dense)   # spdirect: exact local inverse

    if not restricted:
        # additive variant: average overlapped contributions
        counts = np.zeros(n)
        np.add.at(counts, ext_idx.ravel(),
                  own_mask.astype(np.float64).ravel())
        weight_vec = relax_weight / np.maximum(counts, 1.0)
        weight = jnp.asarray(weight_vec, dtype=dtype)[
            jnp.asarray(ext_idx)]
    else:
        weight = jnp.full((nblk, m), relax_weight, dtype=dtype)

    return (jnp.asarray(inv, dtype=dtype),
            jnp.asarray(ext_idx),
            jnp.asarray(own_mask),
            weight)


class SchwarzPrecon(Preconditioner):
    method = "schwarz"
    apply_fn = staticmethod(_schwarz_apply)

    def setup(self, system):
        A_host = system.M_host if system.M_host is not None else system.A_host
        if A_host is None:
            A_host = system.A.to_csr()
        variant = int(self.args.get("variant", 10))
        # ras-* variants: 10, 20, 30, 40; as-*: 11, 21, 31, 41;
        # classical mp/ad (0-4) treated as additive
        restricted = variant in (10, 20, 30, 40)
        overlap = int(self.args.get("overlap", 1))
        # domain_type (ref: schwarz.c) sizes the agglomerates; map the
        # enum onto block sizes: 0=point(small), 1=node, 2=generated(64)
        domain_type = int(self.args.get("domain_type", 2))
        block_size = {0: 16, 1: 32, 2: 64}.get(domain_type, 64)
        # local solver (ref: schwarz.c:44-70): the ras-*/as-* variant
        # name carries it (ras-iluk=10/ras-ilut=20/ras-spdirect=40);
        # classical mp/ad variants fall back to local_solver_type.
        # iluk/ilut build the subdomain solve from approximate factors;
        # spdirect/superlu is the exact dense inverse; amg maps to
        # spdirect (a local AMG per subdomain is stronger than these
        # block sizes warrant).
        if variant >= 10:
            local_solver = {1: "iluk", 2: "ilut"}.get(
                variant // 10, "spdirect")
        else:
            lst = int(self.args.get("local_solver_type", 0))
            local_solver = {0: "iluk", 1: "ilut"}.get(lst, "spdirect")
        self.state = build_schwarz(
            A_host, block_size=block_size, overlap=overlap,
            restricted=restricted,
            relax_weight=float(self.args.get("relax_weight", 1.0)),
            dtype=system.dtype, local_solver=local_solver,
            fill=int(self.args.get("iluk_level_of_fill", 0)),
            droptol=float(self.args.get("ilut_droptol", 1e-2)),
            max_nnz=int(self.args.get("ilut_max_nnz_row", 1000)))
        self.is_setup = True
