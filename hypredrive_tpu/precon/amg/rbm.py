"""Interpolation-vector (rigid-body-mode) augmentation.

Elasticity AMG needs the rotational near-null-space modes represented in
range(P) — plain distance-based interpolation only reproduces constants.
The reference wires RBMs through hypre's GM variants
(ref: src/internal/amg.c:602 hypredrv_AMGSetRBMs,
HYPRE_BoomerAMGSetInterpVectors / SetInterpVecVariant, used by the
elasticity example with 6 modes).

Construction: instead of hypre's per-row C loops, each F-row
of P gets the **minimum-norm weight correction** that makes it exactly
interpolate the coarse-restricted modes within its existing sparsity
pattern:

    Δw_i = V_J (V_Jᵀ V_J)⁺ (v_i − V_Jᵀ w_i)

batched over rows with equal stencil size (one vectorized pinv/matmul
per group).  The minimal-Δw choice preserves the diffusion accuracy of
the base interpolation; with |J| < #modes the correction enforces the
best-fit projection (hypre's QMax truncation has the same effect).
Coarse-level vectors are the C-point injection, as hypre does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def _grow_pattern(P: sp.csr_matrix, cf: np.ndarray, V: np.ndarray,
                  Vc: np.ndarray, A: sp.csr_matrix, qmax: int
                  ) -> sp.csr_matrix:
    """GM2 pattern expansion (ref: amg.c:1025 SetInterpVecQMax(4) and
    hypre interp_vec_variant 2): each F row may gain up to ``qmax`` NEW
    interpolation entries, chosen from the distance-2 C-points (the
    coarse columns reachable through the row's A-neighbors) that best
    fit the row's residual mode constraints.  New entries start at
    weight 0 — the min-norm correction then distributes over the grown
    pattern, recovering the rotational modes that the distance-1
    pattern cannot represent."""
    n, nC = P.shape
    F = np.flatnonzero(cf < 0)
    # residual of the mode constraints on the current pattern
    R = V[F] - (P[F] @ Vc)                       # (nF, k)
    # candidate pattern: |A[F]| @ |P| minus existing P[F]
    pat = sp.csr_matrix(
        (np.ones(A.nnz, np.int8), A.indices, A.indptr), shape=A.shape)[F]
    ppat = sp.csr_matrix(
        (np.ones(P.nnz, np.int8), P.indices, P.indptr), shape=P.shape)
    cand = sp.csr_matrix(pat @ ppat, dtype=np.int8)
    cand = sp.csr_matrix(cand - cand.multiply(ppat[F]))  # drop existing
    cand.eliminate_zeros()
    cand.sort_indices()
    if cand.nnz == 0:
        return P
    rows_c = np.repeat(np.arange(len(F)), np.diff(cand.indptr))
    cols_c = cand.indices
    # score = |<Vc[j], r_i>| / ||Vc[j]||
    num = np.abs(np.einsum("ek,ek->e", Vc[cols_c], R[rows_c]))
    den = np.linalg.norm(Vc[cols_c], axis=1) + 1e-300
    score = num / den
    # top-qmax per row (grouped argpartition over equal-length rows)
    counts = np.diff(cand.indptr)
    take = np.zeros(cand.nnz, bool)
    for m in np.unique(counts):
        if m == 0:
            continue
        grp = np.flatnonzero(counts == m)
        idx = cand.indptr[grp][:, None] + np.arange(m)[None, :]
        if m <= qmax:
            take[idx.ravel()] = True
            continue
        part = np.argpartition(-score[idx], qmax - 1, axis=1)[:, :qmax]
        take[np.take_along_axis(idx, part, axis=1).ravel()] = True
    take &= score > 1e-14
    add_r = F[rows_c[take]]
    add_c = cols_c[take]
    if len(add_r) == 0:
        return P
    Pc = P.tocoo()
    out = sp.csr_matrix(
        (np.concatenate([Pc.data, np.zeros(len(add_r))]),
         (np.concatenate([Pc.row, add_r]),
          np.concatenate([Pc.col, add_c]))), shape=P.shape)
    out.sum_duplicates()
    out.sort_indices()
    return out


def augment_interpolation(P: sp.csr_matrix, cf: np.ndarray,
                          V: np.ndarray, rcond: float = 1e-10,
                          A: sp.csr_matrix = None, qmax: int = 0
                          ) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Return (P', V_coarse): P' exactly (or best-fit) interpolates V.

    P: (n, nC) with identity C rows; cf: PMIS marks (>0 C, <0 F);
    V: (n, k) near-null-space vectors (columns = modes); with ``qmax``
    > 0 and the level operator ``A`` given, each F row may first gain up
    to qmax new entries (GM2 pattern growth, ref amg.c:1025).
    """
    V = np.atleast_2d(np.asarray(V, dtype=np.float64))
    if V.shape[0] != P.shape[0]:
        V = V.T
    n, k = V.shape
    C = np.flatnonzero(cf > 0)
    F = np.flatnonzero(cf < 0)
    Vc = V[C]  # coarse modes by injection

    P = P.tocsr().copy()
    P.sort_indices()
    if qmax > 0 and A is not None and len(F):
        P = _grow_pattern(P, cf, V, Vc, sp.csr_matrix(A), qmax).copy()
        P.sort_indices()
    indptr, indices, data = P.indptr, P.indices, P.data

    counts = np.diff(indptr)
    # F rows only (C rows are identity and already exact)
    f_rows = F[counts[F] > 0]
    f_counts = counts[f_rows]

    for m in np.unique(f_counts):
        grp = f_rows[f_counts == m]
        starts = indptr[grp]
        idx = starts[:, None] + np.arange(m)[None, :]   # (g, m) nnz slots
        J = indices[idx]                                 # coarse col ids
        W = data[idx]                                    # current weights
        VJ = Vc[J]                                       # (g, m, k)
        # residual of the mode-interpolation constraints
        r = V[grp] - np.einsum("gm,gmk->gk", W, VJ)      # (g, k)
        G = np.einsum("gmk,gml->gkl", VJ, VJ)            # (g, k, k) Gram
        Ginv = np.linalg.pinv(G, rcond=rcond)
        dw = np.einsum("gmk,gkl,gl->gm", VJ, Ginv, r)
        data[idx.ravel()] = (W + dw).ravel()

    P_aug = sp.csr_matrix((data, indices, indptr), shape=P.shape)
    return P_aug, Vc
