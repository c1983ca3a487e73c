"""ILU preconditioners: bj-ilu0 / bj-iluk / bj-ilut.

Reference: src/internal/ilu.c — the option surface includes the
device-friendly switch this implementation is built around:
``tri_solve: off`` + ``lower_jac_iters``/``upper_jac_iters`` replaces the
sequential triangular solves with Jacobi sweeps (exactly hypre's GPU
path).  On device the sweeps are fused SpMV+AXPY chains.

Factorization runs on host:
  * ilu0  — native IKJ ILU(0) on the CSR pattern (vectorized per row
    against prior rows via hashed lookups),
  * iluk/ilut — SuperLU's ILUTP via scipy.sparse.linalg.spilu with
    natural ordering (fill_level/droptol mapped to fill_factor/drop_tol).

Apply: z = U⁻¹(L⁻¹ r) with each triangular solve approximated by
``jac_iters`` Jacobi sweeps:  x ← D⁻¹(r − (T−D)x).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from .base import Preconditioner
from ..core.errors import HypredrvError, ErrorCode
from ..ops.device_matrix import EllMatrix


def ilu0_factor(A: sp.csr_matrix):
    """ILU(0): L (unit lower) and U on A's pattern (host, IKJ order)."""
    A = sp.csr_matrix(A, dtype=np.float64)
    A.sort_indices()
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices
    data = A.data.copy()

    # position lookup for (row, col) → data index
    keys = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr)) * n \
        + indices

    def find(r, c):
        q = r * n + c
        p = np.searchsorted(keys, q)
        if p < len(keys) and keys[p] == q:
            return p
        return -1

    diag_pos = np.array([find(i, i) for i in range(n)], dtype=np.int64)
    if (diag_pos < 0).any():
        raise HypredrvError("ILU(0) requires a full diagonal",
                            ErrorCode.MATRIX)

    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        row_cols = indices[lo:hi]
        for kk in range(lo, hi):
            k = indices[kk]
            if k >= i:
                break
            dk = data[diag_pos[k]]
            if dk == 0:
                continue
            lik = data[kk] / dk
            data[kk] = lik
            # subtract lik * U[k, j] for j in row i's pattern, j > k
            uk_lo, uk_hi = indptr[k], indptr[k + 1]
            uk_cols = indices[uk_lo:uk_hi]
            sel = uk_cols > k
            common, ai, bi = np.intersect1d(
                row_cols, uk_cols[sel], return_indices=True)
            if len(common):
                data[lo + ai] -= lik * data[uk_lo + np.flatnonzero(sel)[bi]]

    L = sp.csr_matrix((data.copy(), indices.copy(), indptr.copy()),
                      shape=A.shape)
    U = L.copy()
    rows = np.repeat(np.arange(n), np.diff(indptr))
    L.data[indices > rows] = 0.0
    L.data[indices == rows] = 1.0
    U.data[indices < rows] = 0.0
    L.eliminate_zeros()
    U.eliminate_zeros()
    return L.tocsr(), U.tocsr()


def _tri_jacobi_apply(state, r):
    """z = U⁻¹ L⁻¹ r via Jacobi sweeps on each triangular factor.

    L is stored as its *strict* lower part (unit diagonal):
        x_{k+1} = r − L_strict x_k        (nilpotent → exact in ≤depth sweeps)
    U is stored whole:
        y_{k+1} = y_k + D_U⁻¹ (x − U y_k)
    """
    L, U, l_dinv, u_dinv, l_iters, u_iters = state

    x = r
    x = jax.lax.fori_loop(0, l_iters, lambda _, x: r - L.matvec(x), x)

    y = u_dinv * x

    def u_body(_, y):
        return y + u_dinv * (x - U.matvec(y))

    y = jax.lax.fori_loop(0, u_iters, u_body, y)
    return y


@jax.tree_util.register_pytree_node_class
class SchurILUState:
    """Two-level GMRES-Schur ILU (ref: ilu.c gmres-iluk/gmres-ilut,
    hypre ILU types 10/11): interior dofs eliminated with block ILU,
    the interface Schur complement S = C − E B⁻¹ F solved matrix-free
    with a fixed-budget inner GMRES preconditioned by ILU(C)."""

    def __init__(self, int_idx, if_idx, b_state, c_state, E, F, C,
                 schur_max_iter, n):
        self.int_idx = int_idx
        self.if_idx = if_idx
        self.b_state = b_state      # ILU factors of B = A[int, int]
        self.c_state = c_state      # ILU factors of C = A[if, if]
        self.E = E                  # A[if, int]
        self.F = F                  # A[int, if]
        self.C = C                  # A[if, if] operator
        self.schur_max_iter = schur_max_iter  # static
        self.n = n                  # static

    def tree_flatten(self):
        return ((self.int_idx, self.if_idx, self.b_state, self.c_state,
                 self.E, self.F, self.C),
                (self.schur_max_iter, self.n))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def _schur_apply(state: SchurILUState, r):
    """z = M⁻¹r for the two-level factorization
        M = [B 0; E S][I B⁻¹F; 0 I],  S ≈ C − E B⁻¹ F  (GMRES inner)."""
    from ..solvers.gmres import _gmres_core

    r_int = r[state.int_idx]
    r_if = r[state.if_idx]

    b_inv = lambda v: _tri_jacobi_apply(state.b_state, v)
    z0 = b_inv(r_int)
    rs = r_if - state.E.matvec(z0)

    def s_mv(v):
        return state.C.matvec(v) - state.E.matvec(b_inv(state.F.matvec(v)))

    c_inv = lambda v: _tri_jacobi_apply(state.c_state, v)
    m = state.schur_max_iter
    z_if, *_ = _gmres_core(s_mv, c_inv, rs, jnp.zeros_like(rs),
                           jnp.asarray(0.0, r.dtype),
                           jnp.asarray(0.0, r.dtype), m, m, True)
    z_int = z0 - b_inv(state.F.matvec(z_if))
    z = jnp.zeros_like(r)
    z = z.at[state.int_idx].set(z_int)
    z = z.at[state.if_idx].set(z_if)
    return z


def _ilu_apply(state, r):
    """Static dispatch on the ILU state family."""
    if isinstance(state, NSHState):
        return state.M.matvec(r)
    if isinstance(state, SchurILUState):
        return _schur_apply(state, r)
    if isinstance(state, tuple) and len(state) == 4:
        # RAS-ILU → Schwarz state (ref: ilu.c ras-iluk/ras-ilut)
        from .schwarz import _schwarz_apply

        return _schwarz_apply(state, r)
    return _tri_jacobi_apply(state, r)


def _build_schur_state(A_host: sp.csr_matrix, args, dtype,
                       n_blocks: int = 0):
    """Interior/interface split by contiguous row blocks (the device
    analogue of hypre's per-rank boundary split; ref: ilu.c GMRES-Schur).
    """
    A = sp.csr_matrix(A_host)
    A.sort_indices()
    n = A.shape[0]
    if n_blocks <= 0:
        n_blocks = max(2, min(16, n // 512))
    blk = (np.arange(n, dtype=np.int64) * n_blocks) // n
    col_blk = blk[A.indices]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cross = col_blk != blk[rows]
    is_if = np.zeros(n, bool)
    is_if[np.unique(rows[cross])] = True
    is_if[np.unique(A.indices[cross])] = True
    if_rows = np.flatnonzero(is_if)
    int_rows = np.flatnonzero(~is_if)
    if len(if_rows) == 0 or len(int_rows) == 0:
        return None     # degenerate split → plain ILU

    B = sp.csr_matrix(A[int_rows][:, int_rows])
    E = sp.csr_matrix(A[if_rows][:, int_rows])
    F = sp.csr_matrix(A[int_rows][:, if_rows])
    C = sp.csr_matrix(A[if_rows][:, if_rows])
    b_state = _factor_to_state(B, args, dtype)
    c_state = _factor_to_state(C, args, dtype)
    return SchurILUState(
        int_idx=jnp.asarray(int_rows, jnp.int32),
        if_idx=jnp.asarray(if_rows, jnp.int32),
        b_state=b_state, c_state=c_state,
        E=EllMatrix.from_csr(E, dtype=dtype),
        F=EllMatrix.from_csr(F, dtype=dtype),
        C=EllMatrix.from_csr(C, dtype=dtype),
        schur_max_iter=max(1, int(args.get("schur_max_iter", 5))),
        n=n)


def _factor_to_state(A_host: sp.csr_matrix, args, dtype):
    """(L, U, dinvs, iters) tri-solve state for one ILU factorization.

    ``reordering: 1`` applies RCM (the hypre ILU local-reordering
    option, ref: include/internal/ilu.h:19-34) before factoring.  The
    factors are then similarity-permuted BACK to the original numbering
    (Pᵀ L P / Pᵀ U P): they are no longer triangular, but the Jacobi-
    iterated tri-solve only needs nilpotency of the off-diagonal part,
    which a permuted strictly-triangular matrix keeps ((PᵀLP)ᵏ =
    PᵀLᵏP) — so the apply path is unchanged and pays zero gather cost
    on device."""
    itype = int(args.get("type", 0))
    fill = int(args.get("fill_level", 0))
    droptol = float(args.get("droptol", 1e-2))
    reorder = int(args.get("reordering", 0))
    perm = None
    if reorder == 1 and A_host.shape[0] > 1:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        perm = np.asarray(reverse_cuthill_mckee(
            sp.csr_matrix(A_host), symmetric_mode=False))
        A_host = sp.csr_matrix(A_host[perm][:, perm])
        A_host.sort_indices()
    elif reorder not in (0, 1):
        raise HypredrvError(
            f"ilu.reordering {reorder} not supported (0=none, 1=RCM)",
            ErrorCode.INVALID_ARG)
    if itype in (1, 11, 21, 31, 41) or fill > 0:
        import scipy.sparse.linalg as spla

        lu = spla.spilu(sp.csc_matrix(A_host),
                        drop_tol=droptol if itype % 10 == 1 else 1e-12,
                        fill_factor=max(1.0, 1.0 + fill * 2.0),
                        permc_spec="NATURAL",
                        diag_pivot_thresh=0.0)
        L = sp.csr_matrix(lu.L)
        U = sp.csr_matrix(lu.U)
    else:
        L, U = ilu0_factor(A_host)
    u_diag = U.diagonal()
    Ls = sp.csr_matrix(sp.tril(L, k=-1))
    Us = sp.csr_matrix(U)
    if perm is not None:
        # similarity-permute back to the original row numbering
        n = A_host.shape[0]
        iperm = np.empty(n, np.int64)
        iperm[perm] = np.arange(n)
        Q = sp.csr_matrix((np.ones(n), (perm, np.arange(n))), shape=(n, n))
        Ls = sp.csr_matrix(Q @ Ls @ Q.T)
        Us = sp.csr_matrix(Q @ Us @ Q.T)
        u_diag = u_diag[iperm]
        Ls.sort_indices()
        Us.sort_indices()
    u_dinv = jnp.asarray(
        np.where(u_diag != 0, 1.0 / u_diag, 1.0), dtype=dtype)
    l_dinv = jnp.ones(A_host.shape[0], dtype=dtype)
    tri_solve = bool(args.get("tri_solve", True))
    l_iters = int(args.get("lower_jac_iters", 5))
    u_iters = int(args.get("upper_jac_iters", 5))
    if tri_solve:
        l_iters = max(l_iters, 10)
        u_iters = max(u_iters, 10)
    return (
        EllMatrix.from_csr(Ls, dtype=dtype),
        EllMatrix.from_csr(Us, dtype=dtype),
        l_dinv, u_dinv,
        jnp.int32(max(1, l_iters)), jnp.int32(max(1, u_iters)),
    )


@jax.tree_util.register_pytree_node_class
class NSHState:
    """Newton-Schulz-Hotelling approximate inverse: z = M·r (one SpMV).

    The most device-friendly member of the ILU family — the apply is a single
    gather-SpMV, no triangular solves at all (ref: ilu.c:42-57 nsh-iluk/
    nsh-ilut, hypre NSH inverse with MR initial guess)."""

    def __init__(self, M):
        self.M = M

    def tree_flatten(self):
        return (self.M,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


def _nsh_drop(M: sp.csr_matrix, droptol: float, max_row_nnz: int
              ) -> sp.csr_matrix:
    """Row-relative threshold + per-row nnz cap (hypre NSH dropping)."""
    M = sp.csr_matrix(M)
    M.sum_duplicates()
    n = M.shape[0]
    counts = np.diff(M.indptr)
    rows = np.repeat(np.arange(n), counts)
    absd = np.abs(M.data)
    rowmax = np.zeros(n)
    np.maximum.at(rowmax, rows, absd)
    keep = absd >= droptol * np.maximum(rowmax[rows], 1e-300)
    # never drop the diagonal
    keep |= rows == M.indices
    if max_row_nnz and max_row_nnz > 0:
        key = np.where(keep, absd, -1.0)
        order = np.lexsort((-key, rows))
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.arange(M.nnz) - np.repeat(starts[:-1], counts)
        keep_sorted = keep[order] & (rank < max_row_nnz)
        keep = np.zeros(M.nnz, bool)
        keep[order] = keep_sorted
        keep |= rows == M.indices
    out = sp.csr_matrix((M.data[keep], M.indices[keep],
                         np.concatenate([[0], np.cumsum(
                             np.bincount(rows[keep], minlength=n))])),
                        shape=M.shape)
    out.sort_indices()
    return out


def _nsh_invert_unit_tri(T: sp.csr_matrix, droptol: float,
                         max_row_nnz: int, iters: int) -> sp.csr_matrix:
    """NSH inverse of a UNIT-diagonal triangular factor.

    T = I + N with N nilpotent, so X ← X(2I − TX) starting from X = I
    squares the error term each sweep: exact in ⌈log₂(depth)⌉ sweeps;
    dropping after each SpGEMM keeps the inverse sparse."""
    n = T.shape[0]
    I = sp.identity(n, format="csr")
    X = sp.csr_matrix(I - (T - I))    # first NSH step from X=I, closed form
    for _ in range(max(0, iters - 1)):
        TX = sp.csr_matrix(T @ X)
        X = sp.csr_matrix(2.0 * X - X @ TX)
        X = _nsh_drop(X, droptol, max_row_nnz)
    return X


def build_nsh_state(A_host: sp.csr_matrix, args, dtype) -> NSHState:
    """NSH-ILU (hypre iluType 20/21): factor ILU(k)/ILUT, then build
    sparse NSH inverses of the triangular factors and collapse the whole
    apply into ONE explicit operator  M = Ũ⁻¹ D⁻¹ L⁻¹  (ref:
    ilu.c:42-57 nsh-iluk/nsh-ilut, nsh_droptol).  The apply is a single
    SpMV — no triangular solves, exact quadratic NSH convergence on the
    nilpotent factors."""
    A = sp.csr_matrix(A_host, dtype=np.float64)
    n = A.shape[0]
    itype = int(args.get("type", 20))
    fill = int(args.get("fill_level", 0))
    droptol_f = float(args.get("droptol", 1e-2))
    nsh_drop = float(args.get("nsh_droptol", 1e-3))
    max_row_nnz = int(args.get("max_row_nnz", 0)) or 0
    iters = max(1, int(args.get("nsh_max_iter",
                                int(np.ceil(np.log2(max(2, n)))))))

    if itype == 21 or fill > 0:
        import scipy.sparse.linalg as spla

        lu = spla.spilu(sp.csc_matrix(A),
                        drop_tol=droptol_f if itype == 21 else 1e-12,
                        fill_factor=max(1.0, 1.0 + fill * 2.0),
                        permc_spec="NATURAL", diag_pivot_thresh=0.0)
        L = sp.csr_matrix(lu.L)
        U = sp.csr_matrix(lu.U)
    else:
        L, U = ilu0_factor(A)

    u_diag = U.diagonal()
    dinv = np.where(u_diag != 0, 1.0 / u_diag, 1.0)
    U_unit = sp.csr_matrix(sp.diags(dinv) @ U)   # unit upper
    Linv = _nsh_invert_unit_tri(sp.csr_matrix(L), nsh_drop,
                                max_row_nnz, iters)
    Uinv = _nsh_invert_unit_tri(U_unit, nsh_drop, max_row_nnz, iters)
    M = sp.csr_matrix(Uinv @ sp.diags(dinv) @ Linv)
    M = _nsh_drop(M, nsh_drop, max_row_nnz)
    return NSHState(EllMatrix.from_csr(M, dtype=dtype))


def build_ilu_state(A_host: sp.csr_matrix, args, dtype):
    """Factor on host → device apply state (shared with MGR components)."""
    itype = int(args.get("type", 0))
    fill = int(args.get("fill_level", 0))
    droptol = float(args.get("droptol", 1e-2))

    if itype in (20, 21):
        # nsh-iluk / nsh-ilut: Newton-Schulz-Hotelling approximate
        # inverse (ref: ilu.c:42-57) — no longer aliased to plain ILU
        return build_nsh_state(A_host, args, dtype)
    if itype in (10, 11, 40, 41):
        # gmres-iluk/gmres-ilut (+ ddpq variants): two-level Schur ILU
        st = _build_schur_state(A_host, args, dtype)
        if st is not None:
            return st
    if itype in (30, 31):
        # ras-iluk/ras-ilut: restricted additive Schwarz with local
        # (dense-equivalent) factorizations (ref: ilu.c:42-57)
        from .schwarz import build_schwarz

        return build_schwarz(A_host, overlap=1, restricted=True,
                             dtype=dtype)

    if itype in (1, 11, 21, 31, 41) or fill > 0:
        # ILUT/ILU(k>0) via SuperLU ILUTP, natural ordering
        import scipy.sparse.linalg as spla

        lu = spla.spilu(sp.csc_matrix(A_host),
                        drop_tol=droptol if itype % 10 == 1 else 1e-12,
                        fill_factor=max(1.0, 1.0 + fill * 2.0),
                        permc_spec="NATURAL",
                        diag_pivot_thresh=0.0)
        L = sp.csr_matrix(lu.L)
        U = sp.csr_matrix(lu.U)
    else:
        L, U = ilu0_factor(A_host)

    u_diag = U.diagonal()
    u_dinv = jnp.asarray(
        np.where(u_diag != 0, 1.0 / u_diag, 1.0), dtype=dtype)
    l_dinv = jnp.ones(A_host.shape[0], dtype=dtype)
    # strict lower triangle for the sweep form
    Ls = sp.csr_matrix(sp.tril(L, k=-1))
    Us = sp.csr_matrix(U)
    tri_solve = bool(args.get("tri_solve", True))
    l_iters = int(args.get("lower_jac_iters", 5))
    u_iters = int(args.get("upper_jac_iters", 5))
    if tri_solve:
        # exact sequential tri-solve has no device-friendly form; use
        # enough Jacobi sweeps to converge the triangular solves (they
        # are exact in ≤ depth(L) sweeps; cap for safety)
        l_iters = max(l_iters, 10)
        u_iters = max(u_iters, 10)
    return (
        EllMatrix.from_csr(Ls, dtype=dtype),
        EllMatrix.from_csr(Us, dtype=dtype),
        l_dinv, u_dinv,
        jnp.int32(max(1, l_iters)), jnp.int32(max(1, u_iters)),
    )


class ILUPrecon(Preconditioner):
    method = "ilu"
    apply_fn = staticmethod(_ilu_apply)

    def setup(self, system):
        A_host = system.M_host if system.M_host is not None else system.A_host
        if A_host is None:
            A_host = system.A.to_csr()
        self.state = build_ilu_state(A_host, self.args, system.dtype)
        self.is_setup = True
