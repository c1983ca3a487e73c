"""AMG hierarchy setup (host) → device level pytree.

Setup phase (host, numpy/scipy — latency-bound graph algorithms, the
reference's own split: setup on host semantics, solve on device):

    strength → coarsen (PMIS/HMIS) → interpolation → RAP (scipy SpGEMM)

per level until max_coarse_size / max_levels, then a dense coarse-grid
inverse (the reference coarse_type default 9 = Gaussian elimination).

Each level carries device arrays (EllMatrix A/P/R + smoother vectors) and
static metadata (smoother kind/sweeps) in pytree aux so the jitted cycle
retraces only when the *structure* changes, not the values — pairs with
lsseq pattern dedup for sequences.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from ...ops.device_matrix import EllMatrix
from .strength import strength_graph
from .coarsen import coarsen
from .interp import build_interpolation
from .air import build_restriction

# relax-type codes → native smoother kinds
# (ref vocab: amg.c AMGrlxGetValidValues).  GS-family types are real
# hybrid Gauss-Seidel here: the triangular solve is approximated with a
# fixed number of Jacobi iterations on (D+L) — the reference's own
# GPU-friendly switch (ilu.h tri_solve + lower/upper_jac_iters applied
# to smoothing), which keeps the kernel SpMV-shaped on the device.
_RELAX_KIND = {
    0: "jacobi", 7: "jacobi", 18: "l1-jacobi",
    3: "gs-fwd", 4: "gs-bwd", 5: "gs-fwd", 6: "gs-sym",
    8: "gs-sym", 10: "gs-fwd", 11: "gs-fwd", 12: "gs-fwd",
    13: "gs-fwd", 14: "gs-bwd", 89: "gs-sym",
    16: "chebyshev",
}

# Jacobi iterations approximating each triangular solve in the hybrid
# GS smoothers (z ← D⁻¹(r − L z) repeated); 2 corrections after the
# D⁻¹r seed reproduce hypre's hybrid-GS iteration counts on the
# example suite while staying pure-SpMV.
GS_TRI_ITERS = 2


@jax.tree_util.register_pytree_node_class
@dataclass
class AMGLevel:
    A: EllMatrix
    P: Optional[EllMatrix]          # prolongation (None on coarsest)
    R: Optional[EllMatrix]          # restriction (Pᵀ unless AIR)
    smooth_arrays: Tuple            # arrays for the down smoother
    smoother: str = "l1-jacobi"     # static (down/pre kind)
    pre_sweeps: int = 1             # static
    post_sweeps: int = 1            # static
    up_smoother: Optional[str] = None   # static; None → same as down
    up_arrays: Optional[Tuple] = None   # arrays for the up smoother

    def tree_flatten(self):
        return ((self.A, self.P, self.R, self.smooth_arrays,
                 self.up_arrays),
                (self.smoother, self.pre_sweeps, self.post_sweeps,
                 self.up_smoother))

    @classmethod
    def tree_unflatten(cls, aux, children):
        A, P, R, sm, up = children
        kind, pre, post, up_kind = aux
        return cls(A, P, R, sm, kind, pre, post, up_kind, up)


@jax.tree_util.register_pytree_node_class
@dataclass
class AMGState:
    levels: Tuple[AMGLevel, ...]
    coarse_inv: Optional[object]   # inverse of coarsest A (see coarse_inverse)
    cycle_type: int = 0                  # 0=V, 1=W (static)
    max_iter: int = 1                    # static
    mesh: object = None                  # static; set for multi-chip

    def tree_flatten(self):
        return ((self.levels, self.coarse_inv),
                (self.cycle_type, self.max_iter, self.mesh))

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, coarse_inv = children
        return cls(levels, coarse_inv, *aux)


def _galerkin_rap(A_l: sp.csr_matrix, P: sp.csr_matrix, R: sp.csr_matrix,
                  petrov: bool) -> sp.csr_matrix:
    """A_c = R·A·P (native Pᵀ·A·P fast path when R is just Pᵀ)."""
    if not petrov:
        try:
            from ...io.native import amg_rap

            Ac = amg_rap(sp.csr_matrix(A_l), sp.csr_matrix(P))
        except Exception:
            Ac = None
        if Ac is not None:
            return Ac
    if R is None:
        R = sp.csr_matrix(P.T)
    A_c = sp.csr_matrix(R @ A_l @ P)   # (Petrov-)Galerkin RAP
    A_c.sort_indices()
    return A_c


def _bucket_rows(n: int) -> int:
    """Shape-stability bucket for coarse-level sizes: round n (above 32)
    up to the next multiple of a power-of-two step q = max(32,
    2^(bitlen(n)-4)) — i.e. ~1/8 of n, so ≤12.5% pad for n ≥ 256 and a
    32-row floor below that.  Sequences whose per-system PMIS grids
    drift a few hundred points land on the same padded size, so one
    compiled cycle serves the whole lsseq (ref contract: lsseq pattern
    dedup exists to avoid per-system re-setup,
    /root/reference/src/internal/lsseq.c LSSeqPatternMeta)."""
    if n <= 32:
        return n
    q = max(32, 1 << (int(n).bit_length() - 4))
    return -(-n // q) * q


def _pad_level(A_c: sp.csr_matrix, P: sp.csr_matrix, R: sp.csr_matrix,
               npad: int):
    """Pad the coarse operator to ``npad`` rows with identity rows.

    Exact no-ops: R's pad rows are zero, so padded residuals are always
    0 and the pad solution entries stay 0 through every cycle; the next
    level's strength graph sees isolated points (immediately F, empty
    interpolation rows)."""
    ext = npad - A_c.shape[0]
    A_c = sp.bmat([[A_c, None],
                   [None, sp.identity(ext, format="csr",
                                      dtype=A_c.dtype)]],
                  format="csr")
    P = sp.csr_matrix(sp.hstack(
        [P, sp.csr_matrix((P.shape[0], ext), dtype=P.dtype)]))
    R = sp.csr_matrix(sp.vstack(
        [R, sp.csr_matrix((ext, R.shape[1]), dtype=R.dtype)]))
    A_c.sort_indices()
    P.sort_indices()
    R.sort_indices()
    return A_c, P, R


def _power_lambda_max(A_host: sp.csr_matrix, d_inv: np.ndarray,
                      iters: int = 10, seed: int = 0) -> float:
    """Host power iteration on D⁻¹A (setup-phase λmax estimate —
    deterministic and avoids a per-level device compile)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(A_host.shape[0])
    lam = 1.0
    for _ in range(max(1, iters)):
        w = d_inv * (A_host @ v)
        lam = np.linalg.norm(w)
        if lam == 0:
            return 1.0
        v = w / lam
    return float(lam)


def _smoother_arrays(kind: str, A_host: sp.csr_matrix, E: EllMatrix,
                     cheby_args=None, weight: float = 1.0,
                     fmask: Optional[np.ndarray] = None) -> Tuple:
    dtype = E.dtype
    if kind.startswith("air-") or kind.startswith("cf-"):
        # F/C-masked Jacobi (ref grid_relax_points schedule / CF relax
        # order): base diag scaling + a {0,1} F-point mask consumed by
        # the cycle
        base = _smoother_arrays(kind.split("-", 1)[1], A_host, E,
                                cheby_args, weight)
        if fmask is None:
            fmask = np.ones(A_host.shape[0])
        return base + (jnp.asarray(fmask, dtype),)
    if kind == "chebyshev":
        from ..chebyshev import cheby_coefficients

        order = int(cheby_args.get("order", 2)) if cheby_args else 2
        fraction = float(cheby_args.get("fraction", 0.3)) if cheby_args else 0.3
        eig_iters = int(cheby_args.get("eig_est", 10)) if cheby_args else 10
        diag = A_host.diagonal()
        d_inv_np = np.where(diag != 0, 1.0 / diag, 1.0)
        lam = _power_lambda_max(A_host, d_inv_np, eig_iters) * 1.1
        theta, delta, rhos = cheby_coefficients(lam, fraction, order)
        return (jnp.asarray(d_inv_np, dtype), jnp.asarray(theta, dtype),
                jnp.asarray(delta, dtype), jnp.asarray(rhos, dtype))
    if kind in ("gs-fwd", "gs-bwd", "gs-sym"):
        # hybrid GS: strict triangular parts as device operators + the
        # diagonal; the cycle Jacobi-iterates (D+L)z = r
        diag = A_host.diagonal()
        d = np.where(diag != 0, weight / diag, 1.0)
        mesh = getattr(E, "mesh", None)
        need_l = kind in ("gs-fwd", "gs-sym")
        need_u = kind in ("gs-bwd", "gs-sym")
        L = sp.tril(A_host, -1, format="csr") if need_l else None
        U = sp.triu(A_host, 1, format="csr") if need_u else None
        if mesh is not None:
            from ...parallel.dist_matrix import DistEllMatrix

            Lm = DistEllMatrix.from_csr(L, mesh, dtype=dtype) \
                if need_l else None
            Um = DistEllMatrix.from_csr(U, mesh, dtype=dtype) \
                if need_u else None
        else:
            Lm = EllMatrix.from_csr(L, dtype=dtype) if need_l else None
            Um = EllMatrix.from_csr(U, dtype=dtype) if need_u else None
        return (jnp.asarray(d, dtype), Lm, Um)
    if kind == "jacobi":
        diag = A_host.diagonal()
        d = np.where(diag != 0, weight / diag, 1.0)
        return (jnp.asarray(d, dtype),)
    # l1-jacobi: D = Σ_j |a_ij|
    l1 = np.asarray(np.abs(A_host).sum(axis=1)).ravel()
    d = np.where(l1 != 0, weight / l1, 1.0)
    return (jnp.asarray(d, dtype),)


def _pad_smoother_arrays(arrs: Tuple, n_pad: int, mesh) -> Tuple:
    """Pad per-row smoother vectors with 1.0 (identity pad rows) and shard
    them over the mesh rows axis."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ...parallel.mesh import ROWS_AXIS

    out = []
    for a in arrs:
        if a is None or hasattr(a, "matvec"):
            # matrix-valued smoother operands (hybrid-GS L/U) are
            # already sharded by their own from_csr
            out.append(a)
            continue
        a_np = np.asarray(a)
        if a_np.ndim == 1 and a_np.shape[0] != n_pad and a_np.shape[0] > 4:
            padded = np.ones(n_pad, dtype=a_np.dtype)
            padded[:a_np.shape[0]] = a_np
            out.append(jax.device_put(
                jnp.asarray(padded), NamedSharding(mesh, P(ROWS_AXIS))))
        else:
            out.append(jnp.asarray(a_np))
    return tuple(out)


def _aggressive_interpolation(A_l, S, cf1, itp, lvl, ctype, theta, sabs,
                              func_l, trunc_factor, max_nnz_row):
    """Two-stage (aggressive) coarsening of one level: PMIS → P₁ →
    Galerkin A₁ → PMIS → P₂; returns (P₁·P₂, combined cf marks).

    This is the matrix-matrix formulation of hypre's 2-stage aggressive
    prolongations (ref: amg.c:330-347; agg prolongation vocab
    2_stage_extended+i etc.) — the coarse grid of the fused level is the
    distance-2 C-set."""
    p_type = int(itp.prolongation_type)
    P1 = build_interpolation(A_l, S, cf1, prolongation_type=p_type,
                             trunc_factor=trunc_factor,
                             max_nnz_row=max_nnz_row)
    C1 = np.flatnonzero(cf1 > 0)
    A1 = _galerkin_rap(A_l, P1, None, petrov=False)
    func1 = func_l[C1] if func_l is not None else None
    S1 = strength_graph(A1, theta=theta, sabs=sabs, dof_func=func1)
    if S1.nnz == 0:
        return P1, cf1
    cf2 = coarsen(S1, ctype=ctype, seed=1000 + lvl)
    if (cf2 > 0).sum() in (0, len(C1)):
        return P1, cf1
    P2 = build_interpolation(A1, S1, cf2, prolongation_type=p_type,
                             trunc_factor=trunc_factor,
                             max_nnz_row=max_nnz_row)
    P = sp.csr_matrix(P1 @ P2)
    P.sort_indices()
    cf = cf1.copy()
    cf[C1[cf2 < 0]] = -1
    return P, cf


def setup_hierarchy(A_host: sp.csr_matrix, amg_args, dtype=jnp.float64,
                    dof_func: Optional[np.ndarray] = None,
                    interp_vectors: Optional[np.ndarray] = None,
                    mesh=None, fine_matrix: Optional[EllMatrix] = None
                    ) -> AMGState:
    """Build the multigrid hierarchy from the AMG config Args
    (schema: config/sections.py AMG_SCHEMA; ref arg structs amg.h:23-123).

    With ``mesh`` given, every level's operators become row-sharded
    :class:`~hypredrive_tpu.parallel.dist_matrix.DistEllMatrix` and the
    smoother vectors are padded+sharded accordingly — the cycle then runs
    multi-chip with ppermute halo exchanges.

    ``A_host`` may also be a LIST of per-shard row blocks (global
    columns, ParCSR decomposition).  With a mesh and a config inside
    ``parallel.dist_setup.supports_dist_setup``, the entire setup then
    runs distributed — per-shard strength/PMIS/interpolation/RAP with
    one-ring halo exchanges, never materializing the global matrix
    (ref: hypre ParCSR BoomerAMGSetup decomposition, SURVEY §2.9).
    Configs outside that subset assemble globally with a warning.

    Single-device levels are built directly on the ambient default
    device (the API sets it to the system's device)."""
    if isinstance(A_host, (list, tuple)):
        from ...parallel.dist_setup import (setup_hierarchy_dist,
                                            supports_dist_setup)

        if mesh is None:
            raise ValueError("per-shard matrix parts require a mesh")
        if supports_dist_setup(amg_args) and interp_vectors is None:
            return setup_hierarchy_dist(A_host, amg_args, mesh,
                                        dtype=dtype, dof_func=dof_func)
        from ...core.logging import logger

        logger.warn("AMG config outside the distributed-setup subset; "
                    "assembling the global matrix for host-global setup",
                    obj="amg-dist")
        A_host = sp.csr_matrix(sp.vstack(A_host))
    elif mesh is not None:
        from ...parallel.dist_setup import (setup_hierarchy_dist,
                                            split_rows,
                                            supports_dist_setup)

        if supports_dist_setup(amg_args) and interp_vectors is None:
            # run the distributed setup even from a host-global matrix:
            # one code path for the mesh hierarchy (split is the I/O
            # layer's job in a true multi-host run)
            return setup_hierarchy_dist(
                split_rows(sp.csr_matrix(A_host), int(mesh.devices.size)),
                amg_args, mesh, dtype=dtype, dof_func=dof_func)
    return _setup_hierarchy_impl(A_host, amg_args, dtype, dof_func,
                                 interp_vectors, mesh,
                                 fine_matrix=fine_matrix)


def coarse_inverse(A_c, dtype, mesh=None, n_pad: Optional[int] = None):
    """Exact inverse of the coarsest operator (padded to ``n_pad`` rows
    with identity on a mesh).

    A dense matrix as a rule.  A diagonal operator — a level left with no
    strong connections, such as the identity-embedded F block of an MGR
    F-relaxation — keeps its inverse as a sparse diagonal operator, so a
    large level that does not coarsen is never densified."""
    A_c = sp.csr_matrix(A_c)
    n = A_c.shape[0]
    if mesh is not None and n_pad is None:
        n_pad = -(-n // int(mesh.devices.size)) * int(mesh.devices.size)
    d = A_c.diagonal()
    if A_c.count_nonzero() == np.count_nonzero(d):
        inv = sp.diags(np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0),
                                0.0)).tocsr()
        if mesh is None:
            return EllMatrix.from_csr(inv, dtype=dtype)
        from ...parallel.dist_matrix import DistEllMatrix

        inv.resize((n_pad, n_pad))
        return DistEllMatrix.from_csr(
            inv + sp.diags(np.r_[np.zeros(n), np.ones(n_pad - n)]),
            mesh, dtype=dtype)
    if mesh is not None:
        dense = np.eye(n_pad)
        dense[:n, :n] = A_c.todense()
    else:
        dense = np.asarray(A_c.todense(), dtype=np.float64)
    try:
        inv = np.linalg.inv(dense)
    except np.linalg.LinAlgError:
        inv = np.linalg.pinv(dense)
    return jnp.asarray(inv, dtype=dtype)


def _setup_hierarchy_impl(A_host, amg_args, dtype, dof_func,
                          interp_vectors, mesh,
                          fine_matrix=None) -> AMGState:
    # reuse an already-built device matrix for the finest level (the
    # solver wrapper and level 0 share the same operator)
    if fine_matrix is not None and (
            not isinstance(fine_matrix, EllMatrix)
            or fine_matrix.dtype != jnp.dtype(dtype)):
        fine_matrix = None
    csn = amg_args.coarsening
    itp = amg_args.interpolation
    rlx = amg_args.relaxation

    theta = float(csn.strong_th)
    sabs = bool(csn.sabs)
    seed_base = int(getattr(csn, "rand_seed", 0))
    max_levels = int(csn.max_levels)
    max_coarse = max(1, int(csn.max_coarse_size))
    min_coarse = int(csn.min_coarse_size)
    num_functions = int(csn.num_functions)

    if int(rlx.type) >= 0:
        # relaxation.type sets every direction at once (hypre
        # BoomerAMGSetRelaxType semantics; overridden by down/up below
        # only when those were not given — the schema default is -1)
        down_kind = up_kind = _RELAX_KIND.get(int(rlx.type), "l1-jacobi")
    else:
        down_kind = _RELAX_KIND.get(int(rlx.down_type), "l1-jacobi")
        up_kind = _RELAX_KIND.get(int(rlx.up_type), "l1-jacobi")
    kind = down_kind
    num_sweeps = max(1, int(rlx.num_sweeps))
    pre = int(rlx.down_sweeps) if int(rlx.down_sweeps) >= 0 else num_sweeps
    post = int(rlx.up_sweeps) if int(rlx.up_sweeps) >= 0 else num_sweeps
    weight = float(rlx.weight)

    # complex smoother on the finest levels (ref: amg.c:441-457
    # smoother.{type,num_levels}): FSAI is the device-parallel choice; the
    # other host-sequential types (ilu/pilut/euclid) map to it
    smoother_levels = int(amg_args.smoother.num_levels)
    smoother_type = int(amg_args.smoother.type)
    smoother_sweeps = max(1, int(amg_args.smoother.num_sweeps))

    # AIR: non-Galerkin restriction + the F/C relax schedule of
    # relaxation.points=air (ref: amg.c:870-877,986-1015 — down cycle
    # relaxes all points, up cycle relaxes F with a trailing C sweep)
    restriction_type = int(itp.restriction_type)
    restrict_th = float(itp.restrict_strong_th)
    restrict_filter = float(itp.restrict_filter_th)
    air_points = int(rlx.points) == 1
    if air_points:
        # F/C-masked relaxation schedule (mask only matters on the up
        # sweep; the down sweep relaxes all points)
        if kind not in ("chebyshev",):
            kind = "air-" + ("jacobi" if kind == "jacobi" else "l1-jacobi")
        if up_kind not in ("chebyshev",):
            up_kind = "air-" + ("jacobi" if up_kind == "jacobi"
                                else "l1-jacobi")
    elif int(rlx.order) == 1:
        # relaxation.order = 1 → CF relaxation (hypre
        # BoomerAMGSetRelaxOrder, ref amg.c:895): point-wise smoothers
        # run C-then-F on the down sweep and F-then-C on the up sweep.
        # Chebyshev/GS keep their own schedule (hypre likewise applies
        # relax order only to the pointwise relaxations).
        if kind in ("jacobi", "l1-jacobi"):
            kind = "cf-" + kind
        if up_kind in ("jacobi", "l1-jacobi"):
            up_kind = "cf-" + up_kind

    levels: List[AMGLevel] = []
    A_l = sp.csr_matrix(A_host)
    func_l = dof_func if num_functions > 1 else None

    # worker thread for per-level device prep (jax.default_device is
    # thread-local, so capture the ambient staging device and re-enter
    # it inside the worker)
    executor = None
    ambient_dev = jax.config.jax_default_device
    if mesh is None:
        from concurrent.futures import ThreadPoolExecutor

        executor = ThreadPoolExecutor(max_workers=1)

    # interpolation-vector (RBM) augmentation — active when the variant
    # is enabled and vectors were provided (ref: amg.c:602 AMGSetRBMs)
    V_l = None
    if interp_vectors is not None and int(amg_args.interp_vec_variant) > 0:
        V_l = np.atleast_2d(np.asarray(interp_vectors, dtype=np.float64))
        if V_l.shape[0] != A_l.shape[0]:
            V_l = V_l.T

    agg_levels = int(amg_args.aggressive.num_levels)
    agg_trunc = float(amg_args.aggressive.trunc_factor)
    agg_pmax = int(amg_args.aggressive.max_nnz_row)

    n_real = A_l.shape[0]   # unpadded level size (bucket pads are
                            # identity rows and must not count toward
                            # the min/max_coarse termination checks)
    for lvl in range(max_levels - 1):
        if n_real <= max_coarse or (min_coarse and n_real <= min_coarse):
            break
        n = A_l.shape[0]
        S = strength_graph(A_l, theta=theta, sabs=sabs, dof_func=func_l)
        if S.nnz == 0:
            break
        cf = coarsen(S, ctype=int(csn.type), seed=lvl + seed_base)
        nC = int((cf > 0).sum())
        if nC == 0 or nC >= n:
            break
        if lvl < agg_levels and restriction_type == 0 and nC > max_coarse:
            # aggressive coarsening: a second PMIS pass fused into this
            # level via two-stage interpolation P = P₁·P₂
            # (ref: amg.c:330-347 aggressive.{num_levels,prolongation_type})
            P, cf = _aggressive_interpolation(
                A_l, S, cf, itp, lvl + seed_base,
                ctype=int(csn.type), theta=theta, sabs=sabs,
                func_l=func_l,
                trunc_factor=agg_trunc if agg_trunc > 0
                else float(itp.trunc_factor),
                max_nnz_row=agg_pmax if agg_pmax > 0
                else int(itp.max_nnz_row))
            nC = int((cf > 0).sum())
        else:
            P = build_interpolation(
                A_l, S, cf,
                prolongation_type=int(itp.prolongation_type),
                trunc_factor=float(itp.trunc_factor),
                max_nnz_row=int(itp.max_nnz_row))
        if V_l is not None:
            from .rbm import augment_interpolation

            # GM2 pattern growth: the reference pins QMax=4 when RBMs
            # are active (ref: amg.c:1025 SetInterpVecQMax(4))
            qmax = int(getattr(amg_args, "interp_vec_qmax", 0))
            if qmax <= 0 and int(amg_args.interp_vec_variant) == 2:
                qmax = 4
            P, V_c = augment_interpolation(P, cf, V_l, A=A_l, qmax=qmax)
        R_air = build_restriction(A_l, cf, restriction_type,
                                  restrict_th, restrict_filter)
        R = R_air if R_air is not None else sp.csr_matrix(P.T)
        A_c = _galerkin_rap(A_l, P, R, R_air is not None)
        fmask = (cf < 0).astype(np.float64) \
            if (kind.startswith(("air-", "cf-"))
                or up_kind.startswith(("air-", "cf-"))) \
            else None
        # shape-stability bucket (both paths — under a mesh the padded
        # size additionally keeps DistEllMatrix's shard-uniform padding
        # on the same bucket across a sequence)
        nC_real = A_c.shape[0]
        npad_c = _bucket_rows(nC_real)
        if npad_c > nC_real:
            A_c, P, R = _pad_level(A_c, P, R, npad_c)

        if mesh is not None:
            from ...parallel.dist_matrix import DistEllMatrix

            E = DistEllMatrix.from_csr(A_l, mesh, dtype=dtype)
            sm = _pad_smoother_arrays(
                _smoother_arrays(kind, A_l, E, rlx.chebyshev, weight, fmask),
                E.shape[0], mesh)
            up_k = up_sm = None
            if up_kind != kind:
                up_k = up_kind
                up_sm = _pad_smoother_arrays(
                    _smoother_arrays(up_kind, A_l, E, rlx.chebyshev,
                                     weight, fmask), E.shape[0], mesh)
            levels.append(AMGLevel(
                A=E,
                P=DistEllMatrix.from_csr(P, mesh, dtype=dtype),
                R=DistEllMatrix.from_csr(R, mesh, dtype=dtype),
                smooth_arrays=sm, smoother=kind,
                pre_sweeps=pre, post_sweeps=post,
                up_smoother=up_k, up_arrays=up_sm,
            ))
        else:
            # device prep (layout split, smoother vectors) runs on a
            # worker thread overlapped with the NEXT level's graph work
            # — the native setup kernels release the GIL
            def make_level(A_l=A_l, P=P, R=R, kind=kind, up_kind=up_kind,
                           fmask=fmask, lvl=lvl):
                if ambient_dev is not None:
                    cmgr = jax.default_device(ambient_dev)
                else:
                    import contextlib

                    cmgr = contextlib.nullcontext()
                with cmgr:
                    E = (fine_matrix if lvl == 0 and fine_matrix is not None
                         else EllMatrix.from_csr(A_l, dtype=dtype))
                    lvl_kind = kind
                    sm = None
                    if lvl < smoother_levels \
                            and smoother_type in (4, 5, 7, 8, 9):
                        # FSAI complex smoother on this level (host-
                        # sequential types map to the FSAI equivalent,
                        # the reference's own device fallback philosophy)
                        from ..fsai import build_fsai

                        fs = amg_args.smoother.fsai
                        if int(fs.algo_type) in (1, 3):
                            from ..fsai import build_fsai_adaptive

                            G, GT = build_fsai_adaptive(
                                A_l, max_steps=int(fs.max_steps),
                                max_step_size=int(fs.max_step_size),
                                kap_tolerance=float(fs.kap_tolerance),
                                dtype=dtype)
                        else:
                            G, GT = build_fsai(
                                A_l,
                                max_nnz_row=(int(fs.max_steps)
                                             * int(fs.max_step_size)),
                                threshold=float(fs.kap_tolerance),
                                dtype=dtype)
                        # smoother damping ω = 1/λmax(GᵀG·A), estimated
                        # with eig_max_iters power steps (hypre's FSAI
                        # SetEigMaxIters smoothing scale; ref fsai.c
                        # field list eig_max_iters)
                        omega = 1.0
                        eig_iters = int(fs.eig_max_iters)
                        if eig_iters > 0:
                            Gh = G.to_csr()
                            rng = np.random.default_rng(0)
                            v = rng.standard_normal(A_l.shape[0])
                            lam = 1.0
                            for _ in range(eig_iters):
                                w = Gh.T @ (Gh @ (A_l @ v))
                                lam = float(np.linalg.norm(w))
                                if lam == 0:
                                    lam = 1.0
                                    break
                                v = w / lam
                            omega = 1.0 / lam
                        lvl_kind = "fsai"
                        sm = (G, GT, jnp.asarray(omega, dtype))
                    if sm is None:
                        sm = _smoother_arrays(kind, A_l, E, rlx.chebyshev,
                                              weight, fmask)
                    up_k = up_sm = None
                    if up_kind != kind and lvl_kind != "fsai":
                        # independent up (post) smoother — the reference
                        # configures down/up relax types separately
                        # (ref: amg.c:355-400 down_type/up_type)
                        up_k = up_kind
                        up_sm = _smoother_arrays(up_kind, A_l, E,
                                                 rlx.chebyshev, weight,
                                                 fmask)
                    return AMGLevel(
                        A=E,
                        P=EllMatrix.from_csr(P, dtype=dtype),
                        R=EllMatrix.from_csr(R, dtype=dtype),
                        smooth_arrays=sm,
                        smoother=lvl_kind,
                        pre_sweeps=(pre if lvl_kind != "fsai"
                                    else smoother_sweeps),
                        post_sweeps=(post if lvl_kind != "fsai"
                                     else smoother_sweeps),
                        up_smoother=up_k, up_arrays=up_sm,
                    )
            levels.append(executor.submit(make_level)
                          if executor is not None else make_level())
        if func_l is not None:
            func_l = func_l[cf > 0]
            if npad_c > nC_real:
                func_l = np.concatenate(
                    [func_l, np.zeros(npad_c - nC_real, func_l.dtype)])
        if V_l is not None:
            V_l = V_c
            if npad_c > nC_real:
                V_l = np.vstack([V_l, np.zeros((npad_c - nC_real,
                                                V_l.shape[1]))])
        A_l = A_c
        n_real = nC_real
        if nC_real <= max_coarse:
            break

    # resolve the overlapped level builds
    if executor is not None:
        levels = [lv.result() if hasattr(lv, "result") else lv
                  for lv in levels]
        executor.shutdown(wait=True)

    # coarsest level: exact inverse (ref coarse_type 9 = GE)
    if mesh is not None:
        from ...parallel.dist_matrix import DistEllMatrix

        E_c = DistEllMatrix.from_csr(A_l, mesh, dtype=dtype)
        sm_c = _pad_smoother_arrays(
            _smoother_arrays(kind, A_l, E_c, rlx.chebyshev, weight),
            E_c.shape[0], mesh)
    else:
        E_c = EllMatrix.from_csr(A_l, dtype=dtype)
        sm_c = _smoother_arrays(kind, A_l, E_c, rlx.chebyshev, weight)
    levels.append(AMGLevel(
        A=E_c, P=None, R=None,
        smooth_arrays=sm_c,
        smoother=kind, pre_sweeps=pre, post_sweeps=post,
    ))

    return AMGState(
        levels=tuple(levels),
        coarse_inv=coarse_inverse(A_l, dtype, mesh),
        cycle_type=0 if int(getattr(amg_args, "cycle_type", 1)) <= 1 else 1,
        max_iter=max(1, int(amg_args.max_iter)),
        mesh=mesh,
    )


def hierarchy_summary(state: AMGState) -> str:
    lines = ["AMG hierarchy:"]
    for i, lv in enumerate(state.levels):
        n = lv.A.shape[0]
        lines.append(
            f"  level {i}: n={n} nnz={lv.A.nnz} smoother={lv.smoother} "
            f"(pre={lv.pre_sweeps}, post={lv.post_sweeps})")
    return "\n".join(lines)
