"""Composable solver components.

MGR composes sub-solvers freely: F-relaxation, global relaxation, and the
coarsest-level solver can each be none/jacobi/chebyshev/AMG/ILU/FSAI/
dense-direct/nested Krylov/nested MGR (ref: src/internal/mgr.c:68-365
wrapper registry + include/internal/krylov.h nested solvers).

A component is (kind: str, state: pytree); ``kind`` lives in pytree aux
of the enclosing structure so :func:`apply_component` dispatches
statically at trace time — the whole composition fuses into one XLA
program.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from ..core.errors import HypredrvError, ErrorCode
from ..ops.device_matrix import EllMatrix
from ..ops.vectors import HIGHEST


def apply_component(kind: str, state, r):
    """Dispatch on static kind. state layout is kind-specific."""
    if kind == "none" or state is None:
        return r
    if kind in ("jacobi", "l1-jacobi"):
        from .jacobi import _jacobi_apply

        return _jacobi_apply(state, r)
    if kind == "chebyshev":
        from .chebyshev import _cheby_apply

        return _cheby_apply(state, r)
    if kind == "amg":
        from .amg.cycle import amg_apply

        return amg_apply(state, r)
    if kind == "ilu":
        from .ilu import _ilu_apply

        return _ilu_apply(state, r)
    if kind == "fsai":
        from .fsai import _fsai_apply

        return _fsai_apply(state, r)
    if kind == "schwarz":
        from .schwarz import _schwarz_apply

        return _schwarz_apply(state, r)
    if kind == "dense":
        return jnp.dot(state, r, precision=HIGHEST)
    if kind == "krylov":
        return _krylov_apply(state, r)
    if kind == "mgr":
        from .mgr import mgr_apply

        return mgr_apply(state, r)
    raise HypredrvError(f"unknown component kind '{kind}'",
                        ErrorCode.INVALID_PRECON)


# ---------------------------------------------------------------------------
# component construction (host setup → device state)
# ---------------------------------------------------------------------------

def build_component(kind_config, A_host: sp.csr_matrix, dtype,
                    dofmap: Optional[np.ndarray] = None) -> Tuple[str, object]:
    """Build (kind, state) from a config value.

    ``kind_config`` may be a string name, an int code, or a nested map
    like ``{amg: {...}}`` / ``{krylov: {...}}`` (ref: mgr.c f_relaxation
    forms).
    """
    from ..config.fields import normalize_name
    from ..config.sections import (AMG_SCHEMA, ILU_SCHEMA, FSAI_SCHEMA,
                                   CHEBY_SCHEMA, MGR_KRYLOV_SCHEMA)

    name, sub = _normalize_kind(kind_config)

    if name in ("none", ""):
        return ("none", None)
    if name in ("single", "jacobi", "blk-jacobi"):
        return ("jacobi", _jacobi_state(A_host, dtype, l1=False))
    if name in ("l1-jacobi", "l1-hfgs", "l1-hbgs", "l1-hsgs", "h-fgs",
                "h-bgs", "ch-gs", "h-ssor", "blk-gs", "mixed-gs",
                "2stg-fgs", "2stg-bgs", "v(1,0)"):
        # sequential GS family → ℓ1-Jacobi device equivalent
        return ("jacobi", _jacobi_state(A_host, dtype, l1=True))
    if name == "chebyshev":
        errors = []
        args = CHEBY_SCHEMA.parse(sub or {}, "chebyshev", errors)
        return ("chebyshev", _cheby_state(A_host, args, dtype))
    if name == "amg":
        from .amg.hierarchy import setup_hierarchy

        errors = []
        args = AMG_SCHEMA.parse(sub or {}, "amg", errors)
        return ("amg", setup_hierarchy(A_host, args, dtype=dtype,
                                       dof_func=dofmap))
    if name == "ilu":
        from .ilu import build_ilu_state

        errors = []
        args = ILU_SCHEMA.parse(sub or {}, "ilu", errors)
        return ("ilu", build_ilu_state(A_host, args, dtype))
    if name == "fsai":
        from .fsai import build_fsai

        errors = []
        args = FSAI_SCHEMA.parse(sub or {}, "fsai", errors)
        budget = min(int(args.max_steps) * int(args.max_step_size),
                     int(args.max_nnz_row))
        return ("fsai", build_fsai(A_host, max_nnz_row=max(1, budget),
                                   threshold=float(args.threshold),
                                   dtype=dtype))
    if name == "schwarz":
        from .schwarz import build_schwarz
        from ..config.sections import SCHWARZ_SCHEMA

        errors = []
        args = SCHWARZ_SCHEMA.parse(sub or {}, "schwarz", errors)
        # ras-* variants = restricted additive Schwarz
        # (ref vocab: schwarz.c:44-70; 10/20/30/40 = ras-iluk/ilut/amg/
        # spdirect, 11/21/31/41 = additive)
        return ("schwarz", build_schwarz(
            A_host, overlap=max(0, int(args.overlap)),
            restricted=int(args.variant) in (10, 20, 30, 40),
            relax_weight=float(args.relax_weight), dtype=dtype))
    if name in ("spdirect", "ge", "ge-piv", "ge-inv", "lu_piv", "lu_inv"):
        dense = np.asarray(A_host.todense(), dtype=np.float64)
        try:
            inv = np.linalg.inv(dense)
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(dense)
        return ("dense", jnp.asarray(inv, dtype=dtype))
    if name == "krylov":
        errors = []
        args = MGR_KRYLOV_SCHEMA.parse(sub or {}, "krylov", errors)
        return ("krylov", _krylov_state(A_host, args, dtype, dofmap))
    if name == "mgr":
        from .mgr import setup_mgr
        from ..config.sections import MGR_SCHEMA

        errors = []
        args = MGR_SCHEMA.parse(sub or {}, "mgr", errors)
        return ("mgr", setup_mgr(A_host, args, dofmap, dtype))
    raise HypredrvError(f"unsupported component '{name}'",
                        ErrorCode.INVALID_PRECON)


def _normalize_kind(kind_config):
    from ..config.fields import normalize_name

    if kind_config is None:
        return "none", None
    if isinstance(kind_config, str):
        return normalize_name(kind_config), None
    if isinstance(kind_config, (int, float)):
        # raw int codes from the MGR vocab
        from ..config import vocab as V

        code = int(kind_config)
        for table in (V.MGR_FRELAX, V.MGR_GRELAX, V.MGR_COARSEST):
            if code in table.values:
                return normalize_name(table.name_of(code)), None
        return "none", None
    if isinstance(kind_config, dict):
        items = [(k, v) for k, v in kind_config.items()]
        if len(items) != 1:
            raise HypredrvError(
                f"component config must have one method key, got "
                f"{list(kind_config)}", ErrorCode.INVALID_ARG)
        return normalize_name(items[0][0]), items[0][1]
    raise HypredrvError(f"bad component config {kind_config!r}",
                        ErrorCode.INVALID_ARG)


def _jacobi_state(A_host, dtype, l1=True, sweeps=1):
    if l1:
        d = np.asarray(np.abs(A_host).sum(axis=1)).ravel()
    else:
        d = A_host.diagonal()
    d_inv = jnp.asarray(np.where(d != 0, 1.0 / d, 1.0), dtype=dtype)
    return (d_inv, jnp.int32(sweeps), EllMatrix.from_csr(A_host, dtype=dtype))


def _cheby_state(A_host, args, dtype):
    from .chebyshev import cheby_coefficients
    from .amg.hierarchy import _power_lambda_max

    diag = A_host.diagonal()
    d_inv_np = np.where(diag != 0, 1.0 / diag, 1.0)
    lam = _power_lambda_max(A_host, d_inv_np, int(args.eig_est)) * 1.1
    theta, delta, rhos = cheby_coefficients(lam, float(args.fraction),
                                            int(args.order))
    return (EllMatrix.from_csr(A_host, dtype=dtype),
            jnp.asarray(d_inv_np, dtype),
            jnp.asarray(theta, dtype), jnp.asarray(delta, dtype),
            jnp.asarray(rhos, dtype))


# ---------------------------------------------------------------------------
# nested Krylov component (ref: include/internal/krylov.h:16-44)
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class KrylovComponent:
    """Fixed-budget inner Krylov solve as a preconditioner component."""

    def __init__(self, A, pc_kind, pc_state, method, max_iter, krylov_dim,
                 rtol):
        self.A = A
        self.pc_kind = pc_kind      # static
        self.pc_state = pc_state
        self.method = method        # static
        self.max_iter = max_iter    # static
        self.krylov_dim = krylov_dim  # static
        self.rtol = rtol            # static float

    def tree_flatten(self):
        return ((self.A, self.pc_state),
                (self.pc_kind, self.method, self.max_iter, self.krylov_dim,
                 self.rtol))

    @classmethod
    def tree_unflatten(cls, aux, children):
        A, pc_state = children
        pc_kind, method, max_iter, krylov_dim, rtol = aux
        return cls(A, pc_kind, pc_state, method, max_iter, krylov_dim, rtol)


def _krylov_state(A_host, args, dtype, dofmap):
    from ..config.fields import normalize_name

    pc_cfg = args.get("preconditioner")
    if pc_cfg is not None:
        pc_kind, pc_state = build_component(pc_cfg, A_host, dtype, dofmap)
    else:
        pc_kind, pc_state = "none", None
    return KrylovComponent(
        A=EllMatrix.from_csr(A_host, dtype=dtype),
        pc_kind=pc_kind, pc_state=pc_state,
        method=normalize_name(args.get("type", "gmres")),
        max_iter=int(args.get("max_iter", 20)),
        krylov_dim=int(args.get("krylov_dim", 20)),
        rtol=float(args.get("relative_tol", 0.0)))


def _krylov_apply(state: KrylovComponent, r):
    from ..solvers.gmres import _gmres_core
    from ..solvers.fgmres import _fgmres_core
    from ..solvers.pcg import _pcg_core
    from ..solvers.bicgstab import _bicgstab_core

    mv = lambda v: state.A.matvec(v)
    pc = lambda v: apply_component(state.pc_kind, state.pc_state, v)
    x0 = jnp.zeros_like(r)
    rtol = jnp.asarray(state.rtol, r.dtype)
    atol = jnp.asarray(0.0, r.dtype)
    m = state.method
    if m == "pcg":
        x, *_ = _pcg_core(mv, pc, r, x0, rtol, atol, state.max_iter, True, 0)
    elif m == "bicgstab":
        x, *_ = _bicgstab_core(mv, pc, r, x0, rtol, atol, state.max_iter)
    elif m == "fgmres":
        x, *_ = _fgmres_core(mv, pc, r, x0, rtol, atol, state.max_iter,
                             state.krylov_dim)
    else:
        x, *_ = _gmres_core(mv, pc, r, x0, rtol, atol, state.max_iter,
                            state.krylov_dim, True)
    return x
