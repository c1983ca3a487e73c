"""Solver protocol, result type, jit-cache, and dispatch.

Mirrors the reference solver layer semantics (ref: src/internal/solver.c):

* ``SolverApply`` computes *untimed* true residual norms before and after
  the timed solve (ref: solver.c:627-699); the stats table's "initial" and
  "relative" residual norms come from there.
* the preconditioner is injected as a pair (pure apply function, state
  pytree) — the JAX equivalent of hypre's precond callback pointers
  (ref: solver.c:268-337).
* solver cores are cached per (matvec function, precon function, static
  params) so repeated create/destroy cycles (the CLI does one per
  repetition, ref: main.c:205-222) hit the XLA compilation cache.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, Callable, Optional, Tuple

import numpy as np
import jax

from ..ops.vectors import norm2


@dataclass
class SolveResult:
    """Outcome of one Krylov solve."""

    x: Any = None
    iters: int = 0
    initial_res_norm: float = 0.0
    final_res_norm: float = 0.0
    rel_res_norm: float = 0.0
    converged: bool = True
    res_history: Optional[np.ndarray] = None
    solve_time: float = 0.0
    # per-iteration per-dof-block error norms ||x_k − xref|| — filled by
    # GMRES when a reference solution + dofmap tags are present (ref:
    # hypredrv_GMRESSetRefSolution / hypre tagged inner product,
    # src/internal/gmres.c:80-103, src/HYPREDRV.c:693-726)
    error_histories: Optional[np.ndarray] = None


def identity_precon(state, r):
    return r


class Solver:
    """Base Krylov solver (one subclass per method)."""

    method = "base"

    def __init__(self, args, input_args=None):
        self.args = args
        self.input_args = input_args
        self._matvec = None
        self._precon_fn = identity_precon
        self._precon_state = None

    # -- lifecycle ---------------------------------------------------------

    def setup(self, system, precon=None):
        """Bind the operator and preconditioner
        (ref: hypredrv_SolverSetupWithReuse, solver.c:457)."""
        self._system = system
        self._matvec = type(system.A).matvec
        if precon is not None and precon.apply_fn is not None:
            self._precon_fn = precon.apply_fn
            self._precon_state = precon.state
        else:
            self._precon_fn = identity_precon
            self._precon_state = None

    def apply(self, system, precon=None, stats=None) -> SolveResult:
        """Run the solve with untimed true-residual bookkeeping
        (ref: hypredrv_SolverApply, solver.c:627-699)."""
        A, b, x0 = system.A, system.b, system.x
        # untimed true initial residual
        r0 = b - A.matvec(x0)
        initial_res_norm = float(norm2(r0))
        b_norm = float(norm2(b))

        if stats is not None:
            stats.annotate_begin("solve")
        t0 = time.perf_counter()
        out = self.solve_core(A, self._precon_state, b, x0)
        x, iters, final_norm, converged, history = out[:5]
        err_hist = out[5] if len(out) > 5 else None
        x.block_until_ready()
        solve_time = time.perf_counter() - t0
        if stats is not None:
            stats.annotate_end("solve")

        # untimed true relative residual
        r = b - A.matvec(x)
        true_norm = float(norm2(r))
        denom = b_norm if b_norm > 0 else (initial_res_norm or 1.0)
        rel = true_norm / denom if denom > 0 else true_norm

        result = SolveResult(
            x=x,
            iters=int(iters),
            initial_res_norm=initial_res_norm,
            final_res_norm=true_norm,
            rel_res_norm=rel,
            converged=bool(converged),
            res_history=np.asarray(history),
            solve_time=solve_time,
            error_histories=(np.asarray(err_hist)
                             if err_hist is not None else None),
        )
        system.x = x
        if stats is not None:
            stats.record_solve(result.iters, initial_res_norm, rel,
                               result.converged)
        return result

    # -- per-method core ---------------------------------------------------

    def solve_core(self, A, pstate, b, x0):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# jit cache: one compiled core per (core fn, matvec fn, precon fn, statics)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=256)
def _jitted(core_fn, matvec_fn, precon_fn, statics: Tuple):
    def wrapped(A, pstate, b, x0, *dynamics):
        mv = lambda x: matvec_fn(A, x)
        pc = lambda r: precon_fn(pstate, r)
        return core_fn(mv, pc, b, x0, *dynamics, *statics)

    return jax.jit(wrapped)


def jitted_core(core_fn, matvec_fn, precon_fn, statics: Tuple):
    """Fetch/compile the cached jitted solver core."""
    return _jitted(core_fn, matvec_fn, precon_fn, tuple(statics))


def create_solver(solver_config, input_args=None) -> Solver:
    """ref: solver vtable dispatch (solver.c:104-125, :417)."""
    from .pcg import PCGSolver
    from .gmres import GMRESSolver
    from .fgmres import FGMRESSolver
    from .bicgstab import BiCGSTABSolver

    registry = {
        "pcg": PCGSolver,
        "gmres": GMRESSolver,
        "fgmres": FGMRESSolver,
        "bicgstab": BiCGSTABSolver,
    }
    cls = registry.get(solver_config.method)
    if cls is None:
        from ..core.errors import HypredrvError, ErrorCode

        raise HypredrvError(f"unknown solver {solver_config.method}",
                            ErrorCode.INVALID_SOLVER)
    return cls(solver_config.args, input_args)
