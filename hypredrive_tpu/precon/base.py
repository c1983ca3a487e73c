"""Preconditioner protocol and dispatch.

A preconditioner is (state pytree, pure apply function): the JAX
equivalent of hypre's (handle, solve callback) pair injected into Krylov
(ref: src/internal/solver.c:268-337).  ``apply_fn`` must be a *module- or
class-level* function — its identity keys the solver jit cache, so all
instances of a method share one XLA compilation per shape.

Setup phases run on host (numpy/scipy graph algorithms) and produce
device-resident state; apply phases are pure jittable functions.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..core.errors import HypredrvError, ErrorCode


class Preconditioner:
    """Base preconditioner."""

    method = "base"
    apply_fn: Optional[Callable] = None  # (state, r) -> z ; None = identity

    def __init__(self, args, input_args=None):
        self.args = args
        self.input_args = input_args
        self.state: Any = None
        self.is_setup = False

    def setup(self, system):
        """Build device state from the system (host setup allowed)."""
        self.is_setup = True

    def operator(self):
        """(apply_fn, state) pair for composition (MGR/nested Krylov)."""
        return type(self).apply_fn, self.state


class NonePrecon(Preconditioner):
    method = "none"
    apply_fn = None

    def setup(self, system):
        self.is_setup = True


def create_precon(precon_config, input_args=None) -> Preconditioner:
    """ref: hypredrv_PreconCreate dispatch (precon.c:461-563)."""
    from .jacobi import JacobiPrecon, GaussSeidelPrecon
    from .chebyshev import ChebyshevPrecon
    from .ilu import ILUPrecon
    from .fsai import FSAIPrecon
    from .amg import AMGPrecon
    from .mgr import MGRPrecon
    from .schwarz import SchwarzPrecon
    from .ams import AMSPrecon
    from .ads import ADSPrecon

    registry = {
        "none": NonePrecon,
        "jacobi": JacobiPrecon,
        "gauss-seidel": GaussSeidelPrecon,
        "chebyshev": ChebyshevPrecon,
        "ilu": ILUPrecon,
        "fsai": FSAIPrecon,
        "amg": AMGPrecon,
        "mgr": MGRPrecon,
        "schwarz": SchwarzPrecon,
        "ams": AMSPrecon,
        "ads": ADSPrecon,
    }
    cls = registry.get(precon_config.method)
    if cls is None:
        raise HypredrvError(
            f"preconditioner '{precon_config.method}' not implemented",
            ErrorCode.INVALID_PRECON)
    return cls(precon_config.args, input_args)
