"""hypredrive_tpu — a JAX sparse linear-solver framework.

A from-scratch JAX/XLA rebuild of the capability surface of
hypre-space/hypredrive: YAML-configured Krylov solvers
(PCG/GMRES/FGMRES/BiCGSTAB) with AMG/MGR/ILU/FSAI/Schwarz/Chebyshev/Jacobi
preconditioners over row-partitioned distributed CSR matrices, plus the
surrounding orchestration: stats, presets, precon reuse, sequence handling,
scheduled dumps, and an HYPREDRV-style lifecycle API.

Unlike the reference (a C driver delegating numerics to hypre), this package
implements the numerics natively: setup phases (coarsening, interpolation,
RAP, factorizations) run on host in numpy/scipy; solve phases are jitted JAX
running on the accelerator (an NVIDIA GPU) with `shard_map` row sharding
for multi-device execution.

Reference parity citations use the form `ref: <file>:<line>` pointing into
the hypredrive source tree.
"""

from .version import __version__

from .core.errors import (
    ErrorCode,
    HypredrvError,
    ConfigError,
    error_code_describe,
)
from .core.stats import Stats
from .config import InputArgs, parse_input, config_from_dict
from .api import HypreDrive, solve
from .core.runtime import initialize, finalize, is_initialized

__all__ = [
    "__version__",
    "ErrorCode",
    "HypredrvError",
    "ConfigError",
    "error_code_describe",
    "Stats",
    "InputArgs",
    "parse_input",
    "config_from_dict",
    "HypreDrive",
    "solve",
    "initialize",
    "finalize",
    "is_initialized",
]
