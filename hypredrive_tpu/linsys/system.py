"""LinearSystem: build matrix/RHS/x0/xref/dofmap from config or API.

Reference equivalent: src/internal/linsys.c (hypredrv_LinearSystemReadMatrix
:1123, RHS modes :1779-1842, init-guess modes :376-382, filename resolution
:833-866) orchestrated by HYPREDRV_LinearSystemBuild (src/HYPREDRV.c:1932).

Extension: ``linear_system.generate`` creates deterministic in-memory
systems (7/27-pt Laplacians, elasticity, multiphysics chains) because the
reference's Zenodo datasets are external; ps3d10pt7 ≡ generate.kind
laplacian_7pt nx=10.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from ..core.errors import HypredrvError, ErrorCode
from ..core.logging import log
from ..ops import csr as csr_ops
from ..ops.device_matrix import EllMatrix
from ..io import ij as ij_io
from ..ops.vectors import norm2


def _resolve_dtype(general) -> jnp.dtype:
    name = (general.get("dtype") or "float64").lower()
    if name in ("float64", "f64", "double"):
        jax.config.update("jax_enable_x64", True)
        return jnp.float64
    return jnp.float32


def _resolve_device(general, ls):
    """exec_policy host → CPU backend, device → accelerator
    (ref: exec_policy plumbing, src/HYPREDRV.c:308-349)."""
    # host wins if either section asks for it (linear_system schema default
    # is device, so general's setting must also be consulted)
    policy = min(ls.get("exec_policy", 1), general.get("exec_policy", 1))
    if policy == 0:
        try:
            return jax.devices("cpu")[0]
        except RuntimeError:
            return None
    return None  # default device


def resolve_filename(ls_args, ls_id: int, filename: str, basename: str) -> str:
    """ref: LinearSystemDataFilenameResolve (linsys.c:833-866)."""
    def suffix():
        s = ls_args.get("set_suffix", -1)
        if isinstance(s, (list, tuple)) and len(s) > ls_id:
            return int(s[ls_id])
        init = ls_args.get("init_suffix", -1)
        return (init if init >= 0 else 0) + ls_id

    digits = int(ls_args.get("digits_suffix", 5))
    if not filename and not basename:
        return ""
    if ls_args.get("dirname"):
        return os.path.join(
            f"{ls_args.dirname}_{suffix():0{digits}d}", filename or basename)
    if filename:
        return filename
    if basename:
        return f"{basename}_{suffix():0{digits}d}"
    return ""


class LinearSystem:
    """Holds the device matrices/vectors for one solve."""

    def __init__(self, dtype=jnp.float64):
        self.dtype = dtype
        self.device = None
        self.A: Optional[EllMatrix] = None
        self.A_host: Optional[sp.csr_matrix] = None
        self.M: Optional[EllMatrix] = None        # separate precon matrix
        self.M_host: Optional[sp.csr_matrix] = None
        self.b = None
        self.x = None
        self.x0 = None
        self.xref = None
        self.dofmap: Optional[np.ndarray] = None
        self.dof_labels = {}
        self.nullspace = None
        self.near_nullspace = None   # RBMs for AMG interpolation
        self.coords = None           # vertex coordinates (AMS/ADS)
        self.G_host = None           # discrete gradient (AMS)
        self.C_host = None           # discrete curl (ADS)
        self.scaling = None  # active scaling context
        self.ls_id = 0
        self.pattern_id = None  # lsseq sparsity-pattern id (recompile key)
        self._lsseq = None

    # -- properties --------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return self.A.shape[0] if self.A is not None else 0

    @property
    def nnz(self) -> int:
        return self.A.nnz if self.A is not None else 0

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, input_args, ls_id: int, stats=None, previous=None
              ) -> "LinearSystem":
        ls = input_args.linear_system
        general = input_args.general
        self = cls(dtype=_resolve_dtype(general))
        self.ls_id = ls_id
        self.device = _resolve_device(general, ls)
        self.dof_labels = dict(ls.get("dof_labels") or {})

        # arrays are created on the target device (no post-hoc
        # device_put copies)
        import contextlib

        device_ctx = (jax.default_device(self.device)
                      if self.device is not None else contextlib.nullcontext())
        with device_ctx:
            return cls._build_inner(self, input_args, ls_id, stats, previous)

    @staticmethod
    def _build_inner(self, input_args, ls_id, stats, previous):
        ls = input_args.linear_system

        if stats:
            stats.annotate_begin("matrix")
        try:
            self._build_matrix(ls, ls_id)
        finally:
            if stats:
                stats.annotate_end("matrix")

        if stats:
            stats.annotate_begin("rhs")
        try:
            self._build_rhs(ls, ls_id)
        finally:
            if stats:
                stats.annotate_end("rhs")

        self._build_x0(ls, ls_id, previous)
        self._build_xref(ls, ls_id)

        if ls.get("dofmap_filename") or ls.get("dofmap_basename"):
            if stats:
                stats.annotate_begin("dofmap")
            try:
                path = resolve_filename(ls, ls_id, ls.dofmap_filename,
                                        ls.dofmap_basename)
                self.dofmap = ij_io.read_dofmap_auto(path)
            finally:
                if stats:
                    stats.annotate_end("dofmap")

        self.reset_initial_guess()
        return self

    def _build_matrix(self, ls, ls_id: int):
        gen = ls.get("generate")
        if ls.get("sequence_filename"):
            # lsseq container (ref: linsys.c lsseq reader path)
            from ..io.lsseq import LSSeqFile

            seq = LSSeqFile(ls.sequence_filename)
            self._lsseq = seq
            self.A_host = seq.read_matrix(ls_id)
            dof = seq.read_dofmap(ls_id)
            if dof is not None:
                self.dofmap = dof
            self.pattern_id = seq.pattern_id(ls_id)
        elif gen and gen.get("kind"):
            A_host, dofmap = _generate_matrix(gen)
            self.A_host = A_host
            if dofmap is not None:
                self.dofmap = dofmap
        else:
            path = resolve_filename(ls, ls_id, ls.matrix_filename,
                                    ls.matrix_basename)
            if not path:
                raise HypredrvError(
                    "linear_system: no matrix source (filename/basename/"
                    "generate)", ErrorCode.MISSING_KEY)
            if ls.type == 3 or path.endswith(".mtx"):  # mtx
                from .mtx import read_mtx

                self.A_host = read_mtx(path)
            else:
                self.A_host, _ = ij_io.read_matrix_auto(path)
        self.A = EllMatrix.from_csr(self.A_host, dtype=self.dtype)

        # separate preconditioner matrix (ref: SetPrecMatrix)
        pm = resolve_filename(ls, ls_id, ls.get("precmat_filename", ""),
                              ls.get("precmat_basename", ""))
        if pm:
            self.M_host, _ = ij_io.read_matrix_auto(pm)
            self.M = EllMatrix.from_csr(self.M_host, dtype=self.dtype)

    def _build_rhs(self, ls, ls_id: int):
        n = self.num_rows
        mode = ls.rhs_mode
        if getattr(self, "_lsseq", None) is not None:
            self.b = jnp.asarray(self._lsseq.read_rhs(ls_id),
                                 dtype=self.dtype)
            return
        path = resolve_filename(ls, ls_id, ls.rhs_filename, ls.rhs_basename)
        if path and mode in (0, 2):  # file given (mode default/file)
            vec = ij_io.read_vector_auto(path)
            if len(vec) != n:
                raise HypredrvError(
                    f"rhs size {len(vec)} != matrix rows {n}",
                    ErrorCode.VECTOR)
            self.b = jnp.asarray(vec, dtype=self.dtype)
            return
        if mode == 1:  # ones
            self.b = jnp.ones(n, dtype=self.dtype)
        elif mode == 3:  # random
            rng = np.random.default_rng(2023 + ls_id)
            self.b = jnp.asarray(rng.uniform(-1, 1, n), dtype=self.dtype)
        elif mode == 4:  # randsol: random xref, b = A·xref
            rng = np.random.default_rng(2023 + ls_id)
            xref = jnp.asarray(rng.uniform(-1, 1, n), dtype=self.dtype)
            self.xref = xref
            self.b = self.A.matvec(xref)
        else:  # zeros
            self.b = jnp.zeros(n, dtype=self.dtype)

    def _build_x0(self, ls, ls_id: int, previous):
        n = self.num_rows
        mode = ls.init_guess_mode
        path = resolve_filename(ls, ls_id, ls.x0_filename, "")
        if path and mode in (0, 2):
            vec = ij_io.read_vector_auto(path)
            self.x0 = jnp.asarray(vec, dtype=self.dtype)
            return
        if mode == 1:
            self.x0 = jnp.ones(n, dtype=self.dtype)
        elif mode == 3:
            rng = np.random.default_rng(777 + ls_id)
            self.x0 = jnp.asarray(rng.uniform(-1, 1, n), dtype=self.dtype)
        elif mode == 4 and previous is not None and previous.x is not None \
                and previous.x.shape[0] == n:
            # warm start from previous system's solution
            # (ref: init_guess_mode previous, linsys.c:376-382)
            self.x0 = jnp.asarray(previous.x, dtype=self.dtype)
        else:
            self.x0 = jnp.zeros(n, dtype=self.dtype)

    def _build_xref(self, ls, ls_id: int):
        path = resolve_filename(ls, ls_id, ls.get("xref_filename", ""), "")
        if path:
            self.xref = jnp.asarray(ij_io.read_vector_auto(path),
                                    dtype=self.dtype)

    @classmethod
    def from_csr(cls, input_args, indptr, indices, data, stats=None
                 ) -> "LinearSystem":
        """Library-mode CSR ingestion (ref: linsys.c:1190
        hypredrv_LinearSystemBuildMatrixFromCSR)."""
        general = input_args.general if input_args else {}
        self = cls(dtype=_resolve_dtype(general)
                   if input_args else jnp.float64)
        if stats:
            stats.annotate_begin("matrix")
        n = len(indptr) - 1
        A = sp.csr_matrix(
            (np.asarray(data, dtype=np.float64),
             np.asarray(indices), np.asarray(indptr)),
            shape=(n, n))
        A.sort_indices()
        self.A_host = A
        self.A = EllMatrix.from_csr(A, dtype=self.dtype)
        self.b = jnp.zeros(n, dtype=self.dtype)
        self.x0 = jnp.zeros(n, dtype=self.dtype)
        self.x = self.x0
        if stats:
            stats.annotate_end("matrix")
        return self

    # -- vector setters (library mode) ------------------------------------

    def set_rhs_array(self, values: np.ndarray):
        if len(values) != self.num_rows:
            raise HypredrvError("rhs size mismatch", ErrorCode.VECTOR)
        self.b = jnp.asarray(values, dtype=self.dtype)

    def set_x0_array(self, values: np.ndarray):
        if len(values) != self.num_rows:
            raise HypredrvError("x0 size mismatch", ErrorCode.VECTOR)
        self.x0 = jnp.asarray(values, dtype=self.dtype)
        self.x = self.x0

    def set_xref_array(self, values: np.ndarray):
        self.xref = jnp.asarray(values, dtype=self.dtype)

    def set_dofmap(self, dofmap: np.ndarray):
        self.dofmap = np.asarray(dofmap)

    def reset_initial_guess(self):
        """x ← x0 (ref: HYPREDRV_LinearSystemResetInitialGuess)."""
        self.x = self.x0

    def get_solution(self) -> np.ndarray:
        return np.asarray(self.x)

    # -- transforms --------------------------------------------------------

    def apply_scaling(self, scaling_args):
        if not scaling_args or not scaling_args.get("enabled"):
            return
        from .scaling import ScalingContext

        if self.scaling is None:
            self.scaling = ScalingContext.compute(self, scaling_args)
            self.scaling.apply(self)

    def postprocess_solution(self, result):
        """Undo scaling, project null-space, compute error norms
        (ref: HYPREDRV_LinearSolverApply tail, src/HYPREDRV.c:3307-3344)."""
        if self.scaling is not None:
            self.scaling.undo(self)
            self.scaling = None
        if self.nullspace is not None:
            from .nullspace import project_nullspace

            self.x = project_nullspace(self.x, self.nullspace)
        if self.xref is not None:
            err = self.x - self.xref
            e2 = float(norm2(err))
            xn = float(norm2(self.xref))
            rel = e2 / xn if xn > 0 else e2
            log(1, f"error norms vs reference solution: "
                   f"L2 {e2:.6e} (rel {rel:.6e})")
            result.error_norm = e2

    # -- diagnostics -------------------------------------------------------

    def block_residual_norms(self, x=None):
        """Per-dof-label residual norms (ref: linsys.h:214-228)."""
        if self.dofmap is None:
            return {}
        x = self.x if x is None else x
        r = np.asarray(self.b - self.A.matvec(x))
        out = {}
        for label in np.unique(self.dofmap):
            mask = self.dofmap == label
            out[int(label)] = float(np.linalg.norm(r[mask]))
        return out


def _generate_matrix(gen):
    """Extension: deterministic in-memory systems."""
    kind = gen.get("kind", "")
    nx = int(gen.get("nx", 10))
    ny = int(gen.get("ny", 0)) or None
    nz = int(gen.get("nz", 0)) or None
    if kind in ("laplacian_7pt", "laplacian", "ps3d10pt7"):
        return csr_ops.laplacian_3d_7pt(nx, ny, nz), None
    if kind == "laplacian_27pt":
        return csr_ops.laplacian_3d_27pt(nx, ny, nz), None
    if kind in ("laplacian_5pt", "laplacian_2d"):
        return csr_ops.laplacian_2d_5pt(nx, ny), None
    if kind == "elasticity":
        A, coords = csr_ops.elasticity_3d(nx, ny, nz)
        dofmap = (np.arange(A.shape[0]) % 3).astype(np.int64)
        return A, dofmap
    if kind == "multiphysics":
        ncell = int(gen.get("ncell", 100))
        ndof = int(gen.get("ndof", 3))
        seed = int(gen.get("seed", 7))
        A, dofmap = csr_ops.multiphysics_block_system(ncell, ndof, seed)
        return A, dofmap
    raise HypredrvError(f"unknown generate.kind '{kind}'",
                        ErrorCode.INVALID_VAL)
