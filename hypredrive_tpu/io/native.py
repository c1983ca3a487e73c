"""ctypes bindings for the native C++ I/O library (native/src/ij_io.cpp).

The shared library is built on demand with the in-tree Makefile (g++ is
part of the toolchain); if the build or load fails the callers fall back
to the pure-numpy readers, so the native layer is an accelerator, never
a requirement.  Ref counterparts: src/internal/matrix.c:142,
src/internal/vector.c:92 (the reference's I/O is C for the same reason).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_SO = os.path.join(_NATIVE_DIR, "libhypredrv_io.so")

_lock = threading.Lock()
_lib = None
_tried = False


class _IJBuf(ctypes.Structure):
    _fields_ = [
        ("ilower", ctypes.c_int64),
        ("iupper", ctypes.c_int64),
        ("jlower", ctypes.c_int64),
        ("jupper", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("n", ctypes.c_int64),
        ("rows", ctypes.POINTER(ctypes.c_int64)),
        ("cols", ctypes.POINTER(ctypes.c_int64)),
        ("vals", ctypes.POINTER(ctypes.c_double)),
        ("err", ctypes.c_char * 256),
    ]


def _build() -> bool:
    src = os.path.join(_NATIVE_DIR, "src", "ij_io.cpp")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "-s",
                        "libhypredrv_io.so"],
                       check=True, capture_output=True, timeout=120)
        return os.path.exists(_SO)
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        srcs = [os.path.join(_NATIVE_DIR, "src", f)
                for f in ("ij_io.cpp", "amg_setup.cpp")]
        src_mtime = max((os.path.getmtime(s) for s in srcs
                         if os.path.exists(s)), default=0)
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < src_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        for name in ("hdrv_read_ij_matrix_ascii", "hdrv_read_ij_vector_ascii"):
            fn = getattr(lib, name)
            fn.restype = ctypes.POINTER(_IJBuf)
            fn.argtypes = [ctypes.c_char_p]
        lib.hdrv_ij_free.restype = None
        lib.hdrv_ij_free.argtypes = [ctypes.POINTER(_IJBuf)]
        for name in ("hdrv_write_ij_matrix_ascii",):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p] + [ctypes.c_int64] * 4 + [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        lib.hdrv_write_ij_vector_ascii.restype = ctypes.c_int
        lib.hdrv_write_ij_vector_ascii.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        # AMG setup kernels (native/src/amg_setup.cpp)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.hdrv_strength.restype = ctypes.c_int64
        lib.hdrv_strength.argtypes = [
            ctypes.c_int64, i64p, i64p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, i32p, i64p, i64p]
        lib.hdrv_pmis.restype = None
        lib.hdrv_pmis.argtypes = [
            ctypes.c_int64, i64p, i64p, ctypes.c_int64, f64p, i8p]
        lib.hdrv_interp_begin.restype = ctypes.c_void_p
        lib.hdrv_interp_begin.argtypes = [
            ctypes.c_int64, i64p, i64p, ctypes.c_void_p, ctypes.c_int,
            i64p, i64p, i8p, ctypes.c_int, ctypes.c_double, ctypes.c_int64]
        lib.hdrv_interp_nnz.restype = ctypes.c_int64
        lib.hdrv_interp_nnz.argtypes = [ctypes.c_void_p]
        lib.hdrv_interp_ncols.restype = ctypes.c_int64
        lib.hdrv_interp_ncols.argtypes = [ctypes.c_void_p]
        lib.hdrv_interp_fill.restype = None
        lib.hdrv_interp_fill.argtypes = [ctypes.c_void_p, i64p, i64p, f64p]
        lib.hdrv_interp_end.restype = None
        lib.hdrv_interp_end.argtypes = [ctypes.c_void_p]
        lib.hdrv_rap_begin.restype = ctypes.c_void_p
        lib.hdrv_rap_begin.argtypes = [
            ctypes.c_int64, i64p, i64p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int64, i64p, i64p, f64p]
        lib.hdrv_rap_nnz.restype = ctypes.c_int64
        lib.hdrv_rap_nnz.argtypes = [ctypes.c_void_p]
        lib.hdrv_rap_fill.restype = None
        lib.hdrv_rap_fill.argtypes = [ctypes.c_void_p, i64p, i64p, f64p]
        lib.hdrv_rap_end.restype = None
        lib.hdrv_rap_end.argtypes = [ctypes.c_void_p]
        lib.hdrv_dia_split_begin.restype = ctypes.c_void_p
        lib.hdrv_dia_split_begin.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
        lib.hdrv_dia_split_sizes.restype = None
        lib.hdrv_dia_split_sizes.argtypes = [ctypes.c_void_p, i64p, i64p]
        lib.hdrv_dia_split_fill.restype = None
        lib.hdrv_dia_split_fill.argtypes = [
            ctypes.c_void_p, i64p, f64p, i64p, i64p, ctypes.c_void_p]
        lib.hdrv_lz4_compress.restype = ctypes.c_int64
        lib.hdrv_lz4_compress.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int64]
        lib.hdrv_lz4_decompress.restype = ctypes.c_int64
        lib.hdrv_lz4_decompress.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int64]
        _lib = lib
        return _lib


def read_matrix_ascii(path: str
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                          int, int, int, int]]:
    """(rows, cols, vals, ilower, iupper, jlower, jupper) or None.

    Raises ValueError on parse errors (malformed/non-finite entries) so
    callers distinguish 'native unavailable' from 'bad file'."""
    lib = get_lib()
    if lib is None:
        return None
    bufp = lib.hdrv_read_ij_matrix_ascii(path.encode())
    if not bufp:
        return None
    try:
        b = bufp.contents
        err = bytes(b.err).split(b"\0", 1)[0]
        if err:
            raise ValueError(err.decode())
        nnz = b.nnz
        if nnz:
            rows = np.ctypeslib.as_array(b.rows, (nnz,)).copy()
            cols = np.ctypeslib.as_array(b.cols, (nnz,)).copy()
            vals = np.ctypeslib.as_array(b.vals, (nnz,)).copy()
        else:
            rows = cols = np.empty(0, np.int64)
            vals = np.empty(0, np.float64)
        return rows, cols, vals, b.ilower, b.iupper, b.jlower, b.jupper
    finally:
        lib.hdrv_ij_free(bufp)


def read_vector_ascii(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """(values, ilower) or None; raises ValueError on parse errors."""
    lib = get_lib()
    if lib is None:
        return None
    bufp = lib.hdrv_read_ij_vector_ascii(path.encode())
    if not bufp:
        return None
    try:
        b = bufp.contents
        err = bytes(b.err).split(b"\0", 1)[0]
        if err:
            raise ValueError(err.decode())
        vals = (np.ctypeslib.as_array(b.vals, (b.n,)).copy()
                if b.n else np.empty(0, np.float64))
        return vals, b.ilower
    finally:
        lib.hdrv_ij_free(bufp)


def write_matrix_ascii(path: str, rows, cols, vals,
                       ilower, iupper, jlower, jupper) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    rc = lib.hdrv_write_ij_matrix_ascii(
        path.encode(), ilower, iupper, jlower, jupper,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(vals))
    return rc == 0


def write_vector_ascii(path: str, vals, ilower: int = 0) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    vals = np.ascontiguousarray(vals, np.float64)
    rc = lib.hdrv_write_ij_vector_ascii(
        path.encode(), ilower,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(vals))
    return rc == 0


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _csr_arrays(A):
    """(n, indptr i64, indices i64, data, is_f32) from a scipy CSR."""
    indptr = np.ascontiguousarray(A.indptr, np.int64)
    indices = np.ascontiguousarray(A.indices, np.int64)
    if A.data.dtype == np.float32:
        data = np.ascontiguousarray(A.data, np.float32)
        return A.shape[0], indptr, indices, data, 1
    data = np.ascontiguousarray(A.data, np.float64)
    return A.shape[0], indptr, indices, data, 0


def amg_strength(A, theta: float, sabs: bool, dof_func=None):
    """Native strength pattern; returns (s_indptr, s_indices) or None.

    Semantics: precon/amg/strength.py (classical CreateS)."""
    lib = get_lib()
    if lib is None:
        return None
    n, indptr, indices, data, is_f32 = _csr_arrays(A)
    s_indptr = np.zeros(n + 1, np.int64)
    s_indices = np.empty(max(1, A.nnz), np.int64)
    df = None
    dfp = None
    if dof_func is not None:
        df = np.ascontiguousarray(dof_func, np.int32)
        dfp = df.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    nnz = lib.hdrv_strength(
        n, _i64p(indptr), _i64p(indices),
        data.ctypes.data_as(ctypes.c_void_p), is_f32,
        float(theta), int(bool(sabs)), dfp,
        _i64p(s_indptr), _i64p(s_indices))
    if nnz < 0:
        return None
    return s_indptr, s_indices[:nnz].copy()


def amg_pmis(s_indptr, s_indices, seed: int, boost=None):
    """Native PMIS C/F marks (bit-exact with coarsen.pmis) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(s_indptr) - 1
    s_indptr = np.ascontiguousarray(s_indptr, np.int64)
    s_indices = np.ascontiguousarray(s_indices, np.int64)
    cf = np.empty(n, np.int8)
    bp = None
    if boost is not None:
        boost = np.ascontiguousarray(boost, np.float64)
        bp = boost.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    lib.hdrv_pmis(n, _i64p(s_indptr), _i64p(s_indices), int(seed), bp,
                  cf.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return cf


def amg_interp_ext_i(A, s_indptr, s_indices, cf, plus_i: bool,
                     trunc_factor: float, max_nnz_row: int):
    """Native extended(+i) interpolation; returns a scipy CSR P or None.

    Semantics: precon/amg/interp.py extended_i_interpolation."""
    import scipy.sparse as sp

    lib = get_lib()
    if lib is None:
        return None
    n, indptr, indices, data, is_f32 = _csr_arrays(A)
    s_indptr = np.ascontiguousarray(s_indptr, np.int64)
    s_indices = np.ascontiguousarray(s_indices, np.int64)
    cf8 = np.ascontiguousarray(cf, np.int8)
    h = lib.hdrv_interp_begin(
        n, _i64p(indptr), _i64p(indices),
        data.ctypes.data_as(ctypes.c_void_p), is_f32,
        _i64p(s_indptr), _i64p(s_indices),
        cf8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        int(bool(plus_i)), float(trunc_factor), int(max_nnz_row or 0))
    if not h:
        return None
    try:
        nnz = lib.hdrv_interp_nnz(h)
        nC = lib.hdrv_interp_ncols(h)
        if nnz < 0:
            return None
        p_indptr = np.empty(n + 1, np.int64)
        p_indices = np.empty(max(1, nnz), np.int64)
        p_data = np.empty(max(1, nnz), np.float64)
        lib.hdrv_interp_fill(
            h, _i64p(p_indptr), _i64p(p_indices),
            p_data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        P = sp.csr_matrix(
            (p_data[:nnz], p_indices[:nnz], p_indptr), shape=(n, nC))
        if A.data.dtype == np.float32:
            P.data = P.data.astype(np.float32)
        return P
    finally:
        lib.hdrv_interp_end(h)


def amg_rap(A, P):
    """Native Galerkin triple product Pᵀ·A·P as scipy CSR, or None."""
    import scipy.sparse as sp

    lib = get_lib()
    if lib is None:
        return None
    n, a_indptr, a_indices, a_data, a_is_f32 = _csr_arrays(A)
    nC = P.shape[1]
    p_indptr = np.ascontiguousarray(P.indptr, np.int64)
    p_indices = np.ascontiguousarray(P.indices, np.int64)
    p_data = np.ascontiguousarray(P.data, np.float64)
    h = lib.hdrv_rap_begin(
        n, _i64p(a_indptr), _i64p(a_indices),
        a_data.ctypes.data_as(ctypes.c_void_p), a_is_f32,
        nC, _i64p(p_indptr), _i64p(p_indices),
        p_data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if not h:
        return None
    try:
        nnz = lib.hdrv_rap_nnz(h)
        if nnz < 0:
            return None
        c_indptr = np.empty(nC + 1, np.int64)
        c_indices = np.empty(max(1, nnz), np.int64)
        c_data = np.empty(max(1, nnz), np.float64)
        lib.hdrv_rap_fill(
            h, _i64p(c_indptr), _i64p(c_indices),
            c_data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        Ac = sp.csr_matrix(
            (c_data[:nnz], c_indices[:nnz], c_indptr), shape=(nC, nC))
        if A.data.dtype == np.float32:
            Ac.data = Ac.data.astype(np.float32)
        return Ac
    finally:
        lib.hdrv_rap_end(h)


def dia_split(A, min_count: int, max_diags: int):
    """Native DIA + rest split for the device-matrix builder; returns
    (dia_offsets i64, dia_data (D, n) f64, r_rows i64, r_cols i64,
    r_vals A-dtype) or None.  Semantics: ops/device_matrix.from_csr's
    diagonal census/selection/split, in two threaded C passes."""
    lib = get_lib()
    if lib is None:
        return None
    n, indptr, indices, data, is_f32 = _csr_arrays(A)
    h = lib.hdrv_dia_split_begin(
        n, A.shape[1], _i64p(indptr), _i64p(indices),
        data.ctypes.data_as(ctypes.c_void_p), is_f32,
        int(min_count), int(max_diags))
    if not h:
        return None
    nd = np.zeros(1, np.int64)
    nr = np.zeros(1, np.int64)
    lib.hdrv_dia_split_sizes(h, _i64p(nd), _i64p(nr))
    D, E = int(nd[0]), int(nr[0])
    offsets = np.zeros(max(1, D), np.int64)
    dia = np.empty((max(1, D), n), np.float64)
    rr = np.empty(max(1, E), np.int64)
    rc = np.empty(max(1, E), np.int64)
    rv = np.empty(max(1, E), np.float32 if is_f32 else np.float64)
    lib.hdrv_dia_split_fill(
        h, _i64p(offsets), dia.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)),
        _i64p(rr), _i64p(rc), rv.ctypes.data_as(ctypes.c_void_p))
    return (offsets[:D], dia[:D], rr[:E], rc[:E], rv[:E])
