"""Device-resident sparse matrix: DIA + padded ELL + COO tail hybrid.

This replaces hypre's CSR SpMV — the #1 hot kernel — with layouts that
XLA compiles to streaming loops:

* **DIA.** Most PDE operators are dominated by a handful of diagonals;
  those entries are stored dense-by-diagonal and applied as shifted
  elementwise multiply-adds over contiguous slices, which XLA fuses
  into one loop that streams D+2 vectors.
* **ELL remainder.** Entries off the chosen diagonals live in a padded
  (n, K) gather layout; the rare long rows spill to a COO tail
  (segment_sum).
* **Dense** storage for tiny operators (coarse AMG levels) on
  accelerator backends, where one matrix-vector product costs less than
  the launches of the sparse parts.
* **Static shapes everywhere**, so one XLA compilation serves a whole
  sequence of same-pattern systems (pairs with lsseq pattern dedup).
* Pad slots use column 0 / value 0 — no masking in the inner loops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
import scipy.sparse as sp

from .vectors import HIGHEST

# diagonals covering at least this fraction of rows go to the DIA part
DIA_MIN_FRAC = 0.25
DIA_MAX_DIAGS = 48

# operators of at most this many ELEMENTS (rows*cols) are stored as
# plain dense arrays on accelerator backends: the coarse AMG levels
# (n <= ~250) cost more in launches of the sparse parts than one dense
# matrix-vector product.  0 turns the dense layout off.
DENSE_MAX_ELEMENTS = 1 << 16


def dense_layout_default() -> bool:
    """Layout rule: tiny operators go dense on any accelerator backend
    (the ambient default device's platform, else the default backend);
    the CPU keeps the sparse layouts."""
    dev = jax.config.jax_default_device
    plat = getattr(dev, "platform", dev) or jax.default_backend()
    return str(plat) != "cpu"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class _TraceNeutralInt(int):
    """int carried in pytree aux that compares equal to any other
    instance: bookkeeping values (nnz) that do not shape the traced
    computation must not force jit retraces across a sequence."""

    __slots__ = ()

    def __eq__(self, other):
        return isinstance(other, _TraceNeutralInt)

    def __ne__(self, other):
        return not isinstance(other, _TraceNeutralInt)

    def __hash__(self):
        return 0x5EED


@jax.tree_util.register_pytree_node_class
@dataclass
class EllMatrix:
    """Hybrid DIA+ELL+COO sparse matrix on device (square or rectangular).

    dia_data:  (D, n_rows) — dia_data[i, r] = A[r, r + dia_offsets[i]]
    cols/vals: (n_rows, K) gather part (pad → col 0, val 0)
    tail_*:    (T,) COO spill
    """

    cols: jnp.ndarray
    vals: jnp.ndarray
    tail_rows: jnp.ndarray
    tail_cols: jnp.ndarray
    tail_vals: jnp.ndarray
    shape: Tuple[int, int]
    nnz: int
    dia_data: Optional[jnp.ndarray] = None
    dia_offsets: Tuple[int, ...] = ()
    # dense storage for tiny operators (see DENSE_MAX_ELEMENTS); when
    # set, every kernel short-circuits to plain jnp ops
    dense: Optional[jnp.ndarray] = None

    def tree_flatten(self):
        children = (self.cols, self.vals, self.tail_rows, self.tail_cols,
                    self.tail_vals, self.dia_data, self.dense)
        # nnz is pure bookkeeping (stats/summaries) — wrap it so pytree
        # aux equality ignores its value and same-shape hierarchies from
        # a sequence share one jit cache entry
        aux = (self.shape, _TraceNeutralInt(self.nnz), self.dia_offsets)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        cols, vals, tr, tc, tv, dia, dense = children
        shape, nnz, dia_offsets = aux
        nnz = int(nnz)    # unwrap _TraceNeutralInt (its __eq__ is aux-only)
        return cls(cols, vals, tr, tc, tv, shape, nnz, dia, dia_offsets,
                   dense)

    # -- construction -----------------------------------------------------

    @classmethod
    def from_csr(cls, A: sp.csr_matrix, dtype=jnp.float64,
                 k: Optional[int] = None, k_cap: int = 64,
                 use_dia: bool = True,
                 force_dia_offsets: Optional[Tuple[int, ...]] = None,
                 min_tail: int = 0, layout: str = "auto") -> "EllMatrix":
        """``force_dia_offsets``/``k``/``min_tail`` pin the static
        structure (used by the distributed wrapper to keep shards
        uniform) and imply the sparse layout.

        ``layout``: "auto" applies :func:`dense_layout_default` to tiny
        operators; "dense" forces dense storage; "ell" keeps the sparse
        DIA+ELL+COO layout."""
        if force_dia_offsets is not None or k is not None or min_tail:
            layout = "ell"
        A = sp.csr_matrix(A)
        n_r, n_c = A.shape
        if layout == "dense" or (
                layout == "auto" and n_r * n_c <= DENSE_MAX_ELEMENTS
                and A.nnz > 0 and dense_layout_default()):
            e = np.empty(0)
            return cls(
                cols=jnp.asarray(np.zeros((n_r, 0), np.int32)),
                vals=jnp.asarray(np.zeros((n_r, 0)), dtype=dtype),
                tail_rows=jnp.asarray(e, jnp.int32),
                tail_cols=jnp.asarray(e, jnp.int32),
                tail_vals=jnp.asarray(e, dtype),
                shape=(n_r, n_c), nnz=int(A.nnz),
                dense=jnp.asarray(np.asarray(A.todense()), dtype=dtype),
            )
        # scipy caches the canonical-format check — skipping the
        # sort/dedup passes when already canonical (RAP/interp outputs
        # are) was worth ~0.2 s of the 64³ AMG setup
        if not A.has_canonical_format:
            A.sum_duplicates()
        if not A.has_sorted_indices:
            A.sort_indices()
        n_rows, n_cols = A.shape

        dia_data = None
        dia_offsets: Tuple[int, ...] = ()
        r_rows = r_cols = r_vals = None
        if force_dia_offsets is None and use_dia and A.nnz:
            # native single-call census + selection + split (two
            # threaded C passes instead of ~6 numpy passes over
            # nnz-sized arrays — the dominant warm-setup cost)
            try:
                from ..io.native import dia_split

                nat = dia_split(A, max(16, int(DIA_MIN_FRAC * n_rows)),
                                DIA_MAX_DIAGS)
            except Exception:
                nat = None
            if nat is not None:
                offs, dia, r_rows, r_cols, r_vals = nat
                if len(offs):
                    dia_offsets = tuple(int(o) for o in offs)
                    dia_data = dia

        if r_rows is None:
            counts_rows = np.diff(A.indptr)
            rows_all = np.repeat(np.arange(n_rows), counts_rows)
            cols_all = A.indices.astype(np.int64, copy=False)
            vals_all = A.data.astype(np.float64, copy=False)
            rest = np.ones(A.nnz, dtype=bool)
            if force_dia_offsets is not None:
                good = np.asarray(sorted(force_dia_offsets), dtype=np.int64)
            elif use_dia and A.nnz:
                # O(nnz) diagonal census via bincount over shifted offsets
                # (np.unique's sort was a setup hot spot on coarse
                # operators)
                offs_all = cols_all - rows_all
                shift = offs_all + (n_rows - 1)
                cnt = np.bincount(shift, minlength=n_rows + n_cols - 1)
                min_count = max(16, int(DIA_MIN_FRAC * n_rows))
                good = np.flatnonzero(cnt >= min_count)
                if len(good) > DIA_MAX_DIAGS:
                    good = good[np.argsort(-cnt[good], kind="stable")
                                [:DIA_MAX_DIAGS]]
                    good.sort()
                good = good - (n_rows - 1)
            else:
                good = np.empty(0, np.int64)
            if len(good):
                offs_all = cols_all - rows_all
                dia_offsets = tuple(int(o) for o in good)
                lut = np.zeros(n_rows + n_cols - 1, dtype=bool)
                lut[good + (n_rows - 1)] = True
                sel = lut[offs_all + (n_rows - 1)]
                data = np.zeros((len(good), n_rows))
                pos = np.searchsorted(good, offs_all[sel])
                data[pos, rows_all[sel]] = vals_all[sel]
                dia_data = data
                rest = ~sel

            r_rows = rows_all[rest]
            r_cols = cols_all[rest]
            r_vals = vals_all[rest]

        rest_counts = np.bincount(r_rows, minlength=n_rows)
        max_nnz = int(rest_counts.max(initial=0))
        k_auto = k is None
        if k_auto:
            # round the ELL width up to a multiple of 16 (shape-stability
            # bucket: value-driven max-row-nnz drift across a sequence
            # keeps one compiled signature; pad columns are zero-val
            # no-ops)
            k = min(_round_up(max_nnz, 16) if max_nnz else 0, k_cap)

        cols = np.zeros((n_rows, k), dtype=np.int32)
        vals = np.zeros((n_rows, k), dtype=np.float64)
        if len(r_rows):
            starts = np.zeros(n_rows + 1, dtype=np.int64)
            np.cumsum(rest_counts, out=starts[1:])
            pos_in_row = np.arange(len(r_rows)) - starts[r_rows]
            ell = pos_in_row < k
            cols[r_rows[ell], pos_in_row[ell]] = r_cols[ell]
            vals[r_rows[ell], pos_in_row[ell]] = r_vals[ell]
            spill = ~ell
            tail_r = r_rows[spill]
            tail_c = r_cols[spill]
            tail_v = r_vals[spill]
        else:
            tail_r = tail_c = np.empty(0, np.int64)
            tail_v = np.empty(0, np.float64)

        t = len(tail_r)
        t_pad = max(_round_up(t, 128), 128) if t else 0
        if not t_pad and k_auto and k and k == k_cap:
            # the ELL width hit the cap, so spill is value-dependent: a
            # same-pattern system with drifted values may spill where
            # this one does not (tail (0,) vs (128,) broke the one-
            # compile-per-lsseq-pattern guarantee).  Give the tail the
            # same 128-slot floor it would get with spill; pad slots are
            # (row 0, col 0, val 0) no-ops in segment_sum.
            t_pad = 128
        t_pad = max(t_pad, min_tail)
        tr = np.zeros(t_pad, dtype=np.int32)
        tc = np.zeros(t_pad, dtype=np.int32)
        tv = np.zeros(t_pad, dtype=np.float64)
        tr[:t] = tail_r
        tc[:t] = tail_c
        tv[:t] = tail_v

        return cls(
            cols=jnp.asarray(cols),
            vals=jnp.asarray(vals, dtype=dtype),
            tail_rows=jnp.asarray(tr),
            tail_cols=jnp.asarray(tc),
            tail_vals=jnp.asarray(tv, dtype=dtype),
            shape=(n_rows, n_cols),
            nnz=int(A.nnz),
            dia_data=(jnp.asarray(dia_data, dtype=dtype)
                      if dia_data is not None else None),
            dia_offsets=dia_offsets,
        )

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def has_tail(self) -> bool:
        return self.tail_rows.shape[0] > 0

    @property
    def has_ell(self) -> bool:
        return self.cols.shape[1] > 0

    # -- kernels ----------------------------------------------------------

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x (jit-safe)."""
        n_rows, n_cols = self.shape
        if self.dense is not None:
            return jnp.dot(self.dense, x.astype(self.dense.dtype),
                           precision=HIGHEST).astype(x.dtype)
        y = None
        if self.dia_data is not None:
            # pad x so every shifted window is a static in-bounds slice
            lo = max(0, -min(self.dia_offsets))
            hi = max(0, max(self.dia_offsets) + n_rows - n_cols)
            xp = x
            if lo or hi:
                xp = jnp.concatenate([
                    jnp.zeros(lo, x.dtype), x, jnp.zeros(hi, x.dtype)])
            y = jnp.zeros(n_rows, x.dtype)
            for i, off in enumerate(self.dia_offsets):
                y = y + self.dia_data[i] * jax.lax.dynamic_slice(
                    xp, (lo + off,), (n_rows,))
        if self.has_ell:
            gathered = x[self.cols]                       # (n, K) gather
            ell_y = jnp.sum(self.vals * gathered, axis=1)
            y = ell_y if y is None else y + ell_y
        if y is None:
            y = jnp.zeros(n_rows, x.dtype)
        if self.has_tail:
            y = y + jax.ops.segment_sum(
                self.tail_vals * x[self.tail_cols], self.tail_rows,
                num_segments=n_rows)
        return y

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> jnp.ndarray:
        """Extract diag(A) on device."""
        n = self.shape[0]
        if self.dense is not None:
            return jnp.diagonal(self.dense)
        d = jnp.zeros(n, self.dtype)
        if self.dia_data is not None and 0 in self.dia_offsets:
            d = d + self.dia_data[self.dia_offsets.index(0)]
        if self.has_ell:
            row_ids = jnp.arange(n, dtype=self.cols.dtype)[:, None]
            d = d + jnp.sum(
                jnp.where(self.cols == row_ids, self.vals, 0.0), axis=1)
        if self.has_tail:
            mask = self.tail_rows == self.tail_cols
            d = d + jax.ops.segment_sum(
                jnp.where(mask, self.tail_vals, 0.0), self.tail_rows,
                num_segments=n)
        return d

    def row_l1_norms(self) -> jnp.ndarray:
        """Σ_j |a_ij| per row — the ℓ1-Jacobi scaling vector."""
        if self.dense is not None:
            return jnp.sum(jnp.abs(self.dense), axis=1)
        y = jnp.zeros(self.shape[0], self.dtype)
        if self.dia_data is not None:
            y = y + jnp.sum(jnp.abs(self.dia_data), axis=0)
        if self.has_ell:
            y = y + jnp.sum(jnp.abs(self.vals), axis=1)
        if self.has_tail:
            y = y + jax.ops.segment_sum(
                jnp.abs(self.tail_vals), self.tail_rows,
                num_segments=self.shape[0])
        return y

    def scale(self, sl: Optional[jnp.ndarray], sr: Optional[jnp.ndarray]
              ) -> "EllMatrix":
        """Diagonal scaling Sl·A·Sr as a new matrix (same structure)."""
        n_rows, n_cols = self.shape
        if self.dense is not None:
            import dataclasses

            d = self.dense
            if sl is not None:
                d = d * sl[:, None]
            if sr is not None:
                d = d * sr[None, :]
            return dataclasses.replace(self, dense=d)
        vals = self.vals
        tail_vals = self.tail_vals
        dia = self.dia_data
        if sl is not None:
            vals = vals * sl[:, None]
            if self.has_tail:
                tail_vals = tail_vals * sl[self.tail_rows]
            if dia is not None:
                dia = dia * sl[None, :]
        if sr is not None:
            if self.has_ell:
                vals = vals * sr[self.cols]
            if self.has_tail:
                tail_vals = tail_vals * sr[self.tail_cols]
            if dia is not None:
                lo = max(0, -min(self.dia_offsets))
                hi = max(0, max(self.dia_offsets) + n_rows - n_cols)
                srp = sr
                if lo or hi:
                    srp = jnp.concatenate([
                        jnp.ones(lo, sr.dtype), sr, jnp.ones(hi, sr.dtype)])
                parts = []
                for i, off in enumerate(self.dia_offsets):
                    parts.append(dia[i] * jax.lax.dynamic_slice(
                        srp, (lo + off,), (n_rows,)))
                dia = jnp.stack(parts)
        return EllMatrix(self.cols, vals, self.tail_rows, self.tail_cols,
                         tail_vals, self.shape, self.nnz, dia,
                         self.dia_offsets)

    def to_csr(self) -> sp.csr_matrix:
        """Host round-trip (diagnostics / dumps)."""
        n_rows, n_cols = self.shape
        if self.dense is not None:
            B = sp.csr_matrix(np.asarray(self.dense))
            B.eliminate_zeros()
            B.sort_indices()
            return B
        parts_r, parts_c, parts_v = [], [], []
        if self.dia_data is not None:
            dd = np.asarray(self.dia_data)
            for i, off in enumerate(self.dia_offsets):
                r = np.arange(n_rows)
                c = r + off
                ok = (c >= 0) & (c < n_cols) & (dd[i] != 0)
                parts_r.append(r[ok])
                parts_c.append(c[ok])
                parts_v.append(dd[i][ok])
        if self.has_ell:
            cols = np.asarray(self.cols)
            vals = np.asarray(self.vals)
            mask = vals != 0.0
            rows = np.repeat(np.arange(n_rows), self.k).reshape(
                n_rows, self.k)
            parts_r.append(rows[mask])
            parts_c.append(cols[mask])
            parts_v.append(vals[mask])
        if self.has_tail:
            tm = np.asarray(self.tail_vals) != 0.0
            parts_r.append(np.asarray(self.tail_rows)[tm])
            parts_c.append(np.asarray(self.tail_cols)[tm])
            parts_v.append(np.asarray(self.tail_vals)[tm])
        if not parts_r:
            return sp.csr_matrix(self.shape)
        A = sp.coo_matrix(
            (np.concatenate(parts_v),
             (np.concatenate(parts_r), np.concatenate(parts_c))),
            shape=self.shape).tocsr()
        A.sum_duplicates()
        A.sort_indices()
        return A


def from_csr(A: sp.csr_matrix, dtype=jnp.float64, **kw) -> EllMatrix:
    return EllMatrix.from_csr(A, dtype=dtype, **kw)
