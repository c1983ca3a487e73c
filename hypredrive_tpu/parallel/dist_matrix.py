"""Row-sharded hybrid matrix with shard_map SpMV + ppermute halo exchange.

The distributed twin of :class:`~hypredrive_tpu.ops.device_matrix.
EllMatrix`: rows are block-partitioned over a 1-D mesh (the reference's
ParCSR decomposition, ref: SURVEY §2.9).  Each shard stores a local
DIA+ELL+COO hybrid whose column indices address the extended local
vector ``[x_local | halos]`` filled by the static ppermute schedule from
:mod:`.halo` — so the DIA path (shifted multiply-adds instead of
gathers) applies per shard, and the halo exchange is a collective
inside the same XLA program.

Shard uniformity: all shards share one static structure (union of DIA
offsets, max ELL width, max tail) so a single shard_map kernel serves
every shard.

Global-view semantics: vectors are ordinary jax Arrays sharded with
``NamedSharding(mesh, P('rows'))`` (padded to equal shard sizes with
identity rows), so the *same* Krylov solver code runs single-chip and
multi-chip — XLA inserts psum for the dot products.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.csr import row_partition
from ..ops.device_matrix import EllMatrix
from .mesh import ROWS_AXIS
from .halo import build_halo_plan


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclass
class DistEllMatrix:
    """Row-sharded sparse matrix (square or rectangular).

    Stacked local hybrids, all sharded on axis 0 (= shard axis):
      dia_data: (n_shards, D, rows_max) or None
      cols/vals: (n_shards, rows_max, K)
      tail_*:   (n_shards, T)
      send_idx: per offset (n_shards, S_d)
    """

    dia_data: Optional[jnp.ndarray]
    cols: jnp.ndarray
    vals: jnp.ndarray
    tail_rows: jnp.ndarray
    tail_cols: jnp.ndarray
    tail_vals: jnp.ndarray
    send_idx: Tuple[jnp.ndarray, ...]
    mesh: Mesh
    dia_offsets: Tuple[int, ...]     # static
    offsets: Tuple[int, ...]         # ppermute shard distances (static)
    shape: Tuple[int, int]           # padded global shape
    orig_shape: Tuple[int, int]      # before padding
    nnz: int
    local_max: int                   # padded col-shard size (x_ext locals)
    ext_size: int

    def tree_flatten(self):
        return ((self.dia_data, self.cols, self.vals, self.tail_rows,
                 self.tail_cols, self.tail_vals, self.send_idx),
                (self.mesh, self.dia_offsets, self.offsets, self.shape,
                 self.orig_shape, self.nnz, self.local_max, self.ext_size))

    @classmethod
    def tree_unflatten(cls, aux, children):
        dia, cols, vals, tr, tc, tv, send_idx = children
        return cls(dia, cols, vals, tr, tc, tv, send_idx, *aux)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def n_shards(self) -> int:
        return self.mesh.devices.size

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def from_csr(cls, A: sp.csr_matrix, mesh: Mesh, dtype=jnp.float64,
                 pad_identity: bool = True) -> "DistEllMatrix":
        """Partition a host CSR matrix over the mesh rows axis.

        Square matrices are padded with identity rows/cols to a multiple
        of n_shards (padded entries stay exactly zero through solves);
        rectangular operators (P/R) pad rows and columns independently.
        """
        A = sp.csr_matrix(A)
        n_shards = int(mesh.devices.size)
        n_rows, n_cols = A.shape
        rows_pad = _round_up(n_rows, n_shards)
        cols_pad = _round_up(n_cols, n_shards)
        square = n_rows == n_cols

        if rows_pad != n_rows or cols_pad != n_cols:
            A = A.copy()
            A.resize((rows_pad, cols_pad))
            if square and pad_identity:
                extra = np.arange(n_rows, rows_pad)
                A = (A + sp.coo_matrix(
                    (np.ones(len(extra)), (extra, extra)),
                    shape=(rows_pad, cols_pad))).tocsr()
        A.sort_indices()

        row_off = row_partition(rows_pad, n_shards)
        col_off = row_partition(cols_pad, n_shards)

        subs = []
        for s in range(n_shards):
            lo, hi = int(row_off[s]), int(row_off[s + 1])
            sub = sp.csr_matrix(A[lo:hi])
            sub.sort_indices()
            subs.append(sub)
        return cls._from_local_blocks(
            subs, mesh, col_off, (rows_pad, cols_pad), (n_rows, n_cols),
            int(A.nnz), dtype)

    @classmethod
    def from_parts(cls, parts, mesh: Mesh, n_cols: int,
                   dtype=jnp.float64) -> "DistEllMatrix":
        """Build directly from per-shard row blocks (global columns) —
        the distributed-setup path: the global matrix is never
        assembled.  All parts must have equal row counts and the global
        row/col sizes must be multiples of n_shards (the dist setup's
        bucket padding guarantees this)."""
        n_shards = int(mesh.devices.size)
        if len(parts) != n_shards:
            raise ValueError(f"need {n_shards} parts, got {len(parts)}")
        rows_each = parts[0].shape[0]
        if any(p.shape[0] != rows_each for p in parts):
            raise ValueError("parts must have equal row counts")
        rows_pad = rows_each * n_shards
        if n_cols % n_shards:
            raise ValueError("global column count must divide n_shards")
        col_off = row_partition(n_cols, n_shards)
        subs = []
        for p in parts:
            sub = sp.csr_matrix(p)
            if sub.shape[1] != n_cols:
                sub = sub.copy()
                sub.resize((sub.shape[0], n_cols))
            sub.sort_indices()
            subs.append(sub)
        nnz = int(sum(p.nnz for p in subs))
        return cls._from_local_blocks(
            subs, mesh, col_off, (rows_pad, n_cols), (rows_pad, n_cols),
            nnz, dtype)

    @classmethod
    def _from_local_blocks(cls, subs, mesh, col_off, pad_shape,
                           orig_shape, nnz, dtype) -> "DistEllMatrix":
        n_shards = int(mesh.devices.size)
        rows_pad, cols_pad = pad_shape
        rows_max = rows_pad // n_shards

        # per-shard needed columns → halo plan
        needed = [np.unique(sub.indices) for sub in subs]
        plan, recv_pos = build_halo_plan(n_shards, col_off, needed)

        # remap each shard's columns into x_ext positions
        locals_remapped = []
        for s in range(n_shards):
            sub = subs[s]
            g = sub.indices.astype(np.int64)
            local = (g >= col_off[s]) & (g < col_off[s + 1])
            mapped = np.empty(len(g), dtype=np.int64)
            mapped[local] = g[local] - col_off[s]
            if (~local).any():
                rp = recv_pos[s]
                mapped[~local] = np.array(
                    [rp[int(c)] for c in g[~local]], dtype=np.int64)
            # copy data/indptr: loc.sort_indices() below permutes data
            # in place, and sharing it would silently corrupt the
            # caller's part matrices (the from_parts path passes
            # caller-owned CSR blocks)
            loc = sp.csr_matrix(
                (sub.data.copy(), mapped, sub.indptr.copy()),
                shape=(rows_max, plan.ext_size))
            loc.sort_indices()
            locals_remapped.append(loc)

        # the per-shard pieces are staged on the host and each device is
        # sent only its own slice (staged on the default device, every
        # shard would pass through the first device)
        try:
            staging = jax.default_device(jax.devices("cpu")[0])
        except RuntimeError:            # JAX runs without a CPU backend
            staging = contextlib.nullcontext()
        with staging:
            # pass 1: discover per-shard structure; unify.  max_k/max_t
            # are bucketed (16-wide ELL steps, 128-slot tails) so
            # same-pattern systems of a sequence land on one compiled
            # shard signature — the mesh twin of the single-chip
            # shape-stability buckets.
            probes = [EllMatrix.from_csr(loc, dtype=dtype, layout="ell")
                      for loc in locals_remapped]
            union_offsets = tuple(sorted(set().union(
                *(set(p.dia_offsets) for p in probes))))
            max_k = _round_up(max(p.k for p in probes), 16)
            max_t = max(p.tail_rows.shape[0] for p in probes)
            if max_t:
                max_t = max(_round_up(max_t, 128), 128)

            # pass 2: rebuild with pinned structure
            hybrids = [EllMatrix.from_csr(
                loc, dtype=dtype,
                force_dia_offsets=union_offsets or None,
                k=max_k, min_tail=max_t) for loc in locals_remapped]

        rows_sh3 = NamedSharding(mesh, P(ROWS_AXIS, None, None))
        rows_sh2 = NamedSharding(mesh, P(ROWS_AXIS, None))

        def stack(getter, sharding):
            return jax.device_put(
                np.stack([np.asarray(getter(h)) for h in hybrids]),
                sharding)

        dia = None
        if union_offsets:
            dia = stack(lambda h: h.dia_data, rows_sh3)
        cols = stack(lambda h: h.cols, rows_sh3)
        vals = stack(lambda h: h.vals, rows_sh3)
        tr = stack(lambda h: h.tail_rows, rows_sh2)
        tc = stack(lambda h: h.tail_cols, rows_sh2)
        tv = stack(lambda h: h.tail_vals, rows_sh2)
        send_dev = tuple(
            jax.device_put(idx, rows_sh2) for idx in plan.send_idx)

        return cls(
            dia_data=dia, cols=cols, vals=vals,
            tail_rows=tr, tail_cols=tc, tail_vals=tv,
            send_idx=send_dev, mesh=mesh,
            dia_offsets=union_offsets, offsets=plan.offsets,
            shape=(rows_pad, cols_pad), orig_shape=orig_shape,
            nnz=nnz, local_max=plan.local_max,
            ext_size=plan.ext_size)

    # ------------------------------------------------------------------
    # kernels
    # ------------------------------------------------------------------

    def _local(self, dia, cols, vals, tr, tc, tv) -> EllMatrix:
        rows_max = self.shape[0] // self.n_shards
        return EllMatrix(
            cols=cols[0], vals=vals[0],
            tail_rows=tr[0], tail_cols=tc[0], tail_vals=tv[0],
            shape=(rows_max, self.ext_size), nnz=self.nnz,
            dia_data=dia[0] if dia is not None else None,
            dia_offsets=self.dia_offsets)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x, x sharded P('rows') with length shape[1]."""
        n_sh = self.n_shards
        local_cols = self.shape[1] // n_sh
        perm = [tuple(((i, (i + d) % n_sh) for i in range(n_sh)))
                for d in self.offsets]
        offsets = self.offsets
        local_max = self.local_max
        has_dia = self.dia_data is not None

        def kernel(*args):
            args = list(args)
            dia = args.pop(0) if has_dia else None
            cols, vals, tr, tc, tv, x_loc, *send_idx = args
            parts = [x_loc]
            if local_max > local_cols:
                parts.append(jnp.zeros(local_max - local_cols, x_loc.dtype))
            for k, d in enumerate(offsets):
                buf = x_loc[send_idx[k][0]]          # (S_d,)
                recv = jax.lax.ppermute(buf, ROWS_AXIS, perm[k])
                parts.append(recv)
            x_ext = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
            E = self._local(dia, cols, vals, tr, tc, tv)
            return E.matvec(x_ext)

        spec3 = P(ROWS_AXIS, None, None)
        spec2 = P(ROWS_AXIS, None)
        in_specs = (((spec3,) if has_dia else ())
                    + (spec3, spec3, spec2, spec2, spec2, P(ROWS_AXIS))
                    + tuple(spec2 for _ in offsets))
        f = shard_map(kernel, mesh=self.mesh, in_specs=in_specs,
                      out_specs=P(ROWS_AXIS))
        args = (((self.dia_data,) if has_dia else ())
                + (self.cols, self.vals, self.tail_rows, self.tail_cols,
                   self.tail_vals, x) + self.send_idx)
        return f(*args)

    def diagonal(self) -> jnp.ndarray:
        """diag(A) for square matrices (the global diagonal of shard s,
        row r sits at local x_ext position r)."""
        has_dia = self.dia_data is not None

        def kernel(*args):
            if has_dia:
                dia, cols, vals, tr, tc, tv = args
            else:
                cols, vals, tr, tc, tv = args
                dia = None
            E = self._local(dia, cols, vals, tr, tc, tv)
            return E.diagonal()

        spec3 = P(ROWS_AXIS, None, None)
        spec2 = P(ROWS_AXIS, None)
        in_specs = (((spec3,) if has_dia else ())
                    + (spec3, spec3, spec2, spec2, spec2))
        f = shard_map(kernel, mesh=self.mesh, in_specs=in_specs,
                      out_specs=P(ROWS_AXIS))
        args = (((self.dia_data,) if has_dia else ())
                + (self.cols, self.vals, self.tail_rows, self.tail_cols,
                   self.tail_vals))
        return f(*args)

    def row_l1_norms(self) -> jnp.ndarray:
        has_dia = self.dia_data is not None

        def kernel(*args):
            if has_dia:
                dia, cols, vals, tr, tc, tv = args
            else:
                cols, vals, tr, tc, tv = args
                dia = None
            E = self._local(dia, cols, vals, tr, tc, tv)
            return E.row_l1_norms()

        spec3 = P(ROWS_AXIS, None, None)
        spec2 = P(ROWS_AXIS, None)
        in_specs = (((spec3,) if has_dia else ())
                    + (spec3, spec3, spec2, spec2, spec2))
        f = shard_map(kernel, mesh=self.mesh, in_specs=in_specs,
                      out_specs=P(ROWS_AXIS))
        args = (((self.dia_data,) if has_dia else ())
                + (self.cols, self.vals, self.tail_rows, self.tail_cols,
                   self.tail_vals))
        return f(*args)


def pad_vector(v: np.ndarray, n_pad: int, mesh: Mesh, dtype=jnp.float64):
    """Host vector → padded, row-sharded device array."""
    out = np.zeros(n_pad, dtype=jnp.dtype(dtype))
    out[:len(v)] = np.asarray(v)
    return jax.device_put(out, NamedSharding(mesh, P(ROWS_AXIS)))
