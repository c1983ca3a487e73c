#!/usr/bin/env python
"""SpMV layout and V-cycle diagnostics on a GPU.

    python scripts/bench_diag.py [nx ...]      # default: 128 192

For each 7-point Laplacian grid nx^3 (float32; float64 too at nx <= 128):

* a stream triad (the bandwidth the card reaches in this run);
* the DIA SpMV of the fine operator: time, bytes/s under the
  minimal-traffic model (every stored array, x and y moved once), and
  its share of the triad;
* every AMG level's A, P and R in the layout the hierarchy picked
  (DIA / ELL+COO tail / dense): time and bytes/s under the same model;
* the V-cycle with the dense layout for tiny operators on and off.

All per-op times are slope-timed (two rep counts of an on-device loop,
unrolled so the loop's own per-trip cost is spread over 10 SpMVs), so
dispatch cancels.  One JSON object per measurement goes to stdout.
Exits non-zero without a GPU.
"""

import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

from bench import device_record, slope_time


def matrix_bytes(E) -> int:
    """Minimal SpMV traffic: every stored array once, plus x and y."""
    import jax

    item = np.dtype(E.dtype).itemsize
    stored = sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(E))
    return stored + (E.shape[0] + E.shape[1]) * item


def layout(E) -> str:
    if E.dense is not None:
        return "dense"
    parts = []
    if E.dia_data is not None:
        parts.append(f"dia{len(E.dia_offsets)}")
    if E.has_ell:
        parts.append(f"ell{E.k}")
    if E.has_tail:
        parts.append(f"tail{E.tail_rows.shape[0]}")
    return "+".join(parts)


# SpMVs per while-loop trip: each trip of an XLA while loop on the GPU
# costs a few µs of its own, which would otherwise be charged to the SpMV
UNROLL = 10


def spmv_time(E, reps=(500, 2000)) -> float:
    """Seconds per matvec.  Square operators iterate x <- c·A·x (c keeps
    the iterate bounded and fuses into the SpMV); rectangular ones reduce
    y into a scalar that feeds back into x, so the loop cannot be hoisted."""
    import jax
    import jax.numpy as jnp

    n_r, n_c = E.shape
    x0 = jnp.ones(n_c, E.dtype)
    if n_r == n_c:
        c = 1.0 / float(jnp.max(E.row_l1_norms()))

        def mk(r):
            @jax.jit
            def f(M, x):
                return jax.lax.fori_loop(
                    0, r, lambda _, v: c * M.matvec(v), x, unroll=UNROLL)
            return f
    else:
        def mk(r):
            @jax.jit
            def f(M, x):
                def body(_, v):
                    return v + 0.0 * jnp.sum(M.matvec(v))
                return jax.lax.fori_loop(0, r, body, x, unroll=UNROLL)
            return f
    return slope_time(mk, (E, x0), *reps)


def vcycle_time(state, n) -> float:
    import jax
    import jax.numpy as jnp

    from hypredrive_tpu.precon.amg.cycle import amg_apply

    def mk(r):
        @jax.jit
        def f(s, v):
            def body(_, w):
                w = amg_apply(s, w)
                return w / jnp.max(jnp.abs(w))
            return jax.lax.fori_loop(0, r, body, v)
        return f
    b = jnp.ones(n, state.levels[0].A.dtype)
    return slope_time(mk, (state, b), 50, 200, trials=3)


def sparse_copy(state):
    """The same hierarchy with every dense-stored operator in its sparse
    DIA/ELL+COO layout (the dense layout rule switched off)."""
    from hypredrive_tpu.ops.device_matrix import EllMatrix

    def sp(E):
        if E is None or E.dense is None:
            return E
        return EllMatrix.from_csr(E.to_csr(), dtype=E.dtype, layout="ell")

    levels = tuple(dataclasses.replace(lv, A=sp(lv.A), P=sp(lv.P),
                                       R=sp(lv.R)) for lv in state.levels)
    return dataclasses.replace(state, levels=levels)


def emit(device, **rec):
    rec["device"] = device
    print(json.dumps(rec), flush=True)


def triad_gbs(dtype) -> float:
    import jax
    import jax.numpy as jnp

    ns = 1 << 27
    u = jnp.ones(ns, dtype)
    v = jnp.ones(ns, dtype)

    def mk(r):
        @jax.jit
        def f(u, v):
            w = jax.lax.fori_loop(0, r, lambda _, w: v + 2.0 * w, u)
            return jnp.sum(w)
        return f
    t = slope_time(mk, (u, v), 20, 80)
    return ns * np.dtype(dtype).itemsize * 3 / t / 1e9


def main():
    import jax
    import jax.numpy as jnp

    from hypredrive_tpu.core.runtime import enable_compile_cache

    enable_compile_cache()
    device = device_record()
    jax.config.update("jax_enable_x64", True)

    from hypredrive_tpu.ops.csr import laplacian_3d_7pt
    from hypredrive_tpu.ops.device_matrix import EllMatrix
    from hypredrive_tpu.precon.amg.hierarchy import setup_hierarchy
    from hypredrive_tpu.config.sections import AMG_SCHEMA

    grids = [int(a) for a in sys.argv[1:]] or [128, 192]
    for nx in grids:
        A_host = laplacian_3d_7pt(nx)
        dtypes = [jnp.float32] + ([jnp.float64] if nx <= 128 else [])
        for dtype in dtypes:
            dname = np.dtype(dtype).name
            triad = triad_gbs(dtype)
            emit(device, what="triad", dtype=dname, gbs=triad)
            A = EllMatrix.from_csr(A_host, dtype=dtype)
            t = spmv_time(A)
            gbs = matrix_bytes(A) / t / 1e9
            emit(device, what="spmv_fine", nx=nx, dtype=dname,
                 layout=layout(A), s=t, gbs=gbs, triad_share=gbs / triad,
                 nnz_per_s=A_host.nnz / t)
            state = setup_hierarchy(A_host, AMG_SCHEMA.defaults(),
                                    dtype=dtype, fine_matrix=A)
            for lvl, lv in enumerate(state.levels):
                for name, E in (("A", lv.A), ("P", lv.P), ("R", lv.R)):
                    if E is None or (lvl == 0 and name == "A"):
                        continue
                    t = spmv_time(E, reps=(1000, 4000))
                    emit(device, what="spmv_level", nx=nx, dtype=dname,
                         level=lvl, op=name, shape=list(E.shape),
                         nnz=E.nnz, layout=layout(E), s=t,
                         gbs=matrix_bytes(E) / t / 1e9)
            t_on = vcycle_time(state, A_host.shape[0])
            t_off = vcycle_time(sparse_copy(state), A_host.shape[0])
            emit(device, what="vcycle", nx=nx, dtype=dname,
                 levels=len(state.levels), dense_rule_on_s=t_on,
                 dense_rule_off_s=t_off)
            del state, A


if __name__ == "__main__":
    main()
