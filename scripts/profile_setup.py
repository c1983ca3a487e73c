"""Profile AMG setup + V-cycle phases on the current backend.

Breaks the 64^3 Laplacian bench's `amg_setup_s` into:
host graph work (strength/coarsen/interp/RAP), the full setup with
device layouts and transfer, and first-cycle compile; then times the
V-cycle.

Usage: python scripts/profile_setup.py [grid_n]
"""
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, ".")


def laplacian_7pt(n):
    ex = np.ones(n)
    T = sp.diags([-ex, 2 * ex, -ex], [-1, 0, 1], (n, n))
    I = sp.identity(n)
    A = (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
         + sp.kron(sp.kron(I, I), T))
    return sp.csr_matrix(A)


def main():
    n1 = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    import jax
    import jax.numpy as jnp

    print(f"backend={jax.default_backend()} devices={len(jax.devices())}",
          flush=True)
    t0 = time.perf_counter()
    A = laplacian_7pt(n1)
    print(f"matrix build: {time.perf_counter()-t0:.3f}s  n={A.shape[0]} "
          f"nnz={A.nnz}", flush=True)

    from hypredrive_tpu.config.sections import AMG_SCHEMA
    from hypredrive_tpu.precon.amg import hierarchy as H

    args = AMG_SCHEMA.defaults()

    # --- phase 1: host-side graph work only (no device arrays) ---
    from hypredrive_tpu.precon.amg.strength import strength_graph
    from hypredrive_tpu.precon.amg.coarsen import coarsen
    from hypredrive_tpu.precon.amg.interp import build_interpolation

    t0 = time.perf_counter()
    A_l = A
    host_levels = []
    while A_l.shape[0] > 64 and len(host_levels) < 24:
        ts = time.perf_counter()
        S = strength_graph(A_l, theta=0.25)
        t_s = time.perf_counter() - ts
        ts = time.perf_counter()
        cf = coarsen(S, ctype=8, seed=len(host_levels))
        t_c = time.perf_counter() - ts
        nC = int((cf > 0).sum())
        if nC == 0 or nC >= A_l.shape[0]:
            break
        ts = time.perf_counter()
        P = build_interpolation(A_l, S, cf, prolongation_type=6)
        t_i = time.perf_counter() - ts
        ts = time.perf_counter()
        A_c = sp.csr_matrix(P.T @ A_l @ P)
        A_c.sort_indices()
        t_r = time.perf_counter() - ts
        print(f"  lvl {len(host_levels)}: n={A_l.shape[0]} nnz={A_l.nnz} "
              f"strength={t_s:.3f} coarsen={t_c:.3f} interp={t_i:.3f} "
              f"rap={t_r:.3f}", flush=True)
        host_levels.append((A_l, P))
        A_l = A_c
    t_host = time.perf_counter() - t0
    print(f"host graph total: {t_host:.3f}s ({len(host_levels)+1} levels)",
          flush=True)

    # --- phase 2: full setup_hierarchy (includes transfer) ---
    t0 = time.perf_counter()
    state = H.setup_hierarchy(A, args, dtype=jnp.float32)
    jax.block_until_ready(jax.tree_util.tree_leaves(state)[0])
    t_setup = time.perf_counter() - t0
    print(f"setup_hierarchy total: {t_setup:.3f}s", flush=True)
    print(H.hierarchy_summary(state), flush=True)

    # --- phase 3: cycle compile + run ---
    from hypredrive_tpu.precon.amg.cycle import amg_apply

    b = jnp.ones(A.shape[0], jnp.float32)
    t0 = time.perf_counter()
    f = jax.jit(amg_apply)
    y = f(state, b)
    jax.block_until_ready(y)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        y = f(state, b)
    jax.block_until_ready(y)
    t_cycle = (time.perf_counter() - t0) / reps
    tot_nnz = sum(lv.A.nnz for lv in state.levels)
    print(f"cycle compile: {t_compile:.3f}s  per-cycle: {t_cycle*1e3:.2f}ms "
          f"eff={2*tot_nnz/t_cycle/1e9:.2f} Gnnz/s", flush=True)

    # --- transfer bandwidth probe ---
    for mb in (1, 16, 64):
        x = np.ones(mb * 1024 * 1024 // 4, np.float32)
        t0 = time.perf_counter()
        d = jax.device_put(x)
        jax.block_until_ready(d)
        dt = time.perf_counter() - t0
        print(f"device_put {mb}MB: {dt:.3f}s ({mb/dt:.1f} MB/s)", flush=True)
    # dispatch latency probe
    g = jax.jit(lambda v: v + 1.0)
    d = jax.device_put(np.ones(8, np.float32))
    jax.block_until_ready(g(d))
    t0 = time.perf_counter()
    for _ in range(50):
        d = g(d)
    jax.block_until_ready(d)
    print(f"dispatch latency: {(time.perf_counter()-t0)/50*1e3:.2f} ms/call",
          flush=True)


if __name__ == "__main__":
    main()
