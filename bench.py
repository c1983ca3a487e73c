#!/usr/bin/env python
"""Benchmark: SpMV + AMG V-cycle nnz/s and PCG iters/wall-time on a GPU.

    python bench.py                     # 64^3 7-point Laplacian, float32
    HYPREDRV_BENCH_NX=128 python bench.py

Prints ONE JSON line
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}

value        = SpMV nnz/s on one GPU (f32, 7-pt Laplacian, nx^3 rows)
vs_baseline  = reference iteration parity on the ex1-class system:
               hypre_iters(6; examples/refOutput/ex1.txt) / our_iters —
               ≥ 1.0 means we match or beat hypre's convergence.
``extra.device`` names the device (JAX platform, device kind and count,
and nvidia-smi's name and power limit).  Without a GPU the script exits
non-zero and prints no result.

Per-op throughputs are SLOPE-timed: an on-device fori_loop runs at two
rep counts and the wall-time difference is divided by the rep
difference, so dispatch and readback cancel.  Setup and the full solve
are plain wall time, as a user sees them.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def slope_time(make_fn, args, r1, r2, trials=5):
    """Median of ((t(r2) - t(r1)) / (r2 - r1)) — per-rep device time with
    the dispatch/readback fixed cost cancelled."""
    f1, f2 = make_fn(r1), make_fn(r2)
    np.asarray(f1(*args))
    np.asarray(f2(*args))
    ss = []
    for _ in range(trials):
        t0 = time.perf_counter()
        np.asarray(f1(*args))
        d1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        np.asarray(f2(*args))
        d2 = time.perf_counter() - t0
        ss.append((d2 - d1) / (r2 - r1))
    ss.sort()
    return ss[len(ss) // 2]


def device_record():
    """The device this run measures; exits non-zero without a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench.py: no GPU; JAX runs on platform "
              f"{devs[0].platform!r}", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    name, power = smi.stdout.strip().splitlines()[0].split(", ")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "name": name, "power_limit": power}


def main():
    import jax
    import jax.numpy as jnp

    from hypredrive_tpu.core.runtime import enable_compile_cache

    enable_compile_cache()
    device = device_record()

    from hypredrive_tpu.ops.csr import laplacian_3d_7pt
    from hypredrive_tpu.ops.device_matrix import EllMatrix
    from hypredrive_tpu.precon.amg.hierarchy import setup_hierarchy
    from hypredrive_tpu.precon.amg.cycle import amg_apply
    from hypredrive_tpu.solvers.pcg import _pcg_core
    from hypredrive_tpu.config.sections import AMG_SCHEMA

    dtype = jnp.float32
    nx = int(os.environ.get("HYPREDRV_BENCH_NX", "64"))

    A_host = laplacian_3d_7pt(nx, dtype=np.float32)
    n = A_host.shape[0]
    nnz = A_host.nnz

    # ---- backend bring-up, instrumented ----------------------------------
    # bring-up is a process-scoped one-time cost, not AMG setup (the
    # reference's HYPRE_Initialize is likewise outside its setup timers)
    t0 = time.perf_counter()
    np.asarray(jax.device_put(np.ones(8, np.float32)) + 1.0)
    first_transfer_s = time.perf_counter() - t0

    # warmup: on semantics (ref: docs/usrman-src/input_structure.rst:35,
    # help.c:905 "untimed warmup solve before measured solves") — a tiny
    # full setup touches every numpy/scipy/XLA dispatch path once so the
    # measured setup is the algorithm, not first-touch/compile costs.
    t0 = time.perf_counter()
    Aw = laplacian_3d_7pt(8, dtype=np.float32)
    jax.block_until_ready(jax.tree_util.tree_leaves(
        setup_hierarchy(Aw, AMG_SCHEMA.defaults(), dtype=dtype)))
    jax.block_until_ready(
        EllMatrix.from_csr(Aw, dtype=dtype).matvec(
            jnp.ones(Aw.shape[0], dtype)))
    warm_compile_s = time.perf_counter() - t0
    backend_init_s = first_transfer_s + warm_compile_s

    # ---- AMG setup (cold = first full-size pass incl. jit compiles) ------
    t0 = time.perf_counter()
    A = EllMatrix.from_csr(A_host, dtype=dtype)
    state = setup_hierarchy(A_host, AMG_SCHEMA.defaults(), dtype=dtype,
                            fine_matrix=A)
    jax.block_until_ready(jax.tree_util.tree_leaves(state))
    setup_cold_time = time.perf_counter() - t0
    # warm setup: median of 3 passes — each is an honest wall time
    # (blocks on EVERY leaf so the per-level transfers land)
    setup_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        A = EllMatrix.from_csr(A_host, dtype=dtype)
        state = setup_hierarchy(A_host, AMG_SCHEMA.defaults(), dtype=dtype,
                                fine_matrix=A)
        jax.block_until_ready(jax.tree_util.tree_leaves(state))
        setup_times.append(time.perf_counter() - t0)
    setup_time = sorted(setup_times)[1]

    x = jnp.ones(n, dtype=dtype)
    b = jnp.ones(n, dtype=dtype)

    # ---- device stream calibration (roofline context) --------------------
    # triad over 512 MB operands (10x the 50 MB L2), slope-timed.
    # w' = v + 2w reads v,w and writes w: 3 accesses/element/rep.
    ns = 1 << 27
    u = jnp.ones(ns, dtype)
    v = jnp.ones(ns, dtype)

    def mk_stream(r):
        @jax.jit
        def f(u, v):
            w = jax.lax.fori_loop(0, r, lambda _, w: v + 2.0 * w, u)
            return jnp.sum(w)
        return f

    st = slope_time(mk_stream, (u, v), 20, 80)
    stream_gbs = ns * 4 * 3 / st / 1e9
    del u, v

    # ---- SpMV throughput -------------------------------------------------
    def mk_spmv(r):
        @jax.jit
        def f(A, x):
            def body(_, vv):
                w = A.matvec(vv)
                return w / jnp.max(jnp.abs(w))
            return jax.lax.fori_loop(0, r, body, x)
        return f

    spmv_t = slope_time(mk_spmv, (A, x), 2000, 8000)
    spmv_nnz_s = nnz / spmv_t

    # ---- AMG V-cycle throughput ------------------------------------------
    def mk_vcyc(r):
        @jax.jit
        def f(s, rr):
            def body(_, vv):
                w = amg_apply(s, vv)
                return w / jnp.max(jnp.abs(w))
            return jax.lax.fori_loop(0, r, body, rr)
        return f

    # nnz touched per cycle: smoothing sweeps + residual on each level
    # (pre+post Chebyshev(order) ≈ 2·order−1 SpMVs each + 1 residual) + P/R
    cyc_nnz = 0
    for lv in state.levels[:-1]:
        sweeps = lv.pre_sweeps + lv.post_sweeps
        order = (lv.smooth_arrays[3].shape[0]
                 if lv.smoother == "chebyshev" else 1)
        cyc_nnz += lv.A.nnz * (sweeps * (2 * order - 1) + 1)
        cyc_nnz += lv.P.nnz + lv.R.nnz
    vcyc_t = slope_time(mk_vcyc, (state, b), 200, 800)
    vcyc_nnz_s = cyc_nnz / vcyc_t

    # ---- full solve to rtol=1e-8 (warm; raw wall) ------------------------
    @jax.jit
    def solve(A, state, b, x0):
        mv = lambda v: A.matvec(v)
        pc = lambda r: amg_apply(state, r)
        return _pcg_core(mv, pc, b, x0, jnp.asarray(1e-8, dtype),
                         jnp.asarray(0.0, dtype), 100, True, 0)

    x0 = jnp.zeros(n, dtype=dtype)
    np.asarray(solve(A, state, b, x0)[0])  # compile + warm
    t0 = time.perf_counter()
    xs, iters, norm, done, _ = solve(A, state, b, x0)
    np.asarray(xs)
    solve_t = time.perf_counter() - t0
    iters_big = int(iters)

    # device-only solve time: repeat the whole solve on device and
    # slope-time it (dispatch and readback cancel)
    def mk_solve_loop(r):
        @jax.jit
        def f(A, state, b, x0):
            def body(_, acc):
                xs, it, nm, dn, _h = _pcg_core(
                    lambda v: A.matvec(v), lambda rr: amg_apply(state, rr),
                    b, x0 + acc * 1e-30, jnp.asarray(1e-8, dtype),
                    jnp.asarray(0.0, dtype), 100, True, 0)
                return xs[0]
            return jax.lax.fori_loop(0, r, body, jnp.asarray(0.0, dtype))
        return f

    solve_dev_t = slope_time(mk_solve_loop, (A, state, b, x0), 4, 16,
                             trials=3)

    # ---- ex1-class parity (hypre: 6 iters @ rtol 1e-6, refOutput/ex1.txt)
    @jax.jit
    def solve_ex1(A, state, b, x0):
        mv = lambda v: A.matvec(v)
        pc = lambda r: amg_apply(state, r)
        return _pcg_core(mv, pc, b, x0, jnp.asarray(1e-6, dtype),
                         jnp.asarray(0.0, dtype), 100, True, 0)

    A1_host = laplacian_3d_7pt(10, dtype=np.float32)
    A1 = EllMatrix.from_csr(A1_host, dtype=dtype)
    s1 = setup_hierarchy(A1_host, AMG_SCHEMA.defaults(), dtype=dtype)
    b1 = jnp.ones(1000, dtype=dtype)
    out1 = solve_ex1(A1, s1, b1, jnp.zeros(1000, dtype=dtype))
    ex1_iters = max(1, int(out1[1]))
    vs_baseline = 6.0 / ex1_iters

    print(json.dumps({
        "metric": "spmv_nnz_per_s_per_chip",
        "value": spmv_nnz_s,
        "unit": "nnz/s",
        "vs_baseline": vs_baseline,
        "extra": {
            "device": device,
            "problem": f"laplacian_7pt {nx}^3 (n={n}, nnz={nnz}) f32",
            "timing": "slope-timed per-op (dispatch cancelled); "
                      "setup/solve are raw wall",
            "amg_vcycle_nnz_per_s": vcyc_nnz_s,
            "amg_levels": len(state.levels),
            "pcg_amg_iters_to_1e-8": iters_big,
            "pcg_amg_solve_s": solve_t,
            "pcg_amg_solve_device_s": solve_dev_t,
            "amg_setup_s": setup_time,
            "amg_setup_passes_s": setup_times,
            "amg_setup_cold_s": setup_cold_time,
            "backend_init_s": backend_init_s,
            "backend_init_breakdown_s": {
                "first_transfer": first_transfer_s,
                "warmup_jit_compiles": warm_compile_s,
            },
            "stream_triad_gbs": stream_gbs,
            # minimal-traffic model: D diagonal rows + x + y per SpMV
            "spmv_effective_gbs":
                n * (len(A.dia_offsets) + 2) * 4 / spmv_t / 1e9,
            "ex1_iters": ex1_iters,
            "ex1_ref_iters": 6,
        },
    }))


if __name__ == "__main__":
    main()
