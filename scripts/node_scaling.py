#!/usr/bin/env python
"""Weak/strong scaling sweep over accelerator devices (or a virtual CPU mesh).

Equivalent of the reference's scripts/node_scaling.sh + perf_laplacian.sh
(ref: docs/usrman-src/performance.rst:83-186): runs CG+AMG on generated
Laplacians across increasing device counts and reports rows/s and
nnz/s per chip, plus parallel efficiency.

Without real multi-chip hardware, pass --virtual N to emulate N devices
on CPU (xla_force_host_platform_device_count) — the same code path the
driver validates with dryrun_multichip.

Usage:
  python scripts/node_scaling.py --mode weak --rows-per-chip 262144
  python scripts/node_scaling.py --mode strong --rows 1048576 --virtual 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("weak", "strong"), default="weak")
    ap.add_argument("--rows-per-chip", type=int, default=262_144)
    ap.add_argument("--rows", type=int, default=1_048_576,
                    help="total rows (strong scaling)")
    ap.add_argument("--virtual", type=int, default=0,
                    help="emulate N CPU devices instead of real chips")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default=None, help="append JSON lines here")
    args = ap.parse_args(argv)

    if args.virtual:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()

    import jax
    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from hypredrive_tpu.ops.csr import laplacian_3d_7pt
    from hypredrive_tpu.parallel import make_mesh, DistEllMatrix
    from hypredrive_tpu.parallel.dist_matrix import pad_vector
    from hypredrive_tpu.precon.amg.hierarchy import setup_hierarchy
    from hypredrive_tpu.precon.amg.cycle import amg_apply
    from hypredrive_tpu.solvers.pcg import _pcg_core
    from hypredrive_tpu.config.sections import AMG_SCHEMA

    ndev_avail = len(jax.devices())
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= ndev_avail]
    results = []
    print(f"{'chips':>6} {'rows':>10} {'nnz':>12} {'t_solve[s]':>11} "
          f"{'iters':>6} {'nnz/s/chip':>12} {'eff%':>6}")
    base_rate = None
    for ndev in counts:
        rows = (args.rows_per_chip * ndev if args.mode == "weak"
                else args.rows)
        nx = max(4, round(rows ** (1 / 3)))
        A = laplacian_3d_7pt(nx)
        mesh = make_mesh(ndev)
        D = DistEllMatrix.from_csr(A, mesh)
        state = setup_hierarchy(A, AMG_SCHEMA.defaults(), mesh=mesh)
        b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh)
        x0 = pad_vector(np.zeros(A.shape[0]), D.shape[0], mesh)

        @jax.jit
        def step(D, state, b, x0):
            mv = lambda x: D.matvec(x)
            pc = lambda r: amg_apply(state, r)
            return _pcg_core(mv, pc, b, x0, 1e-8, 0.0, 50, True, 0)

        x, iters, norm, done, _ = step(D, state, b, x0)  # compile+warm
        jax.block_until_ready(x)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            x, iters, *_ = step(D, state, b, x0)
        jax.block_until_ready(x)
        dt = (time.perf_counter() - t0) / args.reps
        it = int(iters)
        spmv_equiv = it * (2 + 2)  # matvec + V-cycle transfers, rough
        rate = A.nnz * max(it, 1) / dt / ndev
        if base_rate is None:
            base_rate = rate
        eff = 100.0 * rate / base_rate
        print(f"{ndev:>6} {A.shape[0]:>10} {A.nnz:>12} {dt:>11.4f} "
              f"{it:>6} {rate:>12.3e} {eff:>6.1f}")
        results.append({"chips": ndev, "rows": int(A.shape[0]),
                        "nnz": int(A.nnz), "t_solve": dt, "iters": it,
                        "nnz_per_s_per_chip": rate, "efficiency_pct": eff,
                        "mode": args.mode})
    if args.json:
        with open(args.json, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
