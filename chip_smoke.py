#!/usr/bin/env python
"""Smoke test of the main solve path on an NVIDIA GPU.

    python chip_smoke.py             # one card: device, SpMV parity, CLI runs
    python chip_smoke.py --chips 4   # four cards: distributed solves only

Phases (one process; any failure exits non-zero before the last line):

1. device  — JAX must run on a GPU; prints the card's name and power limit
             as ``nvidia-smi`` reports them.
2. spmv    — every device-matrix layout (DIA, ELL+COO tail, dense) against
             scipy's float64 CSR matvec at real widths (7-point Laplacian
             at 128^3 and the operators of its AMG hierarchy), float64 and
             float32.
3. cli     — three configs through ``hypredrive_tpu.cli.main``: ex1
             (PCG+AMG), a generated 7-point Laplacian at 128^3 (PCG+AMG,
             float64, rtol 1e-8) and ex7-mgr-frelax-reuse (FGMRES+MGR over
             an 8-system sequence).  Iterations must equal the CPU
             backend's; each solution's residual is recomputed on the host.
4. chips   — (``--chips 4`` only) the distributed stacks on a 4-device
             mesh against the same solve on one card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Iteration counts of the same configs on the CPU backend (float64),
# taken with `JAX_PLATFORMS=cpu python -m hypredrive_tpu.cli <config>`.
CPU_ITERS = {
    "ex1": [5],
    "lap7_128": [11],
    "ex7_mgr": [10, 22, 7, 15, 16, 18, 10, 20],
}
TOLS = {"ex1": 1e-6, "lap7_128": 1e-8, "ex7_mgr": 1e-6}
SPMV_TOL = {"float64": 1e-12, "float32": 1e-5}
NX = 128            # grid of the 7-point Laplacian (2,097,152 rows)
NX_FIELD = 64       # grid of each field of the two-field system

LAP_YML = """\
general:
  use_millisec: on
linear_system:
  generate: {{kind: laplacian_7pt, nx: {nx}}}
  rhs_mode: ones
solver:
  pcg:
    relative_tol: 1.0e-8
preconditioner: amg
"""


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def say(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device(n_chips: int):
    import jax

    devs = jax.devices()
    plat = devs[0].platform
    if plat != "gpu":
        print(f"chip_smoke: no GPU; JAX runs on platform {plat!r}",
              file=sys.stderr)
        sys.exit(1)
    check(len(devs) >= n_chips,
          f"need {n_chips} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        say(f"nvidia-smi: {line.strip()}")
    say(f"device: {plat} {devs[0].device_kind} x{len(devs)} "
        f"(compute capability {getattr(devs[0], 'compute_capability', '?')})")
    from hypredrive_tpu.io.native import get_lib

    say("native setup kernels: "
        + ("built" if get_lib() is not None else "unavailable (numpy)"))
    return devs


# ---------------------------------------------------------------------------
# phase 2: SpMV parity
# ---------------------------------------------------------------------------

def _relerr(E, A, x64):
    """max |E x - A x| / max |A x| against scipy's float64 CSR matvec."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    y = np.asarray(jax.jit(lambda M, v: M.matvec(v))(
        E, jnp.asarray(x64, E.dtype)), dtype=np.float64)
    ref = A @ x64.astype(E.dtype).astype(np.float64)
    return float(np.abs(y - ref).max() / np.abs(ref).max())


def _layout(E) -> str:
    if E.dense is not None:
        return "dense"
    parts = []
    if E.dia_data is not None:
        parts.append(f"dia{len(E.dia_offsets)}")
    if E.has_ell:
        parts.append(f"ell{E.k}")
    if E.has_tail:
        parts.append(f"tail{E.tail_rows.shape[0]}")
    return "+".join(parts) or "empty"


def phase_spmv():
    import numpy as np
    import scipy.sparse as sp
    import jax.numpy as jnp

    from hypredrive_tpu.ops.csr import laplacian_3d_7pt
    from hypredrive_tpu.ops.device_matrix import EllMatrix
    from hypredrive_tpu.precon.amg.hierarchy import setup_hierarchy
    from hypredrive_tpu.config.sections import AMG_SCHEMA

    rng = np.random.default_rng(0)
    A = sp.csr_matrix(laplacian_3d_7pt(NX))
    t0 = time.perf_counter()
    hier = setup_hierarchy(A, AMG_SCHEMA.defaults(), dtype=jnp.float64)
    say(f"spmv: {NX}^3 hierarchy, {len(hier.levels)} levels, setup "
        f"{time.perf_counter() - t0:.3f} s")
    # host copies of the hierarchy's operators (the kernels' inputs)
    ops = [("L0 A", A)]
    for lvl, lv in enumerate(hier.levels):
        if lvl:
            ops.append((f"L{lvl} A", lv.A.to_csr()))
        if lv.P is not None:
            ops.append((f"L{lvl} P", lv.P.to_csr()))
            ops.append((f"L{lvl} R", lv.R.to_csr()))
    seen = set()
    for dt_name, dtype in (("float64", jnp.float64), ("float32", jnp.float32)):
        tol = SPMV_TOL[dt_name]
        for name, M in ops:
            x = rng.standard_normal(M.shape[1])
            variants = [("auto", EllMatrix.from_csr(M, dtype=dtype))]
            if name != "L0 A":
                # the ELL+COO tail layout, forced (narrow ELL so long rows
                # spill to the tail) — the sparse form of every coarse
                # operator whichever layout the rule picked
                variants.append(("ell+tail", EllMatrix.from_csr(
                    M, dtype=dtype, use_dia=False, k_cap=4,
                    layout="ell")))
                if M.shape[0] * M.shape[1] <= (1 << 16):
                    variants.append(("dense", EllMatrix.from_csr(
                        M, dtype=dtype, layout="dense")))
            for vname, E in variants:
                err = _relerr(E, M, x)
                lay = _layout(E)
                seen.add(lay.split("+")[0] if lay != "dense" else "dense")
                if E.has_tail:
                    seen.add("tail")
                if E.has_ell:
                    seen.add("ell")
                say(f"spmv {dt_name} {name:6s} {M.shape[0]:>8d}x"
                    f"{M.shape[1]:<8d} {vname:8s} {lay:18s} "
                    f"relerr={err:.3e}")
                check(err <= tol, f"SpMV {name} {vname} {dt_name} relerr "
                                  f"{err:.3e} > {tol:g}")
    for need in ("dia7", "ell", "tail", "dense"):
        check(need in seen, f"SpMV layout {need} never exercised")
    if hier.levels[-1].A.dense is None:
        raise PhaseError("coarsest operator not dense on a GPU: the "
                         "layout rule did not apply")


# ---------------------------------------------------------------------------
# phase 3: the CLI main path
# ---------------------------------------------------------------------------

_ROW = re.compile(r"^\|\s*(\d+)\s*\|(.*)\|\s*$")


def _stats_rows(text: str):
    """(build, setup, solve, initial, relative, iters) per STATISTICS
    SUMMARY row of the CLI's output."""
    rows = []
    in_table = False
    for line in text.splitlines():
        if line.startswith("STATISTICS SUMMARY"):
            in_table = True
        m = _ROW.match(line) if in_table else None
        if m:
            cells = [c.strip() for c in m.group(2).split("|")]
            rows.append((float(cells[0]), float(cells[1]), float(cells[2]),
                         float(cells[3]), float(cells[4]), int(cells[5])))
    return rows


def _run_cli(name, config, dump_dir):
    """Run one config through cli.main, dumping each system's rhs and
    solution; return its STATISTICS SUMMARY rows."""
    from hypredrive_tpu import cli

    overrides = [
        "-a", "linear_system:print_system:enable", "on",
        "-a", "linear_system:print_system:stages", "[apply]",
        "-a", "linear_system:print_system:artifacts", "[rhs, solution]",
        "-a", "linear_system:print_system:dirname", dump_dir,
    ]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([config] + overrides)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    check(rc == 0, f"{name}: cli.main returned {rc}\n{out[-2000:]}")
    rows = _stats_rows(out)
    check(len(rows) == len(CPU_ITERS[name]),
          f"{name}: {len(rows)} stats rows, expected "
          f"{len(CPU_ITERS[name])}\n{out[-2000:]}")
    say(f"cli {name}: wall {wall:.3f} s")
    return rows


def _host_residual(A, dump_dir, ls_id):
    """||b - A x|| / ||b|| in float64 from the dumped rhs and solution."""
    import numpy as np

    from hypredrive_tpu.io import ij

    d = os.path.join(dump_dir, f"ls_{ls_id:05d}", "apply")
    b, _ = ij.read_vector_ascii(os.path.join(d, "IJ.out.b"))
    x, _ = ij.read_vector_ascii(os.path.join(d, "IJ.out.x"))
    r = b.astype(np.float64) - A @ x.astype(np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def phase_cli():
    import scipy.sparse as sp

    from hypredrive_tpu.io import ij
    from hypredrive_tpu.ops.csr import laplacian_3d_7pt

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        lap = os.path.join(tmp, "lap7_128.yml")
        with open(lap, "w") as f:
            f.write(LAP_YML.format(nx=NX))
        cases = [
            ("ex1", os.path.join("examples", "ex1.yml"),
             lambda k: ij.read_matrix_ascii(
                 os.path.join("data", "ps3d10pt7", "np1", "IJ.out.A"))[0]),
            ("lap7_128", lap,
             lambda k: sp.csr_matrix(laplacian_3d_7pt(NX))),
            ("ex7_mgr", os.path.join("examples",
                                     "ex7-mgr-frelax-reuse.yml"),
             lambda k: ij.read_matrix_ascii(os.path.join(
                 "data", "poroseq", "np1", f"ls_{k:05d}", "IJ.out.A"))[0]),
        ]
        for name, config, matrix in cases:
            dump = os.path.join(tmp, name)
            rows = _run_cli(name, config, dump)
            tol = TOLS[name]
            for k, (build, setup, solve, r0, rel, iters) in enumerate(rows):
                res = _host_residual(matrix(k), dump, k)
                say(f"cli {name} #{k}: iters {iters} (cpu "
                    f"{CPU_ITERS[name][k]}), host relres {res:.3e} "
                    f"(tol {tol:g}), build {build:.3f} ms, setup "
                    f"{setup:.3f} ms, solve {solve:.3f} ms")
                check(iters == CPU_ITERS[name][k],
                      f"{name} #{k}: {iters} iterations, CPU backend "
                      f"{CPU_ITERS[name][k]}")
                check(res <= 1.01 * tol,
                      f"{name} #{k}: host residual {res:.3e} > "
                      f"1.01 x {tol:g}")


# ---------------------------------------------------------------------------
# phase 4: four cards
# ---------------------------------------------------------------------------

def _two_field(nx: int):
    """Two-field CPR-like system: a 7-point Laplacian coupled to a
    diagonal second field (the dryrun_multichip system)."""
    import numpy as np
    import scipy.sparse as sp

    from hypredrive_tpu.ops.csr import laplacian_3d_7pt

    A = sp.csr_matrix(laplacian_3d_7pt(nx))
    nc = A.shape[0]
    coo = A.tocoo()
    i = np.arange(nc)
    rows = np.concatenate([2 * coo.row, 2 * i + 1, 2 * i + 1, 2 * i])
    cols = np.concatenate([2 * coo.col, 2 * i + 1, 2 * i, 2 * i + 1])
    vals = np.concatenate([coo.data, np.full(nc, 2.0), np.full(nc, 0.3),
                           np.full(nc, 0.1)])
    A2 = sp.csr_matrix((vals, (rows, cols)), shape=(2 * nc, 2 * nc))
    return A2, np.tile([0, 1], nc)


def _spread(tag, tree):
    """Bytes of the operator and preconditioner arrays on each device."""
    import jax

    sizes = {}
    for leaf in jax.tree_util.tree_leaves(tree):
        for s in getattr(leaf, "addressable_shards", ()):
            sizes[s.device.id] = sizes.get(s.device.id, 0) + s.data.nbytes
    say(f"chips {tag}: shard bytes per device "
        + ", ".join(f"{d}:{b}" for d, b in sorted(sizes.items())))
    return sizes


def _precon_diff(st4, st1) -> float:
    """max |z4 - z1| / max |z1| for one block-Jacobi ILU apply to the same
    vector on two meshes."""
    import numpy as np
    import jax

    from hypredrive_tpu.parallel.dist_matrix import pad_vector
    from hypredrive_tpu.precon.ilu import _tri_jacobi_apply

    r = np.random.default_rng(0).standard_normal(st1[0].shape[0])
    z = [np.asarray(jax.jit(_tri_jacobi_apply)(
            st, pad_vector(r, st[0].shape[0], st[0].mesh)))[:len(r)]
         for st in (st4, st1)]
    return float(np.abs(z[0] - z[1]).max() / np.abs(z[1]).max())


def phase_chips(devs):
    import numpy as np
    import scipy.sparse as sp
    import jax
    import jax.numpy as jnp

    from hypredrive_tpu.ops.csr import laplacian_3d_7pt
    from hypredrive_tpu.parallel import make_mesh, DistEllMatrix
    from hypredrive_tpu.parallel import dist_setup as ds
    from hypredrive_tpu.parallel import dist_precon as dp
    from hypredrive_tpu.parallel.dist_matrix import pad_vector
    from hypredrive_tpu.precon.amg.hierarchy import setup_hierarchy
    from hypredrive_tpu.precon.amg.cycle import amg_apply
    from hypredrive_tpu.precon.mgr import mgr_apply
    from hypredrive_tpu.precon.ilu import _tri_jacobi_apply
    from hypredrive_tpu.solvers.pcg import _pcg_core
    from hypredrive_tpu.solvers.gmres import _gmres_core
    from hypredrive_tpu.solvers.bicgstab import _bicgstab_core
    from hypredrive_tpu.config.sections import AMG_SCHEMA, MGR_SCHEMA

    f64 = jnp.float64
    tol = {"pcg_amg": 1e-8, "gmres_mgr": 1e-6, "bicgstab_bjilu": 1e-6}

    @jax.jit
    def pcg(D, st, b, x0):
        return _pcg_core(lambda v: D.matvec(v), lambda r: amg_apply(st, r),
                         b, x0, jnp.asarray(tol["pcg_amg"], f64),
                         jnp.asarray(0.0, f64), 100, True, 0)

    @jax.jit
    def gmres(D, st, b, x0):
        return _gmres_core(lambda v: D.matvec(v), lambda r: mgr_apply(st, r),
                           b, x0, jnp.asarray(tol["gmres_mgr"], f64),
                           jnp.asarray(0.0, f64), 100, 30, False)

    @jax.jit
    def bicgstab(D, st, b, x0):
        return _bicgstab_core(lambda v: D.matvec(v),
                              lambda r: _tri_jacobi_apply(st, r),
                              b, x0, jnp.asarray(tol["bicgstab_bjilu"], f64),
                              jnp.asarray(0.0, f64), 200)

    errors = []
    mgr_args = MGR_SCHEMA.parse(
        {"level": {0: {"f_dofs": [1],
                       "f_relaxation": {"amg": {"max_iter": 1}}}},
         "coarsest_level": "amg"}, "mgr", errors)
    check(not errors, f"MGR config: {errors}")
    A1 = sp.csr_matrix(laplacian_3d_7pt(NX))
    A2, dofmap = _two_field(NX_FIELD)

    def block_diag_of(A, n_parts):
        """The diagonal blocks of the n_parts row split, as one matrix:
        its ILU(0) is the block-Jacobi factorization of that split."""
        off = ds.offsets_of(ds.split_rows(A, n_parts))
        return sp.csr_matrix(sp.block_diag(
            [A[off[s]:off[s + 1], off[s]:off[s + 1]]
             for s in range(n_parts)]))

    def solve(solver, A, setup, mesh):
        """(A, x, iters, setup s, warm solve s, operator+state pytree)."""
        t0 = time.perf_counter()
        D, st = setup()
        b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh)
        x0 = pad_vector(np.zeros(A.shape[0]), D.shape[0], mesh)
        setup_s = time.perf_counter() - t0
        solver(D, st, b, x0)[0].block_until_ready()    # compile
        t0 = time.perf_counter()
        x, it, *_ = solver(D, st, b, x0)
        x.block_until_ready()
        return A, x, int(it), setup_s, time.perf_counter() - t0, (D, st)

    def stacks(mesh, n_parts):
        nd = int(mesh.devices.size)

        def amg():
            st = setup_hierarchy(ds.split_rows(A1, nd),
                                 AMG_SCHEMA.defaults(), dtype=f64, mesh=mesh)
            return st.levels[0].A, st

        D2 = DistEllMatrix.from_csr(A2, mesh)
        return {
            "pcg_amg": solve(pcg, A1, amg, mesh),
            "gmres_mgr": solve(gmres, A2, lambda: (
                D2, dp.setup_mgr_dist(ds.split_rows(A2, nd), mgr_args,
                                      dofmap, mesh, dtype=f64)), mesh),
            "bicgstab_bjilu": solve(bicgstab, A2, lambda: (
                D2, dp.build_bj_ilu_dist(
                    ds.split_rows(block_diag_of(A2, n_parts), nd), mesh,
                    dtype=f64)), mesh),
        }

    n = 4
    res4 = stacks(make_mesh(n), n)
    for name, (_, _, _, _, _, tree) in res4.items():
        sizes = _spread(name, tree)
        check(len(sizes) == n and min(sizes.values()) > 0,
              f"{name}: operator not spread over {n} devices: {sizes}")
    for d in devs[:n]:
        say(f"chips device {d.id}: peak_bytes_in_use "
            f"{(d.memory_stats() or {}).get('peak_bytes_in_use')}")
    res1 = stacks(make_mesh(devices=[devs[0]]), n)
    for name in res4:
        A, x4, it4, su4, so4, _ = res4[name]
        _, x1, it1, su1, so1, _ = res1[name]
        b = np.ones(A.shape[0])
        rels = [float(np.linalg.norm(
                    b - A @ np.asarray(x, np.float64)[:A.shape[0]])
                    / np.linalg.norm(b)) for x in (x4, x1)]
        say(f"chips {name}: 4 cards {it4} iters relres {rels[0]:.3e} "
            f"setup {su4:.3f} s solve {so4:.4f} s | 1 card {it1} iters "
            f"relres {rels[1]:.3e} setup {su1:.3f} s solve {so1:.4f} s")
        for r in rels:
            check(r <= 1.01 * tol[name], f"{name}: host residual {r:.3e} > "
                                         f"1.01 x {tol[name]:g}")
        if name != "bicgstab_bjilu":
            # AMG and MGR split C/F points identically on 1 and 4 cards
            check(it4 == it1,
                  f"{name}: {it4} iterations on 4 cards, {it1} on 1")
            continue
        # Block-Jacobi ILU(0) has no C/F split, and BiCGSTAB's count
        # follows the reduction order of its dot products (on CPU, 1/2
        # shards of this system: 40/39 iterations at rtol 1e-4, 62/62
        # at 1e-6, 113/104 at 1e-7).  What must agree is the
        # preconditioner: one apply on 4 cards against 1.
        diff = _precon_diff(res4[name][5][1], res1[name][5][1])
        say(f"chips {name}: preconditioner apply, 4 cards vs 1: max "
            f"relative difference {diff:.3e}")
        check(diff <= 1e-12, f"{name}: preconditioner differs: {diff:.3e}")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card distributed phase")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "hypredrive_tpu")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    os.chdir(REPO)
    sys.path.insert(0, REPO)

    import jax

    from hypredrive_tpu.core.runtime import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    devs = phase_device(args.chips)
    phases = ([phase_spmv, phase_cli] if args.chips == 1
              else [lambda: phase_chips(devs)])
    for ph in phases:
        t0 = time.perf_counter()
        ph()
        say(f"phase done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": args.chips}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
