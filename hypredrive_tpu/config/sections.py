"""Section schemas: general / linear_system / solver / preconditioner.

Key and default parity with the reference arg structs:
  * general           — ref: include/internal/args.h:22-39, args.c:55-80
  * linear_system     — ref: include/internal/linsys.h:135-170
  * solver methods    — ref: src/internal/{pcg,gmres,fgmres,bicgstab}.c field lists
  * preconditioners   — ref: src/internal/{amg,mgr,ilu,fsai,ams,ads,schwarz}.c
  * scaling           — ref: src/internal/scaling.c:43-66
  * print_system      — ref: include/internal/linsys.h:26-129
  * reuse             — ref: include/internal/precon_reuse.h:16-170
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional

from .fields import F, Schema, Args, Choices
from . import vocab as V

# ---------------------------------------------------------------------------
# general (ref: include/internal/args.h:22-39)
# ---------------------------------------------------------------------------

GENERAL_SCHEMA = Schema("general", {
    "name": F("str", "", help="object name used in stats headers"),
    "statistics_filename": F("str", "", help="append stats tables to this file"),
    "warmup": F("bool", False, help="run one untimed warmup solve"),
    "statistics": F("enum", 1, V.STATISTICS_MODE, help="stats off/on/2"),
    "num_repetitions": F("int", 1, help="repeat each solve N times"),
    "print_config_params": F("bool", True,
                             help="echo effective config (driver default on,"
                                  " forced off in library mode; ref:"
                                  " args.c:87,113)"),
    "use_millisec": F("bool", False, help="report times in ms instead of s"),
    "device_lazy_init": F("bool", False),
    "exec_policy": F("enum", 1, V.EXEC_POLICY,
                     help="host (CPU backend) or device (accelerator) "
                          "execution"),
    "use_vendor_spgemm": F("bool", False,
                           help="accepted and ignored (no vendor SpGEMM)"),
    "use_vendor_spmv": F("bool", False,
                         help="accepted and ignored (no vendor SpMV)"),
    "dev_pool_size": F("float", 0.0,
                       help="GB; accepted and ignored, XLA manages device "
                            "memory"),
    "uvm_pool_size": F("float", 0.0),
    "host_pool_size": F("float", 0.0),
    "pinned_pool_size": F("float", 0.0),
    "dtype": F("str", "float64",
               help="extension: solve dtype (float64/float32)"),
}, help="global driver settings")

# ---------------------------------------------------------------------------
# linear_system (ref: include/internal/linsys.h:135-170)
# ---------------------------------------------------------------------------

EIGSPEC_SCHEMA = Schema("eigspec", {
    "enable": F("bool", False),
    "vectors": F("bool", False, help="also write eigenvectors"),
    "hermitian": F("bool", False, help="use symmetric (eigh) path"),
    "preconditioned": F("bool", False, help="spectrum of M^-1 A"),
    "output_prefix": F("str", "eigspec"),
}, help="dense eigenspectrum computation (ref: include/internal/eigspec.h:22-30)")

PRINT_SYSTEM_SCHEMA = Schema("print_system", {
    "enable": F("bool", False),
    "trigger": F("str", "all",
                 help="all|every_n_systems|every_n_timesteps|ids|ranges|"
                      "iterations_over|setup_time_over|solve_time_over|selectors"),
    "value": F("any", None, help="trigger argument (N, id list, ranges, threshold)"),
    "stages": F("str_list", ["build"], help="subset of build/setup/apply"),
    "artifacts": F("str_list",
                   ["matrix", "rhs", "x0"],
                   help="matrix|precmat|rhs|x0|xref|solution|dofmap|metadata"),
    "dirname": F("str", "print_system", help="output directory"),
    "overwrite": F("bool", False),
}, help="scheduled linear-system dumps (ref: include/internal/linsys.h:26-129)")

LINEAR_SYSTEM_SCHEMA = Schema("linear_system", {
    "matrix_filename": F("str", ""),
    "matrix_basename": F("str", ""),
    "precmat_filename": F("str", ""),
    "precmat_basename": F("str", ""),
    "rhs_filename": F("str", ""),
    "rhs_basename": F("str", ""),
    "x0_filename": F("str", ""),
    "x0_basename": F("str", ""),
    "sol_filename": F("str", ""),
    "sol_basename": F("str", ""),
    "xref_filename": F("str", ""),
    "dofmap_filename": F("str", ""),
    "dofmap_basename": F("str", ""),
    "dirname": F("str", ""),
    "sequence_filename": F("str", "", help="lsseq container file"),
    "timestep_filename": F("str", ""),
    "digits_suffix": F("int", 5, help="zero-padded width of file suffixes"),
    "init_suffix": F("int", -1),
    "last_suffix": F("int", -1),
    "set_suffix": F("int", -1),
    "type": F("enum", 1, V.LS_TYPE),
    "rhs_mode": F("enum", 0, V.RHS_MODE),
    "init_guess_mode": F("enum", 0, V.INIT_GUESS_MODE),
    "exec_policy": F("enum", 1, V.EXEC_POLICY),
    "num_systems": F("int", 1),
    "precon_reuse": F("int", 0, help="legacy alias of preconditioner.reuse"),
    "print_system": PRINT_SYSTEM_SCHEMA,
    "eigspec": EIGSPEC_SCHEMA,
    "generate": Schema("generate", {
        "kind": F("str", "", help="laplacian_7pt|laplacian_27pt|laplacian_5pt|"
                                  "elasticity|multiphysics (extension: "
                                  "deterministic in-memory systems)"),
        "nx": F("int", 10),
        "ny": F("int", 0),
        "nz": F("int", 0),
        "ncell": F("int", 100),
        "ndof": F("int", 3),
        "seed": F("int", 7),
    }, help="generated test systems (extension; reference datasets "
            "are external Zenodo downloads, ref: data/README.md)"),
    "dof_labels": Schema("dof_labels", {}, open_keys=True,
                         help="symbolic dof-name → int map "
                              "(ref: containers.h:120-139)"),
}, help="matrix/vector input, generation modes and diagnostics")

# ---------------------------------------------------------------------------
# solver methods (defaults from ref field lists)
# ---------------------------------------------------------------------------

PCG_SCHEMA = Schema("pcg", {
    "max_iter": F("int", 100),
    "two_norm": F("bool", True),
    "stop_crit": F("bool", False),
    "rel_change": F("bool", False),
    "print_level": F("int", 1),
    "recompute_res": F("bool", False),
    "relative_tol": F("float", 1.0e-6),
    "absolute_tol": F("float", 0.0),
    "residual_tol": F("float", 0.0),
    "conv_fac_tol": F("float", 0.0),
}, help="preconditioned conjugate gradient (ref: src/internal/pcg.c:16-27)")

GMRES_SCHEMA = Schema("gmres", {
    "min_iter": F("int", 0),
    "max_iter": F("int", 300),
    "stop_crit": F("bool", False),
    "skip_real_res_check": F("bool", False),
    "krylov_dim": F("int", 30),
    "rel_change": F("bool", False),
    "logging": F("int", 1),
    "print_level": F("int", 1),
    "relative_tol": F("float", 1.0e-6),
    "absolute_tol": F("float", 0.0),
    "conv_fac_tol": F("float", 0.0),
}, help="restarted GMRES (ref: src/internal/gmres.c:16-27)")

FGMRES_SCHEMA = Schema("fgmres", {
    "min_iter": F("int", 0),
    "max_iter": F("int", 300),
    "krylov_dim": F("int", 30),
    "logging": F("int", 1),
    "print_level": F("int", 1),
    "relative_tol": F("float", 1.0e-6),
    "absolute_tol": F("float", 0.0),
}, help="flexible GMRES (ref: src/internal/fgmres.c:16-23)")

BICGSTAB_SCHEMA = Schema("bicgstab", {
    "min_iter": F("int", 0),
    "max_iter": F("int", 100),
    "stop_crit": F("bool", False),
    "logging": F("int", 1),
    "print_level": F("int", 1),
    "relative_tol": F("float", 1.0e-6),
    "absolute_tol": F("float", 0.0),
    "conv_fac_tol": F("float", 0.0),
}, help="BiCGSTAB (ref: src/internal/bicgstab.c:16-24)")

SOLVER_SCHEMAS = {
    "pcg": PCG_SCHEMA,
    "gmres": GMRES_SCHEMA,
    "fgmres": FGMRES_SCHEMA,
    "bicgstab": BICGSTAB_SCHEMA,
}

SCALING_SCHEMA = Schema("scaling", {
    "enabled": F("bool", False),
    "type": F("enum", 0, V.SCALING_TYPE),
    "custom_values": F("float_list", []),
}, help="pre-solve diagonal scaling (ref: src/internal/scaling.c:43-66)")

# ---------------------------------------------------------------------------
# preconditioners
# ---------------------------------------------------------------------------

CHEBY_SCHEMA = Schema("chebyshev", {
    "order": F("int", 2),
    "eig_est": F("int", 10, help="CG iterations for eigenvalue estimate"),
    "variant": F("int", 0),
    "scale": F("bool", True),
    "fraction": F("float", 0.3),
}, help="Chebyshev smoother options (ref: src/internal/cheby.c:16-21)")

FSAI_SCHEMA = Schema("fsai", {
    "max_iter": F("int", 1),
    "print_level": F("int", 0),
    "algo_type": F("enum", 1, V.FSAI_ALGO),
    "ls_type": F("int", 1),
    "max_steps": F("int", 5),
    "max_step_size": F("int", 3),
    "max_nnz_row": F("int", 15),
    "num_levels": F("int", 1),
    "eig_max_iters": F("int", 5),
    "threshold": F("float", 1.0e-3),
    "kap_tolerance": F("float", 1.0e-3),
    "tolerance": F("float", 0.0),
}, help="factored sparse approximate inverse (ref: src/internal/fsai.c:15-27)")

ILU_SCHEMA = Schema("ilu", {
    "max_iter": F("int", 1),
    "print_level": F("int", 0),
    "type": F("enum", 0, V.ILU_TYPE),
    "fill_level": F("int", 0),
    "reordering": F("int", 0),
    "tri_solve": F("bool", True,
                   help="exact triangular solve vs Jacobi sweeps "
                        "(off keeps the apply to SpMVs)"),
    "lower_jac_iters": F("int", 5),
    "upper_jac_iters": F("int", 5),
    "max_row_nnz": F("int", 200),
    "schur_max_iter": F("int", 3),
    "droptol": F("float", 1.0e-2),
    "nsh_droptol": F("float", 1.0e-2),
    "tolerance": F("float", 0.0),
}, help="incomplete LU (ref: src/internal/ilu.c:15-28)")

SCHWARZ_SCHEMA = Schema("schwarz", {
    "variant": F("enum", 10, V.SCHWARZ_VARIANT),
    "overlap": F("int", 1),
    "domain_type": F("int", 2),
    "num_functions": F("int", 1),
    "use_nonsymm": F("bool", False),
    "local_solver_type": F("enum", 0, V.SCHWARZ_LOCAL_SOLVER),
    "iluk_level_of_fill": F("int", 0),
    "ilut_max_nnz_row": F("int", 1000),
    "max_iter": F("int", 1),
    "print_level": F("int", 0),
    "logging": F("int", 0),
    "relax_weight": F("float", 1.0),
    "ilut_droptol": F("float", 1.0e-2),
    "tolerance": F("float", 0.0),
}, help="additive/RAS Schwarz (ref: src/internal/schwarz.c:20-34)")

AMG_SCHEMA = Schema("amg", {
    "max_iter": F("int", 1),
    "print_level": F("int", 0),
    "tolerance": F("float", 0.0),
    "interp_vec_variant": F("int", 2, help="RBM interpolation variant"),
    "interp_vec_qmax": F("int", 0,
                         help="GM2 pattern growth: max added P entries per "
                              "row (hypre InterpVecQMax; 0 = existing "
                              "pattern only)"),
    "cycle_type": F("int", 1,
                    help="multigrid cycle: 1=V, 2=W (hypre "
                         "BoomerAMGSetCycleType convention; extension "
                         "key — the reference fixes V)"),
    "interpolation": Schema("interpolation", {
        "prolongation_type": F("enum", 6, V.AMG_PROLONGATION),
        "restriction_type": F("enum", 0, V.AMG_RESTRICTION),
        "max_nnz_row": F("int", 4),
        "trunc_factor": F("float", 0.0),
        "restrict_strong_th": F("float", 0.25),
        "restrict_filter_th": F("float", 0.0),
    }, help="interpolation/restriction (ref: amg.c:117-127)"),
    "coarsening": Schema("coarsening", {
        # Reference GPU default is PMIS/mod_rap2 (ref: amg.c:135-156);
        # this is a device code, so PMIS is the default here too.
        "type": F("enum", 8, V.AMG_COARSENING),
        "rap2": F("bool", False),
        "mod_rap2": F("bool", True),
        "keep_transpose": F("bool", True),
        "sabs": F("bool", False),
        "num_functions": F("int", 1),
        "filter_functions": F("bool", False),
        "nodal": F("int", 0),
        "seq_amg_th": F("int", 0),
        "min_coarse_size": F("int", 0),
        "max_coarse_size": F("int", 64),
        "max_levels": F("int", 25),
        "max_row_sum": F("float", 0.9),
        "strong_th": F("float", 0.25),
        # Extension: offset for the deterministic splitmix64 PMIS
        # measure hash.  hypre's PMIS measures are rank-local RNG draws,
        # so its multi-rank grids are unreproducible bit-for-bit on one
        # chip; this knob selects among the equivalent random-grid
        # ensemble (see examples/ex2.yml — the reference's 4-rank
        # 351-C-point grid class).
        "rand_seed": F("int", 0),
    }, help="coarsening (ref: amg.c:131-156)"),
    "aggressive": Schema("aggressive", {
        "num_levels": F("int", 0),
        "num_paths": F("int", 1),
        "prolongation_type": F("enum", 4, V.AMG_AGG_PROLONGATION),
        "max_nnz_row": F("int", 0),
        "P12_max_elements": F("int", 0),
        "P12_trunc_factor": F("float", 0.0),
        "trunc_factor": F("float", 0.0),
    }, help="aggressive coarsening (ref: amg.c:160-172)"),
    "relaxation": Schema("relaxation", {
        "type": F("int", -1),
        # Reference GPU default is l1-Jacobi (18, ref: amg.c:180-196);
        # Chebyshev(2) gives strictly better iteration counts
        # (matches/beats the reference's hybrid-GS counts) at the same
        # SpMV cost shape, so it is the device default here.
        "down_type": F("enum", 16, V.AMG_RELAX),
        "up_type": F("enum", 16, V.AMG_RELAX),
        "coarse_type": F("enum", 9, V.AMG_COARSE_RELAX),
        "down_sweeps": F("int", -1),
        "up_sweeps": F("int", -1),
        "coarse_sweeps": F("int", 1),
        "num_sweeps": F("int", 1),
        "order": F("int", 0),
        "points": F("enum", 0, V.AMG_RELAX_POINTS),
        "weight": F("float", 1.0),
        "outer_weight": F("float", 1.0),
        "chebyshev": CHEBY_SCHEMA,
    }, help="relaxation (ref: amg.c:176-200)"),
    "smoother": Schema("smoother", {
        "type": F("enum", 5, V.AMG_SMOOTHER),
        "num_levels": F("int", 0),
        "num_sweeps": F("int", 1),
        "fsai": FSAI_SCHEMA,
        "ilu": ILU_SCHEMA,
    }, help="complex smoothers on the finest levels (ref: amg.c:204-214)"),
}, help="BoomerAMG-equivalent algebraic multigrid")

# MGR global + per-level (ref: src/internal/mgr.c:1546-1694; mgr.h:56-126)
MGR_KRYLOV_SCHEMA = Schema("krylov", {
    "type": F("str", "gmres", help="pcg|gmres|fgmres|bicgstab"),
    "max_iter": F("int", 20),
    "krylov_dim": F("int", 20),
    "relative_tol": F("float", 0.0),
    "absolute_tol": F("float", 0.0),
    "print_level": F("int", 0),
    "preconditioner": F("any", None, help="nested preconditioner config"),
}, help="nested Krylov component (ref: include/internal/krylov.h:16-44)")

MGR_LEVEL_SCHEMA = Schema("level", {
    "f_dofs": F("any", [], help="int list or dof-label list"),
    # ref default: single-sweep Jacobi (type 7, mgr.c MGRfrlxSetDefaultArgs)
    "f_relaxation": F("any", "single",
                      help="none|single|jacobi|l1-jacobi|v(1,0)|amg|mgr|chebyshev|"
                           "ilu|ge|spdirect|ge-piv|ge-inv|fsai|schwarz or "
                           "nested map / krylov block"),
    "g_relaxation": F("any", "none",
                      help="none|blk-jacobi|blk-gs|mixed-gs|amg|...|ilu|fsai|schwarz"),
    "prolongation_type": F("enum", 0, V.MGR_PROLONGATION),
    "restriction_type": F("enum", 0, V.MGR_RESTRICTION),
    "coarse_level_type": F("enum", 0, V.MGR_COARSE_LEVEL),
    "num_sweeps": F("int", 1),
}, help="one MGR reduction level")

MGR_SCHEMA = Schema("mgr", {
    "max_iter": F("int", 1),
    "print_level": F("int", 0),
    "tolerance": F("float", 0.0),
    "coarse_th": F("float", 0.0),
    "num_levels": F("int", -1, help="-1 = infer from level map"),
    "non_c_to_f": F("bool", True),
    "pmax": F("int", 0),
    # cycle accepts v|w|1|2|v(1,0)|v(0,1)|v(1,1)|w(...) — the (pre,post)
    # suffix drives cycle_smooth_pos (ref: MGRCycleSet, mgr.c:611-673)
    "cycle": F("any", "v"),
    "cycle_smooth_pos": F("enum", 1, V.MGR_SMOOTH_POS),
    "nonglk_max_elmts": F("int", 1),
    "level": Schema("level", {}, open_keys=True,
                    help="map of level index -> level config"),
    "coarsest_level": F("any", "def",
                        help="def|amg|spdirect|ilu|fsai|schwarz or nested map"),
    "reuse": F("any", None, help="per-component reuse flags"),
}, help="multigrid reduction for multiphysics blocks")

AMS_SCHEMA = Schema("ams", {
    "max_iter": F("int", 1),
    "print_level": F("int", 0),
    "tolerance": F("float", 0.0),
    "cycle_type": F("int", 1),
    "relax_type": F("int", 2),
    "relax_times": F("int", 1),
    "relax_weight": F("float", 1.0),
    "omega": F("float", 1.0),
    "alpha_amg": AMG_SCHEMA,
    "beta_amg": AMG_SCHEMA,
}, help="auxiliary-space Maxwell solver (ref: include/internal/ams.h:24-63)")

ADS_SCHEMA = Schema("ads", {
    "max_iter": F("int", 1),
    "print_level": F("int", 0),
    "tolerance": F("float", 0.0),
    "cycle_type": F("int", 1),
    "relax_type": F("int", 2),
    "relax_times": F("int", 1),
    "relax_weight": F("float", 1.0),
    "omega": F("float", 1.0),
    "ams": AMS_SCHEMA,
    "amg": AMG_SCHEMA,
}, help="auxiliary-space div solver (ref: include/internal/ads.h:24-57)")

JACOBI_SCHEMA = Schema("jacobi", {
    "max_iter": F("int", 1),
    "l1": F("bool", True, help="l1-scaled Jacobi (device default)"),
}, help="(ref: precon.c:256-289 — AMG as single-level Jacobi relaxation)")

GS_SCHEMA = Schema("gauss-seidel", {
    "max_iter": F("int", 1),
    "sweeps": F("int", 1),
    "hybrid": F("bool", True,
                help="processor-local GS, Jacobi across shards"),
}, help="(ref: precon.c:256-289 — AMG as single-level hybrid-GS relaxation)")

PRECON_SCHEMAS = {
    # chebyshev is a relaxation type in the reference; exposed as a
    # standalone preconditioner here (extension — it is the natural
    # device smoother).
    "chebyshev": CHEBY_SCHEMA,
    "amg": AMG_SCHEMA,
    "mgr": MGR_SCHEMA,
    "ilu": ILU_SCHEMA,
    "fsai": FSAI_SCHEMA,
    "ams": AMS_SCHEMA,
    "ads": ADS_SCHEMA,
    "schwarz": SCHWARZ_SCHEMA,
    "jacobi": JACOBI_SCHEMA,
    "gauss-seidel": GS_SCHEMA,
    "none": Schema("none", {}, help="unpreconditioned"),
}

# ---------------------------------------------------------------------------
# preconditioner reuse (ref: include/internal/precon_reuse.h:16-170)
# ---------------------------------------------------------------------------

REUSE_COMPONENT_SCHEMA = Schema("component", {
    "metric": F("enum", 0, V.REUSE_METRIC),
    "weight": F("float", 1.0),
    "direction": F("enum", 0, V.REUSE_DIRECTION),
    "target": F("float", 0.0),
    "scale": F("float", 1.0),
    "mean": Schema("mean", {
        "kind": F("enum", 0, V.REUSE_MEAN),
        "power": F("float", 1.0),
    }),
    "transform": Schema("transform", {
        "kind": F("enum", 0, V.REUSE_TRANSFORM),
        "baseline": F("int", 0),
        "amortization_window": F("int", 0),
    }),
    "history": Schema("history", {
        "source": F("enum", 0, V.REUSE_HISTORY_SOURCE),
        "level": F("int", 0),
        "max_points": F("int", 8),
        "reduction": F("str", "mean"),
    }),
})

REUSE_SCHEMA = Schema("reuse", {
    "enabled": F("bool", False),
    "frequency": F("int", 0, help="rebuild every N systems (static policy)"),
    "linear_system_ids": F("any", None, help="explicit ids or 'always'"),
    "per_timestep": F("bool", False),
    "policy": F("enum", 0, V.REUSE_POLICY),
    "guards": Schema("guards", {
        "min_reuse_solves": F("int", 0),
        "max_reuse_solves": F("int", 0),
        "min_history_points": F("int", 1),
        "bad_decisions_to_rebuild": F("int", 1),
        "max_iteration_ratio": F("float", 0.0),
        "max_solve_time_ratio": F("float", 0.0),
        "rebuild_on_new_timestep": F("bool", False),
        "rebuild_on_solver_failure": F("bool", True),
        # true = watch every level depth; or a list of depths to watch
        # (ref: guards.rebuild_on_new_level IntArray, precon_reuse.h:122)
        "rebuild_on_new_level": F("any", None),
    }),
    "adaptive": Schema("adaptive", {
        "rebuild_threshold": F("float", 0.5),
        "positive_floor": F("float", 0.0),
        "components": F("any", []),
    }),
}, help="skip preconditioner rebuilds across a system sequence")


# ---------------------------------------------------------------------------
# Top-level parsed configuration
# ---------------------------------------------------------------------------

@dataclass
class SolverConfig:
    method: str = "gmres"
    args: Args = dc_field(default_factory=lambda: GMRES_SCHEMA.defaults())
    scaling: Args = dc_field(default_factory=lambda: SCALING_SCHEMA.defaults())


@dataclass
class PreconConfig:
    method: str = "none"
    args: Args = dc_field(default_factory=Args)
    reuse: Args = dc_field(default_factory=lambda: REUSE_SCHEMA.defaults())


@dataclass
class InputArgs:
    """Fully parsed input (reference equivalent: input_args,
    ref: include/internal/args.h:44-64)."""

    general: Args = dc_field(default_factory=lambda: GENERAL_SCHEMA.defaults())
    linear_system: Args = dc_field(
        default_factory=lambda: LINEAR_SYSTEM_SCHEMA.defaults())
    solver: SolverConfig = dc_field(default_factory=SolverConfig)
    precon_variants: List[PreconConfig] = dc_field(
        default_factory=lambda: [PreconConfig()])
    active_variant: int = 0
    raw_tree: Optional[dict] = None  # effective YAML tree (for echo)

    @property
    def preconditioner(self) -> PreconConfig:
        return self.precon_variants[self.active_variant]

    @property
    def num_precon_variants(self) -> int:
        return len(self.precon_variants)

    def set_precon_variant(self, index: int):
        """ref: HYPREDRV_InputArgsSetPreconVariant (src/HYPREDRV.c:1409)"""
        if not 0 <= index < len(self.precon_variants):
            raise IndexError(f"precon variant {index} out of range")
        self.active_variant = index
