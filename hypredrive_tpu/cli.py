"""Command-line driver.

Reference equivalent: ``hypredrive-cli [options] input.yml ...``
(ref: src/internal/main.c:15-34 usage, :175 RunSolveLoops, :269 main).

Options:
  -h/--help [topic]   schema-generated help topics
  -i/--info           system information report
  -a PATH VALUE       config override (repeatable), path like sect:sub:key
  -p/--prec-preset P  preconditioner preset
  -n/--dry-run        parse + echo config only

Multiple YAML files run as sequential cases (ref: main.c:308-331).
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, Tuple

from .core.info import system_info, library_banner
from .core.errors import HypredrvError
from .config.help import help_text


def _print_banner():
    now = time.strftime("%Y-%m-%d %H:%M:%S")
    print(f"Date and time: {now}\n")
    print(f"Using {library_banner()}\n")
    import jax

    dev = jax.devices()[0]
    print(f"Running on {jax.device_count()} device(s) "
          f"[{dev.platform}: {dev.device_kind}]")


def parse_argv(argv: List[str]):
    """Parse CLI arguments (hand-rolled to keep the reference grammar:
    ``-a path value`` pairs appear after or before the YAML filename)."""
    configs: List[str] = []
    overrides: List[Tuple[str, str]] = []
    preset: Optional[str] = None
    want_help: Optional[str] = None
    want_info = False
    dry_run = False
    profile_dir: Optional[str] = None

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("-h", "--help"):
            want_help = ""
            if i + 1 < len(argv) and not argv[i + 1].startswith("-") \
                    and not argv[i + 1].endswith((".yml", ".yaml")):
                want_help = argv[i + 1]
                i += 1
        elif arg in ("-i", "--info"):
            want_info = True
        elif arg in ("-a", "--args"):
            if i + 2 >= len(argv) + 1:
                raise SystemExit("-a requires PATH VALUE")
            overrides.append((argv[i + 1], argv[i + 2]))
            i += 2
        elif arg in ("-p", "--prec-preset"):
            preset = argv[i + 1]
            i += 1
        elif arg in ("-n", "--dry-run"):
            dry_run = True
        elif arg == "--profile":
            if i + 1 >= len(argv):
                raise SystemExit("--profile requires DIR")
            profile_dir = argv[i + 1]
            i += 1
        elif arg.startswith("-"):
            raise SystemExit(f"unknown option {arg}")
        else:
            configs.append(arg)
        i += 1
    return (configs, overrides, preset, want_help, want_info, dry_run,
            profile_dir)


def run_one_config(path: str, overrides=None, preset=None, dry_run=False,
                   collect=None) -> int:
    """ref: RunOneConfig (main.c:231).

    ``collect``: optional list; when given, the driver object is appended
    so callers (golden-output tests) can inspect ``drv.stats`` entries
    (the Stats object survives destroy)."""
    from .api import HypreDrive

    drv = HypreDrive()
    if collect is not None:
        collect.append(drv)
    try:
        args = drv.input_args_parse(path, overrides, preset)
        if args.general.print_config_params:
            # The reference echoes the effective config between bars when
            # print_config_params is on — the driver default (ref:
            # args.c:87 default 1; :113 off in library mode; :1568 echo).
            from .config.yamlparse import echo_tree

            bar = "-" * 84
            print(bar)
            print(echo_tree(args.raw_tree))
            print(bar)
        if dry_run:
            return 0

        num_systems = max(1, args.linear_system.num_systems)
        if args.linear_system.init_suffix >= 0 and args.linear_system.last_suffix >= 0:
            num_systems = (args.linear_system.last_suffix
                           - args.linear_system.init_suffix + 1)
        if args.linear_system.sequence_filename:
            from .io.lsseq import read_summary

            num_systems = read_summary(
                args.linear_system.sequence_filename).num_systems

        # Solve loops: systems × precon variants × repetitions
        # (ref: RunSolveLoops, main.c:175-229).
        for k in range(num_systems):
            system = drv.linear_system_build()
            bar = "=" * 84
            print(bar)
            print(f"Solving linear system #{drv.current_system_index} with "
                  f"{system.num_rows} rows and {system.nnz} nonzeros...")
            print(bar)
            if args.linear_system.eigspec.enable:
                from .linsys.eigspec import compute_eigenspectrum

                eig_precon = None
                if args.linear_system.eigspec.preconditioned:
                    # spectrum of M^-1 A needs a set-up preconditioner
                    # (ref: eigspec.c precon-apply callback)
                    drv.precon_create()
                    drv.precon.setup(system)
                    eig_precon = drv.precon
                compute_eigenspectrum(system, args.linear_system.eigspec,
                                      precon=eig_precon)
                if eig_precon is not None:
                    drv.precon_destroy()
            for v in range(args.num_precon_variants):
                if args.num_precon_variants > 1:
                    drv.set_precon_variant(v)
                reps = max(1, args.general.num_repetitions)
                warmups = 1 if args.general.warmup else 0
                for rep in range(warmups + reps):
                    is_warmup = rep < warmups
                    if not is_warmup:
                        drv.annotate_begin("Run", rep - warmups)
                    drv.reset_initial_guess()
                    drv.precon_create()
                    drv.linear_solver_create()
                    drv.linear_solver_setup()
                    drv.linear_solver_apply()
                    drv.precon_destroy()
                    drv.linear_solver_destroy()
                    if not is_warmup:
                        drv.annotate_end("Run", rep - warmups)
        if args.general.statistics:
            drv.stats_print()
        return 0
    finally:
        drv.destroy()


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        (configs, overrides, preset, want_help, want_info, dry_run,
         profile_dir) = parse_argv(argv)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 2

    if want_help is not None:
        print(help_text(want_help or None))
        return 0
    if want_info:
        print(system_info())
        if not configs:
            return 0
    if not configs:
        print("usage: hypredrive-tpu [-h [topic]] [-i] [-a PATH VALUE]... "
              "[-p PRESET] input.yml ...", file=sys.stderr)
        return 2

    _print_banner()
    import contextlib

    prof_ctx = contextlib.nullcontext()
    if profile_dir:
        # capture a Perfetto/TensorBoard trace of the whole run; the
        # stats annotator's TraceAnnotation spans + the amg_L* named
        # scopes give the per-phase/per-level breakdown; summarize with
        # scripts/analyze_caliper.py DIR (the Caliper-report analogue,
        # ref: include/internal/stats.h:47-80)
        import jax

        prof_ctx = jax.profiler.trace(profile_dir)
    status = 0
    with prof_ctx:
        for path in configs:
            try:
                status |= run_one_config(path, list(overrides), preset,
                                         dry_run)
            except HypredrvError as exc:
                print(f"ERROR: {exc}", file=sys.stderr)
                status = 1
    now = time.strftime("%Y-%m-%d %H:%M:%S")
    print(f"\nDate and time: {now}")
    print("hypredrive-tpu done!")
    return status


if __name__ == "__main__":
    sys.exit(main())
