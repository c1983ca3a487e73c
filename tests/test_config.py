"""Config front-end tests (reference analogues: tests/test_args.c,
test_yaml.c, test_parser.c, test_presets.c, test_help.c)."""

import textwrap

import pytest

from hypredrive_tpu.config import parse_input, config_from_dict
from hypredrive_tpu.config.parse import parse_tree
from hypredrive_tpu.config.yamlparse import (
    load_yaml_text,
    apply_overrides,
    expand_includes,
    echo_tree,
)
from hypredrive_tpu.config.help import help_text, all_topics
from hypredrive_tpu.core.errors import ConfigError


EX1 = textwrap.dedent("""
    general:
      use_millisec: on
      dev_pool_size: 0.01

    linear_system:
      rhs_filename: data/ps3d10pt7/np1/IJ.out.b
      matrix_filename: data/ps3d10pt7/np1/IJ.out.A

    solver: pcg

    preconditioner: amg
""")


def test_parse_ex1_style():
    args = parse_input(EX1)
    assert args.general.use_millisec is True
    assert args.general.dev_pool_size == 0.01
    assert args.linear_system.matrix_filename.endswith("IJ.out.A")
    assert args.solver.method == "pcg"
    assert args.solver.args.max_iter == 100  # ref default (pcg.c:17)
    assert args.solver.args.relative_tol == 1.0e-6
    assert args.preconditioner.method == "amg"
    # AMG defaults (ref: amg.c:115-200, GPU branch)
    amg = args.preconditioner.args
    assert amg.coarsening.type == 8  # pmis
    assert amg.coarsening.strong_th == 0.25
    assert amg.coarsening.max_levels == 25
    assert amg.interpolation.prolongation_type == 6  # extended+i
    assert amg.relaxation.down_type == 16  # chebyshev (device default)


def test_solver_nested_map():
    args = parse_input(textwrap.dedent("""
        linear_system: {matrix_filename: A}
        solver:
          pcg:
            relative_tol: 1.0e-9
            max_iter: 500
        preconditioner: none
    """))
    assert args.solver.args.relative_tol == 1e-9
    assert args.solver.args.max_iter == 500


def test_enum_names_and_ints():
    args = parse_input(textwrap.dedent("""
        linear_system: {matrix_filename: A}
        solver: gmres
        preconditioner:
          amg:
            coarsening:
              type: HMIS
            interpolation:
              prolongation_type: "MM-ext+i"
            relaxation:
              down_type: 16
              up_type: l1sym-hgs
    """))
    amg = args.preconditioner.args
    assert amg.coarsening.type == 10        # HMIS, case-insensitive
    assert amg.interpolation.prolongation_type == 17   # mm-ext+i
    assert amg.relaxation.down_type == 16   # raw int accepted (chebyshev)
    assert amg.relaxation.up_type == 89


def test_precon_variants_list():
    """Method key mapping to a list defines variants (ref: examples/ex8.yml)."""
    args = parse_input(textwrap.dedent("""
        linear_system: {matrix_filename: A}
        solver: pcg
        preconditioner:
          amg:
            - coarsening: {strong_th: 0.25}
            - coarsening: {strong_th: 0.5}
            - coarsening: {strong_th: 0.8}
    """))
    assert args.num_precon_variants == 3
    assert args.precon_variants[0].args.coarsening.strong_th == 0.25
    assert args.precon_variants[2].args.coarsening.strong_th == 0.8
    args.set_precon_variant(1)
    assert args.preconditioner.args.coarsening.strong_th == 0.5


def test_precon_mixed_variants():
    args = parse_input(textwrap.dedent("""
        linear_system: {matrix_filename: A}
        solver: gmres
        preconditioner:
          - amg
          - ilu: {type: bj-ilut, droptol: 1e-3}
          - fsai
    """))
    assert [v.method for v in args.precon_variants] == ["amg", "ilu", "fsai"]
    assert args.precon_variants[1].args.type == 1
    assert args.precon_variants[1].args.droptol == 1e-3


def test_preset():
    args = parse_input(textwrap.dedent("""
        linear_system: {matrix_filename: A}
        solver: pcg
        preconditioner:
          preset: elasticity_3d
    """))
    assert args.preconditioner.method == "amg"
    assert args.preconditioner.args.coarsening.num_functions == 3
    assert args.preconditioner.args.coarsening.strong_th == 0.8


def test_unknown_key_error_with_suggestion():
    with pytest.raises(ConfigError) as exc:
        parse_input(textwrap.dedent("""
            linear_system: {matrix_filename: A}
            solver:
              pcg:
                maxiter: 10
            preconditioner: amg
        """))
    msg = str(exc.value)
    assert "solver:pcg" in msg and "max_iter" in msg


def test_invalid_enum_value():
    with pytest.raises(ConfigError) as exc:
        parse_input(textwrap.dedent("""
            linear_system: {matrix_filename: A}
            solver: gmres
            preconditioner:
              amg:
                coarsening: {type: bogus}
        """))
    assert "coarsening:type" in str(exc.value)


def test_missing_required_sections():
    with pytest.raises(ConfigError) as exc:
        parse_input("general: {}\n")
    msg = str(exc.value)
    assert "linear_system" in msg and "solver" in msg and "preconditioner" in msg


def test_overrides():
    tree = load_yaml_text(EX1)
    apply_overrides(tree, [("solver", "gmres"),
                           ("general:num_repetitions", "3")])
    args = parse_tree(tree)
    assert args.solver.method == "gmres"
    assert args.general.num_repetitions == 3


def test_includes(tmp_path):
    (tmp_path / "inner.yml").write_text("pcg:\n  max_iter: 7\n")
    main = tmp_path / "main.yml"
    main.write_text(textwrap.dedent(f"""
        linear_system: {{matrix_filename: A}}
        solver:
          include: inner.yml
        preconditioner: none
    """))
    args = parse_input(str(main))
    assert args.solver.method == "pcg"
    assert args.solver.args.max_iter == 7


def test_include_variants(tmp_path):
    """Multi-file include under a method key = variant sweep
    (ref: examples/ex8-multi-1.yml)."""
    (tmp_path / "v1.yml").write_text("coarsening: {strong_th: 0.1}\n")
    (tmp_path / "v2.yml").write_text("coarsening: {strong_th: 0.9}\n")
    main = tmp_path / "main.yml"
    main.write_text(textwrap.dedent("""
        linear_system: {matrix_filename: A}
        solver: pcg
        preconditioner:
          amg:
            include:
              - v1.yml
              - v2.yml
    """))
    args = parse_input(str(main))
    assert args.num_precon_variants == 2
    assert args.precon_variants[0].args.coarsening.strong_th == 0.1


def test_include_cycle(tmp_path):
    (tmp_path / "a.yml").write_text("include: b.yml\n")
    (tmp_path / "b.yml").write_text("include: a.yml\n")
    with pytest.raises(ConfigError, match="cycle"):
        from hypredrive_tpu.config.yamlparse import load_yaml_file

        load_yaml_file(str(tmp_path / "a.yml"))


def test_duplicate_key_rejected():
    with pytest.raises(ConfigError, match="duplicate"):
        load_yaml_text("a: 1\na: 2\n")


def test_config_from_dict():
    args = config_from_dict({
        "linear_system": {"rhs_mode": "ones"},
        "solver": {"gmres": {"krylov_dim": 50}},
        "preconditioner": {"ilu": {"fill_level": 1}},
    })
    assert args.linear_system.rhs_mode == 1
    assert args.solver.args.krylov_dim == 50
    assert args.preconditioner.args.fill_level == 1


def test_mgr_config():
    args = parse_input(textwrap.dedent("""
        linear_system: {matrix_filename: A}
        solver: gmres
        preconditioner:
          mgr:
            level:
              0:
                f_dofs: [2]
                prolongation_type: jacobi
              1:
                f_dofs: [1]
                g_relaxation: l1-hsgs
                restriction_type: columped
            coarsest_level: amg
    """))
    mgr = args.preconditioner.args
    assert 0 in mgr.level and 1 in mgr.level
    assert mgr.coarsest_level == "amg"


def test_reuse_section():
    args = parse_input(textwrap.dedent("""
        linear_system: {matrix_filename: A}
        solver: gmres
        preconditioner:
          amg: {}
          reuse:
            enabled: on
            policy: adaptive
            guards: {max_reuse_solves: 5}
    """))
    reuse = args.preconditioner.reuse
    assert reuse.enabled is True
    assert reuse.policy == 1
    assert reuse.guards.max_reuse_solves == 5


def test_echo_tree_booleans():
    text = echo_tree({"general": {"use_millisec": True, "warmup": False}})
    assert "use_millisec: on" in text
    assert "warmup: off" in text


def test_help_topics():
    assert "max_iter" in help_text("solver:pcg")
    assert "valid values" in help_text("preconditioner:amg:coarsening:type")
    assert "pmis" in help_text("preconditioner:amg:coarsening:type")
    assert "unknown help topic" in help_text("bogus:topic")
    topics = all_topics()
    assert "solver:pcg:max_iter" in topics
    assert "preconditioner:amg:relaxation:down_type" in topics


def test_scaling_subsection():
    args = parse_input(textwrap.dedent("""
        linear_system: {matrix_filename: A}
        solver:
          gmres: {max_iter: 10}
          scaling:
            enabled: on
            type: dofmap_mag
        preconditioner: none
    """))
    assert args.solver.scaling.enabled is True
    assert args.solver.scaling.type == 1
