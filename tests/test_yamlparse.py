"""The in-repo YAML-subset parser (PyYAML is not a dependency)."""

import math
import os
import subprocess
import sys
import textwrap

import pytest

from hypredrive_tpu.config.yamlparse import (apply_overrides, load_yaml_file,
                                             load_yaml_text, parse_yaml)
from hypredrive_tpu.core.errors import ConfigError, ErrorCode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_yaml11_booleans_and_null():
    t = load_yaml_text("a: on\nb: Off\nc: yes\nd: NO\ne: true\nf: False\n"
                       "g: ~\nh: null\ni:\n")
    assert t == {"a": True, "b": False, "c": True, "d": False, "e": True,
                 "f": False, "g": None, "h": None, "i": None}


def test_numbers_resolve_like_yaml11():
    t = load_yaml_text("i: 42\nn: -1\nh: 0x1f\no: 017\nu: 1_000\n"
                       "f: 1.0e-6\ng: .5\ninf: .inf\ns: 1e-3\nk: 0\n")
    assert t["i"] == 42 and t["n"] == -1 and t["h"] == 31
    assert t["o"] == 15 and t["u"] == 1000 and t["k"] == 0
    assert t["f"] == 1.0e-6 and t["g"] == 0.5 and math.isinf(t["inf"])
    assert t["s"] == "1e-3"              # YAML 1.1 floats carry a dot


def test_flow_collections_and_quotes():
    t = load_yaml_text(textwrap.dedent("""\
        a: [1, 2, 'x y', "q\\tz"]
        b: {kind: laplacian_7pt, nx: 10, sub: {c: [on, ~]}}
        c: [1,
            2]
        d: 'it''s'
        e: []
    """))
    assert t["a"] == [1, 2, "x y", "q\tz"]
    assert t["b"] == {"kind": "laplacian_7pt", "nx": 10,
                      "sub": {"c": [True, None]}}
    assert t["c"] == [1, 2] and t["d"] == "it's" and t["e"] == []


def test_nested_maps_sequences_and_comments():
    t = load_yaml_text(textwrap.dedent("""\
        # leading comment
        preconditioner:
          mgr:   # trailing comment
            level:
              0:
                f_dofs: [2]      # int keys, as configs use them
              1:
                g_relaxation: 'a # not a comment'
          amg:
            - coarsening: {type: hmis}
              relaxation:
                down_type: 16
            - coarsening:
                type: pmis
        solver:
        - pcg
        - gmres
    """))
    lvl = t["preconditioner"]["mgr"]["level"]
    assert lvl[0]["f_dofs"] == [2]
    assert lvl[1]["g_relaxation"] == "a # not a comment"
    amg = t["preconditioner"]["amg"]
    assert amg[0] == {"coarsening": {"type": "hmis"},
                      "relaxation": {"down_type": 16}}
    assert amg[1] == {"coarsening": {"type": "pmis"}}
    assert t["solver"] == ["pcg", "gmres"]


def test_duplicate_key_reports_line():
    with pytest.raises(ConfigError, match="line 3: duplicate key 'a'") as e:
        load_yaml_text("a: 1\nb:\na: 2\n")
    assert e.value.code == ErrorCode.YAML
    with pytest.raises(ConfigError, match="duplicate"):
        load_yaml_text("m: {x: 1, x: 2}\n")


@pytest.mark.parametrize("text", [
    "solver: [unclosed",
    "a:\n\t  tabs: everywhere",
    ":\n::\n:::",
    "a: b: c",
    "a: &anchor 1",
    "a: |\n  block\n",
    "a: 1\n---\nb: 2\n",
    "a: 1\n  b: 2\n",
    "a: 'open",
    "a: \"bad \\q escape\"",
    "a: 1\x00",
])
def test_malformed_yaml_raises_typed(text):
    with pytest.raises(ConfigError) as e:
        load_yaml_text(text)
    assert e.value.code == ErrorCode.YAML


def test_include_merge_and_sibling_override(tmp_path):
    (tmp_path / "inner.yml").write_text("pcg:\n  max_iter: 7\n  "
                                        "relative_tol: 1.0e-8\n")
    main = tmp_path / "main.yml"
    main.write_text("solver:\n  include: inner.yml\n  pcg:\n"
                    "    max_iter: 9\n")
    t = load_yaml_file(str(main))
    assert t["solver"]["pcg"] == {"max_iter": 9, "relative_tol": 1.0e-8}


def test_cli_overrides_parse_values():
    t = load_yaml_text("solver: pcg\n")
    apply_overrides(t, [("solver:pcg:max_iter", "50"),
                        ("general:warmup", "on"),
                        ("linear_system:print_system:stages", "[apply]"),
                        ("general:name", "x: y: z")])
    assert t["solver"]["pcg"]["max_iter"] == 50
    assert t["general"]["warmup"] is True
    assert t["linear_system"]["print_system"]["stages"] == ["apply"]
    assert t["general"]["name"] == "x: y: z"       # unparsable → raw


def test_scalar_documents():
    assert parse_yaml("") is None
    assert parse_yaml("gmres") == "gmres"
    assert parse_yaml("[1, 2]") == [1, 2]
    with pytest.raises(ConfigError, match="top-level YAML must be a mapping"):
        load_yaml_text("- a\n- b\n")


def test_package_parses_ex1_without_pyyaml():
    """The config path needs no PyYAML: block it and parse ex1.yml."""
    code = textwrap.dedent("""\
        import sys
        sys.modules["yaml"] = None          # any `import yaml` now fails
        from hypredrive_tpu.config.parse import parse_input
        args = parse_input("examples/ex1.yml")
        assert args.solver.method == "pcg", args.solver.method
        assert args.preconditioner.method == "amg"
        assert "yaml" not in {m for m in sys.modules if sys.modules[m]}
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("OK")
