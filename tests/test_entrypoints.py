"""Compile-cache helper and the GPU-only entry points (chip_smoke.py,
bench.py, scripts/bench_diag.py), which refuse to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from hypredrive_tpu.core import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # set nothing


def test_compile_cache_default_is_fixed_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run_cpu(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py",
                                    "scripts/bench_diag.py"])
def test_gpu_entry_points_fail_on_cpu(script):
    r = _run_cpu([os.path.join(REPO, script)])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_cpu([str(tmp_path / "chip_smoke.py")], cwd=str(tmp_path))
    assert r.returncode != 0 and '"ok"' not in r.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_env):
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=gpu_env, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
