"""Every device contraction on the solve path states Precision.HIGHEST,
so a float32 dot never runs in a reduced (TF32) mode on a GPU.  Checked
by walking the jaxprs of the applies and solver cores."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from hypredrive_tpu.ops.csr import laplacian_3d_7pt
from hypredrive_tpu.ops.device_matrix import EllMatrix


def _dot_precisions(jaxpr):
    """Precision of every dot_general, recursing into sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            subs = p if isinstance(p, (list, tuple)) else [p]
            for sub in subs:
                sub = getattr(sub, "jaxpr", sub)          # ClosedJaxpr
                if hasattr(sub, "eqns"):
                    out += _dot_precisions(sub)
    return out


def _assert_highest(fn, *args):
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, "no contraction traced"
    highest = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(q == highest for q in p), precs


@pytest.fixture(scope="module")
def amg_state():
    from hypredrive_tpu.config.sections import AMG_SCHEMA
    from hypredrive_tpu.precon.amg.hierarchy import setup_hierarchy

    A = laplacian_3d_7pt(10)
    return A, setup_hierarchy(A, AMG_SCHEMA.defaults(), dtype=jnp.float32)


def test_amg_apply_contractions_highest(amg_state, monkeypatch):
    """Coarse solve and the dense tiny-operator layout (what a GPU picks)."""
    from hypredrive_tpu.config.sections import AMG_SCHEMA
    from hypredrive_tpu.ops import device_matrix as dm
    from hypredrive_tpu.precon.amg.cycle import amg_apply
    from hypredrive_tpu.precon.amg.hierarchy import setup_hierarchy

    A, st = amg_state
    _assert_highest(amg_apply, st, jnp.ones(A.shape[0], jnp.float32))
    monkeypatch.setattr(dm, "dense_layout_default", lambda: True)
    st_dense = setup_hierarchy(A, AMG_SCHEMA.defaults(), dtype=jnp.float32)
    assert st_dense.levels[-1].A.dense is not None
    _assert_highest(amg_apply, st_dense, jnp.ones(A.shape[0], jnp.float32))


@pytest.mark.parametrize("core", ["gmres", "fgmres", "pcg", "bicgstab"])
def test_krylov_core_contractions_highest(core, amg_state):
    from hypredrive_tpu.precon.amg.cycle import amg_apply
    from hypredrive_tpu.solvers.bicgstab import _bicgstab_core
    from hypredrive_tpu.solvers.fgmres import _fgmres_core
    from hypredrive_tpu.solvers.gmres import _gmres_core
    from hypredrive_tpu.solvers.pcg import _pcg_core

    A, st = amg_state
    E = EllMatrix.from_csr(A, dtype=jnp.float32)
    b = jnp.ones(A.shape[0], jnp.float32)
    mv = lambda v: E.matvec(v)
    pc = lambda r: amg_apply(st, r)
    tol, atol = jnp.float32(1e-6), jnp.float32(0.0)
    fn = {
        "gmres": lambda b, x: _gmres_core(mv, pc, b, x, tol, atol,
                                          50, 10, False),
        "fgmres": lambda b, x: _fgmres_core(mv, pc, b, x, tol, atol, 50, 10),
        "pcg": lambda b, x: _pcg_core(mv, pc, b, x, tol, atol, 50, True, 0),
        "bicgstab": lambda b, x: _bicgstab_core(mv, pc, b, x, tol, atol, 50),
    }[core]
    _assert_highest(fn, b, jnp.zeros_like(b))


def test_schwarz_and_dense_component_contractions_highest():
    from hypredrive_tpu.precon.components import apply_component
    from hypredrive_tpu.precon.schwarz import _schwarz_apply

    rng = np.random.default_rng(0)
    inv = jnp.asarray(rng.standard_normal((4, 6, 6)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, 20, (4, 6)), jnp.int32)
    own = jnp.ones((4, 6), bool)
    r = jnp.ones(20, jnp.float32)
    _assert_highest(_schwarz_apply, (inv, idx, own, jnp.float32(1.0)), r)
    dense = jnp.asarray(rng.standard_normal((20, 20)), jnp.float32)
    _assert_highest(lambda s, v: apply_component("dense", s, v), dense, r)
