"""Device-matrix layouts (DIA, ELL, ELL+COO tail, dense) against scipy's
CSR, the layout rule, and the coarsest-level inverse."""

import numpy as np
import pytest
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from hypredrive_tpu.ops import device_matrix as dm
from hypredrive_tpu.ops.csr import laplacian_3d_7pt
from hypredrive_tpu.ops.device_matrix import EllMatrix

# relative error bound of one SpMV against scipy's float64 CSR matvec
TOL = {np.float64: 1e-12, np.float32: 1e-5}

SHAPES = [(2000, 2000, 0.005), (900, 500, 0.02), (500, 900, 0.02),
          (1024, 1024, 0.01), (17, 23, 0.3)]


def _rand(m, n, density, seed=0):
    A = sp.random(m, n, density=density, random_state=seed, format="csr")
    A.data[:] = np.random.default_rng(seed).standard_normal(len(A.data))
    return A


def _build(A, layout, dtype):
    if layout == "ell+tail":
        # narrow ELL so the long rows spill into the COO tail
        return EllMatrix.from_csr(A, dtype=dtype, use_dia=False, k_cap=2,
                                  layout="ell")
    if layout == "ell":
        return EllMatrix.from_csr(A, dtype=dtype, use_dia=False,
                                  layout="ell")
    if layout == "dia":
        return EllMatrix.from_csr(A, dtype=dtype, layout="ell")
    return EllMatrix.from_csr(A, dtype=dtype, layout="dense")


def _relerr(E, A, x):
    y = np.asarray(E.matvec(jnp.asarray(x, E.dtype)), np.float64)
    ref = A @ x.astype(E.dtype).astype(np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("layout", ["ell", "ell+tail", "dense"])
@pytest.mark.parametrize("m,n,density", SHAPES)
def test_layout_matvec_matches_scipy(m, n, density, layout, dtype):
    A = _rand(m, n, density)
    E = _build(A, layout, dtype)
    if layout == "ell+tail" and A.getnnz(axis=1).max() > 2:
        assert E.has_tail
    if layout == "dense":
        assert E.dense is not None
    x = np.random.default_rng(1).standard_normal(n)
    assert _relerr(E, A, x) < TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dia_layout_matches_scipy(dtype):
    """The 7-point Laplacian goes fully to DIA (no ELL, no tail)."""
    A = laplacian_3d_7pt(12)
    E = EllMatrix.from_csr(A, dtype=dtype)
    assert len(E.dia_offsets) == 7 and not E.has_ell and not E.has_tail
    x = np.random.default_rng(2).standard_normal(A.shape[0])
    assert _relerr(E, A, x) < TOL[dtype]


@pytest.mark.parametrize("layout", ["dia", "ell+tail", "dense"])
def test_layout_kernels_round_trip(layout):
    """diagonal / row_l1_norms / scale / to_csr agree with scipy."""
    rng = np.random.default_rng(3)
    A = sp.csr_matrix(_rand(300, 300, 0.03, seed=4) + sp.diags(
        rng.uniform(1, 2, 300)) + sp.diags(np.ones(299), 1))
    E = _build(A, layout, np.float64)
    np.testing.assert_allclose(np.asarray(E.diagonal()), A.diagonal(),
                               rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(E.row_l1_norms()),
        np.asarray(abs(A).sum(axis=1)).ravel(), rtol=1e-12)
    sl, sr = rng.uniform(0.5, 2, 300), rng.uniform(0.5, 2, 300)
    Es = E.scale(jnp.asarray(sl), jnp.asarray(sr))
    As = sp.csr_matrix(sp.diags(sl) @ A @ sp.diags(sr))
    x = rng.standard_normal(300)
    assert _relerr(Es, As, x) < 1e-12
    assert abs(E.to_csr() - A).max() < 1e-14


def test_layout_rule_dense_on_accelerators_only(monkeypatch):
    """auto: sparse on the CPU backend; on an accelerator backend tiny
    operators go dense, larger ones stay sparse; DENSE_MAX_ELEMENTS=0
    switches the dense layout off."""
    A = sp.csr_matrix(laplacian_3d_7pt(4))            # 64 x 64
    big = sp.csr_matrix(laplacian_3d_7pt(12))         # 1728 x 1728
    assert not dm.dense_layout_default()             # CPU test backend
    assert EllMatrix.from_csr(A).dense is None
    monkeypatch.setattr(dm, "dense_layout_default", lambda: True)
    assert EllMatrix.from_csr(A).dense is not None
    assert EllMatrix.from_csr(big).dense is None
    assert EllMatrix.from_csr(A, layout="ell").dense is None
    monkeypatch.setattr(dm, "DENSE_MAX_ELEMENTS", 0)
    assert EllMatrix.from_csr(A).dense is None


def test_layout_rule_follows_ambient_device():
    with jax.default_device(jax.devices("cpu")[0]):
        assert not dm.dense_layout_default()


def test_coarse_inverse_diagonal_stays_sparse():
    """A level with no strong connections (diagonal operator) keeps its
    inverse as a sparse diagonal; other coarsest operators go dense."""
    from hypredrive_tpu.precon.amg.hierarchy import coarse_inverse

    d = np.linspace(1.0, 3.0, 50)
    d[7] = 0.0                                     # singular: pinv → 0
    inv = coarse_inverse(sp.diags(d), jnp.float64)
    assert isinstance(inv, EllMatrix)
    b = np.arange(50.0)
    ref = np.linalg.pinv(np.diag(d)) @ b
    np.testing.assert_allclose(np.asarray(inv.matvec(jnp.asarray(b))),
                               ref, rtol=1e-14)
    A = laplacian_3d_7pt(3)
    dense = coarse_inverse(A, jnp.float64)
    np.testing.assert_allclose(np.asarray(dense) @ (A @ np.ones(27)),
                               np.ones(27), rtol=1e-10)


def test_amg_on_diagonal_matrix_never_densifies():
    """AMG on a large diagonal operator (an identity-embedded MGR F
    block) solves it exactly without an n x n dense inverse."""
    from hypredrive_tpu.config.sections import AMG_SCHEMA
    from hypredrive_tpu.precon.amg.cycle import amg_apply
    from hypredrive_tpu.precon.amg.hierarchy import setup_hierarchy

    n = 40000                               # dense inverse: 12.8 GB
    d = np.random.default_rng(5).uniform(1.0, 2.0, n)
    st = setup_hierarchy(sp.diags(d).tocsr(), AMG_SCHEMA.defaults(),
                         dtype=jnp.float64)
    assert isinstance(st.coarse_inv, EllMatrix)
    z = np.asarray(amg_apply(st, jnp.ones(n)))
    np.testing.assert_allclose(z, 1.0 / d, rtol=1e-12)


def test_coarse_inverse_on_mesh_matches_dense():
    from hypredrive_tpu.parallel import make_mesh
    from hypredrive_tpu.parallel.dist_matrix import DistEllMatrix, pad_vector
    from hypredrive_tpu.precon.amg.hierarchy import coarse_inverse

    mesh = make_mesh(8)
    d = np.linspace(1.0, 2.0, 61)                    # pads to 64 rows
    inv = coarse_inverse(sp.diags(d), jnp.float64, mesh)
    assert isinstance(inv, DistEllMatrix) and inv.shape == (64, 64)
    b = pad_vector(np.ones(64), 64, mesh)
    z = np.asarray(inv.matvec(b))
    np.testing.assert_allclose(z[:61], 1.0 / d, rtol=1e-14)
    np.testing.assert_allclose(z[61:], 1.0)       # identity pad rows
