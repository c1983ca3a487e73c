"""Native C++ IJ ASCII reader/writer (native/src/ij_io.cpp via ctypes).

The native layer must be bit-faithful with the numpy fallback and reject
the same malformed inputs (ref contract: src/internal/matrix.c
non-finite rejection, window validation).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from hypredrive_tpu.io import ij, native
from hypredrive_tpu.core.errors import HypredrvError


pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native lib unavailable")


@pytest.fixture
def matrix():
    rng = np.random.default_rng(3)
    A = sp.random(40, 40, density=0.1, random_state=3, format="csr")
    A.setdiag(2.0)
    return A.tocsr()


def test_matrix_round_trip(tmp_path, matrix):
    path = str(tmp_path / "A.out")
    ij.write_matrix_ascii(path, matrix, ilower=5)
    A2, ilower = ij.read_matrix_ascii(path)
    assert ilower == 5
    assert np.allclose(A2.toarray(), matrix.toarray())


def test_native_matches_numpy_fallback(tmp_path, matrix):
    path = str(tmp_path / "A.out")
    ij.write_matrix_ascii(path, matrix, ilower=0)
    nat = native.read_matrix_ascii(path)
    assert nat is not None
    rows, cols, vals, il, iu, jl, ju = nat
    data = np.loadtxt(path, skiprows=1, ndmin=2)
    assert np.array_equal(rows, data[:, 0].astype(np.int64))
    assert np.array_equal(cols, data[:, 1].astype(np.int64))
    assert np.allclose(vals, data[:, 2])
    assert (il, iu, jl, ju) == (0, 39, 0, 39)


def test_vector_round_trip(tmp_path):
    v = np.linspace(-3, 9, 57)
    path = str(tmp_path / "b.out")
    ij.write_vector_ascii(path, v, ilower=2)
    v2, ilower = ij.read_vector_ascii(path)
    assert ilower == 2
    assert np.allclose(v2, v)


def test_nonfinite_rejected(tmp_path):
    path = str(tmp_path / "bad.out")
    with open(path, "w") as f:
        f.write("0 1 0 1\n0 0 1.0\n0 1 nan\n")
    with pytest.raises(HypredrvError, match="non-finite"):
        ij.read_matrix_ascii(path)


def test_malformed_entry_rejected(tmp_path):
    path = str(tmp_path / "bad2.out")
    with open(path, "w") as f:
        f.write("0 1 0 1\n0 zz 1.0\n")
    with pytest.raises(HypredrvError):
        ij.read_matrix_ascii(path)


def test_vector_window_violation(tmp_path):
    path = str(tmp_path / "bad3.out")
    with open(path, "w") as f:
        f.write("0 3\n7 1.0\n")
    with pytest.raises(HypredrvError):
        ij.read_vector_ascii(path)


def test_scientific_and_negative(tmp_path):
    path = str(tmp_path / "sci.out")
    with open(path, "w") as f:
        f.write("0 1 0 1\n0 0 -1.5e-3\n1 1 +2E+4\n")
    A, _ = ij.read_matrix_ascii(path)
    assert np.allclose(A.toarray(), [[-1.5e-3, 0], [0, 2e4]])


def _rand_spd(n, seed, density=0.01, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csr")
    A = A + A.T + sp.identity(n) * (abs(A).sum(axis=1).max() + 1.0)
    A = sp.csr_matrix(A, dtype=dtype)
    A.sum_duplicates()
    A.sort_indices()
    return A


def _numpy_strength(A, theta, sabs=False, dof_func=None):
    from hypredrive_tpu.precon.amg import strength as st
    import hypredrive_tpu.io.native as nat
    orig = nat.get_lib
    nat.get_lib = lambda: None        # force the numpy path
    try:
        return st.strength_graph(A, theta=theta, sabs=sabs,
                                 dof_func=dof_func)
    finally:
        nat.get_lib = orig


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("theta,sabs", [(0.25, False), (0.5, True)])
def test_native_strength_matches_numpy(dtype, theta, sabs):
    from hypredrive_tpu.io.native import amg_strength

    A = _rand_spd(400, 7, dtype=dtype)
    nat = amg_strength(A, theta, sabs)
    assert nat is not None, "native library unavailable"
    S_ref = _numpy_strength(A, theta, sabs=sabs)
    s_indptr, s_indices = nat
    assert np.array_equal(s_indptr, S_ref.indptr)
    assert np.array_equal(s_indices, S_ref.indices)


def test_native_strength_dof_func():
    from hypredrive_tpu.io.native import amg_strength

    A = _rand_spd(300, 3)
    df = (np.arange(300) % 3).astype(np.int32)
    nat = amg_strength(A, 0.25, False, df)
    assert nat is not None
    S_ref = _numpy_strength(A, 0.25, dof_func=df)
    assert np.array_equal(nat[0], S_ref.indptr)
    assert np.array_equal(nat[1], S_ref.indices)


def _numpy_pmis(S, seed, boost=None):
    from hypredrive_tpu.precon.amg import coarsen as co
    import hypredrive_tpu.io.native as nat
    orig = nat.get_lib
    nat.get_lib = lambda: None
    try:
        return co.pmis(S, seed=seed, measure_boost=boost)
    finally:
        nat.get_lib = orig


@pytest.mark.parametrize("seed", [0, 1, 1003])
def test_native_pmis_bit_exact(seed):
    from hypredrive_tpu.io.native import amg_pmis
    from hypredrive_tpu.precon.amg.strength import strength_graph

    A = _rand_spd(500, seed + 11, density=0.02)
    S = strength_graph(A, theta=0.25)
    cf_nat = amg_pmis(S.indptr, S.indices, seed)
    assert cf_nat is not None
    cf_ref = _numpy_pmis(S, seed)
    assert np.array_equal(cf_nat, cf_ref)


def test_native_pmis_with_boost():
    from hypredrive_tpu.io.native import amg_pmis
    from hypredrive_tpu.precon.amg.strength import strength_graph

    A = _rand_spd(300, 5, density=0.03)
    S = strength_graph(A, theta=0.25)
    boost = np.linspace(0, 2.0, 300)
    cf_nat = amg_pmis(S.indptr, S.indices, 2, boost)
    cf_ref = _numpy_pmis(S, 2, boost)
    assert np.array_equal(cf_nat, cf_ref)


def _numpy_interp(A, S, cf, **kw):
    from hypredrive_tpu.precon.amg import interp as itp
    import hypredrive_tpu.io.native as nat
    orig = nat.get_lib
    nat.get_lib = lambda: None
    try:
        return itp.extended_i_interpolation(A, S, cf, **kw)
    finally:
        nat.get_lib = orig


@pytest.mark.parametrize("plus_i", [True, False])
@pytest.mark.parametrize("maxnnz", [4, 0])
def test_native_ext_i_interp_matches_numpy(plus_i, maxnnz):
    from hypredrive_tpu.io.native import amg_interp_ext_i
    from hypredrive_tpu.precon.amg.strength import strength_graph
    from hypredrive_tpu.precon.amg.coarsen import pmis

    A = _rand_spd(400, 17, density=0.02)
    S = strength_graph(A, theta=0.25)
    cf = pmis(S, 0)
    P_nat = amg_interp_ext_i(A, S.indptr, S.indices, cf, plus_i, 0.0, maxnnz)
    assert P_nat is not None
    P_ref = _numpy_interp(A, S, cf, plus_i=plus_i, max_nnz_row=maxnnz)
    assert P_nat.shape == P_ref.shape
    # identical untruncated weights (same formula, double accumulation);
    # with top-k truncation tie-breaks may differ, so compare the row
    # sums (preserved by both) and the overwhelming majority of entries
    if maxnnz == 0:
        d = abs(P_nat - P_ref)
        assert d.max() if d.nnz else 0.0 <= 1e-10
    else:
        rs_nat = np.asarray(P_nat.sum(axis=1)).ravel()
        rs_ref = np.asarray(P_ref.sum(axis=1)).ravel()
        np.testing.assert_allclose(rs_nat, rs_ref, rtol=1e-9, atol=1e-12)
        same = (abs(P_nat - P_ref) < 1e-10).sum() if (P_nat - P_ref).nnz \
            else P_nat.nnz
        assert P_nat.nnz == pytest.approx(P_ref.nnz, rel=0.05)


def test_native_rap_matches_scipy():
    from hypredrive_tpu.io.native import amg_rap
    from hypredrive_tpu.precon.amg.strength import strength_graph
    from hypredrive_tpu.precon.amg.coarsen import pmis
    from hypredrive_tpu.precon.amg.interp import extended_i_interpolation

    A = _rand_spd(500, 23, density=0.02)
    S = strength_graph(A, theta=0.25)
    cf = pmis(S, 0)
    P = extended_i_interpolation(A, S, cf)
    Ac_nat = amg_rap(A, sp.csr_matrix(P))
    assert Ac_nat is not None
    Ac_ref = sp.csr_matrix(P.T @ A @ P)
    d = abs(Ac_nat - Ac_ref)
    assert (d.max() if d.nnz else 0.0) < 1e-9


def test_hierarchy_native_vs_numpy_iters():
    """End-to-end: PCG+AMG iteration count identical with and without
    the native setup kernels (the golden-stability guard)."""
    import jax.numpy as jnp
    from hypredrive_tpu.ops.csr import laplacian_3d_7pt
    from hypredrive_tpu.ops.device_matrix import EllMatrix
    from hypredrive_tpu.precon.amg.hierarchy import setup_hierarchy
    from hypredrive_tpu.precon.amg.cycle import amg_apply
    from hypredrive_tpu.solvers.pcg import _pcg_core
    from hypredrive_tpu.config.sections import AMG_SCHEMA
    import hypredrive_tpu.io.native as nat

    A_host = laplacian_3d_7pt(12, dtype=np.float64)
    n = A_host.shape[0]

    def solve_iters():
        A = EllMatrix.from_csr(A_host, dtype=jnp.float64)
        state = setup_hierarchy(A_host, AMG_SCHEMA.defaults(),
                                dtype=jnp.float64)
        out = _pcg_core(lambda v: A.matvec(v),
                        lambda r: amg_apply(state, r),
                        jnp.ones(n, jnp.float64), jnp.zeros(n, jnp.float64),
                        jnp.asarray(1e-8, jnp.float64),
                        jnp.asarray(0.0, jnp.float64), 100, True, 0)
        return int(out[1])

    it_native = solve_iters()
    orig = nat.get_lib
    nat.get_lib = lambda: None
    try:
        it_numpy = solve_iters()
    finally:
        nat.get_lib = orig
    assert abs(it_native - it_numpy) <= 1


# ---------------------------------------------------------------------------
# LZ4 block codec (native/src/ij_io.cpp) + reference blob format
# ---------------------------------------------------------------------------

def test_lz4_roundtrip_and_prefix_format():
    """compress() emits [uint64 size][raw LZ4 block] exactly as the
    reference's hypredrv_compress (ref: src/internal/comp.c:391-497);
    both the native and pure-Python decoders invert it."""
    import struct
    from hypredrive_tpu.io import comp
    import hypredrive_tpu.io.native as nat

    rng = np.random.default_rng(5)
    payloads = [b"", b"x", rng.integers(0, 5, 100000, np.uint8).tobytes(),
                (b"abcd" * 10000)]
    for raw in payloads:
        for codec in (comp.COMP_LZ4, comp.COMP_LZ4HC, comp.COMP_ZLIB):
            c = comp.compress(codec, raw)
            (size,) = struct.unpack_from("<Q", c)
            assert size == len(raw)
            assert comp.decompress(codec, c) == raw
    # decoder cross-check: native encode -> python decode
    raw = (b"hello world " * 5000)
    c = comp.compress(comp.COMP_LZ4, raw)
    assert len(c) < len(raw) // 10        # actually compresses
    orig = nat.get_lib
    nat.get_lib = lambda: None
    try:
        assert comp.decompress(comp.COMP_LZ4, c) == raw
    finally:
        nat.get_lib = orig


def test_lz4_lsseq_container_roundtrip(tmp_path):
    """lsseq containers written with the lz4 codec read back bit-exact
    (the reference writes .lz4.bin containers with the same format)."""
    import scipy.sparse as sp
    from hypredrive_tpu.io import lsseq

    rng = np.random.default_rng(11)
    A = sp.random(60, 60, density=0.1, random_state=rng, format="csr")
    A = sp.csr_matrix(A + sp.identity(60))
    systems = [{"A": A, "b": rng.standard_normal(60)} for _ in range(3)]
    path = str(tmp_path / "seq.lz4.bin")
    lsseq.write_lsseq(path, systems, codec=3)
    r = lsseq.LSSeqFile(path)
    assert r.codec == 3
    A0 = r.read_matrix(0)
    assert abs(A0 - A).max() < 1e-14


# ---------------------------------------------------------------------------
# blosc1 chunk codec (clean-room; ref: src/internal/comp.c:345-385 uses
# c-blosc1 with compressor blosclz, clevel 9, shuffle, typesize 1)
# ---------------------------------------------------------------------------

def _blosc_payloads():
    rng = np.random.default_rng(7)
    return [b"", b"z", b"abab" * 6000,
            rng.integers(0, 4, 70000, np.uint8).tobytes(),
            rng.integers(0, 255, 300000, np.uint8).tobytes(),
            np.arange(50000, dtype=np.float64).tobytes()]


def test_blosc_roundtrip_prefix_format():
    """COMP_BLOSC emits [uint64 size][blosc1 chunk] like every other
    reference codec and inverts exactly."""
    import struct
    from hypredrive_tpu.io import comp

    for raw in _blosc_payloads():
        c = comp.compress(comp.COMP_BLOSC, raw)
        (size,) = struct.unpack_from("<Q", c)
        assert size == len(raw)
        assert comp.decompress(comp.COMP_BLOSC, c) == raw
        # header sanity: version-format byte + our LZ4 inner codec (or
        # memcpyed fallback for incompressible payloads)
        frame = c[8:]
        assert frame[0] == 2
        assert (frame[2] & 0x2) or (frame[2] >> 5) == 1


def test_blosc_blosclz_inner_roundtrip():
    """A chunk whose blocks hold blosclz streams (what the reference's
    c-blosc writes with blosc_set_compressor("blosclz")) decodes; the
    in-repo greedy blosclz encoder validates the decoder against the
    published stream format."""
    from hypredrive_tpu.io import comp

    for raw in _blosc_payloads():
        frame = comp.blosc_compress(raw, inner=comp._BLOSC_CODEC_BLOSCLZ)
        assert comp.blosc_decompress(frame, len(raw)) == raw
        # raw blosclz streams invert too
        if raw:
            enc = comp._blosclz_compress(raw)
            assert comp._blosclz_decompress(enc, len(raw)) == raw


def test_blosc_shuffled_chunk_decodes():
    """Byte-shuffled chunks (typesize > 1, as a stock c-blosc writer
    would produce for typed data) unshuffle on decode."""
    from hypredrive_tpu.io import comp

    data = np.arange(8192, dtype=np.float32).tobytes()
    typesize, blocksize = 4, 4096
    nblocks = len(data) // blocksize
    blobs, bstarts = [], []
    pos = 16 + 4 * nblocks
    for j in range(nblocks):
        chunk = comp._byte_shuffle(
            data[j * blocksize:(j + 1) * blocksize], typesize)
        # typesize 4 <= MAX_SPLITS and blocksize/typesize >= 128 ->
        # split into `typesize` streams, each [i32 csize][payload]
        nsb = blocksize // typesize
        blob = b""
        for k in range(typesize):
            part = chunk[k * nsb:(k + 1) * nsb]
            cz = comp._blosclz_compress(part)
            if len(cz) >= nsb:
                blob += nsb.to_bytes(4, "little", signed=True) + part
            else:
                blob += len(cz).to_bytes(4, "little", signed=True) + cz
        bstarts.append(pos)
        blobs.append(blob)
        pos += len(blob)
    frame = bytes([2, 1, 0x1, typesize]) \
        + len(data).to_bytes(4, "little") \
        + blocksize.to_bytes(4, "little") + pos.to_bytes(4, "little") \
        + b"".join(b.to_bytes(4, "little") for b in bstarts) \
        + b"".join(blobs)
    assert comp.blosc_decompress(frame, len(data)) == data


def test_blosc_lsseq_container_roundtrip(tmp_path):
    """lsseq containers written with the blosc codec read back bit-exact
    (the reference writes .blosc.bin containers; comp.c:105)."""
    import scipy.sparse as sp
    from hypredrive_tpu.io import lsseq

    rng = np.random.default_rng(12)
    A = sp.random(60, 60, density=0.1, random_state=rng, format="csr")
    A = sp.csr_matrix(A + sp.identity(60))
    systems = [{"A": A, "b": rng.standard_normal(60)} for _ in range(2)]
    path = str(tmp_path / "seq.blosc.bin")
    lsseq.write_lsseq(path, systems, codec=5)
    r = lsseq.LSSeqFile(path)
    assert r.codec == 5
    A0 = r.read_matrix(0)
    assert abs(A0 - A).max() < 1e-14


def test_blosc_malformed_chunks_raise():
    from hypredrive_tpu.io import comp
    from hypredrive_tpu.core.errors import HypredrvError

    good = comp.blosc_compress(b"hello world " * 100)
    for bad in (good[:10],                       # truncated header
                good[:16],                       # missing bstarts
                good[:len(good) // 2],           # truncated payload
                bytes([2, 1, 0x4, 1]) + good[4:16]):   # bit-shuffle flag
        try:
            comp.blosc_decompress(bad, 1200)
        except HypredrvError:
            pass
        else:
            raise AssertionError(f"malformed chunk accepted: {bad[:8]!r}")
