"""C API shim test: compile and run the embedded-interpreter example.

Mirrors the reference's language-interface test tier (ref:
interfaces/cpp/tests, interfaces/fortran/tests — each binding runs a
small lifecycle + solve + failure-path program).
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
LIB = os.path.join(NATIVE, "libhypredrv_tpu.so")


@pytest.mark.skipif(shutil.which("gcc") is None, reason="no C compiler")
def test_c_example_lifecycle(tmp_path):
    if not os.path.exists(LIB):
        r = subprocess.run(["make", "-C", NATIVE, "libhypredrv_tpu.so"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"cannot build C shim: {r.stderr[-400:]}")

    exe = str(tmp_path / "ex_c")
    r = subprocess.run(
        ["gcc", os.path.join(REPO, "interfaces", "c", "example_laplacian.c"),
         "-L" + NATIVE, "-lhypredrv_tpu", "-I" + os.path.join(NATIVE, "include"),
         "-o", exe], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr

    env = dict(os.environ)
    env["LD_LIBRARY_PATH"] = NATIVE + ":/usr/local/lib:" + \
        env.get("LD_LIBRARY_PATH", "")
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([exe], capture_output=True, text=True, env=env,
                       timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASSED" in r.stdout
    assert "bad-config rc=" in r.stdout  # typed failure path exercised


def _c_api_names():
    import re

    hdr = open(os.path.join(NATIVE, "include", "HYPREDRV_tpu.h")).read()
    return set(re.findall(r"\bHYPREDRV_[A-Za-z0-9_]+(?=\s*\()", hdr))


def test_c_header_covers_reference_api():
    """Every exported reference verb exists in the C header
    (ref contract: include/HYPREDRV.h 79 HYPREDRV_EXPORT_SYMBOL fns;
    names checked modulo the MPI-comm params this runtime drops)."""
    ref_expected = {
        # lifecycle / error / info (HYPREDRV.h:112-358)
        "HYPREDRV_Initialize", "HYPREDRV_Finalize", "HYPREDRV_Create",
        "HYPREDRV_Destroy", "HYPREDRV_ErrorCodeDescribe",
        "HYPREDRV_ErrorCodeClear", "HYPREDRV_ErrorInvalidValue",
        "HYPREDRV_SafeCallHandleError", "HYPREDRV_PrintLibInfo",
        "HYPREDRV_PrintSystemInfo", "HYPREDRV_PrintExitInfo",
        # config (:391-641)
        "HYPREDRV_InputArgsParse", "HYPREDRV_SetLibraryMode",
        "HYPREDRV_ObjectSetName", "HYPREDRV_InputArgsGetNumLinearSystems",
        "HYPREDRV_InputArgsGetNumPreconVariants",
        "HYPREDRV_InputArgsGetNumRepetitions", "HYPREDRV_InputArgsGetWarmup",
        "HYPREDRV_InputArgsSetPreconVariant",
        "HYPREDRV_InputArgsSetPreconPreset",
        "HYPREDRV_InputArgsSetSolverPreset",
        "HYPREDRV_PreconPresetRegister", "HYPREDRV_SolverPresetRegister",
        # linear system (:669-1335)
        "HYPREDRV_LinearSystemBuild", "HYPREDRV_LinearSystemReadMatrix",
        "HYPREDRV_LinearSystemSetMatrix",
        "HYPREDRV_LinearSystemSetMatrixFromCSR",
        "HYPREDRV_LinearSystemSetPrecMatrix", "HYPREDRV_LinearSystemSetRHS",
        "HYPREDRV_LinearSystemSetRHSFromArray",
        "HYPREDRV_LinearSystemSetInitialGuess",
        "HYPREDRV_LinearSystemSetSolution",
        "HYPREDRV_LinearSystemSetReferenceSolution",
        "HYPREDRV_LinearSystemResetInitialGuess",
        "HYPREDRV_LinearSystemSetNearNullSpace",
        "HYPREDRV_LinearSystemSetNullSpace",
        "HYPREDRV_LinearSystemSetDiscreteGradient",
        "HYPREDRV_LinearSystemSetDiscreteCurl",
        "HYPREDRV_LinearSystemSetCoordinates",
        "HYPREDRV_LinearSystemSetDofmap",
        "HYPREDRV_LinearSystemSetInterleavedDofmap",
        "HYPREDRV_LinearSystemSetContiguousDofmap",
        "HYPREDRV_LinearSystemReadDofmap", "HYPREDRV_LinearSystemPrint",
        "HYPREDRV_LinearSystemPrintDofmap",
        "HYPREDRV_LinearSystemComputeEigenspectrum",
        # solution getters (:1369-1518)
        "HYPREDRV_LinearSystemGetSolutionLength",
        "HYPREDRV_LinearSystemGetSolutionNorm",
        "HYPREDRV_LinearSystemGetSolutionValues",
        "HYPREDRV_LinearSystemGetRHSValues", "HYPREDRV_LinearSystemGetMatrix",
        "HYPREDRV_LinearSystemGetRHS", "HYPREDRV_LinearSystemGetSolution",
        # state vectors (:1554-1693)
        "HYPREDRV_StateVectorSet", "HYPREDRV_StateVectorGetValues",
        "HYPREDRV_StateVectorCopy", "HYPREDRV_StateVectorUpdateAll",
        "HYPREDRV_StateVectorApplyCorrection",
        # solve lifecycle (:1719-1905)
        "HYPREDRV_PreconCreate", "HYPREDRV_PreconSetup",
        "HYPREDRV_PreconApply", "HYPREDRV_LinearSolverCreate",
        "HYPREDRV_LinearSolverSetup", "HYPREDRV_LinearSolverApply",
        "HYPREDRV_PreconDestroy", "HYPREDRV_LinearSolverDestroy",
        # stats (:1932-2262)
        "HYPREDRV_StatsPrint", "HYPREDRV_AnnotateBegin",
        "HYPREDRV_AnnotateEnd", "HYPREDRV_AnnotateLevelBegin",
        "HYPREDRV_AnnotateLevelEnd", "HYPREDRV_StatsLevelPrint",
        "HYPREDRV_StatsLevelGetCount", "HYPREDRV_StatsLevelGetEntry",
        # solver getters (:2126-2208)
        "HYPREDRV_LinearSolverGetNumIterations",
        "HYPREDRV_LinearSolverGetNumIter",
        "HYPREDRV_LinearSolverGetConverged",
        "HYPREDRV_LinearSolverGetSetupTime",
        "HYPREDRV_LinearSolverGetSolveTime",
        "HYPREDRV_LinearSolverGetFinalRelativeResidualNorm",
    }
    have = _c_api_names()
    missing = ref_expected - have
    assert not missing, f"C header missing: {sorted(missing)}"


def test_cpp_header_covers_c_api():
    """Every C verb is reachable through the C++ RAII binding (analogue
    of interfaces/cpp/tests/check_api_coverage.cmake)."""
    hpp = open(os.path.join(REPO, "interfaces", "cpp", "include",
                            "hypredrive_tpu.hpp")).read()
    for name in sorted(_c_api_names()):
        assert name in hpp, f"C++ header does not wrap {name}"


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")
def test_cpp_header_compiles(tmp_path):
    """The RAII header compiles standalone (no linking needed for the
    syntax check)."""
    src = tmp_path / "probe.cpp"
    src.write_text(
        '#include "hypredrive_tpu.hpp"\n'
        "int main() { return 0; }\n")
    r = subprocess.run(
        ["g++", "-std=c++17", "-fsyntax-only",
         "-I" + os.path.join(REPO, "interfaces", "cpp", "include"),
         "-I" + os.path.join(NATIVE, "include"), str(src)],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_capi_extended_surface_via_ctypes():
    """Exercise the newly added C verbs in-process through ctypes (the
    shim embeds CPython; running inside pytest's interpreter just
    forwards to the already-live runtime)."""
    import ctypes

    if not os.path.exists(LIB):
        r = subprocess.run(["make", "-C", NATIVE, "libhypredrv_tpu.so"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"cannot build C shim: {r.stderr[-400:]}")
    lib = ctypes.CDLL(LIB)
    assert lib.HYPREDRV_Initialize() == 0
    h = ctypes.c_int64()
    assert lib.HYPREDRV_Create(ctypes.byref(h)) == 0

    yaml = (b"general: {statistics: off}\n"
            b"linear_system:\n"
            b"  generate: {kind: laplacian_7pt, nx: 6}\n"
            b"  rhs_mode: ones\n"
            b"solver: pcg\npreconditioner: amg\n")
    assert lib.HYPREDRV_SetLibraryMode(h) == 0
    assert lib.HYPREDRV_InputArgsParse(h, yaml) == 0
    assert lib.HYPREDRV_ObjectSetName(h, b"ctest") == 0

    out32 = ctypes.c_int32()
    assert lib.HYPREDRV_InputArgsGetNumRepetitions(h, ctypes.byref(out32)) == 0
    assert out32.value == 1
    assert lib.HYPREDRV_InputArgsGetWarmup(h, ctypes.byref(out32)) == 0
    assert out32.value == 0

    assert lib.HYPREDRV_LinearSystemBuild(h) == 0
    assert lib.HYPREDRV_LinearSystemSetInterleavedDofmap(h, 2) == 0
    assert lib.HYPREDRV_PreconCreate(h) == 0
    assert lib.HYPREDRV_PreconSetup(h) == 0

    n = 216
    r = (ctypes.c_double * n)(*([1.0] * n))
    z = (ctypes.c_double * n)()
    assert lib.HYPREDRV_PreconApply(h, n, r, z) == 0
    assert any(abs(v) > 0 for v in z)

    assert lib.HYPREDRV_LinearSolverCreate(h) == 0
    assert lib.HYPREDRV_LinearSolverSetup(h) == 0
    assert lib.HYPREDRV_LinearSolverApply(h) == 0

    out64 = ctypes.c_int64()
    assert lib.HYPREDRV_LinearSystemGetSolutionLength(h, ctypes.byref(out64)) == 0
    assert out64.value == n
    norm = ctypes.c_double()
    assert lib.HYPREDRV_LinearSystemGetSolutionNorm(h, ctypes.byref(norm)) == 0
    assert norm.value > 0
    b = (ctypes.c_double * n)()
    assert lib.HYPREDRV_LinearSystemGetRHSValues(h, n, b) == 0
    assert b[0] == 1.0
    conv = ctypes.c_int32()
    assert lib.HYPREDRV_LinearSolverGetConverged(h, ctypes.byref(conv)) == 0
    assert conv.value == 1
    t = ctypes.c_double()
    assert lib.HYPREDRV_LinearSolverGetSetupTime(h, ctypes.byref(t)) == 0
    assert lib.HYPREDRV_LinearSolverGetSolveTime(h, ctypes.byref(t)) == 0

    # state vectors
    sv = (ctypes.c_double * n)(*([2.0] * n))
    sv2 = (ctypes.c_double * n)()
    vecs = (ctypes.POINTER(ctypes.c_double) * 2)(
        ctypes.cast(sv, ctypes.POINTER(ctypes.c_double)),
        ctypes.cast(sv2, ctypes.POINTER(ctypes.c_double)))
    assert lib.HYPREDRV_StateVectorSet(h, 2, n, vecs) == 0
    assert lib.HYPREDRV_StateVectorCopy(h, 0, 1) == 0
    got = (ctypes.c_double * n)()
    assert lib.HYPREDRV_StateVectorGetValues(h, 1, n, got) == 0
    assert got[0] == 2.0
    assert lib.HYPREDRV_StateVectorUpdateAll(h) == 0
    assert lib.HYPREDRV_StateVectorApplyCorrection(h, 0) == 0

    # annotations + stats levels
    assert lib.HYPREDRV_AnnotateLevelBegin(h, b"timestep", 0) == 0
    assert lib.HYPREDRV_AnnotateLevelEnd(h, b"timestep", 0) == 0
    cnt = ctypes.c_int32()
    assert lib.HYPREDRV_StatsLevelGetCount(h, b"timestep", ctypes.byref(cnt)) == 0
    assert cnt.value >= 1
    assert lib.HYPREDRV_StatsLevelGetEntry(h, b"timestep", 0,
                                           ctypes.byref(t)) == 0

    # presets round-trip
    assert lib.HYPREDRV_PreconPresetRegister(b"ctest_pre",
                                             b"preconditioner: jacobi\n") == 0
    assert lib.HYPREDRV_InputArgsSetPreconPreset(h, b"ctest_pre") == 0

    # error paths
    lib.HYPREDRV_ErrorCodeDescribe.restype = ctypes.c_char_p
    assert lib.HYPREDRV_ErrorCodeDescribe(0) == b"success"
    assert lib.HYPREDRV_ErrorInvalidValue() != 0
    bad = ctypes.c_int64(991234)
    assert lib.HYPREDRV_LinearSystemBuild(bad) != 0
    assert lib.HYPREDRV_ErrorCodeClear() == 0

    assert lib.HYPREDRV_Destroy(ctypes.byref(h)) == 0


def test_matlab_mex_lifecycle(tmp_path):
    """Compile and EXECUTE the MATLAB MEX entry point through the mock
    MEX API (interfaces/matlab-octave/tests/mock_mex) — the same one-shot
    CSC->CSR solve the reference's hypredrive_mex.c performs
    (ref: interfaces/matlab-octave/src/hypredrive_mex.c:9-17)."""
    if not os.path.exists(LIB):
        pytest.skip("C shim not built")
    mex_dir = os.path.join(REPO, "interfaces", "matlab-octave")
    exe = str(tmp_path / "mex_test")
    r = subprocess.run(
        ["gcc", "-std=c11",
         "-I", os.path.join(mex_dir, "tests", "mock_mex"),
         "-I", os.path.join(NATIVE, "include"),
         os.path.join(mex_dir, "src", "hypredrive_tpu_mex.c"),
         os.path.join(mex_dir, "tests", "mex_driver.c"),
         "-L" + NATIVE, "-lhypredrv_tpu", "-o", exe],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    env = dict(os.environ)
    env["LD_LIBRARY_PATH"] = NATIVE + ":/usr/local/lib:" + \
        env.get("LD_LIBRARY_PATH", "")
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([exe], capture_output=True, text=True, env=env,
                       timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "mex solve max residual" in r.stdout


def test_julia_binding_symbols_resolve():
    """Every ccall'd symbol in the Julia module exists in the built C
    shim (no Julia runtime in the image, so symbol-level coverage is the
    CI check — ref binding: interfaces/julia/src/HypreDrive.jl:4-10)."""
    import ctypes
    import re

    if not os.path.exists(LIB):
        pytest.skip("C shim not built")
    src = open(os.path.join(REPO, "interfaces", "julia", "src",
                            "HypreDriveTPU.jl")).read()
    syms = set(re.findall(r"ccall\(\(:([A-Za-z0-9_]+)", src))
    assert len(syms) >= 14, syms
    lib = ctypes.CDLL(LIB)
    for s in sorted(syms):
        assert hasattr(lib, s), f"missing symbol {s}"


def test_fortran_interface_names_match_c_header():
    """Syntax-level CI check for the Fortran module (no gfortran in the
    image): every BIND(C, name=...) target must exist in the C header,
    and the module must parse as fixed structure (interface blocks
    balanced)."""
    import re

    f90 = open(os.path.join(REPO, "interfaces", "fortran", "src",
                            "hypredrive_tpu.f90")).read()
    header = open(os.path.join(NATIVE, "include", "HYPREDRV_tpu.h")).read()
    c_names = set(re.findall(r"\b(HYPREDRV_[A-Za-z0-9_]+)\s*\(", header))
    bound = re.findall(r'bind\s*\(\s*c\s*,\s*name\s*=\s*"([^"]+)"',
                       f90, flags=re.IGNORECASE)
    assert len(bound) >= 70, "suspiciously few bound procedures"
    for name in bound:
        assert name in c_names, f"Fortran binds unknown symbol {name}"
    # structural sanity: balanced interface blocks and a closed module
    opens = len(re.findall(r"^\s*interface\b", f90,
                           flags=re.IGNORECASE | re.MULTILINE))
    closes = len(re.findall(r"^\s*end\s+interface\b", f90,
                            flags=re.IGNORECASE | re.MULTILINE))
    assert opens == closes and opens >= 1
    assert re.search(r"end\s+module", f90, flags=re.IGNORECASE)
    # generated section is current (scripts/gen_fortran_bindings.py)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "gen_fortran_bindings.py"),
         "--check"], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
