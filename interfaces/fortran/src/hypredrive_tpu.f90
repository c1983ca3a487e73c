! Fortran ISO-C-binding module for the hypredrive-tpu C API.
!
! Reference counterpart: interfaces/fortran/src/hypredrive.f90 (the
! ISO-C module mirroring every HYPREDRV verb, :6).  Original
! binding over native/include/HYPREDRV_tpu.h: handles are integer(c_int64_t),
! every call returns an integer(c_int32_t) status (0 = success)
! describable with hypredrv_error_describe.
!
! Build (needs a Fortran compiler; not shipped in the dev image):
!   gfortran -c hypredrive_tpu.f90
!   gfortran main.f90 hypredrive_tpu.o -L<repo>/native -lhypredrv_tpu
!
! Strings must be null-terminated by the caller:  trim(s)//c_null_char.

module hypredrive_tpu
  use, intrinsic :: iso_c_binding
  implicit none
  private

  public :: hypredrv_t
  integer, parameter :: hypredrv_t = c_int64_t

  interface

    ! -- lifecycle (ref: HYPREDRV.h:112-289) ------------------------------
    function HYPREDRV_Initialize() bind(c, name="HYPREDRV_Initialize") &
        result(rc)
      import :: c_int32_t
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_Finalize() bind(c, name="HYPREDRV_Finalize") result(rc)
      import :: c_int32_t
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_Create(handle) bind(c, name="HYPREDRV_Create") &
        result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), intent(inout) :: handle
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_Destroy(handle) bind(c, name="HYPREDRV_Destroy") &
        result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), intent(inout) :: handle
      integer(c_int32_t) :: rc
    end function

    ! -- error model -------------------------------------------------------
    function HYPREDRV_ErrorCodeDescribe(code) &
        bind(c, name="HYPREDRV_ErrorCodeDescribe") result(msg)
      import :: c_int32_t, c_ptr
      integer(c_int32_t), value :: code
      type(c_ptr) :: msg
    end function

    function HYPREDRV_ErrorCodeClear() &
        bind(c, name="HYPREDRV_ErrorCodeClear") result(rc)
      import :: c_int32_t
      integer(c_int32_t) :: rc
    end function

    ! -- configuration -----------------------------------------------------
    function HYPREDRV_InputArgsParse(handle, yaml) &
        bind(c, name="HYPREDRV_InputArgsParse") result(rc)
      import :: c_int32_t, c_int64_t, c_char
      integer(c_int64_t), value :: handle
      character(kind=c_char), dimension(*), intent(in) :: yaml
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_SetLibraryMode(handle) &
        bind(c, name="HYPREDRV_SetLibraryMode") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_ObjectSetName(handle, name) &
        bind(c, name="HYPREDRV_ObjectSetName") result(rc)
      import :: c_int32_t, c_int64_t, c_char
      integer(c_int64_t), value :: handle
      character(kind=c_char), dimension(*), intent(in) :: name
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_InputArgsSetPreconVariant(handle, idx) &
        bind(c, name="HYPREDRV_InputArgsSetPreconVariant") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t), value :: idx
      integer(c_int32_t) :: rc
    end function

    ! -- linear system -------------------------------------------------------
    function HYPREDRV_LinearSystemBuild(handle) &
        bind(c, name="HYPREDRV_LinearSystemBuild") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetMatrixFromCSR(handle, nrows, indptr, &
        indices, data) bind(c, name="HYPREDRV_LinearSystemSetMatrixFromCSR") &
        result(rc)
      import :: c_int32_t, c_int64_t, c_double
      integer(c_int64_t), value :: handle, nrows
      integer(c_int64_t), dimension(*), intent(in) :: indptr, indices
      real(c_double), dimension(*), intent(in) :: data
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetRHS(handle, n, values) &
        bind(c, name="HYPREDRV_LinearSystemSetRHS") result(rc)
      import :: c_int32_t, c_int64_t, c_double
      integer(c_int64_t), value :: handle, n
      real(c_double), dimension(*), intent(in) :: values
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetInitialGuess(handle, n, values) &
        bind(c, name="HYPREDRV_LinearSystemSetInitialGuess") result(rc)
      import :: c_int32_t, c_int64_t, c_double
      integer(c_int64_t), value :: handle, n
      real(c_double), dimension(*), intent(in) :: values
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemResetInitialGuess(handle) &
        bind(c, name="HYPREDRV_LinearSystemResetInitialGuess") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetDofmap(handle, n, labels) &
        bind(c, name="HYPREDRV_LinearSystemSetDofmap") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle, n
      integer(c_int64_t), dimension(*), intent(in) :: labels
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetInterleavedDofmap(handle, nfunc) &
        bind(c, name="HYPREDRV_LinearSystemSetInterleavedDofmap") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t), value :: nfunc
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemGetSolutionValues(handle, n, out) &
        bind(c, name="HYPREDRV_LinearSystemGetSolutionValues") result(rc)
      import :: c_int32_t, c_int64_t, c_double
      integer(c_int64_t), value :: handle, n
      real(c_double), dimension(*), intent(out) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemGetSolutionNorm(handle, out) &
        bind(c, name="HYPREDRV_LinearSystemGetSolutionNorm") result(rc)
      import :: c_int32_t, c_int64_t, c_double
      integer(c_int64_t), value :: handle
      real(c_double), intent(out) :: out
      integer(c_int32_t) :: rc
    end function

    ! -- solve lifecycle ------------------------------------------------------
    function HYPREDRV_PreconCreate(handle) &
        bind(c, name="HYPREDRV_PreconCreate") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSolverCreate(handle) &
        bind(c, name="HYPREDRV_LinearSolverCreate") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSolverSetup(handle) &
        bind(c, name="HYPREDRV_LinearSolverSetup") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSolverApply(handle) &
        bind(c, name="HYPREDRV_LinearSolverApply") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_PreconDestroy(handle) &
        bind(c, name="HYPREDRV_PreconDestroy") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSolverDestroy(handle) &
        bind(c, name="HYPREDRV_LinearSolverDestroy") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t) :: rc
    end function

    ! -- stats / getters -------------------------------------------------------
    function HYPREDRV_StatsPrint(handle) &
        bind(c, name="HYPREDRV_StatsPrint") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSolverGetNumIterations(handle, out) &
        bind(c, name="HYPREDRV_LinearSolverGetNumIterations") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t), intent(out) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSolverGetConverged(handle, out) &
        bind(c, name="HYPREDRV_LinearSolverGetConverged") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: handle
      integer(c_int32_t), intent(out) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSolverGetFinalRelativeResidualNorm(handle, out) &
        bind(c, name="HYPREDRV_LinearSolverGetFinalRelativeResidualNorm") &
        result(rc)
      import :: c_int32_t, c_int64_t, c_double
      integer(c_int64_t), value :: handle
      real(c_double), intent(out) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_AnnotateBegin(handle, name, idx) &
        bind(c, name="HYPREDRV_AnnotateBegin") result(rc)
      import :: c_int32_t, c_int64_t, c_char
      integer(c_int64_t), value :: handle
      character(kind=c_char), dimension(*), intent(in) :: name
      integer(c_int32_t), value :: idx
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_AnnotateEnd(handle, name, idx) &
        bind(c, name="HYPREDRV_AnnotateEnd") result(rc)
      import :: c_int32_t, c_int64_t, c_char
      integer(c_int64_t), value :: handle
      character(kind=c_char), dimension(*), intent(in) :: name
      integer(c_int32_t), value :: idx
      integer(c_int32_t) :: rc
    end function

    ! == AUTO-GENERATED from HYPREDRV_tpu.h (scripts/gen_fortran_bindings.py) ==

    function HYPREDRV_ErrorInvalidValue() &
        bind(c, name="HYPREDRV_ErrorInvalidValue") result(rc)
      import :: c_int32_t
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_PrintLibInfo(arg0) &
        bind(c, name="HYPREDRV_PrintLibInfo") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_PrintSystemInfo(arg0) &
        bind(c, name="HYPREDRV_PrintSystemInfo") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_PrintExitInfo(arg0, argv0) &
        bind(c, name="HYPREDRV_PrintExitInfo") result(rc)
      import :: c_char, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      character(kind=c_char), dimension(*) :: argv0
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_InputArgsGetNumLinearSystems(arg0, out) &
        bind(c, name="HYPREDRV_InputArgsGetNumLinearSystems") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), dimension(*) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_InputArgsGetNumPreconVariants(arg0, out) &
        bind(c, name="HYPREDRV_InputArgsGetNumPreconVariants") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), dimension(*) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_InputArgsGetNumRepetitions(arg0, out) &
        bind(c, name="HYPREDRV_InputArgsGetNumRepetitions") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), dimension(*) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_InputArgsGetWarmup(arg0, out) &
        bind(c, name="HYPREDRV_InputArgsGetWarmup") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), dimension(*) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_InputArgsSetPreconPreset(arg0, name) &
        bind(c, name="HYPREDRV_InputArgsSetPreconPreset") result(rc)
      import :: c_char, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      character(kind=c_char), dimension(*) :: name
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_InputArgsSetSolverPreset(arg0, name) &
        bind(c, name="HYPREDRV_InputArgsSetSolverPreset") result(rc)
      import :: c_char, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      character(kind=c_char), dimension(*) :: name
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_PreconPresetRegister(name, yaml) &
        bind(c, name="HYPREDRV_PreconPresetRegister") result(rc)
      import :: c_char, c_int32_t
      character(kind=c_char), dimension(*) :: name
      character(kind=c_char), dimension(*) :: yaml
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_SolverPresetRegister(name, yaml) &
        bind(c, name="HYPREDRV_SolverPresetRegister") result(rc)
      import :: c_char, c_int32_t
      character(kind=c_char), dimension(*) :: name
      character(kind=c_char), dimension(*) :: yaml
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemReadMatrix(arg0, path) &
        bind(c, name="HYPREDRV_LinearSystemReadMatrix") result(rc)
      import :: c_char, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      character(kind=c_char), dimension(*) :: path
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetMatrix(arg0, num_rows, indptr, indices, data) &
        bind(c, name="HYPREDRV_LinearSystemSetMatrix") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int64_t), value :: num_rows
      integer(c_int64_t), dimension(*) :: indptr
      integer(c_int64_t), dimension(*) :: indices
      real(c_double), dimension(*) :: data
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetPrecMatrix(arg0, num_rows, indptr, indices, data) &
        bind(c, name="HYPREDRV_LinearSystemSetPrecMatrix") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int64_t), value :: num_rows
      integer(c_int64_t), dimension(*) :: indptr
      integer(c_int64_t), dimension(*) :: indices
      real(c_double), dimension(*) :: data
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetRHSFromArray(arg0, n, values) &
        bind(c, name="HYPREDRV_LinearSystemSetRHSFromArray") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int64_t), value :: n
      real(c_double), dimension(*) :: values
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetSolution(arg0, n, values) &
        bind(c, name="HYPREDRV_LinearSystemSetSolution") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int64_t), value :: n
      real(c_double), dimension(*) :: values
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetReferenceSolution(arg0, n, values) &
        bind(c, name="HYPREDRV_LinearSystemSetReferenceSolution") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int64_t), value :: n
      real(c_double), dimension(*) :: values
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetNearNullSpace(arg0, num_vecs, n, values) &
        bind(c, name="HYPREDRV_LinearSystemSetNearNullSpace") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), value :: num_vecs
      integer(c_int64_t), value :: n
      real(c_double), dimension(*) :: values
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetNullSpace(arg0, num_vecs, n, values) &
        bind(c, name="HYPREDRV_LinearSystemSetNullSpace") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), value :: num_vecs
      integer(c_int64_t), value :: n
      real(c_double), dimension(*) :: values
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetDiscreteGradient(arg0, num_rows, indptr, indices, data) &
        bind(c, name="HYPREDRV_LinearSystemSetDiscreteGradient") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int64_t), value :: num_rows
      integer(c_int64_t), dimension(*) :: indptr
      integer(c_int64_t), dimension(*) :: indices
      real(c_double), dimension(*) :: data
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetDiscreteCurl(arg0, num_rows, indptr, indices, data) &
        bind(c, name="HYPREDRV_LinearSystemSetDiscreteCurl") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int64_t), value :: num_rows
      integer(c_int64_t), dimension(*) :: indptr
      integer(c_int64_t), dimension(*) :: indices
      real(c_double), dimension(*) :: data
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetCoordinates(arg0, dim, n, coords) &
        bind(c, name="HYPREDRV_LinearSystemSetCoordinates") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), value :: dim
      integer(c_int64_t), value :: n
      real(c_double), dimension(*) :: coords
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemSetContiguousDofmap(arg0, num_functions) &
        bind(c, name="HYPREDRV_LinearSystemSetContiguousDofmap") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), value :: num_functions
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemReadDofmap(arg0, path) &
        bind(c, name="HYPREDRV_LinearSystemReadDofmap") result(rc)
      import :: c_char, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      character(kind=c_char), dimension(*) :: path
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemPrint(arg0, prefix) &
        bind(c, name="HYPREDRV_LinearSystemPrint") result(rc)
      import :: c_char, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      character(kind=c_char), dimension(*) :: prefix
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemPrintDofmap(arg0, path) &
        bind(c, name="HYPREDRV_LinearSystemPrintDofmap") result(rc)
      import :: c_char, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      character(kind=c_char), dimension(*) :: path
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemComputeEigenspectrum(arg0) &
        bind(c, name="HYPREDRV_LinearSystemComputeEigenspectrum") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemGetSolutionLength(arg0, out) &
        bind(c, name="HYPREDRV_LinearSystemGetSolutionLength") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int64_t), dimension(*) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSystemGetRHSValues(arg0, n, out) &
        bind(c, name="HYPREDRV_LinearSystemGetRHSValues") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int64_t), value :: n
      real(c_double), dimension(*) :: out
      integer(c_int32_t) :: rc
    end function

    ! HYPREDRV_LinearSystemGetMatrix: signature not auto-bindable (bind manually if needed)

    ! HYPREDRV_LinearSystemGetRHS: signature not auto-bindable (bind manually if needed)

    ! HYPREDRV_LinearSystemGetSolution: signature not auto-bindable (bind manually if needed)

    ! HYPREDRV_StateVectorSet: signature not auto-bindable (bind manually if needed)

    function HYPREDRV_StateVectorGetValues(arg0, index, n, out) &
        bind(c, name="HYPREDRV_StateVectorGetValues") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), value :: index
      integer(c_int64_t), value :: n
      real(c_double), dimension(*) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_StateVectorCopy(arg0, index_in, index_out) &
        bind(c, name="HYPREDRV_StateVectorCopy") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), value :: index_in
      integer(c_int32_t), value :: index_out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_StateVectorUpdateAll(arg0) &
        bind(c, name="HYPREDRV_StateVectorUpdateAll") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_StateVectorApplyCorrection(arg0, index) &
        bind(c, name="HYPREDRV_StateVectorApplyCorrection") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), value :: index
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_PreconSetup(arg0) &
        bind(c, name="HYPREDRV_PreconSetup") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_PreconApply(arg0, n, r, z) &
        bind(c, name="HYPREDRV_PreconApply") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int64_t), value :: n
      real(c_double), dimension(*) :: r
      real(c_double), dimension(*) :: z
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_AnnotateLevelBegin(arg0, name, index) &
        bind(c, name="HYPREDRV_AnnotateLevelBegin") result(rc)
      import :: c_char, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      character(kind=c_char), dimension(*) :: name
      integer(c_int32_t), value :: index
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_AnnotateLevelEnd(arg0, name, index) &
        bind(c, name="HYPREDRV_AnnotateLevelEnd") result(rc)
      import :: c_char, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      character(kind=c_char), dimension(*) :: name
      integer(c_int32_t), value :: index
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_StatsLevelPrint(arg0) &
        bind(c, name="HYPREDRV_StatsLevelPrint") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_StatsLevelGetCount(arg0, name, out) &
        bind(c, name="HYPREDRV_StatsLevelGetCount") result(rc)
      import :: c_char, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      character(kind=c_char), dimension(*) :: name
      integer(c_int32_t), dimension(*) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_StatsLevelGetEntry(arg0, name, entry, time_out) &
        bind(c, name="HYPREDRV_StatsLevelGetEntry") result(rc)
      import :: c_char, c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      character(kind=c_char), dimension(*) :: name
      integer(c_int32_t), value :: entry
      real(c_double), dimension(*) :: time_out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSolverGetNumIter(arg0, out) &
        bind(c, name="HYPREDRV_LinearSolverGetNumIter") result(rc)
      import :: c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      integer(c_int32_t), dimension(*) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSolverGetSetupTime(arg0, out) &
        bind(c, name="HYPREDRV_LinearSolverGetSetupTime") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      real(c_double), dimension(*) :: out
      integer(c_int32_t) :: rc
    end function

    function HYPREDRV_LinearSolverGetSolveTime(arg0, out) &
        bind(c, name="HYPREDRV_LinearSolverGetSolveTime") result(rc)
      import :: c_double, c_int32_t, c_int64_t
      integer(c_int64_t), value :: arg0
      real(c_double), dimension(*) :: out
      integer(c_int32_t) :: rc
    end function
    ! == END AUTO-GENERATED ==

  end interface

  public :: HYPREDRV_Initialize, HYPREDRV_Finalize, HYPREDRV_Create, &
            HYPREDRV_Destroy, HYPREDRV_ErrorCodeDescribe, &
            HYPREDRV_ErrorCodeClear, HYPREDRV_InputArgsParse, &
            HYPREDRV_SetLibraryMode, HYPREDRV_ObjectSetName, &
            HYPREDRV_InputArgsSetPreconVariant, HYPREDRV_LinearSystemBuild, &
            HYPREDRV_LinearSystemSetMatrixFromCSR, &
            HYPREDRV_LinearSystemSetRHS, &
            HYPREDRV_LinearSystemSetInitialGuess, &
            HYPREDRV_LinearSystemResetInitialGuess, &
            HYPREDRV_LinearSystemSetDofmap, &
            HYPREDRV_LinearSystemSetInterleavedDofmap, &
            HYPREDRV_LinearSystemGetSolutionValues, &
            HYPREDRV_LinearSystemGetSolutionNorm, HYPREDRV_PreconCreate, &
            HYPREDRV_LinearSolverCreate, HYPREDRV_LinearSolverSetup, &
            HYPREDRV_LinearSolverApply, HYPREDRV_PreconDestroy, &
            HYPREDRV_LinearSolverDestroy, HYPREDRV_StatsPrint, &
            HYPREDRV_LinearSolverGetNumIterations, &
            HYPREDRV_LinearSolverGetConverged, &
            HYPREDRV_LinearSolverGetFinalRelativeResidualNorm, &
            HYPREDRV_AnnotateBegin, HYPREDRV_AnnotateEnd
  public :: hypredrv_error_describe

contains

  !> Convenience: status code -> Fortran string.
  function hypredrv_error_describe(code) result(msg)
    integer(c_int32_t), intent(in) :: code
    character(len=:), allocatable :: msg
    type(c_ptr) :: p
    character(kind=c_char), pointer :: chars(:)
    integer :: n
    p = HYPREDRV_ErrorCodeDescribe(code)
    if (.not. c_associated(p)) then
      msg = "unknown"
      return
    end if
    call c_f_pointer(p, chars, [1024])
    n = 0
    do while (n < 1024)
      if (chars(n + 1) == c_null_char) exit
      n = n + 1
    end do
    allocate (character(len=n) :: msg)
    block
      integer :: i
      do i = 1, n
        msg(i:i) = chars(i)
      end do
    end block
  end function

end module hypredrive_tpu
