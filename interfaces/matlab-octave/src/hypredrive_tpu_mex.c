/**
 * @file hypredrive_tpu_mex.c
 * @brief Serial MATLAB/Octave MEX entry point for hypredrive_tpu.
 *
 * One-shot interface mirroring the reference's MEX front end
 * (ref: interfaces/matlab-octave/src/hypredrive_mex.c:9-17 — MATLAB owns
 * a sparse matrix and a dense RHS; the MEX converts CSC storage to the
 * CSR slab the library expects, solves, copies the solution back and
 * releases every library object before returning).  Here the library is
 * the embedded-CPython C shim (native/include/HYPREDRV_tpu.h), so no MPI
 * communicator plumbing is needed — the JAX runtime is process-global.
 *
 * Usage from MATLAB/Octave:
 *     x = hypredrive_tpu_mex(A, b);                 % default PCG+AMG
 *     x = hypredrive_tpu_mex(A, b, yaml_text);      % custom config
 *
 * Build (with the in-tree shim already built by `make -C native`):
 *     mex -I../../../native/include hypredrive_tpu_mex.c \
 *         -L../../../native -lhypredrv_tpu
 */

#include "mex.h"

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "HYPREDRV_tpu.h"

static const char *HYPREDRV_TPU_MEX_DEFAULT_YAML = "linear_system:\n"
                                                   "solver:\n"
                                                   "  pcg:\n"
                                                   "    max_iter: 100\n"
                                                   "    relative_tol: 1.0e-8\n"
                                                   "preconditioner:\n"
                                                   "  amg:\n"
                                                   "    max_iter: 1\n"
                                                   "    tolerance: 0.0\n";

static int hypredrv_tpu_mex_initialized = 0;

static void
hypredrv_tpu_mex_atexit(void)
{
   if (hypredrv_tpu_mex_initialized)
   {
      (void)HYPREDRV_Finalize();
      hypredrv_tpu_mex_initialized = 0;
   }
}

#define MEX_CHECK(call, id, msg)                                          \
   do                                                                     \
   {                                                                      \
      uint32_t code_ = (call);                                            \
      if (code_ != 0)                                                     \
      {                                                                   \
         mexErrMsgIdAndTxt(id, "%s (code 0x%x): %s", msg,                 \
                           (unsigned int)code_, HYPREDRV_ErrorMessage()); \
      }                                                                   \
   } while (0)

/* Convert MATLAB's CSC (columns compressed) to the row-compressed CSR
 * triple the library ingests; symmetric-structure fast path avoided on
 * purpose — the transpose walk is O(nnz) and always correct. */
static void
csc_to_csr(mwIndex n, const mwIndex *jc, const mwIndex *ir,
           const double *pr, int64_t *indptr, int64_t *indices,
           double *data)
{
   mwIndex nnz = jc[n];
   mwIndex col, p;

   for (p = 0; p <= n; ++p)
   {
      indptr[p] = 0;
   }
   for (p = 0; p < nnz; ++p)
   {
      ++indptr[ir[p] + 1];
   }
   for (p = 0; p < n; ++p)
   {
      indptr[p + 1] += indptr[p];
   }
   {
      int64_t *cursor = (int64_t *)malloc((size_t)n * sizeof(int64_t));
      if (!cursor)
      {
         mexErrMsgIdAndTxt("hypredrive_tpu:oom", "out of memory");
      }
      for (p = 0; p < n; ++p)
      {
         cursor[p] = indptr[p];
      }
      for (col = 0; col < n; ++col)
      {
         for (p = jc[col]; p < jc[col + 1]; ++p)
         {
            const int64_t dst = cursor[ir[p]]++;
            indices[dst] = (int64_t)col;
            data[dst]    = pr[p];
         }
      }
      free(cursor);
   }
}

void
mexFunction(int nlhs, mxArray *plhs[], int nrhs, const mxArray *prhs[])
{
   HYPREDRV_t drv = 0;
   const char *yaml = HYPREDRV_TPU_MEX_DEFAULT_YAML;
   char *yaml_owned = NULL;

   if (nrhs < 2 || nrhs > 3)
   {
      mexErrMsgIdAndTxt("hypredrive_tpu:usage",
                        "usage: x = hypredrive_tpu_mex(A, b[, yaml])");
   }
   if (!mxIsSparse(prhs[0]) || mxIsComplex(prhs[0]))
   {
      mexErrMsgIdAndTxt("hypredrive_tpu:matrix",
                        "A must be a real sparse matrix");
   }
   if (mxIsSparse(prhs[1]) || mxIsComplex(prhs[1]) ||
       !mxIsDouble(prhs[1]))
   {
      mexErrMsgIdAndTxt("hypredrive_tpu:rhs",
                        "b must be a dense real double vector");
   }

   {
      const mwIndex n = (mwIndex)mxGetM(prhs[0]);
      const mwIndex *jc = mxGetJc(prhs[0]);
      const mwIndex *ir = mxGetIr(prhs[0]);
      const double *pr = mxGetPr(prhs[0]);
      const mwIndex nnz = jc[n];
      int64_t *indptr, *indices;
      double *data;
      const double *b = mxGetPr(prhs[1]);

      if ((mwIndex)mxGetN(prhs[0]) != n)
      {
         mexErrMsgIdAndTxt("hypredrive_tpu:matrix", "A must be square");
      }
      if ((mwIndex)mxGetNumberOfElements(prhs[1]) != n)
      {
         mexErrMsgIdAndTxt("hypredrive_tpu:rhs",
                           "length(b) must equal size(A, 1)");
      }
      if (nrhs == 3)
      {
         yaml_owned = mxArrayToString(prhs[2]);
         if (!yaml_owned)
         {
            mexErrMsgIdAndTxt("hypredrive_tpu:yaml",
                              "yaml must be a character array");
         }
         yaml = yaml_owned;
      }

      if (!hypredrv_tpu_mex_initialized)
      {
         MEX_CHECK(HYPREDRV_Initialize(), "hypredrive_tpu:init",
                   "HYPREDRV_Initialize failed");
         hypredrv_tpu_mex_initialized = 1;
         mexAtExit(hypredrv_tpu_mex_atexit);
      }

      indptr  = (int64_t *)mxMalloc((n + 1) * sizeof(int64_t));
      indices = (int64_t *)mxMalloc((nnz ? nnz : 1) * sizeof(int64_t));
      data    = (double *)mxMalloc((nnz ? nnz : 1) * sizeof(double));
      csc_to_csr(n, jc, ir, pr, indptr, indices, data);

      MEX_CHECK(HYPREDRV_Create(&drv), "hypredrive_tpu:create",
                "HYPREDRV_Create failed");
      MEX_CHECK(HYPREDRV_SetLibraryMode(drv), "hypredrive_tpu:mode",
                "HYPREDRV_SetLibraryMode failed");
      MEX_CHECK(HYPREDRV_InputArgsParse(drv, yaml), "hypredrive_tpu:parse",
                "HYPREDRV_InputArgsParse failed");
      MEX_CHECK(HYPREDRV_LinearSystemSetMatrixFromCSR(
                   drv, (int64_t)n, indptr, indices, data),
                "hypredrive_tpu:setmatrix",
                "HYPREDRV_LinearSystemSetMatrixFromCSR failed");
      MEX_CHECK(HYPREDRV_LinearSystemSetRHSFromArray(drv, (int64_t)n, b),
                "hypredrive_tpu:setrhs",
                "HYPREDRV_LinearSystemSetRHSFromArray failed");
      MEX_CHECK(HYPREDRV_PreconCreate(drv), "hypredrive_tpu:precon",
                "HYPREDRV_PreconCreate failed");
      MEX_CHECK(HYPREDRV_LinearSolverCreate(drv), "hypredrive_tpu:solver",
                "HYPREDRV_LinearSolverCreate failed");
      MEX_CHECK(HYPREDRV_LinearSolverSetup(drv), "hypredrive_tpu:setup",
                "HYPREDRV_LinearSolverSetup failed");
      MEX_CHECK(HYPREDRV_LinearSolverApply(drv), "hypredrive_tpu:apply",
                "HYPREDRV_LinearSolverApply failed");

      plhs[0] = mxCreateDoubleMatrix(n, 1, mxREAL);
      MEX_CHECK(HYPREDRV_LinearSystemGetSolutionValues(
                   drv, (int64_t)n, mxGetPr(plhs[0])),
                "hypredrive_tpu:solution",
                "HYPREDRV_LinearSystemGetSolutionValues failed");

      MEX_CHECK(HYPREDRV_LinearSolverDestroy(drv), "hypredrive_tpu:destroy",
                "HYPREDRV_LinearSolverDestroy failed");
      MEX_CHECK(HYPREDRV_PreconDestroy(drv), "hypredrive_tpu:destroy",
                "HYPREDRV_PreconDestroy failed");
      MEX_CHECK(HYPREDRV_Destroy(&drv), "hypredrive_tpu:destroy",
                "HYPREDRV_Destroy failed");

      mxFree(indptr);
      mxFree(indices);
      mxFree(data);
   }
   if (yaml_owned)
   {
      mxFree(yaml_owned);
   }
   (void)nlhs;
}
