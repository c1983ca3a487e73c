// C++ RAII binding for the hypredrive-tpu C API.
//
// Reference counterpart: interfaces/cpp/include/hypredrive.hpp (the
// header-only hypredrive::driver class, :154).  Original design: wraps native/include/HYPREDRV_tpu.h — every C verb appears as
// a member (coverage enforced by tests/test_capi.py::
// test_cpp_header_covers_c_api, the analogue of the reference's
// interfaces/cpp/tests/check_api_coverage.cmake).
//
// Error model: nonzero C status codes raise hypredrive::error carrying
// the code and the Python-side message.

#ifndef HYPREDRIVE_TPU_HPP
#define HYPREDRIVE_TPU_HPP

#include <cstdint>
#include <stdexcept>
#include <string>
#include <vector>

#include "HYPREDRV_tpu.h"

namespace hypredrive {

class error : public std::runtime_error {
 public:
  error(uint32_t code, const std::string &what)
      : std::runtime_error(what), code_(code) {}
  uint32_t code() const noexcept { return code_; }

 private:
  uint32_t code_;
};

namespace detail {
inline void check(uint32_t rc) {
  if (rc != 0) {
    std::string msg = HYPREDRV_ErrorCodeDescribe(rc);
    const char *pymsg = HYPREDRV_ErrorMessage();
    if (pymsg && pymsg[0]) msg += std::string(": ") + pymsg;
    throw error(rc, msg);
  }
}
}  // namespace detail

/// Process-wide runtime init/teardown (HYPREDRV_Initialize/Finalize).
inline void initialize() { detail::check(HYPREDRV_Initialize()); }
inline void finalize() { detail::check(HYPREDRV_Finalize()); }
inline void clear_errors() { detail::check(HYPREDRV_ErrorCodeClear()); }

inline void register_precon_preset(const std::string &name,
                                   const std::string &yaml) {
  detail::check(HYPREDRV_PreconPresetRegister(name.c_str(), yaml.c_str()));
}
inline void register_solver_preset(const std::string &name,
                                   const std::string &yaml) {
  detail::check(HYPREDRV_SolverPresetRegister(name.c_str(), yaml.c_str()));
}

/// RAII driver over the C handle (ref: hypredrive.hpp:154 `driver`).
class driver {
 public:
  driver() { detail::check(HYPREDRV_Create(&handle_)); }
  ~driver() noexcept {
    if (handle_) (void)HYPREDRV_Destroy(&handle_);
  }
  driver(const driver &) = delete;
  driver &operator=(const driver &) = delete;
  driver(driver &&o) noexcept : handle_(o.handle_) { o.handle_ = 0; }
  driver &operator=(driver &&o) noexcept {
    if (this != &o) {
      if (handle_) (void)HYPREDRV_Destroy(&handle_);
      handle_ = o.handle_;
      o.handle_ = 0;
    }
    return *this;
  }

  HYPREDRV_t native_handle() const noexcept { return handle_; }
  HYPREDRV_t release() noexcept {
    HYPREDRV_t out = handle_;
    handle_ = 0;
    return out;
  }
  void destroy() { detail::check(HYPREDRV_Destroy(&handle_)); }

  // -- configuration ------------------------------------------------------
  void parse_yaml(const std::string &yaml_text_or_path) {
    detail::check(HYPREDRV_InputArgsParse(handle_, yaml_text_or_path.c_str()));
  }
  void set_library_mode() { detail::check(HYPREDRV_SetLibraryMode(handle_)); }
  void set_name(const std::string &name) {
    detail::check(HYPREDRV_ObjectSetName(handle_, name.c_str()));
  }
  int num_linear_systems() const {
    int32_t v = 0;
    detail::check(HYPREDRV_InputArgsGetNumLinearSystems(handle_, &v));
    return v;
  }
  int num_precon_variants() const {
    int32_t v = 0;
    detail::check(HYPREDRV_InputArgsGetNumPreconVariants(handle_, &v));
    return v;
  }
  int num_repetitions() const {
    int32_t v = 0;
    detail::check(HYPREDRV_InputArgsGetNumRepetitions(handle_, &v));
    return v;
  }
  bool warmup() const {
    int32_t v = 0;
    detail::check(HYPREDRV_InputArgsGetWarmup(handle_, &v));
    return v != 0;
  }
  void set_precon_variant(int index) {
    detail::check(HYPREDRV_InputArgsSetPreconVariant(handle_, index));
  }
  void set_precon_preset(const std::string &name) {
    detail::check(HYPREDRV_InputArgsSetPreconPreset(handle_, name.c_str()));
  }
  void set_solver_preset(const std::string &name) {
    detail::check(HYPREDRV_InputArgsSetSolverPreset(handle_, name.c_str()));
  }

  // -- info ----------------------------------------------------------------
  void print_lib_info() { detail::check(HYPREDRV_PrintLibInfo(handle_)); }
  void print_system_info() {
    detail::check(HYPREDRV_PrintSystemInfo(handle_));
  }
  void print_exit_info(const char *argv0 = "") {
    detail::check(HYPREDRV_PrintExitInfo(handle_, argv0));
  }

  // -- linear system ---------------------------------------------------------
  void build_linear_system() {
    detail::check(HYPREDRV_LinearSystemBuild(handle_));
  }
  void read_matrix(const std::string &path) {
    detail::check(HYPREDRV_LinearSystemReadMatrix(handle_, path.c_str()));
  }
  void set_matrix(int64_t n, const int64_t *indptr, const int64_t *indices,
                  const double *data) {
    detail::check(
        HYPREDRV_LinearSystemSetMatrix(handle_, n, indptr, indices, data));
  }
  void set_matrix_from_csr(const std::vector<int64_t> &indptr,
                           const std::vector<int64_t> &indices,
                           const std::vector<double> &data) {
    detail::check(HYPREDRV_LinearSystemSetMatrixFromCSR(
        handle_, (int64_t)indptr.size() - 1, indptr.data(), indices.data(),
        data.data()));
  }
  void set_prec_matrix(const std::vector<int64_t> &indptr,
                       const std::vector<int64_t> &indices,
                       const std::vector<double> &data) {
    detail::check(HYPREDRV_LinearSystemSetPrecMatrix(
        handle_, (int64_t)indptr.size() - 1, indptr.data(), indices.data(),
        data.data()));
  }
  void set_rhs(const std::vector<double> &b) {
    detail::check(
        HYPREDRV_LinearSystemSetRHS(handle_, (int64_t)b.size(), b.data()));
  }
  void set_rhs_from_array(const std::vector<double> &b) {
    detail::check(HYPREDRV_LinearSystemSetRHSFromArray(
        handle_, (int64_t)b.size(), b.data()));
  }
  void set_initial_guess(const std::vector<double> &x0) {
    detail::check(HYPREDRV_LinearSystemSetInitialGuess(
        handle_, (int64_t)x0.size(), x0.data()));
  }
  void set_solution(const std::vector<double> &x) {
    detail::check(HYPREDRV_LinearSystemSetSolution(
        handle_, (int64_t)x.size(), x.data()));
  }
  void set_reference_solution(const std::vector<double> &xref) {
    detail::check(HYPREDRV_LinearSystemSetReferenceSolution(
        handle_, (int64_t)xref.size(), xref.data()));
  }
  void reset_initial_guess() {
    detail::check(HYPREDRV_LinearSystemResetInitialGuess(handle_));
  }
  void set_near_nullspace(int num_vecs, int64_t n, const double *v) {
    detail::check(
        HYPREDRV_LinearSystemSetNearNullSpace(handle_, num_vecs, n, v));
  }
  void set_nullspace(int num_vecs, int64_t n, const double *v) {
    detail::check(HYPREDRV_LinearSystemSetNullSpace(handle_, num_vecs, n, v));
  }
  void set_discrete_gradient(int64_t n, const int64_t *indptr,
                             const int64_t *indices, const double *data) {
    detail::check(HYPREDRV_LinearSystemSetDiscreteGradient(
        handle_, n, indptr, indices, data));
  }
  void set_discrete_curl(int64_t n, const int64_t *indptr,
                         const int64_t *indices, const double *data) {
    detail::check(HYPREDRV_LinearSystemSetDiscreteCurl(handle_, n, indptr,
                                                       indices, data));
  }
  void set_coordinates(int dim, int64_t n, const double *coords) {
    detail::check(
        HYPREDRV_LinearSystemSetCoordinates(handle_, dim, n, coords));
  }
  void set_dofmap(const std::vector<int64_t> &labels) {
    detail::check(HYPREDRV_LinearSystemSetDofmap(
        handle_, (int64_t)labels.size(), labels.data()));
  }
  void set_interleaved_dofmap(int num_functions) {
    detail::check(
        HYPREDRV_LinearSystemSetInterleavedDofmap(handle_, num_functions));
  }
  void set_contiguous_dofmap(int num_functions) {
    detail::check(
        HYPREDRV_LinearSystemSetContiguousDofmap(handle_, num_functions));
  }
  void read_dofmap(const std::string &path) {
    detail::check(HYPREDRV_LinearSystemReadDofmap(handle_, path.c_str()));
  }
  void print_linear_system(const std::string &prefix) {
    detail::check(HYPREDRV_LinearSystemPrint(handle_, prefix.c_str()));
  }
  void print_dofmap(const std::string &path) {
    detail::check(HYPREDRV_LinearSystemPrintDofmap(handle_, path.c_str()));
  }
  void compute_eigenspectrum() {
    detail::check(HYPREDRV_LinearSystemComputeEigenspectrum(handle_));
  }

  // -- solution getters --------------------------------------------------------
  int64_t solution_length() const {
    int64_t n = 0;
    detail::check(HYPREDRV_LinearSystemGetSolutionLength(handle_, &n));
    return n;
  }
  double solution_norm() const {
    double v = 0;
    detail::check(HYPREDRV_LinearSystemGetSolutionNorm(handle_, &v));
    return v;
  }
  std::vector<double> solution() const {
    std::vector<double> out((size_t)solution_length());
    detail::check(HYPREDRV_LinearSystemGetSolutionValues(
        handle_, (int64_t)out.size(), out.data()));
    return out;
  }
  std::vector<double> rhs() const {
    std::vector<double> out((size_t)solution_length());
    detail::check(HYPREDRV_LinearSystemGetRHSValues(
        handle_, (int64_t)out.size(), out.data()));
    return out;
  }
  void *matrix_handle() const {
    void *p = nullptr;
    detail::check(HYPREDRV_LinearSystemGetMatrix(handle_, &p));
    return p;
  }
  void *rhs_handle() const {
    void *p = nullptr;
    detail::check(HYPREDRV_LinearSystemGetRHS(handle_, &p));
    return p;
  }
  void *solution_handle() const {
    void *p = nullptr;
    detail::check(HYPREDRV_LinearSystemGetSolution(handle_, &p));
    return p;
  }

  // -- state vectors -------------------------------------------------------------
  void state_vector_set(int num_states, int64_t n, double **vectors) {
    detail::check(HYPREDRV_StateVectorSet(handle_, num_states, n, vectors));
  }
  std::vector<double> state_vector_values(int index, int64_t n) const {
    std::vector<double> out((size_t)n);
    detail::check(
        HYPREDRV_StateVectorGetValues(handle_, index, n, out.data()));
    return out;
  }
  void state_vector_copy(int in_idx, int out_idx) {
    detail::check(HYPREDRV_StateVectorCopy(handle_, in_idx, out_idx));
  }
  void state_vector_update_all() {
    detail::check(HYPREDRV_StateVectorUpdateAll(handle_));
  }
  void state_vector_apply_correction(int index) {
    detail::check(HYPREDRV_StateVectorApplyCorrection(handle_, index));
  }

  // -- solve lifecycle --------------------------------------------------------------
  void create_precon() { detail::check(HYPREDRV_PreconCreate(handle_)); }
  void setup_precon() { detail::check(HYPREDRV_PreconSetup(handle_)); }
  std::vector<double> apply_precon(const std::vector<double> &r) {
    std::vector<double> z(r.size());
    detail::check(HYPREDRV_PreconApply(handle_, (int64_t)r.size(), r.data(),
                                       z.data()));
    return z;
  }
  void create_solver() { detail::check(HYPREDRV_LinearSolverCreate(handle_)); }
  void setup() { detail::check(HYPREDRV_LinearSolverSetup(handle_)); }
  void solve() { detail::check(HYPREDRV_LinearSolverApply(handle_)); }
  void destroy_precon() { detail::check(HYPREDRV_PreconDestroy(handle_)); }
  void destroy_solver() {
    detail::check(HYPREDRV_LinearSolverDestroy(handle_));
  }

  // -- stats / observability ------------------------------------------------------
  void print_stats() { detail::check(HYPREDRV_StatsPrint(handle_)); }
  void annotate_begin(const std::string &name, int index) {
    detail::check(HYPREDRV_AnnotateBegin(handle_, name.c_str(), index));
  }
  void annotate_end(const std::string &name, int index) {
    detail::check(HYPREDRV_AnnotateEnd(handle_, name.c_str(), index));
  }
  void annotate_level_begin(const std::string &name, int index) {
    detail::check(HYPREDRV_AnnotateLevelBegin(handle_, name.c_str(), index));
  }
  void annotate_level_end(const std::string &name, int index) {
    detail::check(HYPREDRV_AnnotateLevelEnd(handle_, name.c_str(), index));
  }
  void print_level_stats() { detail::check(HYPREDRV_StatsLevelPrint(handle_)); }
  int level_count(const std::string &name) const {
    int32_t v = 0;
    detail::check(HYPREDRV_StatsLevelGetCount(handle_, name.c_str(), &v));
    return v;
  }
  double level_entry_time(const std::string &name, int entry) const {
    double v = 0;
    detail::check(
        HYPREDRV_StatsLevelGetEntry(handle_, name.c_str(), entry, &v));
    return v;
  }

  // -- solver getters -----------------------------------------------------------
  int num_iterations() const {
    int32_t v = 0;
    detail::check(HYPREDRV_LinearSolverGetNumIterations(handle_, &v));
    return v;
  }
  int num_iter() const {
    int32_t v = 0;
    detail::check(HYPREDRV_LinearSolverGetNumIter(handle_, &v));
    return v;
  }
  bool converged() const {
    int32_t v = 0;
    detail::check(HYPREDRV_LinearSolverGetConverged(handle_, &v));
    return v != 0;
  }
  double setup_time() const {
    double v = 0;
    detail::check(HYPREDRV_LinearSolverGetSetupTime(handle_, &v));
    return v;
  }
  double solve_time() const {
    double v = 0;
    detail::check(HYPREDRV_LinearSolverGetSolveTime(handle_, &v));
    return v;
  }
  double final_relative_residual_norm() const {
    double v = 0;
    detail::check(
        HYPREDRV_LinearSolverGetFinalRelativeResidualNorm(handle_, &v));
    return v;
  }

 private:
  HYPREDRV_t handle_ = 0;
};

}  // namespace hypredrive

// HYPREDRV_SafeCallHandleError / HYPREDRV_ErrorInvalidValue are consumed
// via the macro below (C++ code normally prefers exceptions).
#define HYPREDRIVE_TPU_SAFE_CALL(expr) \
  HYPREDRV_SafeCallHandleError((expr), __FILE__, __LINE__)

#endif  // HYPREDRIVE_TPU_HPP
