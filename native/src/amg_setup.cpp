// ---------------------------------------------------------------------------
// Native AMG setup kernels: strength graph, PMIS coarsening, extended+i
// interpolation, Galerkin RAP.  These are the latency-bound host-side
// graph algorithms of the hierarchy build (the solve phase runs on the
// accelerator); the semantics mirror hypredrive_tpu/precon/amg/{strength,coarsen,
// interp}.py (which in turn mirror hypre's BoomerAMG CreateS / PMIS /
// mm-ext+i — ref: src/internal/amg.c:250-400).
//
// Python falls back to the numpy implementations whenever this library
// is unavailable or an option combination is not covered here.
//
// PMIS integer/hash logic is bit-exact with the numpy twin so C/F
// splittings are identical; strength comparisons run in the input
// precision so the pattern matches numpy's.  Interpolation weights are
// accumulated in double (row-major order) — equal patterns, weights
// equal to numpy's up to summation-order rounding.
// ---------------------------------------------------------------------------

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <new>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// strength pattern.  All comparisons in double: numpy keeps row_max in
// float64 (np.full + maximum.at upcasts) and promotes the comparison,
// so this is bit-identical for f32 AND f64 inputs.
// ---------------------------------------------------------------------------
template <typename T>
int64_t strength_impl(int64_t n, const int64_t *indptr,
                      const int64_t *indices, const T *data, double theta,
                      int sabs, const int32_t *dof_func, int64_t *s_indptr,
                      int64_t *s_indices) {
  int64_t nnz = 0;
  s_indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t b = indptr[i], e = indptr[i + 1];
    double mx = -std::numeric_limits<double>::infinity();
    for (int64_t p = b; p < e; ++p) {
      const int64_t j = indices[p];
      if (j == i) continue;
      if (dof_func && dof_func[i] != dof_func[j]) continue;
      const double v = sabs ? std::fabs((double)data[p]) : -(double)data[p];
      if (v > mx) mx = v;
    }
    const double rm = std::isfinite(mx) ? mx : 0.0;
    const double thr = theta * rm;
    for (int64_t p = b; p < e; ++p) {
      const int64_t j = indices[p];
      if (j == i) continue;
      if (dof_func && dof_func[i] != dof_func[j]) continue;
      const double v = sabs ? std::fabs((double)data[p]) : -(double)data[p];
      if (v >= thr && v > 0.0) s_indices[nnz++] = j;
    }
    s_indptr[i + 1] = nnz;
  }
  return nnz;
}

// splitmix64-based uniform(0,1) — bit-exact with coarsen._hash_random
inline double hash_random(uint64_t idx, uint64_t seed_off) {
  uint64_t z = idx + seed_off + 0x9E3779B97F4A7C15ULL;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  z = z ^ (z >> 31);
  return (double)(z >> 11) / 9007199254740992.0;  // 2^53
}

}  // namespace

extern "C" {

// s_indices must have room for a_nnz entries; returns the strength nnz.
int64_t hdrv_strength(int64_t n, const int64_t *indptr,
                      const int64_t *indices, const void *data, int is_f32,
                      double theta, int sabs, const int32_t *dof_func,
                      int64_t *s_indptr, int64_t *s_indices) {
  if (is_f32)
    return strength_impl<float>(n, indptr, indices, (const float *)data,
                                theta, sabs, dof_func, s_indptr, s_indices);
  return strength_impl<double>(n, indptr, indices, (const double *)data,
                               theta, sabs, dof_func, s_indptr, s_indices);
}

// ---------------------------------------------------------------------------
// PMIS C/F splitting on the strength graph S (S[i,j]: i depends on j).
// Bit-exact replica of coarsen.pmis: measure = |ST row| (+boost) + hash;
// rounds of independent-set selection over the undirected union graph.
// cf_out: +1 C, -1 F.
// ---------------------------------------------------------------------------
void hdrv_pmis(int64_t n, const int64_t *s_indptr, const int64_t *s_indices,
               int64_t seed, const double *boost, int8_t *cf_out) {
  const int64_t s_nnz = s_indptr[n];
  // ST (counting transpose)
  std::vector<int64_t> st_indptr((size_t)n + 1, 0), st_indices((size_t)s_nnz);
  for (int64_t p = 0; p < s_nnz; ++p) ++st_indptr[(size_t)s_indices[p] + 1];
  for (int64_t i = 0; i < n; ++i) st_indptr[(size_t)i + 1] += st_indptr[(size_t)i];
  {
    std::vector<int64_t> cur(st_indptr.begin(), st_indptr.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p)
        st_indices[(size_t)cur[(size_t)s_indices[p]]++] = i;
  }

  // measure
  const uint64_t seed_off =
      (uint64_t)seed * 0x9E3779B97F4A7C15ULL;  // numpy: (seed*K) % 2^64
  std::vector<double> w((size_t)n);
  std::vector<double> influence((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    influence[(size_t)i] =
        (double)(st_indptr[(size_t)i + 1] - st_indptr[(size_t)i]) +
        (boost ? boost[(size_t)i] : 0.0);
    w[(size_t)i] = influence[(size_t)i] + hash_random((uint64_t)i, seed_off);
  }

  constexpr int8_t UNDEC = 0, CPT = 1, FPT = -1;
  std::vector<int8_t> state((size_t)n, UNDEC);
  int64_t n_undec = n;
  for (int64_t i = 0; i < n; ++i) {
    const bool iso = (s_indptr[i + 1] == s_indptr[i]) &&
                     (st_indptr[(size_t)i + 1] == st_indptr[(size_t)i]);
    if (iso) {
      state[(size_t)i] = FPT;
      --n_undec;
    } else if (influence[(size_t)i] == 0.0) {
      state[(size_t)i] = FPT;
      --n_undec;
    }
  }

  // active directed edge lists of G = S ∪ ST (both directions present,
  // mirroring numpy's (S+ST) CSR edge walk) and of S
  std::vector<int64_t> g_r, g_c, s_r, s_c;
  g_r.reserve((size_t)(2 * s_nnz));
  g_c.reserve((size_t)(2 * s_nnz));
  {
    // union per row via merge of sorted S row and sorted ST row
    std::vector<int64_t> st_sorted(st_indices);  // columns per row sorted
    // counting transpose emits ascending row order -> already sorted
    for (int64_t i = 0; i < n; ++i) {
      if (state[(size_t)i] != UNDEC) continue;
      int64_t p = s_indptr[i], pe = s_indptr[i + 1];
      int64_t q = st_indptr[(size_t)i], qe = st_indptr[(size_t)i + 1];
      while (p < pe || q < qe) {
        int64_t j;
        if (p < pe && (q >= qe || s_indices[p] <= st_sorted[(size_t)q])) {
          j = s_indices[p];
          if (q < qe && st_sorted[(size_t)q] == j) ++q;
          ++p;
        } else {
          j = st_sorted[(size_t)q];
          ++q;
        }
        if (state[(size_t)j] == UNDEC) {
          g_r.push_back(i);
          g_c.push_back(j);
        }
      }
    }
  }
  s_r.reserve((size_t)s_nnz);
  s_c.reserve((size_t)s_nnz);
  for (int64_t i = 0; i < n; ++i) {
    if (state[(size_t)i] != UNDEC) continue;
    for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
      s_r.push_back(i);
      s_c.push_back(s_indices[p]);
    }
  }

  std::vector<uint8_t> lose((size_t)n);
  while (n_undec > 0) {
    std::fill(lose.begin(), lose.end(), 0);
    for (size_t e = 0; e < g_r.size(); ++e)
      if (w[(size_t)g_r[e]] <= w[(size_t)g_c[e]]) lose[(size_t)g_r[e]] = 1;
    int64_t n_new = 0;
    for (int64_t i = 0; i < n; ++i)
      if (state[(size_t)i] == UNDEC && !lose[(size_t)i]) {
        state[(size_t)i] = CPT;
        --n_undec;
        ++n_new;
      }
    if (n_new == 0) {
      // tie stalemate guard (mirrors numpy): promote max-w undecided
      int64_t best = -1;
      for (int64_t i = 0; i < n; ++i)
        if (state[(size_t)i] == UNDEC &&
            (best < 0 || w[(size_t)i] > w[(size_t)best]))
          best = i;
      if (best < 0) break;
      state[(size_t)best] = CPT;
      --n_undec;
    }
    // undecided points strongly depending on a new C become F
    size_t keep = 0;
    for (size_t e = 0; e < s_r.size(); ++e) {
      const int64_t r = s_r[e], c = s_c[e];
      if (state[(size_t)r] == UNDEC && state[(size_t)c] == CPT) {
        state[(size_t)r] = FPT;
        --n_undec;
      }
      (void)keep;
    }
    // shrink active sets
    size_t gk = 0;
    for (size_t e = 0; e < g_r.size(); ++e)
      if (state[(size_t)g_r[e]] == UNDEC && state[(size_t)g_c[e]] == UNDEC) {
        g_r[gk] = g_r[e];
        g_c[gk] = g_c[e];
        ++gk;
      }
    g_r.resize(gk);
    g_c.resize(gk);
    size_t sk = 0;
    for (size_t e = 0; e < s_r.size(); ++e)
      if (state[(size_t)s_r[e]] == UNDEC) {
        s_r[sk] = s_r[e];
        s_c[sk] = s_c[e];
        ++sk;
      }
    s_r.resize(sk);
    s_c.resize(sk);
  }
  std::memcpy(cf_out, state.data(), (size_t)n);
}

// ---------------------------------------------------------------------------
// Extended(+i) interpolation (mm-ext+i), row-wise formulation.
// Two-phase handle API (unknown output nnz).
// ---------------------------------------------------------------------------

typedef struct {
  int64_t n, nC, nnz;
  std::vector<int64_t> *p_indptr;
  std::vector<int64_t> *p_indices;
  std::vector<double> *p_data;
} hdrv_interp_handle;

void hdrv_interp_end(hdrv_interp_handle *h) {
  if (!h) return;
  delete h->p_indptr;
  delete h->p_indices;
  delete h->p_data;
  free(h);
}

hdrv_interp_handle *hdrv_interp_begin(
    int64_t n, const int64_t *a_indptr, const int64_t *a_indices,
    const void *a_data, int is_f32, const int64_t *s_indptr,
    const int64_t *s_indices, const int8_t *cf, int plus_i,
    double trunc_factor, int64_t max_nnz_row) {
  auto *h = (hdrv_interp_handle *)calloc(1, sizeof(hdrv_interp_handle));
  if (!h) return nullptr;
  h->p_indptr = new (std::nothrow) std::vector<int64_t>;
  h->p_indices = new (std::nothrow) std::vector<int64_t>;
  h->p_data = new (std::nothrow) std::vector<double>;
  if (!h->p_indptr || !h->p_indices || !h->p_data) return h;

  // F/C ranks
  std::vector<int64_t> rank((size_t)n);
  int64_t nF = 0, nC = 0;
  for (int64_t i = 0; i < n; ++i)
    rank[(size_t)i] = (cf[i] > 0) ? nC++ : nF++;
  h->n = n;
  h->nC = nC;

  // Per F-point: strong-entry scan helpers.  The strong pattern of row i
  // is s_indices[s_indptr[i]:s_indptr[i+1]]; values come from merging
  // with the (sorted) A row.
  // beta[kF] = Σ_{j strong-C of k} a_kj ; also per-F diag and weak sums.
  std::vector<double> beta((size_t)nF, 0.0), diagF((size_t)nF, 0.0),
      weakF((size_t)nF, 0.0);
  // strong rows cached as (col, val) with F/C split offsets
  std::vector<int64_t> fs_indptr((size_t)nF + 1, 0);
  for (int64_t i = 0; i < n; ++i)
    if (cf[i] < 0)
      fs_indptr[(size_t)rank[(size_t)i] + 1] =
          s_indptr[i + 1] - s_indptr[i];
  for (int64_t f = 0; f < nF; ++f) fs_indptr[(size_t)f + 1] += fs_indptr[(size_t)f];
  const int64_t fs_nnz = fs_indptr[(size_t)nF];
  std::vector<int64_t> fs_col((size_t)fs_nnz);
  std::vector<double> fs_val((size_t)fs_nnz);

  for (int64_t i = 0; i < n; ++i) {
    if (cf[i] >= 0) continue;
    const int64_t f = rank[(size_t)i];
    int64_t sp = s_indptr[i];
    const int64_t se = s_indptr[i + 1];
    int64_t out = fs_indptr[(size_t)f];
    double diag = 0.0, weak = 0.0, bsum = 0.0;
    (void)bsum;
    for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int64_t j = a_indices[p];
      const double v = is_f32 ? (double)((const float *)a_data)[p]
                              : ((const double *)a_data)[p];
      if (j == i) {
        diag += v;
        continue;
      }
      if (sp < se && s_indices[sp] == j) {
        fs_col[(size_t)out] = j;
        fs_val[(size_t)out] = v;
        ++out;
        ++sp;
      } else {
        weak += v;
      }
    }
    diagF[(size_t)f] = diag;
    weakF[(size_t)f] = weak;
  }
  // beta from the cached strong rows (C columns only)
  for (int64_t f = 0; f < nF; ++f) {
    double b = 0.0;
    for (int64_t p = fs_indptr[(size_t)f]; p < fs_indptr[(size_t)f + 1]; ++p)
      if (cf[fs_col[(size_t)p]] > 0) b += fs_val[(size_t)p];
    beta[(size_t)f] = b;
  }

  // Row-wise W build with dense accumulator over C-ranks.  Rows are
  // independent (all shared state above is read-only), so the loop
  // splits across two threads by row range — each writes private
  // output vectors that are stitched afterwards; per-row results are
  // bit-identical to the serial order.
  auto build_rows = [&](int64_t i0, int64_t i1,
                        std::vector<int64_t> &out_idx,
                        std::vector<double> &out_val,
                        std::vector<int64_t> &cnt) {
    std::vector<double> acc((size_t)nC, 0.0);
    std::vector<int64_t> touched;
    touched.reserve(64);
    std::vector<int64_t> wcols;
    std::vector<double> wvals;
    std::vector<std::pair<double, int64_t>> trunc_buf;
    out_idx.reserve((size_t)(i1 - i0) * 4);
    out_val.reserve((size_t)(i1 - i0) * 4);
    cnt.assign((size_t)(i1 - i0), 0);

    for (int64_t i = i0; i < i1; ++i) {
      const size_t row_start = out_idx.size();
      if (cf[i] > 0) {  // C-point: identity row
        out_idx.push_back(rank[(size_t)i]);
        out_val.push_back(1.0);
        cnt[(size_t)(i - i0)] = 1;
        continue;
      }
      const int64_t f = rank[(size_t)i];
      touched.clear();
      double gamma = 0.0;
      for (int64_t p = fs_indptr[(size_t)f]; p < fs_indptr[(size_t)f + 1];
           ++p) {
        const int64_t j = fs_col[(size_t)p];
        const double v = fs_val[(size_t)p];
        if (cf[j] > 0) {
          const int64_t c = rank[(size_t)j];
          if (acc[(size_t)c] == 0.0) touched.push_back(c);
          acc[(size_t)c] += v;
        } else {
          // strong F neighbor k = j: distribute through its C row
          const int64_t k = rank[(size_t)j];
          double a_ki = 0.0;
          if (plus_i) {
            // ā_ki: value of A_FF[k, i] (strong entry of row j at col i)
            const int64_t kb = fs_indptr[(size_t)k],
                          ke = fs_indptr[(size_t)k + 1];
            const int64_t *base = fs_col.data();
            const int64_t *lo =
                std::lower_bound(base + kb, base + ke, i);
            if (lo != base + ke && *lo == i)
              a_ki = fs_val[(size_t)(lo - base)];
          }
          double denom = beta[(size_t)k] + a_ki;
          if (denom == 0.0) denom = 1.0;
          const double g = v / denom;
          gamma += g * a_ki;
          for (int64_t q = fs_indptr[(size_t)k];
               q < fs_indptr[(size_t)k + 1]; ++q) {
            const int64_t jc = fs_col[(size_t)q];
            if (cf[jc] > 0) {
              const int64_t c = rank[(size_t)jc];
              if (acc[(size_t)c] == 0.0) touched.push_back(c);
              acc[(size_t)c] += g * fs_val[(size_t)q];
            }
          }
        }
      }
      double denom = diagF[(size_t)f] + weakF[(size_t)f] + gamma;
      if (denom == 0.0) denom = 1.0;
      const double scale0 = -1.0 / denom;

      // gather, sort by column
      std::sort(touched.begin(), touched.end());
      wcols.clear();
      wvals.clear();
      for (int64_t c : touched) {
        const double v = acc[(size_t)c] * scale0;
        acc[(size_t)c] = 0.0;
        if (v != 0.0) {
          wcols.push_back(c);
          wvals.push_back(v);
        }
      }
      // NOTE: a cancelled accumulator (exact 0) may leave a duplicate in
      // `touched`; acc reset handles it, the zero entry is dropped.

      // truncation: drop below trunc_factor*rowmax, keep top max_nnz_row
      // by |w| (ties -> lower column), rescale to preserve the row sum
      const size_t m = wcols.size();
      if (m && (trunc_factor > 0.0 || (max_nnz_row > 0 &&
                                       (int64_t)m > max_nnz_row))) {
        double orig_sum = 0.0, rowmax = 0.0;
        for (size_t p = 0; p < m; ++p) {
          orig_sum += wvals[p];
          rowmax = std::max(rowmax, std::fabs(wvals[p]));
        }
        trunc_buf.clear();
        for (size_t p = 0; p < m; ++p) {
          if (trunc_factor > 0.0 &&
              std::fabs(wvals[p]) < trunc_factor * rowmax)
            continue;
          trunc_buf.emplace_back(-std::fabs(wvals[p]), (int64_t)p);
        }
        if (max_nnz_row > 0 && (int64_t)trunc_buf.size() > max_nnz_row) {
          std::nth_element(trunc_buf.begin(),
                           trunc_buf.begin() + (size_t)(max_nnz_row - 1),
                           trunc_buf.end());
          trunc_buf.resize((size_t)max_nnz_row);
        }
        std::sort(trunc_buf.begin(), trunc_buf.end(),
                  [](const std::pair<double, int64_t> &a,
                     const std::pair<double, int64_t> &b) {
                    return a.second < b.second;
                  });
        double new_sum = 0.0;
        for (auto &pr : trunc_buf) new_sum += wvals[(size_t)pr.second];
        const double rescale =
            (new_sum != 0.0 && orig_sum != 0.0) ? orig_sum / new_sum : 1.0;
        for (auto &pr : trunc_buf) {
          out_idx.push_back(wcols[(size_t)pr.second]);
          out_val.push_back(wvals[(size_t)pr.second] * rescale);
        }
      } else {
        for (size_t p = 0; p < m; ++p) {
          out_idx.push_back(wcols[p]);
          out_val.push_back(wvals[p]);
        }
      }
      cnt[(size_t)(i - i0)] = (int64_t)(out_idx.size() - row_start);
    }
  };

  auto &P_indptr = *h->p_indptr;
  auto &P_indices = *h->p_indices;
  auto &P_data = *h->p_data;
  P_indptr.assign((size_t)n + 1, 0);

  if (n >= 32768) {
    const int64_t mid = n / 2;
    std::vector<int64_t> idx0, idx1, cnt0, cnt1;
    std::vector<double> val0, val1;
    std::thread th(build_rows, 0, mid, std::ref(idx0), std::ref(val0),
                   std::ref(cnt0));
    build_rows(mid, n, idx1, val1, cnt1);
    th.join();
    for (int64_t i = 0; i < mid; ++i)
      P_indptr[(size_t)i + 1] = P_indptr[(size_t)i] + cnt0[(size_t)i];
    for (int64_t i = mid; i < n; ++i)
      P_indptr[(size_t)i + 1] =
          P_indptr[(size_t)i] + cnt1[(size_t)(i - mid)];
    P_indices.resize((size_t)P_indptr[(size_t)n]);
    P_data.resize((size_t)P_indptr[(size_t)n]);
    std::copy(idx0.begin(), idx0.end(), P_indices.begin());
    std::copy(idx1.begin(), idx1.end(), P_indices.begin() + idx0.size());
    std::copy(val0.begin(), val0.end(), P_data.begin());
    std::copy(val1.begin(), val1.end(), P_data.begin() + val0.size());
  } else {
    std::vector<int64_t> idx, cnt;
    std::vector<double> val;
    build_rows(0, n, idx, val, cnt);
    for (int64_t i = 0; i < n; ++i)
      P_indptr[(size_t)i + 1] = P_indptr[(size_t)i] + cnt[(size_t)i];
    P_indices = std::move(idx);
    P_data = std::move(val);
  }
  h->nnz = (int64_t)P_indices.size();
  return h;
}

int64_t hdrv_interp_nnz(const hdrv_interp_handle *h) {
  return h ? h->nnz : -1;
}
int64_t hdrv_interp_ncols(const hdrv_interp_handle *h) {
  return h ? h->nC : -1;
}

void hdrv_interp_fill(const hdrv_interp_handle *h, int64_t *p_indptr,
                      int64_t *p_indices, double *p_data) {
  if (!h || !h->p_indptr) return;
  std::memcpy(p_indptr, h->p_indptr->data(),
              sizeof(int64_t) * h->p_indptr->size());
  std::memcpy(p_indices, h->p_indices->data(),
              sizeof(int64_t) * h->p_indices->size());
  std::memcpy(p_data, h->p_data->data(),
              sizeof(double) * h->p_data->size());
}

// ---------------------------------------------------------------------------
// Galerkin RAP:  Ac = Pᵀ A P  (both inputs CSR, values read at is_f32).
// Row-wise SMMP with a dense accumulator over coarse columns; Ac rows
// come out column-sorted.  Two-phase handle API.
// ---------------------------------------------------------------------------

typedef struct {
  int64_t nC, nnz;
  std::vector<int64_t> *indptr;
  std::vector<int64_t> *indices;
  std::vector<double> *data;
} hdrv_rap_handle;

void hdrv_rap_end(hdrv_rap_handle *h) {
  if (!h) return;
  delete h->indptr;
  delete h->indices;
  delete h->data;
  free(h);
}

hdrv_rap_handle *hdrv_rap_begin(int64_t n, const int64_t *a_indptr,
                                const int64_t *a_indices, const void *a_data,
                                int a_is_f32, int64_t nC,
                                const int64_t *p_indptr,
                                const int64_t *p_indices,
                                const double *p_data) {
  auto *h = (hdrv_rap_handle *)calloc(1, sizeof(hdrv_rap_handle));
  if (!h) return nullptr;
  h->indptr = new (std::nothrow) std::vector<int64_t>;
  h->indices = new (std::nothrow) std::vector<int64_t>;
  h->data = new (std::nothrow) std::vector<double>;
  if (!h->indptr || !h->indices || !h->data) return h;
  h->nC = nC;

  // T = A·P  (n × nC), row-wise with dense accumulator, split across
  // two threads (row ranges; each writes a private output then the
  // halves are stitched)
  std::vector<int64_t> t_indptr((size_t)n + 1, 0);
  std::vector<int64_t> t_indices;
  std::vector<double> t_data;
  {
    auto t_worker = [&](int64_t r0, int64_t r1,
                        std::vector<int64_t> &loc_cnt,
                        std::vector<int64_t> &loc_idx,
                        std::vector<double> &loc_dat) {
      std::vector<double> acc((size_t)nC, 0.0);
      std::vector<int64_t> touched;
      touched.reserve(256);
      loc_idx.reserve((size_t)((p_indptr[n] * 3) / 2));
      loc_dat.reserve((size_t)((p_indptr[n] * 3) / 2));
      for (int64_t i = r0; i < r1; ++i) {
        touched.clear();
        for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
          const int64_t k = a_indices[p];
          const double av = a_is_f32 ? (double)((const float *)a_data)[p]
                                     : ((const double *)a_data)[p];
          for (int64_t q = p_indptr[k]; q < p_indptr[k + 1]; ++q) {
            const int64_t c = p_indices[q];
            if (acc[(size_t)c] == 0.0 && !std::signbit(acc[(size_t)c]))
              touched.push_back(c);
            acc[(size_t)c] += av * p_data[q];
            if (acc[(size_t)c] == 0.0)
              acc[(size_t)c] = -0.0;  // keep membership on cancellation
          }
        }
        std::sort(touched.begin(), touched.end());
        for (int64_t c : touched) {
          loc_idx.push_back(c);
          loc_dat.push_back(acc[(size_t)c]);
          acc[(size_t)c] = 0.0;
        }
        loc_cnt[(size_t)(i - r0)] = (int64_t)touched.size();
      }
    };
    const int64_t mid = n / 2;
    std::vector<int64_t> cnt0((size_t)(mid > 0 ? mid : 0)),
        cnt1((size_t)(n - mid));
    std::vector<int64_t> idx0, idx1;
    std::vector<double> dat0, dat1;
    std::thread th(t_worker, 0, mid, std::ref(cnt0), std::ref(idx0),
                   std::ref(dat0));
    t_worker(mid, n, cnt1, idx1, dat1);
    th.join();
    for (int64_t i = 0; i < mid; ++i)
      t_indptr[(size_t)i + 1] = t_indptr[(size_t)i] + cnt0[(size_t)i];
    for (int64_t i = mid; i < n; ++i)
      t_indptr[(size_t)i + 1] =
          t_indptr[(size_t)i] + cnt1[(size_t)(i - mid)];
    t_indices.resize((size_t)t_indptr[(size_t)n]);
    t_data.resize((size_t)t_indptr[(size_t)n]);
    std::memcpy(t_indices.data(), idx0.data(),
                sizeof(int64_t) * idx0.size());
    std::memcpy(t_data.data(), dat0.data(), sizeof(double) * dat0.size());
    std::memcpy(t_indices.data() + idx0.size(), idx1.data(),
                sizeof(int64_t) * idx1.size());
    std::memcpy(t_data.data() + dat0.size(), dat1.data(),
                sizeof(double) * dat1.size());
  }

  // Pᵀ via counting transpose (fine rows grouped by coarse col)
  const int64_t p_nnz = p_indptr[n];
  std::vector<int64_t> pt_indptr((size_t)nC + 1, 0);
  std::vector<int64_t> pt_rows((size_t)p_nnz);
  std::vector<double> pt_vals((size_t)p_nnz);
  for (int64_t p = 0; p < p_nnz; ++p) ++pt_indptr[(size_t)p_indices[p] + 1];
  for (int64_t c = 0; c < nC; ++c)
    pt_indptr[(size_t)c + 1] += pt_indptr[(size_t)c];
  {
    std::vector<int64_t> cur(pt_indptr.begin(), pt_indptr.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      for (int64_t p = p_indptr[i]; p < p_indptr[i + 1]; ++p) {
        const int64_t c = p_indices[p];
        pt_rows[(size_t)cur[(size_t)c]] = i;
        pt_vals[(size_t)cur[(size_t)c]] = p_data[p];
        ++cur[(size_t)c];
      }
  }

  // Ac = Pᵀ·T, row-wise — two threads over coarse-row ranges, private
  // outputs stitched afterwards (same pattern as the A·P stage)
  auto &c_indptr = *h->indptr;
  auto &c_indices = *h->indices;
  auto &c_data = *h->data;
  c_indptr.assign((size_t)nC + 1, 0);
  {
    auto c_worker = [&](int64_t c0, int64_t c1,
                        std::vector<int64_t> &loc_cnt,
                        std::vector<int64_t> &loc_idx,
                        std::vector<double> &loc_dat) {
      std::vector<double> acc((size_t)nC, 0.0);
      std::vector<int64_t> touched;
      touched.reserve(512);
      for (int64_t c = c0; c < c1; ++c) {
        touched.clear();
        for (int64_t p = pt_indptr[(size_t)c]; p < pt_indptr[(size_t)c + 1];
             ++p) {
          const int64_t i = pt_rows[(size_t)p];
          const double pv = pt_vals[(size_t)p];
          for (int64_t q = t_indptr[(size_t)i]; q < t_indptr[(size_t)i + 1];
               ++q) {
            const int64_t cc = t_indices[(size_t)q];
            if (acc[(size_t)cc] == 0.0 && !std::signbit(acc[(size_t)cc]))
              touched.push_back(cc);
            acc[(size_t)cc] += pv * t_data[(size_t)q];
            if (acc[(size_t)cc] == 0.0) acc[(size_t)cc] = -0.0;
          }
        }
        std::sort(touched.begin(), touched.end());
        int64_t prev = -1;
        int64_t cnt = 0;
        for (int64_t cc : touched) {
          if (cc == prev) continue;
          prev = cc;
          loc_idx.push_back(cc);
          loc_dat.push_back(acc[(size_t)cc]);
          acc[(size_t)cc] = 0.0;
          ++cnt;
        }
        loc_cnt[(size_t)(c - c0)] = cnt;
      }
    };
    const int64_t cmid = nC / 2;
    std::vector<int64_t> cnt0((size_t)(cmid > 0 ? cmid : 0)),
        cnt1((size_t)(nC - cmid));
    std::vector<int64_t> idx0, idx1;
    std::vector<double> dat0, dat1;
    idx0.reserve((size_t)t_indices.size() / 2);
    dat0.reserve((size_t)t_indices.size() / 2);
    idx1.reserve((size_t)t_indices.size() / 2);
    dat1.reserve((size_t)t_indices.size() / 2);
    std::thread th(c_worker, 0, cmid, std::ref(cnt0), std::ref(idx0),
                   std::ref(dat0));
    c_worker(cmid, nC, cnt1, idx1, dat1);
    th.join();
    for (int64_t c = 0; c < cmid; ++c)
      c_indptr[(size_t)c + 1] = c_indptr[(size_t)c] + cnt0[(size_t)c];
    for (int64_t c = cmid; c < nC; ++c)
      c_indptr[(size_t)c + 1] =
          c_indptr[(size_t)c] + cnt1[(size_t)(c - cmid)];
    c_indices.resize((size_t)c_indptr[(size_t)nC]);
    c_data.resize((size_t)c_indptr[(size_t)nC]);
    std::memcpy(c_indices.data(), idx0.data(), sizeof(int64_t) * idx0.size());
    std::memcpy(c_data.data(), dat0.data(), sizeof(double) * dat0.size());
    std::memcpy(c_indices.data() + idx0.size(), idx1.data(),
                sizeof(int64_t) * idx1.size());
    std::memcpy(c_data.data() + dat0.size(), dat1.data(),
                sizeof(double) * dat1.size());
  }
  h->nnz = (int64_t)c_indices.size();
  return h;
}

int64_t hdrv_rap_nnz(const hdrv_rap_handle *h) { return h ? h->nnz : -1; }

void hdrv_rap_fill(const hdrv_rap_handle *h, int64_t *indptr,
                   int64_t *indices, double *data) {
  if (!h || !h->indptr) return;
  std::memcpy(indptr, h->indptr->data(), sizeof(int64_t) * h->indptr->size());
  std::memcpy(indices, h->indices->data(),
              sizeof(int64_t) * h->indices->size());
  std::memcpy(data, h->data->data(), sizeof(double) * h->data->size());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// DIA + rest split for the device-matrix builder (ops/device_matrix.py
// from_csr): census the diagonal occupancy of a canonical CSR, select
// diagonals present in >= min_count rows (top max_diags by count), emit
// the dense per-diagonal data plus the remaining COO entries.  Replaces
// ~6 numpy passes over nnz-sized arrays with two threaded C passes —
// the dominant warm-setup cost on the 2-core host (ROADMAP perf #2).
//   h = hdrv_dia_split_begin(n_rows, n_cols, indptr, indices, data,
//                            is_f32, min_count, max_diags)
//   hdrv_dia_split_sizes(h, &n_dia, &n_rest)
//   hdrv_dia_split_fill(h, offsets, dia_data, r_rows, r_cols, r_vals)
//   (fill frees the handle; buffers are caller-allocated:
//    dia_data (n_dia * n_rows) f64 zero-filled by callee,
//    r_vals f32 or f64 matching is_f32)
// ---------------------------------------------------------------------------

namespace {
struct DiaSplitState {
  int64_t n_rows, n_cols, nnz;
  const int64_t *indptr;
  const int64_t *indices;
  const void *data;
  int is_f32;
  std::vector<int64_t> good;     // selected diagonal offsets (sorted)
  std::vector<int32_t> lut;      // (col - row + n_rows - 1) -> dia idx | -1
  int64_t n_rest;
};

static unsigned dia_nthreads() {
  unsigned t = std::thread::hardware_concurrency();
  return t ? (t > 8 ? 8 : t) : 2;
}
}  // namespace

extern "C" {

void *hdrv_dia_split_begin(int64_t n_rows, int64_t n_cols,
                           const int64_t *indptr, const int64_t *indices,
                           const void *data, int is_f32,
                           int64_t min_count, int64_t max_diags) {
  auto *h = new DiaSplitState();
  h->n_rows = n_rows;
  h->n_cols = n_cols;
  h->nnz = indptr[n_rows];
  h->indptr = indptr;
  h->indices = indices;
  h->data = data;
  h->is_f32 = is_f32;

  const int64_t span = n_rows + n_cols - 1;
  const unsigned nt = dia_nthreads();
  std::vector<std::vector<int64_t>> cnt_loc(nt);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nt; ++t) {
    threads.emplace_back([&, t] {
      auto &cnt = cnt_loc[t];
      cnt.assign((size_t)span, 0);
      int64_t r0 = (int64_t)((n_rows * (int64_t)t) / nt);
      int64_t r1 = (int64_t)((n_rows * (int64_t)(t + 1)) / nt);
      for (int64_t r = r0; r < r1; ++r)
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p)
          ++cnt[(size_t)(indices[p] - r + n_rows - 1)];
    });
  }
  for (auto &th : threads) th.join();
  std::vector<int64_t> cnt((size_t)span, 0);
  for (unsigned t = 0; t < nt; ++t)
    for (int64_t i = 0; i < span; ++i) cnt[(size_t)i] += cnt_loc[t][(size_t)i];

  // selection: count >= min_count; cap at max_diags keeping the largest
  // counts (stable in offset order) — mirrors device_matrix.from_csr
  std::vector<int64_t> good;
  for (int64_t i = 0; i < span; ++i)
    if (cnt[(size_t)i] >= min_count) good.push_back(i);
  if ((int64_t)good.size() > max_diags) {
    std::stable_sort(good.begin(), good.end(), [&](int64_t a, int64_t b) {
      return cnt[(size_t)a] > cnt[(size_t)b];
    });
    good.resize((size_t)max_diags);
    std::sort(good.begin(), good.end());
  }
  h->lut.assign((size_t)span, -1);
  int64_t covered = 0;
  for (size_t d = 0; d < good.size(); ++d) {
    h->lut[(size_t)good[d]] = (int32_t)d;
    covered += cnt[(size_t)good[d]];
  }
  h->n_rest = h->nnz - covered;
  h->good.resize(good.size());
  for (size_t d = 0; d < good.size(); ++d)
    h->good[d] = good[d] - (n_rows - 1);   // store as true offsets
  return h;
}

void hdrv_dia_split_sizes(const void *hv, int64_t *n_dia, int64_t *n_rest) {
  auto *h = (const DiaSplitState *)hv;
  *n_dia = (int64_t)h->good.size();
  *n_rest = h->n_rest;
}

void hdrv_dia_split_fill(void *hv, int64_t *offsets, double *dia_data,
                         int64_t *r_rows, int64_t *r_cols, void *r_vals) {
  auto *h = (DiaSplitState *)hv;
  const int64_t n_rows = h->n_rows;
  const int64_t D = (int64_t)h->good.size();
  for (int64_t d = 0; d < D; ++d) offsets[d] = h->good[(size_t)d];
  if (D) std::memset(dia_data, 0, sizeof(double) * (size_t)(D * n_rows));

  const unsigned nt = dia_nthreads();
  // pass 1: per-block rest counts -> exact output offsets
  std::vector<int64_t> rest_at(nt + 1, 0);
  {
    std::vector<std::thread> threads;
    std::vector<int64_t> loc(nt, 0);
    for (unsigned t = 0; t < nt; ++t) {
      threads.emplace_back([&, t] {
        int64_t r0 = (int64_t)((n_rows * (int64_t)t) / nt);
        int64_t r1 = (int64_t)((n_rows * (int64_t)(t + 1)) / nt);
        int64_t c = 0;
        for (int64_t r = r0; r < r1; ++r)
          for (int64_t p = h->indptr[r]; p < h->indptr[r + 1]; ++p)
            if (h->lut[(size_t)(h->indices[p] - r + n_rows - 1)] < 0) ++c;
        loc[t] = c;
      });
    }
    for (auto &th : threads) th.join();
    for (unsigned t = 0; t < nt; ++t) rest_at[t + 1] = rest_at[t] + loc[t];
  }
  // pass 2: fill dia rows + rest COO (threaded; disjoint outputs)
  {
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < nt; ++t) {
      threads.emplace_back([&, t] {
        int64_t r0 = (int64_t)((n_rows * (int64_t)t) / nt);
        int64_t r1 = (int64_t)((n_rows * (int64_t)(t + 1)) / nt);
        int64_t w = rest_at[t];
        const float *df = (const float *)h->data;
        const double *dd = (const double *)h->data;
        float *rvf = (float *)r_vals;
        double *rvd = (double *)r_vals;
        for (int64_t r = r0; r < r1; ++r) {
          for (int64_t p = h->indptr[r]; p < h->indptr[r + 1]; ++p) {
            const int64_t c = h->indices[p];
            const double v = h->is_f32 ? (double)df[p] : dd[p];
            const int32_t d = h->lut[(size_t)(c - r + n_rows - 1)];
            if (d >= 0) {
              dia_data[(size_t)d * (size_t)n_rows + (size_t)r] = v;
            } else {
              r_rows[w] = r;
              r_cols[w] = c;
              if (h->is_f32) rvf[w] = (float)v; else rvd[w] = v;
              ++w;
            }
          }
        }
      });
    }
    for (auto &th : threads) th.join();
  }
  delete h;
}

}  // extern "C"
