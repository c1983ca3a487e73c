// Native IJ file I/O for hypredrive_tpu.
//
// Native equivalent of the reference's C readers (ref:
// src/internal/matrix.c:142-230, src/internal/vector.c:92-210 and the
// ASCII paths behind HYPRE_IJMatrixRead): the ASCII COO parse is the
// hot I/O path for large matrix files and is ~20x faster here than
// numpy.loadtxt.  Exposed to Python via ctypes (no pybind11 in the
// image); buffers are malloc'd here, copied into numpy arrays by the
// caller, then released with hdrv_ij_free.
//
// Build: make -C native   ->  native/libhypredrv_io.so

#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <malloc.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

// The planner/RAP/transpose kernels allocate multi-MB scratch vectors
// per call; glibc mmaps blocks that size and munmaps them on free, so
// every AMG level re-pays soft page faults for the same footprint (≈3 s
// of the 64³ setup on this host).  Keep large blocks on the heap and
// never trim, so the faults are paid once per process.
__attribute__((constructor)) static void hdrv_malloc_tune(void) {
  mallopt(M_MMAP_THRESHOLD, 1 << 30);
  mallopt(M_TRIM_THRESHOLD, 1 << 30);
}

extern "C" {

typedef struct {
  int64_t ilower, iupper, jlower, jupper;  // header window
  int64_t nnz;                             // matrix entries parsed
  int64_t n;                               // vector length
  int64_t *rows;                           // [nnz]
  int64_t *cols;                           // [nnz]
  double *vals;                            // [nnz] or [n]
  char err[256];
} hdrv_ij_buf;

static hdrv_ij_buf *new_buf() {
  hdrv_ij_buf *b = (hdrv_ij_buf *)calloc(1, sizeof(hdrv_ij_buf));
  return b;
}

void hdrv_ij_free(hdrv_ij_buf *b) {
  if (!b) return;
  free(b->rows);
  free(b->cols);
  free(b->vals);
  free(b);
}

namespace {

struct MappedFile {
  const char *data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open_map(const char *path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) {
      // empty file maps are invalid; treat as zero-size OK
      size = 0;
      data = nullptr;
      return st.st_size == 0;
    }
    size = (size_t)st.st_size;
    void *p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) return false;
    madvise(p, size, MADV_SEQUENTIAL);
    data = (const char *)p;
    return true;
  }

  ~MappedFile() {
    if (data) munmap((void *)data, size);
    if (fd >= 0) close(fd);
  }
};

inline void skip_ws(const char *&p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
}

inline bool parse_i64(const char *&p, const char *end, int64_t &out) {
  skip_ws(p, end);
  if (p >= end) return false;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  else if (*p == '+') ++p;
  if (p >= end || !isdigit((unsigned char)*p)) return false;
  int64_t v = 0;
  while (p < end && isdigit((unsigned char)*p)) v = v * 10 + (*p++ - '0');
  out = neg ? -v : v;
  return true;
}

inline bool parse_f64(const char *&p, const char *end, double &out) {
  skip_ws(p, end);
  if (p >= end) return false;
  char *q = nullptr;
  errno = 0;
  out = strtod(p, &q);
  if (q == p) return false;
  p = q;
  return true;
}

}  // namespace

// ASCII matrix: "ilower iupper jlower jupper\n" then "row col val" lines.
hdrv_ij_buf *hdrv_read_ij_matrix_ascii(const char *path) {
  hdrv_ij_buf *b = new_buf();
  if (!b) return nullptr;
  MappedFile mf;
  if (!mf.open_map(path)) {
    snprintf(b->err, sizeof b->err, "cannot open %s", path);
    return b;
  }
  const char *p = mf.data, *end = mf.data + mf.size;
  if (!parse_i64(p, end, b->ilower) || !parse_i64(p, end, b->iupper) ||
      !parse_i64(p, end, b->jlower) || !parse_i64(p, end, b->jupper)) {
    snprintf(b->err, sizeof b->err, "bad IJ ASCII header in %s", path);
    return b;
  }
  // Upper bound on entries: one per remaining line.
  size_t cap = 1024;
  {
    size_t nl = 0;
    for (const char *q = p; q < end; ++q) nl += (*q == '\n');
    cap = nl + 2;
  }
  b->rows = (int64_t *)malloc(cap * sizeof(int64_t));
  b->cols = (int64_t *)malloc(cap * sizeof(int64_t));
  b->vals = (double *)malloc(cap * sizeof(double));
  if (!b->rows || !b->cols || !b->vals) {
    snprintf(b->err, sizeof b->err, "out of memory (%zu entries)", cap);
    return b;
  }
  int64_t n = 0;
  for (;;) {
    int64_t r, c;
    double v;
    skip_ws(p, end);
    if (p >= end) break;
    if (!parse_i64(p, end, r) || !parse_i64(p, end, c) ||
        !parse_f64(p, end, v)) {
      snprintf(b->err, sizeof b->err,
               "malformed entry near offset %ld in %s",
               (long)(p - mf.data), path);
      return b;
    }
    if (!std::isfinite(v)) {
      // ref: matrix.c rejects non-finite coefficients
      snprintf(b->err, sizeof b->err,
               "non-finite coefficient at entry %lld in %s",
               (long long)n, path);
      return b;
    }
    if ((size_t)n >= cap) {
      snprintf(b->err, sizeof b->err, "entry overflow in %s", path);
      return b;
    }
    b->rows[n] = r;
    b->cols[n] = c;
    b->vals[n] = v;
    ++n;
  }
  b->nnz = n;
  return b;
}

// ASCII vector: "ilower iupper\n" then "row val" lines.
hdrv_ij_buf *hdrv_read_ij_vector_ascii(const char *path) {
  hdrv_ij_buf *b = new_buf();
  if (!b) return nullptr;
  MappedFile mf;
  if (!mf.open_map(path)) {
    snprintf(b->err, sizeof b->err, "cannot open %s", path);
    return b;
  }
  const char *p = mf.data, *end = mf.data + mf.size;
  if (!parse_i64(p, end, b->ilower) || !parse_i64(p, end, b->iupper)) {
    snprintf(b->err, sizeof b->err, "bad IJ ASCII vector header in %s", path);
    return b;
  }
  int64_t len = b->iupper - b->ilower + 1;
  if (len < 0) {
    snprintf(b->err, sizeof b->err, "negative window in %s", path);
    return b;
  }
  b->rows = (int64_t *)malloc((size_t)len * sizeof(int64_t));
  b->vals = (double *)calloc((size_t)len, sizeof(double));
  if (!b->rows || !b->vals) {
    snprintf(b->err, sizeof b->err, "out of memory (%lld rows)",
             (long long)len);
    return b;
  }
  int64_t n = 0;
  for (;;) {
    int64_t r;
    double v;
    skip_ws(p, end);
    if (p >= end) break;
    if (!parse_i64(p, end, r) || !parse_f64(p, end, v)) {
      snprintf(b->err, sizeof b->err,
               "malformed vector entry near offset %ld in %s",
               (long)(p - mf.data), path);
      return b;
    }
    if (!std::isfinite(v)) {
      snprintf(b->err, sizeof b->err,
               "non-finite value at entry %lld in %s", (long long)n, path);
      return b;
    }
    int64_t idx = r - b->ilower;
    if (idx < 0 || idx >= len) {
      snprintf(b->err, sizeof b->err,
               "row %lld outside window [%lld,%lld] in %s", (long long)r,
               (long long)b->ilower, (long long)b->iupper, path);
      return b;
    }
    if (n >= len) {
      snprintf(b->err, sizeof b->err, "vector entry overflow in %s", path);
      return b;
    }
    b->rows[n] = idx;
    b->vals[idx] = v;
    ++n;
  }
  b->n = len;
  b->nnz = n;
  return b;
}

// Fast ASCII writers (print_system dumps of large systems).
int hdrv_write_ij_matrix_ascii(const char *path, int64_t ilower,
                               int64_t iupper, int64_t jlower,
                               int64_t jupper, const int64_t *rows,
                               const int64_t *cols, const double *vals,
                               int64_t nnz) {
  FILE *f = fopen(path, "w");
  if (!f) return -1;
  char buf[1 << 16];
  setvbuf(f, buf, _IOFBF, sizeof buf);
  fprintf(f, "%lld %lld %lld %lld\n", (long long)ilower, (long long)iupper,
          (long long)jlower, (long long)jupper);
  for (int64_t i = 0; i < nnz; ++i)
    fprintf(f, "%lld %lld %.15e\n", (long long)rows[i], (long long)cols[i],
            vals[i]);
  int rc = ferror(f);
  fclose(f);
  return rc ? -2 : 0;
}

int hdrv_write_ij_vector_ascii(const char *path, int64_t ilower,
                               const double *vals, int64_t n) {
  FILE *f = fopen(path, "w");
  if (!f) return -1;
  char buf[1 << 16];
  setvbuf(f, buf, _IOFBF, sizeof buf);
  fprintf(f, "%lld %lld\n", (long long)ilower, (long long)(ilower + n - 1));
  for (int64_t i = 0; i < n; ++i)
    fprintf(f, "%lld %.15e\n", (long long)(ilower + i), vals[i]);
  int rc = ferror(f);
  fclose(f);
  return rc ? -2 : 0;
}

}  // extern "C"

#include <algorithm>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

// ---------------------------------------------------------------------------
// LZ4 block codec (raw block format, as LZ4_compress_default /
// LZ4_decompress_safe produce/consume).  The reference compresses lsseq
// blobs with exactly this block format plus a uint64 original-size
// prefix (ref: src/internal/comp.c:258-340 compress_lz4/lz4hc) — this
// clean-room implementation reads/writes the same byte stream so
// reference-produced .lz4/.lz4hc containers interoperate.
// ---------------------------------------------------------------------------

extern "C" {

// Greedy hash-table encoder (12-bit hash of 4-byte windows, step-1
// search).  Returns compressed size, or -1 if dst is too small.
int64_t hdrv_lz4_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                          int64_t dst_cap) {
  const int64_t MINMATCH = 4;
  const int64_t MFLIMIT = 12;    // last 12 bytes are always literals
  int64_t ht[1 << 12];
  for (int64_t i = 0; i < (1 << 12); ++i) ht[i] = -1;
  int64_t ip = 0, anchor = 0, op = 0;

  auto hash4 = [&](int64_t p) -> uint32_t {
    uint32_t v = (uint32_t)src[p] | ((uint32_t)src[p + 1] << 8) |
                 ((uint32_t)src[p + 2] << 16) | ((uint32_t)src[p + 3] << 24);
    return (v * 2654435761u) >> 20;
  };
  auto emit = [&](int64_t lit_len, int64_t match_len, int64_t offset) -> bool {
    // token + literal length
    int64_t need = 1 + lit_len / 255 + 1 + lit_len + 2 + match_len / 255 + 1;
    if (op + need >= dst_cap) return false;
    uint8_t token = 0;
    token = (uint8_t)((lit_len >= 15 ? 15 : lit_len) << 4);
    if (match_len >= 0)
      token |= (uint8_t)((match_len - MINMATCH) >= 15
                             ? 15
                             : (match_len - MINMATCH));
    dst[op++] = token;
    if (lit_len >= 15) {
      int64_t rest = lit_len - 15;
      while (rest >= 255) {
        dst[op++] = 255;
        rest -= 255;
      }
      dst[op++] = (uint8_t)rest;
    }
    memcpy(dst + op, src + anchor, (size_t)lit_len);
    op += lit_len;
    if (match_len >= 0) {
      dst[op++] = (uint8_t)(offset & 0xff);
      dst[op++] = (uint8_t)((offset >> 8) & 0xff);
      int64_t rest = match_len - MINMATCH;
      if (rest >= 15) {
        rest -= 15;
        while (rest >= 255) {
          dst[op++] = 255;
          rest -= 255;
        }
        dst[op++] = (uint8_t)rest;
      }
    }
    return true;
  };

  if (n >= MFLIMIT) {
    while (ip < n - MFLIMIT) {
      uint32_t h = hash4(ip);
      int64_t cand = ht[h];
      ht[h] = ip;
      if (cand >= 0 && ip - cand <= 65535 &&
          memcmp(src + cand, src + ip, 4) == 0) {
        // extend the match (respect the end margin)
        int64_t mlen = 4;
        const int64_t limit = n - 5;   // last 5 bytes: literals only
        while (ip + mlen < limit && src[cand + mlen] == src[ip + mlen])
          ++mlen;
        if (!emit(ip - anchor, mlen, ip - cand)) return -1;
        ip += mlen;
        anchor = ip;
        continue;
      }
      ++ip;
    }
  }
  // trailing literals (always at least the last MFLIMIT bytes)
  if (!emit(n - anchor, -1, 0)) return -1;
  return op;
}

// Safe decoder; returns decompressed size or -1 on malformed input.
int64_t hdrv_lz4_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                            int64_t dst_cap) {
  int64_t ip = 0, op = 0;
  while (ip < n) {
    uint8_t token = src[ip++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > n || op + lit > dst_cap) return -1;
    memcpy(dst + op, src + ip, (size_t)lit);
    ip += lit;
    op += lit;
    if (ip >= n) break;               // last sequence: literals only
    if (ip + 2 > n) return -1;
    int64_t offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
    ip += 2;
    if (offset == 0 || offset > op) return -1;
    int64_t mlen = (token & 15) + 4;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        mlen += b;
      } while (b == 255);
    }
    if (op + mlen > dst_cap) return -1;
    // overlapping copy must be byte-wise
    for (int64_t k = 0; k < mlen; ++k) {
      dst[op + k] = dst[op + k - offset];
    }
    op += mlen;
  }
  return op;
}

}  // extern "C"
