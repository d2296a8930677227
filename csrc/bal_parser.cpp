// Fast BAL (Bundle Adjustment in the Large) file parser.
//
// Native-runtime component of the bundle-adjustment framework: the
// reference streams .txt.bz2 through Julia's CodecBzip2 wrapper over libbz2
// and parses line-by-line (/root/reference/src/ReadFiles.jl:9-53); at
// Venice/Final scale (9M observation lines) that parse dominates startup.
// This parser slurps the file (optionally inflating bz2 via libbz2), then
// scans the buffer once with strtod/strtol — no line splitting, no
// allocation per token.
//
// C ABI (consumed from Python via ctypes, no pybind11 dependency):
//   bal_read_header(path, &ncams, &npnts, &nobs) -> 0 on success
//   bal_parse(path, cam_idx, pnt_idx, pt2d, cams, points) -> 0 on success
// where the caller allocates:
//   cam_idx, pnt_idx : int64 [nobs]
//   pt2d             : double [nobs * 2]
//   cams             : double [ncams * 9]   (file order: r, t, f, k1, k2)
//   points           : double [npnts * 3]
//
// Build: g++ -O3 -shared -fPIC bal_parser.cpp -o _bal_native.so [-lbz2]

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#if defined(BAL_HAVE_BZ2)
#if defined(__has_include) && __has_include(<bzlib.h>)
#include <bzlib.h>
#else
// Runtime ships libbz2.so but not the dev header; the ABI below has been
// stable since bzip2 1.0 (matches /usr/include/bzlib.h).
#define BZ_OK 0
#define BZ_STREAM_END 4
typedef void BZFILE;
extern "C" {
BZFILE* BZ2_bzReadOpen(int* bzerror, FILE* f, int verbosity, int small,
                       void* unused, int nUnused);
int BZ2_bzRead(int* bzerror, BZFILE* b, void* buf, int len);
void BZ2_bzReadClose(int* bzerror, BZFILE* b);
}
#endif
#endif

namespace {

// Read an entire file (inflating .bz2 when built with BAL_HAVE_BZ2) into a
// NUL-terminated buffer.
bool slurp(const char* path, std::vector<char>& out) {
  const size_t len = std::strlen(path);
  const bool is_bz2 = len > 4 && std::strcmp(path + len - 4, ".bz2") == 0;
  if (is_bz2) {
#if defined(BAL_HAVE_BZ2)
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    int bzerr = BZ_OK;
    BZFILE* bz = BZ2_bzReadOpen(&bzerr, f, 0, 0, nullptr, 0);
    if (bzerr != BZ_OK) { std::fclose(f); return false; }
    out.clear();
    std::vector<char> chunk(1 << 20);
    while (bzerr == BZ_OK) {
      int n = BZ2_bzRead(&bzerr, bz, chunk.data(), (int)chunk.size());
      if (bzerr == BZ_OK || bzerr == BZ_STREAM_END)
        out.insert(out.end(), chunk.data(), chunk.data() + n);
    }
    const bool ok = (bzerr == BZ_STREAM_END);
    BZ2_bzReadClose(&bzerr, bz);
    std::fclose(f);
    if (!ok) return false;
    out.push_back('\0');
    return true;
#else
    return false;  // bz2 not compiled in; Python falls back to stdlib bz2
#endif
  }
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize((size_t)sz + 1);
  const size_t rd = std::fread(out.data(), 1, (size_t)sz, f);
  std::fclose(f);
  if (rd != (size_t)sz) return false;
  out[(size_t)sz] = '\0';
  return true;
}

// `ok` latches false if a token fails to parse (e.g. truncated file:
// strtod stops advancing at the terminating NUL and would otherwise
// silently yield zeros forever).
inline int64_t next_i64(const char*& p, bool& ok) {
  char* end = nullptr;
  const int64_t v = std::strtoll(p, &end, 10);
  if (end == p) ok = false;
  p = end;
  return v;
}

inline double next_f64(const char*& p, bool& ok) {
  char* end = nullptr;
  const double v = std::strtod(p, &end);
  if (end == p) ok = false;
  p = end;
  return v;
}

}  // namespace

extern "C" {

int bal_read_header(const char* path, int64_t* ncams, int64_t* npnts,
                    int64_t* nobs) {
  // Header is the first line; for plain files read only a small prefix.
  const size_t len = std::strlen(path);
  const bool is_bz2 = len > 4 && std::strcmp(path + len - 4, ".bz2") == 0;
  std::vector<char> buf;
  if (is_bz2) {
    if (!slurp(path, buf)) return 1;
  } else {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    buf.resize(256);
    const size_t rd = std::fread(buf.data(), 1, 255, f);
    std::fclose(f);
    buf[rd] = '\0';
  }
  const char* p = buf.data();
  bool ok = true;
  *ncams = next_i64(p, ok);
  *npnts = next_i64(p, ok);
  *nobs = next_i64(p, ok);
  return (ok && *ncams > 0 && *npnts > 0 && *nobs > 0) ? 0 : 1;
}

int bal_parse(const char* path, int64_t* cam_idx, int64_t* pnt_idx,
              double* pt2d, double* cams, double* points) {
  std::vector<char> buf;
  if (!slurp(path, buf)) return 1;
  const char* p = buf.data();
  const char* end = buf.data() + buf.size() - 1;
  bool ok = true;

  const int64_t ncams = next_i64(p, ok);
  const int64_t npnts = next_i64(p, ok);
  const int64_t nobs = next_i64(p, ok);
  if (!ok || ncams <= 0 || npnts <= 0 || nobs <= 0) return 1;

  for (int64_t k = 0; k < nobs && ok; ++k) {
    cam_idx[k] = next_i64(p, ok);
    pnt_idx[k] = next_i64(p, ok);
    pt2d[2 * k] = next_f64(p, ok);
    pt2d[2 * k + 1] = next_f64(p, ok);
  }
  for (int64_t i = 0; i < 9 * ncams && ok; ++i) cams[i] = next_f64(p, ok);
  for (int64_t i = 0; i < 3 * npnts && ok; ++i) points[i] = next_f64(p, ok);
  // every token parsed and p never ran off the buffer?
  return (ok && p <= end) ? 0 : 1;
}

}  // extern "C"
