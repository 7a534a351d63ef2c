// Native host data plane: multithreaded fixed-width HITRAN .par parser.
//
// C++ counterpart of the framework's numpy parser (spectra/par.py), replacing
// the reference's single-threaded per-line Julia loop (ClearSky.jl
// src/hitran/par.jl:127-152). One pass over an in-memory copy of the file,
// records split on newlines, numeric columns converted with a fixed-width
// strtod, threads striped over record ranges. Exposed as a plain C ABI for
// ctypes (no pybind11 in the image).
//
// Built at first use by clearsky_tpu_torch/native/__init__.py (g++ -O3 -shared
// -fPIC -pthread -std=c++17) into the repository's build/ directory.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

// HITRAN 2004 record layout, 0-based [start, stop) — must match
// spectra/par.py PAR_COLUMNS (ref par.jl:131-149).
struct Field { int a, b; };
constexpr Field F_M{0, 2}, F_I{2, 3}, F_NU{3, 15}, F_S{15, 25}, F_A{25, 35},
    F_GA{35, 40}, F_GS{40, 45}, F_EPP{45, 55}, F_NA{55, 59}, F_DA{59, 67};
constexpr int RECORD = 160;

double parse_field(const char* rec, Field f) {
  char buf[24];
  int w = f.b - f.a;
  std::memcpy(buf, rec + f.a, w);
  buf[w] = '\0';
  char* end = nullptr;
  double v = std::strtod(buf, &end);
  if (end == buf) return 0.0;  // blank field -> 0 (matches numpy path)
  // a PARTIAL parse (e.g. a Fortran 'D' exponent or corruption) must not
  // pass silently — the numpy path raises on such fields. Signal with NaN;
  // the Python wrapper detects it and falls back to the strict parser.
  while (*end == ' ' || *end == '\t') ++end;
  if (*end != '\0') return std::numeric_limits<double>::quiet_NaN();
  return v;
}

struct Out {
  double *nu, *S, *A, *ga, *gs, *Epp, *na, *da;
  int16_t* M;
  char* I;
};

void parse_range(const std::vector<const char*>& recs, int64_t lo, int64_t hi,
                 Out o) {
  for (int64_t i = lo; i < hi; ++i) {
    const char* r = recs[i];
    o.M[i] = static_cast<int16_t>(parse_field(r, F_M));
    o.I[i] = r[F_I.a];
    o.nu[i] = parse_field(r, F_NU);
    o.S[i] = parse_field(r, F_S);
    o.A[i] = parse_field(r, F_A);
    o.ga[i] = parse_field(r, F_GA);
    o.gs[i] = parse_field(r, F_GS);
    o.Epp[i] = parse_field(r, F_EPP);
    o.na[i] = parse_field(r, F_NA);
    o.da[i] = parse_field(r, F_DA);
  }
}

}  // namespace

extern "C" {

// Parses `path`; fills the output pointers with malloc'd arrays of length
// n (the return value). Returns -1 on I/O error. Caller frees each array
// with clearsky_free.
int64_t clearsky_parse_par(const char* path, double** nu, double** S,
                           double** A, double** ga, double** gs, double** Epp,
                           double** na, double** da, int16_t** M, char** I) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::vector<char> data(static_cast<size_t>(size));
  if (size > 0 && std::fread(data.data(), 1, size, fp) != static_cast<size_t>(size)) {
    std::fclose(fp);
    return -1;
  }
  std::fclose(fp);

  // split on newlines; keep lines of at least RECORD chars (numpy-path rule)
  std::vector<const char*> recs;
  recs.reserve(static_cast<size_t>(size / (RECORD + 1) + 1));
  const char* p = data.data();
  const char* end = p + size;
  while (p < end) {
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
    const char* stop = nl ? nl : end;
    if (stop - p >= RECORD) recs.push_back(p);
    if (!nl) break;
    p = nl + 1;
  }
  int64_t n = static_cast<int64_t>(recs.size());

  Out o;
  o.nu = static_cast<double*>(std::malloc(n * sizeof(double)));
  o.S = static_cast<double*>(std::malloc(n * sizeof(double)));
  o.A = static_cast<double*>(std::malloc(n * sizeof(double)));
  o.ga = static_cast<double*>(std::malloc(n * sizeof(double)));
  o.gs = static_cast<double*>(std::malloc(n * sizeof(double)));
  o.Epp = static_cast<double*>(std::malloc(n * sizeof(double)));
  o.na = static_cast<double*>(std::malloc(n * sizeof(double)));
  o.da = static_cast<double*>(std::malloc(n * sizeof(double)));
  o.M = static_cast<int16_t*>(std::malloc(n * sizeof(int16_t)));
  o.I = static_cast<char*>(std::malloc(n ? n : 1));

  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = hw ? static_cast<int>(hw) : 4;
  if (n < 4096) nthreads = 1;
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(parse_range, std::cref(recs), lo, hi, o);
  }
  for (auto& th : threads) th.join();

  *nu = o.nu; *S = o.S; *A = o.A; *ga = o.ga; *gs = o.gs;
  *Epp = o.Epp; *na = o.na; *da = o.da; *M = o.M; *I = o.I;
  return n;
}

void clearsky_free(void* ptr) { std::free(ptr); }

}  // extern "C"
