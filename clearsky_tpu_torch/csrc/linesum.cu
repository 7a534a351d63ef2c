// Line-sum kernel (K1): sigma[state, nu] = sum over each wavenumber block's
// line window of TIPS-scaled Voigt, Lorentz or Doppler line profiles.
//
// Replaces clearsky_tpu/ops/linesum_pallas.py::_kernel_resident_grouped,
// launched by _grouped_call through _pallas_sigma_impl, in its split mode
// (voigt: Humlicek region 1 in the far wing, full w4 near the core) and its
// single-sweep modes (lorentz, doppler).
//
// What bounds it on the H100: arithmetic, not memory. Every (point, line,
// state) triple inside the cut costs about ten FP32 operations and one IEEE
// division in the far wing (a full Humlicek w4 near the core), while the
// bytes are one read of each block's line window. The design follows from
// that:
//   * one CUDA block per plan block of grid points, one thread per point; a
//     second grid axis runs over tiles of ST states;
//   * the block's window [start, start + count) streams through shared
//     memory in chunks of CH lines (positions hi and lo, and the per-state
//     coefficients), so each line is read from device memory once per block
//     and reused by all of its points and states;
//   * the per-(state, line) coefficients (Sia, ia, y0, A, c1, c2, k2) are
//     computed before the launch, as _grouped_pack does, so the inner loop
//     holds no per-line division;
//   * the ST state accumulators live in registers;
//   * a per-element branch on |dnu| > d_near replaces the TPU kernel's two
//     masked sweeps (far: region 1; near: full w4). The masks are the same,
//     so the sum is the same; the branch only diverges inside a warp for the
//     few points within d_near = 15 max(alpha) of a line core.
//
// Built without --use_fast_math: divisions are IEEE, expf/sinf/cosf are the
// accurate versions and subnormals are kept.

#include <cuda_runtime.h>

namespace {

constexpr int ST = 8;    // states per tile (grid y axis)
constexpr int CH = 128;  // lines per shared-memory chunk

enum Mode { VOIGT_SPLIT = 0, LORENTZ = 1, DOPPLER = 2 };

constexpr float INV_PI = 0.318309886183790672f;
constexpr float INV_SQRT_PI = 0.564189583547756287f;

__host__ __device__ constexpr int n_coef(int mode) { return mode == VOIGT_SPLIT ? 7 : 3; }

__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi,
                                     float& pr, float& pi) {
  pr = ar * br - ai * bi;
  pi = ar * bi + ai * br;
}

// two-division form: the single-reciprocal rewrite overflows |d|^2 in f32
// for far-wing arguments (clearsky_tpu/ops/faddeeva.py::_cdiv)
__device__ __forceinline__ void cdiv(float ar, float ai, float br, float bi,
                                     float& qr, float& qi) {
  const float d = br * br + bi * bi;
  qr = (ar * br + ai * bi) / d;
  qi = (ai * br - ar * bi) / d;
}

// Horner evaluation of a real-coefficient polynomial (highest degree first)
// at the complex argument (tr, ti)
template <int N>
__device__ __forceinline__ void cpoly(const float (&c)[N], float tr, float ti,
                                      float& pr, float& pi) {
  pr = c[0];
  pi = 0.0f;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    float qr, qi;
    cmul(pr, pi, tr, ti, qr, qi);
    pr = qr + c[k];
    pi = qi;
  }
}

// Re w(x + iy), y >= 0: Humlicek's w4 with the small-y repair of the real
// part, mirroring clearsky_tpu/ops/faddeeva.py::_wofz_re_im_impl (:55-146).
// The TPU version evaluates all four regions and selects; here only the
// active region is evaluated, which gives the same value.
__device__ float wofz_re(float x, float y) {
  const float ax = fabsf(x);
  const float s = ax + y;
  const float tr = y, ti = -x;  // t = y - i x
  float ur, ui;                 // u = t^2
  cmul(tr, ti, tr, ti, ur, ui);
  float wr, wi;
  if (s >= 15.0f) {
    // region 1: w = 0.5641896 t / (0.5 + t^2)
    cdiv(0.5641896f * tr, 0.5641896f * ti, 0.5f + ur, ui, wr, wi);
  } else if (s >= 5.5f) {
    // region 2: w = t (1.410474 + 0.5641896 u) / (0.75 + u (3 + u))
    float n2r, n2i, d2r, d2i;
    cmul(tr, ti, 1.410474f + 0.5641896f * ur, 0.5641896f * ui, n2r, n2i);
    cmul(ur, ui, 3.0f + ur, ui, d2r, d2i);
    cdiv(n2r, n2i, 0.75f + d2r, d2i, wr, wi);
  } else if (y >= 0.195f * ax - 0.176f) {
    // region 3: [4/5] rational in t
    const float n3[5] = {0.5642236f, 3.778987f, 11.96482f, 20.20933f, 16.4955f};
    const float d3[6] = {1.0f, 6.699398f, 21.69274f, 39.27121f, 38.82363f, 16.4955f};
    float nr, ni, dr, di;
    cpoly(n3, tr, ti, nr, ni);
    cpoly(d3, tr, ti, dr, di);
    cdiv(nr, ni, dr, di, wr, wi);
  } else {
    // region 4: w = exp(u) - t P(u) / Q(u), with u_r clamped at 0 (the
    // clamp never changes an active value: u_r < 0 in this region)
    const float u4r = fminf(ur, 0.0f), u4i = ui;
    const float p4[7] = {0.56419f, 1.320522f, 35.76683f, 219.0313f,
                         1540.787f, 3321.9905f, 36183.31f};
    const float q4[8] = {1.0f, 1.841439f, 61.57037f, 364.2191f,
                         2186.181f, 9022.228f, 24322.84f, 32066.6f};
    float pr, pi, qr, qi, fr, fi, tfr, tfi;
    cpoly(p4, -u4r, -u4i, pr, pi);
    cpoly(q4, -u4r, -u4i, qr, qi);
    cdiv(pr, pi, qr, qi, fr, fi);
    cmul(tr, ti, fr, fi, tfr, tfi);
    const float eu = expf(u4r);
    wr = eu * cosf(u4i) - tfr;
    wi = eu * sinf(u4i) - tfi;
  }
  if (y < 0.01f) {
    // small-y repair: Re w = e^{-x^2} + y g - y^2 (2x^2 - 1) e^{-x^2}, with
    // g = 2x Im w(x, 0) - 2/sqrt(pi) from its asymptotic series for |x| >= 5.5
    const float eu = expf(fminf(ur, 0.0f));
    const float ex2 = eu * (1.0f - y * y);
    const float inv = 1.0f / fmaxf(x * x, 1.0f);
    const float g_series = (2.0f * INV_SQRT_PI) * inv *
        (0.5f + inv * (0.75f + inv * (1.875f + inv * 6.5625f)));
    const float wi0 = wi + 2.0f * x * y * ex2;
    const float g_direct = 2.0f * x * wi0 - 2.0f * INV_SQRT_PI;
    const float g = ax >= 5.5f ? g_series : g_direct;
    wr = ex2 + y * g - y * y * (2.0f * x * x - 1.0f) * ex2;
  }
  return wr;
}

// coef layout: [n_tiles][n_lines][ST * n_coef(MODE)], per line the ST states
// of the tile one after another, each with its n_coef values:
//   VOIGT_SPLIT: Sia, ia, y0, A, c1, c2, k2
//   LORENTZ, DOPPLER: S, alpha, gamma
// out: [n_states][n_nu]
template <int MODE>
__global__ void linesum_kernel(const float* __restrict__ nu_hi,
                               const float* __restrict__ nu_lo,
                               const float* __restrict__ line_hi,
                               const float* __restrict__ line_lo,
                               const float* __restrict__ coef,
                               const int* __restrict__ start,
                               const int* __restrict__ count,
                               const float* __restrict__ d_near_p, float cut,
                               int n_lines, int n_states, int n_nu,
                               float* __restrict__ out) {
  constexpr int NC = n_coef(MODE);
  constexpr int W = ST * NC;
  __shared__ float s_hi[CH];
  __shared__ float s_lo[CH];
  __shared__ float s_c[CH * W];

  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int p = b * nthreads + tid;  // plan blocks are padded: p < n_blocks * block
  const float nh = nu_hi[p];
  const float nl = nu_lo[p];
  const float d_near = MODE == VOIGT_SPLIT ? *d_near_p : 0.0f;
  const int s0 = start[b];
  const int cnt = count[b];
  const float* ct = coef + (size_t)tile * n_lines * W;

  float acc[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) acc[s] = 0.0f;

  for (int c0 = 0; c0 < cnt; c0 += CH) {
    const int n = min(CH, cnt - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < n; i += nthreads) {
      s_hi[i] = line_hi[s0 + c0 + i];
      s_lo[i] = line_lo[s0 + c0 + i];
    }
    const float* src = ct + (size_t)(s0 + c0) * W;
    for (int i = tid; i < n * W; i += nthreads) s_c[i] = src[i];
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      // two-float dnu: the hi difference is exact for nearby values and the
      // residuals restore the sub-f32 position information
      const float dnu = (nh - s_hi[j]) + (nl - s_lo[j]);
      const float adnu = fabsf(dnu);
      if (!(adnu <= cut)) continue;
      const float* c = s_c + j * W;
      if (MODE == VOIGT_SPLIT && adnu > d_near) {
        // far wing: Humlicek region 1 in the shared D = dnu^2,
        // k2 (c1 + m) / ((c1 - m)^2 + c2 D) with m = D A
        const float D = dnu * dnu;
#pragma unroll
        for (int s = 0; s < ST; ++s) {
          const float A = c[s * NC + 3], c1 = c[s * NC + 4];
          const float c2 = c[s * NC + 5], k2 = c[s * NC + 6];
          const float m = D * A;
          const float br = c1 - m;
          acc[s] += (k2 * (c1 + m)) / (br * br + c2 * D);
        }
      } else if (MODE == VOIGT_SPLIT) {
#pragma unroll
        for (int s = 0; s < ST; ++s) {
          const float Sia = c[s * NC], ia = c[s * NC + 1], y0 = c[s * NC + 2];
          acc[s] += Sia * wofz_re(dnu * ia, y0);
        }
      } else if (MODE == LORENTZ) {
#pragma unroll
        for (int s = 0; s < ST; ++s) {
          const float S = c[s * NC], gam = c[s * NC + 2];
          acc[s] += S * (gam * INV_PI) / (dnu * dnu + gam * gam);
        }
      } else {  // DOPPLER
#pragma unroll
        for (int s = 0; s < ST; ++s) {
          const float S = c[s * NC], ia = 1.0f / c[s * NC + 1];
          const float arg = dnu * ia;
          acc[s] += (S * INV_SQRT_PI * ia) * expf(-arg * arg);
        }
      }
    }
  }
  if (p < n_nu) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      const int st = tile * ST + s;
      if (st < n_states) out[(size_t)st * n_nu + p] = acc[s];
    }
  }
}

}  // namespace

extern "C" {

int linesum_states_per_tile() { return ST; }

int linesum_coef_per_state(int mode) { return n_coef(mode); }

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int linesum_launch(int mode, const float* nu_hi, const float* nu_lo,
                   const float* line_hi, const float* line_lo,
                   const float* coef, const int* start, const int* count,
                   const float* d_near, float cut, int n_blocks, int block,
                   int n_lines, int n_states, int n_nu, float* out,
                   void* stream) {
  const int n_tiles = (n_states + ST - 1) / ST;
  const dim3 grid(n_blocks, n_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case VOIGT_SPLIT:
      linesum_kernel<VOIGT_SPLIT><<<grid, block, 0, st>>>(
          nu_hi, nu_lo, line_hi, line_lo, coef, start, count, d_near, cut,
          n_lines, n_states, n_nu, out);
      break;
    case LORENTZ:
      linesum_kernel<LORENTZ><<<grid, block, 0, st>>>(
          nu_hi, nu_lo, line_hi, line_lo, coef, start, count, d_near, cut,
          n_lines, n_states, n_nu, out);
      break;
    case DOPPLER:
      linesum_kernel<DOPPLER><<<grid, block, 0, st>>>(
          nu_hi, nu_lo, line_hi, line_lo, coef, start, count, d_near, cut,
          n_lines, n_states, n_nu, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
