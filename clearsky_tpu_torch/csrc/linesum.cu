// Line-sum kernels: K1, sigma[state, nu] = sum over each wavenumber block's
// line windows of TIPS-scaled Voigt, sub-Lorentzian CO2 (phco2), Lorentz or
// Doppler line profiles (and its catalog-segmented use, K1-seg); the
// near-core correction of the stencil-near route; and the full-profile
// kernels K4 (lane-major) and K5 (gathered slabs), further down.
//
// Replaces clearsky_tpu/ops/linesum_pallas.py::_kernel_resident_grouped,
// launched by _grouped_call, in all its modes:
//   * split (voigt: Humlicek region 1 in the far wing, full w4 near the
//     core) and single sweep (lorentz, doppler), through _pallas_sigma_impl;
//   * FARALL (wmode "farall": region 1 over the whole window), the kernel of
//     the stencil-near route;
//   * FINE, FINE_STENCIL and COARSE (wmodes "fine", "fine_stencil",
//     "coarse"), the two passes of the coarse-far split (_coarse_core);
//   * K1-seg (_pallas_sigma_segmented, which runs _pallas_sigma_impl's
//     split and single-sweep modes once per catalog segment): the ACC
//     instances add into sigma at a row stride of their own, so each
//     segment adds its block range's columns in place, with no temporary
//     and no separate sum. Segments run in order on one stream and each
//     output element belongs to one thread of a launch, so nothing races.
//     On the TPU the segments keep the pack inside VMEM; here they bound the
//     per-segment temporaries (a pack is built, read while it sits in L2,
//     and freed), and the segment length comes from the routing's budget.
// The phco2 family (shapes phco2 and phco2_ref; _profile_tile :57-83,
// _profile_far :90-120, tile_near :315 and the phco2 far tile :349-365 of
// the grouped kernel) is a second instance of every Voigt mode: y = y0 chi
// with Perrin and Hartmann's chi(|dnu|, T), 1 below 3 cm^-1 and decaying in
// three pieces beyond, so the far wing is region 1 in the explicit (x, y)
// form on (Sia, ia, y0) (3 values a state and line) instead of the voigt
// coefficients in D. chi takes ONE expf of the selected exponent (the TPU
// code evaluates the three exponentials and selects; the value is the same
// up to rounding); the pieces' arguments are formed once per (point, line)
// and the rates B1(T), B2(T) of each state, computed in float64 by the
// wrapper and rounded, sit in shared memory beside the coefficients. The
// *_ref shapes need no device code: the wrapper folds alpha -> alpha /
// sqrt(ln 2) into the coefficients, as _grouped_pack (:537) does. With a
// cut of 500 cm^-1 almost every (point, line) pair is far wing, and each
// then costs one expf (the SFU) and one IEEE division per state.
// stencil_correction_kernel replaces the XLA-side _stencil_apply, which adds
// Sia (w4 - region 1) at the grid points of each line's |x| <= 15 core; the
// TPU placed it with one-hot matrix products, here atomicAdd puts it in
// place (so its summation order changes from run to run).
//
// What bounds it on the H100: arithmetic, not memory. Every (point, line,
// state) triple inside the cut costs about ten FP32 operations and one IEEE
// division in the far wing (a full Humlicek w4 near the core), while the
// bytes are one read of each block's line windows. The design follows from
// that:
//   * one CUDA block per block of grid points, one thread per point; a
//     second grid axis runs over tiles of ST states;
//   * each of the block's windows [start, start + count) streams through
//     shared memory in chunks of CH lines (positions hi and lo, and the
//     per-state coefficients), so each line is read from device memory once
//     per block and reused by all of its points and states;
//   * the per-(state, line) coefficients (Sia, ia, y0, A, c1, c2, k2) are
//     computed before the launch, as _grouped_pack does, so the inner loop
//     holds no per-line division; every voigt mode reads the same 7-value
//     pack (FARALL and COARSE only A, c1, c2, k2);
//   * the ST state accumulators live in registers, and the switching
//     weights of the coarse-far split are computed once per (point, line)
//     on the shared D = dnu^2, for all ST states;
//   * a per-element branch on |dnu| > d_near replaces the TPU kernel's two
//     masked sweeps (far: region 1; near: full w4) in the split and FINE
//     modes. The masks are the same, so the sum is the same; the branch only
//     diverges inside a warp for the few points within d_near of a line core.
//     FINE's near sub-window is therefore its mid window.
//
// Built without --use_fast_math: divisions are IEEE, expf/sinf/cosf are the
// accurate versions and subnormals are kept.

#include <cuda_runtime.h>

namespace {

constexpr int ST = 8;    // states per tile (grid y axis)
constexpr int CH = 128;  // lines per shared-memory chunk

enum Mode {
  VOIGT_SPLIT = 0, LORENTZ = 1, DOPPLER = 2,       // over the plan's windows
  FARALL = 3, FINE = 4, FINE_STENCIL = 5, COARSE = 6,  // the routes' modes
  // the phco2 family's instances of the Voigt modes
  PH_SPLIT = 7, PH_FARALL = 8, PH_FINE = 9, PH_FINE_STENCIL = 10, PH_COARSE = 11
};

constexpr float INV_PI = 0.318309886183790672f;
constexpr float INV_SQRT_PI = 0.564189583547756287f;

__host__ __device__ constexpr bool is_phco2(int mode) { return mode >= PH_SPLIT; }

// the Voigt mode whose sweeps a phco2 mode runs
__host__ __device__ constexpr int voigt_mode(int mode) {
  return mode == PH_SPLIT ? VOIGT_SPLIT : (is_phco2(mode) ? mode - 5 : mode);
}

// values per (state, line): (S, alpha, gamma) for Lorentz and Doppler, (Sia,
// ia, y0) for the phco2 family, and the voigt modes add (A, c1, c2, k2)
__host__ __device__ constexpr int n_coef(int mode) {
  return (mode == LORENTZ || mode == DOPPLER || is_phco2(mode)) ? 3 : 7;
}

// line windows per block: FINE and FINE_STENCIL sweep the mid window and the
// two annuli at the cut; every other mode one window
__host__ __device__ constexpr int n_windows(int mode) {
  return (voigt_mode(mode) == FINE || voigt_mode(mode) == FINE_STENCIL) ? 3 : 1;
}

// The distances of a launch, float32 as the TPU kernel rounds its constants:
// the cut, the mid zone's support cut_f = 2 d_far, the coarse field's inner
// edge d_lo = d_far, and the two switches, W over D in [D1, D1 + 1/inv_D]
// and the outer roll over [R1, R1 + 1/inv_R]
struct Zones {
  float cut, cut_f, d_lo, D1, inv_D, R1, inv_R;
};

// what a sweep over one window adds
enum Zone { Z_SPLIT, Z_LORENTZ, Z_DOPPLER, Z_FARALL, Z_MID, Z_MID_ALL, Z_ANNULUS, Z_COARSE };

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

// C^2 smootherstep in squared distance: 0 below A1, 1 at A1 + 1/inv
// (linesum_pallas.py::_smoothstep_d2)
__device__ __forceinline__ float smooth_d2(float D, float A1, float inv) {
  const float w = fminf(fmaxf((D - A1) * inv, 0.0f), 1.0f);
  return w * w * w * (10.0f + w * (-15.0f + 6.0f * w));
}

// Humlicek region 1 in the shared D = dnu^2 on one state's coefficients:
// k2 (c1 + m) / ((c1 - m)^2 + c2 D) with m = D A
__device__ __forceinline__ float region1(const float* c, float D) {
  const float m = D * c[3];
  const float br = c[4] - m;
  return (c[6] * (c[4] + m)) / (br * br + c[5] * D);
}

// Re of region 1 in the explicit (x, y) algebra of the TPU code's phco2 far
// tile and of _stencil_apply: 0.5641896 (y br - x t2i) / (br^2 + t2i^2),
// br = 0.5 + y^2 - x^2, t2i = -2 x y
__device__ __forceinline__ float region1_xy(float x, float y) {
  const float t2r = y * y - x * x;
  const float t2i = -2.0f * x * y;
  const float br = 0.5f + t2r;
  const float d2 = br * br + t2i * t2i;
  return 0.5641896f * (y * br - x * t2i) / d2;
}

// chi(|dnu|, T) = exp(-B1 u - B2 v - w): the piece's arguments (u, v, w)
// depend on the pair only, the rates B1, B2 on the state
// (clearsky_tpu/ops/lineshape.py::chi_phco2)
struct ChiArg {
  float u, v, w;
};

__device__ __forceinline__ ChiArg chi_arg(float a) {
  if (a < 3.0f) return {0.0f, 0.0f, 0.0f};
  if (a < 30.0f) return {a - 3.0f, 0.0f, 0.0f};
  if (a < 120.0f) return {27.0f, a - 30.0f, 0.0f};
  return {27.0f, 90.0f, 0.0232f * (a - 120.0f)};
}

__device__ __forceinline__ float chi_of(const ChiArg& q, float B1, float B2) {
  return expf(-(B1 * q.u) - B2 * q.v - q.w);
}

// one state's far-wing term: region 1 in D (voigt), or Sia times the
// explicit form at (dnu ia, y0 chi) (phco2)
template <bool PH>
__device__ __forceinline__ float far_term(const float* c, float dnu, float D, float chi) {
  if constexpr (PH) return c[0] * region1_xy(dnu * c[1], c[2] * chi);
  else return region1(c, D);
}

// one state's core term: Sia Re w(dnu ia, y), y = y0 (voigt) or y0 chi (phco2)
template <bool PH>
__device__ __forceinline__ float near_term(const float* c, float dnu, float chi) {
  if constexpr (PH) return c[0] * wofz_re(dnu * c[1], c[2] * chi);
  else return c[0] * wofz_re(dnu * c[1], c[2]);
}

// Accumulate one window [s0, s0 + cnt) of the tile's lines into acc. Every
// thread of the block calls it with the same window.
// coef layout: [n_lines][ST * NC] for the tile, per line the ST states one
// after another, each with its NC values:
//   voigt modes: Sia, ia, y0, A, c1, c2, k2
//   phco2 modes (PH): Sia, ia, y0; s_B holds the tile's B1 (ST) then B2 (ST)
//   LORENTZ, DOPPLER: S, alpha, gamma
template <int ZONE, int NC, bool PH>
__device__ __forceinline__ void sweep(int s0, int cnt, const float* __restrict__ line_hi,
                                      const float* __restrict__ line_lo,
                                      const float* __restrict__ ct, float* s_hi,
                                      float* s_lo, float* s_c, const float* s_B, float nh,
                                      float nl, const Zones& z, float d_near,
                                      float (&acc)[ST]) {
  constexpr int W = ST * NC;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
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
      const float D = dnu * dnu;
      const float* c = s_c + j * W;
      // the zone's mask and its switching weight, shared by the ST states
      float w = 1.0f;
      if constexpr (ZONE == Z_SPLIT || ZONE == Z_LORENTZ || ZONE == Z_DOPPLER ||
                    ZONE == Z_FARALL) {
        if (!(adnu <= z.cut)) continue;
      } else if constexpr (ZONE == Z_MID || ZONE == Z_MID_ALL) {
        // FINE (mid zone region 1 and near zone w4) and FINE_STENCIL (region
        // 1 over the whole mid zone), weighted 1 - W
        if (!(adnu <= z.cut_f)) continue;
        w = 1.0f - smooth_d2(D, z.D1, z.inv_D);
      } else if constexpr (ZONE == Z_ANNULUS) {
        // the shell [cut - w_roll, cut] weighted by the outer roll: keeps the
        // hard truncation at the cut exact on the fine grid
        if (!(adnu <= z.cut && D > z.R1)) continue;
        w = smooth_d2(D, z.R1, z.inv_R);
      } else {  // Z_COARSE: the smooth far field W Wout on the coarse grid
        if (!(adnu <= z.cut && adnu > z.d_lo)) continue;
        w = smooth_d2(D, z.D1, z.inv_D) * (1.0f - smooth_d2(D, z.R1, z.inv_R));
      }
      ChiArg q{0.0f, 0.0f, 0.0f};
      if constexpr (PH) q = chi_arg(adnu);
      if constexpr (ZONE == Z_LORENTZ) {
#pragma unroll
        for (int s = 0; s < ST; ++s) {
          const float S = c[s * NC], gam = c[s * NC + 2];
          acc[s] += S * (gam * INV_PI) / (dnu * dnu + gam * gam);
        }
      } else if constexpr (ZONE == Z_DOPPLER) {
#pragma unroll
        for (int s = 0; s < ST; ++s) {
          const float S = c[s * NC], ia = 1.0f / c[s * NC + 1];
          const float arg = dnu * ia;
          acc[s] += (S * INV_SQRT_PI * ia) * expf(-arg * arg);
        }
      } else if constexpr (ZONE == Z_SPLIT || ZONE == Z_MID) {
        // a per-element branch replaces the TPU kernel's two masked sweeps:
        // region 1 beyond d_near, the full w4 within it
        if (adnu > d_near) {
#pragma unroll
          for (int s = 0; s < ST; ++s) {
            const float chi = PH ? chi_of(q, s_B[s], s_B[ST + s]) : 1.0f;
            const float f = far_term<PH>(c + s * NC, dnu, D, chi);
            acc[s] += ZONE == Z_MID ? f * w : f;
          }
        } else {
#pragma unroll
          for (int s = 0; s < ST; ++s) {
            const float chi = PH ? chi_of(q, s_B[s], s_B[ST + s]) : 1.0f;
            const float f = near_term<PH>(c + s * NC, dnu, chi);
            acc[s] += ZONE == Z_MID ? f * w : f;
          }
        }
      } else {
        // FARALL (stencil-near route: region 1 over the whole window, the
        // core corrected afterwards by stencil_correction_kernel), MID_ALL,
        // ANNULUS and COARSE: region 1, weighted but in FARALL
#pragma unroll
        for (int s = 0; s < ST; ++s) {
          const float chi = PH ? chi_of(q, s_B[s], s_B[ST + s]) : 1.0f;
          const float f = far_term<PH>(c + s * NC, dnu, D, chi);
          acc[s] += ZONE == Z_FARALL ? f : f * w;
        }
      }
    }
  }
}

// One block per block of grid points, one thread per point; win holds each
// block's n_windows(MODE) windows as (start, count) pairs; bcoef (the phco2
// modes) the rates [n_tiles][2][ST], B1 then B2 of each tile's states.
// out: [n_states][ld_out], the first n_out columns written (ACC: added to)
template <int MODE, bool ACC>
__global__ void linesum_kernel(const float* __restrict__ nu_hi,
                               const float* __restrict__ nu_lo,
                               const float* __restrict__ line_hi,
                               const float* __restrict__ line_lo,
                               const float* __restrict__ coef,
                               const int* __restrict__ win,
                               const float* __restrict__ d_near_p,
                               const float* __restrict__ bcoef, Zones z,
                               int n_lines, int n_states, int n_out, int ld_out,
                               float* __restrict__ out) {
  constexpr int NC = n_coef(MODE);
  constexpr int NW = n_windows(MODE);
  constexpr int VM = voigt_mode(MODE);
  constexpr bool PH = is_phco2(MODE);
  __shared__ float s_hi[CH];
  __shared__ float s_lo[CH];
  __shared__ float s_c[CH * ST * NC];
  __shared__ float s_B[2 * ST];

  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  const int p = b * blockDim.x + threadIdx.x;  // grids are padded to whole blocks
  const float nh = nu_hi[p];
  const float nl = nu_lo[p];
  const float d_near = (VM == VOIGT_SPLIT || VM == FINE) ? *d_near_p : 0.0f;
  const int* w = win + (size_t)b * 2 * NW;
  const float* ct = coef + (size_t)tile * n_lines * ST * NC;
  if constexpr (PH) {
    if (threadIdx.x < 2 * ST) s_B[threadIdx.x] = bcoef[(size_t)tile * 2 * ST + threadIdx.x];
    __syncthreads();
  }

  float acc[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) acc[s] = 0.0f;

#define SWEEP(ZONE, K) \
  sweep<ZONE, NC, PH>(w[2 * (K)], w[2 * (K) + 1], line_hi, line_lo, ct, s_hi, s_lo, s_c, s_B, \
                      nh, nl, z, d_near, acc)
  if constexpr (VM == VOIGT_SPLIT) SWEEP(Z_SPLIT, 0);
  else if constexpr (VM == LORENTZ) SWEEP(Z_LORENTZ, 0);
  else if constexpr (VM == DOPPLER) SWEEP(Z_DOPPLER, 0);
  else if constexpr (VM == FARALL) SWEEP(Z_FARALL, 0);
  else if constexpr (VM == COARSE) SWEEP(Z_COARSE, 0);
  else {
    if constexpr (VM == FINE) SWEEP(Z_MID, 0);
    else SWEEP(Z_MID_ALL, 0);
    SWEEP(Z_ANNULUS, 1);
    SWEEP(Z_ANNULUS, 2);
  }
#undef SWEEP

  if (p < n_out) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      const int st = tile * ST + s;
      if (st < n_states) {
        float* o = out + (size_t)st * ld_out + p;
        if constexpr (ACC) *o += acc[s];
        else *o = acc[s];
      }
    }
  }
}

// The stencil route's near-core correction: one thread per (window point k,
// line l), i = k * n_lines + l, looping over the states. Adds
// Sia (w4 - region 1) [x (1 - W(dnu^2)) when weighted] at grid point
// q[l] K + k where x^2 <= 225 and |dnu_hi| <= cut, region 1 in the explicit
// (x, y) algebra of _stencil_apply. dnu_hi/dnu_lo: [2K][n_lines];
// sia/ia/y0: [n_states][n_lines]; out: [n_states][n_nu], added to.
// PH (the phco2 family): y = y0 chi(|dnu_hi + dnu_lo|, T), as _stencil_apply
// (:1269-1275) has it, the rates from bcoef [n_tiles][2][ST] as K1 reads them.
// (Within the stencil's reach, 15 alpha(1000 K) / sqrt(ln 2), ~0.1 cm^-1 for
// CO2, chi is 1; the kernel applies it all the same.)
template <bool PH>
__global__ void stencil_correction_kernel(const float* __restrict__ dnu_hi,
                                          const float* __restrict__ dnu_lo,
                                          const int* __restrict__ q,
                                          const float* __restrict__ sia,
                                          const float* __restrict__ ia,
                                          const float* __restrict__ y0,
                                          const float* __restrict__ bcoef, int K,
                                          int n_lines, int n_states, int n_nu,
                                          float cut, int weighted, float D1,
                                          float inv_D, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)2 * K * n_lines) return;
  const int k = (int)(i / n_lines);
  const int l = (int)(i % n_lines);
  const int p = q[l] * K + k;
  const float dh = dnu_hi[i];
  if (p >= n_nu || !(fabsf(dh) <= cut)) return;
  const float dl = dnu_lo[i];
  const float dD = dh + dl;
  float w = 1.0f;
  if (weighted) w = 1.0f - smooth_d2(dD * dD, D1, inv_D);
  ChiArg chq{0.0f, 0.0f, 0.0f};
  if constexpr (PH) chq = chi_arg(fabsf(dD));
  for (int s = 0; s < n_states; ++s) {
    const size_t sl = (size_t)s * n_lines + l;
    const float a = ia[sl];
    const float x = a * dh + a * dl;
    if (!(x * x <= 225.0f)) continue;
    float y = y0[sl];
    if constexpr (PH) {
      const float* bt = bcoef + (size_t)(s / ST) * 2 * ST + s % ST;
      y *= chi_of(chq, bt[0], bt[ST]);
    }
    const float corr = sia[sl] * (wofz_re(x, y) - region1_xy(x, y)) * w;
    atomicAdd(out + (size_t)s * n_nu + p, corr);
  }
}

// K4 and K5: the full line profile over each block's lines, w4 at every
// voigt and phco2 pair (no near/far split; phco2 with y = y0 chi(|dnu|, T),
// the rates from bcoef [n_tiles][2][ST] in shared memory), Lorentz or
// Doppler otherwise.
//   * K4, GATHERED = false, replaces linesum_pallas.py::_kernel_resident
//     (the lane branch of _pallas_sigma_impl, strategy "lane"): the per-state
//     rows S, alpha, gamma [n_states][row] unpacked, lines padded past the
//     catalog at 1e30 cm^-1 with zero strength; each block's window starts
//     at start[b] (a CHUNK multiple) and holds count[b] lines, 0 for a block
//     with none.
//   * K5, GATHERED = true, replaces linesum_pallas.py::_kernel (the gathered
//     fallback, strategy "gathered"): each block's slab of row lines was
//     gathered before the launch into positions [n_blocks][row] and per-state
//     rows [n_states][n_blocks][row]; count[b] of them are real.
// What bounds it on the H100: arithmetic. The full Humlicek w4 runs at
// every (point, line, state) inside the cut, ~10x the far-wing region 1 of
// K1's split mode; K5 adds the gathered slabs' bytes, 12 bytes a (state,
// block, slab line), read once. The design is K1's single sweep: a block of
// one thread per grid point and a tile of ST states (grid y); the window
// (K4) or the slab (K5) streams through shared memory in chunks of CH lines,
// read row by row so that a warp reads consecutive addresses; the
// reciprocal 1/alpha and the profile factors are formed once per (line,
// state) as a chunk is staged (the TPU kernel's reciprocals on its [1, chunk]
// rows), and the ST accumulators stay in registers.
// out: [n_states][n_out]
template <int SHAPE, bool GATHERED>
__global__ void fullprofile_kernel(const float* __restrict__ nu_hi,
                                   const float* __restrict__ nu_lo,
                                   const float* __restrict__ line_hi,
                                   const float* __restrict__ line_lo,
                                   const float* __restrict__ S,
                                   const float* __restrict__ alpha,
                                   const float* __restrict__ gamma,
                                   const int* __restrict__ start,
                                   const int* __restrict__ count,
                                   const float* __restrict__ bcoef, int row, int n_blocks,
                                   float cut, int n_states, int n_out,
                                   float* __restrict__ out) {
  constexpr bool PH = SHAPE == PH_SPLIT;
  __shared__ float s_hi[CH];
  __shared__ float s_lo[CH];
  __shared__ float s_f[3][CH * ST];  // per (line, state): the profile's factors
  __shared__ float s_B[2 * ST];

  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int p = b * blockDim.x + tid;  // grids are padded to whole blocks
  const float nh = nu_hi[p];
  const float nl = nu_lo[p];
  const size_t base = GATHERED ? (size_t)b * row : (size_t)start[b];
  const size_t sstride = GATHERED ? (size_t)n_blocks * row : (size_t)row;
  const int cnt = count[b];
  if constexpr (PH) {
    if (tid < 2 * ST) s_B[tid] = bcoef[(size_t)tile * 2 * ST + tid];
    __syncthreads();
  }

  float acc[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) acc[s] = 0.0f;

  for (int c0 = 0; c0 < cnt; c0 += CH) {
    const int n = min(CH, cnt - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < n; i += nthreads) {
      s_hi[i] = line_hi[base + c0 + i];
      s_lo[i] = line_lo[base + c0 + i];
    }
    for (int i = tid; i < n * ST; i += nthreads) {
      const int s = i / n;
      const int j = i - s * n;
      const int st = tile * ST + s;
      // voigt, phco2 and doppler: (S ia / sqrt(pi), ia, gamma ia); lorentz:
      // (S, gamma); a padding state contributes exactly 0
      float f0 = 0.0f, f1 = 1.0f, f2 = 1.0f;
      if (st < n_states) {
        const size_t k = (size_t)st * sstride + base + c0 + j;
        const float Sv = S[k];
        if constexpr (SHAPE == LORENTZ) {
          f0 = Sv;
          f1 = gamma[k];
        } else {
          const float ia = 1.0f / alpha[k];
          f0 = Sv * INV_SQRT_PI * ia;
          f1 = ia;
          f2 = gamma[k] * ia;
        }
      }
      s_f[0][j * ST + s] = f0;
      s_f[1][j * ST + s] = f1;
      s_f[2][j * ST + s] = f2;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      // two-float dnu, as in K1
      const float dnu = (nh - s_hi[j]) + (nl - s_lo[j]);
      if (!(fabsf(dnu) <= cut)) continue;
      ChiArg q{0.0f, 0.0f, 0.0f};
      if constexpr (PH) q = chi_arg(fabsf(dnu));
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        const float f0 = s_f[0][j * ST + s], f1 = s_f[1][j * ST + s];
        if constexpr (SHAPE == VOIGT_SPLIT) {
          acc[s] += f0 * wofz_re(dnu * f1, s_f[2][j * ST + s]);
        } else if constexpr (PH) {
          acc[s] += f0 * wofz_re(dnu * f1, s_f[2][j * ST + s] * chi_of(q, s_B[s], s_B[ST + s]));
        } else if constexpr (SHAPE == LORENTZ) {
          acc[s] += f0 * (f1 * INV_PI) / (dnu * dnu + f1 * f1);
        } else {
          const float arg = dnu * f1;
          acc[s] += f0 * expf(-arg * arg);
        }
      }
    }
  }

  if (p < n_out) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      const int st = tile * ST + s;
      if (st < n_states) out[(size_t)st * n_out + p] = acc[s];
    }
  }
}

}  // namespace

extern "C" {

int linesum_states_per_tile() { return ST; }

int linesum_coef_per_state(int mode) { return n_coef(mode); }

int linesum_windows_per_block(int mode) { return n_windows(mode); }

// Launch `mode` on `stream`; zones: host float[7] (Zones, in field order);
// bcoef: the phco2 modes' rates [n_tiles][2][ST] (unread by the others);
// out: rows of ld_out floats, the first n_out of each written, or added to
// with `accumulate` (the split and single-sweep modes only).
// Returns cudaGetLastError() (0 on success).
int linesum_launch(int mode, const float* nu_hi, const float* nu_lo,
                   const float* line_hi, const float* line_lo,
                   const float* coef, const int* win, const float* d_near,
                   const float* bcoef, const float* zones, int n_blocks, int block,
                   int n_lines, int n_states, int n_out, int ld_out, int accumulate,
                   float* out, void* stream) {
  const int n_tiles = (n_states + ST - 1) / ST;
  const dim3 grid(n_blocks, n_tiles);
  const Zones z{zones[0], zones[1], zones[2], zones[3], zones[4], zones[5], zones[6]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(M, A)                                                              \
  linesum_kernel<M, A><<<grid, block, 0, st>>>(nu_hi, nu_lo, line_hi, line_lo, coef, \
                                               win, d_near, bcoef, z, n_lines, n_states, \
                                               n_out, ld_out, out)
#define LAUNCH_ACC(M) \
  if (accumulate) LAUNCH(M, true); else LAUNCH(M, false)
  if (accumulate && mode > DOPPLER && mode != PH_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_phco2(mode) && bcoef == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case VOIGT_SPLIT: LAUNCH_ACC(VOIGT_SPLIT); break;
    case LORENTZ: LAUNCH_ACC(LORENTZ); break;
    case DOPPLER: LAUNCH_ACC(DOPPLER); break;
    case FARALL: LAUNCH(FARALL, false); break;
    case FINE: LAUNCH(FINE, false); break;
    case FINE_STENCIL: LAUNCH(FINE_STENCIL, false); break;
    case COARSE: LAUNCH(COARSE, false); break;
    case PH_SPLIT: LAUNCH_ACC(PH_SPLIT); break;
    case PH_FARALL: LAUNCH(PH_FARALL, false); break;
    case PH_FINE: LAUNCH(PH_FINE, false); break;
    case PH_FINE_STENCIL: LAUNCH(PH_FINE_STENCIL, false); break;
    case PH_COARSE: LAUNCH(PH_COARSE, false); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_ACC
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Launch K4 (gathered = 0) or K5 (gathered = 1) for `shape` (VOIGT_SPLIT
// for voigt, PH_SPLIT for phco2, LORENTZ, DOPPLER) on `stream`; row: the
// padded catalog length (K4) or the slab length (K5); start: K4's aligned
// window starts (unread by K5); bcoef: phco2's rates [n_tiles][2][ST].
// Returns cudaGetLastError() (0 on success).
int fullprofile_launch(int shape, int gathered, const float* nu_hi, const float* nu_lo,
                       const float* line_hi, const float* line_lo, const float* S,
                       const float* alpha, const float* gamma, const int* start,
                       const int* count, const float* bcoef, int row, int n_blocks, int block,
                       float cut, int n_states, int n_out, float* out, void* stream) {
  const dim3 grid(n_blocks, (n_states + ST - 1) / ST);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shape == PH_SPLIT && bcoef == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH(SH, G)                                                                     \
  fullprofile_kernel<SH, G><<<grid, block, 0, st>>>(nu_hi, nu_lo, line_hi, line_lo, S, alpha, \
                                                    gamma, start, count, bcoef, row, n_blocks, \
                                                    cut, n_states, n_out, out)
#define LAUNCH_G(SH) \
  if (gathered) LAUNCH(SH, true); else LAUNCH(SH, false)
  switch (shape) {
    case VOIGT_SPLIT: LAUNCH_G(VOIGT_SPLIT); break;
    case LORENTZ: LAUNCH_G(LORENTZ); break;
    case DOPPLER: LAUNCH_G(DOPPLER); break;
    case PH_SPLIT: LAUNCH_G(PH_SPLIT); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_G
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Launch the near-core correction on `stream` (adds into out); with bcoef
// (the phco2 family's rates [n_tiles][2][ST]) the chi instance.
int stencil_correction_launch(const float* dnu_hi, const float* dnu_lo, const int* q,
                              const float* sia, const float* ia, const float* y0,
                              const float* bcoef, int K, int n_lines, int n_states, int n_nu,
                              float cut, int weighted, float D1, float inv_D, float* out,
                              void* stream) {
  const size_t n = (size_t)2 * K * n_lines;
  if (n == 0 || n_states == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bcoef != nullptr)
    stencil_correction_kernel<true><<<blocks, threads, 0, st>>>(
        dnu_hi, dnu_lo, q, sia, ia, y0, bcoef, K, n_lines, n_states, n_nu, cut, weighted, D1,
        inv_D, out);
  else
    stencil_correction_kernel<false><<<blocks, threads, 0, st>>>(
        dnu_hi, dnu_lo, q, sia, ia, y0, bcoef, K, n_lines, n_states, n_nu, cut, weighted, D1,
        inv_D, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
