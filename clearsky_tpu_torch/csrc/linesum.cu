// Line-sum kernels: K1, sigma[state, nu] = sum over each wavenumber block's
// line windows of TIPS-scaled Voigt, sub-Lorentzian CO2 (phco2), Lorentz or
// Doppler line profiles (and its catalog-segmented use, K1-seg); the
// near-core correction of the stencil-near route; and the full-profile
// kernels K4 and K5 (strategies "lane" and "gathered"), the window kernel's
// FULL modes further down.
//
// Replaces clearsky_tpu/ops/linesum_pallas.py::_kernel_resident_grouped,
// launched by _grouped_call, in all its modes:
//   * split (voigt: Humlicek region 1 in the far wing, full w4 near the
//     core) and single sweep (lorentz, doppler), through _pallas_sigma_impl;
//   * FARALL (wmode "farall": region 1 over the whole window), the kernel of
//     the stencil-near route, FINE_STENCIL (wmode "fine_stencil"), the
//     coarse-far split's fine pass beside the correction, and FINE (wmode
//     "fine"), its fine pass where the stencil rejects the grid: these
//     three, voigt and phco2, run window_kernel (its design further down);
//   * COARSE (wmode "coarse"), the coarse-far split's far field;
//   * NOSPLIT (strategy "nosplit": use_split false, :1360 and :621): the
//     full Humlicek w4 with the small-y repair at every in-cut (point, line,
//     state), one sweep over the window with no near/far split, on the
//     (Sia, ia, y0) pack;
//   * K1-seg (_pallas_sigma_segmented, which runs _pallas_sigma_impl's
//     split, no-split and single-sweep modes once per catalog segment): a
//     launch with `accumulate` (the kernel's ACC instance, which a profile
//     names apart) adds into sigma at a row stride of its own,
//     so each segment adds its block range's columns in place, with no
//     temporary and no separate sum. Segments run in order on one stream and
//     each output element is added to by one thread of a launch (that of the
//     last work item of its block and tile), so nothing races.
//     On the TPU the segments keep the pack inside VMEM; here they bound the
//     per-segment temporaries (a pack is built, read while it sits in L2,
//     and freed), and the segment length comes from the routing's budget.
// The phco2 family (shapes phco2 and phco2_ref; _profile_tile :57-83,
// _profile_far :90-120, tile_near :315 and the phco2 far tile :349-365 of
// the grouped kernel) is a second instance of every Voigt mode: y = y0 chi
// with Perrin and Hartmann's chi(|dnu|, T), 1 below 3 cm^-1 and decaying in
// three pieces beyond, so the far wing is region 1 in the explicit (x, y)
// form on (Sia, ia, y0, A) (x^2 = D A) instead of the voigt coefficients in
// D. chi takes ONE exponential of the selected exponent (the TPU code
// evaluates the three exponentials and selects; the value is the same up to
// rounding; K1 takes it in base 2, exp2f); the pieces' arguments are formed
// once per (point, line) and the rates B1(T), B2(T) of each state, computed
// in float64 by the wrapper and rounded, sit in shared memory. The
// *_ref shapes need no device code: the wrapper folds alpha -> alpha /
// sqrt(ln 2) into the coefficients, as _grouped_pack (:537) does. With a
// cut of 500 cm^-1 almost every (point, line) pair is far wing, and each
// then costs one exponential (the SFU) and one division per state.
// correction_gather_kernel replaces the XLA-side _stencil_apply, which adds
// Sia (w4 - region 1) at the grid points of each line's |x| <= 15 core; the
// TPU placed it with one-hot matrix products, here each work item gathers
// the lines of one row of the stencil's row grid and adds their terms in a
// fixed order (its design is described above the kernel).
//
// What bounds K1 on the H100: arithmetic, not memory. Every (point, line,
// state) triple inside the cut costs about ten FP32 operations and one
// reciprocal in the far wing (a full Humlicek w4 near the core), while the
// bytes are one read of each block's line windows. Measured on one H100
// before this design (PERF.md, step 0), the first one (one block per grid
// block and tile of 8 states sweeping the block's whole window) lost its
// time three ways: the coarse passes and FARALL ended on tails (the
// densest 1% of blocks alone lasted 92-97% of the launch: windows of up to
// 906 lines beside a mean of 167; phco2's coarse pass ran 624 blocks, under
// one wave);
// K1-seg ran at ~25% of its issue rate (~18 instructions a far triple: four
// scalar shared loads, and an IEEE division whose slow-path branch kept the
// states' divisions from interleaving); and a 7-float pack of 29.7 KB a
// block held 28 of 64 warps an SM. The design answers each:
//   (a) work items: the host cuts each block's windows into pieces of at
//       most PIECE_LINES lines (ops/linesum_cuda.py::piece_schedule, cached
//       with the grid), lists them costliest first, and the kernel runs one
//       block per (piece, tile of states). A block of several pieces leaves
//       its partial sums in scratch; the last of its items to arrive (an
//       arrival counter after __threadfence) adds them in piece order and
//       writes (or, K1-seg, adds) the columns once, so every launch gives
//       the same bits and no float atomic touches sigma. Tiles are 8 states,
//       then one of 4, 2 and 1 for the rest (57 = 7 x 8 + 1): no tile
//       computes a state past the last;
//   (b) the pack is line-major in 16-byte quads, [n_lines][n_states][4 or
//       8]: one state's far-wing values (A, c1, c2, k2), or phco2's (Sia,
//       ia, y0, A), are one LDS.128. Where the wrapper shows from the pack
//       that every far-wing denominator lies in [2^-120, 2^120]
//       (far_reciprocal_ok, one flag a shard) the division is one
//       approximate reciprocal, a Newton step and the product (rcp_newton);
//       elsewhere it stays IEEE. The near core's w4 stays exact, as a call
//       (wofz_re_call) that keeps its registers out of the far loop;
//   (c) chunks of CH = 32 lines (positions and the tile's quads) are staged
//       with cp.async, chunk k + 1 in flight while chunk k is summed; 8.8 KB
//       (16.9 KB for the split mode's two-quad pack) of shared memory
//       and at most 64 registers a thread (__launch_bounds__(512, 2)) hold 32
//       or more of 64 warps an SM in blocks of 128 threads. Tensor cores do
//       not apply: the sum is a rational function of each triple, not a
//       matrix product.
// The per-(point, line) work (the two-float dnu, the masks, the coarse
// split's switching weights on the shared D = dnu^2, chi's piece) is done
// once for the tile's states; a per-element branch on |dnu| > d_near
// replaces the TPU kernel's two masked sweeps (far: region 1; near: full w4)
// in the split mode (the masks are the same, so the sum is the same).
// K1-dev replaces linesum_pallas.py::sigma_from_lines_pallas_device (:1705):
// the same modes over a stack of spectral shards, each with its own block
// grid, its own windows into its own line slab, and its own d_near from its
// own lines (padding lines, placed at 1e30 cm^-1 with zero strength, kept
// out of it). A piece's row is shard s's block b (row = s n_blocks + b): it
// reads grid points [row B, (row + 1) B), d_near[s] and the reciprocal's
// flag[s], and writes columns [s n_out, (s + 1) n_out) of each state's row.
// The slabs lie side by side as one catalog of k L_pad lines (positions and
// coefficient pack), and the wrapper offsets shard s's window starts by s
// L_pad, so the line loop is K1's. One launch a mode covers every shard a
// rank holds; a shard's pieces are the same alone or in a stack, so its
// columns are the same bits.
//
// NOSPLIT is the split mode's sweep with the full w4 at every in-cut pair:
// the same staging and pack of (Sia, ia, y0), and some ten times the split
// mode's operations (the far wing mostly takes w4's region 1 and the small-y
// repair, where the split mode takes region 1 in D alone). It is kept
// simple; it runs only where a caller asks for it.
//
// Built without --use_fast_math: divisions are IEEE but the far wing's
// reciprocal above, expf/exp2f/sinf/cosf are the accurate versions and
// subnormals are kept (the reciprocal's .ftz form is taken only on
// operands shown to be normal).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int ST = 8;    // states per tile at most (K1's grid), and the rates' tile
constexpr int CH = 32;   // lines per shared-memory chunk of K1 (two chunks in flight)

enum Mode {
  VOIGT_SPLIT = 0, LORENTZ = 1, DOPPLER = 2,       // over the plan's windows
  FARALL = 3, FINE = 4, FINE_STENCIL = 5, COARSE = 6,  // the routes' modes
  // the phco2 family's instances of the Voigt modes
  PH_SPLIT = 7, PH_FARALL = 8, PH_FINE = 9, PH_FINE_STENCIL = 10, PH_COARSE = 11,
  // the no-split sweep over the plan's windows, voigt and phco2
  NOSPLIT = 12, PH_NOSPLIT = 13,
  // K4 and K5, the full profile over each row's window (window_kernel's
  // FULL path): voigt, phco2, lorentz, doppler
  FULL = 14, PH_FULL = 15, FULL_LORENTZ = 16, FULL_DOPPLER = 17
};

constexpr float INV_PI = 0.318309886183790672f;
constexpr float INV_SQRT_PI = 0.564189583547756287f;

// each predicate names its modes: a mode number says nothing by its order
__host__ __device__ constexpr bool is_phco2(int mode) {
  return mode == PH_SPLIT || mode == PH_FARALL || mode == PH_FINE ||
         mode == PH_FINE_STENCIL || mode == PH_COARSE || mode == PH_NOSPLIT || mode == PH_FULL;
}

// the Voigt mode whose sweeps a phco2 mode runs
__host__ __device__ constexpr int voigt_mode(int mode) {
  switch (mode) {
    case PH_SPLIT: return VOIGT_SPLIT;
    case PH_FARALL: return FARALL;
    case PH_FINE: return FINE;
    case PH_FINE_STENCIL: return FINE_STENCIL;
    case PH_COARSE: return COARSE;
    case PH_NOSPLIT: return NOSPLIT;
    case PH_FULL: return FULL;
    default: return mode;
  }
}

// 16-byte quads per (line, state) in K1's pack [n_lines][n_states][4 n_quads]:
//   VOIGT_SPLIT: (Sia, ia, y0, 0) and the far wing's (A, c1, c2, k2);
//   COARSE: (A, c1, c2, k2), region 1 alone;
//   the phco2 family: (Sia, ia, y0, A), region 1 on x^2 = D A and y = y0 chi;
//   NOSPLIT: (Sia, ia, y0, A), A unread; LORENTZ, DOPPLER: (S, alpha, gamma, 0);
//   FARALL, FINE_STENCIL: (A, 1/2 - y0^2, 2 y0^2, k2); PH_FARALL,
//   PH_FINE_STENCIL: (0.5641896 Sia, y0, A, 0) (window_kernel's, below);
//   FINE, PH_FINE: their window quad, then the near core's (Sia, ia, y0, r),
//   laid out [n_lines][2][n_states][4] (window_kernel's FINE path, below);
//   FULL, PH_FULL: the same two quads (K4/K5's, window_kernel's FULL path);
//   FULL_LORENTZ: (S gamma / pi, gamma^2, 0, 0); FULL_DOPPLER: (Sia, A, 0, 0)
__host__ __device__ constexpr int n_quads(int mode) {
  return (mode == VOIGT_SPLIT || mode == FINE || mode == PH_FINE || mode == FULL ||
          mode == PH_FULL) ? 2 : 1;
}

// line windows per block: FINE and FINE_STENCIL sweep the mid window and the
// two annuli at the cut; every other mode one window
__host__ __device__ constexpr int n_windows(int mode) {
  return (voigt_mode(mode) == FINE || voigt_mode(mode) == FINE_STENCIL) ? 3 : 1;
}

// the modes whose launch may add into sigma (K1-seg): the split, no-split
// and single-sweep modes over the plan's windows
__host__ __device__ constexpr bool can_accumulate(int mode) {
  return mode == VOIGT_SPLIT || mode == LORENTZ || mode == DOPPLER || mode == PH_SPLIT ||
         mode == NOSPLIT || mode == PH_NOSPLIT;
}

// K1's tiles of states: n / ST tiles of ST, then one of 4, 2 and 1 for each
// bit of the remainder (57 = 7 x 8 + 1), so no tile computes a state past
// the last
__host__ __device__ constexpr int n_state_tiles(int n) {
  return n / ST + ((n % ST) >> 2 & 1) + ((n % ST) >> 1 & 1) + (n % ST & 1);
}

__device__ __forceinline__ void tile_states(int t, int n, int& s0, int& ns) {
  const int full = n / ST;
  if (t < full) {
    s0 = t * ST;
    ns = ST;
    return;
  }
  s0 = full * ST;
  t -= full;
  const int r = n - s0;
  ns = 0;
  for (int w = ST / 2; w >= 1; w >>= 1) {
    if (r & w) {
      if (t == 0) {
        ns = w;
        return;
      }
      s0 += w;
      --t;
    }
  }
}

// The distances of a launch, float32 as the TPU kernel rounds its constants:
// the cut, the mid zone's support cut_f = 2 d_far, the coarse field's inner
// edge d_lo = d_far, and the two switches, W over D in [D1, D1 + 1/inv_D]
// and the outer roll over [R1, R1 + 1/inv_R]
struct Zones {
  float cut, cut_f, d_lo, D1, inv_D, R1, inv_R;
};

// what a sweep over one window adds
enum Zone { Z_SPLIT, Z_LORENTZ, Z_DOPPLER, Z_COARSE, Z_FULL };

// the zones whose terms are region 1 (beyond d_near, in Z_SPLIT)
__host__ __device__ constexpr bool has_far(int zone) {
  return zone != Z_LORENTZ && zone != Z_DOPPLER && zone != Z_FULL;
}

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

// the same w4 as a call: the split modes' near-core branch, taken at fewer
// than 1% of the pairs, keeps its registers out of the far-wing loop's
__device__ __noinline__ float wofz_re_call(float x, float y) { return wofz_re(x, y); }

// C^2 smootherstep in squared distance: 0 below A1, 1 at A1 + 1/inv
// (linesum_pallas.py::_smoothstep_d2)
__device__ __forceinline__ float smooth_d2(float D, float A1, float inv) {
  const float w = fminf(fmaxf((D - A1) * inv, 0.0f), 1.0f);
  return w * w * w * (10.0f + w * (-15.0f + 6.0f * w));
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

// chi in base 2, as K1 takes it: chi = 2^-(B1' u + B2' v + w'), with the
// rates B' = B log2(e) scaled once as a tile's rates are staged and w' =
// 0.0232 log2(e) (|dnu| - 120); the same value up to rounding, with exp2f's
// shorter sequence in the far-wing loop
constexpr float LOG2E = 1.44269504088896341f;

__device__ __forceinline__ ChiArg chi_arg2(float a) {
  ChiArg q = chi_arg(a);
  q.w = a < 120.0f ? 0.0f : (0.0232f * LOG2E) * (a - 120.0f);
  return q;
}

__device__ __forceinline__ float chi2_of(const ChiArg& q, float B1, float B2) {
  return exp2f(-(B1 * q.u) - B2 * q.v - q.w);
}

// 1/d from the approximate reciprocal (1 ulp) and one Newton step; taken
// only where the wrapper has shown every denominator of the launch to lie
// in [2^-120, 2^120], where d and 1/d are normal floats. On such operands
// the .ftz form gives the same value as the plain one, without the range
// fix-ups (five instructions) that the plain one carries for subnormals;
// nothing else in the library flushes subnormals.
__device__ __forceinline__ float rcp_newton(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return fmaf(r, fmaf(-d, r, 1.0f), r);
}

// One state's far-wing term as (numerator, denominator), Humlicek region 1:
// voigt in D = dnu^2 on (A, c1, c2, k2), k2 (c1 + m) / ((c1 - m)^2 + c2 D),
// m = D A; phco2 on (Sia, ia, y0, A) at x^2 = D A and y = y0 chi, the
// explicit form 0.5641896 Sia y (1/2 + y^2 + x^2) / ((1/2 + y^2 - x^2)^2 +
// 4 x^2 y^2) (the TPU's (y br - x t2i) / (br^2 + t2i^2) expanded)
template <bool PH>
__device__ __forceinline__ void far_parts(const float4& c, float D, float chi, float& num,
                                          float& den) {
  if constexpr (PH) {
    const float y = c.z * chi;
    const float y2 = y * y;
    const float x2 = D * c.w;
    const float h = 0.5f + y2;
    const float br = h - x2;
    den = fmaf(br, br, 4.0f * (x2 * y2));
    num = (0.5641896f * c.x) * (y * (h + x2));
  } else {
    const float m = D * c.x;
    const float br = c.y - m;
    den = fmaf(br, br, c.z * D);
    num = c.w * (c.y + m);
  }
}

// acc += w num / den (w = 1 where the zone has no weight). With the
// reciprocal, the zones that may meet region 1's pole (x^2 = 1/2 + y^2: every
// zone but the far branches at |x| >= 15) hold den at 2^-120 or more, so
// that a line of zero strength, which the wrapper's bound leaves out, adds
// 0 and not 0 x inf
template <bool FAST, bool WEIGHTED, bool POLE>
__device__ __forceinline__ void add_far(float& acc, float num, float den, float w) {
  if constexpr (FAST) {
    if constexpr (POLE) den = fmaxf(den, 0x1p-120f);
    acc = fmaf(WEIGHTED ? num * w : num, rcp_newton(den), acc);
  } else {
    const float f = num / den;
    acc += WEIGHTED ? f * w : f;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// K1's shared memory: two chunks in flight, each CH lines' positions and
// their quads for up to ST states, and the phco2 tile's rates
template <int NQ>
struct Stage {
  float4 c[2][CH * ST * NQ];
  float hi[2][CH];
  float lo[2][CH];
  float B[2 * ST];
  int last;
};

// What one work item sees: its grid point (two-float), its tile's states,
// and the launch's operands
struct Item {
  float nh, nl, d_near;
  int s0, n_states;
  const float* line_hi;
  const float* line_lo;
  const float* line_amin;
  const float4* coef;
};

// Accumulate the lines [start, start + cnt) of one window of the item into
// acc: the chunks are staged with cp.async, chunk k + 1 in flight while
// chunk k is summed. Every thread of the block calls it with the same piece.
template <int ZONE, int NS, int NQ, bool PH, bool FAST>
__device__ __forceinline__ void sweep(int start, int cnt, const Item& it, Stage<NQ>& sm,
                                      const Zones& z, float (&acc)[NS]) {
  constexpr int W = NS * NQ;  // quads per line in the tile
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t ls = (size_t)it.n_states * NQ;  // quads per line in the pack
  const float4* base = it.coef + (size_t)it.s0 * NQ;
  const int n_chunks = (cnt + CH - 1) / CH;
  auto stage = [&](int k) {
    const int l0 = start + k * CH;
    const int n = min(CH, cnt - k * CH);
    const int buf = k & 1;
    for (int i = tid; i < n; i += nthreads) {
      cp_async4(&sm.hi[buf][i], it.line_hi + l0 + i);
      cp_async4(&sm.lo[buf][i], it.line_lo + l0 + i);
    }
    for (int i = tid; i < n * W; i += nthreads) {
      const int j = i / W;
      cp_async16(&sm.c[buf][i], base + (size_t)(l0 + j) * ls + (i - j * W));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (n_chunks > 0) stage(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      stage(k + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int buf = k & 1;
    const int n = min(CH, cnt - k * CH);
    for (int j = 0; j < n; ++j) {
      // two-float dnu: the hi difference is exact for nearby values and the
      // residuals restore the sub-f32 position information
      const float dnu = (it.nh - sm.hi[buf][j]) + (it.nl - sm.lo[buf][j]);
      const float adnu = fabsf(dnu);
      const float D = dnu * dnu;
      const float4* c = &sm.c[buf][j * W];
      // the zone's mask and its switching weight, shared by the NS states
      float w = 1.0f;
      if constexpr (ZONE == Z_SPLIT || ZONE == Z_LORENTZ || ZONE == Z_DOPPLER ||
                    ZONE == Z_FULL) {
        if (!(adnu <= z.cut)) continue;
      } else {  // Z_COARSE: the smooth far field W Wout on the coarse grid
        if (!(adnu <= z.cut && adnu > z.d_lo)) continue;
        w = smooth_d2(D, z.D1, z.inv_D) * (1.0f - smooth_d2(D, z.R1, z.inv_R));
      }
      ChiArg q{0.0f, 0.0f, 0.0f};
      if constexpr (PH) q = chi_arg2(adnu);
      if constexpr (ZONE == Z_LORENTZ) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float S = c[s].x, gam = c[s].z;
          acc[s] += S * (gam * INV_PI) / (dnu * dnu + gam * gam);
        }
      } else if constexpr (ZONE == Z_DOPPLER) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float S = c[s].x, ia = 1.0f / c[s].y;
          const float arg = dnu * ia;
          acc[s] += (S * INV_SQRT_PI * ia) * expf(-arg * arg);
        }
      } else if constexpr (ZONE == Z_FULL) {
        // NOSPLIT: the full w4 at every in-cut pair, no near/far branch
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float chi = PH ? chi2_of(q, sm.B[s], sm.B[ST + s]) : 1.0f;
          acc[s] += c[s].x * wofz_re(dnu * c[s].y, c[s].z * chi);
        }
      } else if constexpr (ZONE == Z_SPLIT) {
        // a per-element branch replaces the TPU kernel's two masked sweeps:
        // region 1 beyond d_near, the full w4 within it
        if (adnu > it.d_near) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float chi = PH ? chi2_of(q, sm.B[s], sm.B[ST + s]) : 1.0f;
            float num, den;
            far_parts<PH>(c[s * NQ + NQ - 1], D, chi, num, den);
            add_far<FAST, false, false>(acc[s], num, den, w);
          }
        } else {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float chi = PH ? chi2_of(q, sm.B[s], sm.B[ST + s]) : 1.0f;
            const float4 cn = c[s * NQ];
            acc[s] += cn.x * wofz_re_call(dnu * cn.y, cn.z * chi);
          }
        }
      } else {
        // COARSE: region 1, weighted
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float chi = PH ? chi2_of(q, sm.B[s], sm.B[ST + s]) : 1.0f;
          float num, den;
          far_parts<PH>(c[s * NQ + NQ - 1], D, chi, num, den);
          add_far<FAST, true, true>(acc[s], num, den, w);
        }
      }
    }
    __syncthreads();  // chunk k's buffer is refilled by stage(k + 2)
  }
}

// The sweep of zone ZONE, with the reciprocal where the launch allows it
template <int ZONE, int NS, int NQ, bool PH>
__device__ __forceinline__ void sweep_zone(int start, int cnt, bool fast, const Item& it,
                                           Stage<NQ>& sm, const Zones& z, float (&acc)[NS]) {
  if constexpr (has_far(ZONE)) {
    if (fast) {
      sweep<ZONE, NS, NQ, PH, true>(start, cnt, it, sm, z, acc);
      return;
    }
  }
  sweep<ZONE, NS, NQ, PH, false>(start, cnt, it, sm, z, acc);
}

// One work item of a tile of NS states: sweep the piece, then write its
// columns, or, for a block whose windows were cut into several pieces,
// leave the partial sums in scratch; the last of the block's items to
// arrive sums them in piece order and writes the columns once.
template <int MODE, bool ACC, int NS>
__device__ void run_item(const int4 pa, const int4 pb, int shard, bool fast, const Item& it,
                         Stage<n_quads(MODE)>& sm, const float* bcoef, const Zones& z, int tile,
                         int n_tiles, int n_out, int ld_out, float* scratch, int* counters,
                         float* out, int p) {
  constexpr int NQ = n_quads(MODE);
  constexpr int VM = voigt_mode(MODE);
  constexpr bool PH = is_phco2(MODE);
  const int tid = threadIdx.x;
  const int B = blockDim.x;
  const int n_states = it.n_states;
  const int s0 = it.s0;
  if constexpr (PH) {
    if (tid < NS) {
      const int st = s0 + tid;
      const float* bt = bcoef + (size_t)(st / ST) * 2 * ST + st % ST;
      sm.B[tid] = bt[0] * LOG2E;
      sm.B[ST + tid] = bt[ST] * LOG2E;
    }
    __syncthreads();
  }
  float acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.0f;
  const int start = pa.z, cnt = pa.w;
#define SWEEP(ZONE) sweep_zone<ZONE, NS, NQ, PH>(start, cnt, fast, it, sm, z, acc)
  if constexpr (VM == VOIGT_SPLIT) SWEEP(Z_SPLIT);
  else if constexpr (VM == LORENTZ) SWEEP(Z_LORENTZ);
  else if constexpr (VM == DOPPLER) SWEEP(Z_DOPPLER);
  else if constexpr (VM == COARSE) SWEEP(Z_COARSE);
  else if constexpr (VM == NOSPLIT) SWEEP(Z_FULL);
#undef SWEEP

  const int part = pb.x, nparts = pb.y, slot = pb.z;
  float tot[NS];
  if (nparts == 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s) tot[s] = acc[s];
  } else {
    // partials [slot][n_states][B]; the block's arrival count per tile
    float* mine = scratch + ((size_t)(slot + part) * n_states + s0) * B + tid;
#pragma unroll
    for (int s = 0; s < NS; ++s) __stcg(mine + (size_t)s * B, acc[s]);
    __threadfence();
    __syncthreads();
    if (tid == 0) sm.last = atomicAdd(counters + (size_t)pa.x * n_tiles + tile, 1) == nparts - 1;
    __syncthreads();
    if (!sm.last) return;
    __threadfence();
#pragma unroll
    for (int s = 0; s < NS; ++s) tot[s] = 0.0f;
    for (int k = 0; k < nparts; ++k) {
      const float* src = scratch + ((size_t)(slot + k) * n_states + s0) * B + tid;
#pragma unroll
      for (int s = 0; s < NS; ++s) tot[s] += k == part ? acc[s] : __ldcg(src + (size_t)s * B);
    }
  }
  if (p < n_out) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float* o = out + (size_t)(s0 + s) * ld_out + (size_t)shard * n_out + p;
      if constexpr (ACC) *o += tot[s];
      else *o = tot[s];
    }
  }
}

// K1: one block per work item (a piece of a block's window and a tile of
// states), one thread per grid point. pieces [n_pieces][8] int32: (row,
// window, start, count, part, n_parts, slot, 0), the costliest first; row =
// shard n_blocks + block: the block's grid points are nu rows [row B, (row +
// 1) B), its shard's d_near[shard], fast[shard] and output columns [shard
// n_out, (shard + 1) n_out). grid.x = n_pieces n_tiles, tile fastest.
// out: [n_states][ld_out], written (ACC, K1-seg's launches: added to, an
// instance of its own so that a profile tells them apart); scratch
// [n_slots][n_states][B] and counters [n_rows][n_tiles] (zero) serve the
// blocks of more than one piece. bcoef (the phco2 modes) the rates
// [n_tiles of ST][2][ST].
template <int MODE, bool ACC>
__global__ void __launch_bounds__(512, (MODE == NOSPLIT || MODE == PH_NOSPLIT) ? 1 : 2)
linesum_kernel(const float* __restrict__ nu_hi, const float* __restrict__ nu_lo,
               const float* __restrict__ line_hi, const float* __restrict__ line_lo,
               const float4* __restrict__ coef, const int4* __restrict__ pieces,
               const float* __restrict__ d_near_p, const int* __restrict__ fast_p,
               const float* __restrict__ bcoef, Zones z, int n_blocks, int n_states,
               int n_out, int ld_out, float* __restrict__ scratch,
               int* __restrict__ counters, float* __restrict__ out) {
  constexpr int VM = voigt_mode(MODE);
  __shared__ __align__(16) Stage<n_quads(MODE)> sm;
  const int n_tiles = n_state_tiles(n_states);
  const int item = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - item * n_tiles;
  const int4 pa = pieces[2 * item];
  const int4 pb = pieces[2 * item + 1];
  const int shard = pa.x / n_blocks;
  const int p = (pa.x - shard * n_blocks) * blockDim.x + threadIdx.x;  // padded to whole blocks
  int s0, ns;
  tile_states(tile, n_states, s0, ns);
  Item it;
  it.nh = nu_hi[(size_t)pa.x * blockDim.x + threadIdx.x];
  it.nl = nu_lo[(size_t)pa.x * blockDim.x + threadIdx.x];
  it.d_near = VM == VOIGT_SPLIT ? d_near_p[shard] : 0.0f;
  it.s0 = s0;
  it.n_states = n_states;
  it.line_hi = line_hi;
  it.line_lo = line_lo;
  it.coef = coef;
  const bool fast = fast_p[shard] != 0;
#define RUN(NS)                                                                         \
  run_item<MODE, ACC, NS>(pa, pb, shard, fast, it, sm, bcoef, z, tile, n_tiles, n_out, \
                          ld_out, scratch, counters, out, p)
  switch (ns) {
    case 8: RUN(8); break;
    case 4: RUN(4); break;
    case 2: RUN(2); break;
    default: RUN(1); break;
  }
#undef RUN
}

// The region-1 window modes, FARALL (the stencil-near route: region 1 over
// each block's whole window, the core corrected afterwards by
// correction_gather_kernel) and FINE_STENCIL (the coarse split's fine pass
// beside that correction: region 1 weighted 1 - W over |dnu| <= cut_f, and
// the two annuli at the cut weighted by the outer roll), voigt and phco2
// (wmodes farall :451 and fine_stencil :459 of _kernel_resident_grouped),
// have a kernel of their own, window_kernel. Measured on one H100 in the
// sweep above (PERF.md, the window modes' step 0), they lost their time
// three ways:
//   * issued instructions: a (point, line, state) triple took ~12 (the
//     quad's LDS.128, six FP32 operations for (num, den), the pole's clamp,
//     MUFU.RCP, two Newton FFMAs, the sum), ~30 for phco2; at the mix's 38 x
//     2^19 (18.3 G triples) that and the pair work came to 9.06 ms;
//   * too few warps at the RCM's 20 x 16,384: ~4.5 blocks of 4 warps an SM,
//     each thread a chain of a piece's <= 256 lines x 8 states;
//   * FINE_STENCIL's fixed cost per work item: every window at least one
//     piece, so a row with lines in two or three windows went through
//     scratch, a fence and the arrival counter, for ~16 lines a row.
// The design answers each:
//   (a) region 1 in one quad a (line, state), rewritten so that each triple
//       takes three FFMAs, one MUFU.RCP and the summing FFMA: with x^2 = D A
//       and w = 1/2 - y^2 - x^2, the denominator (1/2 + y^2 - x^2)^2 + 4 x^2
//       y^2 is w^2 + 2 y^2 and the numerator's 1/2 + y^2 + x^2 is 1 - w, so
//       voigt's pack (A, h, g, k2) = (ia^2, 1/2 - y0^2, 2 y0^2, S gamma A /
//       pi) gives w = fma(-D, A, h), den = fma(w, w, g), num = fma(-k2, w,
//       k2); phco2's (c, y0, A, 0), c = 0.5641896 Sia, the same on y = y0
//       chi, with chi's exp2 taken as ex2.approx (the approximation exp2f
//       takes, without the subnormal handling no chi, a normal float,
//       needs). Where the wrapper's flag shows every denominator in
//       [2^-120, 2^120] the reciprocal is one rcp.approx (<= 1 ulp, no
//       Newton step); den >= 2 y^2 needs no clamp, and the pack gives a line
//       of zero strength den = 1 and num = 0. (Shorter forms of the same
//       values per line, phco2's chi within 3 and 30 cm^-1 and a weight of
//       1 left out, did not pay on balance; PERF.md has their times.)
//       Within two Doppler widths of a line for some state (D amin <= 4, amin the line's least ia^2),
//       around region 1's pole (x^2 = 1/2 + y^2), which the correction takes
//       out again, the terms take far_parts' algebra with the Newton step,
//       as the plain version and the earlier sweep do: there the float32
//       residue of the pole's cancellation follows the rounding of the two
//       region 1s, and the new algebra's left up to 5x the plain version's
//       at some states;
//   (b) a launch plan (ops/linesum_cuda.py::window_plan) picks the piece
//       length, how many groups of a row's threads split a piece's lines
//       (G <= 4) and how many of the row's points a thread owns (PTS = 2 for
//       the voigt modes on a full card: one staged quad serves both, and
//       the loop's per-line cost is shared): each group sums its part of
//       every staged chunk, and the groups' sums are added in group order
//       through shared memory, so a launch of few rows fills the card;
//   (c) a work item covers a row's three windows as one stream of lines in
//       (window, line) order, each staged line knowing its zone from its
//       place in the stream, so a row of <= piece-length lines is one item
//       with no scratch; longer rows are cut into pieces added in piece
//       order through scratch, as in K1's other modes;
//   (d) states in balanced tiles: ceil(n / 8) tiles of n / T or n / T + 1
//       states (57 = 8 + 7 x 7, 38 = 3 x 8 + 2 x 7), so no tile repeats the
//       pair work for one or two states.
// No float atomic touches sigma: two launches give the same bits. Measured
// on one H100 (PERF.md): FARALL at the mix's width 9.06 -> 5.89 ms, at the
// RCM's 0.071 -> 0.037 (each block's prologue, staging and pieces' scratch
// now a third of it), FINE_STENCIL 0.319 -> 0.217 (the sigma it writes and
// its per-block fixed cost), phco2's 1.33 -> 0.97 (two MUFUs a triple).
// lines a staged chunk of window_kernel: 64, and 32 for voigt's
// FINE_STENCIL and FINE, whose rows hold ~16 lines (a smaller block stage
// keeps more of its short-lived blocks resident), and for voigt's FULL,
// whose blocks of two warps shared memory held to 11 an SM at 64 (4-6%
// faster at the mix's width, PERF.md)
__host__ __device__ constexpr int window_chunk(int mode) {
  return mode == FINE_STENCIL || mode == FINE || mode == FULL ? 32 : 64;
}
constexpr int MAX_GROUPS = 4;    // thread groups that split a piece's lines
constexpr int RED_FLOATS = 3 * ST * 128;  // the groups' sums, (G - 1) x NS x points

// K4/K5's modes: the full profile over each row's window
__host__ __device__ constexpr bool is_full(int mode) {
  return voigt_mode(mode) == FULL || mode == FULL_LORENTZ || mode == FULL_DOPPLER;
}

// the FULL modes with w4 and its near reach (voigt, phco2)
__host__ __device__ constexpr bool full_w4(int mode) { return voigt_mode(mode) == FULL; }

__host__ __device__ constexpr bool is_window(int mode) {
  return mode == FARALL || mode == FINE_STENCIL || mode == PH_FARALL || mode == PH_FINE_STENCIL ||
         mode == FINE || mode == PH_FINE || is_full(mode);
}

__host__ __device__ constexpr int window_tiles(int n) { return (n + ST - 1) / ST; }

// tile t of the balanced tiling: states [s0, s0 + ns)
__device__ __forceinline__ void window_tile(int t, int n, int& s0, int& ns) {
  const int T = window_tiles(n), q = n / T, r = n - q * T;
  s0 = t * q + min(t, r);
  ns = q + (t < r ? 1 : 0);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

template <int WCH, class AUX = float>
struct WindowStage {
  union {
    float4 c[2][WCH * ST];     // two chunks' quads, [line][state of the tile]
    float red[RED_FLOATS];     // then the groups' sums
  };
  float2 pos[2][WCH];          // the chunks' two-float line positions
  AUX aux[2][WCH];             // the lines' least A = ia^2 over the states (FINE: the
                               // lines' near reach over the tile; FULL's w4 modes: that
                               // reach and the tile's small-y flag)
  float B[2 * ST];             // chi's rates of the tile (phco2), in base 2
  int last;
};

// a window mode's shared memory
template <int MODE>
using ModeStage = WindowStage<window_chunk(MODE), std::conditional_t<full_w4(MODE), float2, float>>;

// chi's arguments in base 2 (chi_arg2) as clamps: u = clamp(a - 3, 0, 27),
// v = clamp(a - 30, 0, 90), w' = 0.0232 log2(e) max(a - 120, 0), the same
// values as chi_arg2's pieces
__device__ __forceinline__ ChiArg chi_arg2_clamped(float a) {
  return {fminf(fmaxf(a - 3.0f, 0.0f), 27.0f), fminf(fmaxf(a - 30.0f, 0.0f), 90.0f),
          (0.0232f * LOG2E) * fmaxf(a - 120.0f, 0.0f)};
}

// One (line, state)'s region-1 term at one point, added into acc: D =
// dnu^2, wt the zone's weight (WEIGHTED), q chi's arguments and B1, B2 the
// state's rates (PH)
template <bool PH, bool FAST, bool WEIGHTED, bool CORE = false, bool CHI1 = false>
__device__ __forceinline__ void region1_term(const float4& k, float D, float wt,
                                             const ChiArg& q, float B1, float B2,
                                             float& acc) {
  float num, den;
  if constexpr (CORE) {
    // within a core the correction takes region 1 out again: there the
    // terms take far_parts' algebra, as the plain version does, from the
    // same pack (c1 = 1/2 + y0^2 = g / 2 + 1/2, c2 = 4 y0^2 A = 2 g A)
    if constexpr (PH) {
      const float y = k.y * ex2_approx(-fmaf(B1, q.u, fmaf(B2, q.v, q.w)));
      const float y2 = y * y;
      const float x2 = D * k.z;
      const float h = 0.5f + y2;
      const float br = h - x2;
      den = fmaf(br, br, 4.0f * (x2 * y2));
      num = k.x * (y * (h + x2));
    } else {
      const float c1 = fmaf(k.z, 0.5f, 0.5f);
      const float m = D * k.x;
      const float br = c1 - m;
      den = fmaf(br, br, ((k.z + k.z) * k.x) * D);
      num = k.w * (c1 + m);
    }
    add_far<FAST, WEIGHTED, true>(acc, num, den, wt);
    return;
  }
  if constexpr (PH) {
    // CHI1: every |dnu| < 3 cm^-1, where chi is 1 (and ex2.approx(0) is 1)
    const float y = CHI1 ? k.y : k.y * ex2_approx(-fmaf(B1, q.u, fmaf(B2, q.v, q.w)));
    const float y2 = y * y;
    const float w = fmaf(-D, k.z, 0.5f - y2);
    den = fmaf(w, w, y2 + y2);
    const float cy = (WEIGHTED ? k.x * wt : k.x) * y;
    num = fmaf(-cy, w, cy);
  } else {
    const float w = fmaf(-D, k.x, k.y);
    den = fmaf(w, w, k.z);
    const float kw = WEIGHTED ? k.w * wt : k.w;
    num = fmaf(-kw, w, kw);
  }
  if constexpr (FAST) acc = fmaf(num, rcp_approx(den), acc);
  else acc += num / den;
}

// A line's terms of the NS states at every one of the thread's PTS points
template <int NS, int PTS, bool PH, bool FAST, bool WEIGHTED, bool CORE, bool CHI1 = false>
__device__ __forceinline__ void region1_line(const float4* c, const float (&D)[PTS],
                                             const float (&wt)[PTS], const ChiArg (&q)[PTS],
                                             const float (&B1)[NS], const float (&B2)[NS],
                                             float (&acc)[PTS][NS]) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const float4 k4 = c[s];
#pragma unroll
    for (int p = 0; p < PTS; ++p)
      region1_term<PH, FAST, WEIGHTED, CORE, CHI1>(k4, D[p], wt[p], q[p], B1[s], B2[s],
                                                   acc[p][s]);
  }
}

// What a window item sees: its PTS points (two-float), the row's windows as
// one stream (window k's lines start at ws[k] and fill the stream's [end[k -
// 1], end[k])), its tile's states and the launch's operands
template <int NW, int PTS>
struct WindowItem {
  float nh[PTS], nl[PTS];
  int ws[NW], end[NW];
  int s0, n_states;
  const float* line_hi;
  const float* line_lo;
  const float* line_amin;
  const float4* coef;
  // the catalog index of the stream's line i
  __device__ __forceinline__ int line(int i) const {
    if constexpr (NW == 1) {
      return ws[0] + i;
    } else {
      return i < end[0] ? ws[0] + i : i < end[1] ? ws[1] + i - end[0] : ws[2] + i - end[1];
    }
  }
};

// Sum the stream's lines [o, o + cnt) into acc: chunks of WCH lines staged
// with cp.async (chunk k + 1 in flight while chunk k is summed), group g of
// the block's G summing lines [g per, (g + 1) per) of each chunk; each
// thread's PTS points share every staged quad it reads
template <int NS, int NW, int PTS, bool PH, bool FAST, int WCH>
__device__ __forceinline__ void window_sweep(int o, int cnt, int g, int G,
                                             const WindowItem<NW, PTS>& it,
                                             WindowStage<WCH>& sm, const Zones& z,
                                             float (&acc)[PTS][NS]) {
  constexpr bool WEIGHTED = NW == 3;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n_chunks = (cnt + WCH - 1) / WCH;
  const int per = (WCH + G - 1) / G;
  auto stage = [&](int k) {
    const int c0 = o + k * WCH;
    const int n = min(WCH, cnt - k * WCH);
    const int buf = k & 1;
    for (int i = tid; i < n; i += nthreads) {
      const int l = it.line(c0 + i);
      cp_async4(&sm.pos[buf][i].x, it.line_hi + l);
      cp_async4(&sm.pos[buf][i].y, it.line_lo + l);
      cp_async4(&sm.aux[buf][i], it.line_amin + l);
    }
    for (int i = tid; i < n * NS; i += nthreads) {
      const int j = i / NS;
      cp_async16(&sm.c[buf][i],
                 it.coef + (size_t)it.line(c0 + j) * it.n_states + it.s0 + (i - j * NS));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  float B1[NS], B2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    B1[s] = PH ? sm.B[s] : 0.0f;
    B2[s] = PH ? sm.B[ST + s] : 0.0f;
  }
  if (n_chunks > 0) stage(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      stage(k + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int buf = k & 1;
    const int c0 = o + k * WCH;
    const int j1 = min(min(WCH, cnt - k * WCH), (g + 1) * per);
    for (int j = g * per; j < j1; ++j) {
      // two-float dnu at each point, as in K1's other modes; the zone's
      // mask and weight
      const float2 ps = sm.pos[buf][j];
      const float am = sm.aux[buf][j];
      const bool mid = NW == 3 && c0 + j < it.end[0];
      float D[PTS], wt[PTS];
      ChiArg q[PTS];
      bool in[PTS], cor[PTS];
      bool any = false, all = true, core = false;
#pragma unroll
      for (int p = 0; p < PTS; ++p) {
        const float dnu = (it.nh[p] - ps.x) + (it.nl[p] - ps.y);
        const float adnu = fabsf(dnu);
        D[p] = dnu * dnu;
        wt[p] = 1.0f;
        if constexpr (NW == 3) {
          if (mid) {
            // the mid window: region 1 over |dnu| <= cut_f, weighted 1 - W
            in[p] = adnu <= z.cut_f;
            wt[p] = 1.0f - smooth_d2(D[p], z.D1, z.inv_D);
          } else {
            // the annuli [cut - w_roll, cut], weighted by the outer roll
            in[p] = adnu <= z.cut && D[p] > z.R1;
            wt[p] = smooth_d2(D[p], z.R1, z.inv_R);
          }
        } else {
          in[p] = adnu <= z.cut;
        }
        if constexpr (PH) q[p] = chi_arg2_clamped(adnu);
        // within two Doppler widths of the line (x^2 <= 4) for some state:
        // around region 1's pole (x^2 = 1/2 + y^2), which the correction
        // cancels, at every y where den there (~ 2 y^2) is small
        cor[p] = D[p] * am <= 4.0f;
        core = core || (in[p] && cor[p]);
        any = any || in[p];
        all = all && in[p];
      }
      if (!any) continue;
      const float4* c = &sm.c[buf][j * NS];
      if (all && core) {
        region1_line<NS, PTS, PH, FAST, WEIGHTED, true>(c, D, wt, q, B1, B2, acc);
      } else if (all) {
        region1_line<NS, PTS, PH, FAST, WEIGHTED, false>(c, D, wt, q, B1, B2, acc);
      } else {
#pragma unroll
        for (int p = 0; p < PTS; ++p) {
          if (!in[p]) continue;
          if (cor[p]) {
#pragma unroll
            for (int s = 0; s < NS; ++s)
              region1_term<PH, FAST, WEIGHTED, true>(c[s], D[p], wt[p], q[p], B1[s], B2[s],
                                                     acc[p][s]);
          } else {
#pragma unroll
            for (int s = 0; s < NS; ++s)
              region1_term<PH, FAST, WEIGHTED>(c[s], D[p], wt[p], q[p], B1[s], B2[s],
                                               acc[p][s]);
          }
        }
      }
    }
    __syncthreads();  // chunk k's buffer is refilled by stage(k + 2)
  }
}


// FINE (the coarse split's fine pass where the stencil rejects the grid:
// region 1 weighted 1 - W over d_near < |dnu| <= cut_f, Humlicek's w4
// weighted 1 - W within d_near, the two annuli at the cut) in window_kernel.
// Measured on one H100 in the general sweep (PERF.md, FINE's step 0), it lost its
// time to the general sweep and the near core: every mid triple took the
// ~15-instruction region 1 of a two-quad pack (its staging 44% of the
// launch); within d_near (15 of the launch's widest Doppler widths) w4 ran
// at every pair, three in four of them in its region 1, each a call that a
// warp's lanes took in every region any of them needed; each window was a
// piece of its own. The design:
//   (a) the row's mid window and annuli are one stream of lines on the
//       window kernel's pieces, groups, points a thread and balanced tiles,
//       region 1 on the window quad (no core algebra: beyond a pair's near
//       reach |x| + y >= 15, far from region 1's pole); phco2 takes y = y0
//       without chi's exponential where the line's points all lie within 3
//       cm^-1 (chi = 1 there, and ex2.approx(0) is 1: the same bits);
//   (b) the near core is per (line, state): a pair takes w4 where |dnu| <=
//       r = min(d_near, (15.01 - y0) / ia), where |x| + y < 15.01 may hold,
//       and region 1 beyond, where w4 is its region 1 (s >= 15, y >= 0.01:
//       no small-y repair), the window quad's function (for voigt up to its
//       constant, 1/sqrt(pi) for w4's 0.5641896, 2.9e-8 apart: below
//       float32's rounding); where y0 < 0.01, and for phco2 where d_near >=
//       3 cm^-1 (chi may bring y below y0 beyond), r = d_near, the plain
//       version's zone. Three in four of the launch's w4 calls go;
//   (c) a line of the mid window whose reach over the tile's states
//       (line_reach, one float a line and tile, staged with the chunk)
//       meets the row is a near line: its group takes each (state, point)
//       in turn, w4 (the call, its quad (Sia, ia, y0, reach) read from the
//       pack where the line is near) within the pair's reach, region 1
//       beyond, in the line's place in the stream. Measured (PERF.md, FINE's
//       design runs): a block-wide gather of the w4 pairs laid out by region, so
//       that a warp runs one region, cost more than the divergence it
//       removed (a few percent of the triples are near); so did one call
//       site for a line's pairs, w4 inlined, and 128 registers a thread;
//   (d) a shard axis: a row is shard s's block b (row = s n_blocks + b), with
//       d_near[s], the reciprocal's flag[s] and output columns [s n_out,
//       (s + 1) n_out), so K1-dev's stack of shards is one launch and a
//       shard's columns are the same bits alone or in a stack (the plan
//       takes each shard from its own rows).
// No float atomic: two launches give the same bits.
constexpr float NEAR_EPS = 1e-5f;  // cm^-1: the near-line test's margin (a superset)

// What a FINE item sees beyond a window item's: its row's first and last
// points (two-float), its shard's d_near, the lines' near reach per tile and
// its tile
template <int PTS>
struct FineItem : WindowItem<3, PTS> {
  float f_hi, f_lo, l_hi, l_lo, d_near;
  const float* line_reach;
  int tile, n_tiles;
};

// a pair's near reach from its (line, state)'s reach ry (the w4 quad's last
// place: (15.01 - y0) / ia, +inf where y0 < 0.01, -inf where Sia = 0):
// min(d_near, ry); phco2 beyond d_near = 3 cm^-1, where chi may bring y
// below y0, d_near for a line of nonzero strength. Taken with a line's
// largest ry over the tile's states (line_reach) it gives the largest over
// the tile's pairs.
template <bool PH>
__device__ __forceinline__ float near_reach(float ry, float d_near) {
  if (PH && d_near >= 3.0f) return ry > -3.0e38f ? d_near : -1.0f;
  return fminf(d_near, ry);
}

// whether a line of the mid window may have near pairs in the row: its
// reach over the tile's states (ry, the largest) meets the row's span
template <bool PH, int PTS>
__device__ __forceinline__ bool near_line(const float2 ps, float ry, const FineItem<PTS>& it) {
  const float r = near_reach<PH>(ry, it.d_near);
  const float d0 = (it.f_hi - ps.x) + (it.f_lo - ps.y);
  const float d1 = (it.l_hi - ps.x) + (it.l_lo - ps.y);
  return r >= 0.0f && d0 <= r + NEAR_EPS && d1 >= -r - NEAR_EPS;
}

// window_sweep's FINE instance: each chunk's lines of group g, region 1 on
// the window quads, a near line's pairs within their reach w4
template <int NS, int PTS, bool PH, bool FAST, int WCH>
__device__ __forceinline__ void fine_sweep(int o, int cnt, int g, int G,
                                           const FineItem<PTS>& it, WindowStage<WCH>& sm,
                                           const Zones& z, float (&acc)[PTS][NS]) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n_chunks = (cnt + WCH - 1) / WCH;
  const int per = (WCH + G - 1) / G;
  const size_t ls = 2 * (size_t)it.n_states;  // quads a line in the pack: [2][n_states]
  auto stage = [&](int k) {
    const int c0 = o + k * WCH;
    const int n = min(WCH, cnt - k * WCH);
    const int buf = k & 1;
    for (int i = tid; i < n; i += nthreads) {
      const int l = it.line(c0 + i);
      cp_async4(&sm.pos[buf][i].x, it.line_hi + l);
      cp_async4(&sm.pos[buf][i].y, it.line_lo + l);
      cp_async4(&sm.aux[buf][i], it.line_reach + (size_t)l * it.n_tiles + it.tile);
    }
    for (int i = tid; i < n * NS; i += nthreads) {
      const int j = i / NS;
      cp_async16(&sm.c[buf][i], it.coef + (size_t)it.line(c0 + j) * ls + it.s0 + (i - j * NS));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  float B1[NS], B2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    B1[s] = PH ? sm.B[s] : 0.0f;
    B2[s] = PH ? sm.B[ST + s] : 0.0f;
  }
  if (n_chunks > 0) stage(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      stage(k + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int buf = k & 1;
    const int c0 = o + k * WCH;
    const int j1 = min(min(WCH, cnt - k * WCH), (g + 1) * per);
    for (int j = g * per; j < j1; ++j) {
      const float2 ps = sm.pos[buf][j];
      const bool mid = c0 + j < it.end[0];
      float dnu[PTS], D[PTS], wt[PTS];
      ChiArg q[PTS];
      bool in[PTS];
      bool any = false, all = true, chi1 = true;
#pragma unroll
      for (int p = 0; p < PTS; ++p) {
        dnu[p] = (it.nh[p] - ps.x) + (it.nl[p] - ps.y);
        const float adnu = fabsf(dnu[p]);
        D[p] = dnu[p] * dnu[p];
        if (mid) {
          // the mid window: region 1 over |dnu| <= cut_f, weighted 1 - W
          in[p] = adnu <= z.cut_f;
          wt[p] = 1.0f - smooth_d2(D[p], z.D1, z.inv_D);
        } else {
          // the annuli [cut - w_roll, cut], weighted by the outer roll
          in[p] = adnu <= z.cut && D[p] > z.R1;
          wt[p] = smooth_d2(D[p], z.R1, z.inv_R);
        }
        if constexpr (PH) q[p] = chi_arg2_clamped(adnu);
        any = any || in[p];
        all = all && in[p];
        chi1 = chi1 && adnu < 3.0f;
      }
      if (!any) continue;
      const float4* c = sm.c[buf] + j * NS;
      if (mid && near_line<PH>(ps, sm.aux[buf][j], it)) {
        // a near line: w4 within each pair's reach, region 1 beyond
        const float4* nq4 = it.coef + (size_t)it.line(c0 + j) * ls + it.n_states + it.s0;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float4 nq = nq4[s];
          const float r = near_reach<PH>(nq.w, it.d_near);
#pragma unroll
          for (int p = 0; p < PTS; ++p) {
            if (fabsf(dnu[p]) <= r) {
              const float chi = PH ? chi2_of(chi_arg2(fabsf(dnu[p])), B1[s], B2[s]) : 1.0f;
              acc[p][s] += nq.x * wofz_re_call(dnu[p] * nq.y, nq.z * chi) * wt[p];
            } else if (in[p]) {
              region1_term<PH, FAST, true>(c[s], D[p], wt[p], q[p], B1[s], B2[s], acc[p][s]);
            }
          }
        }
      } else if (all && PH && chi1) {
        region1_line<NS, PTS, PH, FAST, true, false, true>(c, D, wt, q, B1, B2, acc);
      } else if (all) {
        region1_line<NS, PTS, PH, FAST, true, false>(c, D, wt, q, B1, B2, acc);
      } else {
#pragma unroll
        for (int p = 0; p < PTS; ++p) {
          if (!in[p]) continue;
#pragma unroll
          for (int s = 0; s < NS; ++s)
            region1_term<PH, FAST, true>(c[s], D[p], wt[p], q[p], B1[s], B2[s], acc[p][s]);
        }
      }
    }
    __syncthreads();  // chunk k's buffer is refilled by stage(k + 2)
  }
}

// K4 and K5 (the full profile over each row's window: strategies "lane"
// and "gathered", replacing linesum_pallas.py::_kernel_resident and
// ::_kernel) in window_kernel, modes FULL (voigt), PH_FULL (phco2),
// FULL_LORENTZ and FULL_DOPPLER. They compute Humlicek's w4 with its
// small-y repair at every in-cut (point, line, state) (phco2: at y = y0
// chi(|dnu|, T)), or the exact Lorentz or Doppler profile. Measured on one
// H100 (PERF.md, K4/K5's step 0), the earlier simple kernel (a block a grid
// block and tile of 8 states, w4 inlined at every triple) lost its time to
// w4's code at every triple (~530 SASS instructions, two IEEE divisions even in
// region 1), though 99.96% of the triples are w4's region 1 and 99.7% lie in
// warps wholly in it; K5 also to its host gather of each block's slab, in
// groups of 3 states (19 launches at 57 states in tiles padded to 8, each
// launch's tail set by its densest blocks). The design:
//   (a) the window kernel's work items, groups, points a thread and
//       balanced tiles over the plan's window of each row, read in place
//       from the catalog (the lines K5's slab held; the lane layout's
//       window adds before them lines beyond every point's cut, whose terms
//       are 0, so K4 makes the same launch); one launch for every state;
//   (b) a pack [n_lines][2][n_states][4] made once a call on the device:
//       the window quad, then w4's quad (Sia, ia, y0, r), r the (line,
//       state)'s near reach, (15.01 - y0) / ia, beyond which |x| + y >= 15
//       (w4's region 1; phco2: 15.01 / ia where 3 ia < 15.01, chi may bring
//       y below y0 beyond 3 cm^-1), and each line's largest reach over each
//       tile (with the voigt tile's small-y flag) staged with its chunk;
//   (c) beyond the reach, region 1 in the window quad's algebra (FARALL's:
//       three FMAs, one reciprocal, the sum), where w4 with its repair is
//       region 1 up to float32's rounding (voigt's constant 1/sqrt(pi) for
//       0.5641896, 2.9e-8 apart), and where y < 0.01, w4's small-y repair
//       there: y g(x) with the asymptotic g and e^{-x^2} = 0 in float32 at
//       |x| >= 15, one reciprocal of x^2 and three FMAs (voigt: a (line,
//       state) whose y0 < 0.01 carries the quad (A, 0, -1, 2 Sia y0 /
//       sqrt(pi)), uniform over a warp; phco2: chosen per pair on y = y0
//       chi). A line whose tile reach meets the row (a near line) takes w4,
//       as a call, within each pair's reach;
//   (d) phco2's chi is one ex2.approx of the rates pre-scaled to base 2,
//       and y = y0 where a line's points all lie within 3 cm^-1.
// The reciprocal is rcp.approx where the wrapper's flag (far_reciprocal_ok,
// from the pack's coefficients) shows every denominator to be normal, else
// the IEEE division; Lorentz divides, Doppler takes expf. No float atomic:
// two launches give the same bits. Measured on one H100 (PERF.md):
// K4 62.6 -> 9.3 ms, K5 231 -> 9.4 at 57 x 2^19 (the near lines' path 1.8
// ms of it), phco2 7.9 -> 1.07 at 16 x 2^15.

// voigt beyond the reach where y0 < 0.01: Sia y0 g(x), g = 2/sqrt(pi) (1/2x^2
// + 3/4x^4 + 15/8x^6 + 105/16x^8), from the quad (A, 0, -1, 2 Sia y0 / sqrt(pi))
template <bool FAST>
__device__ __forceinline__ void small_y_term(const float4& k, float D, float& acc) {
  const float x2 = D * k.x;
  const float r = FAST ? rcp_approx(x2) : 1.0f / x2;
  acc = fmaf(k.w * r, fmaf(r, fmaf(r, fmaf(r, 6.5625f, 1.875f), 0.75f), 0.5f), acc);
}

// phco2 beyond the reach, on the window quad (c, y0, A, 0), c = 0.5641896
// Sia, at y = y0 chi: region 1, or where y < 0.01 the small-y repair's c y
// 2 g(x) / (2/sqrt(pi)); one reciprocal, of the selected denominator
template <bool FAST, bool CHI1>
__device__ __forceinline__ void ph_full_term(const float4& k, float D, const ChiArg& q,
                                             float B1, float B2, float& acc) {
  const float y = CHI1 ? k.y : k.y * ex2_approx(-fmaf(B1, q.u, fmaf(B2, q.v, q.w)));
  const float y2 = y * y;
  const float w = fmaf(-D, k.z, 0.5f - y2);
  const float cy = k.x * y;
  const bool small = y < 0.01f;
  const float d = small ? D * k.z : fmaf(w, w, y2 + y2);
  const float r = FAST ? rcp_approx(d) : 1.0f / d;
  const float f = small ? (cy + cy) * fmaf(r, fmaf(r, fmaf(r, 6.5625f, 1.875f), 0.75f), 0.5f)
                        : fmaf(-cy, w, cy);
  acc = fmaf(f, r, acc);
}

// one (line, state)'s term at one point beyond its reach
template <bool PH, bool FAST, bool CHI1 = false>
__device__ __forceinline__ void full_far(const float4& k, float D, const ChiArg& q, float B1,
                                         float B2, float& acc) {
  if constexpr (PH) {
    ph_full_term<FAST, CHI1>(k, D, q, B1, B2, acc);
  } else if (k.z < 0.0f) {
    small_y_term<FAST>(k, D, acc);
  } else {
    region1_term<false, FAST, false>(k, D, 1.0f, q, B1, B2, acc);
  }
}

// What a FULL item sees beyond a window item's: its row's first and last
// points (two-float), the lines' reach and small-y flag per tile, its tile
template <int PTS>
struct FullItem : WindowItem<1, PTS> {
  float f_hi, f_lo, l_hi, l_lo;
  const float2* line_reach;
  int tile, n_tiles;
};

// window_sweep's FULL instance: each chunk's lines of group g over the
// row's one window, staged from the catalog in place
template <int MODE, int NS, int PTS, bool FAST, int WCH, class It>
__device__ __forceinline__ void full_sweep(int o, int cnt, int g, int G, const It& it,
                                           ModeStage<MODE>& sm, const Zones& z,
                                           float (&acc)[PTS][NS]) {
  constexpr bool PH = is_phco2(MODE);
  constexpr bool W4 = full_w4(MODE);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n_chunks = (cnt + WCH - 1) / WCH;
  const int per = (WCH + G - 1) / G;
  const size_t ls = (size_t)n_quads(MODE) * it.n_states;  // floats4 a line in the pack
  auto stage = [&](int k) {
    const int c0 = o + k * WCH;
    const int n = min(WCH, cnt - k * WCH);
    const int buf = k & 1;
    for (int i = tid; i < n; i += nthreads) {
      const int l = it.ws[0] + c0 + i;
      cp_async4(&sm.pos[buf][i].x, it.line_hi + l);
      cp_async4(&sm.pos[buf][i].y, it.line_lo + l);
      if constexpr (W4) cp_async8(&sm.aux[buf][i], it.line_reach + (size_t)l * it.n_tiles + it.tile);
    }
    for (int i = tid; i < n * NS; i += nthreads) {
      const int j = i / NS;
      cp_async16(&sm.c[buf][i], it.coef + (size_t)(it.ws[0] + c0 + j) * ls + it.s0 + (i - j * NS));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  float B1[NS], B2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    B1[s] = PH ? sm.B[s] : 0.0f;
    B2[s] = PH ? sm.B[ST + s] : 0.0f;
  }
  if (n_chunks > 0) stage(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      stage(k + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int buf = k & 1;
    const int c0 = o + k * WCH;
    const int j1 = min(min(WCH, cnt - k * WCH), (g + 1) * per);
    for (int j = g * per; j < j1; ++j) {
      // line j of the chunk: each point's two-float dnu and the cut's mask
      const float2 ps = sm.pos[buf][j];
      float dnu[PTS], D[PTS];
      ChiArg q[PTS];
      bool in[PTS];
      bool any = false, all = true, chi1 = true;
#pragma unroll
      for (int p = 0; p < PTS; ++p) {
        dnu[p] = (it.nh[p] - ps.x) + (it.nl[p] - ps.y);
        const float adnu = fabsf(dnu[p]);
        D[p] = dnu[p] * dnu[p];
        in[p] = adnu <= z.cut;
        if constexpr (PH) q[p] = chi_arg2_clamped(adnu);
        any = any || in[p];
        all = all && in[p];
        chi1 = chi1 && adnu < 3.0f;
      }
      if (!any) continue;
      const float4* c = sm.c[buf] + NS * j;
      if constexpr (MODE == FULL_LORENTZ || MODE == FULL_DOPPLER) {
#pragma unroll
        for (int p = 0; p < PTS; ++p) {
          if (!in[p]) continue;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            if constexpr (MODE == FULL_LORENTZ) acc[p][s] += c[s].x / (D[p] + c[s].y);
            else acc[p][s] += c[s].x * expf(-D[p] * c[s].y);
          }
        }
      } else {
        const float2 ax = sm.aux[buf][j];
        const float d0 = (it.f_hi - ps.x) + (it.f_lo - ps.y);
        const float d1 = (it.l_hi - ps.x) + (it.l_lo - ps.y);
        if (ax.x >= 0.0f && d0 <= ax.x + NEAR_EPS && d1 >= -ax.x - NEAR_EPS) {
          // a near line: w4 within each pair's reach, its far term beyond
          const float4* nq4 = it.coef + (size_t)(it.ws[0] + c0 + j) * ls + it.n_states + it.s0;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float4 nq = nq4[s];
#pragma unroll
            for (int p = 0; p < PTS; ++p) {
              if (!in[p]) continue;
              if (fabsf(dnu[p]) <= nq.w) {
                const float chi = PH ? chi2_of(chi_arg2(fabsf(dnu[p])), B1[s], B2[s]) : 1.0f;
                acc[p][s] += nq.x * wofz_re_call(dnu[p] * nq.y, nq.z * chi);
              } else {
                full_far<PH, FAST>(c[s], D[p], q[p], B1[s], B2[s], acc[p][s]);
              }
            }
          }
        } else if (all && PH && chi1) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
#pragma unroll
            for (int p = 0; p < PTS; ++p)
              full_far<PH, FAST, true>(c[s], D[p], q[p], B1[s], B2[s], acc[p][s]);
          }
        } else if (all && (PH || ax.y == 0.0f)) {
          // no state of the tile takes the small-y form here (voigt): FARALL's
          // region 1; phco2 chooses per pair
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float4 k4 = c[s];
#pragma unroll
            for (int p = 0; p < PTS; ++p) {
              if constexpr (PH) ph_full_term<FAST, false>(k4, D[p], q[p], B1[s], B2[s], acc[p][s]);
              else region1_term<false, FAST, false>(k4, D[p], 1.0f, q[p], B1[s], B2[s], acc[p][s]);
            }
          }
        } else {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
#pragma unroll
            for (int p = 0; p < PTS; ++p) {
              if (in[p]) full_far<PH, FAST>(c[s], D[p], q[p], B1[s], B2[s], acc[p][s]);
            }
          }
        }
      }
    }
    __syncthreads();  // chunk k's buffer is refilled by stage(k + 2)
  }
}

// One work item of a tile of NS states: the groups sweep the piece, their
// sums meet in group order; a row of several pieces adds its pieces'
// partials in piece order through scratch (the last to arrive writes)
template <int MODE, int NS, int PTS, class Item>
__device__ void window_item(const int4 pa, const int4 pb, int B, bool fast, const Item& it,
                            ModeStage<MODE>& sm, const float* bcoef,
                            const Zones& z, int tile, int n_tiles,
                            int rb, int col0, int n_out, int ld_out, float* scratch,
                            int* counters, float* out) {
  constexpr bool PH = is_phco2(MODE);
  constexpr int NW = n_windows(MODE);
  const int tid = threadIdx.x;
  const int TP = B / PTS;  // a group's threads: the row's points, PTS each
  const int G = blockDim.x / TP;
  const int g = tid / TP, pl = tid - g * TP;
  const int n_states = it.n_states;
  const int s0 = it.s0;
  if constexpr (PH) {
    if (tid < NS) {
      const int st = s0 + tid;
      const float* bt = bcoef + (size_t)(st / ST) * 2 * ST + st % ST;
      sm.B[tid] = bt[0] * LOG2E;
      sm.B[ST + tid] = bt[ST] * LOG2E;
    }
    __syncthreads();
  }
  float acc[PTS][NS];
#pragma unroll
  for (int p = 0; p < PTS; ++p) {
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[p][s] = 0.0f;
  }
  constexpr int WCH = window_chunk(MODE);
  if constexpr (is_full(MODE)) {
    if constexpr (full_w4(MODE)) {
      if (fast) full_sweep<MODE, NS, PTS, true, WCH>(pa.z, pa.w, g, G, it, sm, z, acc);
      else full_sweep<MODE, NS, PTS, false, WCH>(pa.z, pa.w, g, G, it, sm, z, acc);
    } else {
      full_sweep<MODE, NS, PTS, false, WCH>(pa.z, pa.w, g, G, it, sm, z, acc);
    }
  } else if constexpr (voigt_mode(MODE) == FINE) {
    if (fast) fine_sweep<NS, PTS, PH, true, WCH>(pa.z, pa.w, g, G, it, sm, z, acc);
    else fine_sweep<NS, PTS, PH, false, WCH>(pa.z, pa.w, g, G, it, sm, z, acc);
  } else {
    if (fast) window_sweep<NS, NW, PTS, PH, true, WCH>(pa.z, pa.w, g, G, it, sm, z, acc);
    else window_sweep<NS, NW, PTS, PH, false, WCH>(pa.z, pa.w, g, G, it, sm, z, acc);
  }
  if (G > 1) {
    // the last chunk's barrier has passed: the buffers hold the groups' sums
    if (g > 0) {
#pragma unroll
      for (int p = 0; p < PTS; ++p) {
#pragma unroll
        for (int s = 0; s < NS; ++s) sm.red[((g - 1) * NS + s) * B + pl + p * TP] = acc[p][s];
      }
    }
    __syncthreads();
    if (g == 0) {
      for (int k = 1; k < G; ++k) {
#pragma unroll
        for (int p = 0; p < PTS; ++p) {
#pragma unroll
          for (int s = 0; s < NS; ++s) acc[p][s] += sm.red[((k - 1) * NS + s) * B + pl + p * TP];
        }
      }
    }
  }
  const int row = pa.x, part = pb.x, nparts = pb.y, slot = pb.z;
  if (nparts > 1) {
    // partials [slot][n_states][B]; the row's arrival count per tile
    if (g == 0) {
      float* mine = scratch + ((size_t)(slot + part) * n_states + s0) * B + pl;
#pragma unroll
      for (int p = 0; p < PTS; ++p) {
#pragma unroll
        for (int s = 0; s < NS; ++s) __stcg(mine + (size_t)s * B + p * TP, acc[p][s]);
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) sm.last = atomicAdd(counters + (size_t)row * n_tiles + tile, 1) == nparts - 1;
    __syncthreads();
    if (!sm.last) return;
    __threadfence();
    if (g == 0) {
      float tot[PTS][NS];
#pragma unroll
      for (int p = 0; p < PTS; ++p) {
#pragma unroll
        for (int s = 0; s < NS; ++s) tot[p][s] = 0.0f;
      }
      for (int k = 0; k < nparts; ++k) {
        const float* src = scratch + ((size_t)(slot + k) * n_states + s0) * B + pl;
#pragma unroll
        for (int p = 0; p < PTS; ++p) {
#pragma unroll
          for (int s = 0; s < NS; ++s)
            tot[p][s] += k == part ? acc[p][s] : __ldcg(src + (size_t)s * B + p * TP);
        }
      }
#pragma unroll
      for (int p = 0; p < PTS; ++p) {
#pragma unroll
        for (int s = 0; s < NS; ++s) acc[p][s] = tot[p][s];
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int p = 0; p < PTS; ++p) {
      const int pt = rb * B + pl + p * TP;
      if (pt < n_out) {
#pragma unroll
        for (int s = 0; s < NS; ++s) out[(size_t)(s0 + s) * ld_out + col0 + pt] = acc[p][s];
      }
    }
  }
}

// window_kernel: one block per work item (a piece of a row's windows and a
// balanced tile of states), G groups of B / PTS threads, thread (g, j) at the
// row's points j + i B / PTS (i < PTS). pieces [n_pieces][8] int32: (row, 0,
// offset, count, part, n_parts, slot, 0), offset and count in the row's
// stream of lines (its windows of win [n_rows][2 NW] one after another), the
// costliest first; grid.x = n_pieces n_tiles, tile fastest. out:
// [n_states][n_shards n_out], written; scratch [n_slots][n_states][B] and
// counters [n_rows][n_tiles] (zero) serve the rows of more than one piece.
// bcoef (phco2) the rates [n_tiles of ST][2][ST]; fast the reciprocal's flag
// (FINE: one a shard, row = shard n_blocks + block, with d_near a shard and
// line_reach [n_lines][n_tiles]; the other modes: one shard, fast[0]).
template <int MODE, int PTS>
__device__ __forceinline__ void window_run(const float* nu_hi, const float* nu_lo,
                                           const float* line_hi, const float* line_lo,
                                           const float* line_amin, const float* line_reach,
                                           const float4* coef, const int* win,
                                           const int4* pieces, const int* fast_p,
                                           const float* d_near_p, const float* bcoef,
                                           const Zones& z, int B, int n_blocks, int n_states,
                                           int n_out, int ld_out, float* scratch,
                                           int* counters, float* out,
                                           ModeStage<MODE>& sm) {
  constexpr int NW = n_windows(MODE);
  constexpr bool IS_FINE = voigt_mode(MODE) == FINE;
  constexpr bool IS_FULL = is_full(MODE);
  const int n_tiles = window_tiles(n_states);
  const int item = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - item * n_tiles;
  const int4 pa = pieces[2 * item];
  const int4 pb = pieces[2 * item + 1];
  const int TP = B / PTS;
  const int pl = threadIdx.x % TP;
  std::conditional_t<IS_FINE, FineItem<PTS>,
                     std::conditional_t<IS_FULL, FullItem<PTS>, WindowItem<NW, PTS>>> it;
#pragma unroll
  for (int p = 0; p < PTS; ++p) {
    it.nh[p] = nu_hi[(size_t)pa.x * B + pl + p * TP];
    it.nl[p] = nu_lo[(size_t)pa.x * B + pl + p * TP];
  }
  int end = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    it.ws[k] = win[(size_t)pa.x * 2 * NW + 2 * k];
    end += win[(size_t)pa.x * 2 * NW + 2 * k + 1];
    it.end[k] = end;
  }
  int s0, ns;
  window_tile(tile, n_states, s0, ns);
  it.s0 = s0;
  it.n_states = n_states;
  it.line_hi = line_hi;
  it.line_lo = line_lo;
  it.line_amin = line_amin;
  it.coef = coef;
  int shard = 0, rb = pa.x;
  if constexpr (IS_FINE) {
    shard = pa.x / n_blocks;
    rb = pa.x - shard * n_blocks;
    const size_t r0 = (size_t)pa.x * B;
    it.f_hi = nu_hi[r0];
    it.f_lo = nu_lo[r0];
    it.l_hi = nu_hi[r0 + B - 1];
    it.l_lo = nu_lo[r0 + B - 1];
    it.d_near = d_near_p[shard];
    it.line_reach = line_reach;
    it.tile = tile;
    it.n_tiles = n_tiles;
  }
  if constexpr (IS_FULL) {
    const size_t r0 = (size_t)pa.x * B;
    it.f_hi = nu_hi[r0];
    it.f_lo = nu_lo[r0];
    it.l_hi = nu_hi[r0 + B - 1];
    it.l_lo = nu_lo[r0 + B - 1];
    it.line_reach = reinterpret_cast<const float2*>(line_reach);
    it.tile = tile;
    it.n_tiles = n_tiles;
  }
  const bool fast = fast_p[shard] != 0;
#define RUN(NS)                                                                            \
  window_item<MODE, NS, PTS>(pa, pb, B, fast, it, sm, bcoef, z, tile, n_tiles, rb,       \
                             shard * n_out, n_out, ld_out, scratch, counters, out)
  switch (ns) {
    case 8: RUN(8); break;
    case 7: RUN(7); break;
    case 6: RUN(6); break;
    case 5: RUN(5); break;
    case 4: RUN(4); break;
    case 3: RUN(3); break;
    case 2: RUN(2); break;
    default: RUN(1); break;
  }
#undef RUN
}

template <int MODE, int PTS>
__global__ void __launch_bounds__(512, 2)
window_kernel(const float* __restrict__ nu_hi, const float* __restrict__ nu_lo,
              const float* __restrict__ line_hi, const float* __restrict__ line_lo,
              const float* __restrict__ line_amin, const float* __restrict__ line_reach,
              const float4* __restrict__ coef, const int* __restrict__ win,
              const int4* __restrict__ pieces, const int* __restrict__ fast_p,
              const float* __restrict__ d_near_p, const float* __restrict__ bcoef, Zones z,
              int B, int n_blocks, int n_states, int n_out, int ld_out,
              float* __restrict__ scratch, int* __restrict__ counters,
              float* __restrict__ out) {
  __shared__ __align__(16) ModeStage<MODE> sm;
  window_run<MODE, PTS>(nu_hi, nu_lo, line_hi, line_lo, line_amin, line_reach, coef, win,
                        pieces, fast_p, d_near_p, bcoef, z, B, n_blocks, n_states, n_out, ld_out,
                        scratch, counters, out, sm);
}

// The stencil route's near-core correction, a gather over the K-point rows
// that lines reach. Adds Sia (w4 - region 1) [x (1 - W(dnu^2)) when
// weighted] at each point of a line's 2K window where x^2 <= 225 and
// |dnu_hi| <= cut, region 1 in the explicit (x, y) algebra of _stencil_apply;
// PH (the phco2 family): y = y0 chi(|dnu_hi + dnu_lo|, T), as _stencil_apply
// (:1269-1275) has it, the rates from bcoef [n_tiles][2][ST] as K1 reads
// them. (Within the stencil's reach, 15 alpha(1000 K) / sqrt(ln 2), ~0.1
// cm^-1 for CO2, chi is 1; the kernel applies it all the same.)
//
// The host schedule (ops/linesum_strategies.py::correction_rows) lists each
// row's lines (the halves of their windows that fall in the row) as one run
// of entries in (q, catalog index) order, with each entry's K offsets
// dnu_hi/dnu_lo [E][K], and lists only the rows some entry reaches,
// costliest first: rows [n_rows][3] (row, first entry, end). One block runs
// a work item (row, tile of G nse states): thread (j, g) owns point j of the
// row and states s0 + g + G i (i < nse), reads their sigma once (cp.async,
// in flight from the start), sums their terms in registers in the
// schedule's order, and writes sigma once where some term was added. No
// float atomic: two launches give the same bits.
//
// What bounds it on the H100 (PERF.md, the correction's step 0): the
// Humlicek w4 evaluations, 8.5% of the (point, line, state) triples, each in
// one of four regions (region 4 with an exp, a sin and a cos). Evaluated
// where they fall (the earlier kernel: a thread a (window point, line), 32
// lines of one window point a warp, a float atomic a term), a warp runs
// every region any lane needs: ~11x the work packed 32 to a warp, 0.126 of
// its 0.171 ms. So a block takes each staged chunk of its row's lines in
// three steps. (1) Each (entry, state) finds by binary search its run of
// points [lo, hi) where |dnu_hi| <= min(cut, 15.01 / ia): every point of
// x^2 <= 225 lies in it (the margin exceeds float32's rounding of x). A
// block scan lays the runs end to end as a list of candidates. (2) The
// block evaluates the list on consecutive lanes, each passing candidate's
// term Sia (w4 - region 1) [x (1 - W)]: a run's points are neighbours, so a
// warp's lanes share a few regions, and lanes idle only on the few
// candidates whose exact test fails (~2.7x the work packed 32 to a warp,
// against ~11x). (3) Each thread adds its candidates' terms in the
// schedule's order; a state group's union of runs lets it pass over an
// entry in one test. Its sigma (read once at the start) and the chunk's
// offsets and coefficients arrive by cp.async.
constexpr int CORR_THREADS = 256;  // a block: the row's K points x G state groups, whole warps
constexpr int CORR_TS = 48;        // states a tile at most (G x nse)
constexpr int CORR_RUNS = 1024;    // (entry, state) runs a chunk at most
constexpr int CORR_DNU = 1024;     // staged offsets a chunk at most (entries x K)
constexpr int CORR_CAP = 2048;     // candidates at a time: one entry's at most (8 G K <= 2048)
constexpr float CORR_X_MAX = 15.01f;
constexpr unsigned CORR_FAIL = 0xffffffffu;  // a NaN no arithmetic gives: the exact test failed

struct CorrShared {
  float sia[CORR_RUNS], ia[CORR_RUNS], y0[CORR_RUNS];  // run q = e TS + u: entry e, tile state u
  float dh[CORR_DNU], dl[CORR_DNU];                     // the entries' offsets: [e][j]
  float b1[CORR_TS], b2[CORR_TS];                       // chi's rates (PH)
  float sig[8][CORR_THREADS];                           // each thread's sigma, read once
  unsigned short lohi[CORR_RUNS];                       // run q's points: lo | hi << 7
  unsigned run[CORR_RUNS];                              // lo | hi << 7 | (first - lo + 64) << 14
  unsigned span[CORR_RUNS];                             // [e][g]: lo | hi << 16 over a group
  unsigned short cand[CORR_CAP];                        // q << 6 | j, the runs end to end
  float val[CORR_CAP];                                  // each candidate's term, or CORR_FAIL
  int scan[CORR_THREADS / 32];
};

// [lo, hi) of v[0..n) (ascending) within [-b, b]: the first v >= -b and the
// first v > b, the two binary searches interleaved
__device__ __forceinline__ void run_of(const float* v, int n, float b, int& lo, int& hi) {
  int a0 = 0, a1 = n, b0 = 0, b1 = n;
  while (a0 < a1 || b0 < b1) {
    if (a0 < a1) {
      const int m = (a0 + a1) >> 1;
      if (v[m] >= -b) a1 = m; else a0 = m + 1;
    }
    if (b0 < b1) {
      const int m = (b0 + b1) >> 1;
      if (v[m] > b) b1 = m; else b0 = m + 1;
    }
  }
  lo = a0;
  hi = max(a0, b0);
}

// exclusive block scan of one count a thread; `total` the block's sum
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
    const int y = warp_sums[k];
    before += k < w ? y : 0;
    all += y;
  }
  __syncthreads();  // warp_sums is free for the next scan
  total = all;
  return before + x - v;
}

template <bool PH, int NS>
__global__ void __launch_bounds__(CORR_THREADS, 4)
correction_gather_kernel(const int* __restrict__ rows, const int* __restrict__ line,
                         const float* __restrict__ dnu_hi, const float* __restrict__ dnu_lo,
                         const float* __restrict__ sia, const float* __restrict__ ia,
                         const float* __restrict__ y0, const float* __restrict__ bcoef, int K,
                         int G, int nse, int n_tiles, int n_lines, int n_states, int n_nu,
                         float cut, int weighted, float D1, float inv_D,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char corr_smem[];
  CorrShared& sm = *reinterpret_cast<CorrShared*>(corr_smem);
  const int TS = G * nse;
  const float inv_ts = 1.0f / (float)TS;  // q / TS = (q + 1/2) inv_ts, rounded down (q < 1024)
  const int ri = blockIdx.x / n_tiles;
  const int s0 = (blockIdx.x - ri * n_tiles) * TS;
  const int row = rows[3 * ri], e_begin = rows[3 * ri + 1], e_end = rows[3 * ri + 2];
  const int t = threadIdx.x, nt = blockDim.x;
  const int j = t % K, g = t / K;
  const int p = row * K + j;
  const int jmax = min(K, n_nu - row * K);  // the row's points inside the grid
  const bool live = g < G && j < jmax;
  const int ce = min(CORR_RUNS / TS, CORR_DNU / K);  // entries a chunk
  // a chunk's offsets and coefficients into shared memory, all in flight
  // at once (cp.async; 16-byte copies, K being whole quads)
  const auto stage = [&](int c0, int ne) {
    for (int i = 4 * t; i < ne * K; i += 4 * nt) {
      cp_async16(sm.dh + i, dnu_hi + (size_t)c0 * K + i);
      cp_async16(sm.dl + i, dnu_lo + (size_t)c0 * K + i);
    }
    for (int i = t; i < ne * TS; i += nt) {
      const int u = i / ne, e = i - u * ne, q = e * TS + u;
      if (s0 + u < n_states) {
        const size_t sl = (size_t)(s0 + u) * n_lines + line[c0 + e];
        cp_async4(&sm.sia[q], sia + sl);
        cp_async4(&sm.ia[q], ia + sl);
        cp_async4(&sm.y0[q], y0 + sl);
      } else {
        sm.sia[q] = sm.ia[q] = sm.y0[q] = 0.0f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  int c0 = e_begin, ne = min(ce, e_end - c0);
  if constexpr (PH) {
    for (int u = t; u < TS; u += nt) {
      const float* bt = bcoef + (size_t)(min(s0 + u, n_states - 1) / ST) * 2 * ST +
                        min(s0 + u, n_states - 1) % ST;
      cp_async4(&sm.b1[u], bt);
      cp_async4(&sm.b2[u], bt + ST);
    }
  }
  stage(c0, ne);
  unsigned valid = 0, hits = 0;
  float acc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int s = s0 + g + G * i;
    if (live && i < nse && s < n_states) {
      valid |= 1u << i;
      cp_async4(&sm.sig[i][t], out + (size_t)s * n_nu + p);  // sigma's one read
    }
    acc[i] = 0.0f;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 1;\n" ::);  // the first chunk (sigma may still fly)
  // candidate k's exact test, and its (x, y) and weight where it passes
  const auto pair_xy = [&](int k, float& x, float& y, float& w) {
    const int d = sm.cand[k];
    const int q = d >> 6, jj = d & 63;
    const int e = __float2int_rz(((float)q + 0.5f) * inv_ts);
    const float a = sm.ia[q];
    const float dh = sm.dh[e * K + jj], dl = sm.dl[e * K + jj];
    x = a * dh + a * dl;
    if (!(x * x <= 225.0f) || !(fabsf(dh) <= cut)) return false;
    const float dD = dh + dl;
    if (weighted) w = 1.0f - smooth_d2(dD * dD, D1, inv_D);
    y = sm.y0[q];
    if constexpr (PH) y *= chi_of(chi_arg(fabsf(dD)), sm.b1[q - e * TS], sm.b2[q - e * TS]);
    return true;
  };
  for (;;) {
    const int n_runs = ne * TS;
    __syncthreads();
    // (1) the runs: every point of x^2 <= 225 and |dnu_hi| <= cut (x = ia
    // dnu, and |x| <= 15 puts ia |dnu_hi| below 15.01)
    for (int q = t; q < n_runs; q += nt) {
      const int e = __float2int_rz(((float)q + 0.5f) * inv_ts), u = q - e * TS;
      int lo = 0, hi = 0;
      if (s0 + u < n_states) run_of(sm.dh + e * K, jmax, fminf(cut, CORR_X_MAX / sm.ia[q]), lo, hi);
      sm.lohi[q] = (unsigned short)(lo | hi << 7);
    }
    __syncthreads();
    for (int i = t; i < ne * G; i += nt) {
      const int e = i / G, gg = i - e * G;
      int lo = K, hi = 0;
      for (int k = 0; k < nse; ++k) {
        const int r = sm.lohi[e * TS + gg + G * k];
        if ((r >> 7) > (r & 127)) {
          lo = min(lo, r & 127);
          hi = max(hi, r >> 7);
        }
      }
      sm.span[i] = (unsigned)lo | (unsigned)hi << 16;
    }
    for (int ea = 0; ea < ne;) {
      // this thread's runs of entries [ea, eb) end to end; the range halves
      // until the block's fit (one entry's always do)
      int eb = ne, first, total;
      for (;;) {
        int mine = 0;
        for (int q = t; q < n_runs; q += nt) {
          const int e = __float2int_rz(((float)q + 0.5f) * inv_ts), r = sm.lohi[q];
          if (e >= ea && e < eb) mine += (r >> 7) - (r & 127);
        }
        first = block_scan(mine, sm.scan, total);
        if (total <= CORR_CAP || eb - ea == 1) break;
        eb = ea + (eb - ea) / 2;
      }
      for (int q = t; q < n_runs; q += nt) {
        const int e = __float2int_rz(((float)q + 0.5f) * inv_ts);
        const int r = sm.lohi[q], lo = r & 127, hi = r >> 7;
        if (e < ea || e >= eb) continue;
        sm.run[q] = (unsigned)r | (unsigned)(first - lo + 64) << 14;
        for (int m = lo; m < hi; ++m) sm.cand[first + m - lo] = (unsigned short)(q << 6 | m);
        first += hi - lo;
      }
      __syncthreads();
      // (2) each candidate's exact test, and its term where it passes
      for (int k = t; k < total; k += nt) {
        float x, y, w = 1.0f;
        const int q = sm.cand[k] >> 6;
        float corr = __uint_as_float(CORR_FAIL);
        if (pair_xy(k, x, y, w)) corr = sm.sia[q] * (wofz_re(x, y) - region1_xy(x, y)) * w;
        sm.val[k] = corr;
      }
      __syncthreads();
      // (3) this thread's terms in the schedule's order
      if (live) {
        for (int e = ea; e < eb; ++e) {
          const unsigned span = sm.span[e * G + g];
          if (j < (int)(span & 0xffff) || j >= (int)(span >> 16)) continue;
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const int q = e * TS + g + G * i;
            const unsigned rw = sm.run[min(q, CORR_RUNS - 1)];
            const int lo = rw & 127, hi = rw >> 7 & 127;
            const bool in = (valid >> i & 1u) && j >= lo && j < hi;
            const float v = sm.val[in ? (int)(rw >> 14) - 64 + j : 0];
            if (in && __float_as_uint(v) != CORR_FAIL) {
              acc[i] += v;
              hits |= 1u << i;
            }
          }
        }
      }
      ea = eb;
    }
    c0 += ce;
    if (c0 >= e_end) break;
    ne = min(ce, e_end - c0);
    __syncthreads();  // the chunk is no longer read
    stage(c0, ne);
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  asm volatile("cp.async.wait_all;\n" ::);
#pragma unroll
  for (int i = 0; i < NS; ++i)
    if (hits >> i & 1u) out[(size_t)(s0 + g + G * i) * n_nu + p] = sm.sig[i][t] + acc[i];
}

// the correction's shared memory is dynamic (above the 48 KB of a static
// block): opt each instance in once
template <bool PH, int NS>
cudaError_t correction_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute((const void*)correction_gather_kernel<PH, NS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(CorrShared));
  done = e == cudaSuccess;
  return e;
}

}  // namespace

extern "C" {

int linesum_states_per_tile() { return ST; }

int linesum_coef_per_state(int mode) { return 4 * n_quads(mode); }

int linesum_windows_per_block(int mode) { return n_windows(mode); }

int linesum_state_tiles(int n_states) { return n_state_tiles(n_states); }

int linesum_window_tiles(int n_states) { return window_tiles(n_states); }

int linesum_window_chunk(int mode) { return window_chunk(mode); }

// Launch `mode` on `stream`: n_pieces work items (pieces, [n_pieces][8]
// int32, see linesum_kernel) times the state tiles of n_states, blocks of
// `block` threads over rows of n_blocks blocks a shard; coef: the pack
// [n_lines][n_states][linesum_coef_per_state(mode)]; zones: host float[7]
// (Zones, in field order); d_near and fast (nonzero: the launch's far-wing
// denominators lie in [2^-120, 2^120]): one value a shard; bcoef: the phco2
// modes' rates [n_tiles of ST][2][ST] (unread by the others); out: rows of
// ld_out floats, the first n_shards n_out of each written, or added to with
// `accumulate` (the split, no-split and single-sweep modes only); scratch
// and counters (zeroed) for the blocks of several pieces.
// Returns cudaGetLastError() (0 on success).
int linesum_launch(int mode, const float* nu_hi, const float* nu_lo,
                   const float* line_hi, const float* line_lo, const float* coef,
                   const int* pieces, int n_pieces, const float* d_near, const int* fast,
                   const float* bcoef, const float* zones, int n_blocks, int block,
                   int n_states, int n_out, int ld_out, int accumulate, float* scratch,
                   int* counters, float* out, void* stream) {
  const long long items = (long long)n_pieces * n_state_tiles(n_states);
  if (items < 1 || items > 0x7fffffffLL || block < 1 || block > 512 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (accumulate && !can_accumulate(mode)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_phco2(mode) && bcoef == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Zones z{zones[0], zones[1], zones[2], zones[3], zones[4], zones[5], zones[6]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* c4 = reinterpret_cast<const float4*>(coef);
  const int4* p4 = reinterpret_cast<const int4*>(pieces);
#define LAUNCH_AS(M, A)                                                                  \
  linesum_kernel<M, A><<<(unsigned)items, block, 0, st>>>(                               \
      nu_hi, nu_lo, line_hi, line_lo, c4, p4, d_near, fast, bcoef, z, n_blocks, n_states, \
      n_out, ld_out, scratch, counters, out)
#define LAUNCH(M) LAUNCH_AS(M, false)
#define LAUNCH_ACC(M)     \
  if (accumulate)         \
    LAUNCH_AS(M, true);   \
  else                    \
    LAUNCH_AS(M, false)
  switch (mode) {
    case VOIGT_SPLIT: LAUNCH_ACC(VOIGT_SPLIT); break;
    case LORENTZ: LAUNCH_ACC(LORENTZ); break;
    case DOPPLER: LAUNCH_ACC(DOPPLER); break;
    case COARSE: LAUNCH(COARSE); break;
    case PH_SPLIT: LAUNCH_ACC(PH_SPLIT); break;
    case PH_COARSE: LAUNCH(PH_COARSE); break;
    case NOSPLIT: LAUNCH_ACC(NOSPLIT); break;
    case PH_NOSPLIT: LAUNCH_ACC(PH_NOSPLIT); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_ACC
#undef LAUNCH
#undef LAUNCH_AS
  return static_cast<int>(cudaGetLastError());
}

// Launch the window mode `mode` (FARALL, FINE_STENCIL, FINE and their phco2
// instances; K4/K5's FULL modes) on `stream`: n_pieces work items (pieces
// [n_pieces][8] int32, see window_kernel) over rows of B points, n_blocks
// rows a shard (FINE; the other modes one shard), times the balanced state
// tiles, in blocks of
// `groups` x B / pts threads, pts (1 or 2) points a thread; line_amin
// (FARALL, FINE_STENCIL): each line's least A = ia^2 over the states (the
// reach of its cores; +inf for a line of zero strength in every state);
// line_reach (FINE): each line's near reach over each state tile
// [n_lines][n_tiles] (< 0: none; FULL, PH_FULL: [n_lines][n_tiles][2], the
// reach and the voigt tile's small-y flag); coef: the window pack
// [n_lines][n_states][4] (FINE, FULL, PH_FULL: [n_lines][2][n_states][4],
// the window quads, then the w4 quads); win: the rows' window table
// [n_rows][2 n_windows(mode)] (FULL: the plan's windows); zones:
// host float[7]; fast: one int32 a shard (nonzero: every region-1
// denominator lies in [2^-120, 2^120]); d_near (FINE): one float a shard;
// bcoef: the phco2 rates [n_tiles of ST][2][ST]; out: [n_states][ld_out],
// shard s's columns [s n_out, (s + 1) n_out) written; scratch and counters
// (zeroed) for the rows of several pieces. Returns cudaGetLastError() (0
// on success).
int window_launch(int mode, const float* nu_hi, const float* nu_lo, const float* line_hi,
                  const float* line_lo, const float* line_amin, const float* line_reach,
                  const float* coef, const int* win, const int* pieces, int n_pieces,
                  const int* fast, const float* d_near, const float* bcoef,
                  const float* zones, int B, int n_blocks, int groups, int pts, int n_states,
                  int n_out, int ld_out, float* scratch, int* counters, float* out,
                  void* stream) {
  const long long blocks = (long long)n_pieces * window_tiles(n_states);
  const int threads = groups * B / max(pts, 1);
  const bool fine = voigt_mode(mode) == FINE;
  if (!is_window(mode) || blocks < 1 || blocks > 0x7fffffffLL || B < 1 || groups < 1 ||
      groups > MAX_GROUPS || (pts != 1 && pts != 2) || B % pts != 0 || threads > 512 ||
      (groups - 1) * B * ST > RED_FLOATS || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_phco2(mode) && bcoef == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (is_full(mode)) {
    if (full_w4(mode) != (line_reach != nullptr) || d_near != nullptr || ld_out != n_out)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (fine != (line_reach != nullptr && d_near != nullptr) || (!fine && ld_out != n_out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Zones z{zones[0], zones[1], zones[2], zones[3], zones[4], zones[5], zones[6]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* c4 = reinterpret_cast<const float4*>(coef);
  const int4* p4 = reinterpret_cast<const int4*>(pieces);
#define LAUNCH_AS(M, P)                                                                  \
  window_kernel<M, P><<<(unsigned)blocks, threads, 0, st>>>(                             \
      nu_hi, nu_lo, line_hi, line_lo, line_amin, line_reach, c4, win, p4, fast, d_near,  \
      bcoef, z, B, n_blocks, n_states, n_out, ld_out, scratch, counters, out)
#define LAUNCH(M)     \
  if (pts == 2)       \
    LAUNCH_AS(M, 2);  \
  else                \
    LAUNCH_AS(M, 1)
  switch (mode) {
    case FARALL: LAUNCH(FARALL); break;
    case FINE_STENCIL: LAUNCH(FINE_STENCIL); break;
    case FINE: LAUNCH(FINE); break;
    case PH_FARALL: LAUNCH(PH_FARALL); break;
    case PH_FINE_STENCIL: LAUNCH(PH_FINE_STENCIL); break;
    case PH_FINE: LAUNCH(PH_FINE); break;
    case FULL: LAUNCH(FULL); break;
    case PH_FULL: LAUNCH(PH_FULL); break;
    case FULL_LORENTZ: LAUNCH(FULL_LORENTZ); break;
    case FULL_DOPPLER: LAUNCH(FULL_DOPPLER); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH
#undef LAUNCH_AS
  return static_cast<int>(cudaGetLastError());
}

// window_kernel's build for `mode` at `pts` points a thread: info[0]
// registers a thread, info[1] static shared bytes, info[2] local (spill)
// bytes a thread, info[3] resident blocks of `threads` threads an SM.
// Returns the CUDA error.
int window_kernel_info(int mode, int pts, int threads, int* info) {
  cudaFuncAttributes a{};
  int per_sm = 0;
  cudaError_t e = cudaErrorInvalidValue;
#define INFO_AS(M, P)                                                                         \
  e = cudaFuncGetAttributes(&a, window_kernel<M, P>);                                         \
  if (e == cudaSuccess)                                                                       \
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_kernel<M, P>, threads, 0)
#define INFO(M)       \
  if (pts == 2) {     \
    INFO_AS(M, 2);    \
  } else {            \
    INFO_AS(M, 1);    \
  }
  switch (mode) {
    case FARALL: INFO(FARALL); break;
    case FINE_STENCIL: INFO(FINE_STENCIL); break;
    case FINE: INFO(FINE); break;
    case PH_FARALL: INFO(PH_FARALL); break;
    case PH_FINE_STENCIL: INFO(PH_FINE_STENCIL); break;
    case PH_FINE: INFO(PH_FINE); break;
    case FULL: INFO(FULL); break;
    case PH_FULL: INFO(PH_FULL); break;
    case FULL_LORENTZ: INFO(FULL_LORENTZ); break;
    case FULL_DOPPLER: INFO(FULL_DOPPLER); break;
    default: break;
  }
#undef INFO
#undef INFO_AS
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)a.localSizeBytes;
  info[3] = per_sm;
  return static_cast<int>(e);
}

// K1's build for `mode` (cudaFuncGetAttributes, of its writing instance): info[0] registers a
// thread, info[1] static shared bytes, info[2] local (spill) bytes a
// thread, info[3] resident blocks of `block` threads an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns the CUDA error.
int linesum_kernel_info(int mode, int block, int* info) {
  cudaFuncAttributes a{};
  int per_sm = 0;
  cudaError_t e = cudaErrorInvalidValue;
#define INFO(M)                                                                     \
  e = cudaFuncGetAttributes(&a, linesum_kernel<M, false>);                          \
  if (e == cudaSuccess)                                                             \
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, linesum_kernel<M, false>, \
                                                      block, 0)
  switch (mode) {
    case VOIGT_SPLIT: INFO(VOIGT_SPLIT); break;
    case LORENTZ: INFO(LORENTZ); break;
    case DOPPLER: INFO(DOPPLER); break;
    case COARSE: INFO(COARSE); break;
    case PH_SPLIT: INFO(PH_SPLIT); break;
    case PH_COARSE: INFO(PH_COARSE); break;
    case NOSPLIT: INFO(NOSPLIT); break;
    case PH_NOSPLIT: INFO(PH_NOSPLIT); break;
    default: break;
  }
#undef INFO
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)a.localSizeBytes;
  info[3] = per_sm;
  return static_cast<int>(e);
}

// Launch the near-core correction on `stream` (adds into out): one block a
// work item (rows[n_rows][3] x n_tiles state tiles of G nse states; K a
// multiple of 4 up to 64, whole quads for the 16-byte copies), K G
// threads rounded up to whole warps; with bcoef (the phco2 family's rates
// [n_tiles of ST][2][ST]) the chi instance. Returns cudaGetLastError().
int stencil_correction_launch(const int* rows, const int* line, const float* dnu_hi,
                              const float* dnu_lo, const float* sia, const float* ia,
                              const float* y0, const float* bcoef, int n_rows, int K, int G,
                              int nse, int n_tiles, int n_lines, int n_states, int n_nu,
                              float cut, int weighted, float D1, float inv_D, float* out,
                              void* stream) {
  if (n_rows == 0 || n_states == 0) return 0;
  if (K < 4 || K > 64 || K % 4 != 0 || G < 1 || K * G > CORR_THREADS || nse < 1 || nse > 8 ||
      G * nse > CORR_TS || (long long)n_rows * n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int block = (K * G + 31) / 32 * 32;
  const unsigned blocks = (unsigned)(n_rows * n_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
#define LAUNCH(PH, NS)                                                                        \
  e = correction_smem<PH, NS>();                                                              \
  if (e == cudaSuccess)                                                                       \
    correction_gather_kernel<PH, NS><<<blocks, block, sizeof(CorrShared), st>>>(             \
        rows, line, dnu_hi, dnu_lo, sia, ia, y0, bcoef, K, G, nse, n_tiles, n_lines, n_states, \
        n_nu, cut, weighted, D1, inv_D, out)
#define LAUNCH_NS(PH) \
  if (nse <= 1) { LAUNCH(PH, 1); } else if (nse <= 2) { LAUNCH(PH, 2); } \
  else if (nse <= 4) { LAUNCH(PH, 4); } else { LAUNCH(PH, 8); }
  if (bcoef != nullptr) {
    LAUNCH_NS(true)
  } else {
    LAUNCH_NS(false)
  }
#undef LAUNCH_NS
#undef LAUNCH
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The correction's build for nse states a thread (chi instance if ph):
// registers, shared bytes (dynamic) and local (spill) bytes a thread, and
// resident blocks of `block` threads an SM.
int stencil_correction_info(int ph, int nse, int block, int* info) {
  cudaFuncAttributes a{};
  const void* k = nullptr;
  cudaError_t e = cudaSuccess;
#define PICK(PH, NS) \
  { k = (const void*)correction_gather_kernel<PH, NS>; e = correction_smem<PH, NS>(); }
#define PICK_NS(PH) \
  if (nse <= 1) PICK(PH, 1) else if (nse <= 2) PICK(PH, 2) else if (nse <= 4) PICK(PH, 4) \
  else PICK(PH, 8)
  if (ph) {
    PICK_NS(true)
  } else {
    PICK_NS(false)
  }
#undef PICK_NS
#undef PICK
  int per_sm = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, block, sizeof(CorrShared));
  info[0] = a.numRegs;
  info[1] = (int)sizeof(CorrShared);
  info[2] = (int)a.localSizeBytes;
  info[3] = per_sm;
  return static_cast<int>(e);
}

}  // extern "C"
