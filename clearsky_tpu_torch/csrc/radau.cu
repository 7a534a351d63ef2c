// The adaptive Radau IIA(5) flux core: one thread a lane.
//
// Counterpart of clearsky_tpu/utils/radau.py::radau_scalar (:104, its
// lax.while_loop :301) and ::radau_dense (:305) on the right-hand sides of
// clearsky_tpu/rt/radau.py (_rhs_emission :111, _rhs_depth :126); no
// pallas_call: the JAX package runs this engine as XLA. It runs every lane
// (stream x wavenumber) in lockstep inside one lax.while_loop, masked
// arithmetic over all lanes, so each pays for the stiffest lane's
// iterations. The lanes are independent scalar ODEs: here a thread
// integrates one lane with its own step size, error controller and
// simplified Newton in the eigenbasis, a thread that finishes exits, and a
// warp runs as long as its slowest lane. Lanes are ordered as the JAX
// package orders them (lane = (column x streams + stream) x n_nu + j), so a
// warp holds 32 neighbouring wavenumbers of one stream.
//
// Two right-hand sides (template RHS), both at the slant m of the lane's
// stream on the column cache (ln sigma [npc, n_nu] of a column, or one for
// every column; T and mu [npc]; all linear in ln P, bracketed as
// searchsorted(side="right") - 1 clipped to [0, npc - 2]):
// - EMISSION: dI/dx = rate (B - I), Jacobian -rate;
// - DEPTH:    dtau/dx = rate, Jacobian 0;
// rate = m const (exp(ln sigma) / mu) 2 sqrt(P), x = -+sqrt(P).
// The rate and Planck function at the three stage abscissae are formed once
// an attempt (Newton changes y, not x); the last stage abscissa is x + h,
// so an accepted step's f(x_next, y_new) and the next attempt's Jacobian
// reuse it. The stiffness-damped re-estimate is formed only where it is
// read (a retry of a rejected step whose error exceeds 1); JAX forms it
// everywhere and discards it. Neither changes a result.
//
// What bounds it on the H100: the instructions a lane issues an attempt.
// The first design (a binary search at every evaluation) completed a
// lane-attempt every ~63 ps on outgoing's launch (5 x 2^19 lanes, ~190
// attempts a lane), ~15 SM-cycles of the card, with at most 7-14% lost to
// divergence; it issued ~1,750 instructions an attempt (1,351 in its
// attempt loop's SASS, the Newton loop's 200 twice, 8 turns of a search at
// each of 3 brackets): 38 IEEE divisions (each a reciprocal, its
// refinement and a slow-path test), two powf, a float64 division, 6 loads
// of ln sigma and 8 float64 to float32 conversions. This design:
// - the lane keeps its row: ln P at rows i and i + 1, 1 / (ln P[i+1] -
//   ln P[i]) and ln sigma at both rows stay in registers while an abscissa
//   falls in [ln P[i], ln P[i+1]) (mu's and T's record of the row is one
//   shared-memory read an evaluation), and a hunt from the row finds
//   another (doubling steps, then bisection: searchsorted's row exactly,
//   ties, both ends and NaN included); a move by one row reads one row of
//   ln sigma;
// - a block stages its columns' rows in shared memory as 16-byte records
//   (ln P, its neighbour and their reciprocal difference; mu, T and their
//   differences), else its lanes read them from device memory;
// - one reciprocal a quantity an attempt (the step, the real and the
//   complex eigen-divisor, the two error scales: the SFU's reciprocal and
//   one Newton step) in place of its divisions, and the SFU's reciprocal
//   for the rate's 1/mu (within an ulp: under exp(ln sigma)'s float32
//   noise); the Planck function's two divisions stay IEEE: B enters as
//   rate (B - I) where I is near B, and an approximate B moves step
//   decisions (1% fewer attempts, most lanes' steps other);
// - the controller's powf pair as err^(-1/4) = rsqrt(sqrt(err)), with
//   err_old^(1/4) / h_old carried from the accepted step; the Newton norms
//   from the SFU's square root;
// - the Planck function in one exponential: e^-x / (1 - e^-x) from expf
//   (1 - e^-x is exact to 2^-24 relative where x >= 1/2; below, where it
//   cancels, -expm1f(-x) as the plain engine; 1 / expm1f(x) would give 0
//   for x in (88.7, 103) where e^-x is still a subnormal);
// - the Newton step with W = 0 written out (its T W and the residual's
//   eigenvalue terms are zeros), two iterations (the flux core's
//   newton_iters; nit still feeds the safety factor);
// - positions, steps and the step floor stay float64: the stage abscissae
//   are formed in float32 from the position's two-float split (x_hi +
//   (x_lo + c h)), one conversion an attempt and two an accepted step in
//   place of eight an attempt;
// - a move by one row in the direction of travel takes the next row's
//   ln sigma, read ahead at the previous move (its load's latency hidden
//   behind the evaluations between), and the next row's bounds, one
//   shared-memory record; any other move hunts;
// - __launch_bounds__ with the blocks an SM that fit each instance's
//   registers with no spill (emission 72, 28 warps; depth 64, 32 warps).

// Dense output walks the nodes xs[0..nx-1]: each segment restarts as JAX's
// lax.scan of radau_scalar does (a fresh initial step, no controller
// history, max_steps attempts), and a lane that does not reach a segment's
// end is NaN from then on. max_steps counts attempts per lane: in JAX a
// lane's attempts equal the loop's global iteration count while the lane is
// active (done is absorbing), so capping each lane at max_steps attempts
// gives JAX's ok lane for lane. The lane's row carries across segments.
//
// Arithmetic: float32 (no fast math: the accurate expf, logf and expm1f;
// the approximate forms only where named above); the method's constants
// (error weights, eigenvalues, the transformation matrices) and the Planck
// constants arrive rounded to float32 by the wrapper, as the plain engine
// rounds them. JAX's guards max(v, 1e-300) are max(v, 0) in float32. A
// lane's position x, its step sizes and the step floor 16 eps max(|x|, 1)
// are doubles (the plain engine's float64 positions), the right-hand side
// sees x rounded to float32: in float32 a lane at the surface (|x| ~ 300)
// whose boundary layer needs steps under 6e-4 would reject at that floor
// until max_steps, as the JAX package's float32 engine does. The
// reciprocals, square-root forms and the two-float abscissae round
// otherwise than the plain float32 engine and move some lanes' step
// decisions; the hunt alone changes no bit (tools/radau_probe.py --nofma
// --cuts hunt on the first design's source).

#include <cuda_runtime.h>
#include <math.h>
#include <float.h>

namespace {

constexpr int MAX_STREAMS = 8;
constexpr int RHS_EMISSION = 0;
constexpr int RHS_DEPTH = 1;
constexpr int BLOCK = 128;
// blocks an SM: emission 7 (28 warps, at most 72 registers), depth 8 (32
// warps, 64 registers), each instance's registers with no spill
constexpr int MIN_BLOCKS_EMISSION = 7;
constexpr int MIN_BLOCKS_DEPTH = 8;
constexpr int NEWTON_ITERS = 2;   // the flux core's (its right-hand sides are linear in y)
constexpr long long SHARED_BUDGET = 48 * 1024;

struct Params {
  // the method (rounded to float32 by the wrapper)
  float C[3];           // the collocation nodes: the stage abscissae's offsets
  float E[3], T[9], TI[9];
  float mu_r, mu_cr, mu_ci, inv_mu_r;
  float rtol, newton_tol;
  float safety[2];      // 0.9 (2 ni + 1) / (2 ni + nit) at nit = 1, 2
  float fac_floor;      // (1e-12)^(-1/4): the factor of an error under 1e-12
  float konst;          // 1e-4 N_A / g
  float pl, c2;         // 2 h c^2 and the second radiation constant
  float m[MAX_STREAMS];
  int max_steps;
  // lanes: C columns x ns streams x n_nu points
  long long L;
  int n_cols, ns, n_nu, npc, nx;
  long long sig_stride;  // floats between columns of ln sigma (0: shared)
  int cols_per_block;
  const float* lnP;     // [npc]
  const float* Tg;      // [C, npc]
  const float* mug;     // [C, npc]
  const float* lnsig;   // [C or 1, npc, n_nu]
  const float* nu;      // [n_nu]
  const float* atol;    // [C]
  const float* y0;      // [L]
  const float* xs;      // [nx]
  float* y;             // [nx, L] (dense) or [L]
  int* steps;           // [L] accepted steps, summed over segments
  int* attempts;        // [L] attempts, summed over segments
  unsigned long long* work;  // [2] the launch's steps and attempts added (null: not counted)
  int dense;
};

// A warp's sum of a non-negative int over the lanes of ``mask`` (the warp's
// first lanes, all that did not leave), exact in 64 bits: its low 16 and
// high 15 bits are summed apart (32 lanes x 2^16 fits 32 bits).
__device__ __forceinline__ unsigned long long warp_sum(unsigned mask, int v) {
  const unsigned u = static_cast<unsigned>(v);
  const unsigned lo = __reduce_add_sync(mask, u & 0xffffu);
  const unsigned hi = __reduce_add_sync(mask, u >> 16);
  return (static_cast<unsigned long long>(hi) << 16) + lo;
}

// The lane's row: the cache's values at rows i and i + 1 that an abscissa
// in [p0, p1) interpolates between (ln sigma's, read from device memory,
// in registers; mu's and T's read from the row's record at each
// evaluation).
struct Row {
  int i;
  float p0, p1, rd;  // ln P at rows i, i + 1; 1 / (p1 - p0)
  float l0, l1;      // ln sigma at rows i, i + 1
  float l_next;      // ln sigma at the next row the lane travels to (i + 2 or i - 1)
};

// Where a lane reads its column. STAGED: the block's shared memory holds
// ln P, a record a row (ln P[k], ln P[k+1], 1 / (ln P[k+1] - ln P[k])) and
// a record a row of each of its columns (mu[k], mu[k+1] - mu[k], T[k],
// T[k+1] - T[k]); else (columns too many for 48 KB) each is read from
// device memory and the same differences formed at the read.
template <bool STAGED>
struct Lane {
  const float* lnP;      // [npc]
  const float4* lrec;    // [npc - 1] (STAGED)
  const float4* crec;    // [npc - 1] (STAGED)
  const float* Tc;       // [npc] (not STAGED)
  const float* muc;      // [npc] (not STAGED)
  const float* sb;       // ln sigma at (column, row 0, j)
  int n_nu, npc;
  float mconst2, pl100, c2nu;  // 2 m const, 100 pl nu^3 (SI), c2 nu
};

// max and min that propagate NaN, as jnp.maximum/minimum and torch's do
// (fmaxf/fminf return the other operand)
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
__device__ __forceinline__ double jmin(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmin(a, b);
}

// the SFU's reciprocal (within 1 ulp; x normal: a subnormal x flushes to
// 0, 1 / x beyond 2^126 to 0)
__device__ __forceinline__ float rcp_sfu(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 1 / x from the SFU's reciprocal and one Newton step (within an ulp of the
// IEEE reciprocal): x the step, an eigen-divisor or an error scale, each
// normal and finite
__device__ __forceinline__ float rcp(float x) {
  const float r = rcp_sfu(x);
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// the SFU's square root (a few ulp; sqrt(0) = 0, a subnormal square 0): the
// Newton norms, whose rounding moves no step of the flux core (the second
// iteration's norm is rounding: rate ~ 1e-7 against 1)
__device__ __forceinline__ float sqrt_sfu(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <bool STAGED>
__device__ __forceinline__ float lnp_at(const Lane<STAGED>& ln, int k) {
  return STAGED ? ln.lnP[k] : __ldg(ln.lnP + k);
}

// searchsorted(lnP, v, side="right") - 1 clipped to [0, npc - 2] (NaN: 0),
// hunted from row i: doubling steps away from it, then bisection
template <bool STAGED>
__device__ __forceinline__ int hunt(const Lane<STAGED>& ln, float v, int i) {
  const int top = ln.npc - 2;
  if (i < top && lnp_at(ln, i + 1) <= v) {
    int lo = i + 1, hi = i + 2, step = 1;
    while (hi <= top && lnp_at(ln, hi) <= v) { lo = hi; step <<= 1; hi = lo + step; }
    if (hi > top + 1) hi = top + 1;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (lnp_at(ln, mid) <= v) lo = mid; else hi = mid;
    }
    return lo;
  }
  if (i > 0 && !(lnp_at(ln, i) <= v)) {
    int hi = i, lo = i - 1, step = 1;
    while (lo > 0 && !(lnp_at(ln, lo) <= v)) { hi = lo; step <<= 1; lo = hi - step; if (lo < 0) lo = 0; }
    if (!(lnp_at(ln, lo) <= v)) return 0;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (lnp_at(ln, mid) <= v) lo = mid; else hi = mid;
    }
    return lo;
  }
  return i;
}

// row i's (ln P[i], ln P[i+1], 1 / (ln P[i+1] - ln P[i]))
template <bool STAGED>
__device__ __forceinline__ float4 row_bounds(const Lane<STAGED>& ln, int i) {
  if (STAGED) return ln.lrec[i];
  const float p0 = __ldg(ln.lnP + i), p1 = __ldg(ln.lnP + i + 1);
  return make_float4(p0, p1, 1.0f / (p1 - p0), 0.0f);
}

// read ahead the ln sigma of the row after the lane's in its direction of
// travel (up: ln P rising), used at its next move
template <bool STAGED>
__device__ __forceinline__ void read_ahead(const Lane<STAGED>& ln, Row& r, bool up) {
  const int k = up ? r.i + 2 : r.i - 1;
  r.l_next = (k >= 0 && k < ln.npc) ? __ldg(ln.sb + static_cast<long long>(k) * ln.n_nu) : 0.0f;
}

// move the lane's row to row i (a move by one reads one row of ln sigma)
template <bool STAGED>
__device__ __forceinline__ void load_row(const Lane<STAGED>& ln, Row& r, int i, bool up) {
  const long long st = ln.n_nu;
  if (i == r.i + 1) {
    r.l0 = r.l1;
    r.l1 = __ldg(ln.sb + (i + 1) * st);
  } else if (i == r.i - 1) {
    r.l1 = r.l0;
    r.l0 = __ldg(ln.sb + i * st);
  } else {
    r.l0 = __ldg(ln.sb + i * st);
    r.l1 = __ldg(ln.sb + (i + 1) * st);
  }
  r.i = i;
  const float4 a = row_bounds(ln, i);
  r.p0 = a.x;
  r.p1 = a.y;
  r.rd = a.z;
  read_ahead(ln, r, up);
}

// the row of v (not the lane's): a move by one in the direction of travel
// takes the ln sigma read ahead, any other the hunt
template <bool STAGED>
__device__ __forceinline__ void move_row(const Lane<STAGED>& ln, Row& r, float v, bool up) {
  const int top = ln.npc - 2;
  if (up ? (r.i < top && r.p1 <= v) : (r.i > 0 && v < r.p0)) {
    const int i = up ? r.i + 1 : r.i - 1;
    const float4 a = row_bounds(ln, i);
    if (up ? (v < a.y || i == top) : (a.x <= v || i == 0)) {
      if (up) {
        r.l0 = r.l1;
        r.l1 = r.l_next;
      } else {
        r.l1 = r.l0;
        r.l0 = r.l_next;
      }
      r.i = i;
      r.p0 = a.x;
      r.p1 = a.y;
      r.rd = a.z;
      read_ahead(ln, r, up);
      return;
    }
  }
  const int i = hunt(ln, v, r.i);
  if (i != r.i) load_row(ln, r, i, up);
}

// mu's and (EMISSION) T's record of row i: (mu[i], mu[i+1] - mu[i], T[i],
// T[i+1] - T[i])
template <int RHS, bool STAGED>
__device__ __forceinline__ float4 row_record(const Lane<STAGED>& ln, int i) {
  if (STAGED) {
    if (RHS == RHS_EMISSION) return ln.crec[i];
    const float2 m = reinterpret_cast<const float2*>(ln.crec + i)[0];
    return make_float4(m.x, m.y, 0.0f, 0.0f);
  }
  const float m0 = __ldg(ln.muc + i);
  float4 c = make_float4(m0, __ldg(ln.muc + i + 1) - m0, 0.0f, 0.0f);
  if (RHS == RHS_EMISSION) {
    c.z = __ldg(ln.Tc + i);
    c.w = __ldg(ln.Tc + i + 1) - c.z;
  }
  return c;
}

// rate and (EMISSION) Planck B at abscissa x
template <int RHS, bool STAGED>
__device__ __forceinline__ void eval_at(const Lane<STAGED>& ln, Row& r, bool up, float x,
                                        float& rate, float& B) {
  const float sp = fabsf(x);
  const float lnp = 2.0f * logf(sp);
  if (!(r.p0 <= lnp && lnp < r.p1)) move_row(ln, r, lnp, up);
  const float4 c = row_record<RHS>(ln, r.i);
  const float t = (lnp - r.p0) * r.rd;
  const float mu = c.x + t * c.y;
  const float lns = r.l0 + t * (r.l1 - r.l0);
  rate = (ln.mconst2 * (expf(lns) * rcp_sfu(mu))) * sp;
  if (RHS == RHS_EMISSION) {
    // ops/planck.py's 100 p e^-x / (1 - e^-x), from one exponential where
    // 1 - e^-x is well conditioned; the divisions IEEE (B's rounding feeds
    // rate (B - I) where I is near B)
    const float T = c.z + t * c.w;
    const float xx = ln.c2nu / T;
    const float em = expf(-xx);
    float dn = 1.0f - em;
    if (xx < 0.5f) dn = -expm1f(-xx);
    B = ln.pl100 * em / dn;
  } else {
    B = 0.0f;
  }
}

template <int RHS>
__device__ __forceinline__ float rhs(float rate, float B, float y) {
  return RHS == RHS_EMISSION ? rate * (B - y) : rate;
}

// One segment [xa, xb] of one lane; returns true when the lane reached xb
// within max_steps attempts. y is updated in place, the row carried.
template <int RHS, bool STAGED>
__device__ bool segment(const Params& p, const Lane<STAGED>& ln, Row& row, float atol, double xa,
                        double xb, float& y, int& steps, int& attempts) {
  const float rtol = p.rtol;
  double x = xa;
  const double x1 = xb;
  const double span = fabs(x1 - x);
  const bool back = (x1 - x) < 0.0;  // the direction
  const bool up = back ? x < 0.0 : x > 0.0;  // ln P rising along the segment
  read_ahead(ln, row, up);
  // the position's two-float split: x = x_hi + x_lo to float32's precision twice
  float x_hi = static_cast<float>(x);
  float x_lo = static_cast<float>(x - static_cast<double>(x_hi));
  float rate_x, B_x;
  eval_at<RHS>(ln, row, up, x_hi, rate_x, B_x);
  float f0 = rhs<RHS>(rate_x, B_x, y);
  if (isnan(f0)) y = nanf("");
  if (span <= 0.0 || isnan(y)) return true;

  // the initial step (curvature heuristic, exponent 1/4)
  double h;
  {
    const float scale = atol + fabsf(y) * rtol;
    const double spn = span > 1e-30 ? span : 1e-30;
    const float d0 = fabsf(y) / scale;
    const float d1 = fabsf(f0) / scale;
    const float h0f = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : 0.01f * d0 / jmax(d1, 0.0f);
    const double h0d = jmin(static_cast<double>(h0f), spn);
    const double dh = back ? -h0d : h0d;
    float r1, B1;
    eval_at<RHS>(ln, row, up, static_cast<float>(x + dh), r1, B1);
    const float f1 = rhs<RHS>(r1, B1, y + static_cast<float>(dh) * f0);
    const float h0 = static_cast<float>(h0d);
    const float d2 = fabsf(f1 - f0) / scale / jmax(h0, 0.0f);
    const float dm = jmax(d1, d2);
    const float h1 = dm <= 1e-15f ? jmax(h0 * 1e-3f, 1e-6f)
                                  : sqrtf(sqrtf(0.01f / jmax(dm, 0.0f)));
    h = jmin(static_cast<double>(jmin(100.0f * h0, h1)), spn);
  }
  double floor_x = 16.0 * DBL_EPSILON * fmax(fabs(x), 1.0);
  float c_old = 0.0f;  // err_old^(1/4) / h_old of the last accepted step; 0: none
  bool rej = false;

  for (int a = 0; a < p.max_steps; ++a) {
    // h_abs = max(min(h, |x1 - x|), floor): a NaN h stays NaN, as jnp's
    const double rem = fabs(x1 - x);
    double h_abs = rem < h ? rem : h;
    h_abs = h_abs < floor_x ? floor_x : h_abs;
    const double hs_x = back ? -h_abs : h_abs;  // the signed step, in positions
    const float hs = static_cast<float>(hs_x);    // the step in y's arithmetic
    const float inv_hs = rcp(hs);
    const float J = RHS == RHS_EMISSION ? -rate_x : 0.0f;
    const float mr = p.mu_r * inv_hs, mcr = p.mu_cr * inv_hs, mci = p.mu_ci * inv_hs;
    const float inv_den = RHS == RHS_EMISSION ? rcp(mr - J) : hs * p.inv_mu_r;
    const float dcr = mcr - J;
    const float inv_c = rcp(dcr * dcr + mci * mci);
    const float inv_scale = rcp(atol + fabsf(y) * rtol);

    float rs0, rs1, rs2, Bs0, Bs1, Bs2;
    eval_at<RHS>(ln, row, up, x_hi + (x_lo + p.C[0] * hs), rs0, Bs0);
    eval_at<RHS>(ln, row, up, x_hi + (x_lo + p.C[1] * hs), rs1, Bs1);
    const float x_st = x_hi + (x_lo + hs);
    eval_at<RHS>(ln, row, up, x_st, rs2, Bs2);

    // simplified Newton on the stage increments, in the eigenbasis; the
    // first iteration from W = 0
    float F0 = rhs<RHS>(rs0, Bs0, y), F1 = rhs<RHS>(rs1, Bs1, y), F2 = rhs<RHS>(rs2, Bs2, y);
    float g_r = p.TI[0] * F0 + p.TI[1] * F1 + p.TI[2] * F2;
    float g_cr = p.TI[3] * F0 + p.TI[4] * F1 + p.TI[5] * F2;
    float g_ci = p.TI[6] * F0 + p.TI[7] * F1 + p.TI[8] * F2;
    float W0 = g_r * inv_den;
    float W1 = (g_cr * dcr - g_ci * mci) * inv_c;
    float W2 = (g_ci * dcr + g_cr * mci) * inv_c;
    float a0 = W0 * inv_scale, a1 = W1 * inv_scale, a2 = W2 * inv_scale;
    const float dwn0 = sqrt_sfu((a0 * a0 + a1 * a1 + a2 * a2) * (1.0f / 3.0f));
    float dwn = dwn0, rate = -1.0f;
    int nit = 1;
    if (dwn0 != 0.0f) {
      const float Z0 = p.T[0] * W0 + p.T[1] * W1 + p.T[2] * W2;
      const float Z1 = p.T[3] * W0 + p.T[4] * W1 + p.T[5] * W2;
      const float Z2 = p.T[6] * W0 + p.T[7] * W1 + p.T[8] * W2;
      F0 = rhs<RHS>(rs0, Bs0, y + Z0);
      F1 = rhs<RHS>(rs1, Bs1, y + Z1);
      F2 = rhs<RHS>(rs2, Bs2, y + Z2);
      g_r = (p.TI[0] * F0 + p.TI[1] * F1 + p.TI[2] * F2) - mr * W0;
      g_cr = (p.TI[3] * F0 + p.TI[4] * F1 + p.TI[5] * F2) - (mcr * W1 + mci * W2);
      g_ci = (p.TI[6] * F0 + p.TI[7] * F1 + p.TI[8] * F2) - (mcr * W2 - mci * W1);
      const float dW0 = g_r * inv_den;
      const float dW1 = (g_cr * dcr - g_ci * mci) * inv_c;
      const float dW2 = (g_ci * dcr + g_cr * mci) * inv_c;
      a0 = dW0 * inv_scale;
      a1 = dW1 * inv_scale;
      a2 = dW2 * inv_scale;
      dwn = sqrt_sfu((a0 * a0 + a1 * a1 + a2 * a2) * (1.0f / 3.0f));
      rate = dwn0 > 0.0f ? dwn * rcp(dwn0) : -1.0f;
      W0 += dW0;
      W1 += dW1;
      W2 += dW2;
      nit = 2;
    }
    // rate / max(1 - rate, 1e-6) dwn < tol, multiplied out
    const bool conv = dwn == 0.0f || (rate >= 0.0f && rate < 1.0f &&
                                      rate * dwn < p.newton_tol * fmaxf(1.0f - rate, 1e-6f));

    const float Z2 = p.T[6] * W0 + p.T[7] * W1 + p.T[8] * W2;
    const float y_new = y + Z2;
    const float ZE = ((p.T[0] * W0 + p.T[1] * W1 + p.T[2] * W2) * p.E[0] +
                      (p.T[3] * W0 + p.T[4] * W1 + p.T[5] * W2) * p.E[1] + Z2 * p.E[2]) * inv_hs;
    const float ay = fabsf(y), ayn = fabsf(y_new);
    const float inv_se = rcp(atol + (ayn < ay ? ay : ayn) * rtol);  // y_new's NaN stays
    const float e_raw = (f0 + ZE) * inv_den;
    float err = fabsf(e_raw) * inv_se;
    if (rej && err > 1.0f) {
      // the stiffness-damped re-estimate (a retry of a rejected step)
      const float f_damp = rhs<RHS>(rate_x, B_x, y + e_raw);
      err = fabsf((f_damp + ZE) * inv_den) * inv_se;
    }

    // the predictive controller: err^(-1/4), and (err_old / err)^(1/4)
    // h_abs / h_old from the accepted step's err_old^(1/4) / h_old
    const float u = rsqrtf(sqrtf(err));
    const float safety = nit == 1 ? p.safety[0] : p.safety[1];
    const float mult = (c_old > 0.0f && err > 0.0f) ? (fabsf(hs) * c_old) * u : 1.0f;
    const float fac = err < 1e-12f ? p.fac_floor : u;   // max(err, 1e-12)^(-1/4)
    const float factor = (1.0f < mult ? 1.0f : mult) * fac;
    const float sf = safety * factor;
    const bool accept = conv && err <= 1.0f;

    const double x_next = x + hs_x;
    if (accept) {
      const float sf_lo = sf < 0.2f ? 0.2f : sf;
      h = h_abs * static_cast<double>(10.0f < sf_lo ? 10.0f : sf_lo);
      c_old = rcp(u * fabsf(hs));
      x = x_next;
      x_hi = x_st;
      x_lo = static_cast<float>(x - static_cast<double>(x_st));
      floor_x = 16.0 * DBL_EPSILON * fmax(fabs(x), 1.0);
      y = y_new;
      rate_x = rs2;
      B_x = Bs2;
      f0 = rhs<RHS>(rate_x, B_x, y_new);
      ++steps;
      rej = false;
      if (fabs(x1 - x_next) <= 16.0 * DBL_EPSILON * fmax(fabs(x1), 1.0)) {
        attempts += a + 1;
        return true;
      }
    } else {
      h = conv ? h_abs * static_cast<double>(sf < 0.2f ? 0.2f : sf) : 0.5 * h_abs;
      rej = true;
    }
  }
  attempts += p.max_steps;
  return false;
}

template <int RHS, bool STAGED>
__global__ void __launch_bounds__(BLOCK, RHS == RHS_EMISSION ? MIN_BLOCKS_EMISSION
                                                             : MIN_BLOCKS_DEPTH)
radau_kernel(const Params p) {
  extern __shared__ float4 sh4[];
  const int npc = p.npc;
  float4* s_lrec = sh4;                            // [npc - 1] (STAGED)
  float4* s_crec = sh4 + (STAGED ? npc - 1 : 0);   // [cols_per_block, npc - 1] (STAGED)
  float* s_xs = reinterpret_cast<float*>(sh4 + (STAGED ? (npc - 1) * (1 + p.cols_per_block) : 0));
  float* s_lnP = s_xs + p.nx;                      // [npc] (STAGED)
  const long long lanes_col = static_cast<long long>(p.ns) * p.n_nu;
  const long long first = static_cast<long long>(blockIdx.x) * BLOCK;
  const int c_lo = static_cast<int>(first / lanes_col);
  for (int k = threadIdx.x; k < p.nx; k += BLOCK) s_xs[k] = p.xs[k];
  if (STAGED) {
    for (int k = threadIdx.x; k < npc; k += BLOCK) {
      s_lnP[k] = p.lnP[k];
      if (k + 1 < npc)
        s_lrec[k] = make_float4(p.lnP[k], p.lnP[k + 1], 1.0f / (p.lnP[k + 1] - p.lnP[k]), 0.0f);
    }
    for (int c = 0; c < p.cols_per_block && c_lo + c < p.n_cols; ++c) {
      const float* Tc = p.Tg + static_cast<long long>(c_lo + c) * npc;
      const float* mc = p.mug + static_cast<long long>(c_lo + c) * npc;
      for (int k = threadIdx.x; k + 1 < npc; k += BLOCK)
        s_crec[c * (npc - 1) + k] = make_float4(mc[k], mc[k + 1] - mc[k], Tc[k], Tc[k + 1] - Tc[k]);
    }
  }
  __syncthreads();
  const long long lane = first + threadIdx.x;
  if (lane >= p.L) return;
  const int c = static_cast<int>(lane / lanes_col);
  const int s = static_cast<int>((lane / p.n_nu) % p.ns);
  const int j = static_cast<int>(lane % p.n_nu);

  Lane<STAGED> ln;
  ln.lnP = STAGED ? s_lnP : p.lnP;
  ln.lrec = s_lrec;
  ln.crec = s_crec + (c - c_lo) * (npc - 1);
  ln.Tc = p.Tg + static_cast<long long>(c) * npc;
  ln.muc = p.mug + static_cast<long long>(c) * npc;
  ln.sb = p.lnsig + c * p.sig_stride + j;
  ln.n_nu = p.n_nu;
  ln.npc = npc;
  ln.mconst2 = 2.0f * (p.m[s] * p.konst);
  const float nu = p.nu[j];
  const float nu_m = 100.0f * nu;
  ln.pl100 = 100.0f * (p.pl * (nu_m * nu_m * nu_m));
  ln.c2nu = p.c2 * nu;
  const float atol = p.atol[c];
  Row row;
  row.i = -2;  // no row held: the first load reads both rows
  load_row(ln, row, 0, true);

  float y = p.y0[lane];
  int steps = 0, attempts = 0;
  if (p.dense) p.y[lane] = y;
  for (int k = 0; k + 1 < p.nx; ++k) {
    if (!segment<RHS>(p, ln, row, atol, s_xs[k], s_xs[k + 1], y, steps, attempts)) y = nanf("");
    if (p.dense) p.y[static_cast<long long>(k + 1) * p.L + lane] = y;
  }
  if (!p.dense) p.y[lane] = y;
  p.steps[lane] = steps;
  p.attempts[lane] = attempts;
  if (p.work != nullptr) {
    // the lanes of this warp that did not leave are its first ``live``
    const long long warp0 = lane - (threadIdx.x & 31);
    const long long live = p.L - warp0 < 32 ? p.L - warp0 : 32;
    const unsigned mask = live == 32 ? 0xffffffffu : (1u << live) - 1u;
    const unsigned long long ws = warp_sum(mask, steps);
    const unsigned long long wa = warp_sum(mask, attempts);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(p.work, ws);
      atomicAdd(p.work + 1, wa);
    }
  }
}

// dynamic shared bytes of a launch, staged or not
long long shared_bytes(const Params& p, bool staged) {
  return staged ? 16LL * (p.npc - 1) * (1 + p.cols_per_block) + 4LL * (p.nx + p.npc)
                : 4LL * p.nx;
}

template <int RHS>
void launch(const Params& p, bool staged, long long smem, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((p.L + BLOCK - 1) / BLOCK);
  if (staged)
    radau_kernel<RHS, true><<<blocks, BLOCK, smem, st>>>(p);
  else
    radau_kernel<RHS, false><<<blocks, BLOCK, smem, st>>>(p);
}

}  // namespace

extern "C" {

int radau_max_streams() { return MAX_STREAMS; }
// present where radau_launch takes ``work`` (an earlier tree's library takes none)
int radau_counts_work() { return 1; }
int radau_block() { return BLOCK; }

// consts: E[3], T[9], TI[9], mu_r, mu_cr, mu_ci, rtol, newton_tol, konst,
// pl, c2, then the nodes C[3], 1 / mu_r, the safety factor at nit = 1 and
// 2 and (1e-12)^(-1/4) (36 floats, each the plain engine's float32 value;
// the first design read the first 29); nodes: the three collocation nodes in
// double (the first design's stage abscissae; not read here: the
// abscissae are formed from C); m: ns host floats; newton_iters must be 2
// (the kernel's); work: null, or 2 device uint64 the launch adds its lanes'
// accepted steps and attempts to (a warp's sum, one atomic each). Every
// pointer but consts and m is device memory. A block
// stages its columns' rows in shared memory where they fit within 48 KB,
// else its lanes read them from device memory. Returns cudaGetLastError().
int radau_launch(int rhs, int dense, long long L, int n_cols, int ns, int n_nu, int npc,
                 int nx, const float* consts, const double* nodes, const float* m,
                 int newton_iters,
                 int max_steps, const float* lnP, const float* Tg, const float* mug,
                 const float* lnsig, long long sig_stride, const float* nu,
                 const float* atol, const float* y0, const float* xs, float* y, int* steps,
                 int* attempts, unsigned long long* work, void* stream) {
  if (ns < 1 || ns > MAX_STREAMS || npc < 2 || nx < 2 || L < 1 || n_nu < 1 || n_cols < 1 ||
      L != static_cast<long long>(n_cols) * ns * n_nu || newton_iters != NEWTON_ITERS ||
      max_steps < 0 || (rhs != RHS_EMISSION && rhs != RHS_DEPTH))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int k = 0; k < 3; ++k) p.E[k] = consts[k];
  for (int k = 0; k < 9; ++k) { p.T[k] = consts[3 + k]; p.TI[k] = consts[12 + k]; }
  p.mu_r = consts[21]; p.mu_cr = consts[22]; p.mu_ci = consts[23];
  p.rtol = consts[24]; p.newton_tol = consts[25]; p.konst = consts[26];
  p.pl = consts[27]; p.c2 = consts[28];
  for (int k = 0; k < 3; ++k) p.C[k] = consts[29 + k];
  p.inv_mu_r = consts[32];
  p.safety[0] = consts[33];
  p.safety[1] = consts[34];
  p.fac_floor = consts[35];
  for (int k = 0; k < ns; ++k) p.m[k] = m[k];
  p.max_steps = max_steps;
  p.L = L; p.n_cols = n_cols; p.ns = ns; p.n_nu = n_nu; p.npc = npc; p.nx = nx;
  p.sig_stride = sig_stride;
  const long long lanes_col = static_cast<long long>(ns) * n_nu;
  long long cols = (BLOCK - 1) / lanes_col + 2;
  if (cols > n_cols) cols = n_cols;
  p.cols_per_block = static_cast<int>(cols);
  const bool staged = shared_bytes(p, true) <= SHARED_BUDGET;
  const long long smem = shared_bytes(p, staged);
  if (smem > SHARED_BUDGET) return static_cast<int>(cudaErrorInvalidValue);
  p.lnP = lnP; p.Tg = Tg; p.mug = mug; p.lnsig = lnsig; p.nu = nu; p.atol = atol;
  p.y0 = y0; p.xs = xs; p.y = y; p.steps = steps; p.attempts = attempts; p.work = work;
  p.dense = dense;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rhs == RHS_EMISSION)
    launch<RHS_EMISSION>(p, staged, smem, st);
  else
    launch<RHS_DEPTH>(p, staged, smem, st);
  return static_cast<int>(cudaGetLastError());
}

// registers and local (spill) bytes a thread, resident blocks an SM, of the
// staged instance (the flux core's)
int radau_kernel_info(int rhs, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = rhs == RHS_EMISSION ? cudaFuncGetAttributes(&a, radau_kernel<RHS_EMISSION, true>)
                                      : cudaFuncGetAttributes(&a, radau_kernel<RHS_DEPTH, true>);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = rhs == RHS_EMISSION
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, radau_kernel<RHS_EMISSION, true>, BLOCK, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, radau_kernel<RHS_DEPTH, true>, BLOCK, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(e);
}

}  // extern "C"
