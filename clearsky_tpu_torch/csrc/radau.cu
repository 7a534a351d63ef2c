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
// simplified Newton in the eigenbasis (one real and one complex division a
// Newton step), a thread that finishes exits, and a warp runs as long as
// its slowest lane. Lanes are ordered as the JAX package orders them
// (lane = (column x streams + stream) x n_nu + j), so a warp holds 32
// neighbouring wavenumbers of one stream.
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
// Dense output walks the nodes xs[0..nx-1]: each segment restarts as JAX's
// lax.scan of radau_scalar does (a fresh initial step, no controller
// history, max_steps attempts), and a lane that does not reach a segment's
// end is NaN from then on. max_steps counts attempts per lane: in JAX a
// lane's attempts equal the loop's global iteration count while the lane is
// active (done is absorbing), so capping each lane at max_steps attempts
// gives JAX's ok lane for lane.
//
// Arithmetic: float32, IEEE division, the accurate expf/logf/expm1f (no fast
// math); the method's constants (error weights, eigenvalues, the
// transformation matrices) and the Planck constants arrive rounded to
// float32 by the wrapper, as the plain engine rounds them. JAX's guards
// max(v, 1e-300) are max(v, 0) in float32. A lane's position x, its step
// sizes and its stage abscissae are doubles (the plain engine's float64
// positions), the right-hand side sees x rounded to float32, and the step
// floor 16 eps max(|x|, 1) is double's: in float32 a lane at the surface
// (|x| ~ 300) whose boundary layer needs steps under 6e-4 would reject at
// that floor until max_steps, as the JAX package's float32 engine does.
// Built with -fmad=false the kernel gives the plain float32 engine's bits
// on the card, lane for lane (tools/radau_probe.py --nofma); the default
// build contracts multiply-adds and differs in rounding only.

#include <cuda_runtime.h>
#include <math.h>
#include <float.h>

namespace {

constexpr int MAX_STREAMS = 8;
constexpr int RHS_EMISSION = 0;
constexpr int RHS_DEPTH = 1;
constexpr int BLOCK = 128;
constexpr long long SHARED_BUDGET = 48 * 1024;

struct Params {
  // the method (rounded to float32 by the wrapper)
  double C_x[3];        // the collocation nodes, for positions
  float E[3], T[9], TI[9];
  float mu_r, mu_cr, mu_ci;
  float rtol, newton_tol;
  float konst;          // 1e-4 N_A / g
  float pl, c2;         // 2 h c^2 and the second radiation constant
  float m[MAX_STREAMS];
  int newton_iters, max_steps;
  // lanes: C columns x ns streams x n_nu points
  long long L;
  int n_cols, ns, n_nu, npc, nx;
  long long sig_stride;  // floats between columns of ln sigma (0: shared)
  int stage_cols, cols_per_block;
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
  int dense;
};

struct Lane {
  const float* lnP;
  const float* Tc;
  const float* muc;
  const float* sb;  // ln sigma at (column, row 0, j)
  int n_nu, npc;
  float mconst, pl_nu, c2nu;
};

// max and min that propagate NaN, as jnp.maximum/minimum and torch's do
// (fmaxf/fminf return the other operand)
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
__device__ __forceinline__ double jmax(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmax(a, b);
}
__device__ __forceinline__ double jmin(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmin(a, b);
}

// searchsorted(lnP, v, side="right") - 1, clipped to [0, npc - 2]
__device__ __forceinline__ int bracket(const float* lnP, int npc, float v) {
  int lo = 0, hi = npc;  // first index with lnP[k] > v lies in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lnP[mid] <= v) lo = mid + 1; else hi = mid;
  }
  const int i = lo - 1;
  return i < 0 ? 0 : (i > npc - 2 ? npc - 2 : i);
}

// rate and (EMISSION) Planck B at abscissa x
template <int RHS>
__device__ __forceinline__ void eval_at(const Lane& ln, float x, float& rate, float& B) {
  const float sp = fabsf(x);
  const float lnp = 2.0f * logf(sp);
  const int i = bracket(ln.lnP, ln.npc, lnp);
  const float t = (lnp - ln.lnP[i]) / (ln.lnP[i + 1] - ln.lnP[i]);
  const float mu = ln.muc[i] + t * (ln.muc[i + 1] - ln.muc[i]);
  const float l0 = __ldg(ln.sb + static_cast<long long>(i) * ln.n_nu);
  const float l1 = __ldg(ln.sb + static_cast<long long>(i + 1) * ln.n_nu);
  const float lns = l0 + t * (l1 - l0);
  rate = ln.mconst * (expf(lns) / mu) * (2.0f * sp);
  if (RHS == RHS_EMISSION) {
    // ops/planck.py's form: 100 p e^-x / (1 - e^-x)
    const float T = ln.Tc[i] + t * (ln.Tc[i + 1] - ln.Tc[i]);
    const float xx = ln.c2nu / T;
    const float em = expf(-xx);
    B = 100.0f * ln.pl_nu * em / (-expm1f(-xx));
  } else {
    B = 0.0f;
  }
}

template <int RHS>
__device__ __forceinline__ float rhs(float rate, float B, float y) {
  return RHS == RHS_EMISSION ? rate * (B - y) : rate;
}

// One segment [xa, xb] of one lane; returns true when the lane reached xb
// within max_steps attempts. y is updated in place.
template <int RHS>
__device__ bool segment(const Params& p, const Lane& ln, float atol, double xa, double xb,
                        float& y, int& steps, int& attempts) {
  const double eps_x = DBL_EPSILON;
  const float rtol = p.rtol;
  double x = xa;
  const double x1 = xb;
  const double span = fabs(x1 - x);
  const double d = (x1 - x) < 0.0 ? -1.0 : 1.0;
  float rate_x, B_x;
  eval_at<RHS>(ln, static_cast<float>(x), rate_x, B_x);
  float f0 = rhs<RHS>(rate_x, B_x, y);
  if (isnan(f0)) y = nanf("");
  if (span <= 0.0 || isnan(y)) return true;

  // the initial step (curvature heuristic, exponent 1/4)
  double h;
  {
    const float scale = atol + fabsf(y) * rtol;
    const double spn = jmax(span, 1e-30);
    const float d0 = fabsf(y) / scale;
    const float d1 = fabsf(f0) / scale;
    const float h0f = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : 0.01f * d0 / jmax(d1, 0.0f);
    const double h0d = jmin(static_cast<double>(h0f), spn);
    const double dh = d * h0d;
    float r1, B1;
    eval_at<RHS>(ln, static_cast<float>(x + dh), r1, B1);
    const float f1 = rhs<RHS>(r1, B1, y + static_cast<float>(dh) * f0);
    const float h0 = static_cast<float>(h0d);
    const float d2 = fabsf(f1 - f0) / scale / jmax(h0, 0.0f);
    const float dm = jmax(d1, d2);
    const float h1 = dm <= 1e-15f ? jmax(h0 * 1e-3f, 1e-6f) : powf(0.01f / jmax(dm, 0.0f), 0.25f);
    h = jmin(static_cast<double>(jmin(100.0f * h0, h1)), spn);
  }
  double h_old = 0.0;
  float err_old = -1.0f;
  bool rej = false;
  const float ni = static_cast<float>(p.newton_iters);

  for (int a = 0; a < p.max_steps; ++a) {
    ++attempts;
    const double rem = fabs(x1 - x);
    double h_abs = jmin(h, rem);
    h_abs = jmax(h_abs, 16.0 * eps_x * jmax(fabs(x), 1.0));
    const double hs_x = d * h_abs;             // the signed step, in positions
    const float hs = static_cast<float>(hs_x);  // the step in y's arithmetic
    const float J = RHS == RHS_EMISSION ? -rate_x : 0.0f;
    const float mr = p.mu_r / hs, mcr = p.mu_cr / hs, mci = p.mu_ci / hs;
    const float den_r = mr - J;
    const float dcr = mcr - J;
    const float inv_c = 1.0f / (dcr * dcr + mci * mci);
    const float scale = atol + fabsf(y) * rtol;

    float rs[3], Bs[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      eval_at<RHS>(ln, static_cast<float>(x + p.C_x[k] * hs_x), rs[k], Bs[k]);

    // simplified Newton on the stage increments, in the eigenbasis
    float W0 = 0.0f, W1 = 0.0f, W2 = 0.0f, dwn = 0.0f, rate = -1.0f, nit = 0.0f;
    for (int k = 0; k < p.newton_iters; ++k) {
      const float Z0 = p.T[0] * W0 + p.T[1] * W1 + p.T[2] * W2;
      const float Z1 = p.T[3] * W0 + p.T[4] * W1 + p.T[5] * W2;
      const float Z2 = p.T[6] * W0 + p.T[7] * W1 + p.T[8] * W2;
      const float F0 = rhs<RHS>(rs[0], Bs[0], y + Z0);
      const float F1 = rhs<RHS>(rs[1], Bs[1], y + Z1);
      const float F2 = rhs<RHS>(rs[2], Bs[2], y + Z2);
      const float g_r = (p.TI[0] * F0 + p.TI[1] * F1 + p.TI[2] * F2) - mr * W0;
      const float g_cr = (p.TI[3] * F0 + p.TI[4] * F1 + p.TI[5] * F2) - (mcr * W1 + mci * W2);
      const float g_ci = (p.TI[6] * F0 + p.TI[7] * F1 + p.TI[8] * F2) - (mcr * W2 - mci * W1);
      const float dW0 = g_r / den_r;
      const float dW1 = (g_cr * dcr - g_ci * mci) * inv_c;
      const float dW2 = (g_ci * dcr + g_cr * mci) * inv_c;
      const float a0 = dW0 / scale, a1 = dW1 / scale, a2 = dW2 / scale;
      const float dwn_new = sqrtf((a0 * a0 + a1 * a1 + a2 * a2) / 3.0f);
      const float rate_new = dwn > 0.0f ? dwn_new / jmax(dwn, 0.0f) : rate;
      W0 += dW0;
      W1 += dW1;
      W2 += dW2;
      dwn = dwn_new;
      rate = rate_new;
      nit += 1.0f;
      const bool settled = dwn_new == 0.0f ||
          (rate_new >= 0.0f && rate_new < 1.0f &&
           rate_new / (1.0f - rate_new) * dwn_new < p.newton_tol);
      if (settled) break;
    }
    const bool conv = dwn == 0.0f ||
        (rate >= 0.0f && rate < 1.0f && rate / jmax(1.0f - rate, 1e-6f) * dwn < p.newton_tol);

    const float Z2 = p.T[6] * W0 + p.T[7] * W1 + p.T[8] * W2;
    const float y_new = y + Z2;
    const float ZE = ((p.T[0] * W0 + p.T[1] * W1 + p.T[2] * W2) * p.E[0] +
                      (p.T[3] * W0 + p.T[4] * W1 + p.T[5] * W2) * p.E[1] + Z2 * p.E[2]) / hs;
    const float scale_e = atol + jmax(fabsf(y), fabsf(y_new)) * rtol;
    const float e_raw = (f0 + ZE) / den_r;
    float err = fabsf(e_raw) / scale_e;
    if (rej && err > 1.0f) {
      // the stiffness-damped re-estimate (a retry of a rejected step)
      const float f_damp = rhs<RHS>(rate_x, B_x, y + e_raw);
      err = fabsf((f_damp + ZE) / den_r) / scale_e;
    }

    const float safety = 0.9f * (2.0f * ni + 1.0f) / (2.0f * ni + nit);
    const float mult = (err_old > 0.0f && h_old > 0.0 && err > 0.0f)
        ? static_cast<float>(h_abs / h_old) * powf(err_old / jmax(err, 0.0f), 0.25f) : 1.0f;
    const float factor = jmin(1.0f, mult) * powf(jmax(err, 1e-12f), -0.25f);
    const bool accept = conv && err <= 1.0f;

    const double x_next = x + hs_x;
    const bool reached = fabs(x1 - x_next) <= 16.0 * eps_x * jmax(fabs(x1), 1.0);
    if (accept) {
      const double h_acc = h_abs * static_cast<double>(jmin(jmax(safety * factor, 0.2f), 10.0f));
      x = x_next;
      y = y_new;
      rate_x = rs[2];
      B_x = Bs[2];
      f0 = rhs<RHS>(rate_x, B_x, y_new);
      h = h_acc;
      h_old = h_abs;
      err_old = err;
      ++steps;
      rej = false;
      if (reached) return true;
    } else {
      h = conv ? h_abs * static_cast<double>(jmax(0.2f, safety * factor)) : 0.5 * h_abs;
      rej = true;
    }
  }
  return false;
}

template <int RHS>
__global__ void __launch_bounds__(BLOCK) radau_kernel(const Params p) {
  extern __shared__ float sh[];
  float* s_xs = sh;                 // [nx]
  float* s_lnP = sh + p.nx;         // [npc]
  float* s_cols = s_lnP + p.npc;    // [cols_per_block, 2, npc]: T, mu
  const long long lanes_col = static_cast<long long>(p.ns) * p.n_nu;
  const long long first = static_cast<long long>(blockIdx.x) * BLOCK;
  const int c_lo = static_cast<int>(first / lanes_col);
  for (int k = threadIdx.x; k < p.nx; k += BLOCK) s_xs[k] = p.xs[k];
  for (int k = threadIdx.x; k < p.npc; k += BLOCK) s_lnP[k] = p.lnP[k];
  if (p.stage_cols) {
    for (int c = 0; c < p.cols_per_block && c_lo + c < p.n_cols; ++c) {
      for (int k = threadIdx.x; k < p.npc; k += BLOCK) {
        s_cols[(2 * c) * p.npc + k] = p.Tg[static_cast<long long>(c_lo + c) * p.npc + k];
        s_cols[(2 * c + 1) * p.npc + k] = p.mug[static_cast<long long>(c_lo + c) * p.npc + k];
      }
    }
  }
  __syncthreads();
  const long long lane = first + threadIdx.x;
  if (lane >= p.L) return;
  const int c = static_cast<int>(lane / lanes_col);
  const int s = static_cast<int>((lane / p.n_nu) % p.ns);
  const int j = static_cast<int>(lane % p.n_nu);

  Lane ln;
  ln.lnP = s_lnP;
  if (p.stage_cols) {
    ln.Tc = s_cols + (2 * (c - c_lo)) * p.npc;
    ln.muc = s_cols + (2 * (c - c_lo) + 1) * p.npc;
  } else {
    ln.Tc = p.Tg + static_cast<long long>(c) * p.npc;
    ln.muc = p.mug + static_cast<long long>(c) * p.npc;
  }
  ln.sb = p.lnsig + c * p.sig_stride + j;
  ln.n_nu = p.n_nu;
  ln.npc = p.npc;
  ln.mconst = p.m[s] * p.konst;
  const float nu = p.nu[j];
  const float nu_m = 100.0f * nu;
  ln.pl_nu = p.pl * (nu_m * nu_m * nu_m);
  ln.c2nu = p.c2 * nu;
  const float atol = p.atol[c];

  float y = p.y0[lane];
  int steps = 0, attempts = 0;
  if (p.dense) p.y[lane] = y;
  for (int k = 0; k + 1 < p.nx; ++k) {
    if (!segment<RHS>(p, ln, atol, s_xs[k], s_xs[k + 1], y, steps, attempts)) y = nanf("");
    if (p.dense) p.y[static_cast<long long>(k + 1) * p.L + lane] = y;
  }
  if (!p.dense) p.y[lane] = y;
  p.steps[lane] = steps;
  p.attempts[lane] = attempts;
}

}  // namespace

extern "C" {

int radau_max_streams() { return MAX_STREAMS; }
int radau_block() { return BLOCK; }

// consts: E[3], T[9], TI[9], mu_r, mu_cr, mu_ci, rtol, newton_tol, konst,
// pl, c2 (29 floats, rounded to float32 by the caller); nodes: the three
// collocation nodes in double (positions); m: ns host
// floats. Every pointer but consts and m is device memory. The columns'
// T and mu are staged in shared memory where a block's columns fit within
// 48 KB, else read from device memory. Returns cudaGetLastError().
int radau_launch(int rhs, int dense, long long L, int n_cols, int ns, int n_nu, int npc,
                 int nx, const float* consts, const double* nodes, const float* m,
                 int newton_iters,
                 int max_steps, const float* lnP, const float* Tg, const float* mug,
                 const float* lnsig, long long sig_stride, const float* nu,
                 const float* atol, const float* y0, const float* xs, float* y, int* steps,
                 int* attempts, void* stream) {
  if (ns < 1 || ns > MAX_STREAMS || npc < 2 || nx < 2 || L < 1 || n_nu < 1 || n_cols < 1 ||
      L != static_cast<long long>(n_cols) * ns * n_nu || newton_iters < 2 || max_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int k = 0; k < 3; ++k) { p.C_x[k] = nodes[k]; p.E[k] = consts[k]; }
  for (int k = 0; k < 9; ++k) { p.T[k] = consts[3 + k]; p.TI[k] = consts[12 + k]; }
  p.mu_r = consts[21]; p.mu_cr = consts[22]; p.mu_ci = consts[23];
  p.rtol = consts[24]; p.newton_tol = consts[25]; p.konst = consts[26];
  p.pl = consts[27]; p.c2 = consts[28];
  for (int k = 0; k < ns; ++k) p.m[k] = m[k];
  p.newton_iters = newton_iters; p.max_steps = max_steps;
  p.L = L; p.n_cols = n_cols; p.ns = ns; p.n_nu = n_nu; p.npc = npc; p.nx = nx;
  p.sig_stride = sig_stride;
  const long long lanes_col = static_cast<long long>(ns) * n_nu;
  long long cols = (BLOCK - 1) / lanes_col + 2;
  if (cols > n_cols) cols = n_cols;
  p.cols_per_block = static_cast<int>(cols);
  long long smem = 4LL * (nx + npc + 2LL * npc * cols);
  p.stage_cols = smem <= SHARED_BUDGET;
  if (!p.stage_cols) smem = 4LL * (nx + npc);
  if (smem > SHARED_BUDGET) return static_cast<int>(cudaErrorInvalidValue);
  p.lnP = lnP; p.Tg = Tg; p.mug = mug; p.lnsig = lnsig; p.nu = nu; p.atol = atol;
  p.y0 = y0; p.xs = xs; p.y = y; p.steps = steps; p.attempts = attempts; p.dense = dense;
  const long long blocks = (L + BLOCK - 1) / BLOCK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rhs == RHS_EMISSION)
    radau_kernel<RHS_EMISSION><<<static_cast<unsigned>(blocks), BLOCK, smem, st>>>(p);
  else if (rhs == RHS_DEPTH)
    radau_kernel<RHS_DEPTH><<<static_cast<unsigned>(blocks), BLOCK, smem, st>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// registers and local (spill) bytes a thread, resident blocks an SM
int radau_kernel_info(int rhs, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = rhs == RHS_EMISSION ? cudaFuncGetAttributes(&a, radau_kernel<RHS_EMISSION>)
                                      : cudaFuncGetAttributes(&a, radau_kernel<RHS_DEPTH>);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = rhs == RHS_EMISSION
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, radau_kernel<RHS_EMISSION>, BLOCK, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, radau_kernel<RHS_DEPTH>, BLOCK, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(e);
}

}  // extern "C"
