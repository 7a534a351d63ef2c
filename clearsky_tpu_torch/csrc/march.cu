// Flux-march kernels (K2, K3): the hemispheric-stream Schwarzschild march of
// the discretized core.
//
// Replace clearsky_tpu/rt/march_pallas.py::_olr_kernel (K2, TOA-only upward
// march, wrapper olr_pallas) and ::_march_kernel (K3, down march + stellar
// beam + Lambertian surface + up march, wrapper monoflux_pallas).
//
// What bounds them on the H100. Per (stream, layer) the march takes one
// expf and about twenty FP32 operations; per layer and point it reads 8
// bytes (tau and one Planck row) and K3 writes 8 (an M_down and an M_up
// row). The main path gives them two shapes (PERF.md, PR 11):
// - 19 layers x 2^19 points (direct outgoing and radiate): 84 MB for K2,
//   170 MB for K3 (25 and 51 us at 3.35 TB/s). The card is full and the
//   instructions issued a (stream, layer) set the time: PR 1's kernels
//   issued ~49 (an IEEE division, both sides of the series/exp branch in
//   mixed warps), and without loads they took as long as with them. K3's
//   loads and stores alone take ~70 us: it sits between the two.
// - 38 layers x 16,384 points (the RCM's refined grid, every RCM and RCE
//   step): 10 MB, 3 us of bytes. One thread a point filled a third of a
//   wave (64 blocks) and each thread ran 2 x 38 x 5 dependent steps: the
//   chain, not the loads, set the time.
// What the design does (the launch plan, rt/march_cuda.py::march_plan,
// picks one of two layouts and passes its numbers):
// - The layer step (layer_step): I <- b2 + t (I - b1) + (b1 - b2) ratio
//   with, below tm = 0.25, t = 1 - tm r and ratio = r (r the 7-term series
//   of (1 - e^-tm)/tm) and above t = e = expf(-tm) (the accurate expf; no
//   fast math) and ratio = (1 - e) q, q = 1/tm formed as rcp(tau) (1/m):
//   one correctly rounded reciprocal a layer for every stream, 1/m by
//   value, no division. The two sides meet in a select, so that at tau = 0
//   the infinite q never reaches the series value.
// - Where the card is full (N >= SMs x 1024), a thread a point with every
//   stream in registers (spread = false), 128 a block; the next layer's
//   tau and B load while this one marches and the lower level's B is
//   carried. Where every lane of a warp has every stream under the switch,
//   or every one over it, the warp runs that side alone (a vote a layer):
//   the entry points' columns are mostly such, chip_smoke's random one
//   is not; a lane's result does not depend on its neighbours. K3 keeps
//   its column's first `chunk` layers in thread-private shared memory
//   during the down march and marches up from there: each input byte is
//   read from device memory once where the column fits.
// - Where N is small (spread = true), a block owns 32 points and runs a
//   warp a stream (K3: and a warp for the stellar beam), so a thread
//   marches one (point, stream) pair: nst + 1 times the warps of a thread a
//   point and a chain nst times shorter, 512 blocks at the RCM's shape.
//   The block stages its points' tau, 1/tau and Planck rows for `chunk`
//   layers in shared memory, a row a warp with 8 rows in flight (K3 keeps
//   the last chunk for the up march and stages the others again, last
//   first); each warp writes W_k I_k of every level into shared memory and,
//   after a barrier, the block sums each level's streams in stream order
//   (then the beam) and writes the flux rows coalesced. K3's surface
//   coupling I_surf = M_down[L] a / pi + B[L] is such a sum, taken before
//   the up march begins. What remains there is each block's chain of
//   phases (stage, march, barrier, sum) at one wave of blocks.
// Every sum has a fixed order and there are no atomics: two launches agree
// bit for bit. Any L >= 1, 1-8 streams, any N.

#include "march_common.cuh"

using namespace clearsky;

namespace {

struct Nodes {
  float m[MAX_STREAMS];      // slant factors 1/cos(theta)
  float inv_m[MAX_STREAMS];  // their reciprocals
  float W[MAX_STREAMS];      // flux quadrature weights
  float m_min, m_max;
};

Nodes pack_nodes(const float* m, const float* W, int nst) {
  Nodes sn{};
  for (int k = 0; k < nst; ++k) {
    sn.m[k] = m[k];
    sn.inv_m[k] = 1.0f / m[k];
    sn.W[k] = W[k];
    sn.m_min = k == 0 || m[k] < sn.m_min ? m[k] : sn.m_min;
    sn.m_max = k == 0 || m[k] > sn.m_max ? m[k] : sn.m_max;
  }
  return sn;
}

// The loads of tau and B and the stores of the flux rows, one place each:
// p is the element of layer (or level, or row) l at point n.
__device__ __forceinline__ float load_tau(const float* __restrict__ p, int l, int n) {
  return *p;
}
__device__ __forceinline__ float load_b(const float* __restrict__ p, int l, int n) {
  return *p;
}
__device__ __forceinline__ void store_row(float* __restrict__ p, int l, int n, float v) {
  *p = v;
}

// A (stream, layer) step entering at level value b1 and leaving at b2:
// I t + b2 omt - dB t + ratio dB with t = 1 - omt (march_pallas.py::
// _trans_emit, _layer_planck), rearranged to b2 + t (I - b1) + dB ratio.
// Below tm = 0.25, (t, ratio) = (1 - tm r, r) with r the 7-term series of
// (1 - e^-tm)/tm; above, (e, (1 - e) q) with e = expf(-tm) and q = 1/tm
// formed as rcp(tau) (1/m).
__device__ __forceinline__ void series_branch(float tm, float& t, float& ratio) {
  const float r = 1.0f - tm * (0.5f - tm * ((1.0f / 6.0f) - tm * (
      (1.0f / 24.0f) - tm * ((1.0f / 120.0f) - tm * ((1.0f / 720.0f)
                                                    - tm * (1.0f / 5040.0f))))));
  t = fmaf(-tm, r, 1.0f);
  ratio = r;
}

__device__ __forceinline__ void exp_branch(float tm, float q, float& t, float& ratio) {
  const float e = expf(-tm);
  t = e;
  ratio = fmaf(-e, q, q);
}

__device__ __forceinline__ float layer_update(float I, float t, float ratio, float dB, float b1,
                                              float b2) {
  return fmaf(dB, ratio, fmaf(t, I - b1, b2));
}

// both branches and a select: at tau = 0 the infinite q never reaches the
// series value
__device__ __forceinline__ float layer_step(float I, float tl, float rtl, float m, float inv_m,
                                            float dB, float b1, float b2) {
  const float tm = tl * m;
  float ts, rs, te, re;
  series_branch(tm, ts, rs);
  exp_branch(tm, rtl * inv_m, te, re);
  const bool small = tm < 0.25f;
  return layer_update(I, small ? ts : te, small ? rs : re, dB, b1, b2);
}

// A layer for all streams of a point (one thread a point). Where every
// lane of the warp has every stream under the switch (tau m_max < 0.25),
// or every one over it (tau m_min >= 0.25), the warp runs that branch
// alone; the results do not depend on the neighbours' branches.
// `mask`: the warp's lanes that march (the kernel's, past its early exit).
template <int NST>
__device__ __forceinline__ void march_layer(float (&I)[NST], const Nodes& sn, float tl,
                                            float b1, float b2, unsigned mask) {
  const float dB = b1 - b2;
  if (__all_sync(mask, tl * sn.m_max < 0.25f)) {
#pragma unroll
    for (int k = 0; k < NST; ++k) {
      float t, ratio;
      series_branch(tl * sn.m[k], t, ratio);
      I[k] = layer_update(I[k], t, ratio, dB, b1, b2);
    }
    return;
  }
  const float rtl = __frcp_rn(tl);
  if (__all_sync(mask, tl * sn.m_min >= 0.25f)) {
#pragma unroll
    for (int k = 0; k < NST; ++k) {
      float t, ratio;
      exp_branch(tl * sn.m[k], rtl * sn.inv_m[k], t, ratio);
      I[k] = layer_update(I[k], t, ratio, dB, b1, b2);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < NST; ++k) I[k] = layer_step(I[k], tl, rtl, sn.m[k], sn.inv_m[k], dB, b1, b2);
}

template <int NST>
__device__ __forceinline__ float weighted(const float (&I)[NST], const Nodes& sn) {
  float e = 0.0f;
#pragma unroll
  for (int k = 0; k < NST; ++k) e += sn.W[k] * I[k];
  return e;
}

// ---- one thread a point (spread = false) --------------------------------

template <int NST>
__device__ __forceinline__ void olr_point(const float* __restrict__ tau,
                                          const float* __restrict__ B, const Nodes& sn, int L,
                                          int N, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const unsigned mask = __activemask();
  const size_t sN = N;
  const float* tp = tau + (size_t)(L - 1) * sN + n;  // layer l's tau
  const float* bp = B + (size_t)(L - 1) * sN + n;    // level l's B
  float b1 = load_b(bp + sN, L, n);  // entering from below: the surface
  float I[NST];
#pragma unroll
  for (int k = 0; k < NST; ++k) I[k] = b1;
  float tl = load_tau(tp, L - 1, n), b2 = load_b(bp, L - 1, n);
  for (int l = L - 1; l >= 0; --l) {
    float tl_next = 0.0f, b_next = 0.0f;
    if (l > 0) {  // the next layer's loads in flight during this one
      tp -= sN;
      bp -= sN;
      tl_next = load_tau(tp, l - 1, n);
      b_next = load_b(bp, l - 1, n);
    }
    march_layer(I, sn, tl, b1, b2, mask);
    b1 = b2;
    tl = tl_next;
    b2 = b_next;
  }
  out[n] = weighted(I, sn);
}

// The column's first `keep` layers (tau and the upper level's B) stay in
// shared memory during the down march, [keep][blockDim.x], each thread its
// own column (no barrier); the up march reads them there, and layers past
// `keep` from device memory. The down march has the next layer's loads in
// flight.
template <int NST>
__device__ __forceinline__ void monoflux_point(
    const float* __restrict__ tau, const float* __restrict__ B, const float* __restrict__ S,
    const float* __restrict__ albedo, float ctheta, const Nodes& sn, int L, int N, int keep,
    float* __restrict__ M_up, float* __restrict__ M_down) {
  extern __shared__ float smem[];
  const int t = threadIdx.x, P = blockDim.x;
  const int n = blockIdx.x * P + t;
  if (n >= N) return;
  const unsigned mask = __activemask();
  const size_t sN = N;
  float* s_tau = smem + t;
  float* s_b = smem + (size_t)keep * P + t;
  const float inv_c = 1.0f / ctheta;
  float I[NST];
#pragma unroll
  for (int k = 0; k < NST; ++k) I[k] = 0.0f;
  const float* tp = tau + n;  // layer l's tau
  const float* bp = B + n;    // level l's B
  float* row = M_down + n;    // M_down's row l
  float bm = ctheta * S[n];   // direct beam below level 0
  store_row(row, 0, n, bm);
  float down = bm;
  float b1 = load_b(bp, 0, n);  // entering from above
  float tl = load_tau(tp, 0, n), b2 = load_b(bp + sN, 1, n);
  for (int l = 0; l < L; ++l) {
    float tl_next = 0.0f, b_next = 0.0f;
    if (l + 1 < L) {
      tl_next = load_tau(tp + sN, l + 1, n);
      b_next = load_b(bp + 2 * sN, l + 2, n);
    }
    if (l < keep) {
      s_tau[l * P] = tl;
      s_b[l * P] = b1;
    }
    march_layer(I, sn, tl, b1, b2, mask);
    bm *= expf(-tl * inv_c);
    down = weighted(I, sn) + bm;
    row += sN;
    store_row(row, l + 1, n, down);
    tp += sN;
    bp += sN;
    b1 = b2;
    tl = tl_next;
    b2 = b_next;
  }
  // b1 is B[L]: Lambertian reflection plus surface emission
  const float I_surf = down * (albedo[n] * INV_PI) + b1;
  row = M_up + (size_t)L * sN + n;
  store_row(row, L, n, PI_F * I_surf);
#pragma unroll
  for (int k = 0; k < NST; ++k) I[k] = I_surf;
  float lo = b1;  // entering from below
  for (int l = L - 1; l >= 0; --l) {
    float tu, hi;
    if (l < keep) {
      tu = s_tau[l * P];
      hi = s_b[l * P];
    } else {
      tu = load_tau(tau + (size_t)l * sN + n, l, n);
      hi = load_b(B + (size_t)l * sN + n, l, n);
    }
    march_layer(I, sn, tu, lo, hi, mask);
    row -= sN;
    store_row(row, l, n, weighted(I, sn));
    lo = hi;
  }
}

// ---- a warp a stream (spread = true) ------------------------------------

constexpr int SP = 32;           // points a block: a warp's lanes
constexpr int STAGE_BATCH = 8;   // rows a warp has in flight while staging

// Shared memory of a block staging `chunk` layers: tau and 1/tau
// [chunk][SP], B [chunk + 1][SP], the weighted intensities
// [chunk][slices][SP] (K2: [slices][SP]) and, for K3, I_surf [SP].
struct Tile {
  float* tau;
  float* rtau;
  float* b;
  float* acc;
  float* isurf;
};

__device__ __forceinline__ Tile tile_of(float* smem, int chunk) {
  Tile s;
  s.tau = smem;
  s.rtau = s.tau + chunk * SP;
  s.b = s.rtau + chunk * SP;
  s.acc = s.b + (chunk + 1) * SP;
  s.isurf = nullptr;
  return s;
}

// Layers l0 .. l0 + nl - 1 of the block's points and levels l0 .. l0 + nl
// into the tile, a row a warp (warp w of `warps` takes rows w, w + warps,
// ...), zeros past N; 1/tau once an element for every stream.
__device__ __forceinline__ void stage_tile(const float* __restrict__ tau,
                                           const float* __restrict__ B, int l0, int nl, int n0,
                                           int N, int w, int warps, const Tile& s) {
  const int q = threadIdx.x & 31, n = n0 + q, rows = 2 * nl + 1;
  const size_t sN = N;
  for (int r0 = w; r0 < rows; r0 += STAGE_BATCH * warps) {
    float v[STAGE_BATCH];
#pragma unroll
    for (int j = 0; j < STAGE_BATCH; ++j) {
      const int row = r0 + j * warps;
      v[j] = 0.0f;
      if (row < rows && n < N) {
        const int l = row < nl ? l0 + row : l0 + row - nl;
        v[j] = row < nl ? load_tau(tau + (size_t)l * sN + n, l, n)
                        : load_b(B + (size_t)l * sN + n, l, n);
      }
    }
#pragma unroll
    for (int j = 0; j < STAGE_BATCH; ++j) {
      const int row = r0 + j * warps;
      if (row < nl) {
        s.tau[row * SP + q] = v[j];
        s.rtau[row * SP + q] = __frcp_rn(v[j]);
      } else if (row < rows) {
        s.b[(row - nl) * SP + q] = v[j];
      }
    }
  }
}

// the slice's stream constants: k is uniform across a warp
template <int NST>
__device__ __forceinline__ void node_of(const Nodes& sn, int k, float& m, float& inv_m,
                                        float& W) {
  m = inv_m = W = 0.0f;
#pragma unroll
  for (int j = 0; j < NST; ++j) {
    if (j == k) {
      m = sn.m[j];
      inv_m = sn.inv_m[j];
      W = sn.W[j];
    }
  }
}

// rows i = nl - 1 .. 0 of the staged chunk, marched up; with ACC, W I of
// each level i into acc[i * stride]
template <bool ACC>
__device__ __forceinline__ float march_up(float I, const Tile& s, int nl, int p, float m,
                                          float inv_m, float W, float* acc, int stride) {
  float lo = s.b[nl * SP + p];
  for (int i = nl - 1; i >= 0; --i) {
    const float hi = s.b[i * SP + p];
    I = layer_step(I, s.tau[i * SP + p], s.rtau[i * SP + p], m, inv_m, lo - hi, lo, hi);
    if (ACC) acc[i * stride] = W * I;
    lo = hi;
  }
  return I;
}

template <int NST>
__device__ __forceinline__ void olr_spread(const float* __restrict__ tau,
                                           const float* __restrict__ B, const Nodes& sn, int L,
                                           int N, int chunk, float* __restrict__ out) {
  extern __shared__ float smem[];
  const Tile s = tile_of(smem, chunk);
  const int k = threadIdx.x >> 5, p = threadIdx.x & 31, n0 = blockIdx.x * SP;
  float m, inv_m, W;
  node_of<NST>(sn, k, m, inv_m, W);
  const int chunks = (L + chunk - 1) / chunk;
  float I = 0.0f;
  for (int c = chunks - 1; c >= 0; --c) {  // from the surface up
    const int l0 = c * chunk, nl = min(chunk, L - l0);
    if (c < chunks - 1) __syncthreads();  // the chunk below is marched
    stage_tile(tau, B, l0, nl, n0, N, k, NST, s);
    __syncthreads();
    if (c == chunks - 1) I = s.b[nl * SP + p];
    I = march_up<false>(I, s, nl, p, m, inv_m, W, nullptr, 0);
  }
  s.acc[k * SP + p] = W * I;
  __syncthreads();
  if (k == 0 && n0 + p < N) {
    float e = 0.0f;
#pragma unroll
    for (int j = 0; j < NST; ++j) e += s.acc[j * SP + p];
    out[n0 + p] = e;
  }
}

template <int NST>
__device__ __forceinline__ void monoflux_spread(
    const float* __restrict__ tau, const float* __restrict__ B, const float* __restrict__ S,
    const float* __restrict__ albedo, float ctheta, const Nodes& sn, int L, int N, int chunk,
    float* __restrict__ M_up, float* __restrict__ M_down) {
  constexpr int SL = NST + 1;  // slices: the streams, then the beam
  extern __shared__ float smem[];
  Tile s = tile_of(smem, chunk);
  s.isurf = s.acc + chunk * SL * SP;
  const int k = threadIdx.x >> 5, p = threadIdx.x & 31, n0 = blockIdx.x * SP;
  const int n = n0 + p;
  const bool valid = n < N;
  const size_t sN = N;
  float m, inv_m, W;
  node_of<NST>(sn, k, m, inv_m, W);
  const float inv_c = 1.0f / ctheta;
  const int chunks = (L + chunk - 1) / chunk;
  float* acc = s.acc + k * SP + p;  // this slice's W I at row i: acc[i * SL * SP]
  float I = 0.0f;
  float bm = valid ? ctheta * S[n] : 0.0f;  // the beam's slice
  if (k == NST && valid) store_row(M_down + n, 0, n, bm);
  for (int c = 0; c < chunks; ++c) {  // down
    const int l0 = c * chunk, nl = min(chunk, L - l0);
    stage_tile(tau, B, l0, nl, n0, N, k, SL, s);
    __syncthreads();
    if (k < NST) {
      float hi = s.b[p];
      for (int i = 0; i < nl; ++i) {
        const float lo = s.b[(i + 1) * SP + p];
        I = layer_step(I, s.tau[i * SP + p], s.rtau[i * SP + p], m, inv_m, hi - lo, hi, lo);
        acc[i * SL * SP] = W * I;
        hi = lo;
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < nl; ++i) {
        bm *= expf(-s.tau[i * SP + p] * inv_c);
        acc[i * SL * SP] = bm;
      }
    }
    __syncthreads();
    if (valid) {  // level rows, a row a warp: the streams in order, then the beam
      for (int row = k; row < nl; row += SL) {
        const float* a = s.acc + row * SL * SP + p;
        float e = 0.0f;
#pragma unroll
        for (int j = 0; j < NST; ++j) e += a[j * SP];
        const float down = e + a[NST * SP];
        store_row(M_down + (size_t)(l0 + row + 1) * sN + n, l0 + row + 1, n, down);
        if (l0 + row + 1 == L) {  // the surface
          const float I_surf = down * (albedo[n] * INV_PI) + s.b[nl * SP + p];
          s.isurf[p] = I_surf;
          store_row(M_up + (size_t)L * sN + n, L, n, PI_F * I_surf);
        }
      }
    }
  }
  __syncthreads();
  I = s.isurf[p];  // unset past N, where nothing is stored
  for (int c = chunks - 1; c >= 0; --c) {  // up; the last chunk is still staged
    const int l0 = c * chunk, nl = min(chunk, L - l0);
    if (c < chunks - 1) {
      stage_tile(tau, B, l0, nl, n0, N, k, SL, s);
      __syncthreads();
    }
    if (k < NST) I = march_up<true>(I, s, nl, p, m, inv_m, W, acc, SL * SP);
    __syncthreads();
    if (valid) {
      for (int row = k; row < nl; row += SL) {
        const float* a = s.acc + row * SL * SP + p;
        float e = 0.0f;
#pragma unroll
        for (int j = 0; j < NST; ++j) e += a[j * SP];
        store_row(M_up + (size_t)(l0 + row) * sN + n, l0 + row, n, e);
      }
    }
  }
}

// ---- the kernels ---------------------------------------------------------

// tau [L, N], B [L+1, N]; out [N] = the top-of-atmosphere flux
template <int NST, bool SPREAD>
__global__ void olr_kernel(const float* __restrict__ tau, const float* __restrict__ B,
                           const Nodes sn, int L, int N, int chunk,
                           float* __restrict__ out) {
  if constexpr (SPREAD) {
    olr_spread<NST>(tau, B, sn, L, N, chunk, out);
  } else {
    olr_point<NST>(tau, B, sn, L, N, out);
  }
}

// monoflux_pallas's contract: M_down row 0 is the beam top c S, rows 1..L
// the down-march emission plus the attenuated beam; M_up row L is pi I_surf
// with I_surf = M_down[L] a / pi + B[L], rows 0..L-1 the up-march emission
template <int NST, bool SPREAD>
__global__ void monoflux_kernel(const float* __restrict__ tau, const float* __restrict__ B,
                                const float* __restrict__ S, const float* __restrict__ albedo,
                                float ctheta, const Nodes sn, int L, int N, int chunk,
                                float* __restrict__ M_up, float* __restrict__ M_down) {
  if constexpr (SPREAD) {
    monoflux_spread<NST>(tau, B, S, albedo, ctheta, sn, L, N, chunk, M_up, M_down);
  } else {
    monoflux_point<NST>(tau, B, S, albedo, ctheta, sn, L, N, chunk, M_up, M_down);
  }
}

// the plan's numbers, checked: threads a block, blocks, dynamic shared bytes
bool plan_ok(int spread, int slices, int P, int chunk, long long smem, int L) {
  if (P < 32 || P % 32 != 0 || smem < 0 || smem > 232448) return false;
  if (spread) return P == SP && slices * P <= 1024 && chunk >= 1;
  return P <= 1024 && chunk >= 0 && chunk <= L;
}

template <class K>
int opt_in(K kernel, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <class K>
int info_of(K kernel, int threads, long long smem, int* info) {
  cudaFuncAttributes a{};
  int per_sm = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, (const void*)kernel);
  if (e == cudaSuccess) e = static_cast<cudaError_t>(opt_in(kernel, smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, (size_t)smem);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = per_sm;
  return (int)e;
}

}  // namespace

extern "C" {

int march_max_streams() { return MAX_STREAMS; }

// m, W: host arrays of nst floats, passed to the kernel by value. The plan
// (rt/march_cuda.py::march_plan): spread, P points a block, chunk (spread:
// the layers a tile stages; else K3's layers kept in shared memory), smem
// the dynamic shared bytes. Returns cudaGetLastError() (0 on success).
int olr_launch(const float* tau, const float* B, const float* m, const float* W, int nst,
               int L, int N, int spread, int P, int chunk, long long smem, float* out,
               void* stream) {
  if (!plan_ok(spread, nst, P, chunk, smem, L)) return static_cast<int>(cudaErrorInvalidValue);
  const Nodes sn = pack_nodes(m, W, nst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (N + P - 1) / P;
  int err = 0;
  const int got = with_streams(nst, [&](auto k) {
    constexpr int NS = decltype(k)::value;
    if (spread) {
      err = opt_in(olr_kernel<NS, true>, smem);
      if (err == 0)
        olr_kernel<NS, true><<<blocks, NS * P, smem, st>>>(tau, B, sn, L, N, chunk, out);
    } else {
      olr_kernel<NS, false><<<blocks, P, 0, st>>>(tau, B, sn, L, N, chunk, out);
    }
  });
  return err != 0 ? err : got;
}

int monoflux_launch(const float* tau, const float* B, const float* S, const float* albedo,
                    float ctheta, const float* m, const float* W, int nst, int L, int N,
                    int spread, int P, int chunk, long long smem, float* M_up, float* M_down,
                    void* stream) {
  if (!plan_ok(spread, nst + 1, P, chunk, smem, L))
    return static_cast<int>(cudaErrorInvalidValue);
  const Nodes sn = pack_nodes(m, W, nst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (N + P - 1) / P;
  int err = 0;
  const int got = with_streams(nst, [&](auto k) {
    constexpr int NS = decltype(k)::value;
    if (spread) {
      err = opt_in(monoflux_kernel<NS, true>, smem);
      if (err == 0)
        monoflux_kernel<NS, true><<<blocks, (NS + 1) * P, smem, st>>>(
            tau, B, S, albedo, ctheta, sn, L, N, chunk, M_up, M_down);
    } else {
      err = opt_in(monoflux_kernel<NS, false>, smem);
      if (err == 0)
        monoflux_kernel<NS, false><<<blocks, P, smem, st>>>(
            tau, B, S, albedo, ctheta, sn, L, N, chunk, M_up, M_down);
    }
  });
  return err != 0 ? err : got;
}

// registers, local (spill) bytes and resident blocks an SM of one instance
// at `threads` threads and `smem` dynamic shared bytes: info[3]
int march_kernel_info(int mono, int spread, int nst, int threads, long long smem, int* info) {
  int err = 0;
  const int got = with_streams(nst, [&](auto k) {
    constexpr int NS = decltype(k)::value;
    if (mono) {
      err = spread ? info_of(monoflux_kernel<NS, true>, threads, smem, info)
                   : info_of(monoflux_kernel<NS, false>, threads, smem, info);
    } else {
      err = spread ? info_of(olr_kernel<NS, true>, threads, smem, info)
                   : info_of(olr_kernel<NS, false>, threads, smem, info);
    }
  });
  return err != 0 ? err : got;
}

}  // extern "C"
