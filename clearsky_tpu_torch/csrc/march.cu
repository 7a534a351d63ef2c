// Flux-march kernels (K2, K3): the hemispheric-stream Schwarzschild march of
// the discretized core, one thread per wavenumber point.
//
// Replace clearsky_tpu/rt/march_pallas.py::_olr_kernel (K2, TOA-only upward
// march, wrapper olr_pallas) and ::_march_kernel (K3, down march + stellar
// beam + Lambertian surface + up march, wrapper monoflux_pallas).
//
// What bounds them on the H100: per layer and stream one expf and about
// twenty FP32 operations against 8 bytes read per layer and point (tau and
// one Planck row) and, for K3, 8 bytes written (one M_down and one M_up row).
// At the main path's 2^19 points x 19 layers that is ~80 MB of traffic
// (tens of microseconds at 3.35 TB/s) against ~2e9 FP32 operations, so the
// two are of the same order. The design keeps the march in registers: each
// thread carries its streams' intensities through a runtime loop over the
// layers (no static-unroll cap on the layer count), reads tau and B once
// with neighbouring threads on neighbouring addresses, and writes only the
// weighted flux rows. Stream slants m and weights W arrive by value.
//
// The transmittance triple (t, 1 - t, (1 - t)/tau_m) comes from one expf and
// a 7-term series below tau_m = 0.25 (march_pallas.py::_trans_emit): forming
// 1 - exp(-tau_m) directly cancels catastrophically in f32 for transparent
// layers. Built without --use_fast_math, so expf is the accurate version.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_STREAMS = 8;
constexpr float PI_F = 3.14159265358979324f;
constexpr float INV_PI = 0.318309886183790672f;

struct Streams {
  float m[MAX_STREAMS];  // slant factors 1/cos(theta)
  float W[MAX_STREAMS];  // flux quadrature weights
};

// (t, omt, ratio) = (e^-tm, 1 - e^-tm, (1 - e^-tm)/tm), march_pallas.py:44-81
__device__ __forceinline__ void trans_emit(float tm, float& t, float& omt,
                                           float& ratio) {
  const float e = expf(-tm);
  const float r = 1.0f - tm * (0.5f - tm * ((1.0f / 6.0f) - tm * (
      (1.0f / 24.0f) - tm * ((1.0f / 120.0f) - tm * ((1.0f / 720.0f)
                                                    - tm * (1.0f / 5040.0f))))));
  if (tm < 0.25f) {
    ratio = r;
    omt = tm * r;
  } else {
    omt = 1.0f - e;
    ratio = omt / tm;
  }
  t = 1.0f - omt;
}

// linear-in-tau layer emission, march_pallas.py::_layer_planck
__device__ __forceinline__ float layer_planck(float b1, float b2, float t,
                                              float omt, float ratio) {
  const float dB = b1 - b2;
  return b2 * omt - dB * t + ratio * dB;
}

// one layer for all streams: I <- I t + Be
template <int NST>
__device__ __forceinline__ void march_layer(float (&I)[NST], const Streams& sn,
                                            float tl, float b1, float b2) {
#pragma unroll
  for (int k = 0; k < NST; ++k) {
    float t, omt, ratio;
    trans_emit(tl * sn.m[k], t, omt, ratio);
    I[k] = I[k] * t + layer_planck(b1, b2, t, omt, ratio);
  }
}

template <int NST>
__device__ __forceinline__ float weighted(const float (&I)[NST], const Streams& sn) {
  float e = 0.0f;
#pragma unroll
  for (int k = 0; k < NST; ++k) e += sn.W[k] * I[k];
  return e;
}

// tau [L, N], B [L+1, N] (row 0 = top of atmosphere, row L = surface);
// out [N] = sum_k W_k I_k at the top after marching up from surface Planck
template <int NST>
__global__ void olr_kernel(const float* __restrict__ tau,
                           const float* __restrict__ B, Streams sn, int L,
                           int N, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float I[NST];
  const float bs = B[(size_t)L * N + n];
#pragma unroll
  for (int k = 0; k < NST; ++k) I[k] = bs;
  for (int l = L - 1; l >= 0; --l) {
    march_layer(I, sn, tau[(size_t)l * N + n], B[(size_t)(l + 1) * N + n],
                B[(size_t)l * N + n]);
  }
  out[n] = weighted(I, sn);
}

// monoflux_pallas's contract: M_down row 0 is the beam top c S, rows 1..L the
// down-march emission plus the attenuated beam; M_up row L is pi I_surf with
// I_surf = M_down[L] a / pi + B[L], rows 0..L-1 the up-march emission.
template <int NST>
__global__ void monoflux_kernel(const float* __restrict__ tau,
                                const float* __restrict__ B,
                                const float* __restrict__ S,
                                const float* __restrict__ albedo, float ctheta,
                                Streams sn, int L, int N,
                                float* __restrict__ M_up,
                                float* __restrict__ M_down) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float inv_c = 1.0f / ctheta;
  float I[NST];
#pragma unroll
  for (int k = 0; k < NST; ++k) I[k] = 0.0f;
  float bm = ctheta * S[n];  // direct beam below level 0
  M_down[n] = bm;
  float down = bm;
  for (int l = 0; l < L; ++l) {
    const float tl = tau[(size_t)l * N + n];
    march_layer(I, sn, tl, B[(size_t)l * N + n], B[(size_t)(l + 1) * N + n]);
    bm *= expf(-tl * inv_c);
    down = weighted(I, sn) + bm;
    M_down[(size_t)(l + 1) * N + n] = down;
  }
  const float I_surf = down * (albedo[n] * INV_PI) + B[(size_t)L * N + n];
  M_up[(size_t)L * N + n] = PI_F * I_surf;
#pragma unroll
  for (int k = 0; k < NST; ++k) I[k] = I_surf;
  for (int l = L - 1; l >= 0; --l) {
    march_layer(I, sn, tau[(size_t)l * N + n], B[(size_t)(l + 1) * N + n],
                B[(size_t)l * N + n]);
    M_up[(size_t)l * N + n] = weighted(I, sn);
  }
}

constexpr int THREADS = 256;

Streams pack_streams(const float* m, const float* W, int nst) {
  Streams sn{};
  for (int k = 0; k < nst; ++k) {
    sn.m[k] = m[k];
    sn.W[k] = W[k];
  }
  return sn;
}

template <int NST>
void launch_olr(const float* tau, const float* B, const Streams& sn, int L,
                int N, float* out, cudaStream_t st) {
  olr_kernel<NST><<<(N + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      tau, B, sn, L, N, out);
}

template <int NST>
void launch_monoflux(const float* tau, const float* B, const float* S,
                     const float* a, float ctheta, const Streams& sn, int L,
                     int N, float* M_up, float* M_down, cudaStream_t st) {
  monoflux_kernel<NST><<<(N + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      tau, B, S, a, ctheta, sn, L, N, M_up, M_down);
}

}  // namespace

extern "C" {

int march_max_streams() { return MAX_STREAMS; }

// m, W: host arrays of nst floats, passed to the kernel by value.
// Returns cudaGetLastError() (0 on success).
int olr_launch(const float* tau, const float* B, const float* m,
               const float* W, int nst, int L, int N, float* out,
               void* stream) {
  const Streams sn = pack_streams(m, W, nst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nst) {
    case 1: launch_olr<1>(tau, B, sn, L, N, out, st); break;
    case 2: launch_olr<2>(tau, B, sn, L, N, out, st); break;
    case 3: launch_olr<3>(tau, B, sn, L, N, out, st); break;
    case 4: launch_olr<4>(tau, B, sn, L, N, out, st); break;
    case 5: launch_olr<5>(tau, B, sn, L, N, out, st); break;
    case 6: launch_olr<6>(tau, B, sn, L, N, out, st); break;
    case 7: launch_olr<7>(tau, B, sn, L, N, out, st); break;
    case 8: launch_olr<8>(tau, B, sn, L, N, out, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int monoflux_launch(const float* tau, const float* B, const float* S,
                    const float* albedo, float ctheta, const float* m,
                    const float* W, int nst, int L, int N, float* M_up,
                    float* M_down, void* stream) {
  const Streams sn = pack_streams(m, W, nst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nst) {
    case 1: launch_monoflux<1>(tau, B, S, albedo, ctheta, sn, L, N, M_up, M_down, st); break;
    case 2: launch_monoflux<2>(tau, B, S, albedo, ctheta, sn, L, N, M_up, M_down, st); break;
    case 3: launch_monoflux<3>(tau, B, S, albedo, ctheta, sn, L, N, M_up, M_down, st); break;
    case 4: launch_monoflux<4>(tau, B, S, albedo, ctheta, sn, L, N, M_up, M_down, st); break;
    case 5: launch_monoflux<5>(tau, B, S, albedo, ctheta, sn, L, N, M_up, M_down, st); break;
    case 6: launch_monoflux<6>(tau, B, S, albedo, ctheta, sn, L, N, M_up, M_down, st); break;
    case 7: launch_monoflux<7>(tau, B, S, albedo, ctheta, sn, L, N, M_up, M_down, st); break;
    case 8: launch_monoflux<8>(tau, B, S, albedo, ctheta, sn, L, N, M_up, M_down, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
