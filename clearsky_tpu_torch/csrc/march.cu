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
// weighted flux rows. Stream slants m and weights W arrive by value. The
// march itself (march_common.cuh) is shared with the fused table kernels.

#include "march_common.cuh"

using namespace clearsky;

namespace {

constexpr int THREADS = 256;

// tau [L, N], B [L+1, N]; out [N] = the top-of-atmosphere flux
template <int NST>
__global__ void olr_kernel(const float* __restrict__ tau,
                           const float* __restrict__ B, Streams sn, int L,
                           int N, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const auto tau_at = [&](int l) { return tau[(size_t)l * N + n]; };
  out[n] = olr_column<NST>(tau_at, B, sn, L, N, n);
}

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
  const auto tau_at = [&](int l) { return tau[(size_t)l * N + n]; };
  monoflux_column<NST>(tau_at, B, S[n], albedo[n], ctheta, sn, L, N, n, M_up, M_down);
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
  return with_streams(nst, [&](auto k) {
    olr_kernel<decltype(k)::value><<<(N + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        tau, B, sn, L, N, out);
  });
}

int monoflux_launch(const float* tau, const float* B, const float* S,
                    const float* albedo, float ctheta, const float* m,
                    const float* W, int nst, int L, int N, float* M_up,
                    float* M_down, void* stream) {
  const Streams sn = pack_streams(m, W, nst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_streams(nst, [&](auto k) {
    monoflux_kernel<decltype(k)::value><<<(N + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        tau, B, S, albedo, ctheta, sn, L, N, M_up, M_down);
  });
}

}  // extern "C"
