// Fused table kernels (K6, K7): split-precision Chebyshev coefficients ->
// ln sigma -> sigma -> Lobatto layer tau -> flux march.
//
// Replace clearsky_tpu/rt/fused_table.py::_fused_kernel (K6, with
// _tau_in_kernel; TOA-only upward march, wrapper _fused_call) and
// ::_fused_mono_kernel (K7; tau out + down march + stellar beam + Lambertian
// surface + up march, wrapper _fused_mono_call).
//
// Per point n and Lobatto node j (L layers of k nodes, j = l k + jj):
//   ln_j = sum_c bl[j, c] lead[c, n] + sum_c bt[j, c] tail[c, n]
//          (K float32 lead rows; T bfloat16 tail rows and basis, widened
//          exactly, so the products are exact in float32)
//   tau_l = sum_jj wq[l, jj] expf(ln_{l k + jj})
// and tau marches as in march.cu (march_common.cuh).
//
// What bounds them on the H100: at the OLR shape (57 nodes, 288 coefficients,
// 2^19 points) the contraction is 8.6e9 FMAs, 0.26 ms at the 67 TFLOP/s of
// FP32 outside the tensor cores, while the split coefficients are 304 MiB,
// 0.1 ms at 3.35 TB/s, read once. So arithmetic and the loads that feed it
// bound the kernel, not one pass over the bytes. Design:
// - A block takes BP = 128 points. Its threads copy the points' 608
//   coefficient bytes each into shared memory once, by 16-byte asynchronous
//   copies (cp.async) with many in flight, so no coefficient is read from
//   device memory twice. Two blocks fit an SM (87 KB of shared memory each
//   at 19 layers, registers capped by the launch bounds), so one block's
//   copies overlap the other's arithmetic.
// - The quadrature matrix is block-diagonal by construction (layer l uses
//   only its own k nodes), so the nodes go in groups of whole layers: a
//   group is lpg = NG / k layers, its NG basis columns zero past lpg k. One
//   warp runs one group for all BP points, each thread PPT = 4 neighbouring
//   points: per coefficient two broadcast float4 loads of the group's basis
//   row, one vector load of the thread's 4 coefficients and 32 FMAs into
//   registers (lead and tail sums apart, as the plain version adds two
//   products). A layer's tau is then formed by the one thread that owns it,
//   in shared memory, without atomics. The dense [L, nnode] matrix of the
//   TPU kernel is not formed.
// - After a barrier the block's threads march their points, one each,
//   reading tau from shared memory.
// - Built without --use_fast_math: expf is the accurate one.
// The tensor cores (mma on the bfloat16 tail) are left for later work.

#include <cuda_bf16.h>

#include <cstdint>

#include "march_common.cuh"

using namespace clearsky;

namespace {

constexpr int BP = 128;        // points per block
constexpr int PPT = 4;         // points per thread in the contraction
constexpr int NG = 8;          // basis columns (nodes) per group
constexpr int MAX_WARPS = 10;  // groups run at once in a block (19 layers of 3)
constexpr size_t MAX_SMEM = 232448;  // a block's shared-memory limit on sm_90
static_assert(32 * PPT == BP, "a warp covers the block's points");

size_t smem_bytes(int K, int T, int L) {
  return (size_t)BP * (4 * (size_t)K + 4 * (size_t)L + 2 * (size_t)T);
}

struct Smem {
  float* lead;           // [K][BP]
  float* tau;            // [L][BP]
  __nv_bfloat16* tail;   // [T][BP]
};

__device__ __forceinline__ Smem carve(unsigned char* base, int K, int L) {
  Smem s;
  s.lead = reinterpret_cast<float*>(base);
  s.tau = s.lead + (size_t)K * BP;
  s.tail = reinterpret_cast<__nv_bfloat16*>(s.tau + (size_t)L * BP);
  return s;
}

// acc[q][i] += row[q] v[i]: the group's NG basis values of one coefficient
// (the same address for the whole warp: a broadcast read) times the
// coefficient at the thread's PPT points
__device__ __forceinline__ void accumulate(float (&acc)[NG][PPT], const float (&v)[PPT],
                                           const float* __restrict__ row) {
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(row));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
  const float b[NG] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int q = 0; q < NG; ++q) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) acc[q][i] = fmaf(b[q], v[i], acc[q][i]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Stage the block's coefficient columns, zero past N, and clear tau. With
// vec (N a multiple of 8, both rows 16-byte aligned) each thread keeps many
// 16-byte asynchronous copies in flight: staging is bandwidth-bound only if
// enough bytes are in flight per SM, which 2-byte loads one at a time are
// not. Otherwise one element per load.
__device__ __forceinline__ void stage(const float* __restrict__ lead,
                                      const __nv_bfloat16* __restrict__ tail,
                                      int K, int T, int L, int N, int n0, bool vec,
                                      const Smem& s) {
  if (vec) {
    constexpr int LC = BP / 4, TC = BP / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < K * LC; i += blockDim.x) {
      const int r = i / LC, p = 4 * (i % LC);
      float* dst = s.lead + (size_t)r * BP + p;
      if (n0 + p < N) {
        cp_async16(dst, lead + (size_t)r * N + n0 + p);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    for (int i = threadIdx.x; i < T * TC; i += blockDim.x) {
      const int r = i / TC, p = 8 * (i % TC);
      __nv_bfloat16* dst = s.tail + (size_t)r * BP + p;
      if (n0 + p < N) {
        cp_async16(dst, tail + (size_t)r * N + n0 + p);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < K * BP; i += blockDim.x) {
      const int n = n0 + i % BP;
      s.lead[i] = n < N ? lead[(size_t)(i / BP) * N + n] : 0.0f;
    }
    for (int i = threadIdx.x; i < T * BP; i += blockDim.x) {
      const int n = n0 + i % BP;
      s.tail[i] = n < N ? tail[(size_t)(i / BP) * N + n] : zero;
    }
  }
  for (int i = threadIdx.x; i < L * BP; i += blockDim.x) s.tau[i] = 0.0f;
}

// tau of group g's layers (l0 = g lpg, ..., at most L - 1) at the thread's
// points 4 lane .. 4 lane + 3. basis is [K + T][ngroups][NG]; wq is [L, k].
__device__ __forceinline__ void group_tau(const float* __restrict__ basis,
                                          const float* __restrict__ wq, int K,
                                          int T, int L, int k, int lpg,
                                          int ngroups, int g, const Smem& s) {
  const int p0 = PPT * (threadIdx.x & 31);
  float ls[NG][PPT], ts[NG][PPT];
#pragma unroll
  for (int q = 0; q < NG; ++q) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) ls[q][i] = ts[q][i] = 0.0f;
  }
  const size_t stride = (size_t)ngroups * NG;
  const float* row = basis + (size_t)g * NG;
  for (int c = 0; c < K; ++c, row += stride) {
    const float4 x = *reinterpret_cast<const float4*>(s.lead + (size_t)c * BP + p0);
    const float v[PPT] = {x.x, x.y, x.z, x.w};
    accumulate(ls, v, row);
  }
  for (int c = 0; c < T; ++c, row += stride) {
    const uint2 raw = *reinterpret_cast<const uint2*>(s.tail + (size_t)c * BP + p0);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    const float v[PPT] = {a.x, a.y, b.x, b.y};
    accumulate(ts, v, row);
  }
  const int l0 = g * lpg;
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int l = l0 + q / k;
    if (q < lpg * k && l < L) {
      const float w = wq[(size_t)l0 * k + q];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        s.tau[(size_t)l * BP + p0 + i] += w * expf(ls[q][i] + ts[q][i]);
      }
    }
  }
}

// The block's layer tau into shared memory: stage, every group, barrier.
__device__ __forceinline__ Smem block_tau(
    unsigned char* smem, const float* __restrict__ lead,
    const __nv_bfloat16* __restrict__ tail, const float* __restrict__ basis,
    const float* __restrict__ wq, int K, int T, int L, int k, int lpg,
    int ngroups, int N, int n0, bool vec) {
  const Smem s = carve(smem, K, L);
  stage(lead, tail, K, T, L, N, n0, vec, s);
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  for (int g = threadIdx.x >> 5; g < ngroups; g += nwarps) {
    group_tau(basis, wq, K, T, L, k, lpg, ngroups, g, s);
  }
  __syncthreads();
  return s;
}

template <int NST>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2) fused_olr_kernel(
    const float* __restrict__ lead, const __nv_bfloat16* __restrict__ tail,
    const float* __restrict__ basis, const float* __restrict__ wq,
    const float* __restrict__ B, Streams sn, int K, int T, int L, int k,
    int lpg, int ngroups, int N, bool vec, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * BP;
  const Smem s = block_tau(smem, lead, tail, basis, wq, K, T, L, k, lpg, ngroups, N, n0, vec);
  for (int p = threadIdx.x; p < BP && n0 + p < N; p += blockDim.x) {
    const auto tau_at = [&](int l) { return s.tau[(size_t)l * BP + p]; };
    out[n0 + p] = olr_column<NST>(tau_at, B, sn, L, N, n0 + p);
  }
}

template <int NST>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2) fused_monoflux_kernel(
    const float* __restrict__ lead, const __nv_bfloat16* __restrict__ tail,
    const float* __restrict__ basis, const float* __restrict__ wq,
    const float* __restrict__ B, const float* __restrict__ S,
    const float* __restrict__ albedo, float ctheta, Streams sn, int K, int T,
    int L, int k, int lpg, int ngroups, int N, bool vec, float* __restrict__ tau_out,
    float* __restrict__ M_up, float* __restrict__ M_down) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * BP;
  const Smem s = block_tau(smem, lead, tail, basis, wq, K, T, L, k, lpg, ngroups, N, n0, vec);
  for (int p = threadIdx.x; p < BP && n0 + p < N; p += blockDim.x) {
    const int n = n0 + p;
    for (int l = 0; l < L; ++l) tau_out[(size_t)l * N + n] = s.tau[(size_t)l * BP + p];
    const auto tau_at = [&](int l) { return s.tau[(size_t)l * BP + p]; };
    monoflux_column<NST>(tau_at, B, S[n], albedo[n], ctheta, sn, L, N, n, M_up, M_down);
  }
}

bool bad_shape(int K, int T, int L, int k, int lpg, int ngroups, int N) {
  return K < 1 || T < 1 || L < 1 || k < 1 || k > NG || N < 1 || lpg != NG / k ||
         ngroups != (L + lpg - 1) / lpg || smem_bytes(K, T, L) > MAX_SMEM;
}

bool vectorizable(const void* lead, const void* tail, int N) {
  return N % 8 == 0 && reinterpret_cast<uintptr_t>(lead) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(tail) % 16 == 0;
}

template <class Kernel, class... Args>
void launch(Kernel kern, int K, int T, int L, int ngroups, int N, cudaStream_t st,
            Args... args) {
  const size_t bytes = smem_bytes(K, T, L);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess) {
    return;  // the error stays for cudaGetLastError
  }
  const int warps = ngroups < MAX_WARPS ? ngroups : MAX_WARPS;
  kern<<<(N + BP - 1) / BP, 32 * warps, bytes, st>>>(args...);
}

}  // namespace

extern "C" {

int fused_max_streams() { return MAX_STREAMS; }
int fused_nodes_per_group() { return NG; }
long long fused_smem_bytes(int K, int T, int L) { return (long long)smem_bytes(K, T, L); }

// lead [K, N] f32, tail [T, N] bf16, basis [K + T, ngroups, NG] f32 (group g
// holds the nodes of layers g lpg .. g lpg + lpg - 1, lpg = NG / k, zero
// past them), wq [L, k] f32, B [L+1, N] f32; m, W: host arrays of nst
// floats. out [N]. Returns cudaGetLastError() (0 on success).
int fused_olr_launch(const float* lead, const void* tail, const float* basis,
                     const float* wq, const float* B, const float* m,
                     const float* W, int nst, int K, int T, int L, int k,
                     int lpg, int ngroups, int N, float* out, void* stream) {
  if (bad_shape(K, T, L, k, lpg, ngroups, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Streams sn = pack_streams(m, W, nst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* tl = static_cast<const __nv_bfloat16*>(tail);
  return with_streams(nst, [&](auto s) {
    launch(fused_olr_kernel<decltype(s)::value>, K, T, L, ngroups, N, st, lead, tl, basis,
           wq, B, sn, K, T, L, k, lpg, ngroups, N, vectorizable(lead, tail, N), out);
  });
}

// as fused_olr_launch, plus S, albedo [N] and cos(stellar zenith) ctheta;
// tau_out [L, N], M_up and M_down [L+1, N].
int fused_monoflux_launch(const float* lead, const void* tail,
                          const float* basis, const float* wq, const float* B,
                          const float* S, const float* albedo, float ctheta,
                          const float* m, const float* W, int nst, int K,
                          int T, int L, int k, int lpg, int ngroups, int N,
                          float* tau_out, float* M_up, float* M_down,
                          void* stream) {
  if (bad_shape(K, T, L, k, lpg, ngroups, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Streams sn = pack_streams(m, W, nst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* tl = static_cast<const __nv_bfloat16*>(tail);
  return with_streams(nst, [&](auto s) {
    launch(fused_monoflux_kernel<decltype(s)::value>, K, T, L, ngroups, N, st, lead, tl,
           basis, wq, B, S, albedo, ctheta, sn, K, T, L, k, lpg, ngroups, N,
           vectorizable(lead, tail, N), tau_out, M_up, M_down);
  });
}

}  // extern "C"
