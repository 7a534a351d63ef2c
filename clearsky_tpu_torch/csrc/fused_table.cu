// Fused table kernels (K6, K7): split-precision Chebyshev coefficients ->
// ln sigma -> sigma -> Lobatto layer tau -> flux march.
//
// Replace clearsky_tpu/rt/fused_table.py::_fused_kernel (K6, with
// _tau_in_kernel; TOA-only upward march, wrapper _fused_call) and
// ::_fused_mono_kernel (K7; tau out + down march + stellar beam + Lambertian
// surface + up march, wrapper _fused_mono_call).
//
// Per point n and Lobatto node j (L layers of k nodes, j = l k + jj):
//   ln_j = sum_c bt[j, c] tail[c, n] + sum_c bl[j, c] lead[c, n]
//          (T bfloat16 tail rows against the bfloat16 tail basis, products
//          exact in float32; K float32 lead rows against the float32 lead
//          basis)
//   tau_l = sum_jj wq[l, jj] expf(ln_{l k + jj})
// and tau marches as in march.cu (march_common.cuh).
//
// What bounds them on the H100: at the OLR shape (57 nodes, 16 lead and 272
// tail rows, 2^19 points) the coefficients are 319 MB, read once, and the
// kernel moves ~363 MB (K7 ~489 MB with tau and both flux packs): 0.108 ms
// (0.146 ms) at 3.35 TB/s. The tail's 8.4e9 products are 17 us at the
// tensor cores' dense bfloat16 rate; the lead's 0.5e9 FP32 FMAs, the
// exponentials and the march fit beside the bytes. So the design keeps the
// memory system busy and the arithmetic off the FP32 pipes. (Measured, the
// kernels run at ~2.5x the byte bound: the march, one thread a point, and
// the phases of each tile, not the loads, hold them there; PERF.md, PR 9.)
// - The tail runs on the tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32
//   with nodes as rows (M, a pass of NODE_TILE = 64 nodes: 4 m16 tiles, zero
//   basis rows past the last node) and points as columns (N, 32 a warp: 4
//   n8 tiles). A small launch first gathers bl and bt into each chunk's
//   basis as the threads read it (fused_basis_kernel: the A fragments, 16
//   bytes a thread); the coefficient fragments come by ldmatrix.trans from the
//   [row][point] stage, whose rows are padded by 16 bytes so that
//   ldmatrix's eight rows fall on distinct banks. mma.sync, not wgmma: the
//   64-node tile is one warpgroup's M, but the lead's FP32 FMAs must land in
//   the accumulator elements each thread holds, which mma.sync's small
//   fragments make plain, and the tensor work is a sixth of the byte bound
//   either way.
// - The lead stays in true FP32: after the tail's MMAs, each thread adds
//   bl[j, c] lead[c, n] by fmaf into the accumulator elements it holds (the
//   JAX kernel's Precision.HIGHEST lead; never TF32, never bfloat16).
// - Coefficients stream through a ring of STAGES chunks (16 tail rows or 8
//   lead rows of the tile's 128 points, each with its 2 KB of basis) filled
//   by 16-byte cp.async copies: the copies of chunks c+1 and c+2 overlap the
//   MMAs on chunk c, and the basis reaches the MMAs from shared memory, not
//   through L1 (which the blocks' shared memory leaves small).
//   Blocks are persistent (the occupancy API's blocks an SM x the SMs), walk
//   over point tiles, and prefetch the next tile's chunks during this tile's
//   epilogue. Shared memory is the ring, half a node pass of sigma and the
//   tile's tau and Planck rows: it grows with L, not with K + T (~56 KB at
//   19 layers: 4 blocks, 16 of 64 warps an SM, at most 128 registers).
// - Epilogue on every thread: each accumulator element becomes
//   wq_j expf(ln_j) (the accurate expf) in shared memory, half a pass at a
//   time; thread p sums its point's nodes into tau[l][p] in node order (no
//   atomics), and marches point p, with B (and K7's S and albedo) staged by
//   cp.async during the tile's chunks. K7 writes tau, M_up and M_down
//   coalesced.
// - The chunks keep a block barrier each: without it the warps of a block
//   drift apart and read the same rows at different times, which was slower
//   on the card (PERF.md, PR 9).
// - Every sum has a fixed order, so two launches agree bit for bit.
// - Built without --use_fast_math.

#include <cuda_bf16.h>

#include <cstdint>

#include "march_common.cuh"

using namespace clearsky;

namespace {

constexpr int BP = 128;                  // points per tile
constexpr int WARPS = 4;                 // a warp: 32 points of the tile
constexpr int THREADS = 32 * WARPS;      // a thread: one point in the march
constexpr int NODE_TILE = 64;            // nodes per pass
constexpr int MT = NODE_TILE / 16;       // m16 tiles per pass
constexpr int NT = 32 / 8;               // n8 tiles per warp
constexpr int KSTEP = 16;                // tail rows per chunk (the mma's k)
constexpr int LCHUNK = 8;                // lead rows per chunk
constexpr int STAGES = 3;                // chunks in the ring
constexpr int MAX_NODES_PER_LAYER = 8;   // the route gate's Lobatto bound
constexpr int TAIL_ROW = 2 * BP + 16;    // bytes of a staged tail row
constexpr int LEAD_ROW = 4 * BP + 16;    // bytes of a staged lead row
constexpr int BASIS_OFF = KSTEP * TAIL_ROW;  // the chunk's basis after its rows
constexpr int BASIS_BYTES = MT * 32 * 16;    // 16 bytes a thread
constexpr int STAGE_BYTES = BASIS_OFF + BASIS_BYTES;
constexpr int SIG_NODES = NODE_TILE / 2; // nodes of sigma in shared memory at once
constexpr int SIG_ROW = BP + 4;          // floats of a sigma row
constexpr int BLOCKS_PER_SM = 4;         // the design's residency at 19 layers
constexpr size_t MAX_SMEM = 232448;      // a block's shared-memory limit on sm_90
constexpr int MAX_LAYERS_CACHED = 255;   // layer counts whose residency is kept
static_assert(LCHUNK * LEAD_ROW <= BASIS_OFF, "a lead chunk fits a stage");
static_assert(BASIS_BYTES == THREADS * 16 && LCHUNK * 8 * 2 * MT * 4 == BASIS_BYTES,
              "a chunk's basis is 16 bytes a thread");
static_assert(WARPS * 32 == BP && THREADS == BP, "a warp covers 32 points, a thread one");
static_assert(THREADS * 2 * 16 == KSTEP * 2 * BP && THREADS * 2 * 16 == LCHUNK * 4 * BP,
              "a chunk is two 16-byte pieces a thread");

// the ring, half a pass of sigma [SIG_NODES][SIG_ROW], tau [L][BP] and the
// staged rows [L + 1 (+ 2 for S and albedo)][BP]
size_t smem_bytes(int L, bool mono) {
  return (size_t)STAGES * STAGE_BYTES + (size_t)SIG_NODES * SIG_ROW * 4 +
         (size_t)BP * 4 * (2 * (size_t)L + 1 + (mono ? 2 : 0));
}

struct Fused {
  const float* lead;            // [K, N]
  const uint16_t* tail;         // [T, N] bfloat16 bits
  const float* bl;              // [L k, K] the lead basis
  const uint16_t* bt;           // [L k, T] the tail basis, bfloat16 bits
  const uint4* pack;            // [npass][kt + kl][THREADS]: the basis as staged
  const float* wq;              // [L k]
  const float* B;               // [L + 1, N]
  const float* S;               // [N] (K7)
  const float* albedo;          // [N] (K7)
  float ctheta;
  int K, T, L, k, J, N, npass, kt, kl, ntiles;
  bool vec;                     // 16-byte copies (N % 8 == 0, aligned rows)
  float* out;                   // [N] (K6)
  float* tau_out;               // [L, N] (K7)
  float* M_up;                  // [L + 1, N] (K7)
  float* M_down;                // [L + 1, N] (K7)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// four 8x8 bfloat16 matrices, transposed: r_i from the rows whose addresses
// lanes 8i..8i+7 give
__device__ __forceinline__ void ldsm_x4_trans(const void* row, unsigned& r0, unsigned& r1,
                                              unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(row))
               : "memory");
}

// d += a b on the tensor cores: a 16x16 bfloat16 (row), b 16x8 (col), f32 d
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// 16 bytes of chunk c's basis for thread tid, gathered from bl and bt in the
// order the kernel reads them, zero past the nodes, T and K. A tail chunk
// holds each m16 tile's A fragments: thread 32m + lane (g = lane / 4,
// t = lane % 4) the bfloat16 pairs bt[n, 2t..2t+1], bt[n+8, 2t..],
// bt[n, 2t+8..], bt[n+8, 2t+8..] of node n = 64 pass + 16m + g and columns
// from 16c (mma.m16n8k16's row-major A). A lead chunk holds for its 8 rows
// r and lane groups g the 8 node values bl[64 pass + 16m + 8h + g, 8lc + r]
// at [r][g][2m + h], thread i the four at float 4i.
__device__ __forceinline__ uint4 basis_piece(const Fused& f, int pass, int c, int tid) {
  unsigned w[4];
  if (c < f.kt) {
    const int m = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int node = pass * NODE_TILE + 16 * m + g + 8 * (i & 1);
      const int col = c * KSTEP + 2 * t + 8 * (i >> 1);
      const bool in = node < f.J && col < f.T;
      const uint16_t* src = f.bt + (size_t)node * f.T + col;
      w[i] = (in ? unsigned(src[0]) : 0u) | (in && col + 1 < f.T ? unsigned(src[1]) << 16 : 0u);
    }
  } else {
    const int g = (tid >> 1) & 7, col = (c - f.kt) * LCHUNK + (tid >> 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mh = 4 * (tid & 1) + i;
      const int node = pass * NODE_TILE + 16 * (mh >> 1) + 8 * (mh & 1) + g;
      w[i] = node < f.J && col < f.K ? __float_as_uint(f.bl[(size_t)node * f.K + col]) : 0u;
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The basis of every chunk of every pass, in the order the ring stages it
// (block (c, pass), 16 bytes a thread): one small launch before K6/K7, so
// that each chunk's basis is one 16-byte copy a thread.
__global__ void __launch_bounds__(THREADS) fused_basis_kernel(const Fused f, uint4* pack) {
  const int c = blockIdx.x, pass = blockIdx.y;
  pack[((size_t)pass * (f.kt + f.kl) + c) * THREADS + threadIdx.x] =
      basis_piece(f, pass, c, threadIdx.x);
}

// Copy chunk c of node pass `pass` of the point tile at n0 into a ring
// stage: tail rows 16c..16c+15 (c < kt) or lead rows 8(c - kt).. as
// [row][point], zero past T, K and N, and after them the chunk's 2 KB of
// basis. Each thread copies two 16-byte pieces of rows, the same two places
// of every chunk, neighbouring threads neighbouring pieces of a row (whole
// 256- and 512-byte rows a half-warp and a warp), asynchronously where vec,
// else element by element; and 16 bytes of the basis.
__device__ __forceinline__ void issue_chunk(const Fused& f, unsigned char* stage, int n0,
                                            int pass, int c) {
  cp_async16(stage + BASIS_OFF + 16 * threadIdx.x,
             f.pack + ((size_t)pass * (f.kt + f.kl) + c) * THREADS + threadIdx.x);
  if (c < f.kt) {
    const int r = threadIdx.x >> 4, j = threadIdx.x & 15, n = n0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h, row = c * KSTEP + rr;
      uint4* dst = reinterpret_cast<uint4*>(stage + rr * TAIL_ROW) + j;
      const uint16_t* src = f.tail + (size_t)row * f.N + n;
      if (row < f.T && n < f.N && f.vec) {
        cp_async16(dst, src);
      } else if (row < f.T && n < f.N) {
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (n + e < f.N) w[e >> 1] |= unsigned(src[e]) << (16 * (e & 1));
        }
        *dst = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        *dst = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    const int r = threadIdx.x >> 5, j = threadIdx.x & 31, n = n0 + 4 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 4 * h, row = (c - f.kt) * LCHUNK + rr;
      float4* dst = reinterpret_cast<float4*>(stage + rr * LEAD_ROW) + j;
      const float* src = f.lead + (size_t)row * f.N + n;
      if (row < f.K && n < f.N && f.vec) {
        cp_async16(dst, src);
      } else if (row < f.K && n < f.N) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = n + e < f.N ? src[e] : 0.0f;
        *dst = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        *dst = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
}

// Stage the tile's Planck rows (and K7's S and albedo rows) as [row][BP];
// points past N are never read.
template <bool MONO>
__device__ __forceinline__ void issue_rows(const Fused& f, float* rows, int tile) {
  constexpr int PIECES = BP / 4;
  const int n0 = tile * BP, R = f.L + 1 + (MONO ? 2 : 0);
  for (int i = threadIdx.x; i < R * PIECES; i += THREADS) {
    const int r = i / PIECES, n = n0 + 4 * (i % PIECES);
    if (n >= f.N) continue;
    const float* src = r <= f.L ? f.B + (size_t)r * f.N : (r == f.L + 1 ? f.S : f.albedo);
    float* dst = rows + r * BP + 4 * (i % PIECES);
    if (f.vec) {
      cp_async16(dst, src + n);
    } else {
      for (int e = 0; e < 4 && n + e < f.N; ++e) dst[e] = src[n + e];
    }
  }
}

// The tail chunk's MMAs: acc[m][t] (nodes 16m.. of the pass, points 8t.. of
// the warp's 32) += basis rows x chunk. mt: the pass's m16 tiles that hold
// nodes.
__device__ __forceinline__ void tail_chunk(const unsigned char* stage, int mt,
                                           float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned b[NT][2];
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int x = 0; x < NT / 2; ++x) {
    const unsigned char* row = stage + ((mat & 1) * 8 + r) * TAIL_ROW +
                               2 * (warp * 32 + 8 * (2 * x + (mat >> 1)));
    ldsm_x4_trans(row, b[2 * x][0], b[2 * x][1], b[2 * x + 1][0], b[2 * x + 1][1]);
  }
  const uint4* a = reinterpret_cast<const uint4*>(stage + BASIS_OFF) + lane;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < mt) {
      const uint4 av = a[m * 32];
#pragma unroll
      for (int t = 0; t < NT; ++t) mma_bf16(acc[m][t], av, b[t][0], b[t][1]);
    }
  }
}

// The lead chunk in FP32 FMAs into the same accumulator elements: the thread
// holds nodes 16m + 8h + g (g = lane / 4) at points 8t + 2(lane % 4) + e, in
// acc[m][t][2h + e]; the stage's basis gives its 8 node values of each
// lead row.
__device__ __forceinline__ void lead_chunk(const unsigned char* stage, int mt,
                                           float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* bl = reinterpret_cast<const float*>(stage + BASIS_OFF) + (lane >> 2) * 8;
#pragma unroll
  for (int r = 0; r < LCHUNK; ++r) {
    const float4 w0 = *reinterpret_cast<const float4*>(bl + r * 64);
    const float4 w1 = *reinterpret_cast<const float4*>(bl + r * 64 + 4);
    const float w[2 * MT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float* row =
        reinterpret_cast<const float*>(stage + r * LEAD_ROW) + warp * 32 + 2 * (lane & 3);
    float2 x[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) x[t] = *reinterpret_cast<const float2*>(row + 8 * t);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mt) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[m][t][2 * h] = fmaf(w[2 * m + h], x[t].x, acc[m][t][2 * h]);
            acc[m][t][2 * h + 1] = fmaf(w[2 * m + h], x[t].y, acc[m][t][2 * h + 1]);
          }
        }
      }
    }
  }
}

// The pass's wq_j expf(ln_j) summed into tau[l][p] in node order, half a
// pass (SIG_NODES nodes, two m16 tiles) at a time: each thread writes its
// accumulators' terms into sig, then (after a barrier) thread p adds its
// point's, and a second barrier frees sig for the next half.
__device__ __forceinline__ void pass_tau(const Fused& f, int pass, int mt,
                                         const float (&acc)[MT][NT][4], float* sig, float* tau) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, p = threadIdx.x;
  const int j0 = pass * NODE_TILE, j1 = min(f.J, j0 + NODE_TILE);
  // a layer cut by the pass boundary goes on from its stored partial sum
  int l = j0 / f.k, jj = j0 - l * f.k;
  float run = jj == 0 ? 0.0f : tau[l * BP + p];
#pragma unroll
  for (int half = 0; half < MT / 2; ++half) {
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
      const int m = 2 * half + mm;
      if (m < mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int jl = 16 * mm + 8 * h + (lane >> 2);
          const int j = j0 + SIG_NODES * half + jl;
          if (j < f.J) {
            const float w = __ldg(f.wq + j);
            float* row = sig + jl * SIG_ROW + warp * 32 + 2 * (lane & 3);
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              *reinterpret_cast<float2*>(row + 8 * t) =
                  make_float2(w * expf(acc[m][t][2 * h]), w * expf(acc[m][t][2 * h + 1]));
            }
          }
        }
      }
    }
    __syncthreads();
    const int ja = j0 + SIG_NODES * half, jb = min(j1, ja + SIG_NODES);
    for (int j = ja; j < jb; ++j) {
      const float v = sig[(j - ja) * SIG_ROW + p];
      run = jj == 0 ? v : run + v;
      if (++jj == f.k || j == j1 - 1) tau[l * BP + p] = run;
      if (jj == f.k) {
        jj = 0;
        ++l;
      }
    }
    __syncthreads();
  }
}

// A chunk's place: the block's tile, the node pass, the chunk of the pass.
struct Place {
  int tile, pass, c;
  // the next chunk of the block (tiles gridDim.x apart)
  __device__ __forceinline__ void advance(const Fused& f) {
    if (++c == f.kt + f.kl) {
      c = 0;
      if (++pass == f.npass) {
        pass = 0;
        tile += gridDim.x;
      }
    }
  }
};

// One block: its point tiles blockIdx.x, blockIdx.x + gridDim.x, ..., each
// as npass passes of kt tail and kl lead chunks through the ring; the
// chunk being issued runs STAGES - 1 ahead of the one computed.
template <int NST, bool MONO>
__device__ __forceinline__ void fused_body(const Fused& f, const Streams& sn) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* sig = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  float* tau = sig + SIG_NODES * SIG_ROW;
  float* rows = tau + (size_t)f.L * BP;
  Place at{(int)blockIdx.x, 0, 0}, next = at;
  issue_rows<MONO>(f, rows, at.tile);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (next.tile < f.ntiles) {
      issue_chunk(f, ring + s * STAGE_BYTES, next.tile * BP, next.pass, next.c);
    }
    cp_commit();
    next.advance(f);
  }
  float acc[MT][NT][4];
  for (int q = 0; at.tile < f.ntiles; ++q, at.advance(f)) {
    cp_wait<STAGES - 2>();  // chunk q (and the rows issued with it) landed
    __syncthreads();        // for every thread; and chunk q - 1's stage is free
    if (next.tile < f.ntiles) {
      issue_chunk(f, ring + ((q + STAGES - 1) % STAGES) * STAGE_BYTES, next.tile * BP,
                  next.pass, next.c);
    }
    cp_commit();
    next.advance(f);
    const int pass = at.pass, c = at.c;
    const int mt = min(MT, (f.J - pass * NODE_TILE + 15) / 16);
    const unsigned char* stage = ring + (q % STAGES) * STAGE_BYTES;
    if (c == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.0f;
    }
    if (c < f.kt) {
      tail_chunk(stage, mt, acc);
    } else {
      lead_chunk(stage, mt, acc);
    }
    if (c != f.kt + f.kl - 1) continue;
    pass_tau(f, pass, mt, acc, sig, tau);
    if (pass != f.npass - 1) continue;
    // the tile's tau is whole (each thread's own column): march point p
    if (f.npass * (f.kt + f.kl) < STAGES) {  // the rows came with a group not yet waited for
      cp_wait_all();
      __syncthreads();
    }
    const int p = threadIdx.x, n = at.tile * BP + p;
    if (n < f.N) {
      const auto tau_at = [&](int l) { return tau[l * BP + p]; };
      const auto b_at = [&](int l) { return rows[l * BP + p]; };
      if constexpr (MONO) {
        for (int l = 0; l < f.L; ++l) f.tau_out[(size_t)l * f.N + n] = tau[l * BP + p];
        monoflux_column_at<NST>(
            tau_at, b_at, rows[(f.L + 1) * BP + p], rows[(f.L + 2) * BP + p], f.ctheta, sn,
            f.L, [&](int l, float v) { f.M_down[(size_t)l * f.N + n] = v; },
            [&](int l, float v) { f.M_up[(size_t)l * f.N + n] = v; });
      } else {
        f.out[n] = olr_column_at<NST>(tau_at, b_at, sn, f.L);
      }
    }
    __syncthreads();  // every thread is done with the rows
    if (at.tile + (int)gridDim.x < f.ntiles) issue_rows<MONO>(f, rows, at.tile + gridDim.x);
  }
}

template <int NST>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    fused_olr_kernel(const Fused f, const Streams sn) {
  fused_body<NST, false>(f, sn);
}

template <int NST>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    fused_monoflux_kernel(const Fused f, const Streams sn) {
  fused_body<NST, true>(f, sn);
}

// fills f's derived counts; false for a shape the kernels do not take
bool shape(Fused& f, int K, int T, int L, int k, int N, bool mono) {
  if (K < 1 || T < 1 || L < 1 || k < 1 || k > MAX_NODES_PER_LAYER || N < 1 ||
      smem_bytes(L, mono) > MAX_SMEM) {
    return false;
  }
  f.K = K, f.T = T, f.L = L, f.k = k, f.N = N, f.J = L * k;
  f.npass = (f.J + NODE_TILE - 1) / NODE_TILE;
  f.kt = (T + KSTEP - 1) / KSTEP;
  f.kl = (K + LCHUNK - 1) / LCHUNK;
  f.ntiles = (N + BP - 1) / BP;
  return true;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// persistent blocks: the occupancy API's blocks an SM x the SMs, at most
// one a tile; 0 on an error (left for cudaGetLastError). The shared-memory
// attribute (at the card's limit), the SM count and each layer count's
// residency are found once a kernel instance and kept: they are host calls
// on every launch otherwise.
template <int NST, bool MONO>
int grid_of(int L, int ntiles, int* per_sm_out = nullptr) {
  const auto kern = MONO ? fused_monoflux_kernel<NST> : fused_olr_kernel<NST>;
  static int sms = 0;
  static int per_sm_of_L[MAX_LAYERS_CACHED + 1] = {};
  if (sms == 0) {
    int dev = 0;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)MAX_SMEM) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 0;
      return 0;
    }
  }
  int per_sm = L <= MAX_LAYERS_CACHED ? per_sm_of_L[L] : 0;
  if (per_sm == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                      smem_bytes(L, MONO)) != cudaSuccess) {
      return 0;
    }
    if (L <= MAX_LAYERS_CACHED) per_sm_of_L[L] = per_sm;
  }
  if (per_sm_out) *per_sm_out = per_sm;
  const long long g = (long long)sms * per_sm;
  return (int)(g < ntiles ? g : ntiles);
}

template <int NST, bool MONO>
void launch(const Fused& f, const Streams& sn, uint4* pack, cudaStream_t st) {
  fused_basis_kernel<<<dim3(f.kt + f.kl, f.npass), THREADS, 0, st>>>(f, pack);
  // grid 0 (an error in grid_of) fails the launch: cudaGetLastError reports it
  const int grid = grid_of<NST, MONO>(f.L, f.ntiles);
  const auto kern = MONO ? fused_monoflux_kernel<NST> : fused_olr_kernel<NST>;
  kern<<<grid, THREADS, smem_bytes(f.L, MONO), st>>>(f, sn);
}

}  // namespace

extern "C" {

int fused_max_streams() { return MAX_STREAMS; }

// the pack layout the wrapper builds: node tile, tail rows a chunk, lead
// rows a chunk, Lobatto nodes a layer at most
void fused_layout(int* out) {
  out[0] = NODE_TILE;
  out[1] = KSTEP;
  out[2] = LCHUNK;
  out[3] = MAX_NODES_PER_LAYER;
}

long long fused_smem_bytes(int L, int mono) { return (long long)smem_bytes(L, mono != 0); }

// bytes of the basis pack (scratch the launches fill) for K lead and T tail
// rows, L layers of k nodes; 0 for a shape the kernels do not take
long long fused_pack_bytes(int K, int T, int L, int k) {
  Fused f{};
  if (!shape(f, K, T, L, k, 1, false)) return 0;
  return (long long)f.npass * (f.kt + f.kl) * THREADS * 16;
}

// K6 (mono 0) or K7 (mono 1) with nst streams at L layers and N points:
// info[0] registers a thread, info[1] static shared bytes, info[2] local
// (spill) bytes a thread, info[3] resident blocks an SM at the launch's
// dynamic shared bytes (info[4]), info[5] the blocks a launch starts.
// Returns the CUDA error.
int fused_kernel_info(int mono, int nst, int L, int N, int* info) {
  cudaFuncAttributes a{};
  int per_sm = 0, grid = 0;
  const size_t bytes = smem_bytes(L, mono != 0);
  const int ntiles = (N + BP - 1) / BP;
  const int err = with_streams(nst, [&](auto s) {
    constexpr int K = decltype(s)::value;
    if (mono) {
      cudaFuncGetAttributes(&a, fused_monoflux_kernel<K>);
      grid = grid_of<K, true>(L, ntiles, &per_sm);
    } else {
      cudaFuncGetAttributes(&a, fused_olr_kernel<K>);
      grid = grid_of<K, false>(L, ntiles, &per_sm);
    }
  });
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)a.localSizeBytes;
  info[3] = per_sm;
  info[4] = (int)bytes;
  info[5] = grid;
  return err;
}

// lead [K, N] f32, tail [T, N] bf16, bl [L k, K] f32 and bt [L k, T] bf16
// the basis at the nodes, pack fused_pack_bytes of 16-byte aligned scratch,
// wq [L, k] f32, B [L+1, N] f32; m, W: host arrays of nst floats. out [N].
// Launches the basis pack, then K6. Returns cudaGetLastError() (0 on
// success).
int fused_olr_launch(const float* lead, const void* tail, const float* bl,
                     const void* bt, void* pack, const float* wq, const float* B, const float* m,
                     const float* W, int nst, int K, int T, int L, int k, int N, float* out,
                     void* stream) {
  Fused f{};
  if (!shape(f, K, T, L, k, N, false)) return static_cast<int>(cudaErrorInvalidValue);
  f.lead = lead, f.tail = static_cast<const uint16_t*>(tail);
  f.bl = bl, f.bt = static_cast<const uint16_t*>(bt), f.wq = wq, f.B = B, f.out = out;
  f.pack = static_cast<const uint4*>(pack);
  f.vec = N % 8 == 0 && aligned16(lead) && aligned16(tail) && aligned16(B);
  if (!aligned16(pack)) return static_cast<int>(cudaErrorInvalidValue);
  const Streams sn = pack_streams(m, W, nst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_streams(nst, [&](auto s) {
    launch<decltype(s)::value, false>(f, sn, static_cast<uint4*>(pack), st);
  });
}

// as fused_olr_launch, plus S, albedo [N] and cos(stellar zenith) ctheta;
// tau_out [L, N], M_up and M_down [L+1, N].
int fused_monoflux_launch(const float* lead, const void* tail, const float* bl,
                          const void* bt, void* pack, const float* wq, const float* B,
                          const float* S,
                          const float* albedo, float ctheta, const float* m, const float* W,
                          int nst, int K, int T, int L, int k, int N, float* tau_out,
                          float* M_up, float* M_down, void* stream) {
  Fused f{};
  if (!shape(f, K, T, L, k, N, true)) return static_cast<int>(cudaErrorInvalidValue);
  f.lead = lead, f.tail = static_cast<const uint16_t*>(tail);
  f.bl = bl, f.bt = static_cast<const uint16_t*>(bt), f.wq = wq, f.B = B;
  f.pack = static_cast<const uint4*>(pack);
  f.S = S, f.albedo = albedo, f.ctheta = ctheta;
  f.tau_out = tau_out, f.M_up = M_up, f.M_down = M_down;
  f.vec = N % 8 == 0 && aligned16(lead) && aligned16(tail) && aligned16(B) && aligned16(S) &&
          aligned16(albedo);
  if (!aligned16(pack)) return static_cast<int>(cudaErrorInvalidValue);
  const Streams sn = pack_streams(m, W, nst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_streams(nst, [&](auto s) {
    launch<decltype(s)::value, true>(f, sn, static_cast<uint4*>(pack), st);
  });
}

}  // extern "C"
