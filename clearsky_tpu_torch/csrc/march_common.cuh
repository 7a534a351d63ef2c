// Device code shared by the march kernels (march.cu: K2, K3) and the fused
// table kernels (fused_table.cu: K6, K7): the stream set and its dispatch
// on the stream count, and the column marches of one wavenumber point that
// K6/K7 run (the transmittance triple, the linear-in-tau layer emission,
// the OLR and whole-column marches). K2/K3 have their own layer step since
// PR 11 (march.cu: no division, a reciprocal a layer).
//
// The column marches take the layer optical depth and the level Planck
// values through accessors tau(l) and b(l) (and store flux rows through
// accessors), so that K6/K7 read the shared memory where they formed tau
// and staged B. The transmittance triple (t, 1 - t, (1 - t)/tau_m) comes
// from one expf and a 7-term series below tau_m = 0.25
// (clearsky_tpu/rt/march_pallas.py::_trans_emit): forming 1 - exp(-tau_m)
// directly cancels catastrophically in float32 for transparent layers. The
// sources are built without --use_fast_math, so expf is the accurate one.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace clearsky {

constexpr int MAX_STREAMS = 8;
constexpr float PI_F = 3.14159265358979324f;
constexpr float INV_PI = 0.318309886183790672f;

struct Streams {
  float m[MAX_STREAMS];  // slant factors 1/cos(theta)
  float W[MAX_STREAMS];  // flux quadrature weights
};

inline Streams pack_streams(const float* m, const float* W, int nst) {
  Streams sn{};
  for (int k = 0; k < nst; ++k) {
    sn.m[k] = m[k];
    sn.W[k] = W[k];
  }
  return sn;
}

// Calls f(std::integral_constant<int, nst>{}) for nst in 1..MAX_STREAMS and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// any other stream count.
template <class F>
inline int with_streams(int nst, F&& f) {
  switch (nst) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 5: f(std::integral_constant<int, 5>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    case 7: f(std::integral_constant<int, 7>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

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

// b(l) the Planck value at level l of the column (row 0 = top of
// atmosphere, row L = surface). Returns sum_k W_k I_k at the top after
// marching up from the surface Planck.
template <int NST, class Tau, class Planck>
__device__ __forceinline__ float olr_column_at(const Tau& tau, const Planck& b,
                                               const Streams& sn, int L) {
  float I[NST];
  const float bs = b(L);
#pragma unroll
  for (int k = 0; k < NST; ++k) I[k] = bs;
  for (int l = L - 1; l >= 0; --l) {
    march_layer(I, sn, tau(l), b(l + 1), b(l));
  }
  return weighted(I, sn);
}

// monoflux_pallas's contract: M_down row 0 is the beam top c S, rows 1..L the
// down-march emission plus the attenuated beam; M_up row L is pi I_surf with
// I_surf = M_down[L] a / pi + B[L], rows 0..L-1 the up-march emission.
// down(l, v) and up(l, v) store row l of M_down and M_up.
template <int NST, class Tau, class Planck, class Down, class Up>
__device__ __forceinline__ void monoflux_column_at(
    const Tau& tau, const Planck& b, float S, float albedo, float ctheta,
    const Streams& sn, int L, const Down& down_at, const Up& up_at) {
  const float inv_c = 1.0f / ctheta;
  float I[NST];
#pragma unroll
  for (int k = 0; k < NST; ++k) I[k] = 0.0f;
  float bm = ctheta * S;  // direct beam below level 0
  down_at(0, bm);
  float down = bm;
  for (int l = 0; l < L; ++l) {
    const float tl = tau(l);
    march_layer(I, sn, tl, b(l), b(l + 1));
    bm *= expf(-tl * inv_c);
    down = weighted(I, sn) + bm;
    down_at(l + 1, down);
  }
  const float I_surf = down * (albedo * INV_PI) + b(L);
  up_at(L, PI_F * I_surf);
#pragma unroll
  for (int k = 0; k < NST; ++k) I[k] = I_surf;
  for (int l = L - 1; l >= 0; --l) {
    march_layer(I, sn, tau(l), b(l + 1), b(l));
    up_at(l, weighted(I, sn));
  }
}

}  // namespace clearsky
