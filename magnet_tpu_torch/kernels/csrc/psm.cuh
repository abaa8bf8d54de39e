// Tile loader of the PSM-Net (F-Net) kernels: the implicit GEMM of
// common.cuh over a conv with a stride, a dilation, a 3x3 or 1x1 window and
// up to three input maps whose channel concat is never built.
//
// It has TileLoader's tile shapes and shared-memory layout, so the tile
// products (MmaCore, SimtCore) and the double-buffered K loop of common.cuh
// run on it unchanged.

#pragma once

#include "common.cuh"

namespace mt {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// src[i]: (N, H, W, C[i]) NHWC, unused sources have C[i] = 0; w: HWIO
// (taps, C[0] + C[1] + C[2], Cout) with the input channels in source order.
// taps = 9: 3x3 window with padding = dil; taps = 1: 1x1, no padding.
// Output (N, Ho, Wo, Cout) with Ho = (H - 1) / stride + 1.
struct PsmArgs {
  const void* src[3];
  int C[3];
  const void* w;
  int N, H, W, Ho, Wo, Ctot, Cout, taps, stride, dil;
};

template <typename T, int BM, int BN>
struct PsmLoader {
  using Base = TileLoader<T, BM, BN>;
  static constexpr int BK = Base::BK, VEC = Base::VEC, LDA = Base::LDA, LDB = Base::LDB;
  static constexpr int KCH = Base::KCH, NCH = Base::NCH;
  static constexpr int A_CH = Base::A_CH, B_CH = Base::B_CH;
  static constexpr int A_STEP = Base::A_STEP, B_STEP = Base::B_STEP;
  static constexpr int A_ELEMS = Base::A_ELEMS, B_ELEMS = Base::B_ELEMS;
  static constexpr int SMEM = Base::SMEM;

  PsmArgs a;
  int nb0, nb1, nb2;          // K blocks per tap of each source
  int pn[A_CH], py[A_CH], px[A_CH];   // image, input row and column of the window centre
  bool pv[A_CH];
  uint4 ra[A_CH], rb[B_CH];
  int n0;

  __device__ PsmLoader(const PsmArgs& args, int m0, int n0_) : a(args), n0(n0_) {
    nb0 = (a.C[0] + BK - 1) / BK;
    nb1 = (a.C[1] + BK - 1) / BK;
    nb2 = (a.C[2] + BK - 1) / BK;
    const int hw = a.Ho * a.Wo;
    const int M = a.N * hw;
#pragma unroll
    for (int r = 0; r < A_CH; ++r) {
      int m = m0 + (int)threadIdx.x / KCH + r * A_STEP;
      pv[r] = m < M;
      int mm = pv[r] ? m : 0;
      pn[r] = mm / hw;
      int rem = mm - pn[r] * hw;
      int oy = rem / a.Wo;
      py[r] = oy * a.stride;
      px[r] = (rem - oy * a.Wo) * a.stride;
    }
  }

  __device__ int iters() const { return a.taps * (nb0 + nb1 + nb2); }

  // K step `it`: source-major, then tap, then channel block.
  __device__ void load(int it) {
    int local = it, nb = nb0, C = a.C[0], coff = 0;
    const void* sp = a.src[0];
    if (local >= a.taps * nb0) {
      local -= a.taps * nb0;
      nb = nb1; C = a.C[1]; coff = a.C[0]; sp = a.src[1];
      if (local >= a.taps * nb1) {
        local -= a.taps * nb1;
        nb = nb2; C = a.C[2]; coff = a.C[0] + a.C[1]; sp = a.src[2];
      }
    }
    const int tap = local / nb;
    const int c0 = (local - tap * nb) * BK;
    const int dy = a.taps == 9 ? (tap / 3 - 1) * a.dil : 0;
    const int dx = a.taps == 9 ? (tap % 3 - 1) * a.dil : 0;
    const T* src = static_cast<const T*>(sp);

    const int c = c0 + ((int)threadIdx.x % KCH) * VEC;
#pragma unroll
    for (int r = 0; r < A_CH; ++r) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const int iy = py[r] + dy, ix = px[r] + dx;
      if (pv[r] && c < C && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
        v = ldg16(src + (((size_t)pn[r] * a.H + iy) * a.W + ix) * C + c);
      ra[r] = v;
    }

    const T* w = static_cast<const T*>(a.w);
    const int n = n0 + ((int)threadIdx.x % NCH) * VEC;
#pragma unroll
    for (int r = 0; r < B_CH; ++r) {
      const int cc = c0 + (int)threadIdx.x / NCH + r * B_STEP;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (cc < C && n < a.Cout)
        v = ldg16(w + ((size_t)tap * a.Ctot + coff + cc) * a.Cout + n);
      rb[r] = v;
    }
  }

  __device__ void store(T* As, T* Bs) const {
#pragma unroll
    for (int r = 0; r < A_CH; ++r) {
      const int row = (int)threadIdx.x / KCH + r * A_STEP;
      *reinterpret_cast<uint4*>(As + row * LDA + ((int)threadIdx.x % KCH) * VEC) = ra[r];
    }
#pragma unroll
    for (int r = 0; r < B_CH; ++r) {
      const int k = (int)threadIdx.x / NCH + r * B_STEP;
      *reinterpret_cast<uint4*>(Bs + k * LDB + ((int)threadIdx.x % NCH) * VEC) = rb[r];
    }
  }
};

}  // namespace mt
