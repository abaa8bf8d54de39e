// Tile loaders of the streamed-BasicBlock kernel: the implicit GEMM of
// common.cuh over A rows that are not the output pixels of one map in order.
//
// GatherLoader: row r of the A tile is a pixel (n, y, x) of an NHWC map in
// device memory, given by a map function at construction (a BasicBlock's
// mid tile); 3x3 taps, dilation dil, padding dil.
// SmemLoader: the A rows come from a map already in shared memory (a
// BasicBlock's mid tile), 3x3 taps with dilation dil.
//
// Both derive from common.cuh's TileStage (tile shapes, shared-memory layout
// and store), so the tile products (MmaCore, SimtCore) and the
// double-buffered K loop of common.cuh run on them unchanged.

#pragma once

#include "psm.cuh"

namespace mt {

// x: (N, H, W, Cin); w: (9, Cin, ldb), columns [n0, n0 + BN) of which
// those below ncols are read (ncols a multiple of 16 bytes).
struct GatherArgs {
  const void* x;
  const void* w;
  int H, W, Cin, ldb, ncols, dil;
};

template <typename T, int BM, int BN>
struct GatherLoader : TileStage<T, BM, BN> {
  using Stage = TileStage<T, BM, BN>;
  using Stage::BK, Stage::VEC, Stage::KCH, Stage::NCH, Stage::A_CH, Stage::B_CH,
      Stage::A_STEP, Stage::B_STEP, Stage::ra, Stage::rb;

  GatherArgs a;
  int nb;                               // K blocks per tap
  int pn[A_CH], py[A_CH], px[A_CH];     // image, row and column of the window centre
  bool pv[A_CH];
  int n0;

  // pixel(row, n, y, x) sets the pixel of tile row `row` and returns
  // whether the row is a real one.
  template <class Pixel>
  __device__ GatherLoader(const GatherArgs& args, int n0_, Pixel&& pixel)
      : a(args), n0(n0_) {
    nb = (a.Cin + BK - 1) / BK;
#pragma unroll
    for (int r = 0; r < A_CH; ++r) {
      pv[r] = pixel((int)threadIdx.x / KCH + r * A_STEP, pn[r], py[r], px[r]);
      if (!pv[r]) pn[r] = py[r] = px[r] = 0;
    }
  }

  __device__ int iters() const { return 9 * nb; }

  __device__ void load(int it) {
    const int tap = it / nb;
    const int c0 = (it - tap * nb) * BK;
    const int dy = (tap / 3 - 1) * a.dil, dx = (tap % 3 - 1) * a.dil;
    const T* src = static_cast<const T*>(a.x);

    const int c = c0 + ((int)threadIdx.x % KCH) * VEC;
#pragma unroll
    for (int r = 0; r < A_CH; ++r) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const int iy = py[r] + dy, ix = px[r] + dx;
      if (pv[r] && c < a.Cin && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
        v = ldg16(src + (((size_t)pn[r] * a.H + iy) * a.W + ix) * a.Cin + c);
      ra[r] = v;
    }

    const T* w = static_cast<const T*>(a.w);
    const int n = n0 + ((int)threadIdx.x % NCH) * VEC;
#pragma unroll
    for (int r = 0; r < B_CH; ++r) {
      const int cc = c0 + (int)threadIdx.x / NCH + r * B_STEP;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (cc < a.Cin && n < a.ncols)
        v = ldg16(w + ((size_t)tap * a.Cin + cc) * a.ldb + n);
      rb[r] = v;
    }
  }
};

// A rows from a (MH, MW, C) tile in shared memory with row pitch ldm
// elements; row r of the GEMM is the output pixel whose 3x3 window (dilation
// dil) starts at tile position base(r) = (oy, ox), so tap (ty, tx) reads
// (oy + ty * dil, ox + tx * dil). w: (9, C, C) HWIO.
template <typename T, int BM, int BN>
struct SmemLoader : TileStage<T, BM, BN> {
  using Stage = TileStage<T, BM, BN>;
  using Stage::BK, Stage::VEC, Stage::KCH, Stage::NCH, Stage::A_CH, Stage::B_CH,
      Stage::A_STEP, Stage::B_STEP, Stage::ra, Stage::rb;

  const T* mid;
  const T* w;
  int ldm, mw, C, dil, nb, n0;
  int base[A_CH];

  // ow: output pixels per tile row (row r is pixel (r / ow, r % ow)).
  __device__ SmemLoader(const T* mid_, int ldm_, int mw_, int ow, const T* w_,
                        int C_, int dil_, int n0_)
      : mid(mid_), w(w_), ldm(ldm_), mw(mw_), C(C_), dil(dil_), n0(n0_) {
    nb = (C + BK - 1) / BK;
#pragma unroll
    for (int r = 0; r < A_CH; ++r) {
      const int row = (int)threadIdx.x / KCH + r * A_STEP;
      base[r] = (row / ow) * mw + row % ow;
    }
  }

  __device__ int iters() const { return 9 * nb; }

  __device__ void load(int it) {
    const int tap = it / nb;
    const int c0 = (it - tap * nb) * BK;
    const int off = (tap / 3) * dil * mw + (tap % 3) * dil;
    const int c = c0 + ((int)threadIdx.x % KCH) * VEC;
#pragma unroll
    for (int r = 0; r < A_CH; ++r) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < C) v = *reinterpret_cast<const uint4*>(mid + (size_t)(base[r] + off) * ldm + c);
      ra[r] = v;
    }
    const int n = n0 + ((int)threadIdx.x % NCH) * VEC;
#pragma unroll
    for (int r = 0; r < B_CH; ++r) {
      const int cc = c0 + (int)threadIdx.x / NCH + r * B_STEP;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (cc < C && n < C) v = ldg16(w + ((size_t)tap * C + cc) * C + n);
      rb[r] = v;
    }
  }
};

}  // namespace mt
