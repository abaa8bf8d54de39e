// Shared building blocks of the port's convolution kernels (sm_90a).
//
// Both kernels are implicit GEMMs over NHWC activations: M is the output
// pixels, N the output channels and K runs tap by tap (9 taps of a SAME 3x3
// conv) over the input channels. One 256-thread block computes a BM x BN
// output tile. Each K step stages a BM x BK slab of the im2col matrix (A) and
// a BK x BN slab of the HWIO weights (B) in shared memory, double buffered:
// the global loads of step k+1 are held in registers while step k computes.
//
// bf16 runs on the tensor cores through WMMA (mma.sync, f32 accumulate);
// f32 runs as register-tiled FMA so that it equals a full-precision
// reference (no TF32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int THREADS = 256;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

__device__ __forceinline__ float activate(float y, int act) {
  if (act == ACT_LEAKY) return y > 0.f ? y : 0.01f * y;   // torch LeakyReLU()
  if (act == ACT_RELU) return fmaxf(y, 0.f);
  return y;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes <-> floats: 4 f32 or 8 bf16 values.
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, bf16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, bf16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ uint4 ldg16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// align_corners=True source taps of output index o (n_out outputs over n_in
// inputs): value = (1 - f) * in[i0] + f * in[i1].
__device__ __forceinline__ void src_coord(int o, int n_out, int n_in, int& i0,
                                          int& i1, float& f) {
  float pos = n_out > 1 ? (float)o * (float)(n_in - 1) / (float)(n_out - 1) : 0.f;
  int lim = n_in >= 2 ? n_in - 2 : 0;
  i0 = min((int)floorf(pos), lim);
  f = pos - (float)i0;
  i1 = min(i0 + 1, n_in - 1);
}

// Tile shapes per element type: BK input channels per K step, row padding of
// the shared-memory slabs (keeps 16-byte row alignment, breaks bank strides).
template <typename T> struct TileCfg;
template <> struct TileCfg<bf16> { static constexpr int BK = 32, PAD = 8; };
template <> struct TileCfg<float> { static constexpr int BK = 16, PAD = 4; };

// The conv operands. x: (N, Hs, Ws, Cx) (upsampled to (H, W) on the fly when
// ups); skip: (N, H, W, Cs) or null; wx: (9*Cx, Cout); ws: (9*Cs, Cout).
struct ConvArgs {
  const void* x;
  const void* skip;
  const void* wx;
  const void* ws;
  int N, H, W, Hs, Ws, Cx, Cs, Cout;
  bool ups;
};

// What the loaders of the K loop below share: the tile shapes, the
// registers that hold the A (BM x BK) and B (BK x BN) slabs of one K step,
// and their store to a shared-memory stage. A loader derives from it and
// adds its own iters() and load(it), which fill ra and rb. psm.cuh's
// PsmLoader keeps its own copy: derived from this, the bf16 SPP-tail kernel
// took 95 registers instead of 80 and ran 7 % slower on an H100.
template <typename T, int BM, int BN>
struct TileStage {
  static constexpr int BK = TileCfg<T>::BK;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int LDA = BK + TileCfg<T>::PAD;
  static constexpr int LDB = BN + TileCfg<T>::PAD;
  static constexpr int KCH = BK / VEC;
  static constexpr int NCH = BN / VEC;
  static constexpr int A_CH = BM * KCH / THREADS;
  static constexpr int B_CH = BK * NCH / THREADS;
  static constexpr int A_STEP = THREADS / KCH;
  static constexpr int B_STEP = THREADS / NCH;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int SMEM = 2 * (A_ELEMS + B_ELEMS) * (int)sizeof(T);
  static_assert(BM * KCH % THREADS == 0 && BK * NCH % THREADS == 0, "tile");
  static_assert(KCH == 4, "A rows are read as four 16-byte chunks");

  uint4 ra[A_CH], rb[B_CH];

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

// Loads the A (im2col) and B (weights) slabs of one K step. K step `it`
// covers tap it / nb and channels [c0, c0 + BK) of x first, then of skip:
// the channel concat of the reference is never built.
template <typename T, int BM, int BN>
struct TileLoader : TileStage<T, BM, BN> {
  // (a dependent base's members are not found unqualified)
  using Stage = TileStage<T, BM, BN>;
  using Stage::BK, Stage::VEC, Stage::KCH, Stage::NCH, Stage::A_CH, Stage::B_CH,
      Stage::A_STEP, Stage::B_STEP, Stage::ra, Stage::rb;

  ConvArgs a;
  int nxb, nsb;
  int pn[A_CH], py[A_CH], px[A_CH];
  bool pv[A_CH];
  int n0;

  __device__ TileLoader(const ConvArgs& args, int m0, int n0_) : a(args), n0(n0_) {
    nxb = (a.Cx + BK - 1) / BK;
    nsb = a.Cs > 0 ? (a.Cs + BK - 1) / BK : 0;
    const int hw = a.H * a.W;
    const int M = a.N * hw;
#pragma unroll
    for (int r = 0; r < A_CH; ++r) {
      int m = m0 + (int)threadIdx.x / KCH + r * A_STEP;
      pv[r] = m < M;
      int mm = pv[r] ? m : 0;
      pn[r] = mm / hw;
      int rem = mm - pn[r] * hw;
      py[r] = rem / a.W;
      px[r] = rem - py[r] * a.W;
    }
  }

  __device__ int iters() const { return 9 * (nxb + nsb); }

  __device__ void load(int it) {
    const bool is_x = it < 9 * nxb;
    const int local = is_x ? it : it - 9 * nxb;
    const int nb = is_x ? nxb : nsb;
    const int tap = local / nb;
    const int c0 = (local - tap * nb) * BK;
    const int C = is_x ? a.Cx : a.Cs;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const T* src = static_cast<const T*>(is_x ? a.x : a.skip);
    const bool ups = is_x && a.ups;

    const int c = c0 + ((int)threadIdx.x % KCH) * VEC;
#pragma unroll
    for (int r = 0; r < A_CH; ++r) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const int iy = py[r] + dy, ix = px[r] + dx;
      if (pv[r] && c < C && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) {
        if (!ups) {
          v = ldg16(src + (((size_t)pn[r] * a.H + iy) * a.W + ix) * C + c);
        } else {
          int y0, y1, x0, x1;
          float fy, fx;
          src_coord(iy, a.H, a.Hs, y0, y1, fy);
          src_coord(ix, a.W, a.Ws, x0, x1, fx);
          const size_t base = (size_t)pn[r] * a.Hs;
          float f00[VEC], f01[VEC], f10[VEC], f11[VEC], o[VEC];
          unpack(ldg16(src + ((base + y0) * a.Ws + x0) * C + c), f00, T());
          unpack(ldg16(src + ((base + y0) * a.Ws + x1) * C + c), f01, T());
          unpack(ldg16(src + ((base + y1) * a.Ws + x0) * C + c), f10, T());
          unpack(ldg16(src + ((base + y1) * a.Ws + x1) * C + c), f11, T());
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float top = f00[e] * (1.f - fx) + f01[e] * fx;
            float bot = f10[e] * (1.f - fx) + f11[e] * fx;
            o[e] = top * (1.f - fy) + bot * fy;
          }
          v = pack(o, T());
        }
      }
      ra[r] = v;
    }

    const T* w = static_cast<const T*>(is_x ? a.wx : a.ws);
    const int n = n0 + ((int)threadIdx.x % NCH) * VEC;
#pragma unroll
    for (int r = 0; r < B_CH; ++r) {
      const int cc = c0 + (int)threadIdx.x / NCH + r * B_STEP;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (cc < C && n < a.Cout)
        v = ldg16(w + ((size_t)tap * C + cc) * a.Cout + n);
      rb[r] = v;
    }
  }
};

// bf16 tile product on the tensor cores: WM x WN warps, each owning a
// (BM/WM) x (BN/WN) sub-tile of 16x16 accumulator fragments.
template <int BM, int BN, int WM, int WN>
struct MmaCore {
  using T = bf16;
  using L = TileLoader<bf16, BM, BN>;
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int FM = WTM / 16, FN = WTN / 16;
  static_assert(WM * WN * 32 == THREADS, "warps");
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ void step(const bf16* As, const bf16* Bs) {
    const int warp = threadIdx.x / 32, wm = warp / WN, wn = warp % WN;
#pragma unroll
    for (int kk = 0; kk < L::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WTM + i * 16) * L::LDA + kk, L::LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * L::LDB + wn * WTN + j * 16, L::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // Hands each lane 8 consecutive accumulator values of a row:
  // emit(row, col, v, 8) in tile coordinates. `scratch` holds 256 floats
  // per warp and must not alias a live operand.
  template <class F>
  __device__ void epilogue(float* scratch, F&& emit) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / WN, wn = warp % WN;
    float* s = scratch + warp * 256;
    const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(s, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = s[r * 16 + c + e];
        emit(wm * WTM + i * 16 + r, wn * WTN + j * 16 + c, v, 8);
        __syncwarp();
      }
  }
};

// f32 tile product as FMA: thread (ty, tx) of a 16 x 16 grid owns rows
// ty + 16 i and columns tx + 16 j.
template <int BM, int BN>
struct SimtCore {
  using T = float;
  using L = TileLoader<float, BM, BN>;
  static constexpr int TM = BM / 16, TN = BN / 16;
  float acc[TM][TN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  __device__ void step(const float* As, const float* Bs) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int k = 0; k < L::BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[(ty + 16 * i) * L::LDA + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k * L::LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  template <class F>
  __device__ void epilogue(float*, F&& emit) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) emit(ty + 16 * i, tx + 16 * j, &acc[i][j], 1);
  }
};

// The double-buffered K loop. smem holds two A stages then two B stages.
template <class Core, class Loader, typename T>
__device__ void run_mainloop(Core& core, Loader& ld, T* smem) {
  T* As = smem;
  T* Bs = smem + 2 * Loader::A_ELEMS;
  const int n = ld.iters();
  core.zero();
  ld.load(0);
  ld.store(As, Bs);
  __syncthreads();
  for (int it = 0; it < n; ++it) {
    const int cur = it & 1;
    if (it + 1 < n) ld.load(it + 1);
    core.step(As + cur * Loader::A_ELEMS, Bs + cur * Loader::B_ELEMS);
    if (it + 1 < n)
      ld.store(As + (cur ^ 1) * Loader::A_ELEMS, Bs + (cur ^ 1) * Loader::B_ELEMS);
    __syncthreads();
  }
}

// ---- chained 1x1 layers over a 64-pixel hidden tile in shared memory ------
// (the f32 paths of the head chain, the SPP tail and the G-Net update)

constexpr int HID = 128;    // hidden width of every chain
constexpr int HBM = 64;     // output pixels per block

template <typename T> struct HidCfg { static constexpr int LDH = HID + TileCfg<T>::PAD; };

// One 1x1 layer as FMA in f32: in (64 x 128, shared) times w (128 x
// cn_pad, global) + bias, into the next shared tile or the output.
__device__ inline void chain_layer(const float* in, float* hid_out, float* gout,
                            const float* w, const float* b, int cn, bool relu,
                            float*, int m0, int M, SimtCore<HBM, HID>*) {
  constexpr int LDH = HidCfg<float>::LDH;
  const int cn_pad = (cn + 15) / 16 * 16;
  for (int o = threadIdx.x; o < HBM * cn; o += THREADS) {
    const int row = o / cn, n = o - row * cn;
    float y = b[n];
#pragma unroll 8
    for (int k = 0; k < HID; ++k) y = fmaf(in[row * LDH + k], w[(size_t)k * cn_pad + n], y);
    if (relu) y = fmaxf(y, 0.f);
    if (gout) {
      if (m0 + row < M) gout[(size_t)(m0 + row) * cn + n] = y;
    } else {
      hid_out[row * LDH + n] = y;
    }
  }
}

}  // namespace mt
