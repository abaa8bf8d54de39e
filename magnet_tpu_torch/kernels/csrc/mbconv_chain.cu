// One stride-1 MBConv block of an EfficientNet stage tail, eval BatchNorm
// folded, NHWC; a chain of them is one call per block:
//   e = swish(x @ wpw + s1)                 expand 1x1, bn1 scale in wpw
//   d = swish(dwKxK(e) + s2)                depthwise, bn2 scale in the taps
//   g = sigmoid(swish(mean_HW(d) @ wse1 + bse1) @ wse2 + bse2)   in f32
//   y = (d * g) @ wpwl + s3                 project 1x1, bn3 scale in wpwl
//   out = round(y) + x                      the residual, in the compute type
// e, d and d * g round to the compute type where they are stored.
//
// Replaces the TPU kernel magnet_tpu/kernels/mbchain_pallas.py
// (mbchain_fused). The TPU version keeps a frame's whole map in VMEM across
// the chain, one grid step per block. An H100 SM holds no expanded map (120 x
// 160 x 240 bf16 is 9.2 MB at stage 1), and the squeeze-excitation mean is a
// reduction over the whole map that the projection has to wait for, so a
// block is two launches here.
//
// Bound on an H100: the maps are small (300 to 19200 pixels a frame) and the
// GEMMs thin, so at N = 1 no launch comes near the tensor cores' or the
// memory's rate; what costs is latency and the SMs left idle. The first
// version (three launches: WMMA halo tiles of 8x10 outputs, the SE MLP in one
// block per frame, a projection of 128x64 tiles walking K = M serially)
// spent 1.7 ms of its 3.4 ms per D-Net frame in the projection on 15-30
// blocks and 0.7 ms in the one-block SE. This version:
//
// (1) mb_expand: a block owns (frame, 64 expanded channels, a tile of th x
//     tw output pixels). It runs the expand GEMM over the tile and its
//     (K - 1)-pixel halo, m64 runs of pixels on wgmma (m64n64k16: two
//     warpgroups on alternate runs, each with its own EX_STAGES-deep
//     cp.async ring of x; the 64 columns of wpw staged once, transposed into the
//     128-byte swizzle), writes swish(+ s1) as e into shared memory (zero
//     outside the image: the depthwise conv pads e, not x), applies the
//     taps, shift and swish from shared memory (a thread on 2 channels of 4
//     pixels at once), writes d, and sums its channels. The host's plan
//     (kernels/mbconv_chain.py::expand_tile) weighs waves of blocks against
//     the halo: the whole map where it fits and fills the card (15x20 at 5
//     frames), else tiles small enough for two blocks an SM. A first
//     version of this kernel took bands of full rows at one block an SM
//     (150-230 KB of shared memory): 8 warps an SM left every phase
//     latency-bound, and it ran 1.5-2x slower than the three-launch one.
//     The block that completes a (frame, slice)'s sums (the only one, or
//     the last tile to arrive on a counter) computes the SE's first layer
//     over its 64 channels: an R-vector of partials, summed over the slices
//     by the projection in a fixed order. No pool atomics, no SE launch.
// (2) mb_project: a block owns (frame, 64-pixel tile, 128 output channels,
//     a K range of kc expanded channels). It copies its rows of d with
//     cp.async while it computes the SE's second layer and the sigmoid for
//     its K range, scales them by the gate in place (rounded), stages wpwl
//     transposed as B, and multiplies on wgmma (m64n64k16, a warpgroup on
//     each half of the 128 channels). Where tiles x channel tiles leave SMs
//     idle the plan splits K: each block writes its f32 partial tile, and
//     the last to arrive on the tile's counter sums the partials in split
//     order (the result does not depend on the arrival order) before the
//     shift, the rounding and the residual. Counters return to zero for
//     the next launch.
// Epilogues go through shared memory; every wgmma wait is unconditional.
// f32 runs the same two launches with FMA on the same staged tiles (K
// blocks of 32 floats in place of 64 bf16), so that it equals a
// full-precision reference.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace mt {
namespace mb {

constexpr int SLICE = 64;        // expanded channels a mb_expand block
constexpr int TM = 64;           // pixels an m-tile
constexpr int PN = 128;          // output channels a mb_project block
constexpr int EX_THREADS = 256;  // two warpgroups
constexpr int EX_STAGES = 2;     // depth of each warpgroup's ring of x
constexpr int PR_THREADS = 256;  // two warpgroups, 64 output channels each
constexpr int KROW = 128;        // bytes of a tile row in a K block
constexpr int SMEM_MAX = 232448;
constexpr int CS = PN + 4;       // row stride (floats) of the staged product

// swish in f32; where the result rounds to bf16, on the fast exponential
// and division
__device__ __forceinline__ float swish(float v) { return v / (1.f + expf(-v)); }
template <typename T> __device__ __forceinline__ float swish_t(float v) { return swish(v); }
template <> __device__ __forceinline__ float swish_t<bf16>(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}
// two consecutive values (p 4-byte aligned for bf16, 8 for f32)
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T> struct Elem {
  static constexpr int V = 16 / sizeof(T);      // elements in 16 bytes
  static constexpr int EPB = KROW / sizeof(T);  // elements in a K block row
  using S = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hp::smem_addr(p) & 1023)) & 1023);
}

// A kernel argument held in a register. The compiler otherwise re-reads a
// shared-memory offset from the parameter bank wherever an address is
// formed, which cost both kernels 2 %.
__device__ __forceinline__ int in_register(int v) { return __shfl_sync(~0u, v, 0); }

// The shared-memory layouts come from the host's plan
// (kernels/mbconv_chain.py::expand_layout, project_layout) as byte offsets
// from the 1024-aligned base; the kernels place their regions there, and
// mt_mbconv_block checks the offsets' order and alignment and the total.
__host__ __device__ inline int kblocks(int k, int elem) { return (k * elem + KROW - 1) / KROW; }

// B operand: element (k, n) of a row-major src (ld elements a row, valid
// for k < kend and n < nend, zero elsewhere) to row n, column k of a K-major
// tile of ROWS rows in the 128-byte swizzle (K block b at b * ROWS * 128
// bytes), kblk K blocks. A thread takes V x V elements: V 16-byte loads
// along n, transposed in registers, V 16-byte stores along k. Neighbouring
// threads take neighbouring 16-byte chunks of a tile row, so a warp's
// stores fall in distinct banks.
template <typename T, int ROWS>
__device__ __forceinline__ void stage_bt(unsigned char* dst, const T* src, int ld, int kend,
                                         int nend, int kblk, int tid, int nthreads) {
  using E = Elem<T>;
  constexpr int V = E::V, ng = ROWS / V;
  using S = typename E::S;
  static_assert(E::EPB / V == 8, "eight chunks a tile row");
  for (int it = tid; it < 8 * ng * kblk; it += nthreads) {
    const int n = (it / 8 % ng) * V, k = it / (8 * ng) * E::EPB + it % 8 * V;
    union { uint4 u; S e[V]; } in[V], out[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      in[i].u = (k + i < kend && n < nend) ? ldg16(src + (size_t)(k + i) * ld + n)
                                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) out[j].e[i] = in[i].e[j];
    unsigned char* blk = dst + (k / E::EPB) * ROWS * KROW;
    const int chunk = (k % E::EPB) / V;
#pragma unroll
    for (int j = 0; j < V; ++j)
      *reinterpret_cast<uint4*>(blk + hp::swizzled(n + j, chunk, KROW)) = out[j].u;
  }
}

// One K block of the m64nN product of a warpgroup: acc (the m64nN f32
// fragment) += A (64 rows) * B (N rows)^T, both K-major tiles in the
// 128-byte swizzle; first: acc = A * B^T.
template <int N>
__device__ __forceinline__ void mma_kblock(float (&acc)[N / 2], const unsigned char* A,
                                           const unsigned char* B, bool first, bf16, int) {
  hp::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    hp::wgmma_ss<N>(acc, hp::desc_sw128(A + 32 * k, 1024), hp::desc_sw128(B + 32 * k, 1024),
                    (first && k == 0) ? 0 : 1);
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) hp::fence_operand(acc[i]);
}
// f32: the same fragment by FMA; thread t of the warpgroup owns rows r0 and
// r0 + 8 and columns 8 j + 2 (t % 4) + {0, 1}.
template <int N>
__device__ __forceinline__ void mma_kblock(float (&acc)[N / 2], const unsigned char* A,
                                           const unsigned char* B, bool first, float, int wt) {
  if (first) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  }
  const int r0 = hp::frag_row(wt, 0);
  auto at = [](const unsigned char* tile, int r, int k) {
    return *reinterpret_cast<const float*>(tile + hp::swizzled(r, k / 4, KROW) + 4 * (k % 4));
  };
#pragma unroll 4
  for (int k = 0; k < 32; ++k) {
    const float a0 = at(A, r0, k), a1 = at(A, r0 + 8, k);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = at(B, 8 * j + 2 * (wt % 4) + e, k);
        acc[4 * j + e] = fmaf(a0, b, acc[4 * j + e]);
        acc[4 * j + 2 + e] = fmaf(a1, b, acc[4 * j + 2 + e]);
      }
  }
}

struct ExArgs {
  const void* x;      // (N, H, W, C)
  const void* wpw;    // (C, M)
  const float* s1;    // (M,)
  const void* wdw;    // (K*K, M)
  const float* s2;    // (M,)
  const float* wse1;  // (M, R)
  void* d;            // (N, H, W, M)
  float* pool;        // (N, tiles, M) the tiles' channel sums
  float* separt;      // (N, slices, R) the SE's first layer, a partial a slice
  int* count;         // (N, slices) arrival counters, zero between launches
  int N, H, W, C, M, R, th, tw, tiles_x, tiles, slices;
  int off_ring, off_e, off_red;  // shared memory: the x rings, e, the scratch
};

template <typename T, int K>
__global__ void __launch_bounds__(EX_THREADS, 2) mb_expand(const ExArgs a) {
  using E = Elem<T>;
  constexpr int V = E::V, PT = (K - 1) / 2;
  constexpr int elem = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  unsigned char* smem = align1024(smem_dyn);
  const int tid = threadIdx.x;
  const int n = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles, slice = blockIdx.y;
  const int m0 = slice * SLICE;
  // the output tile, its halo (e), and the part of the halo inside the image
  const int oy0 = tile / a.tiles_x * a.th, ox0 = tile % a.tiles_x * a.tw;
  const int oh = min(a.th, a.H - oy0), ow = min(a.tw, a.W - ox0);
  const int ey0 = oy0 - PT, ex0 = ox0 - PT, EH = oh + K - 1, EW = ow + K - 1;
  const int iy0 = max(ey0, 0), ix0 = max(ex0, 0);
  const int cw = min(ex0 + EW, a.W) - ix0;
  const int P = (min(ey0 + EH, a.H) - iy0) * cw;  // pixels of the expand GEMM
  const int kblk = kblocks(a.C, elem);
  unsigned char* Bw = smem;
  unsigned char* ring = smem + in_register(a.off_ring);
  T* e = reinterpret_cast<T*>(smem + in_register(a.off_e));
  float* red = reinterpret_cast<float*>(smem + in_register(a.off_red));  // 8 x 64 sums, then:
  float* mean = red + 8 * SLICE;
  float* s1 = mean + SLICE;
  float* s2 = s1 + SLICE;
  int& last = *reinterpret_cast<int*>(s2 + SLICE);
  const T* x = static_cast<const T*>(a.x);

  // e outside the image is zero (the depthwise conv pads e, not x): thread
  // t clears 16 bytes t % (SLICE / V) of every (EX_THREADS / (SLICE / V))-th
  // pixel of each row
  {
    constexpr int Q = SLICE / V, PX = EX_THREADS / Q;
    for (int row = 0; row < EH; ++row) {
      const bool out_row = ey0 + row < 0 || ey0 + row >= a.H;
      for (int col = tid / Q; col < EW; col += PX)
        if (out_row || ex0 + col < 0 || ex0 + col >= a.W)
          reinterpret_cast<uint4*>(e)[(row * EW + col) * Q + tid % Q] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  for (int i = tid; i < SLICE; i += EX_THREADS) {
    const int m = m0 + i;
    s1[i] = m < a.M ? a.s1[m] : 0.f;
    s2[i] = m < a.M ? a.s2[m] : 0.f;
  }
  stage_bt<T, TM>(Bw, static_cast<const T*>(a.wpw) + m0, a.M, a.C, a.M - m0, kblk, tid,
                  EX_THREADS);
  hp::fence_proxy_async();
  __syncthreads();

  // the expand GEMM: warpgroup wg takes m-tiles wg, wg + 2, ...
  {
    const int wg = tid / 128, wt = tid % 128;
    const int nt = (P + TM - 1) / TM;
    const int my_tiles = nt > wg ? (nt - wg + 1) / 2 : 0;
    const int steps = my_tiles * kblk;
    unsigned char* st0 = ring + wg * EX_STAGES * TM * KROW;
    // a thread copies 16-byte chunk wt % 8 of rows wt / 8 + 16 i of each
    // K block; the rows' pixel offsets are worked out once an m-tile
    static_assert(TM * 8 == 4 * 128, "four chunks a thread");
    const int ch = wt % 8;
    size_t src[4];
    bool rok[4];
    int cached = -1;
    auto issue = [&](int step) {
      if (step < steps) {
        const int mt = wg + 2 * (step / kblk), kb = step % kblk;
        if (mt != cached) {
          cached = mt;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int pi = mt * TM + wt / 8 + 16 * i;
            rok[i] = pi < P;
            const int q = rok[i] ? pi : 0;
            src[i] = ((size_t)(n * a.H + iy0 + q / cw) * a.W + ix0 + q % cw) * a.C;
          }
        }
        unsigned char* st = st0 + (step % EX_STAGES) * TM * KROW;
        const int k = kb * E::EPB + ch * V;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = rok[i] && k < a.C;
          hp::cp_async16(st + hp::swizzled(wt / 8 + 16 * i, ch, KROW), x + (ok ? src[i] + k : 0),
                         ok);
        }
      }
      hp::cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < EX_STAGES; ++i) issue(i);
    float acc[SLICE / 2];
    int step = 0;
#pragma unroll 1
    for (int t = 0; t < my_tiles; ++t) {
#pragma unroll 1
      for (int kb = 0; kb < kblk; ++kb, ++step) {
        hp::cp_async_wait<EX_STAGES - 1>();
        hp::fence_proxy_async();
        hp::bar_sync(1 + wg, 128);
        mma_kblock<SLICE>(acc, st0 + (step % EX_STAGES) * TM * KROW, Bw + kb * TM * KROW,
                          kb == 0, T(), wt);
        hp::bar_sync(1 + wg, 128);
        issue(step + EX_STAGES);
      }
      // swish(+ s1), rounded, into e: the thread's two rows r0 and r0 + 8;
      // tile rows past the GEMM's pixels go to the spare pixel after e
      int slot[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pi = (wg + 2 * t) * TM + hp::frag_row(wt, 2 * h);
        slot[h] = pi < P ? (iy0 - ey0 + pi / cw) * EW + ix0 - ex0 + pi % cw : EH * EW;
      }
#pragma unroll
      for (int i = 0; i < SLICE / 2; i += 2) {
        const int col = 8 * (i / 4) + 2 * (wt % 4);
        store2(e + (size_t)slot[(i / 2) % 2] * SLICE + col, swish_t<T>(acc[i] + s1[col]),
               swish_t<T>(acc[i + 1] + s1[col + 1]));
      }
    }
    hp::cp_async_wait_all();
  }
  __syncthreads();

  // depthwise: thread (pg, cp) takes channels 2 cp, 2 cp + 1 of output
  // pixels pg, pg + 8, ...; DWP of them at once
  constexpr int DWP = 4;
  const int cp = tid % 32, pg = tid / 32;
  const int c0 = 2 * cp, m = m0 + c0;
  const bool live = m < a.M;
  float taps[K * K][2];
  const T* wdw = static_cast<const T*>(a.wdw);
#pragma unroll
  for (int i = 0; i < K * K; ++i) {
    taps[i][0] = live ? to_f(wdw[(size_t)i * a.M + m]) : 0.f;
    taps[i][1] = live ? to_f(wdw[(size_t)i * a.M + m + 1]) : 0.f;
  }
  float ps0 = 0.f, ps1 = 0.f;
  T* d = static_cast<T*>(a.d);
  const int npix = oh * ow;
  int oy = pg / ow, ox = pg % ow;  // output pixel `base`, stepped without divisions
  for (int base = pg; base < npix; base += 8 * DWP) {
    float acc[DWP][2];
    int at[DWP], py[DWP], px[DWP];
#pragma unroll
    for (int j = 0; j < DWP; ++j) {
      py[j] = oy, px[j] = ox;
      at[j] = base + 8 * j < npix ? oy * EW + ox : 0;
      acc[j][0] = acc[j][1] = 0.f;
      for (ox += 8; ox >= ow; ox -= ow) ++oy;
    }
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
#pragma unroll
        for (int j = 0; j < DWP; ++j) {
          const float2 ev = load2(e + (size_t)(at[j] + dy * EW + dx) * SLICE + c0);
          acc[j][0] = fmaf(ev.x, taps[dy * K + dx][0], acc[j][0]);
          acc[j][1] = fmaf(ev.y, taps[dy * K + dx][1], acc[j][1]);
        }
#pragma unroll
    for (int j = 0; j < DWP; ++j) {
      const int p = base + 8 * j;
      const float v0 = round_t<T>(swish_t<T>(acc[j][0] + s2[c0]));
      const float v1 = round_t<T>(swish_t<T>(acc[j][1] + s2[c0 + 1]));
      if (p < npix) {
        if (live)
          store2(d + ((size_t)(n * a.H + oy0 + py[j]) * a.W + ox0 + px[j]) * a.M + m, v0, v1);
        ps0 += v0;
        ps1 += v1;
      }
    }
  }
  red[pg * SLICE + c0] = ps0;
  red[pg * SLICE + c0 + 1] = ps1;
  __syncthreads();

  // the slice's channel sums: the tile's, then all tiles' in tile order
  float sum = 0.f;
  if (tid < SLICE) {
#pragma unroll
    for (int g = 0; g < 8; ++g) sum += red[g * SLICE + tid];
  }
  if (a.tiles > 1) {
    float* pool = a.pool + (size_t)n * a.tiles * a.M;
    if (tid < SLICE && m0 + tid < a.M) __stcg(pool + (size_t)tile * a.M + m0 + tid, sum);
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last = atomicAdd(a.count + n * a.slices + slice, 1) == a.tiles - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (tid < SLICE && m0 + tid < a.M) {
      sum = 0.f;
#pragma unroll 8
      for (int b = 0; b < a.tiles; ++b) sum += __ldcg(pool + (size_t)b * a.M + m0 + tid);
    }
    if (tid == 0) a.count[n * a.slices + slice] = 0;
  }
  if (tid < SLICE) mean[tid] = m0 + tid < a.M ? sum / (float)(a.H * a.W) : 0.f;
  __syncthreads();

  // the SE's first layer over this slice: R partial sums, each over the
  // slice's channels split `parts` ways (R * parts <= 8 * SLICE), summed in
  // part order
  const int mc = min(SLICE, a.M - m0), parts = max(1, EX_THREADS / a.R);
  for (int it = tid; it < a.R * parts; it += EX_THREADS) {
    const int j = it % a.R, part = it / a.R;
    float acc = 0.f;
#pragma unroll 4
    for (int c = part; c < mc; c += parts)
      acc = fmaf(mean[c], a.wse1[(size_t)(m0 + c) * a.R + j], acc);
    red[part * a.R + j] = acc;
  }
  __syncthreads();
  for (int j = tid; j < a.R; j += EX_THREADS) {
    float acc = 0.f;
    for (int part = 0; part < parts; ++part) acc += red[part * a.R + j];
    a.separt[((size_t)n * a.slices + slice) * a.R + j] = acc;
  }
}

struct PrArgs {
  const void* d;       // (N, H, W, M)
  const void* x;       // (N, H, W, C), the residual
  const void* wpwl;    // (M, C)
  const float* s3;     // (C,)
  const float* bse1;   // (R,)
  const float* wse2;   // (R, M)
  const float* bse2;   // (M,)
  const float* separt; // (N, slices, R)
  float* ws;           // split-K partials: (tiles, splits, 64 x 128)
  int* count;          // (tiles) arrival counters, zero between launches
  void* out;           // (N, H, W, C)
  int N, H, W, C, M, R, slices, kc, splits, tpf;
  int off_a, off_gate, off_r;  // shared memory: A, the gate, r
};

template <typename T>
__global__ void __launch_bounds__(PR_THREADS) mb_project(const PrArgs a) {
  using E = Elem<T>;
  constexpr int V = E::V, elem = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  unsigned char* smem = align1024(smem_dyn);
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int n = blockIdx.x / a.tpf, tile = blockIdx.x % a.tpf;
  const int n0 = blockIdx.y * PN, split = blockIdx.z;
  const int k0 = split * a.kc, kn = min(a.kc, a.M - k0);
  const int kblk = kblocks(kn, elem);
  const int hw = a.H * a.W;
  unsigned char* B = smem;
  unsigned char* A = smem + in_register(a.off_a);
  float* gate = reinterpret_cast<float*>(smem + in_register(a.off_gate));
  float* r = reinterpret_cast<float*>(smem + in_register(a.off_r));
  int& last = *reinterpret_cast<int*>(r + a.R);

  // A: the tile's rows of d, copied as they are (the gate is applied below)
  // thread tid takes chunks tid, tid + PR_THREADS, ... of the tile's rows
  // of kc8 16-byte chunks, stepped without divisions
  const T* dsrc = static_cast<const T*>(a.d) + (size_t)n * hw * a.M + k0;
  const int kc8 = kblk * 8, drow = PR_THREADS / kc8, dch = PR_THREADS % kc8;
  for (int it = tid, row = tid / kc8, ch = tid % kc8; it < TM * kc8; it += PR_THREADS) {
    const int k = (ch / 8) * E::EPB + (ch % 8) * V, p = tile * TM + row;
    const bool ok = p < hw && k < kn;
    hp::cp_async16(A + (ch / 8) * TM * KROW + hp::swizzled(row, ch % 8, KROW),
                   dsrc + (ok ? (size_t)p * a.M + k : 0), ok);
    row += drow, ch += dch;
    if (ch >= kc8) ch -= kc8, ++row;
  }
  hp::cp_async_commit();
  stage_bt<T, PN>(B, static_cast<const T*>(a.wpwl) + (size_t)k0 * a.C + n0, a.C, kn,
                  a.C - n0, kblk, tid, PR_THREADS);
  // the SE's first layer completed (its slices' partials summed `sp` ways,
  // meeting in the gate's buffer), then its second layer and the sigmoid
  // over this block's K range
  const int sp = max(1, PR_THREADS / a.R);
  for (int it = tid; it < a.R * sp; it += PR_THREADS) {
    const int j = it % a.R, part = it / a.R;
    float z = 0.f;
#pragma unroll 4
    for (int s = part; s < a.slices; s += sp) z += a.separt[((size_t)n * a.slices + s) * a.R + j];
    gate[part * a.R + j] = z;
  }
  __syncthreads();
  for (int j = tid; j < a.R; j += PR_THREADS) {
    float z = a.bse1[j];
    for (int part = 0; part < sp; ++part) z += gate[part * a.R + j];
    r[j] = swish(z);
  }
  __syncthreads();
  // thread t sums the float4 of channels 4 q .. 4 q + 3 over every
  // parts-th row of wse2, partial sums meeting in the gate's buffer
  const int quads = kn / 4, parts = max(1, PR_THREADS / quads);
  for (int it = tid; it < quads * parts; it += PR_THREADS) {
    const int q = it % quads, part = it / quads;
    float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* w = reinterpret_cast<const float4*>(a.wse2 + k0) + q;
#pragma unroll 4
    for (int j = part; j < a.R; j += parts) {
      const float4 v = __ldg(w + (size_t)j * (a.M / 4));
      const float rj = r[j];
      z.x = fmaf(rj, v.x, z.x), z.y = fmaf(rj, v.y, z.y);
      z.z = fmaf(rj, v.z, z.z), z.w = fmaf(rj, v.w, z.w);
    }
    reinterpret_cast<float4*>(gate + part * kn)[q] = z;
  }
  __syncthreads();
  for (int k = tid; k < kn; k += PR_THREADS) {
    float z = a.bse2[k0 + k];
    for (int part = 0; part < parts; ++part) z += gate[part * kn + k];
    gate[k] = 1.f / (1.f + expf(-z));
  }

  hp::cp_async_wait_all();
  __syncthreads();
  // d * g, rounded, in place (each thread on the chunks it copied)
  for (int it = tid, row = tid / kc8, ch = tid % kc8; it < TM * kc8; it += PR_THREADS) {
    const int k = (ch / 8) * E::EPB + (ch % 8) * V;
    uint4* at =
        reinterpret_cast<uint4*>(A + (ch / 8) * TM * KROW + hp::swizzled(row, ch % 8, KROW));
    if (k < kn) {
      float f[V];
      unpack(*at, f, T());
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 g = *reinterpret_cast<const float4*>(gate + k + e);
        f[e] *= g.x, f[e + 1] *= g.y, f[e + 2] *= g.z, f[e + 3] *= g.w;
      }
      *at = pack(f, T());
    }
    row += drow, ch += dch;
    if (ch >= kc8) ch -= kc8, ++row;
  }
  hp::fence_proxy_async();
  __syncthreads();

  // warpgroup wg: output channels n0 + 64 wg .. + 63
  float acc[PN / 4];
#pragma unroll 1
  for (int kb = 0; kb < kblk; ++kb)
    mma_kblock<PN / 2>(acc, A + kb * TM * KROW, B + kb * PN * KROW + wg * (PN / 2) * KROW,
                       kb == 0, T(), wt);
  __syncthreads();
  float* ct = reinterpret_cast<float*>(A);
#pragma unroll
  for (int e = 0; e < PN / 4; e += 2) {
    const int row = hp::frag_row(wt, e), col = wg * (PN / 2) + 8 * (e / 4) + 2 * (wt % 4);
    *reinterpret_cast<float2*>(ct + row * CS + col) = make_float2(acc[e], acc[e + 1]);
  }
  __syncthreads();

  if (a.splits > 1) {
    // split K: publish the partial; the last block of the tile sums all in
    // split order
    const size_t tid_tile = (size_t)blockIdx.x * gridDim.y + blockIdx.y;
    float4* part = reinterpret_cast<float4*>(a.ws + tid_tile * a.splits * TM * PN);
    for (int e = tid; e < TM * PN / 4; e += PR_THREADS)
      __stcg(part + (size_t)split * TM * PN / 4 + e,
             *reinterpret_cast<const float4*>(ct + (e / (PN / 4)) * CS + 4 * (e % (PN / 4))));
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.count + tid_tile, 1) == a.splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int e = tid; e < TM * PN / 4; e += PR_THREADS) {
      float4* own = reinterpret_cast<float4*>(ct + (e / (PN / 4)) * CS + 4 * (e % (PN / 4)));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int s = 0; s < a.splits; ++s) {
        const float4 p = s == split ? *own : __ldcg(part + (size_t)s * TM * PN / 4 + e);
        v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
      }
      *own = v;
    }
    if (tid == 0) a.count[tid_tile] = 0;
    __syncthreads();
  }

  // out = round(round(y + s3) + x)
  const T* xres = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
#pragma unroll 4
  for (int it = tid; it < TM * PN / V; it += PR_THREADS) {
    const int row = it / (PN / V), cv = it % (PN / V);
    const int p = tile * TM + row, c = n0 + cv * V;
    if (p < hw && c < a.C) {
      const size_t g = ((size_t)n * hw + p) * a.C + c;
      float xr[V], o[V];
      unpack(ldg16(xres + g), xr, T());
#pragma unroll
      for (int e = 0; e < V; ++e)
        o[e] = round_t<T>(ct[row * CS + cv * V + e] + a.s3[c + e]) + xr[e];
      *reinterpret_cast<uint4*>(out + g) = pack(o, T());
    }
  }
}

template <typename T>
int launch_block(const ExArgs& ex, const PrArgs& pr, int K, int ex_bytes, int pr_bytes,
                 cudaStream_t s) {
  auto k1 = K == 3 ? mb_expand<T, 3> : mb_expand<T, 5>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, ex_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mb_project<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pr_bytes);
  if (err != cudaSuccess) return (int)err;
  k1<<<dim3((unsigned)(ex.N * ex.tiles), (unsigned)ex.slices), EX_THREADS, ex_bytes, s>>>(ex);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(pr.N * pr.tpf), (unsigned)((pr.C + PN - 1) / PN),
                  (unsigned)pr.splits);
  mb_project<T><<<grid, PR_THREADS, pr_bytes, s>>>(pr);
  return (int)cudaGetLastError();
}

}  // namespace mb
}  // namespace mt

// One block of the chain, two launches. dtype: 0 f32, 1 bf16. x: (N, H, W,
// C); wpw: (C, M); wdw: (K*K, M); wpwl: (M, C), all of x's type; s1, s2,
// bse2: (M,); wse1: (M, R); bse1: (R,); wse2: (R, M); s3: (C,), f32. d:
// (N, H, W, M) scratch of x's type; pool: (N, tiles, M) f32 scratch;
// separt: (N, slices, R) f32 scratch; ws: the split-K partials, (N * tpf *
// ctiles * splits, 64 * 128) f32 scratch (unused with one split); counters:
// N * slices + N * tpf * ctiles int32 zeros (zeros again when the launch
// ends); out: (N, H, W, C). The plan: th x tw output pixels a tile of
// mb_expand, kc expanded channels a K range of mb_project (a multiple of
// 64); tiles = ceil(H / th) ceil(W / tw), slices = ceil(M / 64), tpf =
// ceil(H * W / 64), ctiles = ceil(C / 128), splits = ceil(M / kc); ex: the
// byte offsets of mb_expand's x rings, e and scratch and its shared memory
// in all, pr: those of mb_project's A, gate and r and its total. C and M
// multiples of 16 bytes; K 3 or 5. Returns the first cudaGetLastError()
// that is not 0, or cudaErrorInvalidValue for a plan whose offsets are out
// of order or alignment or whose shared memory does not fit.
extern "C" int mt_mbconv_block(int dtype, const void* x, const void* wpw, const void* s1,
                               const void* wdw, const void* s2, const void* wse1,
                               const void* bse1, const void* wse2, const void* bse2,
                               const void* wpwl, const void* s3, void* d, void* pool,
                               void* separt, void* ws, void* counters, void* out, int N,
                               int H, int W, int C, int M, int R, int K, int th, int tw,
                               int kc, int ex_ring, int ex_e, int ex_red, int ex_bytes,
                               int pr_a, int pr_gate, int pr_r, int pr_bytes, void* stream) {
  using namespace mt::mb;
  if ((K != 3 && K != 5) || th < 1 || tw < 1 || kc < 64 || kc % 64)
    return (int)cudaErrorInvalidValue;
  if (!(0 < ex_ring && ex_ring < ex_e && ex_e < ex_red && ex_red < ex_bytes &&
        ex_bytes <= SMEM_MAX && ex_ring % 1024 == 0 && ex_e % 16 == 0 && ex_red % 16 == 0) ||
      !(0 < pr_a && pr_a < pr_gate && pr_gate < pr_r && pr_r < pr_bytes &&
        pr_bytes <= SMEM_MAX && pr_a % 1024 == 0 && pr_gate % 16 == 0 && pr_r % 4 == 0))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int slices = (M + SLICE - 1) / SLICE, tiles_x = (W + tw - 1) / tw;
  const int tiles = (H + th - 1) / th * tiles_x;
  int* count = static_cast<int*>(counters);
  ExArgs ex{x, wpw, f(s1), wdw, f(s2), f(wse1), d, static_cast<float*>(pool),
            static_cast<float*>(separt), count, N, H, W, C, M, R, th, tw, tiles_x, tiles,
            slices, ex_ring, ex_e, ex_red};
  PrArgs pr{d, x, wpwl, f(s3), f(bse1), f(wse2), f(bse2), static_cast<const float*>(separt),
            static_cast<float*>(ws), count + N * slices, out, N, H, W, C, M, R, slices, kc,
            (M + kc - 1) / kc, (H * W + TM - 1) / TM, pr_a, pr_gate, pr_r};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_block<mt::bf16>(ex, pr, K, ex_bytes, pr_bytes, s);
  return launch_block<float>(ex, pr, K, ex_bytes, pr_bytes, s);
}
