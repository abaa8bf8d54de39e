// G-Net update: one launch per refinement iteration, NHWC.
//
// Replaces the TPU kernel magnet_tpu/kernels/gnet_pallas.py
// (gnet_update_pallas): a SAME 3x3 conv over the D-channel cost volume into
// 128 channels, plus the precomputed feature term, ReLU; two 1x1 convs
// 128 -> 128 with bias and ReLU; a 1x1 conv to 2; then the Gaussian update
//   mu = mu0 + mu1 * sigma0,  sigma = (elu(sigma1) + 1 + 1e-10) * sigma0
// in f32. As on the TPU the hidden 128-channel tiles never reach device
// memory: only the 2 output channels are stored. Hidden activations round
// to the compute type between layers, as the TPU kernel's do.
//
// Bound on an H100: bytes. A launch at the ScanNet eval shape (19200
// pixels) reads the 128-channel feature term (4.9 MB in bf16) and little
// else, against 1.5 GFLOP; the tensor cores are nowhere near the limit.
//
// bf16 (gnet_update_hopper). The first version (WMMA, common.cuh's chained
// layers) ran at 53x the bound: its blocks ran their phases one after
// another, layer 0 ran as scalar FMA with weights read from global memory
// at every k, and each 1x1 layer read its 128 x 128 weights from L2 four
// times a block (about 77 MB a launch). This one:
//   * persistent blocks; two consumer warpgroups, each on its own 64-pixel
//     tile (tiles are runs of 64 consecutive pixels of the flat NHWC map),
//     a producer thread and three gather warps that fill a ring of
//     stages ahead of them (a third consumer warpgroup, with registers
//     moved by setmaxnreg, ran 15 % slower on an H100:
//     profile_psm_conv's gnet_three_wg);
//   * resident weights: the producer copies the packed operands
//     (kernels/gnet_update.py::gnet_operands: w0 as (9 D, 128) in K blocks
//     of 64, w1 and w2 as two K blocks each, all in the 128-byte swizzle)
//     once per block with the bulk-copy engine; the biases and the last
//     layer's weights sit in shared memory as f32;
//   * layer 0 on wgmma: the gather warps copy each tile's 64 x 9 D im2col
//     matrix from the cost volume (D need not be a multiple of 16 bytes, so
//     they copy 2-byte values; columns past 9 D stay zero), one m64n128k16
//     step per 16 columns of each K block of 64;
//   * the feature term, 16 KB a tile, is streamed by the producer with one
//     bulk copy per pixel into rows padded to 272 bytes (no bank conflict
//     in the fragment's reads) and added to layer 0's accumulators in
//     registers;
//   * layers 1 and 2 take their A operand from registers: the previous
//     layer's results, bias and ReLU applied and rounded to bf16 pairs,
//     are the next wgmma's A fragments (as head_chain.cu's 1x1 layers), so
//     no hidden tile touches shared memory;
//   * layer 3 (128 -> 2) and the update run in f32 on each thread's
//     fragment: per-thread dot products, reduced over the four threads of
//     a row with shuffles; prev is loaded before the products.
// Every wgmma wait is unconditional and the accumulators are only read.
// The f32 path keeps the FMA kernel (SimtCore), which equals a
// full-precision reference.

#include "common.cuh"
#include "hopper.cuh"

namespace mt {

constexpr int GN_MAX_D = 16;

struct GnetArgs {
  const void* cv;      // (B, H, W, D)
  const void* feat;    // (B, H, W, 128): conv0_feat(x) + bias
  const void* prev;    // (B, H, W, 2): (mu0, sigma0)
  const void* w0;      // (9 * D, 128), taps row-major (ky, kx, d)
  const void* w1;      // (128, 128)
  const void* w2;      // (128, 128)
  const void* w3;      // (128, 2)
  const float* b1;     // (128,)
  const float* b2;     // (128,)
  const float* b3;     // (2,)
  void* out;           // (B, H, W, 2)
  int B, H, W, D;
};

__device__ __forceinline__ float to_f(float v) { return v; }

// Shared memory: the patch (64 x 9D floats), then the two hidden tiles.
__host__ __device__ constexpr int gnet_patch_bytes(int D) { return HBM * 9 * D * 4; }
template <typename T>
constexpr int gnet_smem_bytes(int D) {
  return gnet_patch_bytes(D) + 2 * HBM * HidCfg<T>::LDH * (int)sizeof(T);
}

template <typename T, class Core>
__global__ void __launch_bounds__(THREADS) gnet_update_kernel(GnetArgs g) {
  constexpr int LDH = HidCfg<T>::LDH;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* patch = reinterpret_cast<float*>(smem_raw);
  T* hid0 = reinterpret_cast<T*>(smem_raw + gnet_patch_bytes(g.D));
  T* hid1 = hid0 + HBM * LDH;

  const int m0 = blockIdx.x * HBM;
  const int hw = g.H * g.W;
  const int M = g.B * hw;
  const int K0 = 9 * g.D;
  const T* cv = static_cast<const T*>(g.cv);

  // The 3x3 neighbourhoods of the block's 64 pixels, zero padded.
  for (int i = threadIdx.x; i < HBM * K0; i += THREADS) {
    const int row = i / K0, k = i - row * K0;
    const int tap = k / g.D, d = k - tap * g.D;
    const int m = m0 + row;
    float v = 0.f;
    if (m < M) {
      const int b = m / hw, rem = m - b * hw;
      const int y = rem / g.W + tap / 3 - 1, x = rem % g.W + tap % 3 - 1;
      if (y >= 0 && y < g.H && x >= 0 && x < g.W)
        v = to_f(cv[((size_t)(b * g.H + y) * g.W + x) * g.D + d]);
    }
    patch[i] = v;
  }
  __syncthreads();

  // Layer 0: thread (n, half) owns channel n of rows half, half + 2, ...
  {
    constexpr int RPT = HBM / (THREADS / HID);   // rows per thread
    const int n = threadIdx.x % HID, half = threadIdx.x / HID;
    const T* w0 = static_cast<const T*>(g.w0);
    const T* feat = static_cast<const T*>(g.feat);
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    for (int k = 0; k < K0; ++k) {
      const float wv = to_f(w0[k * HID + n]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(patch[(half + i * (THREADS / HID)) * K0 + k], wv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = half + i * (THREADS / HID);
      float y = acc[i];
      if (m0 + row < M) y += to_f(feat[(size_t)(m0 + row) * HID + n]);
      hid0[row * LDH + n] = from_f<T>(fmaxf(y, 0.f));
    }
  }
  __syncthreads();

  chain_layer(hid0, hid1, static_cast<T*>(nullptr), static_cast<const T*>(g.w1), g.b1, HID,
              true, nullptr, m0, M, static_cast<Core*>(nullptr));
  __syncthreads();
  chain_layer(hid1, hid0, static_cast<T*>(nullptr), static_cast<const T*>(g.w2), g.b2, HID,
              true, nullptr, m0, M, static_cast<Core*>(nullptr));
  __syncthreads();

  // Last layer and the update, f32: lanes 4r .. 4r + 3 share pixel r.
  {
    const int row = threadIdx.x / 4, part = threadIdx.x % 4;
    const T* w3 = static_cast<const T*>(g.w3);
    float y0 = 0.f, y1 = 0.f;
#pragma unroll 8
    for (int k = part * (HID / 4); k < (part + 1) * (HID / 4); ++k) {
      const float h = to_f(hid0[row * LDH + k]);
      y0 = fmaf(h, to_f(w3[2 * k]), y0);
      y1 = fmaf(h, to_f(w3[2 * k + 1]), y1);
    }
    y0 += __shfl_xor_sync(0xffffffffu, y0, 1);
    y1 += __shfl_xor_sync(0xffffffffu, y1, 1);
    y0 += __shfl_xor_sync(0xffffffffu, y0, 2);
    y1 += __shfl_xor_sync(0xffffffffu, y1, 2);
    const int m = m0 + row;
    if (part == 0 && m < M) {
      y0 += g.b3[0];
      y1 += g.b3[1];
      const T* prev = static_cast<const T*>(g.prev) + (size_t)m * 2;
      const float mu0 = to_f(prev[0]), sigma0 = to_f(prev[1]);
      const float elu = y1 > 0.f ? y1 : expm1f(y1);
      T* out = static_cast<T*>(g.out) + (size_t)m * 2;
      out[0] = from_f<T>(mu0 + y0 * sigma0);
      out[1] = from_f<T>((elu + 1.f + 1e-10f) * sigma0);
    }
  }
}

template <typename T, class Core>
int launch_gnet(const GnetArgs& g, cudaStream_t s) {
  const int smem = gnet_smem_bytes<T>(g.D);
  cudaError_t err = cudaFuncSetAttribute(gnet_update_kernel<T, Core>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         gnet_smem_bytes<T>(GN_MAX_D));
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)g.B * g.H * g.W;
  dim3 grid((unsigned)((M + HBM - 1) / HBM));
  gnet_update_kernel<T, Core><<<grid, THREADS, smem, s>>>(g);
  return (int)cudaGetLastError();
}

// ---- bf16: persistent, resident weights, wgmma -----------------------------

namespace gx {

constexpr int CONSUMERS = 256;   // two warpgroups, a tile each
constexpr int GATHERERS = 96;     // three warps gather the im2col tiles
constexpr int THREADS = CONSUMERS + 32 + GATHERERS;
constexpr int TM = 64;           // pixels of a tile
constexpr int SLAB = 128 * 128;  // bytes of a K block of weights: 128 rows of 64 bf16
constexpr int ABLK = TM * 128;   // bytes of a K block of the im2col tile
constexpr int FROW = 128 * 2 + 16;  // a feature row in shared memory, padded
constexpr int FSTAGE = TM * FROW;
constexpr int MAX_STAGES = 4;
// f32 parameters in shared memory: b1, b2, w3 (128 x 2, row-major), b3
constexpr int P_B1 = 0, P_B2 = 128, P_W3 = 256, P_B3 = 512, NPAR = 516;

struct Args {
  const bf16* cv;     // (B, H, W, D)
  const bf16* feat;   // (B, H, W, 128)
  const bf16* prev;   // (B, H, W, 2)
  const bf16* w0;     // nkb0 K blocks of (128, 64), swizzled
  const bf16* w1;     // 2 K blocks of (128, 64), swizzled
  const bf16* w2;
  const float* w3;    // (128, 2)
  const float* b1;    // (128,)
  const float* b2;    // (128,)
  const float* b3;    // (2,)
  bf16* out;          // (B, H, W, 2)
  int H, W, D, M, nkb0, tiles, stages;
  int off_w1, off_w2, off_par, off_a, off_f, off_bar, smem;
};

// Lays out shared memory: the weights, the parameters, `stages` im2col
// tiles and feature tiles, the barriers; as many stages as fit, at most
// MAX_STAGES and at least 2. Returns false where two do not fit.
inline bool layout(Args& a) {
  a.off_w1 = a.nkb0 * SLAB;
  a.off_w2 = a.off_w1 + 2 * SLAB;
  a.off_par = a.off_w2 + 2 * SLAB;
  a.off_a = a.off_par + (NPAR * 4 + 1023) / 1024 * 1024;
  for (a.stages = MAX_STAGES; a.stages >= 2; --a.stages) {
    a.off_f = a.off_a + a.stages * a.nkb0 * ABLK;
    a.off_bar = a.off_f + a.stages * FSTAGE;
    a.smem = a.off_bar + (2 + 3 * MAX_STAGES) * 8 + 1024;  // + alignment
    if (a.smem <= 232448) return true;
  }
  return false;
}

// The gather warps: for each of the block's tiles, its im2col matrix (row r:
// the 3x3 neighbourhood of pixel m0 + r, column tap * D + d) into stage
// seq % stages once the consumers have released it. Thread bt copies the D
// values of (row, tap) pairs bt, bt + GATHERERS, ...
__device__ __forceinline__ void gather_tiles(const Args& a, unsigned char* smem, uint64_t* afull,
                                            uint64_t* empty, int bt) {
  const uint16_t* cv = reinterpret_cast<const uint16_t*>(a.cv);
  const int hw = a.H * a.W;
  int seq = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++seq) {
    const int st = seq % a.stages;
    if (seq >= a.stages) hp::mbar_wait(&empty[st], (seq / a.stages - 1) & 1);
    unsigned char* A = smem + a.off_a + st * a.nkb0 * ABLK;
    const int m0 = t * TM;
    for (int i = bt; i < TM * 9; i += GATHERERS) {
      const int row = i / 9, tap = i - 9 * row;
      const int m = m0 + row;
      const int b = m / hw, rem = m - b * hw;
      const int y = rem / a.W + tap / 3 - 1, x = rem % a.W + tap % 3 - 1;
      const bool ok = m < a.M && y >= 0 && y < a.H && x >= 0 && x < a.W;
      const uint16_t* src = cv + ((size_t)(b * a.H + y) * a.W + x) * a.D;
      for (int d = 0, k = tap * a.D; d < a.D; ++d, ++k) {
        const uint16_t v = ok ? __ldg(src + d) : (uint16_t)0;
        *reinterpret_cast<uint16_t*>(A + (k >> 6) * ABLK + hp::swizzled(row, (k & 63) >> 3, 128) +
                                     (k & 7) * 2) = v;
      }
    }
    hp::fence_proxy_async();
    hp::mbar_arrive(&afull[st]);
  }
}

// The producer thread: the weights once, then each tile's feature rows.
__device__ __forceinline__ void stream(const Args& a, unsigned char* smem, uint64_t* wbar,
                                       uint64_t* ffull, uint64_t* empty) {
  hp::mbar_arrive_expect_tx(&wbar[0], a.nkb0 * SLAB);
  hp::bulk_g2s(smem, a.w0, a.nkb0 * SLAB, &wbar[0]);
  hp::mbar_arrive_expect_tx(&wbar[1], 4 * SLAB);
  hp::bulk_g2s(smem + a.off_w1, a.w1, 2 * SLAB, &wbar[1]);
  hp::bulk_g2s(smem + a.off_w2, a.w2, 2 * SLAB, &wbar[1]);
  int seq = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++seq) {
    const int st = seq % a.stages;
    if (seq >= a.stages) hp::mbar_wait(&empty[st], (seq / a.stages - 1) & 1);
    const int m0 = t * TM, rows = min(TM, a.M - m0);
    unsigned char* F = smem + a.off_f + st * FSTAGE;
    hp::mbar_arrive_expect_tx(&ffull[st], rows * 256);
    for (int r = 0; r < rows; ++r)
      hp::bulk_g2s(F + r * FROW, a.feat + (size_t)(m0 + r) * 128, 256, &ffull[st]);
  }
}

__device__ __forceinline__ uint32_t bf2(float v0, float v1) {
  __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<uint32_t*>(&p);
}

// A 1x1 layer 128 -> 128 on the register operand `frag` (the previous
// layer's m64 x 128 results as bf16 pairs) and the two K blocks at w.
__device__ __forceinline__ void layer_1x1(float (&acc)[64], const uint32_t (&frag)[8][4],
                                          const unsigned char* w) {
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hp::wgmma_rs<128>(acc, frag[kk], hp::desc_sw128(w + (kk / 4) * SLAB + 32 * (kk % 4), 1024),
                      kk != 0);
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) hp::fence_operand(acc[i]);
}

__global__ void __launch_bounds__(THREADS, 1) gnet_update_hopper(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_dyn[];
  unsigned char* smem = smem_dyn + ((1024 - (hp::smem_addr(smem_dyn) & 1023)) & 1023);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + a.off_bar);  // w0; w1 and w2
  uint64_t* afull = wbar + 2;
  uint64_t* ffull = afull + MAX_STAGES;
  uint64_t* empty = ffull + MAX_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    hp::mbar_init(&wbar[0], 1);
    hp::mbar_init(&wbar[1], 1);
    for (int s = 0; s < a.stages; ++s) {
      hp::mbar_init(&afull[s], GATHERERS);
      hp::mbar_init(&ffull[s], 1);
      hp::mbar_init(&empty[s], 4);  // the warps of the warpgroup that used it
    }
    hp::mbar_fence_init();
  }
  float* par = reinterpret_cast<float*>(smem + a.off_par);
  for (int i = tid; i < NPAR; i += THREADS)
    par[i] = i < P_B2 ? a.b1[i] : i < P_W3 ? a.b2[i - P_B2] : i < P_B3 ? a.w3[i - P_W3]
                                                                      : i < P_B3 + 2 ? a.b3[i - P_B3] : 0.f;
  // the im2col tiles' columns past 9 D stay zero
  uint4* atiles = reinterpret_cast<uint4*>(smem + a.off_a);
  for (int i = tid; i < a.stages * a.nkb0 * ABLK / 16; i += THREADS)
    atiles[i] = make_uint4(0u, 0u, 0u, 0u);
  hp::fence_proxy_async();
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid >= CONSUMERS + 32)
      gather_tiles(a, smem, afull, empty, tid - CONSUMERS - 32);
    else if (tid == CONSUMERS)
      stream(a, smem, wbar, ffull, empty);
    return;
  }

  const int wg = tid / 128, wt = tid % 128;
  const int r0 = hp::frag_row(wt, 0);  // the thread's rows: r0 and r0 + 8
  const bool lead = (tid & 31) == 0;
  const uint32_t* prev = reinterpret_cast<const uint32_t*>(a.prev);
  uint32_t* out = reinterpret_cast<uint32_t*>(a.out);
  float acc[64];
  uint32_t frag[8][4];
  hp::mbar_wait(&wbar[0], 0);
  for (int seq = wg;; seq += CONSUMERS / 128) {
    const int t = blockIdx.x + seq * gridDim.x;
    if (t >= a.tiles) break;
    const int st = seq % a.stages;
    const uint32_t ph = (seq / a.stages) & 1;
    const int m0 = t * TM;
    uint32_t pv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) pv[h] = __ldg(prev + min(m0 + r0 + 8 * h, a.M - 1));

    // layer 0: the im2col tile times w0, K block by K block
    hp::mbar_wait(&afull[st], ph);
    const unsigned char* A = smem + a.off_a + st * a.nkb0 * ABLK;
#pragma unroll 1
    for (int kb = 0; kb < a.nkb0; ++kb) {
      hp::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hp::wgmma_ss<128>(acc, hp::desc_sw128(A + kb * ABLK + 32 * k, 1024),
                          hp::desc_sw128(smem + kb * SLAB + 32 * k, 1024), (kb | k) != 0);
      hp::wgmma_commit();
    }
    hp::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) hp::fence_operand(acc[i]);

    // + the feature term, ReLU, bf16: layer 1's A fragments (register
    // 4 j + 2 h is element 2 (j % 2) + h of k16 step j / 2's)
    hp::mbar_wait(&ffull[st], ph);
    const unsigned char* Fs = smem + a.off_f + st * FSTAGE;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * (wt % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Fs + (r0 + 8 * h) * FROW + 2 * col));
        frag[j / 2][2 * (j % 2) + h] =
            bf2(fmaxf(acc[4 * j + 2 * h] + f.x, 0.f), fmaxf(acc[4 * j + 2 * h + 1] + f.y, 0.f));
      }
    }
    __syncwarp();
    if (lead) hp::mbar_arrive(&empty[st]);

    hp::mbar_wait(&wbar[1], 0);
    layer_1x1(acc, frag, smem + a.off_w1);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(par + P_B1 + 8 * j + 2 * (wt % 4));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        frag[j / 2][2 * (j % 2) + h] = bf2(fmaxf(acc[4 * j + 2 * h] + bv.x, 0.f),
                                           fmaxf(acc[4 * j + 2 * h + 1] + bv.y, 0.f));
    }
    layer_1x1(acc, frag, smem + a.off_w2);

    // layer 2's bias, ReLU and bf16 rounding, then layer 3 in f32: y[h][o]
    // is output o of row r0 + 8 h over this thread's 32 columns
    float y[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * (wt % 4);
      const float2 bv = *reinterpret_cast<const float2*>(par + P_B2 + col);
      const float4 w3 = *reinterpret_cast<const float4*>(par + P_W3 + 2 * col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = __bfloat1622float2(__floats2bfloat162_rn(
            fmaxf(acc[4 * j + 2 * h] + bv.x, 0.f), fmaxf(acc[4 * j + 2 * h + 1] + bv.y, 0.f)));
        y[h][0] = fmaf(v.x, w3.x, fmaf(v.y, w3.z, y[h][0]));
        y[h][1] = fmaf(v.x, w3.y, fmaf(v.y, w3.w, y[h][1]));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        y[h][o] += __shfl_xor_sync(0xffffffffu, y[h][o], 1);
        y[h][o] += __shfl_xor_sync(0xffffffffu, y[h][o], 2);
      }
    // the update: thread 4 q + h of a quad stores row r0 + 8 h
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r0 + 8 * h;
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pv[h]));
      const float mu1 = y[h][0] + par[P_B3], s1 = y[h][1] + par[P_B3 + 1];
      const float elu = s1 > 0.f ? s1 : expm1f(s1);
      if (wt % 4 == h && m < a.M) out[m] = bf2(p.x + mu1 * p.y, (elu + 1.f + 1e-10f) * p.y);
    }
  }
}

}  // namespace gx

}  // namespace mt

// dtype: 0 f32, 1 bf16 (of cv, feat, prev and out). f32: w0 (9 D, 128), w1
// and w2 (128, 128), w3 (128, 2), all f32; bf16: w0, w1, w2 packed by
// gnet_update.py::gnet_operands, w3 (128, 2) f32 (the bf16 weights' values).
// The biases are f32. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a D the kernel does not take.
extern "C" int mt_gnet_update(int dtype, const void* cv, const void* feat, const void* prev,
                              const void* w0, const void* w1, const void* w2,
                              const void* w3, const void* b1, const void* b2,
                              const void* b3, void* out, int B, int H, int W, int D,
                              void* stream) {
  using namespace mt;
  if (D < 1 || D > GN_MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    gx::Args a{};
    a.cv = static_cast<const bf16*>(cv);
    a.feat = static_cast<const bf16*>(feat);
    a.prev = static_cast<const bf16*>(prev);
    a.w0 = static_cast<const bf16*>(w0);
    a.w1 = static_cast<const bf16*>(w1);
    a.w2 = static_cast<const bf16*>(w2);
    a.w3 = static_cast<const float*>(w3);
    a.b1 = static_cast<const float*>(b1);
    a.b2 = static_cast<const float*>(b2);
    a.b3 = static_cast<const float*>(b3);
    a.out = static_cast<bf16*>(out);
    a.H = H;
    a.W = W;
    a.D = D;
    const long long M = (long long)B * H * W;
    if (M >= (1ll << 31) - gx::TM) return (int)cudaErrorInvalidValue;
    a.M = (int)M;
    a.nkb0 = (9 * D + 63) / 64;
    a.tiles = (int)((M + gx::TM - 1) / gx::TM);
    if (a.tiles == 0) return (int)cudaSuccess;
    if (!gx::layout(a)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(gx::gnet_update_hopper,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    int dev = 0, sms = 132;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    gx::gnet_update_hopper<<<a.tiles < sms ? a.tiles : sms, gx::THREADS, a.smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  GnetArgs g{cv, feat, prev, w0, w1, w2, w3,
             static_cast<const float*>(b1), static_cast<const float*>(b2),
             static_cast<const float*>(b3), out, B, H, W, D};
  return launch_gnet<float, SimtCore<HBM, HID>>(g, s);
}
