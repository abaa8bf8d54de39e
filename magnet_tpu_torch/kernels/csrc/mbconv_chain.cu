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
// block is three launches here:
//   (a) expand + depthwise: a block owns a 10x12-pixel halo tile (8x10
//       outputs at K = 3, 6x8 at K = 5) and 64 of the M expanded channels;
//       it runs the expand GEMM over the halo tile (common.cuh's tile product
//       and K loop, rows gathered by gather.cuh), writes swish(+ s1) into
//       shared memory (zero outside the image: the depthwise conv pads e, not
//       x), applies the taps, shift and swish, writes d and adds its channel
//       sums of d into an f32 (N, M) pool with atomics;
//   (b) the SE MLP, M -> R -> M, one 1024-thread block per frame;
//   (c) the projection GEMM over d, the gate applied to A as it is staged,
//       shift and residual in the epilogue.
// The halo costs (10*12)/(8*10) = 1.5x the expand GEMM at K = 3 and 2.5x at
// K = 5. Bound on an H100: tensor-core operations at the wide stages, bytes
// (d written and read back) at stage 1.
// bf16 runs the GEMMs on the tensor cores (WMMA, f32 accumulate), f32 as FMA.

#include "gather.cuh"

namespace mt {

constexpr int MB_HH = 10, MB_HW = 12;     // expand tile with its halo: 120 of 128 rows
constexpr int MB_BM = 128, MB_BN = 64;

template <typename T, class Core, int K>
__global__ void __launch_bounds__(THREADS)
mb_expand_dw_kernel(GatherArgs ga, const float* __restrict__ s1, const T* __restrict__ wdw,
                    const float* __restrict__ s2, T* __restrict__ d_out,
                    float* __restrict__ pool, int H, int W, int M) {
  using L = GatherLoader<T, MB_BM, MB_BN>;
  constexpr int OH = MB_HH - K + 1, OW = MB_HW - K + 1, R = K / 2;
  constexpr int LDE = MB_BN + TileCfg<T>::PAD;
  // bf16: the expanded tile starts past the MMA epilogue's scratch
  constexpr int EOFF = sizeof(T) == 2 ? THREADS / 32 * 256 * (int)sizeof(float) : 0;
  constexpr int ESZ = EOFF + MB_BM * LDE * (int)sizeof(T);
  constexpr int SMEM = L::SMEM > ESZ ? L::SMEM : ESZ;
  static_assert(L::SMEM >= EOFF, "scratch");
  __shared__ __align__(128) unsigned char smem_raw[SMEM];

  const int tiles_w = (W + OW - 1) / OW, tiles_h = (H + OH - 1) / OH;
  const int n = blockIdx.x / (tiles_h * tiles_w);
  const int t = blockIdx.x - n * tiles_h * tiles_w;
  const int oy0 = (t / tiles_w) * OH, ox0 = (t % tiles_w) * OW;
  const int m0 = blockIdx.y * MB_BN;

  L ld(ga, m0, [&](int row, int& pn, int& py, int& px) {
    pn = n;
    py = oy0 - R + row / MB_HW;
    px = ox0 - R + row % MB_HW;
    return row < MB_HH * MB_HW;
  });
  Core core;
  run_mainloop(core, ld, reinterpret_cast<T*>(smem_raw));

  T* et = reinterpret_cast<T*>(smem_raw + EOFF);
  core.epilogue(reinterpret_cast<float*>(smem_raw),
                [&](int row, int col, const float* v, int cnt) {
                  const int hy = oy0 - R + row / MB_HW, hx = ox0 - R + row % MB_HW;
                  const bool in = row < MB_HH * MB_HW && hy >= 0 && hy < H && hx >= 0 &&
                                  hx < W;
                  for (int e = 0; e < cnt; ++e) {
                    const int m = m0 + col + e;
                    float y = 0.f;
                    if (in && m < M) y = swish(v[e] + s1[m]);
                    et[row * LDE + col + e] = from_f<T>(y);
                  }
                });
  __syncthreads();

  // depthwise over the expanded tile: thread (pg, c) takes channel c of
  // every (THREADS / MB_BN)-th output pixel
  const int c = threadIdx.x % MB_BN, pg = threadIdx.x / MB_BN;
  const int m = m0 + c;
  if (m >= M) return;
  float taps[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) taps[i] = to_f(wdw[(size_t)i * M + m]);
  const float sh = s2[m];
  float part = 0.f;
  for (int p = pg; p < OH * OW; p += THREADS / MB_BN) {
    const int oy = p / OW, ox = p % OW;
    const int gy = oy0 + oy, gx = ox0 + ox;
    if (gy >= H || gx >= W) continue;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
        acc = fmaf(to_f(et[((oy + dy) * MB_HW + ox + dx) * LDE + c]), taps[dy * K + dx], acc);
    const T dv = from_f<T>(swish(acc + sh));
    d_out[(((size_t)n * H + gy) * W + gx) * M + m] = dv;
    part += to_f(dv);
  }
  atomicAdd(pool + (size_t)n * M + m, part);
}

// The SE MLP of one frame: mean = pool / (H*W); r = swish(mean @ w1 + b1)
// (R); gate = sigmoid(r @ w2 + b2) (M). One 1024-thread block per frame:
// the first layer's M sum is split S = 1024 / R ways, and every loop keeps
// four independent sums so that four weight loads are in flight per
// thread (the loads, not the 2*M*R operations, set its time). Shared:
// M + S*R + R floats.
constexpr int SE_THREADS = 1024;

__global__ void __launch_bounds__(SE_THREADS)
mb_se_kernel(const float* __restrict__ pool, const float* __restrict__ w1,
             const float* __restrict__ b1, const float* __restrict__ w2,
             const float* __restrict__ b2, float* __restrict__ gate, int M, int R,
             float inv_hw) {
  extern __shared__ float se_smem[];
  const int S = max(1, SE_THREADS / R);     // splits of the M sum
  float* mean = se_smem;
  float* part = mean + M;
  float* red = part + S * R;
  const int n = blockIdx.x;
  for (int i = threadIdx.x; i < M; i += SE_THREADS) mean[i] = pool[(size_t)n * M + i] * inv_hw;
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * S; idx += SE_THREADS) {
    const int j = idx % R, s = idx / R;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int i = s;
    for (; i + 3 * S < M; i += 4 * S) {
      a0 = fmaf(mean[i], w1[(size_t)i * R + j], a0);
      a1 = fmaf(mean[i + S], w1[(size_t)(i + S) * R + j], a1);
      a2 = fmaf(mean[i + 2 * S], w1[(size_t)(i + 2 * S) * R + j], a2);
      a3 = fmaf(mean[i + 3 * S], w1[(size_t)(i + 3 * S) * R + j], a3);
    }
    for (; i < M; i += S) a0 = fmaf(mean[i], w1[(size_t)i * R + j], a0);
    part[s * R + j] = (a0 + a1) + (a2 + a3);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < R; j += SE_THREADS) {
    float acc = b1[j];
    for (int s = 0; s < S; ++s) acc += part[s * R + j];
    red[j] = swish(acc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += SE_THREADS) {
    float a0 = b2[i], a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int j = 0;
    for (; j + 3 < R; j += 4) {
      a0 = fmaf(red[j], w2[(size_t)j * M + i], a0);
      a1 = fmaf(red[j + 1], w2[(size_t)(j + 1) * M + i], a1);
      a2 = fmaf(red[j + 2], w2[(size_t)(j + 2) * M + i], a2);
      a3 = fmaf(red[j + 3], w2[(size_t)(j + 3) * M + i], a3);
    }
    for (; j < R; ++j) a0 = fmaf(red[j], w2[(size_t)j * M + i], a0);
    gate[(size_t)n * M + i] = 1.f / (1.f + expf(-((a0 + a1) + (a2 + a3))));
  }
}

// The projection: ga.x = d (N, H, W, M), ga.gate = the SE gate, ga.w = wpwl
// (M, C); out = round(acc + s3) + res.
template <typename T, class Core>
__global__ void __launch_bounds__(THREADS)
mb_project_kernel(GatherArgs ga, const float* __restrict__ s3, const T* __restrict__ res,
                  T* __restrict__ out, int N, int C) {
  using L = GatherLoader<T, MB_BM, MB_BN>;
  static_assert(L::SMEM >= THREADS / 32 * 256 * (int)sizeof(float), "scratch");
  __shared__ __align__(128) unsigned char smem_raw[L::SMEM];
  const int hw = ga.H * ga.W, Mtot = N * hw;
  const int m0 = blockIdx.x * MB_BM, n0 = blockIdx.y * MB_BN;
  L ld(ga, n0, [&](int row, int& pn, int& py, int& px) {
    const int m = m0 + row;
    const int mm = m < Mtot ? m : 0;
    pn = mm / hw;
    const int rem = mm - pn * hw;
    py = rem / ga.W;
    px = rem - py * ga.W;
    return m < Mtot;
  });
  Core core;
  run_mainloop(core, ld, reinterpret_cast<T*>(smem_raw));
  core.epilogue(reinterpret_cast<float*>(smem_raw),
                [&](int row, int col, const float* v, int cnt) {
                  const int m = m0 + row, nn = n0 + col;
                  if (m >= Mtot || nn >= C) return;
                  const size_t at = (size_t)m * C + nn;
                  for (int e = 0; e < cnt; ++e) {
                    const float y = to_f(from_f<T>(v[e] + s3[nn + e]));
                    out[at + e] = from_f<T>(y + to_f(res[at + e]));
                  }
                });
}

struct MbArgs {
  const void *x, *wpw, *wdw, *wpwl;
  const float *s1, *s2, *wse1, *bse1, *wse2, *bse2, *s3;
  void* d;
  float* pool;
  float* gate;
  void* out;
  int N, H, W, C, M, R, K;
};

template <typename T, class Core>
int launch_mb_block(const MbArgs& a, cudaStream_t s) {
  int err;
  const int oh = MB_HH - a.K + 1, ow = MB_HW - a.K + 1;
  dim3 ga_grid((unsigned)(a.N * ((a.H + oh - 1) / oh) * ((a.W + ow - 1) / ow)),
               (unsigned)((a.M + MB_BN - 1) / MB_BN));
  GatherArgs ex{a.x, a.wpw, nullptr, a.H, a.W, a.C, a.M, a.M, 1, 1};
  if (a.K == 3)
    mb_expand_dw_kernel<T, Core, 3><<<ga_grid, THREADS, 0, s>>>(
        ex, a.s1, static_cast<const T*>(a.wdw), a.s2, static_cast<T*>(a.d), a.pool, a.H,
        a.W, a.M);
  else if (a.K == 5)
    mb_expand_dw_kernel<T, Core, 5><<<ga_grid, THREADS, 0, s>>>(
        ex, a.s1, static_cast<const T*>(a.wdw), a.s2, static_cast<T*>(a.d), a.pool, a.H,
        a.W, a.M);
  else
    return (int)cudaErrorInvalidValue;
  if ((err = (int)cudaGetLastError())) return err;

  const int S = SE_THREADS / a.R > 1 ? SE_THREADS / a.R : 1;
  const size_t se_smem = (size_t)(a.M + S * a.R + a.R) * sizeof(float);
  mb_se_kernel<<<a.N, SE_THREADS, se_smem, s>>>(a.pool, a.wse1, a.bse1, a.wse2, a.bse2,
                                             a.gate, a.M, a.R,
                                             1.f / (float)(a.H * a.W));
  if ((err = (int)cudaGetLastError())) return err;

  GatherArgs pr{a.d, a.wpwl, a.gate, a.H, a.W, a.M, a.C, a.C, 1, 1};
  const long long rows = (long long)a.N * a.H * a.W;
  dim3 pr_grid((unsigned)((rows + MB_BM - 1) / MB_BM), (unsigned)((a.C + MB_BN - 1) / MB_BN));
  mb_project_kernel<T, Core><<<pr_grid, THREADS, 0, s>>>(
      pr, a.s3, static_cast<const T*>(a.x), static_cast<T*>(a.out), a.N, a.C);
  return (int)cudaGetLastError();
}

}  // namespace mt

// One block of the chain, three launches. dtype: 0 f32, 1 bf16. x: (N, H, W,
// C); wpw: (C, M); wdw: (K*K, M); wpwl: (M, C), all of x's type; s1, s2,
// bse2: (M,); wse1: (M, R); bse1: (R,); wse2: (R, M); s3: (C,), f32. d: (N,
// H, W, M) scratch of x's type; pool: (N, M) f32 zeros; gate: (N, M) f32
// scratch; out: (N, H, W, C). C and M multiples of 16 bytes; K 3 or 5.
// Returns the first cudaGetLastError() that is not 0.
extern "C" int mt_mbconv_block(int dtype, const void* x, const void* wpw, const void* s1,
                               const void* wdw, const void* s2, const void* wse1,
                               const void* bse1, const void* wse2, const void* bse2,
                               const void* wpwl, const void* s3, void* d, void* pool,
                               void* gate, void* out, int N, int H, int W, int C, int M,
                               int R, int K, void* stream) {
  using namespace mt;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  MbArgs a{x,       wpw,      wdw,      wpwl,     f(s1),    f(s2),
           f(wse1), f(bse1),  f(wse2),  f(bse2),  f(s3),    d,
           static_cast<float*>(pool), static_cast<float*>(gate), out,
           N,       H,        W,        C,        M,        R,        K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_mb_block<bf16, MmaCore<128, 64, 4, 2>>(a, s);
  return launch_mb_block<float, SimtCore<128, 64>>(a, s);
}
