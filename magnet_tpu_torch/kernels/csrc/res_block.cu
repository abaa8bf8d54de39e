// One stride-1 PSM-Net BasicBlock in one launch, eval BatchNorm folded, NHWC:
//   out = bn2(conv2(relu(bn1(conv1(x))))) + x
// both convs 3x3 with dilation d and padding d, no activation after the sum.
//
// Replaces the TPU kernel magnet_tpu/kernels/resstream_pallas.py
// (resblock_stream), the path for maps too large for the whole-map chains
// (the KITTI shape: 176x608 and 88x304). The TPU version streams row tiles
// down the map with a 2d-row input ring and a 2d-row mid ring carried across
// sequential grid steps, channels lane-padded to 128. GPU blocks run in no
// order, so nothing carries over: a 256-thread block owns an 8x16-pixel
// output tile, computes conv1 on the (8 + 2d) x (16 + 2d) mid tile around it
// (the halo recomputed by the neighbours, 2 GEMM passes of 128 rows), keeps
// mid in shared memory, and runs conv2 from there. Mid positions outside the
// image are stored as zero, as conv2's zero padding needs (relu(bn1(conv1))
// of zero-padded x would be relu(shift) there). Mid never reaches device
// memory: one read of x (the residual from L2) and one write of out per
// pixel. Shared memory: the GEMM stages plus the mid tile, at C = 128, d = 2
// 103 KB in bf16 and 160 KB in f32.
//
// Bound on an H100: tensor-core operations (K = 9 * C per value, C = 32-128);
// the halo recompute doubles conv1's work. bf16 runs on the tensor cores
// (WMMA, f32 accumulate), f32 as FMA.

#include "gather.cuh"

namespace mt {

constexpr int RB_TH = 8, RB_TW = 16;      // output tile: 128 GEMM rows

template <typename T, class Core, int BN>
__global__ void __launch_bounds__(THREADS)
res_block_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ s1,
                 const float* __restrict__ t1, const T* __restrict__ w2,
                 const float* __restrict__ s2, const float* __restrict__ t2,
                 T* __restrict__ out, int H, int W, int C, int dil) {
  using L1 = GatherLoader<T, 128, BN>;
  using L2 = SmemLoader<T, 128, BN>;
  static_assert(L1::SMEM >= THREADS / 32 * 256 * (int)sizeof(float), "scratch");
  extern __shared__ __align__(128) unsigned char rb_smem[];
  T* stages = reinterpret_cast<T*>(rb_smem);
  T* mid = reinterpret_cast<T*>(rb_smem + L1::SMEM);
  const int ldm = C + TileCfg<T>::PAD;
  const int mh = RB_TH + 2 * dil, mw = RB_TW + 2 * dil, nmid = mh * mw;

  const int tiles_w = (W + RB_TW - 1) / RB_TW, tiles_h = (H + RB_TH - 1) / RB_TH;
  const int n = blockIdx.x / (tiles_h * tiles_w);
  const int t = blockIdx.x - n * tiles_h * tiles_w;
  const int y0 = (t / tiles_w) * RB_TH, x0 = (t % tiles_w) * RB_TW;

  // mid = relu(bn1(conv1(x))) on the mid tile, zero outside the image
  const GatherArgs ga{x, w1, nullptr, H, W, C, C, C, 9, dil};
  for (int r0 = 0; r0 < nmid; r0 += 128) {
    for (int n0 = 0; n0 < C; n0 += BN) {
      L1 ld(ga, n0, [&](int row, int& pn, int& py, int& px) {
        const int r = r0 + row;
        pn = n;
        py = y0 - dil + r / mw;
        px = x0 - dil + r % mw;
        return r < nmid;
      });
      Core core;
      run_mainloop(core, ld, stages);
      core.epilogue(reinterpret_cast<float*>(rb_smem),
                    [&](int row, int col, const float* v, int cnt) {
                      const int r = r0 + row;
                      if (r >= nmid) return;
                      const int gy = y0 - dil + r / mw, gx = x0 - dil + r % mw;
                      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
                      for (int e = 0; e < cnt; ++e) {
                        const int c = n0 + col + e;
                        if (c >= C) break;
                        const float y = in ? fmaxf(v[e] * s1[c] + t1[c], 0.f) : 0.f;
                        mid[r * ldm + c] = from_f<T>(y);
                      }
                    });
      __syncthreads();
    }
  }

  // out = bn2(conv2(mid)) + x on the output tile
  for (int n0 = 0; n0 < C; n0 += BN) {
    L2 ld(mid, ldm, mw, RB_TW, w2, C, dil, n0);
    Core core;
    run_mainloop(core, ld, stages);
    core.epilogue(reinterpret_cast<float*>(rb_smem),
                  [&](int row, int col, const float* v, int cnt) {
                    const int gy = y0 + row / RB_TW, gx = x0 + row % RB_TW;
                    if (gy >= H || gx >= W) return;
                    const size_t at = (((size_t)n * H + gy) * W + gx) * C;
                    for (int e = 0; e < cnt; ++e) {
                      const int c = n0 + col + e;
                      if (c >= C) break;
                      out[at + c] = from_f<T>(v[e] * s2[c] + t2[c] + to_f(x[at + c]));
                    }
                  });
    __syncthreads();
  }
}

template <typename T, class Core, int BN>
int launch_res_block(const void* x, const void* w1, const float* s1, const float* t1,
                     const void* w2, const float* s2, const float* t2, void* out, int N,
                     int H, int W, int C, int dil, cudaStream_t s) {
  using L1 = GatherLoader<T, 128, BN>;
  const int mh = RB_TH + 2 * dil, mw = RB_TW + 2 * dil;
  const size_t smem = (size_t)L1::SMEM
                      + (size_t)mh * mw * (C + TileCfg<T>::PAD) * sizeof(T);
  auto kernel = res_block_kernel<T, Core, BN>;
  // raised once per instantiation, before any graph capture replays it
  static size_t allowed = 0;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const int tiles = ((H + RB_TH - 1) / RB_TH) * ((W + RB_TW - 1) / RB_TW);
  kernel<<<(unsigned)(N * tiles), THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), s1, t1,
      static_cast<const T*>(w2), s2, t2, static_cast<T*>(out), H, W, C, dil);
  return (int)cudaGetLastError();
}

}  // namespace mt

// dtype: 0 f32, 1 bf16. x, out: (N, H, W, C); w1, w2: (3, 3, C, C) HWIO of
// x's type; s*, t*: (C,) f32 folded BN. C a multiple of 16 bytes, at most
// 128 (the mid tile must fit in shared memory). Returns cudaGetLastError().
extern "C" int mt_res_block(int dtype, const void* x, const void* w1, const void* s1,
                            const void* t1, const void* w2, const void* s2, const void* t2,
                            void* out, int N, int H, int W, int C, int dil, void* stream) {
  using namespace mt;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C > 128) return (int)cudaErrorInvalidValue;
  const bool narrow = C <= 64;
  if (dtype == 1) {
    if (narrow)
      return launch_res_block<bf16, MmaCore<128, 64, 4, 2>, 64>(
          x, w1, f(s1), f(t1), w2, f(s2), f(t2), out, N, H, W, C, dil, s);
    return launch_res_block<bf16, MmaCore<128, 128, 4, 2>, 128>(
        x, w1, f(s1), f(t1), w2, f(s2), f(t2), out, N, H, W, C, dil, s);
  }
  if (narrow)
    return launch_res_block<float, SimtCore<128, 64>, 64>(
        x, w1, f(s1), f(t1), w2, f(s2), f(t2), out, N, H, W, C, dil, s);
  return launch_res_block<float, SimtCore<128, 128>, 128>(
      x, w1, f(s1), f(t1), w2, f(s2), f(t2), out, N, H, W, C, dil, s);
}
