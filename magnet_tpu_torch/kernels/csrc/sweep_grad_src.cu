// Gradient of the plane-sweep matching cost with respect to the source
// features: the transpose of the bilinear warp.
//
// Replaces the TPU kernel magnet_tpu/kernels/sweepbwd_pallas.py
// (sweep_grad_src_pallas), the backward of the F-Net training sweep
// (magnet_tpu/ops/costvolume.py::_sweep_pre_cost_bwd). It computes the exact
// gradient, what autodiff through the gather gives:
//
//   grad_src[b, v, p, c] = sum over (q, d) of
//       w(q, d -> p) * gbar[b, q, d] * valid[b, v] * ref[b, q, c]
//
// where w are the bilinear weights of reference pixel q at sweep depth d
// projected into view v (the f32 projection of the forward; corners outside
// the map weigh nothing). The TPU kernel put a free 16-row window under each
// pair of reference rows, dropped footprints taller than that and rounded
// the weights to bf16; a GPU scatters to any row, so here there is no window
// and no rounding: it is exact at any camera motion, in f32.
//
// Bound on an H100: at the training shape (B = 2, V = 4, D = 80, 120x160,
// C = 64) the compulsory bytes are about 56 MB (0.017 ms) and the additions
// about 6.3 GFLOP of f32 (0.094 ms at 67 TFLOP/s), so the f32 rate bounds it.
// What the kernel really does is 3.1 G f32 atomic adds into a 39 MB output
// that the L2 cache holds; their throughput sets its time.
//
// Design: one warp owns one (b, v, reference pixel). The reference feature
// stays in registers, lane l holding channels l, l + 32, ...; the warp walks
// the D planes, 32 at a time: lane l loads plane d0 + l's cotangent and depth
// (one coalesced load each) and the warp broadcasts them with shuffles. Per
// plane the warp projects the pixel (every lane the same arithmetic, so the
// branches stay uniform) and, for each in-image corner, adds
// w * gbar * valid * ref[c] to the corner's C channels with f32 atomics:
// 32 lanes on 32 consecutive channels, one coalesced run of reductions. An
// invalid view's warps leave at once; the output is zeroed first. The order
// of the sums is not fixed, so two runs may differ in the last bits.

#include "common.cuh"

namespace mt {

constexpr int SG_MAX_C = 128;           // most channels the kernel takes
constexpr int SG_K = SG_MAX_C / 32;     // channels per lane
constexpr unsigned FULL_MASK = 0xffffffffu;

struct SgArgs {
  const float* depth;  // (D,) sweep depths
  const void* ref;     // (B, H, W, C)
  const float* gbar;   // (B, H, W, D) cotangent of the pre-softmax sum
  const float* R;      // (B, V, 3, 3)
  const float* t;      // (B, V, 3)
  const float* valid;  // (B, V)
  const float* K;      // (B, 3, 3)
  const float* rays;   // (B, 3, H*W)
  float* out;          // (B, V, H, W, C)
  int B, V, H, W, C, D;
};

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(*p); }

template <typename T>
__global__ void __launch_bounds__(THREADS) sweep_grad_src_kernel(SgArgs a) {
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int hw = a.H * a.W;
  // The warp index is the same on all 32 lanes, so a warp leaves whole and
  // the shuffles below always see a full warp.
  if (warp >= (long long)a.B * a.V * hw) return;
  const int bv = (int)(warp / hw);
  const int p = (int)(warp - (long long)bv * hw);
  const int b = bv / a.V;
  const float valid = a.valid[bv];
  if (valid == 0.f) return;

  const T* ref = static_cast<const T*>(a.ref) + ((size_t)b * hw + p) * a.C;
  float q[SG_K];
#pragma unroll
  for (int k = 0; k < SG_K; ++k) {
    const int c = lane + 32 * k;
    q[k] = c < a.C ? load_f(ref + c) : 0.f;
  }

  // K t + K (R ray) d, as the forward projects it
  const float* rays = a.rays + (size_t)b * 3 * hw;
  const float r0 = rays[p], r1 = rays[hw + p], r2 = rays[2 * hw + p];
  const float* K = a.K + b * 9;
  const float* R = a.R + bv * 9;
  const float* t = a.t + bv * 3;
  const float rr0 = R[0] * r0 + R[1] * r1 + R[2] * r2;
  const float rr1 = R[3] * r0 + R[4] * r1 + R[5] * r2;
  const float rr2 = R[6] * r0 + R[7] * r1 + R[8] * r2;
  const float a0 = K[0] * t[0] + K[1] * t[1] + K[2] * t[2];
  const float a1 = K[3] * t[0] + K[4] * t[1] + K[5] * t[2];
  const float a2 = K[6] * t[0] + K[7] * t[1] + K[8] * t[2];
  const float b0 = K[0] * rr0 + K[1] * rr1 + K[2] * rr2;
  const float b1 = K[3] * rr0 + K[4] * rr1 + K[5] * rr2;
  const float b2 = K[6] * rr0 + K[7] * rr1 + K[8] * rr2;
  const float fW = (float)a.W, fH = (float)a.H;

  float* out = a.out + (size_t)bv * hw * a.C;
  const float* gbar = a.gbar + ((size_t)b * hw + p) * a.D;
  for (int d0 = 0; d0 < a.D; d0 += 32) {
    const int dl = d0 + lane;
    const float g_l = dl < a.D ? gbar[dl] * valid : 0.f;
    const float z_l = dl < a.D ? a.depth[dl] : 0.f;
    const int n = min(32, a.D - d0);
    for (int j = 0; j < n; ++j) {
      const float g = __shfl_sync(FULL_MASK, g_l, j);
      const float depth = __shfl_sync(FULL_MASK, z_l, j);
      if (g == 0.f) continue;
      const float denom = (a2 + b2 * depth) + 1e-10f;
      const float u = (a0 + b0 * depth) / denom;
      const float w = (a1 + b1 * depth) / denom;
      const float gx = fminf(fmaxf((u - fW * 0.5f) / (fW * 0.5f), -10.f), 10.f);
      const float gy = fminf(fmaxf((w - fH * 0.5f) / (fH * 0.5f), -10.f), 10.f);
      const float x = ((gx + 1.f) * fW - 1.f) * 0.5f;
      const float y = ((gy + 1.f) * fH - 1.f) * 0.5f;
      const float xf = floorf(x), yf = floorf(y);
      // A NaN coordinate fails every test below and scatters nothing.
      if (!(xf >= -1.f && xf <= fW - 1.f && yf >= -1.f && yf <= fH - 1.f)) continue;
      const int x0 = (int)xf, y0 = (int)yf;
      const float wx1 = x - xf, wy1 = y - yf;
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const int yi = y0 + cy, xi = x0 + cx;
          if (yi < 0 || yi >= a.H || xi < 0 || xi >= a.W) continue;
          const float wg = (cy ? wy1 : 1.f - wy1) * (cx ? wx1 : 1.f - wx1) * g;
          float* o = out + ((size_t)yi * a.W + xi) * a.C;
#pragma unroll
          for (int k = 0; k < SG_K; ++k) {
            const int c = lane + 32 * k;
            if (c < a.C) atomicAdd(o + c, wg * q[k]);
          }
        }
      }
    }
  }
}

}  // namespace mt

// dtype: 0 f32, 1 bf16 (of ref). Zeroes out, then launches; returns the
// first CUDA error (cudaGetLastError() after the launch).
extern "C" int mt_sweep_grad_src(int dtype, const void* depth, const void* ref,
                                 const void* gbar, const void* R, const void* t,
                                 const void* valid, const void* K, const void* rays,
                                 void* out, int B, int V, int H, int W, int C, int D,
                                 void* stream) {
  using namespace mt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = (size_t)B * V * H * W * C * sizeof(float);
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, s);
  if (err != cudaSuccess) return (int)err;
  SgArgs a{static_cast<const float*>(depth), ref, static_cast<const float*>(gbar),
           static_cast<const float*>(R), static_cast<const float*>(t),
           static_cast<const float*>(valid), static_cast<const float*>(K),
           static_cast<const float*>(rays), static_cast<float*>(out),
           B, V, H, W, C, D};
  const long long threads = (long long)B * V * H * W * 32;
  dim3 grid((unsigned)((threads + THREADS - 1) / THREADS));
  if (dtype == 1) sweep_grad_src_kernel<bf16><<<grid, THREADS, 0, s>>>(a);
  else sweep_grad_src_kernel<float><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
