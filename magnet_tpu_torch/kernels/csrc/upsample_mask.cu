// Learned convex upsampling by k, NHWC.
//
// Replaces the TPU kernel magnet_tpu/kernels/upsample_pallas.py
// (upsample_via_mask_pallas): per coarse pixel and sub-pixel (ki, kj), a
// softmax in f32 over the 9 mask logits mask[..., j, ki, kj], the weighted
// sum of the zero-padded 3x3 neighbourhood of each of the C channels
// (j = ky * 3 + kx), written at (h k + ki, w k + kj).
//
// Bound on an H100: bytes. At the ScanNet eval shape a launch reads the mask
// (5.5 MB in bf16) and the coarse map and writes the fine map (2.5 MB),
// against a few MFLOP.
//
// Design: one thread per fine pixel, ordered (coarse pixel, ki, kj), so the
// k * k threads of a coarse pixel read each of its 9 logit groups as one
// contiguous run and share its neighbourhood through the L1 cache. No
// intermediate reaches device memory.

#include "common.cuh"

namespace mt {

__device__ __forceinline__ float up_f(float v) { return v; }
__device__ __forceinline__ float up_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
upsample_mask_kernel(const T* __restrict__ depth, const T* __restrict__ mask,
                     T* __restrict__ out, int B, int H, int W, int C, int k) {
  const int kk = k * k;
  const long long total = (long long)B * H * W * kk;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int sub = (int)(i % kk);
  const long long pix = i / kk;                 // b * H * W + h * W + w
  const int w = (int)(pix % W);
  const int h = (int)((pix / W) % H);
  const int b = (int)(pix / ((long long)H * W));
  const int ki = sub / k, kj = sub - ki * k;

  const T* m = mask + pix * 9 * kk + sub;
  float p[9];
  float top = -INFINITY;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    p[j] = up_f(m[j * kk]);
    top = fmaxf(top, p[j]);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    p[j] = expf(p[j] - top);
    sum += p[j];
  }
  const float inv = 1.f / sum;

  T* o = out + (((size_t)b * H * k + (size_t)h * k + ki) * W * k + (size_t)w * k + kj) * C;
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int y = h + j / 3 - 1, x = w + j % 3 - 1;
      if (y >= 0 && y < H && x >= 0 && x < W)
        acc = fmaf(p[j] * inv, up_f(depth[(((size_t)b * H + y) * W + x) * C + c]), acc);
    }
    o[c] = from_f<T>(acc);
  }
}

}  // namespace mt

// dtype: 0 f32, 1 bf16 (of depth, mask and out). Returns cudaGetLastError()
// after the launch.
extern "C" int mt_upsample_mask(int dtype, const void* depth, const void* mask, void* out,
                                int B, int H, int W, int C, int k, void* stream) {
  using namespace mt;
  const long long total = (long long)B * H * W * k * k;
  dim3 grid((unsigned)((total + THREADS - 1) / THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    upsample_mask_kernel<bf16><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(depth), static_cast<const bf16*>(mask),
        static_cast<bf16*>(out), B, H, W, C, k);
  else
    upsample_mask_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(depth), static_cast<const float*>(mask),
        static_cast<float*>(out), B, H, W, C, k);
  return (int)cudaGetLastError();
}
