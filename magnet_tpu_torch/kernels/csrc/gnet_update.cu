// G-Net update: one launch per refinement iteration, NHWC.
//
// Replaces the TPU kernel magnet_tpu/kernels/gnet_pallas.py
// (gnet_update_pallas): a SAME 3x3 conv over the D-channel cost volume into
// 128 channels, plus the precomputed feature term, ReLU; two 1x1 convs
// 128 -> 128 with bias and ReLU; a 1x1 conv to 2; then the Gaussian update
//   mu = mu0 + mu1 * sigma0,  sigma = (elu(sigma1) + 1 + 1e-10) * sigma0
// in f32. As on the TPU the hidden 128-channel tiles never reach device
// memory: a block owns 64 pixels, keeps the two hidden tiles in shared
// memory and stores only the 2 output channels. Hidden activations round to
// the compute type between layers, as the TPU kernel's do.
//
// Bound on an H100: bytes. A launch at the ScanNet eval shape reads the
// 128-channel feature term (4.9 MB in bf16) and little else, against
// 1.5 GFLOP; the tensor cores are nowhere near the limit.
//
// Design: the first layer has K = 9 D (45 at D = 5), too thin for a tensor
// core tile, so it runs as FMA from a 64 x 9D patch staged in shared memory
// with scalar loads (D need not be a multiple of 16 bytes, and the cost
// volume is not padded): thread (n, r) owns channel n of 32 pixels. The two
// 128 -> 128 layers are the chained 1x1 layers of common.cuh (WMMA in bf16,
// FMA in f32). The last layer (128 -> 2) and the update stay in f32: four
// lanes split one pixel's K range and reduce with shuffles.

#include "common.cuh"

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
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// Shared memory: the patch (64 x 9D floats; later the WMMA scratch of 8 KB)
// then the two hidden tiles.
__host__ __device__ constexpr int gnet_patch_bytes(int D) {
  return HBM * 9 * D * 4 > 8192 ? HBM * 9 * D * 4 : 8192;
}
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

  float* scratch = patch;   // the patch is dead from here on
  chain_layer(hid0, hid1, static_cast<T*>(nullptr), static_cast<const T*>(g.w1), g.b1, HID,
              true, scratch, m0, M, static_cast<Core*>(nullptr));
  __syncthreads();
  chain_layer(hid1, hid0, static_cast<T*>(nullptr), static_cast<const T*>(g.w2), g.b2, HID,
              true, scratch, m0, M, static_cast<Core*>(nullptr));
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

}  // namespace mt

// dtype: 0 f32, 1 bf16 (of cv, feat, prev, the weights and out; the biases
// are f32). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a D the kernel does not take.
extern "C" int mt_gnet_update(int dtype, const void* cv, const void* feat, const void* prev,
                              const void* w0, const void* w1, const void* w2,
                              const void* w3, const void* b1, const void* b2,
                              const void* b3, void* out, int B, int H, int W, int D,
                              void* stream) {
  using namespace mt;
  if (D < 1 || D > GN_MAX_D) return (int)cudaErrorInvalidValue;
  GnetArgs g{cv, feat, prev, w0, w1, w2, w3,
             static_cast<const float*>(b1), static_cast<const float*>(b2),
             static_cast<const float*>(b3), out, B, H, W, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_gnet<bf16, MmaCore<HBM, HID, 2, 4>>(g, s);
  return launch_gnet<float, SimtCore<HBM, HID>>(g, s);
}
