// Fused prediction-head chain: one SAME 3x3 conv C0 -> 128, then up to three
// 1x1 convs (128 -> 128, the last 128 -> c_out <= 256), each with a bias and
// an optional ReLU. NHWC.
//
// Replaces the TPU kernel magnet_tpu/kernels/headchain_pallas.py
// (head_chain_pallas): the D-Net depth and mask heads, the 4-conv MaGNet mask
// head and G-Net's conv0_feat. As on the TPU, the hidden 128-channel tiles
// never reach device memory: a block owns 64 output pixels, accumulates the
// 3x3 conv (the implicit GEMM of common.cuh) into a shared-memory tile, and
// each 1x1 layer reads that tile and writes the next one in shared memory.
// Only the last layer's c_out channels are stored.
//
// Bound on an H100: tensor-core operations. At the ScanNet eval shape the
// 3x3 conv is M = 19200 pixels, N = 128, K = 2304 (11.3 GFLOP) against about
// 10 MB of input, so the 3x3 dominates; the 1x1 layers add 0.6-1.3 GFLOP and
// no traffic. bf16 runs on the tensor cores (WMMA, f32 accumulate; hidden
// tiles rounded to bf16 between layers as the TPU kernel does), f32 as FMA.

#include "common.cuh"

namespace mt {

struct HeadArgs {
  const void* x;
  const void* w[4];   // w[0]: (9*C0, 128); w[l]: (128, pad16(width of layer l))
  const float* b[4];  // (pad16(width),) f32, zero padded
  void* out;          // (N, H, W, c_out)
  int N, H, W, C0, n_convs, c_out, relu_mask;
};

template <typename T>
constexpr int head_smem_bytes() {
  return TileLoader<T, HBM, HID>::SMEM + 2 * HBM * HidCfg<T>::LDH * (int)sizeof(T);
}

template <typename T, class Core>
__global__ void __launch_bounds__(THREADS) head_chain_kernel(HeadArgs h) {
  using L = TileLoader<T, HBM, HID>;
  constexpr int LDH = HidCfg<T>::LDH;
  static_assert(L::SMEM >= THREADS / 32 * 256 * (int)sizeof(float), "scratch");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hid[2] = {reinterpret_cast<T*>(smem_raw + L::SMEM),
               reinterpret_cast<T*>(smem_raw + L::SMEM) + HBM * LDH};
  float* scratch = reinterpret_cast<float*>(smem_raw);  // after the K loop

  const int m0 = blockIdx.x * HBM;
  const int M = h.N * h.H * h.W;
  ConvArgs a{h.x, nullptr, h.w[0], nullptr, h.N, h.H, h.W, h.H, h.W, h.C0, 0, HID, false};
  L ld(a, m0, 0);
  Core core;
  run_mainloop(core, ld, reinterpret_cast<T*>(smem_raw));

  // Layer 0: bias + ReLU into hidden tile 0, or the output if it is the last.
  const bool last0 = h.n_convs == 1;
  const bool relu0 = h.relu_mask & 1;
  T* out = static_cast<T*>(h.out);
  const float* b0 = h.b[0];
  core.epilogue(scratch, [&](int row, int col, const float* v, int cnt) {
    for (int e = 0; e < cnt; ++e) {
      float y = v[e] + b0[col + e];
      if (relu0) y = fmaxf(y, 0.f);
      if (last0) {
        if (m0 + row < M) out[(size_t)(m0 + row) * HID + col + e] = from_f<T>(y);
      } else {
        hid[0][row * LDH + col + e] = from_f<T>(y);
      }
    }
  });
  __syncthreads();

  for (int l = 1; l < h.n_convs; ++l) {
    const bool last = l == h.n_convs - 1;
    chain_layer(hid[(l - 1) & 1], hid[l & 1], last ? out : nullptr,
                static_cast<const T*>(h.w[l]), h.b[l], last ? h.c_out : HID,
                (h.relu_mask >> l) & 1, scratch, m0, M, static_cast<Core*>(nullptr));
    __syncthreads();
  }
}

template <typename T, class Core>
int launch_head(const HeadArgs& h, cudaStream_t s) {
  constexpr int smem = head_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(head_chain_kernel<T, Core>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)h.N * h.H * h.W;
  dim3 grid((unsigned)((M + HBM - 1) / HBM));
  head_chain_kernel<T, Core><<<grid, THREADS, smem, s>>>(h);
  return (int)cudaGetLastError();
}

}  // namespace mt

// dtype: 0 f32, 1 bf16. relu_mask bit l: ReLU after conv l. Returns
// cudaGetLastError() after the launch.
extern "C" int mt_head_chain(int dtype, const void* x, const void* w0, const void* w1,
                             const void* w2, const void* w3, const void* b0,
                             const void* b1, const void* b2, const void* b3, void* out,
                             int N, int H, int W, int C0, int n_convs, int c_out,
                             int relu_mask, void* stream) {
  using namespace mt;
  HeadArgs h{x,
             {w0, w1, w2, w3},
             {static_cast<const float*>(b0), static_cast<const float*>(b1),
              static_cast<const float*>(b2), static_cast<const float*>(b3)},
             out, N, H, W, C0, n_convs, c_out, relu_mask};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_head<bf16, MmaCore<HBM, HID, 2, 4>>(h, s);
  return launch_head<float, SimtCore<HBM, HID>>(h, s);
}
