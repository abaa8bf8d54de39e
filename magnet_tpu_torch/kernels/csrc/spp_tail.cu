// Fused tail of PSM-Net's feature extractor: SAME 3x3 conv over the channel
// concat [raw | skip | branches] -> 128, folded eval BatchNorm, ReLU, then a
// 1x1 projection (no bias) to the feature width. NHWC.
//
// Replaces the TPU kernel magnet_tpu/kernels/spptail_pallas.py
// (spp_tail_fused). As there, the 320-channel concat is never built: the
// three maps are three K ranges of one implicit GEMM (the loader of psm.cuh),
// and the 128-channel hidden tile never reaches device memory: a block owns
// 64 output pixels, writes BN + ReLU of its accumulators into a shared-memory
// tile (rounded to the compute type, as the TPU kernel does) and the 1x1
// layer of common.cuh reads it from there. The TPU version's row-tile halo
// DMAs and the lane padding of the 64-channel map do not carry over.
//
// Bound on an H100: tensor-core operations (K = 2880 per hidden value). bf16
// runs on the tensor cores (WMMA, f32 accumulate), f32 as FMA.

#include "psm.cuh"

namespace mt {

struct TailArgs {
  PsmArgs conv;        // Cout = 128
  const float* scale;  // (128,) folded BN
  const float* shift;
  const void* w1;      // (128, c_out), c_out a multiple of 16
  const float* zero;   // (c_out,) zeros: the projection has no bias
  void* out;           // (N, H, W, c_out)
  int c_out;
};

template <typename T>
constexpr int tail_smem_bytes() {
  return PsmLoader<T, HBM, HID>::SMEM + HBM * HidCfg<T>::LDH * (int)sizeof(T);
}

template <typename T, class Core>
__global__ void __launch_bounds__(THREADS) spp_tail_kernel(TailArgs h) {
  using L = PsmLoader<T, HBM, HID>;
  constexpr int LDH = HidCfg<T>::LDH;
  static_assert(L::SMEM >= THREADS / 32 * 256 * (int)sizeof(float), "scratch");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hid = reinterpret_cast<T*>(smem_raw + L::SMEM);
  float* scratch = reinterpret_cast<float*>(smem_raw);  // after the K loop

  const int m0 = blockIdx.x * HBM;
  const int M = h.conv.N * h.conv.Ho * h.conv.Wo;
  L ld(h.conv, m0, 0);
  Core core;
  run_mainloop(core, ld, reinterpret_cast<T*>(smem_raw));

  const float* sc = h.scale;
  const float* sh = h.shift;
  core.epilogue(scratch, [&](int row, int col, const float* v, int cnt) {
    for (int e = 0; e < cnt; ++e)
      hid[row * LDH + col + e] =
          from_f<T>(fmaxf(v[e] * sc[col + e] + sh[col + e], 0.f));
  });
  __syncthreads();
  chain_layer(hid, static_cast<T*>(nullptr), static_cast<T*>(h.out),
              static_cast<const T*>(h.w1), h.zero, h.c_out, false, scratch, m0, M,
              static_cast<Core*>(nullptr));
}

template <typename T, class Core>
int launch_tail(const TailArgs& h, cudaStream_t s) {
  constexpr int smem = tail_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(spp_tail_kernel<T, Core>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)h.conv.N * h.conv.Ho * h.conv.Wo;
  dim3 grid((unsigned)((M + HBM - 1) / HBM));
  spp_tail_kernel<T, Core><<<grid, THREADS, smem, s>>>(h);
  return (int)cudaGetLastError();
}

}  // namespace mt

// dtype: 0 f32, 1 bf16. Returns cudaGetLastError() after the launch.
extern "C" int mt_spp_tail(int dtype, const void* raw, const void* skip, const void* br,
                           const void* w0, const void* scale, const void* shift,
                           const void* w1, const void* zero, void* out, int N, int H,
                           int W, int C0, int C1, int C2, int c_out, void* stream) {
  using namespace mt;
  PsmArgs a{{raw, skip, br}, {C0, C1, C2}, w0, N, H, W, H, W, C0 + C1 + C2, HID, 9, 1, 1};
  TailArgs h{a, static_cast<const float*>(scale), static_cast<const float*>(shift), w1,
             static_cast<const float*>(zero), out, c_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_tail<bf16, MmaCore<HBM, HID, 2, 4>>(h, s);
  return launch_tail<float, SimtCore<HBM, HID>>(h, s);
}
