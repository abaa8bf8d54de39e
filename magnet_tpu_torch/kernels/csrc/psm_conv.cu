// One conv of a PSM-Net residual block: 3x3 (stride 1 or 2, dilation d,
// padding d) or 1x1 (the shortcut projection), folded eval BatchNorm, then
// either a ReLU or the residual add, fused in the epilogue. NHWC.
//
// Replaces three TPU kernels of the F-Net:
//   magnet_tpu/kernels/psmstage_pallas.py  (fused_residual_stage: chains of
//     BasicBlocks and the stem's conv-BN-ReLU pairs),
//   magnet_tpu/kernels/psmtrans_pallas.py  (downsample_block: layer2's first
//     block, stride 2 with a 1x1 projection shortcut),
//   magnet_tpu/kernels/psmtrans2_pallas.py (expand_block: layer3's first
//     block, 64 -> 128 channels with a 1x1 projection shortcut).
// The TPU versions keep a whole feature map resident in VMEM across a chain
// and pack 2 or 4 pixels into the 128 lanes to fill the MXU at 64 and 32
// channels. Neither carries over: a map does not fit one SM's shared memory,
// and a GPU tile is not tied to 128 lanes. Here each conv is one launch of an
// implicit GEMM (M = output pixels in tiles of 128, N = output channels in
// tiles of 64 or 128, K = taps x input channels), the maps between convs go
// through device memory (2.5-12 MB in bf16 at the ScanNet eval shape, which
// the 50 MB L2 cache holds), and what the TPU kernels fused per conv is fused
// here per conv too: y = acc * scale + shift in f32, then ReLU (first conv of
// a block, stem convs) or + residual (second conv), rounded once.
//
// Bound on an H100: tensor-core operations for the 64- and 128-channel
// stages (K = 576 or 1152 per output value against 2 bytes read and written
// per value); the 32-channel stem and layer1 at 240x320 sit near the ridge.
// bf16 runs on the tensor cores (WMMA, f32 accumulate), f32 as FMA.

#include "psm.cuh"

namespace mt {

template <typename T, class Core, int BN>
__global__ void __launch_bounds__(THREADS)
psm_conv_kernel(PsmArgs a, const float* __restrict__ scale, const float* __restrict__ shift,
                const T* __restrict__ res, T* __restrict__ out, int relu) {
  constexpr int BM = 128;
  using L = PsmLoader<T, BM, BN>;
  static_assert(L::SMEM >= THREADS / 32 * 256 * (int)sizeof(float), "scratch");
  __shared__ __align__(128) unsigned char smem_raw[L::SMEM];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = a.N * a.Ho * a.Wo;
  L ld(a, m0, n0);
  Core core;
  run_mainloop(core, ld, reinterpret_cast<T*>(smem_raw));

  // The K loop ended on a barrier: its stages are free for the scratch.
  core.epilogue(reinterpret_cast<float*>(smem_raw),
                [&](int row, int col, const float* v, int cnt) {
                  const int m = m0 + row, n = n0 + col;
                  if (m >= M || n >= a.Cout) return;
                  const size_t at = (size_t)m * a.Cout + n;
                  for (int e = 0; e < cnt; ++e) {
                    float y = v[e] * scale[n + e] + shift[n + e];
                    if (res) y += to_f(res[at + e]);
                    if (relu) y = fmaxf(y, 0.f);
                    out[at + e] = from_f<T>(y);
                  }
                });
}

template <typename T, class Core, int BN>
int launch_psm_conv(const PsmArgs& a, const float* scale, const float* shift,
                    const void* res, void* out, int relu, cudaStream_t s) {
  const long long M = (long long)a.N * a.Ho * a.Wo;
  dim3 grid((unsigned)((M + 127) / 128), (unsigned)((a.Cout + BN - 1) / BN));
  psm_conv_kernel<T, Core, BN><<<grid, THREADS, 0, s>>>(
      a, scale, shift, static_cast<const T*>(res), static_cast<T*>(out), relu);
  return (int)cudaGetLastError();
}

}  // namespace mt

// dtype: 0 f32, 1 bf16. x1, x2 and res may be null (C1 = C2 = 0). Returns
// cudaGetLastError() after the launch.
extern "C" int mt_psm_conv(int dtype, const void* x0, const void* x1, const void* x2,
                           const void* w, const void* scale, const void* shift,
                           const void* res, void* out, int N, int H, int W, int C0,
                           int C1, int C2, int Cout, int taps, int stride, int dil,
                           int relu, void* stream) {
  using namespace mt;
  PsmArgs a{{x0, x1, x2}, {C0, x1 ? C1 : 0, x2 ? C2 : 0}, w, N, H, W,
            (H - 1) / stride + 1, (W - 1) / stride + 1, 0, Cout, taps, stride, dil};
  a.Ctot = a.C[0] + a.C[1] + a.C[2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const bool narrow = Cout <= 64;
  if (dtype == 1) {
    if (narrow)
      return launch_psm_conv<bf16, MmaCore<128, 64, 4, 2>, 64>(a, sc, sh, res, out, relu, s);
    return launch_psm_conv<bf16, MmaCore<128, 128, 4, 2>, 128>(a, sc, sh, res, out, relu, s);
  }
  if (narrow)
    return launch_psm_conv<float, SimtCore<128, 64>, 64>(a, sc, sh, res, out, relu, s);
  return launch_psm_conv<float, SimtCore<128, 128>, 128>(a, sc, sh, res, out, relu, s);
}
