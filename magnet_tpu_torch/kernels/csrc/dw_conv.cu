// Stride-1 depthwise KxK convolution (K = 3 or 5) with TF-SAME padding and no
// bias, NHWC: out[n, y, x, c] = sum_{dy, dx} x[n, y + dy - pt, x + dx - pl, c]
// * w[dy, dx, c], zero outside the image, accumulated in f32 and rounded
// once to x's type.
//
// Replaces the TPU kernel magnet_tpu/kernels/dwconv_pallas.py
// (dw_conv_pallas). The TPU version pads the input in XLA and reads each row
// tile twice (the tile and the next for its halo) through two BlockSpecs. Here
// a 256-thread block owns an 8x16-pixel output tile and up to 8 channel
// vectors of 16 bytes (64 bf16 or 32 f32 channels): it stages the tile's
// input with its K-1 halo (zero outside the image, so no padded copy exists)
// and the K*K taps of its channels in shared memory, then each thread
// computes 16 bytes of output channels with the taps unrolled.
//
// Bound on an H100: bytes (2*K*K operations per value against 2 bytes read
// and 2 written in bf16); the halo is read again by the neighbouring tiles,
// 1.4-2x the compulsory input at K = 3-5.

#include "common.cuh"

namespace mt {

constexpr int DW_TH = 8, DW_TW = 16, DW_CV = 8;

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
dw_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int H, int W, int C, int pt, int pl) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int IH = DW_TH + K - 1, IW = DW_TW + K - 1;
  __shared__ uint4 xs[IH * IW * DW_CV];
  __shared__ uint4 ws[K * K * DW_CV];

  const int tiles_w = (W + DW_TW - 1) / DW_TW;
  const int y0 = (blockIdx.x / tiles_w) * DW_TH;
  const int x0 = (blockIdx.x % tiles_w) * DW_TW;
  const int n = blockIdx.z;
  const int cv0 = blockIdx.y * DW_CV;
  const int ncv = min(DW_CV, C / VEC - cv0);
  const T* xn = x + (size_t)n * H * W * C;

  for (int i = threadIdx.x; i < IH * IW * ncv; i += THREADS) {
    const int v = i % ncv, p = i / ncv;
    const int gy = y0 + p / IW - pt, gx = x0 + p % IW - pl;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = ldg16(xn + ((size_t)gy * W + gx) * C + (cv0 + v) * VEC);
    xs[p * DW_CV + v] = val;
  }
  for (int i = threadIdx.x; i < K * K * ncv; i += THREADS) {
    const int v = i % ncv, t = i / ncv;
    ws[t * DW_CV + v] = ldg16(w + (size_t)t * C + (cv0 + v) * VEC);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < DW_TH * DW_TW * ncv; i += THREADS) {
    const int v = i % ncv, p = i / ncv;
    const int oy = p / DW_TW, ox = p % DW_TW;
    if (y0 + oy >= H || x0 + ox >= W) continue;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        float a[VEC], b[VEC];
        unpack(xs[((oy + dy) * IW + ox + dx) * DW_CV + v], a, T());
        unpack(ws[(dy * K + dx) * DW_CV + v], b, T());
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(a[e], b[e], acc[e]);
      }
    *reinterpret_cast<uint4*>(out + (((size_t)n * H + y0 + oy) * W + x0 + ox) * C
                              + (cv0 + v) * VEC) = pack(acc, T());
  }
}

template <typename T, int K>
int launch_dw_conv(const void* x, const void* w, void* out, int N, int H, int W,
                   int C, int pt, int pl, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int cvt = C / VEC;
  dim3 grid((unsigned)(((H + DW_TH - 1) / DW_TH) * ((W + DW_TW - 1) / DW_TW)),
            (unsigned)((cvt + DW_CV - 1) / DW_CV), (unsigned)N);
  dw_conv_kernel<T, K><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      H, W, C, pt, pl);
  return (int)cudaGetLastError();
}

}  // namespace mt

// dtype: 0 f32, 1 bf16. x: (N, H, W, C); w: (K, K, C); out: (N, H, W, C); C
// a multiple of 16 bytes; K 3 or 5. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for another K).
extern "C" int mt_dw_conv(int dtype, const void* x, const void* w, void* out,
                          int N, int H, int W, int C, int K, int pt, int pl,
                          void* stream) {
  using namespace mt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (K == 3) return launch_dw_conv<bf16, 3>(x, w, out, N, H, W, C, pt, pl, s);
    if (K == 5) return launch_dw_conv<bf16, 5>(x, w, out, N, H, W, C, pt, pl, s);
  } else {
    if (K == 3) return launch_dw_conv<float, 3>(x, w, out, N, H, W, C, pt, pl, s);
    if (K == 5) return launch_dw_conv<float, 5>(x, w, out, N, H, W, C, pt, pl, s);
  }
  return (int)cudaErrorInvalidValue;
}
