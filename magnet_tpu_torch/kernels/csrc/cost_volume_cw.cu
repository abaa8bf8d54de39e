// Consistency-weighted plane-sweep cost volume, NHWC.
//
// Replaces the TPU kernel magnet_tpu/kernels/costvolume_pallas.py
// (cost_volume_cw_pallas and its three bodies) and computes what the exact
// path magnet_tpu/ops/costvolume.py::_cost_volume_cw_xla computes, at any
// camera motion. The TPU kernel read a band of source rows per row tile and
// needed a guard and an escalation ladder for samples outside it; a GPU
// gathers from any row, so none of that exists here.
//
// For every (pixel, candidate depth) and every source view: project the
// candidate into the view in f32, sample the view's feature, mu and sigma
// maps bilinearly (zeros outside the map), take the dot product of the
// sampled feature with the reference feature, zero it where
// |z - mu_w| >= kappa * sigma_w, weight it by the view's validity flag; sum
// over the views and divide by their number.
//
// Bound on an H100: bytes. The compulsory traffic (source maps, reference
// feature, depths, output) is about 12 MB per launch at the ScanNet eval
// shape in bf16, and the operations are negligible. What the gather really
// requests is 4 corners x (C + 2) channels per sample and view, about 200 MB
// per launch in bf16; the source maps of one frame (about 10 MB in bf16) fit
// the L2 cache, which serves most of it.
//
// Design: eight lanes own one (pixel, candidate). A corner's C channels are
// read as 16-byte chunks, lane l taking chunks l, l + 8, ..., so the eight
// lanes read one corner's channels as one contiguous run; the reference
// feature stays in registers. Every lane carries the geometry and the
// sampled mu/sigma (the loads are broadcasts), so the consistency test is
// uniform over the eight lanes and the partial dot products are reduced
// once, after the loop over views. Neighbouring groups hold the candidates
// of one pixel and then the next pixel of the row, whose samples fall close
// together in the source maps.

#include "common.cuh"

namespace mt {

constexpr int CV_LANES = 8;        // lanes per (pixel, candidate)
constexpr int CV_MAX_C = 128;      // most channels the kernel takes

struct CvArgs {
  const float* d;      // (B, H, W, D) candidate depths
  const void* ref;     // (B, H, W, C)
  const void* src;     // (B, V, H, W, C)
  const void* ms;      // (B, V, H, W, 2): (mu, sigma) in the matching type
  const float* R;      // (B, V, 3, 3)
  const float* t;      // (B, V, 3)
  const float* valid;  // (B, V)
  const float* K;      // (B, 3, 3)
  const float* rays;   // (B, 3, H*W)
  float* out;          // (B, H, W, D)
  int B, V, H, W, C, D;
  float kappa;
};

__device__ __forceinline__ float2 load_ms(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_ms(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) cost_volume_cw_kernel(CvArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NCH = CV_MAX_C / (VEC * CV_LANES);   // chunks per lane
  const int lane = threadIdx.x % CV_LANES;
  const long long total = (long long)a.B * a.H * a.W * a.D;
  const long long g = ((long long)blockIdx.x * THREADS + threadIdx.x) / CV_LANES;
  const bool live = g < total;
  const long long gi = live ? g : total - 1;   // idle groups repeat the last one
  const int hw = a.H * a.W;
  const long long pix = gi / a.D;              // b * H * W + y * W + x
  const int b = (int)(pix / hw);
  const int p = (int)(pix - (long long)b * hw);

  const T* ref = static_cast<const T*>(a.ref) + pix * a.C;
  float q[NCH][VEC];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int c = (k * CV_LANES + lane) * VEC;
    if (c < a.C) {
      unpack(ldg16(ref + c), q[k], T());
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) q[k][e] = 0.f;
    }
  }

  const float depth = a.d[gi];
  const float* rays = a.rays + (size_t)b * 3 * hw;
  const float r0 = rays[p], r1 = rays[hw + p], r2 = rays[2 * hw + p];
  const float* K = a.K + b * 9;
  const float fW = (float)a.W, fH = (float)a.H;

  float total_cost = 0.f;
  for (int v = 0; v < a.V; ++v) {
    const int bv = b * a.V + v;
    const float* R = a.R + bv * 9;
    const float* t = a.t + bv * 3;
    // K t + K (R ray) d, and z = t_z + (R ray)_z d
    const float rr0 = R[0] * r0 + R[1] * r1 + R[2] * r2;
    const float rr1 = R[3] * r0 + R[4] * r1 + R[5] * r2;
    const float rr2 = R[6] * r0 + R[7] * r1 + R[8] * r2;
    const float a0 = K[0] * t[0] + K[1] * t[1] + K[2] * t[2];
    const float a1 = K[3] * t[0] + K[4] * t[1] + K[5] * t[2];
    const float a2 = K[6] * t[0] + K[7] * t[1] + K[8] * t[2];
    const float b0 = K[0] * rr0 + K[1] * rr1 + K[2] * rr2;
    const float b1 = K[3] * rr0 + K[4] * rr1 + K[5] * rr2;
    const float b2 = K[6] * rr0 + K[7] * rr1 + K[8] * rr2;
    const float denom = (a2 + b2 * depth) + 1e-10f;
    const float u = (a0 + b0 * depth) / denom;
    const float w = (a1 + b1 * depth) / denom;
    const float z = t[2] + rr2 * depth;
    const float gx = fminf(fmaxf((u - fW * 0.5f) / (fW * 0.5f), -10.f), 10.f);
    const float gy = fminf(fmaxf((w - fH * 0.5f) / (fH * 0.5f), -10.f), 10.f);
    const float x = ((gx + 1.f) * fW - 1.f) * 0.5f;
    const float y = ((gy + 1.f) * fH - 1.f) * 0.5f;
    const float xf = floorf(x), yf = floorf(y);
    // A NaN coordinate fails every test below and samples nothing.
    if (!(xf >= -1.f && xf <= fW - 1.f && yf >= -1.f && yf <= fH - 1.f)) continue;
    const int x0 = (int)xf, y0 = (int)yf;
    const float wx1 = x - xf, wy1 = y - yf;

    const T* src = static_cast<const T*>(a.src) + (size_t)bv * hw * a.C;
    const T* ms = static_cast<const T*>(a.ms) + (size_t)bv * hw * 2;
    float dot = 0.f, mu = 0.f, sigma = 0.f;
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const int yi = y0 + cy, xi = x0 + cx;
        if (yi < 0 || yi >= a.H || xi < 0 || xi >= a.W) continue;
        const float wt = (cy ? wy1 : 1.f - wy1) * (cx ? wx1 : 1.f - wx1);
        const size_t at = (size_t)yi * a.W + xi;
        const float2 m = load_ms(ms + at * 2);
        mu += wt * m.x;
        sigma += wt * m.y;
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          const int c = (k * CV_LANES + lane) * VEC;
          if (c < a.C) {
            float f[VEC];
            unpack(ldg16(src + at * a.C + c), f, T());
#pragma unroll
            for (int e = 0; e < VEC; ++e) part = fmaf(f[e], q[k][e], part);
          }
        }
        dot += wt * part;
      }
    }
    if (fabsf(z - mu) < sigma * a.kappa) total_cost += dot * a.valid[bv];
  }

  // Sum the eight lanes' partial dot products (every lane of the warp is
  // here: idle groups ran the loop too).
  total_cost += __shfl_xor_sync(0xffffffffu, total_cost, 4);
  total_cost += __shfl_xor_sync(0xffffffffu, total_cost, 2);
  total_cost += __shfl_xor_sync(0xffffffffu, total_cost, 1);
  if (live && lane == 0) a.out[g] = total_cost / (float)a.V;
}

}  // namespace mt

// dtype: 0 f32, 1 bf16 (of ref, src and ms). Returns cudaGetLastError()
// after the launch.
extern "C" int mt_cost_volume_cw(int dtype, const void* d, const void* ref, const void* src,
                                 const void* ms, const void* R, const void* t,
                                 const void* valid, const void* K, const void* rays,
                                 void* out, int B, int V, int H, int W, int C, int D,
                                 float kappa, void* stream) {
  using namespace mt;
  CvArgs a{static_cast<const float*>(d), ref, src, ms,
           static_cast<const float*>(R), static_cast<const float*>(t),
           static_cast<const float*>(valid), static_cast<const float*>(K),
           static_cast<const float*>(rays), static_cast<float*>(out),
           B, V, H, W, C, D, kappa};
  const long long threads = (long long)B * H * W * D * CV_LANES;
  dim3 grid((unsigned)((threads + THREADS - 1) / THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) cost_volume_cw_kernel<bf16><<<grid, THREADS, 0, s>>>(a);
  else cost_volume_cw_kernel<float><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
