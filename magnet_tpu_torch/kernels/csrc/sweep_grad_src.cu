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
// about 5.6 GFLOP of f32 (0.088 ms at 67 TFLOP/s), so the f32 rate bounds
// it. The first version (one warp a reference pixel, every lane repeating
// the pixel's projection, one scalar f32 atomic per in-image corner and
// channel) ran at 3.85 ms, and 3.44 ms with its atomics taken out: the
// warp's 32-fold repeated walk set its pace, not the 2.8 G atomics.
//
// Design: the merged walk. Each lane owns one (b, v, reference pixel q) and
// walks the D planes in order on its own: the cotangent and depth loads of
// consecutive planes hit the same cache sectors, the projection runs once
// per sample. The projection u(d) = (a0 + b0 d) / (a2 + b2 d) is a Moebius
// map of d, so while its denominator keeps its sign the 2x2 footprint moves
// monotonically along the epipolar line and consecutive planes mostly land
// on the same pixels. The lane keeps the scalar weight sum
// sum(w * gbar * valid) of each pixel of the current footprint in registers;
// a pixel's C-wide reduction of weight_sum * ref[q] is emitted only when the
// footprint leaves it: a one-pixel step carries two corners to the new
// footprint and flushes the other two. A sample outside the map, or one
// whose denominator has the other sign, flushes all four. The flushes only
// decide when partial sums are added, never what is added, so the result
// does not depend on monotonicity: it is the same sum in another order.
// The warp emits its lanes' flushes together: a ballot finds them, and a
// group of G lanes (16 at C = 64, so two flushes a round) takes each, lane
// l adding channels 4 l .. 4 l + 3 with one float4 atomicAdd
// (red.global.add.v4.f32 on sm_90) and reading ref[q] from the cache.
// Channels that are no multiple of 4 take scalar atomics, 32 lanes each
// adding 4 channels 32 apart. An invalid view's lanes add nothing; the
// output is zeroed first. The order of the sums is not fixed, so two runs
// may differ in the last bits.

#include "common.cuh"

namespace mt {

constexpr int SG_MAX_C = 128;           // most channels the kernel takes
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int SG_NONE = -2;  // no pending footprint (none starts left of -1)

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

// VEC consecutive channels of a reference feature as floats.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    v[0] = __ldg(p);
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// One lane's share of a pixel's reduction: o[c] += w * q[c] for its
// channels, chunk j of lane l of the group starting at channel (l + G j) VEC.
template <typename T, int G, int VEC, int NCH>
__device__ __forceinline__ void reduce_pixel(float* o, float w, const T* q, int gl, int C) {
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = (gl + G * j) * VEC;
    if (c >= C) continue;
    float v[VEC];
    load_vec<VEC>(q + c, v);
    if constexpr (VEC == 4)
      atomicAdd(reinterpret_cast<float4*>(o + c),
                make_float4(w * v[0], w * v[1], w * v[2], w * v[3]));
    else
      atomicAdd(o + c, w * v[0]);
  }
}

// G lanes a reduction (8, 16 or 32), 32 / G reductions a round; each lane
// adds NCH chunks of VEC channels.
template <typename T, int G, int VEC, int NCH>
__global__ void __launch_bounds__(THREADS) sweep_grad_src_kernel(SgArgs a) {
  constexpr int E = 32 / G;
  const int lane = threadIdx.x & 31, gl = lane % G, ev = lane / G;
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int hw = a.H * a.W;
  const bool inside = item < (long long)a.B * a.V * hw;
  const int bv = inside ? (int)(item / hw) : 0;
  const int p = inside ? (int)(item - (long long)bv * hw) : 0;
  const int b = bv / a.V;
  const float valid = a.valid[bv];
  const bool active = inside && valid != 0.f;
  // A warp with nothing to add leaves whole, so the shuffles below always
  // see a full warp; within it an idle lane walks with a zero cotangent.
  if (!__any_sync(FULL_MASK, active)) return;

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

  const T* ref = static_cast<const T*>(a.ref);
  const long long qrow = ((long long)b * hw + p) * a.C;  // this lane's ref[q]
  const long long vrow = (long long)bv * hw;             // its view's first output pixel
  const float* gbar = a.gbar + ((size_t)b * hw + p) * a.D;
  // the pending footprint: pixels (fx + cx, fy + cy) with weight sums
  // w[2 cy + cx]; fpos the sign of its samples' denominator
  int fx = SG_NONE, fy = SG_NONE;
  bool fpos = true;
  float w[4] = {0.f, 0.f, 0.f, 0.f};

  // Every lane with `want` set adds wsum * ref[q] to pixel `pix` of its
  // view: a round takes the warp's next E such lanes, one a group.
  auto emit = [&](bool want, int pix, float wsum) {
    unsigned m = __ballot_sync(FULL_MASK, want);
    while (m) {
      unsigned mine = m;
      for (int i = 0; i < ev; ++i) mine &= mine - 1;
      const int src = mine ? __ffs(mine) - 1 : 0;
      const long long o = __shfl_sync(FULL_MASK, vrow + pix, src);
      const long long q = __shfl_sync(FULL_MASK, qrow, src);
      const float wv = __shfl_sync(FULL_MASK, wsum, src);
      if (mine) reduce_pixel<T, G, VEC, NCH>(a.out + o * a.C, wv, ref + q, gl, a.C);
#pragma unroll
      for (int i = 0; i < E; ++i) m &= m - 1;
    }
  };

  for (int d = 0; d < a.D; ++d) {
    const float g = active ? __ldg(gbar + d) * valid : 0.f;
    const float depth = __ldg(a.depth + d);
    const float denom = (a2 + b2 * depth) + 1e-10f;
    const float u = (a0 + b0 * depth) / denom;
    const float v = (a1 + b1 * depth) / denom;
    const float gx = fminf(fmaxf((u - fW * 0.5f) / (fW * 0.5f), -10.f), 10.f);
    const float gy = fminf(fmaxf((v - fH * 0.5f) / (fH * 0.5f), -10.f), 10.f);
    const float x = ((gx + 1.f) * fW - 1.f) * 0.5f;
    const float y = ((gy + 1.f) * fH - 1.f) * 0.5f;
    const float xf = floorf(x), yf = floorf(y);
    // A NaN coordinate fails this test too.
    const bool in_map = xf >= -1.f && xf <= fW - 1.f && yf >= -1.f && yf <= fH - 1.f;
    const bool live = g != 0.f, pos = denom > 0.f;
    const bool reset = live && (!in_map || pos != fpos);
    const int x0 = in_map ? (int)xf : 0, y0 = in_map ? (int)yf : 0;
    const bool move = live && in_map && (x0 != fx || y0 != fy);
    // old slot (cx, cy) stays as new slot (cx - dx, cy - dy) where that is
    // a slot of the new footprint; the others are flushed
    const int dx = x0 - fx, dy = y0 - fy;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int nx = s % 2 - dx, ny = s / 2 - dy;
      const bool kept = !reset && nx >= 0 && nx <= 1 && ny >= 0 && ny <= 1;
      emit((reset || (move && !kept)) && w[s] != 0.f, (fy + s / 2) * a.W + fx + s % 2, w[s]);
    }
    if (reset) {
#pragma unroll
      for (int s = 0; s < 4; ++s) w[s] = 0.f;
      fx = fy = SG_NONE;
      fpos = pos;
    }
    if (live && in_map && (x0 != fx || y0 != fy)) {
      const int ex = x0 - fx, ey = y0 - fy;
      float nw[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int sx = s % 2 + ex, sy = s / 2 + ey;
        nw[s] = sy == 0 ? (sx == 0 ? w[0] : sx == 1 ? w[1] : 0.f)
                        : sy == 1 ? (sx == 0 ? w[2] : sx == 1 ? w[3] : 0.f) : 0.f;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) w[s] = nw[s];
      fx = x0;
      fy = y0;
    }
    if (live && in_map) {
      const float wx1 = x - xf, wy1 = y - yf;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int cx = s % 2, cy = s / 2;
        const int yi = y0 + cy, xi = x0 + cx;
        if (yi >= 0 && yi < a.H && xi >= 0 && xi < a.W)
          w[s] += (cy ? wy1 : 1.f - wy1) * (cx ? wx1 : 1.f - wx1) * g;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) emit(w[s] != 0.f, (fy + s / 2) * a.W + fx + s % 2, w[s]);
}

template <typename T, int G, int VEC, int NCH>
void launch_sweep(const SgArgs& a, cudaStream_t s) {
  const long long items = (long long)a.B * a.V * a.H * a.W;
  dim3 grid((unsigned)((items + THREADS - 1) / THREADS));
  sweep_grad_src_kernel<T, G, VEC, NCH><<<grid, THREADS, 0, s>>>(a);
}

// Lanes a reduction: as few as cover C in float4 chunks (at least 8), or
// 32 lanes of scalar channels where C is no multiple of 4.
template <typename T>
void launch_sweep(const SgArgs& a, cudaStream_t s) {
  if (a.C % 4)
    launch_sweep<T, 32, 1, SG_MAX_C / 32>(a, s);
  else if (a.C <= 32)
    launch_sweep<T, 8, 4, 1>(a, s);
  else if (a.C <= 64)
    launch_sweep<T, 16, 4, 1>(a, s);
  else
    launch_sweep<T, 32, 4, 1>(a, s);
}

}  // namespace mt

// dtype: 0 f32, 1 bf16 (of ref). Zeroes out, then launches; returns the
// first CUDA error (cudaGetLastError() after the launch), or
// cudaErrorInvalidValue for C over 128.
extern "C" int mt_sweep_grad_src(int dtype, const void* depth, const void* ref,
                                 const void* gbar, const void* R, const void* t,
                                 const void* valid, const void* K, const void* rays,
                                 void* out, int B, int V, int H, int W, int C, int D,
                                 void* stream) {
  using namespace mt;
  if (C < 1 || C > SG_MAX_C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = (size_t)B * V * H * W * C * sizeof(float);
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, s);
  if (err != cudaSuccess) return (int)err;
  SgArgs a{static_cast<const float*>(depth), ref, static_cast<const float*>(gbar),
           static_cast<const float*>(R), static_cast<const float*>(t),
           static_cast<const float*>(valid), static_cast<const float*>(K),
           static_cast<const float*>(rays), static_cast<float*>(out),
           B, V, H, W, C, D};
  if (dtype == 1) launch_sweep<bf16>(a, s);
  else launch_sweep<float>(a, s);
  return (int)cudaGetLastError();
}
