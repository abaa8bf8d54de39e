// Consistency-weighted plane-sweep cost volume, NHWC.
//
// Replaces the TPU kernel magnet_tpu/kernels/costvolume_pallas.py
// (cost_volume_cw_pallas and its three bodies) and computes what the exact
// path magnet_tpu/ops/costvolume.py::_cost_volume_cw_xla computes, at any
// camera motion. The TPU kernel read a band of source rows per row tile and
// needed a guard and an escalation ladder for samples outside it; this one
// stages a window of the source maps where the samples fall close together
// and gathers from global memory where they do not, inside the same kernel.
//
// For every (pixel, candidate depth) and every source view: project the
// candidate into the view in f32, sample the view's feature, mu and sigma
// maps bilinearly (zeros outside the map), take the dot product of the
// sampled feature with the reference feature, zero it where
// |z - mu_w| >= kappa * sigma_w, weight it by the view's validity flag; sum
// over the views and divide by v_total: their number, or the global view
// count where each device holds a share of the views and the partial sums
// are added over the devices (core/sharding_inference.py).
//
// Bound on an H100: the compulsory bytes (source maps, reference feature,
// depths, output: about 12 MB a launch at the ScanNet eval shape in bf16)
// at the main path; the f32 products (4 corners x C channels a sample and
// view) at the F-Net training sweep (D = 80). What a plain gather requests
// is 4 corners x (C + 2) channels a sample and view, about 200 MB a launch
// at the main path, served by the L2 cache.
//
// Design: tiles and windows. A 256-thread block owns an 8 x 8 tile of
// reference pixels and all D of their candidates.
//  1. Plan. For each valid view and candidate one warp projects the tile's
//     64 samples and reduces the box of their in-image bilinear corners.
//     Then per view one warp cuts the candidates into chunks: a candidate
//     belongs to the largest aligned run of 16, 8, 4, 2 or 1 candidates
//     whose boxes' union, times C + 2 channels in the features' type, fits a
//     window buffer (CV_WINDOW_BYTES); such a chunk is staged. A single
//     candidate whose box does not fit goes to the global branch; a run of
//     such candidates within an aligned 16 is one global job. The rule
//     reads nothing but the sample positions, so
//     kernels/cost_volume_cw.py::cost_volume_cw_plan replays it.
//  2. Jobs run in (view, candidate) order over two window buffers: while
//     one job is matched, the cp.async copies of the next job's window (16
//     bytes for the features, 4 or 8 for the (mu, sigma) pairs) are in
//     flight.
//  3. Each of a job's samples gets its source position, depth z and
//     bilinear weights once, from one thread, into shared memory. The
//     projection spells out every rounding (no contraction), so the plan
//     and the match see the same corners.
//  4. Four lanes own one reference pixel: its feature stays in their
//     registers, a quarter of the channels each. Two samples of the pixel
//     at a time, they read each in-image corner's channels from the window
//     (from global memory on a global job) and the (mu, sigma) pair, sum
//     the four lanes' products, test the consistency and add the cost to
//     the pixel's accumulator in shared memory, view after view. No
//     atomics: two calls are equal bit for bit.
// The cameras, the tile's rays and its candidate depths are read into
// shared memory once, at the start.
//
// Second entry point, mt_sweep_grad_ref: the gradient of the F-Net training
// sweep (the forward above at mu 0, sigma 1e30, kappa 1 and the same depths
// at every pixel) with respect to the reference features,
//
//   grad_ref[b, q, c] = sum over v, d of
//       gbar[b, q, d] * valid[b, v] * bilinear(src_v, proj(q, d))[c].
//
// It replaces no TPU kernel: the JAX package leaves this gradient to XLA (a
// re-gather in the custom VJP of magnet_tpu/ops/costvolume.py), and its
// Pallas backward (sweepbwd_pallas.py) is the source gradient alone.
// Bound on an H100 at the training shape (B = 2, V = 4, D = 80, 120x160,
// C = 64): the f32 operations, a multiply-add per channel at each of 4
// corners and the projection a sample, 6.66 GFLOP, 0.099 ms at 67 TFLOP/s;
// the bytes (about 42 MB) take 0.013 ms. The plain re-gather it replaces
// took 59.5 ms on an H100, 600x that bound, in 2785 launches a step.
// Design: the forward transposed in the channels, not in the pixels. The
// gradient gathers (a reference pixel reads the source corners its samples
// fall on), so it runs on the forward's tiles, plan and staged windows as
// they stand, and sees the same samples and corners: a staged pixel takes C
// channels (no (mu, sigma) pair). The tile's cotangent rows, (64, D) f32,
// are read into shared memory in place of the forward's accumulator. Four
// lanes own a reference pixel and hold a quarter of its C f32 sums in
// registers, the feature's place in the forward; per sample each lane adds
// gbar * valid * w times each corner's channels to them, and writes them
// once at the end. No reductions across lanes, no atomics: two calls are
// equal bit for bit, and the work per sample is the forward's less its dot
// product's shuffles and the consistency test.

#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace mt {

constexpr int CV_THREADS = 256;
constexpr int CV_WARPS = CV_THREADS / 32;
constexpr int CV_LANES = 4;               // lanes a reference pixel
constexpr int CV_TILE_H = 8, CV_TILE_W = 8;
constexpr int CV_TP = CV_TILE_H * CV_TILE_W;
static_assert(CV_TP * CV_LANES == CV_THREADS, "four lanes a tile pixel");
constexpr int CV_CHUNK = 16;              // most candidates a chunk
constexpr int CV_WINDOW_BYTES = 24576;    // one window buffer
constexpr int CV_MAX_C = 128;
constexpr int CV_MAX_D = 256;
constexpr int CV_SMEM_LIMIT = 232448;
constexpr unsigned CV_FULL = 0xffffffffu;

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
  const float* gbar;   // sweep gradient: (B, H, W, D) cotangent of the sum
  float* out;          // (B, H, W, D); sweep gradient: (B, H, W, C)
  int B, V, H, W, C, D;
  int dpix;            // depths a pixel in d: D, or 0 where every pixel
                       // takes the same D planes (d is then (D,))
  int v_total;         // the divisor of the sum over views: V, or the global
                       // view count when the views are split over devices
  float kappa;
  int tiles_x;
  int swz;             // XOR of the chunk index on odd pixels (bank spread)
};

// Shared memory, in bytes: the accumulator (D rows of CV_TP + 1 floats), the
// boxes of every (view, candidate) that the plan then overwrites with its
// jobs, the jobs a view, the cameras (CV_VIEW floats a view), the tile's
// rays and candidate depths, a job's sample geometry, two window buffers.
struct CvLayout {
  int acc, box, count, view, ray, dep, geom, win0, win1, total;
};

constexpr int CV_VIEW = 24;   // R, K, K t, t_z, the validity flag, padding

__host__ __device__ inline int cv_align(int x, int a) { return (x + a - 1) / a * a; }

__host__ __device__ inline CvLayout cv_layout(int V, int D) {
  CvLayout L;
  int off = 0;
  L.acc = off;
  off = cv_align(off + D * (CV_TP + 1) * 4, 16);
  L.box = off;
  off += V * D * 16;
  L.count = off;
  off = cv_align(off + V * 4, 16);
  L.view = off;
  off += V * CV_VIEW * 4;
  L.ray = off;
  off += 3 * CV_TP * 4;
  L.dep = off;
  off += CV_TP * D * 4;
  L.geom = off;
  off = cv_align(off + CV_TP * (D < CV_CHUNK ? D : CV_CHUNK) * 16, 128);
  L.win0 = off;
  L.win1 = off + CV_WINDOW_BYTES;
  L.total = off + 2 * CV_WINDOW_BYTES;
  return L;
}

// View bv's camera into c[0 .. CV_VIEW): R, K, K t, t_z, the validity flag.
__device__ __forceinline__ void cv_load_view(const CvArgs& a, int b, int bv, float* c) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    c[i] = __ldg(a.R + bv * 9 + i);
    c[9 + i] = __ldg(a.K + b * 9 + i);
  }
  const float t0 = __ldg(a.t + bv * 3), t1 = __ldg(a.t + bv * 3 + 1), tz = __ldg(a.t + bv * 3 + 2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c[18 + i] = __fmaf_rn(c[9 + 3 * i + 2], tz, __fmaf_rn(c[9 + 3 * i + 1], t1, __fmul_rn(c[9 + 3 * i], t0)));
  c[21] = tz;
  c[22] = __ldg(a.valid + bv);
}

struct CvSample {
  int x0, y0;        // top-left corner; x0 < -1 when the sample misses the map
  float wx1, wy1, z;
};

// The projection of depth `dep` along ray r into the view, each rounding
// explicit (kernels/cost_volume_cw.py::kernel_positions replays it).
__device__ __forceinline__ CvSample cv_sample(const float* c, const float* ray, float dep, int W,
                                              int H) {
  const float* R = c;
  const float* K = c + 9;
  const float r0 = ray[0], r1 = ray[CV_TP], r2 = ray[2 * CV_TP];
  float rr[3], p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    rr[i] = __fmaf_rn(R[3 * i + 2], r2, __fmaf_rn(R[3 * i + 1], r1, __fmul_rn(R[3 * i], r0)));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float bi = __fmaf_rn(K[3 * i + 2], rr[2], __fmaf_rn(K[3 * i + 1], rr[1], __fmul_rn(K[3 * i], rr[0])));
    p[i] = __fmaf_rn(bi, dep, c[18 + i]);
  }
  const float denom = __fadd_rn(p[2], 1e-10f);
  const float fW = (float)W, fH = (float)H, hW = fW * 0.5f, hH = fH * 0.5f;
  const float u = __fdiv_rn(p[0], denom), w = __fdiv_rn(p[1], denom);
  const float gx = fminf(fmaxf(__fdiv_rn(__fsub_rn(u, hW), hW), -10.f), 10.f);
  const float gy = fminf(fmaxf(__fdiv_rn(__fsub_rn(w, hH), hH), -10.f), 10.f);
  const float x = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), fW), 1.f), 0.5f);
  const float y = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), fH), 1.f), 0.5f);
  const float xf = floorf(x), yf = floorf(y);
  CvSample s;
  s.z = __fmaf_rn(rr[2], dep, c[21]);
  if (xf >= -1.f && xf <= fW - 1.f && yf >= -1.f && yf <= fH - 1.f) {
    s.x0 = (int)xf;
    s.y0 = (int)yf;
    s.wx1 = __fsub_rn(x, xf);
    s.wy1 = __fsub_rn(y, yf);
  } else {
    s.x0 = s.y0 = -32768;
    s.wx1 = s.wy1 = 0.f;
  }
  return s;
}

// Boxes of in-image corners: (xlo, xhi, ylo, yhi), empty when xlo > xhi.
__device__ __forceinline__ int4 cv_empty() { return make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN); }
__device__ __forceinline__ int4 cv_unite(int4 p, int4 q) {
  return make_int4(min(p.x, q.x), max(p.y, q.y), min(p.z, q.z), max(p.w, q.w));
}
__device__ __forceinline__ bool cv_fits(int4 u, int bpp) {
  return u.x > u.y ||
         (long long)(u.y - u.x + 1) * (u.w - u.z + 1) * bpp <= (long long)CV_WINDOW_BYTES;
}

__device__ __forceinline__ float2 cv_ms(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 cv_ms(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int BYTES>
__device__ __forceinline__ void cv_cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(hp::smem_addr(dst)), "l"(src),
               "n"(BYTES)
               : "memory");
}

// Job i of a view: x = d0 | nd << 16, y = xlo | ylo << 16, z = ww | wh << 16,
// w = 1 when staged (else a global job).

// The copies of a staged job's window into `win`: features row by row, then
// the (mu, sigma) pairs where MS.
template <typename T, bool MS>
__device__ void cv_stage(const CvArgs& a, int bv, int4 job, unsigned char* win) {
  if (!job.w) return;
  const int xlo = job.y & 0xffff, ylo = job.y >> 16;
  const int ww = job.z & 0xffff, wh = job.z >> 16;
  const int pix = a.C * (int)sizeof(T) / 16;
  const int row = ww * pix;
  const char* src = static_cast<const char*>(a.src) +
                    ((size_t)bv * a.H * a.W + (size_t)ylo * a.W + xlo) * a.C * sizeof(T);
  const size_t pitch = (size_t)a.W * a.C * sizeof(T);
  // chunk i is (r, e) = (i / row, i % row), stepped without dividing
  {
    int r = threadIdx.x / row, e = threadIdx.x % row;
    const int dr = CV_THREADS / row, de = CV_THREADS % row;
    for (int i = threadIdx.x; i < wh * row; i += CV_THREADS) {
      hp::cp_async16(win + (size_t)i * 16, src + r * pitch + (size_t)e * 16, true);
      r += dr;
      e += de;
      if (e >= row) e -= row, ++r;
    }
  }
  if constexpr (!MS) return;
  constexpr int MSB = 2 * sizeof(T);
  unsigned char* wms = win + (size_t)ww * wh * a.C * sizeof(T);
  const char* ms = static_cast<const char*>(a.ms) +
                   ((size_t)bv * a.H * a.W + (size_t)ylo * a.W + xlo) * MSB;
  int r = threadIdx.x / ww, c = threadIdx.x % ww;
  const int dr = CV_THREADS / ww, dc = CV_THREADS % ww;
  for (int i = threadIdx.x; i < wh * ww; i += CV_THREADS) {
    cv_cp_async<MSB>(wms + i * MSB, ms + ((size_t)r * a.W + c) * MSB);
    r += dr;
    c += dc;
    if (c >= ww) c -= ww, ++r;
  }
}

// One thread a sample (pixel p, candidate d0 + dd) of the job: geom[p * nd +
// dd] = (x0 | y0 << 16, wx1, wy1, z).
__device__ void cv_geometry(const CvArgs& a, const float* view, const float* ray, const float* dep,
                            int d0, int nd, int ty0, int tx0, float4* geom) {
  for (int s = threadIdx.x; s < CV_TP * nd; s += CV_THREADS) {
    const int p = s / nd, dd = s - p * nd;
    const int y = ty0 + p / CV_TILE_W, x = tx0 + p % CV_TILE_W;
    float4 g = make_float4(__int_as_float(-32768), 0.f, 0.f, 0.f);
    if (y < a.H && x < a.W) {
      const CvSample sm = cv_sample(view, ray + p, dep[p * a.D + d0 + dd], a.W, a.H);
      g = make_float4(__int_as_float((sm.x0 & 0xffff) | (int)((unsigned)sm.y0 << 16)), sm.wx1,
                      sm.wy1, sm.z);
    }
    geom[s] = g;
  }
}

// One sample's (this lane's part of the dot product, mu, sigma). Corners
// outside the map weigh 0 and read a pixel of the map (index 0) in their
// place, so that two samples' loads and products interleave without
// branches; a weight of 0 adds +-0, as a skipped corner would.
template <typename T, int NCH, bool STAGED>
__device__ __forceinline__ float3 cv_dot(const CvArgs& a, float4 gm, const T* src, const T* ms,
                                         int xlo, int ylo, int pitch,
                                         const float (&q)[NCH][16 / sizeof(T)], const int (&off)[NCH]) {
  constexpr int VEC = 16 / sizeof(T);
  const int packed = __float_as_int(gm.x);
  const int x0 = (int)(short)(packed & 0xffff), y0 = packed >> 16;
  const bool hit = x0 >= -1;
  const bool inx[2] = {hit && x0 >= 0, hit && x0 + 1 < a.W};
  const bool iny[2] = {hit && y0 >= 0, hit && y0 + 1 < a.H};
  const int at0 = STAGED ? (y0 - ylo) * pitch + (x0 - xlo) : y0 * pitch + x0;
  float dot = 0.f, mu = 0.f, sigma = 0.f;
#pragma unroll
  for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const bool in = iny[cy] && inx[cx];
      const float wt = in ? (cy ? gm.z : 1.f - gm.z) * (cx ? gm.y : 1.f - gm.y) : 0.f;
      const int at = in ? at0 + cy * pitch + cx : 0;
      const float2 m = cv_ms(ms + (size_t)at * 2);
      mu += wt * m.x;
      sigma += wt * m.y;
      const T* f = src + (size_t)at * a.C;
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        if (off[k] >= 0) {
          float v[VEC];
          unpack(STAGED ? *reinterpret_cast<const uint4*>(f + off[k]) : ldg16(f + off[k]), v, T());
#pragma unroll
          for (int e = 0; e < VEC; ++e) part = fmaf(v[e], q[k][e], part);
        }
      }
      dot += wt * part;
    }
  }
  return make_float3(dot, mu, sigma);
}

__device__ __forceinline__ bool cv_hit(float4 gm) {
  return (int)(short)(__float_as_int(gm.x) & 0xffff) >= -1;
}

// The four lanes of pixel g match its samples of the job, two at a time
// (pairs in which no lane of the warp has a sample are skipped); lane 0
// adds each consistent cost to acc. off[k]: the element offset of the
// lane's k-th 16-byte chunk of a pixel's channels, or -1.
template <typename T, int NCH, bool STAGED>
__device__ __forceinline__ void cv_match(const CvArgs& a, int bv, float valid, int4 job,
                                         const unsigned char* win, const float4* geom, float* acc,
                                         const float (&q)[NCH][16 / sizeof(T)], const int (&off)[NCH],
                                         int g, int l) {
  const int d0 = job.x & 0xffff, nd = job.x >> 16;
  const int xlo = job.y & 0xffff, ylo = job.y >> 16;
  const int ww = job.z & 0xffff, wh = job.z >> 16;
  const int pitch = STAGED ? ww : a.W;
  const T* src = STAGED ? reinterpret_cast<const T*>(win)
                        : static_cast<const T*>(a.src) + (size_t)bv * a.H * a.W * a.C;
  const T* ms = STAGED ? reinterpret_cast<const T*>(win + (size_t)ww * wh * a.C * sizeof(T))
                       : static_cast<const T*>(a.ms) + (size_t)bv * a.H * a.W * 2;
  const float4 none = make_float4(__int_as_float(-32768), 0.f, 0.f, 0.f);
  for (int dd = 0; dd < nd; dd += 2) {
    const bool two = dd + 1 < nd;
    const float4 g0 = geom[g * nd + dd];
    const float4 g1 = two ? geom[g * nd + dd + 1] : none;
    if (!__any_sync(CV_FULL, cv_hit(g0) || cv_hit(g1))) continue;
    float3 r0 = cv_dot<T, NCH, STAGED>(a, g0, src, ms, xlo, ylo, pitch, q, off);
    float3 r1 = cv_dot<T, NCH, STAGED>(a, g1, src, ms, xlo, ylo, pitch, q, off);
    r0.x += __shfl_xor_sync(CV_FULL, r0.x, 2);
    r1.x += __shfl_xor_sync(CV_FULL, r1.x, 2);
    r0.x += __shfl_xor_sync(CV_FULL, r0.x, 1);
    r1.x += __shfl_xor_sync(CV_FULL, r1.x, 1);
    if (l == 0) {
      if (fabsf(g0.w - r0.y) < r0.z * a.kappa) acc[(d0 + dd) * (CV_TP + 1) + g] += r0.x * valid;
      if (two && fabsf(g1.w - r1.y) < r1.z * a.kappa)
        acc[(d0 + dd + 1) * (CV_TP + 1) + g] += r1.x * valid;
    }
  }
}

// Steps 1 and 2 of both kernels, after the cameras, the tile's rays and
// candidate depths are in shared memory: the box of every valid (view,
// candidate), then each view's jobs (box[v * D + j], j < count[v]). `bpp`:
// the bytes a staged source pixel takes.
__device__ __forceinline__ void cv_plan(const CvArgs& a, const CvLayout& L, unsigned char* smem,
                                        int ty0, int tx0, int bpp) {
  int4* box = reinterpret_cast<int4*>(smem + L.box);
  int* count = reinterpret_cast<int*>(smem + L.count);
  const float* view = reinterpret_cast<const float*>(smem + L.view);
  const float* ray = reinterpret_cast<const float*>(smem + L.ray);
  const float* dep = reinterpret_cast<const float*>(smem + L.dep);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // 1. the box of every valid (view, candidate): a lane two tile pixels
  for (int i = warp; i < a.V * a.D; i += CV_WARPS) {
    const int v = i / a.D, d = i - v * a.D;
    const float* c = view + v * CV_VIEW;
    if (c[22] == 0.f) continue;
    int4 bx = cv_empty();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      const int y = ty0 + p / CV_TILE_W, x = tx0 + p % CV_TILE_W;
      if (y < a.H && x < a.W) {
        const CvSample s = cv_sample(c, ray + p, dep[p * a.D + d], a.W, a.H);
        if (s.x0 >= -1)
          bx = cv_unite(bx, make_int4(max(s.x0, 0), min(s.x0 + 1, a.W - 1), max(s.y0, 0),
                                      min(s.y0 + 1, a.H - 1)));
      }
    }
    bx = make_int4(__reduce_min_sync(CV_FULL, bx.x), __reduce_max_sync(CV_FULL, bx.y),
                   __reduce_min_sync(CV_FULL, bx.z), __reduce_max_sync(CV_FULL, bx.w));
    if (lane == 0) box[i] = bx;
  }
  __syncthreads();

  // 2. a warp a view cuts its candidates into chunks (written over the
  // boxes: job j of a round is at most its first candidate)
  for (int v = warp; v < a.V; v += CV_WARPS) {
    int n = 0;
    if (view[v * CV_VIEW + 22] != 0.f) {
      for (int r = 0; r < a.D; r += 32) {
        const int d = r + lane;
        int4 u = d < a.D ? box[v * a.D + d] : cv_empty();
        int4 pick = u;
        int size = 1;
        bool staged = cv_fits(u, bpp);
#pragma unroll
        for (int lv = 1; lv <= 4; ++lv) {
          const int4 o = make_int4(__shfl_xor_sync(CV_FULL, u.x, 1 << (lv - 1)),
                                   __shfl_xor_sync(CV_FULL, u.y, 1 << (lv - 1)),
                                   __shfl_xor_sync(CV_FULL, u.z, 1 << (lv - 1)),
                                   __shfl_xor_sync(CV_FULL, u.w, 1 << (lv - 1)));
          u = cv_unite(u, o);
          if (cv_fits(u, bpp)) {
            pick = u;
            size = 1 << lv;
            staged = true;
          }
        }
        // candidates that fit no window alone: a run of them within an
        // aligned 16 is one global job
        const bool any = d < a.D && pick.x <= pick.y;
        const unsigned long long gm = __ballot_sync(CV_FULL, any && !staged);
        const int seg = lane & (CV_CHUNK - 1);
        const bool gstart = ((gm >> lane) & 1) && (seg == 0 || !((gm >> (lane - 1)) & 1));
        const int run = min(__ffsll(~(gm >> lane)) - 1, CV_CHUNK - seg);
        const bool lead = any && (staged ? (lane & (size - 1)) == 0 : gstart);
        const unsigned m = __ballot_sync(CV_FULL, lead);
        __syncwarp();
        if (lead) {
          const int j = n + __popc(m & ((1u << lane) - 1));
          const int nd = staged ? min(size, a.D - d) : run;
          box[v * a.D + j] = make_int4(d | nd << 16, pick.x | pick.z << 16,
                                       (pick.y - pick.x + 1) | (pick.w - pick.z + 1) << 16, staged);
        }
        n += __popc(m);
        __syncwarp();
      }
    }
    if (lane == 0) count[v] = n;
  }
  __syncthreads();
}

// The cameras, the tile's rays and candidate depths into shared memory (both
// kernels, before cv_plan).
__device__ __forceinline__ void cv_load_tile(const CvArgs& a, const CvLayout& L,
                                             unsigned char* smem, int b, int ty0, int tx0) {
  float* view = reinterpret_cast<float*>(smem + L.view);
  float* ray = reinterpret_cast<float*>(smem + L.ray);
  float* dep = reinterpret_cast<float*>(smem + L.dep);
  const int tid = threadIdx.x;
  const int hw = a.H * a.W;
  if (tid < a.V) cv_load_view(a, b, b * a.V + tid, view + tid * CV_VIEW);
  for (int i = tid; i < 3 * CV_TP; i += CV_THREADS) {
    const int k = i / CV_TP, p = i - k * CV_TP;
    const int y = ty0 + p / CV_TILE_W, x = tx0 + p % CV_TILE_W;
    ray[i] = y < a.H && x < a.W ? __ldg(a.rays + ((size_t)b * 3 + k) * hw + y * a.W + x) : 0.f;
  }
  for (int i = tid; i < CV_TP * a.D; i += CV_THREADS) {
    const int p = i / a.D, d = i - p * a.D;
    const int y = ty0 + p / CV_TILE_W, x = tx0 + p % CV_TILE_W;
    dep[i] = y < a.H && x < a.W ? __ldg(a.d + ((size_t)b * hw + y * a.W + x) * a.dpix + d) : 0.f;
  }
  __syncthreads();
}

// Where step 3 starts: the first view with jobs (V if none), its first job's
// window copies issued into the first buffer.
template <typename T, bool MS>
__device__ __forceinline__ int cv_first(const CvArgs& a, const CvLayout& L, unsigned char* smem,
                                        int b) {
  const int4* box = reinterpret_cast<const int4*>(smem + L.box);
  const int* count = reinterpret_cast<const int*>(smem + L.count);
  int v = 0;
  while (v < a.V && count[v] == 0) ++v;
  if (v < a.V) cv_stage<T, MS>(a, b * a.V + v, box[v * a.D], smem + L.win0);
  hp::cp_async_commit();
  return v;
}

// 3. the jobs from view v on, the next job's window in flight while
// match(job, window, v, valid) runs on one, each sample's geometry in
// shared memory first.
template <typename T, bool MS, typename Match>
__device__ __forceinline__ void cv_jobs(const CvArgs& a, const CvLayout& L, unsigned char* smem,
                                        int b, int ty0, int tx0, int v, Match&& match) {
  const int4* box = reinterpret_cast<const int4*>(smem + L.box);
  const int* count = reinterpret_cast<const int*>(smem + L.count);
  float4* geom = reinterpret_cast<float4*>(smem + L.geom);
  const float* view = reinterpret_cast<const float*>(smem + L.view);
  const float* ray = reinterpret_cast<const float*>(smem + L.ray);
  const float* dep = reinterpret_cast<const float*>(smem + L.dep);
  int j = 0;
  for (int it = 0; v < a.V; ++it) {
    int nv = v, nj = j + 1;
    if (nj == count[v]) {
      nj = 0;
      do ++nv; while (nv < a.V && count[nv] == 0);
    }
    const int4 job = box[v * a.D + j];
    unsigned char* cur = smem + ((it & 1) ? L.win1 : L.win0);
    unsigned char* next = smem + ((it & 1) ? L.win0 : L.win1);
    if (nv < a.V) cv_stage<T, MS>(a, b * a.V + nv, box[nv * a.D + nj], next);
    hp::cp_async_commit();
    cv_geometry(a, view + v * CV_VIEW, ray, dep, job.x & 0xffff, job.x >> 16, ty0, tx0, geom);
    hp::cp_async_wait<1>();
    __syncthreads();
    match(job, cur, v, view[v * CV_VIEW + 22]);
    __syncthreads();
    v = nv;
    j = nj;
  }
  hp::cp_async_wait_all();
}

// Blocks an SM: three where a lane holds at most two 16-byte chunks of the
// feature (up to 88 registers without the bound), else two.
template <typename T, int NCH>
__global__ void __launch_bounds__(CV_THREADS, NCH <= 2 ? 3 : 2) cost_volume_cw_kernel(CvArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const CvLayout L = cv_layout(a.V, a.D);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  const float4* geom = reinterpret_cast<const float4*>(smem + L.geom);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / a.tiles_x) * CV_TILE_H;
  const int tx0 = (blockIdx.x % a.tiles_x) * CV_TILE_W;
  const int hw = a.H * a.W;

  for (int i = tid; i < a.D * (CV_TP + 1); i += CV_THREADS) acc[i] = 0.f;
  cv_load_tile(a, L, smem, b, ty0, tx0);
  cv_plan(a, L, smem, ty0, tx0, (a.C + 2) * (int)sizeof(T));
  const int v0 = cv_first<T, true>(a, L, smem, b);

  // the pixel's feature, a quarter of its 16-byte chunks a lane
  const int g = tid / CV_LANES, l = tid % CV_LANES;
  const int swz = (g & 1) ? a.swz : 0;
  float q[NCH][VEC];
  int off[NCH];
  {
    const int y = ty0 + g / CV_TILE_W, x = tx0 + g % CV_TILE_W;
    const bool in = y < a.H && x < a.W;
    const T* ref = static_cast<const T*>(a.ref) + ((size_t)b * hw + (in ? y * a.W + x : 0)) * a.C;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int ch = (k * CV_LANES + l) ^ swz;
      off[k] = ch < a.C / VEC ? ch * VEC : -1;
      if (in && off[k] >= 0) {
        unpack(ldg16(ref + off[k]), q[k], T());
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) q[k][e] = 0.f;
      }
    }
  }

  cv_jobs<T, true>(a, L, smem, b, ty0, tx0, v0,
                   [&](int4 job, const unsigned char* cur, int v, float valid) {
                     if (job.w)
                       cv_match<T, NCH, true>(a, b * a.V + v, valid, job, cur, geom, acc, q, off,
                                              g, l);
                     else
                       cv_match<T, NCH, false>(a, b * a.V + v, valid, job, cur, geom, acc, q,
                                               off, g, l);
                   });

  // 4. the tile's costs
  for (int i = tid; i < CV_TP * a.D; i += CV_THREADS) {
    const int p = i / a.D, d = i - p * a.D;
    const int y = ty0 + p / CV_TILE_W, x = tx0 + p % CV_TILE_W;
    if (y < a.H && x < a.W)
      a.out[((size_t)b * hw + y * a.W + x) * a.D + d] = acc[d * (CV_TP + 1) + p] / (float)a.v_total;
  }
}

// The sweep gradient's samples of one job, one at a time: the lane adds
// gbar * valid * w times its channels of each corner to its sums s. Corners
// outside the map weigh 0 and read a pixel of the map in their place, as in
// cv_dot; a sample that misses the map is skipped.
template <typename T, int NCH, bool STAGED>
__device__ __forceinline__ void sg_gather(const CvArgs& a, int bv, float valid, int4 job,
                                          const unsigned char* win, const float4* geom,
                                          const float* gb, float (&s)[NCH][16 / sizeof(T)],
                                          const int (&off)[NCH], int g) {
  constexpr int VEC = 16 / sizeof(T);
  const int d0 = job.x & 0xffff, nd = job.x >> 16;
  const int xlo = job.y & 0xffff, ylo = job.y >> 16;
  const int pitch = STAGED ? (job.z & 0xffff) : a.W;
  const T* src = STAGED ? reinterpret_cast<const T*>(win)
                        : static_cast<const T*>(a.src) + (size_t)bv * a.H * a.W * a.C;
  for (int dd = 0; dd < nd; ++dd) {
    const float4 gm = geom[g * nd + dd];
    if (!cv_hit(gm)) continue;
    const float gv = gb[(d0 + dd) * (CV_TP + 1) + g] * valid;
    const int packed = __float_as_int(gm.x);
    const int x0 = (int)(short)(packed & 0xffff), y0 = packed >> 16;
    const bool inx[2] = {x0 >= 0, x0 + 1 < a.W};
    const bool iny[2] = {y0 >= 0, y0 + 1 < a.H};
    const int at0 = STAGED ? (y0 - ylo) * pitch + (x0 - xlo) : y0 * pitch + x0;
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const bool in = iny[cy] && inx[cx];
        const float wt = in ? gv * ((cy ? gm.z : 1.f - gm.z) * (cx ? gm.y : 1.f - gm.y)) : 0.f;
        const T* f = src + (size_t)(in ? at0 + cy * pitch + cx : 0) * a.C;
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          if (off[k] >= 0) {
            float v[VEC];
            unpack(STAGED ? *reinterpret_cast<const uint4*>(f + off[k]) : ldg16(f + off[k]), v, T());
#pragma unroll
            for (int e = 0; e < VEC; ++e) s[k][e] = fmaf(wt, v[e], s[k][e]);
          }
        }
      }
    }
  }
}

// The sweep gradient with respect to the reference features: the forward's
// tiles, plan and windows (a staged pixel C channels), a lane's share of a
// pixel's C sums in registers, written once.
template <typename T, int NCH>
__global__ void __launch_bounds__(CV_THREADS, NCH <= 2 ? 3 : 2) sweep_grad_ref_kernel(CvArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const CvLayout L = cv_layout(a.V, a.D);
  float* gb = reinterpret_cast<float*>(smem + L.acc);
  const float4* geom = reinterpret_cast<const float4*>(smem + L.geom);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / a.tiles_x) * CV_TILE_H;
  const int tx0 = (blockIdx.x % a.tiles_x) * CV_TILE_W;
  const int hw = a.H * a.W;

  // the tile's cotangent, laid out as the forward's accumulator
  for (int i = tid; i < CV_TP * a.D; i += CV_THREADS) {
    const int p = i / a.D, d = i - p * a.D;
    const int y = ty0 + p / CV_TILE_W, x = tx0 + p % CV_TILE_W;
    gb[d * (CV_TP + 1) + p] =
        y < a.H && x < a.W ? __ldg(a.gbar + ((size_t)b * hw + y * a.W + x) * a.D + d) : 0.f;
  }
  cv_load_tile(a, L, smem, b, ty0, tx0);
  cv_plan(a, L, smem, ty0, tx0, a.C * (int)sizeof(T));
  const int v0 = cv_first<T, false>(a, L, smem, b);

  const int g = tid / CV_LANES, l = tid % CV_LANES;
  const int swz = (g & 1) ? a.swz : 0;
  float s[NCH][VEC];
  int off[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int ch = (k * CV_LANES + l) ^ swz;
    off[k] = ch < a.C / VEC ? ch * VEC : -1;
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[k][e] = 0.f;
  }

  cv_jobs<T, false>(a, L, smem, b, ty0, tx0, v0,
                    [&](int4 job, const unsigned char* cur, int v, float valid) {
                      if (job.w)
                        sg_gather<T, NCH, true>(a, b * a.V + v, valid, job, cur, geom, gb, s,
                                                off, g);
                      else
                        sg_gather<T, NCH, false>(a, b * a.V + v, valid, job, cur, geom, gb, s,
                                                 off, g);
                    });

  // 4. the pixel's gradient
  const int y = ty0 + g / CV_TILE_W, x = tx0 + g % CV_TILE_W;
  if (y < a.H && x < a.W) {
    float* o = a.out + ((size_t)b * hw + y * a.W + x) * a.C;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (off[k] >= 0) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(o + off[k] + e) =
              make_float4(s[k][e], s[k][e + 1], s[k][e + 2], s[k][e + 3]);
      }
    }
  }
}

template <typename T, int NCH>
int launch_cv(const CvArgs& a, cudaStream_t s) {
  const int smem = cv_layout(a.V, a.D).total;
  void (*kernel)(CvArgs) =
      a.gbar ? &sweep_grad_ref_kernel<T, NCH> : &cost_volume_cw_kernel<T, NCH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (a.H + CV_TILE_H - 1) / CV_TILE_H;
  kernel<<<dim3(a.tiles_x * tiles_y, a.B), CV_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// Both entry points: the shapes the kernels take (C a multiple of 16 bytes,
// at most 128; D at most 256; maps under 32768 pixels a side; the layout
// within the block's shared memory), then the launch by type and by the
// 16-byte chunks of a pixel's feature that a lane holds.
inline int cv_launch(int dtype, CvArgs a, cudaStream_t s) {
  const int elem = dtype == 1 ? 2 : 4;
  if (a.C < 1 || a.C * elem % 16 || a.C > CV_MAX_C || a.D < 1 || a.D > CV_MAX_D || a.V < 1 ||
      a.v_total < 1 || a.H > 32767 || a.W > 32767 || cv_layout(a.V, a.D).total > CV_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.H == 0 || a.W == 0) return (int)cudaSuccess;
  const int chunks = a.C * elem / 16;
  a.tiles_x = (a.W + CV_TILE_W - 1) / CV_TILE_W;
  a.swz = chunks % (2 * CV_LANES) == 0 ? CV_LANES : 0;
  const int per_lane = (chunks + CV_LANES - 1) / CV_LANES;   // 16-byte chunks a lane
  if (dtype == 1) {
    if (per_lane <= 1) return launch_cv<bf16, 1>(a, s);
    if (per_lane <= 2) return launch_cv<bf16, 2>(a, s);
    return launch_cv<bf16, 4>(a, s);
  }
  if (per_lane <= 1) return launch_cv<float, 1>(a, s);
  if (per_lane <= 2) return launch_cv<float, 2>(a, s);
  if (per_lane <= 4) return launch_cv<float, 4>(a, s);
  return launch_cv<float, 8>(a, s);
}

}  // namespace mt

// dtype: 0 f32, 1 bf16 (of ref, src and ms). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes the kernel does not
// take (C not a multiple of 16 bytes or over 128, D over 256, v_total below
// 1, shared memory over the block's limit, maps of 32768 pixels a side).
extern "C" int mt_cost_volume_cw(int dtype, const void* d, const void* ref, const void* src,
                                 const void* ms, const void* R, const void* t,
                                 const void* valid, const void* K, const void* rays,
                                 void* out, int B, int V, int H, int W, int C, int D,
                                 int v_total, float kappa, void* stream) {
  using namespace mt;
  CvArgs a{static_cast<const float*>(d), ref, src, ms,
           static_cast<const float*>(R), static_cast<const float*>(t),
           static_cast<const float*>(valid), static_cast<const float*>(K),
           static_cast<const float*>(rays), nullptr, static_cast<float*>(out),
           B, V, H, W, C, D, D, v_total, kappa, 0, 0};
  return cv_launch(dtype, a, static_cast<cudaStream_t>(stream));
}

// The sweep gradient with respect to the reference features. dtype: 0 f32,
// 1 bf16 (of src); depth (D,), gbar (B, H, W, D) and the geometry f32; out
// (B, H, W, C) f32. Returns as mt_cost_volume_cw, on the same shapes.
extern "C" int mt_sweep_grad_ref(int dtype, const void* depth, const void* src,
                                 const void* gbar, const void* R, const void* t,
                                 const void* valid, const void* K, const void* rays,
                                 void* out, int B, int V, int H, int W, int C, int D,
                                 void* stream) {
  using namespace mt;
  CvArgs a{static_cast<const float*>(depth), nullptr, src, nullptr,
           static_cast<const float*>(R), static_cast<const float*>(t),
           static_cast<const float*>(valid), static_cast<const float*>(K),
           static_cast<const float*>(rays), static_cast<const float*>(gbar),
           static_cast<float*>(out), B, V, H, W, C, D, 0, 1, 1.f, 0, 0};
  return cv_launch(dtype, a, static_cast<cudaStream_t>(stream));
}
