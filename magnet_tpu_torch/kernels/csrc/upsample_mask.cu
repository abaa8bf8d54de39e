// Learned convex upsampling by k, NHWC, of up to four maps that share a mask,
// and its backward.
//
// Replaces the TPU kernel magnet_tpu/kernels/upsample_pallas.py
// (upsample_via_mask_pallas): per coarse pixel and sub-pixel (ki, kj), a
// softmax in f32 over the 9 mask logits mask[..., j, ki, kj], the weighted
// sum of the zero-padded 3x3 neighbourhood of each of the C channels
// (j = ky * 3 + kx), written at (h k + ki, w k + kj). MaGNet upsamples the n
// maps of its iterations with one mask; one launch takes them all, and each
// map's output is what a launch of that map alone gives, bit for bit.
//
// Bound on an H100: bytes. At the ScanNet eval shape a MaGNet frame reads
// the mask (5.5 MB in bf16) once and the three coarse maps, and writes the
// three fine maps (3.7 MB), against a few MFLOP.
//
// Design: a block owns a segment of one coarse row (32 coarse pixels at
// k = 4). It copies the segment's mask into shared memory in 16-byte
// vectors (narrower where the rows are not 16-byte aligned), and the
// coarse rows h - 1 .. h + 1 of every map over the segment and its two
// neighbours as f32, zero outside the map. One thread a fine pixel then
// takes the softmax once (__expf) and applies it to every channel of every
// map, into
// fine rows staged in shared memory, which go out in 16-byte stores. Index
// arithmetic is 32-bit within the block.
//
// Backward (mt_upsample_mask_bwd; no TPU counterpart: the JAX package
// differentiates upsampling through XLA). Given the upstream gradients of
// the n fine maps, it writes the gradient of each coarse map and of the
// shared mask logits (the maps' terms summed). Both are gathers, in a fixed
// order and with no atomics, so two calls are equal bit for bit. A block
// owns a segment of one coarse row again; it stages the softmax of the mask
// of the coarse rows h - 1 .. h + 1 over the segment and its two neighbours,
// the upstream gradient of their fine rows and the coarse neighbourhood of
// every map, all f32 and zero outside the map. Then one thread a fine pixel
// of the segment takes dL/dp_j = sum over maps and channels of g * nb_j and
// the softmax's backward p_j (dL/dp_j - sum_i p_i dL/dp_i); one thread a
// (coarse pixel, map, channel) sums p_j g over the k x k fine pixels of the
// nine coarse pixels whose neighbourhood holds it (j = 8 - the neighbour's
// offset). Bound by bytes: it reads the mask three times (its row and the
// two beside it) and writes the mask's gradient once.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace mt {

constexpr int UP_THREADS = 256;
constexpr int UP_MAX_MAPS = 4;
constexpr int UP_FINE = 512;              // fine pixels a block
constexpr int UP_SMEM = 48 * 1024;        // a segment shrinks until it fits
constexpr int UP_SMEM_LIMIT = 232448;

struct UpArgs {
  const void* depth[UP_MAX_MAPS];
  void* out[UP_MAX_MAPS];
  const void* mask;
  int n, B, H, W, C, k;
  int seg;                  // coarse pixels a block
  int nb_off, out_off;      // shared memory: mask at 0, coarse rows, fine rows
  int out_row;              // bytes a staged fine row (a multiple of 16)
  int mvec, ovec;           // vector bytes of the mask and output copies
};

__device__ __forceinline__ float up_f(float v) { return v; }
__device__ __forceinline__ float up_f(bf16 v) { return __bfloat162float(v); }

// Map m's pointers by selects: an array indexed at run time would go to
// local memory.
__device__ __forceinline__ const void* up_in(const UpArgs& a, int m) {
  return m == 0 ? a.depth[0] : m == 1 ? a.depth[1] : m == 2 ? a.depth[2] : a.depth[3];
}
__device__ __forceinline__ void* up_out(const UpArgs& a, int m) {
  return m == 0 ? a.out[0] : m == 1 ? a.out[1] : m == 2 ? a.out[2] : a.out[3];
}

template <int VB>
using UpVec = typename std::conditional<
    VB == 16, uint4,
    typename std::conditional<VB == 8, uint2,
                              typename std::conditional<VB == 4, unsigned, unsigned short>::type>::type>::type;

// The segment's mask rows into shared memory, VB bytes at a time: 16-byte
// cp.async copies (in flight while the coarse rows load), or loads and
// stores.
template <int VB>
__device__ __forceinline__ void up_load_mask(unsigned char* dst, const unsigned char* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / VB; i += UP_THREADS) {
    if (VB == 16)
      hp::cp_async16(dst + i * 16, src + i * 16, true);
    else
      reinterpret_cast<UpVec<VB>*>(dst)[i] = reinterpret_cast<const UpVec<VB>*>(src)[i];
  }
}

// The n * k staged fine rows of `bytes` each to the outputs, VB bytes at a
// time.
template <int VB>
__device__ __forceinline__ void up_store_rows(const UpArgs& a, const unsigned char* rows, int b, int h,
                                              int w0, int bytes, int elem) {
  const int nv = bytes / VB;
  for (int i = threadIdx.x; i < a.n * a.k * nv; i += UP_THREADS) {
    const int r = i / nv, e = i - r * nv;
    const int m = r / a.k, ki = r - m * a.k;
    unsigned char* dst = static_cast<unsigned char*>(up_out(a, m)) +
                         ((((size_t)b * a.H + h) * a.k + ki) * a.W * a.k + (size_t)w0 * a.k) * a.C * elem;
    reinterpret_cast<UpVec<VB>*>(dst)[e] = reinterpret_cast<const UpVec<VB>*>(rows + r * a.out_row)[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(UP_THREADS) upsample_mask_kernel(UpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * a.seg, h = blockIdx.y, b = blockIdx.z;
  const int segw = min(a.seg, a.W - w0);
  const int k = a.k, kk = k * k, nm = 9 * kk, C = a.C;
  const T* ms = reinterpret_cast<const T*>(smem);
  float* nb = reinterpret_cast<float*>(smem + a.nb_off);

  // the segment's mask, and the coarse rows h - 1 .. h + 1 of every map
  {
    const unsigned char* src = static_cast<const unsigned char*>(a.mask) +
                               ((size_t)(b * a.H + h) * a.W + w0) * nm * sizeof(T);
    const int bytes = segw * nm * (int)sizeof(T);
    if (a.mvec == 16) up_load_mask<16>(smem, src, bytes);
    else if (a.mvec == 8) up_load_mask<8>(smem, src, bytes);
    else if (a.mvec == 4) up_load_mask<4>(smem, src, bytes);
    else up_load_mask<2>(smem, src, bytes);
  }
  const int cols = segw + 2, per = 3 * cols * C;
#pragma unroll 4
  for (int i = tid; i < a.n * per; i += UP_THREADS) {
    const int m = i / per, r = i - m * per;
    const int row = r / (cols * C), rc = r - row * cols * C;
    const int col = rc / C, c = rc - col * C;
    const int y = h - 1 + row, x = w0 - 1 + col;
    float v = 0.f;
    if (y >= 0 && y < a.H && x >= 0 && x < a.W)
      v = up_f(__ldg(static_cast<const T*>(up_in(a, m)) + ((size_t)(b * a.H + y) * a.W + x) * C + c));
    nb[i] = v;
  }
  hp::cp_async_wait_all();
  __syncthreads();

  // one thread a fine pixel (ki, wl, kj) of the segment, every map; f steps
  // through the fine pixels without dividing
  const int fw = segw * k;
  int ki = tid / fw, wl = tid % fw / k, kj = tid % k;
  const int dki = UP_THREADS / fw, dwl = UP_THREADS % fw / k, dkj = UP_THREADS % k;
  for (int f = tid; f < k * fw; f += UP_THREADS) {
    const int fx = wl * k + kj;
    const T* lg = ms + wl * nm + ki * k + kj;
    float p[9];
    float top = -INFINITY;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      p[j] = up_f(lg[j * kk]);
      top = fmaxf(top, p[j]);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      p[j] = __expf(p[j] - top);
      sum += p[j];
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int j = 0; j < 9; ++j) p[j] *= inv;
    for (int m = 0; m < a.n; ++m) {
      T* o = reinterpret_cast<T*>(smem + a.out_off + (m * k + ki) * a.out_row) + fx * C;
      const float* q = nb + m * per + wl * C;
      for (int c = 0; c < C; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 9; ++j) acc = fmaf(p[j], q[((j / 3) * cols + j % 3) * C + c], acc);
        o[c] = from_f<T>(acc);
      }
    }
    ki += dki;
    wl += dwl;
    kj += dkj;
    if (kj >= k) kj -= k, ++wl;
    if (wl >= segw) wl -= segw, ++ki;
  }
  __syncthreads();

  // the fine rows out
  const unsigned char* rows = smem + a.out_off;
  const int bytes = fw * C * (int)sizeof(T);
  if (a.ovec == 16) up_store_rows<16>(a, rows, b, h, w0, bytes, sizeof(T));
  else if (a.ovec == 8) up_store_rows<8>(a, rows, b, h, w0, bytes, sizeof(T));
  else if (a.ovec == 4) up_store_rows<4>(a, rows, b, h, w0, bytes, sizeof(T));
  else up_store_rows<2>(a, rows, b, h, w0, bytes, sizeof(T));
}

constexpr int UP_BWD_SMEM = 112 * 1024;   // a segment shrinks until it fits

struct UpBwdArgs {
  const void* gout[UP_MAX_MAPS];  // (B, k H, k W, C) upstream gradients
  const void* depth[UP_MAX_MAPS];
  void* gdepth[UP_MAX_MAPS];
  const void* mask;
  void* gmask;
  int n, B, H, W, C, k;
  int seg;
  int g_off, nb_off;        // shared memory: probabilities at 0, gradients, maps
};

// Map m's pointer by selects, as up_in / up_out.
__device__ __forceinline__ const void* up_sel(const void* const* p, int m) {
  return m == 0 ? p[0] : m == 1 ? p[1] : m == 2 ? p[2] : p[3];
}
__device__ __forceinline__ void* up_sel(void* const* p, int m) {
  return m == 0 ? p[0] : m == 1 ? p[1] : m == 2 ? p[2] : p[3];
}

template <typename T>
__global__ void __launch_bounds__(UP_THREADS) upsample_mask_bwd_kernel(UpBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * a.seg, h = blockIdx.y, b = blockIdx.z;
  const int segw = min(a.seg, a.W - w0);
  const int k = a.k, kk = k * k, nm = 9 * kk, C = a.C, n = a.n;
  const int cols = a.seg + 2, fcols = cols * k;
  float* P = reinterpret_cast<float*>(smem);                  // [3][cols][nm]
  float* G = reinterpret_cast<float*>(smem + a.g_off);        // [n][3][k][fcols][C]
  float* NB = reinterpret_cast<float*>(smem + a.nb_off);      // [n][3][cols][C]

  // the mask logits of the coarse rows h - 1 .. h + 1
  const T* mask = static_cast<const T*>(a.mask);
  for (int i = tid; i < 3 * cols * nm; i += UP_THREADS) {
    const int rc = i / nm, e = i - rc * nm;
    const int r = rc / cols, col = rc - r * cols;
    const int y = h - 1 + r, x = w0 - 1 + col;
    float v = 0.f;
    if (y >= 0 && y < a.H && x >= 0 && x < a.W)
      v = up_f(__ldg(mask + ((size_t)(b * a.H + y) * a.W + x) * nm + e));
    P[i] = v;
  }
  // the upstream gradients of their fine rows
  const int fW = a.W * k;
  const int gper = 3 * k * fcols * C;
  for (int i = tid; i < n * gper; i += UP_THREADS) {
    const int m = i / gper;
    int r = i - m * gper;
    const int row = r / (fcols * C);            // r_coarse * k + ki
    r -= row * fcols * C;
    const int fx = r / C, c = r - fx * C;
    const int y = h - 1 + row / k;
    const int gy = y * k + row % k, gx = (w0 - 1) * k + fx;
    float v = 0.f;
    if (y >= 0 && y < a.H && gx >= 0 && gx < fW)
      v = up_f(__ldg(static_cast<const T*>(up_sel(a.gout, m)) +
                     (((size_t)b * a.H * k + gy) * fW + gx) * C + c));
    G[i] = v;
  }
  // the coarse neighbourhoods of the segment, as the forward reads them
  const int nper = 3 * cols * C;
  for (int i = tid; i < n * nper; i += UP_THREADS) {
    const int m = i / nper, r = i - m * nper;
    const int row = r / (cols * C), rc = r - row * cols * C;
    const int col = rc / C, c = rc - col * C;
    const int y = h - 1 + row, x = w0 - 1 + col;
    float v = 0.f;
    if (y >= 0 && y < a.H && x >= 0 && x < a.W)
      v = up_f(__ldg(static_cast<const T*>(up_sel(a.depth, m)) + ((size_t)(b * a.H + y) * a.W + x) * C + c));
    NB[i] = v;
  }
  __syncthreads();

  // the softmax over the 9 logits of every staged (coarse pixel, sub-pixel)
  for (int i = tid; i < 3 * cols * kk; i += UP_THREADS) {
    const int rc = i / kk, sub = i - rc * kk;
    const int r = rc / cols, col = rc - r * cols;
    const int y = h - 1 + r, x = w0 - 1 + col;
    if (y < 0 || y >= a.H || x < 0 || x >= a.W) continue;   // stays zero
    float* q = P + rc * nm + sub;
    float top = -INFINITY;
#pragma unroll
    for (int j = 0; j < 9; ++j) top = fmaxf(top, q[j * kk]);
    float p[9], sum = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      p[j] = __expf(q[j * kk] - top);
      sum += p[j];
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int j = 0; j < 9; ++j) q[j * kk] = p[j] * inv;
  }
  __syncthreads();

  // the mask's gradient: one thread a fine pixel (ki, wl, kj) of the segment
  T* gmask = static_cast<T*>(a.gmask);
  for (int f = tid; f < segw * kk; f += UP_THREADS) {
    const int ki = f / (segw * k), rem = f - ki * segw * k;
    const int wl = rem / k, kj = rem - wl * k;
    const float* q = P + (cols + wl + 1) * nm + ki * k + kj;
    float dp[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) dp[j] = 0.f;
    for (int m = 0; m < n; ++m) {
      const float* g = G + m * gper + ((k + ki) * fcols + (wl + 1) * k + kj) * C;
      const float* nb = NB + m * nper + wl * C;
      for (int c = 0; c < C; ++c) {
        const float gc = g[c];
#pragma unroll
        for (int j = 0; j < 9; ++j) dp[j] = fmaf(gc, nb[((j / 3) * cols + j % 3) * C + c], dp[j]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) s = fmaf(q[j * kk], dp[j], s);
    T* o = gmask + ((size_t)(b * a.H + h) * a.W + w0 + wl) * nm + ki * k + kj;
#pragma unroll
    for (int j = 0; j < 9; ++j) o[j * kk] = from_f<T>(q[j * kk] * (dp[j] - s));
  }

  // the maps' gradients: one thread a (coarse pixel, map, channel)
  for (int i = tid; i < segw * n * C; i += UP_THREADS) {
    const int wl = i / (n * C), mc = i - wl * n * C;
    const int m = mc / C, c = mc - m * C;
    float acc = 0.f;
    for (int ky = 0; ky < 3; ++ky) {
      const int r = 2 - ky;
      for (int kx = 0; kx < 3; ++kx) {
        const int col = wl + 2 - kx, j = ky * 3 + kx;
        const float* q = P + (r * cols + col) * nm + j * kk;
        const float* g = G + m * gper + (r * k * fcols + col * k) * C + c;
        for (int ki = 0; ki < k; ++ki)
          for (int kj = 0; kj < k; ++kj) acc = fmaf(q[ki * k + kj], g[(ki * fcols + kj) * C], acc);
      }
    }
    static_cast<T*>(up_sel(a.gdepth, m))[((size_t)(b * a.H + h) * a.W + w0 + wl) * C + c] =
        from_f<T>(acc);
  }
}

inline int up_vec(long long bytes_or_addr) {
  for (int v = 16; v > 2; v /= 2)
    if (bytes_or_addr % v == 0) return v;
  return 2;
}

inline int up_align16(int x) { return (x + 15) / 16 * 16; }

}  // namespace mt

// dtype: 0 f32, 1 bf16 (of the maps, the mask and the outputs). n maps
// (1..4) of (B, H, W, C) at d0..d3 share the (B, H, W, 9 k k) mask; their
// (B, k H, k W, C) outputs go to o0..o3 (unused pointers may be null).
// Returns cudaGetLastError() after the launch.
extern "C" int mt_upsample_mask(int dtype, int n, const void* d0, const void* d1, const void* d2,
                                const void* d3, const void* mask, void* o0, void* o1, void* o2,
                                void* o3, int B, int H, int W, int C, int k, void* stream) {
  using namespace mt;
  if (n < 1 || n > UP_MAX_MAPS || k < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  const int elem = dtype == 1 ? 2 : 4;
  const int kk = k * k, nm = 9 * kk;
  UpArgs a{{d0, d1, d2, d3}, {o0, o1, o2, o3}, mask, n, B, H, W, C, k};
  int seg = UP_FINE / kk > 1 ? UP_FINE / kk : 1;
  int smem = 0;
  for (;; seg = (seg + 1) / 2) {
    a.seg = seg;
    a.nb_off = up_align16(seg * nm * elem);
    a.out_off = a.nb_off + up_align16(n * 3 * (seg + 2) * C * 4);
    a.out_row = up_align16(seg * k * C * elem);
    smem = a.out_off + n * k * a.out_row;
    if (smem <= UP_SMEM || seg == 1) break;
  }
  if (smem > UP_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // a vector width that divides every row's offset, length and base
  long long mv = (long long)nm * elem | (long long)(uintptr_t)mask;
  long long ov = (long long)W * k * C * elem | (long long)seg * k * C * elem;
  for (int m = 0; m < n; ++m) ov |= (long long)(uintptr_t)a.out[m];
  a.mvec = up_vec(mv);
  a.ovec = up_vec(ov);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + seg - 1) / seg, H, B);
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(upsample_mask_kernel<bf16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    upsample_mask_kernel<bf16><<<grid, UP_THREADS, smem, s>>>(a);
  } else {
    cudaError_t err = cudaFuncSetAttribute(upsample_mask_kernel<float>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    upsample_mask_kernel<float><<<grid, UP_THREADS, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// The backward of mt_upsample_mask, same dtype rule. g0..g3: the upstream
// gradients of the n (B, k H, k W, C) outputs; d0..d3 and mask: the forward's
// inputs; gd0..gd3: the (B, H, W, C) gradients of the maps; gmask: the
// (B, H, W, 9 k k) gradient of the mask logits, the maps' terms summed.
// Returns cudaGetLastError() after the launch.
extern "C" int mt_upsample_mask_bwd(int dtype, int n, const void* g0, const void* g1,
                                    const void* g2, const void* g3, const void* d0,
                                    const void* d1, const void* d2, const void* d3,
                                    const void* mask, void* gd0, void* gd1, void* gd2, void* gd3,
                                    void* gmask, int B, int H, int W, int C, int k, void* stream) {
  using namespace mt;
  if (n < 1 || n > UP_MAX_MAPS || k < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  const int kk = k * k, nm = 9 * kk;
  UpBwdArgs a{{g0, g1, g2, g3}, {d0, d1, d2, d3}, {gd0, gd1, gd2, gd3}, mask, gmask,
              n, B, H, W, C, k};
  int seg = UP_FINE / kk > 1 ? UP_FINE / kk : 1;
  int smem = 0;
  for (;; seg = (seg + 1) / 2) {
    const int cols = seg + 2;
    a.seg = seg;
    a.g_off = up_align16(3 * cols * nm * 4);
    a.nb_off = a.g_off + up_align16(n * 3 * k * cols * k * C * 4);
    smem = a.nb_off + up_align16(n * 3 * cols * C * 4);
    if (smem <= UP_BWD_SMEM || seg == 1) break;
  }
  if (smem > UP_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + seg - 1) / seg, H, B);
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(upsample_mask_bwd_kernel<bf16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    upsample_mask_bwd_kernel<bf16><<<grid, UP_THREADS, smem, s>>>(a);
  } else {
    cudaError_t err = cudaFuncSetAttribute(upsample_mask_bwd_kernel<float>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    upsample_mask_bwd_kernel<float><<<grid, UP_THREADS, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}
