// Learned convex upsampling by k, NHWC, of up to four maps that share a mask.
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
