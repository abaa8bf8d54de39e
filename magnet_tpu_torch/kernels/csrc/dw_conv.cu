// Stride-1 depthwise KxK convolution (K = 3 or 5) with TF-SAME padding and no
// bias, NHWC: out[n, y, x, c] = sum_{dy, dx} x[n, y + dy - pt, x + dx - pl, c]
// * w[dy, dx, c], zero outside the image, accumulated in f32 and rounded
// once to x's type.
//
// Replaces the TPU kernel magnet_tpu/kernels/dwconv_pallas.py
// (dw_conv_pallas). The TPU version pads the input in XLA and reads each row
// tile twice (the tile and the next for its halo) through two BlockSpecs.
//
// Bound on an H100: bytes (2*K*K operations per value against 2 bytes read
// and 2 written in bf16).
//
// bf16 (dw_conv_hopper). The first version (kept for f32, dw_conv_kernel)
// staged an 8x16 tile with its halo through registers in one synchronous
// pass, then computed: no load overlapped the FMAs, the narrow maps (24
// and 48 channels, 83 % of the bytes on the trunk's path) left half of a
// block's threads idle in its second round, and every 16 bytes of output
// read K*K input and K*K tap vectors from shared memory. This one:
//   * persistent blocks walk over tiles of TH x TW output pixels and CV
//     16-byte channel vectors: below 64 channels all of a pixel's channels
//     (CV = C / 8) in a tile widened to keep the block's threads, blocks of
//     64 channels otherwise (TileOf);
//   * each tile's input with its halo is one box of a 4-d tensor map
//     (C, W, H, N) loaded by the tensor memory accelerator into a ring of
//     STAGES stages; the box may start above and left of the image, where
//     it reads zeros, which gives the SAME padding with no branch. Thread
//     0 starts the load of tile i + STAGES as soon as tile i's stage is
//     free, so loads run under the FMAs;
//   * a sliding window in registers: a thread owns 8 channels (4 at K = 5)
//     of a column of R outputs and keeps their K*K taps in registers in
//     f32. It walks down the column reading each input row's K vectors
//     from shared memory once, K (R + K - 1) / R reads an output vector
//     (3.75 at K = 3) where the first version made 2 K*K;
//   * outputs go from registers to device memory as 16-byte (8-byte)
//     stores.
// Shapes (CV, TW, channels a thread, R, rows of threads) are template
// parameters.

#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16: persistent tiles, a TMA ring, a sliding window in registers -----

namespace dwx {

constexpr int STAGES = 3;

// K: the window; CV: 16-byte channel vectors of a tile; TW: its width; E:
// channels a thread owns (8, or 4 at K = 5, whose 25 taps in f32 would not
// fit in registers with 8); R: output rows a thread walks; RG: rows of
// threads (the tile is R RG high).
template <int K_, int CV_, int TW_, int E_, int R_, int RG_>
struct Shape {
  static constexpr int K = K_, CV = CV_, TW = TW_, E = E_, R = R_, RG = RG_;
  static constexpr int TH = R * RG, IH = TH + K - 1, IW = TW + K - 1;
  static constexpr int LANES = CV * 8 / E;                // threads of a pixel
  static constexpr int THREADS = LANES * TW * RG;
  static constexpr int BOX = IH * IW * CV * 16;           // bytes of a halo box
  static constexpr int STAGE = (BOX + 127) / 128 * 128;
  static constexpr int SMEM = STAGES * STAGE + STAGES * 8 + 128;  // + alignment
};

struct Args {
  const bf16* w;  // (K, K, C)
  bf16* out;      // (N, H, W, C)
  int H, W, C, pt, pl;
  int tiles_x, tiles_y, ncb, tiles;
};

// E bf16 values, 2 E bytes, as E / 2 pairs.
template <int E>
struct Vec {
  uint32_t q[E / 2];
};
template <int E>
__device__ __forceinline__ Vec<E> load(const void* p) {
  Vec<E> v;
  if (E == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < E / 2; ++i) v.q[i] = q[i];
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v.q[0] = u.x;
    v.q[E / 2 - 1] = u.y;
  }
  return v;
}

__device__ __forceinline__ float lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// Work item t: image, output tile origin, channel block (fastest).
struct Tile {
  int n, y0, x0, cb;
};
template <class S>
__device__ __forceinline__ Tile tile(const Args& a, int t) {
  const int cb = t % a.ncb;
  t /= a.ncb;
  const int tx = t % a.tiles_x;
  t /= a.tiles_x;
  const int ty = t % a.tiles_y;
  return Tile{t / a.tiles_y, ty * S::TH, tx * S::TW, cb};
}

// Thread 0: tile t's halo box into stage st.
template <class S>
__device__ __forceinline__ void load_box(const CUtensorMap* map, const Args& a, int t,
                                      unsigned char* stage, uint64_t* full) {
  const Tile p = tile<S>(a, t);
  hp::mbar_arrive_expect_tx(full, S::BOX);
  hp::tma_load_4d(stage, map, p.cb * S::CV * 8, p.x0 - a.pl, p.y0 - a.pt, p.n, full);
}

template <class S>
__global__ void __launch_bounds__(S::THREADS)
    dw_conv_hopper(__grid_constant__ const CUtensorMap map, const Args a) {
  constexpr int K = S::K, E = S::E, R = S::R, PIX = S::CV * 16;  // bytes of a box pixel
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  unsigned char* smem = smem_dyn + ((128 - (hp::smem_addr(smem_dyn) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * S::STAGE);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hp::mbar_init(&full[s], 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < STAGES; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < a.tiles) load_box<S>(&map, a, t, smem + s * S::STAGE, &full[s]);
    }

  const int v = tid % S::LANES, col = tid / S::LANES % S::TW, rg = tid / (S::LANES * S::TW);
  float taps[K * K][E];  // of the thread's channels, in f32
  int cur_cb = -1;
  for (int seq = 0;; ++seq) {
    const int t = blockIdx.x + seq * gridDim.x;
    if (t >= a.tiles) break;
    const Tile p = tile<S>(a, t);
    const int c = p.cb * S::CV * 8 + v * E;  // the thread's first channel
    const bool cvalid = c < a.C;
    if (p.cb != cur_cb) {
      cur_cb = p.cb;
#pragma unroll
      for (int i = 0; i < K * K; ++i) {
        Vec<E> u{};
        if (cvalid) u = load<E>(a.w + (size_t)i * a.C + c);
#pragma unroll
        for (int e = 0; e < E / 2; ++e) {
          taps[i][2 * e] = lo(u.q[e]);
          taps[i][2 * e + 1] = hi(u.q[e]);
        }
      }
    }
    const int st = seq % STAGES;
    hp::mbar_wait(&full[st], (seq / STAGES) & 1);
    const unsigned char* in = smem + st * S::STAGE + v * E * 2;

    // the column's walk: input row i feeds output rows i - K + 1 .. i
    float acc[R][E];
#pragma unroll
    for (int i = 0; i < R + K - 1; ++i) {
      Vec<E> xv[K];
#pragma unroll
      for (int d = 0; d < K; ++d) xv[d] = load<E>(in + ((rg * R + i) * S::IW + col + d) * PIX);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int dy = i - j;
        if (dy < 0 || dy >= K) continue;
        if (dy == 0)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int d = 0; d < K; ++d)
#pragma unroll
          for (int e = 0; e < E / 2; ++e) {
            acc[j][2 * e] = fmaf(lo(xv[d].q[e]), taps[dy * K + d][2 * e], acc[j][2 * e]);
            acc[j][2 * e + 1] = fmaf(hi(xv[d].q[e]), taps[dy * K + d][2 * e + 1], acc[j][2 * e + 1]);
          }
        if (dy == K - 1) {
          const int y = p.y0 + rg * R + j, x = p.x0 + col;
          bf16* o = a.out + ((size_t)(p.n * a.H + y) * a.W + x) * a.C + c;
          if (cvalid && y < a.H && x < a.W) {
            if (E == 8) {
              *reinterpret_cast<uint4*>(o) = pack(acc[j], bf16());
            } else {
              const __nv_bfloat162 p0 = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
              const __nv_bfloat162 p1 = __floats2bfloat162_rn(acc[j][E - 2], acc[j][E - 1]);
              *reinterpret_cast<uint2*>(o) = make_uint2(*reinterpret_cast<const uint32_t*>(&p0),
                                                        *reinterpret_cast<const uint32_t*>(&p1));
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with the stage
    if (tid == 0) {
      const int next = t + STAGES * gridDim.x;
      if (next < a.tiles) load_box<S>(&map, a, next, smem + st * S::STAGE, &full[st]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime (no link to libcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <class S>
int launch(const bf16* x, const bf16* w, bf16* out, int N, int H, int W, int C, int pt, int pl,
           cudaStream_t s) {
  Args a{w, out, H, W, C, pt, pl};
  a.tiles_x = (W + S::TW - 1) / S::TW;
  a.tiles_y = (H + S::TH - 1) / S::TH;
  a.ncb = (C / 8 + S::CV - 1) / S::CV;
  const long long tiles = (long long)N * a.tiles_y * a.tiles_x * a.ncb;
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  if (a.tiles == 0) return (int)cudaSuccess;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(S::CV * 8), (cuuint32_t)S::IW, (cuuint32_t)S::IH, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dw_conv_hopper<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  int dev = 0, sms = 132, per_sm = 1;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dw_conv_hopper<S>, S::THREADS,
                                                        S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int slots = (per_sm > 1 ? per_sm : 1) * sms;
  const int grid = a.tiles < slots ? a.tiles : slots;
  dw_conv_hopper<S><<<grid, S::THREADS, S::SMEM, s>>>(map, a);
  return (int)cudaGetLastError();
}

// The tile of a launch at K and CV channel vectors. Below 64 channels CV =
// C / 8 holds all of a pixel's channels, and the tile is 96 / CV pixels wide
// at K = 3 (about 192 threads), 64 / CV at K = 5 (E = 4: about 256), so no
// width leaves lanes idle; 64 channels or more go in blocks of 64 (CV = 8),
// 8 pixels wide (the shape measured at 768 and 1824 channels).
template <int K, int CV>
using TileOf = Shape<K, CV, CV == 8 ? 8 : (K == 3 ? 96 : 64) / CV, K == 3 ? 8 : 4, 8, 2>;

template <int K>
int launch_k(const bf16* x, const bf16* w, bf16* out, int N, int H, int W, int C, int pt, int pl,
             cudaStream_t s) {
  switch (C < 64 ? C / 8 : 8) {
    case 1: return launch<TileOf<K, 1>>(x, w, out, N, H, W, C, pt, pl, s);
    case 2: return launch<TileOf<K, 2>>(x, w, out, N, H, W, C, pt, pl, s);
    case 3: return launch<TileOf<K, 3>>(x, w, out, N, H, W, C, pt, pl, s);
    case 4: return launch<TileOf<K, 4>>(x, w, out, N, H, W, C, pt, pl, s);
    case 5: return launch<TileOf<K, 5>>(x, w, out, N, H, W, C, pt, pl, s);
    case 6: return launch<TileOf<K, 6>>(x, w, out, N, H, W, C, pt, pl, s);
    case 7: return launch<TileOf<K, 7>>(x, w, out, N, H, W, C, pt, pl, s);
    default: return launch<TileOf<K, 8>>(x, w, out, N, H, W, C, pt, pl, s);
  }
}

}  // namespace dwx

}  // namespace mt

// dtype: 0 f32, 1 bf16. x: (N, H, W, C); w: (K, K, C); out: (N, H, W, C); C
// a multiple of 16 bytes; x 16-byte aligned; K 3 or 5. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another K).
extern "C" int mt_dw_conv(int dtype, const void* x, const void* w, void* out,
                          int N, int H, int W, int C, int K, int pt, int pl,
                          void* stream) {
  using namespace mt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* ob = static_cast<bf16*>(out);
    if (K == 3) return dwx::launch_k<3>(xb, wb, ob, N, H, W, C, pt, pl, s);
    if (K == 5) return dwx::launch_k<5>(xb, wb, ob, N, H, W, C, pt, pl, s);
  } else {
    if (K == 3) return launch_dw_conv<float, 3>(x, w, out, N, H, W, C, pt, pl, s);
    if (K == 5) return launch_dw_conv<float, 5>(x, w, out, N, H, W, C, pt, pl, s);
  }
  return (int)cudaErrorInvalidValue;
}
