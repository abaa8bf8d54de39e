// Fused tail of PSM-Net's feature extractor: SAME 3x3 conv over the channel
// concat [raw | skip | branches] -> 128, folded eval BatchNorm, ReLU, then a
// 1x1 projection (no bias) to the feature width. NHWC.
//
// Replaces the TPU kernel magnet_tpu/kernels/spptail_pallas.py
// (spp_tail_fused). As there, the 320-channel concat is never built and the
// 128-channel hidden tile never reaches device memory; only the projected
// features are stored. The TPU version's row-tile halo DMAs and the lane
// padding of the 64-channel map do not carry over.
//
// Bound on an H100: tensor-core operations. At the ScanNet eval shape (5
// frames at 120x160) the 3x3 conv is M = 96000 pixels, N = 128, K = 2880
// (70.8 GFLOP) against about 20 MB of input; the 1x1 adds 1.6 GFLOP. The
// first (WMMA) version ran at 12 % of the bf16 peak. The bf16 kernel is the
// head chain's design (head_chain.cu) on hopper_conv.cuh's conv: persistent
// blocks of 8 x 16 output pixels, wgmma m64n128k16 on a halo tile per
// 64-channel K block that the nine taps read as descriptor windows, a
// bulk-copy ring of weight slabs. What is new is the input: each of the
// three maps is a whole number of 64-channel K blocks (a map whose width is
// not a multiple of 64 is padded with zeros to its own K blocks), and the
// halo warps stage K block kb from its map through a table of (map,
// channels, first channel) (hopper_conv.cuh::stage_halos_src), so no K
// block mixes two maps. The weights are packed once on the host in the same
// K blocks (kernels/spp_tail.py::tail_operands). The epilogue applies the
// folded BN's f32 scale and shift and the ReLU to the accumulators, rounds
// to bf16, and those pairs are the register A operand of the 1x1's wgmma
// (hopper.cuh::wgmma_rs); the projected channels go out through a
// shared-memory staging tile.
// f32 keeps the FMA implicit GEMM of psm.cuh (PsmLoader, SimtCore), which
// equals a full-precision reference (no TF32).

#include "hopper_conv.cuh"
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


// ---- bf16: hopper_conv.cuh with a K-block table, the 1x1 on register operands

constexpr int SLAB = 128 * 64;  // elements of a weight slab: 128 rows of 64

struct HxTailArgs {
  hx::KSrc src[hx::MAX_KSRC];  // K block kb of the 3x3's input
  const bf16* w0;              // packed (nkb, 9, 128, 64) (spp_tail.py::tail_operands)
  const bf16* w1;              // packed (2, 1, cpad, 64)
  const float* scale;          // (128,) folded BN
  const float* shift;
  bf16* out;                   // (N, H, W, c_out)
  int c_out, cpad;             // cpad: c_out padded to 128
};

// Slab i of a patch's sequence: the 3x3's (K block, tap) slabs, then two per
// 128-column chunk of the 1x1.
__device__ __forceinline__ const bf16* tail_slab(const HxTailArgs& a, int n3, int i) {
  if (i < n3) return a.w0 + (size_t)i * SLAB;
  i -= n3;
  return a.w1 + ((size_t)(i % 2) * a.cpad + 128 * (i / 2)) * 64;
}

__global__ void __launch_bounds__(hx::THREADS, 1)
    spp_tail_hopper(const hx::Geom g, const __grid_constant__ HxTailArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_dyn[];
  hx::Bars b;
  // the folded BN: scale at 0, shift at 128
  unsigned char* smem = hx::setup(g, smem_dyn, b, [&](int i) {
    return i < 128 ? a.scale[i] : a.shift[i - 128];
  });
  const int tid = threadIdx.x;
  const int n3 = g.nkb * 9;
  const int nchunk = a.cpad / 128;
  if (tid >= hx::CONSUMERS + 32) {
    hx::stage_halos_src(g, a.src, smem, b, tid - hx::CONSUMERS - 32);
    return;
  }
  if (tid >= hx::CONSUMERS) {
    if (tid == hx::CONSUMERS)
      hx::stream_weights(g, smem, b, n3 + 2 * nchunk,
                         [&](int, int i) { return tail_slab(a, n3, i); });
    return;
  }
  const int wg = tid / 128, wt = tid % 128;
  constexpr int LD = (128 + 8) * 2;  // staging row bytes
  unsigned char* stg = smem + g.off_stg + wg * g.stg;
  const float* bn = reinterpret_cast<const float*>(smem + g.off_par);
  hx::Consumer cs(g, smem, b, (tid & 31) == 0);
  float tile[1][64];  // the warpgroup's m64 x 128 accumulators
  float (&acc)[64] = tile[0];
  uint32_t frag[8][4];
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    hx::conv_patch<128, 1, 64, false>(cs, tile, wg);
    const hx::Patch p = hx::patch(g, t);
    // BN and ReLU in f32, rounded to bf16 pairs: the 1x1's A fragments
    // (register 4 j + 2 h of the accumulator is element 2 (j % 2) + h of
    // k16 step j / 2's). The accumulators are only read here: writing them
    // between the wgmma would make the compiler serialize them.
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * (wt % 4);
      const float2 sc = *reinterpret_cast<const float2*>(bn + col);
      const float2 sh = *reinterpret_cast<const float2*>(bn + 128 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = fmaxf(acc[4 * j + 2 * h] * sc.x + sh.x, 0.f);
        const float v1 = fmaxf(acc[4 * j + 2 * h + 1] * sc.y + sh.y, 0.f);
        __nv_bfloat162 pr = __floats2bfloat162_rn(v0, v1);
        frag[j / 2][2 * (j % 2) + h] = *reinterpret_cast<uint32_t*>(&pr);
      }
    }
    int slab = n3;
    for (int ch = 0; ch < nchunk; ++ch) {
      // the projection's columns [128 ch, 128 ch + 128): the hidden bf16
      // fragments times two 64-row K blocks of the slab sequence
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const unsigned char* w = cs.slab<false>(slab++);
        hp::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          hp::wgmma_rs<128>(acc, frag[4 * kb + k], hp::desc_sw128(w + 32 * k, 1024), kb | k);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        cs.release(cs.stage_of_last(), -1);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) hp::fence_operand(acc[i]);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          hx::stage_pair(stg, LD, 0, wt, j, h, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      hp::bar_sync(1 + wg, 128);
      // columns [c0, c0 + width) of the output, 8 a chunk
      const int c0 = 128 * ch, width = min(128, a.c_out - c0), chunks = width / 8;
      for (int e = wt; e < 64 * chunks; e += 128) {
        const int px = e / chunks, c8 = e % chunks;
        const int y = p.y0 + px / 8, x = p.x0 + 8 * wg + px % 8;
        if (y >= g.Ho || x >= g.Wo) continue;
        *reinterpret_cast<uint4*>(a.out + (((size_t)p.img * g.Ho + y) * g.Wo + x) * a.c_out +
                                  c0 + 8 * c8) =
            *reinterpret_cast<const uint4*>(stg + px * LD + 16 * c8);
      }
      hp::bar_sync(1 + wg, 128);  // the tile is free for the next results
    }
  }
}

}  // namespace mt

// dtype: 0 f32, 1 bf16. f32: w0 HWIO (3, 3, C0 + C1 + C2, 128), w1 (128,
// c_out), zero (c_out,) zeros (the projection has no bias); bf16: w0 and w1
// packed by spp_tail.py::tail_operands (each map in K blocks of 64
// channels), zero unused. c_out a multiple of 16, at most 256; each map's
// channels a multiple of 16 bytes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int mt_spp_tail(int dtype, const void* raw, const void* skip, const void* br,
                           const void* w0, const void* scale, const void* shift,
                           const void* w1, const void* zero, void* out, int N, int H,
                           int W, int C0, int C1, int C2, int c_out, void* stream) {
  using namespace mt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (c_out % 16 || c_out > 256) return (int)cudaErrorInvalidValue;
    HxTailArgs a{};
    const void* maps[3] = {raw, skip, br};
    const int widths[3] = {C0, C1, C2};
    int nkb = 0;
    for (int m = 0; m < 3; ++m)
      for (int c0 = 0; c0 < widths[m]; c0 += 64) {
        if (nkb == hx::MAX_KSRC) return (int)cudaErrorInvalidValue;
        a.src[nkb++] = hx::KSrc{static_cast<const bf16*>(maps[m]), widths[m], c0};
      }
    a.w0 = static_cast<const bf16*>(w0);
    a.w1 = static_cast<const bf16*>(w1);
    a.scale = static_cast<const float*>(scale);
    a.shift = static_cast<const float*>(shift);
    a.out = static_cast<bf16*>(out);
    a.c_out = c_out;
    a.cpad = (c_out + 127) / 128 * 128;
    hx::Geom g = hx::make_geom(N, H, W, 64 * nkb, 1, 1, 9, 64, 1, 1);
    if (!hx::layout(g, 0, SLAB * 2, false, 256, 64 * (128 + 8) * 2))
      return (int)cudaErrorInvalidValue;
    return hx::launch(spp_tail_hopper, g, s, g, a);
  }
  PsmArgs a{{raw, skip, br}, {C0, C1, C2}, w0, N, H, W, H, W, C0 + C1 + C2, HID, 9, 1, 1};
  TailArgs h{a, static_cast<const float*>(scale), static_cast<const float*>(shift), w1,
             static_cast<const float*>(zero), out, c_out};
  return launch_tail<float, SimtCore<HBM, HID>>(h, s);
}
