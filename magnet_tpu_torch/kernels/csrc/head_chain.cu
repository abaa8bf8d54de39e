// Fused prediction-head chain: one SAME 3x3 conv C0 -> 128, then up to three
// 1x1 convs (128 -> 128, the last 128 -> c_out <= 256), each with a bias and
// an optional ReLU. NHWC.
//
// Replaces the TPU kernel magnet_tpu/kernels/headchain_pallas.py
// (head_chain_pallas): the D-Net depth and mask heads, the 4-conv MaGNet mask
// head and G-Net's conv0_feat. As on the TPU, the hidden 128-channel tiles
// never reach device memory; only the last layer's c_out channels are
// stored.
//
// Bound on an H100: tensor-core operations. At the ScanNet eval shape the
// 3x3 conv is M = 19200 pixels a frame, N = 128, K = 2304 (11.3 GFLOP)
// against about 10 MB of input, so the 3x3 dominates; the 1x1 layers add
// 0.6-1.3 GFLOP and no traffic. The first (WMMA) version ran at about 10 %
// of the bf16 peak. The bf16 kernel runs the 3x3 as hopper_conv.cuh's conv
// (wgmma on a halo tile per 64-channel block that the nine taps read as
// descriptor windows, persistent blocks of 8x16 output pixels, a bulk-copy
// ring of weight slabs packed once on the host: kernels/head_chain.py::
// pack_head). Each 1x1 layer then multiplies the previous layer's results
// without leaving the registers: bias and ReLU applied, the m64n128 f32
// fragment rounded to bf16 pairs is the A fragment of the next wgmma's k16
// steps (hopper.cuh::wgmma_rs), so no hidden tile is written to shared
// memory and no barrier orders it (the 1x1 layers take 5-8 % of the
// kernel, profile_psm_conv's no_1x1). The 1x1 weights (128 x 128, and the
// last layer's c_out in column chunks of 128, zero padded: 2 and 128 in
// one, 144 in two) come through the same ring as the 3x3's slabs: resident
// copies would not fit beside the ring and the halo stages. The bf16
// rounding of each hidden layer is the reference's. The last layer's
// results go out through a shared-memory staging tile.
// f32 keeps the FMA implicit GEMM of common.cuh (SimtCore), which equals a
// full-precision reference (no TF32).

#include "common.cuh"
#include "hopper_conv.cuh"

namespace mt {

struct HeadArgs {
  const void* x;
  const void* w[4];   // w[0]: (9*C0, 128); w[l]: (128, pad16(width of layer l))
  const float* b[4];  // (pad16(width),) f32, zero padded
  void* out;          // (N, H, W, c_out)
  int N, H, W, C0, n_convs, c_out, relu_mask;
};

template <typename T>
constexpr int head_smem_bytes() {
  return TileLoader<T, HBM, HID>::SMEM + 2 * HBM * HidCfg<T>::LDH * (int)sizeof(T);
}

template <typename T, class Core>
__global__ void __launch_bounds__(THREADS) head_chain_kernel(HeadArgs h) {
  using L = TileLoader<T, HBM, HID>;
  constexpr int LDH = HidCfg<T>::LDH;
  static_assert(L::SMEM >= THREADS / 32 * 256 * (int)sizeof(float), "scratch");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hid[2] = {reinterpret_cast<T*>(smem_raw + L::SMEM),
               reinterpret_cast<T*>(smem_raw + L::SMEM) + HBM * LDH};
  float* scratch = reinterpret_cast<float*>(smem_raw);  // after the K loop

  const int m0 = blockIdx.x * HBM;
  const int M = h.N * h.H * h.W;
  ConvArgs a{h.x, nullptr, h.w[0], nullptr, h.N, h.H, h.W, h.H, h.W, h.C0, 0, HID, false};
  L ld(a, m0, 0);
  Core core;
  run_mainloop(core, ld, reinterpret_cast<T*>(smem_raw));

  // Layer 0: bias + ReLU into hidden tile 0, or the output if it is the last.
  const bool last0 = h.n_convs == 1;
  const bool relu0 = h.relu_mask & 1;
  T* out = static_cast<T*>(h.out);
  const float* b0 = h.b[0];
  core.epilogue(scratch, [&](int row, int col, const float* v, int cnt) {
    for (int e = 0; e < cnt; ++e) {
      float y = v[e] + b0[col + e];
      if (relu0) y = fmaxf(y, 0.f);
      if (last0) {
        if (m0 + row < M) out[(size_t)(m0 + row) * HID + col + e] = from_f<T>(y);
      } else {
        hid[0][row * LDH + col + e] = from_f<T>(y);
      }
    }
  });
  __syncthreads();

  for (int l = 1; l < h.n_convs; ++l) {
    const bool last = l == h.n_convs - 1;
    chain_layer(hid[(l - 1) & 1], hid[l & 1], last ? out : nullptr,
                static_cast<const T*>(h.w[l]), h.b[l], last ? h.c_out : HID,
                (h.relu_mask >> l) & 1, scratch, m0, M, static_cast<Core*>(nullptr));
    __syncthreads();
  }
}

template <typename T, class Core>
int launch_head(const HeadArgs& h, cudaStream_t s) {
  constexpr int smem = head_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(head_chain_kernel<T, Core>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)h.N * h.H * h.W;
  dim3 grid((unsigned)((M + HBM - 1) / HBM));
  head_chain_kernel<T, Core><<<grid, THREADS, smem, s>>>(h);
  return (int)cudaGetLastError();
}

// ---- bf16: hopper_conv.cuh, the 1x1 layers on register operands -----------

constexpr int SLAB = 128 * 64;  // elements of a weight slab: 128 rows of 64

struct HxHeadArgs {
  const bf16* x;      // (N, H, W, C0)
  const bf16* w[4];   // packed (head_chain.py::pack_head)
  const float* b[4];  // f32, zero padded to the packed widths
  bf16* out;          // (N, H, W, c_out)
  int n_convs, c_out, relu_mask;
  int cpad;           // the last layer's width padded to 128
};

// Slab i of a patch's sequence: the 3x3's (K block, tap) slabs, two K
// blocks per hidden 1x1 layer, then two per 128-column chunk of the last.
__device__ __forceinline__ const bf16* head_slab(const HxHeadArgs& a, int n3, int i) {
  if (i < n3) return a.w[0] + (size_t)i * SLAB;
  i -= n3;
  const int hidden = a.n_convs - 2;
  if (i < 2 * hidden) return a.w[1 + i / 2] + (size_t)(i % 2) * SLAB;
  i -= 2 * hidden;
  return a.w[a.n_convs - 1] + ((size_t)(i % 2) * a.cpad + 128 * (i / 2)) * 64;
}

__global__ void __launch_bounds__(hx::THREADS, 1)
    head_chain_hopper(const hx::Geom g, const HxHeadArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_dyn[];
  hx::Bars b;
  // the biases: layer l's at 128 l, the last layer's c_out padded to 128
  unsigned char* smem = hx::setup(g, smem_dyn, b, [&](int i) {
    const int l = min(i / 128, a.n_convs - 1);
    return a.b[l][i - 128 * l];
  });
  const int tid = threadIdx.x;
  const int n3 = g.nkb * 9;
  const int nchunk = a.cpad / 128;
  const int nslab = n3 + (a.n_convs > 1 ? 2 * (a.n_convs - 2) + 2 * nchunk : 0);
  if (tid >= hx::CONSUMERS + 32) {
    hx::stage_halos(g, a.x, smem, b, tid - hx::CONSUMERS - 32);
    return;
  }
  if (tid >= hx::CONSUMERS) {
    if (tid == hx::CONSUMERS)
      hx::stream_weights(g, smem, b, nslab, [&](int, int i) { return head_slab(a, n3, i); });
    return;
  }
  const int wg = tid / 128, wt = tid % 128;
  constexpr int LD = (128 + 8) * 2;  // staging row bytes
  unsigned char* stg = smem + g.off_stg + wg * g.stg;
  const float* bias = reinterpret_cast<const float*>(smem + g.off_par);
  hx::Consumer cs(g, smem, b, (tid & 31) == 0);
  float tile[1][64];  // the warpgroup's m64 x 128 accumulators
  float (&acc)[64] = tile[0];
  uint32_t frag[8][4];
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    hx::conv_patch<128, 1, 64, false>(cs, tile, wg);
    const hx::Patch p = hx::patch(g, t);
    int slab = n3;
    for (int l = 0; l < a.n_convs; ++l) {
      const bool last = l == a.n_convs - 1;
      const bool relu = (a.relu_mask >> l) & 1;
      for (int ch = 0; ch < (last && l > 0 ? nchunk : 1); ++ch) {
        if (l > 0) {
          // this layer's products (128 columns of it): the previous layer's
          // bf16 fragments times two 64-row K blocks of the slab sequence
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
        }
        // bias and ReLU on every register (the biases are zero past the
        // layer's width); a hidden layer's results, as bf16 pairs, are the
        // next layer's A fragments (register 4 j + 2 h of the accumulator
        // is element 2 (j % 2) + h of k16 step j / 2's), the last layer's go
        // through the staging tile. The accumulators are only read: writing
        // them between the wgmma would make the compiler serialize them.
        const float* bl = bias + 128 * (l + ch);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * (wt % 4);
          const float2 bv = *reinterpret_cast<const float2*>(bl + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[4 * j + 2 * h] + bv.x;
            float v1 = acc[4 * j + 2 * h + 1] + bv.y;
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            if (last) {
              hx::stage_pair(stg, LD, 0, wt, j, h, v0, v1);
            } else {
              __nv_bfloat162 pr = __floats2bfloat162_rn(v0, v1);
              frag[j / 2][2 * (j % 2) + h] = *reinterpret_cast<uint32_t*>(&pr);
            }
          }
        }
        if (!last) continue;
        hp::bar_sync(1 + wg, 128);
        // columns [c0, c0 + width) of the output, 8 a chunk
        const int c0 = 128 * ch, width = min(128, a.c_out - c0), chunks = (width + 7) / 8;
        for (int e = wt; e < 64 * chunks; e += 128) {
          const int px = e / chunks, c8 = e % chunks;
          const int y = p.y0 + px / 8, x = p.x0 + 8 * wg + px % 8;
          if (y >= g.Ho || x >= g.Wo) continue;
          bf16* o = a.out + (((size_t)p.img * g.Ho + y) * g.Wo + x) * a.c_out + c0 + 8 * c8;
          const bf16* v = reinterpret_cast<const bf16*>(stg + px * LD + 16 * c8);
          if (a.c_out % 8 == 0) {
            *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
          } else {
            for (int q = 0; q < 8 && 8 * c8 + q < width; ++q) o[q] = v[q];
          }
        }
        hp::bar_sync(1 + wg, 128);  // the tile is free for the next results
      }
    }
  }
}

}  // namespace mt

// dtype: 0 f32, 1 bf16. relu_mask bit l: ReLU after conv l. f32: w0 (9 C0,
// 128) and w_l (128, pad16(width)), biases padded to pad16(width); bf16: the
// weights packed by head_chain.py::pack_head, biases padded to the packed
// widths. Returns cudaGetLastError() after the launch.
extern "C" int mt_head_chain(int dtype, const void* x, const void* w0, const void* w1,
                             const void* w2, const void* w3, const void* b0,
                             const void* b1, const void* b2, const void* b3, void* out,
                             int N, int H, int W, int C0, int n_convs, int c_out,
                             int relu_mask, void* stream) {
  using namespace mt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bs[4] = {static_cast<const float*>(b0), static_cast<const float*>(b1),
                        static_cast<const float*>(b2), static_cast<const float*>(b3)};
  if (dtype == 1) {
    if (n_convs < 1 || n_convs > 4 || c_out > 256 || (n_convs == 1 && c_out != 128))
      return (int)cudaErrorInvalidValue;
    HxHeadArgs a{static_cast<const bf16*>(x),
                 {static_cast<const bf16*>(w0), static_cast<const bf16*>(w1),
                  static_cast<const bf16*>(w2), static_cast<const bf16*>(w3)},
                 {bs[0], bs[1], bs[2], bs[3]},
                 static_cast<bf16*>(out), n_convs, c_out, relu_mask, (c_out + 127) / 128 * 128};
    hx::Geom g = hx::make_geom(N, H, W, C0, 1, 1, 9, 64, 1, 1);
    if (!hx::layout(g, 0, SLAB * 2, false, 128 * (n_convs - 1) + a.cpad, 64 * (128 + 8) * 2))
      return (int)cudaErrorInvalidValue;
    return hx::launch(head_chain_hopper, g, s, g, a);
  }
  HeadArgs h{x, {w0, w1, w2, w3}, {bs[0], bs[1], bs[2], bs[3]}, out, N, H, W, C0, n_convs,
             c_out, relu_mask};
  return launch_head<float, SimtCore<HBM, HID>>(h, s);
}
