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
// and a GPU tile is not tied to 128 lanes. Here each conv is one launch, the
// maps between convs go through device memory (2.5-12 MB in bf16 at the
// ScanNet eval shape, which the 50 MB L2 cache holds), and what the TPU
// kernels fused per conv is fused here per conv too: y = acc * scale + shift
// in f32, then ReLU (first conv of a block, stem convs) or + residual
// (second conv), rounded once. The projection of a transition block is its
// own launch (one tap, no halo), rounded before conv2 adds it, as the
// unfused reference rounds it.
//
// Bound on an H100: tensor-core operations for the 64- and 128-channel
// stages (K = 576 or 1152 per output value against 2 bytes read and written
// per value); the 32-channel stem and layer1 at 240x320 sit near the ridge.
// The first (WMMA) version ran at 6.5-10 % of the bf16 peak. The bf16
// kernel is hopper_conv.cuh's: wgmma (m64 x 32, 64 or 128 outputs x k16,
// 128 / width m64 tiles a warpgroup up to 64 outputs) on 128- or 64-byte
// swizzled operands, a halo tile per K block that all nine taps read as
// descriptor windows (stride 2 as four phases in shared memory, dilation 2
// as a 2-pixel halo), persistent blocks whose halo warps stage the next
// patch under this one's products and epilogue, and weights packed once on
// the host (kernels/psm_blocks.py::pack_weights). A conv whose slabs fit
// beside the halos (Ci x Co up to 64 x 128) keeps them in shared memory for
// the block's life; the 128-channel convs stream them through a ring.
// 32-channel inputs take K blocks of 32 in the 64-byte swizzle layout
// rather than 64 channels with 32 of zeros, which would double the MMA work
// of the layers near the ridge (psm_blocks.py::k_block; on an H100 the
// stem's conv at 240x320, 5 frames, takes 0.041 ms so and 0.065 ms padded,
// profile_psm_conv.py --ablate). The residual is copied into the epilogue's
// staging tile under the products; scale and shift are kept in shared
// memory.
// f32 keeps the FMA implicit GEMM of psm.cuh (SimtCore), which equals a
// full-precision reference (no TF32).

#include "hopper_conv.cuh"
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

// ---- bf16: hopper_conv.cuh -------------------------------------------------

struct HxConvArgs {
  const bf16* x;       // (N, H, W, Ci)
  const bf16* wp;      // packed: (nkb, taps, cout_pad, kb), swizzled
  const float* scale;  // (Co,)
  const float* shift;
  const bf16* res;     // (N, Ho, Wo, Co) or null
  bf16* out;           // (N, Ho, Wo, Co)
  int Co, cout_pad, relu;
};

// MT m64 tiles a warpgroup (64 accumulators a thread). The epilogue
// visits the registers of a thread's tile m as (j, h): columns 8 j + 2 (t %
// 4) + {0, 1} of fragment row frag_row(t, 4 j + 2 h).
template <int BN, int MT, int KB, bool RES>
__global__ void __launch_bounds__(hx::THREADS, 1)
    psm_conv_hopper(const hx::Geom g, const HxConvArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_dyn[];
  hx::Bars b;
  // scale, then shift, of every output channel (zero past Co)
  unsigned char* smem = hx::setup(g, smem_dyn, b, [&](int i) {
    const int n = i % a.cout_pad;
    return n < a.Co ? (i < a.cout_pad ? a.scale : a.shift)[n] : 0.f;
  });
  const int tid = threadIdx.x;
  if (tid >= hx::CONSUMERS + 32) {
    hx::stage_halos(g, a.x, smem, b, tid - hx::CONSUMERS - 32);
    return;
  }
  if (tid >= hx::CONSUMERS) {
    if (tid == hx::CONSUMERS)
      hx::stream_weights(g, smem, b, g.nkb * g.taps, [&](int t, int i) {
        return a.wp + ((size_t)i * a.cout_pad + t % g.nblk * BN) * g.kb;
      });
    return;
  }
  const int wg = tid / 128, wt = tid % 128;
  const float* pars = reinterpret_cast<const float*>(smem + g.off_par);
  constexpr int LD = (BN + 8) * 2;       // staging row bytes
  constexpr int CHUNKS = MT * 64 * BN / 8;  // 16-byte chunks of a staging tile
  unsigned char* stg = smem + g.off_stg + wg * g.stg;
  hx::Consumer cs(g, smem, b, (tid & 31) == 0);
  if (RES) hp::mbar_wait(&b.wfull[0], 0);
  float acc[MT][BN / 2];
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const hx::Patch p = hx::patch(g, t);
    // staging chunk e: pixel e / (BN / 8) of the warpgroup's tiles, 8
    // output channels; its offset in the output, or -1 outside
    auto out_at = [&](int e) -> long long {
      const int px = e / (BN / 8), r = px % 64;
      const int y = p.y0 + r / 8, x = p.x0 + 8 * (MT * wg + px / 64) + r % 8;
      const int n = p.nb * BN + 8 * (e % (BN / 8));
      if (y >= g.Ho || x >= g.Wo || n >= a.Co) return -1;
      return (((long long)p.img * g.Ho + y) * g.Wo + x) * a.Co + n;
    };
    // the residual into the staging tile, under the products
    if (a.res) {
      for (int e = wt; e < CHUNKS; e += 128) {
        const long long o = out_at(e);
        hp::cp_async16(stg + e / (BN / 8) * LD + 16 * (e % (BN / 8)), o >= 0 ? a.res + o : a.res,
                       o >= 0);
      }
      hp::cp_async_commit();
    }
    hx::conv_patch<BN, MT, KB, RES>(cs, acc, wg);
    if (a.res) {
      hp::cp_async_wait_all();
      hp::bar_sync(1 + wg, 128);
    }
    // each result in place of its residual in the staging tile
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = p.nb * BN + 8 * j + 2 * (wt % 4);  // < cout_pad
          float v0 = acc[m][4 * j + 2 * h] * pars[n] + pars[a.cout_pad + n];
          float v1 = acc[m][4 * j + 2 * h + 1] * pars[n + 1] + pars[a.cout_pad + n + 1];
          if (a.res) {
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                stg + (64 * m + hp::frag_row(wt, 4 * j + 2 * h)) * LD + (n - p.nb * BN) * 2));
            v0 += r.x;
            v1 += r.y;
          }
          if (a.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          hx::stage_pair(stg, LD, m, wt, j, h, v0, v1);
        }
    hp::bar_sync(1 + wg, 128);
#pragma unroll
    for (int e = wt; e < CHUNKS; e += 128) {
      const long long o = out_at(e);
      if (o >= 0)
        *reinterpret_cast<uint4*>(a.out + o) =
            *reinterpret_cast<const uint4*>(stg + e / (BN / 8) * LD + 16 * (e % (BN / 8)));
    }
    hp::bar_sync(1 + wg, 128);  // the tile is free for the next patch
  }
}

// One kernel for the conv: the output width BN, MT m64 tiles a warpgroup
// (64 accumulators a thread: two tiles of 128 outputs spill), K blocks of
// kb and resident weights where they fit. Returns a CUDA error.
template <int BN, int MT>
int launch_tiles(hx::Geom g, const HxConvArgs& a, cudaStream_t s) {
  if (!hx::layout(g, g.nkb * g.taps, BN * g.kb * 2, true, 2 * a.cout_pad,
                  MT * 64 * (BN + 8) * 2))
    return (int)cudaErrorInvalidValue;
  if (g.kb == 32)
    return g.resident ? hx::launch(psm_conv_hopper<BN, MT, 32, true>, g, s, g, a)
                      : hx::launch(psm_conv_hopper<BN, MT, 32, false>, g, s, g, a);
  return g.resident ? hx::launch(psm_conv_hopper<BN, MT, 64, true>, g, s, g, a)
                    : hx::launch(psm_conv_hopper<BN, MT, 64, false>, g, s, g, a);
}

int launch_hopper(int N, int H, int W, int Ci, int stride, int dil, int taps, int kb,
                  const HxConvArgs& a, cudaStream_t s) {
  const int nblk = a.cout_pad / (a.Co <= 32 ? 32 : a.Co <= 64 ? 64 : 128);
  auto geom = [&](int mt) { return hx::make_geom(N, H, W, Ci, stride, dil, taps, kb, mt, nblk); };
  if (a.Co <= 32) return launch_tiles<32, 4>(geom(4), a, s);
  if (a.Co <= 64) return launch_tiles<64, 2>(geom(2), a, s);
  return launch_tiles<128, 1>(geom(1), a, s);
}

}  // namespace mt

// dtype: 0 f32, 1 bf16. f32: w HWIO (taps, C0 + C1 + C2, Cout); x1, x2 and res
// may be null (C1 = C2 = 0). bf16: x1 = x2 = null, w packed
// (psm_blocks.py::pack_weights) with K blocks of `kblock` (32 or 64) input
// channels, output channels in blocks of up to 128; a stride of 2 takes a
// dilation of 1. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int mt_psm_conv(int dtype, const void* x0, const void* x1, const void* x2,
                           const void* w, const void* scale, const void* shift,
                           const void* res, void* out, int N, int H, int W, int C0,
                           int C1, int C2, int Cout, int taps, int stride, int dil,
                           int relu, int kblock, void* stream) {
  using namespace mt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (dtype == 1) {
    if (x1 || x2 || (kblock != 32 && kblock != 64) ||
        (stride == 2 && taps == 9 && dil != 1))
      return (int)cudaErrorInvalidValue;
    const int bn = Cout <= 32 ? 32 : Cout <= 64 ? 64 : 128;
    const HxConvArgs a{static_cast<const bf16*>(x0), static_cast<const bf16*>(w), sc, sh,
                       static_cast<const bf16*>(res), static_cast<bf16*>(out), Cout,
                       (Cout + bn - 1) / bn * bn, relu};
    return launch_hopper(N, H, W, C0, stride, dil, taps, kblock, a, s);
  }
  PsmArgs a{{x0, x1, x2}, {C0, x1 ? C1 : 0, x2 ? C2 : 0}, w, N, H, W,
            (H - 1) / stride + 1, (W - 1) / stride + 1, 0, Cout, taps, stride, dil};
  a.Ctot = a.C[0] + a.C[1] + a.C[2];
  if (Cout <= 64)
    return launch_psm_conv<float, SimtCore<128, 64>, 64>(a, sc, sh, res, out, relu, s);
  return launch_psm_conv<float, SimtCore<128, 128>, 128>(a, sc, sh, res, out, relu, s);
}
