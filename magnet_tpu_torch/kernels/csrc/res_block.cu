// One stride-1 PSM-Net BasicBlock in one launch, eval BatchNorm folded, NHWC:
//   out = bn2(conv2(relu(bn1(conv1(x))))) + x
// both convs 3x3 with dilation d and padding d, no activation after the sum.
//
// Replaces the TPU kernel magnet_tpu/kernels/resstream_pallas.py
// (resblock_stream), the path for maps too large for the whole-map chains
// (the KITTI shape: 176x608 and 88x304). The TPU version streams row tiles
// down the map with a 2d-row input ring and a 2d-row mid ring carried across
// sequential grid steps, channels lane-padded to 128. GPU blocks run in no
// order, so nothing carries over: a block computes conv1 on the mid tile
// around its output patch (the halo recomputed by the neighbours), keeps mid
// in shared memory and runs conv2 from there. Mid never reaches device
// memory: one read of x and one write of out per pixel, which is what sets
// this kernel apart from two launches of the F-Net conv (psm_conv.cu).
// Mid positions outside the image are stored as zero, as conv2's zero
// padding needs (relu(bn1(conv1)) of zero-padded x would be relu(shift)
// there).
//
// Bound on an H100: tensor-core operations (K = 9 C per value, C = 32-128),
// plus the halo recompute. The first (WMMA) version gathered every tap from
// device memory and ran conv1 as 2 GEMM passes of 128 rows over the mid
// tile (2.0 conv1 rows per output pixel), at 6 % of the bf16 peak. The bf16
// kernel runs on hopper_conv.cuh: persistent blocks of 8 x PW output pixels
// (PW = 64, 32, 16 at C = 32, 64, 128; 32, 16, 16 at d = 2) with a producer
// warp, three halo warps and two consumer warpgroups, shapes that decide
// the wgmma sequence as template parameters, unconditional waits.
//   * The input halo, (8 + 4d) x (PW + 4d) pixels, is staged once per K
//     block (hopper_conv.cuh::stage_halos at dilation 2d).
//   * conv1 runs in the halo's own flat row order: mid pixel (r, c) is halo
//     row r hw + c (hw = PW + 4d) and reads tap (ky, kx) at row r hw + c +
//     d (ky hw + kx), so an m64 tile is 64 consecutive halo rows and each
//     tap one descriptor window (a window may start at any row). The rows
//     at c >= PW + 2d are computed and dropped. conv1 rows per output pixel:
//     1.5 at C = 32 and 64 (d = 1), 2.0 at C = 128 (d = 1), 3.0 at C = 128
//     (d = 2); chosen over 8 x 8 tiles of the mid tile (3.0 at 8 x 16, d =
//     1). A tile's window reads past the staged rows into the next buffer;
//     only dropped rows read there.
//   * conv1's epilogue writes BN1 + ReLU (zero outside the image) as bf16
//     straight into the mid tile, one buffer per K block in the swizzled
//     layout that conv2's windows read (64-byte swizzle at C = 32): conv2 is
//     the conv of hopper_conv.cuh on a halo that was never staged from
//     device memory. At C = 128 and d = 2 conv1 runs in two rounds of 64
//     output channels (96 accumulators a thread), each streaming half of
//     every weight slab; at d = 1 in one of 128 (two m64n128 tiles a
//     warpgroup, 128 accumulators), 15 % faster (profile_psm_conv's
//     c128_n64 variant).
//   * The residual is loaded from device memory into registers under
//     conv2's products; the output is staged in the mid tile once both
//     warpgroups are done reading it.
//   * Weights stay resident at C = 32 (36 KB for both convs) and stream
//     through a ring of 4-8 slabs otherwise (kernels/psm_blocks.py::
//     pack_weights, kept on the module).
//   * The copy warpgroup (producer and halo warps) gives registers to the
//     consumers (setmaxnreg: 56 and 224 a thread); at the launch's 168
//     every instance spilled.
// Shared memory per (C, d) instance: two halo stages, the mid tile, the
// weights, up to 227 KB.
// f32 keeps the FMA implicit GEMM of gather.cuh (GatherLoader, SmemLoader,
// SimtCore), which equals a full-precision reference (no TF32).

#include "gather.cuh"
#include "hopper_conv.cuh"

namespace mt {

constexpr int RB_TH = 8, RB_TW = 16;      // output tile: 128 GEMM rows

template <typename T, class Core, int BN>
__global__ void __launch_bounds__(THREADS)
res_block_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ s1,
                 const float* __restrict__ t1, const T* __restrict__ w2,
                 const float* __restrict__ s2, const float* __restrict__ t2,
                 T* __restrict__ out, int H, int W, int C, int dil) {
  using L1 = GatherLoader<T, 128, BN>;
  using L2 = SmemLoader<T, 128, BN>;
  static_assert(L1::SMEM >= THREADS / 32 * 256 * (int)sizeof(float), "scratch");
  extern __shared__ __align__(128) unsigned char rb_smem[];
  T* stages = reinterpret_cast<T*>(rb_smem);
  T* mid = reinterpret_cast<T*>(rb_smem + L1::SMEM);
  const int ldm = C + TileCfg<T>::PAD;
  const int mh = RB_TH + 2 * dil, mw = RB_TW + 2 * dil, nmid = mh * mw;

  const int tiles_w = (W + RB_TW - 1) / RB_TW, tiles_h = (H + RB_TH - 1) / RB_TH;
  const int n = blockIdx.x / (tiles_h * tiles_w);
  const int t = blockIdx.x - n * tiles_h * tiles_w;
  const int y0 = (t / tiles_w) * RB_TH, x0 = (t % tiles_w) * RB_TW;

  // mid = relu(bn1(conv1(x))) on the mid tile, zero outside the image
  const GatherArgs ga{x, w1, H, W, C, C, C, dil};
  for (int r0 = 0; r0 < nmid; r0 += 128) {
    for (int n0 = 0; n0 < C; n0 += BN) {
      L1 ld(ga, n0, [&](int row, int& pn, int& py, int& px) {
        const int r = r0 + row;
        pn = n;
        py = y0 - dil + r / mw;
        px = x0 - dil + r % mw;
        return r < nmid;
      });
      Core core;
      run_mainloop(core, ld, stages);
      core.epilogue(reinterpret_cast<float*>(rb_smem),
                    [&](int row, int col, const float* v, int cnt) {
                      const int r = r0 + row;
                      if (r >= nmid) return;
                      const int gy = y0 - dil + r / mw, gx = x0 - dil + r % mw;
                      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
                      for (int e = 0; e < cnt; ++e) {
                        const int c = n0 + col + e;
                        if (c >= C) break;
                        const float y = in ? fmaxf(v[e] * s1[c] + t1[c], 0.f) : 0.f;
                        mid[r * ldm + c] = from_f<T>(y);
                      }
                    });
      __syncthreads();
    }
  }

  // out = bn2(conv2(mid)) + x on the output tile
  for (int n0 = 0; n0 < C; n0 += BN) {
    L2 ld(mid, ldm, mw, RB_TW, w2, C, dil, n0);
    Core core;
    run_mainloop(core, ld, stages);
    core.epilogue(reinterpret_cast<float*>(rb_smem),
                  [&](int row, int col, const float* v, int cnt) {
                    const int gy = y0 + row / RB_TW, gx = x0 + row % RB_TW;
                    if (gy >= H || gx >= W) return;
                    const size_t at = (((size_t)n * H + gy) * W + gx) * C;
                    for (int e = 0; e < cnt; ++e) {
                      const int c = n0 + col + e;
                      if (c >= C) break;
                      out[at + c] = from_f<T>(v[e] * s2[c] + t2[c] + to_f(x[at + c]));
                    }
                  });
    __syncthreads();
  }
}

template <typename T, class Core, int BN>
int launch_res_block(const void* x, const void* w1, const float* s1, const float* t1,
                     const void* w2, const float* s2, const float* t2, void* out, int N,
                     int H, int W, int C, int dil, cudaStream_t s) {
  using L1 = GatherLoader<T, 128, BN>;
  const int mh = RB_TH + 2 * dil, mw = RB_TW + 2 * dil;
  const size_t smem = (size_t)L1::SMEM
                      + (size_t)mh * mw * (C + TileCfg<T>::PAD) * sizeof(T);
  auto kernel = res_block_kernel<T, Core, BN>;
  // raised once per instantiation, before any graph capture replays it
  static size_t allowed = 0;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const int tiles = ((H + RB_TH - 1) / RB_TH) * ((W + RB_TW - 1) / RB_TW);
  kernel<<<(unsigned)(N * tiles), THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), s1, t1,
      static_cast<const T*>(w2), s2, t2, static_cast<T*>(out), H, W, C, dil);
  return (int)cudaGetLastError();
}


// ---- bf16: hopper_conv.cuh, conv1 in the halo's flat row order ------------

// The ablations of profile_psm_conv.py switch one conv's products off here.
constexpr bool CONV1_MMA = true, CONV2_MMA = true;

// The shapes of one (C, d) instance: BN output channels (wgmma N) in K
// blocks of KB; MT2 m64 tiles a warpgroup in conv2 (patch 8 x 16 MT2); conv1
// in NR1 rounds of BN1 output channels over MT1 tiles a warpgroup.
template <int BN_, int KB_, int MT2_, int NR1_, int D_>
struct RbShape {
  static constexpr int BN = BN_, KB = KB_, MT2 = MT2_, NR1 = NR1_, D = D_;
  static constexpr int NKB = BN / KB, RB = 2 * KB, PW = 16 * MT2;
  static constexpr int HW = PW + 4 * D;            // input halo row
  static constexpr int MH = 8 + 2 * D, MW = PW + 2 * D;  // mid tile
  static constexpr int FLAT = (MH - 1) * HW + MW;  // conv1 rows in halo order
  static constexpr int MT1 = ((FLAT + 63) / 64 + 1) / 2;
  static constexpr int BN1 = BN / NR1;
  static constexpr bool RES = BN == 32;             // both convs' slabs resident
  static constexpr int N1 = 9 * NKB;                // slabs of one conv
  static constexpr int LD = (BN + 8) * 2;           // output staging row bytes
  static constexpr int MID = (MH * MW * RB + 1023) / 1024 * 1024;  // a K block of mid
  static_assert(BN1 * NR1 == BN && (!RES || NR1 == 1), "rounds");
  static_assert(2 * MT2 * 64 * LD <= NKB * MID, "the output staging fits in the mid tile");
};

struct HxBlockArgs {
  const bf16* x;    // (N, H, W, C)
  const bf16* w1;   // packed (NKB, 9, BN, KB) (psm_blocks.py::pack_weights)
  const bf16* w2;
  const float *s1, *t1, *s2, *t2;
  bf16* out;        // (N, H, W, C)
  int C;
  int off_mid, off_trash;
};

// The weight producer's thread. Per patch: conv1's NR1 rounds of (K block,
// tap) slabs, BN1 rows of each (round r: rows r BN1 ..), then conv2's whole
// slabs; resident (RES): conv1's and conv2's slabs once.
template <class S>
__device__ __forceinline__ void stream_block_weights(const hx::Geom& g, unsigned char* smem,
                                                     const hx::Bars& b, const HxBlockArgs& a) {
  auto src = [&](int i) -> const bf16* {
    if (i < S::NR1 * S::N1)
      return a.w1 + ((size_t)(i % S::N1) * S::BN + i / S::N1 * S::BN1) * S::KB;
    return a.w2 + (size_t)(i - S::NR1 * S::N1) * S::BN * S::KB;
  };
  if (S::RES) {
    hp::mbar_arrive_expect_tx(&b.wfull[0], (uint32_t)(2 * S::N1 * g.wstage));
    for (int i = 0; i < 2 * S::N1; ++i)
      hp::bulk_g2s(smem + g.off_w + i * g.wstage, src(i), g.wstage, &b.wfull[0]);
    return;
  }
  int it = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x)
    for (int i = 0; i < (S::NR1 + 1) * S::N1; ++i, ++it) {
      const int s = it % g.stages;
      const uint32_t bytes = (i < S::NR1 * S::N1 ? S::BN1 : S::BN) * S::KB * 2;
      if (it >= g.stages) hp::mbar_wait(&b.wempty[s], (it / g.stages - 1) & 1);
      hp::mbar_arrive_expect_tx(&b.wfull[s], bytes);
      hp::bulk_g2s(smem + g.off_w + s * g.wstage, src(i), bytes, &b.wfull[s]);
    }
}

template <class S>
__global__ void __launch_bounds__(hx::THREADS, 1)
    res_block_hopper(const hx::Geom g, const HxBlockArgs a) {
  constexpr int BN = S::BN, KB = S::KB, RB = S::RB, D = S::D, NKB = S::NKB;
  constexpr int MT1 = S::MT1, MT2 = S::MT2, BN1 = S::BN1;
  extern __shared__ __align__(1024) unsigned char smem_dyn[];
  hx::Bars b;
  // s1, t1, s2, t2 of every output channel at BN apart, zero past C
  unsigned char* smem = hx::setup(g, smem_dyn, b, [&](int i) {
    const int q = i / BN, n = i % BN;
    const float* v = q == 0 ? a.s1 : q == 1 ? a.t1 : q == 2 ? a.s2 : a.t2;
    return n < a.C ? v[n] : 0.f;
  });
  const int tid = threadIdx.x;
  // the copy warpgroup (producer and halo warps) keeps 56 registers a
  // thread and the consumers take 224: 168 each, the launch's, spill
  if (tid >= hx::CONSUMERS) {
    hp::reg_release<56>();
    if (tid >= hx::CONSUMERS + 32)
      hx::stage_halos(g, a.x, smem, b, tid - hx::CONSUMERS - 32);
    else if (tid == hx::CONSUMERS)
      stream_block_weights<S>(g, smem, b, a);
    return;
  }
  hp::reg_claim<224>();
  const int wg = tid / 128, wt = tid % 128;
  const float* pars = reinterpret_cast<const float*>(smem + g.off_par);
  unsigned char* mid = smem + a.off_mid;
  unsigned char* trash = smem + a.off_trash;
  unsigned char* stg = mid + wg * (MT2 * 64 * S::LD);  // once conv2 is done
  hx::Consumer cs(g, smem, b, (tid & 31) == 0);
  if (S::RES) hp::mbar_wait(&b.wfull[0], 0);
  float acc1[MT1][BN1 / 2];
  float acc2[MT2][BN / 2];
  uint32_t res[MT2][BN / 8][2];
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const hx::Patch p = hx::patch(g, t);
    // the patch's input halo: one stage per K block
    const int h0 = cs.hseq;
#pragma unroll
    for (int kb = 0; kb < NKB; ++kb)
      hp::mbar_wait(&b.hfull[(h0 + kb) % hx::HALOS], ((h0 + kb) / hx::HALOS) & 1);
    cs.hseq += NKB;
#pragma unroll
    for (int r = 0; r < S::NR1; ++r) {
      // conv1, output channels [r BN1, r BN1 + BN1), on tiles MT1 wg ..
      hx::conv_windows<BN1, MT1, KB, NKB, S::RES, CONV1_MMA>(
          cs, acc1, 0, 8 * RB, [&](int kb, int tap, int m) {
            return smem + ((h0 + kb) % hx::HALOS) * g.halo_bytes +
                   (64 * (MT1 * wg + m) + D * (tap / 3 * S::HW + tap % 3)) * RB;
          });
      if (r == S::NR1 - 1)
#pragma unroll
        for (int kb = 0; kb < NKB; ++kb) cs.release(-1, (h0 + kb) % hx::HALOS);
      // both warpgroups are done with the last patch's staging tiles
      if (r == 0) hp::bar_sync(3, 2 * 128);
      // relu(bn1) into the mid tile, zero outside the image; rows past the
      // mid tile go to the trash (every thread stores every result)
#pragma unroll
      for (int m = 0; m < MT1; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 64 * (MT1 * wg + m) + hp::frag_row(wt, 2 * h);
          const int rr = f / S::HW, cc = f - rr * S::HW;
          const bool keep = rr < S::MH && cc < S::MW;
          const int gy = p.y0 - D + rr, gx = p.x0 - D + cc;
          const bool in = keep && gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
          const int row = rr * S::MW + cc;
#pragma unroll
          for (int j = 0; j < BN1 / 8; ++j) {
            const int n = r * BN1 + 8 * j + 2 * (wt % 4);
            const float v0 = fmaxf(acc1[m][4 * j + 2 * h] * pars[n] + pars[BN + n], 0.f);
            const float v1 = fmaxf(acc1[m][4 * j + 2 * h + 1] * pars[n + 1] + pars[BN + n + 1], 0.f);
            unsigned char* dst = keep ? mid + n / KB * S::MID +
                                            hp::swizzled(row, n % KB / 8, RB) + n % 8 * 2
                                      : trash;
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(in ? v0 : 0.f, in ? v1 : 0.f);
          }
        }
    }
    hp::fence_proxy_async();
    hp::bar_sync(3, 2 * 128);  // the mid tile is complete
    // the residual, loaded under conv2's products; row i of tile m is
    // output pixel (i / 8, 8 (MT2 wg + m) + i % 8) of the patch
#pragma unroll
    for (int m = 0; m < MT2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = hp::frag_row(wt, 2 * h);
        const int y = p.y0 + i / 8, x = p.x0 + 8 * (MT2 * wg + m) + i % 8;
        const bool in = y < g.H && x < g.W;
        const size_t at = (((size_t)p.img * g.H + y) * g.W + x) * a.C;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = 8 * j + 2 * (wt % 4);
          res[m][j][h] = *reinterpret_cast<const uint32_t*>(a.x + (in && n < a.C ? at + n : 0));
        }
      }
    // conv2 on the mid tile: tap (ky, kx) of tile m is the window at mid
    // row d (ky MW + kx) + 8 (MT2 wg + m), rows of 8 pixels MW apart
    hx::conv_windows<BN, MT2, KB, NKB, S::RES, CONV2_MMA>(
        cs, acc2, S::N1, S::MW * RB, [&](int kb, int tap, int m) {
          return mid + kb * S::MID +
                 (D * (tap / 3 * S::MW + tap % 3) + 8 * (MT2 * wg + m)) * RB;
        });
    hp::bar_sync(3, 2 * 128);  // both warpgroups are done reading the mid tile
    // bn2 + x, rounded once, into the staging tile, then 16-byte rows out
#pragma unroll
    for (int m = 0; m < MT2; ++m)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 8 * j + 2 * (wt % 4);
          const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[m][j][h]));
          const float v0 = acc2[m][4 * j + 2 * h] * pars[2 * BN + n] + pars[3 * BN + n] + x2.x;
          const float v1 =
              acc2[m][4 * j + 2 * h + 1] * pars[2 * BN + n + 1] + pars[3 * BN + n + 1] + x2.y;
          hx::stage_pair(stg, S::LD, m, wt, j, h, v0, v1);
        }
    hp::bar_sync(1 + wg, 128);
    constexpr int CPR = BN / 8;  // 16-byte chunks of a staging row
    for (int e = wt; e < MT2 * 64 * CPR; e += 128) {
      const int px = e / CPR, q = px % 64, n = 8 * (e % CPR);
      const int y = p.y0 + q / 8, x = p.x0 + 8 * (MT2 * wg + px / 64) + q % 8;
      if (y >= g.H || x >= g.W || n >= a.C) continue;
      *reinterpret_cast<uint4*>(a.out + (((size_t)p.img * g.H + y) * g.W + x) * a.C + n) =
          *reinterpret_cast<const uint4*>(stg + px * S::LD + 2 * n);
    }
  }
}

// Lays out shared memory for instance S and launches: the two halo stages,
// the mid tile (a buffer per K block; later the output staging), the
// weights (resident, or a ring of up to 8 whole slabs), the row table, the
// folded BN, the trash, the barriers.
template <class S>
int launch_block(int N, int H, int W, HxBlockArgs a, cudaStream_t s) {
  hx::Geom g = hx::make_geom(N, H, W, a.C, 1, 2 * S::D, 9, S::KB, S::MT2, 1);
  g.wstage = S::BN * S::KB * 2;
  g.npar = 4 * S::BN;
  a.off_mid = hx::HALOS * g.halo_bytes;
  g.off_w = a.off_mid + S::NKB * S::MID;
  const int rest = (g.rows * 4 + 15) / 16 * 16 + g.npar * 4 + 16 +
                   2 * (hx::STAGES + hx::HALOS) * 8 + 1024;
  int slabs = 2 * S::N1;
  g.resident = S::RES;
  if (!S::RES) {
    slabs = (hx::SMEM_MAX - g.off_w - rest) / g.wstage;
    slabs = slabs > hx::STAGES ? hx::STAGES : slabs;
    if (slabs < 2) return (int)cudaErrorInvalidValue;
  }
  g.stages = slabs;
  g.off_tab = g.off_w + slabs * g.wstage;
  g.off_par = g.off_tab + (g.rows * 4 + 15) / 16 * 16;
  a.off_trash = g.off_par + g.npar * 4;
  g.off_bar = a.off_trash + 16;
  g.smem = g.off_bar + 2 * (hx::STAGES + hx::HALOS) * 8 + 1024;
  if (g.smem > hx::SMEM_MAX) return (int)cudaErrorInvalidValue;
  return hx::launch(res_block_hopper<S>, g, s, g, a);
}

int launch_block_hopper(int N, int H, int W, int dil, const HxBlockArgs& a, cudaStream_t s) {
  if (a.C <= 32)
    return dil == 1 ? launch_block<RbShape<32, 32, 4, 1, 1>>(N, H, W, a, s)
                    : launch_block<RbShape<32, 32, 2, 1, 2>>(N, H, W, a, s);
  if (a.C <= 64)
    return dil == 1 ? launch_block<RbShape<64, 64, 2, 1, 1>>(N, H, W, a, s)
                    : launch_block<RbShape<64, 64, 1, 1, 2>>(N, H, W, a, s);
  return dil == 1 ? launch_block<RbShape<128, 64, 1, 1, 1>>(N, H, W, a, s)
                  : launch_block<RbShape<128, 64, 1, 2, 2>>(N, H, W, a, s);
}

}  // namespace mt

// dtype: 0 f32, 1 bf16. x, out: (N, H, W, C); s*, t*: (C,) f32 folded BN;
// C a multiple of 16 bytes, at most 128 (the mid tile must fit in shared
// memory). f32: w1, w2 (3, 3, C, C) HWIO, any dilation; bf16: w1, w2 packed
// (psm_blocks.py::pack_weights), dilation 1 or 2. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int mt_res_block(int dtype, const void* x, const void* w1, const void* s1,
                            const void* t1, const void* w2, const void* s2, const void* t2,
                            void* out, int N, int H, int W, int C, int dil, void* stream) {
  using namespace mt;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C > 128) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (dil != 1 && dil != 2) return (int)cudaErrorInvalidValue;
    const HxBlockArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                        static_cast<const bf16*>(w2), f(s1), f(t1), f(s2), f(t2),
                        static_cast<bf16*>(out), C, 0, 0};
    return launch_block_hopper(N, H, W, dil, a, s);
  }
  if (C <= 64)
    return launch_res_block<float, SimtCore<128, 64>, 64>(
        x, w1, f(s1), f(t1), w2, f(s2), f(t2), out, N, H, W, C, dil, s);
  return launch_res_block<float, SimtCore<128, 128>, 128>(
      x, w1, f(s1), f(t1), w2, f(s2), f(t2), out, N, H, W, C, dil, s);
}
