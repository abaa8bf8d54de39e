// SAME 3x3 conv over [x | skip] + per-channel scale/shift + optional
// activation, NHWC, one launch per conv.
//
// Replaces the TPU kernels magnet_tpu/kernels/convstream_pallas.py
// (conv3x3_stream / up2_fused, decoder stage up2) and
// magnet_tpu/kernels/upstage_pallas.py (upstage_fused, decoder stage up3).
// The TPU versions stream row bands through VMEM rings, lane-pad the skip
// to 128 and split the output channels to fit 16 MB of VMEM; none of that
// carries over. Here x and skip are two K ranges of one GEMM, consumed one
// after the other, so the channel concat is never built and the skip is not
// padded; in upsample mode x is the half-resolution map and each
// align_corners bilinear value is formed on the way into shared memory, so
// the upsampled map never reaches device memory; the epilogue applies
// y = acc * scale + shift (eval BatchNorm with the conv bias folded into the
// shift) and LeakyReLU(0.01).
//
// Bound on an H100: tensor-core operations. At the ScanNet eval shape
// (480x640 input) up2's conv_a is M = 4800 pixels a frame, N = 512,
// K = 9 * 1088 (48 GFLOP) against 10 MB of operands, far above the card's
// ~295 FLOP/byte ridge. What held the first (WMMA) version at 7-10 % of the
// bf16 peak, and what the bf16 kernel below does about it:
//   * mma.sync cannot reach the tensor cores' rate on Hopper: two consumer
//     warpgroups issue wgmma (m64n128k16, f32 accumulators in registers) on
//     operands in shared memory in the 128-byte swizzle layout, and do
//     nothing else until the epilogue;
//   * im2col gathers read every input pixel 9 times and, in upsample mode,
//     formed every bilinear value 9 times: a block owns a patch of output
//     pixels (8x8 for 256 output channels or 16x16 for 128), and for each
//     64-channel block of the K range halo warps stage the patch's halo
//     once, zero outside the image (the SAME padding). The nine taps read
//     it as the same descriptor at nine start rows. Skip and conv_b blocks
//     are cp.async copies whose sources and places each halo thread keeps
//     for the whole block; in upsample mode the halo warps copy the
//     half-resolution window of x into a source tile (the next block's
//     while they form this one's) and lerp each halo value once from it;
//   * a shallow synchronous K loop (registers -> shared, one barrier per
//     32-wide step): the weights are packed once on the host
//     (kernels/conv3x3_bnact.py::pack_weights) in the swizzled layout, and a
//     producer warp streams one (tap, 64 channels, all the block's outputs)
//     slab a step with the bulk-copy engine into a ring of 4 stages; the
//     halos have a ring of 2, so the halo warps stage block kb + 1 while the
//     tensor cores run block kb's nine taps. Full/empty mbarriers guard
//     both rings;
//   * a scalar epilogue: scale, shift and the activation are applied to the
//     accumulator registers, rounded to bf16, staged in shared memory and
//     written as 16-byte stores;
//   * a grid of 1.15 waves at batch 1: the patch is chosen per call.
//     Upsample mode, bound by its halo building, takes the 8x8 patch: seven
//     halo warps (16 warps in all; the 16x16 patch's 128 accumulators a
//     thread leave the registers for three) and each halo value formed once
//     for 256 output channels. Without it, the patch that fills the card's
//     SMs in fewer waves.
// f32 keeps the FMA implicit GEMM of common.cuh (SimtCore), which equals a
// full-precision reference (no TF32).

#include "common.cuh"
#include "hopper.cuh"

namespace mt {

// ---- f32: the implicit GEMM of common.cuh ----------------------------------

template <typename T, class Core>
__global__ void __launch_bounds__(THREADS)
conv3x3_bnact_kernel(ConvArgs a, const float* __restrict__ scale,
                     const float* __restrict__ shift, T* __restrict__ out, int act) {
  constexpr int BM = 128, BN = 128;
  using L = TileLoader<T, BM, BN>;
  static_assert(L::SMEM >= THREADS / 32 * 256 * (int)sizeof(float), "scratch");
  __shared__ __align__(128) unsigned char smem_raw[L::SMEM];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = a.N * a.H * a.W;
  L ld(a, m0, n0);
  Core core;
  run_mainloop(core, ld, reinterpret_cast<T*>(smem_raw));

  // The K loop ended on a barrier: its stages are free for the scratch.
  core.epilogue(reinterpret_cast<float*>(smem_raw),
                [&](int row, int col, const float* v, int cnt) {
                  const int m = m0 + row, n = n0 + col;
                  if (m >= M || n >= a.Cout) return;
                  T* dst = out + (size_t)m * a.Cout + n;
                  for (int e = 0; e < cnt; ++e)
                    dst[e] = from_f<T>(activate(v[e] * scale[n + e] + shift[n + e], act));
                });
}

// ---- bf16: halo tiles, wgmma, a bulk-copy weight ring ------------------------

constexpr int KC = 64;                      // input channels per K block
constexpr int BNH = 128;                    // output channels a warpgroup
constexpr int CONSUMERS = 256;              // two warpgroups of wgmma

struct HopperArgs {
  const bf16* x;      // (N, Hs, Ws, Cx)
  const bf16* skip;   // (N, H, W, Cs) or null
  const bf16* wp;     // packed weights: (nxb + nsb, 9, cout_pad, 64), swizzled
  const float* scale;
  const float* shift;
  bf16* out;          // (N, H, W, Cout)
  int N, H, W, Hs, Ws, Cx, Cs, Cout, cout_pad;
  int nxb, nsb;       // 64-channel blocks of x and of skip
  int tiles_y, tiles_x, ups, act;
};

// The patch of output pixels a block owns: MT = 1, 8x8 (one M tile that
// both warpgroups multiply, each by its own 128 of the block's 256 output
// channels); MT = 2, 16x16 (warpgroup w owns rows 8w.., two M tiles side by
// side, and all of the block's 128 output channels). A halo stage holds one
// 64-channel K block of the (PH + 2) x (PW + 2) pixels around the patch:
// pixel (hy, hx) is row hy * HW + hx of 128 bytes in the 128-byte swizzle
// layout (hopper.cuh).
template <int MT>
struct HopperCfg {
  static constexpr bool NSPLIT = MT == 1;       // warpgroups split N
  static constexpr int PH = 8 * MT, PW = 8 * MT;
  static constexpr int BN = NSPLIT ? 2 * BNH : BNH;  // output channels a block
  static constexpr int HP = PH + 2, HW = PW + 2;
  // bytes of one halo stage, whole swizzle atoms so that every stage has the
  // same pattern
  static constexpr int HALO = (HP * HW * 128 + 1023) / 1024 * 1024;
  static constexpr int HALOS = 2;               // halo stages in the ring
  static constexpr int STAGES = 4;              // weight stages in the ring
  static constexpr int WSTAGE = KC * BN * 2;    // one (tap, K block) weight slab
  static constexpr int CHUNKS = HP * HW * 8;    // 16-byte chunks of a halo
  // threads that stage the halos: 7 warps where a thread holds 64
  // accumulators (16 warps' registers), 3 where it holds 128 (12 warps)
  static constexpr int HALO_THREADS = MT == 1 ? 224 : 96;
  static constexpr int THREADS = CONSUMERS + 32 + HALO_THREADS;  // + the weight producer
  static constexpr int PER_THREAD = (CHUNKS + HALO_THREADS - 1) / HALO_THREADS;
  static constexpr int ROWB = (BNH + 8) * 2;    // epilogue staging row, bytes
  static constexpr int SRC_MAX = 144;           // pixels of a staged source tile
  static constexpr int OFF_W = HALOS * HALO;
  static constexpr int OFF_SRC = OFF_W + STAGES * WSTAGE;
  static constexpr int OFF_BAR = OFF_SRC + 2 * SRC_MAX * 128;
  static constexpr int OFF_TAB = OFF_BAR + 2 * (STAGES + HALOS) * 8;
  static constexpr int SMEM = OFF_TAB + (HP + HW) * 16 + 1024;  // + alignment
  // the epilogue stages its outputs over the halo stages, or for small
  // patches over the weight stages
  static constexpr int OFF_STG = NSPLIT ? OFF_W : 0;
  static_assert(2 * MT * 64 * ROWB <= (NSPLIT ? STAGES * WSTAGE : HALOS * HALO),
                "the staged outputs fit");
  static_assert(HALO_THREADS % 32 == 0, "whole warps; a halo thread keeps its 8 channels");
  static_assert(WSTAGE % 1024 == 0, "weight slabs start at a swizzle atom");
  // M tile g's first output row and column in the patch
  __device__ static int tile_row(int g) { return 8 * (g / 2); }
  __device__ static int tile_col(int g) { return 8 * (g % 2); }
};

// The halo warps' view of a block: its source, the per-row and
// per-column tables, and in upsample mode the window of x that the halo's
// bilinear taps read.
template <int MT>
struct HaloBuild {
  using C = HopperCfg<MT>;
  const HopperArgs& a;
  unsigned char* smem;
  const int4* tab_y;
  const int4* tab_x;
  int img;
  int sy0, sx0, srows, scols;  // the source window (upsample mode)
  bool tile;                   // the window fits a source tile

  __device__ HaloBuild(const HopperArgs& a_, unsigned char* smem_, const int4* ty,
                       const int4* tx, int img_)
      : a(a_), smem(smem_), tab_y(ty), tab_x(tx), img(img_) {
    // valid rows and columns are contiguous and their taps non-decreasing
    int f = 0, l = C::HP - 1;
    while (tab_y[f].w < 0) ++f;
    while (tab_y[l].w < 0) --l;
    sy0 = tab_y[f].x;
    srows = tab_y[l].y - sy0 + 1;
    f = 0;
    l = C::HW - 1;
    while (tab_x[f].w < 0) ++f;
    while (tab_x[l].w < 0) --l;
    sx0 = tab_x[f].x;
    scols = tab_x[l].y - sx0 + 1;
    tile = a.ups && srows * scols <= C::SRC_MAX;
  }

  // The byte offset in a halo stage of chunk e: channels [8 (e % 8), +8)
  // of the K block at halo pixel e / 8 (rows of 128 bytes; a stage starts
  // at a multiple of 1024 bytes, so row r's chunks are swizzled by r % 8).
  __device__ static int place(int e, int& hy, int& hx) {
    const int q = e >> 3, p = e & 7;
    hy = q / C::HW;
    hx = q - hy * C::HW;
    const int row = hy * C::HW + hx;
    return row * 128 + ((p ^ (row & 7)) << 4);
  }

  // x's K block kb over the source window into source stage s, one cp.async
  // group (zero past x's channels).
  __device__ void load_tile(int kb, int s, int bt) const {
    unsigned char* dst = smem + C::OFF_SRC + s * C::SRC_MAX * 128;
    const int c0 = kb * KC;
    const bf16* base = a.x + (size_t)img * a.Hs * a.Ws * a.Cx + c0;
    for (int e = bt; e < srows * scols * 8; e += C::HALO_THREADS) {
      const int i = e >> 3, p = e & 7;
      const int ly = i / scols, lx = i - ly * scols;
      const bool v = c0 + p * 8 < a.Cx;
      hp::cp_async16(dst + e * 16,
                     v ? base + ((size_t)(sy0 + ly) * a.Ws + sx0 + lx) * a.Cx + p * 8 : a.x, v);
    }
    hp::cp_async_commit();
  }

  // The align_corners lerp of common.cuh's TileLoader over four 8-channel
  // taps, rounded to bf16.
  __device__ static uint4 lerp(const uint4* r, float fx, float fy) {
    float f00[8], f01[8], f10[8], f11[8], o[8];
    unpack(r[0], f00, bf16());
    unpack(r[1], f01, bf16());
    unpack(r[2], f10, bf16());
    unpack(r[3], f11, bf16());
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float top = f00[i] * (1.f - fx) + f01[i] * fx;
      float bot = f10[i] * (1.f - fx) + f11[i] * fx;
      o[i] = top * (1.f - fy) + bot * fy;
    }
    return pack(o, bf16());
  }

  // Upsample mode from source stage s: each halo value from four taps in
  // shared memory.
  __device__ void from_tile(unsigned char* halo, int kb, int s, int bt) const {
    const unsigned char* src = smem + C::OFF_SRC + s * C::SRC_MAX * 128 + (bt & 7) * 16;
    const bool cvalid = kb * KC + (bt & 7) * 8 < a.Cx;
    for (int e = bt; e < C::CHUNKS; e += C::HALO_THREADS) {
      int hy, hx;
      unsigned char* dst = halo + place(e, hy, hx);
      const int4 ty = tab_y[hy], tx = tab_x[hx];
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ty.w >= 0 && tx.w >= 0 && cvalid) {
        const int r0 = (ty.x - sy0) * scols, r1 = (ty.y - sy0) * scols;
        const int c0 = tx.x - sx0, c1 = tx.y - sx0;
        uint4 r[4];
        r[0] = *reinterpret_cast<const uint4*>(src + (r0 + c0) * 128);
        r[1] = *reinterpret_cast<const uint4*>(src + (r0 + c1) * 128);
        r[2] = *reinterpret_cast<const uint4*>(src + (r1 + c0) * 128);
        r[3] = *reinterpret_cast<const uint4*>(src + (r1 + c1) * 128);
        v = lerp(r, __int_as_float(tx.z), __int_as_float(ty.z));
      }
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }

  // Halo thread bt's chunks e = bt + HALO_THREADS j: all at the same 8 channels
  // (HALO_THREADS is a multiple of 8) of the K block, so that what a chunk reads
  // and where it goes is the same for every block: the image pixel (-1
  // outside the image) and the byte offset in a halo stage (-1: no chunk).
  struct Chunks {
    int pix[C::PER_THREAD];
    int off[C::PER_THREAD];
  };

  __device__ Chunks chunks(int bt) const {
    Chunks k;
#pragma unroll
    for (int j = 0; j < C::PER_THREAD; ++j) {
      const int e = bt + C::HALO_THREADS * j;
      int hy = 0, hx = 0;
      k.off[j] = e < C::CHUNKS ? place(e, hy, hx) : -1;
      const int4 ty = tab_y[hy], tx = tab_x[hx];
      k.pix[j] = ty.w >= 0 && tx.w >= 0 ? ty.w * a.W + tx.w : -1;
    }
    return k;
  }

  // A K block of x (not upsampled) or of the skip: cp.async, zero outside
  // the image and past the source's channels.
  __device__ void copy(const Chunks& k, unsigned char* halo, int kb, int bt) const {
    const bool is_x = kb < a.nxb;
    const int cch = is_x ? a.Cx : a.Cs;
    const int c = (is_x ? kb : kb - a.nxb) * KC + (bt & 7) * 8;
    const bf16* base = (is_x ? a.x : a.skip) + (size_t)img * a.H * a.W * cch + c;
#pragma unroll
    for (int j = 0; j < C::PER_THREAD; ++j) {
      const bool v = k.pix[j] >= 0 && c < cch;
      if (k.off[j] >= 0)
        hp::cp_async16(halo + k.off[j], v ? base + (size_t)k.pix[j] * cch : a.x, v);
    }
  }

  // Upsample mode where the source window is too large for a tile: four
  // loads from device memory per value, two chunks' loads issued before
  // either is stored.
  __device__ void from_global(unsigned char* halo, int kb, int bt) const {
    constexpr int U = 2;
    const int c = kb * KC + (bt & 7) * 8;
    const bf16* base = a.x + (size_t)img * a.Hs * a.Ws * a.Cx + c;
    for (int e0 = bt; e0 < C::CHUNKS; e0 += U * C::HALO_THREADS) {
      uint4 raw[U][4];
      float fx[U], fy[U];
      bool valid[U];
      unsigned char* dst[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * C::HALO_THREADS;
        valid[u] = false;
        dst[u] = nullptr;
        if (e >= C::CHUNKS) continue;
        int hy, hx;
        dst[u] = halo + place(e, hy, hx);
        const int4 ty = tab_y[hy], tx = tab_x[hx];
        valid[u] = ty.w >= 0 && tx.w >= 0 && c < a.Cx;
        if (valid[u]) {
          raw[u][0] = ldg16(base + ((size_t)ty.x * a.Ws + tx.x) * a.Cx);
          raw[u][1] = ldg16(base + ((size_t)ty.x * a.Ws + tx.y) * a.Cx);
          raw[u][2] = ldg16(base + ((size_t)ty.y * a.Ws + tx.x) * a.Cx);
          raw[u][3] = ldg16(base + ((size_t)ty.y * a.Ws + tx.y) * a.Cx);
          fx[u] = __int_as_float(tx.z);
          fy[u] = __int_as_float(ty.z);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (dst[u] != nullptr)
          *reinterpret_cast<uint4*>(dst[u]) =
              valid[u] ? lerp(raw[u], fx[u], fy[u]) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// Warps 0-7 (two warpgroups) run wgmma and the epilogue; warp 8 streams the
// weights; the warps after it (HALO_THREADS threads) build the halos. Two rings
// connect them: STAGES weight slabs (full: one arrival and the bytes; empty:
// the 8 consumer warps) and HALOS halo stages (full: the halo threads;
// empty: the consumer warps).
template <int MT>
__global__ void __launch_bounds__(HopperCfg<MT>::THREADS, 1)
    conv3x3_bnact_hopper(const HopperArgs a) {
  using C = HopperCfg<MT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of the shared address
  unsigned char* smem = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  uint64_t* halo_full = empty + C::STAGES;
  uint64_t* halo_empty = halo_full + C::HALOS;
  int4* tab_y = reinterpret_cast<int4*>(smem + C::OFF_TAB);
  int4* tab_x = tab_y + C::HP;

  const int tid = threadIdx.x;
  const int tiles = a.tiles_y * a.tiles_x;
  const int img = blockIdx.x / tiles;
  const int rem = blockIdx.x - img * tiles;
  const int py0 = (rem / a.tiles_x) * C::PH, px0 = (rem % a.tiles_x) * C::PW;
  const int n0 = blockIdx.y * C::BN;
  const int nkb = a.nxb + a.nsb;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], CONSUMERS / 32);
    }
    for (int b = 0; b < C::HALOS; ++b) {
      hp::mbar_init(&halo_full[b], C::HALO_THREADS);
      hp::mbar_init(&halo_empty[b], CONSUMERS / 32);
    }
    hp::mbar_fence_init();
  }
  // Per halo row and column: the image index (-1 outside the image) and, in
  // upsample mode, its two source taps and weight.
  if (tid < C::HP + C::HW) {
    const bool is_y = tid < C::HP;
    const int h = is_y ? tid : tid - C::HP;
    const int o = (is_y ? py0 : px0) + h - 1;
    const int n_out = is_y ? a.H : a.W, n_in = is_y ? a.Hs : a.Ws;
    const bool in = o >= 0 && o < n_out;
    int i0 = 0, i1 = 0;
    float f = 0.f;
    if (in && a.ups) src_coord(o, n_out, n_in, i0, i1, f);
    (is_y ? tab_y : tab_x)[h] = make_int4(i0, i1, __float_as_int(f), in ? o : -1);
  }
  __syncthreads();

  if (tid >= CONSUMERS + 32) {
    // The halo warps: K block kb into halo stage kb % HALOS, once the
    // consumers have released what it held (K block kb - HALOS). In
    // upsample mode x's block kb + 1 is copied into a source tile while
    // block kb's halo is formed from the other one.
    const int bt = tid - CONSUMERS - 32;
    const HaloBuild<MT> hb(a, smem, tab_y, tab_x, img);
    auto publish = [&](int kb) {
      hp::fence_proxy_async();
      hp::mbar_arrive(&halo_full[kb % C::HALOS]);
    };
    auto stage = [&](int kb) {
      if (kb >= C::HALOS) hp::mbar_wait(&halo_empty[kb % C::HALOS], (kb / C::HALOS - 1) & 1);
      return smem + (kb % C::HALOS) * C::HALO;
    };
    const int nups = a.ups ? a.nxb : 0;
    if (hb.tile) hb.load_tile(0, 0, bt);
    for (int kb = 0; kb < nups; ++kb) {
      if (hb.tile) {
        hp::bar_sync(4, C::HALO_THREADS);  // all done reading the stage refilled next
        if (kb + 1 < nups) {
          hb.load_tile(kb + 1, (kb + 1) & 1, bt);
          hp::cp_async_wait<1>();
        } else {
          hp::cp_async_wait<0>();
        }
        hp::bar_sync(4, C::HALO_THREADS);  // block kb's tile has landed
        hb.from_tile(stage(kb), kb, kb & 1, bt);
      } else {
        hb.from_global(stage(kb), kb, bt);
      }
      publish(kb);
    }
    const auto chunks = hb.chunks(bt);
    for (int kb = nups; kb < nkb; ++kb) {
      hb.copy(chunks, stage(kb), kb, bt);
      hp::cp_async_wait_all();
      publish(kb);
    }
    return;
  }
  if (tid >= CONSUMERS) {
    // The weight producer: one thread keeps STAGES slabs in flight.
    if (tid == CONSUMERS) {
      const int total = nkb * 9;
      for (int it = 0; it < total; ++it) {
        const int s = it % C::STAGES;
        if (it >= C::STAGES) hp::mbar_wait(&empty[s], (it / C::STAGES - 1) & 1);
        hp::mbar_arrive_expect_tx(&full[s], C::WSTAGE);
        hp::bulk_g2s(smem + C::OFF_W + s * C::WSTAGE,
                     a.wp + ((size_t)it * a.cout_pad + n0) * KC, C::WSTAGE, &full[s]);
      }
    }
    return;
  }

  // ---- consumers -------------------------------------------------------------
  const int wg = tid / 128, wt = tid % 128;
  const bool lead = (tid & 31) == 0;
  // this warpgroup's output channels: [nw, nw + 128), row wn of a slab
  const int wn = C::NSPLIT ? wg * BNH : 0;
  const int nw = n0 + wn;
  float acc[MT][64];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[m][i] = 0.f;
      hp::fence_operand(acc[m][i]);
    }

  int it = 0;
  for (int kb = 0; kb < nkb; ++kb) {
    const unsigned char* halo = smem + (kb % C::HALOS) * C::HALO;
    hp::mbar_wait(&halo_full[kb % C::HALOS], (kb / C::HALOS) & 1);
    for (int tap = 0; tap < 9; ++tap, ++it) {
      const int s = it % C::STAGES;
      hp::mbar_wait(&full[s], (it / C::STAGES) & 1);
      const unsigned char* wst = smem + C::OFF_W + s * C::WSTAGE;
      const int dy = tap / 3, dx = tap % 3;
      hp::wgmma_fence();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int g = C::NSPLIT ? 0 : wg * MT + m;
        const unsigned char* at =
            halo + ((C::tile_row(g) + dy) * C::HW + C::tile_col(g) + dx) * 128;
#pragma unroll
        for (int k = 0; k < KC / 16; ++k)
          hp::wgmma_m64n128k16(acc[m], hp::desc_sw128(at + 32 * k, C::HW * 128),
                               hp::desc_sw128(wst + wn * 128 + 32 * k, 1024));
      }
      hp::wgmma_commit();
      if (it > 0) {
        // the previous step's products are done: release its weight slab
        // and, at a new K block, the previous halo
        hp::wgmma_wait<1>();
        if (lead) {
          hp::mbar_arrive(&empty[(it - 1) % C::STAGES]);
          if (tap == 0) hp::mbar_arrive(&halo_empty[(kb - 1) % C::HALOS]);
        }
      }
    }
  }
  hp::wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 64; ++i) hp::fence_operand(acc[m][i]);
  // Both warpgroups' products are done before either overwrites the halo
  // (or weight) stages with its staged outputs: per M tile 64 pixels x 128
  // channels.
  hp::bar_sync(1, CONSUMERS);

  unsigned char* stg = smem + C::OFF_STG + wg * MT * 64 * C::ROWB;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    unsigned char* t = stg + m * 64 * C::ROWB;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * (wt % 4);
      const int n = nw + col;
      float2 sc = make_float2(0.f, 0.f), sh = sc;
      if (n < a.Cout) {
        sc = __ldg(reinterpret_cast<const float2*>(a.scale + n));
        sh = __ldg(reinterpret_cast<const float2*>(a.shift + n));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = hp::frag_row(wt, 4 * j + 2 * h);
        const float v0 = activate(acc[m][4 * j + 2 * h] * sc.x + sh.x, a.act);
        const float v1 = activate(acc[m][4 * j + 2 * h + 1] * sc.y + sh.y, a.act);
        *reinterpret_cast<__nv_bfloat162*>(t + row * C::ROWB + col * 2) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  hp::bar_sync(2 + wg, 128);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int g = C::NSPLIT ? 0 : wg * MT + m;
    const unsigned char* t = stg + m * 64 * C::ROWB;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = wt + 128 * k;
      const int px = e / 16, ch = e % 16;
      const int y = py0 + C::tile_row(g) + px / 8, x = px0 + C::tile_col(g) + px % 8;
      const int n = nw + 8 * ch;
      if (y < a.H && x < a.W && n < a.Cout)
        *reinterpret_cast<uint4*>(a.out + (((size_t)img * a.H + y) * a.W + x) * a.Cout + n) =
            *reinterpret_cast<const uint4*>(t + px * C::ROWB + ch * 16);
    }
  }
}

template <int MT>
int launch_patches(HopperArgs a, cudaStream_t s) {
  using C = HopperCfg<MT>;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_bnact_hopper<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  a.tiles_y = (a.H + C::PH - 1) / C::PH;
  a.tiles_x = (a.W + C::PW - 1) / C::PW;
  dim3 grid((unsigned)(a.N * a.tiles_y * a.tiles_x), (unsigned)(a.cout_pad / C::BN));
  conv3x3_bnact_hopper<MT><<<grid, C::THREADS, C::SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// Blocks of patch MT over the card's SMs, one block an SM: the number of
// waves times a block's time (MT units of main loop and about a quarter of
// one for its prologue and epilogue).
template <int MT>
long long patch_cost(const HopperArgs& a, int sms) {
  using C = HopperCfg<MT>;
  const long long blocks = (long long)a.N * ((a.H + C::PH - 1) / C::PH) *
                           ((a.W + C::PW - 1) / C::PW) * (a.cout_pad / C::BN);
  return (blocks + sms - 1) / sms * (4 * MT + 1);
}

// Upsample mode is bound by building its halos, which the 8x8 patch does
// with seven halo warps (the 16x16 one has the registers for three) and
// once for 256 output channels. Without it, the patch that fills the card
// in fewer waves.
inline int choose_patch(const HopperArgs& a, int sms) {
  return !a.ups && patch_cost<2>(a, sms) < patch_cost<1>(a, sms) ? 2 : 1;
}

int launch_hopper(const HopperArgs& a, cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int p = choose_patch(a, sms);
  return p == 2 ? launch_patches<2>(a, s) : launch_patches<1>(a, s);
}

}  // namespace mt

// dtype: 0 f32, 1 bf16. f32 takes HWIO weights wx (3, 3, Cx, Cout) and ws
// (3, 3, Cs, Cout); bf16 takes the packed weights of both in wx
// (conv3x3_bnact.py::pack_weights) and ignores ws. Returns the first CUDA
// error of the launch (cudaGetLastError() after it).
extern "C" int mt_conv3x3_bnact(int dtype, const void* x, const void* skip,
                                const void* wx, const void* ws, const void* scale,
                                const void* shift, void* out, int N, int H, int W,
                                int Hs, int Ws, int Cx, int Cs, int Cout,
                                int upsample, int act, void* stream) {
  using namespace mt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (dtype == 1) {
    const int cs = skip ? Cs : 0;
    HopperArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(skip),
                 static_cast<const bf16*>(wx), sc, sh, static_cast<bf16*>(out),
                 N, H, W, Hs, Ws, Cx, cs, Cout, (Cout + 2 * BNH - 1) / (2 * BNH) * (2 * BNH),
                 (Cx + KC - 1) / KC, (cs + KC - 1) / KC, 0, 0, upsample != 0, act};
    return launch_hopper(a, s);
  }
  ConvArgs a{x, skip, wx, ws, N, H, W, Hs, Ws, Cx, skip ? Cs : 0, Cout, upsample != 0};
  const long long M = (long long)N * H * W;
  dim3 grid((unsigned)((M + 127) / 128), (unsigned)((Cout + 127) / 128));
  conv3x3_bnact_kernel<float, SimtCore<128, 128>>
      <<<grid, THREADS, 0, s>>>(a, sc, sh, static_cast<float*>(out), act);
  return (int)cudaGetLastError();
}

extern "C" const char* mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
