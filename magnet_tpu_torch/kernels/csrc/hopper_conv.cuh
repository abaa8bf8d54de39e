// A bf16 convolution on Hopper's tensor cores, shared by the F-Net conv
// kernel (psm_conv.cu), the head chain (head_chain.cu), the SPP tail
// (spp_tail.cu: its input a table of K blocks from three maps,
// stage_halos_src) and the one-launch BasicBlock (res_block.cu: its convs
// on windows it names, conv_windows): a block owns an
// 8 x 16 mt patch of output pixels at a time, stages the patch's halo once
// per K block (64 or 32 input channels) and lets every tap read it as a
// shifted wgmma descriptor window; a producer warp streams the packed
// weights with the bulk-copy engine. Blocks are persistent: each walks over
// patches gridDim.x apart, and its halo warps stage the next patch while
// the consumers multiply and store this one.
//
// Warps 0-7 (two warpgroups) run wgmma and the epilogue, warpgroup w the mt
// m64 tiles (8 x 8 output pixels, all of the block's output channels) of
// patch columns 8 mt w .. 8 mt (w + 1) - 1; warp 8 is the weight producer;
// warps 9-11 stage the halos. Two rings connect them: HALOS halo stages
// (full: the halo threads; empty: the 8 consumer warps) and the weight
// slabs, either resident (every slab of the conv loaded once, for the
// block's life) or a ring of 8 slabs, 4 where 8 do not fit (full: one
// arrival and the bytes; empty: the 8 consumer warps).
//
// What held the first (WMMA) kernels at 6.5-10 % of the bf16 peak, and what
// this one does about it (profile_psm_conv.py --ablate splits the time):
//   * every shape that decides the instruction sequence (the output width,
//     mt, the K block, resident weights) is a template parameter and every
//     wgmma wait is unconditional: where ptxas cannot resolve a wgmma's path
//     (a runtime k loop, a wait on one side of a branch, an accumulator read
//     on a divergent path) it serializes every wgmma of the kernel (C7515,
//     C7518), which cost 2-4x here;
//   * small output widths (32, 64) give a wgmma little work for its operand
//     bytes and one accumulator chain: mt = 128 / width tiles a warpgroup
//     run as independent chains, each k16 step issuing all of them;
//   * the epilogue stages its results in shared memory (every thread writes
//     all of its registers, then 16-byte rows go out), and the residual is
//     copied into the same staging tile with cp.async under the products,
//     so the consumers never wait on device memory.
//
// The halo of a K block. Each halo pixel is one row of 2 * kb bytes (the
// 128- or 64-byte swizzle layout, hopper.cuh), rows in the order
// (phase, y, x). At stride 1 there is one phase, the (8 + 2 pad) x (16 mt +
// 2 pad) input pixels around the patch (pad = the dilation of a 3x3 conv,
// 0 for a 1x1), and tap (ky, kx) of the m64 tile at patch column c0 is the
// window that starts at row (ky dil) hw + kx dil + c0, rows of 8 pixels
// hw rows apart. At stride 2 consecutive output pixels read input pixels 2
// apart, which no descriptor window can: the halo is staged as its four
// phases, space to depth in shared memory. Phase (a, b) holds the input
// pixels (2 y + a, 2 x + b) from the halo's origin, 9 x (16 mt + 1) of
// them, so that tap (ky, kx) reads phase (ky % 2, kx % 2) at offset (ky / 2,
// kx / 2), a contiguous window again. A stride-2 1x1 conv stages phase
// (0, 0) only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace mt {
namespace hx {

using bf = __nv_bfloat16;

constexpr int CONSUMERS = 256;                          // two warpgroups of wgmma
constexpr int HALO_THREADS = 96;                        // three warps
constexpr int THREADS = CONSUMERS + 32 + HALO_THREADS;  // + the weight producer
constexpr int PH = 8;                                   // rows of a block's patch
constexpr int HALOS = 2;                                // halo stages
constexpr int STAGES = 8;                               // weight stages of the ring, at most
constexpr int SMEM_MAX = 232448;                        // a block's shared memory
static_assert(HALO_THREADS % 8 == 0, "a halo thread keeps one chunk of every row");

// One conv's geometry and its shared-memory layout, set on the host
// (make_geom, then layout).
struct Geom {
  int N, H, W, Ci, Ho, Wo;
  int stride, dil, taps, pad;
  int kb, nkb;          // input channels per K block (32 or 64), K blocks
  int pw;               // patch columns: 16 mt for mt m64 tiles a warpgroup
  int nph, hp, hw;      // halo phases, each hp rows of hw pixels
  int rows;             // halo pixels: nph * hp * hw
  int halo_bytes;       // a halo stage, whole 1024-byte atoms
  int tiles_x, tiles;   // patches per image row; patches x N blocks, in all
  int nblk;             // blocks of the output channels
  int wstage;           // bytes of one weight slab (one tap, one K block)
  int resident;         // the slabs stay in shared memory
  int stages;           // else the ring's stages
  int npar;             // f32 epilogue parameters kept in shared memory
  int stg;              // bytes of a warpgroup's epilogue staging tile
  int off_w, off_tab, off_par, off_stg, off_bar, smem;
};

inline Geom make_geom(int N, int H, int W, int Ci, int stride, int dil, int taps, int kb,
                      int mt, int nblk) {
  Geom g{};
  g.pw = 16 * mt;
  const int PW = g.pw;
  g.N = N;
  g.H = H;
  g.W = W;
  g.Ci = Ci;
  g.stride = stride;
  g.dil = dil;
  g.taps = taps;
  g.pad = taps == 9 ? dil : 0;
  g.Ho = (H - 1) / stride + 1;
  g.Wo = (W - 1) / stride + 1;
  g.kb = kb;
  g.nkb = (Ci + kb - 1) / kb;
  if (stride == 1) {
    g.nph = 1;
    g.hp = PH + 2 * g.pad;
    g.hw = PW + 2 * g.pad;
  } else if (taps == 9) {
    g.nph = 4;
    g.hp = PH + 1;
    g.hw = PW + 1;
  } else {
    g.nph = 1;
    g.hp = PH;
    g.hw = PW;
  }
  g.rows = g.nph * g.hp * g.hw;
  g.halo_bytes = (g.rows * 2 * kb + 1023) / 1024 * 1024;
  g.tiles_x = (g.Wo + PW - 1) / PW;
  g.nblk = nblk;
  g.tiles = N * ((g.Ho + PH - 1) / PH) * g.tiles_x * nblk;
  return g;
}

// Lays out shared memory: the halo stages; the weights, all `nslab` slabs
// of `wstage` bytes (resident, where allow_resident and they fit) or a
// ring; the row table; `npar` floats of epilogue parameters; a staging tile
// of `stg` bytes for each consumer warpgroup; the barriers. Resident
// weights where they fit, else a ring of STAGES slabs, else STAGES / 2.
// Returns false where nothing fits.
inline bool layout(Geom& g, int nslab, int wstage, bool allow_resident, int npar, int stg) {
  g.wstage = wstage;
  g.npar = npar;
  g.stg = stg;
  auto fit = [&](int slabs) {
    g.off_w = HALOS * g.halo_bytes;
    g.off_tab = g.off_w + slabs * wstage;
    g.off_par = g.off_tab + (g.rows * 4 + 15) / 16 * 16;
    g.off_stg = g.off_par + (npar * 4 + 15) / 16 * 16;
    g.off_bar = g.off_stg + 2 * stg;
    g.smem = g.off_bar + 2 * (STAGES + HALOS) * 8 + 1024;  // + alignment
    return g.smem <= SMEM_MAX;
  };
  for (int res = allow_resident && g.nblk == 1; res >= 0; --res)
    for (int stages = STAGES; stages >= (res ? STAGES : STAGES / 2); stages /= 2)
      if (fit(res ? nslab : stages)) {
        g.resident = res;
        g.stages = stages;
        return true;
      }
  return false;
}

struct Bars {
  uint64_t* wfull;   // STAGES
  uint64_t* wempty;  // STAGES
  uint64_t* hfull;   // HALOS
  uint64_t* hempty;  // HALOS
};

// The 1024-aligned base of the dynamic shared memory (the swizzle pattern
// repeats every 1024 bytes of the address), its barriers initialised, its
// row table filled (for halo row r, the input pixel it holds as (dy << 16)
// | dx from the halo's origin) and its epilogue parameters: par(i) for i <
// g.npar. Ends on a block-wide barrier.
template <class Par>
__device__ __forceinline__ unsigned char* setup(const Geom& g, unsigned char* raw, Bars& b,
                                                Par par) {
  unsigned char* smem = raw + ((1024 - (hp::smem_addr(raw) & 1023)) & 1023);
  b.wfull = reinterpret_cast<uint64_t*>(smem + g.off_bar);
  b.wempty = b.wfull + STAGES;
  b.hfull = b.wempty + STAGES;
  b.hempty = b.hfull + HALOS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&b.wfull[s], 1);
      hp::mbar_init(&b.wempty[s], CONSUMERS / 32);
    }
    for (int s = 0; s < HALOS; ++s) {
      hp::mbar_init(&b.hfull[s], HALO_THREADS);
      hp::mbar_init(&b.hempty[s], CONSUMERS / 32);
    }
    hp::mbar_fence_init();
  }
  int* tab = reinterpret_cast<int*>(smem + g.off_tab);
  const int per_phase = g.hp * g.hw;
  for (int r = threadIdx.x; r < g.rows; r += blockDim.x) {
    const int ph = r / per_phase, q = r - ph * per_phase;
    const int ly = q / g.hw, lx = q - ly * g.hw;
    tab[r] = ((g.stride * ly + (ph >> 1)) << 16) | (g.stride * lx + (ph & 1));
  }
  float* pars = reinterpret_cast<float*>(smem + g.off_par);
  for (int i = threadIdx.x; i < g.npar; i += blockDim.x) pars[i] = par(i);
  __syncthreads();
  return smem;
}

// Work item t: its image, the output pixel at its patch's top left and its
// block of output channels (the blocks of a patch are consecutive items).
struct Patch {
  int img, y0, x0, nb;
};
__device__ __forceinline__ Patch patch(const Geom& g, int t) {
  const int nb = t % g.nblk;
  t /= g.nblk;
  const int per_img = g.tiles / g.nblk / g.N;
  const int img = t / per_img, rem = t - img * per_img;
  return Patch{img, rem / g.tiles_x * PH, rem % g.tiles_x * g.pw, nb};
}

// The halo warps: for each of the block's patches and each K block, the
// halo into stage hseq % HALOS once the consumers have released what it
// held, as cp.async copies (zero outside the image, SAME padding, and past
// the input channels). Halo thread bt copies chunk bt % (kb / 8) of every
// (HALO_THREADS / (kb / 8))-th row.
__device__ __forceinline__ void stage_halos(const Geom& g, const bf* x, unsigned char* smem,
                                            const Bars& b, int bt) {
  const int* tab = reinterpret_cast<const int*>(smem + g.off_tab);
  const int rb = 2 * g.kb, cpr = g.kb / 8;
  const int c = bt % cpr, r0 = bt / cpr, rstep = HALO_THREADS / cpr;
  int hseq = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const Patch p = patch(g, t);
    const int iy0 = p.y0 * g.stride - g.pad, ix0 = p.x0 * g.stride - g.pad;
    const bf* img = x + (size_t)p.img * g.H * g.W * g.Ci;
    for (int kb = 0; kb < g.nkb; ++kb, ++hseq) {
      const int s = hseq % HALOS;
      if (hseq >= HALOS) hp::mbar_wait(&b.hempty[s], (hseq / HALOS - 1) & 1);
      unsigned char* stage = smem + s * g.halo_bytes;
      const int ch = kb * g.kb + 8 * c;
      const bool cvalid = ch < g.Ci;
      for (int r = r0; r < g.rows; r += rstep) {
        const int v = tab[r];
        const int iy = iy0 + (v >> 16), ix = ix0 + (v & 0xFFFF);
        const bool ok = cvalid && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
        hp::cp_async16(stage + hp::swizzled(r, c, rb),
                       ok ? img + ((size_t)iy * g.W + ix) * g.Ci + ch : x, ok);
      }
      hp::cp_async_wait_all();
      hp::fence_proxy_async();
      hp::mbar_arrive(&b.hfull[s]);
    }
  }
}

// A K block of stage_halos_src: channels [c0, c0 + kb) of the (N, H, W, C)
// map p, those at or past C zero. A conv whose input is a channel concat
// (the SPP tail's raw | skip | branches) names one K block per kb channels
// of each map, so that no K block mixes two maps and the concat is never
// built.
struct KSrc {
  const bf* p;
  int C, c0;
};
constexpr int MAX_KSRC = 16;  // K blocks of a table

// stage_halos for an input given as a table of K blocks: K block kb of each
// patch's sequence is staged from src[kb] (g.nkb entries).
__device__ __forceinline__ void stage_halos_src(const Geom& g, const KSrc* src,
                                                unsigned char* smem, const Bars& b, int bt) {
  const int* tab = reinterpret_cast<const int*>(smem + g.off_tab);
  const int rb = 2 * g.kb, cpr = g.kb / 8;
  const int c = bt % cpr, r0 = bt / cpr, rstep = HALO_THREADS / cpr;
  int hseq = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const Patch p = patch(g, t);
    const int iy0 = p.y0 - g.pad, ix0 = p.x0 - g.pad;
    for (int kb = 0; kb < g.nkb; ++kb, ++hseq) {
      const int s = hseq % HALOS;
      if (hseq >= HALOS) hp::mbar_wait(&b.hempty[s], (hseq / HALOS - 1) & 1);
      unsigned char* stage = smem + s * g.halo_bytes;
      const KSrc k = src[kb];
      const int ch = k.c0 + 8 * c;
      const bool cvalid = ch < k.C;
      const bf* img = k.p + (size_t)p.img * g.H * g.W * k.C;
      for (int row = r0; row < g.rows; row += rstep) {
        const int v = tab[row];
        const int iy = iy0 + (v >> 16), ix = ix0 + (v & 0xFFFF);
        const bool ok = cvalid && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
        hp::cp_async16(stage + hp::swizzled(row, c, rb),
                       ok ? img + ((size_t)iy * g.W + ix) * k.C + ch : k.p, ok);
      }
      hp::cp_async_wait_all();
      hp::fence_proxy_async();
      hp::mbar_arrive(&b.hfull[s]);
    }
  }
}

// The weight producer's thread: slab i of each of the block's work items t,
// from src(t, i) (wstage bytes each), through the ring; or, resident (one
// block of output channels), every slab once into place (the consumers wait
// on wfull[0] once).
template <class Src>
__device__ __forceinline__ void stream_weights(const Geom& g, unsigned char* smem, const Bars& b,
                                               int nslab, Src src) {
  if (g.resident) {
    hp::mbar_arrive_expect_tx(&b.wfull[0], (uint32_t)(nslab * g.wstage));
    for (int i = 0; i < nslab; ++i)
      hp::bulk_g2s(smem + g.off_w + i * g.wstage, src(0, i), g.wstage, &b.wfull[0]);
    return;
  }
  int it = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x)
    for (int i = 0; i < nslab; ++i, ++it) {
      const int s = it % g.stages;
      if (it >= g.stages) hp::mbar_wait(&b.wempty[s], (it / g.stages - 1) & 1);
      hp::mbar_arrive_expect_tx(&b.wfull[s], g.wstage);
      hp::bulk_g2s(smem + g.off_w + s * g.wstage, src(t, i), g.wstage, &b.wfull[s]);
    }
}

// A consumer warpgroup's view of the rings: the next weight slab and halo
// stage in sequence.
struct Consumer {
  const Geom& g;
  unsigned char* smem;
  const Bars& b;
  bool lead;     // lane 0 of its warp: arrives for the warp
  int it = 0;    // weight slabs taken (ring mode)
  int hseq = 0;  // halo stages taken

  __device__ Consumer(const Geom& g_, unsigned char* smem_, const Bars& b_, bool lead_)
      : g(g_), smem(smem_), b(b_), lead(lead_) {}

  // Slab i of a patch's sequence, once it has landed (RES: the slabs are
  // resident).
  template <bool RES>
  __device__ const unsigned char* slab(int i) {
    if (RES) return smem + g.off_w + i * g.wstage;
    const int s = it % g.stages;
    hp::mbar_wait(&b.wfull[s], (it / g.stages) & 1);
    ++it;
    return smem + g.off_w + s * g.wstage;
  }

  // The ring stage of the slab `slab<false>` just returned.
  __device__ int stage_of_last() const { return (it - 1) % g.stages; }

  // Releases ring stage s (s >= 0) and halo stage h (h >= 0) for the warp.
  __device__ void release(int s, int h) const {
    if (lead && s >= 0) hp::mbar_arrive(&b.wempty[s]);
    if (lead && h >= 0) hp::mbar_arrive(&b.hempty[h]);
  }
};

template <int KB>
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t sbo) {
  return KB == 64 ? hp::desc_sw128(p, sbo) : hp::desc_sw64(p, sbo);
}

// The first halo row of tap `tap`'s window (before the tile's column).
__device__ __forceinline__ int window(const Geom& g, int tap) {
  const int ky = tap / 3, kx = tap - 3 * (tap / 3);
  if (g.nph == 4) return ((ky & 1) * 2 + (kx & 1)) * g.hp * g.hw + (ky >> 1) * g.hw + (kx >> 1);
  return ky * g.dil * g.hw + kx * g.dil;
}

// The conv of one patch into warpgroup wg's accumulators: MT m64 tiles
// of BN output channels (slabs of BN rows), tile m at patch columns
// 8 (MT wg + m) .. + 7; slabs 0 .. nkb * taps - 1 of the sequence in (K
// block, tap) order, K blocks of KB (= g.kb) channels, resident (RES) or
// through the ring. The MT tiles' products alternate, so that each k16 step
// issues MT independent accumulations. The shapes that decide the
// instruction sequence are template parameters: a wgmma on a path that
// the compiler cannot resolve makes it serialize every wgmma. Returns with
// every group complete and every stage released.
template <int BN, int MT, int KB, bool RES>
__device__ __forceinline__ void conv_patch(Consumer& cs, float (&acc)[MT][BN / 2], int wg) {
  const Geom& g = cs.g;
  constexpr int RB = 2 * KB;
  const uint32_t sbo_a = g.hw * RB;
  int held_slab = -1, held_halo = -1;  // what the last group read (ring mode)
  for (int kb = 0; kb < g.nkb; ++kb) {
    const int hs = cs.hseq % HALOS;
    hp::mbar_wait(&cs.b.hfull[hs], (cs.hseq / HALOS) & 1);
    ++cs.hseq;
    const unsigned char* halo = cs.smem + hs * g.halo_bytes;
    for (int tap = 0; tap < g.taps; ++tap) {
      const unsigned char* w = cs.slab<RES>(kb * g.taps + tap);
      const unsigned char* a = halo + (window(g, tap) + 8 * MT * wg) * RB;
      hp::wgmma_fence();
#pragma unroll
      for (int k = 0; k < KB / 16; ++k) {
        const uint64_t db = desc<KB>(w + 32 * k, 8 * RB);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          hp::wgmma_ss<BN>(acc[m], desc<KB>(a + 8 * m * RB + 32 * k, sbo_a), db,
                           (kb | tap | k) != 0);
      }
      hp::wgmma_commit();
      if (!RES) {
        // the step before this one is done: release its slab and, at the
        // start of a K block, the previous block's halo (the waits are
        // unconditional, as the compiler must see them to keep the wgmma
        // asynchronous)
        hp::wgmma_wait<1>();
        cs.release(held_slab, held_halo);
        held_slab = cs.stage_of_last();
        held_halo = tap == g.taps - 1 ? hs : -1;
      }
    }
    if (RES) {
      // no slab to release: the taps' groups queue up behind each other,
      // and the halo is released once its K block's are done
      hp::wgmma_wait<0>();
      cs.release(-1, hs);
    }
  }
  if (!RES) {
    hp::wgmma_wait<0>();
    cs.release(held_slab, held_halo);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) hp::fence_operand(acc[m][i]);
}

// A 3x3 conv over shared-memory operands that the caller names, for
// kernels whose A tiles are not conv_patch's (res_block.cu: conv1 over rows
// of a halo in flat order, conv2 over a tile that the block computed
// itself): for K block kb < NKB and tap < 9, slab i0 + 9 kb + tap of the
// sequence (resident, RES, or the ring's next) times the window win(kb,
// tap, m) of tile m (8-row groups sbo bytes apart) into MT m64 x BN
// accumulators, which it overwrites. MMA = false runs no wgmma (an
// ablation). Returns with every group complete and every ring stage
// released; halo stages are the caller's. The accumulators are set to zero
// first (the first product overwrites them anyway): the wgmma's operand
// constraint reads them, and without a definition here the compiler would
// keep them live from the previous use, beside a second conv's.
template <int BN, int MT, int KB, int NKB, bool RES, bool MMA, class Win>
__device__ __forceinline__ void conv_windows(Consumer& cs, float (&acc)[MT][BN / 2], int i0,
                                             uint32_t sbo, Win win) {
  constexpr int RB = 2 * KB;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;
  int held = -1;  // the ring stage the last group read
  // the taps stay a loop at run time: unrolled, the compiler would hoist
  // every window's descriptors out of the patch loop and spill them
#pragma unroll 1
  for (int kb = 0; kb < NKB; ++kb)
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const unsigned char* w = cs.slab<RES>(i0 + 9 * kb + tap);
      hp::wgmma_fence();
#pragma unroll
      for (int k = 0; k < KB / 16; ++k) {
        const uint64_t db = desc<KB>(w + 32 * k, 8 * RB);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (MMA)
            hp::wgmma_ss<BN>(acc[m], desc<KB>(win(kb, tap, m) + 32 * k, sbo), db,
                             (kb | tap | k) != 0);
      }
      hp::wgmma_commit();
      if (!RES) {
        hp::wgmma_wait<1>();
        cs.release(held, -1);
        held = cs.stage_of_last();
      }
    }
  hp::wgmma_wait<0>();
  if (!RES) cs.release(held, -1);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) hp::fence_operand(acc[m][i]);
}

// A consumer warpgroup's epilogue goes through its staging tile: every
// thread writes all of its (rounded) results, so that no accumulator is read
// on a divergent path (which makes the compiler serialize every wgmma), and
// then copies 16-byte chunks of whole rows out. Row r of the tile is output
// pixel r of the warpgroup's MT m64 tiles, `ld` bytes apart.
__device__ __forceinline__ void stage_pair(unsigned char* stg, int ld, int m, int wt, int j, int h,
                                           float v0, float v1) {
  const int row = 64 * m + hp::frag_row(wt, 4 * j + 2 * h);
  *reinterpret_cast<__nv_bfloat162*>(stg + row * ld + (8 * j + 2 * (wt % 4)) * 2) =
      __floats2bfloat162_rn(v0, v1);
}

// The launch: one persistent block an SM (its registers hold no second
// one), fewer for fewer patches.
template <class Kernel, class... Args>
int launch(Kernel kernel, const Geom& g, cudaStream_t s, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  int dev = 0, sms = 132;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  kernel<<<g.tiles < sms ? g.tiles : sms, THREADS, g.smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace hx
}  // namespace mt
