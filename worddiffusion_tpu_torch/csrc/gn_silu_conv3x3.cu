// GroupNorm -> SiLU -> 3x3 SAME convolution (C -> C channels), by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bench_kernels/resblock_pallas.py::_kernel
// (reached through fused_gn_silu_conv3x3 -> pl.pallas_call), the prologue of
// every SD-VAE resnet and every UNet ResBlock. For x [B, H, W, C] bf16
// (channels contiguous), w [C_out = C][3][3][C_in = C] bf16 and b [C] fp32:
//
//   a   = bf16(silu(GroupNorm(x)))            the statistics as groupnorm.cu's,
//                                             normalised and activated in fp32
//   a   = 0 outside the image                 padded AFTER the activation (:57)
//   out = bf16(sum over the 9 taps (dy, dx) of a[y + dy - 1, x + dx - 1] . w[:, dy, dx, :]
//              + b)                           fp32 accumulate
//
// What bounds it on this card: operations. At the UNet's training shape
// (B = 128, 8 x 32, C = 320) it is 2 * 9 * C * C per pixel, 60 GFLOP against
// 42 MB of x and out: about 1400 FLOP per byte, far above the bf16 ridge of
// about 295, so the tensor cores' rate is the bound. The TPU kernel held one
// whole image and its normalised copy in VMEM; the VAE's largest image ([64,
// 256, 128], 4 MB in bf16) does not fit an SM's shared memory, so this is an
// implicit GEMM over pixel tiles, M = pixels, N = output channels, K = 9 taps x
// C input channels, in units of (chunk of KC = 64 input channels, tap).
//
// Design (the parts of csrc/hopper.cuh; one launch policy, pick_plan; each
// CTA's sums in a fixed order):
//   - a CTA is two consumer warpgroups and a producer warpgroup. The
//     producer's thread 0 issues every load as a TMA box
//     completing on an mbarrier: each unit's weights, w[n0 .. n0 + BN, tap,
//     c0 .. c0 + 64], a [BN][64] box of a rank-3 map over w ([C_in, 9, C_out])
//     into a ring of 3 to 8 stages (as many as fit), K-major with the 128-byte
//     swizzle that wgmma reads; and each chunk's raw halo, a [TH + 2][TW + 2][64]
//     box of a rank-4 map over x ([C, W, H, B]) at (c0, x0 - 1, y0 - 1, b), into
//     two raw slots, so the next chunk's halo lands behind this chunk's
//     products. The box's pixels outside the image and channels past C arrive
//     as zeros;
//   - a zero raw pixel is not a zero activation (silu((0 - mu) * r * g + b) is
//     not 0): each chunk's raw halo (read through its swizzle) is normalised
//     and activated into one of two activated halos of 144-byte rows
//     (ldmatrix's 8 rows on distinct banks), with 0 written at every position
//     outside the image, as the TPU kernel pads after SiLU: chunk 0 by all the
//     CTA's threads, chunk i + 1 by the producer warpgroup's other three warps
//     while the consumers run chunk i's units, each halo on a full and an
//     empty mbarrier (no setmaxnreg: those warps need their registers);
//   - the products: wgmma.m64nBNk16 with A from registers and B (the unit's
//     weights) from the ring. Each tap's A is the halo shifted by (dy, dx),
//     which no descriptor describes (a tile's rows are TW pixels of a halo row
//     of TW + 2), so each warp loads its 16 pixel rows by ldmatrix at the
//     tap's offset, in the m16n8k16 fragment layout wgmma's register A takes.
//     Each warpgroup waits for a unit's products before it loads the next
//     unit's A (wgmma.wait_group 0), and releases the unit's stage then; the
//     other warpgroup's products keep the tensor cores busy meanwhile.
//     (Tried on the H100 and not kept, none faster: a wait_group 1 pipeline
//     with two A register sets; A from shared memory in three dx-shifted
//     copies of the halo; the activation spread over the units.)
//   - the tile: 128 pixels (a TH x TW rectangle, TW = 32, or 16 for images 16
//     or fewer wide), a warpgroup on each 64, x BN output channels (128, or 160
//     where C is a multiple of 160 and not of 128, as the UNet's 320; else 64),
//     wherever the tile has fewer than twice the image's rows (the fastest
//     plan at every such shape measured); else 64 pixels with K split across
//     the two warpgroups (each takes two of a unit's four k16 steps), x BN or
//     x 64, the first that gives 90% of the SMs a CTA, else the one with the
//     more CTAs;
//   - the GroupNorm statistics: where a sample's CTAs (pixel tiles x channel
//     tiles) are at most 8, they are one thread-block cluster and the kernel
//     computes them itself with B.5's steps (gn_stats.cuh): each CTA sums x
//     and x^2 over its share of the sample's pixels, the group sums go through
//     distributed shared memory in rank order, and every CTA of the cluster
//     holds the same (mu, rstd) before its first activation (the UNet's 8 x 32
//     and 4 x 16 sites: one launch a call). Larger images take B.5's one
//     cluster launch, stopped after its statistics (groupnorm.cu,
//     wd_groupnorm_cluster_stats), into stats [B, G]: two launches a call. The
//     plan decides, here and nowhere else: the caller always passes stats, and
//     the entry says whether it launched the statistics;
//   - the epilogue: the fp32 sums through shared memory (with K split, the two
//     warpgroups' added in order), b added in fp32, bf16 out in 16-byte
//     stores; pixels past H or W and channels past C are masked, so ragged
//     images (5 x 13) and C % 64 != 0 (48) need no padding of the inputs.
// Bitwise repeatable: no atomics, and every sum runs in a fixed order.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "gn_stats.cuh"
#include "hopper.cuh"

extern "C" int wd_groupnorm_cluster_stats(const void* x, void* stats, int b, int s, int c,
                                          int groups, float eps, void* stream);
extern "C" int wd_groupnorm_max_c();

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int KC = 64;        // input channels per chunk: one 128-byte row a pixel
constexpr int LDK = KC + 8;   // bf16 row stride of the activated halo: 144 bytes, so
                              // that ldmatrix's 8 rows fall on distinct banks
constexpr int CONS = 256;     // the two consumer warpgroups' threads
constexpr int THREADS = CONS + 128;  // and the producer warpgroup
constexpr int CONS_BAR = 1;   // named barrier of the consumers
constexpr int ACT_THREADS = 96;  // the producer warpgroup's warps 1..3 activate the halos
constexpr int SMEM_BUDGET = 232448;  // a CTA's most (227 KB)
constexpr int MAX_STAGES = 8;        // < 10: the prologue (that many units) asks for no halo
                                     // but chunk 1's, whose slot is free, so it never waits
                                     // on the consumers
constexpr int MIN_STAGES = 3;
constexpr int MAX_CLUSTER = 8;       // portable cluster size
constexpr int RED_BYTES = 2 * CONS * 8 * 4;  // the statistics pass's per-channel sums

// The launch's shapes and shared-memory layout (bytes from a 1024-byte aligned
// base), by value.
struct Geo {
  int h, w, c, groups, tw, th, ptx, ntiles, chunks, units, stages, cluster;
  int ring, raw, raw_slot, act, act_slot, stat, part, bars, size;
  float eps;
};

struct Plan {
  int px, bn, split;  // pixels a CTA, output channels, K split across the warpgroups
  Geo g;
  long long ctas;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// silu(GroupNorm(x)) of 8 channels as bf16, from their affine
__device__ __forceinline__ uint4 activate8(uint4 raw, const float (&mu)[8], const float (&sc)[8],
                                           const float (&bb)[8]) {
  float f[8];
  unpack8(raw, f);
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float a0 = (f[2 * j] - mu[2 * j]) * sc[2 * j] + bb[2 * j];
    const float a1 = (f[2 * j + 1] - mu[2 * j + 1]) * sc[2 * j + 1] + bb[2 * j + 1];
    o[j] = pack_bf16(__fdividef(a0, 1.f + __expf(-a0)), __fdividef(a1, 1.f + __expf(-a1)));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// One consumer warp's arrival (lane 0) on an empty barrier.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
  __syncwarp();
}

// grid (pixel tiles * channel tiles, B), in clusters of a sample's CTAs where
// g.cluster > 0; threads 0 .. 255 consume, 256 .. 383 produce.
template <int BN, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
    conv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const bf16* __restrict__ x, const float2* __restrict__ stats,
                const float* __restrict__ gn_scale, const float* __restrict__ gn_bias,
                const float* __restrict__ bias, bf16* __restrict__ out, const Geo g) {
  constexpr int SLOT = BN * 128;  // a weight stage: [BN][64] bf16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* wfull = reinterpret_cast<uint64_t*>(sm + g.bars);
  uint64_t* wempty = wfull + g.stages;
  uint64_t* rfull = wempty + g.stages;
  uint64_t* rempty = rfull + 2;
  uint64_t* afull = rempty + 2;
  uint64_t* aempty = afull + 2;
  float2* stat = reinterpret_cast<float2*>(sm + g.stat);
  float2* part = reinterpret_cast<float2*>(sm + g.part);
  const int tid = threadIdx.x;
  const int b = blockIdx.y, nt = blockIdx.x % g.ntiles, pt = blockIdx.x / g.ntiles;
  const int y0 = (pt / g.ptx) * g.th, x0 = (pt % g.ptx) * g.tw, n0 = nt * BN;
  const int hw = g.tw + 2, halo = (g.th + 2) * hw;
  if (tid == 0) {
    for (int i = 0; i < g.stages; ++i) {
      mbar_init(wfull + i, 1);           // the producer's expect_tx
      mbar_init(wempty + i, CONS / 32);  // each consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(rfull + i, 1);
      mbar_init(rempty + i, ACT_THREADS / 32);  // each activating warp
      mbar_init(afull + i, ACT_THREADS / 32);
      mbar_init(aempty + i, CONS / 32);         // each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the producer's thread 0: chunk cc's raw halo into slot cc % 2, unit u's
  // weights into stage u % stages, each after its slot's last reader is done;
  // chunk cc + 1's halo right behind the first unit of chunk cc
  auto issue_raw = [&](int cc) {
    const int slot = cc & 1;
    wait_phase(rempty + slot, ((cc >> 1) & 1) ^ 1);
    mbar_expect_tx(rfull + slot, uint32_t(halo) * KC * 2);
    tma_load_4d(sm + g.raw + slot * g.raw_slot, &xmap, rfull + slot, cc * KC, x0 - 1, y0 - 1, b);
  };
  auto issue_unit = [&](int u) {
    const int s = u % g.stages;
    wait_phase(wempty + s, ((u / g.stages) & 1) ^ 1);
    mbar_expect_tx(wfull + s, SLOT);
    tma_load_3d(sm + g.ring + s * SLOT, &wmap, wfull + s, (u / 9) * KC, u % 9, n0);
    if (u % 9 == 0 && u / 9 + 1 < g.chunks) issue_raw(u / 9 + 1);
  };
  const int ahead = g.stages < g.units ? g.stages : g.units;
  if (tid == CONS) {  // the first loads fly while the statistics are taken
    issue_raw(0);
    for (int u = 0; u < ahead; ++u) issue_unit(u);
  }

  if (g.cluster) {
    // the sample's statistics by the consumers (gn_stats.cuh): this CTA's
    // share of the sample's pixels, 8 channels a thread, summed over the
    // activated halos' space, then the cluster's sums in rank order
    cg::cluster_group cluster = cg::this_cluster();
    const int s = g.h * g.w, nv = g.c / 8, par = CONS / nv;
    if (tid < CONS) {
      const int rank = int(cluster.block_rank()), cv = tid % nv, rp = tid / nv;
      const int r0 = int((long long)rank * s / g.cluster);
      const int r1 = int((long long)(rank + 1) * s / g.cluster);
      float* red = reinterpret_cast<float*>(sm + g.act);
      if (rp < par) {
        float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float sq[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        gn_stats::sum_rows<4>(x + size_t(b) * s * g.c + cv * 8, r0 + rp, r1, par, g.c, sum, sq);
        gn_stats::store_sums<CONS>(red, rp, cv, g.c, sum, sq);
      }
      bar_sync(CONS_BAR, CONS);
      gn_stats::group_sums<CONS>(red, par, g.c, g.groups, part);
    }
    cluster.sync();
    if (tid < CONS)
      gn_stats::cluster_stats<CONS>(part, stat, g.groups, g.cluster,
                                    float(s) * float(g.c / g.groups), g.eps);
    cluster.sync();  // every remote read done; stat visible
  } else {
    for (int i = tid; i < g.groups; i += THREADS) stat[i] = stats[size_t(b) * g.groups + i];
    __syncthreads();
  }

  const int lane = tid % 32;
  const int cpg = g.c / g.groups;
  // Chunk cc's raw halo activated into activated halo cc % 2 (silu(GroupNorm
  // (x)), 0 outside the image and past C: the SAME padding after the
  // activation) by n threads, this one the t-th
  auto activate = [&](int cc, int t, int n) {
    const int slot = cc & 1, v = t & 7, c0 = cc * KC + 8 * v;
    const unsigned char* raw = sm + g.raw + slot * g.raw_slot;
    bf16* dst = reinterpret_cast<bf16*>(sm + g.act + slot * g.act_slot);
    float mu[8], sc[8], bb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ch = c0 + e;
      mu[e] = sc[e] = bb[e] = 0.f;
      if (ch < g.c) {
        const float2 st = stat[ch / cpg];
        mu[e] = st.x;
        sc[e] = st.y * gn_scale[ch];
        bb[e] = gn_bias[ch];
      }
    }
    for (int p = t >> 3; p < halo; p += n / 8) {
      const int yy = y0 - 1 + p / hw, xx = x0 - 1 + p % hw;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (yy >= 0 && yy < g.h && xx >= 0 && xx < g.w)
        val = activate8(*reinterpret_cast<const uint4*>(raw + p * 128 + (((v ^ p) & 7) << 4)), mu,
                        sc, bb);
      *reinterpret_cast<uint4*>(dst + p * LDK + 8 * v) = val;
    }
  };
  // chunk 0 by every thread, then chunk cc by the producer warpgroup's warps
  // 1..3 while the consumers run chunk cc - 1's units
  wait_phase(rfull, 0);
  activate(0, tid, THREADS);
  __syncthreads();
  if (tid >= CONS) {
    if (tid == CONS) {
      for (int u = ahead; u < g.units; ++u) issue_unit(u);
    } else if (tid >= CONS + 32) {
      const int at = tid - (CONS + 32);
      if (lane == 0) {
        mbar_arrive(rempty);  // chunk 0's raw slot read
        mbar_arrive(afull);   // and its activated halo written
      }
      for (int cc = 1; cc < g.chunks; ++cc) {
        const int slot = cc & 1;
        wait_phase(aempty + slot, ((cc >> 1) & 1) ^ 1);
        wait_phase(rfull + slot, (cc >> 1) & 1);
        activate(cc, at, ACT_THREADS);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(rempty + slot);
          mbar_arrive(afull + slot);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, cw = tid / 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row
  // the warpgroup's 64 pixels start at pw: 64 wg (128-pixel tiles) or 0 (K
  // split); the warp's 16 pixels, one tile row, at p0
  const int pw = SPLIT ? 0 : 64 * wg, p0 = pw + 16 * (cw & 3);
  constexpr int KS = SPLIT ? 2 : 4;  // k16 steps of a unit this warpgroup takes
  const int ks0 = SPLIT ? 2 * wg : 0;
  // this lane's ldmatrix row in an activated halo at tap (0, 0)
  const int a_off = ((p0 / g.tw) * hw + p0 % g.tw + (mi & 1) * 8 + lr) * LDK + (mi >> 1) * 8 +
                    ks0 * 16;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t a[KS][4];

  for (int cc = 0; cc < g.chunks; ++cc) {
    const int slot = cc & 1;
    wait_phase(afull + slot, (cc >> 1) & 1);
    const bf16* act = reinterpret_cast<const bf16*>(sm + g.act + slot * g.act_slot) + a_off;
    for (int tap = 0; tap < 9; ++tap) {
      // unit u: A by ldmatrix at the tap's shift (dy, dx); its products, then
      // its stage free
      const int u = cc * 9 + tap, s = u % g.stages;
      wait_phase(wfull + s, (u / g.stages) & 1);
      __syncwarp();
      const bf16* ap = act + ((tap / 3) * hw + tap % 3) * LDK;
#pragma unroll
      for (int k = 0; k < KS; ++k) ldmatrix_x4(a[k], ap + k * 16);
      if (tap == 8) release(aempty + slot, lane);  // the chunk's halo read
      const unsigned char* ws = sm + g.ring + s * SLOT;
#pragma unroll
      for (int k = 0; k < KS; ++k) pin(a[k]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KS; ++k)  // k16 step: 32 bytes into each 128-byte row
        wgmma_rs<0>(acc, a[k], make_desc_sw128(ws + (ks0 + k) * 32), 1);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      release(wempty + s, lane);
    }
  }

  // Each warpgroup's fp32 sums over the ring (every product done, every load
  // landed): [64 pixels][BN] from pixel pw; then, by all 256 threads, bias
  // added (with K split, warpgroup 0's sums + warpgroup 1's, in that order),
  // bf16, 16 bytes a store, pixels past the image and channels past C masked.
  // No instruction but wgmma writes an accumulator.
  float* red = reinterpret_cast<float*>(sm + g.ring);
  constexpr int LDR = BN + 8, PART = 64 * LDR;
  bar_sync(CONS_BAR, CONS);
  {
    const int row = 16 * (cw & 3) + g8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(red + wg * PART + row * LDR + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(red + wg * PART + (row + 8) * LDR + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  bar_sync(CONS_BAR, CONS);
  constexpr int PIX = SPLIT ? 64 : 128;
  for (int i = tid; i < PIX * (BN / 8); i += CONS) {
    const int p = i / (BN / 8), q = i % (BN / 8), co = n0 + 8 * q;
    const int yy = y0 + p / g.tw, xx = x0 + p % g.tw;
    if (yy >= g.h || xx >= g.w || co >= g.c) continue;  // C % 8 == 0: all 8 or none
    const float* r = red + (SPLIT ? p * LDR : (p >> 6) * PART + (p & 63) * LDR) + 8 * q;
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = (SPLIT ? r[e] + r[e + PART] : r[e]) + bias[co + e];
    *reinterpret_cast<uint4*>(out + ((size_t(b) * g.h + yy) * g.w + xx) * g.c + co) =
        make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                   pack_bf16(y[6], y[7]));
  }
}

// ---- the plan and the launch --------------------------------------------------------

// The shapes and layout of a tile of px pixels x bn channels at this shape;
// size 0 where it does not fit.
Geo geometry(int px, int bn, int h, int w, int c, int groups) {
  Geo g{};
  g.h = h;
  g.w = w;
  g.c = c;
  g.groups = groups;
  g.tw = w <= 16 ? 16 : 32;
  g.th = px / g.tw;
  g.ptx = (w + g.tw - 1) / g.tw;
  g.ntiles = (c + bn - 1) / bn;
  g.chunks = (c + KC - 1) / KC;
  g.units = 9 * g.chunks;
  const int ptiles = ((h + g.th - 1) / g.th) * g.ptx, per_sample = ptiles * g.ntiles;
  g.cluster = per_sample <= MAX_CLUSTER ? per_sample : 0;
  const int halo = (g.th + 2) * (g.tw + 2);
  g.raw_slot = round_up(halo * KC * 2, 1024);
  // the ring at the base, then the two raw halo slots (1024-byte aligned for
  // the swizzle), the two activated halos (which also hold the statistics'
  // sums before the first chunk), stat, part, the barriers
  g.act_slot = round_up(halo * LDK * 2, 16);
  const int act = 2 * g.act_slot > RED_BYTES ? 2 * g.act_slot : RED_BYTES;
  const int fixed = 2 * g.raw_slot + act + 2 * round_up(groups * 8, 16) + 8 * (2 * MAX_STAGES + 8);
  const int slot = bn * 128;
  int stages = (SMEM_BUDGET - 1024 - fixed) / slot;
  stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  if (stages < MIN_STAGES || stages * slot < 2 * 64 * (bn + 8) * 4) return Geo{};
  g.stages = stages;
  g.ring = 0;
  g.raw = stages * slot;
  g.act = g.raw + 2 * g.raw_slot;
  g.stat = g.act + act;
  g.part = g.stat + round_up(groups * 8, 16);
  g.bars = g.part + round_up(groups * 8, 16);
  g.size = g.bars + 8 * (2 * stages + 8) + 1024;  // + the base's alignment
  return g;
}

long long ctas_of(const Geo& g, int b) {
  return (long long)b * ((g.h + g.th - 1) / g.th) * g.ptx * g.ntiles;
}

Plan make_plan(int px, int bn, int split, int b, int h, int w, int c, int groups) {
  Plan p{px, bn, split, geometry(px, bn, h, w, c, groups), 0};
  if (p.g.size) p.ctas = ctas_of(p.g, b);
  return p;
}

// The plan: 128 pixels x BN where the tile has fewer than twice the image's
// rows (measured the fastest at every such shape: the weights are read once
// for more pixels); else, with K split over 64 pixels, the first of x BN and
// x 64 channels that gives 90% of the SMs a CTA, else the one with the more
// CTAs; x 64 is passed over where its sample's CTAs outgrow a cluster and x BN's
// do not (a 640-wide 4 x 16 site at B = 16: 5 CTAs a sample against 10), so
// that the statistics stay in the kernel rather than take a B.5 launch
// (measured there on an H100: 0.052 ms of device time against 0.093).
Plan pick_plan(int b, int h, int w, int c, int groups) {
  const int bn = c % 128 == 0 ? 128 : c % 160 == 0 ? 160 : 64;
  const int sms = [] {
    int n = 132, dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const Plan wide = make_plan(128, bn, 0, b, h, w, c, groups);
  if (wide.g.size && wide.g.th < 2 * h) return wide;
  Plan best{};
  best.ctas = -1;
  for (const int n : {bn, 64}) {
    const Plan p = make_plan(64, n, 1, b, h, w, c, groups);
    if (p.g.size == 0 || (best.ctas > 0 && best.g.cluster && !p.g.cluster)) continue;
    if (10 * p.ctas >= 9LL * sms) return p;
    if (p.ctas > best.ctas) best = p;
  }
  return best;
}

template <typename Kernel>
cudaError_t raise_smem_once(Kernel kernel, std::atomic<unsigned long long>& raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BUDGET);
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit);
  }
  return cudaSuccess;
}

struct Args {
  const void *x, *gn_scale, *gn_bias, *w, *bias;
  void *out, *stats;
  int b;
};

template <int BN, bool SPLIT>
cudaError_t launch(const Plan& p, const Args& a, cudaStream_t stream) {
  static std::atomic<unsigned long long> raised{0};
  cudaError_t e = raise_smem_once(conv_kernel<BN, SPLIT>, raised);
  if (e != cudaSuccess) return e;
  const Geo& g = p.g;
  const long long c = g.c;
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, map_key(a.x, 4, {c, g.w, g.h, a.b}, {2 * c, 2 * c * g.w, 2 * c * g.w * g.h},
                             {KC, g.tw + 2, g.th + 2, 1})) ||
      !encode(&wmap, map_key(a.w, 3, {c, 9, c}, {2 * c, 18 * c}, {KC, 1, BN})))
    return cudaErrorInvalidValue;
  const long long per_sample = ctas_of(g, 1);
  if (per_sample > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(per_sample), unsigned(a.b));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = g.size;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.cluster ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, conv_kernel<BN, SPLIT>, xmap, wmap, static_cast<const bf16*>(a.x),
                         static_cast<const float2*>(a.stats), static_cast<const float*>(a.gn_scale),
                         static_cast<const float*>(a.gn_bias), static_cast<const float*>(a.bias),
                         static_cast<bf16*>(a.out), g);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool shape_ok(int b, int h, int w, int c, int groups) {
  return b >= 1 && b <= 65535 && h >= 1 && w >= 1 && c >= 8 && c % 8 == 0 &&
         c <= wd_groupnorm_max_c() && groups >= 1 && c % groups == 0;
}

// Launch on plan p: B.5's statistics first where the plan takes no cluster
// (then *stats_launched = 1, else 0, where stats_launched is not null).
int run(Plan p, int b, const void* x, const void* gn_scale, const void* gn_bias, const void* w,
        const void* bias, void* out, void* stats, float eps, int* stats_launched, void* stream) {
  if (p.ctas <= 0 || stats == nullptr) return cudaErrorInvalidValue;
  p.g.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!p.g.cluster) {
    const int err = wd_groupnorm_cluster_stats(x, stats, b, p.g.h * p.g.w, p.g.c, p.g.groups,
                                               eps, stream);
    if (err) return err;
  }
  if (stats_launched != nullptr) *stats_launched = p.g.cluster ? 0 : 1;
  const Args a{x, gn_scale, gn_bias, w, bias, out, stats, b};
  if (p.bn == 128) return p.split ? launch<128, true>(p, a, s) : launch<128, false>(p, a, s);
  if (p.bn == 160) return p.split ? launch<160, true>(p, a, s) : launch<160, false>(p, a, s);
  return p.split ? launch<64, true>(p, a, s) : launch<64, false>(p, a, s);
}

}  // namespace

extern "C" {

// The plan at this shape into out[0..7]: pixels a CTA, output channels a CTA,
// K split across the two warpgroups (0 or 1), the cluster of a sample's CTAs
// (0: the statistics come from a launch before, into stats), CTAs, weight
// stages of the ring, dynamic shared memory bytes, tile width. Returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
int wd_gn_silu_conv3x3_plan(int b, int h, int w, int c, int groups, int* out) {
  if (!shape_ok(b, h, w, c, groups)) return cudaErrorInvalidValue;
  const Plan p = pick_plan(b, h, w, c, groups);
  if (p.ctas <= 0) return cudaErrorInvalidValue;
  const int v[8] = {p.px, p.bn, p.split, p.g.cluster, int(p.ctas), p.g.stages, p.g.size, p.g.tw};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// out [B, H, W, C] = conv3x3(silu(GroupNorm(x)), w) + b; x and out bf16, w
// [C][3][3][C] bf16 (output channel, tap row, tap column, input channel), all
// contiguous and 16-byte aligned; gn_scale, gn_bias, b [C] fp32; stats [B, G]
// float2 scratch (used where the plan's cluster is 0). One launch, or two
// where the statistics take B.5's: *stats_launched (a host int) says which, 0
// or 1. Returns a cudaError_t.
int wd_gn_silu_conv3x3(const void* x, const void* gn_scale, const void* gn_bias, const void* w,
                       const void* bias, void* out, void* stats, int b, int h, int wd, int c,
                       int groups, float eps, int* stats_launched, void* stream) {
  if (!shape_ok(b, h, wd, c, groups)) return cudaErrorInvalidValue;
  return run(pick_plan(b, h, wd, c, groups), b, x, gn_scale, gn_bias, w, bias, out, stats, eps,
             stats_launched, stream);
}

// For measurements (worddiffusion_tpu_torch/kernel_times.py): wd_gn_silu_conv3x3
// on the plan of px pixels (64 or 128) x bn channels (64, 128 or 160), K split
// or not, where it fits the shape, instead of the one it picks.
int wd_gn_silu_conv3x3_planned(const void* x, const void* gn_scale, const void* gn_bias,
                               const void* w, const void* bias, void* out, void* stats, int b,
                               int h, int wd, int c, int groups, float eps, int px, int bn,
                               int split, void* stream) {
  if (!shape_ok(b, h, wd, c, groups) || (px != 64 && px != 128) ||
      (bn != 64 && bn != 128 && bn != 160) || (split != 0 && split != 1) ||
      (px == 64) != (split == 1))
    return cudaErrorInvalidValue;
  return run(make_plan(px, bn, split, b, h, wd, c, groups), b, x, gn_scale, gn_bias, w, bias,
             out, stats, eps, nullptr, stream);
}

}  // extern "C"
