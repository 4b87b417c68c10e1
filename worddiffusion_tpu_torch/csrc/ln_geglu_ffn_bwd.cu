// Backward of the fused LayerNorm + GEGLU feed-forward + residual, by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel worddiffusion_tpu/ops/ffn_pallas.py::_ln_ffn_bwd_kernel
// (reached through _ln_ffn_bwd_pallas -> pl.pallas_call). For x, dy [M, d] bf16,
// gamma/beta [d] fp32 and the forward's weights in the port's parameter layout,
// W1 [2*inner, d] bf16 (proj.weight: a rows, then u rows), b1 [2*inner] fp32 and
// W2 [d, inner] bf16 (out.weight), all contiguous, it recomputes the forward
//
//   xhat = (x - mean) * rstd,  xn = bf16(xhat * gamma + beta)
//   [a | u] = xn . W1^T + b1  (fp32),  act = bf16(a * gelu_tanh(u))
//
// and returns, with the TPU kernel's dtype contract,
//
//   dact = dy . W2 (fp32),  dh = [dact * gelu(u) | dact * a * gelu'(u)] (fp32)
//   dhc  = bf16(dh),  dxn = dhc . W1 (fp32)
//   dx   = bf16(dy + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))),
//          dxhat = dxn * gamma
//   dgamma = sum_rows dxn * xhat, dbeta = sum_rows dxn, db1 = sum_rows dh,
//   db2 = sum_rows dy, dW1 = dhc^T . xn [2*inner, d], dW2 = dy^T . act [d, inner]
//   (all fp32, the weight gradients in parameter layout).
//
// What bounds it on this card: operations. At the flagship width (d = 320,
// inner = 1280) the backward does 16*M*d*inner FLOP (214.7 GFLOP at M = 32768):
// recompute 4, dact 2, dxn 4, dW1 4, dW2 2, far above the H100's bf16 ridge of
// about 295 FLOP per byte; 0.217 ms at 989 TFLOP/s. At d = 640, M = 8192 (the
// middle block of channel_mult (1, 2) at B = 128) it is the same 214.7 GFLOP.
//
// Widths: every d = 64k from 64 to 768, the widths the forward kernel takes
// (JAX's fits_vmem(d, 4d)), with inner any positive multiple of 64. Two routes,
// chosen by d at compile time:
//   - d <= 320: the fused route, A (rows), B (weights), C (sums) below. Row
//     kernel A keeps a 64-row tile's x and dy in shared memory (2 * 128 d
//     bytes) beside a 4-stage ring of W1 rows and W2 columns (4 * 96 d bytes):
//     640 d bytes, 227 KB at d = 320, which is as wide as it fits. d = 320 is
//     the plan the port has trained with since it was written.
//   - d > 320: the split route. A's x and dy tiles alone are 160 KB at d = 640
//     (192 KB at 768), so they cannot stay resident beside any ring stage
//     (one stage is 60 KB at 640), and its dxn [64, d] accumulator would be
//     d/4 fp32 registers a thread of each consumer warpgroup (192 at 768,
//     beside [a | u] and dact under setmaxnreg 240). So A is split in three
//     and its operands streamed: S0 normalises x into xn (and the row
//     statistics) one warp a row; S1 recomputes [a | u] and dact for a
//     128-row x 64-column tile of inner, K = d streamed in 64-column atoms
//     of xn, dy, W1 and W2 through a 4-stage TMA ring (96 accumulator
//     registers a thread), and writes dhc, act and db1's partials; S2 is
//     dxn = dhc . W1 as its own wgmma product over K = 2 inner (a 128 x 192
//     or 128 x 256 tile, fp32 to device memory); S3 is the LayerNorm
//     backward, one warp a row, then the per-block column partials. dxn's
//     round trip costs 8 M d bytes (42 MB at d = 640, M = 8192: about 13 us
//     at 3.35 TB/s) against the 217 us bound. B and C are shared by both
//     routes (B's column tile set by d).
//
// Design of the fused route. CTAs run in parallel and in no order, and fp32
// atomics would make the gradients depend on the order in which CTAs finish,
// which would break the trainer's bitwise resume; so every sum is taken in a
// fixed order, in three launches on one stream, every product on wgmma with
// both operands in shared memory, every operand tile brought by TMA
// (csrc/hopper.cuh):
//   A. rows: a CTA is two consumer warpgroups and a producer warpgroup
//      (setmaxnreg 24 / 240) on a 64-row tile. The producer's thread 0 loads
//      the tile's x and dy (TMA boxes of [64 rows][64 d], 128-byte swizzle),
//      then walks inner in chunks of 16 columns into a ring of 4 stages, each
//      chunk's W1 rows [32 x d] (a rows, then u rows: one box of a rank-3 view
//      [2, inner, d] per 32 d, 64-byte swizzle) and W2 columns [d x 16]
//      (32-byte swizzle), each stage on a full and an empty mbarrier. Each CTA
//      walks its chunks from its own start (rotated by its tile), so that the
//      card's CTAs read different weights from L2 at once rather than all the
//      same lines. Where the row tiles are too few for the card
//      (under 90% of the SMs: M up to about 7600) a cluster of 2, 4 or 8 CTAs
//      shares one tile, each CTA a range of the chunks. The consumers
//      normalise x into xn in place (xn also leaves by TMA stores, for B), then
//      take the CTA's chunks in pairs: warpgroup w takes chunk 2j + w's [a | u]
//      of its 16 columns (wgmma m64n32 over d, W1 K-major), dact (m64n16, W2
//      MN-major: wgmma transposes 16-bit B), GEGLU and its derivative in the
//      accumulators' registers (the forward's tanhf), writes dhc to shared
//      memory in the 64-byte swizzle (double-buffered by the pair) and act
//      beside it; then each warpgroup adds the pair's dhc . W1-rows into its
//      own half of dxn's columns (m64n160, K = 32 a chunk: the staged W1 rows
//      read MN-major), 80 fp32 registers a thread (a whole [64, d] dxn a
//      warpgroup, with the recompute's accumulators beside it, spilled). dxn
//      stays in flight while act and dhc go to device memory as 16-byte
//      stores and the column sums of dh (db1's partials) are written. After
//      the last pair the cluster's partials (where it shares a tile) are added
//      in rank order through distributed shared memory, CTA r taking rows
//      [r*64/CL, (r+1)*64/CL), which then run the LayerNorm backward into dx
//      and per-tile column partials of dgamma, dbeta, db2.
//   B. weights: dW1 = dhc^T . xn and dW2 (as its transpose act^T . dy) on
//      wgmma with both operands M-major (transposed): a CTA per 128 x WN
//      output tile (WN = 160 at d = 320; ceil(d / 192) column tiles of at
//      most 192, the last one ragged) and quarter of M, two consumer
//      warpgroups of 64 output rows and a producer warpgroup whose thread 0
//      brings each 64-row step's dhc (or act) [64 x 128] and xn (or dy)
//      [64 x 64 YA] (YA = 3 at d = 320) by TMA into a 4-stage ring
//      (128-byte swizzle; rows past M and columns past the matrix arrive as
//      zeros); a cluster of 4 CTAs a tile, 240 CTAs on the 132 SMs, the four
//      fp32 partials summed in rank order through distributed shared memory.
//   C. the per-tile partials of dgamma, dbeta, db2 and db1 summed in order.
// No atomics anywhere, on either route; for a given M the clusters and tiles,
// and so every sum's order, are fixed: bitwise repeatable.
// Scratch: xn [M, d], dhc [M, 2*inner], act [M, inner] (bf16), written by A and
// read by B; the partials [tiles*CL, 3*d] and [tiles, 2*inner] (fp32); on the
// split route also the row statistics [2, M] and dxn [M, d] (fp32).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int D_MIN = 64, D_MAX = 768, D_STEP = 64;  // the widths both routes take
constexpr int FUSED_MAX = 320;  // the widest d of the fused row kernel (its shared memory)
constexpr int BM = 64;         // rows per tile of kernel A: one wgmma M
constexpr int NC = 16;         // inner columns per chunk (a ring stage)
constexpr int CONS = 256;      // two consumer warpgroups
constexpr int THREADS = CONS + 128;  // and the producer warpgroup
constexpr int CONS_BAR = 1;    // named barriers: the consumers', then each warpgroup's (2, 3)
constexpr int WG_BAR = 2;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * (168 - PRODUCER_REGS) >= CONS * (CONSUMER_REGS - 168), "what the producer frees");
constexpr int STAGES = 4;      // kernel A's ring
constexpr int SMEM_MAX = 232448;

// Kernel A's shared memory, byte offsets from a 1024-byte aligned base: the ring
// (per stage W1's 32 rows in d/32 blocks of [32][32] and W2's columns [d][16]),
// the x (then xn) and dy tiles (5 atoms of [64][64] each), a chunk pair's dhc
// [64 x 32] per chunk (64-byte swizzle), double-buffered by the pair's parity;
// per warpgroup act [64][16] and db1's per-warp column sums, the row
// statistics, the barriers. The epilogue's fp32 dxn [64][d + 8] lies over the
// ring.
template <int D>
struct SmemA {
  static constexpr int ATOMS = D / 64;
  static constexpr int NB = D / 32;             // W1's 32-column blocks
  static constexpr int BLOCK = 32 * 64;         // a block: [32 rows][32 d], 64-byte swizzle
  static constexpr int LDR = D + 8;             // fp32 row stride of dxn
  static constexpr int W1_BYTES = NB * BLOCK;   // 32 rows of W1
  static constexpr int W2_BYTES = D * NC * 2;   // d rows of 16 columns of W2
  static constexpr int STAGE = W1_BYTES + W2_BYTES;
  static constexpr int TILE = BM * D * 2;
  static constexpr int ring = 0;
  static constexpr int xs = ring + STAGES * STAGE;
  static constexpr int dys = xs + TILE;
  static constexpr int dhc = dys + TILE;                 // [2 pair parities][2 chunks][64][32] bf16
  static constexpr int act = dhc + 4 * BM * 64;          // 2 x [64][16] bf16
  static constexpr int db1 = act + 2 * BM * 32;          // 2 x [4 warps][32] fp32
  static constexpr int mu = db1 + 2 * 4 * 32 * 4;
  static constexpr int rstd = mu + BM * 4;
  static constexpr int bars = rstd + BM * 4;             // full, empty per stage; x full
  static constexpr int total = bars + 8 * (2 * STAGES + 1) + 1024;  // + the alignment
  static_assert(D % 64 == 0 && D <= FUSED_MAX, "the fused route's widths");
  static_assert(STAGE % 1024 == 0 && TILE % 1024 == 0, "swizzle alignment");
  static_assert(BM * LDR * 4 <= STAGES * STAGE, "dxn fits over the ring");
  static_assert(total <= SMEM_MAX, "a CTA's shared memory");
};

// Kernel A's clusters at M rows: CL CTAs share a tile (the smallest of 1, 2,
// 4, 8 that gives 90% of the SMs a CTA, each CTA two chunks at least).
struct RowsPlan {
  int tiles, cl;
  int ctas() const { return tiles * cl; }
};

int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

RowsPlan rows_plan(int m, int inner) {
  RowsPlan p{(m + BM - 1) / BM, 1};
  const int sms = sm_count();
  while (p.cl < 8 && 2 * p.cl <= inner / NC && 10LL * p.tiles * p.cl < 9LL * sms) p.cl *= 2;
  return p;
}

// Byte offset of element (r, c) (c < 64) in a [rows][64] atom, 128-byte swizzle.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// One consumer warp's arrival (lane 0) on an empty barrier.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
  __syncwarp();
}

// grid (tiles * CL), clusters of CL CTAs: cluster t is row tile t and CTA r
// takes the r-th of CL ranges of its chunks. part1 [tiles * CL][3 D]: dgamma |
// dbeta | db2 over CTA r's rows of the epilogue at row t * CL + r; part2
// [tiles][2 inner]: db1 over tile t's rows.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_bwd_rows_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap dymap,
                        const __grid_constant__ CUtensorMap w1map,
                        const __grid_constant__ CUtensorMap w2map,
                        const __grid_constant__ CUtensorMap xnmap, const bf16* __restrict__ x,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        const float* __restrict__ b1, bf16* __restrict__ dx,
                        bf16* __restrict__ dhc_g, bf16* __restrict__ act_g,
                        float* __restrict__ part1, float* __restrict__ part2, int M, int inner,
                        int cl, float eps) {
  using L = SmemA<D>;
  constexpr int NV = D / 8, PER = (NV + 31) / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* xs = sm + L::xs;
  unsigned char* dys = sm + L::dys;
  float* mus = reinterpret_cast<float*>(sm + L::mu);
  float* rstds = reinterpret_cast<float*>(sm + L::rstd);
  float* red = reinterpret_cast<float*>(sm + L::ring);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* xfull = empty + STAGES;

  const int tid = threadIdx.x;
  // this CTA's tile and range of chunks
  const int tile = blockIdx.x / cl;
  const int split = rank;
  const int row0 = tile * BM;
  const int chunks = inner / NC;
  const int c0 = split * chunks / cl, nch = (split + 1) * chunks / cl - c0;
  // The CTA walks its chunks from its own start (its lc-th chunk is c0 + (lc +
  // rot) % nch), so that at any time the card's
  // CTAs read different weights from L2 rather than all the same lines; the
  // order of dxn's sums is the CTA's own, fixed
  const int rot = nch ? tile % nch : 0;
  auto chunk_of = [&](int lc) { return c0 + (lc + rot < nch ? lc + rot : lc + rot - nch); };
  const int two_inner = 2 * inner;
  const int rows = BM / cl, r_lo = split * rows;  // this CTA's rows of the epilogue

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);           // this CTA's producer's expect_tx
      mbar_init(empty + i, 8);          // every consumer warp
    }
    mbar_init(xfull, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONS) {
      mbar_expect_tx(xfull, 2 * L::TILE);
      for (int a = 0; a < L::ATOMS; ++a) {
        tma_load_2d(xs + a * BM * 128, &xmap, xfull, 64 * a, row0);
        tma_load_2d(dys + a * BM * 128, &dymap, xfull, 64 * a, row0);
      }
      // chunk lc: W1 boxes 0 .. NB - 1 ([2][16][32] at d 32 i), W2 boxes NB,
      // NB + 1 ([160][16] at d 0, 160)
      for (int lc = 0; lc < nch; ++lc) {
        const int s = lc % STAGES, c = chunk_of(lc) * NC;
        wait_phase(empty + s, ((lc / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, L::STAGE);
        unsigned char* st = sm + L::ring + s * L::STAGE;
        for (int i = 0; i < L::NB; ++i)
          tma_load_3d(st + i * L::BLOCK, &w1map, full + s, 32 * i, c, 0);
        for (int i = 0; i < 2; ++i)
          tma_load_2d(st + L::W1_BYTES + i * (D / 2) * 32, &w2map, full + s, c, i * (D / 2));
      }
    }
    cluster.sync();  // the consumers' partials written
    cluster.sync();  // every remote read done
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, w4 = warp % 4, g8 = (lane >> 2) + 16 * w4, t4 = lane & 3;

  // LayerNorm of the tile in place: warp w takes rows 8w .. 8w + 7, four at a
  // time, 8 lanes a row, lane l the 8-column chunk l % 8 of every atom; fp32
  // statistics in two passes (the mean, then the centred squares). Rows past M
  // arrive as zeros and stay zero.
  wait_phase(xfull, 0);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = 8 * warp + 4 * q + (lane >> 3), c8 = lane & 7;
    float f[L::ATOMS][8];
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < L::ATOMS; ++a) {
      unpack8(*reinterpret_cast<const uint4*>(xs + a * BM * 128 + sw128(r, 8 * c8)), f[a]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[a][e];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    const float mu = s / D;
    float v = 0.f;
#pragma unroll
    for (int a = 0; a < L::ATOMS; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) v += (f[a][e] - mu) * (f[a][e] - mu);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    const float rs = rsqrtf(v / D + eps);
    const bool in = row0 + r < M;
    if (c8 == 0) {
      mus[r] = mu;
      rstds[r] = rs;
    }
#pragma unroll
    for (int a = 0; a < L::ATOMS; ++a) {
      const int col = 64 * a + 8 * c8;
      const float4 ga = *reinterpret_cast<const float4*>(gamma + col);
      const float4 gb = *reinterpret_cast<const float4*>(gamma + col + 4);
      const float4 ba = *reinterpret_cast<const float4*>(beta + col);
      const float4 bb = *reinterpret_cast<const float4*>(beta + col + 4);
      const float gm[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const float bt[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = in ? (f[a][e] - mu) * rs * gm[e] + bt[e] : 0.f;
      *reinterpret_cast<uint4*>(xs + a * BM * 128 + sw128(r, 8 * c8)) = make_uint4(
          pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
    }
  }
  fence_proxy_async();  // xn's stores, visible to wgmma and the TMA store
  bar_sync(CONS_BAR, CONS);
  if (tid == 0 && split == 0) {  // xn for kernel B; rows past M clipped
    for (int a = 0; a < L::ATOMS; ++a) tma_store_2d(&xnmap, xs + a * BM * 128, 64 * a, row0);
    bulk_commit();
  }

  // The CTA's chunks in pairs (2j, 2j + 1): warpgroup wg takes chunk 2j + wg's
  // [a | u] (its 16 columns), dact, GEGLU and dhc, then both add the pair's
  // dhc . W1-rows into their half of dxn's columns, d/2 each. acc1 and dact
  // are overwritten by each chunk's first product and read after wait_group 0;
  // dxn accumulates over the pairs and is in flight from its issue to the
  // next pair's wait. No other instruction writes an accumulator while a
  // product is in flight.
  unsigned char* acts = sm + L::act + wg * BM * 32;
  float* db1s = reinterpret_cast<float*>(sm + L::db1) + wg * 4 * 32;
  const int wtid = tid % 128;
  const int pairs = (nch + 1) / 2;
  float acc1[16], dact[8], dxn[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dxn[i] = 0.f;
  // the stages of pair j, released by each warp of both warpgroups once both
  // warpgroups' products of the pair are done
  auto release_pair = [&](int j) {
    for (int c = 0; c < 2; ++c)
      if (2 * j + c < nch) release(empty + (2 * j + c) % STAGES, lane);
  };
  for (int j = 0; j < pairs; ++j) {
    const int lc = 2 * j + wg;
    const bool mine = lc < nch;
    const unsigned char* w1s = sm + L::ring + (lc % STAGES) * L::STAGE;
    if (mine) {
      const unsigned char* w2s = w1s + L::W1_BYTES;
      wait_phase(full + lc % STAGES, (lc / STAGES) & 1);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int off = (ks >> 2) * BM * 128 + (ks & 3) * 32;
        wgmma_ss<0, 0>(acc1, make_desc_sw128(xs + off),
                       make_desc(w1s + (ks >> 1) * L::BLOCK + (ks & 1) * 32, 16, 512, SW64),
                       ks > 0);
        wgmma_ss<0, 1>(dact, make_desc_sw128(dys + off),
                       make_desc(w2s + ks * 16 * 32, 16, 256, SW32), ks > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();  // and the last pair's dxn: its stages are free
    pin(acc1);
    pin(dact);
    pin(dxn);
    if (j > 0) release_pair(j - 1);
    bar_sync(WG_BAR + wg, 128);  // every warp's stores of the last pair's act done

    // GEGLU and its derivative: thread (g8, t4) holds a (acc1 j = 0, 1), u
    // (j = 2, 3) and dact (j = 0, 1) of columns 8q + 2 t4, + 1 of the chunk's
    // 16, rows g8 and g8 + 8
    unsigned char* dhcs = sm + L::dhc + ((j & 1) * 2 + wg) * BM * 64;
    const int cb = chunk_of(lc) * NC;
    if (mine) {
      float db1a[2][2], db1u[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * q + 2 * t4;
        const float2 ba = *reinterpret_cast<const float2*>(b1 + cb + col);
        const float2 bu = *reinterpret_cast<const float2*>(b1 + inner + cb + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float act2[2], da2[2], du2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = acc1[4 * q + 2 * h + e] + (e ? ba.y : ba.x);
            const float u = acc1[4 * (q + 2) + 2 * h + e] + (e ? bu.y : bu.x);
            const float t = tanhf(GELU_C * (u + GELU_K * u * u * u));
            const float gu = 0.5f * u * (1.f + t);
            const float dgu =
                0.5f * (1.f + t) + 0.5f * u * (1.f - t * t) * GELU_C * (1.f + 3.f * GELU_K * u * u);
            const float dd = dact[4 * q + 2 * h + e];
            act2[e] = a * gu;
            da2[e] = dd * gu;
            du2[e] = dd * a * dgu;
            db1a[q][e] = (h ? db1a[q][e] : 0.f) + da2[e];
            db1u[q][e] = (h ? db1u[q][e] : 0.f) + du2[e];
          }
          const int r = g8 + 8 * h;
          *reinterpret_cast<uint32_t*>(acts + r * 32 + col * 2) = pack_bf16(act2[0], act2[1]);
          *reinterpret_cast<uint32_t*>(dhcs + swz_chunk<64>(r, col >> 3) + (col & 7) * 2) =
              pack_bf16(da2[0], da2[1]);
          *reinterpret_cast<uint32_t*>(dhcs + swz_chunk<64>(r, 2 + (col >> 3)) + (col & 7) * 2) =
              pack_bf16(du2[0], du2[1]);
        }
      }
      // db1: the column sums of dh over the warp's 16 rows (the 8 lanes of a
      // column, in a fixed butterfly), then over the 4 warps in order below
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sa = db1a[q][e], su = db1u[q][e];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            sa += __shfl_xor_sync(0xffffffffu, sa, o);
            su += __shfl_xor_sync(0xffffffffu, su, o);
          }
          if (lane < 4) {
            db1s[w4 * 32 + 8 * q + 2 * t4 + e] = sa;
            db1s[w4 * 32 + 16 + 8 * q + 2 * t4 + e] = su;
          }
        }
    }
    fence_proxy_async();  // dhc, read by both warpgroups' dxn products
    bar_sync(CONS_BAR, CONS);  // the pair's dhc complete

    // dxn[:, wg d/2 .. (wg + 1) d/2) += dhc_c . W1-rows_c over the pair's chunks:
    // K = a chunk's 32 rows, W1's rows read MN-major (blocks of 32 columns)
    wgmma_fence();
    for (int c = 0; c < 2; ++c) {
      const int lc2 = 2 * j + c;
      if (lc2 >= nch) break;
      wait_phase(full + lc2 % STAGES, (lc2 / STAGES) & 1);  // landed: read here too
      __syncwarp();
      const unsigned char* ws = sm + L::ring + (lc2 % STAGES) * L::STAGE + wg * (L::NB / 2) * L::BLOCK;
      const unsigned char* dh = sm + L::dhc + ((j & 1) * 2 + c) * BM * 64;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        wgmma_ss<0, 1>(dxn, make_desc(dh + ks * 32, 16, 512, SW64),
                       make_desc(ws + ks * 16 * 64, L::BLOCK, 512, SW64), 1);
    }
    wgmma_commit();

    // behind it: act and dhc to device memory, 16 bytes a store, and db1
    if (mine) {
      {
        const int r = wtid / 2, q = wtid % 2, gr = row0 + r;
        if (gr < M)
          *reinterpret_cast<uint4*>(act_g + size_t(gr) * inner + cb + 8 * q) =
              *reinterpret_cast<const uint4*>(acts + r * 32 + q * 16);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = wtid + 128 * k, r = i / 4, q = i % 4, gr = row0 + r;
        if (gr < M)
          *reinterpret_cast<uint4*>(dhc_g + size_t(gr) * two_inner + ((q & 2) ? inner : 0) + cb +
                                    8 * (q & 1)) =
              *reinterpret_cast<const uint4*>(dhcs + swz_chunk<64>(r, q));
      }
      if (wtid < 32) {
        const float* sp = db1s + wtid;
        const int col = ((wtid & 16) ? inner : 0) + cb + (wtid & 15);
        part2[size_t(tile) * two_inner + col] = sp[0] + sp[32] + sp[64] + sp[96];
      }
    }
  }
  wgmma_wait<0>();
  pin(dxn);
  if (pairs > 0) release_pair(pairs - 1);
  // every product of both warpgroups done (the ring free: every chunk landed
  // and was read): each warpgroup's half of dxn over the ring
  bar_sync(CONS_BAR, CONS);
#pragma unroll
  for (int q = 0; q < D / 16; ++q) {
    const int col = wg * (D / 2) + 8 * q + 2 * t4;
    *reinterpret_cast<float2*>(red + g8 * L::LDR + col) = make_float2(dxn[4 * q], dxn[4 * q + 1]);
    *reinterpret_cast<float2*>(red + (g8 + 8) * L::LDR + col) =
        make_float2(dxn[4 * q + 2], dxn[4 * q + 3]);
  }
  cluster.sync();

  // The LayerNorm backward of this CTA's rows, one warp a row: dxn summed over
  // the tile's CL partials in rank order (kept in this CTA's own rows for the
  // column sums), then dx.
  for (int r = r_lo + warp; r < r_lo + rows; r += CONS / 32) {
    const int gr = row0 + r;
    if (gr >= M) continue;
    const float mu = mus[r], rstd = rstds[r];
    float dn[PER][8], xh[PER][8], dyv[PER][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int vi = lane + 32 * k;
      if (vi >= NV) break;
#pragma unroll
      for (int j = 0; j < 8; ++j) dn[k][j] = 0.f;
      for (int q = 0; q < cl; ++q) {
        const float* src = cluster.map_shared_rank(red, q) + r * L::LDR + vi * 8;
        const float4 lo = *reinterpret_cast<const float4*>(src);
        const float4 hi = *reinterpret_cast<const float4*>(src + 4);
        dn[k][0] += lo.x; dn[k][1] += lo.y; dn[k][2] += lo.z; dn[k][3] += lo.w;
        dn[k][4] += hi.x; dn[k][5] += hi.y; dn[k][6] += hi.z; dn[k][7] += hi.w;
      }
      unpack8(*reinterpret_cast<const uint4*>(x + size_t(gr) * D + vi * 8), xh[k]);
      unpack8(*reinterpret_cast<const uint4*>(dys + (vi >> 3) * BM * 128 + sw128(r, (vi & 7) * 8)),
              dyv[k]);
      const float4 ga = *reinterpret_cast<const float4*>(gamma + vi * 8);
      const float4 gb = *reinterpret_cast<const float4*>(gamma + vi * 8 + 4);
      const float gm[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        xh[k][j] = (xh[k][j] - mu) * rstd;
        const float dxh = dn[k][j] * gm[j];
        s1 += dxh;
        s2 += dxh * xh[k][j];
      }
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int vi = lane + 32 * k;
      if (vi >= NV) break;
      const float4 ga = *reinterpret_cast<const float4*>(gamma + vi * 8);
      const float4 gb = *reinterpret_cast<const float4*>(gamma + vi * 8 + 4);
      const float gm[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = dyv[k][j] + rstd * (dn[k][j] * gm[j] - m1 - xh[k][j] * m2);
      *reinterpret_cast<uint4*>(dx + size_t(gr) * D + vi * 8) = make_uint4(
          pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
    }
    // the summed dxn into this CTA's own row r, which no other CTA reads
    __syncwarp();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int vi = lane + 32 * k;
      if (vi >= NV) break;
      float* d = red + r * L::LDR + vi * 8;
      *reinterpret_cast<float4*>(d) = make_float4(dn[k][0], dn[k][1], dn[k][2], dn[k][3]);
      *reinterpret_cast<float4*>(d + 4) = make_float4(dn[k][4], dn[k][5], dn[k][6], dn[k][7]);
    }
  }
  bar_sync(CONS_BAR, CONS);

  // column partials over this CTA's rows, in row order
  float* p1 = part1 + size_t(tile * cl + split) * 3 * D;
  for (int c = tid; c < D; c += CONS) {
    float sg = 0.f, sb = 0.f, sy = 0.f;
    for (int r = r_lo; r < r_lo + rows && row0 + r < M; ++r) {
      const float dn = red[r * L::LDR + c];
      const float xh = (__bfloat162float(x[size_t(row0 + r) * D + c]) - mus[r]) * rstds[r];
      const bf16 dyv =
          *reinterpret_cast<const bf16*>(dys + (c >> 6) * BM * 128 + sw128(r, c & 63));
      sg += dn * xh;
      sb += dn;
      sy += __bfloat162float(dyv);
    }
    p1[c] = sg;
    p1[D + c] = sb;
    p1[2 * D + c] = sy;
  }
  if (tid == 0 && split == 0) bulk_wait<0>();  // xn's store has read the tile
  cluster.sync();  // every remote read done before any CTA of the cluster leaves
}

// Kernel B: the weight gradients. Tile t of 128 rows x WN columns of
//   dW1 [2 inner, D] = X^T . Y, X = dhc [M, 2 inner], Y = xn [M, D]   (t < T1), or
//   dW2^T [inner, D] = X^T . Y, X = act [M, inner], Y = dy [M, D], stored as dW2 [D, inner];
// grid (tiles * SPLIT), cluster (SPLIT, 1, 1): CTA r of a cluster walks the r-th
// of SPLIT equal runs of M's 64-row steps.
constexpr int SPLIT = 4;
constexpr int WR = 128, WK = 64;  // tile rows; M rows a step
constexpr int W_STAGES = 4;
constexpr int WX_BYTES = WK * WR * 2;   // two [64 x 64] atoms of X^T

// The column tiles at width D: NT tiles of WN columns (a multiple of 16, at
// most 192: 160 at D = 320), the last one ragged; Y's stage holds YA 64-column
// atoms (the last one partly used, or past D and not loaded).
template <int D>
struct WPlan {
  static constexpr int NT = (D + 191) / 192;
  static constexpr int WN = ((D + NT - 1) / NT + 15) / 16 * 16;
  static constexpr int YA = (WN + 63) / 64;
  static constexpr int Y_BYTES = YA * WK * 128;
  static constexpr int STAGE = WX_BYTES + Y_BYTES;
  static constexpr int LDR = WN + 8;
  static constexpr int SMEM = W_STAGES * STAGE + 8 * 2 * W_STAGES + 1024;
  static_assert(WN <= 192 && WN % 16 == 0 && NT * WN >= D, "column tiles");
  static_assert(WR * LDR * 4 <= W_STAGES * STAGE, "the partial fits over the ring");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_bwd_weights_kernel(const __grid_constant__ CUtensorMap dhcmap,
                           const __grid_constant__ CUtensorMap xnmap,
                           const __grid_constant__ CUtensorMap actmap,
                           const __grid_constant__ CUtensorMap dymap, float* __restrict__ dw1,
                           float* __restrict__ dw2, int M, int inner) {
  using W = WPlan<D>;
  constexpr int WN = W::WN, W_LDR = W::LDR, W_STAGE = W::STAGE;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + W_STAGES * W_STAGE);
  uint64_t* empty = full + W_STAGES;

  const int tid = threadIdx.x;
  const int two_inner = 2 * inner;
  const int t1 = W::NT * ((two_inner + WR - 1) / WR);
  int t = blockIdx.x / SPLIT;
  const bool first = t < t1;
  if (!first) t -= t1;
  const int r0 = (t / W::NT) * WR, n0 = (t % W::NT) * WN;
  const int R = first ? two_inner : inner;  // X's columns: the output's rows
  const int steps = (M + WK - 1) / WK;
  const int s0 = rank * steps / SPLIT, s1 = (rank + 1) * steps / SPLIT;
  const int n = s1 - s0;
  // the atoms of X and Y that hold a column of the matrix (the others are not
  // loaded: they feed only outputs past its edge, which are not stored)
  const int xa = r0 + 64 < R ? 2 : 1;
  const int ya = min(W::YA, (D - n0 + 63) / 64);

  if (tid == 0) {
    for (int i = 0; i < W_STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONS) {
      const CUtensorMap* xm = first ? &dhcmap : &actmap;
      const CUtensorMap* ym = first ? &xnmap : &dymap;
      for (int i = 0; i < n; ++i) {
        const int s = i % W_STAGES, m0 = (s0 + i) * WK;
        wait_phase(empty + s, ((i / W_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, (xa + ya) * 8192);
        unsigned char* xs = sm + s * W_STAGE;
        for (int a = 0; a < xa; ++a) tma_load_2d(xs + a * 8192, xm, full + s, r0 + 64 * a, m0);
        for (int a = 0; a < ya; ++a)
          tma_load_2d(xs + WX_BYTES + a * 8192, ym, full + s, n0 + 64 * a, m0);
      }
    }
    cluster.sync();
    cluster.sync();
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, g8 = (lane >> 2) + 16 * (warp % 4), t4 = lane & 3;
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % W_STAGES;
    wait_phase(full + s, (i / W_STAGES) & 1);
    __syncwarp();
    const unsigned char* xs = sm + s * W_STAGE;
    const unsigned char* ys = xs + WX_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WK / 16; ++ks)
      wgmma_ss<1, 1>(acc, make_desc(xs + wg * 8192 + ks * 2048, 8192, 1024, SW128),
                     make_desc(ys + ks * 2048, 8192, 1024, SW128), 1);
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) {  // step i - 1's products are done: its stage is free
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (i - 1) % W_STAGES);
      __syncwarp();
    }
  }
  wgmma_wait<0>();
  pin(acc);
  bar_sync(CONS_BAR, CONS);  // every product done, every load landed: the partial goes over the ring

  // warpgroup wg holds rows [64 wg, 64 wg + 64) of the tile
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = 8 * j + 2 * t4, row = 64 * wg + g8;
    *reinterpret_cast<float2*>(red + row * W_LDR + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(red + (row + 8) * W_LDR + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  cluster.sync();

  // rows [rank * 128 / SPLIT, ...) of the tile: the SPLIT partials in rank order;
  // columns past D (the last tile's ragged edge) are not stored
  constexpr int ROWS = WR / SPLIT;
  const int lo = rank * ROWS;
  if (first) {
    for (int i = tid; i < ROWS * (WN / 4); i += CONS) {
      const int r = lo + i / (WN / 4), c = (i % (WN / 4)) * 4;
      if (r0 + r >= R || n0 + c >= D) continue;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < SPLIT; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + r * W_LDR + c);
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      *reinterpret_cast<float4*>(dw1 + size_t(r0 + r) * D + n0 + c) = s;
    }
  } else {
    // dW2 [D, inner]: neighbouring threads take neighbouring rows of the tile
    for (int i = tid; i < ROWS * WN; i += CONS) {
      const int r = lo + i % ROWS, c = i / ROWS;
      if (r0 + r >= R || n0 + c >= D) continue;
      float s = 0.f;
      for (int q = 0; q < SPLIT; ++q) s += cluster.map_shared_rank(red, q)[r * W_LDR + c];
      dw2[size_t(n0 + c) * inner + r0 + r] = s;
    }
  }
  cluster.sync();  // every remote read done before any CTA of the cluster leaves
}

// --- the split route (d > 320): S0 .. S3, then B and C ---

// S0: the LayerNorm forward, one warp a row (N_ROWS rows a CTA): xn =
// bf16(xhat * gamma + beta) to device memory (for S1 and B), and the row's
// mean and rstd (fp32; two passes, the mean then the centred squares, as A's).
constexpr int N_ROWS = 8;

template <int D>
__global__ void __launch_bounds__(32 * N_ROWS)
    ffn_bwd_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ beta, bf16* __restrict__ xn,
                        float* __restrict__ mu_g, float* __restrict__ rstd_g, int M, float eps) {
  constexpr int NV = D / 8, PER = (NV + 31) / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * N_ROWS + threadIdx.x / 32;
  if (r >= M) return;
  float f[PER][8];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int vi = lane + 32 * k;
    if (vi >= NV) break;
    unpack8(*reinterpret_cast<const uint4*>(x + size_t(r) * D + vi * 8), f[k]);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[k][e];
  }
  const float mu = warp_sum(s) / D;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (lane + 32 * k >= NV) break;
#pragma unroll
    for (int e = 0; e < 8; ++e) v += (f[k][e] - mu) * (f[k][e] - mu);
  }
  const float rs = rsqrtf(warp_sum(v) / D + eps);
  if (lane == 0) {
    mu_g[r] = mu;
    rstd_g[r] = rs;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int vi = lane + 32 * k;
    if (vi >= NV) break;
    const float4 ga = *reinterpret_cast<const float4*>(gamma + vi * 8);
    const float4 gb = *reinterpret_cast<const float4*>(gamma + vi * 8 + 4);
    const float4 ba = *reinterpret_cast<const float4*>(beta + vi * 8);
    const float4 bb = *reinterpret_cast<const float4*>(beta + vi * 8 + 4);
    const float gm[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    const float bt[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = (f[k][e] - mu) * rs * gm[e] + bt[e];
    *reinterpret_cast<uint4*>(xn + size_t(r) * D + vi * 8) = make_uint4(
        pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
  }
}

// S1: [a | u] = xn . W1^T + b1 and dact = dy . W2 for a tile of GM rows and GN
// columns of inner (CTA = row tile * inner / GN + column tile), K = d in
// 64-column atoms through a ring of G_STAGES stages, each xn and dy [GM][64],
// W1's a rows and u rows [GN][64] (K-major) and W2 [64][GN] (MN-major), all
// 128-byte swizzled TMA boxes; consumer warpgroup w takes rows [64 w, 64 w +
// 64) (m64n64k16, three accumulators of 32 registers). Then GEGLU and its
// derivative in the accumulators' registers, as A's: act and dhc to device
// memory, and db1's column sums over the tile's rows (the 8 rows of a lane
// group by a fixed butterfly, then the 8 warps in order) into part2's row of
// the row tile. Rows past M arrive as zeros: dact = 0 there, so they add 0.
constexpr int GM = 128, GN = 64, G_STAGES = 4;
constexpr int G_ROWS = GM * 128;  // xn or dy: [128 rows][64] bf16
constexpr int G_W = GN * 128;     // W1's a or u rows, or W2's columns: [64][64] bf16
constexpr int G_STAGE = 2 * G_ROWS + 3 * G_W;
constexpr int G_SMEM = G_STAGES * G_STAGE + 8 * 2 * G_STAGES + 1024;
static_assert(G_SMEM <= SMEM_MAX && G_STAGE % 1024 == 0, "S1's ring");
static_assert(8 * 2 * GN * 4 <= G_STAGES * G_STAGE, "db1's warp sums fit over the ring");

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_bwd_gate_kernel(const __grid_constant__ CUtensorMap xnmap,
                        const __grid_constant__ CUtensorMap dymap,
                        const __grid_constant__ CUtensorMap w1map,
                        const __grid_constant__ CUtensorMap w2map, const float* __restrict__ b1,
                        bf16* __restrict__ dhc_g, bf16* __restrict__ act_g,
                        float* __restrict__ part2, int M, int inner) {
  constexpr int KS = D / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G_STAGES * G_STAGE);
  uint64_t* empty = full + G_STAGES;
  const int tid = threadIdx.x;
  const int ctiles = inner / GN;
  const int rt = blockIdx.x / ctiles, c0 = (blockIdx.x % ctiles) * GN, row0 = rt * GM;

  if (tid == 0) {
    for (int i = 0; i < G_STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONS) {
      for (int k = 0; k < KS; ++k) {
        const int s = k % G_STAGES;
        wait_phase(empty + s, ((k / G_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, G_STAGE);
        unsigned char* st = sm + s * G_STAGE;
        tma_load_2d(st, &xnmap, full + s, 64 * k, row0);
        tma_load_2d(st + G_ROWS, &dymap, full + s, 64 * k, row0);
        tma_load_2d(st + 2 * G_ROWS, &w1map, full + s, 64 * k, c0);
        tma_load_2d(st + 2 * G_ROWS + G_W, &w1map, full + s, 64 * k, inner + c0);
        tma_load_2d(st + 2 * G_ROWS + 2 * G_W, &w2map, full + s, c0, 64 * k);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, g8 = (lane >> 2) + 16 * (warp % 4), t4 = lane & 3;
  float acc_a[GN / 2], acc_u[GN / 2], dact[GN / 2];
  for (int k = 0; k < KS; ++k) {
    const int s = k % G_STAGES;
    wait_phase(full + s, (k / G_STAGES) & 1);
    __syncwarp();
    const unsigned char* st = sm + s * G_STAGE;
    const unsigned char* xs = st + wg * (G_ROWS / 2);
    const unsigned char* ys = st + G_ROWS + wg * (G_ROWS / 2);
    const unsigned char* was = st + 2 * G_ROWS;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int acc = (k | kk) != 0;
      wgmma_ss<0, 0>(acc_a, make_desc_sw128(xs + kk * 32), make_desc_sw128(was + kk * 32), acc);
      wgmma_ss<0, 0>(acc_u, make_desc_sw128(xs + kk * 32), make_desc_sw128(was + G_W + kk * 32),
                     acc);
      wgmma_ss<0, 1>(dact, make_desc_sw128(ys + kk * 32),
                     make_desc(was + 2 * G_W + kk * 2048, 8192, 1024, SW128), acc);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (k > 0) release(empty + (k - 1) % G_STAGES, lane);  // step k - 1's products are done
  }
  wgmma_wait<0>();
  pin(acc_a);
  pin(acc_u);
  pin(dact);
  bar_sync(CONS_BAR, CONS);  // both warpgroups' products done: the ring is free

  // thread (g8, t4) holds columns 8 j + 2 t4, + 1 of the tile's 64, rows g8 and g8 + 8
  float* db1s = reinterpret_cast<float*>(sm);  // [8 warps][a 64 | u 64]
  const int two_inner = 2 * inner;
#pragma unroll
  for (int j = 0; j < GN / 8; ++j) {
    const int gc = c0 + 8 * j + 2 * t4;
    const float2 ba = *reinterpret_cast<const float2*>(b1 + gc);
    const float2 bu = *reinterpret_cast<const float2*>(b1 + inner + gc);
    float sa[2], su[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float act2[2], da2[2], du2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = acc_a[4 * j + 2 * h + e] + (e ? ba.y : ba.x);
        const float u = acc_u[4 * j + 2 * h + e] + (e ? bu.y : bu.x);
        const float t = tanhf(GELU_C * (u + GELU_K * u * u * u));
        const float gu = 0.5f * u * (1.f + t);
        const float dgu =
            0.5f * (1.f + t) + 0.5f * u * (1.f - t * t) * GELU_C * (1.f + 3.f * GELU_K * u * u);
        const float dd = dact[4 * j + 2 * h + e];
        act2[e] = a * gu;
        da2[e] = dd * gu;
        du2[e] = dd * a * dgu;
        sa[e] = (h ? sa[e] : 0.f) + da2[e];
        su[e] = (h ? su[e] : 0.f) + du2[e];
      }
      const int r = row0 + 64 * wg + g8 + 8 * h;
      if (r < M) {
        *reinterpret_cast<uint32_t*>(act_g + size_t(r) * inner + gc) = pack_bf16(act2[0], act2[1]);
        *reinterpret_cast<uint32_t*>(dhc_g + size_t(r) * two_inner + gc) =
            pack_bf16(da2[0], da2[1]);
        *reinterpret_cast<uint32_t*>(dhc_g + size_t(r) * two_inner + inner + gc) =
            pack_bf16(du2[0], du2[1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sa[e] += __shfl_xor_sync(0xffffffffu, sa[e], o);
        su[e] += __shfl_xor_sync(0xffffffffu, su[e], o);
      }
      if (lane < 4) {
        db1s[warp * 2 * GN + 8 * j + 2 * t4 + e] = sa[e];
        db1s[warp * 2 * GN + GN + 8 * j + 2 * t4 + e] = su[e];
      }
    }
  }
  bar_sync(CONS_BAR, CONS);
  if (tid < 2 * GN) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < CONS / 32; ++w) sum += db1s[w * 2 * GN + tid];
    part2[size_t(rt) * two_inner + (tid < GN ? c0 + tid : inner + c0 + tid - GN)] = sum;
  }
}

// S2: dxn [M, D] = dhc . W1 in fp32, a tile of 128 rows (consumer warpgroup w
// the rows [64 w, 64 w + 64)) and XN columns, K = 2 inner in 64-row steps
// through a ring: dhc [128][64] (K-major) and XA atoms of W1's rows [64][64]
// (MN-major: W1 [2 inner, d] is K x N, N contiguous), 128-byte swizzle. d's
// ATOMS atoms are cut into TILES column tiles of XA atoms (the last one
// ragged; atoms past d are not loaded and their columns not stored).
template <int D>
struct DxnPlan {
  static constexpr int ATOMS = D / 64;
  static constexpr int TILES = (ATOMS + 3) / 4;
  static constexpr int XA = (ATOMS + TILES - 1) / TILES;
  static constexpr int XN = 64 * XA;
  static constexpr int STAGES = 4;
  static constexpr int STAGE = G_ROWS + XA * 8192;
  static constexpr int SMEM = STAGES * STAGE + 8 * 2 * STAGES + 1024;
  static_assert(XN <= 256 && SMEM <= SMEM_MAX, "S2's tile and ring");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_bwd_dxn_kernel(const __grid_constant__ CUtensorMap dhcmap,
                       const __grid_constant__ CUtensorMap w1map, float* __restrict__ dxn, int M,
                       int inner) {
  using P = DxnPlan<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::STAGES * P::STAGE);
  uint64_t* empty = full + P::STAGES;
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / P::TILES) * GM, n0 = (blockIdx.x % P::TILES) * P::XN;
  const int steps = 2 * inner / 64;
  const int xa = min(P::XA, (D - n0) / 64);  // the tile's atoms inside d

  if (tid == 0) {
    for (int i = 0; i < P::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONS) {
      for (int k = 0; k < steps; ++k) {
        const int s = k % P::STAGES;
        wait_phase(empty + s, ((k / P::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, G_ROWS + xa * 8192);
        unsigned char* st = sm + s * P::STAGE;
        tma_load_2d(st, &dhcmap, full + s, 64 * k, row0);
        for (int a = 0; a < xa; ++a)
          tma_load_2d(st + G_ROWS + a * 8192, &w1map, full + s, n0 + 64 * a, 64 * k);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, g8 = (lane >> 2) + 16 * (warp % 4), t4 = lane & 3;
  float acc[P::XN / 2];
  for (int k = 0; k < steps; ++k) {
    const int s = k % P::STAGES;
    wait_phase(full + s, (k / P::STAGES) & 1);
    __syncwarp();
    const unsigned char* st = sm + s * P::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 1>(acc, make_desc_sw128(st + wg * (G_ROWS / 2) + kk * 32),
                     make_desc(st + G_ROWS + kk * 2048, 8192, 1024, SW128), (k | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (k > 0) release(empty + (k - 1) % P::STAGES, lane);
  }
  wgmma_wait<0>();
  pin(acc);
  const int r = row0 + 64 * wg + g8;
#pragma unroll
  for (int j = 0; j < P::XN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    if (col >= D) continue;
    if (r < M)
      *reinterpret_cast<float2*>(dxn + size_t(r) * D + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < M)
      *reinterpret_cast<float2*>(dxn + size_t(r + 8) * D + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// S3: the LayerNorm backward of LR rows a CTA, one warp a row (A's epilogue
// on dxn from device memory): dx = bf16(dy + rstd * (dxhat - mean(dxhat) -
// xhat * mean(dxhat * xhat))); then the CTA's column partials of dgamma, dbeta
// and db2 over its rows in row order, a thread a column, into part1's row of
// the CTA.
constexpr int LR = 64;

template <int D>
__global__ void __launch_bounds__(32 * N_ROWS)
    ffn_bwd_ln_kernel(const float* __restrict__ dxn, const bf16* __restrict__ x,
                      const bf16* __restrict__ dy, const float* __restrict__ mu_g,
                      const float* __restrict__ rstd_g, const float* __restrict__ gamma,
                      bf16* __restrict__ dx, float* __restrict__ part1, int M) {
  constexpr int NV = D / 8, PER = (NV + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * LR;
  for (int r = warp; r < LR; r += N_ROWS) {
    const int gr = row0 + r;
    if (gr >= M) break;
    const float mu = mu_g[gr], rstd = rstd_g[gr];
    float dn[PER][8], xh[PER][8], dyv[PER][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int vi = lane + 32 * k;
      if (vi >= NV) break;
      const float4 lo = *reinterpret_cast<const float4*>(dxn + size_t(gr) * D + vi * 8);
      const float4 hi = *reinterpret_cast<const float4*>(dxn + size_t(gr) * D + vi * 8 + 4);
      dn[k][0] = lo.x; dn[k][1] = lo.y; dn[k][2] = lo.z; dn[k][3] = lo.w;
      dn[k][4] = hi.x; dn[k][5] = hi.y; dn[k][6] = hi.z; dn[k][7] = hi.w;
      unpack8(*reinterpret_cast<const uint4*>(x + size_t(gr) * D + vi * 8), xh[k]);
      unpack8(*reinterpret_cast<const uint4*>(dy + size_t(gr) * D + vi * 8), dyv[k]);
      const float4 ga = *reinterpret_cast<const float4*>(gamma + vi * 8);
      const float4 gb = *reinterpret_cast<const float4*>(gamma + vi * 8 + 4);
      const float gm[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        xh[k][j] = (xh[k][j] - mu) * rstd;
        const float dxh = dn[k][j] * gm[j];
        s1 += dxh;
        s2 += dxh * xh[k][j];
      }
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int vi = lane + 32 * k;
      if (vi >= NV) break;
      const float4 ga = *reinterpret_cast<const float4*>(gamma + vi * 8);
      const float4 gb = *reinterpret_cast<const float4*>(gamma + vi * 8 + 4);
      const float gm[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = dyv[k][j] + rstd * (dn[k][j] * gm[j] - m1 - xh[k][j] * m2);
      *reinterpret_cast<uint4*>(dx + size_t(gr) * D + vi * 8) = make_uint4(
          pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
    }
  }
  float* p1 = part1 + size_t(blockIdx.x) * 3 * D;
  for (int c = threadIdx.x; c < D; c += 32 * N_ROWS) {
    float sg = 0.f, sb = 0.f, sy = 0.f;
    for (int r = 0; r < LR && row0 + r < M; ++r) {
      const size_t i = size_t(row0 + r) * D + c;
      const float dn = dxn[i];
      const float xh = (__bfloat162float(x[i]) - mu_g[row0 + r]) * rstd_g[row0 + r];
      sg += dn * xh;
      sb += dn;
      sy += __bfloat162float(dy[i]);
    }
    p1[c] = sg;
    p1[D + c] = sb;
    p1[2 * D + c] = sy;
  }
}

// Kernel C: column j of [dgamma | dbeta | db2] (j < 3 D, over part1's n1 rows)
// or of db1 (over part2's n2 rows); the 8 warps take rows w, w + 8, ..., and
// their 8 sums are added in warp order.
constexpr int C_THREADS = 256;

__global__ void __launch_bounds__(C_THREADS)
    ffn_bwd_reduce_kernel(const float* __restrict__ part1, int n1, const float* __restrict__ part2,
                          int n2, int d, int inner, float* __restrict__ dgamma,
                          float* __restrict__ dbeta, float* __restrict__ db2,
                          float* __restrict__ db1) {
  __shared__ float sums[C_THREADS / 32][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.x * 32 + lane, w1 = 3 * d, width = w1 + 2 * inner;
  float s = 0.f;
  if (j < w1) {
    for (int r = warp; r < n1; r += C_THREADS / 32) s += part1[size_t(r) * w1 + j];
  } else if (j < width) {
    for (int r = warp; r < n2; r += C_THREADS / 32) s += part2[size_t(r) * 2 * inner + j - w1];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp || j >= width) return;
  s = 0.f;
#pragma unroll
  for (int w = 0; w < C_THREADS / 32; ++w) s += sums[w][lane];
  if (j < d) dgamma[j] = s;
  else if (j < 2 * d) dbeta[j - d] = s;
  else if (j < 3 * d) db2[j - 2 * d] = s;
  else db1[j - w1] = s;
}

// The dynamic shared memory limit of a kernel, raised once per device.
template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes, std::atomic<unsigned long long>& raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit);
  }
  return cudaSuccess;
}

template <typename K, typename... Args>
cudaError_t launch_cluster(K kernel, int grid, int cl, size_t smem, cudaStream_t stream,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int D>
int weight_tiles(int inner) {
  return WPlan<D>::NT * ((2 * inner + WR - 1) / WR + (inner + WR - 1) / WR);
}

// The split route's scratch: part1 [n1][3 D] | part2 [n2][2 inner] | mean [Mp] |
// rstd [Mp] | dxn [M][D] (fp32), Mp = M rounded up to 4 floats (16 bytes).
struct SplitParts {
  long long n1, n2, mp;
  long long floats(int m, int d, int inner) const {
    return n1 * 3 * d + n2 * 2 * inner + 2 * mp + (long long)m * d;
  }
};

SplitParts split_parts(int m) {
  return {(m + LR - 1) / LR, (m + GM - 1) / GM, (m + 3) / 4 * 4};
}

template <int D>
cudaError_t launch_all(const void* x, const void* dy, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2, void* dx, void* dgamma,
                       void* dbeta, void* dw1, void* db1, void* dw2, void* db2, void* xn,
                       void* dhc, void* act, void* part, int M, int inner, float eps,
                       cudaStream_t s) {
  static std::atomic<unsigned long long> raised_a{0}, raised_b{0}, raised_x{0};
  constexpr size_t smem_w = WPlan<D>::SMEM;
  cudaError_t e = raise_smem(ffn_bwd_weights_kernel<D>, smem_w, raised_b);
  if (e != cudaSuccess) return e;
  const long long m = M, d = D, in = inner;
  CUtensorMap dymap, xnmap, dhcmap, actmap;
  if (!encode(&dymap, map_key(dy, 2, {d, m}, {2 * d}, {64, BM})) ||
      !encode(&xnmap, map_key(xn, 2, {d, m}, {2 * d}, {64, BM})) ||
      !encode(&dhcmap, map_key(dhc, 2, {2 * in, m}, {4 * in}, {64, WK})) ||
      !encode(&actmap, map_key(act, 2, {in, m}, {2 * in}, {64, WK})))
    return cudaErrorInvalidValue;
  const auto f32 = [](const void* q) { return static_cast<const float*>(q); };
  float* part1 = static_cast<float*>(part);
  float* part2;
  int n1, n2;
  if constexpr (D <= FUSED_MAX) {
    constexpr size_t smem_a = SmemA<D>::total;
    e = raise_smem(ffn_bwd_rows_kernel<D>, smem_a, raised_a);
    if (e != cudaSuccess) return e;
    CUtensorMap xmap, w1map, w2map;
    if (!encode(&xmap, map_key(x, 2, {d, m}, {2 * d}, {64, BM})) ||
        !encode(&w1map, map_key(w1, 3, {d, in, 2}, {2 * d, 2 * d * in}, {32, NC, 2},
                                CU_TENSOR_MAP_SWIZZLE_64B)) ||
        !encode(&w2map, map_key(w2, 2, {in, d}, {2 * in}, {NC, D / 2}, CU_TENSOR_MAP_SWIZZLE_32B)))
      return cudaErrorInvalidValue;
    const RowsPlan p = rows_plan(M, inner);
    part2 = part1 + size_t(p.ctas()) * 3 * D;
    n1 = p.ctas();
    n2 = p.tiles;
    e = launch_cluster(ffn_bwd_rows_kernel<D>, p.ctas(), p.cl, smem_a, s, xmap, dymap,
                       w1map, w2map, xnmap, static_cast<const bf16*>(x), f32(gamma), f32(beta),
                       f32(b1), static_cast<bf16*>(dx), static_cast<bf16*>(dhc),
                       static_cast<bf16*>(act), part1, part2, M, inner, p.cl, eps);
    if (e != cudaSuccess) return e;
  } else {
    using P = DxnPlan<D>;
    e = raise_smem(ffn_bwd_gate_kernel<D>, G_SMEM, raised_a);
    if (e == cudaSuccess) e = raise_smem(ffn_bwd_dxn_kernel<D>, P::SMEM, raised_x);
    if (e != cudaSuccess) return e;
    CUtensorMap xnmap_g, dymap_g, w1map, w2map, dhcmap_x;
    if (!encode(&xnmap_g, map_key(xn, 2, {d, m}, {2 * d}, {64, GM})) ||
        !encode(&dymap_g, map_key(dy, 2, {d, m}, {2 * d}, {64, GM})) ||
        !encode(&w1map, map_key(w1, 2, {d, 2 * in}, {2 * d}, {64, GN})) ||
        !encode(&w2map, map_key(w2, 2, {in, d}, {2 * in}, {GN, 64})) ||
        !encode(&dhcmap_x, map_key(dhc, 2, {2 * in, m}, {4 * in}, {64, GM})))
      return cudaErrorInvalidValue;
    const SplitParts sp = split_parts(M);
    n1 = int(sp.n1);
    n2 = int(sp.n2);
    part2 = part1 + size_t(sp.n1) * 3 * D;
    float* mu = part2 + size_t(sp.n2) * 2 * inner;
    float* rstd = mu + sp.mp;
    float* dxn = rstd + sp.mp;
    const int row_tiles = int(sp.n2);
    ffn_bwd_norm_kernel<D><<<(M + N_ROWS - 1) / N_ROWS, 32 * N_ROWS, 0, s>>>(
        static_cast<const bf16*>(x), f32(gamma), f32(beta), static_cast<bf16*>(xn), mu, rstd,
        M, eps);
    ffn_bwd_gate_kernel<D><<<row_tiles * (inner / GN), THREADS, G_SMEM, s>>>(
        xnmap_g, dymap_g, w1map, w2map, f32(b1), static_cast<bf16*>(dhc),
        static_cast<bf16*>(act), part2, M, inner);
    ffn_bwd_dxn_kernel<D><<<row_tiles * P::TILES, THREADS, P::SMEM, s>>>(dhcmap_x, w1map, dxn,
                                                                         M, inner);
    ffn_bwd_ln_kernel<D><<<n1, 32 * N_ROWS, 0, s>>>(
        dxn, static_cast<const bf16*>(x), static_cast<const bf16*>(dy), mu, rstd, f32(gamma),
        static_cast<bf16*>(dx), part1, M);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  e = launch_cluster(ffn_bwd_weights_kernel<D>, weight_tiles<D>(inner) * SPLIT, SPLIT, smem_w, s,
                     dhcmap, xnmap, actmap, dymap, static_cast<float*>(dw1),
                     static_cast<float*>(dw2), M, inner);
  if (e != cudaSuccess) return e;
  const int width = 3 * D + 2 * inner;
  ffn_bwd_reduce_kernel<<<(width + 31) / 32, C_THREADS, 0, s>>>(
      part1, n1, part2, n2, D, inner,
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), static_cast<float*>(db2),
      static_cast<float*>(db1));
  return cudaGetLastError();
}

// f.template run<D>() at the width d; false for a width the kernels do not take.
template <typename F>
bool with_width(int d, F&& f) {
  switch (d) {
    case 64: f.template run<64>(); return true;
    case 128: f.template run<128>(); return true;
    case 192: f.template run<192>(); return true;
    case 256: f.template run<256>(); return true;
    case 320: f.template run<320>(); return true;
    case 384: f.template run<384>(); return true;
    case 448: f.template run<448>(); return true;
    case 512: f.template run<512>(); return true;
    case 576: f.template run<576>(); return true;
    case 640: f.template run<640>(); return true;
    case 704: f.template run<704>(); return true;
    case 768: f.template run<768>(); return true;
    default: return false;
  }
}

// The plan at (M, d, inner) into out[0..9], as wd_ln_geglu_ffn_bwd_plan returns it.
struct PlanOf {
  int m, inner, *out;
  template <int D>
  void run() {
    const int wctas = weight_tiles<D>(inner) * SPLIT;
    if constexpr (D <= FUSED_MAX) {
      const RowsPlan p = rows_plan(m, inner);
      const int v[10] = {0, BM, STAGES, p.ctas(), p.cl, 0, wctas, SPLIT, W_STAGES, WPlan<D>::WN};
      for (int i = 0; i < 10; ++i) out[i] = v[i];
    } else {
      const int rt = (m + GM - 1) / GM;
      const int v[10] = {1, GM, G_STAGES, rt * (inner / GN), 1, rt * DxnPlan<D>::TILES,
                         wctas, SPLIT, W_STAGES, WPlan<D>::WN};
      for (int i = 0; i < 10; ++i) out[i] = v[i];
    }
  }
};

struct SmemOf {
  int which, out = 0;
  template <int D>
  void run() {
    if (which == 1) out = WPlan<D>::SMEM;
    else if constexpr (D <= FUSED_MAX) out = which == 0 ? SmemA<D>::total : 0;
    else out = which == 0 ? G_SMEM : DxnPlan<D>::SMEM;
  }
};

struct Launch {
  const void *x, *dy, *gamma, *beta, *w1, *b1, *w2;
  void *dx, *dgamma, *dbeta, *dw1, *db1, *dw2, *db2, *xn, *dhc, *act, *part;
  int m, inner;
  float eps;
  cudaStream_t stream;
  cudaError_t err = cudaSuccess;
  template <int D>
  void run() {
    err = launch_all<D>(x, dy, gamma, beta, w1, b1, w2, dx, dgamma, dbeta, dw1, db1, dw2, db2,
                        xn, dhc, act, part, m, inner, eps, stream);
  }
};

}  // namespace

extern "C" {

// The widths the backward kernels take, (least, most, step), and the widest
// d of the fused route (above it, the split route).
void wd_ln_geglu_ffn_bwd_d(int* out) {
  out[0] = D_MIN;
  out[1] = D_MAX;
  out[2] = D_STEP;
  out[3] = FUSED_MAX;
}

// The plan at (M, d, inner) into out[0..9]: the route (0 fused, 1 split); the
// row kernel's rows a tile, ring stages, CTAs and cluster size (A's; on the
// split route S1's, cluster 1); S2's CTAs (0 on the fused route); the weight
// kernel's CTAs, cluster size (M split), ring stages and column tile. Returns
// 0, or cudaErrorInvalidValue for M < 1 or a width the kernels do not take.
int wd_ln_geglu_ffn_bwd_plan(int m, int d, int inner, int* out) {
  if (m < 1 || inner <= 0 || inner % 64) return cudaErrorInvalidValue;
  PlanOf f{m, inner, out};
  return with_width(d, f) ? 0 : cudaErrorInvalidValue;
}

// The dynamic shared memory of a CTA at width d, bytes: of the row kernel (A,
// or S1 on the split route; which = 0), the weight-gradient kernel (1) or S2
// (2; 0 on the fused route). 0 for a width the kernels do not take.
int wd_ln_geglu_ffn_bwd_smem(int which, int d) {
  SmemOf f{which};
  return with_width(d, f) ? f.out : 0;
}

// fp32 elements of the partial-sum scratch at M rows.
long long wd_ln_geglu_ffn_bwd_part_floats(int m, int d, int inner) {
  if (m <= 0) return 0;
  if (d > FUSED_MAX) return split_parts(m).floats(m, d, inner);
  const RowsPlan p = rows_plan(m, inner);
  return (long long)p.ctas() * 3 * d + (long long)p.tiles * 2 * inner;
}

// Launches the kernels of d's route on `stream`; returns the CUDA error code (0
// on success): a shape they do not take (d not a multiple of 64 in 64..768,
// inner not a positive multiple of 64), a tensor map cuTensorMapEncodeTiled
// refuses, or a launch the device refuses. Weights in parameter layout (w1
// [2 inner, d], w2 [d, inner]); dw1 [2 inner, d] and dw2 [d, inner] come back
// so. Scratch: xn [M, d], dhc [M, 2 inner], act [M, inner] (bf16) and part
// (wd_ln_geglu_ffn_bwd_part_floats fp32), all written before they are read;
// every tensor 16-byte aligned.
int wd_ln_geglu_ffn_bwd(const void* x, const void* dy, const void* gamma, const void* beta,
                        const void* w1, const void* b1, const void* w2, void* dx, void* dgamma,
                        void* dbeta, void* dw1, void* db1, void* dw2, void* db2, void* xn,
                        void* dhc, void* act, void* part, int M, int d, int inner, float eps,
                        void* stream) {
  if (M <= 0) return cudaSuccess;
  if (inner <= 0 || inner % 64) return cudaErrorInvalidValue;
  Launch f{x, dy, gamma, beta, w1, b1, w2, dx, dgamma, dbeta, dw1, db1, dw2, db2, xn, dhc, act,
           part, M, inner, eps, static_cast<cudaStream_t>(stream)};
  return with_width(d, f) ? f.err : cudaErrorInvalidValue;
}

}  // extern "C"
