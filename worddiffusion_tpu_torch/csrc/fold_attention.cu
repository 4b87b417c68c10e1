// Context-folded attention sub-layer, by hand for Hopper (sm_90a):
//
//   y = x + sum_h softmax(LN(x) . wt_h) . vw_h + b_out
//
// Replaces two Pallas TPU kernels that compute this one function:
//   B.7 bench_kernels/attn_fold_pallas.py::_fold_attn_kernel, folds wt [B, C, H*L] and
//       vw [B, H*L, C];
//   B.8 bench_kernels/attn_fold_sublayer_pallas.py::_fold_attn_kernel, per-head folds
//       wt4 [B, H, C, L] and vw4 [B, H, L, C].
// The folds are per-sample effective weights built from the L context tokens
// (models/attention.py): wt_h = Wq_h . K_h^T * scale [C, L] and vw_h = V_h . Wout_h
// [L, C], so the q and out projections of a cross-attention disappear into them.
// The two layouts are one kernel: vw and vw4 are the same memory, and wt is read
// through its (sample, head, channel) strides with l contiguous, so B.7's
// [B, C, H*L] is the strided view [B, H, C, L] of the same bytes.
//
// Arithmetic (the TPU bodies' dtype contract), x and y [B, N, C] bf16:
//   xn  = bf16((x - mean) * rsqrt(var + eps) * gamma + beta)   fp32 statistics
//   s_h = xn . wt_h                                            fp32 accumulate
//   p_h = bf16(softmax(s_h))                                   fp32, over the L columns
//   y   = bf16(x + sum_h p_h . vw_h + b_out)                   fp32 sum, one rounding
// B.8 sums the heads in fp32 one after another, B.7 contracts over H*L in one dot;
// here each head's product accumulates in fp32 registers and the heads' sums are
// added in head order. The orders differ only in fp32 rounding, far below the
// output's bf16 rounding; how the folds are loaded never changes the arithmetic,
// so the two layouts give the same bits.
//
// What bounds it on this card. At the iam UNet's shapes (C = 320, H = 4, L = 42,
// N = 256 or 64 tokens) the work is 4*B*N*C*H*L FLOP on B*N*C*2 bytes of x, as many
// of y, and 2*B*H*L*C*2 bytes of folds. At B = 128, N = 256: 7.0 GFLOP against
// 69 MB (x and y 42 MB, folds 27.5 MB), about 100 FLOP per byte, under the bf16
// ridge of about 295: memory-bound, 21 us at 3.35 TB/s (7.1 us of tensor work at
// 989 TFLOP/s). At B = 16 the bound is 2.6 us, where a launch's own latency and
// filling 132 SMs count. The plain composition launches about ten kernels and
// writes LN(x), the [N, H, L] scores and probabilities and the [N, C] product to
// memory between them; here none of them leaves the SM.
//
// At channel_mult (1, 2)'s middle block (C = 640, N = 64, H = 4, L = 42, folds
// padded to 48) and B = 128 the same count gives 84 MB (x and y 21 MB, folds
// 63 MB) against 3.6 us of tensor work: 25 us, memory-bound as well.
//
// Design (the parts of attention.cu's B.4, csrc/hopper.cuh):
//   - a CTA is a consumer warpgroup and a producer warpgroup, one CTA an SM
//     (227 KB of shared memory, 255 registers a thread, so setmaxnreg has
//     nothing to move); the producer's thread 0 issues every load as a TMA box
//     into shared memory completing on an mbarrier;
//   - the work is units of 64-row tiles, and the CTAs are persistent, as many
//     as are resident (one an SM), each walking its units, so that the
//     producer runs ahead into the next tile. At B = 16 that leaves SMs idle
//     (64 CTAs at N = 256, 16 at N = 64); splitting a tile's heads across a
//     cluster of 2 or 4 CTAs, their fp32 partials summed through distributed
//     shared memory, gave more SMs work but read slower at both shapes (the
//     partials' round trip and the cluster's barriers; PERF.md), so there is
//     one launch policy;
//   - shared memory: two x tiles (the next tile's x lands in one while the
//     consumer works in the other) and a ring of head stages (2 at L = 42), each
//     wt_h and vw_h with a full and an empty barrier apiece, so that the next
//     head's wt lands behind this head's softmax and p . vw, and its vw behind
//     the next score product. x, xn, y and vw_h are in 64-column atoms with the
//     128-byte swizzle; wt_h, whose LP columns (L rounded up to 16) are the
//     score product's N, in 16-column panels with the 32-byte swizzle, so that
//     N is 48 and not a 64-column atom (the 32 score registers of N = 64 pushed
//     the consumer's o into local memory);
//   - the consumer, per tile: o [64, 320] fp32 in registers starts as x + b_out,
//     read from the raw tile; the LayerNorm in place (two passes for the
//     statistics, one to write); then per head the score product s_h = xn .
//     wt_h on wgmma (m64 x LP x k16 over C / 16 steps, both operands in shared
//     memory), the exact fp32 softmax of the row's L columns in registers
//     (columns past L score -inf, LP <= 80, no online rescaling), p rounded to
//     bf16 in the score registers, which are the layout of wgmma's register A
//     operand, and o += p_h . vw_h on wgmma (m64 x (128, 128, 64) x k16 over
//     LP / 16 steps); then y = bf16(o) into the tile's own buffer and TMA
//     stores (rows past N clipped);
//   - TMA needs the folds' global strides in multiples of 16 bytes, and a box
//     whose first column starts off a 16-byte boundary faults (B.7's head h at
//     column h * 42 of its [B, C, H*L] rows did, on the H100): wt4 with its L
//     stride a multiple of 8 (build_folds pads it to 48 for L = 42) is read
//     through a rank-4 map [B, H, C, L]; any other wt4 (B.7's layout, the
//     contiguous L = 42 layout, an odd L) is copied by the producer
//     warpgroup's 128 threads into the same panels. vw4 is contiguous, so
//     always TMA;
//   - a narrower width (C % 16 == 0, C < 320) runs as C = 320 with the
//     columns past C zero: the tensor maps have C columns, so TMA fills the
//     rest of every box with zeros and clips the stores, and the LayerNorm
//     takes its statistics over the C columns only. The padding adds zeros
//     to the sums, and costs the full width's work;
//   - 320 < C <= 640 (channel_mult (1, 2)'s middle block is 640) runs the
//     wide kernel as C = 640, padded as above (C = 336 does 640's work, 1.9
//     times its own). o [64, 640] fp32 would be 320 registers a thread of one
//     warpgroup, so two consumer warpgroups each hold [64, 320] of it, the
//     narrow kernel's register tile, and both compute every head's scores
//     over all C (the score product is as large as a warpgroup's own p . vw_h;
//     the duplicate costs tensor work that the memory bound hides, and spares
//     a barrier a head to share p). A third warpgroup or even one producer
//     warp would cap every thread at 168 registers (a CTA of 9 to 12 warps
//     has 3 on one of the SM's four register partitions: ptxas spilled o and
//     serialised the products, C7512), so the wide CTA is the two consumer
//     warpgroups alone, 255 registers a thread, and consumer thread 0 issues
//     the TMA loads: each slot's next load once all eight warps have released
//     it. The x tile is 80 KB, so there is one x buffer (the next tile's x
//     lands once the tile's store has read it; at (1, 2)'s shapes a CTA has
//     one tile) and a ring of slots of one wt_h or one vw_h each (C * LP * 2
//     bytes, a head's wt and vw consecutive loads): 2 at L <= 48 (6 at L <=
//     16), 1 at L = 64 and 80, where a head stage no longer fits beside x and
//     each load waits for the product before it. wt4 must come by TMA: the
//     wrapper (ops/fold_attention.py) gives a layout the tensor map cannot
//     read (B.7's rows, an odd L) the L stride build_folds gives, one copy.
// The residual joins the fp32 sum first (o = x + b_out, then each head's
// product in head order), one rounding at the end, as the contract above: the
// association differs from B.8's body, (x + sum_h) + b_out, only in fp32
// rounding. Bitwise repeatable: no atomics, and every sum's order is fixed,
// whatever the route of wt's loads.
//
// The host encodes the tensor maps with hopper.cuh's encode (the driver's
// cuTensorMapEncodeTiled through the runtime, no -lcuda, cached per host
// thread).

#include <cuda.h>  // CUtensorMap and the encode's enums (header only)
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <initializer_list>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int C = 320;      // the register tile's width: o [64, C] fp32 is the consumer's
                            // registers (a narrower width runs padded to it)
constexpr int C_WIDE = 640;  // the wide kernel's: two consumer warpgroups of C columns each
constexpr int MAX_L = 80;   // = C / H at the UNet's widths: one head per 80 channels
constexpr int BM = 64;      // rows a tile: one wgmma M
constexpr int ATOMS = C / 64;         // 64-column atoms of the 128-byte swizzle across C
constexpr int ATOM = BM * 128;        // an x tile's atom: [64 rows][64] bf16
constexpr int XN_BYTES = BM * C * 2;  // an x tile: ATOMS atoms
constexpr int WT_BOX = C / 2;         // rows of a wt box (a box has at most 256)
constexpr int THREADS = 256;          // the consumer warpgroup, then the producer's
constexpr int CONS_BAR = 1, PROD_BAR = 2;  // named barriers of each warpgroup
constexpr int SMEM = 232448;  // a CTA's most: one CTA an SM
constexpr int MAX_STAGES = 4;

// How wt reaches shared memory: TMA boxes of a rank-4 map [B, H, C, L], or
// copies by the producer's threads.
enum WtMode { WT_TMA = 0, WT_COPY = 1 };

// Shared memory of a CTA, bytes from a 1024-byte aligned base: two x tiles
// (x lands in one, is normalised in place into xn and, after the tile's last
// score product, holds y for the TMA store, while the next tile's x lands in
// the other); then the ring's head stages, each wt_h [C][LP] and vw_h [LP][C],
// as many as fit;
// then the barriers (x full 2, x empty 2; per stage wt full, wt empty, vw
// full, vw empty). x, xn and vw_h are in 64-column atoms of [rows][64] bf16
// with the 128-byte swizzle (TMA's, and the one wgmma reads): the 16-byte
// chunk j of row r is stored at chunk j ^ (r % 8); wt_h, whose LP columns are
// the scores' N, in 16-column panels of [C][16] with the 32-byte swizzle
// (chunk j ^ (r / 4) % 2), so that N is LP and not a whole 64-column atom
// (the 32 score registers of N = 64 spilled the consumer's o).
struct Smem {
  int wt, vw, stage, nst, stages, bars, size;
};

__host__ __device__ constexpr Smem smem_layout(int lp) {
  Smem s{};
  s.wt = C * lp * 2;
  s.vw = lp * C * 2;
  s.stage = s.wt + s.vw;
  s.stages = 2 * XN_BYTES;
  const int n = (SMEM - 1024 - 8 * (4 + 4 * MAX_STAGES) - s.stages) / s.stage;
  s.nst = n > MAX_STAGES ? MAX_STAGES : n;
  s.bars = s.stages + s.nst * s.stage;
  s.size = s.bars + 8 * (4 + 4 * s.nst) + 1024;  // + the base's alignment
  return s;
}

// The four threads of a quad (t = 0..3) hold one row between them.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Byte offset of element (r, c) (c < 64) in a [rows][64] atom, 128-byte swizzle.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// Descriptor of an MN-major matrix in 64-column atoms `lbo` bytes apart,
// 128-byte swizzle (8-row groups of 1024 bytes along K).
__device__ __forceinline__ uint64_t desc_mn(const void* p, uint32_t lbo) {
  return make_desc(p, lbo, 1024, SW128);
}

// Descriptor of an MN-major matrix in 16-column panels `lbo` bytes apart,
// 32-byte swizzle (8-row groups of 256 bytes along K).
__device__ __forceinline__ uint64_t desc_mn32(const void* p, uint32_t lbo) {
  return make_desc(p, lbo, 256, SW32);
}

// Byte offset of 16-byte chunk j (0, 1) of row r of a 32-byte swizzled panel.
__device__ __forceinline__ int chunk32(int r, int j) {
  return r * 32 + ((j ^ (r >> 2)) & 1) * 16;
}

// wt_h [c x l] (element (r, j) at wth[r * sc + j]) into a stage's wt panels,
// columns past l and rows past c zero, by the producer warpgroup's 128 threads: 8 columns a
// thread and step, read 4 bytes at a time where wt's rows start on 4-byte
// boundaries (B.7's layout and the contiguous one at an even L), else 2;
// 16-byte stores.
template <int LP>
__device__ __forceinline__ void copy_wt(unsigned char* dst, const bf16* wth, long long sc, int c,
                                        int l, int pt) {
  constexpr int Q = LP / 8;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(wth);
  const bool pairs = ((reinterpret_cast<uintptr_t>(wth) | uintptr_t(sc * 2)) & 3) == 0;
#pragma unroll 4
  for (int i = pt; i < C * Q; i += 128) {
    const int r = i / Q, q = i % Q;
    const unsigned short* row = src + r * sc + 8 * q;
    const int lr = r < c ? l : 0;  // the row's columns to read
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * q + 2 * e;
      if (pairs && j + 1 < lr) {
        w[e] = *reinterpret_cast<const uint32_t*>(row + 2 * e);
      } else {
        const uint32_t lo = j < lr ? row[2 * e] : 0u, hi = j + 1 < lr ? row[2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
    }
    *reinterpret_cast<uint4*>(dst + (q >> 1) * C * 32 + chunk32(r, q & 1)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The producer warpgroup, unit after unit: thread 0 issues the CTA's i-th
// unit's x tile into x buffer i % 2 once the store of the tile before last has
// read it, then each head's wt_h and vw_h into the next head stage, each after
// its empty barrier. The copy route copies wt_h with all 128 threads.
template <int LP>
__device__ __forceinline__ void produce(unsigned char* sm, const CUtensorMap* xmap,
                                        const CUtensorMap* wtmap, const CUtensorMap* vwmap,
                                        const bf16* __restrict__ wt, long long wt_sb,
                                        long long wt_sh, long long wt_sc, int c, int heads,
                                        int l, int wt_mode, int units, int groups) {
  constexpr Smem S = smem_layout(LP);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(sm + S.bars);
  uint64_t* xempty = xfull + 2;
  uint64_t* wfull = xfull + 4;
  uint64_t* wempty = wfull + S.nst;
  uint64_t* vfull = wempty + S.nst;
  uint64_t* vempty = vfull + S.nst;
  const int pt = threadIdx.x - 128;
  int m = 0, i = 0;  // heads and units so far
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int b = u / groups, row0 = (u % groups) * BM, xb = i & 1;
    if (pt == 0) {
      wait_phase(xempty + xb, ((i >> 1) & 1) ^ 1);
      mbar_expect_tx(xfull + xb, XN_BYTES);
      for (int a = 0; a < ATOMS; ++a)
        tma_load_3d(sm + xb * XN_BYTES + a * ATOM, xmap, xfull + xb, 64 * a, row0, b);
    }
    for (int h = 0; h < heads; ++h, ++m) {
      const int st = m % S.nst;
      const uint32_t parity = ((m / S.nst) & 1) ^ 1;
      unsigned char* wd = sm + S.stages + st * S.stage;
      unsigned char* vd = wd + S.wt;
      if (wt_mode == WT_COPY) {
        wait_phase(wempty + st, parity);
        copy_wt<LP>(wd, wt + b * wt_sb + h * wt_sh, wt_sc, c, l, pt);
        fence_proxy_async();  // this thread's stores, visible to wgmma
        bar_sync(PROD_BAR, 128);
        if (pt == 0) mbar_arrive(wfull + st);
      } else if (pt == 0) {  // wt_h: LP / 16 panels of two boxes of WT_BOX rows
        wait_phase(wempty + st, parity);
        mbar_expect_tx(wfull + st, S.wt);
        for (int q = 0; q < 2 * (LP / 16); ++q)
          tma_load_4d(wd + (q >> 1) * C * 32 + (q & 1) * WT_BOX * 32, wtmap, wfull + st,
                      16 * (q >> 1), (q & 1) * WT_BOX, h, b);
      }
      if (pt == 0) {  // vw_h: ATOMS atoms of [LP][64]
        wait_phase(vempty + st, parity);
        mbar_expect_tx(vfull + st, S.vw);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_4d(vd + a * LP * 128, vwmap, vfull + st, 64 * a, 0, h, b);
      }
    }
  }
}

// LayerNorm of an x tile of CW columns in place (rows past n arrive as zeros
// and are computed on, not stored): lane l of warp w (of NWG warpgroups' 4
// NWG warps) takes rows (16 / NWG) w + 4 q + l / 8 (q < 4 / NWG), each the
// 8-column chunk l % 8 of every atom, so that a warp's 16-byte reads of an
// atom are 512 contiguous bytes; fp32 statistics in two passes over shared
// memory (the mean, then the centred squares), then a third that writes, a
// lane's rows side by side, so that few registers are live beside o. Columns
// past c (zeros) are left out of the statistics and left zero.
template <int CW, int NWG>
__device__ __forceinline__ void layer_norm(unsigned char* xn, const float* __restrict__ gamma,
                                           const float* __restrict__ beta, float eps, int c,
                                           int warp, int lane) {
  constexpr int NA = CW / 64, RQ = 4 / NWG;
  const int c8 = lane & 7, r0 = (16 / NWG) * warp + (lane >> 3);
  float mu[RQ], rs[RQ];
#pragma unroll
  for (int q = 0; q < RQ; ++q) mu[q] = rs[q] = 0.f;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(xn + a * ATOM + sw128(r0 + 4 * q, 8 * c8)), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) mu[q] += f[e];
    }
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
    mu[q] += __shfl_xor_sync(0xffffffffu, mu[q], 1);
    mu[q] += __shfl_xor_sync(0xffffffffu, mu[q], 2);
    mu[q] += __shfl_xor_sync(0xffffffffu, mu[q], 4);
    mu[q] /= float(c);
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    if (64 * a + 8 * c8 >= c) continue;
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(xn + a * ATOM + sw128(r0 + 4 * q, 8 * c8)), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) rs[q] += (f[e] - mu[q]) * (f[e] - mu[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
    rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], 1);
    rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], 2);
    rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], 4);
    rs[q] = rsqrtf(rs[q] / float(c) + eps);
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int c0 = 64 * a + 8 * c8;
    if (c0 >= c) continue;
    const float4 g0 = __ldg(reinterpret_cast<const float4*>(gamma + c0));
    const float4 g1 = __ldg(reinterpret_cast<const float4*>(gamma + c0 + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(beta + c0));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(beta + c0 + 4));
    const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      uint4* at = reinterpret_cast<uint4*>(xn + a * ATOM + sw128(r0 + 4 * q, 8 * c8));
      float f[8], y[8];
      unpack8(*at, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = (f[e] - mu[q]) * rs[q] * gm[e] + bt[e];
      *at = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                       pack_bf16(y[6], y[7]));
    }
  }
}

// One arrival of each consumer warp (lane 0) on an empty barrier.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
  __syncwarp();
}

// A full barrier's phase, then the warp converged for the wgmma that follow.
__device__ __forceinline__ void wait_full(uint64_t* bar, uint32_t parity) {
  wait_phase(bar, parity);
  __syncwarp();
}

// The columns of o's three accumulators: [0, 128), [128, 256), [256, 320).
constexpr int O_A = 0, O_B = 128, O_C = 256;

// fn(col, d0, d1, d2, d3) for each 8-column group of the thread's fragment of
// o, by reference (d0, d1: row g, columns col, col + 1; d2, d3: row g + 8).
template <typename Fn>
__device__ __forceinline__ void for_fragment(float (&oa)[64], float (&ob)[64], float (&oc)[32],
                                             int t, Fn fn) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    fn(O_A + 8 * j + 2 * t, oa[4 * j], oa[4 * j + 1], oa[4 * j + 2], oa[4 * j + 3]);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    fn(O_B + 8 * j + 2 * t, ob[4 * j], ob[4 * j + 1], ob[4 * j + 2], ob[4 * j + 3]);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    fn(O_C + 8 * j + 2 * t, oc[4 * j], oc[4 * j + 1], oc[4 * j + 2], oc[4 * j + 3]);
}

// The bf16 pair at (r, col), (r, col + 1) of an x tile, as fp32.
__device__ __forceinline__ float2 pair_at(const unsigned char* xt, int r, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      xt + (col >> 6) * ATOM + sw128(r, col & 63)));
}

// A consumer warpgroup's pieces, shared by the narrow and the wide kernel; the
// warpgroup holds o's 320 columns from cw0 (0 in the narrow kernel), the
// thread rows r0 and r0 + 8 of them.

// o = x + b_out, from the raw tile before it is normalised in place.
__device__ __forceinline__ void init_o(float (&oa)[64], float (&ob)[64], float (&oc)[32],
                                       const unsigned char* xt, const float* __restrict__ bo,
                                       int c, int r0, int t, int cw0) {
  for_fragment(oa, ob, oc, t, [&](int col, float& d0, float& d1, float& d2, float& d3) {
    col += cw0;
    const float2 bv = col < c ? __ldg(reinterpret_cast<const float2*>(bo + col))
                              : make_float2(0.f, 0.f);
    const float2 x0 = pair_at(xt, r0, col), x1 = pair_at(xt, r0 + 8, col);
    d0 = x0.x + bv.x;
    d1 = x0.y + bv.y;
    d2 = x1.x + bv.x;
    d3 = x1.y + bv.y;
  });
}

// y = bf16(o) into the tile.
__device__ __forceinline__ void store_y(float (&oa)[64], float (&ob)[64], float (&oc)[32],
                                        unsigned char* xt, int r0, int t, int cw0) {
  for_fragment(oa, ob, oc, t, [&](int col, float& d0, float& d1, float& d2, float& d3) {
    col += cw0;
    unsigned char* at = xt + (col >> 6) * ATOM;
    *reinterpret_cast<uint32_t*>(at + sw128(r0, col & 63)) = pack_bf16(d0, d1);
    *reinterpret_cast<uint32_t*>(at + sw128(r0 + 8, col & 63)) = pack_bf16(d2, d3);
  });
}

// s = xn . wt_h over the tile's CW columns: CW / 16 steps of m64 x LP x k16;
// xn K-major, wt_h MN-major (panels CW * 32 bytes apart); waited for.
template <int CW, int LP>
__device__ __forceinline__ void scores(float (&s)[LP / 2], const unsigned char* xn,
                                       const unsigned char* ws) {
  const uint64_t wd = desc_mn32(ws, CW * 32);
  pin(s);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < CW / 16; ++k)
    wgmma_ss<0, 1>(s, make_desc_sw128(xn + (k >> 2) * ATOM + (k & 3) * 32),
                   wd + ((k * 16 * 32) >> 4), k > 0);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
}

// The exact fp32 softmax over the row's l columns (s[4j..4j+1] row g,
// s[4j+2..] row g + 8, columns 8j + 2t, + 1), in bf16 into p as p . vw's A
// fragments: n-tiles 2kb and 2kb + 1 are keys 16kb .. + 15.
template <int LP>
__device__ __forceinline__ void softmax_p(float (&s)[LP / 2], uint32_t (&p)[LP / 16][4], int l,
                                          int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < LP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= l) s[4 * j] = s[4 * j + 2] = -INFINITY;
    if (col + 1 >= l) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < LP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = __expf(s[4 * j + e] - mx[e >> 1]);
      sum[e >> 1] += s[4 * j + e];
    }
  const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
  for (int kb = 0; kb < LP / 16; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[kb][e] = pack_bf16(s[8 * kb + 2 * e] * inv[e & 1], s[8 * kb + 2 * e + 1] * inv[e & 1]);
}

// o += p . vw_h: LP / 16 steps of m64 x (128, 128, 64) x k16 on the 5 atoms
// of vw_h at vd (MN-major, atoms LP * 128 bytes apart); waited for.
template <int LP>
__device__ __forceinline__ void add_pv(float (&oa)[64], float (&ob)[64], float (&oc)[32],
                                       uint32_t (&p)[LP / 16][4], uint64_t vd) {
  pin(oa);
  pin(ob);
  pin(oc);
#pragma unroll
  for (int kb = 0; kb < LP / 16; ++kb) pin(p[kb]);
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < LP / 16; ++kb) {
    const uint64_t k0 = (kb * 16 * 128) >> 4;
    wgmma_rs<1>(oa, p[kb], vd + k0, 1);
    wgmma_rs<1>(ob, p[kb], vd + k0 + ((2 * LP * 128) >> 4), 1);
    wgmma_rs<1>(oc, p[kb], vd + k0 + ((4 * LP * 128) >> 4), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(oa);
  pin(ob);
  pin(oc);
}

// grid: persistent CTAs (as many as are resident at once), each walking its
// units; threads 0..127 consume, 128..255 produce; y leaves by TMA stores.
template <int LP>
__global__ void __launch_bounds__(THREADS, 1)
    fold_attention_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wtmap,
                          const __grid_constant__ CUtensorMap vwmap,
                          const __grid_constant__ CUtensorMap omap,
                          const bf16* __restrict__ wt, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const float* __restrict__ bo, int c,
                          int heads, int l, long long wt_sb, long long wt_sh, long long wt_sc,
                          float eps, int wt_mode, int units, int groups) {
  constexpr Smem S = smem_layout(LP);
  static_assert(S.nst >= 1 && S.size <= SMEM, "the ring fits");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(sm + S.bars);
  uint64_t* xempty = xfull + 2;
  uint64_t* wfull = xfull + 4;
  uint64_t* wempty = wfull + S.nst;
  uint64_t* vfull = wempty + S.nst;
  uint64_t* vempty = vfull + S.nst;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(xfull + i, 1);   // the producer's expect_tx
      mbar_init(xempty + i, 1);  // consumer thread 0, once the tile's store has read it
    }
    for (int i = 0; i < S.nst; ++i) {
      mbar_init(wfull + i, 1);  // the producer's arrival
      mbar_init(vfull + i, 1);
      mbar_init(wempty + i, 4);  // each consumer warp
      mbar_init(vempty + i, 4);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    produce<LP>(sm, &xmap, &wtmap, &vwmap, wt, wt_sb, wt_sh, wt_sc, c, heads, l, wt_mode, units,
                groups);
    return;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  float s[LP / 2], oa[64], ob[64], oc[32];
  uint32_t p[LP / 16][4];
#pragma unroll
  for (int i = 0; i < LP / 2; ++i) s[i] = 0.f;
  int m = 0, i = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int b = u / groups, row0 = (u % groups) * BM;
    unsigned char* xn = sm + (i & 1) * XN_BYTES;
    wait_phase(xfull + (i & 1), (i >> 1) & 1);
    // o starts as x + b_out, from the raw tile before it is normalised in place
    const int r0 = 16 * warp + g;
    init_o(oa, ob, oc, xn, bo, c, r0, t, 0);
    __syncwarp();  // the warp's rows are read before its lanes normalise them
    layer_norm<C, 1>(xn, gamma, beta, eps, c, warp, lane);
    fence_proxy_async();  // xn's stores, visible to wgmma
    bar_sync(CONS_BAR, 128);
    for (int h = 0; h < heads; ++h, ++m) {
      const int st = m % S.nst;
      const uint32_t parity = (m / S.nst) & 1;
      const unsigned char* ws = sm + S.stages + st * S.stage;
      const unsigned char* vs = ws + S.wt;
      wait_full(wfull + st, parity);
      scores<C, LP>(s, xn, ws);
      release(wempty + st, lane);
      softmax_p<LP>(s, p, l, t);
      wait_full(vfull + st, parity);
      add_pv<LP>(oa, ob, oc, p, desc_mn(vs, LP * 128));
      release(vempty + st, lane);
      if (h == 0 && i > 0 && tid == 0) {
        // the last tile's store has read its x buffer: the tile after this may land there
        bulk_wait_read<0>();
        mbar_arrive(xempty + ((i - 1) & 1));
      }
    }
    // y = bf16(o) into xn, its last reader (the score products) done in every
    // warp; then TMA stores, rows past n clipped
    bar_sync(CONS_BAR, 128);
    store_y(oa, ob, oc, xn, r0, t, 0);
    fence_proxy_async();  // y's stores, visible to the TMA store
    bar_sync(CONS_BAR, 128);
    if (tid == 0) {
      for (int a = 0; a < ATOMS; ++a) tma_store_3d(&omap, xn + a * ATOM, 64 * a, row0, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();
}

// --- the wide kernel: 320 < C <= 640 ---

// Shared memory of a wide CTA, bytes from a 1024-byte aligned base: the x tile
// [64][640] (10 atoms), then NS slots of C_WIDE * LP * 2 bytes (a wt_h in LP /
// 16 panels, or a vw_h in 10 atoms, as the narrow kernel's), as many pairs as
// fit (at most MAX_STAGES), else as many slots; then the barriers (x full;
// full, empty per slot).
struct WideSmem {
  int slot, ns, bars, size;
};

__host__ __device__ constexpr WideSmem wide_layout(int lp) {
  WideSmem s{};
  s.slot = C_WIDE * lp * 2;
  const int avail = SMEM - 1024 - 8 * (1 + 4 * MAX_STAGES) - BM * C_WIDE * 2;
  const int pairs = avail / (2 * s.slot);
  s.ns = pairs >= 1 ? 2 * (pairs > MAX_STAGES ? MAX_STAGES : pairs) : avail / s.slot;
  s.bars = BM * C_WIDE * 2 + s.ns * s.slot;
  s.size = s.bars + 8 * (1 + 2 * s.ns) + 1024;  // + the base's alignment
  return s;
}

// Slot load j of a wide CTA (two a head of each of its units: wt_h, then
// vw_h), by TMA into slot j % NS, completing on its full barrier; nothing past
// the CTA's last unit. The caller has seen the slot's last load released.
template <int LP>
__device__ __forceinline__ void wide_load(unsigned char* sm, const CUtensorMap* wtmap,
                                          const CUtensorMap* vwmap, uint64_t* full, int j,
                                          int heads, int units, int groups) {
  constexpr WideSmem S = wide_layout(LP);
  const int i = j / (2 * heads), h = (j / 2) % heads;
  const int u = blockIdx.x + i * gridDim.x;
  if (u >= units) return;
  const int b = u / groups, slot = j % S.ns;
  unsigned char* dst = sm + BM * C_WIDE * 2 + slot * S.slot;
  mbar_expect_tx(full + slot, S.slot);
  if (j % 2 == 0) {  // wt_h: LP / 16 panels of NB boxes of WT_BOX rows
    constexpr int NB = C_WIDE / WT_BOX;
    for (int q = 0; q < NB * (LP / 16); ++q)
      tma_load_4d(dst + (q / NB) * C_WIDE * 32 + (q % NB) * WT_BOX * 32, wtmap, full + slot,
                  16 * (q / NB), (q % NB) * WT_BOX, h, b);
  } else {  // vw_h: 10 atoms of [LP][64]
    for (int a = 0; a < C_WIDE / 64; ++a)
      tma_load_4d(dst + a * LP * 128, vwmap, full + slot, 64 * a, 0, h, b);
  }
}

// As slot load j once every consumer warp has released the slot's last load.
template <int LP>
__device__ __forceinline__ void wide_refill(unsigned char* sm, const CUtensorMap* wtmap,
                                            const CUtensorMap* vwmap, uint64_t* full,
                                            uint64_t* empty, int j, int loads, int heads,
                                            int units, int groups) {
  constexpr WideSmem S = wide_layout(LP);
  if (j >= loads) return;
  wait_phase(empty + j % S.ns, ((j / S.ns) & 1) ^ 1);
  wide_load<LP>(sm, wtmap, vwmap, full, j, heads, units, groups);
}

// grid: persistent CTAs as the narrow kernel's; 256 threads, warpgroup w the
// columns [320 w, 320 w + 320) of o; thread 0 also issues every TMA load (x,
// and each slot's next load after its release) and the stores.
template <int LP>
__global__ void __launch_bounds__(256, 1)
    fold_attention_wide_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap wtmap,
                               const __grid_constant__ CUtensorMap vwmap,
                               const __grid_constant__ CUtensorMap omap,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               const float* __restrict__ bo, int c, int heads, int l, float eps,
                               int units, int groups) {
  constexpr WideSmem S = wide_layout(LP);
  constexpr int X_BYTES = BM * C_WIDE * 2;
  static_assert(S.ns >= 1 && S.size <= SMEM, "the ring fits");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(sm + S.bars);
  uint64_t* full = xfull + 1;
  uint64_t* empty = full + S.ns;
  unsigned char* xn = sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int cw0 = C * (tid / 128);  // this warpgroup's first column of o
  const int mine = blockIdx.x < units ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int loads = 2 * heads * mine;
  if (tid == 0) {
    mbar_init(xfull, 1);
    for (int i = 0; i < S.ns; ++i) {
      mbar_init(full + i, 1);   // thread 0's expect_tx
      mbar_init(empty + i, 8);  // each consumer warp
    }
    fence_mbar_init();
    if (mine) {  // the first tile's x, and the ring's first loads
      mbar_expect_tx(xfull, X_BYTES);
      for (int a = 0; a < C_WIDE / 64; ++a)
        tma_load_3d(xn + a * ATOM, &xmap, xfull, 64 * a, (blockIdx.x % groups) * BM,
                    blockIdx.x / groups);
      for (int j = 0; j < S.ns && j < loads; ++j)
        wide_load<LP>(sm, &wtmap, &vwmap, full, j, heads, units, groups);
    }
  }
  __syncthreads();

  float s[LP / 2], oa[64], ob[64], oc[32];
  uint32_t p[LP / 16][4];
#pragma unroll
  for (int i = 0; i < LP / 2; ++i) s[i] = 0.f;
  int k = 0, i = 0;  // slot loads consumed and units so far
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int b = u / groups, row0 = (u % groups) * BM;
    wait_phase(xfull, i & 1);
    // o starts as x + b_out, from the raw tile before it is normalised in place
    const int r0 = 16 * (warp % 4) + g;
    init_o(oa, ob, oc, xn, bo, c, r0, t, cw0);
    bar_sync(CONS_BAR, 256);  // both warpgroups have read the raw rows
    layer_norm<C_WIDE, 2>(xn, gamma, beta, eps, c, warp, lane);
    fence_proxy_async();  // xn's stores, visible to wgmma
    bar_sync(CONS_BAR, 256);
    for (int h = 0; h < heads; ++h, k += 2) {
      const int sw = k % S.ns, sv = (k + 1) % S.ns;
      wait_full(full + sw, (k / S.ns) & 1);
      scores<C_WIDE, LP>(s, xn, sm + X_BYTES + sw * S.slot);  // over all 640 columns
      release(empty + sw, lane);
      softmax_p<LP>(s, p, l, t);
      // wt_h's slot takes its next load (the scores no longer live)
      if (tid == 0)
        wide_refill<LP>(sm, &wtmap, &vwmap, full, empty, k + S.ns, loads, heads, units, groups);
      // o += p . vw_h over this warpgroup's 5 atoms of the 10
      wait_full(full + sv, ((k + 1) / S.ns) & 1);
      add_pv<LP>(oa, ob, oc, p, desc_mn(sm + X_BYTES + sv * S.slot + (cw0 / 64) * LP * 128,
                                        LP * 128));
      release(empty + sv, lane);
      if (tid == 0)
        wide_refill<LP>(sm, &wtmap, &vwmap, full, empty, k + 1 + S.ns, loads, heads, units,
                        groups);
    }
    // y = bf16(o) into xn, its last reader (the score products) done in every
    // warp; then TMA stores, rows past n clipped; the next tile's x lands once
    // they have read it
    bar_sync(CONS_BAR, 256);
    store_y(oa, ob, oc, xn, r0, t, cw0);
    fence_proxy_async();  // y's stores, visible to the TMA store
    bar_sync(CONS_BAR, 256);
    if (tid == 0) {
      for (int a = 0; a < C_WIDE / 64; ++a) tma_store_3d(&omap, xn + a * ATOM, 64 * a, row0, b);
      bulk_commit();
      const int next = u + gridDim.x;
      if (next < units) {
        bulk_wait_read<0>();
        mbar_expect_tx(xfull, X_BYTES);
        for (int a = 0; a < C_WIDE / 64; ++a)
          tma_load_3d(xn + a * ATOM, &xmap, xfull, 64 * a, (next % groups) * BM, next / groups);
      }
    }
  }
  if (tid == 0) bulk_wait<0>();
}

int sm_count() {
  static std::atomic<int> cached[64];  // zero: not yet read
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 132;
  if (dev < 64 && cached[dev].load()) return cached[dev].load();
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;
  if (dev < 64) cached[dev].store(n);
  return n;
}

// The operands of a launch, as wd_fold_attention takes them.
struct Args {
  const void *x, *wt, *vw, *gamma, *beta, *bo;
  void* out;
  int b, n, c, heads, l;
  long long wt_sb, wt_sh, wt_sc;
  float eps;
};

bool valid(const Args& a) {
  return a.b >= 1 && a.b <= 65535 && a.n >= 1 && a.heads >= 1 && a.l >= 1 && a.l <= MAX_L &&
         a.heads * a.l <= a.c && a.c % 16 == 0 && a.c <= C_WIDE;
}

int lp_of(int l) { return (l + 15) / 16 * 16; }

int row_tiles(int n) { return (n + BM - 1) / BM; }

// How wt reaches shared memory, and its map: per head by TMA where every
// stride is a multiple of 8 elements and they do not overlap in the order l,
// c, h, b (a stride of a dimension of size 1 taken as the one it would have),
// else copies.
int wt_mode(const Args& a, CUtensorMap* map) {
  if (reinterpret_cast<uintptr_t>(a.wt) % 16) return WT_COPY;
  const long long sc = a.wt_sc;
  const long long sh = a.heads == 1 ? a.c * sc : a.wt_sh;
  const long long sb = a.b == 1 ? a.heads * sh : a.wt_sb;
  if (sc % 8 == 0 && sh % 8 == 0 && sb % 8 == 0 && sc >= a.l && sh >= a.c * sc &&
      sb >= a.heads * sh &&
      encode(map, map_key(a.wt, 4, {a.l, a.c, a.heads, a.b}, {2 * sc, 2 * sh, 2 * sb},
                      {16, WT_BOX, 1, 1}, CU_TENSOR_MAP_SWIZZLE_32B)))
    return WT_TMA;
  return WT_COPY;
}

// The CTAs of the instance (the narrow or the wide kernel at LP) resident at
// once on the device (one an SM by its shared memory), into *resident, once
// the instance may take its shared memory; read once per instance and device.
template <bool WIDE, int LP>
cudaError_t resident_ctas(int* resident) {
  static std::atomic<int> cached[64];  // zero: not yet read
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if ((*resident = cached[dev].load())) return cudaSuccess;
  int per_sm = 0;
  if constexpr (WIDE) {
    constexpr int size = wide_layout(LP).size;
    e = cudaFuncSetAttribute(fold_attention_wide_kernel<LP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, size);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_attention_wide_kernel<LP>,
                                                      256, size);
  } else {
    constexpr Smem S = smem_layout(LP);
    e = cudaFuncSetAttribute(fold_attention_kernel<LP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S.size);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_attention_kernel<LP>, THREADS,
                                                      S.size);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *resident = per_sm * sm_count();
  cached[dev].store(*resident);
  return cudaSuccess;
}

// The CTAs a launch at LP of `units` tiles takes: as many as are resident, at
// most one a tile; 0 on an error.
template <int LP>
int ctas(int units, bool wide) {
  int resident = 0;
  const cudaError_t e = wide ? resident_ctas<true, LP>(&resident)
                             : resident_ctas<false, LP>(&resident);
  return e == cudaSuccess ? std::min(units, resident) : 0;
}

// The maps of x, out (C columns: TMA fills the boxes' columns past a.c with
// zeros and clips the stores) and vw.
bool io_maps(const Args& a, int lp, CUtensorMap* xmap, CUtensorMap* vwmap, CUtensorMap* omap) {
  const long long c = a.c, nc = (long long)a.n * c, lc = (long long)a.l * c;
  return encode(xmap, map_key(a.x, 3, {c, a.n, a.b}, {2 * c, 2 * nc}, {64, BM, 1})) &&
         encode(omap, map_key(a.out, 3, {c, a.n, a.b}, {2 * c, 2 * nc}, {64, BM, 1})) &&
         encode(vwmap, map_key(a.vw, 4, {c, a.l, a.heads, a.b}, {2 * c, 2 * lc, 2 * lc * a.heads},
                               {64, lp, 1, 1}));
}

template <int LP>
cudaError_t launch(const Args& a, int mode, const CUtensorMap& wtmap, cudaStream_t stream) {
  constexpr Smem S = smem_layout(LP);
  CUtensorMap xmap, vwmap, omap;
  if (!io_maps(a, LP, &xmap, &vwmap, &omap)) return cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t err = resident_ctas<false, LP>(&resident);
  if (err != cudaSuccess) return err;
  const int groups = row_tiles(a.n), units = a.b * groups;
  fold_attention_kernel<LP><<<std::min(units, resident), THREADS, S.size, stream>>>(
      xmap, mode == WT_COPY ? xmap : wtmap, vwmap, omap, static_cast<const bf16*>(a.wt),
      static_cast<const float*>(a.gamma), static_cast<const float*>(a.beta),
      static_cast<const float*>(a.bo), a.c, a.heads, a.l, a.wt_sb, a.wt_sh, a.wt_sc, a.eps, mode,
      units, groups);
  return cudaGetLastError();
}

// The wide kernel reads wt by TMA only (a copy route is refused).
template <int LP>
cudaError_t launch_wide(const Args& a, int mode, const CUtensorMap& wtmap, cudaStream_t stream) {
  if (mode != WT_TMA) return cudaErrorInvalidValue;
  CUtensorMap xmap, vwmap, omap;
  if (!io_maps(a, LP, &xmap, &vwmap, &omap)) return cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t err = resident_ctas<true, LP>(&resident);
  if (err != cudaSuccess) return err;
  const int groups = row_tiles(a.n), units = a.b * groups;
  fold_attention_wide_kernel<LP><<<std::min(units, resident), 256, wide_layout(LP).size,
                                   stream>>>(
      xmap, wtmap, vwmap, omap, static_cast<const float*>(a.gamma),
      static_cast<const float*>(a.beta), static_cast<const float*>(a.bo), a.c, a.heads, a.l,
      a.eps, units, groups);
  return cudaGetLastError();
}

template <int LP>
cudaError_t launch_at(const Args& a, int mode, const CUtensorMap& wtmap, cudaStream_t s) {
  return a.c > C ? launch_wide<LP>(a, mode, wtmap, s) : launch<LP>(a, mode, wtmap, s);
}

cudaError_t run(const Args& a, int mode, const CUtensorMap& wtmap, cudaStream_t s) {
  switch (lp_of(a.l)) {
    case 16: return launch_at<16>(a, mode, wtmap, s);
    case 32: return launch_at<32>(a, mode, wtmap, s);
    case 48: return launch_at<48>(a, mode, wtmap, s);
    case 64: return launch_at<64>(a, mode, wtmap, s);
    case 80: return launch_at<80>(a, mode, wtmap, s);
    default: return cudaErrorInvalidValue;
  }
}

bool lp_taken(int c, int lp) {
  return lp >= 16 && lp <= MAX_L && lp % 16 == 0 && c >= 16 && c <= C_WIDE;
}

}  // namespace

extern "C" {

int wd_fold_attention_max_c() { return C_WIDE; }
int wd_fold_attention_max_l() { return MAX_L; }

// The dynamic shared memory of a CTA at width c and LP (L rounded up to 16), bytes.
int wd_fold_attention_smem(int c, int lp) {
  if (!lp_taken(c, lp)) return 0;
  return c > C ? wide_layout(lp).size : smem_layout(lp).size;
}

// Slots of a CTA's ring at width c and LP, each a wt_h or a vw_h (the narrow
// kernel's head stages are two slots each).
int wd_fold_attention_slots(int c, int lp) {
  if (!lp_taken(c, lp)) return 0;
  return c > C ? wide_layout(lp).ns : 2 * smem_layout(lp).nst;
}

// The persistent CTAs a launch at these shapes takes (0 on an error).
int wd_fold_attention_ctas(int b, int n, int c, int l) {
  const int units = b * row_tiles(n);
  const bool wide = c > C;
  if (c < 16 || c > C_WIDE) return 0;
  switch (lp_of(l)) {
    case 16: return ctas<16>(units, wide);
    case 32: return ctas<32>(units, wide);
    case 48: return ctas<48>(units, wide);
    case 64: return ctas<64>(units, wide);
    case 80: return ctas<80>(units, wide);
    default: return 0;
  }
}

// How wt reaches shared memory at these shapes and strides: 0 TMA, 1 copies by
// the producer's threads (c <= 320; the wide kernel takes TMA only).
int wd_fold_attention_wt_mode(const void* wt, int b, int heads, int c, int l, long long wt_sb,
                              long long wt_sh, long long wt_sc) {
  const Args a{nullptr, wt, nullptr, nullptr, nullptr, nullptr, nullptr, b, 1, c, heads, l,
               wt_sb, wt_sh, wt_sc, 0.f};
  if (!valid(a)) return -1;
  CUtensorMap map;
  return wt_mode(a, &map);
}

// out [b, n, c] = x + sum_h softmax(LN(x) . wt_h) . vw_h + bo, with x and out bf16
// [b, n, c] contiguous and 16-byte aligned; wt bf16, element (b, h, c, l) at
// b*wt_sb + h*wt_sh + c*wt_sc + l (above c = 320 in a layout the tensor map
// reads: wd_fold_attention_wt_mode 0); vw bf16 [b, heads, l, c] contiguous and
// 16-byte aligned; gamma, beta, bo fp32 [c], 16-byte aligned. Needs c % 16 == 0,
// c <= 640, 1 <= l <= MAX_L and heads * l <= c. Returns a cudaError_t (0 on
// success; a failed tensor-map encode is cudaErrorInvalidValue).
int wd_fold_attention(const void* x, const void* wt, const void* vw, const void* gamma,
                      const void* beta, const void* bo, void* out, int b, int n, int c,
                      int heads, int l, long long wt_sb, long long wt_sh, long long wt_sc,
                      float eps, void* stream) {
  const Args a{x, wt, vw, gamma, beta, bo, out, b, n, c, heads, l, wt_sb, wt_sh, wt_sc, eps};
  if (!valid(a)) return cudaErrorInvalidValue;
  CUtensorMap wtmap;
  const int mode = wt_mode(a, &wtmap);
  return run(a, mode, wtmap, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
