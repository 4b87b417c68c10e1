// Fused LayerNorm + GEGLU feed-forward + residual, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel worddiffusion_tpu/ops/ffn_pallas.py::_ln_ffn_kernel
// (reached through _ln_geglu_ffn_pallas -> _run_ffn_pallas -> pl.pallas_call). For
// x [M, d] bf16, gamma/beta [d] fp32, the weights in the port's parameter layout
// W1 [2*inner, d] bf16 (proj.weight: a rows, then g rows) and W2 [d, inner] bf16
// (out.weight), b1 [2*inner] fp32 and b2 [d] fp32 (all contiguous):
//
//   xn      = bf16((x - mean) * rsqrt(var + eps) * gamma + beta)   fp32 two-pass stats
//   [a | g] = xn . W1^T + b1                                         fp32 accumulate
//   act     = bf16(a * gelu_tanh(g))
//   out     = bf16(fp32(x) + act . W2^T + b2)
//
// The widths: every d = 64k from 64 to 768 and any inner % 64 == 0, the range
// in which the TPU kernel runs the UNet's FF (ffn_pallas.py::fits_vmem(d, 4d) is
// true for each such d and false from 832 on; ops/ffn.py::kernel_takes).
//
// What bounds it on this card: operations. At the flagship width (d = 320,
// inner = 1280) it does 6*M*d*inner operations (80.5 GFLOP at M = 32768)
// against the x-in and out streams and 2.4 MB of weights that stay in the 50 MB
// L2: about 1,800 FLOP per byte, far above the bf16 ridge of about 295 (at
// d = 640 twice that). The unfused form also writes and reads back the
// [M, 2*inner] hidden; here, as on the TPU, it never leaves the SM. The TPU
// kernel walked the row tiles in order on one core; on 132 SMs the main path's M
// (4096 and 1024 rows at B = 16) makes only 64 and 16 tiles of 64 rows, so one
// CTA per tile leaves most SMs idle, and the products have to run on wgmma, the
// only path to the tensor cores' rate.
//
// Design:
//   - a thread-block cluster of CL CTAs shares a 64-row tile and splits inner:
//     CTA r takes the 64-column chunks [r*n/CL, (r+1)*n/CL) of the n = inner/64.
//     CL is the smallest of 1, 2, 4, 8 that gives 90% of an SM a CTA (M = 4096:
//     2, 128 CTAs; M = 1024: 8, 128 CTAs; M = 32768: 1, no reduction);
//   - each CTA computes the tile's LayerNorm itself (fp32 two-pass statistics,
//     one warp a row) into xn, bf16 in shared memory, in the 128-byte swizzled
//     K-major layout of a wgmma operand;
//   - NWG consumer warpgroups, 2 up to d = 512 and 4 above. Per chunk, product
//     1 is xn [64, d] . W1-slice^T on wgmma, both operands from shared memory:
//     warpgroup w takes the chunk's a columns HW*w..HW*w+HW-1 (HW = 64/NWG) and
//     the matching g columns, so one thread holds a and g of the same columns
//     and applies bias + tanh-GEGLU in registers, writing the bf16 act chunk
//     [64, 64] to shared memory (same layout; two buffers, by chunk parity,
//     where W2 streams through the ring: with one K panel, d = 64, nothing
//     else orders a chunk's act after the last chunk's product 2).
//     Product 2 is act . W2-slice^T on wgmma.m64n(d/NWG)k16: warpgroup w
//     accumulates output columns [w*d/NWG, (w+1)*d/NWG) in fp32 registers over
//     the CTA's chunks. The column split keeps that accumulator at d/(2 NWG)
//     registers a thread (96 at d = 768 with 4 warpgroups, where 2 would need
//     192) and each instruction's N at most 256;
//   - the weights stream through shared memory by cp.async, AHEAD units ahead
//     of the products, in the 128-byte swizzle and in parameter layout, which
//     is the K-major layout wgmma reads, so the wrapper only casts them. A unit
//     is one [128 rows x 64 K] panel of W1 (a ring of stages) or W2's slice of
//     the chunk: from d = 192 to 512 the whole [d x 64 K] slice in a slot of its
//     own (d = 320's plan, 10-13% faster there than the ring on an H100);
//     below and above, W2 streams through the same ring as
//     four [d x 16 K] K-quarters in the 32-byte swizzle, one k-step of product 2
//     each, so that d = 768's 96 KB slice never has to sit in shared memory at
//     once beside xn (96 KB); the products of one unit stay in flight while the
//     next is fetched (wgmma.wait_group 1);
//   - the epilogue: each CTA writes its partial out [64, d] fp32 to shared
//     memory (over the weights, xn and act, all read by then), cluster.sync(),
//     and CTA r sums rows [r*64/CL, (r+1)*64/CL) over the CL partials in rank
//     order through distributed shared memory, adds b2 (+ the fp32 residual) and
//     stores bf16; rows past M are never stored (the TPU version padded instead).
// Product 2's width d/NWG is an instruction constant, so each d is an instance
// (12, each in both launch modes); everything else reads d from the instance
// or loops over it.
// Bitwise repeatable: no atomics, every sum in a fixed order (for a given M, CL
// is fixed).
//
// A second launch mode, wd_geglu_ffn, replaces the Pallas TPU kernel
// worddiffusion_tpu/ops/ffn_pallas.py::_ffn_kernel (reached through
// fused_geglu_ffn -> _geglu_ffn_pallas -> _run_ffn_pallas -> pl.pallas_call):
// the bare GEGLU feed-forward out = bf16(act . W2^T + b2), with no LayerNorm and
// no residual. The x tile goes into xn as it is and the epilogue leaves the
// residual out; everything else is shared. It is bound the same way.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int BM = 64;                  // rows per tile: one wgmma M
constexpr int NC = 64;                  // inner columns per chunk
constexpr int PANEL = BM * 64;          // bf16 of a [64 rows x 64 K] swizzled panel (8 KB)
constexpr int W1_UNIT = 2 * NC * 64;    // bf16 of a W1 unit, [128 rows x 64 K] (16 KB)
constexpr size_t SMEM_BUDGET = 232448;  // dynamic shared memory a CTA may take
constexpr int D_MIN = 64, D_MAX = 768, D_STEP = 64;

// The plan of width D. Shared memory, byte offsets from a 1024-byte aligned
// base: the ring of STAGES slots, the W2 slot [D rows x 64 K] (where W2 is not
// streamed through the ring), xn [D/64 panels], act [ACT_BUFS panels]; the
// epilogue's fp32 partial out [64][D + 8] lies over all of them.
template <int D>
struct Plan {
  static_assert(D % D_STEP == 0 && D >= D_MIN && D <= D_MAX, "a width the kernel takes");
  static constexpr int NWG = D > 512 ? 4 : 2;   // consumer warpgroups
  static constexpr int THREADS = 128 * NWG;
  static constexpr int KP = D / 64;             // K panels of xn: W1 units per chunk
  static constexpr int N2 = D / NWG;            // product 2's columns a warpgroup
  static constexpr int HW = NC / NWG;           // a (and g) columns of a chunk a warpgroup
  static constexpr int WG_SHIFT = NWG == 2 ? 6 : 5;  // a W1 unit row's warpgroup: row >> WG_SHIFT
  static_assert(2 * HW == 1 << WG_SHIFT, "2 HW rows a warpgroup");
  static constexpr bool W2_RING = D <= 128 || D > 512;
  static constexpr int W2K = W2_RING ? 16 : 64;  // K of a W2 unit
  static constexpr int UPC = KP + 64 / W2K;      // units a chunk
  static constexpr size_t W1_BYTES = size_t(W1_UNIT) * 2;
  static constexpr size_t W2_BYTES = size_t(D) * W2K * 2;
  static constexpr size_t SLOT = W2_RING && W2_BYTES > W1_BYTES ? W2_BYTES : W1_BYTES;
  static constexpr size_t XN_BYTES = size_t(KP) * PANEL * 2;
  static constexpr size_t ACT_BYTES = size_t(PANEL) * 2;
  static constexpr int ACT_BUFS = W2_RING ? 2 : 1;
  static constexpr size_t FIXED = XN_BYTES + ACT_BUFS * ACT_BYTES + (W2_RING ? 0 : W2_BYTES) + 1024;
  static constexpr int FIT = int((SMEM_BUDGET - FIXED) / SLOT);
  static constexpr int STAGES = W2_RING ? (FIT < 6 ? FIT : 6) : 4;
  static constexpr int AHEAD = STAGES - 2;  // units loading; one computing, one in flight
  static constexpr size_t w2 = size_t(STAGES) * SLOT;
  static constexpr size_t xn = w2 + (W2_RING ? 0 : W2_BYTES);
  static constexpr size_t act = xn + XN_BYTES;
  static constexpr size_t total = act + ACT_BUFS * ACT_BYTES + 1024;  // + the alignment
  static constexpr int LDR = D + 8;  // fp32 row stride of the partial out
  static_assert(AHEAD >= 1 && total <= SMEM_BUDGET, "the plan fits");
  static_assert(size_t(BM) * LDR * 4 <= act + ACT_BUFS * ACT_BYTES, "the partial out fits");
  static_assert(N2 % 16 == 0 && N2 <= 256, "one wgmma N a warpgroup");
};

// LN: the LayerNorm + residual sub-layer (_ln_ffn_kernel); otherwise the bare
// FFN (_ffn_kernel), which reads neither gamma, beta nor eps.
// grid (tiles * CL), cluster (CL, 1, 1): cluster t is row tile t.
template <int D, bool LN>
__global__ void __launch_bounds__(Plan<D>::THREADS, 1)
    ffn_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ out, int M, int inner,
               float eps) {
  using P = Plan<D>;
  constexpr int THREADS = P::THREADS, KP = P::KP, UPC = P::UPC, N2 = P::N2, HW = P::HW;
  constexpr int STAGES = P::STAGES, AHEAD = P::AHEAD, NV = D / 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = static_cast<int>(cluster.num_blocks());
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* w2s = reinterpret_cast<bf16*>(sm + P::w2);
  bf16* xn = reinterpret_cast<bf16*>(sm + P::xn);
  bf16* act = reinterpret_cast<bf16*>(sm + P::act);
  float* red = reinterpret_cast<float*>(sm);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, g8 = (lane >> 2) + 16 * (warp % 4), t4 = lane & 3;
  const int row0 = (blockIdx.x / cl) * BM;
  const int chunks = inner / NC;
  const int c0 = rank * chunks / cl, c1 = (rank + 1) * chunks / cl;
  const int units = (c1 - c0) * UPC;

  // The ring slot of chunk lc's part p: W1 units alone where W2 has a slot of
  // its own, else every unit in turn.
  auto slot_of = [&](int lc, int p) -> unsigned char* {
    const int s = (P::W2_RING ? lc * UPC + p : lc * KP + p) % STAGES;
    return sm + size_t(s) * P::SLOT;
  };
  // unit u = (chunk c0 + u / UPC, part u % UPC): parts 0..KP-1 are W1's K panels,
  // then W2's slice (one part, or four K-quarters). Eight neighbouring threads
  // fill the same 16 bytes of K of 8 rows (on 8 distinct bank groups, by the
  // swizzle).
  auto load_unit = [&](int u) {
    const int lc = u / UPC, p = u % UPC, c = c0 + lc;
    if (p < KP) {
      // slot row n: warpgroup n / (2 HW)'s a columns, then its g columns
      bf16* slot = reinterpret_cast<bf16*>(slot_of(lc, p));
      for (int i = tid; i < 2 * NC * 8; i += THREADS) {
        const int n = (i & 7) | ((i >> 6) << 3), v = (i >> 3) & 7;
        const int col = c * NC + HW * (n >> P::WG_SHIFT) + (n & (HW - 1)) + ((n & HW) ? inner : 0);
        cp_async16(slot + n * 64 + ((v ^ (n & 7)) << 3), w1 + size_t(col) * D + p * 64 + v * 8);
      }
    } else if constexpr (!P::W2_RING) {
      for (int i = tid; i < D * 8; i += THREADS) {
        const int n = (i & 7) | ((i >> 6) << 3), v = (i >> 3) & 7;
        cp_async16(w2s + n * 64 + ((v ^ (n & 7)) << 3), w2 + size_t(n) * inner + c * NC + v * 8);
      }
    } else {
      // K-quarter q: [D rows x 16 K], rows of 32 bytes in the 32-byte swizzle
      unsigned char* slot = slot_of(lc, p);
      const int q = p - KP;
      for (int i = tid; i < D * 2; i += THREADS) {
        const int n = i >> 1, h = i & 1;
        cp_async16(slot + swz_chunk<32>(n, h), w2 + size_t(n) * inner + c * NC + q * 16 + h * 8);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {  // behind the LayerNorm
    if (s < units) load_unit(s);
    cp_async_commit();
  }

  // xn: one warp a row, 8 channels a lane and vector; rows past M are zero
  constexpr int PER = (NV + 31) / 32;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int gr = row0 + r;
    uint4 v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int vi = lane + 32 * k;
      v[k] = (gr < M && vi < NV) ? *reinterpret_cast<const uint4*>(x + size_t(gr) * D + vi * 8)
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
    if (LN && gr < M) {
      float f[PER][8];
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        unpack8(v[k], f[k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += f[k][j];  // zero past d
      }
      const float mu = warp_sum(s) / D;
      float q = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (lane + 32 * k < NV)
#pragma unroll
          for (int j = 0; j < 8; ++j) q += (f[k][j] - mu) * (f[k][j] - mu);
      const float rstd = rsqrtf(warp_sum(q) / D + eps);
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
        for (int j = 0; j < 8; ++j) y[j] = (f[k][j] - mu) * rstd * gm[j] + bt[j];
        v[k] = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                          pack_bf16(y[6], y[7]));
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int vi = lane + 32 * k;
      if (vi < NV)
        *reinterpret_cast<uint4*>(xn + (vi >> 3) * PANEL + swz(r, (vi & 7) * 8)) = v[k];
    }
  }
  fence_proxy_async();

  // One iteration a chunk, its units unrolled, so that each product's
  // accumulators stay in fixed registers between its issue and its wait. No
  // other instruction writes them while a product is in flight (ptxas would
  // then serialize the products, C7515): acc1 is zeroed once, before any
  // product, and pinned after the GEGLU has read it; acc2 is never zeroed, the
  // CTA's first product 2 overwrites it (every CTA has at least one chunk).
  // Before unit u's barrier every warpgroup has at most unit u - 1's products
  // in flight, so the unit loaded after it (u + AHEAD, slot of u + AHEAD -
  // STAGES <= u - 2) overwrites nothing that is read.
  auto begin_unit = [&](int u) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of unit u have landed
    fence_proxy_async();         // and are visible to wgmma
    __syncthreads();             // everyone's; every warpgroup past unit u - 2
    if (u + AHEAD < units) load_unit(u + AHEAD);
    cp_async_commit();
  };
  float acc1[HW], acc2[N2 / 2];
#pragma unroll
  for (int i = 0; i < HW; ++i) acc1[i] = 0.f;
  for (int lc = 0; lc < c1 - c0; ++lc) {
    // act by chunk parity where it has two buffers: chunk lc's GEGLU writes
    // the buffer that chunk lc - 2's product 2 read, which every warpgroup
    // finished before the barrier of chunk lc - 1's product 2. With one
    // buffer (KP >= 3), the barrier of this chunk's K panel 1 follows every
    // warpgroup's wait for chunk lc - 1's product 2.
    bf16* actb = act + (P::ACT_BUFS == 2 ? (lc & 1) * PANEL : 0);
    // product 1, K panel by K panel: [a | g] of this warpgroup's HW columns
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      begin_unit(lc * UPC + p);
      const bf16* slot = reinterpret_cast<const bf16*>(slot_of(lc, p)) + wg * 2 * HW * 64;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss<0, 0>(acc1, make_desc_sw128(xn + p * PANEL + ks * 16),
                       make_desc_sw128(slot + ks * 16), p > 0 || ks > 0);
      wgmma_commit();
      if (p < KP - 1) wgmma_wait<1>();  // the accumulators are read after wait_group 0
    }
    wgmma_wait<0>();
    pin(acc1);
    // bias + tanh-GEGLU: thread (g8, t4) holds a and g of columns 8j + 2 t4, + 1
    // (j < HW / 8), rows g8 and g8 + 8; the bf16 act chunk to shared memory
    const int cbase = (c0 + lc) * NC + HW * wg;
#pragma unroll
    for (int j = 0; j < HW / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 ba = *reinterpret_cast<const float2*>(b1 + cbase + col);
      const float2 bg = *reinterpret_cast<const float2*>(b1 + inner + cbase + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a0 = acc1[4 * j + 2 * h] + ba.x, a1 = acc1[4 * j + 2 * h + 1] + ba.y;
        const float q0 = acc1[4 * (j + HW / 8) + 2 * h] + bg.x;
        const float q1 = acc1[4 * (j + HW / 8) + 2 * h + 1] + bg.y;
        *reinterpret_cast<uint32_t*>(actb + swz(g8 + 8 * h, HW * wg + col)) =
            pack_bf16(a0 * gelu_tanh(q0), a1 * gelu_tanh(q1));
      }
    }
    fence_proxy_async();  // read by product 2 after the next unit's barrier
    pin(acc1);            // the GEGLU's reads stay above the next chunk's products

    // product 2: out[:, this warpgroup's N2 columns] += act . W2-slice^T
    if constexpr (!P::W2_RING) {
      begin_unit(lc * UPC + KP);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss<0, 0>(acc2, make_desc_sw128(actb + ks * 16),
                       make_desc_sw128(w2s + wg * N2 * 64 + ks * 16), lc > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // in flight behind the next chunk's first unit
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        begin_unit(lc * UPC + KP + q);
        wgmma_fence();
        wgmma_ss<0, 0>(acc2, make_desc_sw128(actb + q * 16),
                       make_desc(slot_of(lc, KP + q) + wg * N2 * 32, 16, 256, SW32),
                       lc > 0 || q > 0);
        wgmma_commit();
        wgmma_wait<1>();
      }
    }
  }
  wgmma_wait<0>();
  pin(acc2);
  cp_async_wait<0>();
  __syncthreads();  // every product done: the partial out goes over the weights

#pragma unroll
  for (int j = 0; j < N2 / 8; ++j) {
    const int col = wg * N2 + 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(red + g8 * P::LDR + col) = make_float2(acc2[4 * j], acc2[4 * j + 1]);
    *reinterpret_cast<float2*>(red + (g8 + 8) * P::LDR + col) =
        make_float2(acc2[4 * j + 2], acc2[4 * j + 3]);
  }
  cluster.sync();

  // rows [rank * 64 / CL, (rank + 1) * 64 / CL) of the tile: the CL partials in
  // rank order, + b2 (+ the residual), 8 columns a thread and step
  const int rows = BM / cl;
  for (int i = tid; i < rows * NV; i += THREADS) {
    const int r = rank * rows + i / NV, vi = i % NV, gr = row0 + r;
    if (gr >= M) continue;
    float y[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < cl; ++q) {
      const float* src = cluster.map_shared_rank(red, q) + r * P::LDR + vi * 8;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      y[0] += lo.x; y[1] += lo.y; y[2] += lo.z; y[3] += lo.w;
      y[4] += hi.x; y[5] += hi.y; y[6] += hi.z; y[7] += hi.w;
    }
    const float4 ba = *reinterpret_cast<const float4*>(b2 + vi * 8);
    const float4 bb = *reinterpret_cast<const float4*>(b2 + vi * 8 + 4);
    const float bias[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
    float res[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const size_t gi = size_t(gr) * D + vi * 8;
    if (LN) unpack8(*reinterpret_cast<const uint4*>(x + gi), res);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = LN ? res[j] + (y[j] + bias[j]) : y[j] + bias[j];
    *reinterpret_cast<uint4*>(out + gi) = make_uint4(
        pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
  }
  cluster.sync();  // every remote read done before any CTA of the cluster leaves
}

// The smallest cluster of 1, 2, 4, 8 that gives 90% of the SMs a CTA (no more
// CTAs than inner has chunks).
int cluster_size(int tiles, int chunks) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int cl = 1;
  while (cl < 8 && 2 * cl <= chunks && 10LL * tiles * cl < 9LL * sms) cl *= 2;
  return cl;
}

template <int D, bool LN>
cudaError_t launch(const void* x, const void* gamma, const void* beta, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* out, int M, int inner,
                   float eps, cudaStream_t stream) {
  using P = Plan<D>;
  // The shared memory limit is raised once per device for this instance: the
  // attribute call costs host time of the order of the launch itself.
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    e = cudaFuncSetAttribute(ffn_kernel<D, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(P::total));
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit);
  }
  const int tiles = (M + BM - 1) / BM;
  const int cl = cluster_size(tiles, inner / NC);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(tiles) * cl);
  cfg.blockDim = dim3(P::THREADS);
  cfg.dynamicSmemBytes = P::total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ffn_kernel<D, LN>, static_cast<const bf16*>(x),
                         static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<const bf16*>(w1), static_cast<const float*>(b1),
                         static_cast<const bf16*>(w2), static_cast<const float*>(b2),
                         static_cast<bf16*>(out), M, inner, eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Calls f.template run<D>() for the instance of width d; false where the
// kernel does not take d.
template <typename F>
bool with_width(int d, F& f) {
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

struct Launcher {
  const void *x, *gamma, *beta, *w1, *b1, *w2, *b2;
  void* out;
  int M, inner;
  float eps;
  int ln;
  cudaStream_t stream;
  cudaError_t e = cudaErrorInvalidValue;
  template <int D>
  void run() {
    e = ln ? launch<D, true>(x, gamma, beta, w1, b1, w2, b2, out, M, inner, eps, stream)
           : launch<D, false>(x, gamma, beta, w1, b1, w2, b2, out, M, inner, eps, stream);
  }
};

struct PlanOf {
  int* out;
  template <int D>
  void run() {
    using P = Plan<D>;
    out[0] = int(P::total);
    out[1] = P::THREADS;
    out[2] = P::NWG;
    out[3] = P::STAGES;
    out[4] = P::W2_RING;
  }
};

int dispatch(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
             const void* w2, const void* b2, void* out, int M, int d, int inner, float eps,
             int ln, void* stream) {
  if (M <= 0) return cudaSuccess;
  if (inner <= 0 || inner % NC) return cudaErrorInvalidValue;
  Launcher f{x, gamma, beta, w1, b1, w2, b2, out, M, inner, eps, ln,
             static_cast<cudaStream_t>(stream)};
  with_width(d, f);
  return f.e;
}

}  // namespace

extern "C" {

// The feature widths the forward kernel takes: out = {min, max, step}.
void wd_ln_geglu_ffn_d(int* out) {
  out[0] = D_MIN;
  out[1] = D_MAX;
  out[2] = D_STEP;
}

// The plan of width d: out = {dynamic shared memory bytes, threads a CTA,
// consumer warpgroups, ring stages, W2 streamed through the ring (0 / 1)};
// returns nonzero where the kernel does not take d.
int wd_ln_geglu_ffn_plan(int d, int* out) {
  PlanOf f{out};
  return with_width(d, f) ? 0 : int(cudaErrorInvalidValue);
}

// The cluster size the forward kernel launches with at M rows.
int wd_ln_geglu_ffn_cluster(int m, int inner) {
  return m > 0 && inner >= NC ? cluster_size((m + BM - 1) / BM, inner / NC) : 0;
}

// Launches the LN + FFN + residual kernel on `stream`; returns the CUDA error
// code (0 on success): a shape it does not take, or a launch the device refuses.
int wd_ln_geglu_ffn(const void* x, const void* gamma, const void* beta, const void* w1,
                    const void* b1, const void* w2, const void* b2, void* out, int M, int d,
                    int inner, float eps, void* stream) {
  return dispatch(x, gamma, beta, w1, b1, w2, b2, out, M, d, inner, eps, 1, stream);
}

// The bare GEGLU FFN, out = act . W2^T + b2 (no LayerNorm, no residual), with the
// same operands and constraints.
int wd_geglu_ffn(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 void* out, int M, int d, int inner, void* stream) {
  return dispatch(x, nullptr, nullptr, w1, b1, w2, b2, out, M, d, inner, 0.f, 0, stream);
}

const char* wd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
