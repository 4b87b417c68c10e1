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
// about 295 FLOP per byte; 0.217 ms at 989 TFLOP/s.
//
// Design. CTAs run in parallel and in no order, and fp32 atomics would make the
// gradients depend on the order in which CTAs finish, which would break the
// trainer's bitwise resume; so every sum is taken in a fixed order, in three
// launches on one stream, all products on wgmma with both operands in shared
// memory:
//   A. rows: a thread-block cluster of CL CTAs shares a 64-row tile and splits
//      inner in chunks of 32 columns, as the forward does (CL from 1, 2, 4, 8:
//      the smallest that gives 90% of the SMs a CTA; 1 from M = 8192 on). Each
//      CTA recomputes the tile's LayerNorm into xn and stages dy, both bf16 in
//      shared memory, K-major in the 64-byte swizzle. Per chunk, with its W1
//      rows [64 x d] and W2 columns [d x 32] staged through a cp.async double
//      buffer in parameter layout, warpgroup w computes [a | u] of its 16
//      columns (wgmma m64n32, W1 K-major) and dact of the same columns (m64n16,
//      W2 MN-major: wgmma transposes 16-bit B), applies GEGLU and its
//      derivative in the accumulators' registers (the forward's tanhf, so act
//      and gelu' come from the tanh that B.1 and the TPU kernel use), writes dhc to shared memory in the 128-byte swizzle and act
//      beside it, and both warpgroups then accumulate dxn [64, d] += dhc . W1
//      (m64n160 each: the same staged W1 rows read MN-major). act and dhc go to
//      device memory as 16-byte stores, behind the dxn product. After the last
//      chunk the CL partial dxn (fp32) are summed in rank order through
//      distributed shared memory, CTA r taking rows [r*64/CL, (r+1)*64/CL),
//      which then run the LayerNorm backward into dx and per-tile column
//      partials of dgamma, dbeta, db2; db1's partials are written per chunk.
//   B. weights: dW1 = dhc^T . xn and dW2 (as its transpose act^T . dy) on
//      wgmma with both operands M-major (transposed): one CTA per 128 x 160
//      output tile, a cluster of 2 CTAs a tile splitting M in halves, each
//      walking its half in 64-row steps through a 4-stage cp.async ring in the
//      128-byte swizzle; the two fp32 partials summed in rank order through
//      distributed shared memory and stored in parameter layout.
//   C. the per-tile partials of dgamma, dbeta, db2 and db1 summed in order.
// No atomics anywhere; for a given M the cluster sizes, and so every sum's
// order, are fixed: bitwise repeatable.
// Scratch: xn [M, d], dhc [M, 2*inner], act [M, inner] (bf16), written by A and
// read by B; the partials [tiles*CL, 3*d] and [tiles, 2*inner] (fp32).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int D_TAKEN = 320;
constexpr int BM = 64;         // rows per tile of kernel A: one wgmma M
constexpr int NC = 32;         // inner columns per chunk
constexpr int THREADS = 256;   // two warpgroups
constexpr int SW64_BLOCK = BM * 64;  // bytes of a [64 rows x 32 K] 64-byte swizzled block

// Kernel A's shared memory, byte offsets from a 1024-byte aligned base: the W1
// double buffer ([64 rows x d] in d/32 blocks of [64 x 32]), the W2 double
// buffer (each warpgroup's [d rows x 16 columns], 32-byte swizzle), xn and dy
// (d/32 blocks of [64 x 32]), dhc [64 x 64] (128-byte swizzle), act [64 x 32]
// (64-byte swizzle), db1's per-warp column sums, the row statistics. The
// epilogue's fp32 dxn [64][d + 8] lies over the weight buffers.
template <int D>
struct SmemA {
  static constexpr int NB = D / 32;           // K blocks
  static constexpr int LDR = D + 8;           // fp32 row stride of dxn
  static constexpr size_t W1_SLOT = size_t(NB) * SW64_BLOCK;
  static constexpr size_t W2_HALF = size_t(D) * 32;
  static constexpr size_t W2_SLOT = 2 * W2_HALF;
  static constexpr size_t w1 = 0;
  static constexpr size_t w2 = w1 + 2 * W1_SLOT;
  static constexpr size_t xn = w2 + 2 * W2_SLOT;
  static constexpr size_t dy = xn + W1_SLOT;
  static constexpr size_t dhc = dy + W1_SLOT;
  static constexpr size_t act = dhc + size_t(BM) * 128;
  static constexpr size_t db1 = act + size_t(BM) * 64;
  static constexpr size_t mu = db1 + 2 * 4 * NC * 4;
  static constexpr size_t rstd = mu + BM * 4;
  static constexpr size_t total = rstd + BM * 4 + 1024;  // + the alignment
  static_assert(size_t(BM) * LDR * 4 <= xn, "dxn fits over the weight buffers");
  static_assert(W2_HALF % 256 == 0 && dhc % 1024 == 0, "swizzle alignment");
};

// The smallest cluster of 1, 2, 4, 8 that gives 90% of the SMs a CTA (every
// CTA at least one chunk).
int cluster_size(int tiles, int chunks) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int cl = 1;
  while (cl < 8 && 2 * cl <= chunks && 10LL * tiles * cl < 9LL * sms) cl *= 2;
  return cl;
}

// grid (tiles * CL), cluster (CL, 1, 1): cluster t is row tile t.
// part1 [tiles * CL][3 D]: dgamma | dbeta | db2 over CTA r's rows of tile t at
// row t * CL + r; part2 [tiles][2 inner]: db1 over tile t's rows.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        const bf16* __restrict__ w1, const float* __restrict__ b1,
                        const bf16* __restrict__ w2, bf16* __restrict__ dx,
                        bf16* __restrict__ xn_g, bf16* __restrict__ dhc_g,
                        bf16* __restrict__ act_g, float* __restrict__ part1,
                        float* __restrict__ part2, int M, int inner, float eps) {
  using L = SmemA<D>;
  constexpr int NB = L::NB, NV = D / 8, N3 = D / 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = static_cast<int>(cluster.num_blocks());
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xns = sm + L::xn;
  unsigned char* dys = sm + L::dy;
  unsigned char* dhcs = sm + L::dhc;
  unsigned char* acts = sm + L::act;
  float* db1s = reinterpret_cast<float*>(sm + L::db1);
  float* mus = reinterpret_cast<float*>(sm + L::mu);
  float* rstds = reinterpret_cast<float*>(sm + L::rstd);
  float* red = reinterpret_cast<float*>(sm);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, w4 = warp % 4, g8 = (lane >> 2) + 16 * w4, t4 = lane & 3;
  const int tile = blockIdx.x / cl, row0 = tile * BM;
  const int chunks = inner / NC;
  const int c0 = rank * chunks / cl, nch = (rank + 1) * chunks / cl - c0;
  const int two_inner = 2 * inner;
  const int rows = BM / cl, r_lo = rank * rows;  // this CTA's rows of the epilogue

  // [64 rows x D] bf16 from device memory (row stride D) into d/32 blocks of
  // the 64-byte swizzle; rows past M read as zero. A warp fills 8 rows x 64
  // bytes of one block a step: 64 contiguous bytes of each row.
  auto load_rows = [&](unsigned char* dst, const bf16* src) {
    for (int u = warp; u < 8 * NB; u += THREADS / 32) {
      const int r = (u % 8) * 8 + lane / 4, j = lane % 4, blk = u / 8;
      const int gr = row0 + r;
      cp_async16_zfill(dst + blk * SW64_BLOCK + swz_chunk<64>(r, j),
                       src + size_t(gr < M ? gr : 0) * D + blk * 32 + j * 8, gr < M);
    }
  };
  // chunk lc's W1 rows (slot row n: warpgroup n / 32's a columns, then its u
  // columns) and each warpgroup's 16 W2 columns
  auto load_chunk = [&](int lc, int buf) {
    const int c = (c0 + lc) * NC;
    unsigned char* w1s = sm + L::w1 + buf * L::W1_SLOT;
    for (int u = warp; u < 8 * NB; u += THREADS / 32) {
      const int n = (u % 8) * 8 + lane / 4, j = lane % 4, blk = u / 8;
      const int col = c + 16 * (n >> 5) + (n & 15) + ((n & 16) ? inner : 0);
      cp_async16(w1s + blk * SW64_BLOCK + swz_chunk<64>(n, j),
                 w1 + size_t(col) * D + blk * 32 + j * 8);
    }
    unsigned char* w2s = sm + L::w2 + buf * L::W2_SLOT;
    for (int u = warp; u < 2 * (D / 16); u += THREADS / 32) {
      const int h = u / (D / 16), k = (u % (D / 16)) * 16 + lane / 2, j = lane % 2;
      cp_async16(w2s + h * L::W2_HALF + swz_chunk<32>(k, j),
                 w2 + size_t(k) * inner + c + 16 * h + j * 8);
    }
  };

  load_rows(dys, dy);
  load_chunk(0, 0);
  cp_async_commit();

  // LayerNorm of the tile, one warp a row, 8 channels a lane and vector; rows
  // past M are zero. This CTA's rows of the epilogue also go to xn_g for B.
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
    if (gr < M) {
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
      if (lane == 0) {
        mus[r] = mu;
        rstds[r] = rstd;
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
        for (int j = 0; j < 8; ++j) y[j] = (f[k][j] - mu) * rstd * gm[j] + bt[j];
        v[k] = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                          pack_bf16(y[6], y[7]));
        if (r / rows == rank) *reinterpret_cast<uint4*>(xn_g + size_t(gr) * D + vi * 8) = v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int vi = lane + 32 * k;
      if (vi < NV)
        *reinterpret_cast<uint4*>(xns + (vi >> 2) * SW64_BLOCK + swz_chunk<64>(r, vi & 3)) = v[k];
    }
  }

  // One chunk an iteration. acc1 ([a | u] of the warpgroup's 16 columns) and
  // dact are overwritten by each chunk's first product and read after
  // wait_group 0; acc3 (dxn, this warpgroup's d/2 columns) is overwritten by the
  // first chunk's first product and stays in flight only from its issue to the
  // next iteration's wait. No other instruction writes an accumulator while a
  // product is in flight (ptxas would then serialize the products, C7515).
  float acc1[16], dact[8], acc3[N3 / 2];
  float db1a[2][2], db1u[2][2];
  for (int lc = 0; lc < nch; ++lc) {
    const int buf = lc & 1;
    wgmma_wait<0>();  // this warpgroup's dxn of the last chunk
    __syncthreads();  // everyone's: the other buffer, dhc, act and db1 are free
    if (lc + 1 < nch) load_chunk(lc + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of chunk lc (and dy) have landed
    fence_proxy_async(); // and, with xn, dhc and act's writes, are visible to wgmma
    __syncthreads();

    const unsigned char* w1s = sm + L::w1 + buf * L::W1_SLOT;
    const unsigned char* w2s = sm + L::w2 + buf * L::W2_SLOT + wg * L::W2_HALF;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int off = (ks >> 1) * SW64_BLOCK + (ks & 1) * 32;
      wgmma_ss<0, 0>(acc1, make_desc(xns + off, 16, 512, SW64),
                     make_desc(w1s + off + wg * 32 * 64, 16, 512, SW64), ks > 0);
      wgmma_ss<0, 1>(dact, make_desc(dys + off, 16, 512, SW64),
                     make_desc(w2s + ks * 16 * 32, 16, 256, SW32), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc1);
    pin(dact);

    // GEGLU and its derivative: thread (g8, t4) holds a (acc1 j = 0, 1), u
    // (j = 2, 3) and dact (j = 0, 1) of columns 8j + 2 t4, + 1 of the
    // warpgroup's 16, rows g8 and g8 + 8
    const int cb = (c0 + lc) * NC + 16 * wg;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 ba = *reinterpret_cast<const float2*>(b1 + cb + col);
      const float2 bu = *reinterpret_cast<const float2*>(b1 + inner + cb + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float act2[2], da2[2], du2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc1[4 * j + 2 * h + e] + (e ? ba.y : ba.x);
          const float u = acc1[4 * (j + 2) + 2 * h + e] + (e ? bu.y : bu.x);
          const float t = tanhf(GELU_C * (u + GELU_K * u * u * u));
          const float gu = 0.5f * u * (1.f + t);
          const float dgu =
              0.5f * (1.f + t) + 0.5f * u * (1.f - t * t) * GELU_C * (1.f + 3.f * GELU_K * u * u);
          const float dd = dact[4 * j + 2 * h + e];
          act2[e] = a * gu;
          da2[e] = dd * gu;
          du2[e] = dd * a * dgu;
          db1a[j][e] = (h ? db1a[j][e] : 0.f) + da2[e];
          db1u[j][e] = (h ? db1u[j][e] : 0.f) + du2[e];
        }
        const int r = g8 + 8 * h;
        *reinterpret_cast<uint32_t*>(acts + swz_chunk<64>(r, wg * 2 + j) + t4 * 4) =
            pack_bf16(act2[0], act2[1]);
        bf16* dr = reinterpret_cast<bf16*>(dhcs);
        *reinterpret_cast<uint32_t*>(dr + swz(r, 32 * wg + col)) = pack_bf16(da2[0], da2[1]);
        *reinterpret_cast<uint32_t*>(dr + swz(r, 32 * wg + 16 + col)) = pack_bf16(du2[0], du2[1]);
      }
    }
    // db1: the column sums of dh over the warp's 16 rows (the 8 lanes of a
    // column, in a fixed butterfly), then over the 4 warps in order below
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sa = db1a[j][e], su = db1u[j][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, o);
          su += __shfl_xor_sync(0xffffffffu, su, o);
        }
        if (lane < 4) {
          float* d = db1s + (wg * 4 + w4) * NC;
          d[8 * j + 2 * t4 + e] = sa;
          d[16 + 8 * j + 2 * t4 + e] = su;
        }
      }
    fence_proxy_async();  // dhc, read by the dxn product
    __syncthreads();

    // dxn[:, this warpgroup's d/2 columns] += dhc . W1-rows: K = the 64 slot
    // rows, W1's rows read MN-major (atoms of 32 columns, one block apart)
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<0, 1>(acc3, make_desc_sw128(dhcs + ks * 32),
                     make_desc(w1s + (NB / 2) * wg * SW64_BLOCK + ks * 16 * 64, SW64_BLOCK, 512,
                               SW64),
                     lc > 0 || ks > 0);
    wgmma_commit();

    // behind it: act and dhc to device memory, 16 bytes a store, and db1
    {
      const int r = tid / 4, j = tid % 4, gr = row0 + r;
      if (gr < M)
        *reinterpret_cast<uint4*>(act_g + size_t(gr) * inner + (c0 + lc) * NC + 8 * j) =
            *reinterpret_cast<const uint4*>(acts + swz_chunk<64>(r, j));
    }
    for (int i = tid; i < BM * 8; i += THREADS) {
      const int r = i / 8, q = i % 8, gr = row0 + r;
      if (gr >= M) continue;
      const int col = ((q & 2) ? inner : 0) + (c0 + lc) * NC + 16 * (q >> 2) + 8 * (q & 1);
      *reinterpret_cast<uint4*>(dhc_g + size_t(gr) * two_inner + col) =
          *reinterpret_cast<const uint4*>(dhcs + swz_chunk<128>(r, q));
    }
    if (tid < 2 * NC) {
      const int h = tid / NC, k = tid % NC;
      const float* s = db1s + h * 4 * NC + k;
      const int col = ((k & 16) ? inner : 0) + (c0 + lc) * NC + 16 * h + (k & 15);
      part2[size_t(tile) * two_inner + col] = s[0] + s[NC] + s[2 * NC] + s[3 * NC];
    }
  }
  wgmma_wait<0>();
  pin(acc3);
  cp_async_wait<0>();
  __syncthreads();  // every product done: dxn goes over the weight buffers

#pragma unroll
  for (int j = 0; j < N3 / 8; ++j) {
    const int col = wg * N3 + 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(red + g8 * L::LDR + col) = make_float2(acc3[4 * j], acc3[4 * j + 1]);
    *reinterpret_cast<float2*>(red + (g8 + 8) * L::LDR + col) =
        make_float2(acc3[4 * j + 2], acc3[4 * j + 3]);
  }
  cluster.sync();

  // The LayerNorm backward of this CTA's rows, one warp a row: dxn summed over
  // the cluster's partials in rank order (kept in this CTA's own rows for the
  // column sums), then dx.
  for (int r = r_lo + warp; r < r_lo + rows; r += THREADS / 32) {
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
      unpack8(*reinterpret_cast<const uint4*>(dys + (vi >> 2) * SW64_BLOCK +
                                              swz_chunk<64>(r, vi & 3)), dyv[k]);
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
  __syncthreads();

  // column partials over this CTA's rows, in row order
  float* p1 = part1 + size_t(tile * cl + rank) * 3 * D;
  for (int c = tid; c < D; c += THREADS) {
    float sg = 0.f, sb = 0.f, sy = 0.f;
    for (int r = r_lo; r < r_lo + rows && row0 + r < M; ++r) {
      const float dn = red[r * L::LDR + c];
      const float xh = (__bfloat162float(x[size_t(row0 + r) * D + c]) - mus[r]) * rstds[r];
      const bf16 dyv = *reinterpret_cast<const bf16*>(
          dys + (c >> 5) * SW64_BLOCK + swz_chunk<64>(r, (c >> 3) & 3) + (c & 7) * 2);
      sg += dn * xh;
      sb += dn;
      sy += __bfloat162float(dyv);
    }
    p1[c] = sg;
    p1[D + c] = sb;
    p1[2 * D + c] = sy;
  }
  cluster.sync();  // every remote read done before any CTA of the cluster leaves
}

// Kernel B: the weight gradients. Tile t of 128 rows x 160 columns of
//   dW1 [2 inner, D] = X^T . Y, X = dhc [M, 2 inner], Y = xn [M, D]   (t < T1), or
//   dW2^T [inner, D] = X^T . Y, X = act [M, inner], Y = dy [M, D], stored as dW2 [D, inner];
// grid (tiles * SPLIT), cluster (SPLIT, 1, 1): CTA r of a cluster walks the r-th
// of SPLIT equal runs of M's 64-row steps.
constexpr int SPLIT = 2;
constexpr int WR = 128, WN = 160, WK = 64;  // tile rows, columns; M rows a step
constexpr int W_STAGES = 4, W_AHEAD = 2;
constexpr size_t WX_BYTES = size_t(WK) * WR * 2;  // two [64 x 64] atoms of X^T
constexpr size_t WY_BYTES = size_t(WK) * 192 * 2; // three of Y (the last one half used)
constexpr size_t W_STAGE = WX_BYTES + WY_BYTES;
constexpr int W_LDR = WN + 8;
constexpr size_t W_SMEM = W_STAGES * W_STAGE + 1024;
static_assert(size_t(WR) * W_LDR * 4 <= W_STAGES * W_STAGE, "the partial fits over the ring");

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_bwd_weights_kernel(const bf16* __restrict__ xn_g, const bf16* __restrict__ dhc_g,
                           const bf16* __restrict__ act_g, const bf16* __restrict__ dy,
                           float* __restrict__ dw1, float* __restrict__ dw2, int M, int inner) {
  static_assert(D == 2 * WN, "two column tiles");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(sm);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, g8 = (lane >> 2) + 16 * (warp % 4), t4 = lane & 3;
  const int two_inner = 2 * inner;
  const int t1 = 2 * ((two_inner + WR - 1) / WR);
  int t = blockIdx.x / SPLIT;
  const bool first = t < t1;
  if (!first) t -= t1;
  const int r0 = (t / 2) * WR, n0 = (t % 2) * WN;
  const bf16* X = first ? dhc_g : act_g;
  const bf16* Y = first ? xn_g : dy;
  const int R = first ? two_inner : inner;  // X's columns: the output's rows
  const int steps = (M + WK - 1) / WK;
  const int s0 = rank * steps / SPLIT, s1 = (rank + 1) * steps / SPLIT;
  const int n = s1 > s0 ? s1 - s0 : 1;  // an empty run takes one step of zeros

  // step i into stage slot: X rows [m0, m0 + 64) x columns [r0, r0 + 128) and
  // Y rows x columns [n0, n0 + 160), each as 64-column atoms of the 128-byte
  // swizzle, rows along M; rows past M or past the run, and X columns past R,
  // are zero. A warp fills 4 rows x 128 bytes of an atom a step.
  auto load = [&](int i) {
    unsigned char* xs = sm + (i % W_STAGES) * W_STAGE;
    unsigned char* ys = xs + WX_BYTES;
    const int m0 = (s0 + i) * WK;
    const bool run = s0 + i < s1;
    for (int u = warp; u < 2 * 16; u += THREADS / 32) {
      const int atom = u / 16, r = (u % 16) * 4 + lane / 8, j = lane % 8;
      const int m = m0 + r, col = r0 + atom * 64 + j * 8;
      const bool ok = run && m < M && col < R;
      cp_async16_zfill(xs + atom * 8192 + swz_chunk<128>(r, j),
                       X + (ok ? size_t(m) * R + col : 0), ok);
    }
    for (int u = warp; u < 2 * 16 + 8; u += THREADS / 32) {
      int atom, r, j;
      if (u < 32) {
        atom = u / 16, r = (u % 16) * 4 + lane / 8, j = lane % 8;
      } else {
        atom = 2, r = (u - 32) * 8 + lane / 4, j = lane % 4;
      }
      const int m = m0 + r;
      const bool ok = run && m < M;
      cp_async16_zfill(ys + atom * 8192 + swz_chunk<128>(r, j),
                       Y + (ok ? size_t(m) * D + n0 + atom * 64 + j * 8 : 0), ok);
    }
  };

#pragma unroll
  for (int s = 0; s < W_AHEAD; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }
  // acc is overwritten by the first product (every CTA takes at least one
  // step) and read after wait_group 0
  float acc[WN / 2];
  for (int i = 0; i < n; ++i) {
    cp_async_wait<W_AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();  // step i landed for all; every product of step i - 2 done
    if (i + W_AHEAD < n) load(i + W_AHEAD);
    cp_async_commit();
    const unsigned char* xs = sm + (i % W_STAGES) * W_STAGE;
    const unsigned char* ys = xs + WX_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WK / 16; ++ks)
      wgmma_ss<1, 1>(acc, make_desc(xs + wg * 8192 + ks * 2048, 8192, 1024, SW128),
                     make_desc(ys + ks * 2048, 8192, 1024, SW128), i > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  pin(acc);
  cp_async_wait<0>();
  __syncthreads();  // every product done: the partial goes over the ring

  // warpgroup wg holds rows [64 wg, 64 wg + 64) of the tile
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = 8 * j + 2 * t4, row = 64 * wg + g8;
    *reinterpret_cast<float2*>(red + row * W_LDR + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(red + (row + 8) * W_LDR + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  cluster.sync();

  // rows [rank * 128 / SPLIT, ...) of the tile: the SPLIT partials in rank order
  constexpr int ROWS = WR / SPLIT;
  const int lo = rank * ROWS;
  if (first) {
    for (int i = tid; i < ROWS * (WN / 4); i += THREADS) {
      const int r = lo + i / (WN / 4), c = (i % (WN / 4)) * 4;
      if (r0 + r >= R) continue;
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
    for (int i = tid; i < ROWS * WN; i += THREADS) {
      const int r = lo + i % ROWS, c = i / ROWS;
      if (r0 + r >= R) continue;
      float s = 0.f;
      for (int q = 0; q < SPLIT; ++q) s += cluster.map_shared_rank(red, q)[r * W_LDR + c];
      dw2[size_t(n0 + c) * inner + r0 + r] = s;
    }
  }
  cluster.sync();  // every remote read done before any CTA of the cluster leaves
}

// Kernel C: column j of [dgamma | dbeta | db2] (j < 3 D, over part1's n1 rows)
// or of db1 (over part2's n2 rows); the 8 warps take rows w, w + 8, ..., and
// their 8 sums are added in warp order.
__global__ void __launch_bounds__(THREADS)
    ffn_bwd_reduce_kernel(const float* __restrict__ part1, int n1, const float* __restrict__ part2,
                          int n2, int d, int inner, float* __restrict__ dgamma,
                          float* __restrict__ dbeta, float* __restrict__ db2,
                          float* __restrict__ db1) {
  __shared__ float sums[THREADS / 32][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.x * 32 + lane, w1 = 3 * d, width = w1 + 2 * inner;
  float s = 0.f;
  if (j < w1) {
    for (int r = warp; r < n1; r += THREADS / 32) s += part1[size_t(r) * w1 + j];
  } else if (j < width) {
    for (int r = warp; r < n2; r += THREADS / 32) s += part2[size_t(r) * 2 * inner + j - w1];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp || j >= width) return;
  s = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += sums[w][lane];
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

int tiles_of(int m) { return (m + BM - 1) / BM; }

template <int D>
cudaError_t launch_all(const void* x, const void* dy, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2, void* dx, void* dgamma,
                       void* dbeta, void* dw1, void* db1, void* dw2, void* db2, void* xn,
                       void* dhc, void* act, void* part, int M, int inner, float eps,
                       cudaStream_t s) {
  static std::atomic<unsigned long long> raised_a{0}, raised_b{0};
  constexpr size_t smem_a = SmemA<D>::total;
  cudaError_t e = raise_smem(ffn_bwd_rows_kernel<D>, smem_a, raised_a);
  if (e != cudaSuccess) return e;
  e = raise_smem(ffn_bwd_weights_kernel<D>, W_SMEM, raised_b);
  if (e != cudaSuccess) return e;
  const auto bf = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const int tiles = tiles_of(M), cl = cluster_size(tiles, inner / NC);
  float* part1 = static_cast<float*>(part);
  float* part2 = part1 + size_t(tiles) * cl * 3 * D;
  e = launch_cluster(ffn_bwd_rows_kernel<D>, tiles * cl, cl, smem_a, s, bf(x), bf(dy), f32(gamma),
                     f32(beta), bf(w1), f32(b1), bf(w2), static_cast<bf16*>(dx),
                     static_cast<bf16*>(xn), static_cast<bf16*>(dhc), static_cast<bf16*>(act),
                     part1, part2, M, inner, eps);
  if (e != cudaSuccess) return e;
  const int wtiles = 2 * ((2 * inner + WR - 1) / WR) + 2 * ((inner + WR - 1) / WR);
  e = launch_cluster(ffn_bwd_weights_kernel<D>, wtiles * SPLIT, SPLIT, W_SMEM, s, bf(xn),
                     bf(dhc), bf(act), bf(dy), static_cast<float*>(dw1), static_cast<float*>(dw2),
                     M, inner);
  if (e != cudaSuccess) return e;
  const int width = 3 * D + 2 * inner;
  ffn_bwd_reduce_kernel<<<(width + 31) / 32, THREADS, 0, s>>>(
      part1, tiles * cl, part2, tiles, D, inner, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<float*>(db2), static_cast<float*>(db1));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The feature width the backward kernels take.
int wd_ln_geglu_ffn_bwd_d() { return D_TAKEN; }

// The cluster size of kernel A (CTAs per 64-row tile) at M rows.
int wd_ln_geglu_ffn_bwd_cluster(int m, int inner) {
  return m > 0 && inner >= 2 * NC ? cluster_size(tiles_of(m), inner / NC) : 0;
}

// The dynamic shared memory of a CTA of the row kernel (0) or the
// weight-gradient kernel (1), bytes.
int wd_ln_geglu_ffn_bwd_smem(int which) {
  return int(which ? W_SMEM : SmemA<D_TAKEN>::total);
}

// fp32 elements of the partial-sum scratch at M rows.
long long wd_ln_geglu_ffn_bwd_part_floats(int m, int d, int inner) {
  if (m <= 0) return 0;
  const long long tiles = tiles_of(m);
  return tiles * wd_ln_geglu_ffn_bwd_cluster(m, inner) * 3 * d + tiles * 2 * inner;
}

// Launches the three kernels on `stream`; returns the CUDA error code (0 on
// success): a shape they do not take (d != 320, inner not a positive multiple
// of 64), or a launch the device refuses. Weights in parameter layout (w1
// [2 inner, d], w2 [d, inner]); dw1 [2 inner, d] and dw2 [d, inner] come back
// so. Scratch: xn [M, d], dhc [M, 2 inner], act [M, inner] (bf16) and part
// (wd_ln_geglu_ffn_bwd_part_floats fp32), all written before they are read.
int wd_ln_geglu_ffn_bwd(const void* x, const void* dy, const void* gamma, const void* beta,
                        const void* w1, const void* b1, const void* w2, void* dx, void* dgamma,
                        void* dbeta, void* dw1, void* db1, void* dw2, void* db2, void* xn,
                        void* dhc, void* act, void* part, int M, int d, int inner, float eps,
                        void* stream) {
  if (M <= 0) return cudaSuccess;
  if (d != D_TAKEN || inner <= 0 || inner % 64) return cudaErrorInvalidValue;
  return launch_all<D_TAKEN>(x, dy, gamma, beta, w1, b1, w2, dx, dgamma, dbeta, dw1, db1, dw2,
                             db2, xn, dhc, act, part, M, inner, eps,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
