// Backward of the fused LayerNorm + GEGLU feed-forward + residual, by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel worddiffusion_tpu/ops/ffn_pallas.py::_ln_ffn_bwd_kernel
// (reached through _ln_ffn_bwd_pallas -> pl.pallas_call). For x, dy [M, d] bf16,
// gamma/beta [d] fp32, W1 [d, 2*inner] bf16, b1 [2*inner] fp32 and W2 [inner, d] bf16
// (the forward's operands, row-major, contiguous) it recomputes the forward
//
//   xhat = (x - mean) * rstd,  xn = bf16(xhat * gamma + beta)
//   [a | u] = xn . W1 + b1  (fp32),  act = bf16(a * gelu_tanh(u))
//
// and returns, with the TPU kernel's dtype contract,
//
//   dact = dy . W2^T (fp32),  dh = [dact * gelu(u) | dact * a * gelu'(u)] (fp32)
//   dhc  = bf16(dh),  dxn = dhc . W1^T (fp32)
//   dx   = bf16(dy + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))),
//          dxhat = dxn * gamma
//   dgamma = sum_rows dxn * xhat, dbeta = sum_rows dxn, db1 = sum_rows dh,
//   db2 = sum_rows dy, dW1 = xn^T . dhc, dW2 = act^T . dy     (all fp32)
//
// What bounds it on this card. At the flagship width (d = 320, inner = 1280) the
// backward does 16*M*d*inner FLOP (214.7 GFLOP at M = 32768): recompute 4, dact 2,
// dxn 4, dW1 4, dW2 2. That is far above the H100's bf16 ridge of about 295 FLOP per
// byte, so it is bound by the tensor cores, as the forward is.
//
// Design. The TPU walks the row tiles in order with the six gradient sums resident
// in VMEM. CTAs on the card run in parallel and in no order, and fp32 atomics would
// make the weight gradients depend on the order in which CTAs finish, which would
// break the trainer's bitwise resume. So the sums are taken in a fixed order, in
// three launches on one stream:
//   A. one CTA of 8 warps per 64-row tile (the ragged last tile is masked; the TPU
//      version padded instead). LayerNorm with one warp per row; a loop over inner
//      in chunks of 32 columns that stages the W1 a- and g-slices and 32 rows of W2
//      in shared memory, computes the [64, 32] a, u and dact tiles with
//      nvcuda::wmma bf16 16x16x16 (fp32 accumulate), applies GEGLU and its
//      derivative in fp32, and accumulates dxn[64, d] += dhc . W1^T in wmma
//      accumulator fragments that stay in registers across the loop; then the
//      LayerNorm backward gives dx. It writes xn, dhc and act (bf16) to scratch and
//      per-tile partial sums of dgamma, dbeta, db2 and db1.
//   B. dW1 = xn^T . dhc and dW2 = act^T . dy, one CTA per 64x64 output tile, each
//      looping over M in a fixed order.
//   C. the per-tile partials summed over the tiles in order.
// Simple first: wgmma, TMA, split-M reductions and overlapped staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 64;            // rows per CTA of kernel A
constexpr int NC = 32;            // inner columns per chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;            // bf16 row padding (16 bytes) against bank conflicts
constexpr int LDW = NC + PAD;     // row stride of the staged W1 slices
constexpr int LDD = 2 * NC + PAD; // row stride of the bf16 dhc chunk [a(32) | g(32)]
constexpr int LDS = 3 * 16 + 4;   // row stride of a warp's fp32 [16, a | u | dact] scratch
constexpr int MAX_TILES = 11;     // dxn tiles per warp: ceil(d / 32) for d <= 352

// kernel B: 64x64 output tiles, 64 rows of M per step, 4 warps of 2x2 16x16 tiles
constexpr int GT = 64;
constexpr int GK = 64;
constexpr int GLD = GT + PAD;
constexpr int GWARPS = 4;
constexpr int GTHREADS = GWARPS * 32;

constexpr int RTHREADS = 256;     // kernel C

struct Layout {
  int ldx;                        // row stride of xn, dy and the staged W2 rows (bf16)
  int ldo;                        // row stride of the fp32 dxn epilogue tile
  size_t xn, dy, w1a, w1g, w2, scr, dhc, dbs, mu, rstd, out, total;  // byte offsets
};

__host__ __device__ inline size_t round_up(size_t v) { return (v + 127) / 128 * 128; }

__host__ __device__ inline Layout make_layout(int d) {
  Layout L;
  L.ldx = d + PAD;
  L.ldo = d + 4;
  const size_t row_tile = round_up(size_t(BM) * L.ldx * 2);
  const size_t w1_bytes = round_up(size_t(d) * LDW * 2);
  L.xn = 0;
  L.dy = L.xn + row_tile;
  L.w1a = L.dy + row_tile;
  L.w1g = L.w1a + w1_bytes;
  L.w2 = L.w1g + w1_bytes;
  L.scr = L.w2 + round_up(size_t(NC) * L.ldx * 2);
  L.dhc = L.scr + round_up(size_t(WARPS) * 16 * LDS * 4);
  L.dbs = L.dhc + round_up(size_t(BM) * LDD * 2);
  // The fp32 dxn tile of the epilogue reuses everything from w1a up to dbs.
  L.out = L.w1a;
  const size_t out_end = L.out + round_up(size_t(BM) * L.ldo * 4);
  size_t end = L.dbs + round_up(size_t(4) * 2 * NC * 4);
  if (out_end > end) end = out_end;
  L.mu = end;
  L.rstd = L.mu + round_up(size_t(BM) * 4);
  L.total = L.rstd + round_up(size_t(BM) * 4);
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Partial sums per row tile: [dgamma(d) | dbeta(d) | db2(d) | db1(2*inner)].
__host__ __device__ inline int partial_width(int d, int inner) { return 3 * d + 2 * inner; }

__global__ void __launch_bounds__(THREADS, 1)
ln_geglu_ffn_bwd_rows(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ dx,
                      __nv_bfloat16* __restrict__ xn_g, __nv_bfloat16* __restrict__ dhc_g,
                      __nv_bfloat16* __restrict__ act_g, float* __restrict__ part, int M, int d,
                      int inner, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(d);
  __nv_bfloat16* xn_s = reinterpret_cast<__nv_bfloat16*>(smem + L.xn);
  __nv_bfloat16* dy_s = reinterpret_cast<__nv_bfloat16*>(smem + L.dy);
  __nv_bfloat16* w1a_s = reinterpret_cast<__nv_bfloat16*>(smem + L.w1a);
  __nv_bfloat16* w1g_s = reinterpret_cast<__nv_bfloat16*>(smem + L.w1g);
  __nv_bfloat16* w2_s = reinterpret_cast<__nv_bfloat16*>(smem + L.w2);
  float* scr_s = reinterpret_cast<float*>(smem + L.scr);
  __nv_bfloat16* dhc_s = reinterpret_cast<__nv_bfloat16*>(smem + L.dhc);
  float* dbs_s = reinterpret_cast<float*>(smem + L.dbs);
  float* out_s = reinterpret_cast<float*>(smem + L.out);
  float* mu_s = reinterpret_cast<float*>(smem + L.mu);
  float* rstd_s = reinterpret_cast<float*>(smem + L.rstd);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  const int rows = M - row0 < BM ? M - row0 : BM;
  const int two_inner = 2 * inner;
  float* part_t = part + size_t(blockIdx.x) * partial_width(d, inner);

  // LayerNorm recompute and the dy tile: one warp per row. Rows past M are zero.
  for (int r = warp; r < BM; r += WARPS) {
    __nv_bfloat16* xn_r = xn_s + r * L.ldx;
    __nv_bfloat16* dy_r = dy_s + r * L.ldx;
    if (r < rows) {
      const size_t g0 = size_t(row0 + r) * d;
      const __nv_bfloat16* src = x + g0;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += __bfloat162float(src[c]);
      const float mu = warp_sum(s) / d;
      float v = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float t = __bfloat162float(src[c]) - mu;
        v += t * t;
      }
      const float rstd = rsqrtf(warp_sum(v) / d + eps);
      if (lane == 0) {
        mu_s[r] = mu;
        rstd_s[r] = rstd;
      }
      for (int c = lane; c < d; c += 32) {
        const __nv_bfloat16 xn =
            __float2bfloat16((__bfloat162float(src[c]) - mu) * rstd * gamma[c] + beta[c]);
        xn_r[c] = xn;
        xn_g[g0 + c] = xn;
        dy_r[c] = dy[g0 + c];
      }
    } else {
      if (lane == 0) {
        mu_s[r] = 0.f;
        rstd_s[r] = 0.f;
      }
      for (int c = lane; c < d; c += 32) {
        xn_r[c] = __float2bfloat16(0.f);
        dy_r[c] = __float2bfloat16(0.f);
      }
    }
  }

  // Phase-1 tile of a warp: rows ht*16.., inner columns c0 + hc*16 .. +15.
  const int ht = warp & 3;
  const int hc = warp >> 2;
  float* scr_w = scr_s + warp * 16 * LDS;
  // Phase-2 (dxn) tiles of a warp: row tile prow, column tiles pcol0, pcol0 + 2, ...
  const int n16 = d / 16;
  const int prow = warp & 3;
  const int pcol0 = warp >> 2;

  FragC acc[MAX_TILES];
#pragma unroll
  for (int i = 0; i < MAX_TILES; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int c0 = 0; c0 < inner; c0 += NC) {
    // Stage W1[:, c0:c0+32], W1[:, inner+c0:inner+c0+32] and W2[c0:c0+32, :], 16 bytes a thread.
    for (int v = tid; v < d * 8; v += THREADS) {
      const int k = v >> 3, half = (v >> 2) & 1, vec = v & 3;
      const uint4 val = *reinterpret_cast<const uint4*>(
          w1 + size_t(k) * two_inner + size_t(half) * inner + c0 + vec * 8);
      *reinterpret_cast<uint4*>((half ? w1g_s : w1a_s) + k * LDW + vec * 8) = val;
    }
    const int row_vecs = d / 8;
    for (int v = tid; v < NC * row_vecs; v += THREADS) {
      const int j = v / row_vecs, vec = v - j * row_vecs;
      *reinterpret_cast<uint4*>(w2_s + j * L.ldx + vec * 8) =
          *reinterpret_cast<const uint4*>(w2 + size_t(c0 + j) * d + vec * 8);
    }
    __syncthreads();

    // Phase 1: a = xn . W1a, u = xn . W1g, dact = dy . W2^T on the warp's 16x16 tile.
    {
      FragC fa_acc, fu_acc, fd_acc;
      wmma::fill_fragment(fa_acc, 0.f);
      wmma::fill_fragment(fu_acc, 0.f);
      wmma::fill_fragment(fd_acc, 0.f);
      FragA fx, fdy;
      FragB fb;
      FragBc fbc;
      for (int k = 0; k < d; k += 16) {
        wmma::load_matrix_sync(fx, xn_s + ht * 16 * L.ldx + k, L.ldx);
        wmma::load_matrix_sync(fdy, dy_s + ht * 16 * L.ldx + k, L.ldx);
        wmma::load_matrix_sync(fb, w1a_s + k * LDW + hc * 16, LDW);
        wmma::mma_sync(fa_acc, fx, fb, fa_acc);
        wmma::load_matrix_sync(fb, w1g_s + k * LDW + hc * 16, LDW);
        wmma::mma_sync(fu_acc, fx, fb, fu_acc);
        // W2^T[k.., j..] = W2[j.., k..]: the staged W2 rows read column-major
        wmma::load_matrix_sync(fbc, w2_s + hc * 16 * L.ldx + k, L.ldx);
        wmma::mma_sync(fd_acc, fdy, fbc, fd_acc);
      }
      wmma::store_matrix_sync(scr_w, fa_acc, LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(scr_w + 16, fu_acc, LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(scr_w + 32, fd_acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
    // GEGLU and its derivative in fp32 on the warp's own tile. act and dhc go to
    // scratch in device memory, dhc also to shared memory; fp32 dh stays in the
    // warp's scratch for the db1 column sums.
    for (int e = lane; e < 16 * 16; e += 32) {
      const int r = e >> 4, cc = e & 15;
      const int lr = ht * 16 + r;
      const int col = c0 + hc * 16 + cc;
      const float a = scr_w[r * LDS + cc] + b1[col];
      const float u = scr_w[r * LDS + 16 + cc] + b1[inner + col];
      const float dact = scr_w[r * LDS + 32 + cc];
      const float cst = 0.7978845608028654f, kk = 0.044715f;
      const float t = tanhf(cst * (u + kk * u * u * u));
      const float gu = 0.5f * u * (1.f + t);
      const float dgu = 0.5f * (1.f + t) + 0.5f * u * (1.f - t * t) * cst * (1.f + 3.f * kk * u * u);
      const bool valid = lr < rows;
      const float dha = valid ? dact * gu : 0.f;
      const float dhg = valid ? dact * a * dgu : 0.f;
      const __nv_bfloat16 ca = __float2bfloat16(dha), cg = __float2bfloat16(dhg);
      dhc_s[lr * LDD + hc * 16 + cc] = ca;
      dhc_s[lr * LDD + NC + hc * 16 + cc] = cg;
      scr_w[r * LDS + cc] = dha;
      scr_w[r * LDS + 16 + cc] = dhg;
      if (valid) {
        const size_t gr = size_t(row0 + lr);
        act_g[gr * inner + col] = __float2bfloat16(a * gu);
        dhc_g[gr * two_inner + col] = ca;
        dhc_g[gr * two_inner + inner + col] = cg;
      }
    }
    __syncwarp();
    {
      // lane l < 16: column l of dh_a, lane l >= 16: column l - 16 of dh_g
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += scr_w[r * LDS + lane];
      const int j = lane < 16 ? hc * 16 + lane : NC + hc * 16 + (lane - 16);
      dbs_s[ht * 2 * NC + j] = s;
    }
    __syncthreads();

    // db1 partials of this chunk's 64 columns, the four row tiles summed in order.
    if (tid < 2 * NC) {
      const float s = dbs_s[tid] + dbs_s[2 * NC + tid] + dbs_s[4 * NC + tid] + dbs_s[6 * NC + tid];
      const int col = tid < NC ? c0 + tid : inner + c0 + (tid - NC);
      part_t[3 * d + col] = s;
    }

    // Phase 2: dxn[64, d] += dhc[:, a] . W1a^T + dhc[:, g] . W1g^T.
    {
      FragA fa;
      FragBc fb;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat16* w = half ? w1g_s : w1a_s;
#pragma unroll
        for (int k = 0; k < NC; k += 16) {
          wmma::load_matrix_sync(fa, dhc_s + prow * 16 * LDD + half * NC + k, LDD);
#pragma unroll
          for (int i = 0; i < MAX_TILES; ++i) {
            const int ct = pcol0 + 2 * i;
            if (ct < n16) {
              // W1^T[j.., n..] = W1[n.., j..]: the staged W1 slice read column-major
              wmma::load_matrix_sync(fb, w + ct * 16 * LDW + k, LDW);
              wmma::mma_sync(acc[i], fa, fb, acc[i]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: dxn through shared memory (it reuses the staging area).
#pragma unroll
  for (int i = 0; i < MAX_TILES; ++i) {
    const int ct = pcol0 + 2 * i;
    if (ct < n16)
      wmma::store_matrix_sync(out_s + prow * 16 * L.ldo + ct * 16, acc[i], L.ldo,
                              wmma::mem_row_major);
  }
  __syncthreads();

  // LayerNorm backward, one warp per row.
  for (int r = warp; r < rows; r += WARPS) {
    const size_t g0 = size_t(row0 + r) * d;
    const float mu = mu_s[r], rstd = rstd_s[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xhat = (__bfloat162float(x[g0 + c]) - mu) * rstd;
      const float dxhat = out_s[r * L.ldo + c] * gamma[c];
      s1 += dxhat;
      s2 += dxhat * xhat;
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      const float xhat = (__bfloat162float(x[g0 + c]) - mu) * rstd;
      const float dxhat = out_s[r * L.ldo + c] * gamma[c];
      dx[g0 + c] = __float2bfloat16(__bfloat162float(dy_s[r * L.ldx + c]) +
                                    rstd * (dxhat - m1 - xhat * m2));
    }
  }

  // Column partials of dgamma, dbeta and db2 over the tile's rows, in row order.
  for (int c = tid; c < d; c += THREADS) {
    float sg = 0.f, sb = 0.f, sy = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float dxn = out_s[r * L.ldo + c];
      const float xhat = (__bfloat162float(x[size_t(row0 + r) * d + c]) - mu_s[r]) * rstd_s[r];
      sg += dxn * xhat;
      sb += dxn;
      sy += __bfloat162float(dy_s[r * L.ldx + c]);
    }
    part_t[c] = sg;
    part_t[d + c] = sb;
    part_t[2 * d + c] = sy;
  }
}

// C[P, Q] = A^T . B for A [M, P] and B [M, Q] (bf16, row-major), fp32 out; one
// 64x64 tile of C per CTA, summed over M in order. P and Q are multiples of 16,
// so a 16x16 tile is either wholly inside C or wholly outside.
__device__ void gemm_tn_tile(const __nv_bfloat16* __restrict__ A, int P,
                             const __nv_bfloat16* __restrict__ B, int Q, float* __restrict__ C,
                             int M, int p0, int q0, __nv_bfloat16* As, __nv_bfloat16* Bs) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wp = (warp >> 1) * 32, wq = (warp & 1) * 32;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int m0 = 0; m0 < M; m0 += GK) {
    // 64 rows x 64 columns of A and of B, 16 bytes a thread; zeros past M, P and Q.
    for (int v = tid; v < GK * (GT / 8); v += GTHREADS) {
      const int r = v >> 3, vec = v & 7;
      const int m = m0 + r;
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (m < M) {
        if (p0 + vec * 8 < P)
          va = *reinterpret_cast<const uint4*>(A + size_t(m) * P + p0 + vec * 8);
        if (q0 + vec * 8 < Q)
          vb = *reinterpret_cast<const uint4*>(B + size_t(m) * Q + q0 + vec * 8);
      }
      *reinterpret_cast<uint4*>(As + r * GLD + vec * 8) = va;
      *reinterpret_cast<uint4*>(Bs + r * GLD + vec * 8) = vb;
    }
    __syncthreads();
    FragAc fa[2];
    FragB fb[2];
#pragma unroll
    for (int k = 0; k < GK; k += 16) {
      // A^T[p.., m..] = A[m.., p..]: the staged rows of A read column-major
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + k * GLD + wp + i * 16, GLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + k * GLD + wq + j * 16, GLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = p0 + wp + i * 16, q = q0 + wq + j * 16;
      if (p < P && q < Q)
        wmma::store_matrix_sync(C + size_t(p) * Q + q, acc[i][j], Q, wmma::mem_row_major);
    }
}

__global__ void __launch_bounds__(GTHREADS)
ln_geglu_ffn_bwd_weights(const __nv_bfloat16* __restrict__ xn_g,
                         const __nv_bfloat16* __restrict__ dhc_g,
                         const __nv_bfloat16* __restrict__ act_g,
                         const __nv_bfloat16* __restrict__ dy, float* __restrict__ dw1,
                         float* __restrict__ dw2, int M, int d, int inner) {
  __shared__ __align__(128) __nv_bfloat16 As[GK * GLD];
  __shared__ __align__(128) __nv_bfloat16 Bs[GK * GLD];
  const int tp_d = (d + GT - 1) / GT;
  const int tq_w1 = (2 * inner + GT - 1) / GT;
  const int n_w1 = tp_d * tq_w1;
  int t = blockIdx.x;
  if (t < n_w1) {
    // dW1 [d, 2*inner] = xn^T . dhc
    gemm_tn_tile(xn_g, d, dhc_g, 2 * inner, dw1, M, (t / tq_w1) * GT, (t % tq_w1) * GT, As, Bs);
  } else {
    // dW2 [inner, d] = act^T . dy
    t -= n_w1;
    gemm_tn_tile(act_g, inner, dy, d, dw2, M, (t / tp_d) * GT, (t % tp_d) * GT, As, Bs);
  }
}

__global__ void __launch_bounds__(RTHREADS)
ln_geglu_ffn_bwd_reduce(const float* __restrict__ part, int n_tiles, int d, int inner,
                        float* __restrict__ dgamma, float* __restrict__ dbeta,
                        float* __restrict__ db2, float* __restrict__ db1) {
  const int width = partial_width(d, inner);
  const int j = blockIdx.x * RTHREADS + threadIdx.x;
  if (j >= width) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += part[size_t(t) * width + j];
  if (j < d) dgamma[j] = s;
  else if (j < 2 * d) dbeta[j - d] = s;
  else if (j < 3 * d) db2[j - 2 * d] = s;
  else db1[j - 3 * d] = s;
}

}  // namespace

extern "C" {

// Largest feature width the backward takes (its per-warp accumulator budget).
int wd_ln_geglu_ffn_bwd_max_d() { return 2 * MAX_TILES * 16; }

// Row tile of kernel A; the caller allocates ceil(M / 64) rows of partials.
int wd_ln_geglu_ffn_bwd_block_m() { return BM; }

// Launches the three kernels on `stream`; returns the CUDA error code (0 on
// success). Scratch: xn [M, d], dhc [M, 2*inner], act [M, inner] (bf16) and
// partials [ceil(M / 64), 3*d + 2*inner] (fp32), all written before they are read.
int wd_ln_geglu_ffn_bwd(const void* x, const void* dy, const void* gamma, const void* beta,
                        const void* w1, const void* b1, const void* w2, void* dx, void* dgamma,
                        void* dbeta, void* dw1, void* db1, void* dw2, void* db2, void* xn,
                        void* dhc, void* act, void* part, int M, int d, int inner, float eps,
                        void* stream) {
  if (M <= 0) return cudaSuccess;
  if (d <= 0 || d % 16 || d > 2 * MAX_TILES * 16 || inner <= 0 || inner % NC)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = make_layout(d).total;
  cudaError_t err = cudaFuncSetAttribute(
      ln_geglu_ffn_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (M + BM - 1) / BM;
  const auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  ln_geglu_ffn_bwd_rows<<<n_tiles, THREADS, smem, s>>>(
      bf(x), bf(dy), f32(gamma), f32(beta), bf(w1), f32(b1), bf(w2),
      static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(xn),
      static_cast<__nv_bfloat16*>(dhc), static_cast<__nv_bfloat16*>(act),
      static_cast<float*>(part), M, d, inner, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tp_d = (d + GT - 1) / GT;
  const int n_gemm = tp_d * ((2 * inner + GT - 1) / GT) + ((inner + GT - 1) / GT) * tp_d;
  ln_geglu_ffn_bwd_weights<<<n_gemm, GTHREADS, 0, s>>>(
      bf(xn), bf(dhc), bf(act), bf(dy), static_cast<float*>(dw1), static_cast<float*>(dw2), M,
      d, inner);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = partial_width(d, inner);
  ln_geglu_ffn_bwd_reduce<<<(width + RTHREADS - 1) / RTHREADS, RTHREADS, 0, s>>>(
      f32(part), n_tiles, d, inner, static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<float*>(db2), static_cast<float*>(db1));
  return cudaGetLastError();
}

}  // extern "C"
