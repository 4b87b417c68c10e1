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
// output's bf16 rounding; the staging route never changes the arithmetic, so the
// two layouts give the same bits.
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
// Design:
//   - a thread-block cluster of CL CTAs (1, 2 or 4) shares a tile of BM rows (64,
//     or 32 where 64-row tiles leave SMs idle) of one sample and splits the heads:
//     CTA r takes heads [r*H/CL, (r+1)*H/CL) and stages only their folds. The
//     route (BM, CL) is the first of (64, 1), (64, 2), (64, 4), (32, 1..4) that
//     gives 90% of the SMs a CTA (B = 16: 128 CTAs instead of 64 or 16; B = 128:
//     one CTA a tile, which takes all four heads);
//   - the folds are copied into shared memory as they lie, by cp.async: wt_h as
//     [C rows x L] (16-byte copies where its rows start on 16-byte boundaries,
//     an L stride that is a multiple of 8, and the last row's L rounded up to 8
//     lies inside wt's allocation; 4-byte copies for an even L, such as
//     build_folds' contiguous rows at 84*c bytes and B.7's at 84*h + 336*c; element
//     copies for an odd L), vw_h as
//     [L rows x C] in 16-byte copies; the next head's folds are copied behind the
//     current head's products where two sets fit. The mma fragments come from
//     ldmatrix (xn) and ldmatrix.trans (wt_h and vw_h, which are k-by-n
//     row-major), so nothing is transposed element by element;
//   - each CTA copies its x tile into shared memory (cp.async, ahead of the first
//     folds) and computes the tile's LayerNorm from it in fp32, one warp a row, 16
//     bytes a lane, into xn (bf16, shared memory) while the first folds land; the
//     epilogue reads x from the same tile;
//   - warp w owns rows 16*(w % (BM/16)) and the output columns of half
//     w / (BM/16); it computes its rows' [16, Lp] scores with mma.sync.m16n8k16
//     (Lp = L rounded up to 16; columns past L score -inf), the exact fp32 softmax
//     over the row in registers (Lp <= 80, no online rescaling), rounds p to bf16
//     in the score registers, which are the A operand of p . vw_h, accumulated
//     over the CTA's heads in a [16, C/2] fp32 register tile;
//   - the epilogue: each CTA writes its partial [BM, C] fp32 to shared memory,
//     cluster barrier, and CTA r sums rows [r*BM/CL, (r+1)*BM/CL) over the CL
//     partials in rank (head) order through distributed shared memory, adds x and
//     b_out in fp32 and rounds once, 16-byte stores.
// Bitwise repeatable: no atomics; for a given shape the route and every sum's
// order are fixed.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int PAD = 8;      // bf16 row padding (16 bytes): ldmatrix rows on distinct banks
constexpr int MAX_C = 320;  // the per-warp accumulator is [16, C / 2] fp32
constexpr int MAX_L = 80;   // = C / H at the UNet's widths: one head per 80 channels
constexpr int MAX_CT = MAX_C / 16;  // 8-column output tiles per warp
constexpr int SMEM_LIMIT = 227 * 1024;

// How wt's rows are copied: 16-byte, 4-byte or element copies.
enum WtRoute { WT16 = 0, WT4 = 1, WT1 = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
    f[2 * j] = __low2float(p);
    f[2 * j + 1] = __high2float(p);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

// Shared memory of a CTA, bf16 elements: with two fold buffers, the x tile
// [BM][C + PAD] apart; xn [BM][C + PAD] (which, with one buffer, first holds
// the x tile and is normalised in place); then the `bufs` fold buffers, each
// wt_h [C][LP + PAD] and vw_h [LP][C + PAD]. The epilogue's fp32 partial [BM][C
// + 4] lies over xn and the folds.
struct Layout {
  int ldx, ldw, buf;  // row strides of x, xn, vw_h and of wt_h; a buffer's elements
  int xn;             // xn's offset, elements
  size_t total;       // bytes
};

__host__ __device__ inline Layout make_layout(int bm, int c, int lp, int bufs) {
  Layout L;
  L.ldx = c + PAD;
  L.ldw = lp + PAD;
  L.buf = c * L.ldw + lp * L.ldx;
  L.xn = bufs == 2 ? bm * L.ldx : 0;
  const size_t bytes = 2 * (size_t(L.xn) + size_t(bm) * L.ldx + size_t(bufs) * L.buf);
  const size_t red = 2 * size_t(L.xn) + size_t(bm) * (c + 4) * 4;
  L.total = bytes > red ? bytes : red;
  return L;
}

// x, out [B, N, C]; wt element (b, h, c, l) at b*wt_sb + h*wt_sh + c*wt_sc + l;
// vw [B, H, L, C] contiguous; gamma, beta, bo [C] fp32. LP = L rounded up to 16.
// grid (tiles * CL, B), cluster (CL, 1, 1). BUFS fold buffers (1 or 2). STOP is
// 0 on every path; kernel_times' phase timing builds its own instances, which
// end after the LayerNorm (1), copy the folds but run no product (2), or run
// the products on folds never copied (3).
template <int LP, int BM, int BUFS, int STOP>
__global__ void __launch_bounds__(BM * 4)
    fold_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                          const bf16* __restrict__ vw, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const float* __restrict__ bo,
                          bf16* __restrict__ out, int n, int c, int heads, int l,
                          long long wt_sb, long long wt_sh, long long wt_sc, float eps,
                          int route) {
  constexpr int ST = LP / 8;          // score tiles
  constexpr int WARPS = BM / 8;       // BM / 16 row groups x 2 column halves
  constexpr int THREADS = WARPS * 32;
  constexpr int RG = BM / 16;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = static_cast<int>(cluster.num_blocks());
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = make_layout(BM, c, LP, BUFS);
  const int ldx = lay.ldx, ldw = lay.ldw;
  // the x tile: apart where there are two fold buffers (the epilogue reads x
  // from it), else xn itself (the epilogue reads x from device memory)
  constexpr bool keep_x = BUFS == 2;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [BM][ldx]
  bf16* xn = xs + lay.xn;                    // [BM][ldx]
  bf16* folds = xn + BM * ldx;
  float* red = reinterpret_cast<float*>(xn);

  const int b = blockIdx.y;
  const int row0 = (blockIdx.x / cl) * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, lr = lane & 7;  // ldmatrix: this lane's matrix and row
  const bf16* xb = x + size_t(b) * n * c;
  const int hpc = heads / cl, h0 = rank * hpc;  // this CTA's heads
  const int nh = STOP == 1 ? 0 : hpc;
  const int cv = c / 8;

  // head h0 + i's folds into buffer i % BUFS: wt_h rows as they lie (columns
  // past L are left as they are: their scores are overwritten with -inf), vw_h
  // rows in 16-byte copies, rows l .. LP zero
  auto stage = [&](int i) {
    if constexpr (STOP == 3) return;
    bf16* wts = folds + (i % BUFS) * lay.buf;
    bf16* vws = wts + c * ldw;
    const int h = h0 + i;
    const bf16* wth = wt + b * wt_sb + h * wt_sh;
    if (route == WT16) {
      const int per = (l + 7) / 8;
      for (int k = tid; k < c * per; k += THREADS) {
        const int cc = k / per, j = k % per;
        cp_async16_zfill(wts + cc * ldw + j * 8, wth + cc * wt_sc + j * 8, true);
      }
    } else if (route == WT4) {
      const int per = l / 2;
      for (int k = tid; k < c * per; k += THREADS) {
        const int cc = k / per, j = k % per;
        cp_async4(wts + cc * ldw + j * 2, wth + cc * wt_sc + j * 2);
      }
    } else {
      for (int k = tid; k < c * l; k += THREADS) {
        const int cc = k / l, j = k % l;
        wts[cc * ldw + j] = wth[cc * wt_sc + j];
      }
    }
    const bf16* vwh = vw + (size_t(b) * heads + h) * l * c;
    for (int k = tid; k < LP * cv; k += THREADS) {
      const int r = k / cv, j = k % cv;
      cp_async16_zfill(vws + r * ldx + j * 8, vwh + (r < l ? size_t(r) * c + j * 8 : 0), r < l);
    }
  };
  // the x tile (rows past n zero), then head 0's folds: two copy groups
  for (int k = tid; k < BM * cv; k += THREADS) {
    const int r = k / cv, j = k % cv, row = row0 + r;
    cp_async16_zfill(xs + r * ldx + j * 8, xb + (row < n ? size_t(row) * c + j * 8 : 0), row < n);
  }
  cp_async_commit();
  stage(0);
  cp_async_commit();
  // gamma and beta of this lane's channels 8 (lane + 32 k) .. + 7
  float gm[2][8], bt[2][8];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = lane + 32 * k;
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      const float4 g4 = j < cv ? *reinterpret_cast<const float4*>(gamma + j * 8 + e)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b4 = j < cv ? *reinterpret_cast<const float4*>(beta + j * 8 + e)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      gm[k][e] = g4.x; gm[k][e + 1] = g4.y; gm[k][e + 2] = g4.z; gm[k][e + 3] = g4.w;
      bt[k][e] = b4.x; bt[k][e + 1] = b4.y; bt[k][e + 2] = b4.z; bt[k][e + 3] = b4.w;
    }
  }
  cp_async_wait<1>();  // this thread's copies of the x tile have landed
  __syncthreads();

  // LayerNorm from the x tile, one warp a row, 8 channels a lane and vector;
  // rows past n are zero (computed on, not stored).
  for (int r = warp; r < BM; r += WARPS) {
    bf16* dst = xn + r * ldx;
    const int row = row0 + r;
    if (row >= n) {
      for (int j = lane; j < cv; j += 32)
        *reinterpret_cast<uint4*>(dst + j * 8) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const bf16* src = xs + r * ldx;
    float f[2][8];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = lane + 32 * k;
#pragma unroll
      for (int e = 0; e < 8; ++e) f[k][e] = 0.f;
      if (j < cv) unpack8(*reinterpret_cast<const uint4*>(src + j * 8), f[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[k][e];
    }
    const float mu = warp_sum(s) / c;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (lane + 32 * k < cv)
#pragma unroll
        for (int e = 0; e < 8; ++e) v += (f[k][e] - mu) * (f[k][e] - mu);
    const float rstd = rsqrtf(warp_sum(v) / c + eps);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = lane + 32 * k;
      if (j >= cv) break;
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = (f[k][e] - mu) * rstd * gm[k][e] + bt[k][e];
      *reinterpret_cast<uint4*>(dst + j * 8) = make_uint4(
          pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
    }
  }

  const int r0 = (warp % RG) * 16;      // this warp's rows in the tile
  const int ct = c / 16;                // its 8-column output tiles
  const int c0 = (warp / RG) * (c / 2); // its first output column
  float acc[MAX_CT][4];
#pragma unroll
  for (int i = 0; i < MAX_CT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int i = 0; i < nh; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // head i's folds (and, the first time, xn) are in for all;
                      // every warp is done with head i - 1's buffer
    if (BUFS == 2 && i + 1 < hpc) {
      stage(i + 1);  // into head i - 1's buffer, behind this head's products
      cp_async_commit();
    }
    if constexpr (STOP == 2) continue;
    const bf16* wts = folds + (i % BUFS) * lay.buf;
    const bf16* vws = wts + c * ldw;

    // s = xn . wt_h for the warp's 16 rows: s[j] is the m16n8 accumulator of
    // columns 8j .. 8j + 7 (s[j][0..1] row g, s[j][2..3] row g + 8)
    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // Each step's fragments are all loaded before its products issue, so
    // their latencies overlap one another and the last step's products.
    for (int ks = 0; ks < c / 16; ++ks) {
      uint32_t a[4], bb[ST / 2][4];  // bb[q]: k rows 16 ks .., columns 16q .. + 15 of wt_h
      ldmatrix_x4(a, xn + (r0 + lr + (mi & 1) * 8) * ldx + ks * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int q = 0; q < ST / 2; ++q)
        ldmatrix_x4_trans(bb[q], wts + (ks * 16 + (mi & 1) * 8 + lr) * ldw + (2 * q + (mi >> 1)) * 8);
#pragma unroll
      for (int q = 0; q < ST / 2; ++q) {
        mma_bf16(s[2 * q], a, bb[q][0], bb[q][1]);
        mma_bf16(s[2 * q + 1], a, bb[q][2], bb[q][3]);
      }
    }

    // exact fp32 softmax over the row's L columns
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      const int col = j * 8 + 2 * t;
      if (col >= l) s[j][0] = s[j][2] = -INFINITY;
      if (col + 1 >= l) s[j][1] = s[j][3] = -INFINITY;
      m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
      m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      s[j][0] = __expf(s[j][0] - m[0]);
      s[j][1] = __expf(s[j][1] - m[0]);
      s[j][2] = __expf(s[j][2] - m[1]);
      s[j][3] = __expf(s[j][3] - m[1]);
      sum[0] += s[j][0] + s[j][1];
      sum[1] += s[j][2] + s[j][3];
    }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);

    // acc += bf16(p) . vw_h: the accumulators of score tiles 2kk and 2kk + 1 are
    // the A fragment of columns 16kk .. 16kk + 15
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 2 * kk + hh;
        pa[2 * hh] = pack_bf16(s[j][0] / sum[0], s[j][1] / sum[0]);
        pa[2 * hh + 1] = pack_bf16(s[j][2] / sum[1], s[j][3] / sum[1]);
      }
      // five fragment loads, then their ten products, twice
#pragma unroll
      for (int n0 = 0; n0 < MAX_CT; n0 += 10) {
        uint32_t bb[5][4];  // bb[q]: k rows 16 kk .., columns c0 + 8 (n0 + 2q) .. + 15 of vw_h
#pragma unroll
        for (int q = 0; q < 5; ++q)
          if (n0 + 2 * q < ct)
            ldmatrix_x4_trans(bb[q], vws + (kk * 16 + (mi & 1) * 8 + lr) * ldx + c0 +
                                         (n0 + 2 * q + (mi >> 1)) * 8);
#pragma unroll
        for (int q = 0; q < 5; ++q)
          if (n0 + 2 * q < ct) {
            mma_bf16(acc[n0 + 2 * q], pa, bb[q][0], bb[q][1]);
            mma_bf16(acc[n0 + 2 * q + 1], pa, bb[q][2], bb[q][3]);
          }
      }
    }
    if (BUFS == 1 && i + 1 < hpc) {
      __syncthreads();  // every warp done with the one buffer
      stage(i + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every product done: the partial goes over xn and the folds

  const int ldr = c + 4;
#pragma unroll
  for (int nt = 0; nt < MAX_CT; ++nt) {
    if (nt < ct) {
      const int col = c0 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(red + (r0 + g) * ldr + col) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(red + (r0 + g + 8) * ldr + col) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  cluster.sync();

  // rows [rank * BM / CL, ...) of the tile: y = bf16(x + sum of the CL partials
  // in head order + b_out), 8 columns a thread and step
  const int rows = BM / cl;
  bf16* ob = out + size_t(b) * n * c;
#pragma unroll 4
  for (int k = tid; k < rows * cv; k += THREADS) {
    const int r = rank * rows + k / cv, j = k % cv, row = row0 + r;
    if (row >= n) continue;
    float y[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < cl; ++q) {
      const float* src = cluster.map_shared_rank(red, q) + r * ldr + j * 8;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      y[0] += lo.x; y[1] += lo.y; y[2] += lo.z; y[3] += lo.w;
      y[4] += hi.x; y[5] += hi.y; y[6] += hi.z; y[7] += hi.w;
    }
    float xv[8];
    unpack8(*reinterpret_cast<const uint4*>(keep_x ? xs + r * ldx + j * 8
                                                   : xb + size_t(row) * c + j * 8), xv);
    const float4 b0 = *reinterpret_cast<const float4*>(bo + j * 8);
    const float4 b1 = *reinterpret_cast<const float4*>(bo + j * 8 + 4);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = xv[e] + y[e] + bv[e];
    *reinterpret_cast<uint4*>(ob + size_t(row) * c + j * 8) = make_uint4(
        pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
  }
  cluster.sync();  // every remote read done before any CTA of the cluster leaves
}

// The SMs of the current device, read once.
int sm_count() {
  static std::atomic<int> cached{0};
  int sms = cached.load();
  if (sms) return sms;
  int dev = 0;
  sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cached.store(sms);
  return sms;
}

// The route: (BM, CL), the first of (64, 1), (64, 2), (64, 4), (32, 1), (32,
// 2), (32, 4) that gives 90% of the SMs a CTA (the last where none does); CL
// divides heads. More CTAs than that only repeat the LayerNorm and add the
// cluster's exchange (kernel_times.py: fold routes).
void pick_route(int b, int n, int heads, int* bm, int* cl) {
  const int sms = sm_count();
  const int opts[6][2] = {{64, 1}, {64, 2}, {64, 4}, {32, 1}, {32, 2}, {32, 4}};
  *bm = 64;
  *cl = 1;
  for (const auto& o : opts) {
    if (heads % o[1]) continue;
    *bm = o[0];
    *cl = o[1];
    if (10LL * b * ((n + o[0] - 1) / o[0]) * o[1] >= 9LL * sms) break;
  }
}

// How wt's rows can be copied: 16 bytes at a time where every row starts on a
// 16-byte boundary and its copy of L rounded up to 8 stays inside wt's
// allocation (room: the elements from wt to its end), 4 bytes at a time for an
// even L on 4-byte boundaries, else element by element.
int wt_route(const void* wt, int b, int heads, int c, int l, long long sb, long long sh,
             long long sc, long long room) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(wt);
  const long long last = (b - 1) * sb + (heads - 1) * sh + (c - 1) * sc;  // the last row
  if (p % 16 == 0 && sb % 8 == 0 && sh % 8 == 0 && sc % 8 == 0 &&
      (l % 8 == 0 || last + (l + 7) / 8 * 8 <= room))
    return WT16;
  if (l % 2 == 0 && p % 4 == 0 && sb % 2 == 0 && sh % 2 == 0 && sc % 2 == 0) return WT4;
  return WT1;
}

// Fold buffers: two (the next head's folds copied behind the current head's
// products, the x tile kept) where a CTA takes more than one head and they fit.
int auto_bufs(int bm, int c, int lp, int hpc) {
  return hpc > 1 && make_layout(bm, c, lp, 2).total <= size_t(SMEM_LIMIT) ? 2 : 1;
}

// The operands of a launch, as wd_fold_attention takes them.
struct Args {
  const void *x, *wt, *vw, *gamma, *beta, *bo;
  void* out;
  int b, n, c, heads, l;
  long long wt_sb, wt_sh, wt_sc, wt_room;
  float eps;
};

template <int LP, int BM, int BUFS, int STOP>
cudaError_t launch(const Args& a, int cl, cudaStream_t stream) {
  const size_t smem = make_layout(BM, a.c, LP, BUFS).total;
  if (smem > size_t(SMEM_LIMIT)) return cudaErrorInvalidValue;
  // The instance's shared memory limit is raised to the most a CTA may have,
  // once per device: the attribute call costs host time of the order of the
  // launch itself.
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(fold_attention_kernel<LP, BM, BUFS, STOP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned((a.n + BM - 1) / BM) * cl, unsigned(a.b));
  cfg.blockDim = dim3(BM * 4);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, fold_attention_kernel<LP, BM, BUFS, STOP>, static_cast<const bf16*>(a.x),
      static_cast<const bf16*>(a.wt), static_cast<const bf16*>(a.vw),
      static_cast<const float*>(a.gamma), static_cast<const float*>(a.beta),
      static_cast<const float*>(a.bo), static_cast<bf16*>(a.out), a.n, a.c, a.heads, a.l,
      a.wt_sb, a.wt_sh, a.wt_sc, a.eps,
      wt_route(a.wt, a.b, a.heads, a.c, a.l, a.wt_sb, a.wt_sh, a.wt_sc, a.wt_room));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int LP, int BM, int STOP>
cudaError_t launch_bufs(const Args& a, int cl, int bufs, cudaStream_t s) {
  return bufs == 2 ? launch<LP, BM, 2, STOP>(a, cl, s) : launch<LP, BM, 1, STOP>(a, cl, s);
}

// The instance for L's LP; the phase-timing instances (STOP > 0) are built for
// LP = 48 only (33 <= L <= 48: the UNet's 42).
template <int BM, int STOP>
cudaError_t launch_lp(const Args& a, int cl, int bufs, cudaStream_t s) {
  const int lp = (a.l + 15) / 16 * 16;
  if constexpr (STOP > 0) {
    return lp == 48 ? launch_bufs<48, BM, STOP>(a, cl, bufs, s) : cudaErrorInvalidValue;
  } else {
    switch (lp) {
      case 16: return launch_bufs<16, BM, 0>(a, cl, bufs, s);
      case 32: return launch_bufs<32, BM, 0>(a, cl, bufs, s);
      case 48: return launch_bufs<48, BM, 0>(a, cl, bufs, s);
      case 64: return launch_bufs<64, BM, 0>(a, cl, bufs, s);
      case 80: return launch_bufs<80, BM, 0>(a, cl, bufs, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <int BM>
cudaError_t launch_stop(const Args& a, int cl, int bufs, int stop, cudaStream_t s) {
  switch (stop) {
    case 0: return launch_lp<BM, 0>(a, cl, bufs, s);
    case 1: return launch_lp<BM, 1>(a, cl, bufs, s);
    case 2: return launch_lp<BM, 2>(a, cl, bufs, s);
    case 3: return launch_lp<BM, 3>(a, cl, bufs, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(const Args& a) {
  return a.b >= 1 && a.b <= 65535 && a.n >= 1 && a.heads >= 1 && a.l >= 1 && a.l <= MAX_L &&
         a.heads * a.l <= a.c && a.c % 16 == 0 && a.c <= MAX_C;
}

}  // namespace

extern "C" {

int wd_fold_attention_max_c() { return MAX_C; }
int wd_fold_attention_max_l() { return MAX_L; }

// The dynamic shared memory of a CTA, bytes.
int wd_fold_attention_smem(int bm, int c, int lp, int bufs) {
  return int(make_layout(bm, c, lp, bufs).total);
}

// The route at these shapes: BM * 16 + CL (rows a tile; CTAs a cluster).
int wd_fold_attention_route(int b, int n, int heads) {
  int bm, cl;
  pick_route(b, n, heads, &bm, &cl);
  return bm * 16 + cl;
}

// How wt's rows are copied at these shapes and strides, with wt_room elements
// from wt to the end of its allocation: 0 16-byte, 1 4-byte, 2 element copies.
int wd_fold_attention_wt_route(const void* wt, int b, int heads, int c, int l, long long wt_sb,
                               long long wt_sh, long long wt_sc, long long wt_room) {
  return wt_route(wt, b, heads, c, l, wt_sb, wt_sh, wt_sc, wt_room);
}

// out [b, n, c] = x + sum_h softmax(LN(x) . wt_h) . vw_h + bo, with x and out bf16
// [b, n, c] contiguous and 16-byte aligned; wt bf16, element (b, h, c, l) at
// b*wt_sb + h*wt_sh + c*wt_sc + l, with wt_room elements from wt to the end of
// its allocation; vw bf16 [b, heads, l, c] contiguous and 16-byte aligned;
// gamma, beta, bo fp32 [c]. Needs c % 16 == 0, c <= MAX_C, 1 <= l <= MAX_L and
// heads * l <= c. Returns a cudaError_t (0 on success).
int wd_fold_attention(const void* x, const void* wt, const void* vw, const void* gamma,
                      const void* beta, const void* bo, void* out, int b, int n, int c,
                      int heads, int l, long long wt_sb, long long wt_sh, long long wt_sc,
                      long long wt_room, float eps, void* stream) {
  const Args a{x, wt, vw, gamma, beta, bo, out, b, n, c, heads, l, wt_sb, wt_sh, wt_sc, wt_room,
               eps};
  if (!valid(a)) return cudaErrorInvalidValue;
  int bm, cl;
  pick_route(b, n, heads, &bm, &cl);
  const int bufs = auto_bufs(bm, c, (l + 15) / 16 * 16, heads / cl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bm == 64 ? launch_lp<64, 0>(a, cl, bufs, s) : launch_lp<32, 0>(a, cl, bufs, s);
}

// As wd_fold_attention on a route given (kernel_times sweeps it): bm 64 or 32,
// cl 1, 2 or 4 dividing heads, bufs 1 or 2 fold buffers (0: as
// wd_fold_attention picks), and stop 0 (the whole kernel) or, for
// 33 <= l <= 48, a phase to stop at (see the kernel).
int wd_fold_attention_routed(const void* x, const void* wt, const void* vw, const void* gamma,
                             const void* beta, const void* bo, void* out, int b, int n, int c,
                             int heads, int l, long long wt_sb, long long wt_sh, long long wt_sc,
                             long long wt_room, float eps, int bm, int cl, int bufs, int stop,
                             void* stream) {
  const Args a{x, wt, vw, gamma, beta, bo, out, b, n, c, heads, l, wt_sb, wt_sh, wt_sc, wt_room,
               eps};
  if (!valid(a) || (bm != 64 && bm != 32) || (cl != 1 && cl != 2 && cl != 4) || heads % cl ||
      bufs < 0 || bufs > 2)
    return cudaErrorInvalidValue;
  if (!bufs) bufs = auto_bufs(bm, c, (l + 15) / 16 * 16, heads / cl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bm == 64 ? launch_stop<64>(a, cl, bufs, stop, s) : launch_stop<32>(a, cl, bufs, stop, s);
}

}  // extern "C"
