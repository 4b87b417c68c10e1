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
// here the heads accumulate one after another into the same fp32 registers. The
// orders differ only in fp32 rounding, far below the output's bf16 rounding.
//
// What bounds it on this card. At the iam UNet's shapes (C = 320, H = 4, L = 42,
// N = 256 or 64 tokens) the work is 4*B*N*C*H*L FLOP on B*N*C*2 bytes of x, as many
// of y, and 2*B*H*L*C*2 bytes of folds. At B = 128, N = 256: 7.0 GFLOP against
// 69 MB (x and y 42 MB, folds 27.5 MB), about 100 FLOP per byte, under the bf16
// ridge of about 295: memory-bound, 21 us at 3.35 TB/s (7.1 us of tensor work at
// 989 TFLOP/s). At B = 16 the bound is 2.6 us, where a launch's own latency
// counts. The plain composition launches about ten kernels and writes LN(x), the
// [N, H, L] scores and probabilities and the [N, C] product to memory between them;
// here none of them leaves the SM.
//
// Design (simple first; TMA, wgmma and a persistent grid are later work):
//   - one CTA of 8 warps per (sample, tile of 64 rows). The folds are per sample,
//     so a larger tile stages them fewer times; 64 rows still give B*N/64 CTAs
//     (512 at B = 128, N = 256);
//   - LayerNorm of the tile in fp32, one warp per row; xn is kept in shared
//     memory as bf16 for all heads;
//   - per head: wt_h is staged transposed, [Lp][C], and vw_h transposed, [C][Lp]
//     (Lp = L rounded up to 16; the padded columns are zero), so that every mma
//     operand is a 32-bit shared-memory load. wt_h's rows start at byte offsets
//     like 84*h that break 16-byte loads, so it is staged element by element;
//     vw_h's rows are C wide and come in 16-byte vectors;
//   - warp w owns rows 16*(w % 4) and the output columns of half w / 4. The two
//     warps of a row group both compute its [16, Lp] scores with
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate, K = C); columns past L score
//     -inf; the exact fp32 softmax runs over the whole row in registers (Lp <= 80,
//     so no online rescaling is needed); p is rounded to bf16 in the score
//     accumulators' registers, which are the A operand of p . vw_h;
//   - p . vw_h accumulates into a [16, C/2] fp32 tile in registers across the
//     heads; the epilogue adds x and b_out in fp32 and rounds once.
// Shared memory is (64 + Lp) * (C + 8) * 2 + C * (Lp + 8) * 2 bytes, 109 KB at
// C = 320, L = 42: dynamic, above the 48 KB default, so the launch raises the
// kernel's limit with cudaFuncSetAttribute first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;      // rows per CTA
constexpr int WARPS = 8;    // 4 row groups of 16 x 2 column halves
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;      // bf16 row padding (16 bytes) against bank conflicts
constexpr int MAX_C = 320;  // the per-warp accumulator is [16, C / 2] fp32
constexpr int MAX_L = 80;   // = C / H at the UNet's widths: one head per 80 channels
constexpr int MAX_CT = MAX_C / 16;  // 8-column output tiles per warp

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring bf16 (the lower column in the low half, as mma expects).
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Element loads issued per thread before their stores: a batch of loads in
// flight hides the L2 latency that one load after another would pay each time.
constexpr int STAGE_BATCH = 8;

// wt_h [c, l] (element (c, l) at c*wt_sc + l) -> wts [LP][ldx] transposed;
// columns l .. LP are zero. Element loads: B.7's rows start at byte offsets
// like 84*h, which 16-byte loads cannot take.
template <int LP>
__device__ __forceinline__ void stage_wt(bf16* wts, const bf16* wth, int c, int l,
                                         long long wt_sc, int ldx) {
  const int total = LP * c;
  for (int i0 = threadIdx.x; i0 < total; i0 += THREADS * STAGE_BATCH) {
    bf16 v[STAGE_BATCH];
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * THREADS;
      const int cc = i / LP, ll = i % LP;  // neighbouring threads read neighbouring l
      v[u] = i < total && ll < l ? wth[cc * wt_sc + ll] : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * THREADS;
      if (i < total) wts[(i % LP) * ldx + i / LP] = v[u];
    }
  }
}

// vw_h [l, c] row-major -> vws [c][LP + PAD] transposed, in 16-byte loads;
// rows l .. LP are zero. Neighbouring threads take neighbouring rows of one
// 8-column slice, so that their transposed stores are neighbours too (with
// neighbouring slices instead, every store of a warp would hit one bank).
template <int LP>
__device__ __forceinline__ void stage_vw(bf16* vws, const bf16* vwh, int c, int l) {
  constexpr int LDV = LP + PAD;
  constexpr int BATCH = STAGE_BATCH / 2;
  const int total = LP * (c / 8);
  for (int i0 = threadIdx.x; i0 < total; i0 += THREADS * BATCH) {
    uint4 val[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * THREADS, ll = i % LP, cc = (i / LP) * 8;
      val[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && ll < l) val[u] = *reinterpret_cast<const uint4*>(vwh + size_t(ll) * c + cc);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * THREADS, ll = i % LP, cc = (i / LP) * 8;
      if (i >= total) break;
      const uint32_t w[4] = {val[u].x, val[u].y, val[u].z, val[u].w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        vws[(cc + j) * LDV + ll] =
            __ushort_as_bfloat16(static_cast<unsigned short>(w[j / 2] >> (16 * (j % 2))));
    }
  }
}

size_t smem_bytes(int c, int lp) {
  return sizeof(bf16) * (size_t(BM + lp) * (c + PAD) + size_t(c) * (lp + PAD));
}

// x, out [B, N, C]; wt element (b, h, c, l) at b*wt_sb + h*wt_sh + c*wt_sc + l;
// vw [B, H, L, C] contiguous; gamma, beta, bo [C] fp32. LP = L rounded up to 16.
template <int LP>
__global__ void __launch_bounds__(THREADS)
    fold_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                          const bf16* __restrict__ vw, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const float* __restrict__ bo,
                          bf16* __restrict__ out, int n, int c, int heads, int l,
                          long long wt_sb, long long wt_sh, long long wt_sc, float eps) {
  constexpr int ST = LP / 8;  // score tiles
  constexpr int LDV = LP + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = c + PAD;
  bf16* xn = reinterpret_cast<bf16*>(smem);  // [BM][ldx]
  bf16* wts = xn + BM * ldx;                 // [LP][ldx]: wt_h transposed
  bf16* vws = wts + LP * ldx;                // [c][LDV]:  vw_h transposed

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* xb = x + size_t(b) * n * c;

  // LayerNorm, one warp per row; rows past n are zero (computed on, not stored).
  for (int r = warp; r < BM; r += WARPS) {
    bf16* dst = xn + r * ldx;
    const int row = row0 + r;
    if (row >= n) {
      for (int j = lane; j < c; j += 32) dst[j] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* src = xb + size_t(row) * c;
    float s = 0.f;
    for (int j = lane; j < c; j += 32) s += __bfloat162float(src[j]);
    const float mu = warp_sum(s) / c;
    float v = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float d = __bfloat162float(src[j]) - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / c + eps);
    for (int j = lane; j < c; j += 32)
      dst[j] = __float2bfloat16((__bfloat162float(src[j]) - mu) * rstd * gamma[j] + beta[j]);
  }

  const int r0 = (warp & 3) * 16;     // this warp's rows in the tile
  const int ct = c / 16;              // its 8-column output tiles
  const int c0 = (warp >> 2) * (c / 2);  // its first output column
  float acc[MAX_CT][4];
#pragma unroll
  for (int i = 0; i < MAX_CT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int h = 0; h < heads; ++h) {
    __syncthreads();  // xn is written; the previous head's folds are consumed
    stage_wt<LP>(wts, wt + b * wt_sb + h * wt_sh, c, l, wt_sc, ldx);
    stage_vw<LP>(vws, vw + (size_t(b) * heads + h) * l * c, c, l);
    __syncthreads();

    // s = xn . wt_h for the warp's 16 rows: s[j] is the m16n8 accumulator of
    // columns 8j .. 8j + 7 (s[j][0..1] row g, s[j][2..3] row g + 8).
    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int ks = 0; ks < c / 16; ++ks) {
      const bf16* ap = xn + (r0 + g) * ldx + ks * 16 + 2 * t;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * ldx), ld32(ap + 8), ld32(ap + 8 * ldx + 8)};
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        const bf16* bp = wts + (j * 8 + g) * ldx + ks * 16 + 2 * t;
        mma_bf16(s[j], a, ld32(bp), ld32(bp + 8));
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
#pragma unroll
      for (int nt = 0; nt < MAX_CT; ++nt) {
        if (nt < ct) {
          const bf16* vp = vws + (c0 + nt * 8 + g) * LDV + kk * 16 + 2 * t;
          mma_bf16(acc[nt], pa, ld32(vp), ld32(vp + 8));
        }
      }
    }
  }

  // y = bf16(x + acc + b_out), summed in fp32 in the bodies' order
  bf16* ob = out + size_t(b) * n * c;
  const int row_a = row0 + r0 + g, row_b = row_a + 8;
#pragma unroll
  for (int nt = 0; nt < MAX_CT; ++nt) {
    if (nt < ct) {
      const int col = c0 + nt * 8 + 2 * t;
      const float b0 = bo[col], b1 = bo[col + 1];
      if (row_a < n) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xb + size_t(row_a) * c + col));
        *reinterpret_cast<uint32_t*>(ob + size_t(row_a) * c + col) =
            pack_bf16(xv.x + acc[nt][0] + b0, xv.y + acc[nt][1] + b1);
      }
      if (row_b < n) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xb + size_t(row_b) * c + col));
        *reinterpret_cast<uint32_t*>(ob + size_t(row_b) * c + col) =
            pack_bf16(xv.x + acc[nt][2] + b0, xv.y + acc[nt][3] + b1);
      }
    }
  }
}

template <int LP>
cudaError_t launch(const void* x, const void* wt, const void* vw, const void* gamma,
                   const void* beta, const void* bo, void* out, int b, int n, int c, int heads,
                   int l, long long wt_sb, long long wt_sh, long long wt_sc, float eps,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(c, LP);
  cudaError_t err = cudaFuncSetAttribute(fold_attention_kernel<LP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM, b);
  fold_attention_kernel<LP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), static_cast<const bf16*>(vw),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(bo), static_cast<bf16*>(out), n, c, heads, l, wt_sb, wt_sh,
      wt_sc, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int wd_fold_attention_max_c() { return MAX_C; }
int wd_fold_attention_max_l() { return MAX_L; }

// out [b, n, c] = x + sum_h softmax(LN(x) . wt_h) . vw_h + bo, with x and out bf16
// [b, n, c] contiguous and 16-byte aligned; wt bf16, element (b, h, c, l) at
// b*wt_sb + h*wt_sh + c*wt_sc + l; vw bf16 [b, heads, l, c] contiguous and 16-byte
// aligned; gamma, beta, bo fp32 [c]. Needs c % 16 == 0, c <= MAX_C, 1 <= l <= MAX_L
// and heads * l <= c. Returns a cudaError_t (0 on success).
int wd_fold_attention(const void* x, const void* wt, const void* vw, const void* gamma,
                      const void* beta, const void* bo, void* out, int b, int n, int c,
                      int heads, int l, long long wt_sb, long long wt_sh, long long wt_sc,
                      float eps, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || heads < 1 || l < 1 || l > MAX_L || heads * l > c ||
      c % 16 || c > MAX_C)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((l + 15) / 16) {
    case 1: return launch<16>(x, wt, vw, gamma, beta, bo, out, b, n, c, heads, l, wt_sb, wt_sh, wt_sc, eps, s);
    case 2: return launch<32>(x, wt, vw, gamma, beta, bo, out, b, n, c, heads, l, wt_sb, wt_sh, wt_sc, eps, s);
    case 3: return launch<48>(x, wt, vw, gamma, beta, bo, out, b, n, c, heads, l, wt_sb, wt_sh, wt_sc, eps, s);
    case 4: return launch<64>(x, wt, vw, gamma, beta, bo, out, b, n, c, heads, l, wt_sb, wt_sh, wt_sc, eps, s);
    case 5: return launch<80>(x, wt, vw, gamma, beta, bo, out, b, n, c, heads, l, wt_sb, wt_sh, wt_sc, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
