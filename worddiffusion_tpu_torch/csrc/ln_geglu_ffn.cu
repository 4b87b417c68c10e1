// Fused LayerNorm + GEGLU feed-forward + residual, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel worddiffusion_tpu/ops/ffn_pallas.py::_ln_ffn_kernel
// (reached through _ln_geglu_ffn_pallas -> _run_ffn_pallas -> pl.pallas_call). For
// x [M, d] bf16, gamma/beta [d] fp32, W1 [d, 2*inner] bf16, b1 [2*inner] fp32,
// W2 [inner, d] bf16 and b2 [d] fp32 (all row-major, contiguous):
//
//   xn      = bf16((x - mean) * rsqrt(var + eps) * gamma + beta)   fp32 two-pass stats
//   [a | g] = xn . W1 + b1                                           fp32 accumulate
//   act     = bf16(a * gelu_tanh(g))
//   out     = bf16(fp32(x) + act . W2 + b2)
//
// What bounds it on this card. At the flagship width (d = 320, inner = 1280) and
// M = 32768 rows the sub-layer does 6*M*d*inner = 80.5 GFLOP but needs only the
// x-in and out streams (about 42 MB) plus 2.4 MB of weights, which stay resident
// in the 50 MB L2: about 1,800 FLOP per byte of device memory, far above the
// H100's bf16 ridge of about 295. The unfused form also writes and reads back the
// [M, 2*inner] intermediate (about 168 MB at that M). So the fused form is bound
// by the tensor cores, and the point of the kernel, as on the TPU, is that the
// [M, 2*inner] intermediate never reaches device memory.
//
// Design (simple first; wgmma, TMA, warp specialisation and persistent CTAs are
// later work):
//   - one CTA of 8 warps per 64-row tile; the ragged last tile is masked here
//     (the TPU version padded instead);
//   - LayerNorm with one warp per row, fp32 two-pass statistics, xn kept in
//     shared memory as bf16;
//   - a loop over inner in chunks of 64 columns. Each chunk stages the matching
//     a- and g-slices of W1 and the 64 rows of W2 in shared memory, computes the
//     [64, 64] a and g tiles with nvcuda::wmma bf16 16x16x16 (fp32 accumulate),
//     applies bias + tanh-GEGLU in fp32 and keeps the bf16 act chunk in shared
//     memory, then accumulates out[64, d] += act . W2[chunk, :] in wmma
//     accumulator fragments that stay in registers across the whole loop;
//   - epilogue: + b2 + the fp32 residual, stored as bf16.
//
// A second launch mode, wd_geglu_ffn, replaces the Pallas TPU kernel
// worddiffusion_tpu/ops/ffn_pallas.py::_ffn_kernel (reached through
// fused_geglu_ffn -> _geglu_ffn_pallas -> _run_ffn_pallas -> pl.pallas_call):
// the bare GEGLU feed-forward out = bf16(act . W2 + b2), with no LayerNorm and
// no residual. The x tile goes into the xn buffer as it is (16-byte copies)
// and the epilogue leaves the residual out; everything else is shared. It is
// bound the same way: 6*M*d*inner operations on the tensor cores against
// 4*M*d bytes of x and out, far above the ridge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 64;            // rows per CTA
constexpr int NC = 64;            // inner columns per chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;            // bf16 row padding (16 bytes) against bank conflicts
constexpr int LDW = NC + PAD;     // row stride of the staged W1 slices and of act
constexpr int LDH = NC + 4;       // row stride of a warp's fp32 [16, a(32) | g(32)] scratch
constexpr int MAX_TILES = 11;     // out tiles per warp: ceil(d / 32) for d <= 352

struct Layout {
  int ldx;                        // row stride of xn and of the staged W2 rows (bf16)
  int ldo;                        // row stride of the fp32 epilogue tile
  size_t xn, w1a, w1g, out, w2, h, act, total;  // byte offsets into shared memory
};

__host__ __device__ inline size_t round_up(size_t v) { return (v + 127) / 128 * 128; }

__host__ __device__ inline Layout make_layout(int d) {
  Layout L;
  L.ldx = d + PAD;
  L.ldo = d + 4;
  const size_t xn_bytes = size_t(BM) * L.ldx * 2;
  const size_t w1_bytes = round_up(size_t(d) * LDW * 2);
  const size_t out_bytes = size_t(BM) * L.ldo * 4;
  // The fp32 epilogue tile reuses the W1 staging area once the loop is done.
  const size_t union_bytes = 2 * w1_bytes > out_bytes ? 2 * w1_bytes : out_bytes;
  L.xn = 0;
  L.w1a = round_up(xn_bytes);
  L.w1g = L.w1a + w1_bytes;
  L.out = L.w1a;
  L.w2 = L.w1a + round_up(union_bytes);
  L.h = L.w2 + round_up(size_t(NC) * L.ldx * 2);
  L.act = L.h + round_up(size_t(WARPS) * 16 * LDH * 4);
  L.total = L.act + round_up(size_t(BM) * LDW * 2);
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// tanh-approximate gelu, as flax.linen.gelu and ffn_pallas.py::_gelu_and_grad
__device__ __forceinline__ float gelu_tanh(float u) {
  const float c = 0.7978845608028654f, k = 0.044715f;
  return 0.5f * u * (1.0f + tanhf(c * (u + k * u * u * u)));
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// LN: the LayerNorm + residual sub-layer (_ln_ffn_kernel); otherwise the bare
// FFN (_ffn_kernel), which reads neither gamma, beta nor eps.
template <bool LN>
__global__ void __launch_bounds__(THREADS, 1)
ln_geglu_ffn_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1,
                    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                    const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int M, int d,
                    int inner, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(d);
  __nv_bfloat16* xn_s = reinterpret_cast<__nv_bfloat16*>(smem + L.xn);
  __nv_bfloat16* w1a_s = reinterpret_cast<__nv_bfloat16*>(smem + L.w1a);
  __nv_bfloat16* w1g_s = reinterpret_cast<__nv_bfloat16*>(smem + L.w1g);
  float* out_s = reinterpret_cast<float*>(smem + L.out);
  __nv_bfloat16* w2_s = reinterpret_cast<__nv_bfloat16*>(smem + L.w2);
  float* h_s = reinterpret_cast<float*>(smem + L.h);
  __nv_bfloat16* act_s = reinterpret_cast<__nv_bfloat16*>(smem + L.act);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM;

  if (!LN) {
    // The x tile as it is, 16 bytes a thread. Rows past M are zero-filled.
    const int row_vecs = d / 8;
    for (int v = tid; v < BM * row_vecs; v += THREADS) {
      const int r = v / row_vecs, vec = v - r * row_vecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < M)
        val = *reinterpret_cast<const uint4*>(x + size_t(row0 + r) * d + vec * 8);
      *reinterpret_cast<uint4*>(xn_s + r * L.ldx + vec * 8) = val;
    }
  }
  // LayerNorm: one warp per row. Rows past M are zero-filled; they are never stored.
  for (int r = warp; LN && r < BM; r += WARPS) {
    __nv_bfloat16* dst = xn_s + r * L.ldx;
    const int gr = row0 + r;
    if (gr < M) {
      const __nv_bfloat16* src = x + size_t(gr) * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += __bfloat162float(src[c]);
      const float mu = warp_sum(s) / d;
      float v = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float t = __bfloat162float(src[c]) - mu;
        v += t * t;
      }
      const float rstd = rsqrtf(warp_sum(v) / d + eps);
      for (int c = lane; c < d; c += 32)
        dst[c] = __float2bfloat16((__bfloat162float(src[c]) - mu) * rstd * gamma[c] + beta[c]);
    } else {
      for (int c = lane; c < d; c += 32) dst[c] = __float2bfloat16(0.f);
    }
  }

  // Phase-1 tiles of a warp: row tile hrow, columns hcol..hcol+31 of both a and g.
  const int hrow = warp >> 1;
  const int hcol = (warp & 1) * 32;
  float* h_w = h_s + warp * 16 * LDH;
  // Phase-2 tiles of a warp: row tile prow, column tiles pcol0, pcol0 + 2, ...
  const int n16 = d / 16;
  const int prow = warp & 3;
  const int pcol0 = warp >> 2;

  FragC acc[MAX_TILES];
#pragma unroll
  for (int i = 0; i < MAX_TILES; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int c0 = 0; c0 < inner; c0 += NC) {
    // Stage W1[:, c0:c0+64], W1[:, inner+c0:inner+c0+64] and W2[c0:c0+64, :], 16 bytes a thread.
    for (int v = tid; v < d * 16; v += THREADS) {
      const int k = v >> 4, half = (v >> 3) & 1, vec = v & 7;
      const uint4 val = *reinterpret_cast<const uint4*>(
          w1 + size_t(k) * 2 * inner + size_t(half) * inner + c0 + vec * 8);
      *reinterpret_cast<uint4*>((half ? w1g_s : w1a_s) + k * LDW + vec * 8) = val;
    }
    const int row_vecs = d / 8;
    for (int v = tid; v < NC * row_vecs; v += THREADS) {
      const int j = v / row_vecs, vec = v - j * row_vecs;
      *reinterpret_cast<uint4*>(w2_s + j * L.ldx + vec * 8) =
          *reinterpret_cast<const uint4*>(w2 + size_t(c0 + j) * d + vec * 8);
    }
    __syncthreads();

    // Phase 1: [a | g] tiles = xn . W1 slices.
    {
      FragC ha[2], hg[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fill_fragment(ha[j], 0.f);
        wmma::fill_fragment(hg[j], 0.f);
      }
      FragA fa;
      FragB fb;
      for (int k = 0; k < d; k += 16) {
        wmma::load_matrix_sync(fa, xn_s + hrow * 16 * L.ldx + k, L.ldx);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::load_matrix_sync(fb, w1a_s + k * LDW + hcol + j * 16, LDW);
          wmma::mma_sync(ha[j], fa, fb, ha[j]);
          wmma::load_matrix_sync(fb, w1g_s + k * LDW + hcol + j * 16, LDW);
          wmma::mma_sync(hg[j], fa, fb, hg[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(h_w + j * 16, ha[j], LDH, wmma::mem_row_major);
        wmma::store_matrix_sync(h_w + 32 + j * 16, hg[j], LDH, wmma::mem_row_major);
      }
    }
    __syncwarp();
    // Bias + tanh-GEGLU in fp32 on the warp's own tiles; bf16 act chunk to shared memory.
    for (int e = lane; e < 16 * 32; e += 32) {
      const int r = e >> 5, cc = e & 31;
      const int col = c0 + hcol + cc;
      const float a = h_w[r * LDH + cc] + b1[col];
      const float g = h_w[r * LDH + 32 + cc] + b1[inner + col];
      act_s[(hrow * 16 + r) * LDW + hcol + cc] = __float2bfloat16(a * gelu_tanh(g));
    }
    __syncthreads();

    // Phase 2: out[64, d] += act . W2[c0:c0+64, :].
    {
      FragA fa;
      FragB fb;
#pragma unroll
      for (int k = 0; k < NC; k += 16) {
        wmma::load_matrix_sync(fa, act_s + prow * 16 * LDW + k, LDW);
#pragma unroll
        for (int i = 0; i < MAX_TILES; ++i) {
          const int ct = pcol0 + 2 * i;
          if (ct < n16) {
            wmma::load_matrix_sync(fb, w2_s + k * L.ldx + ct * 16, L.ldx);
            wmma::mma_sync(acc[i], fa, fb, acc[i]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: the fp32 tile goes through shared memory (it reuses the W1 staging
  // area), then + b2 (+ the fp32 residual with LN), stored as bf16 for the rows
  // below M.
#pragma unroll
  for (int i = 0; i < MAX_TILES; ++i) {
    const int ct = pcol0 + 2 * i;
    if (ct < n16)
      wmma::store_matrix_sync(out_s + prow * 16 * L.ldo + ct * 16, acc[i], L.ldo,
                              wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < BM * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    const int gr = row0 + r;
    if (gr < M) {
      const size_t gi = size_t(gr) * d + c;
      const float y = out_s[r * L.ldo + c] + b2[c];
      out[gi] = __float2bfloat16(LN ? __bfloat162float(x[gi]) + y : y);
    }
  }
}

template <bool LN>
int launch(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int M, int d, int inner, float eps,
           void* stream) {
  if (M <= 0) return cudaSuccess;
  if (d <= 0 || d % 16 || d > 2 * MAX_TILES * 16 || inner <= 0 || inner % NC)
    return cudaErrorInvalidValue;
  const size_t smem = make_layout(d).total;
  cudaError_t err = cudaFuncSetAttribute(
      ln_geglu_ffn_kernel<LN>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM);
  ln_geglu_ffn_kernel<LN><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), M, d, inner, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest feature width the kernel takes (its per-warp accumulator budget).
int wd_ln_geglu_ffn_max_d() { return 2 * MAX_TILES * 16; }

// Launches the LN + FFN + residual kernel on `stream`; returns the CUDA error
// code (0 on success).
int wd_ln_geglu_ffn(const void* x, const void* gamma, const void* beta, const void* w1,
                    const void* b1, const void* w2, const void* b2, void* out, int M, int d,
                    int inner, float eps, void* stream) {
  return launch<true>(x, gamma, beta, w1, b1, w2, b2, out, M, d, inner, eps, stream);
}

// The bare GEGLU FFN, out = act . W2 + b2 (no LayerNorm, no residual), with the
// same operands and constraints; x must be 16-byte aligned.
int wd_geglu_ffn(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 void* out, int M, int d, int inner, void* stream) {
  return launch<false>(x, nullptr, nullptr, w1, b1, w2, b2, out, M, d, inner, 0.f, stream);
}

const char* wd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
