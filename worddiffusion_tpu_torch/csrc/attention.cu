// Fused attention softmax(q . k^T * scale) . v, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bench_kernels/attention_pallas.py::_attn_kernel
// (reached through fused_attention -> _fused_attention_impl -> pl.pallas_call).
// For each (batch, head) pair of q [B*H, Nq, D], k and v [B*H, Nk, D] (bf16,
// row-major, contiguous), with the body's arithmetic:
//
//   s   = (q . k^T) * scale          fp32 accumulate, then scaled
//   p   = bf16(exp(s - rowmax(s)) / rowsum(exp(s - rowmax(s))))   fp32 softmax
//   out = bf16(p . v)                 fp32 accumulate
//
// What bounds it on this card. At the UNet's shapes (D = 80, Nq = 256 or 64, Nk =
// 42, 64, 256 or 811) one (batch, head) pair does 4*Nq*Nk*D FLOP against
// 2*(Nq + 2*Nk)*D bytes of q, k, v plus 2*Nq*D of output: 66 MFLOP over 0.4 MB
// at Nq = 256, Nk = 811, about 160 FLOP per byte, below the H100's bf16 ridge
// of about 295. The plain composition also writes and reads back the fp32
// [Nq, Nk] scores and the bf16 probabilities (1.2 MB for that pair, three times
// its inputs), and launches four or five kernels. So the kernel is bound by
// device memory and by the exp of the softmax, and its point, as on the TPU, is
// that the [Nq, Nk] matrix never reaches device memory.
//
// Design (simple first; wgmma, TMA, cp.async double buffering are later work):
//   - one CTA of 4 warps per (batch*head, 64-query tile); each warp owns 16
//     query rows and keeps its q fragments in registers;
//   - keys are streamed through shared memory in chunks of 64. The TPU kernel
//     held a whole row of scores in VMEM; here a row of 811 fp32 scores for 64
//     rows would take 209 KB. Instead there are two passes over the chunks: the
//     first computes each row's maximum and its sum of exp (with the running
//     rescale), the second recomputes the scores, forms the normalised p in
//     bf16 exactly as the TPU body does, and accumulates p . v. q . k^T is done
//     twice; nothing of size Nq x Nk is stored anywhere;
//   - the products are mma.sync.m16n8k16 bf16 tensor-core instructions with
//     fp32 accumulators; the score accumulators are reused in registers as the
//     A operand of p . v (no shared-memory round trip); v is staged transposed
//     so that its B fragments are 32-bit loads;
//   - keys past Nk score -inf and their staged k and v rows are zero, so a
//     ragged Nk (42, 811) needs no padding of the inputs; query rows past Nq
//     are computed on zeros and not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;            // query rows per CTA
constexpr int WARPS = 4;          // 16 query rows each
constexpr int THREADS = WARPS * 32;
constexpr int KC = 64;            // keys per chunk
constexpr int PAD = 8;            // bf16 row padding (16 bytes) against bank conflicts
constexpr int MAX_D = 128;
// Longest key sequence taken. The UNet's are 42 (characters), 256 (latent
// self-attention) and 811 (characters + 769 PHOSC tokens); the two-pass design
// computes q . k^T twice, and past about a thousand keys a single-pass
// (online-softmax) kernel is the better design, so longer ones are refused.
constexpr int MAX_NK = 1024;
static_assert(KC <= BQ, "a key chunk is staged in the q tile's shared memory");

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

// rows [row0, row0 + n) of src [total, D] -> dst [n][D + PAD]; rows past the
// end are zero.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int total,
                                           int n) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < n * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < total) val = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) = val;
  }
}

// rows [key0, key0 + KC) of v [total, D] -> vt [D][KC + PAD] (transposed);
// keys past the end are zero.
template <int D>
__device__ __forceinline__ void stage_v_transposed(bf16* vt, const bf16* src, int key0,
                                                   int total) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < KC * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (key0 + r < total) val = *reinterpret_cast<const uint4*>(src + size_t(key0 + r) * D + c);
    const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      vt[(c + j) * (KC + PAD) + r] =
          __ushort_as_bfloat16(static_cast<unsigned short>(w[j / 2] >> (16 * (j % 2))));
  }
}

// The warp's [16, KC] scores against the staged key chunk, scaled; keys past
// nk are -inf. s[j] is the m16n8 accumulator of keys key0 + 8j .. 8j + 7:
// s[j][0..1] row g, s[j][2..3] row g + 8, columns 2t and 2t + 1.
template <int D>
__device__ __forceinline__ void chunk_scores(float (&s)[KC / 8][4],
                                             const uint32_t (&qf)[D / 16][4],
                                             const bf16* kc, int g, int t, int key0, int nk,
                                             float scale) {
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      const bf16* kp = kc + (j * 8 + g) * (D + PAD) + ks * 16 + 2 * t;
      mma_bf16(s[j], qf[ks], ld32(kp), ld32(kp + 8));
    }
  }
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    const int col = key0 + j * 8 + 2 * t;
    const bool in0 = col < nk, in1 = col + 1 < nk;
    s[j][0] = in0 ? s[j][0] * scale : -INFINITY;
    s[j][1] = in1 ? s[j][1] * scale : -INFINITY;
    s[j][2] = in0 ? s[j][2] * scale : -INFINITY;
    s[j][3] = in1 ? s[j][3] * scale : -INFINITY;
  }
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

template <int D>
__global__ void __launch_bounds__(THREADS)
    attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int nq, int nk,
                     float scale) {
  constexpr int LDK = D + PAD, LDV = KC + PAD;
  constexpr int NT = KC / 8;  // score tiles per chunk
  constexpr int OT = D / 8;   // output tiles
  __shared__ __align__(16) bf16 qk[BQ * LDK];  // the q tile, then each key chunk
  __shared__ __align__(16) bf16 vt[D * LDV];   // each value chunk, transposed

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const bf16* kb = k + bh * nk * D;
  const bf16* vb = v + bh * nk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  // q fragments (A operand, row-major 16x16 per k-step) stay in registers.
  stage_rows<D>(qk, q + bh * nq * D, q0, nq, BQ);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* p = qk + (r0 + g) * LDK + ks * 16 + 2 * t;
    qf[ks][0] = ld32(p);
    qf[ks][1] = ld32(p + 8 * LDK);
    qf[ks][2] = ld32(p + 8);
    qf[ks][3] = ld32(p + 8 * LDK + 8);
  }
  __syncthreads();

  // Pass 1: each row's max and sum of exp(s - max), rescaled as the max grows.
  // m is quad-uniform; l is this thread's share, summed over the quad after.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[NT][4];
  for (int key0 = 0; key0 < nk; key0 += KC) {
    stage_rows<D>(qk, kb, key0, nk, KC);
    __syncthreads();
    chunk_scores<D>(s, qf, qk, g, t, key0, nk, scale);
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      cm[0] = fmaxf(cm[0], fmaxf(s[j][0], s[j][1]));
      cm[1] = fmaxf(cm[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(cm[r]));  // finite: a chunk holds a key
      l[r] *= __expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      l[0] += __expf(s[j][0] - m[0]) + __expf(s[j][1] - m[0]);
      l[1] += __expf(s[j][2] - m[1]) + __expf(s[j][3] - m[1]);
    }
    __syncthreads();
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  // Pass 2: p = bf16(exp(s - max) / sum), out += p . v.
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int key0 = 0; key0 < nk; key0 += KC) {
    stage_rows<D>(qk, kb, key0, nk, KC);
    stage_v_transposed<D>(vt, vb, key0, nk);
    __syncthreads();
    chunk_scores<D>(s, qf, qk, g, t, key0, nk, scale);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      // the accumulators of score tiles 2kk and 2kk + 1 are the A fragment of
      // keys 16kk .. 16kk + 15
      uint32_t pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kk + h;
        pa[2 * h] = pack_bf16(__expf(s[j][0] - m[0]) / l[0], __expf(s[j][1] - m[0]) / l[0]);
        pa[2 * h + 1] = pack_bf16(__expf(s[j][2] - m[1]) / l[1], __expf(s[j][3] - m[1]) / l[1]);
      }
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        const bf16* vp = vt + (n * 8 + g) * LDV + kk * 16 + 2 * t;
        mma_bf16(o[n], pa, ld32(vp), ld32(vp + 8));
      }
    }
    __syncthreads();
  }

  bf16* ob = out + bh * nq * D;
  const int row_a = q0 + r0 + g, row_b = row_a + 8;
#pragma unroll
  for (int n = 0; n < OT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < nq)
      *reinterpret_cast<uint32_t*>(ob + size_t(row_a) * D + col) = pack_bf16(o[n][0], o[n][1]);
    if (row_b < nq)
      *reinterpret_cast<uint32_t*>(ob + size_t(row_b) * D + col) = pack_bf16(o[n][2], o[n][3]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int nq,
                   int nk, float scale, cudaStream_t stream) {
  const dim3 grid(bh, (nq + BQ - 1) / BQ);
  attention_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), nq, nk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int wd_attention_max_d() { return MAX_D; }
int wd_attention_max_nk() { return MAX_NK; }

// out [bh, nq, d] = softmax(q [bh, nq, d] . k [bh, nk, d]^T * scale) . v [bh, nk, d],
// all bf16, contiguous and 16-byte aligned; d a multiple of 16 up to MAX_D,
// 1 <= nk <= MAX_NK, nq >= 1. Returns a cudaError_t (0 on success).
int wd_attention(const void* q, const void* k, const void* v, void* out, int bh, int nq,
                 int nk, int d, float scale, void* stream) {
  if (bh < 1 || nq < 1 || nk < 1 || nk > MAX_NK || (nq + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, out, bh, nq, nk, scale, s);
    case 32: return launch<32>(q, k, v, out, bh, nq, nk, scale, s);
    case 48: return launch<48>(q, k, v, out, bh, nq, nk, scale, s);
    case 64: return launch<64>(q, k, v, out, bh, nq, nk, scale, s);
    case 80: return launch<80>(q, k, v, out, bh, nq, nk, scale, s);
    case 96: return launch<96>(q, k, v, out, bh, nq, nk, scale, s);
    case 112: return launch<112>(q, k, v, out, bh, nq, nk, scale, s);
    case 128: return launch<128>(q, k, v, out, bh, nq, nk, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
