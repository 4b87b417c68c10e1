// Fused attention softmax(q . k^T * scale) . v, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bench_kernels/attention_pallas.py::_attn_kernel
// (reached through fused_attention -> _fused_attention_impl -> pl.pallas_call).
// For each (batch, head) pair of q [B*H, Nq, D], k and v [B*H, Nk, D] (bf16,
// row-major, contiguous):
//
//   s   = (q . k^T) * scale          fp32 accumulate, then scaled
//   p   = softmax(s)                  fp32, one pass (online softmax, below)
//   out = bf16(p . v)                 bf16 p, fp32 accumulate
//
// What bounds it on this card. At the UNet's shapes (D = 80, Nq = 256 or 64, Nk =
// 42, 64, 256 or 811) one (batch, head) pair does 4*Nq*Nk*D FLOP against
// 2*(Nq + 2*Nk)*D bytes of q, k, v plus 2*Nq*D of output: 66 MFLOP over 0.4 MB
// at Nq = 256, Nk = 811, about 160 FLOP per byte, below the H100's bf16 ridge
// of about 295. So device memory bounds it (and, close behind, the exp of the
// softmax and the tensor cores); its point, as on the TPU, is that the
// [Nq, Nk] matrix never reaches device memory, and then that q, k and v are
// read as few times as possible.
//
// Design:
//   - one pass over the keys with an online softmax: each query row keeps its
//     running maximum m and sum l; a chunk of keys whose scores raise m
//     rescales l and the fp32 p . v accumulators by exp(m_old - m_new), and the
//     output is divided by l once at the end. q . k^T is computed once and k and
//     v are read once per query tile; nothing of size Nq x Nk is stored, and any
//     Nk is taken;
//   - one CTA of 16 * MT * WARPS query rows per (batch*head, query tile); each
//     warp owns MT m16 tiles of rows and keeps their q fragments in registers.
//     128 rows wherever Nq >= 128 (4 warps of 32 rows: each k and v fragment
//     loaded from shared memory serves two m16 tiles), so k and v are read once
//     per 128 queries; a shorter Nq takes 4 warps of 16 rows, or 2 where 4
//     would leave most of the 132 SMs idle (the UNet's middle block at B = 16
//     has 64 (batch, head) pairs). The query tiles of one pair are neighbours
//     in the grid, so the second reads k and v from L2;
//   - k and v stream through a ring of STAGES chunks of 64 keys in shared
//     memory, filled by cp.async 16 bytes a thread: the next chunk loads while
//     the current one computes (one __syncthreads per chunk);
//   - the products are mma.sync.m16n8k16 bf16 with fp32 accumulators. At 160
//     FLOP per byte the kernel sits below the ridge, so mma.sync's rate is not
//     what bounds it. The B fragments come from ldmatrix (k as it is, v
//     transposed by ldmatrix.trans); the score accumulators are reused in
//     registers as the A operand of p . v;
//   - keys past Nk score -inf and their staged k and v rows are zero
//     (cp.async's zero fill), so a ragged Nk (42, 811) needs no padding of the
//     inputs; query rows past Nq are computed on zeros and not stored.
//
// Rounding, against the TPU body: it rounds the NORMALISED p to bf16 before
// p . v; one pass cannot know the final sum yet, so this kernel rounds
// exp(s - m_running) (in [0, 1]) to bf16 and divides the fp32 product by l at
// the end. That moves one bf16 rounding of each p (0.4% of a value) to before
// the division; chip_smoke.py's ATTN_REL_TOL (1% of max |plain|) covers it.
// The exponentials are the SFU's exp2 of the scores scaled by scale * log2(e),
// the scale folded into one FMA with the subtraction of the running maximum.
//
// Fast mode (FAST, UNetConfig.fast_softmax=True; the JAX model's _attend with
// fast_softmax, worddiffusion_tpu/models/attention.py:88-93): JAX keeps the
// scores and the max-subtract in fp32 and then rounds three times,
//   e = bf16(exp(s - m)),  S = bf16(sum_f32 e),  p = bf16(e / S),
// before p . v with fp32 accumulation. One pass makes the first two: l sums
// the bf16-rounded exponentials (the values it packs as p . v's A operand)
// instead of their fp32 values, and each row's final sum is rounded to bf16
// before its reciprocal. The third, the rounding of each normalised p, cannot
// be made before the final sum is known: here the fp32 product sum_j e_j v_j is
// divided by S once at the end, so p's rounding falls elsewhere, a difference
// within one bf16 rounding of each p (ROADMAP A.4). Where the running maximum
// rises past a chunk (Nk > 64), that chunk's e were rounded against the older
// maximum and rescaled in fp32; JAX rounds them against the final one. The
// lse output stays the fp32 sum's (the maps path never runs fast).
//
// Bitwise repeatable: no atomics, and every sum runs in a fixed order (the
// chunks in key order, the quad shuffles in lane order).
//
// Attention maps (UNetConfig.return_attn; the JAX model sows the fp32
// softmax(q . k^T * scale) [B, H, Nq, Nk] of each attention). The online
// softmax never forms them, so the kernel can also write each query row's
// log-sum-exp, lse = ln(sum_j exp(s_j * scale)) = (m + log2 l) * ln 2 from its
// final running maximum m and sum l (wd_attention), and a second kernel,
// attention_probs_kernel, writes p = exp(s * scale - lse) in fp32 from q, k and
// that lse: one more pass over q and k, each score recomputed once in fp32 on
// the CUDA cores (a register-tiled fmaf chain over d, in d order), no reduction
// over keys.
// The output stays B.4's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int KC = 64;      // keys per chunk
constexpr int STAGES = 2;   // chunks in flight in the ring
constexpr int PAD = 8;      // bf16 row padding (16 bytes): ldmatrix rows on distinct banks
constexpr int MAX_D = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
__host__ __device__ constexpr int ld() { return D + PAD; }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// 16 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two neighbouring bf16 (the lower column in the low half, as mma expects).
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The sum of the two bf16 values packed in v (as pack_bf16 packs them), in fp32.
__device__ __forceinline__ float bf16_sum(uint32_t v) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return __low2float(b) + __high2float(b);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 2^x by the SFU (flushes denormal results to zero: they are below bf16's range
// of p anyway)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// Keys [key0, key0 + KC) of k and v [nk, D] -> the ring stage's kc, vc
// [KC][D + PAD] by cp.async; keys past nk are zero.
template <int D, int THREADS>
__device__ __forceinline__ void load_chunk(bf16* kc, bf16* vc, const bf16* kb, const bf16* vb,
                                           int key0, int nk) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < KC * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool in = key0 + r < nk;
    const size_t off = in ? size_t(key0 + r) * D + c : 0;
    cp_async16(kc + r * ld<D>() + c, kb + off, in ? 16 : 0);
    cp_async16(vc + r * ld<D>() + c, vb + off, in ? 16 : 0);
  }
}

// grid (query tiles * B*H): the query tiles of one (batch, head) pair are
// neighbours. WARPS warps of MT m16 tiles (16 * MT query rows) each. FAST: the
// fast mode's roundings of the sums (the header).
template <int D, int WARPS, int MT, bool FAST>
__global__ void __launch_bounds__(WARPS * 32)
    attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int nq, int nk, float scale_log2) {
  constexpr int THREADS = WARPS * 32, BQ = 16 * MT * WARPS, LD = ld<D>();
  constexpr int NT = KC / 8;  // score tiles per chunk
  constexpr int OT = D / 8;   // output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* ring = qs + BQ * LD;                     // STAGES x (k [KC][LD], v [KC][LD])

  const int qtiles = (nq + BQ - 1) / BQ;
  const size_t bh = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x % qtiles) * BQ;
  const bf16* kb = k + bh * nk * D;
  const bf16* vb = v + bh * nk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 * MT;
  const int chunks = (nk + KC - 1) / KC;

  // the q tile (rows past nq zero) and the ring's first chunks, all by cp.async
  // in flight together, q in the first chunk's group
  {
    constexpr int VPR = D / 8;
    const bf16* qb = q + bh * nq * D;
    for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const bool in = q0 + r < nq;
      cp_async16(qs + r * LD + c, qb + (in ? size_t(q0 + r) * D + c : 0), in ? 16 : 0);
    }
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks)
      load_chunk<D, THREADS>(ring + 2 * s * KC * LD, ring + (2 * s + 1) * KC * LD, kb, vb,
                             s * KC, nk);
    cp_async_commit();
  }
  // then the q tile's A fragments into registers
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  uint32_t qf[MT][D / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const bf16* p = qs + (r0 + 16 * mt + g) * LD + ks * 16 + 2 * t;
      qf[mt][ks][0] = ld32(p);
      qf[mt][ks][1] = ld32(p + 8 * LD);
      qf[mt][ks][2] = ld32(p + 8);
      qf[mt][ks][3] = ld32(p + 8 * LD + 8);
    }

  // per m16 tile and row half: m (log2 domain) is quad-uniform; l is this
  // thread's share of its row's sum
  float m[MT][2], l[MT][2];
  float o[MT][OT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < OT; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }

  // ldmatrix lane roles: matrix mi = lane / 8, its row lr = lane % 8
  const int mi = lane >> 3, lr = lane & 7;

  for (int c = 0; c < chunks; ++c) {
    // refill the stage that chunk c - 1 used (every thread is past it)
    const int next = c + STAGES - 1;
    if (next < chunks) {
      const int s = next % STAGES;
      load_chunk<D, THREADS>(ring + 2 * s * KC * LD, ring + (2 * s + 1) * KC * LD, kb, vb,
                             next * KC, nk);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this thread's copies of chunk c have landed
    __syncthreads();              // and everyone's
    const bf16* kc = ring + 2 * (c % STAGES) * KC * LD;
    const bf16* vc = kc + KC * LD;
    const int key0 = c * KC;

    // s = q . k^T for the warp's rows and the chunk's KC keys; each k
    // fragment serves the warp's MT m16 tiles
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // matrices: keys 8j.. (k lo, k hi), keys 8(j+1).. (k lo, k hi)
        uint32_t b[4];
        ldmatrix_x4(b, kc + ((j + (mi >> 1)) * 8 + lr) * LD + ks * 16 + (mi & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][j], qf[mt][ks], b[0], b[1]);
          mma_bf16(s[mt][j + 1], qf[mt][ks], b[2], b[3]);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // mask keys past nk (only the last chunk has any), the chunk's row maxima
      float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float* sj = s[mt][j];
        if (key0 + KC > nk) {
          const int col = key0 + j * 8 + 2 * t;
          if (col >= nk) sj[0] = sj[2] = -INFINITY;
          if (col + 1 >= nk) sj[1] = sj[3] = -INFINITY;
        }
        cm[0] = fmaxf(cm[0], fmaxf(sj[0], sj[1]));
        cm[1] = fmaxf(cm[1], fmaxf(sj[2], sj[3]));
      }
      // the online step, in the log2 domain (scale > 0, so the maximum of the
      // scaled scores is the scaled maximum): m_new is finite (the chunk holds
      // a key); the first chunk's alpha is exp2(-inf) = 0
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[mt][r], quad_max(cm[r]) * scale_log2);
        const float alpha = exp2_approx(m[mt][r] - mn);
        m[mt][r] = mn;
        l[mt][r] *= alpha;
#pragma unroll
        for (int n = 0; n < OT; ++n) {
          o[mt][n][2 * r] *= alpha;
          o[mt][n][2 * r + 1] *= alpha;
        }
      }
    }

    // p = exp2(s - m) in fp32 into l, in bf16 as the A operand of p . v; each
    // v fragment serves the warp's MT m16 tiles
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      // score tiles 2kk and 2kk + 1 are the A fragment of keys 16kk .. 16kk + 15
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* sj = s[mt][2 * kk + h];
          const float m0 = m[mt][0], m1 = m[mt][1];
          const float p0 = exp2_approx(fmaf(sj[0], scale_log2, -m0));
          const float p1 = exp2_approx(fmaf(sj[1], scale_log2, -m0));
          const float p2 = exp2_approx(fmaf(sj[2], scale_log2, -m1));
          const float p3 = exp2_approx(fmaf(sj[3], scale_log2, -m1));
          pa[mt][2 * h] = pack_bf16(p0, p1);
          pa[mt][2 * h + 1] = pack_bf16(p2, p3);
          if constexpr (FAST) {  // sum the bf16 values p . v takes, as JAX sums e
            l[mt][0] += bf16_sum(pa[mt][2 * h]);
            l[mt][1] += bf16_sum(pa[mt][2 * h + 1]);
          } else {
            l[mt][0] += p0 + p1;
            l[mt][1] += p2 + p3;
          }
        }
#pragma unroll
      for (int n = 0; n < OT; n += 2) {
        // matrices: (keys lo, d tile n), (keys hi, n), (keys lo, n + 1), (keys hi, n + 1)
        uint32_t b[4];
        ldmatrix_x4_trans(b, vc + (kk * 16 + (mi & 1) * 8 + lr) * LD + (n + (mi >> 1)) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][n], pa[mt], b[0], b[1]);
          mma_bf16(o[mt][n + 1], pa[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the refill STAGES - 1 chunks on
  }
  cp_async_wait<0>();

  bf16* ob = out + bh * nq * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float la = quad_sum(l[mt][0]), lb = quad_sum(l[mt][1]);
    // fast mode: the row's sum rounded to bf16 before the division, as JAX's S
    const float inv0 = 1.f / (FAST ? round_bf16(la) : la);
    const float inv1 = 1.f / (FAST ? round_bf16(lb) : lb);
    const int row_a = q0 + r0 + 16 * mt + g, row_b = row_a + 8;
    if (lse != nullptr && t == 0) {
      if (row_a < nq) lse[bh * nq + row_a] = (m[mt][0] + log2f(la)) * LN2;
      if (row_b < nq) lse[bh * nq + row_b] = (m[mt][1] + log2f(lb)) * LN2;
    }
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      const int col = n * 8 + 2 * t;
      if (row_a < nq)
        *reinterpret_cast<uint32_t*>(ob + size_t(row_a) * D + col) =
            pack_bf16(o[mt][n][0] * inv0, o[mt][n][1] * inv0);
      if (row_b < nq)
        *reinterpret_cast<uint32_t*>(ob + size_t(row_b) * D + col) =
            pack_bf16(o[mt][n][2] * inv1, o[mt][n][3] * inv1);
    }
  }
}

constexpr int SMS = 132;

// The CTA for this shape, as (warps, m16 tiles per warp): 128 query rows
// wherever Nq >= 128, as 4 warps of 32 rows (each k and v fragment serves two
// m16 tiles); below, 4 warps of 16 rows unless that leaves fewer CTAs than
// SMs, then 2.
struct Cfg {
  int warps, mt;
};

Cfg pick(int bh, int nq) {
  if (nq >= 128) return {4, 2};
  return (long long)bh * ((nq + 63) / 64) >= SMS ? Cfg{4, 1} : Cfg{2, 1};
}

template <int D, int WARPS, int MT, bool FAST>
cudaError_t launch_cfg(const void* q, const void* k, const void* v, void* out, float* lse,
                       int bh, int nq, int nk, float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * MT * WARPS;
  constexpr size_t smem = size_t(BQ + 2 * STAGES * KC) * ld<D>() * sizeof(bf16);
  const long long ctas = (long long)bh * ((nq + BQ - 1) / BQ);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  // The shared memory limit is raised once per device for this instance (its
  // smem is a constant): the attribute call costs host time of the order of
  // the launch itself, and the small shapes are bound by the host.
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    e = cudaFuncSetAttribute(attention_kernel<D, WARPS, MT, FAST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit);
  }
  attention_kernel<D, WARPS, MT, FAST><<<unsigned(ctas), WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, nq, nk, scale * LOG2E);
  return cudaGetLastError();
}

template <int D, bool FAST>
cudaError_t launch_mode(const void* q, const void* k, const void* v, void* out, float* lse,
                        int bh, int nq, int nk, float scale, cudaStream_t stream) {
  const Cfg cfg = pick(bh, nq);
  if (cfg.mt == 2)
    return launch_cfg<D, 4, 2, FAST>(q, k, v, out, lse, bh, nq, nk, scale, stream);
  if (cfg.warps == 4)
    return launch_cfg<D, 4, 1, FAST>(q, k, v, out, lse, bh, nq, nk, scale, stream);
  return launch_cfg<D, 2, 1, FAST>(q, k, v, out, lse, bh, nq, nk, scale, stream);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                   int nq, int nk, float scale, int fast, cudaStream_t stream) {
  return fast ? launch_mode<D, true>(q, k, v, out, lse, bh, nq, nk, scale, stream)
              : launch_mode<D, false>(q, k, v, out, lse, bh, nq, nk, scale, stream);
}

// p [bh, nq, nk] fp32 = exp(q . k^T * scale - lse): grid (query tiles of PR
// rows, bh). A CTA computes its PR x PK tile of p for each chunk of PK keys;
// each thread 4 rows x 4 keys (16 fp32 accumulators, a register tile as in a
// SIMT GEMM), from q and k staged in shared memory transposed and in fp32
// ([D][PLD] each), so that the thread reads its 4 rows and its 4 keys of one d
// with two 16-byte loads: 16 FMAs for two shared loads. The sum over d runs in
// d order in each thread (bitwise repeatable).
constexpr int PR = 64, PK = 64, PTHREADS = 256;
constexpr int PLD = PR + 4;  // a row of 68 floats: 16-byte aligned, and the
                             // transposed stores of consecutive d spread over banks
static_assert(PR == PK, "one shared row pitch for both tiles");
static_assert(PTHREADS == (PR / 4) * (PK / 4), "a thread a 4 x 4 tile");

// Rows [r0, r0 + 64) of src [n, D] bf16 -> dst [D][PLD] fp32 transposed (rows
// past n zero), 16 bytes (8 elements of a row) a thread a step; the 32 lanes
// of a warp take 32 rows, so that their stores of one element fall on 32 banks.
template <int D>
__device__ __forceinline__ void stage_transposed(float* dst, const bf16* src, int r0, int n) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < PR * VPR; i += PTHREADS) {
    const int r = i % PR, c = (i / PR) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < n) v = *reinterpret_cast<const uint4*>(src + size_t(r0 + r) * D + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * PLD + r] = __bfloat162float(e[j]);
  }
}

template <int D>
__global__ void __launch_bounds__(PTHREADS)
    attention_probs_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const float* __restrict__ lse, float* __restrict__ p, int nq,
                           int nk, float scale) {
  extern __shared__ __align__(16) float psm[];
  float* qt = psm;             // [D][PLD]: q rows transposed
  float* kt = psm + D * PLD;   // [D][PLD]: the chunk's keys transposed
  const size_t bh = blockIdx.y;
  const int row0 = blockIdx.x * PR;
  const bf16* qb = q + bh * size_t(nq) * D;
  const bf16* kb = k + bh * size_t(nk) * D;
  stage_transposed<D>(qt, qb, row0, nq);
  const int tr = threadIdx.x / (PK / 4), tk = threadIdx.x % (PK / 4);
  float row_lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * tr + i;
    row_lse[i] = row < nq ? lse[bh * nq + row] : 0.f;
  }
  for (int key0 = 0; key0 < nk; key0 += PK) {
    __syncthreads();  // the previous chunk is read (and, the first time, q is staged)
    stage_transposed<D>(kt, kb, key0, nk);
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * PLD + 4 * tr);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * PLD + 4 * tk);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 4 * tr + i;
      if (row >= nq) continue;
      float* prow = p + (bh * nq + row) * size_t(nk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + 4 * tk + j;
        if (key < nk) prow[key] = expf(acc[i][j] * scale - row_lse[i]);
      }
    }
  }
}

template <int D>
cudaError_t launch_probs(const void* q, const void* k, const float* lse, float* p, int bh,
                         int nq, int nk, float scale, cudaStream_t stream) {
  if (bh > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = size_t(2) * D * PLD * sizeof(float);
  // raised once per device for this instance, as launch_cfg does
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    e = cudaFuncSetAttribute(attention_probs_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit);
  }
  const dim3 grid((nq + PR - 1) / PR, bh);
  attention_probs_kernel<D><<<grid, PTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), lse, p, nq, nk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int wd_attention_max_d() { return MAX_D; }

// Query rows per CTA that the kernel picks for this shape.
int wd_attention_tile_rows(int bh, int nq) {
  const Cfg cfg = pick(bh, nq);
  return 16 * cfg.warps * cfg.mt;
}

// out [bh, nq, d] = softmax(q [bh, nq, d] . k [bh, nk, d]^T * scale) . v [bh, nk, d],
// all bf16, contiguous and 16-byte aligned; d a multiple of 16 up to MAX_D,
// nk >= 1, nq >= 1; with lse non-null, each query row's log-sum-exp [bh, nq]
// fp32 too; fast non-zero: the fast mode (UNetConfig.fast_softmax, the
// header). Returns a cudaError_t (0 on success).
int wd_attention(const void* q, const void* k, const void* v, void* out, float* lse,
                 int bh, int nq, int nk, int d, float scale, int fast, void* stream) {
  if (bh < 1 || nq < 1 || nk < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 32: return launch<32>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 48: return launch<48>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 64: return launch<64>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 80: return launch<80>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 96: return launch<96>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 112: return launch<112>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 128: return launch<128>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    default: return cudaErrorInvalidValue;
  }
}

// p [bh, nq, nk] fp32 = exp(q . k^T * scale - lse) for q [bh, nq, d], k [bh, nk,
// d] bf16 (contiguous) and lse [bh, nq] fp32 (wd_attention's): the
// attention maps. bh <= 65535.
int wd_attention_probs(const void* q, const void* k, const float* lse, float* p, int bh,
                       int nq, int nk, int d, float scale, void* stream) {
  if (bh < 1 || nq < 1 || nk < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_probs<16>(q, k, lse, p, bh, nq, nk, scale, s);
    case 32: return launch_probs<32>(q, k, lse, p, bh, nq, nk, scale, s);
    case 48: return launch_probs<48>(q, k, lse, p, bh, nq, nk, scale, s);
    case 64: return launch_probs<64>(q, k, lse, p, bh, nq, nk, scale, s);
    case 80: return launch_probs<80>(q, k, lse, p, bh, nq, nk, scale, s);
    case 96: return launch_probs<96>(q, k, lse, p, bh, nq, nk, scale, s);
    case 112: return launch_probs<112>(q, k, lse, p, bh, nq, nk, scale, s);
    case 128: return launch_probs<128>(q, k, lse, p, bh, nq, nk, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
