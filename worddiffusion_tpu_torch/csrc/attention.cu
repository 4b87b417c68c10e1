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
// What bounds it on this card: three floors of one size at the UNet's shapes
// (D = 80), and the kernel is built to overlap them rather than take them in turn.
//   - bytes: q, k, v read once and out written once, over 3.35 TB/s. It leads
//     where Nk is short (the iam characters' 42, every pixel cross-attention):
//     there the kernel is a stream of q in and out back;
//   - tensor: 4 * Nq * Nk * D products a pair, over 989 TFLOP/s, and
//   - exp: Nq * Nk exponentials a pair on the SFU (16 ex2 a clock an SM);
//     these two lead where Nk is long (811 keys, the 16384^2 self-attention),
//     within 1.4x of each other.
//
// Design:
//   - one pass over the keys with an online softmax: each query row keeps its
//     running maximum m and sum l; a chunk of keys whose scores raise m
//     rescales l and the fp32 p . v accumulators by exp(m_old - m_new), and the
//     output is divided by l once at the end; nothing of size Nq x Nk is stored
//     and any Nk is taken;
//   - warp roles (one CTA of NWG consumer warpgroups and a producer): the
//     producer's one thread issues every load as a TMA box of a
//     rank-3 tensor map over [B*H, N, D] into shared memory, completing on an
//     mbarrier, and gives its registers to the consumers (setmaxnreg); the
//     consumers never wait on device memory while loads are in flight ahead
//     of them: the q tiles through a ring of QST slots, the k and v chunks
//     through a ring of ST stages, each slot with a full and an empty barrier;
//   - both products on wgmma: s = q . k^T with both operands in shared memory,
//     and p . v with p from registers (the score accumulators, exponentiated
//     and packed to bf16, are already the layout of wgmma's register A
//     operand) and v read MN-major (transposed) from shared memory;
//   - overlap of the tensor cores with the exponentials: inside a warpgroup,
//     chunk j + 1's score product is issued before chunk j's p . v, and chunk
//     j + 1's softmax runs while that p . v is in flight; across the two
//     warpgroups of a CTA, a ping-pong on named barriers lets one issue its
//     products while the other exponentiates;
//   - the bytes: CTAs are persistent and walk (pair, query tile) items in
//     pair-major order (where Nk spans chunks, the query tiles of one pair run
//     side by side on neighbouring CTAs, so its chunks come from L2); the
//     producer issues the next items' q tiles while this
//     item computes, and the output leaves through shared memory by a TMA
//     store that runs on while the next item computes. Where Nk fits one
//     chunk, a CTA takes a contiguous run of items, so that one pair's k and
//     v are loaded once for all its query tiles, and the chunk is as narrow
//     as wgmma allows: Nk rounded up to 16 (48 keys for Nk = 42). Longer
//     contexts take chunks of 64 keys, or 128 with two consumer warpgroups
//     where Nk > 256: the loop is bound by latency (the score product's, the
//     softmax's, the barriers'), which a wider chunk pays once for twice the
//     work;
//   - shared memory is in 16-column panels with TMA's 32-byte swizzle (an
//     8-row group of 256 bytes), the one layout wgmma reads K-major (q, k) and
//     MN-major (v) at every D in 16..128, so that D = 80's 160-byte rows need
//     no other route than D = 64's or 128's;
//   - the rank-3 maps clip each box at its own pair's N: k and v rows past Nk
//     arrive as zeros (their scores are masked to -inf), and out rows past Nq
//     are not stored;
//   - a CTA of 128 query rows (two consumer warpgroups, one CTA an SM) where
//     that leaves at least one item an SM; else 64 rows (one consumer
//     warpgroup, two CTAs an SM), as for the UNet's middle block at B = 16;
//   - head widths above 128 (D = 144 .. 256, a UNet whose heads are wider:
//     channel_mult (1, 2)'s second level has 4 heads of 160) take one plan of
//     their own: one consumer warpgroup of 64 query rows, chunks of 64 keys
//     (Nk = 42 is one masked chunk), one CTA an SM. O's accumulator is D / 2
//     registers a thread (128 at D = 256), which two CTAs an SM could not hold
//     beside the scores; q [64, D] in two slots and the k / v ring take the
//     227 KB of one CTA (two stages at D = 256). One plan, and no other chunk
//     width, keeps the build's instances at two a width (the two modes).
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
// chunks in key order, the k-steps of each product in order, the quad
// shuffles in lane order).
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
//
// The host encodes the tensor maps with hopper.cuh's encode (the driver's
// cuTensorMapEncodeTiled, reached through the runtime's
// cudaGetDriverEntryPoint, so that the library links without libcuda); a
// failed encode is returned as an error, as a refused launch is.

#include <cuda.h>  // CUtensorMap and the encode's enums (header only)
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MAX_D = 256;
constexpr int MAX_PLANNED_D = 128;  // widths with every chunk / warpgroup plan
constexpr int MAX_KC = 64;    // keys a chunk where Nk is longer
constexpr int WIDE_KC = 128;  // ... with two consumer warpgroups and Nk > WIDE_MIN_NK
constexpr int WIDE_MIN_NK = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int SCHED_BAR = 1;  // named barriers 1, 2: the warpgroups' turns to issue products
constexpr int EPI_BAR = 3;    // 3, 4: a warpgroup's output staging
// With two consumer warpgroups the producer is a whole warpgroup, as
// setmaxnreg acts on whole warpgroups: 3 x 128 threads launch with 168
// registers a thread; the producer drops to 24 and the 256 consumer threads
// take the 128 x 144 it frees, up to 240. With one consumer warpgroup (two
// CTAs an SM) the producer is one warp and every thread keeps what it has.
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * (168 - PRODUCER_REGS) >= 256 * (CONSUMER_REGS - 168), "what the producer frees");

__host__ __device__ constexpr int cta_threads(int nwg) { return nwg == 2 ? 384 : 160; }

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

// Shared memory of one CTA, in bytes from a 256-byte aligned base: QST q tiles
// (QROWS rows), ST stages of a k chunk and a v chunk (KC rows), one output
// tile a consumer warpgroup (64 rows), each as D / 16 panels of [rows][16]
// bf16 with the 32-byte swizzle; then the barriers. Two consumer warpgroups
// take one CTA an SM (227 KB), one takes two (113 KB each). A chunk of 64
// keys or more (Nk > 48) is most often one of many, so it keeps q at 2 slots
// and deepens the k / v ring; a narrower one is Nk's only chunk,
// so an item is a q tile and one k / v stage, and both rings take as many
// items as fit, up to 4 (the next items' q in flight).
struct Smem {
  int qrows, q_bytes, kv_bytes, o_bytes, st, qst, q, k, v, o, bars, size;
};

// One CTA an SM with two consumer warpgroups or a head width above 128, else two.
__host__ __device__ constexpr bool one_cta_an_sm(int d, int nwg) {
  return nwg == 2 || d > MAX_PLANNED_D;
}

__host__ __device__ constexpr int smem_budget(int d, int nwg) {
  return one_cta_an_sm(d, nwg) ? 232448 : 115712;
}

__host__ __device__ constexpr Smem smem_layout(int d, int kc, int nwg) {
  Smem s{};
  s.qrows = 64 * nwg;
  s.q_bytes = s.qrows * d * 2;
  s.kv_bytes = kc * d * 2;  // one chunk of k, or of v
  s.o_bytes = 64 * d * 2;
  const int avail = smem_budget(d, nwg) - 256 - nwg * s.o_bytes - 8 * 16;
  const int deep_kv = (avail - 2 * s.q_bytes) / (2 * s.kv_bytes);
  const int deep_item = avail / (s.q_bytes + 2 * s.kv_bytes);
  s.st = kc >= MAX_KC ? (deep_kv < 4 ? deep_kv : 4) : (deep_item < 4 ? deep_item : 4);
  s.qst = kc >= MAX_KC ? 2 : s.st;
  s.q = 0;
  s.k = s.q + s.qst * s.q_bytes;
  s.v = s.k + s.st * s.kv_bytes;
  s.o = s.v + s.st * s.kv_bytes;
  s.bars = s.o + nwg * s.o_bytes;
  s.size = s.bars + 8 * 2 * (s.qst + s.st) + 256;  // + the base's alignment
  return s;
}

// Descriptor of a 16-column panel group with the 32-byte swizzle (8-row groups
// of 256 bytes); lbo: K-major 16 (unused), MN-major the panel stride.
__device__ __forceinline__ uint64_t desc_sw32(const void* p, uint32_t lbo) {
  return make_desc(p, lbo, 256, SW32);
}

// The CTA's items. Where k and v fit one chunk, a contiguous run of items,
// so that one pair's query tiles follow each other and its k and v are loaded
// once; else every gridDim-th item, so that the query tiles of one pair run on
// neighbouring CTAs at once and its chunks come from L2.
struct Items {
  int first, end, step;
};

__device__ __forceinline__ Items cta_items(int items, bool single) {
  if (!single) return {int(blockIdx.x), items, int(gridDim.x)};
  return {int((long long)blockIdx.x * items / gridDim.x),
          int((long long)(blockIdx.x + 1) * items / gridDim.x), 1};
}

// The producer's one thread: for each of the CTA's items, its q tile
// into the q ring, then its k and v chunks into the k / v ring (a single
// chunk only where the pair changes), each slot after its empty barrier,
// each completing on its full barrier.
template <int D, int KC, int NWG>
__device__ __forceinline__ void produce(unsigned char* sm, const CUtensorMap* qmap,
                                        const CUtensorMap* kmap, const CUtensorMap* vmap, int nk,
                                        int qtiles, int items) {
  constexpr Smem S = smem_layout(D, KC, NWG);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S.bars);
  uint64_t* q_empty = q_full + S.qst;
  uint64_t* kv_full = q_empty + S.qst;
  uint64_t* kv_empty = kv_full + S.st;
  const int chunks = (nk + KC - 1) / KC;
  const Items r = cta_items(items, chunks == 1);
  uint32_t qi = 0, kvi = 0;
  int held = -1;  // the pair whose single chunk the ring holds
  for (int it = r.first; it < r.end; it += r.step, ++qi) {
    const int bh = it / qtiles, q0 = (it % qtiles) * S.qrows;
    const uint32_t qs = qi % S.qst;
    mbar_wait(q_empty + qs, ((qi / S.qst) & 1) ^ 1);
    mbar_expect_tx(q_full + qs, S.q_bytes);
    unsigned char* qd = sm + S.q + qs * S.q_bytes;
#pragma unroll
    for (int p = 0; p < D / 16; ++p)
      tma_load_3d(qd + p * S.qrows * 32, qmap, q_full + qs, 16 * p, q0, bh);
    if (chunks == 1) {
      if (bh == held) continue;
      held = bh;
    }
    for (int c = 0; c < chunks; ++c, ++kvi) {
      const uint32_t st = kvi % S.st;
      mbar_wait(kv_empty + st, ((kvi / S.st) & 1) ^ 1);
      mbar_expect_tx(kv_full + st, 2 * S.kv_bytes);
      unsigned char* kd = sm + S.k + st * S.kv_bytes;
      unsigned char* vd = sm + S.v + st * S.kv_bytes;
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        tma_load_3d(kd + p * KC * 32, kmap, kv_full + st, 16 * p, c * KC, bh);
        tma_load_3d(vd + p * KC * 32, vmap, kv_full + st, 16 * p, c * KC, bh);
      }
    }
  }
}

// One chunk's softmax step on the scores s of a consumer thread (rows g and
// g + 8 of its warp's 16, key columns 8j + 2t, + 1 of n-tile j): mask keys
// past nk, the online update of m (log2 domain, scaled) and l, and s replaced
// by p = exp2(s * scale_log2 - m) in fp32 (packed to bf16 by pack_p once the
// p . v that reads the last chunk's p has completed). alpha: the factor the
// p . v accumulators take before this chunk's product is added.
template <int KC, bool FAST>
__device__ __forceinline__ void softmax_chunk(float (&s)[KC / 2], float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], int key0, int nk,
                                              float scale_log2, int t) {
  // each row's maximum and sum in two interleaved partials (n-tiles j even,
  // odd) to halve the dependent chains; a fixed order, so bitwise repeatable
  float cm[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    float* sj = s + 4 * j;
    if (key0 + KC > nk) {  // only the last chunk has keys past nk
      const int col = key0 + j * 8 + 2 * t;
      if (col >= nk) sj[0] = sj[2] = -INFINITY;
      if (col + 1 >= nk) sj[1] = sj[3] = -INFINITY;
    }
    cm[0][j & 1] = fmaxf(cm[0][j & 1], fmaxf(sj[0], sj[1]));
    cm[1][j & 1] = fmaxf(cm[1][j & 1], fmaxf(sj[2], sj[3]));
  }
  // scale > 0, so the maximum of the scaled scores is the scaled maximum; the
  // new m is finite (the chunk holds a key), and the first chunk's alpha is
  // exp2(-inf) = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(fmaxf(cm[r][0], cm[r][1])) * scale_log2);
    alpha[r] = exp2_approx(m[r] - mn);
    m[r] = mn;
  }
  float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < KC / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* e = s + 4 * j + 2 * r;
      e[0] = exp2_approx(fmaf(e[0], scale_log2, -m[r]));
      e[1] = exp2_approx(fmaf(e[1], scale_log2, -m[r]));
      if constexpr (FAST) {  // sum the bf16 values p . v takes, as JAX sums e
        const __nv_bfloat162 b = __floats2bfloat162_rn(e[0], e[1]);
        cs[r][j & 1] += __low2float(b) + __high2float(b);
      } else {
        cs[r][j & 1] += e[0] + e[1];
      }
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], cs[r][0] + cs[r][1]);
}

// p in bf16 as p . v's A fragments: n-tiles 2kb and 2kb + 1 of the scores
// are the fragment of keys 16kb .. 16kb + 15 (a0 = row g's two keys of the
// first n-tile, a1 = row g + 8's, a2, a3 the second n-tile's).
template <int KC>
__device__ __forceinline__ void pack_p(const float (&s)[KC / 2], uint32_t (&p)[KC / 16][4]) {
#pragma unroll
  for (int kb = 0; kb < KC / 16; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[kb][e] = pack_bf16(s[8 * kb + 2 * e], s[8 * kb + 2 * e + 1]);
}

// o += p . v for one chunk: KC / 16 k-steps of m64 x D x k16, A from registers
// (after a wgmma.fence that follows the last write of o and p).
template <int D, int KC>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], uint32_t (&p)[KC / 16][4],
                                         const unsigned char* vs) {
  const uint64_t vd = desc_sw32(vs, KC * 32);
#pragma unroll
  for (int kb = 0; kb < KC / 16; ++kb) wgmma_rs<1>(o, p[kb], vd + ((kb * 16 * 32) >> 4), 1);
  wgmma_commit();
}

// s = q . k^T for the warpgroup's 64 rows and a chunk's KC keys: D / 16
// k-steps of m64 x KC x k16, both operands K-major in shared memory; with PV,
// the previous chunk's o += p . v behind them (KC / 16 k-steps of m64 x D x
// k16, A from registers, v MN-major), its own commit group. With two
// consumer warpgroups, issued in this warpgroup's turn (a ping-pong on named
// barriers). One wgmma.fence before both: every register they read was
// written above it.
template <int D, int KC, int NWG, bool PV>
__device__ __forceinline__ void issue_scores(float (&s)[KC / 2], uint64_t qd,
                                             const unsigned char* ks, int wg, float (&o)[D / 2],
                                             uint32_t (&p)[KC / 16][4], const unsigned char* vs) {
  constexpr int QROWS = 64 * NWG;
  const uint64_t kd = desc_sw32(ks, 16);
  if constexpr (NWG == 2) bar_sync(SCHED_BAR + wg, 256);  // this warpgroup's turn
  pin(s);
  pin(o);
#pragma unroll
  for (int kb = 0; kb < KC / 16; ++kb) pin(p[kb]);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    wgmma_ss<0, 0>(s, qd + ((k * QROWS * 32) >> 4), kd + ((k * KC * 32) >> 4), k > 0);
  wgmma_commit();
  if constexpr (PV) issue_pv<D, KC>(o, p, vs);
  if constexpr (NWG == 2) bar_arrive(SCHED_BAR + (wg ^ 1), 256);  // the other's turn
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// A consumer warpgroup: 64 query rows of each of the CTA's items.
template <int D, int KC, int NWG, bool FAST>
__device__ __forceinline__ void consume(unsigned char* sm, const CUtensorMap* omap,
                                        float* __restrict__ lse, int nq, int nk, int qtiles,
                                        int items, float scale_log2, int wg) {
  constexpr Smem S = smem_layout(D, KC, NWG);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S.bars);
  uint64_t* q_empty = q_full + S.qst;
  uint64_t* kv_full = q_empty + S.qst;
  uint64_t* kv_empty = kv_full + S.st;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = (nk + KC - 1) / KC;
  const Items r = cta_items(items, chunks == 1);
  unsigned char* ob = sm + S.o + wg * S.o_bytes;

  if (NWG == 2 && wg == 1) bar_arrive(SCHED_BAR, 256);  // warpgroup 0 issues first

  float s[KC / 2], o[D / 2];
  uint32_t p[KC / 16][4];
#pragma unroll
  for (int i = 0; i < KC / 2; ++i) s[i] = 0.f;
  uint32_t qi = 0, kvi = 0, prev = 0;  // prev: the stage whose p . v is pending
  int held = -1;                        // the pair whose single chunk stage prev holds
  for (int it = r.first; it < r.end; it += r.step, ++qi) {
    const int bh = it / qtiles, q0 = (it % qtiles) * S.qrows;
    const uint32_t qs = qi % S.qst;
    mbar_wait(q_full + qs, (qi / S.qst) & 1);
    const uint64_t qd = desc_sw32(sm + S.q + qs * S.q_bytes + wg * 64 * 32, 16);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // chunk 0 (a single chunk: the pair's, loaded when the pair changed):
    // its scores and softmax, no p . v in flight yet
    if (chunks > 1 || bh != held) {
      if (chunks == 1 && held >= 0 && lane == 0) mbar_arrive(kv_empty + prev);  // the last pair's
      prev = kvi % S.st;
      mbar_wait(kv_full + prev, (kvi / S.st) & 1);
      ++kvi;
      held = bh;
    }
    issue_scores<D, KC, NWG, false>(s, qd, sm + S.k + prev * S.kv_bytes, wg, o, p, nullptr);
    wgmma_wait<0>();
    pin(s);
    if (chunks == 1 && lane == 0) mbar_arrive(q_empty + qs);  // this warp's q rows are read
    softmax_chunk<KC, FAST>(s, m, l, alpha, 0, nk, scale_log2, t);
    pack_p<KC>(s, p);
    // chunk c's scores, then chunk c - 1's p . v behind them; chunk c's
    // softmax while that p . v runs
    for (int c = 1; c < chunks; ++c, ++kvi) {
      const uint32_t st = kvi % S.st;
      mbar_wait(kv_full + st, (kvi / S.st) & 1);
      rescale<D>(o, alpha);  // before the products' fence: nothing written while one runs
      issue_scores<D, KC, NWG, true>(s, qd, sm + S.k + st * S.kv_bytes, wg, o, p,
                               sm + S.v + prev * S.kv_bytes);
      wgmma_wait<1>();
      pin(s);
      if (c == chunks - 1 && lane == 0) mbar_arrive(q_empty + qs);
      softmax_chunk<KC, FAST>(s, m, l, alpha, c * KC, nk, scale_log2, t);
      wgmma_wait<0>();
      pin(o);
      if (lane == 0) mbar_arrive(kv_empty + prev);
      pack_p<KC>(s, p);  // the last p . v has read the old p
      prev = st;
    }
    rescale<D>(o, alpha);
    pin(o);
#pragma unroll
    for (int kb = 0; kb < KC / 16; ++kb) pin(p[kb]);
    wgmma_fence();
    issue_pv<D, KC>(o, p, sm + S.v + prev * S.kv_bytes);
    wgmma_wait<0>();
    pin(o);
    if (chunks > 1 && lane == 0) mbar_arrive(kv_empty + prev);  // a single chunk stays

    // out = o / l through this warpgroup's staging tile and a TMA store
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]);
      // fast mode: the row's sum rounded to bf16 before the division, as JAX's S
      inv[r] = 1.f / (FAST ? round_bf16(lr) : lr);
      const int row = q0 + wg * 64 + 16 * warp + g + 8 * r;
      if (lse != nullptr && t == 0 && row < nq) lse[size_t(bh) * nq + row] = (m[r] + log2f(lr)) * LN2;
    }
    if (tid == 0) bulk_wait_read<0>();  // the last item's store has read the tile
    bar_sync(EPI_BAR + wg, 128);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
        const int chunk = (i & 1) ^ ((row >> 2) & 1);
        *reinterpret_cast<uint32_t*>(ob + (i >> 1) * 64 * 32 + row * 32 + chunk * 16 + 4 * t) =
            pack_bf16(o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
      }
    fence_proxy_async();
    bar_sync(EPI_BAR + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int pi = 0; pi < D / 16; ++pi)
        tma_store_3d(omap, ob + pi * 64 * 32, 16 * pi, q0 + wg * 64, bh);
      bulk_commit();
    }
  }
  if (NWG == 2 && wg == 0) bar_sync(SCHED_BAR, 256);  // warpgroup 1's last turn
  if (tid == 0) bulk_wait<0>();
}

// grid: persistent CTAs over items = B*H * qtiles (pair-major); NWG consumer
// warpgroups (threads 0 .. 128 NWG - 1), then the producer.
template <int D, int KC, int NWG, bool FAST>
__global__ void __launch_bounds__(cta_threads(NWG), one_cta_an_sm(D, NWG) ? 1 : 2)
    attention_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap, float* __restrict__ lse, int nq,
                     int nk, int qtiles, int items, float scale_log2) {
  constexpr Smem S = smem_layout(D, KC, NWG);
  static_assert(S.st >= 2 && S.qst >= 2 && S.size <= smem_budget(D, NWG), "the rings fit");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((256 - (smem_addr(smem_raw) & 255)) & 255);
  if (threadIdx.x == 0) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(sm + S.bars);
    for (int i = 0; i < S.qst; ++i) {
      mbar_init(bar + i, 1);                        // q full: the producer's expect_tx
      mbar_init(bar + S.qst + i, 4 * NWG);         // q empty: each consumer warp
    }
    for (int i = 0; i < S.st; ++i) {
      mbar_init(bar + 2 * S.qst + i, 1);
      mbar_init(bar + 2 * S.qst + S.st + i, 4 * NWG);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    if constexpr (NWG == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NWG * 128) produce<D, KC, NWG>(sm, &qmap, &kmap, &vmap, nk, qtiles, items);
  } else {
    if constexpr (NWG == 2) setmaxnreg_inc<CONSUMER_REGS>();
    consume<D, KC, NWG, FAST>(sm, &omap, lse, nq, nk, qtiles, items, scale_log2, wg);
  }
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

// The launch plan of a shape: consumer warpgroups a CTA (2: 128 query rows,
// one CTA an SM, wherever that leaves at least one item an SM and Nq > 64;
// else 1: 64 rows, two CTAs an SM), the chunk width (Nk rounded up to 16 up
// to 48, else 64, or 128 with two warpgroups where Nk > WIDE_MIN_NK), and the
// persistent grid. A head width above 128: one warpgroup, 64 keys a chunk, one
// CTA an SM.
struct Plan {
  int nwg, kc, rows, ctas;
};

Plan plan(int bh, int nq, int nk, int d) {
  const int sms = sm_count();
  Plan p;
  if (d > MAX_PLANNED_D) {
    p.nwg = 1;
    p.kc = MAX_KC;
  } else {
    p.nwg = nq <= 64 || (long long)bh * ((nq + 127) / 128) < sms ? 1 : 2;
    p.kc = nk <= 16 ? 16 : nk <= 32 ? 32 : nk <= 48 ? 48
        : p.nwg == 2 && nk > WIDE_MIN_NK ? WIDE_KC : MAX_KC;
  }
  p.rows = 64 * p.nwg;
  const long long items = (long long)bh * ((nq + p.rows - 1) / p.rows);
  p.ctas = int(std::min<long long>(items, (long long)sms * (one_cta_an_sm(d, p.nwg) ? 1 : 2)));
  return p;
}

// A rank-3 map over x [bh, n, d] bf16 with boxes of 16 columns x `rows` rows of
// one pair, 32-byte swizzle; out-of-range elements load as zeros and are not
// stored. Through hopper.cuh's encode, which caches maps per host thread.
bool encode_cached(CUtensorMap* map, const void* x, int d, int n, int bh, int rows) {
  return encode(map, map_key(x, 3, {d, n, bh}, {2LL * d, 2LL * n * d}, {16, rows, 1},
                             CU_TENSOR_MAP_SWIZZLE_32B));
}

// Raise a kernel instance's dynamic shared memory limit once per device: the
// attribute call costs host time of the order of the launch itself, and the
// small shapes are bound by the host.
template <typename Kernel>
cudaError_t raise_smem_once(Kernel kernel, int bytes, std::atomic<unsigned long long>& raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit);
  }
  return cudaSuccess;
}

template <int D, int KC, int NWG, bool FAST>
cudaError_t launch_cfg(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                       int nq, int nk, float scale, int ctas, cudaStream_t stream) {
  constexpr Smem S = smem_layout(D, KC, NWG);
  const long long qtiles = (nq + S.qrows - 1) / S.qrows, items = bh * qtiles;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!encode_cached(&maps[0], q, D, nq, bh, S.qrows) ||
      !encode_cached(&maps[1], k, D, nk, bh, KC) || !encode_cached(&maps[2], v, D, nk, bh, KC) ||
      !encode_cached(&maps[3], out, D, nq, bh, 64))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t e = raise_smem_once(attention_kernel<D, KC, NWG, FAST>, S.size, raised);
  if (e != cudaSuccess) return e;
  attention_kernel<D, KC, NWG, FAST><<<ctas, cta_threads(NWG), S.size, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, nq, nk, int(qtiles), int(items), scale * LOG2E);
  return cudaGetLastError();
}

template <int D, int KC, bool FAST>
cudaError_t launch_kc(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                      int nq, int nk, float scale, const Plan& p, cudaStream_t stream) {
  return p.nwg == 2
             ? launch_cfg<D, KC, 2, FAST>(q, k, v, out, lse, bh, nq, nk, scale, p.ctas, stream)
             : launch_cfg<D, KC, 1, FAST>(q, k, v, out, lse, bh, nq, nk, scale, p.ctas, stream);
}

template <int D, bool FAST>
cudaError_t launch_mode(const void* q, const void* k, const void* v, void* out, float* lse,
                        int bh, int nq, int nk, float scale, cudaStream_t stream) {
  const Plan p = plan(bh, nq, nk, D);
  if constexpr (D > MAX_PLANNED_D) {  // the one plan of a wide head
    return launch_cfg<D, MAX_KC, 1, FAST>(q, k, v, out, lse, bh, nq, nk, scale, p.ctas, stream);
  } else {
    switch (p.kc) {
      case 16: return launch_kc<D, 16, FAST>(q, k, v, out, lse, bh, nq, nk, scale, p, stream);
      case 32: return launch_kc<D, 32, FAST>(q, k, v, out, lse, bh, nq, nk, scale, p, stream);
      case 48: return launch_kc<D, 48, FAST>(q, k, v, out, lse, bh, nq, nk, scale, p, stream);
      case MAX_KC: return launch_kc<D, MAX_KC, FAST>(q, k, v, out, lse, bh, nq, nk, scale, p, stream);
      default:  // WIDE_KC: two consumer warpgroups only
        return launch_cfg<D, WIDE_KC, 2, FAST>(q, k, v, out, lse, bh, nq, nk, scale, p.ctas, stream);
    }
  }
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
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t e = raise_smem_once(attention_probs_kernel<D>, int(smem), raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((nq + PR - 1) / PR, bh);
  attention_probs_kernel<D><<<grid, PTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), lse, p, nq, nk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int wd_attention_max_d() { return MAX_D; }

// Query rows per CTA that the kernel picks for this shape, at a head width up
// to 128 (a wider head always takes 64).
int wd_attention_tile_rows(int bh, int nq) { return plan(bh, nq, 1, MAX_PLANNED_D).rows; }

// The launch plan of a shape at head width d: out[0] query rows a CTA, out[1] keys a chunk, out[2] CTAs (persistent,
// at most one or two an SM), out[3] dynamic shared memory bytes, out[4] q ring
// slots, out[5] k / v ring stages, out[6] and out[7] the producer's and the
// consumers' registers a thread after setmaxnreg (0: not used).
int wd_attention_plan(int bh, int nq, int nk, int d, int* out) {
  if (bh < 1 || nq < 1 || nk < 1 || d < 16 || d % 16 || d > MAX_D) return cudaErrorInvalidValue;
  const Plan p = plan(bh, nq, nk, d);
  const Smem s = smem_layout(d, p.kc, p.nwg);
  const int filled[8] = {p.rows, p.kc, p.ctas, s.size, s.qst, s.st,
                         p.nwg == 2 ? PRODUCER_REGS : 0, p.nwg == 2 ? CONSUMER_REGS : 0};
  std::copy(filled, filled + 8, out);
  return cudaSuccess;
}

// out [bh, nq, d] = softmax(q [bh, nq, d] . k [bh, nk, d]^T * scale) . v [bh, nk, d],
// all bf16, contiguous and 16-byte aligned; d a multiple of 16 up to MAX_D,
// nk >= 1, nq >= 1; with lse non-null, each query row's log-sum-exp [bh, nq]
// fp32 too; fast non-zero: the fast mode (UNetConfig.fast_softmax, the
// header). Returns a cudaError_t (0 on success; a failed tensor-map encode is
// cudaErrorInvalidValue).
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
    case 144: return launch<144>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 160: return launch<160>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 176: return launch<176>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 192: return launch<192>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 208: return launch<208>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 224: return launch<224>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 240: return launch<240>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
    case 256: return launch<256>(q, k, v, out, lse, bh, nq, nk, scale, fast, s);
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
    case 144: return launch_probs<144>(q, k, lse, p, bh, nq, nk, scale, s);
    case 160: return launch_probs<160>(q, k, lse, p, bh, nq, nk, scale, s);
    case 176: return launch_probs<176>(q, k, lse, p, bh, nq, nk, scale, s);
    case 192: return launch_probs<192>(q, k, lse, p, bh, nq, nk, scale, s);
    case 208: return launch_probs<208>(q, k, lse, p, bh, nq, nk, scale, s);
    case 224: return launch_probs<224>(q, k, lse, p, bh, nq, nk, scale, s);
    case 240: return launch_probs<240>(q, k, lse, p, bh, nq, nk, scale, s);
    case 256: return launch_probs<256>(q, k, lse, p, bh, nq, nk, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
