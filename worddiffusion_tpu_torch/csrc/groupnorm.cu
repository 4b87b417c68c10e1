// GroupNorm (+ SiLU) over channel-last activations, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bench_kernels/groupnorm_pallas.py::_gn_kernel
// (reached through fused_groupnorm -> pl.pallas_call). For x [B, S, C] bf16
// (S = H*W pixels, channels contiguous) in G groups of C/G channels:
//
//   mu  = E[x]          over the S * C/G values of a (sample, group), fp32
//   var = E[x^2] - mu^2 (the TPU body's formula), clamped at 0
//   y   = (x - mu) * (rsqrt(var + eps) * scale_c) + bias_c     fp32
//   out = bf16(silu ? y * sigmoid(y) : y)
//
// The clamp: E[x^2] - mu^2 can come out slightly negative in fp32 for a group
// of near-equal values, and var + eps < 0 would give NaN. Clamping at 0 is
// what flax's GroupNorm (the JAX VAE's and OCR's norm) does; the plain version
// (ops/groupnorm.py::groupnorm_reference) clamps too.
//
// What bounds it on this card: memory. It reads x twice (statistics, then the
// normalisation) and writes out once, a few operations per byte. The TPU kernel
// held one whole image in VMEM and read it once; a [64, 256, 128] bf16 image
// (the VAE encoder's first level) is 4 MB, far beyond one SM's shared memory,
// so the work is split in three launches:
//   1. gn_partial_kernel: one CTA per (sample, tile of pixel rows) sums x and
//      x^2 per channel over its rows (16-byte loads, 8 channels a thread), then
//      per group in a fixed order, into partial[b][tile][g];
//   2. gn_finalize_kernel: per (sample, group), the tiles' partial sums in tile
//      order -> (mu, rsqrt(var + eps)) in stats[b][g];
//   3. gn_apply_kernel: normalise, affine, SiLU, store, 8 channels a thread.
// No atomics anywhere: two runs give the same bits (the trainer's bitwise
// resume rests on it). Steps 1 and 2 (wd_groupnorm_stats) are shared with the
// GN -> SiLU -> conv3x3 kernel (gn_silu_conv3x3.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int MAX_C = 8 * THREADS;  // one 8-channel vector column per thread at most
constexpr int ROWS_PER_THREAD = 8;  // pixel rows a thread sums in the partial pass

// vector columns (8 channels each) and rows summed in parallel by one CTA
__host__ __device__ inline int par_rows(int c) { return THREADS / (c / 8); }
__host__ __device__ inline int tile_rows(int c) { return par_rows(c) * ROWS_PER_THREAD; }

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
    f[2 * j] = __low2float(p);
    f[2 * j + 1] = __high2float(p);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    w[j] = *reinterpret_cast<uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// grid (tiles, B). partial[(b * tiles + tile) * G + g] = (sum x, sum x^2).
__global__ void __launch_bounds__(THREADS)
    gn_partial_kernel(const bf16* __restrict__ x, float2* __restrict__ partial, int s, int c,
                      int groups) {
  __shared__ float red_s[MAX_C], red_q[MAX_C];
  const int nv = c / 8, par = THREADS / nv, rows = par * ROWS_PER_THREAD;
  const int tile = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int cv = threadIdx.x % nv, rp = threadIdx.x / nv;
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float sq[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (rp < par) {
    const int end = min(s, (tile + 1) * rows);
    const bf16* xb = x + size_t(b) * s * c + cv * 8;
    for (int r = tile * rows + rp; r < end; r += par) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(xb + size_t(r) * c), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sum[j] += f[j];
        sq[j] += f[j] * f[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red_s[rp * c + cv * 8 + j] = sum[j];
      red_q[rp * c + cv * 8 + j] = sq[j];
    }
  }
  __syncthreads();
  const int cpg = c / groups;
  for (int g = threadIdx.x; g < groups; g += THREADS) {
    float ts = 0.f, tq = 0.f;
    for (int ch = g * cpg; ch < (g + 1) * cpg; ++ch)
      for (int p = 0; p < par; ++p) {
        ts += red_s[p * c + ch];
        tq += red_q[p * c + ch];
      }
    partial[(size_t(b) * tiles + tile) * groups + g] = make_float2(ts, tq);
  }
}

// grid B. stats[b * G + g] = (mu, rsqrt(max(var, 0) + eps)).
__global__ void __launch_bounds__(THREADS)
    gn_finalize_kernel(const float2* __restrict__ partial, float2* __restrict__ stats,
                       int tiles, int groups, float n, float eps) {
  const int b = blockIdx.x;
  for (int g = threadIdx.x; g < groups; g += THREADS) {
    float ts = 0.f, tq = 0.f;
    for (int t = 0; t < tiles; ++t) {
      const float2 p = partial[(size_t(b) * tiles + t) * groups + g];
      ts += p.x;
      tq += p.y;
    }
    const float mu = ts / n;
    const float var = fmaxf(tq / n - mu * mu, 0.f);
    stats[size_t(b) * groups + g] = make_float2(mu, rsqrtf(var + eps));
  }
}

__global__ void __launch_bounds__(THREADS)
    gn_apply_kernel(const bf16* __restrict__ x, const float2* __restrict__ stats,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    bf16* __restrict__ out, size_t vectors, int s, int c, int groups,
                    int silu) {
  const int nv = c / 8, cpg = c / groups;
  for (size_t i = blockIdx.x * size_t(THREADS) + threadIdx.x; i < vectors;
       i += size_t(gridDim.x) * THREADS) {
    const int b = static_cast<int>(i / (size_t(s) * nv));
    const int c0 = static_cast<int>(i % nv) * 8;
    float f[8];
    unpack8(reinterpret_cast<const uint4*>(x)[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = c0 + j;
      const float2 st = stats[size_t(b) * groups + ch / cpg];
      float y = (f[j] - st.x) * (st.y * scale[ch]) + bias[ch];
      if (silu) y = y * (1.f / (1.f + __expf(-y)));
      f[j] = y;
    }
    reinterpret_cast<uint4*>(out)[i] = pack8(f);
  }
}

bool shape_ok(int b, int s, int c, int groups) {
  return b >= 1 && b <= 65535 && s >= 1 && c >= 8 && c % 8 == 0 && c <= MAX_C &&
         groups >= 1 && c % groups == 0;
}

}  // namespace

extern "C" {

int wd_groupnorm_max_c() { return MAX_C; }

// Number of pixel tiles of the partial pass: partial holds B * tiles * G
// float2 (the wrapper allocates it).
int wd_groupnorm_tiles(int s, int c) {
  if (c < 8 || c % 8 || c > MAX_C || s < 1) return 0;
  return (s + tile_rows(c) - 1) / tile_rows(c);
}

// Steps 1 and 2: stats [B, G] float2 (mu, rsqrt(var + eps)) of x [B, S, C]
// bf16 (contiguous, 16-byte aligned). Returns a cudaError_t.
int wd_groupnorm_stats(const void* x, void* partial, void* stats, int b, int s, int c,
                       int groups, float eps, void* stream) {
  if (!shape_ok(b, s, c, groups)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = wd_groupnorm_tiles(s, c);
  gn_partial_kernel<<<dim3(tiles, b), THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<float2*>(partial), s, c, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize_kernel<<<b, THREADS, 0, st>>>(static_cast<const float2*>(partial),
                                           static_cast<float2*>(stats), tiles, groups,
                                           float(s) * float(c / groups), eps);
  return cudaGetLastError();
}

// out [B, S, C] = GroupNorm(x) (+ SiLU), bf16; scale, bias [C] fp32.
int wd_groupnorm(const void* x, const void* scale, const void* bias, void* out, void* partial,
                 void* stats, int b, int s, int c, int groups, float eps, int silu,
                 void* stream) {
  int err = wd_groupnorm_stats(x, partial, stats, b, s, c, groups, eps, stream);
  if (err) return err;
  const size_t vectors = size_t(b) * s * (c / 8);
  const size_t want = (vectors + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  gn_apply_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float2*>(stats),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<bf16*>(out), vectors, s, c, groups, silu);
  return cudaGetLastError();
}

}  // extern "C"
