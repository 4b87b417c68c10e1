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
// What bounds it on this card: memory, a few operations per byte; the least
// traffic is x read once and out written once. At the UNet's regeneration
// sites (B = 16, 8 x 32 pixels, 320 or 640 channels: 2.6-5.2 MB) the device
// work is about 10 us and the host's launch path is the bound, so the host
// path is one ctypes call and one allocation (the output). The TPU kernel held
// a whole image in VMEM and read it once; one SM's shared memory holds a
// fraction of the VAE's largest image (a [64, 256, 128] bf16 image is 4 MB), and
// a statistic over a whole image needs the SMs that hold it to agree. So an
// image is split over a thread-block cluster, in one launch:
//   - a cluster of CL CTAs per sample (grid (CL, B)), each CTA a contiguous
//     range of ceil(S / CL) pixel rows, all channels;
//   - each CTA sums x and x^2 per channel over its rows (8 channels a thread),
//     in a fixed order, then per group (a warp a group, a fixed butterfly) into
//     its shared memory;
//   - cluster.sync(); every CTA reads the CL partial sums of each group through
//     distributed shared memory (map_shared_rank) and adds them in rank order,
//     so all CTAs hold the same (mu, rstd); cluster.sync() again before any CTA
//     leaves (these steps are gn_stats.cuh's, shared with the conv kernel);
//   - each CTA normalises its own range. Where the range fits in shared memory
//     (FIT_BYTES) the first pass brought it there by cp.async, every row in
//     flight at once, and device memory sees x once and out once; where it
//     does not (the UNet's 8 x 32, 640-channel sites at B = 128, the VAE
//     decoder's 4-8 MB images), the CTA reads its range again, from L2 where
//     it is still there.
// The cluster size (pick_route) is the smallest of 1, 2, 4, 8 that gives the
// card about two CTAs an SM in one wave: 8 at B = 16, 2 at B = 128. Measured
// at every site on the H100 (kernel_times.py's route sweep, through
// wd_groupnorm_routed), larger clusters are slower at B = 128, and keeping
// the range in shared memory saves little over the L2 re-read. What is left:
// the statistics exchange (two cluster barriers and the group sums, a fixed
// few microseconds, most of a B = 16 call's device time) and, with SiLU, the
// MUFU pipe, hence the sigmoid on one tanh.approx.
// Nothing goes through a global scratch buffer and there are no atomics: two
// runs give the same bits (the trainer's bitwise resume rests on it).
//
// wd_groupnorm_cluster_stats runs the same launch stopped after the
// statistics, rank 0 of each cluster writing stats [B, G] (mu, rstd) to device
// memory, for the GN -> SiLU -> conv3x3 kernel (gn_silu_conv3x3.cu) where a
// sample is more of its CTAs than one cluster holds.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "gn_stats.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int MAX_C = 8 * THREADS;  // one 8-channel vector column per thread at most
constexpr int UNROLL = 4;           // 16-byte loads in flight a thread (cluster kernel)
constexpr int MIN_CTAS = 4;         // cluster kernel CTAs an SM holds at once (<= 64 registers)
// Shared memory of one cluster CTA: its group sums, the cluster's statistics,
// the per-channel reduction buffer and, where it fits, its range of x. A range
// is kept when the whole stays within FIT_BYTES, so that two CTAs share an SM.
constexpr int FIT_BYTES = 112 * 1024;
constexpr int RED_BYTES = 2 * THREADS * 8 * 4;
// Where a CTA keeps its range of x between the two passes.
constexpr int KEEP_NONE = 0, KEEP_SMEM = 1;
// Where a measurement stops the kernel.
constexpr int STOP_NONE = 0, STOP_PASS1 = 1, STOP_STATS = 2;

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

// sigmoid(y) = (1 + tanh(y / 2)) / 2 on one MUFU operation (tanh.approx, relative
// error below 2^-10.9); exp and a reciprocal take two, and at the SiLU sites the
// MUFU pipe is what the normalise pass waits on.
__device__ __forceinline__ float sigmoid(float y) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * y));
  return fmaf(0.5f, t, 0.5f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// ---- one launch: a cluster per sample ---------------------------------------------------
//
// grid (CL, B), cluster (CL, 1, 1). Dynamic shared memory: part [G] float2 (this
// CTA's sums), stat [G] float2 (mu, rstd), red [2][THREADS * 8] fp32 and, with
// keep == KEEP_SMEM, the CTA's rows of x as 16-byte vectors [rows][C / 8]. Each
// thread owns one 8-channel column cv and the rows rp, rp + par, ... of the
// range, in both passes, so a kept vector is read back by the thread that
// stored it. stop (0 but for wd_groupnorm_routed's measurements and
// wd_groupnorm_cluster_stats) ends the kernel after pass 1 (STOP_PASS1) or
// after the statistics (STOP_STATS); stats_out, where not null, takes them
// ([B, G] float2, from rank 0).
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    gn_cluster_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, bf16* __restrict__ out, int s, int c,
                      int groups, float eps, int silu, int keep, int stop,
                      float2* __restrict__ stats_out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = static_cast<int>(cluster.num_blocks());
  extern __shared__ __align__(16) unsigned char smem[];
  float2* part = reinterpret_cast<float2*>(smem);
  float2* stat = part + groups;
  float* red = reinterpret_cast<float*>(stat + groups);  // [2][THREADS * 8]
  uint4* kept = reinterpret_cast<uint4*>(red + 2 * THREADS * 8);

  const int nv = c / 8, par = THREADS / nv, cpg = c / groups;
  const int cv = threadIdx.x % nv, rp = threadIdx.x / nv;
  const int span = (s + cl - 1) / cl, r0 = rank * span, r1 = min(s, r0 + span);
  const size_t base = size_t(blockIdx.y) * s * c + cv * 8;
  const bf16* xb = x + base;

  // pass 1: per-channel sums over the range, rows in order. A kept range goes
  // to shared memory by cp.async, every row of the thread's in flight at once
  // (no registers held); otherwise UNROLL loads are in flight before the first
  // is used.
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float sq[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (rp < par && keep == KEEP_SMEM) {
    for (int r = r0 + rp; r < r1; r += par)
      cp_async16(kept + (r - r0) * nv + cv, xb + size_t(r) * c);
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // this thread's own rows
    for (int r = r0 + rp; r < r1; r += par) gn_stats::add8(kept[(r - r0) * nv + cv], sum, sq);
  } else if (rp < par) {
    gn_stats::sum_rows<UNROLL>(xb, r0 + rp, r1, par, c, sum, sq);
  }
  if (rp < par) gn_stats::store_sums<THREADS>(red, rp, cv, c, sum, sq);
  __syncthreads();
  if (stop == STOP_PASS1) return;
  gn_stats::group_sums<THREADS>(red, par, c, groups, part);
  cluster.sync();
  gn_stats::cluster_stats<THREADS>(part, stat, groups, cl, float(s) * float(cpg), eps);
  cluster.sync();  // every remote read done before any CTA leaves; stat visible

  if (stats_out != nullptr && rank == 0)
    for (int g = threadIdx.x; g < groups; g += THREADS)
      stats_out[size_t(blockIdx.y) * groups + g] = stat[g];
  if (rp >= par || stop == STOP_STATS) return;
  float mu[8], sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = cv * 8 + j;
    const float2 st = stat[ch / cpg];
    mu[j] = st.x;
    sc[j] = st.y * scale[ch];
    bi[j] = bias[ch];
  }
  bf16* ob = out + base;
  // pass 2: normalise the range, from shared memory where it was kept
  for (int r = r0 + rp; r < r1; r += UNROLL * par) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * par;
      v[u] = rr >= r1              ? make_uint4(0u, 0u, 0u, 0u)
             : keep == KEEP_SMEM ? kept[(rr - r0) * nv + cv]
                                 : *reinterpret_cast<const uint4*>(xb + size_t(rr) * c);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * par;
      if (rr >= r1) break;
      float f[8];
      unpack8(v[u], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float y = (f[j] - mu[j]) * sc[j] + bi[j];
        f[j] = silu ? y * sigmoid(y) : y;
      }
      *reinterpret_cast<uint4*>(ob + size_t(rr) * c) = pack8(f);
    }
  }
}

bool shape_ok(int b, int s, int c, int groups) {
  return b >= 1 && b <= 65535 && s >= 1 && c >= 8 && c % 8 == 0 && c <= MAX_C &&
         groups >= 1 && c % groups == 0;
}

struct Route {
  int cl;      // CTAs per cluster (one cluster per sample)
  int keep;    // KEEP_SMEM, or KEEP_NONE (x read twice)
  int smem;    // dynamic shared memory of a CTA, bytes
};

// The route: the smallest cluster of 1, 2, 4, 8 (portable sizes) that gives the
// card B * CL >= 1.9 CTAs an SM, about the two a wave holds (at most 64
// registers and 112 KB of shared memory a CTA); larger clusters hold fewer CTAs
// at once, and a second wave costs more than it spreads. Then x is kept in
// shared memory where the CTA's range fits FIT_BYTES, else read twice (the
// second read mostly from L2).
Route pick_route(int b, int s, int c, int groups) {
  const int fixed = 16 * groups + RED_BYTES;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int cl = 1;
  while (cl < 8 && 10LL * b * cl < 19LL * sms) cl *= 2;
  const long long kept = (long long)((s + cl - 1) / cl) * c * 2;
  if (fixed + kept <= FIT_BYTES) return {cl, KEEP_SMEM, int(fixed + kept)};
  return {cl, KEEP_NONE, fixed};
}

// The dynamic shared memory limit (FIT_BYTES), raised once per device: the
// attribute call costs host time of the order of the launch itself.
cudaError_t raise_limit_once() {
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (raised.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(gn_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           FIT_BYTES);
  if (e != cudaSuccess) return e;
  raised.fetch_or(bit);
  return cudaSuccess;
}

int launch(const void* x, const void* scale, const void* bias, void* out, int b, int s, int c,
           int groups, float eps, int silu, const Route& r, int stop, cudaStream_t stream,
           void* stats_out = nullptr) {
  cudaError_t e = raise_limit_once();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(r.cl, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = r.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = r.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gn_cluster_kernel, static_cast<const bf16*>(x),
                         static_cast<const float*>(scale), static_cast<const float*>(bias),
                         static_cast<bf16*>(out), s, c, groups, eps, silu, r.keep, stop,
                         static_cast<float2*>(stats_out));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int wd_groupnorm_max_c() { return MAX_C; }

// The route of B.5 at this shape, as (cluster size << 1) | x kept in shared
// memory; 0 for a shape the kernel does not take.
int wd_groupnorm_route(int b, int s, int c, int groups) {
  if (!shape_ok(b, s, c, groups)) return 0;
  const Route r = pick_route(b, s, c, groups);
  return r.cl << 1 | r.keep;
}

// stats [B, G] float2 (mu, rsqrt(max(var, 0) + eps)) of x [B, S, C] bf16
// (contiguous, 16-byte aligned): the cluster launch of wd_groupnorm, its range
// of x read once and not kept, stopped after the statistics. Returns a
// cudaError_t.
int wd_groupnorm_cluster_stats(const void* x, void* stats, int b, int s, int c, int groups,
                               float eps, void* stream) {
  if (!shape_ok(b, s, c, groups)) return cudaErrorInvalidValue;
  Route r = pick_route(b, s, c, groups);
  r.keep = KEEP_NONE;
  r.smem = 16 * groups + RED_BYTES;
  return launch(x, nullptr, nullptr, nullptr, b, s, c, groups, eps, 0, r, STOP_STATS,
                static_cast<cudaStream_t>(stream), stats);
}

// out [B, S, C] = GroupNorm(x) (+ SiLU), bf16, in one cluster launch; x and out
// contiguous and 16-byte aligned, scale and bias [C] fp32. Returns a cudaError_t:
// a shape it does not take, or a launch the device refuses.
int wd_groupnorm(const void* x, const void* scale, const void* bias, void* out, int b, int s,
                 int c, int groups, float eps, int silu, void* stream) {
  if (!shape_ok(b, s, c, groups)) return cudaErrorInvalidValue;
  return launch(x, scale, bias, out, b, s, c, groups, eps, silu, pick_route(b, s, c, groups),
                STOP_NONE, static_cast<cudaStream_t>(stream));
}

// For measurements (worddiffusion_tpu_torch/kernel_times.py): wd_groupnorm with
// the route given, cl CTAs per cluster (1, 2, 4 or 8) and x kept in shared
// memory (keep 1, where it fits) or read twice (0), stopped after pass 1 (stop
// 1) or after the statistics (2), or run whole (0).
int wd_groupnorm_routed(const void* x, const void* scale, const void* bias, void* out, int b,
                        int s, int c, int groups, float eps, int silu, int cl, int keep,
                        int stop, void* stream) {
  if (!shape_ok(b, s, c, groups) || (cl != 1 && cl != 2 && cl != 4 && cl != 8) ||
      (keep != KEEP_NONE && keep != KEEP_SMEM) || stop < STOP_NONE || stop > STOP_STATS)
    return cudaErrorInvalidValue;
  const int fixed = 16 * groups + RED_BYTES;
  const long long kept = keep ? (long long)((s + cl - 1) / cl) * c * 2 : 0;
  if (fixed + kept > FIT_BYTES) return cudaErrorInvalidValue;
  return launch(x, scale, bias, out, b, s, c, groups, eps, silu, {cl, keep, int(fixed + kept)},
                stop, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
