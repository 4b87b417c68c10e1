// GroupNorm statistics of a sample split over a thread-block cluster: the
// device steps shared by B.5's cluster kernel (groupnorm.cu) and B.6's conv
// kernel (gn_silu_conv3x3.cu), which takes them in-kernel where a sample's CTAs
// are one cluster. Every sum runs in a fixed order and there are no atomics,
// so two runs give the same bits.
//
// In a CTA of NT threads (NT / 32 warps), each thread owns one 8-channel
// column cv of C and the rows rp, rp + par, ... of the CTA's range of the
// sample's S pixels, par = NT / (C / 8):
//   1. sum_rows: the column's sums of x and x^2 over those rows, in row order;
//   2. store_sums: into red ([2][NT * 8] fp32: the sums, then the squares);
//   3. after a barrier of the NT threads, group_sums: per group a warp adds the
//      group's (row set, channel) sums in order, then a fixed butterfly, into
//      part [G] float2 (sum, sum of squares) in the CTA's shared memory;
//   4. after a cluster barrier, cluster_stats: per group a warp reads the
//      cluster's CL parts through distributed shared memory and adds them in
//      rank order into stat [G] float2 (mu, rsqrt(var + eps)), var = E[x^2] -
//      mu^2 (the TPU body's formula) clamped at 0; every CTA of the cluster holds
//      the same stat. A second cluster barrier ends the remote reads.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace gn_stats {

// x and x^2 of 8 bf16 channels, added into sum and sq.
__device__ __forceinline__ void add8(const uint4& v, float (&sum)[8], float (&sq)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
    const float f0 = __low2float(p), f1 = __high2float(p);
    sum[2 * j] += f0;
    sq[2 * j] += f0 * f0;
    sum[2 * j + 1] += f1;
    sq[2 * j + 1] += f1 * f1;
  }
}

// Rows r, r + par, ... < r1 of the column at xb (row stride c elements), added
// in row order, UNROLL 16-byte loads in flight before the first is used.
template <int UNROLL>
__device__ __forceinline__ void sum_rows(const __nv_bfloat16* __restrict__ xb, int r, int r1,
                                         int par, int c, float (&sum)[8], float (&sq)[8]) {
  for (; r < r1; r += UNROLL * par) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * par;
      v[u] = rr < r1 ? *reinterpret_cast<const uint4*>(xb + size_t(rr) * c)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (r + u * par < r1) add8(v[u], sum, sq);
  }
}

template <int NT>
__device__ __forceinline__ void store_sums(float* red, int rp, int cv, int c,
                                           const float (&sum)[8], const float (&sq)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[rp * c + cv * 8 + j] = sum[j];
    red[NT * 8 + rp * c + cv * 8 + j] = sq[j];
  }
}

template <int NT>
__device__ __forceinline__ void group_sums(const float* red, int par, int c, int groups,
                                           float2* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cpg = c / groups, per_group = par * cpg;
  for (int g = warp; g < groups; g += NT / 32) {
    float ts = 0.f, tq = 0.f;
    for (int e = lane; e < per_group; e += 32) {
      const int i = (e / cpg) * c + g * cpg + e % cpg;
      ts += red[i];
      tq += red[NT * 8 + i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ts += __shfl_xor_sync(0xffffffffu, ts, o);
      tq += __shfl_xor_sync(0xffffffffu, tq, o);
    }
    if (lane == 0) part[g] = make_float2(ts, tq);
  }
}

// n: the values of a (sample, group), S * C / G.
template <int NT>
__device__ __forceinline__ void cluster_stats(float2* part, float2* stat, int groups, int cl,
                                              float n, float eps) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < groups; g += NT / 32) {
    float2 p = make_float2(0.f, 0.f);
    if (lane < cl) p = cluster.map_shared_rank(part, lane)[g];
    float ts = 0.f, tq = 0.f;
    for (int q = 0; q < cl; ++q) {
      ts += __shfl_sync(0xffffffffu, p.x, q);
      tq += __shfl_sync(0xffffffffu, p.y, q);
    }
    if (lane == 0) {
      const float mu = ts / n;
      const float var = fmaxf(tq / n - mu * mu, 0.f);
      stat[g] = make_float2(mu, rsqrtf(var + eps));
    }
  }
}

}  // namespace gn_stats
