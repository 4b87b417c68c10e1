// GroupNorm -> SiLU -> 3x3 SAME convolution (C -> C channels), by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bench_kernels/resblock_pallas.py::_kernel
// (reached through fused_gn_silu_conv3x3 -> pl.pallas_call), the prologue of
// every SD-VAE resnet and every UNet ResBlock. For x [B, H, W, C] bf16
// (channels contiguous), w [C_out = C][3][3][C_in = C] bf16 and b [C] fp32:
//
//   a   = bf16(silu(GroupNorm(x)))            the statistics as groupnorm.cu's,
//                                             normalised and activated in fp32
//   a   = 0 outside the image                 padded AFTER the activation (:57)
//   out = bf16(sum over the 9 taps (dy, dx) of a[y + dy - 1, x + dx - 1] . w[:, dy, dx, :]
//              + b)                           fp32 accumulate
//
// What bounds it on this card: operations. At the UNet's training shape
// (B = 128, 8 x 32, C = 320) it is 2 * 9 * C * C per pixel, 60 GFLOP against
// 42 MB of x and out: about 1400 FLOP per byte, far above the bf16 ridge of
// about 295. The TPU kernel held one whole image and its normalised copy in
// VMEM; the VAE's largest image ([64, 256, 128], 4 MB in bf16) does not fit an
// SM's shared memory, so this is an implicit GEMM over pixel tiles:
//   - the statistics come first, from groupnorm.cu's two-launch pass
//     (wd_groupnorm_stats), into stats [B, G] (mu, rsqrt(var + eps));
//   - one CTA of 4 warps computes a tile of 4 x 16 output pixels (warp w owns
//     tile row w, 16 pixels) for 64 output channels;
//   - it walks the input channels in chunks of 32. For each chunk it stages
//     the tile's 6 x 18 pixel halo in shared memory as bf16, normalised and
//     activated on the fly (zero outside the image), and the chunk's weights
//     for its 64 output channels and 9 taps. Then the 9 taps are 9 shifted
//     [64 x 32] x [32 x 64] products of mma.sync.m16n8k16 bf16 tiles with fp32
//     accumulators, the A fragments read from the halo at the tap's offset;
//   - the epilogue adds b in fp32 and stores bf16; pixels past H or W and
//     channels past C are masked, so ragged images (5 x 13) and C % 64 != 0
//     (48) need no padding of the inputs.
// Simple first: no cp.async or TMA double buffering, no wgmma; the halo is
// re-read for each of the C / 64 output-channel tiles and the weights for each
// pixel tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

extern "C" int wd_groupnorm_stats(const void* x, void* partial, void* stats, int b, int s,
                                  int c, int groups, float eps, void* stream);

namespace {

using bf16 = __nv_bfloat16;

constexpr int TH = 4, TW = 16;              // output pixel tile
constexpr int HH = TH + 2, HW = TW + 2;     // its halo
constexpr int BN = 64;                      // output channels per CTA
constexpr int KC = 32;                      // input channels per chunk
constexpr int WARPS = TH, THREADS = WARPS * 32;
constexpr int LD = KC + 8;                  // bf16 row stride: 80 bytes, no bank conflicts
constexpr int VPR = KC / 8;                 // 16-byte vectors per staged row
constexpr size_t HALO_ELEMS = size_t(HH) * HW * LD;
constexpr size_t W_ELEMS = size_t(BN) * 9 * LD;
constexpr size_t SMEM_BYTES = (HALO_ELEMS + W_ELEMS) * sizeof(bf16);  // 54,720

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid (tiles_x * tiles_y, ceil(C / BN), B)
__global__ void __launch_bounds__(THREADS)
    gn_silu_conv3x3_kernel(const bf16* __restrict__ x, const float2* __restrict__ stats,
                           const float* __restrict__ gn_scale, const float* __restrict__ gn_bias,
                           const bf16* __restrict__ w, const float* __restrict__ bias,
                           bf16* __restrict__ out, int h, int wd, int c, int groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* halo = reinterpret_cast<bf16*>(smem_raw);  // [HH * HW][LD]
  bf16* ws = halo + HALO_ELEMS;                    // [BN * 9][LD]: (n, tap) rows of k
  __shared__ float ch_mu[KC], ch_s[KC], ch_b[KC];  // the chunk's per-channel affine

  const int tiles_x = (wd + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int cpg = c / groups;
  const bf16* xb = x + size_t(b) * h * wd * c;

  float acc[BN / 8][4];
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int c0 = 0; c0 < c; c0 += KC) {
    if (threadIdx.x < KC) {
      const int ch = c0 + threadIdx.x;
      float mu = 0.f, s = 0.f, bb = 0.f;
      if (ch < c) {
        const float2 st = stats[size_t(b) * groups + ch / cpg];
        mu = st.x;
        s = st.y * gn_scale[ch];
        bb = gn_bias[ch];
      }
      ch_mu[threadIdx.x] = mu;
      ch_s[threadIdx.x] = s;
      ch_b[threadIdx.x] = bb;
    }
    __syncthreads();

    // the halo, normalised and activated; zero outside the image and past C
    for (int i = threadIdx.x; i < HH * HW * VPR; i += THREADS) {
      const int p = i / VPR, v = i % VPR;
      const int yy = y0 + p / HW - 1, xx = x0 + p % HW - 1, ch = c0 + v * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (yy >= 0 && yy < h && xx >= 0 && xx < wd && ch < c) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(xb + (size_t(yy) * wd + xx) * c + ch);
        const uint32_t rw[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(&rw[j]);
          const int k = v * 8 + 2 * j;
          float a0 = (__low2float(pr) - ch_mu[k]) * ch_s[k] + ch_b[k];
          float a1 = (__high2float(pr) - ch_mu[k + 1]) * ch_s[k + 1] + ch_b[k + 1];
          a0 = a0 * (1.f / (1.f + __expf(-a0)));
          a1 = a1 * (1.f / (1.f + __expf(-a1)));
          o[j] = pack_bf16(a0, a1);
        }
        val = make_uint4(o[0], o[1], o[2], o[3]);
      }
      *reinterpret_cast<uint4*>(halo + size_t(p) * LD + v * 8) = val;
    }
    // the chunk's weights for output channels n0 .. n0 + BN - 1, all 9 taps
    for (int i = threadIdx.x; i < BN * 9 * VPR; i += THREADS) {
      const int row = i / VPR, v = i % VPR;  // row = n * 9 + tap
      const int co = n0 + row / 9, ch = c0 + v * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (co < c && ch < c)
        val = *reinterpret_cast<const uint4*>(w + (size_t(co) * 9 + row % 9) * c + ch);
      *reinterpret_cast<uint4*>(ws + size_t(row) * LD + v * 8) = val;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        // rows g and g + 8 of the warp's A tile are output pixels (warp, g) and
        // (warp, g + 8); the tap reads the halo at (warp + dy, pixel + dx)
        const bf16* ap = halo + size_t((warp + dy) * HW + g + dx) * LD + ks * 16 + 2 * t;
        uint32_t a[4];
        a[0] = ld32(ap);
        a[1] = ld32(ap + 8 * LD);
        a[2] = ld32(ap + 8);
        a[3] = ld32(ap + 8 * LD + 8);
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          const bf16* bp = ws + size_t((n * 8 + g) * 9 + tap) * LD + ks * 16 + 2 * t;
          mma_bf16(acc[n], a, ld32(bp), ld32(bp + 8));
        }
      }
    }
    __syncthreads();
  }

  const int yy = y0 + warp, xa = x0 + g, xb2 = xa + 8;
  if (yy >= h) return;
  bf16* orow = out + (size_t(b) * h + yy) * wd * c;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int co = n0 + n * 8 + 2 * t;  // even; C % 8 == 0, so co + 1 < C with co
    if (co >= c) continue;
    const float b0 = bias[co], b1 = bias[co + 1];
    if (xa < wd)
      *reinterpret_cast<uint32_t*>(orow + size_t(xa) * c + co) =
          pack_bf16(acc[n][0] + b0, acc[n][1] + b1);
    if (xb2 < wd)
      *reinterpret_cast<uint32_t*>(orow + size_t(xb2) * c + co) =
          pack_bf16(acc[n][2] + b0, acc[n][3] + b1);
  }
}

}  // namespace

extern "C" {

// out [B, H, W, C] = conv3x3(silu(GroupNorm(x)), w) + b; x and out bf16, w
// [C][3][3][C] bf16 (output channel, tap row, tap column, input channel), all
// contiguous and 16-byte aligned; gn_scale, gn_bias, b [C] fp32; partial and
// stats as wd_groupnorm_stats takes them. Returns a cudaError_t.
int wd_gn_silu_conv3x3(const void* x, const void* gn_scale, const void* gn_bias, const void* w,
                       const void* bias, void* out, void* partial, void* stats, int b, int h,
                       int wd, int c, int groups, float eps, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || wd < 1) return cudaErrorInvalidValue;
  const long long tiles = (long long)((h + TH - 1) / TH) * ((wd + TW - 1) / TW);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  int err = wd_groupnorm_stats(x, partial, stats, b, h * wd, c, groups, eps, stream);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(gn_silu_conv3x3_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(tiles), (c + BN - 1) / BN, b);
  gn_silu_conv3x3_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float2*>(stats),
      static_cast<const float*>(gn_scale), static_cast<const float*>(gn_bias),
      static_cast<const bf16*>(w), static_cast<const float*>(bias), static_cast<bf16*>(out), h,
      wd, c, groups);
  return cudaGetLastError();
}

}  // extern "C"
