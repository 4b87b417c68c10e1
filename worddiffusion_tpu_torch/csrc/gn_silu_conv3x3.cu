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
// about 295, so the tensor cores' rate is the bound. The TPU kernel held one
// whole image and its normalised copy in VMEM; the VAE's largest image ([64,
// 256, 128], 4 MB in bf16) does not fit an SM's shared memory, so this is an
// implicit GEMM over pixel tiles, M = pixels, N = output channels, K = 9 taps x
// C input channels:
//   - the statistics come first, from groupnorm.cu's two-launch pass
//     (wd_groupnorm_stats), into stats [B, G] (mu, rsqrt(var + eps));
//   - one CTA of WARPS warps computes BM = 16 * WARPS pixels (a TH x TW
//     rectangle, TW = 32, or 16 for images 16 or fewer wide) for BN output
//     channels (128, or 160 where C is a multiple of 160 and not of 128, as the
//     UNet's 320; 64 for narrow C). The weights are the operand that repeats:
//     every pixel tile reads all of them, so the device-wide weight traffic
//     is (pixels / BM) * 9 C^2; a 256-pixel tile reads them a quarter as often
//     as the earlier 64-pixel one;
//   - K runs in units of (chunk of KC = 64 input channels, tap). A unit's
//     weights, BN x KC bf16, stream through a ring of 3 or 4 slots by cp.async,
//     AHEAD = 2 units ahead of the products, one __syncthreads per unit. At the
//     start of each chunk the tile's (TH + 2) x (TW + 2) pixel halo is
//     normalised and activated into a bf16 halo in shared memory (zero outside
//     the image and past C);
//   - the products, two ways:
//       * 128- and 256-pixel tiles (conv_wgmma_kernel): wgmma.m64nBNk16 bf16,
//         one warpgroup per 64 pixels and all BN channels, fp32 accumulators in
//         registers, B (the weights, in the ring as K-major rows of KC bf16 =
//         128 bytes with the 128-byte swizzle, which spreads wgmma's reads of
//         a row group over all banks) from shared memory behind a descriptor,
//         A (the activation) from registers. Each tap's A operand is
//         the halo shifted by (dy, dx), which no descriptor describes, so each
//         warp loads its 16 pixel rows by ldmatrix from the halo at the tap's
//         offset, in the m16n8k16 fragment layout that wgmma's register A takes.
//         A unit's products stay in flight while the next unit is fetched and
//         its A loaded (wgmma.wait_group 1; the A fragments of two units
//         alternate). The next chunk's raw halo is fetched by cp.async a chunk
//         ahead, in the weights' copy groups, and activated from shared memory,
//         so no load from device memory waits in the products' path;
//       * 64-pixel tiles (conv_mma_kernel: the UNet's regeneration sites, B =
//         16, and its 4 x 16 level): mma.sync.m16n8k16, 2 x 2 warps of 32 pixels
//         x BN / 2 channels, A and B by ldmatrix from the halo and the ring
//         (rows padded to 144 bytes); the halo comes from device memory at the
//         chunk's start, 4 loads in flight a thread. On these tiles a single
//         warpgroup keeps too few wgmma in flight, and it ran slower than
//         mma.sync on the H100;
//   - the tile follows the shape: the largest of 256 and 128 pixels x BN, and
//     64 pixels x BN or x 64, that gives at least one CTA per SM (a tile of
//     twice an image's rows is passed over), so the UNet's regeneration sites
//     do not leave most SMs idle;
//   - the epilogue adds b in fp32 and stores bf16; pixels past H or W and
//     channels past C are masked, so ragged images (5 x 13) and C % 64 != 0
//     (48) need no padding of the inputs.
// Bitwise repeatable: no atomics, and every sum runs in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

extern "C" int wd_groupnorm_stats(const void* x, void* partial, void* stats, int b, int s,
                                  int c, int groups, float eps, void* stream);

namespace {

using bf16 = __nv_bfloat16;

constexpr int KC = 64;            // input channels per chunk
constexpr int LDK = KC + 8;       // bf16 row stride of the halo (and of the mma.sync
                                  // ring): 144 bytes, ldmatrix's 8 rows on distinct banks
constexpr int VPR = KC / 8;       // 16-byte vectors per staged row
constexpr int AHEAD = 2;          // weight units loading while one computes
constexpr int SMS = 132;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// this thread's generic-proxy writes to shared memory, visible to wgmma's
// async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the accumulators in place across the asynchronous products.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, K-major, 128-byte swizzle: rows of 64 bf16
// (128 bytes), 8-row groups 1024 bytes apart; the 16-byte chunk j of row r
// stored at chunk j ^ (r % 8). p is 1024-byte aligned but for the k offset.
__device__ __forceinline__ uint64_t make_desc_sw128(const void* p) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// D[64 x N] += A[64 x 16] (registers, m16n8k16 A fragments, warp w of the
// warpgroup holding rows 16w .. 16w + 15) . B[16 x N] (shared memory, the
// descriptor), fp32 D; overloads by N = 2 * the accumulator count.
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[80], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Weight units in the ring: AHEAD loading, the one computing and, with wgmma,
// the one still in flight.
__host__ __device__ constexpr int stages(bool wg) { return AHEAD + (wg ? 2 : 1); }

// The chunk's per-channel GroupNorm affine (mu, rstd * scale, bias) into
// shared memory, by the first KC threads.
__device__ __forceinline__ void chunk_affine(float* ch_mu, float* ch_s, float* ch_b,
                                             const float2* stats, const float* gn_scale,
                                             const float* gn_bias, int b, int c, int groups,
                                             int c0) {
  if (threadIdx.x < KC) {
    const int ch = c0 + threadIdx.x;
    float mu = 0.f, s = 0.f, bb = 0.f;
    if (ch < c) {
      const float2 st = stats[size_t(b) * groups + ch / (c / groups)];
      mu = st.x;
      s = st.y * gn_scale[ch];
      bb = gn_bias[ch];
    }
    ch_mu[threadIdx.x] = mu;
    ch_s[threadIdx.x] = s;
    ch_b[threadIdx.x] = bb;
  }
}

// bf16(silu(GroupNorm(x))) of the 8 channels v * 8 .. v * 8 + 7 of the chunk.
__device__ __forceinline__ uint4 activate8(uint4 raw, int v, const float* ch_mu,
                                           const float* ch_s, const float* ch_b) {
  const uint32_t rw[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(&rw[j]);
    const int k = v * 8 + 2 * j;
    const float a0 = (__low2float(pr) - ch_mu[k]) * ch_s[k] + ch_b[k];
    const float a1 = (__high2float(pr) - ch_mu[k + 1]) * ch_s[k + 1] + ch_b[k + 1];
    o[j] = pack_bf16(__fdividef(a0, 1.f + __expf(-a0)), __fdividef(a1, 1.f + __expf(-a1)));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The tile and its place: BM = 16 * warps pixels (th x tw) x BN channels.
struct Place {
  int th, hw, y0, x0, n0, b;
  __device__ Place(int bm, int bn, int h, int wd, int c, int tw) {
    th = bm / tw;
    hw = tw + 2;  // halo width
    const int n_tiles = (c + bn - 1) / bn, tiles_x = (wd + tw - 1) / tw;
    const int nt = blockIdx.x % n_tiles, pt = blockIdx.x / n_tiles;
    y0 = (pt / tiles_x) * th;
    x0 = (pt % tiles_x) * tw;
    n0 = nt * bn;
    b = blockIdx.y;
  }
  // halo pixel p, 8-channel vector v of the chunk at c0: inside the image and C
  __device__ bool inside(int p, int v, int c0, int h, int wd, int c) const {
    const int yy = y0 + p / hw - 1, xx = x0 + p % hw - 1;
    return yy >= 0 && yy < h && xx >= 0 && xx < wd && c0 + v * 8 < c;
  }
  __device__ size_t offset(int p, int v, int c0, int wd, int c) const {
    return (size_t(y0 + p / hw - 1) * wd + x0 + p % hw - 1) * c + c0 + v * 8;
  }
};

// out pixels p and p + 8 (one tile row), channels co and co + 1 (+ b), masked
__device__ __forceinline__ void store_pair(bf16* out, const float* bias, const Place& pl, int p,
                                           int co, int h, int wd, int c, int tw, float d0,
                                           float d1, float d2, float d3) {
  const int yy = pl.y0 + p / tw, xa = pl.x0 + p % tw, xb = xa + 8;
  if (yy >= h || co >= c) return;  // co even, C % 8 == 0: co + 1 < C too
  bf16* orow = out + (size_t(pl.b) * h + yy) * wd * c;
  const float b0 = bias[co], b1 = bias[co + 1];
  if (xa < wd)
    *reinterpret_cast<uint32_t*>(orow + size_t(xa) * c + co) = pack_bf16(d0 + b0, d1 + b1);
  if (xb < wd)
    *reinterpret_cast<uint32_t*>(orow + size_t(xb) * c + co) = pack_bf16(d2 + b0, d3 + b1);
}

// ---- 128- and 256-pixel tiles: wgmma -------------------------------------------------
//
// Shared memory, in bf16 elements: the ring [4][BN][KC] (1024-byte aligned, the
// 16-byte chunk j of row n at chunk j ^ (n % 8)), the halo
// [(th + 2) * (tw + 2)][LDK], the next chunk's raw halo [(th + 2) * (tw + 2)][KC].
constexpr int WG_STAGES = AHEAD + 2;  // AHEAD loading, one computing, one in flight

__host__ __device__ constexpr size_t halo_elems(int th, int tw) {
  return size_t(th + 2) * (tw + 2) * LDK;
}

size_t wg_smem_bytes(int bn, int th, int tw) {
  return (size_t(WG_STAGES) * bn * KC + halo_elems(th, tw) + size_t(th + 2) * (tw + 2) * KC) *
             sizeof(bf16) + 1024;
}

// grid (n tiles * pixel tiles, B); WARPS / 4 warpgroups of 64 pixels x BN
template <int WARPS, int BN>
__global__ void __launch_bounds__(WARPS * 32)
    conv_wgmma_kernel(const bf16* __restrict__ x, const float2* __restrict__ stats,
                      const float* __restrict__ gn_scale, const float* __restrict__ gn_bias,
                      const bf16* __restrict__ w, const float* __restrict__ bias,
                      bf16* __restrict__ out, int h, int wd, int c, int groups, int tw) {
  constexpr int THREADS = WARPS * 32, STAGES = WG_STAGES;
  static_assert(WARPS % 4 == 0, "whole warpgroups");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float ch_mu[KC], ch_s[KC], ch_b[KC];  // the chunk's per-channel affine
  const Place pl(WARPS * 16, BN, h, wd, c, tw);
  // the ring 1024-byte aligned for the swizzle
  bf16* ring = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* halo = ring + size_t(STAGES) * BN * KC;
  bf16* raw = halo + halo_elems(pl.th, tw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row
  const bf16* xb = x + size_t(pl.b) * h * wd * c;
  const int chunks = (c + KC - 1) / KC, units = chunks * 9;
  const int halo_vecs = (pl.th + 2) * pl.hw * VPR;

  // unit u = (chunk u / 9, tap u % 9): w[n0 .. n0 + BN, tap, c0 .. c0 + KC] -> its
  // slot. Eight neighbouring threads fill the same 16 bytes of K of 8 rows (on
  // 8 distinct bank groups, by the swizzle) and a warp reads 64 contiguous
  // bytes of each of 8 rows.
  auto load_unit = [&](int u) {
    bf16* slot = ring + size_t(u % STAGES) * BN * KC;
    const int c0 = (u / 9) * KC, tap = u % 9;
    for (int i = threadIdx.x; i < BN * VPR; i += THREADS) {
      const int n = (i & 7) | ((i >> 6) << 3), v = (i >> 3) & 7;
      const int co = pl.n0 + n, ch = c0 + v * 8;
      const bool in = co < c && ch < c;
      const size_t off = in ? (size_t(co) * 9 + tap) * c + ch : 0;
      cp_async16(slot + n * 64 + ((v ^ (n & 7)) * 8), w + off, in ? 16 : 0);
    }
  };
  // chunk cc's raw halo -> raw (zeros outside the image and past C)
  auto load_raw = [&](int cc) {
    for (int i = threadIdx.x; i < halo_vecs; i += THREADS) {
      const int p = i / VPR, v = i % VPR;
      const bool in = pl.inside(p, v, cc * KC, h, wd, c);
      cp_async16(raw + size_t(p) * KC + v * 8, xb + (in ? pl.offset(p, v, cc * KC, wd, c) : 0),
                 in ? 16 : 0);
    }
  };

  // the warp's 16 pixels 16 warp .. + 15 (its warpgroup's rows 16 (warp % 4)):
  // this lane's ldmatrix row in the halo at tap (0, 0)
  const int p0 = 16 * warp;
  const bf16* a_base =
      halo + size_t((p0 / tw) * pl.hw + p0 % tw + (mi & 1) * 8 + lr) * LDK + (mi >> 1) * 8;

  float acc[BN / 2];  // [n8 tile][4]
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][KC / 16][4];  // the A fragments of two units: one in flight, one loading

  load_raw(0);  // in unit 0's group
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < units) load_unit(s);
    cp_async_commit();
  }

  // unit u; par = u % 2 at compile time (the loop below runs units in pairs)
  auto unit = [&](int u, auto par) {
    constexpr int P = decltype(par)::value;
    cp_async_wait<AHEAD - 1>();  // this thread's copies of unit u have landed
    fence_proxy_async();         // and are visible to wgmma
    __syncthreads();             // everyone's; every warpgroup is done with unit u - 2
    const int tap = u % 9;
    if (tap == 0) {
      // a new chunk: its affine, then the halo from its raw copy, normalised and
      // activated; zero outside the image and past C
      const int c0 = (u / 9) * KC;
      chunk_affine(ch_mu, ch_s, ch_b, stats, gn_scale, gn_bias, pl.b, c, groups, c0);
      __syncthreads();
      for (int i = threadIdx.x; i < halo_vecs; i += THREADS) {
        const int p = i / VPR, v = i % VPR;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (pl.inside(p, v, c0, h, wd, c))
          val = activate8(*reinterpret_cast<const uint4*>(raw + size_t(p) * KC + v * 8), v,
                          ch_mu, ch_s, ch_b);
        *reinterpret_cast<uint4*>(halo + size_t(p) * LDK + v * 8) = val;
      }
      __syncthreads();
      // the next chunk's raw halo loads behind this chunk's products
      if (u / 9 + 1 < chunks) load_raw(u / 9 + 1);
    }
    if (u + AHEAD < units) load_unit(u + AHEAD);  // into unit u - 2's slot
    cp_async_commit();

    const bf16* ap = a_base + ((tap / 3) * pl.hw + tap % 3) * LDK;  // shifted by (dy, dx)
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) ldmatrix_x4(a[P][ks], ap + ks * 16);
    const bf16* slot = ring + size_t(u % STAGES) * BN * KC;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      // k16 step ks: 32 bytes into each 128-byte row
      wgmma(acc, a[P][ks], make_desc_sw128(slot + ks * 16));
    pin(acc);
    wgmma_commit();
    wgmma_wait<1>();  // unit u - 1's products are done; unit u's may run on
    pin(acc);
  };
  for (int u = 0; u < units; u += 2) {
    unit(u, std::integral_constant<int, 0>());
    if (u + 1 < units) unit(u + 1, std::integral_constant<int, 1>());
  }
  wgmma_wait<0>();
  pin(acc);
  cp_async_wait<0>();

  // thread (g, t) holds pixels p0 + g and + 8, channels 8 j + 2 t and + 1
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    store_pair(out, bias, pl, p0 + g, pl.n0 + 8 * j + 2 * t, h, wd, c, tw, acc[4 * j],
               acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
}

// ---- 64-pixel tiles: mma.sync ------------------------------------------------------
//
// Shared memory, in bf16 elements: the ring [3][BN][LDK], the halo
// [(th + 2) * (tw + 2)][LDK]. The halo is loaded at the start of its chunk, 4
// loads in flight a thread.
constexpr int MMA_STAGES = AHEAD + 1;  // AHEAD loading, one computing
constexpr int MMA_WARPS = 4;           // 2 along the pixels x 2 along the channels

size_t mma_smem_bytes(int bn, int th, int tw) {
  return (size_t(MMA_STAGES) * bn * LDK + halo_elems(th, tw)) * sizeof(bf16);
}

// grid (n tiles * pixel tiles, B)
template <int BN>
__global__ void __launch_bounds__(MMA_WARPS * 32)
    conv_mma_kernel(const bf16* __restrict__ x, const float2* __restrict__ stats,
                    const float* __restrict__ gn_scale, const float* __restrict__ gn_bias,
                    const bf16* __restrict__ w, const float* __restrict__ bias,
                    bf16* __restrict__ out, int h, int wd, int c, int groups, int tw) {
  constexpr int THREADS = MMA_WARPS * 32, STAGES = MMA_STAGES;
  constexpr int NW = BN / 16;  // n8 tiles per warp (BN / 2 channels)
  static_assert(NW % 2 == 0, "B fragments load two n8 tiles at a time");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float ch_mu[KC], ch_s[KC], ch_b[KC];  // the chunk's per-channel affine
  const Place pl(MMA_WARPS * 16, BN, h, wd, c, tw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][BN][LDK]
  bf16* halo = ring + size_t(STAGES) * BN * LDK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row
  const int wm = warp % 2, wn = warp / 2;
  const bf16* xb = x + size_t(pl.b) * h * wd * c;
  const int chunks = (c + KC - 1) / KC, units = chunks * 9;
  const int halo_vecs = (pl.th + 2) * pl.hw * VPR;

  // unit u = (chunk u / 9, tap u % 9): w[n0 .. n0 + BN, tap, c0 .. c0 + KC] -> its slot
  auto load_unit = [&](int u) {
    bf16* slot = ring + size_t(u % STAGES) * BN * LDK;
    const int c0 = (u / 9) * KC, tap = u % 9;
    for (int i = threadIdx.x; i < BN * VPR; i += THREADS) {
      const int n = i / VPR, v = i % VPR;
      const int co = pl.n0 + n, ch = c0 + v * 8;
      const bool in = co < c && ch < c;
      const size_t off = in ? (size_t(co) * 9 + tap) * c + ch : 0;
      cp_async16(slot + n * LDK + v * 8, w + off, in ? 16 : 0);
    }
  };

  // the warp's m16 tiles i = 0, 1 at pixels 32 wm + 16 i (one tile row each):
  // this lane's ldmatrix row in the halo at tap (0, 0)
  const bf16* a_base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = 32 * wm + 16 * i;
    a_base[i] =
        halo + size_t((q / tw) * pl.hw + q % tw + (mi & 1) * 8 + lr) * LDK + (mi >> 1) * 8;
  }

  float acc[2][NW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < units) load_unit(s);
    cp_async_commit();
  }

  for (int u = 0; u < units; ++u) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of unit u have landed
    __syncthreads();             // everyone's; and every warp is past unit u - 1
    if (u + AHEAD < units) load_unit(u + AHEAD);  // into unit u - 1's slot
    cp_async_commit();

    const int tap = u % 9;
    if (tap == 0) {
      // a new chunk: its affine, then the halo, normalised and activated; zero
      // outside the image and past C
      const int c0 = (u / 9) * KC;
      chunk_affine(ch_mu, ch_s, ch_b, stats, gn_scale, gn_bias, pl.b, c, groups, c0);
      __syncthreads();
      for (int i0 = threadIdx.x; i0 < halo_vecs; i0 += 4 * THREADS) {
        uint4 r4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r * THREADS, p = i / VPR, v = i % VPR;
          const bool in = i < halo_vecs && pl.inside(p, v, c0, h, wd, c);
          r4[r] = in ? *reinterpret_cast<const uint4*>(xb + pl.offset(p, v, c0, wd, c))
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r * THREADS, p = i / VPR, v = i % VPR;
          if (i >= halo_vecs) break;
          *reinterpret_cast<uint4*>(halo + size_t(p) * LDK + v * 8) =
              pl.inside(p, v, c0, h, wd, c) ? activate8(r4[r], v, ch_mu, ch_s, ch_b)
                                            : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      __syncthreads();
    }

    const bf16* slot = ring + size_t(u % STAGES) * BN * LDK;
    const int a_off = ((tap / 3) * pl.hw + tap % 3) * LDK;  // the halo shifted by (dy, dx)
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t am[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(am[i], a_base[i] + a_off + ks * 16);
#pragma unroll
      for (int j = 0; j < NW; j += 2) {
        // matrices: (n tile j, k lo), (j, k hi), (j + 1, k lo), (j + 1, k hi)
        uint32_t bw[4];
        ldmatrix_x4(bw, slot + size_t(wn * (BN / 2) + (j + (mi >> 1)) * 8 + lr) * LDK +
                            ks * 16 + (mi & 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], am[i], bw[0], bw[1]);
          mma_bf16(acc[i][j + 1], am[i], bw[2], bw[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // thread (g, t) holds pixels 32 wm + 16 i + g and + 8, channels 8 j + 2 t and + 1
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
      store_pair(out, bias, pl, 32 * wm + 16 * i + g, pl.n0 + wn * (BN / 2) + 8 * j + 2 * t, h,
                 wd, c, tw, acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
}

// ---- the tile and the launch ------------------------------------------------------

struct Tile {
  int warps, bn, tw;  // 16 or 8 warps: wgmma; 4: mma.sync
};

long long ctas(const Tile& t, int b, int h, int wd, int c) {
  const int th = t.warps * 16 / t.tw;
  return (long long)b * ((h + th - 1) / th) * ((wd + t.tw - 1) / t.tw) * ((c + t.bn - 1) / t.bn);
}

// The largest tile that gives at least one CTA per SM, else the one with the
// most CTAs; a 128- or 256-pixel tile with twice the image's rows is passed
// over.
Tile pick_tile(int b, int h, int wd, int c) {
  const int bn = c % 128 == 0 ? 128 : c % 160 == 0 ? 160 : 64;
  const int tw = wd <= 16 ? 16 : 32;
  const Tile cands[4] = {{16, bn, tw}, {8, bn, tw}, {4, bn, tw}, {4, 64, tw}};
  Tile best = cands[3];
  long long best_n = -1;
  for (const Tile& t : cands) {
    if (t.warps > 4 && t.warps * 16 / t.tw >= 2 * h) continue;
    const long long n = ctas(t, b, h, wd, c);
    if (n >= SMS) return t;
    if (n > best_n) best = t, best_n = n;
  }
  return best;
}

struct Args {
  const bf16* x;
  const float2* stats;
  const float *gn_scale, *gn_bias;
  const bf16* w;
  const float* bias;
  bf16* out;
  int b, h, wd, c, groups;
};

template <typename Kernel>
cudaError_t launch(Kernel kernel, int warps, size_t smem, const Tile& t, const Args& a,
                   cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const long long n = ctas(t, 1, a.h, a.wd, a.c);
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<dim3(unsigned(n), a.b), warps * 32, smem, stream>>>(
      a.x, a.stats, a.gn_scale, a.gn_bias, a.w, a.bias, a.out, a.h, a.wd, a.c, a.groups, t.tw);
  return cudaGetLastError();
}

template <int WARPS>
cudaError_t launch_wgmma(const Tile& t, const Args& a, cudaStream_t s) {
  const size_t smem = wg_smem_bytes(t.bn, WARPS * 16 / t.tw, t.tw);
  if (t.bn == 128) return launch(conv_wgmma_kernel<WARPS, 128>, WARPS, smem, t, a, s);
  if (t.bn == 160) return launch(conv_wgmma_kernel<WARPS, 160>, WARPS, smem, t, a, s);
  return launch(conv_wgmma_kernel<WARPS, 64>, WARPS, smem, t, a, s);
}

cudaError_t launch_mma(const Tile& t, const Args& a, cudaStream_t s) {
  const size_t smem = mma_smem_bytes(t.bn, MMA_WARPS * 16 / t.tw, t.tw);
  if (t.bn == 128) return launch(conv_mma_kernel<128>, MMA_WARPS, smem, t, a, s);
  if (t.bn == 160) return launch(conv_mma_kernel<160>, MMA_WARPS, smem, t, a, s);
  return launch(conv_mma_kernel<64>, MMA_WARPS, smem, t, a, s);
}

}  // namespace

extern "C" {

// The tile the kernel picks for this shape, as (pixels << 16) | channels.
int wd_gn_silu_conv3x3_tile(int b, int h, int wd, int c) {
  const Tile t = pick_tile(b, h, wd, c);
  return (t.warps * 16) << 16 | t.bn;
}

// out [B, H, W, C] = conv3x3(silu(GroupNorm(x)), w) + b; x and out bf16, w
// [C][3][3][C] bf16 (output channel, tap row, tap column, input channel), all
// contiguous and 16-byte aligned; gn_scale, gn_bias, b [C] fp32; partial and
// stats as wd_groupnorm_stats takes them. Returns a cudaError_t.
int wd_gn_silu_conv3x3(const void* x, const void* gn_scale, const void* gn_bias, const void* w,
                       const void* bias, void* out, void* partial, void* stats, int b, int h,
                       int wd, int c, int groups, float eps, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || wd < 1) return cudaErrorInvalidValue;
  int err = wd_groupnorm_stats(x, partial, stats, b, h * wd, c, groups, eps, stream);
  if (err) return err;
  const Tile t = pick_tile(b, h, wd, c);
  const Args a{static_cast<const bf16*>(x),     static_cast<const float2*>(stats),
               static_cast<const float*>(gn_scale), static_cast<const float*>(gn_bias),
               static_cast<const bf16*>(w),     static_cast<const float*>(bias),
               static_cast<bf16*>(out),         b, h, wd, c, groups};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t.warps == 16) return launch_wgmma<16>(t, a, s);
  if (t.warps == 8) return launch_wgmma<8>(t, a, s);
  return launch_mma(t, a, s);
}

}  // extern "C"
