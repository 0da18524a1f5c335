// K3: batched 8-bit av1_convolve_2d_sr — every sub-pel prediction of
// the motion search, the consensus snap, the filter pick and the merge
// levels.
//
// Replaces aom_av1_lavish_tpu/ops/pallas_kernels.py _conv8_kernel (via
// _conv8_pallas_fn / convolve_8tap).  Rounding follows the reference
// exactly: H pass (acc + 2^14 + 4) >> 3, V pass
// ((acc + 2^19 + 2^10) >> 11) - 384, clipped to 0..255.
//
// Two entries:
//
// avl_convolve_8tap_plane — the form motion compensation calls.  It reads
// each block's (n+7)x(n+7) region straight from the padded uint8 plane at
// the block's origin (rows and columns clamped to the plane as K1 clamps
// them), so neither the gathered uint8 region nor its int32 copy exists
// in device memory: per 16x16 block 529 bytes in and 256 out, where a
// gather, an int32 conversion and the region form below move about 2.4 KB
// through three launches.  It does 16 multiply-adds per output pixel on data read
// once, so it is bound by bytes, and at the slice's batch sizes by launch
// and memory latency more than by bandwidth.  The design is about
// occupancy and few instructions per byte:
//   * The region sits in shared memory as bytes and the horizontal pass
//     writes a 16-bit intermediate.  With AV1's filter rows (taps sum to
//     128, positive taps to at most 184, negative to at least -56) the
//     rounded H result lies in 263..7913, so 16 bits hold it exactly; the
//     entry is exact for any taps whose absolute values sum to at most
//     963.  That is 1.3 KB a block at 16x16 and 14 KB at 64x64, against
//     38 KB for an int32 region and intermediate, so many blocks share
//     an SM.
//   * One 256-thread CTA handles 256 / LANES predicted blocks, LANES = 16,
//     32, 128, 256 threads for n = 8, 16, 32, 64 — a half-warp or warp per
//     block at the small sizes that are most launches — so the 16x16 grid
//     is 1020 full CTAs, not 8160 nearly empty ones.
//   * Each thread keeps its block's 16 taps in registers; an H task is four
//     adjacent outputs of a row from three aligned word loads, a V task is
//     a 4x2 patch whose four output bytes per row go out as one word.
//
// avl_convolve_8tap — the (region, kx, ky) form, for callers that already
// hold an int32 region: one thread block per predicted block, any
// bh and bw, any int32 taps.

#include <cstdint>
#include <cuda_runtime.h>

// ---------------------------------------------------------------------------
// Plane form

namespace {

constexpr int CTA = 256;

template <int N>
struct Geo {
  static constexpr int LANES = N == 8 ? 16 : N == 16 ? 32 : N == 32 ? 128 : 256;
  static constexpr int PER_CTA = CTA / LANES;
  static constexpr int RH = N + 7;                  // region rows
  static constexpr int RS = (N + 7 + 3) & ~3;       // region row stride, bytes
  static constexpr int REG_BYTES = RH * RS;         // multiple of 4
  static constexpr int IM_BYTES = RH * N * 2;       // int16 intermediate
  static constexpr int BLK_BYTES = (REG_BYTES + IM_BYTES + 15) & ~15;
  // the intermediate is stored and loaded as 8-byte words
  static_assert(REG_BYTES % 8 == 0, "intermediate must be 8-byte aligned");
};

template <int N>
__global__ void __launch_bounds__(CTA)
conv8_plane_kernel(uint8_t* __restrict__ out, const uint8_t* __restrict__ ref,
                   const int32_t* __restrict__ base_r,
                   const int32_t* __restrict__ base_c,
                   const int32_t* __restrict__ kx,
                   const int32_t* __restrict__ ky, int B, int H, int W) {
  using G = Geo<N>;
  extern __shared__ __align__(16) uint8_t conv_smem[];
  const int grp = threadIdx.x / G::LANES;
  const int lane = threadIdx.x - grp * G::LANES;
  const int b = blockIdx.x * G::PER_CTA + grp;
  const bool live = b < B;
  uint8_t* sreg = conv_smem + grp * G::BLK_BYTES;
  int16_t* sim = reinterpret_cast<int16_t*>(sreg + G::REG_BYTES);

  int fx[8], fy[8];
  if (live) {
    const int r0 = base_r[b];
    const int c0 = base_c[b];
    const int4* kx4 = reinterpret_cast<const int4*>(kx + (size_t)b * 8);
    const int4* ky4 = reinterpret_cast<const int4*>(ky + (size_t)b * 8);
    const int4 a0 = kx4[0], a1 = kx4[1], b0 = ky4[0], b1 = ky4[1];
    fx[0] = a0.x; fx[1] = a0.y; fx[2] = a0.z; fx[3] = a0.w;
    fx[4] = a1.x; fx[5] = a1.y; fx[6] = a1.z; fx[7] = a1.w;
    fy[0] = b0.x; fy[1] = b0.y; fy[2] = b0.z; fy[3] = b0.w;
    fy[4] = b1.x; fy[5] = b1.y; fy[6] = b1.z; fy[7] = b1.w;
    // region bytes, rows and columns clamped to the plane
    for (int i = lane; i < G::RH * G::RH; i += G::LANES) {
      const int y = i / G::RH;
      const int x = i - y * G::RH;
      const int r = min(max(r0 + y, 0), H - 1);
      const int c = min(max(c0 + x, 0), W - 1);
      sreg[y * G::RS + x] = ref[(size_t)r * W + c];
    }
  }
  __syncthreads();
  if (live) {
    // H pass: task = four adjacent outputs of one region row
    constexpr int HT = N / 4;
    for (int t = lane; t < G::RH * HT; t += G::LANES) {
      const int y = t / HT;
      const int x0 = (t - y * HT) * 4;
      const uint32_t* p =
          reinterpret_cast<const uint32_t*>(sreg + y * G::RS + x0);
      const uint32_t w0 = p[0], w1 = p[1], w2 = p[2];
      int px[12];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        px[j] = (w0 >> (8 * j)) & 255;
        px[4 + j] = (w1 >> (8 * j)) & 255;
        px[8 + j] = (w2 >> (8 * j)) & 255;
      }
      int im[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += fx[k] * px[j + k];
        im[j] = (acc + (1 << 14) + (1 << 2)) >> 3;
      }
      uint2 packed;
      packed.x = (uint32_t)(im[0] & 0xffff) | ((uint32_t)im[1] << 16);
      packed.y = (uint32_t)(im[2] & 0xffff) | ((uint32_t)im[3] << 16);
      *reinterpret_cast<uint2*>(sim + y * N + x0) = packed;
    }
  }
  __syncthreads();
  if (live) {
    // V pass: task = 4 columns x 2 rows
    constexpr int VT = N / 4;
    uint8_t* ob = out + (size_t)b * N * N;
    for (int t = lane; t < (N / 2) * VT; t += G::LANES) {
      const int yy = t / VT;
      const int y0 = yy * 2;
      const int x0 = (t - yy * VT) * 4;
      int acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll
      for (int r = 0; r < 9; ++r) {
        const uint2 v =
            *reinterpret_cast<const uint2*>(sim + (y0 + r) * N + x0);
        int q[4];
        q[0] = (int16_t)(v.x & 0xffff);
        q[1] = (int16_t)(v.x >> 16);
        q[2] = (int16_t)(v.y & 0xffff);
        q[3] = (int16_t)(v.y >> 16);
        if (r < 8) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[0][j] += fy[r] * q[j];
        }
        if (r >= 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[1][j] += fy[r - 1] * q[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int res = ((acc[i][j] + (1 << 19) + (1 << 10)) >> 11) -
                          ((1 << 8) + (1 << 7));
          word |= (uint32_t)min(max(res, 0), 255) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(ob + (y0 + i) * N + x0) = word;
      }
    }
  }
}

template <int N>
int launch_conv8_plane(void* out, const void* ref, const void* base_r,
                       const void* base_c, const void* kx, const void* ky,
                       int B, int H, int W, cudaStream_t s) {
  using G = Geo<N>;
  const size_t smem = (size_t)G::PER_CTA * G::BLK_BYTES;
  const int grid = (B + G::PER_CTA - 1) / G::PER_CTA;
  conv8_plane_kernel<N><<<grid, CTA, smem, s>>>(
      static_cast<uint8_t*>(out), static_cast<const uint8_t*>(ref),
      static_cast<const int32_t*>(base_r),
      static_cast<const int32_t*>(base_c), static_cast<const int32_t*>(kx),
      static_cast<const int32_t*>(ky), B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// ref: (H, W) uint8 plane; base_r/base_c: (B,) int32 region origins; kx/ky:
// (B, 8) int32 taps; out: (B, n, n) uint8.  n is 8, 16, 32 or 64.
extern "C" int avl_convolve_8tap_plane(void* out, const void* ref,
                                       const void* base_r,
                                       const void* base_c, const void* kx,
                                       const void* ky, int B, int H, int W,
                                       int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8:
      return launch_conv8_plane<8>(out, ref, base_r, base_c, kx, ky, B, H, W,
                                   s);
    case 16:
      return launch_conv8_plane<16>(out, ref, base_r, base_c, kx, ky, B, H,
                                    W, s);
    case 32:
      return launch_conv8_plane<32>(out, ref, base_r, base_c, kx, ky, B, H,
                                    W, s);
    case 64:
      return launch_conv8_plane<64>(out, ref, base_r, base_c, kx, ky, B, H,
                                    W, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Region form

__global__ void convolve_8tap_kernel(uint8_t* __restrict__ out,
                                     const int32_t* __restrict__ region,
                                     const int32_t* __restrict__ kx,
                                     const int32_t* __restrict__ ky,
                                     int bh, int bw) {
  extern __shared__ int32_t sm[];
  __shared__ int32_t fx[8];
  __shared__ int32_t fy[8];
  const int rh = bh + 7;
  const int rw = bw + 7;
  int32_t* sreg = sm;
  int32_t* sim = sm + rh * rw;
  const int b = blockIdx.x;
  const int32_t* rb = region + (size_t)b * rh * rw;
  for (int i = threadIdx.x; i < rh * rw; i += blockDim.x) sreg[i] = rb[i];
  if (threadIdx.x < 8) {
    fx[threadIdx.x] = kx[b * 8 + threadIdx.x];
    fy[threadIdx.x] = ky[b * 8 + threadIdx.x];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rh * bw; i += blockDim.x) {
    const int r = i / bw;
    const int c = i - r * bw;
    const int32_t* p = sreg + r * rw + c;
    int32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += fx[k] * p[k];
    sim[i] = (acc + (1 << 14) + (1 << 2)) >> 3;
  }
  __syncthreads();
  uint8_t* ob = out + (size_t)b * bh * bw;
  for (int i = threadIdx.x; i < bh * bw; i += blockDim.x) {
    const int r = i / bw;
    const int c = i - r * bw;
    const int32_t* p = sim + r * bw + c;
    int32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += fy[k] * p[k * bw];
    int32_t res = ((acc + (1 << 19) + (1 << 10)) >> 11) - ((1 << 8) + (1 << 7));
    ob[i] = (uint8_t)min(max(res, 0), 255);
  }
}

extern "C" int avl_convolve_8tap(void* out, const void* region,
                                 const void* kx, const void* ky, int B,
                                 int bh, int bw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      (size_t)((bh + 7) * (bw + 7) + (bh + 7) * bw) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        convolve_8tap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  convolve_8tap_kernel<<<B, 256, smem, s>>>(
      static_cast<uint8_t*>(out), static_cast<const int32_t*>(region),
      static_cast<const int32_t*>(kx), static_cast<const int32_t*>(ky), bh,
      bw);
  return (int)cudaGetLastError();
}
