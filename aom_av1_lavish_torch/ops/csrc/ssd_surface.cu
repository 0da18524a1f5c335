// K2: exhaustive full-pel SSD surface of each source block against its
// search window — the whole of the two-scale full-pel motion search.
//
// Replaces aom_av1_lavish_tpu/ops/pallas_kernels.py _ssd_lane_kernel
// (via _ssd_lanes_fn, the TPU default) and _ssd_kernel (via
// _ssd_pallas_fn).  Both compute the same surface; their lane/grid split
// is a TPU layout choice, so one kernel family replaces them.  The TPU
// kernels used the f32 identity sum(src^2) + sum(win^2) - 2*corr, which
// is inexact above 2^24; here the sum of squared differences is taken
// directly in 32-bit integers and converted to f32 once at the end.
//
// Two entries:
//
// avl_ssd_surface_plane — the form the motion search calls.  It takes the
// source plane and the padded reference plane themselves (uint8 at full
// resolution, int32 for the half-resolution 2x2 sums, which reach 1020)
// and the block grid, so the (B, W, W) windows never exist in device
// memory.  What the function must move is then the two planes and the
// (B, S, S) f32 surface, and the surface is most of it (35.5 MB of about
// 40 MB at 1080p, bsz 16, r 16): the bound is the surface write.  The
// arithmetic, 2.3e9 squared differences at that shape, runs on the CUDA
// cores: every block meets only its own window, so there is no operand
// shared across blocks for a tensor-core (wgmma) product to amortise, and
// the integer pipes are the compute roof.  The design keeps them fed:
//   * One CTA covers GROUP horizontally adjacent blocks and stages the
//     union of their windows (neighbouring windows overlap by two thirds
//     at r = bsz) and their source rows into shared memory once, with
//     16-byte cp.async copies when every address is 16-byte aligned and a
//     plain loop otherwise.
//   * Each thread owns one dy and a run of four adjacent dx.  Per source
//     row it loads the row (a broadcast) and the window segment once into
//     registers and slides the source over it, so one shared load feeds
//     up to 16 multiply-adds where the window form below issues two
//     shared loads for each.
//   * uint8 planes stay bytes: four pixels a word, the three byte shifts
//     of a window word pair by __byte_perm, |s - w| of four pixels by
//     __vabsdiffu4 and the sum of their squares by one __dp4a.  The
//     differences were chosen over the sum(s^2) + sum(w^2) - 2 sum(s*w)
//     identity because they need no second table of window energies and
//     cannot cancel.  A surface entry is at most 256 * 255^2 = 16.6e6, far
//     below 2^32, so the unsigned accumulator cannot overflow.
//   * int32 planes keep 32-bit lanes (the half-res sums do not fit a
//     byte, and splitting them into two bytes would cost four dp4a for
//     each four pixels, no fewer instructions than the plain subtract and
//     multiply-add).  At the values the search feeds it an entry is at
//     most 64 * 1020^2 = 66.6e6; larger inputs wrap modulo 2^32 exactly
//     as the plain version's int32 sum does.
//   * The P frames of a frame-parallel GF group search the same reference
//     planes, so a stack of source planes goes in one launch: the grid's
//     third axis is the frame, each CTA offsets its source by its frame's
//     stride, and every frame's blocks read the one reference.
//
// avl_ssd_surface — the (src_blk, win) form the Pallas kernels took, for
// callers that already hold windows (none on the encoder's path: TPL and
// the temporal filter pad their reference by the radius and call the plane
// form): one thread block per source block, window and source in shared
// memory as int32, one thread per surface entry.  Any bsz and radius.

#include <cstdint>
#include <cuda_runtime.h>

// ---------------------------------------------------------------------------
// Plane form

namespace {

constexpr int GROUP = 4;     // adjacent blocks per CTA
constexpr int RUN = 4;       // adjacent dx per thread
constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy `rows` rows of `row_bytes` bytes from global (stride g_stride
// bytes) to shared (stride s_stride bytes).  `vec` says that every
// address and length involved is a multiple of 16.
__device__ __forceinline__ void stage_rows(uint8_t* smem, int s_stride,
                                           const uint8_t* gmem,
                                           size_t g_stride, int rows,
                                           int row_bytes, bool vec) {
  if (vec) {
    const int per_row = row_bytes >> 4;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int y = i / per_row;
      const int x = (i - y * per_row) << 4;
      cp_async16(smem + y * s_stride + x, gmem + y * g_stride + x);
    }
  } else {
    for (int i = threadIdx.x; i < rows * row_bytes; i += blockDim.x) {
      const int y = i / row_bytes;
      const int x = i - y * row_bytes;
      smem[y * s_stride + x] = gmem[y * g_stride + x];
    }
  }
}

// One source row against RUN shifts of a window row segment.
template <int BSZ>
__device__ __forceinline__ void row_ssd(const uint8_t* srow,
                                        const uint8_t* wrow,
                                        unsigned (&acc)[RUN]) {
  // srow: BSZ bytes, wrow: BSZ + 4 bytes, both 4-byte aligned
  const uint32_t* s = reinterpret_cast<const uint32_t*>(srow);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(wrow);
  uint32_t wv[BSZ / 4 + 1];
#pragma unroll
  for (int j = 0; j <= BSZ / 4; ++j) wv[j] = w[j];
#pragma unroll
  for (int j = 0; j < BSZ / 4; ++j) {
    const uint32_t sv = s[j];
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      // bytes 4j+k .. 4j+k+3 of the window segment
      const uint32_t wk =
          k == 0 ? wv[j] : __byte_perm(wv[j], wv[j + 1], 0x3210 + 0x1111 * k);
      const unsigned d = __vabsdiffu4(sv, wk);
      acc[k] = __dp4a(d, d, acc[k]);
    }
  }
}

template <int BSZ>
__device__ __forceinline__ void row_ssd(const int32_t* srow,
                                        const int32_t* wrow,
                                        unsigned (&acc)[RUN]) {
  int32_t wv[BSZ + RUN - 1];
#pragma unroll
  for (int j = 0; j < BSZ + RUN - 1; ++j) wv[j] = wrow[j];
#pragma unroll
  for (int j = 0; j < BSZ; ++j) {
    const int32_t sv = srow[j];
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      const unsigned d = (unsigned)sv - (unsigned)wv[j + k];
      acc[k] += d * d;
    }
  }
}

// grid (ceil(nbx / GROUP), nby, frames).  Block (by, bx) of frame f has
// its source at (by*BSZ, bx*BSZ) of src's plane f (src_fstride elements
// apart) and its window at (oy + by*BSZ, ox + bx*BSZ) of the one ref,
// W = 2*radius + BSZ square; frame f's surfaces follow frame f-1's in out.
template <typename T, int BSZ>
__global__ void __launch_bounds__(THREADS)
ssd_plane_kernel(float* __restrict__ out, const T* __restrict__ src,
                 const T* __restrict__ ref, int src_w, int ref_w, int nbx,
                 int radius, int oy, int ox, long long src_fstride) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int W = 2 * radius + BSZ;
  const int S = 2 * radius + 1;
  const int bx0 = blockIdx.x * GROUP;
  const int by = blockIdx.y;
  src += (size_t)blockIdx.z * src_fstride;
  out += (size_t)blockIdx.z * gridDim.y * nbx * S * S;
  const int ng = min(GROUP, nbx - bx0);
  // shared layout, in elements of T: the window union (W rows of
  // win_stride), 16 elements of slack for the last run's over-read, then
  // the source rows (BSZ rows of GROUP*BSZ)
  const int win_cols = W + (GROUP - 1) * BSZ;
  const int win_stride = (win_cols + 15) & ~15;
  const int src_stride = GROUP * BSZ;
  T* swin = reinterpret_cast<T*>(smem_raw);
  T* ssrc = swin + W * win_stride + 16;

  const T* gwin = ref + (size_t)(oy + by * BSZ) * ref_w + ox + bx0 * BSZ;
  const T* gsrc = src + (size_t)(by * BSZ) * src_w + bx0 * BSZ;
  const int win_bytes = (W + (ng - 1) * BSZ) * (int)sizeof(T);
  const int src_bytes = ng * BSZ * (int)sizeof(T);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(gwin) | reinterpret_cast<uintptr_t>(gsrc) |
        ((size_t)ref_w * sizeof(T)) | ((size_t)src_w * sizeof(T)) |
        (size_t)win_bytes | (size_t)src_bytes) & 15) == 0;
  stage_rows(reinterpret_cast<uint8_t*>(swin), win_stride * (int)sizeof(T),
             reinterpret_cast<const uint8_t*>(gwin),
             (size_t)ref_w * sizeof(T), W, win_bytes, vec);
  stage_rows(reinterpret_cast<uint8_t*>(ssrc), src_stride * (int)sizeof(T),
             reinterpret_cast<const uint8_t*>(gsrc),
             (size_t)src_w * sizeof(T), BSZ, src_bytes, vec);
  if (vec) cp_async_wait_all();
  __syncthreads();

  const int runs = (S + RUN - 1) / RUN;
  const int per_blk = S * runs;
  for (int t = threadIdx.x; t < ng * per_blk; t += blockDim.x) {
    const int g = t / per_blk;
    const int rem = t - g * per_blk;
    const int dy = rem / runs;
    const int dx0 = (rem - dy * runs) * RUN;
    unsigned acc[RUN];
#pragma unroll
    for (int k = 0; k < RUN; ++k) acc[k] = 0u;
    const T* wbase = swin + dy * win_stride + g * BSZ + dx0;
    const T* sbase = ssrc + g * BSZ;
#pragma unroll 4
    for (int i = 0; i < BSZ; ++i)
      row_ssd<BSZ>(sbase + i * src_stride, wbase + i * win_stride, acc);
    float* o = out + ((size_t)(by * nbx + bx0 + g) * S + dy) * S + dx0;
#pragma unroll
    for (int k = 0; k < RUN; ++k)
      if (dx0 + k < S) o[k] = (float)(int32_t)acc[k];
  }
}

template <typename T, int BSZ>
int launch_plane(void* out, const void* src, const void* ref, int src_w,
                 int ref_w, int nby, int nbx, int radius, int oy, int ox,
                 int frames, long long src_fstride, cudaStream_t s) {
  const int W = 2 * radius + BSZ;
  const int win_stride = (W + (GROUP - 1) * BSZ + 15) & ~15;
  const size_t smem =
      (size_t)(W * win_stride + 16 + BSZ * GROUP * BSZ) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_plane_kernel<T, BSZ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((nbx + GROUP - 1) / GROUP, nby, frames);
  ssd_plane_kernel<T, BSZ><<<grid, THREADS, smem, s>>>(
      static_cast<float*>(out), static_cast<const T*>(src),
      static_cast<const T*>(ref), src_w, ref_w, nbx, radius, oy, ox,
      src_fstride);
  return (int)cudaGetLastError();
}

}  // namespace

// src: (frames, >= nby*bsz, src_w >= nbx*bsz) planes, src_fstride elements
// apart (one plane: frames 1); ref: (>= oy + (nby-1)*bsz + W, ref_w >= ox +
// (nbx-1)*bsz + W) plane shared by every frame; both of elem_bytes 1
// (uint8) or 4 (int32); out: (frames, nby*nbx, S, S) f32.  bsz is 8 or 16.
extern "C" int avl_ssd_surface_plane(void* out, const void* src,
                                     const void* ref, int src_w, int ref_w,
                                     int nby, int nbx, int bsz, int radius,
                                     int oy, int ox, int elem_bytes,
                                     int frames, long long src_fstride,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (frames < 1 || frames > 65535) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 1 && bsz == 16)
    return launch_plane<uint8_t, 16>(out, src, ref, src_w, ref_w, nby, nbx,
                                     radius, oy, ox, frames, src_fstride, s);
  if (elem_bytes == 1 && bsz == 8)
    return launch_plane<uint8_t, 8>(out, src, ref, src_w, ref_w, nby, nbx,
                                    radius, oy, ox, frames, src_fstride, s);
  if (elem_bytes == 4 && bsz == 16)
    return launch_plane<int32_t, 16>(out, src, ref, src_w, ref_w, nby, nbx,
                                     radius, oy, ox, frames, src_fstride, s);
  if (elem_bytes == 4 && bsz == 8)
    return launch_plane<int32_t, 8>(out, src, ref, src_w, ref_w, nby, nbx,
                                    radius, oy, ox, frames, src_fstride, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Window form

__global__ void ssd_surface_kernel(float* __restrict__ out,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ win,
                                   int bsz, int radius) {
  extern __shared__ int32_t sm[];
  const int W = 2 * radius + bsz;
  const int S = 2 * radius + 1;
  int32_t* swin = sm;
  int32_t* ssrc = sm + W * W;
  const int b = blockIdx.x;
  const int32_t* wb = win + (size_t)b * W * W;
  const int32_t* sb = src + (size_t)b * bsz * bsz;
  for (int i = threadIdx.x; i < W * W; i += blockDim.x) swin[i] = wb[i];
  for (int i = threadIdx.x; i < bsz * bsz; i += blockDim.x) ssrc[i] = sb[i];
  __syncthreads();
  float* ob = out + (size_t)b * S * S;
  for (int o = threadIdx.x; o < S * S; o += blockDim.x) {
    const int dy = o / S;
    const int dx = o - dy * S;
    int32_t acc = 0;
    for (int i = 0; i < bsz; ++i) {
      const int32_t* wrow = swin + (dy + i) * W + dx;
      const int32_t* srow = ssrc + i * bsz;
      for (int j = 0; j < bsz; ++j) {
        const int32_t d = srow[j] - wrow[j];
        acc += d * d;
      }
    }
    ob[o] = (float)acc;
  }
}

extern "C" int avl_ssd_surface(void* out, const void* src, const void* win,
                               int B, int bsz, int radius, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = 2 * radius + bsz;
  const size_t smem = (size_t)(W * W + bsz * bsz) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_surface_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_surface_kernel<<<B, 256, smem, s>>>(
      static_cast<float*>(out), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(win), bsz, radius);
  return (int)cudaGetLastError();
}
