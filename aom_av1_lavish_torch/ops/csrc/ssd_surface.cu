// K2: exhaustive full-pel SSD surface of each source block against its
// search window — the whole of the two-scale full-pel motion search.
//
// Replaces aom_av1_lavish_tpu/ops/pallas_kernels.py _ssd_lane_kernel
// (via _ssd_lanes_fn, the TPU default) and _ssd_kernel (via
// _ssd_pallas_fn).  Both compute the same surface; their lane/grid split
// is a TPU layout choice, so one kernel family replaces them.
//
// Every route of the reference (its XLA default and both Pallas kernels)
// returns e_src + e_ref - 2*corr in float32.  With S2 = sum(s^2),
// W2 = sum(w^2) and C = sum(s*w) over one candidate position, each summed
// here exactly in 32-bit integers, an entry is:
//   * S2, W2 and C all below 2^24: every partial sum of the reference is
//     an exact integer whatever its order, and its one rounding is the
//     float32 add S2 + W2, so the entry is R(S2 + W2) - 2C, R the
//     round-to-nearest-even int-to-float32 conversion (__int2float_rn;
//     S2 + W2 < 2^25, 2C is exact, and so is the difference).  uint8
//     planes are always here (256 * 255^2 < 2^24).
//   * otherwise (int32 half-resolution planes only): the reference's value
//     depends on the order in which XLA sums and no kernel can promise
//     it, so the entry is the exact S2 + W2 - 2C, converted once.
// The plain version, ops/kernels.py ssd_value_plain, applies the same rule.

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
//   * The rule needs S2 of every block, and W2 and C of every entry.  W2
//     depends on the window position only, and the GROUP blocks of a CTA
//     share their union of windows: the CTA builds a table of W2 for every
//     position in that union once, in shared memory, from sliding sums of
//     w^2 down the columns and then along the rows, and sums each block's
//     S2 once.  A thread then accumulates only C for its entries; the SSD
//     is S2 + W2 - 2C, exact modulo 2^32.  Summing W2 beside C in every
//     thread instead doubles the inner loop's multiply-adds: against the
//     exact-SSD kernel that this rule replaced, that form took 19%, 35%
//     and 19% longer at full res, half res and r 8 on an H100, the table
//     form -1%, +8% and +14% (PERF.md section 6).
//   * uint8 planes stay bytes: four pixels a word, the three byte shifts
//     of a window word pair by __byte_perm and s*w of four pixels by one
//     __dp4a, two instructions for each four pixels and shift where the
//     exact SSD took three (|s - w| by __vabsdiffu4, then __dp4a).  Each
//     sum is at most 256 * 255^2 = 16.6e6, so no unsigned accumulator
//     overflows.
//   * int32 planes keep 32-bit lanes (the half-res sums do not fit a
//     byte, and splitting them into two bytes would cost four dp4a for
//     each four pixels, no fewer instructions than the plain multiply-
//     adds): one multiply-add a pixel and shift.  At the values the
//     search feeds it a sum is at most 64 * 1020^2 = 66.6e6; larger
//     inputs wrap modulo 2^32 exactly as the plain version's int32 sums
//     do.
//   * The P frames of a frame-parallel GF group search the same reference
//     planes, so a stack of source planes goes in one launch: the grid's
//     third axis is the frame, each CTA offsets its source by its frame's
//     stride, and every frame's blocks read the one reference.
//
// avl_ssd_surface — the (src_blk, win) form the Pallas kernels took, for
// callers that already hold windows (none on the encoder's path: TPL and
// the temporal filter pad their reference by the radius and call the plane
// form): one thread block per source block, window and source in shared
// memory as int32, one thread per surface entry, the same rule.  Any bsz
// and radius.

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

// The surface entry from the block's S2, the entry's W2 and C (see the
// header): R(S2 + W2) - 2C where all three lie below 2^24, else the exact
// S2 + W2 - 2C.  __fsub_rn keeps the subtraction a subtraction.
__device__ __forceinline__ float ssd_value(unsigned s2, unsigned w2,
                                           unsigned c) {
  if (((s2 | w2 | c) >> 24) == 0u)
    return __fsub_rn(__int2float_rn((int)(s2 + w2)),
                     __int2float_rn((int)(2u * c)));
  return __int2float_rn((int)(s2 + w2 - 2u * c));
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

// One source row against RUN shifts of a window row segment: adds each
// shift's sum of s*w to c.
template <int BSZ>
__device__ __forceinline__ void row_corr(const uint8_t* srow,
                                         const uint8_t* wrow,
                                         unsigned (&c)[RUN]) {
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
      c[k] = __dp4a(sv, wk, c[k]);
    }
  }
}

template <int BSZ>
__device__ __forceinline__ void row_corr(const int32_t* srow,
                                         const int32_t* wrow,
                                         unsigned (&c)[RUN]) {
  unsigned wv[BSZ + RUN - 1];
#pragma unroll
  for (int j = 0; j < BSZ + RUN - 1; ++j) wv[j] = (unsigned)wrow[j];
#pragma unroll
  for (int j = 0; j < BSZ; ++j) {
    const unsigned sv = (unsigned)srow[j];
#pragma unroll
    for (int k = 0; k < RUN; ++k) c[k] += sv * wv[j + k];
  }
}

// The sum of squares of one source row of BSZ pixels.
template <int BSZ>
__device__ __forceinline__ unsigned row_energy(const uint8_t* srow) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(srow);
  unsigned e = 0u;
#pragma unroll
  for (int j = 0; j < BSZ / 4; ++j) e = __dp4a(s[j], s[j], e);
  return e;
}

template <int BSZ>
__device__ __forceinline__ unsigned row_energy(const int32_t* srow) {
  unsigned e = 0u;
#pragma unroll
  for (int j = 0; j < BSZ; ++j) e += (unsigned)srow[j] * (unsigned)srow[j];
  return e;
}

// The W2 table of a CTA's window union (rows of `cols` elements of T,
// `stride` apart): tab[dy * tstride + x] = the sum of w^2 over the
// BSZ x BSZ window at (dy, x), for dy < S and x < cols - BSZ + 1.  colsum
// (S rows of `cols`, cstride apart, odd so that the row pass's threads,
// each on its own dy, meet no bank twice) holds the column sums between
// the two passes.  Each pass slides its sum over a run of SLIDE outputs:
// two multiply-adds (or adds) an output after the first.
constexpr int SLIDE = 8;

template <typename T, int BSZ>
__device__ __forceinline__ void w2_table(unsigned* tab, int tstride,
                                         unsigned* colsum, int cstride,
                                         const T* swin, int stride, int S,
                                         int cols) {
  const int tcols = cols - BSZ + 1;
  const int nch = (S + SLIDE - 1) / SLIDE;
  for (int e = threadIdx.x; e < nch * cols; e += blockDim.x) {
    const int ch = e / cols;
    const int x = e - ch * cols;
    const int d0 = ch * SLIDE;
    const int d1 = min(S, d0 + SLIDE);
    unsigned acc = 0u;
#pragma unroll
    for (int i = 0; i < BSZ; ++i) {
      const unsigned v = (unsigned)swin[(d0 + i) * stride + x];
      acc += v * v;
    }
    colsum[d0 * cstride + x] = acc;
    for (int dy = d0 + 1; dy < d1; ++dy) {
      const unsigned a = (unsigned)swin[(dy + BSZ - 1) * stride + x];
      const unsigned b = (unsigned)swin[(dy - 1) * stride + x];
      acc += a * a - b * b;
      colsum[dy * cstride + x] = acc;
    }
  }
  __syncthreads();
  const int ncx = (tcols + SLIDE - 1) / SLIDE;
  for (int e = threadIdx.x; e < ncx * S; e += blockDim.x) {
    const int cx = e / S;
    const int dy = e - cx * S;
    const int x0 = cx * SLIDE;
    const int x1 = min(tcols, x0 + SLIDE);
    const unsigned* row = colsum + dy * cstride;
    unsigned acc = 0u;
#pragma unroll
    for (int j = 0; j < BSZ; ++j) acc += row[x0 + j];
    tab[dy * tstride + x0] = acc;
    for (int x = x0 + 1; x < x1; ++x) {
      acc += row[x + BSZ - 1] - row[x - 1];
      tab[dy * tstride + x] = acc;
    }
  }
}

// Shared memory of the plane kernel, in bytes: the window union (W rows
// of win_stride elements of T), 16 elements of slack for the last run's
// over-read, the source rows (BSZ rows of GROUP*BSZ), then the W2 table
// (S rows of tcols) and the column sums (S rows of cstride), unsigned.
struct PlaneSmem {
  int win_stride, tcols, cstride;
  size_t src_off, tab_off, col_off, total;
};

template <typename T, int BSZ>
__host__ __device__ inline PlaneSmem plane_smem(int radius) {
  PlaneSmem m;
  const int W = 2 * radius + BSZ;
  const int S = 2 * radius + 1;
  const int cols = W + (GROUP - 1) * BSZ;
  m.win_stride = (cols + 15) & ~15;
  m.tcols = cols - BSZ + 1;
  m.cstride = cols | 1;
  m.src_off = (size_t)(W * m.win_stride + 16) * sizeof(T);
  m.tab_off = (m.src_off + (size_t)BSZ * GROUP * BSZ * sizeof(T) + 15) &
              ~(size_t)15;
  m.col_off = m.tab_off + (size_t)S * m.tcols * sizeof(unsigned);
  m.total = m.col_off + (size_t)S * m.cstride * sizeof(unsigned);
  return m;
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
  __shared__ unsigned s_s2[GROUP];       // each block's S2
  const int W = 2 * radius + BSZ;
  const int S = 2 * radius + 1;
  const int bx0 = blockIdx.x * GROUP;
  const int by = blockIdx.y;
  src += (size_t)blockIdx.z * src_fstride;
  out += (size_t)blockIdx.z * gridDim.y * nbx * S * S;
  const int ng = min(GROUP, nbx - bx0);
  const PlaneSmem m = plane_smem<T, BSZ>(radius);
  const int win_stride = m.win_stride;
  const int src_stride = GROUP * BSZ;
  T* swin = reinterpret_cast<T*>(smem_raw);
  T* ssrc = reinterpret_cast<T*>(smem_raw + m.src_off);
  unsigned* tab = reinterpret_cast<unsigned*>(smem_raw + m.tab_off);

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
  if (threadIdx.x < GROUP) s_s2[threadIdx.x] = 0u;
  if (vec) cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < ng * BSZ) {
    const int g = threadIdx.x / BSZ;
    const int i = threadIdx.x - g * BSZ;
    atomicAdd(&s_s2[g], row_energy<BSZ>(ssrc + i * src_stride + g * BSZ));
  }
  // the table over the columns this CTA's ng blocks read
  w2_table<T, BSZ>(tab, m.tcols,
                   reinterpret_cast<unsigned*>(smem_raw + m.col_off),
                   m.cstride, swin, win_stride, S, W + (ng - 1) * BSZ);
  __syncthreads();

  const int runs = (S + RUN - 1) / RUN;
  const int per_blk = S * runs;
  for (int t = threadIdx.x; t < ng * per_blk; t += blockDim.x) {
    const int g = t / per_blk;
    const int rem = t - g * per_blk;
    const int dy = rem / runs;
    const int dx0 = (rem - dy * runs) * RUN;
    unsigned c[RUN];
#pragma unroll
    for (int k = 0; k < RUN; ++k) c[k] = 0u;
    const T* wbase = swin + dy * win_stride + g * BSZ + dx0;
    const T* sbase = ssrc + g * BSZ;
#pragma unroll 4
    for (int i = 0; i < BSZ; ++i)
      row_corr<BSZ>(sbase + i * src_stride, wbase + i * win_stride, c);
    const unsigned s2 = s_s2[g];
    const unsigned* w2 = tab + dy * m.tcols + g * BSZ + dx0;
    float* o = out + ((size_t)(by * nbx + bx0 + g) * S + dy) * S + dx0;
#pragma unroll
    for (int k = 0; k < RUN; ++k)
      if (dx0 + k < S) o[k] = ssd_value(s2, w2[k], c[k]);
  }
}

template <typename T, int BSZ>
int launch_plane(void* out, const void* src, const void* ref, int src_w,
                 int ref_w, int nby, int nbx, int radius, int oy, int ox,
                 int frames, long long src_fstride, cudaStream_t s) {
  const size_t smem = plane_smem<T, BSZ>(radius).total;
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
  __shared__ unsigned s2;
  const int W = 2 * radius + bsz;
  const int S = 2 * radius + 1;
  int32_t* swin = sm;
  int32_t* ssrc = sm + W * W;
  const int b = blockIdx.x;
  const int32_t* wb = win + (size_t)b * W * W;
  const int32_t* sb = src + (size_t)b * bsz * bsz;
  for (int i = threadIdx.x; i < W * W; i += blockDim.x) swin[i] = wb[i];
  for (int i = threadIdx.x; i < bsz * bsz; i += blockDim.x) ssrc[i] = sb[i];
  if (threadIdx.x == 0) s2 = 0u;
  __syncthreads();
  unsigned e = 0u;
  for (int i = threadIdx.x; i < bsz * bsz; i += blockDim.x)
    e += (unsigned)ssrc[i] * (unsigned)ssrc[i];
  atomicAdd(&s2, e);
  __syncthreads();
  float* ob = out + (size_t)b * S * S;
  for (int o = threadIdx.x; o < S * S; o += blockDim.x) {
    const int dy = o / S;
    const int dx = o - dy * S;
    unsigned w2 = 0u, c = 0u;
    for (int i = 0; i < bsz; ++i) {
      const int32_t* wrow = swin + (dy + i) * W + dx;
      const int32_t* srow = ssrc + i * bsz;
      for (int j = 0; j < bsz; ++j) {
        const unsigned w = (unsigned)wrow[j];
        w2 += w * w;
        c += (unsigned)srow[j] * w;
      }
    }
    ob[o] = ssd_value(s2, w2, c);
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
