// K1: per-block windows of a plane at dynamic origins — the read side of
// the full-pel refine and of the temporal filter's motion alignment.
//
// Replaces aom_av1_lavish_tpu/ops/pallas_kernels.py _gather_win_kernel
// (via _gather_windows_fn / gather_windows), a scalar-prefetch DMA of
// 128-lane granules that resolved the sub-granule offset in registers.
// On Hopper a window is a strided copy with no arithmetic, so the function
// is bound by device-memory bytes; at the encoder's shapes (8,160 windows of
// 256 bytes at 1080p) the whole call is a few microseconds, and what decides
// its time is how few instructions and memory transactions a window costs
// and how many windows are in flight.  Every index is clamped to the plane,
// so an origin off the plane reads its edge and never outside the
// allocation.  Two entries:
//
// avl_block_ssd_at — the fused form the full-pel refine calls.  The caller
// does not want the windows, only the sum of squared differences of source
// block b against the window at each of its C candidate origins, so the
// windows never reach device memory: what moves is the source plane, the
// reach of the candidates in the reference plane, the origins and B*C sums.
//   * One warp owns one block; a CTA of four warps covers four blocks and
//     needs no block-wide barrier.
//   * The source block goes straight to registers, four pixels a word; each
//     lane keeps the words it will compare.
//   * The candidates of a block normally sit next to each other (a 3x3
//     neighbourhood reaches 18x18 pixels for a 16x16 block).  The warp takes
//     the bounding box of its candidates and, when it fits 32 rows of 48
//     bytes, stages it in shared memory once, with 16-byte loads where the
//     plane allows them (bytes with clamped indices at the plane's edges).
//     Candidates that lie apart are read from the plane directly instead.
//   * Pixels stay packed: a window word at any byte offset is two aligned
//     shared loads and one __byte_perm, |s - w| of four pixels is one
//     __vabsdiffu4 and the sum of their squares one __dp4a, as in the SSD
//     surface kernel.  A sum is at most 256 * 255^2 < 2^24.
//   * Eight lanes share a candidate (eight words each of a 16x16 block, two
//     of an 8x8), so a warp sums four candidates at a time and a sum takes
//     three shuffle steps.
//   * The P frames of a frame-parallel GF group refine against the same
//     reference plane, so a stack of source planes goes in one launch: the
//     warps run over every frame's blocks, and a warp finds its frame's
//     source plane by the frame stride.
//
// avl_gather_windows — the copy itself, for callers that need the pixels
// (the temporal filter's aligned neighbours).  A CTA copies several windows
// and a thread moves 16 bytes.  Where a window row is a multiple of 8 bytes
// (the 16x16 and 8x8 blocks of the encoder) a thread takes a 16-byte
// segment of a row: for uint8 five aligned word loads funnelled by
// __byte_perm to the row's byte offset and one 16-byte store where the
// output row is aligned; the thread layout (segment, row, window) needs no
// divide.  Other widths put their output rows at any byte, so a thread
// takes a 16-byte piece of device memory instead, gathers the elements
// that fall into it and stores them at once.  A window that lies inside
// the plane skips every clamp.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// ---------------------------------------------------------------------------
// Fused form: SSD of each source block at its candidate origins

constexpr int AT_THREADS = 128;
constexpr int WARPS = AT_THREADS / 32;
constexpr int UROWS = 32;    // rows of the staged bounding box
constexpr int UBYTES = 48;   // bytes per staged row (three 16-byte groups)

// src: (frames, >= nby*BSZ, src_w) uint8 planes src_fstride bytes apart,
// block b of frame f at (b / nbx * BSZ, b % nbx * BSZ) of plane f; ref:
// (H, W) uint8, shared by every frame; base_r/base_c: (frames * B, C) window
// origins in ref; out: (frames * B, C) int32.  Eight lanes share a
// candidate, so a warp sums four candidates at a time.
template <int BSZ>
__global__ void __launch_bounds__(AT_THREADS)
block_ssd_at_kernel(int32_t* __restrict__ out, const uint8_t* __restrict__ src,
                    const uint8_t* __restrict__ ref,
                    const int32_t* __restrict__ base_r,
                    const int32_t* __restrict__ base_c, int B, int C, int nbx,
                    int src_w, int H, int W, int frames,
                    long long src_fstride) {
  constexpr int WORDS = BSZ * BSZ / 4;            // 4-pixel words of a block
  constexpr int LPC = 8;                          // lanes per candidate
  constexpr int WPL = WORDS / LPC;                // words per lane
  constexpr int PAR = 32 / LPC;                   // candidates at a time
  constexpr int WPR = BSZ / 4;                    // words per block row
  __shared__ __align__(16) uint8_t sun[WARPS][UROWS * UBYTES + 16];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;       // over frames * B
  if (b >= frames * B) return;                    // the whole warp leaves
  const int f = b / B;
  const int by = (b - f * B) / nbx;
  const int bx = b - f * B - by * nbx;
  src += (size_t)f * src_fstride;
  const int sub = lane / LPC;                     // candidate slot of the lane
  const int l = lane - sub * LPC;

  // this lane's words of the source block: word k = l + i * LPC
  uint32_t sv[WPL];
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    const int k = l + i * LPC;
    const uint8_t* p = src + (size_t)(by * BSZ + k / WPR) * src_w + bx * BSZ +
                       (k % WPR) * 4;
    if ((reinterpret_cast<uintptr_t>(p) & 3) == 0) {
      sv[i] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      sv[i] = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
              ((uint32_t)p[3] << 24);
    }
  }

  // The candidates' origins, one coalesced load when a warp holds them all,
  // and their bounding box (an origin further than one block off the plane
  // reads what one block off reads: the edge).
  const int32_t* br = base_r + (size_t)b * C;
  const int32_t* bc = base_c + (size_t)b * C;
  const bool in_regs = C <= 32;
  int my_r = 0, my_c = 0;
  int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
  for (int c = lane; c < C; c += 32) {
    my_r = clampi(br[c], -BSZ, H);
    my_c = clampi(bc[c], -BSZ, W);
    rmin = min(rmin, my_r);
    rmax = max(rmax, my_r);
    cmin = min(cmin, my_c);
    cmax = max(cmax, my_c);
  }
  rmin = __reduce_min_sync(0xffffffffu, rmin);
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  cmin = __reduce_min_sync(0xffffffffu, cmin);
  cmax = __reduce_max_sync(0xffffffffu, cmax);
  const int cs = cmin & ~15;                      // 16-byte column group
  const int urows = rmax - rmin + BSZ;
  const int ubytes = cmax + BSZ - cs;
  const bool staged = urows <= UROWS && ubytes <= UBYTES;
  uint8_t* su = sun[warp];

  if (staged) {
    // lane y stages row y of the box: its (up to three) 16-byte groups are
    // loaded before any is stored, so the loads are in flight together
    const bool vec =
        ((reinterpret_cast<uintptr_t>(ref) | (uintptr_t)(unsigned)W) & 15) == 0;
    const int groups = (ubytes + 15) >> 4;
    if (lane < urows) {
      const uint8_t* row = ref + (size_t)clampi(rmin + lane, 0, H - 1) * W;
      uint4 v[UBYTES / 16];
#pragma unroll
      for (int g = 0; g < UBYTES / 16; ++g) {
        const int col = cs + 16 * g;
        if (g >= groups) {
          v[g] = make_uint4(0u, 0u, 0u, 0u);
        } else if (vec && col >= 0 && col + 16 <= W) {
          v[g] = *reinterpret_cast<const uint4*>(row + col);
        } else {
          uint32_t w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            w[j] = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              w[j] |= (uint32_t)row[clampi(col + 4 * j + k, 0, W - 1)]
                      << (8 * k);
          }
          v[g] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
#pragma unroll
      for (int g = 0; g < UBYTES / 16; ++g)
        *reinterpret_cast<uint4*>(su + lane * UBYTES + 16 * g) = v[g];
    }
    __syncwarp();
  }

  for (int c0 = 0; c0 < C; c0 += PAR) {
    const int c = c0 + sub;
    const int cl = min(c, C - 1);
    int r, cc;
    if (in_regs) {
      r = __shfl_sync(0xffffffffu, my_r, cl);
      cc = __shfl_sync(0xffffffffu, my_c, cl);
    } else {
      r = clampi(br[cl], -BSZ, H);
      cc = clampi(bc[cl], -BSZ, W);
    }
    unsigned acc = 0;
    if (staged) {
      const uint8_t* base = su + (r - rmin) * UBYTES + (cc - cs);
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const int k = l + i * LPC;
        const uint8_t* p = base + (k / WPR) * UBYTES + (k % WPR) * 4;
        const unsigned sh = (unsigned)(reinterpret_cast<uintptr_t>(p) & 3);
        const uint32_t* q = reinterpret_cast<const uint32_t*>(p - sh);
        const uint32_t wv = __byte_perm(q[0], q[1], 0x3210u + 0x1111u * sh);
        const unsigned d = __vabsdiffu4(sv[i], wv);
        acc = __dp4a(d, d, acc);
      }
    } else {
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const int k = l + i * LPC;
        const uint8_t* row = ref + (size_t)clampi(r + k / WPR, 0, H - 1) * W;
        uint32_t wv = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv |= (uint32_t)row[clampi(cc + (k % WPR) * 4 + j, 0, W - 1)]
                << (8 * j);
        const unsigned d = __vabsdiffu4(sv[i], wv);
        acc = __dp4a(d, d, acc);
      }
    }
#pragma unroll
    for (int o = LPC / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (l == 0 && c < C) out[(size_t)b * C + c] = (int32_t)acc;
  }
}

// ---------------------------------------------------------------------------
// Gather form

// Up to 16 bytes of a uint8 plane row from column c on, n <= 16 of them
// wanted, packed little-endian into w.  [lo, hi) is the plane's allocation.
__device__ __forceinline__ void load_seg(uint32_t (&w)[4], const uint8_t* row,
                                         int c, int n, int W, bool inside,
                                         const uint8_t* lo, const uint8_t* hi) {
  const uint8_t* p = row + c;
  const unsigned sh = (unsigned)(reinterpret_cast<uintptr_t>(p) & 3);
  const uint8_t* pa = p - sh;
  if (inside && n == 16 && pa >= lo && pa + 20 <= hi) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(pa);
    const uint32_t v0 = q[0], v1 = q[1], v2 = q[2], v3 = q[3], v4 = q[4];
    const unsigned sel = 0x3210u + 0x1111u * sh;
    w[0] = __byte_perm(v0, v1, sel);
    w[1] = __byte_perm(v1, v2, sel);
    w[2] = __byte_perm(v2, v3, sel);
    w[3] = __byte_perm(v3, v4, sel);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * j + k;
      if (i < n) {
        const int col = inside ? c + i : clampi(c + i, 0, W - 1);
        w[j] |= (uint32_t)row[col] << (8 * k);
      }
    }
  }
}

// The same for an int32 plane: up to 4 elements.
__device__ __forceinline__ void load_seg(uint32_t (&w)[4], const int32_t* row,
                                         int c, int n, int W, bool inside,
                                         const int32_t*, const int32_t*) {
  if (inside && n == 4 &&
      (reinterpret_cast<uintptr_t>(row + c) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + c);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = 0;
    if (j < n)
      w[j] = (uint32_t)row[inside ? c + j : clampi(c + j, 0, W - 1)];
  }
}

// nbytes <= 16 bytes of w to o, in the widest stores o's alignment allows.
// For an int32 plane o is 4-byte aligned and nbytes a multiple of 4.
__device__ __forceinline__ void store_seg(uint8_t* o, const uint32_t (&w)[4],
                                          int nbytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(o);
  if (nbytes == 16 && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  const bool words = (a & 3) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (words && 4 * j + 4 <= nbytes) {
      reinterpret_cast<uint32_t*>(o)[j] = w[j];
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * j + k < nbytes) o[4 * j + k] = (uint8_t)(w[j] >> (8 * k));
    }
  }
}

// block (segments, rows, windows): thread (x, y, z) copies segments x, x +
// blockDim.x, ... of rows y, y + blockDim.y, ... of window
// blockIdx.x * blockDim.z + z.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_windows_kernel(T* __restrict__ out, const T* __restrict__ plane,
                      const int32_t* __restrict__ base_r,
                      const int32_t* __restrict__ base_c, int B, int H, int W,
                      int wr, int wc, int segs) {
  constexpr int EPS = 16 / (int)sizeof(T);        // elements per segment
  const int b = blockIdx.x * blockDim.z + threadIdx.z;
  if (b >= B) return;
  const int r0 = clampi(base_r[b], -wr, H);
  const int c0 = clampi(base_c[b], -wc, W);
  const bool inside = r0 >= 0 && r0 + wr <= H && c0 >= 0 && c0 + wc <= W;
  T* ob = out + (size_t)b * wr * wc;
  const T* hi = plane + (size_t)H * W;
  for (int y = threadIdx.y; y < wr; y += blockDim.y) {
    const int r = inside ? r0 + y : clampi(r0 + y, 0, H - 1);
    const T* row = plane + (size_t)r * W;
    for (int s = threadIdx.x; s < segs; s += blockDim.x) {
      const int e0 = s * EPS;
      const int n = min(EPS, wc - e0);
      uint32_t w[4];
      load_seg(w, row, c0 + e0, n, W, inside, plane, hi);
      store_seg(reinterpret_cast<uint8_t*>(ob + (size_t)y * wc + e0), w,
                n * (int)sizeof(T));
    }
  }
}

// Windows whose rows are no multiple of 8 bytes: their output rows start at
// any byte, so the window's output is taken as one run of bytes instead and
// cut at the 16-byte boundaries of device memory.  tpw threads share a
// window (about as many as it has pieces, so that small windows fill a CTA
// together and a large one spreads over it), a thread per 16-byte piece,
// which gathers its elements (one divide finds where the piece starts) and
// stores them at once.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_flat_kernel(T* __restrict__ out, const T* __restrict__ plane,
                   const int32_t* __restrict__ base_r,
                   const int32_t* __restrict__ base_c, int B, int H, int W,
                   int wr, int wc, int tpw) {
  constexpr int EPS = 16 / (int)sizeof(T);        // elements per piece
  const int wpb = THREADS / tpw;                  // windows per CTA
  const int wi = threadIdx.x / tpw;
  const int b = blockIdx.x * wpb + wi;
  if (wi >= wpb || b >= B) return;
  const int r0 = clampi(base_r[b], -wr, H);
  const int c0 = clampi(base_c[b], -wc, W);
  const bool inside = r0 >= 0 && r0 + wr <= H && c0 >= 0 && c0 + wc <= W;
  const int n = wr * wc;
  T* ob = out + (size_t)b * n;
  // elements ahead of the output's first 16-byte boundary: piece 0
  const int head = min(
      n, (int)(((16 - (reinterpret_cast<uintptr_t>(ob) & 15)) & 15) /
               sizeof(T)));
  const int pieces = 1 + (n - head + EPS - 1) / EPS;
  for (int j = threadIdx.x - wi * tpw; j < pieces; j += tpw) {
    const int e0 = j == 0 ? 0 : head + (j - 1) * EPS;
    const int cnt = j == 0 ? head : min(EPS, n - e0);
    if (cnt <= 0) continue;
    int y = e0 / wc;
    int x = e0 - y * wc;
    const T* row =
        plane + (size_t)(inside ? r0 + y : clampi(r0 + y, 0, H - 1)) * W;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < EPS; ++i) {
      if (i < cnt) {
        const uint32_t v =
            (uint32_t)row[inside ? c0 + x : clampi(c0 + x, 0, W - 1)];
        if constexpr (sizeof(T) == 1) {
          w[i >> 2] |= v << (8 * (i & 3));
        } else {
          w[i & 3] = v;
        }
        if (++x == wc) {
          x = 0;
          ++y;
          row = plane +
                (size_t)(inside ? r0 + y : clampi(r0 + y, 0, H - 1)) * W;
        }
      }
    }
    store_seg(reinterpret_cast<uint8_t*>(ob + e0), w, cnt * (int)sizeof(T));
  }
}

template <typename T>
int launch_gather(void* out, const void* plane, const int32_t* br,
                  const int32_t* bc, int B, int H, int W, int wr, int wc,
                  cudaStream_t s) {
  if ((wc * (int)sizeof(T)) % 8 != 0) {
    // at most 128 pieces a round, the threads of a window a multiple of 8
    const int pieces = 2 + wr * wc * (int)sizeof(T) / 16;
    const int rounds = (pieces + 127) / 128;
    const int tpw = ((pieces + rounds - 1) / rounds + 7) & ~7;
    const int wpb = THREADS / tpw;
    gather_flat_kernel<T><<<(B + wpb - 1) / wpb, THREADS, 0, s>>>(
        static_cast<T*>(out), static_cast<const T*>(plane), br, bc, B, H, W,
        wr, wc, tpw);
    return (int)cudaGetLastError();
  }
  const int segs = (wc * (int)sizeof(T) + 15) / 16;
  int tx = 1;
  while (tx < segs && tx < 8) tx <<= 1;
  const int ty = wr < 32 ? wr : 32;
  int tz = THREADS / (tx * ty);
  if (tz > 64) tz = 64;                           // blockDim.z's limit
  const dim3 block(tx, ty, tz);
  const dim3 grid((B + tz - 1) / tz);
  gather_windows_kernel<T><<<grid, block, 0, s>>>(
      static_cast<T*>(out), static_cast<const T*>(plane), br, bc, B, H, W, wr,
      wc, segs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int avl_gather_windows(void* out, const void* plane,
                                  const void* base_r, const void* base_c,
                                  int B, int H, int W, int wr, int wc,
                                  int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* br = static_cast<const int32_t*>(base_r);
  const int32_t* bc = static_cast<const int32_t*>(base_c);
  if (wr <= 0 || wc <= 0) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 1)
    return launch_gather<uint8_t>(out, plane, br, bc, B, H, W, wr, wc, s);
  if (elem_bytes == 4)
    return launch_gather<int32_t>(out, plane, br, bc, B, H, W, wr, wc, s);
  return (int)cudaErrorInvalidValue;
}

// out (frames * B, C) int32; src (frames planes of >= nby*bsz rows and src_w
// columns, src_fstride bytes apart) and ref (H, W) uint8; base_r/base_c
// (frames * B, C) int32; B = nby * nbx blocks of bsz 8 or 16 a frame.
extern "C" int avl_block_ssd_at(void* out, const void* src, const void* ref,
                                const void* base_r, const void* base_c, int B,
                                int C, int nbx, int bsz, int src_w, int H,
                                int W, int frames, long long src_fstride,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (frames < 1 || (long long)frames * B > INT_MAX - WARPS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((frames * B + WARPS - 1) / WARPS);
  int32_t* o = static_cast<int32_t*>(out);
  const uint8_t* sp = static_cast<const uint8_t*>(src);
  const uint8_t* rp = static_cast<const uint8_t*>(ref);
  const int32_t* br = static_cast<const int32_t*>(base_r);
  const int32_t* bc = static_cast<const int32_t*>(base_c);
  if (bsz == 16) {
    block_ssd_at_kernel<16><<<grid, AT_THREADS, 0, s>>>(
        o, sp, rp, br, bc, B, C, nbx, src_w, H, W, frames, src_fstride);
  } else if (bsz == 8) {
    block_ssd_at_kernel<8><<<grid, AT_THREADS, 0, s>>>(
        o, sp, rp, br, bc, B, C, nbx, src_w, H, W, frames, src_fstride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
