// K4, fused entry for the wavefront KEY: one launch codes one wave (one
// anti-diagonal of 16x16 blocks) of all N frames of a batch, all three
// planes.
//
// Replaces, at the KEY's shapes, aom_av1_lavish_tpu/ops/pallas_kernels.py
// _quant_kernel (inline twin wavefront._quantize_jnp) together with its
// producer and its consumers in aom_av1_lavish_tpu/ops/wavefront.py
// (plane_encode and body): edges from the recon with the fill rules, the
// predictions (7 luma modes in WAVE_MODES order, DC for chroma), residual,
// forward DCT_DCT (TX_16X16 luma, TX_8X8 chroma), aom_quantize_b, the bit
// estimate and eob in scan order, dequantize, exact inverse and add, SSE,
// cost = float32(sse) + lam * bits, the first minimum over the modes, and
// the winner's recon, mode, eobs and coefficients written out.
//
// What bounds it.  A wave has at most 68 blocks at 1080p and a block moves
// about 1.6 KB (its source and edges in, its recon and its (390,) int16 row
// out), so neither bytes nor operations (about 0.3 M integer operations a
// block) come near the card's rates: the kernel is bound by latency, and a
// frame by its 187 dependent launches.  The design therefore spends
// threads, not bandwidth:
//   * one CTA per (frame, block), 960 threads; a launch fills at most 68 N
//     of the 132 SMs' slots;
//   * everything of a block lives in shared memory (about 39 KB): source,
//     edges, the 7 + 2 predictions, two ping-pong coefficient buffers, the
//     quantized levels and the recon candidates.  Global memory sees the
//     source block and the edges once in and the winner once out;
//   * the 7 luma modes and the two chroma blocks run side by side: the
//     1792 + 128 positions are spread over the threads, two a thread, so a
//     butterfly stage of all nine transforms is one step between two
//     barriers;
//   * the transforms are the port's own stage tables (common/txfm1d.py
//     fdct_stages / idct_stages, handed over as one int32 tensor by
//     ops/kernels.py wave_tables) run by the interpreter of ops/txfm.py
//     _run_stages, so they are exact by construction: butterfly products
//     in 64 bits, add/sub in 32, the inverse's clamps at 16 bits (bd 8);
//   * the quantizer's products wrap in 32 bits as in quantize_b.cu.
//
// Float decisions keep float32 and a fixed order.  Every float operation
// is an explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn), which
// the compiler never contracts into a fused multiply-add (the file is also
// built with -fmad=false), and log is logf.  The level-bits sum of a block
// is taken by one warp: lane L adds the terms of scan positions L, L + 32,
// L + 64, ... in ascending order, then the 32 partial sums are combined by
// a butterfly over lane distances 16, 8, 4, 2, 1.  The order is the same
// on every run.  The argmin takes the first minimum.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 960;                  // threads a CTA (30 warps)
constexpr int MODES = 7;
constexpr int NY = 256, NC = 64;         // coefficients of a luma / chroma block
constexpr int ITEMS_Y = MODES * NY;      // 1792 luma positions (7 modes)
constexpr int ITEMS = ITEMS_Y + 2 * NC;  // + the u and v blocks: 1920
constexpr int ROW = 390;                 // int16 values of a result row

// Layout of the table tensor (ops/kernels.py wave_tables builds it and
// WAVE_TABLE_OFFSETS names the same offsets).  A stage table is
// [stage][position][kind, src0, src1, w0, w1].
constexpr int T_F16C = 0;      // fdct16, column cos bit   7 x 16 x 5
constexpr int T_F16R = 560;    // fdct16, row cos bit
constexpr int T_I16 = 1120;    // idct16
constexpr int T_F8C = 1680;    // fdct8, column cos bit    5 x 8 x 5
constexpr int T_F8R = 1880;    // fdct8, row cos bit
constexpr int T_I8 = 2080;     // idct8
constexpr int T_SCAN_Y = 2280; // scan order as positions of the kernel's
constexpr int T_SCAN_C = 2536; //   coefficient layout (see quantize below)
constexpr int T_SMW = 2600;    // smooth weights of a 16-wide block
constexpr int T_MODES = 2616;  // WAVE_MODES
constexpr int T_PAR = 2624;    // per size: fwd cos bit col, row, fwd shifts
                               //   s0 s1 s2, inv shifts s0 s1, stages
constexpr int T_TOTAL = 2640;
constexpr int K_ADDSUB = 1, K_BTF = 2;
constexpr int INV_COS_BIT = 12;

__device__ __forceinline__ int32_t mul_wrap(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ int32_t clamp16(int32_t v) {
  return min(max(v, -32768), 32767);
}

// ops/txfm.py _round_shift
__device__ __forceinline__ int32_t round_shift(int32_t x, int bit) {
  if (bit > 0) return (x + (1 << (bit - 1))) >> bit;
  if (bit < 0) return (int32_t)((uint32_t)x << (-bit));
  return x;
}

// The two groups of transforms that run side by side: the 7 luma blocks
// (n 16) and the 2 chroma blocks (n 8), each in its own ping-pong pair.
struct Group {
  int32_t* cur;
  int32_t* alt;
};

// One 1-D pass of all nine blocks (ops/txfm.py _run_stages): along the
// rows (the elements of a line are neighbours) or along the columns.  A
// thread owns position p of a block in both cases, so neighbouring threads
// write neighbouring words.  `post` is the round shift that follows the
// pass and `clamp_out` the 16-bit clamp the inverse applies between its
// passes.
__device__ void txfm_pass(Group& gy, Group& gc, const int32_t* ty,
                          const int32_t* tc, int stages_y, int stages_c,
                          int cos_y, int cos_c, bool along_rows, bool inverse,
                          int post_y, int post_c, bool clamp_out) {
  const int stages = max(stages_y, stages_c);
  for (int s = 0; s < stages; ++s) {
    for (int item = threadIdx.x; item < ITEMS; item += NT) {
      const bool luma = item < ITEMS_Y;
      const int st = luma ? stages_y : stages_c;
      if (s >= st) continue;
      const int lg = luma ? 4 : 3;
      const int n = 1 << lg;
      const int local = luma ? item : item - ITEMS_Y;
      const int p = local & (n * n - 1);
      const int blk = local - p;
      const int hi = p >> lg, lo = p & (n - 1);
      const int i = along_rows ? lo : hi;
      const int line = blk + (along_rows ? (hi << lg) : lo);
      const int es = along_rows ? 1 : n;
      const int32_t* e = (luma ? ty : tc) + (s * n + i) * 5;
      const int32_t* in = luma ? gy.cur : gc.cur;
      const int kind = e[0];
      const int32_t a = in[line + e[1] * es];
      const int32_t b = in[line + e[2] * es];
      const int32_t w0 = e[3], w1 = e[4];
      int32_t v;
      if (kind == K_BTF) {
        const int cb = luma ? cos_y : cos_c;
        v = (int32_t)(((int64_t)a * w0 + (int64_t)b * w1 +
                       ((int64_t)1 << (cb - 1))) >> cb);
      } else if (kind == K_ADDSUB) {
        v = mul_wrap(a, w0) + mul_wrap(b, w1);
        if (inverse) v = clamp16(v);
      } else {
        v = mul_wrap(a, w0);
      }
      if (s == st - 1) {
        v = round_shift(v, luma ? post_y : post_c);
        if (clamp_out) v = clamp16(v);
      }
      (luma ? gy.alt : gc.alt)[blk + p] = v;
    }
    __syncthreads();
    if (s < stages_y) { int32_t* t = gy.cur; gy.cur = gy.alt; gy.alt = t; }
    if (s < stages_c) { int32_t* t = gc.cur; gc.cur = gc.alt; gc.alt = t; }
  }
}

// Edges of one block of one plane with the fill rules of
// reconintra.c (no top: the left neighbour's first pixel or 127; no left:
// the top neighbour's first pixel or 129), and its DC prediction.
// Run by one warp.  edge[0..B) above, edge[B..2B) left, edge[2B] corner.
__device__ void load_edges(const uint8_t* rec, int stride, int y,
                           int x, int B, int32_t* edge, int32_t* dc) {
  const int lane = threadIdx.x & 31;
  const bool top = y > 0, left = x > 0;
  for (int i = lane; i < 2 * B + 1; i += 32) {
    int32_t v;
    if (i < B) {
      v = top ? rec[(size_t)(y - 1) * stride + x + i]
              : (left ? rec[(size_t)y * stride + x - 1] : 127);
    } else if (i < 2 * B) {
      v = left ? rec[(size_t)(y + i - B) * stride + x - 1]
               : (top ? rec[(size_t)(y - 1) * stride + x] : 129);
    } else {
      v = (top && left) ? rec[(size_t)(y - 1) * stride + x - 1]
          : top ? rec[(size_t)(y - 1) * stride + x]
          : left ? rec[(size_t)y * stride + x - 1] : 128;
    }
    edge[i] = v;
  }
  __syncwarp();
  if (lane == 0) {
    int32_t sa = 0, sl = 0;
    for (int i = 0; i < B; ++i) { sa += edge[i]; sl += edge[B + i]; }
    const int lg = B == 16 ? 4 : 3;
    *dc = (top && left) ? (sa + sl + B) >> (lg + 1)
          : top ? (sa + (B >> 1)) >> lg
          : left ? (sl + (B >> 1)) >> lg : 128;
  }
}

__global__ void __launch_bounds__(NT, 1)
wave_encode_kernel(int16_t* __restrict__ rows, float* __restrict__ costs,
                   uint8_t* ry, uint8_t* ru, uint8_t* rv,
                   const uint8_t* __restrict__ sy,
                   const uint8_t* __restrict__ su,
                   const uint8_t* __restrict__ sv,
                   const int32_t* __restrict__ order,
                   const int32_t* __restrict__ pq,
                   const int32_t* __restrict__ tables, int start, int H,
                   int W, float lam, float inv_ln2) {
  __shared__ int32_t tab[T_TOTAL];
  __shared__ int32_t buf0[ITEMS], buf1[ITEMS];
  __shared__ int32_t qbuf[ITEMS];        // quantized levels, kernel layout
  __shared__ uint8_t pred[ITEMS], cand[ITEMS];
  __shared__ uint8_t src[NY + 2 * NC];
  __shared__ int32_t edge[3][33];
  __shared__ int32_t dc[3];
  __shared__ int32_t spq[30];
  __shared__ float bits[MODES + 2];
  __shared__ int32_t eobs[MODES + 2];
  __shared__ float cost[MODES];
  __shared__ int best_s;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int frame = blockIdx.y;
  const int nbc = W >> 4;
  const int nblk = (H >> 4) * nbc;
  const int bid = order[start + blockIdx.x];
  const int y0 = (bid / nbc) << 4, x0 = (bid % nbc) << 4;
  const int Wc = W >> 1, Hc = H >> 1;
  const size_t off_y = (size_t)frame * H * W;
  const size_t off_c = (size_t)frame * Hc * Wc;

  // tables, quantizer parameters, source blocks and edges
  for (int i = tid; i < T_TOTAL; i += NT) tab[i] = tables[i];
  if (tid < 30) spq[tid] = pq[tid];
  if (tid >= 32 && tid < 32 + NY) {
    const int p = tid - 32;
    src[p] = sy[off_y + (size_t)(y0 + (p >> 4)) * W + x0 + (p & 15)];
  } else if (tid >= 32 + NY && tid < 32 + NY + 2 * NC) {
    const int q = tid - 32 - NY, p = q & (NC - 1);
    const uint8_t* s = q < NC ? su : sv;
    src[NY + q] =
        s[off_c + (size_t)((y0 >> 1) + (p >> 3)) * Wc + (x0 >> 1) + (p & 7)];
  } else if (warp >= 27) {
    const int pl = warp - 27;
    if (pl == 0) {
      load_edges(ry + off_y, W, y0, x0, 16, edge[0], &dc[0]);
    } else {
      load_edges((pl == 1 ? ru : rv) + off_c, Wc, y0 >> 1, x0 >> 1, 8,
                 edge[pl], &dc[pl]);
    }
  }
  __syncthreads();

  const int32_t* par_y = tab + T_PAR;
  const int32_t* par_c = tab + T_PAR + 8;

  // predictions (ops/wavefront.py predict_modes) and shifted residuals
  for (int item = tid; item < ITEMS; item += NT) {
    int32_t pv;
    if (item < ITEMS_Y) {
      const int m = item >> 8, p = item & 255, r = p >> 4, c = p & 15;
      const int32_t* ab = edge[0];
      const int32_t* lf = edge[0] + 16;
      const int32_t a = ab[c], l = lf[r], tl = ab[32];
      const int32_t below = lf[15], right = ab[15];
      const int32_t wr = tab[T_SMW + r], wc = tab[T_SMW + c];
      switch (m) {
        case 0: pv = dc[0]; break;
        case 1: pv = a; break;
        case 2: pv = l; break;
        case 3:
          pv = (wr * a + (256 - wr) * below + wc * l + (256 - wc) * right +
                256) >> 9;
          break;
        case 4: pv = (wr * a + (256 - wr) * below + 128) >> 8; break;
        case 5: pv = (wc * l + (256 - wc) * right + 128) >> 8; break;
        default: {
          const int32_t base = a + l - tl;
          const int32_t pl = abs(base - l), pt = abs(base - a),
                        ptl = abs(base - tl);
          pv = (pl <= pt && pl <= ptl) ? l : (pt <= ptl ? a : tl);
        }
      }
      buf0[item] = round_shift((int32_t)src[p] - pv, -par_y[2]);
    } else {
      const int q = item - ITEMS_Y;
      pv = dc[1 + (q >> 6)];
      buf0[item] = round_shift((int32_t)src[NY + q] - pv, -par_c[2]);
    }
    pred[item] = (uint8_t)pv;
  }
  __syncthreads();

  Group gy = {buf0, buf1};
  Group gc = {buf0 + ITEMS_Y, buf1 + ITEMS_Y};
  const int st_y = par_y[7], st_c = par_c[7];

  // forward: columns, round shift, rows, round shift
  txfm_pass(gy, gc, tab + T_F16C, tab + T_F8C, st_y, st_c, par_y[0], par_c[0],
            false, false, -par_y[3], -par_c[3], false);
  txfm_pass(gy, gc, tab + T_F16R, tab + T_F8R, st_y, st_c, par_y[1], par_c[1],
            true, false, -par_y[4], -par_c[4], false);

  // aom_quantize_b (log_scale 0).  Position p = r' * n + c' of the kernel's
  // layout holds the coefficient whose index in the emitter's flat order
  // is c' * n + r' (the forward transform's output transposed), which is
  // also where the inverse wants it; position 0 is the DC either way.
  for (int item = tid; item < ITEMS; item += NT) {
    const bool luma = item < ITEMS_Y;
    const int local = luma ? item : item - ITEMS_Y;
    const int p = local & ((luma ? NY : NC) - 1);
    const int plane = luma ? 0 : 1 + (local >> 6);
    const int32_t* q5 = spq + plane * 10 + (p == 0 ? 0 : 1);
    const int32_t c = (luma ? gy.cur : gc.cur)[local];
    const int32_t ac = c < 0 ? (int32_t)(0u - (uint32_t)c) : c;
    const int32_t sign = c < 0 ? -1 : 1;
    int32_t tmp = (int32_t)((uint32_t)ac + (uint32_t)q5[2]);
    tmp = clamp16(tmp);
    int32_t t = (mul_wrap(tmp, q5[4]) >> 16) + tmp;
    t = mul_wrap(t, q5[6]) >> 16;
    t = ac >= q5[0] ? t : 0;
    qbuf[item] = mul_wrap(sign, t);
    // the inverse clamps its input to 16 bits (bd 8)
    (luma ? gy.cur : gc.cur)[local] =
        clamp16(mul_wrap(sign, mul_wrap(t, q5[8])));
  }
  __syncthreads();

  // bit estimate and eob of each of the nine blocks (ops/wavefront.py
  // est_bits): one warp a block, in the order stated at the top
  if (warp < MODES + 2) {
    const bool luma = warp < MODES;
    const int n2 = luma ? NY : NC;
    const int32_t* q = qbuf + (luma ? warp * NY : ITEMS_Y + (warp - MODES) * NC);
    const int32_t* scan = tab + (luma ? T_SCAN_Y : T_SCAN_C);
    int eob = 0, nnz = 0;
    float lb = 0.0f;
    for (int j = lane; j < n2; j += 32) {
      const int32_t v = q[scan[j]];
      if (v != 0) {
        eob = j + 1;
        ++nnz;
        const float aq = (float)(v < 0 ? -v : v);
        const float l2 = __fmul_rn(logf(__fadd_rn(aq, 1.0f)), inv_ln2);
        lb = __fadd_rn(lb, __fadd_rn(1.7f, __fmul_rn(2.0f, l2)));
      }
    }
    for (int d = 16; d > 0; d >>= 1) {
      eob = max(eob, __shfl_xor_sync(0xffffffffu, eob, d));
      nnz += __shfl_xor_sync(0xffffffffu, nnz, d);
      lb = __fadd_rn(lb, __shfl_xor_sync(0xffffffffu, lb, d));
    }
    if (lane == 0) {
      const float l2 = __fmul_rn(logf(__fadd_rn((float)eob, 1.0f)), inv_ln2);
      float b = __fadd_rn(2.0f, __fmul_rn(0.9f, l2));
      b = __fadd_rn(b, __fmul_rn(0.55f, (float)(eob - nnz)));
      b = __fadd_rn(b, lb);
      bits[warp] = eob == 0 ? 0.6f : b;
      eobs[warp] = eob;
    }
  }
  // (the inverse's first barrier also publishes bits and eobs)

  // inverse: rows, round shift, clamp, columns, round shift
  txfm_pass(gy, gc, tab + T_I16, tab + T_I8, st_y, st_c, INV_COS_BIT,
            INV_COS_BIT, true, true, -par_y[5], -par_c[5], true);
  txfm_pass(gy, gc, tab + T_I16, tab + T_I8, st_y, st_c, INV_COS_BIT,
            INV_COS_BIT, false, true, -par_y[6], -par_c[6], false);

  // recon candidates; a block without coefficients keeps its prediction
  for (int item = tid; item < ITEMS; item += NT) {
    const bool luma = item < ITEMS_Y;
    const int blk = luma ? item >> 8 : MODES + ((item - ITEMS_Y) >> 6);
    const int32_t res = luma ? gy.cur[item] : gc.cur[item - ITEMS_Y];
    const int32_t pv = pred[item];
    cand[item] = eobs[blk] > 0 ? (uint8_t)min(max(pv + res, 0), 255)
                               : (uint8_t)pv;
  }
  __syncthreads();

  // SSE and cost of each luma mode, one warp a mode
  if (warp < MODES) {
    int32_t sse = 0;
    for (int p = lane; p < NY; p += 32) {
      const int32_t d = (int32_t)src[p] - (int32_t)cand[warp * NY + p];
      sse += d * d;
    }
    for (int d = 16; d > 0; d >>= 1)
      sse += __shfl_xor_sync(0xffffffffu, sse, d);
    if (lane == 0)
      cost[warp] = __fadd_rn((float)sse, __fmul_rn(lam, bits[warp]));
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    for (int m = 1; m < MODES; ++m)
      if (cost[m] < cost[best]) best = m;
    best_s = best;
  }
  __syncthreads();
  const int best = best_s;

  // the winner: recon into the planes, the row in the emitter's layout
  // (mode, 3 eobs, 2 zeros, 256 + 64 + 64 levels as int16), the costs
  if (tid < NY) {
    ry[off_y + (size_t)(y0 + (tid >> 4)) * W + x0 + (tid & 15)] =
        cand[best * NY + tid];
  } else if (tid < NY + 2 * NC) {
    const int q = tid - NY, p = q & (NC - 1);
    (q < NC ? ru : rv)[off_c + (size_t)((y0 >> 1) + (p >> 3)) * Wc +
                       (x0 >> 1) + (p & 7)] = cand[ITEMS_Y + q];
  } else if (tid < NY + 2 * NC + MODES) {
    const int m = tid - NY - 2 * NC;
    costs[((size_t)frame * gridDim.x + blockIdx.x) * MODES + m] = cost[m];
  }
  int16_t* row = rows + ((size_t)frame * nblk + bid) * ROW;
  for (int k = tid; k < ROW; k += NT) {
    int32_t v;
    if (k >= 6) {
      const int kk = k - 6;
      if (kk < NY) {
        v = qbuf[best * NY + ((kk & 15) << 4) + (kk >> 4)];
      } else {
        const int c = kk - NY, p = c & (NC - 1);
        v = qbuf[ITEMS_Y + (c & NC) + ((p & 7) << 3) + (p >> 3)];
      }
    } else if (k == 0) {
      v = tab[T_MODES + best];
    } else if (k == 1) {
      v = eobs[best];
    } else if (k < 4) {
      v = eobs[MODES + k - 2];
    } else {
      v = 0;
    }
    row[k] = (int16_t)v;
  }
}

}  // namespace

extern "C" int avl_wave_encode(void* rows, void* costs, void* ry, void* ru,
                               void* rv, const void* sy, const void* su,
                               const void* sv, const void* order,
                               const void* pq, const void* tables,
                               int n_tables, int start, int count,
                               int n_frames, int H, int W, float lam,
                               float inv_ln2, void* stream) {
  if (n_tables != T_TOTAL || count <= 0 || n_frames <= 0 || n_frames > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)count, (unsigned)n_frames);
  wave_encode_kernel<<<grid, NT, 0, s>>>(
      static_cast<int16_t*>(rows), static_cast<float*>(costs),
      static_cast<uint8_t*>(ry), static_cast<uint8_t*>(ru),
      static_cast<uint8_t*>(rv), static_cast<const uint8_t*>(sy),
      static_cast<const uint8_t*>(su), static_cast<const uint8_t*>(sv),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(pq),
      static_cast<const int32_t*>(tables), start, H, W, lam, inv_ln2);
  return (int)cudaGetLastError();
}
