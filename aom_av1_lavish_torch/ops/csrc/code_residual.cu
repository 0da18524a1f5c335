// K4, fused entry for the P frames: one launch codes one plane's batch of
// square DCT_DCT blocks (n 8, 16, 32 or 64) from residual to recon.
//
// Replaces, at the P frame's shapes, aom_av1_lavish_tpu/ops/pallas_kernels.py
// _quant_kernel (inline twin wavefront._quantize_jnp) together with its
// producer and its consumers in aom_av1_lavish_tpu/ops/inter_tpu.py
// (_p_frame_core :445-473 and _eval_merge_level :703-737): the residual, the
// forward 2-D DCT (tx64 keeps its 32x32 corner), aom_quantize_b with the log
// scale of tx 32 and 64, the trellis-lite tail dropout (_rd_dropout), the
// bit estimate and eob in scan order (wavefront._est_bits), dequantize, the
// exact inverse, add and clamp, and the eob select.  A P frame calls it nine
// times: y, u, v at each of the levels 16, 32 and 64.
//
// What bounds it.  A block moves its source and prediction in and its recon,
// levels, eob and bits out (about 10 bytes a pixel with an int32 source),
// and does about 100 integer operations a pixel, most in its four 1-D
// passes: at 1080p's luma level 16 (8160 blocks) 21 MB and 2e8 operations,
// so the bytes bound it, at about 6 us.  The torch ops it replaces (about
// 600 launches a call) were bound by launches.  The design keeps a block in
// shared memory from residual to recon:
//   * a CTA codes BPC blocks (16 at n 8, 4 at n 16, 1 at n 32 and 64) with
//     NT threads (512; 1024 at n 64) spread over their positions; two int32
//     ping-pong buffers of BPC x n x n (32 KB at n 64) hold the transform;
//   * the transforms are the port's own stage tables (common/txfm1d.py
//     fdct_stages / idct_stages at the cos bits of common/txfm2d.py, handed
//     over by ops/kernels.py residual_tables(), which also gives each size's
//     offsets, shifts and stage counts) run by the interpreter of ops/txfm.py
//     _run_stages, one stage between two barriers: butterfly products in 64
//     bits, add/sub in 32, the inverse's clamps at 16 bits (bd 8).  At n 64
//     the forward row pass runs only the 32 rows the corner keeps, and the
//     inverse row pass only the 32 rows that hold coefficients (the others
//     are zero in and out);
//   * the quantizer's products wrap in 32 bits as in quantize_b.cu;
//   * dropout, bits and eob of a block are one warp's: it walks the scan 32
//     positions at a time, and a ballot ranks the nonzero levels, so the
//     sequential part runs over the nonzero levels only.
//
// Float decisions keep float32 and a fixed order.  Every float operation is
// an explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn),
// which the compiler never contracts into a fused multiply-add (the file is
// also built with -fmad=false), and log2 is logf(x) * INV_LN2.  Each nonzero
// level's terms are elementwise, in the order of ops/kernels.py
// rd_dropout_plain: lvl = 1.7 + 2 * log2(|q| + 1); save = (1 + lvl) + 0.55 *
// gap; net = K * dq * dq - lam * save.  The dropout's suffix sums are taken
// sequentially from the last nonzero level in scan order back to the first
// (the zero positions between them add 0, which changes no sum); the cut
// is at the first minimum, as argmin takes it, when that minimum is below
// 0.  The level-bits sum of the kept levels is taken by the warp: lane L
// adds the terms of kept levels L, L + 32, ... in scan order, then the 32
// partial sums are combined by a butterfly over lane distances 16, 8, 4, 2,
// 1.  The orders are the same on every run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K_ADDSUB = 1, K_BTF = 2;
constexpr int INV_COS_BIT = 12;
// A size's parameter row in the table (ops/kernels.py RESIDUAL_PARAM_FIELDS):
// row s (n = 8 << s) starts at s * PAR.
constexpr int PAR = 16;
enum {
  P_FCOL, P_FROW, P_INV, P_SCAN,  // offsets of the stage tables and scan
  P_CBCOL, P_CBROW,               // forward cos bits
  P_F0, P_F1, P_F2,               // forward shifts
  P_I0, P_I1,                     // inverse shifts
  P_STF, P_STI,                   // stages of the forward and inverse
  P_LOG,                          // the quantizer's log scale
  P_NCOEF                         // coefficients kept a block
};

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

template <int N> struct Cfg;
template <> struct Cfg<8> { static constexpr int BPC = 16, NT = 512; };
template <> struct Cfg<16> { static constexpr int BPC = 4, NT = 512; };
template <> struct Cfg<32> { static constexpr int BPC = 1, NT = 512; };
template <> struct Cfg<64> { static constexpr int BPC = 1, NT = 1024; };

// One 1-D pass over the CTA's blocks (ops/txfm.py _run_stages): along the
// rows (the elements of a line are neighbours) or along the columns.  A
// block keeps position p = r * N + c; a thread computes position p of a
// block in both cases, so neighbouring threads write neighbouring words.
// `lines`: rows computed by a pass along the rows (N, or 32 at N 64 with
// one block a CTA).  `post` is the round shift that follows the pass and
// `clamp_out` the 16-bit clamp the inverse applies between its passes.
template <int N>
__device__ void txfm_pass(int32_t*& cur, int32_t*& alt,
                          const int32_t* __restrict__ tab, int stages,
                          int cos_bit, bool along_rows, bool inverse,
                          int post, bool clamp_out, int lines) {
  constexpr int BPC = Cfg<N>::BPC, NT = Cfg<N>::NT, NN = N * N;
  const int per_blk = along_rows ? lines * N : NN;
  const int items = BPC * per_blk;
  for (int s = 0; s < stages; ++s) {
    for (int item = threadIdx.x; item < items; item += NT) {
      const int blk = BPC == 1 ? 0 : item / NN;   // lines == N when BPC > 1
      const int p = item - blk * per_blk;
      const int hi = p / N, lo = p % N;
      const int i = along_rows ? lo : hi;
      const int base = blk * NN + (along_rows ? hi * N : lo);
      const int es = along_rows ? 1 : N;
      const int32_t* e = tab + (s * N + i) * 5;
      const int kind = __ldg(e);
      const int32_t a = cur[base + __ldg(e + 1) * es];
      const int32_t b = cur[base + __ldg(e + 2) * es];
      const int32_t w0 = __ldg(e + 3), w1 = __ldg(e + 4);
      int32_t v;
      if (kind == K_BTF) {
        v = (int32_t)(((int64_t)a * w0 + (int64_t)b * w1 +
                       ((int64_t)1 << (cos_bit - 1))) >> cos_bit);
      } else if (kind == K_ADDSUB) {
        v = mul_wrap(a, w0) + mul_wrap(b, w1);
        if (inverse) v = clamp16(v);
      } else {
        v = mul_wrap(a, w0);
      }
      if (s == stages - 1) {
        v = round_shift(v, post);
        if (clamp_out) v = clamp16(v);
      }
      alt[blk * NN + p] = v;
    }
    __syncthreads();
    int32_t* t = cur;
    cur = alt;
    alt = t;
  }
}

template <int N>
__global__ void __launch_bounds__(Cfg<N>::NT)
code_residual_kernel(int32_t* __restrict__ q_out,
                     long long* __restrict__ eob_out,
                     uint8_t* __restrict__ rec_out,
                     float* __restrict__ bits_out, const void* __restrict__ src,
                     int src_u8, const uint8_t* __restrict__ pred,
                     const int32_t* __restrict__ pq,
                     const float* __restrict__ lam,
                     const int32_t* __restrict__ tab, int B, int per_frame,
                     float k_sse, float inv_ln2, int dropout) {
  constexpr int BPC = Cfg<N>::BPC, NT = Cfg<N>::NT, NN = N * N;
  constexpr int NS = N < 32 ? N : 32;       // side of the kept coefficients
  constexpr int NC = NS * NS;
  constexpr int SZ = N == 8 ? 0 : N == 16 ? 1 : N == 32 ? 2 : 3;
  static_assert(BPC <= NT / 32, "a warp a block for the rate estimate");
  __shared__ int32_t buf0[BPC * NN], buf1[BPC * NN];
  __shared__ float l_net[BPC * NC], l_lvl[BPC * NC];  // by nonzero rank
  __shared__ int16_t l_j[BPC * NC];                   // its scan index
  __shared__ int32_t par[PAR];
  __shared__ int32_t sq[BPC][10];   // each block's [field][dc, ac]
  __shared__ int s_eob[BPC];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * BPC;
  const int nb = min(BPC, B - b0);

  if (tid < PAR) par[tid] = tab[SZ * PAR + tid];
  __syncthreads();
  const int ls = par[P_LOG];
  // quantizer of each block's frame; zbin and round at the log scale
  if (tid < BPC * 10) {
    const int bl = tid / 10, k = tid % 10;
    int32_t v = 0;
    if (bl < nb) {
      v = pq[(size_t)((b0 + bl) / per_frame) * 10 + k];
      if (k < 4 && ls) v = (v + (1 << ls >> 1)) >> ls;
    }
    sq[bl][k] = v;
  }
  // the residual, shifted for the column pass
  const int f0 = par[P_F0];
  for (int item = tid; item < BPC * NN; item += NT) {
    const int bl = item / NN;
    int32_t v = 0;
    if (bl < nb) {
      const size_t g = (size_t)b0 * NN + item;
      const int32_t s = src_u8 ? (int32_t)((const uint8_t*)src)[g]
                               : ((const int32_t*)src)[g];
      v = round_shift(s - (int32_t)pred[g], -f0);
    }
    buf0[item] = v;
  }
  __syncthreads();

  int32_t* cur = buf0;
  int32_t* alt = buf1;
  // forward: columns, round shift, rows, round shift
  txfm_pass<N>(cur, alt, tab + par[P_FCOL], par[P_STF], par[P_CBCOL], false,
               false, -par[P_F1], false, N);
  txfm_pass<N>(cur, alt, tab + par[P_FROW], par[P_STF], par[P_CBROW], true,
               false, -par[P_F2], false, NS);

  // aom_quantize_b: levels into alt, dequantized values into cur; outside
  // the kept corner both are 0.  Position r * N + c holds the coefficient
  // whose raster index is c * NS + r (the forward transform's output
  // before its final transpose, which is where the inverse reads it).
  for (int item = tid; item < BPC * NN; item += NT) {
    const int bl = item / NN, p = item % NN;
    const int r = p / N, c = p % N;
    int32_t q = 0, dq = 0;
    if (r < NS && c < NS) {
      const int32_t* q5 = sq[bl] + (p == 0 ? 0 : 1);
      const int32_t co = cur[item];
      const int32_t ac = co < 0 ? (int32_t)(0u - (uint32_t)co) : co;
      const int32_t sign = co < 0 ? -1 : 1;
      int32_t tmp = (int32_t)((uint32_t)ac + (uint32_t)q5[2]);
      tmp = clamp16(tmp);
      int32_t t = (mul_wrap(tmp, q5[4]) >> 16) + tmp;
      t = mul_wrap(t, q5[6]) >> (16 - ls);
      t = ac >= q5[0] ? t : 0;
      q = mul_wrap(sign, t);
      dq = mul_wrap(sign, mul_wrap(t, q5[8]) >> ls);
    }
    alt[item] = q;
    cur[item] = dq;
  }
  __syncthreads();

  // tail dropout, bit estimate and eob: one warp a block, in the order
  // stated at the top
  if (warp < nb) {
    const int bl = warp;
    int32_t* qb = alt + bl * NN;
    int32_t* dqb = cur + bl * NN;
    float* lnet = l_net + bl * NC;
    float* llvl = l_lvl + bl * NC;
    int16_t* lj = l_j + bl * NC;
    const int32_t* scan = tab + par[P_SCAN];
    const float lm = lam[b0 + bl];
    int count = 0, prev = -1;
    for (int j0 = 0; j0 < NC; j0 += 32) {
      const int j = j0 + lane;
      const int pos = __ldg(scan + j);
      const int32_t v = qb[pos];
      const unsigned m = __ballot_sync(0xffffffffu, v != 0);
      if (v != 0) {
        const unsigned below = m & ((1u << lane) - 1u);
        const int pj = below ? j0 + 31 - __clz(below) : prev;
        const int32_t av = v < 0 ? (int32_t)(0u - (uint32_t)v) : v;
        const float l2 =
            __fmul_rn(logf(__fadd_rn((float)av, 1.0f)), inv_ln2);
        const float lvl = __fadd_rn(1.7f, __fmul_rn(2.0f, l2));
        const float ds = (float)dqb[pos];
        const float cost = __fmul_rn(__fmul_rn(k_sse, ds), ds);
        const float save = __fadd_rn(__fadd_rn(1.0f, lvl),
                                     __fmul_rn(0.55f, (float)(j - pj - 1)));
        const int rank = count + __popc(below);
        lnet[rank] = __fsub_rn(cost, __fmul_rn(lm, save));
        llvl[rank] = lvl;
        lj[rank] = (int16_t)j;
      }
      count += __popc(m);
      if (m) prev = j0 + 31 - __clz(m);
    }
    __syncwarp();
    int keep = count;
    if (dropout && lane == 0) {
      // S_k, the suffix sum from nonzero level k, is also the suffix at
      // every zero position before it back to level k - 1; so the first
      // minimum over all positions, where it is below 0, cuts before the
      // lowest k of the least S_k (`<=` while walking down keeps it)
      float s = 0.0f, best = 0.0f;
      int at = count;
      for (int k = count - 1; k >= 0; --k) {
        s = __fadd_rn(s, lnet[k]);
        if (s <= best) {
          best = s;
          at = k;
        }
      }
      keep = best < 0.0f ? at : count;
    }
    keep = __shfl_sync(0xffffffffu, keep, 0);
    for (int k = keep + lane; k < count; k += 32) {
      const int pos = __ldg(scan + lj[k]);
      qb[pos] = 0;
      dqb[pos] = 0;
    }
    float lb = 0.0f;
    for (int k = lane; k < keep; k += 32) lb = __fadd_rn(lb, llvl[k]);
    for (int d = 16; d > 0; d >>= 1)
      lb = __fadd_rn(lb, __shfl_xor_sync(0xffffffffu, lb, d));
    if (lane == 0) {
      const int eob = keep ? lj[keep - 1] + 1 : 0;
      const float l2 =
          __fmul_rn(logf(__fadd_rn((float)eob, 1.0f)), inv_ln2);
      float bits = __fadd_rn(2.0f, __fmul_rn(0.9f, l2));
      bits = __fadd_rn(bits, __fmul_rn(0.55f, (float)(eob - keep)));
      bits = __fadd_rn(bits, lb);
      bits_out[b0 + bl] = eob == 0 ? 0.6f : bits;
      eob_out[b0 + bl] = eob;
      s_eob[bl] = eob;
    }
  }
  __syncthreads();

  // the levels out in raster order; the inverse's input clamped to 16 bits
  for (int item = tid; item < BPC * NC; item += NT) {
    const int bl = item / NC, f = item % NC;
    if (bl < nb)
      q_out[(size_t)(b0 + bl) * NC + f] = alt[bl * NN + (f % NS) * N + f / NS];
  }
  for (int item = tid; item < BPC * NN; item += NT)
    cur[item] = clamp16(cur[item]);
  __syncthreads();

  // inverse: rows, round shift, clamp, columns, round shift (at N 64 the
  // rows past the corner are zero in both buffers and stay so)
  txfm_pass<N>(cur, alt, tab + par[P_INV], par[P_STI], INV_COS_BIT, true,
               true, -par[P_I0], true, NS);
  txfm_pass<N>(cur, alt, tab + par[P_INV], par[P_STI], INV_COS_BIT, false,
               true, -par[P_I1], false, N);

  // recon; a block without levels keeps its prediction
  for (int item = tid; item < BPC * NN; item += NT) {
    const int bl = item / NN;
    if (bl < nb) {
      const size_t g = (size_t)b0 * NN + item;
      const int32_t pv = pred[g];
      rec_out[g] = s_eob[bl] > 0 ? (uint8_t)min(max(pv + cur[item], 0), 255)
                                 : (uint8_t)pv;
    }
  }
}

template <int N>
int launch(void* q, void* eob, void* rec, void* bits, const void* src,
           int src_u8, const void* pred, const void* pq, const void* lam,
           const void* tables, int B, int per_frame, float k_sse,
           float inv_ln2, int dropout, cudaStream_t s) {
  const int grid = (B + Cfg<N>::BPC - 1) / Cfg<N>::BPC;
  code_residual_kernel<N><<<grid, Cfg<N>::NT, 0, s>>>(
      static_cast<int32_t*>(q), static_cast<long long*>(eob),
      static_cast<uint8_t*>(rec), static_cast<float*>(bits), src, src_u8,
      static_cast<const uint8_t*>(pred), static_cast<const int32_t*>(pq),
      static_cast<const float*>(lam), static_cast<const int32_t*>(tables), B,
      per_frame, k_sse, inv_ln2, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int avl_code_residual(void* q, void* eob, void* rec, void* bits,
                                 const void* src, int src_u8,
                                 const void* pred, const void* pq,
                                 const void* lam, const void* tables,
                                 int n_tables, int n, int B, int per_frame,
                                 float k_sse, float inv_ln2, int dropout,
                                 void* stream) {
  if (B <= 0 || per_frame <= 0 || B % per_frame != 0 || n_tables < 4 * PAR)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8:
      return launch<8>(q, eob, rec, bits, src, src_u8, pred, pq, lam, tables,
                       B, per_frame, k_sse, inv_ln2, dropout, s);
    case 16:
      return launch<16>(q, eob, rec, bits, src, src_u8, pred, pq, lam,
                        tables, B, per_frame, k_sse, inv_ln2, dropout, s);
    case 32:
      return launch<32>(q, eob, rec, bits, src, src_u8, pred, pq, lam,
                        tables, B, per_frame, k_sse, inv_ln2, dropout, s);
    case 64:
      return launch<64>(q, eob, rec, bits, src, src_u8, pred, pq, lam,
                        tables, B, per_frame, k_sse, inv_ln2, dropout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
