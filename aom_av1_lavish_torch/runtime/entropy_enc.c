/* Native tile entropy encoder: range coder + coefficient tokenizer.
 *
 * The TPU analyze path (ops/lossless.py) produces per-txb quantized
 * coefficients in parallel; this module replays the per-tile sequential
 * symbol stream (the only inherently serial stage of AV1 encoding) at
 * native speed.  It mirrors, byte-exactly, the Python reference
 * implementation in bitstream/entropy.py + common/coeffs.py (which are the
 * bit-exactness anchors, themselves validated against the AV1 spec
 * semantics of aom_dsp/entenc.c and av1/encoder/encodetxb.c).
 *
 * Interface: a flat op stream.  Python computes all *contexts that depend
 * on neighbor state* (txb_skip_ctx, dc_sign_ctx, mode contexts) because
 * those never depend on CDF contents; C owns the in-loop coefficient
 * context derivation (base/br ctx from the levels buffer) and CDF
 * adaptation.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define CDF_PROB_TOP 32768
#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4
#define NUM_BASE_LEVELS 2
#define MAX_BASE_BR_RANGE 15
#define BR_CDF_SIZE 4
#define COEFF_BASE_RANGE 12
#define COEFF_CONTEXT_MASK 63

/* ---- range encoder (own formulation; see bitstream/entropy.py) ---- */

typedef struct {
  uint64_t low;
  unsigned rng;
  int cnt;
  uint8_t *buf;
  size_t len, cap;
} RangeEnc;

static void re_init(RangeEnc *e, uint8_t *buf, size_t cap) {
  e->low = 0;
  e->rng = 0x8000;
  e->cnt = -9;
  e->buf = buf;
  e->len = 0;
  e->cap = cap;
}

static void re_carry(RangeEnc *e, long pos) {
  while (pos >= 0) {
    if (++e->buf[pos] != 0) return;
    pos--;
  }
}

static void re_renorm(RangeEnc *e, uint64_t low, unsigned rng) {
  int d = 0;
  unsigned r = rng;
  while (!(r & 0x8000u)) { r <<= 1; d++; }
  int s = e->cnt + d;
  if (s >= 40) {
    int nready = (s >> 3) + 1;
    int c = e->cnt + 24 - (nready << 3);
    uint64_t out = low >> c;
    low &= (((uint64_t)1) << c) - 1;
    uint64_t carry = out >> (nready << 3);
    out &= ((((uint64_t)1) << (nready << 3)) - 1);
    long pos = (long)e->len;
    for (int i = nready - 1; i >= 0; i--)
      e->buf[e->len++] = (uint8_t)(out >> (8 * i));
    if (carry) re_carry(e, pos - 1);
    s = c + d - 24;
  }
  e->low = low << d;
  e->rng = rng << d;
  e->cnt = s;
}

static void re_encode_q15(RangeEnc *e, int fl, int fh, int s, int nsymbs) {
  uint64_t low = e->low;
  unsigned r = e->rng;
  int n = nsymbs - 1;
  if (fl < CDF_PROB_TOP) {
    unsigned u = ((r >> 8) * (unsigned)(fl >> EC_PROB_SHIFT) >>
                  (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (n - (s - 1));
    unsigned v = ((r >> 8) * (unsigned)(fh >> EC_PROB_SHIFT) >>
                  (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (n - s);
    low += r - u;
    r = u - v;
  } else {
    r -= ((r >> 8) * (unsigned)(fh >> EC_PROB_SHIFT) >>
          (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (n - s);
  }
  re_renorm(e, low, r);
}

static void re_encode_bool_q15(RangeEnc *e, int val, int f) {
  uint64_t low = e->low;
  unsigned r = e->rng;
  unsigned v = ((r >> 8) * (unsigned)(f >> EC_PROB_SHIFT) >>
                (7 - EC_PROB_SHIFT)) + EC_MIN_PROB;
  if (val) {
    low += r - v;
    r = v;
  } else {
    r -= v;
  }
  re_renorm(e, low, r);
}

static void re_encode_bit(RangeEnc *e, int bit) {
  re_encode_bool_q15(e, bit, (0x7FFFFF - (128 << 15) + 128) >> 8);
}

static size_t re_done(RangeEnc *e) {
  uint64_t low = e->low;
  int c = e->cnt;
  uint64_t m = 0x3FFF;
  uint64_t end = ((low + m) & ~m) | (m + 1);
  int s = c + 10;
  while (s > 0) {
    unsigned val = (unsigned)((end >> (c + 16)) & 0x1FF);
    long pos = (long)e->len;
    e->buf[e->len++] = (uint8_t)(val & 0xFF);
    if (val & 0x100) re_carry(e, pos - 1);
    end &= ((((uint64_t)1) << (c + 16)) - 1);
    s -= 8;
    c -= 8;
  }
  return e->len;
}

/* ---- CDF adaptation (prob.h:110 semantics; see entropy.py) ---- */

static void update_cdf(uint16_t *cdf, int val, int nsymbs) {
  int count = cdf[nsymbs];
  int rate = 4 + (count >> 4) + (nsymbs > 3);
  for (int i = 0; i < nsymbs - 1; i++) {
    int cv = cdf[i];
    if (i < val)
      cdf[i] = (uint16_t)(cv + ((CDF_PROB_TOP - cv) >> rate));
    else
      cdf[i] = (uint16_t)(cv - (cv >> rate));
  }
  cdf[nsymbs] = (uint16_t)(count + (count < 32));
}

static void enc_symbol(RangeEnc *e, uint16_t *cdf, int s, int nsymbs,
                       int adapt) {
  int fl = s > 0 ? cdf[s - 1] : CDF_PROB_TOP;
  re_encode_q15(e, fl, cdf[s], s, nsymbs);
  if (adapt) update_cdf(cdf, s, nsymbs);
}

static void write_golomb(RangeEnc *e, int level) {
  int x = level + 1;
  int length = 0;
  for (int t = x; t; t >>= 1) length++;
  for (int i = 0; i < length - 1; i++) re_encode_bit(e, 0);
  for (int i = length - 1; i >= 0; i--) re_encode_bit(e, (x >> i) & 1);
}

/* ---- coefficient coding ---- */

static const int16_t EOB_GROUP_START[12] = {0, 1, 2, 3, 5, 9, 17, 33,
                                            65, 129, 257, 513};
static const int8_t EOB_OFFSET_BITS[12] = {0, 0, 0, 1, 2, 3, 4, 5,
                                           6, 7, 8, 9};

/* raw (unadjusted) tx dims drive the rect-asymmetry rule */
static int nz_map_ctx_offset(int raw_w, int raw_h, int row, int col) {
  if (raw_w < raw_h && row < 2) return 11;
  if (raw_w > raw_h && col < 2) return 16;
  if (row + col < 2) return 1;
  if (row + col < 4) return 6;
  return 21;
}

static const int8_t NZ_CTX_OFFSET_1D_FIRST2[2] = {26, 31};
#define NZ_1D(idx) ((idx) < 2 ? NZ_CTX_OFFSET_1D_FIRST2[(idx)] : 36)

#define MIN(a, b) ((a) < (b) ? (a) : (b))

/* levels: (height+4) x (width+4) row-major int16 */
static int base_ctx(const int16_t *lv, int stride, int raw_w, int raw_h,
                    int pos, int bhl, int tx_class) {
  int col = pos >> bhl;
  int row = pos - (col << bhl);
  const int16_t *p = lv + row * stride + col;
  int mag, ctx;
  if (tx_class == 0) {
    if (pos == 0) return 0;
    mag = MIN(p[stride], 3) + MIN(p[1], 3) + MIN(p[stride + 1], 3) +
          MIN(p[2 * stride], 3) + MIN(p[2], 3);
    ctx = MIN((mag + 1) >> 1, 4);
    return ctx + nz_map_ctx_offset(raw_w, raw_h, row, col);
  } else if (tx_class == 2) { /* VERT */
    mag = MIN(p[stride], 3) + MIN(p[1], 3) + MIN(p[2 * stride], 3) +
          MIN(p[3 * stride], 3) + MIN(p[4 * stride], 3);
    ctx = MIN((mag + 1) >> 1, 4);
    return ctx + NZ_1D(row);
  } else { /* HORIZ */
    mag = MIN(p[stride], 3) + MIN(p[1], 3) + MIN(p[2], 3) + MIN(p[3], 3) +
          MIN(p[4], 3);
    ctx = MIN((mag + 1) >> 1, 4);
    return ctx + NZ_1D(col);
  }
}

static int br_ctx(const int16_t *lv, int stride, int pos, int bhl,
                  int tx_class) {
  int col = pos >> bhl;
  int row = pos - (col << bhl);
  const int16_t *p = lv + row * stride + col;
  int mag = p[stride] + p[1];
  if (tx_class == 0) {
    mag += p[stride + 1];
    mag = MIN((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (row < 2 && col < 2) return mag + 7;
  } else if (tx_class == 1) {
    mag += p[2];
    mag = MIN((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (col == 0) return mag + 7;
  } else {
    mag += p[2 * stride];
    mag = MIN((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (row == 0) return mag + 7;
  }
  return mag + 14;
}

static int br_ctx_eob(int pos, int bhl, int tx_class) {
  int col = pos >> bhl;
  int row = pos - (col << bhl);
  if (pos == 0) return 0;
  if ((tx_class == 0 && row < 2 && col < 2) || (tx_class == 1 && col == 0) ||
      (tx_class == 2 && row == 0))
    return 7;
  return 14;
}

/* ---- gathered split-vs-rect binary from the live partition cdf row
 * (av1_common_int.h:1460 partition_gather_*_alike semantics) ---- */

static void enc_gather_split(RangeEnc *e, const uint16_t *cdf, int is_128,
                             int horz_alike, int sym) {
  static const int horz_elems[6] = {1, 3, 4, 5, 6, 8};
  static const int vert_elems[6] = {2, 3, 4, 6, 7, 9};
  const int *elems = horz_alike ? horz_elems : vert_elems;
  int n_elems = is_128 ? 5 : 6;
  int p = CDF_PROB_TOP;
  for (int k = 0; k < n_elems; k++) {
    int el = elems[k];
    int prev = el == 0 ? CDF_PROB_TOP : cdf[el - 1];
    p -= prev - cdf[el];
  }
  uint16_t g[2];
  g[0] = (uint16_t)(CDF_PROB_TOP - p);
  g[1] = 0;
  enc_symbol(e, g, sym, 2, 0);
}

/* ---- one transform block (skip flag + eob + levels + signs).
 * cs: the 8-offset cdfset row (see avl_encode_tile docs).  pend_off >= 0
 * emits that (tx_type) symbol right after a nonzero skip flag.  levels is
 * caller scratch of at least (height+4)*(width+4) int16.  Returns the
 * cul_level entropy-context byte (sum|q| capped + dc-sign code). ---- */

static int code_txb(RangeEnc *e, uint16_t *arena, const int32_t *cs,
                    const int32_t *q, const int16_t *scan,
                    int width, int height, int bhl, int tx_class,
                    int raw_w, int raw_h, int eob_ms,
                    int skip_ctx, int dc_sign_ctx,
                    int pend_off, int pend_nsymbs, int pend_sym,
                    int16_t *levels) {
  int n_coeffs = width * height;
  int eob = 0;
  int abs_sum = 0;
  for (int si = 0; si < n_coeffs; si++) {
    int v = q[scan[si]];
    if (v) {
      eob = si + 1;
      abs_sum += v < 0 ? -v : v;
    }
  }
  int cul = abs_sum < COEFF_CONTEXT_MASK ? abs_sum : COEFF_CONTEXT_MASK;
  if (q[0] < 0) cul |= 1 << 6;
  else if (q[0] > 0) cul += 2 << 6;

  int eob_nsym = eob_ms + 5;
  uint16_t *txb_skip = arena + cs[0] + skip_ctx * 3;
  enc_symbol(e, txb_skip, eob == 0, 2, 1);
  if (eob == 0) return cul;
  if (pend_off >= 0) /* luma tx_type symbol follows the skip flag */
    enc_symbol(e, arena + pend_off, pend_sym, pend_nsymbs, 1);

    int eob_pt = 1;
    for (int t = 1; t < 12; t++) {
      if (EOB_GROUP_START[t] <= eob &&
          (t + 1 >= 12 || eob < EOB_GROUP_START[t + 1])) {
        eob_pt = t;
        break;
      }
    }
    /* eob_flag cdf row: eob_multi_ctx = (tx_class == 2D) ? 0 : 1 */
    enc_symbol(e, arena + cs[1] + (tx_class ? 1 : 0) * (eob_nsym + 1),
               eob_pt - 1, eob_nsym, 1);
    int offset_bits = EOB_OFFSET_BITS[eob_pt];
    int eob_extra = eob - EOB_GROUP_START[eob_pt];
    if (offset_bits > 0) {
      int eob_ctx = eob_pt - 3;
      int bit = (eob_extra >> (offset_bits - 1)) & 1;
      enc_symbol(e, arena + cs[2] + eob_ctx * 3, bit, 2, 1);
      for (int b = 1; b < offset_bits; b++)
        re_encode_bit(e, (eob_extra >> (offset_bits - 1 - b)) & 1);
    }

    int stride = width + 4;
    memset(levels, 0, sizeof(int16_t) * (size_t)((height + 4) * stride));

    /* last coeff */
    {
      int ci = eob - 1;
      int pos = scan[ci];
      int v = q[pos];
      int level = v < 0 ? -v : v;
      if (level > MAX_BASE_BR_RANGE) level = MAX_BASE_BR_RANGE;
      int ctx = (ci == 0) ? 0
                : (ci <= (width << bhl) / 8) ? 1
                : (ci <= (width << bhl) / 4) ? 2 : 3;
      int sym = (level < 3 ? level : 3) - 1;
      enc_symbol(e, arena + cs[3] + ctx * 4, sym, 3, 1);
      if (level > NUM_BASE_LEVELS) {
        int bctx = br_ctx_eob(pos, bhl, tx_class);
        uint16_t *cdf = arena + cs[5] + bctx * 5;
        int rem = level - NUM_BASE_LEVELS - 1;
        for (int idx = 0; idx < COEFF_BASE_RANGE; idx += BR_CDF_SIZE - 1) {
          int k = rem < BR_CDF_SIZE - 1 ? rem : BR_CDF_SIZE - 1;
          enc_symbol(e, cdf, k, BR_CDF_SIZE, 1);
          rem -= k;
          if (k < BR_CDF_SIZE - 1) break;
        }
      }
      int col = pos >> bhl, row = pos - (col << bhl);
      levels[row * stride + col] = (int16_t)level;
    }

    for (int ci = eob - 2; ci >= 0; ci--) {
      int pos = scan[ci];
      int v = q[pos];
      int level = v < 0 ? -v : v;
      if (level > MAX_BASE_BR_RANGE) level = MAX_BASE_BR_RANGE;
      int ctx = base_ctx(levels, stride, raw_w, raw_h, pos, bhl, tx_class);
      enc_symbol(e, arena + cs[4] + ctx * 5, level < 3 ? level : 3, 4, 1);
      if (level > NUM_BASE_LEVELS) {
        int bctx = br_ctx(levels, stride, pos, bhl, tx_class);
        uint16_t *cdf = arena + cs[5] + bctx * 5;
        int rem = level - NUM_BASE_LEVELS - 1;
        for (int idx = 0; idx < COEFF_BASE_RANGE; idx += BR_CDF_SIZE - 1) {
          int k = rem < BR_CDF_SIZE - 1 ? rem : BR_CDF_SIZE - 1;
          enc_symbol(e, cdf, k, BR_CDF_SIZE, 1);
          rem -= k;
          if (k < BR_CDF_SIZE - 1) break;
        }
      }
      int col = pos >> bhl, row = pos - (col << bhl);
      levels[row * stride + col] = (int16_t)level;
    }

    /* signs + golomb */
    for (int ci = 0; ci < eob; ci++) {
      int pos = scan[ci];
      int v = q[pos];
      if (!v) continue;
      int level = v < 0 ? -v : v;
      int sign = v < 0;
      if (ci == 0)
        enc_symbol(e, arena + cs[6] + dc_sign_ctx * 3, sign, 2, 1);
      else
        re_encode_bit(e, sign);
      if (level >= MAX_BASE_BR_RANGE)
        write_golomb(e, level - MAX_BASE_BR_RANGE);
    }
  return cul;
}

/* ---- op stream ----
 * ops: int32 rows of 8:
 *  kind 0 SYMBOL:  [0, cdf_off, nsymbs, symbol, adapt, 0, 0, 0]
 *  kind 1 BIT:     [1, bit, 0, ...]
 *  kind 2 TXB:     [2, qcoeff_off, geom: (w<<20|h<<8|bhl<<4|txclass),
 *                   skip_ctx, dc_sign_ctx, cdfset_idx, scan_off, eob_ms]
 *  kind 3 GATHER_SPLIT: [3, cdf_off, is_128, horz_alike, sym, 0, 0, 0]
 *  kind 4 PENDING: [4, cdf_off, nsymbs, sym, 1, 0, 0, 0]
 * cdfset: int32 rows of 8 per (plane_type x txs_ctx) combination:
 *  [txb_skip_base, eob_flag_base, eob_extra_base, coeff_base_eob_base,
 *   coeff_base_base, coeff_br_base, dc_sign_base, 0]
 * Each *_base points at the start of that context family's rows for the
 * relevant plane_type/txs_ctx; C indexes rows by its computed ctx.
 */

#ifndef AVL_NO_TILE_ENTRY
int avl_encode_tile(const int32_t *ops, int n_ops, uint16_t *arena,
                    const int32_t *cdfsets, const int32_t *qcoeff,
                    const int16_t *scans, uint8_t *out, int out_cap) {
  RangeEnc e;
  re_init(&e, out, (size_t)out_cap);
  int16_t levels[(64 + 4) * (64 + 4)];
  /* pending symbol (tx_type): emitted inside the next TXB op iff eob>0 */
  int pend_off = -1, pend_nsymbs = 0, pend_sym = 0;
  for (int i = 0; i < n_ops; i++) {
    const int32_t *op = ops + 8 * i;
    if (op[0] == 0) {
      enc_symbol(&e, arena + op[1], op[3], op[2], op[4]);
      continue;
    }
    if (op[0] == 1) {
      re_encode_bit(&e, op[1]);
      continue;
    }
    if (op[0] == 4) { /* pending symbol for the following TXB */
      pend_off = op[1];
      pend_nsymbs = op[2];
      pend_sym = op[3];
      continue;
    }
    if (op[0] == 3) {
      enc_gather_split(&e, arena + op[1], op[2], op[3], op[4]);
      continue;
    }
    /* TXB */
    int geom = op[2];
    code_txb(&e, arena, cdfsets + 8 * op[5], qcoeff + op[1],
             scans + op[6], (geom >> 20) & 0xFFF, (geom >> 8) & 0xFFF,
             (geom >> 4) & 0xF, geom & 0xF, (op[7] >> 8) & 0xFFF,
             (op[7] >> 20) & 0xFFF, op[7] & 0xFF, op[3], op[4],
             pend_off, pend_nsymbs, pend_sym, levels);
    pend_off = -1;
  }
  return (int)re_done(&e);
}
#endif /* AVL_NO_TILE_ENTRY */
