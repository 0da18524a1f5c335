/* Native coefficient-block decode fast path.
 *
 * C port of the hot tail of common/coeffs.py:read_coeffs_txb (eob
 * symbols, level map, signs, golomb, dequant) driven by the same
 * od_ec-style range decoder as bitstream/entropy.py.  CDF adaptation
 * updates the caller's numpy arrays in place, so the Python and native
 * paths are interchangeable mid-tile and byte-exact
 * (tests/test_native_coeffs.py).
 */
#include <stdint.h>
#include <string.h>

#define CDF_PROB_TOP 32768
#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4
#define LOTS_OF_BITS 0x4000

typedef struct {
  const uint8_t *data;
  int32_t pos;
  int32_t end;
  uint32_t dif;
  uint32_t rng;
  int32_t cnt;
  int32_t tell_offs;
} avl_dec;

static void dec_refill(avl_dec *d) {
  int s = 32 - 9 - (d->cnt + 15);
  while (s >= 0 && d->pos < d->end) {
    d->dif ^= (uint32_t)d->data[d->pos] << s;
    d->cnt += 8;
    d->pos += 1;
    s -= 8;
  }
  if (d->pos >= d->end) {
    d->tell_offs += LOTS_OF_BITS - d->cnt;
    d->cnt = LOTS_OF_BITS;
  }
}

static int bitlen(uint32_t v) {
  int n = 0;
  while (v) { n++; v >>= 1; }
  return n;
}

static void dec_renorm(avl_dec *d, uint32_t dif, uint32_t rng) {
  int sh = 16 - bitlen(rng);
  d->cnt -= sh;
  d->dif = (uint32_t)(((uint64_t)dif + 1) << sh) - 1;
  d->rng = rng << sh;
  if (d->cnt < 0) dec_refill(d);
}

static int dec_symbol(avl_dec *d, const uint16_t *cdf, int nsymbs) {
  uint32_t dif = d->dif;
  uint32_t r = d->rng;
  int n = nsymbs - 1;
  uint32_t c = dif >> 16;
  uint32_t v = r;
  int ret = -1;
  uint32_t u;
  do {
    u = v;
    ret++;
    v = ((r >> 8) * ((uint32_t)cdf[ret] >> EC_PROB_SHIFT)
         >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (n - ret);
  } while (c < v);
  dec_renorm(d, dif - (v << 16), u - v);
  return ret;
}

static void cdf_update(uint16_t *cdf, int val, int nsymbs) {
  int count = cdf[nsymbs];
  int rate = 4 + (count >> 4) + (nsymbs > 3);
  for (int i = 0; i < nsymbs - 1; i++) {
    int c = cdf[i];
    cdf[i] = (uint16_t)(i < val ? c + ((CDF_PROB_TOP - c) >> rate)
                                : c - (c >> rate));
  }
  cdf[nsymbs] = (uint16_t)(count + (count < 32));
}

static int dec_symbol_adapt(avl_dec *d, uint16_t *cdf, int nsymbs) {
  int ret = dec_symbol(d, cdf, nsymbs);
  cdf_update(cdf, ret, nsymbs);
  return ret;
}

static int dec_bool_q15(avl_dec *d, uint32_t f) {
  uint32_t dif = d->dif;
  uint32_t r = d->rng;
  uint32_t v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
               + EC_MIN_PROB;
  uint32_t vw = v << 16;
  if (dif >= vw) {
    dec_renorm(d, dif - vw, r - v);
    return 0;
  }
  dec_renorm(d, dif, v);
  return 1;
}

static int dec_bit(avl_dec *d) { return dec_bool_q15(d, 16384); }

static int read_golomb(avl_dec *d) {
  int length = 0;
  while (dec_bit(d) == 0) {
    length++;
    if (length >= 32) break;
  }
  length++;
  int x = 1;
  for (int i = 0; i < length - 1; i++) x = (x << 1) | dec_bit(d);
  return x - 1;
}

/* --- coefficient contexts (common/coeffs.py ports) --------------------- */

#define TX_CLASS_2D 0
#define TX_CLASS_HORIZ 1
#define TX_CLASS_VERT 2
#define NUM_BASE_LEVELS 2
#define MAX_BASE_BR_RANGE 15
#define BR_CDF_SIZE 4
#define COEFF_BASE_RANGE 12

static const int EOB_GROUP_START[12] = {0, 1, 2,  3,  5,  9,   17,
                                        33, 65, 129, 257, 513};
static const int EOB_OFFSET_BITS[12] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9};
static const int NZ_CTX_OFFSET_1D0 = 26, NZ_CTX_OFFSET_1D1 = 31,
                 NZ_CTX_OFFSET_1DN = 36;

static int nz_map_ctx_offset(int raw_w, int raw_h, int row, int col) {
  if (raw_w < raw_h && row < 2) return 11;
  if (raw_w > raw_h && col < 2) return 16;
  if (row + col < 2) return 1;
  if (row + col < 4) return 6;
  return 21;
}

#define LMIN(a, b) ((a) < (b) ? (a) : (b))

static int base_ctx(const int32_t *lev, int stride, int pos, int bhl,
                    int raw_w, int raw_h, int tx_class) {
  int col = pos >> bhl;
  int row = pos - (col << bhl);
  const int32_t *a = lev + row * stride + col;
  int mag, ctx;
  if (tx_class == TX_CLASS_2D) {
    if (pos == 0) return 0;
    mag = LMIN(a[stride], 3) + LMIN(a[1], 3) + LMIN(a[stride + 1], 3)
          + LMIN(a[2 * stride], 3) + LMIN(a[2], 3);
    ctx = LMIN((mag + 1) >> 1, 4);
    return ctx + nz_map_ctx_offset(raw_w, raw_h, row, col);
  }
  if (tx_class == TX_CLASS_VERT)
    mag = LMIN(a[stride], 3) + LMIN(a[1], 3) + LMIN(a[2 * stride], 3)
          + LMIN(a[3 * stride], 3) + LMIN(a[4 * stride], 3);
  else
    mag = LMIN(a[stride], 3) + LMIN(a[1], 3) + LMIN(a[2], 3)
          + LMIN(a[3], 3) + LMIN(a[4], 3);
  ctx = LMIN((mag + 1) >> 1, 4);
  int idx = tx_class == TX_CLASS_VERT ? row : col;
  if (idx > 31) idx = 31;
  return ctx + (idx == 0 ? NZ_CTX_OFFSET_1D0
                         : idx == 1 ? NZ_CTX_OFFSET_1D1
                                    : NZ_CTX_OFFSET_1DN);
}

static int base_ctx_eob(int bhl, int width, int si) {
  if (si == 0) return 0;
  if (si <= (width << bhl) >> 3) return 1;
  if (si <= (width << bhl) >> 2) return 2;
  return 3;
}

static int br_ctx(const int32_t *lev, int stride, int pos, int bhl,
                  int tx_class) {
  int col = pos >> bhl;
  int row = pos - (col << bhl);
  const int32_t *a = lev + row * stride + col;
  int mag = a[stride] + a[1];
  if (tx_class == TX_CLASS_2D) {
    mag += a[stride + 1];
    mag = LMIN((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (row < 2 && col < 2) return mag + 7;
  } else if (tx_class == TX_CLASS_HORIZ) {
    mag += a[2];
    mag = LMIN((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (col == 0) return mag + 7;
  } else {
    mag += a[2 * stride];
    mag = LMIN((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (row == 0) return mag + 7;
  }
  return mag + 14;
}

static int br_ctx_eob(int pos, int bhl, int tx_class) {
  int col = pos >> bhl;
  int row = pos - (col << bhl);
  if (pos == 0) return 0;
  if ((tx_class == TX_CLASS_2D && row < 2 && col < 2)
      || (tx_class == TX_CLASS_HORIZ && col == 0)
      || (tx_class == TX_CLASS_VERT && row == 0))
    return 7;
  return 14;
}

/* levels scratch: 36x36 covers the adjusted 32x32 max + 4 pad */
static int32_t g_levels[36 * 36];

/* Returns eob; out_info = {cul_level(with dc sign), dc_val}.  Parses
 * everything after the all_zero flag + tx_type symbol. */
int avl_read_coeffs_txb(
    avl_dec *dec, const int16_t *scan, int tx_class, int bhl, int width,
    int height, int raw_w, int raw_h,
    uint16_t *eob_cdf, int eob_syms,
    uint16_t *eob_extra_base,   /* (9, 3) */
    uint16_t *base_eob_base,    /* (4, 4) */
    uint16_t *base_base,        /* (42, 5) */
    uint16_t *br_base,          /* (21, 5) */
    uint16_t *dc_sign_cdf,      /* (3,) */
    int dqv_dc, int dqv_ac, int shift, int bd, const uint8_t *iqm,
    int32_t *dqcoeff, int32_t *out_info) {
  const int stride = width + 4;
  memset(g_levels, 0, sizeof(int32_t) * (size_t)((height + 4) * stride));

  int eob_pt = dec_symbol_adapt(dec, eob_cdf, eob_syms) + 1;
  int eob_extra = 0;
  int offset_bits = EOB_OFFSET_BITS[eob_pt];
  if (offset_bits > 0) {
    int eob_ctx = eob_pt - 3;
    if (dec_symbol_adapt(dec, eob_extra_base + eob_ctx * 3, 2))
      eob_extra += 1 << (offset_bits - 1);
    for (int i = 1; i < offset_bits; i++)
      if (dec_bit(dec)) eob_extra += 1 << (offset_bits - 1 - i);
  }
  int eob = EOB_GROUP_START[eob_pt] + eob_extra;

  /* last coefficient */
  {
    int pos = scan[eob - 1];
    int ctx = base_ctx_eob(bhl, width, eob - 1);
    int level = dec_symbol_adapt(dec, base_eob_base + ctx * 4, 3) + 1;
    if (level > NUM_BASE_LEVELS) {
      int bctx = br_ctx_eob(pos, bhl, tx_class);
      uint16_t *cdf = br_base + bctx * 5;
      for (int idx = 0; idx < COEFF_BASE_RANGE; idx += BR_CDF_SIZE - 1) {
        int k = dec_symbol_adapt(dec, cdf, BR_CDF_SIZE);
        level += k;
        if (k < BR_CDF_SIZE - 1) break;
      }
    }
    int col = pos >> bhl;
    int row = pos - (col << bhl);
    g_levels[row * stride + col] = level;
  }

  for (int ci = eob - 2; ci >= 0; ci--) {
    int pos = scan[ci];
    int ctx = base_ctx(g_levels, stride, pos, bhl, raw_w, raw_h, tx_class);
    int level = dec_symbol_adapt(dec, base_base + ctx * 5, 4);
    if (level > NUM_BASE_LEVELS) {
      int bctx = br_ctx(g_levels, stride, pos, bhl, tx_class);
      uint16_t *cdf = br_base + bctx * 5;
      for (int idx = 0; idx < COEFF_BASE_RANGE; idx += BR_CDF_SIZE - 1) {
        int k = dec_symbol_adapt(dec, cdf, BR_CDF_SIZE);
        level += k;
        if (k < BR_CDF_SIZE - 1) break;
      }
    }
    int col = pos >> bhl;
    int row = pos - (col << bhl);
    g_levels[row * stride + col] = level;
  }

  /* signs + golomb + dequant (forward scan order) */
  int64_t max_value = ((int64_t)1 << (7 + bd)) - 1;
  int64_t min_value = -((int64_t)1 << (7 + bd));
  int cul = 0;
  int dc_val = 0;
  for (int ci = 0; ci < eob; ci++) {
    int pos = scan[ci];
    int col = pos >> bhl;
    int row = pos - (col << bhl);
    int level = g_levels[row * stride + col];
    if (!level) continue;
    int sign = ci == 0 ? dec_symbol_adapt(dec, dc_sign_cdf, 2)
                       : dec_bit(dec);
    if (level >= MAX_BASE_BR_RANGE) level += read_golomb(dec);
    if (ci == 0) dc_val = sign ? -level : level;
    level &= 0xFFFFF;
    cul += level;
    int64_t dqv = pos == 0 ? dqv_dc : dqv_ac;
    if (iqm) dqv = ((int64_t)iqm[pos] * dqv + 16) >> 5;
    int64_t dq = ((int64_t)level * dqv) & 0xFFFFFF;
    dq >>= shift;
    if (sign) dq = -dq;
    if (dq > max_value) dq = max_value;
    if (dq < min_value) dq = min_value;
    dqcoeff[pos] = (int32_t)dq;
  }
  if (cul > 63) cul = 63;
  if (dc_val < 0)
    cul |= 1 << 6;
  else if (dc_val > 0)
    cul += 2 << 6;
  out_info[0] = cul;
  out_info[1] = dc_val;
  return eob;
}

/* ---- exported primitives for the native lossless tile decoder
 * (lossless_dec.c): init mirrors entropy.py RangeDecoder.__init__ /
 * od_ec_dec_init; tell mirrors od_ec_dec_tell. ---- */

void avl_dec_init(avl_dec *d, const uint8_t *data, int len) {
  d->data = data;
  d->pos = 0;
  d->end = len;
  d->dif = (1u << (32 - 1)) - 1;
  d->rng = 0x8000;
  d->cnt = -15;
  d->tell_offs = 10 - (32 - 8);
  dec_refill(d);
}

int avl_dec_symbol_adapt(avl_dec *d, uint16_t *cdf, int nsymbs) {
  return dec_symbol_adapt(d, cdf, nsymbs);
}

int avl_dec_symbol(avl_dec *d, const uint16_t *cdf, int nsymbs) {
  return dec_symbol(d, cdf, nsymbs);
}

int avl_dec_tell(const avl_dec *d) {
  return d->pos * 8 - d->cnt + d->tell_offs;
}
