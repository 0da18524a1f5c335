/* Native inverse 2D transform + add.
 *
 * C engine for common/txfm2d.py:inv_txfm2d_add driven by the SAME
 * op tables (stage lists of {kind,i0,i1,w0,w1}) that the Python
 * reference builds in common/txfm1d.py — Python flattens them once and
 * passes pointers, so both paths share one butterfly definition and
 * stay byte-exact (tests/test_native_coeffs.py).
 */
#include <stdint.h>
#include <string.h>

#define XK_COPY 0
#define XK_ADDSUB 1
#define XK_BTF 2

#define NEW_SQRT2_BITS 12
#define NEW_SQRT2 5793
#define NEW_INV_SQRT2 2896
#define INV_COS_BIT 12

/* sinpi_arr(12) (av1_txfm.h sinpi values at 12-bit precision) */
static const int64_t SINPI12[5] = {0, 1321, 2482, 3344, 3803};

static inline int64_t round2(int64_t x, int bits) {
  return (x + ((int64_t)1 << (bits - 1))) >> bits;
}

static inline int64_t clampb(int64_t x, int bits) {
  int64_t lo = -((int64_t)1 << (bits - 1));
  int64_t hi = ((int64_t)1 << (bits - 1)) - 1;
  return x < lo ? lo : x > hi ? hi : x;
}

/* table layout: [n_stages, count_0..count_{ns-1}, ops(5 each)];
 * range_bits >= 63 disables the ADDSUB clamp (forward path) */
static void run_stages_1d(int64_t *buf, int n, const int32_t *table,
                          int range_bits, int cos_bit) {
  int64_t out[64];
  int ns = table[0];
  const int32_t *op = table + 1 + ns;
  for (int s = 0; s < ns; s++) {
    int cnt = table[1 + s];
    for (int i = 0; i < cnt; i++, op += 5) {
      int kind = op[0];
      int64_t v;
      if (kind == XK_COPY)
        v = (int64_t)op[3] * buf[op[1]];
      else if (kind == XK_ADDSUB) {
        v = (int64_t)op[3] * buf[op[1]] + (int64_t)op[4] * buf[op[2]];
        if (range_bits < 63) v = clampb(v, range_bits);
      } else
        v = round2((int64_t)op[3] * buf[op[1]]
                   + (int64_t)op[4] * buf[op[2]], cos_bit);
      out[i] = v;
    }
    memcpy(buf, out, sizeof(int64_t) * (size_t)n);
  }
}

/* sinpi_arr(13) for the forward ADST4 */
static const int64_t SINPI13[5] = {0, 2642, 4964, 6689, 7606};

static void fadst4_1d(int64_t *x, int cos_bit) {
  const int64_t *sp = cos_bit == 13 ? SINPI13 : SINPI12;
  int64_t x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  int64_t s0 = sp[1] * x0, s1 = sp[4] * x0, s2 = sp[2] * x1;
  int64_t s3 = sp[1] * x1, s4 = sp[3] * x2, s5 = sp[4] * x3;
  int64_t s6 = sp[2] * x3;
  int64_t s7 = (x0 + x1) - x3;
  int64_t t0 = s0 + s2;
  int64_t t1 = sp[3] * s7;
  int64_t t2 = s1 - s3;
  int64_t t3 = s4;
  t0 = t0 + s5;
  t2 = t2 + s6;
  x[0] = round2(t0 + t3, cos_bit);
  x[1] = round2(t1, cos_bit);
  x[2] = round2(t2 - t3, cos_bit);
  x[3] = round2((t2 - t0) + t3, cos_bit);
}

static void iadst4_1d(int64_t *x) {
  int64_t x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  int64_t s0 = SINPI12[1] * x0;
  int64_t s1 = SINPI12[2] * x0;
  int64_t s2 = SINPI12[3] * x1;
  int64_t s3 = SINPI12[4] * x2;
  int64_t s4 = SINPI12[1] * x2;
  int64_t s5 = SINPI12[2] * x3;
  int64_t s6 = SINPI12[4] * x3;
  int64_t s7 = (x0 - x2) + x3;
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = SINPI12[3] * s7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  x[0] = round2(s0 + s3, INV_COS_BIT);
  x[1] = round2(s1 + s3, INV_COS_BIT);
  x[2] = round2(s2, INV_COS_BIT);
  x[3] = round2((s0 + s1) - s3, INV_COS_BIT);
}

static void iidentity_1d(int64_t *x, int n) {
  if (n == 4)
    for (int i = 0; i < 4; i++)
      x[i] = round2(NEW_SQRT2 * x[i], NEW_SQRT2_BITS);
  else if (n == 8)
    for (int i = 0; i < 8; i++) x[i] *= 2;
  else if (n == 16)
    for (int i = 0; i < 16; i++)
      x[i] = round2(NEW_SQRT2 * 2 * x[i], NEW_SQRT2_BITS);
  else
    for (int i = 0; i < 32; i++) x[i] *= 4;
}

/* kind: 0 = op-table (DCT/ADST>=8), 2 = iadst4, 3 = identity,
 *       4 = fadst4 (forward) */
static void txfm_1d(int64_t *buf, int n, int kind, const int32_t *table,
                    int range_bits, int cos_bit) {
  if (kind == 2)
    iadst4_1d(buf);
  else if (kind == 3)
    iidentity_1d(buf, n);
  else if (kind == 4)
    fadst4_1d(buf, cos_bit);
  else
    run_stages_1d(buf, n, table, range_bits, cos_bit);
}

static int64_t g_x[64 * 64];
static int64_t g_t[64 * 64];

int avl_inv_txfm2d_add(const int32_t *coeff, uint8_t *dst8,
                       uint16_t *dst16, int w, int h, int aw, int ah,
                       int kind_row, int kind_col,
                       const int32_t *row_table, const int32_t *col_table,
                       int flip_lr, int flip_ud, int rect1, int sh0,
                       int sh1, int range_row, int range_col, int bd) {
  /* x[r*w + c] = visible coeff (col-major input) else 0 */
  for (int r = 0; r < h; r++)
    for (int col = 0; col < w; col++)
      g_x[r * w + col] = (col < aw && r < ah) ? coeff[col * ah + r] : 0;
  if (rect1)
    for (int i = 0; i < w * h; i++)
      g_x[i] = round2(g_x[i] * NEW_INV_SQRT2, NEW_SQRT2_BITS);
  for (int i = 0; i < w * h; i++) g_x[i] = clampb(g_x[i], bd + 8);

  /* rows */
  for (int r = 0; r < h; r++)
    txfm_1d(g_x + r * w, w, kind_row, row_table, range_row,
            INV_COS_BIT);
  if (sh0 > 0)
    for (int i = 0; i < w * h; i++) g_x[i] = round2(g_x[i], sh0);
  if (flip_lr)
    for (int r = 0; r < h; r++)
      for (int col = 0; col < w / 2; col++) {
        int64_t t = g_x[r * w + col];
        g_x[r * w + col] = g_x[r * w + (w - 1 - col)];
        g_x[r * w + (w - 1 - col)] = t;
      }

  /* columns: transpose into g_t rows, clamp, transform */
  int clamp2 = bd + 6 > 16 ? bd + 6 : 16;
  for (int col = 0; col < w; col++)
    for (int r = 0; r < h; r++)
      g_t[col * h + r] = clampb(g_x[r * w + col], clamp2);
  for (int col = 0; col < w; col++)
    txfm_1d(g_t + col * h, h, kind_col, col_table, range_col,
            INV_COS_BIT);
  if (sh1 > 0)
    for (int i = 0; i < w * h; i++) g_t[i] = round2(g_t[i], sh1);

  /* add + clamp into dst (natural layout), honoring ud flip */
  int64_t maxv = ((int64_t)1 << bd) - 1;
  for (int r = 0; r < h; r++) {
    int sr = flip_ud ? h - 1 - r : r;
    for (int col = 0; col < w; col++) {
      int64_t res = g_t[col * h + sr];
      int64_t v = (dst8 ? (int64_t)dst8[r * w + col]
                        : (int64_t)dst16[r * w + col]) + res;
      if (v < 0) v = 0;
      if (v > maxv) v = maxv;
      if (dst8)
        dst8[r * w + col] = (uint8_t)v;
      else
        dst16[r * w + col] = (uint16_t)v;
    }
  }
  return 0;
}

/* forward 2D transform (common/txfm2d.py:fwd_txfm2d port).
 * resid: (h, w) int32 natural layout; out: adjusted col-major flat. */
int avl_fwd_txfm2d(const int32_t *resid, int32_t *out, int w, int h,
                   int aw, int ah, int kind_col, int kind_row,
                   const int32_t *col_table, const int32_t *row_table,
                   int cb_col, int cb_row, int flip_ud, int flip_lr,
                   int s0, int s1, int s2, int rect1) {
  /* columns operate on x.T rows: g_t[c*h + r] = resid[srcr][c] << s0 */
  for (int c2 = 0; c2 < w; c2++)
    for (int r = 0; r < h; r++) {
      int sr = flip_ud ? h - 1 - r : r;
      int64_t v = resid[sr * w + c2];
      g_t[c2 * h + r] = s0 ? v << s0 : v;
    }
  for (int c2 = 0; c2 < w; c2++)
    txfm_1d(g_t + c2 * h, h, kind_col, col_table, 64, cb_col);
  if (s1)
    for (int i = 0; i < w * h; i++) g_t[i] = round2(g_t[i], s1);
  /* buf = cols.T (h, w) with optional lr flip */
  for (int r = 0; r < h; r++)
    for (int c2 = 0; c2 < w; c2++) {
      int sc = flip_lr ? w - 1 - c2 : c2;
      g_x[r * w + c2] = g_t[sc * h + r];
    }
  for (int r = 0; r < h; r++)
    txfm_1d(g_x + r * w, w, kind_row, row_table, 64, cb_row);
  if (s2)
    for (int i = 0; i < w * h; i++) g_x[i] = round2(g_x[i], s2);
  if (rect1)
    for (int i = 0; i < w * h; i++)
      g_x[i] = round2(g_x[i] * NEW_SQRT2, NEW_SQRT2_BITS);
  /* out[c*ah + r] = rows[r][c] over the visible aw x ah */
  for (int c2 = 0; c2 < aw; c2++)
    for (int r = 0; r < ah; r++)
      out[c2 * ah + r] = (int32_t)g_x[r * w + c2];
  return 0;
}

/* aom_quantize_b_helper_c port (common/quant.py:quantize_b). */
int avl_quantize_b(const int32_t *coeff, const int16_t *scan, int n,
                   int zbin0, int zbin1, int rnd0, int rnd1, int q0,
                   int q1, int qs0, int qs1, int deq0, int deq1,
                   int log_scale, const uint8_t *qm, const uint8_t *iqm,
                   int32_t *qcoeff, int32_t *dqcoeff) {
  int zbins[2] = {log_scale ? (zbin0 + (1 << log_scale >> 1)) >> log_scale
                            : zbin0,
                  log_scale ? (zbin1 + (1 << log_scale >> 1)) >> log_scale
                            : zbin1};
  int rounds[2] = {rnd0, rnd1};
  int quants[2] = {q0, q1};
  int qshift[2] = {qs0, qs1};
  int deqs[2] = {deq0, deq1};
  memset(qcoeff, 0, sizeof(int32_t) * (size_t)n);
  memset(dqcoeff, 0, sizeof(int32_t) * (size_t)n);
  int non_zero_count = n;
  for (int si = n - 1; si >= 0; si--) {
    int rc = scan[si];
    int wt = qm ? qm[rc] : 32;
    int64_t v = (int64_t)coeff[rc] * wt;
    int64_t z = (int64_t)zbins[rc != 0] << 5;
    if (v > -z && v < z)
      non_zero_count--;
    else
      break;
  }
  int eob = -1;
  for (int si = 0; si < non_zero_count; si++) {
    int rc = scan[si];
    int v = coeff[rc];
    int64_t abs_v = v < 0 ? -(int64_t)v : v;
    int wt = qm ? qm[rc] : 32;
    if (abs_v * wt >= ((int64_t)zbins[rc != 0] << 5)) {
      int rnd = log_scale
                    ? (rounds[rc != 0] + (1 << log_scale >> 1)) >> log_scale
                    : rounds[rc != 0];
      int64_t tmp = abs_v + rnd;
      if (tmp > 32767) tmp = 32767;
      if (tmp < -32768) tmp = -32768;
      int64_t tmp32;
      if (qm) {
        tmp *= wt;
        tmp32 = ((((tmp * quants[rc != 0]) >> 16) + tmp)
                 * qshift[rc != 0]) >> (16 - log_scale + 5);
      } else {
        /* flat-matrix form (quant.py:quantize_b without qm) */
        tmp32 = ((((tmp * quants[rc != 0]) >> 16) + tmp)
                 * qshift[rc != 0]) >> (16 - log_scale);
      }
      qcoeff[rc] = (int32_t)(v >= 0 ? tmp32 : -tmp32);
      int64_t dq;
      if (iqm) {
        int64_t deq = ((int64_t)deqs[rc != 0] * iqm[rc] + 16) >> 5;
        dq = (tmp32 * deq) >> log_scale;
      } else {
        dq = (tmp32 * deqs[rc != 0]) >> log_scale;
      }
      dqcoeff[rc] = (int32_t)(v >= 0 ? dq : -dq);
      if (tmp32) eob = si;
    }
  }
  return eob + 1;
}
