/* Native lossless tile DECODER: the byte-exact mirror of the walk in
 * lossless_tile.c (avl_encode_lossless_tile) plus reconstruction —
 * partition/skip/mode symbols, per-4x4 coefficient parse
 * (avl_read_coeffs_txb), DC prediction and the inverse Walsh-Hadamard
 * add (av1_highbd_iwht4x4_16_add_c), writing pixels straight into the
 * frame planes.
 *
 * Scope (the fast-path gate lives in decoder/decoder.py): 8-bit 4:2:0
 * or mono key frames with base_q_idx == 0 (coded_lossless), no screen
 * tools, produced-by-us stream shapes (all-DC modes).  Any symbol
 * outside that shape sets t->err and the Python reference decoder
 * re-decodes the tile from scratch.
 *
 * Reference behavior: av1/decoder/decodeframe.c decode_partition /
 * parse_decode_block for the ONLY_4X4 lossless case. */

#include <stdint.h>
#include <string.h>

typedef struct {
  const uint8_t *data;
  int32_t pos;
  int32_t end;
  uint32_t dif;
  uint32_t rng;
  int32_t cnt;
  int32_t tell_offs;
} avl_dec;

void avl_dec_init(avl_dec *d, const uint8_t *data, int len);
int avl_dec_symbol_adapt(avl_dec *d, uint16_t *cdf, int nsymbs);
int avl_dec_symbol(avl_dec *d, const uint16_t *cdf, int nsymbs);
int avl_dec_tell(const avl_dec *d);
int avl_read_coeffs_txb(
    avl_dec *dec, const int16_t *scan, int tx_class, int bhl, int width,
    int height, int raw_w, int raw_h, uint16_t *eob_cdf, int eob_syms,
    uint16_t *eob_extra_base, uint16_t *base_eob_base, uint16_t *base_base,
    uint16_t *br_base, uint16_t *dc_sign_cdf, int dqv_dc, int dqv_ac,
    int shift, int bd, const uint8_t *iqm, int32_t *dqcoeff,
    int32_t *out_info);

#define CDF_PROB_TOP 32768
#define COEFF_CONTEXT_MASK 63

enum { P_NONE = 0, P_HORZ = 1, P_VERT = 2, P_SPLIT = 3 };
enum { B4X4 = 0, B8X8 = 3 };

static const uint8_t BW_PX[22] = {4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32,
                                  64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64};
static const uint8_t BH_PX[22] = {4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64,
                                  32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16};

static int bsize_of_dims(int w, int h) {
  for (int b = 0; b < 22; b++)
    if (BW_PX[b] == w && BH_PX[b] == h) return b;
  return -1;
}

static int lt_subsize(int bsize, int partition) {
  int bw = BW_PX[bsize], bh = BH_PX[bsize];
  switch (partition) {
    case P_NONE: return bsize;
    case P_HORZ: return bsize_of_dims(bw, bh / 2);
    case P_VERT: return bsize_of_dims(bw / 2, bh);
    default: return bsize_of_dims(bw / 2, bh / 2);
  }
}

static int ilog2i(int v) {
  int r = 0;
  while (v > 1) { v >>= 1; r++; }
  return r;
}

static const int8_t SKIP_CONTEXTS[5][5] = {{1, 2, 2, 2, 3},
                                           {2, 4, 4, 4, 5},
                                           {2, 4, 4, 4, 5},
                                           {2, 4, 4, 4, 5},
                                           {3, 5, 5, 5, 6}};

static int dc_sign_of(int v) {
  int code = v >> 6;
  return code == 0 ? 0 : (code == 1 ? -1 : 1);
}

typedef struct {
  avl_dec d;
  uint16_t *arena;
  const int32_t *offs;    /* [part_base, part_stride, skip_base,
                             kf_y_off, uv_off0, uv_off1] */
  const int32_t *cdfsets; /* 2 rows x 8 (plane_type 0/1) */
  const int16_t *scan4;
  uint8_t *plane[3];
  int stride[3];
  int vis_w[3], vis_h[3]; /* visible plane px (pred edge extension) */
  int mi_rows, mi_cols, num_planes, sb_mi;
  uint8_t above_part[4096 + 32], left_part[4096 + 32];
  uint8_t ae[3][4096 + 32], le[3][4096 + 32];
  uint8_t *mi_skip;
  int err;
} LD;

/* --- inverse 4x4 Walsh-Hadamard + clip-add (txfm.py iwht4x4) --- */
static void iwht4x4_add(const int32_t *dq, uint8_t *p, int stride) {
  int64_t interm[16];
  for (int i = 0; i < 4; i++) {
    int64_t a1 = dq[i] >> 2, c1 = dq[4 + i] >> 2;
    int64_t d1 = dq[8 + i] >> 2, b1 = dq[12 + i] >> 2;
    a1 += c1;
    d1 -= b1;
    int64_t e1 = (a1 - d1) >> 1;
    b1 = e1 - b1;
    c1 = e1 - c1;
    a1 -= b1;
    d1 += c1;
    interm[i] = a1;
    interm[4 + i] = b1;
    interm[8 + i] = c1;
    interm[12 + i] = d1;
  }
  for (int i = 0; i < 4; i++) {
    int64_t a1 = interm[4 * i], c1 = interm[4 * i + 1];
    int64_t d1 = interm[4 * i + 2], b1 = interm[4 * i + 3];
    a1 += c1;
    d1 -= b1;
    int64_t e1 = (a1 - d1) >> 1;
    b1 = e1 - b1;
    c1 = e1 - c1;
    a1 -= b1;
    d1 += c1;
    int64_t col[4] = {a1, b1, c1, d1};
    for (int r = 0; r < 4; r++) {
      int v = p[r * stride + i] + (int)col[r];
      p[r * stride + i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

/* --- DC prediction for one 4x4 at plane px (y, x); edge samples
 * extend with their last visible value (intra.py predict_intra) --- */
static int dc_pred_4x4(LD *t, int pl, int y, int x) {
  uint8_t *p = t->plane[pl];
  int stride = t->stride[pl];
  int have_t = y > 0;
  int have_l = x > 0;
  if (!have_t && !have_l) return 128;
  int sum_t = 0, sum_l = 0;
  if (have_t) {
    int n = t->vis_w[pl] - x;
    if (n > 4) n = 4;
    int last = 129; /* base + 1 never used: n >= 1 when have_t in-frame */
    for (int k = 0; k < 4; k++) {
      if (k < n) last = p[(y - 1) * stride + x + k];
      sum_t += last;
    }
  }
  if (have_l) {
    int n = t->vis_h[pl] - y;
    if (n > 4) n = 4;
    int last = 127;
    for (int k = 0; k < 4; k++) {
      if (k < n) last = p[(y + k) * stride + x - 1];
      sum_l += last;
    }
  }
  if (have_t && have_l) return (sum_t + sum_l + 4) >> 3;
  return ((have_t ? sum_t : sum_l) + 2) >> 2;
}

static void ld_read_partition(LD *t, int mi_row, int mi_col, int bsize,
                              int *partition) {
  /* fixed edge policy (lt_choose_partition): interior = NONE, so the
   * symbol's VALUE is known, but the bits must still be consumed with
   * identical cdf adaptation */
  int hbs = (BW_PX[bsize] >> 2) / 2;
  int has_rows = mi_row + hbs < t->mi_rows;
  int has_cols = mi_col + hbs < t->mi_cols;
  if (!has_rows && !has_cols) {
    *partition = P_SPLIT; /* implicit */
    return;
  }
  int bsl = ilog2i(BW_PX[bsize] >> 2) - 1;
  int above = (t->above_part[mi_col] >> bsl) & 1;
  int left = (t->left_part[mi_row] >> bsl) & 1;
  int ctx = (left * 2 + above) + bsl * 4;
  uint16_t *cdf = t->arena + t->offs[0] + ctx * t->offs[1];
  if (has_rows && has_cols) {
    int n = bsize == B8X8 ? 4 : 10;
    *partition = avl_dec_symbol_adapt(&t->d, cdf, n);
    if (*partition > P_SPLIT) t->err = 1;
    return;
  }
  /* gather split-vs-rect (decoder.py _gather_split_cdf) */
  static const int horz_elems[6] = {1, 3, 4, 5, 6, 8};
  static const int vert_elems[6] = {2, 3, 4, 6, 7, 9};
  /* encoder passes horz_alike = !has_cols (lossless_tile.c) */
  const int *elems = has_cols ? vert_elems : horz_elems;
  int p = CDF_PROB_TOP;
  for (int k = 0; k < 6; k++) {
    int el = elems[k];
    int prev = el == 0 ? CDF_PROB_TOP : cdf[el - 1];
    p -= prev - cdf[el];
  }
  uint16_t g[3] = {(uint16_t)(CDF_PROB_TOP - p), 0, 0};
  int split = avl_dec_symbol(&t->d, g, 2);
  *partition = split ? P_SPLIT : (has_cols ? P_HORZ : P_VERT);
}

static void ld_update_ext_ctx(LD *t, int mi_row, int mi_col, int subsize,
                              int bsize, int partition) {
  if (bsize < B8X8) return;
  if (partition == P_SPLIT && bsize != B8X8) return;
  int bw = BW_PX[bsize] >> 2, bh = BH_PX[bsize] >> 2;
  int sub_w4 = BW_PX[subsize] >> 2, sub_h4 = BH_PX[subsize] >> 2;
  uint8_t above = (uint8_t)((31 << ilog2i(sub_w4)) & 31);
  uint8_t left = (uint8_t)((31 << ilog2i(sub_h4)) & 31);
  memset(t->above_part + mi_col, above, (size_t)bw);
  memset(t->left_part + mi_row, left, (size_t)bh);
}

static void ld_decode_block(LD *t, int mi_row, int mi_col, int bsize) {
  int bw = BW_PX[bsize] >> 2, bh = BH_PX[bsize] >> 2;
  int chroma_ref = t->num_planes > 1 &&
                   ((mi_row & 1) || !(bh & 1)) && ((mi_col & 1) || !(bw & 1));
  int skip_ctx =
      (mi_row > 0 ? t->mi_skip[(mi_row - 1) * t->mi_cols + mi_col] : 0) +
      (mi_col > 0 ? t->mi_skip[mi_row * t->mi_cols + mi_col - 1] : 0);
  int skip = avl_dec_symbol_adapt(
      &t->d, t->arena + t->offs[2] + skip_ctx * 3, 2);
  int y_mode = avl_dec_symbol_adapt(&t->d, t->arena + t->offs[3], 13);
  if (y_mode != 0) { t->err = 1; return; }
  if (chroma_ref) {
    int cfl_allowed = (BW_PX[bsize] <= 8 && BH_PX[bsize] <= 8);
    int uv = avl_dec_symbol_adapt(&t->d,
                                  t->arena + t->offs[4 + cfl_allowed],
                                  14 - !cfl_allowed);
    if (uv != 0) { t->err = 1; return; }
  }
  int rmax = mi_row + bh < t->mi_rows ? mi_row + bh : t->mi_rows;
  int cmax = mi_col + bw < t->mi_cols ? mi_col + bw : t->mi_cols;
  for (int r = mi_row; r < rmax; r++)
    memset(t->mi_skip + r * t->mi_cols + mi_col, skip,
           (size_t)(cmax - mi_col));

  int nplanes = chroma_ref ? t->num_planes : 1;
  for (int plane = 0; plane < nplanes; plane++) {
    int ss = plane ? 1 : 0;
    int pbw = plane ? (BW_PX[bsize] >> 1 < 4 ? 4 : BW_PX[bsize] >> 1)
                    : BW_PX[bsize];
    int pbh = plane ? (BH_PX[bsize] >> 1 < 4 ? 4 : BH_PX[bsize] >> 1)
                    : BH_PX[bsize];
    int plane_bsize = plane ? bsize_of_dims(pbw, pbh) : bsize;
    int row0 = plane ? (((mi_row - (mi_row & 1)) * 4) >> 1) : mi_row * 4;
    int col0 = plane ? (((mi_col - (mi_col & 1)) * 4) >> 1) : mi_col * 4;
    int mb_to_right = (t->mi_cols - bw - mi_col) * 4;
    int mb_to_bottom = (t->mi_rows - bh - mi_row) * 4;
    int vis_w = pbw + ((mb_to_right < 0 ? mb_to_right : 0) >> ss);
    int vis_h = pbh + ((mb_to_bottom < 0 ? mb_to_bottom : 0) >> ss);
    int n4w = vis_w >> 2 > 1 ? vis_w >> 2 : 1;
    int n4h = vis_h >> 2 > 1 ? vis_h >> 2 : 1;
    const int32_t *cs = t->cdfsets + (plane ? 8 : 0);
    for (int r4 = 0; r4 < n4h; r4++) {
      for (int c4 = 0; c4 < n4w; c4++) {
        int py = row0 + r4 * 4, px = col0 + c4 * 4;
        int acol = px >> 2, lrow = py >> 2;
        uint8_t *au = t->ae[plane], *lu = t->le[plane];
        /* prediction always runs (skip blocks are pred-only) */
        int dc = dc_pred_4x4(t, plane, py, px);
        uint8_t *dst = t->plane[plane] + py * t->stride[plane] + px;
        for (int r = 0; r < 4; r++)
          memset(dst + r * t->stride[plane], dc, 4);
        if (skip) {
          au[acol] = 0;
          lu[lrow] = 0;
          continue;
        }
        int a = au[acol], l = lu[lrow];
        int ds = dc_sign_of(a) + dc_sign_of(l);
        int dc_sign_ctx = ds == 0 ? 0 : (ds < 0 ? 1 : 2);
        int sctx;
        if (plane == 0) {
          if (plane_bsize == B4X4)
            sctx = 0;
          else {
            int top = (a & COEFF_CONTEXT_MASK) < 4
                          ? (a & COEFF_CONTEXT_MASK) : 4;
            int lft = (l & COEFF_CONTEXT_MASK) < 4
                          ? (l & COEFF_CONTEXT_MASK) : 4;
            sctx = SKIP_CONTEXTS[top][lft];
          }
        } else {
          sctx = (a != 0) + (l != 0) + (plane_bsize == B4X4 ? 7 : 10);
        }
        int all_zero = avl_dec_symbol_adapt(
            &t->d, t->arena + cs[0] + sctx * 3, 2);
        if (all_zero) {
          au[acol] = 0;
          lu[lrow] = 0;
          continue;
        }
        int32_t dqcoeff[16];
        memset(dqcoeff, 0, sizeof(dqcoeff));
        int32_t info[2];
        avl_read_coeffs_txb(
            &t->d, t->scan4, 0 /* 2D */, 2 /* bhl */, 4, 4, 4, 4,
            t->arena + cs[1], 5, t->arena + cs[2], t->arena + cs[3],
            t->arena + cs[4], t->arena + cs[5],
            t->arena + cs[6] + dc_sign_ctx * 3,
            4 /* dqv dc, qindex 0 */, 4 /* dqv ac */, 0 /* shift */, 8,
            0 /* iqm */, dqcoeff, info);
        iwht4x4_add(dqcoeff, dst, t->stride[plane]);
        au[acol] = (uint8_t)info[0];
        lu[lrow] = (uint8_t)info[0];
      }
    }
  }
}

static void ld_decode_partition(LD *t, int mi_row, int mi_col, int bsize) {
  if (mi_row >= t->mi_rows || mi_col >= t->mi_cols || t->err) return;
  int bw = BW_PX[bsize] >> 2;
  int hbs = bw / 2;
  int partition = P_NONE;
  if (bsize >= B8X8) ld_read_partition(t, mi_row, mi_col, bsize, &partition);
  if (t->err) return;
  int subsize = lt_subsize(bsize, partition);
  switch (partition) {
    case P_NONE:
      ld_decode_block(t, mi_row, mi_col, subsize);
      break;
    case P_HORZ:
      ld_decode_block(t, mi_row, mi_col, subsize);
      if (mi_row + hbs < t->mi_rows)
        ld_decode_block(t, mi_row + hbs, mi_col, subsize);
      break;
    case P_VERT:
      ld_decode_block(t, mi_row, mi_col, subsize);
      if (mi_col + hbs < t->mi_cols)
        ld_decode_block(t, mi_row, mi_col + hbs, subsize);
      break;
    default:
      ld_decode_partition(t, mi_row, mi_col, subsize);
      ld_decode_partition(t, mi_row, mi_col + hbs, subsize);
      ld_decode_partition(t, mi_row + hbs, mi_col, subsize);
      ld_decode_partition(t, mi_row + hbs, mi_col + hbs, subsize);
      break;
  }
  if (!t->err) ld_update_ext_ctx(t, mi_row, mi_col, subsize, bsize,
                                 partition);
}

static uint8_t g_mi_skip[8192 * 64];

/* Decode one lossless tile into the plane buffers (y/u/v point at the
 * TILE origin inside each plane).  vis_* give the remaining visible
 * plane extent from that origin (pred edge extension).  Returns bits
 * consumed, or -1 on an unsupported stream shape (caller falls back to
 * the Python reference decoder). */
int avl_decode_lossless_tile(
    const uint8_t *data, int len, uint16_t *arena, const int32_t *offs,
    const int32_t *cdfsets, const int16_t *scan4, uint8_t *y, uint8_t *u,
    uint8_t *v, int ys, int cs, int vis_wy, int vis_hy, int mi_rows,
    int mi_cols, int num_planes, int sb_mi) {
  static LD t; /* large ctx arrays; single-threaded per process */
  if ((size_t)mi_rows * mi_cols > sizeof(g_mi_skip)) return -1;
  memset(&t, 0, sizeof(t));
  avl_dec_init(&t.d, data, len);
  t.arena = arena;
  t.offs = offs;
  t.cdfsets = cdfsets;
  t.scan4 = scan4;
  t.plane[0] = y;
  t.plane[1] = u;
  t.plane[2] = v;
  t.stride[0] = ys;
  t.stride[1] = t.stride[2] = cs;
  t.vis_w[0] = vis_wy;
  t.vis_h[0] = vis_hy;
  t.vis_w[1] = t.vis_w[2] = (vis_wy + 1) >> 1;
  t.vis_h[1] = t.vis_h[2] = (vis_hy + 1) >> 1;
  t.mi_rows = mi_rows;
  t.mi_cols = mi_cols;
  t.num_planes = num_planes;
  t.sb_mi = sb_mi;
  t.mi_skip = g_mi_skip;
  t.err = 0;
  memset(g_mi_skip, 0, (size_t)mi_rows * mi_cols);
  for (int mi_row = 0; mi_row < mi_rows && !t.err; mi_row += sb_mi) {
    memset(t.left_part, 0, sizeof(t.left_part));
    for (int p = 0; p < 3; p++) memset(t.le[p], 0, sizeof(t.le[p]));
    for (int mi_col = 0; mi_col < mi_cols && !t.err; mi_col += sb_mi) {
      int sb_bsize = sb_mi == 32 ? 15 : 12; /* B128X128 : B64X64 */
      ld_decode_partition(&t, mi_row, mi_col, sb_bsize);
    }
  }
  if (t.err) return -1;
  return avl_dec_tell(&t.d);
}
