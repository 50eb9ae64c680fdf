/* Full-frame CU-tree syntax emitter (H.265 7.3.8) — the native production
 * backend of the fast-path host walk (pipeline/fast_path.py
 * FastCtuEncoder + pipeline/encoder.py _encode_fast).
 *
 * Because the quadtree decisions, motion field, intra modes, TU sizes and
 * quantized levels are all final once the fused device graph has run, the
 * ENTIRE slice-substream syntax is a pure function of those maps: merge /
 * AMVP legality (8.5.3.2.3-8 incl. TMVP), MPM derivation (8.4.2), cbf
 * flags and residual payloads. This file walks every CTU once, derives
 * that syntax, and drives the arithmetic coder (cabac_core.h) directly —
 * one C call per tile replaces the per-CU Python walk that dominated the
 * encoder's steady-state profile.
 *
 * Reference analogue: EbEntropyCoding.c EncodeLcu :7343 (the reference's
 * table-driven LCU emitter running in the EntropyCoding process) fused
 * with the candidate derivations of EbAdaptiveMotionVectorPrediction.c.
 * The Python walk remains the oracle; byte-equality is test-enforced
 * (tests/test_native_emitter.py).
 */

#include <stdlib.h>
#include "cabac_core.h"

/* residual-coding bin-op generator (residual.c, same shared object) */
extern int64_t residual_ops(const int32_t *coeffs, int32_t n, int32_t c_idx,
                            int32_t scan_idx, const int32_t *bases,
                            int32_t *ops_out, int64_t cap);

/* ---- context-base table order (matches pipeline/native_emit.py) ---- */
enum {
    CB_SPLIT_CU, CB_CU_SKIP, CB_PART_MODE, CB_PRED_MODE, CB_PREV_INTRA,
    CB_INTRA_CHROMA, CB_MERGE_FLAG, CB_MERGE_IDX, CB_INTER_DIR, CB_MVD,
    CB_MVP, CB_RQT_ROOT, CB_CBF_LUMA, CB_CBF_CHROMA, CB_SPLIT_TRANSFORM,
    CB_DQP, CB_SAO_MERGE, CB_SAO_TYPE, CB_COUNT
};

#define SCAN_DIAG 0
#define SCAN_HOR 1
#define SCAN_VER 2

typedef struct {
    int32_t w, h, ctb_log2, slice_type, max_merge, cur_poc;
    int32_t n_ref0, n_ref1;
    int32_t ref_pocs0[8], ref_pocs1[8];
    int32_t has_col, col_poc, col_from_l0, no_backward;
    int32_t col_w16, col_h16;
    int32_t col_ref_pocs0[8], col_ref_pocs1[8];
    int32_t max_tt_depth_inter;
    int32_t sao_enabled, bit_depth;
    int32_t cu_qp_delta_enabled, slice_qp;
    int32_t nbx, nby;                 /* 8x8 decision-map dims (padded) */
    int32_t stride_y, stride_c;       /* lv plane strides (padded dims) */
    int32_t sao_nx;                   /* SAO grid stride (padded CTB grid) */
    int32_t qpm_nx;                   /* qp_map stride (coded CTB grid) */
    int32_t ctb_x0, ctb_y0, ctb_x1, ctb_y1;  /* tile CTB rect [x0,x1) */
    int32_t last_ctb_x, last_ctb_y;   /* slice-final CTB (terminate=1) */
    int32_t end_of_subset;            /* extra terminate(1) at tile end */
} emit_cfg_t;

typedef struct {
    const int32_t *cu8;        /* [nby][nbx] CU log2 (3..6) */
    const int32_t *ref8;       /* [2][nby][nbx] ref idx, -1 = unused */
    const int32_t *mv8;        /* [2][nby][nbx][2] quarter-pel MV */
    const int32_t *mode8;      /* [nby][nbx] intra mode of covering CU */
    const int32_t *tu8;        /* [nby][nbx] TU log2 (3..5) for inter */
    const int32_t *lv_y;       /* [>=h][stride_y] levels */
    const int32_t *lv_cb, *lv_cr;      /* [>=h/2][stride_c] */
    const int32_t *sao_type;   /* [ny][sao_nx][2] */
    const int32_t *sao_eo;     /* [ny][sao_nx][2] */
    const int32_t *sao_bp;     /* [ny][sao_nx][3] */
    const int32_t *sao_offs;   /* [ny][sao_nx][3][4] */
    const int32_t *col_mv;     /* [col_h16][col_w16][2][2] */
    const int32_t *col_ref;    /* [col_h16][col_w16][2] */
    const int32_t *qp_map;     /* [ny_ctb][qpm_nx] or NULL */
    const int32_t *bases;      /* CB_COUNT context bases */
    const int32_t *res_bases;  /* residual ctx bases (residual.c order) */
    uint8_t *ctx;              /* context states, mutated */
    int32_t *mv_out;           /* [h/4][w/4][2][2] motion state + output */
    int32_t *ref_out;          /* [h/4][w/4][2] init -1 by caller */
    uint8_t *out;
    int64_t out_cap;
} emit_bufs_t;

/* ------------------------------------------------------------- state */

typedef struct {
    const emit_cfg_t *c;
    const emit_bufs_t *b;
    bac_t bac;
    int32_t w4, h4;
    uint8_t *avail;            /* [h4][w4] z-order reconstructed (luma) */
    int16_t *lmode;            /* [h4][w4] intra mode, -1 = none/inter */
    uint8_t *depth4;           /* [h4][w4] coding quadtree depth */
    uint8_t *skipm;            /* [h4][w4] skip flag */
    int32_t *res_ops;          /* residual op scratch */
    int64_t res_cap;
    /* QG (cu_qp_delta) state */
    int32_t qp, prev_qp, qg_pred;
    int32_t qg_coded;
    int32_t err;
} est_t;

#define E_BIN(base, inc, v) encode_bin(&e->bac, e->b->ctx, \
        e->b->bases[base] + (inc), (v))
#define E_BYP(v) encode_bypass(&e->bac, (v))
#define E_BYPN(v, n) encode_bypass_bins(&e->bac, (n), (v))

static void egk(est_t *e, int64_t v, int k) {
    /* k-th order Exp-Golomb, bypass bins (9.3.3.3) */
    while (v >= ((int64_t)1 << k)) {
        E_BYP(1);
        v -= (int64_t)1 << k;
        k++;
    }
    E_BYP(0);
    if (k)
        E_BYPN(v, k);
}

/* ---------------------------------------------------------- motion info */

typedef struct {
    int32_t mvx[2], mvy[2];
    int32_t ref[2];
} mi_t;

static int mi_eq(const mi_t *a, const mi_t *b) {
    return a->mvx[0] == b->mvx[0] && a->mvy[0] == b->mvy[0]
        && a->mvx[1] == b->mvx[1] && a->mvy[1] == b->mvy[1]
        && a->ref[0] == b->ref[0] && a->ref[1] == b->ref[1];
}

/* motion at luma (x, y): 1 if available inter motion (core/inter.py
 * _motion_at: bounds + avail map + any ref >= 0) */
static int motion_at(est_t *e, int32_t x, int32_t y, mi_t *out) {
    const emit_cfg_t *c = e->c;
    if (x < 0 || y < 0 || x >= c->w || y >= c->h)
        return 0;
    int32_t i4 = (y >> 2) * e->w4 + (x >> 2);
    if (!e->avail[i4])
        return 0;
    const int32_t *rr = e->b->ref_out + 2 * i4;
    if (rr[0] < 0 && rr[1] < 0)
        return 0;
    const int32_t *mm = e->b->mv_out + 4 * i4;
    out->mvx[0] = mm[0]; out->mvy[0] = mm[1];
    out->mvx[1] = mm[2]; out->mvy[1] = mm[3];
    out->ref[0] = rr[0]; out->ref[1] = rr[1];
    return 1;
}

static int32_t clip32(int32_t v, int32_t lo, int32_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

/* spec 5.4 integer division truncating toward zero */
static int32_t div_trunc(int32_t n, int32_t d) {
    int32_t q = (n < 0 ? -n : n) / (d < 0 ? -d : d);
    return ((n < 0) != (d < 0)) ? -q : q;
}

/* MV scaling with explicit POC distances (8.5.3.2.8; core/inter.py
 * _scale_mv_td) */
static void scale_mv_td(int32_t mx, int32_t my, int32_t tb, int32_t td,
                        int32_t *ox, int32_t *oy) {
    tb = clip32(tb, -128, 127);
    td = clip32(td, -128, 127);
    if (td == tb || td == 0) {
        *ox = mx; *oy = my;
        return;
    }
    int32_t tx = div_trunc(16384 + ((td < 0 ? -td : td) >> 1), td);
    int32_t dsf = clip32((tb * tx + 32) >> 6, -4096, 4095);
    int32_t comp[2] = {mx, my}, res[2];
    for (int i = 0; i < 2; i++) {
        int64_t v = (int64_t)dsf * comp[i];
        int64_t a = ((v < 0 ? -v : v) + 127) >> 8;
        a = v >= 0 ? a : -a;
        res[i] = (int32_t)(a < -32768 ? -32768 : (a > 32767 ? 32767 : a));
    }
    *ox = res[0]; *oy = res[1];
}

/* TMVP (8.5.3.2.7/8; core/inter.py tmvp_mv). Returns 1 + mv if found. */
static int tmvp_mv(est_t *e, int32_t x0, int32_t y0, int32_t n, int lst,
                   int32_t target_poc, int32_t *ox, int32_t *oy) {
    const emit_cfg_t *c = e->c;
    if (!c->has_col)
        return 0;
    int32_t cands[2][2];
    int ncand = 0;
    int32_t xbr = x0 + n, ybr = y0 + n;
    if (xbr < c->w && ybr < c->h
            && (ybr >> c->ctb_log2) == (y0 >> c->ctb_log2)) {
        cands[ncand][0] = xbr; cands[ncand][1] = ybr; ncand++;
    }
    cands[ncand][0] = x0 + n / 2; cands[ncand][1] = y0 + n / 2; ncand++;

    for (int i = 0; i < ncand; i++) {
        int32_t cx = cands[i][0] >> 4, cy = cands[i][1] >> 4;
        if (cy >= c->col_h16 || cx >= c->col_w16)
            continue;
        const int32_t *cr = e->b->col_ref + 2 * (cy * c->col_w16 + cx);
        if (cr[0] < 0 && cr[1] < 0)
            continue;
        int lc;
        if (cr[0] < 0)
            lc = 1;
        else if (cr[1] < 0)
            lc = 0;
        else if (c->no_backward)
            lc = lst;
        else
            lc = c->col_from_l0 ? 1 : 0;
        const int32_t *crp = lc == 0 ? c->col_ref_pocs0 : c->col_ref_pocs1;
        int32_t ref_poc_col = crp[cr[lc]];
        int32_t tb = c->cur_poc - target_poc;
        int32_t td = c->col_poc - ref_poc_col;
        const int32_t *cm = e->b->col_mv + 4 * (cy * c->col_w16 + cx);
        scale_mv_td(cm[2 * lc], cm[2 * lc + 1], tb, td, ox, oy);
        return 1;
    }
    return 0;
}

/* merge candidate list (8.5.3.2.3/4; core/inter.py merge_candidates) */
static int merge_list(est_t *e, int32_t x0, int32_t y0, int32_t n,
                      mi_t *cand) {
    const emit_cfg_t *c = e->c;
    int is_b = c->slice_type == 0;
    int max_cand = c->max_merge;
    mi_t a1, b1, b0, a0, b2;
    int pa1 = motion_at(e, x0 - 1, y0 + n - 1, &a1);
    int pb1 = motion_at(e, x0 + n - 1, y0 - 1, &b1);
    int pb0 = motion_at(e, x0 + n, y0 - 1, &b0);
    int pa0 = motion_at(e, x0 - 1, y0 + n, &a0);
    int pb2 = motion_at(e, x0 - 1, y0 - 1, &b2);

    int nc = 0;
    if (pa1)
        cand[nc++] = a1;
    if (pb1 && !(pa1 && mi_eq(&b1, &a1)))
        cand[nc++] = b1;
    if (pb0 && !(pb1 && mi_eq(&b0, &b1)))
        cand[nc++] = b0;
    if (pa0 && !(pa1 && mi_eq(&a0, &a1)))
        cand[nc++] = a0;
    if (nc < 4 && pb2 && !(pa1 && mi_eq(&b2, &a1))
            && !(pb1 && mi_eq(&b2, &b1)))
        cand[nc++] = b2;

    /* temporal candidate */
    if (c->has_col && nc < max_cand) {
        int32_t m0x, m0y, m1x, m1y;
        int f0 = tmvp_mv(e, x0, y0, n, 0, c->ref_pocs0[0], &m0x, &m0y);
        int f1 = is_b ? tmvp_mv(e, x0, y0, n, 1, c->ref_pocs1[0],
                                &m1x, &m1y) : 0;
        if (f0 || f1) {
            mi_t t;
            t.mvx[0] = f0 ? m0x : 0; t.mvy[0] = f0 ? m0y : 0;
            t.ref[0] = f0 ? 0 : -1;
            t.mvx[1] = f1 ? m1x : 0; t.mvy[1] = f1 ? m1y : 0;
            t.ref[1] = f1 ? 0 : -1;
            cand[nc++] = t;
        }
    }
    if (is_b && nc > 1) {
        /* combined bi-predictive candidates (8.5.3.2.4) */
        static const int l0i[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
        static const int l1i[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
        int num_orig = nc;
        for (int k = 0; k < num_orig * (num_orig - 1) && k < 12; k++) {
            if (nc >= max_cand)
                break;
            int i = l0i[k], j = l1i[k];
            if (i >= num_orig || j >= num_orig)
                break;
            const mi_t *ci = &cand[i], *cj = &cand[j];
            if (ci->ref[0] < 0 || cj->ref[1] < 0)
                continue;
            int32_t p0 = c->ref_pocs0[ci->ref[0]];
            int32_t p1 = c->ref_pocs1[cj->ref[1]];
            if (p0 == p1 && ci->mvx[0] == cj->mvx[1]
                    && ci->mvy[0] == cj->mvy[1])
                continue;
            mi_t t;
            t.mvx[0] = ci->mvx[0]; t.mvy[0] = ci->mvy[0];
            t.ref[0] = ci->ref[0];
            t.mvx[1] = cj->mvx[1]; t.mvy[1] = cj->mvy[1];
            t.ref[1] = cj->ref[1];
            cand[nc++] = t;
        }
    }
    while (nc < max_cand) {
        mi_t z;
        z.mvx[0] = 0; z.mvy[0] = 0; z.ref[0] = 0;
        z.mvx[1] = 0; z.mvy[1] = 0; z.ref[1] = is_b ? 0 : -1;
        cand[nc++] = z;
    }
    return max_cand;
}

/* AMVP candidate pair (8.5.3.2.5-7; core/inter.py amvp_candidates) */
static void scale_mv(int32_t mx, int32_t my, int32_t cur_poc,
                     int32_t target_poc, int32_t cand_poc,
                     int32_t *ox, int32_t *oy) {
    scale_mv_td(mx, my, cur_poc - target_poc, cur_poc - cand_poc, ox, oy);
}

static void amvp_candidates(est_t *e, int32_t x0, int32_t y0, int32_t n,
                            int lst, int32_t out[2][2]) {
    const emit_cfg_t *c = e->c;
    const int32_t *rp[2] = {c->ref_pocs0, c->ref_pocs1};
    int32_t target_poc = rp[lst][0];
    mi_t nb[5];
    int p[5];
    p[0] = motion_at(e, x0 - 1, y0 + n, &nb[0]);        /* a0 */
    p[1] = motion_at(e, x0 - 1, y0 + n - 1, &nb[1]);    /* a1 */
    p[2] = motion_at(e, x0 + n, y0 - 1, &nb[2]);        /* b0 */
    p[3] = motion_at(e, x0 + n - 1, y0 - 1, &nb[3]);    /* b1 */
    p[4] = motion_at(e, x0 - 1, y0 - 1, &nb[4]);        /* b2 */

    /* step1: same-POC candidate, unscaled */
#define STEP1(idxs, cnt, fx, fy, found) do { \
        found = 0; \
        for (int _i = 0; _i < (cnt) && !found; _i++) { \
            int _k = (idxs)[_i]; \
            if (!p[_k]) continue; \
            int _lls[2] = {lst, 1 - lst}; \
            for (int _j = 0; _j < 2 && !found; _j++) { \
                int _ll = _lls[_j]; \
                if (nb[_k].ref[_ll] >= 0 \
                        && rp[_ll][nb[_k].ref[_ll]] == target_poc) { \
                    fx = nb[_k].mvx[_ll]; fy = nb[_k].mvy[_ll]; \
                    found = 1; \
                } \
            } \
        } \
    } while (0)

    /* step2: any candidate, POC-scaled */
#define STEP2(idxs, cnt, fx, fy, found) do { \
        found = 0; \
        for (int _i = 0; _i < (cnt) && !found; _i++) { \
            int _k = (idxs)[_i]; \
            if (!p[_k]) continue; \
            int _lls[2] = {lst, 1 - lst}; \
            for (int _j = 0; _j < 2 && !found; _j++) { \
                int _ll = _lls[_j]; \
                if (nb[_k].ref[_ll] >= 0) { \
                    scale_mv(nb[_k].mvx[_ll], nb[_k].mvy[_ll], c->cur_poc, \
                             target_poc, rp[_ll][nb[_k].ref[_ll]], \
                             &fx, &fy); \
                    found = 1; \
                } \
            } \
        } \
    } while (0)

    static const int aidx[2] = {0, 1};
    static const int bidx[3] = {2, 3, 4};
    int is_scaled = p[0] || p[1];
    int32_t ax = 0, ay = 0, bx = 0, by = 0;
    int fa, fb;
    STEP1(aidx, 2, ax, ay, fa);
    if (!fa && is_scaled)
        STEP2(aidx, 2, ax, ay, fa);
    STEP1(bidx, 3, bx, by, fb);
    if (!is_scaled) {
        /* no left neighbors: B's unscaled result moves to slot A, B
         * re-runs with scaling (8.5.3.2.6) */
        fa = fb; ax = bx; ay = by;
        STEP2(bidx, 3, bx, by, fb);
    }
#undef STEP1
#undef STEP2

    int nc = 0;
    if (fa) {
        out[nc][0] = ax; out[nc][1] = ay; nc++;
    }
    if (fb && !(fa && bx == ax && by == ay)) {
        out[nc][0] = bx; out[nc][1] = by; nc++;
    }
    if (nc < 2 && c->has_col) {
        int32_t tx, ty;
        if (tmvp_mv(e, x0, y0, n, lst, target_poc, &tx, &ty)) {
            out[nc][0] = tx; out[nc][1] = ty; nc++;
        }
    }
    while (nc < 2) {
        out[nc][0] = 0; out[nc][1] = 0; nc++;
    }
}

static int32_t mvd_bits(int32_t v) {
    int32_t a = v < 0 ? -v : v;
    if (a == 0) return 1;
    if (a == 1) return 3;
    int32_t big = a - 2 > 1 ? a - 2 : 1;
    int32_t bl = 0;
    while (big) { bl++; big >>= 1; }
    return 4 + 2 * bl;
}

/* --------------------------------------------------------- level queries */

static int any_nz_y(est_t *e, int32_t x0, int32_t y0, int32_t n) {
    const int32_t *lv = e->b->lv_y;
    int32_t s = e->c->stride_y;
    for (int32_t y = y0; y < y0 + n; y++) {
        const int32_t *row = lv + (int64_t)y * s + x0;
        for (int32_t x = 0; x < n; x++)
            if (row[x])
                return 1;
    }
    return 0;
}

static int any_nz_c(est_t *e, const int32_t *lv, int32_t xc, int32_t yc,
                    int32_t n) {
    int32_t s = e->c->stride_c;
    for (int32_t y = yc; y < yc + n; y++) {
        const int32_t *row = lv + (int64_t)y * s + xc;
        for (int32_t x = 0; x < n; x++)
            if (row[x])
                return 1;
    }
    return 0;
}

/* ----------------------------------------------------------- residuals */

static void emit_residual(est_t *e, const int32_t *lv, int32_t stride,
                          int32_t x0, int32_t y0, int32_t log2,
                          int32_t c_idx, int32_t scan_idx) {
    int32_t n = 1 << log2;
    int32_t buf[32 * 32];
    for (int32_t y = 0; y < n; y++)
        memcpy(buf + y * n, lv + (int64_t)(y0 + y) * stride + x0,
               (size_t)n * 4);
    int64_t k = residual_ops(buf, n, c_idx, scan_idx, e->b->res_bases,
                             e->res_ops, e->res_cap);
    if (k < 0) {
        e->err = -10;
        return;
    }
    for (int64_t i = 0; i < k; i++) {
        int32_t kind = e->res_ops[3 * i];
        int32_t a = e->res_ops[3 * i + 1];
        int32_t v = e->res_ops[3 * i + 2];
        if (kind == 0)
            encode_bin(&e->bac, e->b->ctx, a, v);
        else if (kind == 1)
            encode_bypass(&e->bac, v);
        else
            encode_bypass_bins(&e->bac, a, v);
    }
}

static int scan_for(int32_t log2, int32_t c_idx, int32_t intra_mode) {
    /* spec 7.4.9.11 / bitstream/residual.py select_scan; intra_mode < 0
     * means inter (always diagonal) */
    if (intra_mode < 0)
        return SCAN_DIAG;
    if (log2 == 2 || (log2 == 3 && c_idx == 0)) {
        if (intra_mode >= 6 && intra_mode <= 14)
            return SCAN_VER;
        if (intra_mode >= 22 && intra_mode <= 30)
            return SCAN_HOR;
    }
    return SCAN_DIAG;
}

/* ----------------------------------------------------------- map updates */

static void mark_avail(est_t *e, int32_t x0, int32_t y0, int32_t n) {
    for (int32_t y = y0 >> 2; y < (y0 + n) >> 2; y++)
        memset(e->avail + y * e->w4 + (x0 >> 2), 1, (size_t)(n >> 2));
}

static void set_lmode(est_t *e, int32_t x0, int32_t y0, int32_t n,
                      int32_t mode) {
    for (int32_t y = y0 >> 2; y < (y0 + n) >> 2; y++)
        for (int32_t x = x0 >> 2; x < (x0 + n) >> 2; x++)
            e->lmode[y * e->w4 + x] = (int16_t)mode;
}

static void set_depth(est_t *e, int32_t x0, int32_t y0, int32_t n,
                      int32_t depth) {
    for (int32_t y = y0 >> 2; y < (y0 + n) >> 2; y++)
        memset(e->depth4 + y * e->w4 + (x0 >> 2), depth, (size_t)(n >> 2));
}

static void set_motion(est_t *e, int32_t x0, int32_t y0, int32_t n,
                       const mi_t *mi, int skip) {
    for (int32_t y = y0 >> 2; y < (y0 + n) >> 2; y++)
        for (int32_t x = x0 >> 2; x < (x0 + n) >> 2; x++) {
            int32_t i4 = y * e->w4 + x;
            int32_t *mm = e->b->mv_out + 4 * i4;
            int32_t *rr = e->b->ref_out + 2 * i4;
            mm[0] = mi->mvx[0]; mm[1] = mi->mvy[0];
            mm[2] = mi->mvx[1]; mm[3] = mi->mvy[1];
            rr[0] = mi->ref[0]; rr[1] = mi->ref[1];
            e->skipm[i4] = (uint8_t)skip;
            e->lmode[i4] = -1;
        }
}

/* ------------------------------------------------------------ intra MPM */

static int mpm_list(est_t *e, int32_t xp, int32_t yp, int32_t cand[3]) {
    /* derive_mpm (core/ctu.py) + candidate_mode_list (core/intra.py) */
    int32_t left = -1, above = -1;
    if (xp > 0)
        left = e->lmode[(yp >> 2) * e->w4 + ((xp - 1) >> 2)];
    if (yp > 0 && ((yp - 1) >> e->c->ctb_log2) == (yp >> e->c->ctb_log2))
        above = e->lmode[((yp - 1) >> 2) * e->w4 + (xp >> 2)];
    int32_t a = left < 0 ? 1 : left;        /* DC */
    int32_t b = above < 0 ? 1 : above;
    if (a == b) {
        if (a < 2) {
            cand[0] = 0; cand[1] = 1; cand[2] = 26;
        } else {
            cand[0] = a;
            cand[1] = 2 + ((a + 29) % 32);
            cand[2] = 2 + ((a - 2 + 1) % 32);
        }
        return 3;
    }
    cand[0] = a; cand[1] = b;
    cand[2] = (a != 0 && b != 0) ? 0 : ((a != 1 && b != 1) ? 1 : 26);
    return 3;
}

static int32_t rem_from_mode(int32_t mode, const int32_t cand[3]) {
    int32_t s[3] = {cand[0], cand[1], cand[2]};
    /* sort descending (3 elements) */
    for (int i = 0; i < 2; i++)
        for (int j = 0; j < 2 - i; j++)
            if (s[j] < s[j + 1]) {
                int32_t t = s[j]; s[j] = s[j + 1]; s[j + 1] = t;
            }
    int32_t rem = mode;
    for (int i = 0; i < 3; i++)
        if (rem > s[i])
            rem -= 1;
    return rem;
}

/* -------------------------------------------------------------- the plan */

typedef struct {
    int use_inter, skip, merge_flag, merge_idx;
    int idc;                    /* 0 L0, 1 L1, 2 BI */
    int root_cbf;
    int mvp_idx[2];
    int32_t mvd[2][2];
    mi_t mi;
    mi_t mlist[5];
    int nmerge;
} plan_t;

static void compute_plan(est_t *e, int32_t x0, int32_t y0, int32_t log2,
                         plan_t *p) {
    /* pipeline/fast_path.py FastCtuEncoder._compute_plan, generalized to
     * two reference lists (B slices) */
    const emit_cfg_t *c = e->c;
    int32_t n = 1 << log2;
    int32_t bx = x0 >> 3, by = y0 >> 3;
    int32_t bi = by * c->nbx + bx;
    int32_t r0 = e->b->ref8[bi];
    int32_t r1 = e->b->ref8[(int64_t)c->nby * c->nbx + bi];
    memset(p, 0, sizeof(*p));
    if (r0 < 0 && r1 < 0) {
        p->use_inter = 0;
        return;
    }
    p->use_inter = 1;
    mi_t target;
    const int32_t *m0 = e->b->mv8 + 2 * bi;
    const int32_t *m1 = e->b->mv8 + 2 * ((int64_t)c->nby * c->nbx + bi);
    target.mvx[0] = r0 >= 0 ? m0[0] : 0;
    target.mvy[0] = r0 >= 0 ? m0[1] : 0;
    target.ref[0] = r0;
    target.mvx[1] = r1 >= 0 ? m1[0] : 0;
    target.mvy[1] = r1 >= 0 ? m1[1] : 0;
    target.ref[1] = r1;
    p->mi = target;

    int any_nz = any_nz_y(e, x0, y0, n)
        || any_nz_c(e, e->b->lv_cb, x0 >> 1, y0 >> 1, n >> 1)
        || any_nz_c(e, e->b->lv_cr, x0 >> 1, y0 >> 1, n >> 1);
    p->root_cbf = any_nz;

    p->nmerge = merge_list(e, x0, y0, n, p->mlist);
    for (int idx = 0; idx < p->nmerge; idx++)
        if (mi_eq(&p->mlist[idx], &target)) {
            p->merge_flag = 1;
            p->merge_idx = idx;
            p->skip = !any_nz;
            return;
        }
    /* AMVP per used list */
    if (r0 >= 0 && r1 >= 0)
        p->idc = 2;
    else
        p->idc = r0 >= 0 ? 0 : 1;
    for (int lst = 0; lst < 2; lst++) {
        if (target.ref[lst] < 0)
            continue;
        int32_t amvp[2][2];
        amvp_candidates(e, x0, y0, n, lst, amvp);
        int32_t mvx = target.mvx[lst], mvy = target.mvy[lst];
        int32_t b0 = mvd_bits(mvx - amvp[0][0]) + mvd_bits(mvy - amvp[0][1]);
        int32_t b1 = mvd_bits(mvx - amvp[1][0]) + mvd_bits(mvy - amvp[1][1]);
        int mvp_i = b1 < b0 ? 1 : 0;
        p->mvp_idx[lst] = mvp_i;
        p->mvd[lst][0] = mvx - amvp[mvp_i][0];
        p->mvd[lst][1] = mvy - amvp[mvp_i][1];
    }
}

/* ------------------------------------------------------------- syntax */

static void emit_merge_idx(est_t *e, int idx) {
    int cmax = e->c->max_merge - 1;
    if (cmax > 0) {
        E_BIN(CB_MERGE_IDX, 0, idx > 0);
        if (idx > 0) {
            for (int i = 1; i < idx; i++)
                E_BYP(1);
            if (idx < cmax)
                E_BYP(0);
        }
    }
}

static void emit_mvd(est_t *e, const int32_t mvd[2]) {
    E_BIN(CB_MVD, 0, mvd[0] != 0);
    E_BIN(CB_MVD, 0, mvd[1] != 0);
    for (int i = 0; i < 2; i++)
        if (mvd[i] != 0)
            E_BIN(CB_MVD, 1, (mvd[i] < 0 ? -mvd[i] : mvd[i]) > 1);
    for (int i = 0; i < 2; i++)
        if (mvd[i] != 0) {
            int32_t a = mvd[i] < 0 ? -mvd[i] : mvd[i];
            if (a > 1)
                egk(e, a - 2, 1);
            E_BYP(mvd[i] < 0);
        }
}

static void emit_dqp(est_t *e) {
    /* sx_cu_qp_delta (core/ctu.py): TR cMax=5 + EG0 + sign */
    int32_t delta = e->qp - e->qg_pred;
    int32_t a = delta < 0 ? -delta : delta;
    E_BIN(CB_DQP, 0, a > 0);
    if (a) {
        int32_t lim = a < 5 ? a : 5;
        for (int32_t i = 0; i < lim - 1; i++)
            E_BIN(CB_DQP, 1, 1);
        if (a < 5)
            E_BIN(CB_DQP, 1, 0);
        else
            egk(e, a - 5, 0);
        E_BYP(delta < 0);
    }
    e->qg_coded = 1;
}

/* inter TU-tree split decision (FastCtuEncoder._tu_split) */
static int tu_split(est_t *e, int32_t x0, int32_t y0, int32_t log2) {
    if (log2 > 5)
        return 1;
    return log2 > 3
        && e->b->tu8[(y0 >> 3) * e->c->nbx + (x0 >> 3)] < log2;
}

typedef struct {
    int32_t x0, y0, log2;
    int is_inter;
    int32_t intra_mode;         /* luma mode (DM chroma), -1 for inter */
} cu_t;

/* chroma cbf of the tree node at luma (x0, y0, log2): any nonzero level
 * over the node's chroma area (equals the aggregated child flags) */
static int node_cbf_c(est_t *e, const int32_t *lv, int32_t x0, int32_t y0,
                      int32_t log2) {
    int32_t log2c = log2 - 1 > 2 ? log2 - 1 : 2;
    return any_nz_c(e, lv, x0 >> 1, y0 >> 1, 1 << log2c);
}

static void transform_tree(est_t *e, const cu_t *cu, int32_t x0, int32_t y0,
                           int32_t log2, int32_t depth,
                           int parent_cbf_cb, int parent_cbf_cr) {
    const emit_cfg_t *c = e->c;
    int split = log2 > 5;
    if (!split && cu->is_inter && log2 > 2
            && depth < c->max_tt_depth_inter) {
        split = tu_split(e, x0, y0, log2);
        E_BIN(CB_SPLIT_TRANSFORM, 5 - log2, split);
    }
    int cbf_cb = parent_cbf_cb, cbf_cr = parent_cbf_cr;
    if (log2 > 2) {
        if (depth == 0 || parent_cbf_cb) {
            cbf_cb = node_cbf_c(e, e->b->lv_cb, x0, y0, log2);
            E_BIN(CB_CBF_CHROMA, depth, cbf_cb);
        } else {
            cbf_cb = 0;
        }
        if (depth == 0 || parent_cbf_cr) {
            cbf_cr = node_cbf_c(e, e->b->lv_cr, x0, y0, log2);
            E_BIN(CB_CBF_CHROMA, depth, cbf_cr);
        } else {
            cbf_cr = 0;
        }
    }
    if (split) {
        int32_t half = 1 << (log2 - 1);
        transform_tree(e, cu, x0, y0, log2 - 1, depth + 1, cbf_cb, cbf_cr);
        transform_tree(e, cu, x0 + half, y0, log2 - 1, depth + 1,
                       cbf_cb, cbf_cr);
        transform_tree(e, cu, x0, y0 + half, log2 - 1, depth + 1,
                       cbf_cb, cbf_cr);
        transform_tree(e, cu, x0 + half, y0 + half, log2 - 1, depth + 1,
                       cbf_cb, cbf_cr);
        return;
    }
    /* leaf: transform_unit */
    int32_t n = 1 << log2;
    int cbf_luma;
    if (cu->is_inter && depth == 0 && !cbf_cb && !cbf_cr) {
        cbf_luma = 1;           /* inferred (7.4.9.8) */
    } else {
        cbf_luma = any_nz_y(e, x0, y0, n);
        E_BIN(CB_CBF_LUMA, depth == 0 ? 1 : 0, cbf_luma);
    }
    if (!cu->is_inter)
        mark_avail(e, x0, y0, n);
    if (c->cu_qp_delta_enabled && !e->qg_coded
            && (cbf_luma || cbf_cb || cbf_cr))
        emit_dqp(e);
    if (cbf_luma)
        emit_residual(e, e->b->lv_y, c->stride_y, x0, y0, log2, 0,
                      scan_for(log2, 0, cu->intra_mode));
    if (log2 > 2) {
        int32_t log2c = log2 - 1 > 2 ? log2 - 1 : 2;
        int32_t xc = x0 >> 1, yc = y0 >> 1;
        if (cbf_cb)
            emit_residual(e, e->b->lv_cb, c->stride_c, xc, yc, log2c, 1,
                          scan_for(log2c, 1, cu->intra_mode));
        if (cbf_cr)
            emit_residual(e, e->b->lv_cr, c->stride_c, xc, yc, log2c, 2,
                          scan_for(log2c, 1, cu->intra_mode));
    }
}

static void inter_nocbf(est_t *e, int32_t x0, int32_t y0, int32_t log2,
                        const mi_t *mi, int skip) {
    int32_t n = 1 << log2;
    set_motion(e, x0, y0, n, mi, skip);
    mark_avail(e, x0, y0, n);
}

static void coding_unit(est_t *e, int32_t x0, int32_t y0, int32_t log2,
                        int32_t depth) {
    const emit_cfg_t *c = e->c;
    int32_t n = 1 << log2;
    set_depth(e, x0, y0, n, depth);

    plan_t plan;
    int use_intra = 1;
    if (c->slice_type != 2) {
        compute_plan(e, x0, y0, log2, &plan);
        int skip = plan.use_inter && plan.skip;
        int inc = 0;
        if (x0 > 0 && e->avail[(y0 >> 2) * e->w4 + ((x0 - 1) >> 2)])
            inc += e->skipm[(y0 >> 2) * e->w4 + ((x0 - 1) >> 2)];
        if (y0 > 0 && e->avail[((y0 - 1) >> 2) * e->w4 + (x0 >> 2)])
            inc += e->skipm[((y0 - 1) >> 2) * e->w4 + (x0 >> 2)];
        E_BIN(CB_CU_SKIP, inc, skip);
        if (skip) {
            emit_merge_idx(e, plan.merge_idx);
            inter_nocbf(e, x0, y0, log2, &plan.mlist[plan.merge_idx], 1);
            return;
        }
        E_BIN(CB_PRED_MODE, 0, !plan.use_inter);
        use_intra = !plan.use_inter;
        if (plan.use_inter) {
            /* inter coding unit, PART_2Nx2N */
            E_BIN(CB_PART_MODE, 0, 1);
            E_BIN(CB_MERGE_FLAG, 0, plan.merge_flag);
            mi_t mi;
            if (plan.merge_flag) {
                emit_merge_idx(e, plan.merge_idx);
                mi = plan.mlist[plan.merge_idx];
            } else {
                if (c->slice_type == 0) {
                    if (plan.idc == 2) {
                        E_BIN(CB_INTER_DIR, depth, 1);
                    } else {
                        E_BIN(CB_INTER_DIR, depth, 0);
                        E_BIN(CB_INTER_DIR, 4, plan.idc);
                    }
                }
                for (int lst = 0; lst < 2; lst++)
                    if (plan.idc == 2 || plan.idc == lst) {
                        emit_mvd(e, plan.mvd[lst]);
                        E_BIN(CB_MVP, 0, plan.mvp_idx[lst]);
                    }
                mi = plan.mi;
            }
            int root_cbf = plan.merge_flag ? 1 : plan.root_cbf;
            if (!plan.merge_flag)
                E_BIN(CB_RQT_ROOT, 0, plan.root_cbf);
            if (!root_cbf) {
                inter_nocbf(e, x0, y0, log2, &mi, 0);
                return;
            }
            set_motion(e, x0, y0, n, &mi, 0);
            mark_avail(e, x0, y0, n);
            cu_t cu = {x0, y0, log2, 1, -1};
            transform_tree(e, &cu, x0, y0, log2, 0, 1, 1);
            return;
        }
    }
    (void)use_intra;
    /* ---- intra CU, PART_2Nx2N (NxN never chosen on the fast path) ---- */
    if (log2 == 3)
        E_BIN(CB_PART_MODE, 0, 1);
    int32_t cand[3];
    mpm_list(e, x0, y0, cand);
    int32_t mode = e->b->mode8[(y0 >> 3) * c->nbx + (x0 >> 3)];
    int mpm_idx = -1;
    for (int i = 0; i < 3; i++)
        if (cand[i] == mode) {
            mpm_idx = i;
            break;
        }
    E_BIN(CB_PREV_INTRA, 0, mpm_idx >= 0);
    set_lmode(e, x0, y0, n, mode);
    if (mpm_idx >= 0) {
        if (mpm_idx == 0) {
            E_BYP(0);
        } else {
            E_BYP(1);
            E_BYP(mpm_idx - 1);
        }
    } else {
        E_BYPN(rem_from_mode(mode, cand), 5);
    }
    E_BIN(CB_INTRA_CHROMA, 0, 0);       /* DM */
    cu_t cu = {x0, y0, log2, 0, mode};
    transform_tree(e, &cu, x0, y0, log2, 0, 1, 1);
}

static void coding_quadtree(est_t *e, int32_t x0, int32_t y0, int32_t log2,
                            int32_t depth) {
    const emit_cfg_t *c = e->c;
    int32_t size = 1 << log2;
    int inside = x0 + size <= c->w && y0 + size <= c->h;
    int split;
    if (inside && log2 > 3) {
        split = e->b->cu8[(y0 >> 3) * c->nbx + (x0 >> 3)] < log2;
        int inc = 0;
        if (x0 > 0 && e->avail[(y0 >> 2) * e->w4 + ((x0 - 1) >> 2)])
            inc += e->depth4[(y0 >> 2) * e->w4 + ((x0 - 1) >> 2)] > depth;
        if (y0 > 0 && e->avail[((y0 - 1) >> 2) * e->w4 + (x0 >> 2)])
            inc += e->depth4[((y0 - 1) >> 2) * e->w4 + (x0 >> 2)] > depth;
        E_BIN(CB_SPLIT_CU, inc, split);
    } else {
        split = inside ? 0 : 1;
    }
    if (split) {
        int32_t half = size >> 1;
        static const int32_t off[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
        for (int i = 0; i < 4; i++) {
            int32_t x1 = x0 + off[i][0] * half, y1 = y0 + off[i][1] * half;
            if (x1 < c->w && y1 < c->h)
                coding_quadtree(e, x1, y1, log2 - 1, depth + 1);
        }
    } else {
        coding_unit(e, x0, y0, log2, depth);
    }
}

/* ------------------------------------------------------------------ SAO */

static int sao_eq(est_t *e, int32_t cy, int32_t cx, int32_t oy, int32_t ox) {
    /* SaoCtbParams equality: all of type/eo/band/offsets (core/sao.py) */
    const emit_cfg_t *c = e->c;
    const emit_bufs_t *b = e->b;
    int64_t i = (int64_t)cy * c->sao_nx + cx;
    int64_t j = (int64_t)oy * c->sao_nx + ox;
    for (int k = 0; k < 2; k++)
        if (b->sao_type[2 * i + k] != b->sao_type[2 * j + k]
                || b->sao_eo[2 * i + k] != b->sao_eo[2 * j + k])
            return 0;
    for (int k = 0; k < 3; k++)
        if (b->sao_bp[3 * i + k] != b->sao_bp[3 * j + k])
            return 0;
    for (int k = 0; k < 12; k++)
        if (b->sao_offs[12 * i + k] != b->sao_offs[12 * j + k])
            return 0;
    return 1;
}

static void emit_sao_ctb(est_t *e, int32_t cx, int32_t cy,
                         int left_ok, int up_ok) {
    const emit_cfg_t *c = e->c;
    const emit_bufs_t *b = e->b;
    int64_t i = (int64_t)cy * c->sao_nx + cx;
    if (left_ok) {
        int m = sao_eq(e, cy, cx, cy, cx - 1);
        E_BIN(CB_SAO_MERGE, 0, m);
        if (m)
            return;
    }
    if (up_ok) {
        int m = sao_eq(e, cy, cx, cy - 1, cx);
        E_BIN(CB_SAO_MERGE, 0, m);
        if (m)
            return;
    }
    int32_t cmax = (1 << ((c->bit_depth < 10 ? c->bit_depth : 10) - 5)) - 1;
    for (int comp = 0; comp < 3; comp++) {
        int c01 = comp < 1 ? comp : 1;
        int32_t t = b->sao_type[2 * i + c01];
        if (comp < 2) {
            E_BIN(CB_SAO_TYPE, 0, t ? 1 : 0);
            if (t)
                E_BYP(t - 1);
        }
        if (t == 0)
            continue;
        const int32_t *offs = b->sao_offs + 12 * i + 4 * comp;
        for (int k = 0; k < 4; k++) {
            int32_t v = offs[k] < 0 ? -offs[k] : offs[k];
            for (int32_t j = 0; j < v; j++)
                E_BYP(1);
            if (v < cmax)
                E_BYP(0);
        }
        if (t == 1) {           /* band */
            for (int k = 0; k < 4; k++)
                if (offs[k])
                    E_BYP(offs[k] < 0 ? 1 : 0);
            E_BYPN(b->sao_bp[3 * i + comp], 5);
        } else if (comp < 2) {  /* edge */
            E_BYPN(b->sao_eo[2 * i + c01], 2);
        }
    }
}

/* ------------------------------------------------------------ entry point */

int64_t frame_emit(const emit_cfg_t *cfg, const emit_bufs_t *bufs) {
    est_t e;
    memset(&e, 0, sizeof(e));
    e.c = cfg;
    e.b = bufs;
    e.w4 = cfg->w / 4;
    e.h4 = cfg->h / 4;
    bac_init(&e.bac, bufs->out, bufs->out_cap);

    size_t n4 = (size_t)e.w4 * e.h4;
    e.avail = (uint8_t *)calloc(n4, 1);
    e.lmode = (int16_t *)malloc(n4 * 2);
    e.depth4 = (uint8_t *)calloc(n4, 1);
    e.skipm = (uint8_t *)calloc(n4, 1);
    e.res_cap = 16 * 32 * 32 + 256;
    e.res_ops = (int32_t *)malloc((size_t)e.res_cap * 3 * 4);
    if (!e.avail || !e.lmode || !e.depth4 || !e.skipm || !e.res_ops) {
        e.err = -3;
        goto done;
    }
    memset(e.lmode, 0xFF, n4 * 2);       /* -1 everywhere */
    e.qp = cfg->slice_qp;
    e.prev_qp = cfg->slice_qp;

    int32_t ctb = 1 << cfg->ctb_log2;
    for (int32_t cy = cfg->ctb_y0; cy < cfg->ctb_y1; cy++) {
        for (int32_t cx = cfg->ctb_x0; cx < cfg->ctb_x1; cx++) {
            if (e.bac.pos + e.bac.num_buffered + (int64_t)(1 << 17)
                    > bufs->out_cap) {
                e.err = -4;
                goto done;
            }
            if (cfg->sao_enabled)
                emit_sao_ctb(&e, cx, cy, cx > cfg->ctb_x0,
                             cy > cfg->ctb_y0);
            /* qg_begin: QG == CTB (PictureState.qg_begin) */
            if (cfg->cu_qp_delta_enabled) {
                e.qg_pred = e.prev_qp;
                e.qg_coded = 0;
                e.qp = bufs->qp_map
                    ? bufs->qp_map[cy * cfg->qpm_nx + cx]
                    : e.qg_pred;
            }
            coding_quadtree(&e, cx * ctb, cy * ctb, cfg->ctb_log2, 0);
            if (cfg->cu_qp_delta_enabled) {
                int32_t fin = e.qg_coded ? e.qp : e.qg_pred;
                e.qp = fin;
                e.prev_qp = fin;
            }
            int last = cx == cfg->last_ctb_x && cy == cfg->last_ctb_y;
            encode_terminate(&e.bac, last ? 1 : 0);
            if (e.err)
                goto done;
        }
    }
    if (cfg->end_of_subset)
        encode_terminate(&e.bac, 1);     /* end_of_subset_one_bit */
    if (e.bac.pos + e.bac.num_buffered + 16 > bufs->out_cap) {
        e.err = -4;
        goto done;
    }
    bac_finish(&e.bac);

done:
    free(e.avail);
    free(e.lmode);
    free(e.depth4);
    free(e.skipm);
    free(e.res_ops);
    return e.err ? e.err : e.bac.pos;
}
