/* HEVC residual-coding bin-op generation (H.265 7.3.8.11 / 9.3) — native
 * production backend of svt_hevc_tpu/bitstream/residual.py encode_residual.
 *
 * Emits the recorder op stream (kind, a, v) for one TB's quantized
 * coefficients; the Python reference implementation stays the oracle
 * (equivalence is test-enforced, the analogue of the reference's
 * C_DEFAULT-vs-ASM asm_test). Reference analogue of the syntax itself:
 * EbEntropyCoding.c EncodeQuantizedCoefficients_generic :1172.
 *
 * Op kinds match bitstream/recorder.py: 0 = context bin (a = ctxIdx),
 * 1 = bypass bin, 2 = bypass bins (a = nbits, v = value), 3 = terminate.
 */

#include <stdint.h>
#include <string.h>

#define KIND_BIN 0
#define KIND_BYPASS 1
#define KIND_BYPASS_BINS 2

#define SCAN_DIAG 0
#define SCAN_HOR 1
#define SCAN_VER 2

/* spec 9.3.4.2.5: ctxIdxMap for 4x4 sig_coeff_flag */
static const int CTX_IDX_MAP_4X4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                        6, 6, 8, 8, 7, 7, 8, 8};
/* spec 9.3.3.1 Table 9-48 helpers */
static const int MIN_IN_GROUP[10] = {0, 1, 2, 3, 4, 6, 8, 12, 16, 24};

static int group_idx(int k) {
    if (k < 4) return k;
    int bl = 0, t = k;
    while (t) { bl++; t >>= 1; }          /* bit_length */
    return 2 * (bl - 1) + ((k >> (bl - 2)) & 1);
}

/* ---- scan tables: scanPos -> (x, y), built on first use ---- */
typedef struct { int32_t x[1024], y[1024]; } ScanTab;
static ScanTab scans[4][3];               /* [log2-2][scan_idx] */
static int scans_ready = 0;

static void diag_scan(int n, int32_t *xs, int32_t *ys) {
    int cnt = 0, x = 0, y = 0;
    while (cnt < n * n) {
        while (y >= 0) {
            if (x < n && y < n) { xs[cnt] = x; ys[cnt] = y; cnt++; }
            y--; x++;
        }
        y = x; x = 0;
    }
}

static void base_scan(int n, int scan_idx, int32_t *xs, int32_t *ys) {
    if (scan_idx == SCAN_DIAG) { diag_scan(n, xs, ys); return; }
    int cnt = 0;
    if (scan_idx == SCAN_HOR) {
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++) { xs[cnt] = x; ys[cnt] = y; cnt++; }
    } else {
        for (int x = 0; x < n; x++)
            for (int y = 0; y < n; y++) { xs[cnt] = x; ys[cnt] = y; cnt++; }
    }
}

static void init_scans(void) {
    int32_t in_x[16], in_y[16], sb_x[64], sb_y[64];
    for (int lg = 2; lg <= 5; lg++) {
        for (int si = 0; si < 3; si++) {
            ScanTab *t = &scans[lg - 2][si];
            base_scan(4, si, in_x, in_y);
            if (lg == 2) {
                memcpy(t->x, in_x, sizeof(in_x));
                memcpy(t->y, in_y, sizeof(in_y));
                continue;
            }
            int sbn = 1 << (lg - 2);
            base_scan(sbn, si, sb_x, sb_y);
            for (int s = 0; s < sbn * sbn; s++)
                for (int i = 0; i < 16; i++) {
                    t->x[16 * s + i] = 4 * sb_x[s] + in_x[i];
                    t->y[16 * s + i] = 4 * sb_y[s] + in_y[i];
                }
        }
    }
    scans_ready = 1;
}

/* ---- ctx derivations (mirror residual.py) ---- */

static void last_ctx_params(int log2, int c_idx, int *off, int *shift) {
    if (c_idx == 0) {
        *off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
        *shift = (log2 + 1) >> 2;
    } else {
        *off = 15;
        *shift = log2 - 2;
    }
}

static int sig_ctx(int xc, int yc, int log2, int c_idx, int scan_idx,
                   int prev_csbf) {
    int sig;
    if (log2 == 2) {
        sig = CTX_IDX_MAP_4X4[(yc << 2) + xc];
    } else if (xc + yc == 0) {
        sig = 0;
    } else {
        int xs = xc >> 2, ys = yc >> 2, xp = xc & 3, yp = yc & 3;
        if (prev_csbf == 0)
            sig = (xp + yp == 0) ? 2 : (xp + yp < 3 ? 1 : 0);
        else if (prev_csbf == 1)
            sig = (yp == 0) ? 2 : (yp == 1 ? 1 : 0);
        else if (prev_csbf == 2)
            sig = (xp == 0) ? 2 : (xp == 1 ? 1 : 0);
        else
            sig = 2;
        if (c_idx == 0 && (xs + ys) > 0) sig += 3;
        if (log2 == 3)
            sig += (scan_idx == SCAN_DIAG || c_idx != 0) ? 9 : 15;
        else
            sig += (c_idx == 0) ? 21 : 12;
    }
    return (c_idx == 0) ? sig : 27 + sig;
}

/* ---- op emission ---- */

typedef struct { int32_t *buf; int64_t cap, n; } Ops;

static int put(Ops *o, int kind, int a, int v) {
    if (o->n >= o->cap) return -1;
    o->buf[3 * o->n] = kind;
    o->buf[3 * o->n + 1] = a;
    o->buf[3 * o->n + 2] = v;
    o->n++;
    return 0;
}

#define BIN(ctx, v) do { if (put(o, KIND_BIN, (ctx), (v))) return -1; } while (0)
#define BYP(v) do { if (put(o, KIND_BYPASS, 0, (v))) return -1; } while (0)

static int byp_bins(Ops *o, int64_t value, int nbits) {
    while (nbits > 24) {                  /* match recorder splitting */
        nbits -= 24;
        if (put(o, KIND_BYPASS_BINS, 24, (int32_t)((value >> nbits) & 0xFFFFFF)))
            return -1;
        value &= ((int64_t)1 << nbits) - 1;
    }
    if (nbits)
        if (put(o, KIND_BYPASS_BINS, nbits, (int32_t)value)) return -1;
    return 0;
}

#define BYPN(v, n) do { if (byp_bins(o, (v), (n))) return -1; } while (0)

static int encode_last_xy(Ops *o, int lx, int ly, int log2, int c_idx,
                          int base_last_x, int base_last_y) {
    int off, shift;
    last_ctx_params(log2, c_idx, &off, &shift);
    int cmax = (log2 << 1) - 1;
    const int coords[2] = {lx, ly};
    const int bases[2] = {base_last_x, base_last_y};
    for (int i = 0; i < 2; i++) {
        int prefix = group_idx(coords[i]);
        int lim = prefix < cmax ? prefix : cmax;
        for (int j = 0; j < lim; j++)
            BIN(bases[i] + off + (j >> shift), 1);
        if (prefix < cmax)
            BIN(bases[i] + off + (prefix >> shift), 0);
    }
    for (int i = 0; i < 2; i++) {
        int prefix = group_idx(coords[i]);
        if (prefix > 3) {
            int nbits = (prefix >> 1) - 1;
            BYPN(coords[i] - MIN_IN_GROUP[prefix], nbits);
        }
    }
    return 0;
}

static int encode_remaining(Ops *o, int64_t value, int rice) {
    if (value < ((int64_t)3 << rice)) {
        int length = (int)(value >> rice);
        BYPN(((int64_t)1 << (length + 1)) - 2, length + 1);
        if (rice) BYPN(value & ((1 << rice) - 1), rice);
    } else {
        int length = rice;
        value -= (int64_t)3 << rice;
        while (value >= ((int64_t)1 << length)) {
            value -= (int64_t)1 << length;
            length++;
        }
        int n_ones = 3 + length + 1 - rice;
        BYPN(((int64_t)1 << n_ones) - 2, n_ones);
        if (length) BYPN(value, length);
    }
    return 0;
}

/* coeffs: n*n int32 row-major [y][x], nonzero somewhere.
 * bases: [LAST_X, LAST_Y, SIG_GROUP, SIG, GT1, GT2] ctx offsets.
 * Returns op count written to ops_out (triples), or -1 on overflow. */
int64_t residual_ops(const int32_t *coeffs, int32_t n, int32_t c_idx,
                     int32_t scan_idx, const int32_t *bases,
                     int32_t *ops_out, int64_t cap) {
    if (!scans_ready) init_scans();
    int log2 = 0;
    while ((1 << log2) < n) log2++;
    const ScanTab *sc = &scans[log2 - 2][scan_idx];
    const int base_last_x = bases[0], base_last_y = bases[1];
    const int base_sig_group = bases[2], base_sig = bases[3];
    const int base_gt1 = bases[4], base_gt2 = bases[5];

    Ops ops_s = {ops_out, cap, 0};
    Ops *o = &ops_s;

    int64_t vals[1024];
    int total = n * n, last = -1;
    for (int i = 0; i < total; i++) {
        vals[i] = coeffs[sc->y[i] * n + sc->x[i]];
        if (vals[i]) last = i;
    }
    if (last < 0) return -2;              /* caller guarantees nonzero */

    int lx = sc->x[last], ly = sc->y[last];
    if (scan_idx == SCAN_VER) { int t = lx; lx = ly; ly = t; }
    if (encode_last_xy(o, lx, ly, log2, c_idx, base_last_x, base_last_y))
        return -1;

    int last_sb = last >> 4;
    int sb_w = n >= 4 ? (n >> 2) : 1;
    int32_t csbf[64];
    memset(csbf, 0, sizeof(csbf));

    int c1 = 1;
    for (int sb = last_sb; sb >= 0; sb--) {
        int sb_pos = 16 * sb;
        int sxc = sc->x[sb_pos] >> 2;
        int syc = sc->y[sb_pos] >> 2;
        int right = (sxc + 1 < sb_w) ? csbf[syc * sb_w + sxc + 1] : 0;
        int below = (syc + 1 < sb_w) ? csbf[(syc + 1) * sb_w + sxc] : 0;
        int prev_csbf = right + 2 * below;

        int sb_nonzero = 0;
        for (int i = 0; i < 16; i++)
            if (vals[sb_pos + i]) { sb_nonzero = 1; break; }

        int explicit_csbf = (sb != 0 && sb != last_sb);
        if (explicit_csbf) {
            int rb = right + below;
            BIN(base_sig_group + (rb < 1 ? rb : 1) + (c_idx == 0 ? 0 : 2),
                sb_nonzero);
            csbf[syc * sb_w + sxc] = sb_nonzero;
            if (!sb_nonzero) continue;
        } else {
            csbf[syc * sb_w + sxc] = 1;
        }

        /* significance map (reverse scan) */
        int sig_pos[16], num = 0;
        int start = (sb == last_sb) ? last - 1 : sb_pos + 15;
        if (sb == last_sb) sig_pos[num++] = last;
        for (int sp = start; sp >= sb_pos; sp--) {
            int is_sig = vals[sp] != 0;
            if (sp == sb_pos && explicit_csbf && num == 0) {
                sig_pos[num++] = sp;      /* inferSbDcSigCoeffFlag */
                continue;
            }
            int xc = sc->x[sp], yc = sc->y[sp];
            BIN(base_sig + sig_ctx(xc, yc, log2, c_idx, scan_idx, prev_csbf),
                is_sig);
            if (is_sig) sig_pos[num++] = sp;
        }

        /* level coding */
        int64_t abs_vals[16];
        int signs[16];
        for (int i = 0; i < num; i++) {
            int64_t v = vals[sig_pos[i]];
            abs_vals[i] = v < 0 ? -v : v;
            signs[i] = v < 0;
        }
        int ctx_set = (sb > 0 && c_idx == 0) ? 2 : 0;
        if (c1 == 0) ctx_set += 1;
        c1 = 1;
        int gt1_base = (c_idx == 0) ? base_gt1 + 4 * ctx_set
                                    : base_gt1 + 16 + 4 * ctx_set;
        int num_c1 = num < 8 ? num : 8;
        int first_c2 = -1;
        for (int i = 0; i < num_c1; i++) {
            int sym = abs_vals[i] > 1;
            BIN(gt1_base + c1, sym);
            if (sym) {
                c1 = 0;
                if (first_c2 == -1) first_c2 = i;
            } else if (c1 > 0 && c1 < 3) {
                c1++;
            }
        }
        if (first_c2 != -1) {
            int gt2_ctx = (c_idx == 0) ? base_gt2 + ctx_set
                                       : base_gt2 + 4 + ctx_set;
            BIN(gt2_ctx, abs_vals[first_c2] > 2);
        }
        for (int i = 0; i < num; i++) BYP(signs[i]);

        int rice = 0, first_coeff2 = 1;
        for (int i = 0; i < num; i++) {
            int cap_v = (i >= 8) ? 1 : (i == first_c2 ? 3 : 2);
            int64_t flag_val = abs_vals[i] < cap_v ? abs_vals[i] : cap_v;
            int escape = (i < 8) ? (2 + first_coeff2) : 1;
            if (flag_val == escape)
                if (encode_remaining(o, abs_vals[i] - escape, rice))
                    return -1;
            if (abs_vals[i] >= 2) first_coeff2 = 0;
            if (abs_vals[i] > ((int64_t)3 << rice))
                rice = rice < 4 ? rice + 1 : 4;
        }
    }
    return ops_s.n;
}
