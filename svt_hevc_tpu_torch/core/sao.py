"""Sample Adaptive Offset (H.265 7.3.8.3 syntax, 8.7.3 filter).

Per-CTB parameters: off / band-offset (4 offsets at a signalled band
position) / edge-offset (4 offsets for one of 4 directional classes).
Classification always reads the *pre-SAO* (post-deblocking) picture;
application is picture-wide and vectorized.

Encoder strategy (two-pass per frame, see pipeline/encoder.py): after the
reconstruction + deblocking of the whole picture, derive per-CTB stats for
all 4 EO classes and BO in one vectorized sweep, pick the
distortion-optimal type/offsets per CTB, then emit the final CABAC stream
with the SAO syntax interleaved. Analogue of reference
EbSampleAdaptiveOffsetGenerationDecision.c (SaoGenerationDecision :647)
with the stats gathering batched picture-wide instead of per-LCU.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream.contexts import Ctx

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2


# SAO rate-estimate weight: the simple 4+sum(|o|+1) bit model
# underestimates the real CABAC cost of SAO parameters (measured vs the
# reference encoder's SAO spend at CIF M7: ~3x ours per CTB), so the
# decision charges it scaled — calibrated by BD sweep
SAO_RATE_SCALE = 2


def _max_offset(bit_depth: int) -> int:
    """(1 << (min(bd,10)-5)) - 1: 7 at 8-bit, 31 at 10-bit (7.4.9.3)."""
    return (1 << (min(bit_depth, 10) - 5)) - 1

# EO class -> ((h0x, h0y), (h1x, h1y))
_EO_CAT_LUT = np.array([1, 2, 0, 3, 4], np.int32)

_EO_NEIGHBORS = (((-1, 0), (1, 0)), ((0, -1), (0, 1)),
                 ((-1, -1), (1, 1)), ((1, -1), (-1, 1)))


@dataclass
class SaoCtbParams:
    """Parameters of one CTB. Luma = component 0; chroma shares type and
    eo_class between cb (1) and cr (2) but has its own offsets/band pos."""
    type_idx: list[int] = field(default_factory=lambda: [0, 0])    # [luma, chroma]
    eo_class: list[int] = field(default_factory=lambda: [0, 0])
    band_pos: list[int] = field(default_factory=lambda: [0, 0, 0])  # per comp
    offsets: list[list[int]] = field(
        default_factory=lambda: [[0, 0, 0, 0] for _ in range(3)])   # per comp

    def copy(self) -> "SaoCtbParams":
        return SaoCtbParams([*self.type_idx], [*self.eo_class],
                            [*self.band_pos], [list(o) for o in self.offsets])

    def __eq__(self, other) -> bool:
        return (self.type_idx == other.type_idx
                and self.eo_class == other.eo_class
                and self.band_pos == other.band_pos
                and self.offsets == other.offsets)


# ------------------------------------------------------------------- syntax

def _encode_offset_abs(bac, v: int, cmax: int) -> None:
    for _ in range(v):
        bac.encode_bypass(1)
    if v < cmax:
        bac.encode_bypass(0)


def _decode_offset_abs(dec, cmax: int) -> int:
    v = 0
    while v < cmax and dec.decode_bypass():
        v += 1
    return v


def encode_sao_ctb(bac, grid: list[list[SaoCtbParams]], cx: int, cy: int,
                   slice_sao_luma: bool, slice_sao_chroma: bool,
                   bit_depth: int = 8, left_ok: bool | None = None,
                   up_ok: bool | None = None) -> None:
    # merge candidates must lie in the same tile (7.4.9.3)
    left_ok = (cx > 0) if left_ok is None else left_ok
    up_ok = (cy > 0) if up_ok is None else up_ok
    p = grid[cy][cx]
    if left_ok:
        merge_left = int(p == grid[cy][cx - 1])
        bac.encode_bin(Ctx.SAO_MERGE, merge_left)
        if merge_left:
            return
    if up_ok:
        merge_up = int(p == grid[cy - 1][cx])
        bac.encode_bin(Ctx.SAO_MERGE, merge_up)
        if merge_up:
            return
    for comp in range(3):
        if comp == 0 and not slice_sao_luma:
            continue
        if comp > 0 and not slice_sao_chroma:
            continue
        c01 = min(comp, 1)
        if comp < 2:   # type signalled for luma and once for chroma
            t = p.type_idx[c01]
            bac.encode_bin(Ctx.SAO_TYPE, 1 if t else 0)
            if t:
                bac.encode_bypass(t - 1)
        t = p.type_idx[c01]
        if t == SAO_OFF:
            continue
        offs = p.offsets[comp]
        for i in range(4):
            _encode_offset_abs(bac, abs(offs[i]), _max_offset(bit_depth))
        if t == SAO_BAND:
            for i in range(4):
                if offs[i]:
                    bac.encode_bypass(1 if offs[i] < 0 else 0)
            bac.encode_bypass_bins(p.band_pos[comp], 5)
        elif comp < 2:
            bac.encode_bypass_bins(p.eo_class[c01], 2)


def decode_sao_ctb(dec, grid: list[list[SaoCtbParams]], cx: int, cy: int,
                   slice_sao_luma: bool, slice_sao_chroma: bool,
                   bit_depth: int = 8, left_ok: bool | None = None,
                   up_ok: bool | None = None) -> None:
    left_ok = (cx > 0) if left_ok is None else left_ok
    up_ok = (cy > 0) if up_ok is None else up_ok
    if left_ok and dec.decode_bin(Ctx.SAO_MERGE):
        grid[cy][cx] = grid[cy][cx - 1].copy()
        return
    if up_ok and dec.decode_bin(Ctx.SAO_MERGE):
        grid[cy][cx] = grid[cy - 1][cx].copy()
        return
    p = grid[cy][cx]
    for comp in range(3):
        if comp == 0 and not slice_sao_luma:
            continue
        if comp > 0 and not slice_sao_chroma:
            continue
        c01 = min(comp, 1)
        if comp < 2:
            t = 0
            if dec.decode_bin(Ctx.SAO_TYPE):
                t = 1 + dec.decode_bypass()
            p.type_idx[c01] = t
        t = p.type_idx[c01]
        if t == SAO_OFF:
            continue
        mag = [_decode_offset_abs(dec, _max_offset(bit_depth))
               for _ in range(4)]
        if t == SAO_BAND:
            offs = []
            for i in range(4):
                if mag[i] and dec.decode_bypass():
                    offs.append(-mag[i])
                else:
                    offs.append(mag[i])
            p.offsets[comp] = offs
            p.band_pos[comp] = dec.decode_bypass_bins(5)
        else:
            # EO signs are fixed: categories 1,2 positive; 3,4 negative
            p.offsets[comp] = [mag[0], mag[1], -mag[2], -mag[3]]
            if comp < 2:
                p.eo_class[c01] = dec.decode_bypass_bins(2)


# ------------------------------------------------------- classification/apply

def _eo_category_map(plane: np.ndarray, eo_class: int,
                     tile_edges: tuple | None = None) -> np.ndarray:
    """Category (0..4; 0 = no offset) per pixel; border pixels whose
    neighbor lies outside the picture — or across a tile boundary when
    loop_filter_across_tiles is off (8.7.3) — get category 0."""
    h, w = plane.shape
    (ax, ay), (bx, by) = _EO_NEIGHBORS[eo_class]
    pad = np.pad(plane, 1, mode="edge").astype(np.int32)
    c = pad[1:-1, 1:-1]
    na = pad[1 + ay:h + 1 + ay, 1 + ax:w + 1 + ax]
    nb = pad[1 + by:h + 1 + by, 1 + bx:w + 1 + bx]
    edge_idx = 2 + np.sign(c - na) + np.sign(c - nb)
    # map raw 0,1,2,3,4 -> category 1,2,0,3,4
    cat = _EO_CAT_LUT[edge_idx]
    # invalidate pixels with out-of-picture neighbors
    valid = np.ones((h, w), bool)
    horiz = ax != 0 or bx != 0
    vert = ay != 0 or by != 0
    if horiz:
        valid[:, :1] = False
        valid[:, -1:] = False
    if vert:
        valid[:1, :] = False
        valid[-1:, :] = False
    if tile_edges is not None:
        ex, ey = tile_edges
        if horiz:
            for x in ex:                       # neighbor across vertical edge
                valid[:, max(x - 1, 0):x + 1] = False
        if vert:
            for y in ey:
                valid[max(y - 1, 0):y + 1, :] = False
    return np.where(valid, cat, 0)


def _tile_edges_for(st, comp: int) -> tuple | None:
    if st.filter_across_tiles or not (st.tile_edges_x or st.tile_edges_y):
        return None
    sx = st.ss_x if comp else 0
    sy = st.ss_y if comp else 0
    return ([x >> sx for x in st.tile_edges_x],
            [y >> sy for y in st.tile_edges_y])


def _band_map(plane: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    return (plane >> (bit_depth - 5)).astype(np.int32)   # 32 bands


def apply_sao(st, grid: list[list[SaoCtbParams]],
              slice_sao_luma: bool, slice_sao_chroma: bool) -> None:
    """Apply SAO in place, vectorized over the whole plane: per-CTB
    offset LUTs are gathered through the classification maps in one pass
    (classification on the pre-SAO copies, 8.7.3)."""
    ctb = 1 << st.ctb_log2
    ny, nx = len(grid), len(grid[0])
    maxval = (1 << st.bit_depth) - 1
    for comp in range(3):
        if comp == 0 and not slice_sao_luma:
            continue
        if comp > 0 and not slice_sao_chroma:
            continue
        c01 = min(comp, 1)
        plane = st.planes[comp]
        h, w = plane.shape
        csx = ctb if comp == 0 else ctb >> st.ss_x
        csy = ctb if comp == 0 else ctb >> st.ss_y
        tmap = np.array([[p.type_idx[c01] for p in row] for row in grid],
                        np.int32)
        if not (tmap != SAO_OFF).any():
            continue
        pre = plane.copy()
        cyi = (np.arange(h) // csy)[:, None]     # per-pixel CTB row
        cxi = (np.arange(w) // csx)[None, :]
        offset_plane = np.zeros((h, w), np.int32)

        if (tmap == SAO_EDGE).any():
            emap = np.array([[p.eo_class[c01] for p in row] for row in grid],
                            np.int32)
            for ec in range(4):
                sel = (tmap == SAO_EDGE) & (emap == ec)
                if not sel.any():
                    continue
                lut = np.zeros((ny, nx, 5), np.int32)
                for cy, cx in zip(*np.nonzero(sel)):
                    lut[cy, cx, 1:] = grid[cy][cx].offsets[comp]
                cat = _eo_category_map(pre, ec, _tile_edges_for(st, comp))
                offset_plane += lut[cyi, cxi, cat]

        if (tmap == SAO_BAND).any():
            lut = np.zeros((ny, nx, 32), np.int32)
            for cy, cx in zip(*np.nonzero(tmap == SAO_BAND)):
                p = grid[cy][cx]
                for i in range(4):
                    lut[cy, cx, (p.band_pos[comp] + i) % 32] = \
                        p.offsets[comp][i]
            band = _band_map(pre, st.bit_depth)
            offset_plane += lut[cyi, cxi, band]

        plane[:, :] = np.clip(pre + offset_plane, 0, maxval)


# ------------------------------------------------------------ encoder choice

def derive_sao_params(st, src, lam: float) -> list[list[SaoCtbParams]]:
    """Distortion-optimal per-CTB SAO decision from (source, post-DLF
    recon). Offset = clip(round(sum/count)); type chosen by the SSE delta
    c*o^2 - 2*o*s with a small lambda rate charge."""
    ctb = 1 << st.ctb_log2
    ny = (st.h + ctb - 1) // ctb
    nx = (st.w + ctb - 1) // ctb
    grid = [[SaoCtbParams() for _ in range(nx)] for _ in range(ny)]

    for comp in range(3):
        c01 = min(comp, 1)
        plane = st.planes[comp]
        source = src[comp]
        csx = ctb if comp == 0 else ctb >> st.ss_x
        csy = ctb if comp == 0 else ctb >> st.ss_y
        diff = source.astype(np.int64) - plane.astype(np.int64)
        cat_maps = [_eo_category_map(plane, ec, _tile_edges_for(st, comp))
                    for ec in range(4)]
        band = _band_map(plane, st.bit_depth)
        mx = _max_offset(st.bit_depth)

        for cy in range(ny):
            for cx in range(nx):
                y0, x0 = cy * csy, cx * csx
                y1 = min(y0 + csy, plane.shape[0])
                x1 = min(x0 + csx, plane.shape[1])
                d = diff[y0:y1, x0:x1]
                p = grid[cy][cx]

                if comp == 2:
                    # cr shares the chroma type / eo class chosen for cb;
                    # only its offsets (and band position) are free
                    t = p.type_idx[1]
                    if t == SAO_OFF:
                        continue
                    if t == SAO_EDGE:
                        cat = cat_maps[p.eo_class[1]][y0:y1, x0:x1]
                        offs = [0, 0, 0, 0]
                        for k in range(1, 5):
                            m = cat == k
                            c = int(m.sum())
                            if c == 0:
                                continue
                            s = int(d[m].sum())
                            o = int(np.clip(round(s / c), -mx, mx))
                            o = max(o, 0) if k <= 2 else min(o, 0)
                            if 2 * o * s - c * o * o > 0:
                                offs[k - 1] = o
                        p.offsets[2] = offs
                    else:
                        bp, offs, g = _best_band(band[y0:y1, x0:x1], d, lam, mx)
                        if g > 0 and any(offs):
                            p.band_pos[2] = bp
                            p.offsets[2] = offs
                    continue

                best = (0.0, SAO_OFF, 0, 0, [0, 0, 0, 0])   # (gain, type, eo, bp, offs)
                for ec in range(4):
                    cat = cat_maps[ec][y0:y1, x0:x1]
                    gain = 0.0
                    offs = [0, 0, 0, 0]
                    for k in range(1, 5):
                        m = cat == k
                        c = int(m.sum())
                        if c == 0:
                            continue
                        s = int(d[m].sum())
                        o = int(np.clip(round(s / c), -mx, mx))
                        if k <= 2:
                            o = max(o, 0)     # EO categories 1,2: positive
                        else:
                            o = min(o, 0)
                        g = 2 * o * s - c * o * o   # SSE reduction
                        if g > 0:
                            offs[k - 1] = o
                            gain += g
                    rate = SAO_RATE_SCALE * (4 + sum(abs(o) + 1
                                                     for o in offs))
                    gain -= lam * rate
                    if gain > best[0]:
                        best = (gain, SAO_EDGE, ec, 0, offs)

                # band offset: best run of 4 adjacent bands
                bp, offs, g = _best_band(band[y0:y1, x0:x1], d, lam, mx)
                if g > best[0] and any(offs):
                    best = (g, SAO_BAND, 0, bp, offs)

                if best[1] == SAO_OFF:
                    continue
                p.type_idx[c01] = best[1]
                p.eo_class[c01] = best[2]
                p.band_pos[comp] = best[3]
                p.offsets[comp] = list(best[4])
    return grid


def _best_band(b: np.ndarray, d: np.ndarray, lam: float, mx: int = 7):
    """Best 4-band window for band offset; returns (band_pos, offsets, gain)."""
    cnt = np.bincount(b.ravel(), minlength=32).astype(np.int64)
    sums = np.bincount(b.ravel(), weights=d.ravel(),
                       minlength=32).astype(np.int64)
    ob = np.zeros(32, np.int64)
    nz = cnt > 0
    ob[nz] = np.clip(np.round(sums[nz] / cnt[nz]), -mx, mx)
    gains = np.maximum(np.where(ob != 0, 2 * ob * sums - cnt * ob * ob, 0), 0)
    win = np.array([gains[k:k + 4].sum() for k in range(29)])
    bp = int(np.argmax(win))
    offs = [int(ob[bp + i]) if gains[bp + i] > 0 else 0 for i in range(4)]
    g = float(win[bp]) - lam * SAO_RATE_SCALE * (9 + sum(abs(o) + 1
                                                         for o in offs))
    return bp, offs, g


def _best_band_stats(cnt: np.ndarray, sums: np.ndarray, lam: float,
                     mx: int = 7):
    """_best_band from precomputed per-band (count, diff-sum) stats."""
    ob = np.zeros(32, np.int64)
    nz = cnt > 0
    ob[nz] = np.clip(np.round(sums[nz] / cnt[nz]), -mx, mx)
    gains = np.maximum(np.where(ob != 0, 2 * ob * sums - cnt * ob * ob, 0), 0)
    win = np.array([gains[k:k + 4].sum() for k in range(29)])
    bp = int(np.argmax(win))
    offs = [int(ob[bp + i]) if gains[bp + i] > 0 else 0 for i in range(4)]
    g = float(win[bp]) - lam * SAO_RATE_SCALE * (9 + sum(abs(o) + 1
                                                         for o in offs))
    return bp, offs, g


def _eo_offsets_gains(eo_cnt, eo_sum, mx):
    """Vectorized per-(ctb, eo-class) EO offsets + per-class gains.

    eo_cnt/eo_sum: (ny, nx, 4, 5) int64. Returns (offs (ny,nx,4,4) int64,
    gain (ny,nx,4) float64) — offsets zeroed where their SSE gain <= 0,
    identical math to the scalar per-CTB loop."""
    c = eo_cnt[..., 1:5]
    s = eo_sum[..., 1:5]
    nz = c > 0
    o = np.where(nz, np.clip(np.round(s / np.maximum(c, 1)), -mx, mx), 0)
    o = o.astype(np.int64)
    # categories 1,2 positive; 3,4 negative
    o[..., 0:2] = np.maximum(o[..., 0:2], 0)
    o[..., 2:4] = np.minimum(o[..., 2:4], 0)
    g = 2 * o * s - c * o * o
    keep = g > 0
    offs = np.where(keep, o, 0)
    gain = np.where(keep, g, 0).sum(-1).astype(np.float64)
    return offs, gain


def _bo_offsets_gains(bo_cnt, bo_sum, lam, mx):
    """Vectorized _best_band_stats over the CTB grid. bo_cnt/bo_sum:
    (ny, nx, 32) int64. Returns (bp (ny,nx), offs (ny,nx,4), gain)."""
    nz = bo_cnt > 0
    ob = np.where(nz, np.clip(np.round(bo_sum / np.maximum(bo_cnt, 1)),
                              -mx, mx), 0).astype(np.int64)
    gains = np.maximum(np.where(ob != 0, 2 * ob * bo_sum - bo_cnt * ob * ob,
                                0), 0)
    # sliding window of 4 adjacent bands, start positions 0..28
    win = np.stack([gains[..., k:k + 4].sum(-1) for k in range(29)], -1)
    bp = win.argmax(-1)
    iy, ix = np.indices(bp.shape)
    offs = np.stack([np.where(gains[iy, ix, bp + i] > 0,
                              ob[iy, ix, bp + i], 0) for i in range(4)], -1)
    g = (np.take_along_axis(win, bp[..., None], -1)[..., 0]
         .astype(np.float32)
         - np.float32(lam) * np.float32(SAO_RATE_SCALE)
         * (9 + (np.abs(offs) + 1).sum(-1)).astype(np.float32))
    return bp, offs, g


def derive_sao_params_from_stats(st, stats, lam: float):
    """derive_sao_params with the per-CTB statistics precomputed on the
    TPU (tpu.encode.sao_stats_plane): identical decision math, fully
    vectorized over the CTB grid. stats: per-component dicts with
    eo_cnt/eo_sum (ny, nx, 4, 5) and bo_cnt/bo_sum (ny, nx, 32)."""
    ctb = 1 << st.ctb_log2
    ny = (st.h + ctb - 1) // ctb
    nx = (st.w + ctb - 1) // ctb
    grid = [[SaoCtbParams() for _ in range(nx)] for _ in range(ny)]
    mx = _max_offset(st.bit_depth)

    cb_type = None      # decisions comp 1 reuses for comp 2
    cb_eo = None
    for comp in range(3):
        c01 = min(comp, 1)
        eo_cnt = stats[comp]["eo_cnt"].astype(np.int64)
        eo_sum = stats[comp]["eo_sum"].astype(np.int64)
        bo_cnt = stats[comp]["bo_cnt"].astype(np.int64)
        bo_sum = stats[comp]["bo_sum"].astype(np.int64)

        eo_offs, eo_gain = _eo_offsets_gains(eo_cnt, eo_sum, mx)
        eo_rate = SAO_RATE_SCALE * (4 + (np.abs(eo_offs) + 1).sum(-1))
        eo_score = (eo_gain.astype(np.float32)
                    - np.float32(lam) * eo_rate.astype(np.float32))
        bo_bp, bo_offs, bo_score = _bo_offsets_gains(bo_cnt, bo_sum, lam, mx)
        bo_valid = (bo_score > 0) & bo_offs.any(-1)

        if comp == 2:
            # cr shares the chroma type / eo class chosen for cb; only its
            # offsets (and band position) are free
            for cy, cx in zip(*np.nonzero(cb_type != SAO_OFF)):
                p = grid[cy][cx]
                if cb_type[cy, cx] == SAO_EDGE:
                    ec = cb_eo[cy, cx]
                    p.offsets[2] = [int(v) for v in eo_offs[cy, cx, ec]]
                elif bo_valid[cy, cx]:
                    p.band_pos[2] = int(bo_bp[cy, cx])
                    p.offsets[2] = [int(v) for v in bo_offs[cy, cx]]
            continue

        best_ec = eo_score.argmax(-1)
        best_eo_score = np.take_along_axis(eo_score, best_ec[..., None],
                                           -1)[..., 0]
        use_bo = bo_valid & (bo_score > np.maximum(best_eo_score, 0.0))
        use_eo = ~use_bo & (best_eo_score > 0.0)
        type_map = np.where(use_bo, SAO_BAND,
                            np.where(use_eo, SAO_EDGE, SAO_OFF))
        if comp == 1:
            cb_type, cb_eo = type_map, best_ec
        for cy, cx in zip(*np.nonzero(type_map != SAO_OFF)):
            p = grid[cy][cx]
            p.type_idx[c01] = int(type_map[cy, cx])
            if type_map[cy, cx] == SAO_EDGE:
                ec = int(best_ec[cy, cx])
                p.eo_class[c01] = ec
                p.offsets[comp] = [int(v) for v in eo_offs[cy, cx, ec]]
            else:
                p.band_pos[comp] = int(bo_bp[cy, cx])
                p.offsets[comp] = [int(v) for v in bo_offs[cy, cx]]
    return grid
