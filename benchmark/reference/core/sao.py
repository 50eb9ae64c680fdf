"""Sample Adaptive Offset (H.265 7.3.8.3 syntax, 8.7.3 filter).

Per-CTB parameters: off / band-offset (4 offsets at a signalled band
position) / edge-offset (4 offsets for one of 4 directional classes).
Classification always reads the *pre-SAO* (post-deblocking) picture;
application is picture-wide and vectorized.
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


def _decode_offset_abs(dec, cmax: int) -> int:
    v = 0
    while v < cmax and dec.decode_bypass():
        v += 1
    return v


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
