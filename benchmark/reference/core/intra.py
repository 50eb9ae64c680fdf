"""HEVC intra prediction (H.265 8.4.4.2) — numpy normative backend.

Reference sample generation + substitution (8.4.4.2.2), mode-dependent
smoothing filter (8.4.4.2.3), and the 35 prediction modes: planar (8.4.4.2.4),
DC (8.4.4.2.5), angular 2..34 (8.4.4.2.6) with the normative luma boundary
filters for DC / pure-horizontal / pure-vertical.

Shared by the encoder's encode pass and the conformance decoder so the
reconstruction loop is a single implementation. The TPU open-loop search
(svt_hevc_tpu.tpu.intra_search) runs the same arithmetic batched over all
blocks; this module is the scalar ground truth it is tested against.

Analogue of reference Source/Lib/Codec/EbIntraPrediction.c (reference sample
gen :212/:748, modes :3180-3487) re-designed as vectorized numpy.
"""

from __future__ import annotations

import numpy as np

PLANAR = 0
DC = 1
HORIZONTAL = 10
VERTICAL = 26

# spec 8.4.4.2.6 Table 8-4/8-5: intraPredAngle & invAngle per mode
INTRA_PRED_ANGLE = {
    m: a for m, a in zip(
        range(2, 35),
        [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
         -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32])
}
INV_ANGLE = {
    m: ia for m, ia in zip(
        range(11, 26),
        [-4096, -1638, -910, -630, -482, -390, -315, -256,
         -315, -390, -482, -630, -910, -1638, -4096])
}


def build_ref_samples(plane: np.ndarray, avail4: np.ndarray, x0: int, y0: int,
                      n: int, *, c_idx: int = 0, bit_depth: int = 8,
                      strong_smoothing: bool = False):
    """Gather + substitute + (luma) filter reference samples for a TB.

    plane: recon plane [y][x]; avail4: bool map at 4x4-of-this-plane
    granularity marking already-reconstructed blocks (z-order availability,
    spec 6.4.1 via explicit bookkeeping).

    Returns dict mode -> (left[2n], corner, top[2n]) where filtered variants
    are produced lazily; practically returns (unfiltered, filtered) tuples.
    """
    h, w = plane.shape
    n2 = 2 * n
    default = 1 << (bit_depth - 1)

    # sample coordinates: left column (x0-1, y0..y0+2n-1), corner, top row
    left = np.empty(n2, dtype=np.int32)
    top = np.empty(n2, dtype=np.int32)

    def avail(x: int, y: int) -> bool:
        if x < 0 or y < 0 or x >= w or y >= h:
            return False
        return bool(avail4[y >> 2, x >> 2])

    left_av = np.zeros(n2, dtype=bool)
    top_av = np.zeros(n2, dtype=bool)
    for i in range(n2):
        ly = y0 + i
        if avail(x0 - 1, ly):
            left_av[i] = True
            left[i] = plane[ly, x0 - 1]
        tx = x0 + i
        if avail(tx, y0 - 1):
            top_av[i] = True
            top[i] = plane[y0 - 1, tx]
    corner_av = avail(x0 - 1, y0 - 1)
    corner = int(plane[y0 - 1, x0 - 1]) if corner_av else 0

    # ---- substitution (8.4.4.2.2) ----
    if not corner_av and not left_av.any() and not top_av.any():
        left[:] = default
        top[:] = default
        corner = default
    else:
        # scan order: left[2n-1] .. left[0], corner, top[0] .. top[2n-1]
        if not left_av[n2 - 1]:
            # search forward for first available
            val = None
            for i in range(n2 - 2, -1, -1):
                if left_av[i]:
                    val = left[i]
                    break
            if val is None:
                val = corner if corner_av else None
            if val is None:
                for i in range(n2):
                    if top_av[i]:
                        val = top[i]
                        break
            left[n2 - 1] = val
            left_av[n2 - 1] = True
        for i in range(n2 - 2, -1, -1):
            if not left_av[i]:
                left[i] = left[i + 1]
        if not corner_av:
            corner = int(left[0])
        prev = corner
        for i in range(n2):
            if not top_av[i]:
                top[i] = prev
            prev = top[i]

    return left, corner, top


def filter_ref_samples(left: np.ndarray, corner: int, top: np.ndarray,
                       n: int, mode: int, c_idx: int, bit_depth: int = 8,
                       strong_smoothing: bool = False,
                       chroma444: bool = False) -> tuple:
    """Mode-dependent [1 2 1] smoothing (8.4.4.2.3): luma, and chroma when
    ChromaArrayType is 3 (REXT)."""
    if (c_idx != 0 and not chroma444) or not _filter_flag(mode, n):
        return left, corner, top
    n2 = 2 * n
    if strong_smoothing and n == 32:
        bi_int = 1 << (bit_depth - 5)
        if (abs(corner + int(top[n2 - 1]) - 2 * int(top[n - 1])) < bi_int and
                abs(corner + int(left[n2 - 1]) - 2 * int(left[n - 1])) < bi_int):
            fl = np.empty_like(left)
            ft = np.empty_like(top)
            idx = np.arange(n2)
            fl[:] = ((63 - (idx + 1)) * corner
                     + (idx + 1) * int(left[n2 - 1]) + 32) >> 6
            fl[n2 - 1] = left[n2 - 1]
            ft[:] = ((63 - (idx + 1)) * corner
                     + (idx + 1) * int(top[n2 - 1]) + 32) >> 6
            ft[n2 - 1] = top[n2 - 1]
            return fl, corner, ft
    fl = np.empty_like(left)
    ft = np.empty_like(top)
    fl[0] = (corner + 2 * left[0] + left[1] + 2) >> 2
    fl[1:n2 - 1] = (left[:n2 - 2] + 2 * left[1:n2 - 1] + left[2:] + 2) >> 2
    fl[n2 - 1] = left[n2 - 1]
    ft[0] = (corner + 2 * top[0] + top[1] + 2) >> 2
    ft[1:n2 - 1] = (top[:n2 - 2] + 2 * top[1:n2 - 1] + top[2:] + 2) >> 2
    ft[n2 - 1] = top[n2 - 1]
    fc = (left[0] + 2 * corner + top[0] + 2) >> 2
    return fl, int(fc), ft


def _filter_flag(mode: int, n: int) -> bool:
    if mode == DC or n == 4:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10))
    # n == 64 occurs only in encoder-side mode *evaluation* of a 64x64 CU
    # (its coded TBs are always <= 32, 7.4.3.2 MaxTbLog2SizeY); filter like 32
    thresh = {8: 7, 16: 1, 32: 0, 64: 0}[n]
    return min_dist > thresh


def predict_intra(left: np.ndarray, corner: int, top: np.ndarray, n: int,
                  mode: int, c_idx: int = 0, bit_depth: int = 8,
                  chroma444: bool = False) -> np.ndarray:
    """Predict an (n, n) block [y][x] from (already filtered) references.
    The DC / pure-H / pure-V boundary filters apply to luma and, under
    REXT, to 4:4:4 chroma (8.4.4.2.5/8.4.4.2.6: cIdx == 0 or
    ChromaArrayType == 3)."""
    ci = 0 if chroma444 else c_idx
    if mode == PLANAR:
        return _predict_planar(left, corner, top, n)
    if mode == DC:
        return _predict_dc(left, corner, top, n, ci, bit_depth)
    return _predict_angular(left, corner, top, n, mode, ci, bit_depth)


def _predict_planar(left, corner, top, n):
    x = np.arange(n)
    y = np.arange(n)
    log2 = n.bit_length() - 1
    px = left[y].astype(np.int64)                 # p[-1][y]
    py = top[x].astype(np.int64)                  # p[x][-1]
    tr = int(top[n])                              # p[nTbS][-1]
    bl = int(left[n])                             # p[-1][nTbS]
    pred = ((n - 1 - x)[None, :] * px[:, None]
            + (x + 1)[None, :] * tr
            + (n - 1 - y)[:, None] * py[None, :]
            + (y + 1)[:, None] * bl + n) >> (log2 + 1)
    return pred.astype(np.int32)


def _predict_dc(left, corner, top, n, c_idx, bit_depth):
    log2 = n.bit_length() - 1
    dc = (int(top[:n].sum()) + int(left[:n].sum()) + n) >> (log2 + 1)
    pred = np.full((n, n), dc, dtype=np.int32)
    if c_idx == 0 and n < 32:
        pred[0, 0] = (int(left[0]) + 2 * dc + int(top[0]) + 2) >> 2
        pred[0, 1:] = (top[1:n].astype(np.int64) + 3 * dc + 2) >> 2
        pred[1:, 0] = (left[1:n].astype(np.int64) + 3 * dc + 2) >> 2
    return pred


def _predict_angular(left, corner, top, n, mode, c_idx, bit_depth):
    angle = INTRA_PRED_ANGLE[mode]
    maxval = (1 << bit_depth) - 1
    if mode >= 18:
        main, side = top, left
    else:
        main, side = left, top

    # build extended reference ref[-n .. 2n+1]; store with offset n
    ref = np.zeros(3 * n + 2, dtype=np.int64)
    off = n
    ref[off] = corner
    ref[off + 1: off + 2 * n + 1] = main[:2 * n]
    if angle < 0:
        inv = INV_ANGLE[mode]
        lo = (n * angle) >> 5
        # lower bound exclusive: ref[lo] itself is never addressed
        # (max iIdx = lo, min sample index = lo + 1)
        for xx in range(-1, lo, -1):
            ref[off + xx] = side[((xx * inv + 128) >> 8) - 1]

    yy = np.arange(1, n + 1)
    iidx = (yy * angle) >> 5
    ifact = (yy * angle) & 31
    xs = np.arange(n)
    # idx arrays: pred[row r][col c]; for vertical family r=y, c=x
    a = ref[off + iidx[:, None] + xs[None, :] + 1]
    b = ref[off + iidx[:, None] + xs[None, :] + 2]
    pred = ((32 - ifact)[:, None] * a + ifact[:, None] * b + 16) >> 5
    pred = pred.astype(np.int32)

    if mode >= 18:
        out = pred                       # rows are y
        if mode == VERTICAL and c_idx == 0 and n < 32:
            col = top[0] + ((left[:n].astype(np.int64) - corner) >> 1)
            out = out.copy()
            out[:, 0] = np.clip(col, 0, maxval)
    else:
        out = pred.T                     # transpose horizontal family
        if mode == HORIZONTAL and c_idx == 0 and n < 32:
            row = left[0] + ((top[:n].astype(np.int64) - corner) >> 1)
            out = out.copy()
            out[0, :] = np.clip(row, 0, maxval)
    return out


def candidate_mode_list(left_mode: int | None, above_mode: int | None) -> list[int]:
    """MPM candidate list (spec 8.4.2). None => treated as DC (unavailable /
    not intra / above outside CTB row is handled by the caller passing None)."""
    a = DC if left_mode is None else left_mode
    b = DC if above_mode is None else above_mode
    if a == b:
        if a < 2:
            return [PLANAR, DC, VERTICAL]
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
    lst = [a, b]
    for c in (PLANAR, DC, VERTICAL):
        if c not in lst:
            lst.append(c)
            break
    return lst
