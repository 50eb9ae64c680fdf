"""Inter prediction: normative MCP interpolation + AMVP/merge derivation.

Motion-compensated prediction per H.265 8.5.4 (8-tap luma / 4-tap chroma
separable interpolation, quarter-pel luma, eighth-pel chroma) and the
merge (8.5.3.2.3/4) and AMVP (8.5.3.2.5/6) candidate lists with spatial
and temporal (TMVP, 8.5.3.2.7/8) candidates; the collocated picture's
compressed motion is attached as st.col (the reference equivalent is
EbAdaptiveMotionVectorPrediction.c FillAMVPCandidates :1749 / EbMvMerge.h
with its TMVP map, EbCodingLoop.c:4500).

MVs are (mvx, mvy) in quarter-luma-sample units. The motion field lives in
PictureState at 4x4 granularity: st.mv[(y>>2, x>>2)] and st.ref_idx
(-1 = no inter motion, i.e. intra or not yet decoded).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# H.265 Table 8-11: luma 8-tap filters for fractional positions 1..3
LUMA_FILTERS = {
    0: np.array([0, 0, 0, 64, 0, 0, 0, 0], np.int64),
    1: np.array([-1, 4, -10, 58, 17, -5, 1, 0], np.int64),
    2: np.array([-1, 4, -11, 40, 40, -11, 4, -1], np.int64),
    3: np.array([0, 1, -5, 17, 58, -10, 4, -1], np.int64),
}
# H.265 Table 8-12: chroma 4-tap filters for eighth positions 1..7
CHROMA_FILTERS = {
    0: np.array([0, 64, 0, 0], np.int64),
    1: np.array([-2, 58, 10, -2], np.int64),
    2: np.array([-4, 54, 16, -2], np.int64),
    3: np.array([-6, 46, 28, -4], np.int64),
    4: np.array([-4, 36, 36, -4], np.int64),
    5: np.array([-4, 28, 46, -6], np.int64),
    6: np.array([-2, 16, 54, -4], np.int64),
    7: np.array([-2, 10, 58, -2], np.int64),
}


def _gather_window(ref: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Read a (h, w) window with edge clamping (8.5.4.2.1 reference sample
    clipping — equivalent to the reference's padded pictures,
    EbMcp.c GeneratePadding :1017)."""
    hh, ww = ref.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, hh - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, ww - 1)
    return ref[ys[:, None], xs[None, :]]


def interp_luma_raw(ref: np.ndarray, x0: int, y0: int, n_w: int, n_h: int,
                    mvx: int, mvy: int, bit_depth: int = 8) -> np.ndarray:
    """Luma fractional interpolation to the 14-bit intermediate domain
    (8.5.4.2.2.1 predSampleLX, before the weighted-sample rounding) —
    needed so bi-prediction averages at full precision."""
    ix, fx = x0 + (mvx >> 2), mvx & 3
    iy, fy = y0 + (mvy >> 2), mvy & 3
    shift1 = bit_depth - 8

    if fx == 0 and fy == 0:
        w = _gather_window(ref, ix, iy, n_w, n_h).astype(np.int64)
        return w << (14 - bit_depth)

    if fx and fy:
        win = _gather_window(ref, ix - 3, iy - 3, n_w + 7, n_h + 7).astype(np.int64)
    elif fx:
        win = _gather_window(ref, ix - 3, iy, n_w + 7, n_h).astype(np.int64)
    else:
        win = _gather_window(ref, ix, iy - 3, n_w, n_h + 7).astype(np.int64)

    if fx:
        f = LUMA_FILTERS[fx]
        win = sum(f[k] * win[:, k:k + n_w] for k in range(8)) >> shift1
    if fy:
        f = LUMA_FILTERS[fy]
        second_shift = 6 if fx else shift1
        win = sum(f[k] * win[k:k + n_h, :] for k in range(8)) >> second_shift
    return win


def interp_luma(ref: np.ndarray, x0: int, y0: int, n_w: int, n_h: int,
                mvx: int, mvy: int, bit_depth: int = 8) -> np.ndarray:
    """Uni-pred luma MCP: (n_h, n_w) block at integer position (x0, y0)
    displaced by quarter-pel MV. Returns clipped samples."""
    maxval = (1 << bit_depth) - 1
    if (mvx & 3) == 0 and (mvy & 3) == 0:
        return _gather_window(ref, x0 + (mvx >> 2), y0 + (mvy >> 2),
                              n_w, n_h).astype(np.int32)
    raw = interp_luma_raw(ref, x0, y0, n_w, n_h, mvx, mvy, bit_depth)
    shift = 14 - bit_depth
    out = (raw + (1 << (shift - 1))) >> shift
    return np.clip(out, 0, maxval).astype(np.int32)


def chroma_mv_split(mv_comp: int, ss: int) -> tuple[int, int]:
    """(integer chroma-sample offset, eighth-pel filter phase) of one MV
    component (8.5.3.2.2): a subsampled axis uses the quarter-luma-pel MV
    as eighth-chroma-pel directly; an unsubsampled axis (4:2:2 vertical,
    4:4:4) doubles the quarter-pel fraction to the eighth-pel phase."""
    if ss:
        return mv_comp >> 3, mv_comp & 7
    return mv_comp >> 2, (mv_comp & 3) << 1


def interp_chroma_raw(ref: np.ndarray, x0: int, y0: int, n_w: int, n_h: int,
                      mvx: int, mvy: int, bit_depth: int = 8,
                      ss_x: int = 1, ss_y: int = 1) -> np.ndarray:
    """Chroma interpolation to the 14-bit intermediate domain."""
    dx, fx = chroma_mv_split(mvx, ss_x)
    dy, fy = chroma_mv_split(mvy, ss_y)
    ix, iy = x0 + dx, y0 + dy
    shift1 = bit_depth - 8

    if fx == 0 and fy == 0:
        w = _gather_window(ref, ix, iy, n_w, n_h).astype(np.int64)
        return w << (14 - bit_depth)

    if fx and fy:
        win = _gather_window(ref, ix - 1, iy - 1, n_w + 3, n_h + 3).astype(np.int64)
    elif fx:
        win = _gather_window(ref, ix - 1, iy, n_w + 3, n_h).astype(np.int64)
    else:
        win = _gather_window(ref, ix, iy - 1, n_w, n_h + 3).astype(np.int64)

    if fx:
        f = CHROMA_FILTERS[fx]
        win = sum(f[k] * win[:, k:k + n_w] for k in range(4)) >> shift1
    if fy:
        f = CHROMA_FILTERS[fy]
        second_shift = 6 if fx else shift1
        win = sum(f[k] * win[k:k + n_h, :] for k in range(4)) >> second_shift
    return win


def interp_chroma(ref: np.ndarray, x0: int, y0: int, n_w: int, n_h: int,
                  mvx: int, mvy: int, bit_depth: int = 8,
                  ss_x: int = 1, ss_y: int = 1) -> np.ndarray:
    """Uni-pred chroma MCP: chroma-plane coords, quarter-luma-pel MV."""
    maxval = (1 << bit_depth) - 1
    dx, fx = chroma_mv_split(mvx, ss_x)
    dy, fy = chroma_mv_split(mvy, ss_y)
    if fx == 0 and fy == 0:
        return _gather_window(ref, x0 + dx, y0 + dy,
                              n_w, n_h).astype(np.int32)
    raw = interp_chroma_raw(ref, x0, y0, n_w, n_h, mvx, mvy, bit_depth,
                            ss_x, ss_y)
    shift = 14 - bit_depth
    out = (raw + (1 << (shift - 1))) >> shift
    return np.clip(out, 0, maxval).astype(np.int32)


def mc_predict_uni(ref_planes, x0: int, y0: int, n: int, mv,
                   bit_depth: int = 8, ss_x: int = 1, ss_y: int = 1):
    """Uni-predict luma (n x n at x0,y0) + both chroma planes."""
    mvx, mvy = int(mv[0]), int(mv[1])
    py = interp_luma(ref_planes[0], x0, y0, n, n, mvx, mvy, bit_depth)
    pcb = interp_chroma(ref_planes[1], x0 >> ss_x, y0 >> ss_y,
                        n >> ss_x, n >> ss_y, mvx, mvy, bit_depth, ss_x, ss_y)
    pcr = interp_chroma(ref_planes[2], x0 >> ss_x, y0 >> ss_y,
                        n >> ss_x, n >> ss_y, mvx, mvy, bit_depth, ss_x, ss_y)
    return py, pcb, pcr


def mc_predict_bi(ref0, mv0, ref1, mv1, x0: int, y0: int, n: int,
                  bit_depth: int = 8, ss_x: int = 1, ss_y: int = 1):
    """Bi-prediction: average the two 14-bit intermediates (8.5.4.2.3.2,
    default weighted sample prediction)."""
    shift = 15 - bit_depth
    off = 1 << (shift - 1)
    maxval = (1 << bit_depth) - 1
    out = []
    for c_idx in range(3):
        if c_idx == 0:
            a = interp_luma_raw(ref0[0], x0, y0, n, n,
                                int(mv0[0]), int(mv0[1]), bit_depth)
            b = interp_luma_raw(ref1[0], x0, y0, n, n,
                                int(mv1[0]), int(mv1[1]), bit_depth)
        else:
            a = interp_chroma_raw(ref0[c_idx], x0 >> ss_x, y0 >> ss_y,
                                  n >> ss_x, n >> ss_y,
                                  int(mv0[0]), int(mv0[1]), bit_depth,
                                  ss_x, ss_y)
            b = interp_chroma_raw(ref1[c_idx], x0 >> ss_x, y0 >> ss_y,
                                  n >> ss_x, n >> ss_y,
                                  int(mv1[0]), int(mv1[1]), bit_depth,
                                  ss_x, ss_y)
        out.append(np.clip((a + b + off) >> shift, 0, maxval).astype(np.int32))
    return tuple(out)


def mc_predict(ref_planes, x0: int, y0: int, n: int, mv, bit_depth: int = 8):
    """Back-compat alias for uni-prediction (4:2:0)."""
    return mc_predict_uni(ref_planes, x0, y0, n, mv, bit_depth)


# ------------------------------------------------------- candidate derivation

class Mi(NamedTuple):
    """Motion information of one block: per-list MV + ref idx (-1 = list
    unused). Uni L0: ref1 == -1; bi: both >= 0."""
    mv0: tuple[int, int] = (0, 0)
    ref0: int = -1
    mv1: tuple[int, int] = (0, 0)
    ref1: int = -1

    def uses(self, lst: int) -> bool:
        return (self.ref0 if lst == 0 else self.ref1) >= 0

    def mv(self, lst: int) -> tuple[int, int]:
        return self.mv0 if lst == 0 else self.mv1

    def ref(self, lst: int) -> int:
        return self.ref0 if lst == 0 else self.ref1


def uni_mi(mv, ref: int = 0, lst: int = 0) -> Mi:
    if lst == 0:
        return Mi((int(mv[0]), int(mv[1])), ref, (0, 0), -1)
    return Mi((0, 0), -1, (int(mv[0]), int(mv[1])), ref)


def _motion_at(st, x: int, y: int) -> Mi | None:
    """Motion info at luma position, or None if outside / intra / not yet
    decoded (z-order + tile availability via the avail map)."""
    if x < 0 or y < 0 or x >= st.w or y >= st.h:
        return None
    if not st.avail[0][y >> 2, x >> 2]:
        return None
    r0 = int(st.ref_idx[y >> 2, x >> 2, 0])
    r1 = int(st.ref_idx[y >> 2, x >> 2, 1])
    if r0 < 0 and r1 < 0:
        return None
    return Mi((int(st.mv[y >> 2, x >> 2, 0, 0]), int(st.mv[y >> 2, x >> 2, 0, 1])),
              r0,
              (int(st.mv[y >> 2, x >> 2, 1, 0]), int(st.mv[y >> 2, x >> 2, 1, 1])),
              r1)


def _div_trunc(n: int, d: int) -> int:
    """Integer division truncating toward zero (spec 5.4 '/'), unlike
    Python's floor division — the distinction matters for negative td in
    the tx = (16384 + |td|/2) / td step of MV scaling."""
    q = abs(n) // abs(d)
    return -q if (n < 0) != (d < 0) else q


def _scale_mv_td(mv, tb: int, td: int):
    """MV scaling with explicit POC distances (8.5.3.2.8 general form)."""
    tb = max(-128, min(127, tb))
    td = max(-128, min(127, td))
    if td == tb or td == 0:
        return (int(mv[0]), int(mv[1]))
    tx = _div_trunc(16384 + (abs(td) >> 1), td)
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))
    out = []
    for c in mv:
        v = dsf * int(c)
        v = (abs(v) + 127) >> 8
        v = v if dsf * int(c) >= 0 else -v
        out.append(max(-32768, min(32767, v)))
    return (out[0], out[1])


def _col_motion_at(col: dict, x: int, y: int) -> Mi | None:
    """Collocated picture's (compressed, 16x16) motion at luma (x, y).
    col maps are stored at 16x16 granularity (the spec's motion
    compression: the top-left 4x4 of each 16x16 region)."""
    mvm, refm = col["mv"], col["ref_idx"]
    cy, cx = y >> 4, x >> 4
    if cy >= refm.shape[0] or cx >= refm.shape[1]:
        return None
    r0, r1 = int(refm[cy, cx, 0]), int(refm[cy, cx, 1])
    if r0 < 0 and r1 < 0:
        return None
    return Mi((int(mvm[cy, cx, 0, 0]), int(mvm[cy, cx, 0, 1])), r0,
              (int(mvm[cy, cx, 1, 0]), int(mvm[cy, cx, 1, 1])), r1)


def tmvp_mv(st, x0: int, y0: int, n: int, lst: int,
            target_poc: int) -> tuple[int, int] | None:
    """Temporal MV predictor (8.5.3.2.7/8): collocated bottom-right
    block (same CTB row, inside the picture), else the collocated
    center block; the chosen list's MV is POC-scaled. Reference:
    EbAdaptiveMotionVectorPrediction.c FillAMVPCandidates :1749 /
    the TMVP map fill EbCodingLoop.c:4500."""
    col = getattr(st, "col", None)
    if col is None:
        return None
    cur_poc = getattr(st, "poc", 0)
    no_backward = all(p <= cur_poc
                     for refs in st.ref_pocs for p in refs)

    cands = []
    xbr, ybr = x0 + n, y0 + n
    if (xbr < st.w and ybr < st.h
            and (ybr >> st.ctb_log2) == (y0 >> st.ctb_log2)):
        cands.append((xbr, ybr))
    cands.append((x0 + n // 2, y0 + n // 2))

    for (x, y) in cands:
        m = _col_motion_at(col, x, y)
        if m is None:
            continue
        if not m.uses(0):
            lc = 1
        elif not m.uses(1):
            lc = 0
        elif no_backward:
            lc = lst
        else:
            lc = 1 if col.get("from_l0", True) else 0
        ref_poc_col = col["ref_pocs"][lc][m.ref(lc)]
        tb = cur_poc - target_poc
        td = col["poc"] - ref_poc_col
        return _scale_mv_td(m.mv(lc), tb, td)
    return None


def merge_candidates(st, x0: int, y0: int, n: int, max_cand: int = 5):
    """Merge list (8.5.3.2.3/4): spatial candidates, the temporal (TMVP)
    candidate when a collocated picture is attached (st.col), then (B
    slices) combined bi-predictive candidates, then zero candidates.
    Returns list of Mi."""
    a1 = _motion_at(st, x0 - 1, y0 + n - 1)
    b1 = _motion_at(st, x0 + n - 1, y0 - 1)
    b0 = _motion_at(st, x0 + n, y0 - 1)
    a0 = _motion_at(st, x0 - 1, y0 + n)
    b2 = _motion_at(st, x0 - 1, y0 - 1)

    cand: list[Mi] = []
    if a1 is not None:
        cand.append(a1)
    if b1 is not None and b1 != a1:
        cand.append(b1)
    if b0 is not None and b0 != b1:
        cand.append(b0)
    if a0 is not None and a0 != a1:
        cand.append(a0)
    if len(cand) < 4 and b2 is not None and b2 != a1 and b2 != b1:
        cand.append(b2)

    is_b = getattr(st, "slice_type", 1) == 0
    # temporal candidate (8.5.3.2.3 step after B2; refIdxLXCol = 0; no
    # pruning against the spatial candidates per spec)
    if getattr(st, "col", None) is not None and len(cand) < max_cand:
        mv0 = tmvp_mv(st, x0, y0, n, 0, st.ref_pocs[0][0])
        mv1 = (tmvp_mv(st, x0, y0, n, 1, st.ref_pocs[1][0])
               if is_b else None)
        if mv0 is not None or mv1 is not None:
            cand.append(Mi(mv0 or (0, 0), 0 if mv0 is not None else -1,
                           mv1 or (0, 0), 0 if mv1 is not None else -1))
    if is_b and len(cand) > 1:
        # combined bi-predictive candidates (8.5.3.2.4)
        l0i = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)
        l1i = (1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2)
        num_orig = len(cand)
        for k in range(num_orig * (num_orig - 1)):
            if len(cand) >= max_cand:
                break
            i, j = l0i[k], l1i[k]
            if i >= num_orig or j >= num_orig:
                break
            ci, cj = cand[i], cand[j]
            if not (ci.uses(0) and cj.uses(1)):
                continue
            p0 = st.ref_pocs[0][ci.ref0]
            p1 = st.ref_pocs[1][cj.ref1]
            if p0 == p1 and ci.mv0 == cj.mv1:
                continue
            comb = Mi(ci.mv0, ci.ref0, cj.mv1, cj.ref1)
            cand.append(comb)

    zero_ref = 0
    while len(cand) < max_cand:
        if is_b:
            cand.append(Mi((0, 0), zero_ref, (0, 0), zero_ref))
        else:
            cand.append(Mi((0, 0), zero_ref, (0, 0), -1))
        zero_ref = 0   # single active ref per list
    return cand[:max_cand]


def _scale_mv(mv, cur_poc: int, target_ref_poc: int, cand_ref_poc: int):
    """Temporal MV scaling (8.5.3.2.8)."""
    tb = max(-128, min(127, cur_poc - target_ref_poc))
    td = max(-128, min(127, cur_poc - cand_ref_poc))
    if td == tb or td == 0:
        return (int(mv[0]), int(mv[1]))
    tx = _div_trunc(16384 + (abs(td) >> 1), td)
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))
    out = []
    for c in mv:
        v = dsf * int(c)
        v = (abs(v) + 127) >> 8
        v = v if dsf * int(c) >= 0 else -v
        out.append(max(-32768, min(32767, v)))
    return (out[0], out[1])


def amvp_candidates(st, x0: int, y0: int, n: int, lst: int = 0):
    """Spatial AMVP list for list `lst` (8.5.3.2.5-7), 2 entries,
    zero-filled. Single active reference per list; candidates from the
    other list / other references are POC-scaled."""
    cur_poc = getattr(st, "poc", 0)
    target_poc = st.ref_pocs[lst][0]
    a0 = _motion_at(st, x0 - 1, y0 + n)
    a1 = _motion_at(st, x0 - 1, y0 + n - 1)
    b0 = _motion_at(st, x0 + n, y0 - 1)
    b1 = _motion_at(st, x0 + n - 1, y0 - 1)
    b2 = _motion_at(st, x0 - 1, y0 - 1)

    def step1(neighbors):
        for m in neighbors:
            if m is None:
                continue
            for ll in (lst, 1 - lst):
                if m.uses(ll) and st.ref_pocs[ll][m.ref(ll)] == target_poc:
                    return m.mv(ll)
        return None

    def step2(neighbors):
        for m in neighbors:
            if m is None:
                continue
            for ll in (lst, 1 - lst):
                if m.uses(ll):
                    return _scale_mv(m.mv(ll), cur_poc, target_poc,
                                     st.ref_pocs[ll][m.ref(ll)])
        return None

    is_scaled = a0 is not None or a1 is not None
    mv_a = step1((a0, a1))
    if mv_a is None and is_scaled:
        mv_a = step2((a0, a1))
    mv_b = step1((b0, b1, b2))
    if not is_scaled:
        # no left neighbors: B's unscaled result moves to slot A, B re-runs
        # with scaling (8.5.3.2.6 availableFlagLXA := availableFlagLXB)
        mv_a = mv_b
        mv_b = step2((b0, b1, b2))

    cand = []
    if mv_a is not None:
        cand.append(mv_a)
    if mv_b is not None and mv_b != mv_a:
        cand.append(mv_b)
    if len(cand) < 2 and getattr(st, "col", None) is not None:
        # temporal candidate (8.5.3.2.6: appended without pruning)
        mv_t = tmvp_mv(st, x0, y0, n, lst, target_poc)
        if mv_t is not None:
            cand.append(mv_t)
    while len(cand) < 2:
        cand.append((0, 0))
    return cand[:2]
