"""Deblocking filter (H.265 8.7.2) — vectorized numpy normative backend.

All-intra scope: boundary strength is 2 on every transform/coding block
edge aligned to the 8x8 (luma) deblocking grid, so edge *flags* (marked
during the shared CTU walk, see core/ctu.py transform_unit) fully determine
the filter. Both encoder and decoder call deblock_picture() after the CTU
loop; conformance requires bit-identical output.

Design: vertical edges across the whole picture are mutually independent
(filters write <=3 samples a side, edges are >=8 apart), so every 4-line
edge segment is filtered in one vectorized batch; horizontal edges reuse
the same core on the transposed plane (spec order: all vertical first,
then horizontal on the vertically-filtered result).

Analogue of reference Source/Lib/Codec/EbDeblockingFilter.c (bS maps
:339/:472, luma/chroma edge cores :1027-2221) re-designed batch-first; the
TPU path will run the same math as lane-parallel Pallas over edge columns.
"""

from __future__ import annotations

import numpy as np

from .ctu import PictureState, chroma_qp

# spec Table 8-12
BETA_TABLE = np.array(
    [0] * 16
    + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
       26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
       58, 60, 62, 64], dtype=np.int32)
TC_TABLE = np.array(
    [0] * 18
    + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
       4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],
    dtype=np.int32)

assert len(BETA_TABLE) == 52 and len(TC_TABLE) == 54


def _clip3(lo, hi, v):
    return np.minimum(np.maximum(v, lo), hi)


def _filter_luma_vertical(plane: np.ndarray, bs: np.ndarray, qp: int,
                          bit_depth: int, beta_offset: int = 0,
                          tc_offset: int = 0) -> None:
    """Filter all vertical luma edge segments with bS > 0 in place.

    plane: (H, W) int32; bs: (H//4, W//8) int — boundary strength of the
    vertical edge at column 8c for rows 4s..4s+3. Column 0 (picture
    boundary) is never filtered. qp: scalar, or an (H//4, W//8) per-edge
    qpL map (8.7.2.5.3) when the picture carries per-CTB QPs.
    """
    maxval = (1 << bit_depth) - 1
    seg = bs > 0
    seg[:, 0] = False
    ys, xs = np.nonzero(seg)
    if ys.size == 0:
        return
    qpa = np.asarray(qp, np.int32)
    qps = qpa if qpa.ndim == 0 else qpa[ys, xs]                # (S,) or 0-d
    qb = np.clip(qps + (beta_offset << 1), 0, 51)
    beta = (BETA_TABLE[qb] << (bit_depth - 8)).astype(np.int64)
    if not np.any(beta):
        return
    y0 = ys * 4
    x0 = xs * 8
    # per-segment tc from bS (8.7.2.5.3: Q = qp + 2*(bS-1) + 2*tc_offset)
    qts = np.clip(qps + 2 * (bs[ys, xs].astype(np.int32) - 1)
                  + (tc_offset << 1), 0, 53)
    tcs = (TC_TABLE[qts] << (bit_depth - 8)).astype(np.int64)  # (S,)
    tc = tcs[:, None]                                          # per-line

    rows = y0[:, None] + np.arange(4)                       # (S, 4)
    cols = x0[:, None] + np.arange(-4, 4)                   # (S, 8)
    blk = plane[rows[:, :, None], cols[:, None, :]].astype(np.int64)  # (S,4,8)
    p3, p2, p1, p0 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    q0, q1, q2, q3 = blk[..., 4], blk[..., 5], blk[..., 6], blk[..., 7]

    # decisions from lines 0 and 3 (8.7.2.5.3)
    dp0 = np.abs(p2[:, 0] - 2 * p1[:, 0] + p0[:, 0])
    dp3 = np.abs(p2[:, 3] - 2 * p1[:, 3] + p0[:, 3])
    dq0 = np.abs(q2[:, 0] - 2 * q1[:, 0] + q0[:, 0])
    dq3 = np.abs(q2[:, 3] - 2 * q1[:, 3] + q0[:, 3])
    dpq0, dpq3 = dp0 + dq0, dp3 + dq3
    d = dpq0 + dpq3
    do_filter = d < beta                                    # (S,)

    def strong_line(k):
        return ((2 * dpq_k[k] < (beta >> 2))
                & (np.abs(p3[:, k] - p0[:, k]) + np.abs(q0[:, k] - q3[:, k])
                   < (beta >> 3))
                & (np.abs(p0[:, k] - q0[:, k]) < ((5 * tcs + 1) >> 1)))

    dpq_k = {0: dpq0, 3: dpq3}
    strong = do_filter & strong_line(0) & strong_line(3)    # (S,)
    weak = do_filter & ~strong
    dEp1 = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    dEq1 = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)

    s = strong[:, None]
    # ---- strong filter (8.7.2.5.7, dE=2), all 4 lines ----
    sp0 = _clip3(p0 - 2 * tc, p0 + 2 * tc,
                 (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = _clip3(p1 - 2 * tc, p1 + 2 * tc, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = _clip3(p2 - 2 * tc, p2 + 2 * tc,
                 (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = _clip3(q0 - 2 * tc, q0 + 2 * tc,
                 (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
    sq1 = _clip3(q1 - 2 * tc, q1 + 2 * tc, (p0 + q0 + q1 + q2 + 2) >> 2)
    sq2 = _clip3(q2 - 2 * tc, q2 + 2 * tc,
                 (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)

    # ---- weak filter, per line ----
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    w_on = np.abs(delta) < 10 * tc                           # (S, 4)
    dc = _clip3(-tc, tc, delta)
    wp0 = _clip3(0, maxval, p0 + dc)
    wq0 = _clip3(0, maxval, q0 - dc)
    dcp = _clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + dc) >> 1)
    wp1 = _clip3(0, maxval, p1 + dcp)
    dcq = _clip3(-(tc >> 1), tc >> 1, (((q2 + q0 + 1) >> 1) - q1 - dc) >> 1)
    wq1 = _clip3(0, maxval, q1 + dcq)

    w = weak[:, None] & w_on
    out_p0 = np.where(s, sp0, np.where(w, wp0, p0))
    out_q0 = np.where(s, sq0, np.where(w, wq0, q0))
    out_p1 = np.where(s, sp1, np.where(w & dEp1[:, None], wp1, p1))
    out_q1 = np.where(s, sq1, np.where(w & dEq1[:, None], wq1, q1))
    out_p2 = np.where(s, sp2, p2)
    out_q2 = np.where(s, sq2, q2)

    out = blk.copy()
    out[..., 1] = out_p2
    out[..., 2] = out_p1
    out[..., 3] = out_p0
    out[..., 4] = out_q0
    out[..., 5] = out_q1
    out[..., 6] = out_q2
    out = _clip3(0, maxval, out)
    plane[rows[:, :, None], cols[:, None, :]] = out.astype(np.int32)


def _filter_chroma_vertical(plane: np.ndarray, bs_luma: np.ndarray,
                            qp_c: int, bit_depth: int,
                            tc_offset: int = 0, ss_edge: int = 1,
                            ss_along: int = 1) -> None:
    """Filter vertical chroma edges (only segments with bS == 2, 8.7.2.5.5)
    on the 8x8 *chroma*-sample grid.

    bs_luma: the luma (H//4, W//8) bS map. ss_edge: chroma subsampling
    across the edge (selects every 2nd bS column for 4:2:0/4:2:2 vertical
    edges); ss_along: subsampling along the edge (each luma 4-row segment
    is 4 >> ss_along chroma rows). qp_c: scalar, or per-edge QpC map with
    the bs_luma layout.
    """
    maxval = (1 << bit_depth) - 1
    seg = (bs_luma[:, ::1 << ss_edge] == 2).copy()
    seg[:, 0] = False
    ys, xs = np.nonzero(seg)
    if ys.size == 0:
        return
    qpa = np.asarray(qp_c, np.int32)
    qps = qpa if qpa.ndim == 0 else qpa[:, ::1 << ss_edge][ys, xs]
    qt = np.clip(qps + 2 + (tc_offset << 1), 0, 53)
    tc_s = (TC_TABLE[qt] << (bit_depth - 8)).astype(np.int64)
    if not np.any(tc_s):
        return
    tc = tc_s if tc_s.ndim == 0 else tc_s[:, None]
    seg_h = 4 >> ss_along
    y0 = ys * seg_h          # chroma rows
    x0 = xs * 8              # chroma cols

    rows = y0[:, None] + np.arange(seg_h)
    cols = x0[:, None] + np.arange(-2, 2)
    blk = plane[rows[:, :, None], cols[:, None, :]].astype(np.int64)  # (S,sh,4)
    p1, p0, q0, q1 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    delta = _clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
    blk[..., 1] = _clip3(0, maxval, p0 + delta)
    blk[..., 2] = _clip3(0, maxval, q0 - delta)
    plane[rows[:, :, None], cols[:, None, :]] = blk.astype(np.int32)


_POC_NONE = -(10 ** 6)


def _refpoc_maps(st: PictureState) -> np.ndarray:
    """Per-4x4 POC of each list's reference (sentinel when unused)."""
    out = np.full(st.ref_idx.shape, _POC_NONE, np.int64)
    for lst in (0, 1):
        pocs = st.ref_pocs[lst] if len(st.ref_pocs) > lst else []
        for ri, pv in enumerate(pocs):
            out[..., lst] = np.where(st.ref_idx[..., lst] == ri, pv,
                                     out[..., lst])
    return out


def _bs_motion_rule(rp, rq, mvp, mvq):
    """bS=1 motion conditions (8.7.2.4) for inter/inter edges, two-list.

    rp/rq: (..., 2) ref POCs (sentinel = unused); mvp/mvq: (..., 2, 2) MVs.
    """
    # reference-picture *sets* as sorted POC pairs
    sp = np.sort(rp, axis=-1)
    sq = np.sort(rq, axis=-1)
    diff_sets = (sp != sq).any(-1)

    both_bi = (rp != _POC_NONE).all(-1) & (rq != _POC_NONE).all(-1)
    # uni: the single used MV per side
    up = np.where((rp[..., 0] != _POC_NONE)[..., None],
                  mvp[..., 0, :], mvp[..., 1, :])
    uq = np.where((rq[..., 0] != _POC_NONE)[..., None],
                  mvq[..., 0, :], mvq[..., 1, :])
    uni_diff = (np.abs(up - uq) >= 4).any(-1)

    # bi with two distinct refs: align pairs by POC
    same_order = rp[..., 0] == rq[..., 0]
    d_same = ((np.abs(mvp[..., 0, :] - mvq[..., 0, :]) >= 4).any(-1)
              | (np.abs(mvp[..., 1, :] - mvq[..., 1, :]) >= 4).any(-1))
    d_cross = ((np.abs(mvp[..., 0, :] - mvq[..., 1, :]) >= 4).any(-1)
               | (np.abs(mvp[..., 1, :] - mvq[..., 0, :]) >= 4).any(-1))
    bi_distinct_diff = np.where(same_order, d_same, d_cross)
    # bi with the same picture twice: filter only if BOTH pairings differ
    same_pic_twice = both_bi & (rp[..., 0] == rp[..., 1])
    bi_same_diff = d_same & d_cross

    mv_rule = np.where(both_bi,
                       np.where(same_pic_twice, bi_same_diff, bi_distinct_diff),
                       uni_diff)
    return diff_sets | mv_rule


def _derive_bs(st: PictureState, edge, p_rows, p_cols, q_rows, q_cols):
    refpoc = _refpoc_maps(st)
    rp = refpoc[p_rows, p_cols]
    rq = refpoc[q_rows, q_cols]
    intra_p = (st.ref_idx[p_rows, p_cols] < 0).all(-1)
    intra_q = (st.ref_idx[q_rows, q_cols] < 0).all(-1)
    cbf = (st.cbf4[p_rows, p_cols] | st.cbf4[q_rows, q_cols]) > 0
    mvp = st.mv[p_rows, p_cols]
    mvq = st.mv[q_rows, q_cols]
    bs1 = cbf | _bs_motion_rule(rp, rq, mvp, mvq)
    bs = np.where(intra_p | intra_q, 2, np.where(bs1, 1, 0)).astype(np.int8)
    return np.where(edge, bs, 0)


def derive_bs_vertical(st: PictureState) -> np.ndarray:
    """Boundary strength per flagged vertical edge segment (8.7.2.4)."""
    ns, nc = st.edge_v.shape
    cols = np.arange(nc) * 8
    px = (np.maximum(cols - 1, 0) >> 2)[None, :].repeat(ns, 0)
    qx = (cols >> 2)[None, :].repeat(ns, 0)
    rows = np.arange(ns)[:, None].repeat(nc, 1)
    return _derive_bs(st, st.edge_v, rows, px, rows, qx)


def derive_bs_horizontal(st: PictureState) -> np.ndarray:
    ns, nc = st.edge_h.shape    # (H//8, W//4)
    rows8 = np.arange(ns) * 8
    py = (np.maximum(rows8 - 1, 0) >> 2)[:, None].repeat(nc, 1)
    qy = (rows8 >> 2)[:, None].repeat(nc, 1)
    cols = np.arange(nc)[None, :].repeat(ns, 0)
    return _derive_bs(st, st.edge_h, py, cols, qy, cols)


def _edge_qp(st: PictureState, vertical: bool):
    """Per-edge (qpL, QpC) maps from the per-CTB QP grid (8.7.2.5.3:
    qpL = (QpQ + QpP + 1) >> 1 across the edge)."""
    lg = st.ctb_log2
    shape = st.edge_v.shape if vertical else st.edge_h.shape
    ns, nc = shape
    if vertical:
        rows = (np.arange(ns) * 4) >> lg
        cq = (np.arange(nc) * 8) >> lg
        cp = np.maximum(np.arange(nc) * 8 - 1, 0) >> lg
        qpp = st.ctb_qp[rows[:, None], cp[None, :]]
        qpq = st.ctb_qp[rows[:, None], cq[None, :]]
    else:
        cols = (np.arange(nc) * 4) >> lg
        rq = (np.arange(ns) * 8) >> lg
        rp = np.maximum(np.arange(ns) * 8 - 1, 0) >> lg
        qpp = st.ctb_qp[rp[:, None], cols[None, :]]
        qpq = st.ctb_qp[rq[:, None], cols[None, :]]
    qpl = (qpp + qpq + 1) >> 1
    cmap = np.array([chroma_qp(q, 0, st.chroma_format) for q in range(52)],
                    np.int32)
    return qpl, cmap[np.clip(qpl, 0, 51)]


def deblock_picture(st: PictureState, *, beta_offset: int = 0,
                    tc_offset: int = 0) -> None:
    """Apply the full in-loop deblocking filter to the picture in place.
    Order per spec: all vertical edges first, then all horizontal edges."""
    if st.ctb_qp is not None:
        (qp, qp_c), (qp_h, qpc_h) = _edge_qp(st, True), _edge_qp(st, False)
    else:
        qp = qp_h = st.qp
        qp_c = qpc_h = chroma_qp(st.qp, 0, st.chroma_format)
    bd = st.bit_depth

    bs_v = derive_bs_vertical(st)
    bs_h = derive_bs_horizontal(st)
    if not st.filter_across_tiles:
        # loop_filter_across_tiles_enabled_flag == 0: no filtering on
        # interior tile boundaries (8.7.2; reference analogue: tile edge
        # flags passed into the DLF, EbCodingLoop.c:4598-4637)
        for x in st.tile_edges_x:
            bs_v[:, x // 8] = 0
        for y in st.tile_edges_y:
            bs_h[y // 8, :] = 0
    _filter_luma_vertical(st.planes[0], bs_v, qp, bd, beta_offset, tc_offset)
    # horizontal edges: same core on the transposed plane. bs_h is
    # (H//8, W//4); transposed it has exactly the vertical layout.
    yt = np.ascontiguousarray(st.planes[0].T)
    qp_ht = qp_h if np.ndim(qp_h) == 0 else qp_h.T
    qpc_ht = qpc_h if np.ndim(qpc_h) == 0 else qpc_h.T
    _filter_luma_vertical(yt, bs_h.T, qp_ht, bd, beta_offset, tc_offset)
    st.planes[0][:] = yt.T

    for c_idx in (1, 2):
        _filter_chroma_vertical(st.planes[c_idx], bs_v, qp_c, bd, tc_offset,
                                ss_edge=st.ss_x, ss_along=st.ss_y)
        ct = np.ascontiguousarray(st.planes[c_idx].T)
        _filter_chroma_vertical(ct, bs_h.T, qpc_ht, bd, tc_offset,
                                ss_edge=st.ss_y, ss_along=st.ss_x)
        st.planes[c_idx][:] = ct.T
