"""Deblocking filter on the card: dense edge-parallel form of core/deblock.

PyTorch port of svt_hevc_tpu/tpu/dlf.py: every vertical edge segment of
the picture is filtered in one masked dense pass, then horizontal edges
run the same core on the transposed plane (spec 8.7.2 order). Boundary
strengths come from the fast path's decision maps: one reference list
(P pictures) or two (B pictures, with the full two-list motion rule).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.deblock import BETA_TABLE, TC_TABLE


@functools.lru_cache(maxsize=None)
def _tc_table(device: str) -> torch.Tensor:
    return torch.as_tensor(TC_TABLE.astype(np.int64)).to(device)


def _clip3(lo, hi, v):
    return torch.minimum(torch.maximum(v, lo), hi) \
        if isinstance(lo, torch.Tensor) else v.clamp(lo, hi)


def _filter_luma_dir(plane, bs, qp: int, bit_depth: int):
    """Filter all vertical luma edges (bs: (H//4, W//8), qp host int).
    Mirror of core.deblock._filter_luma_vertical, dense + masked."""
    hh, ww = plane.shape
    dev = plane.device
    ns, nc = hh // 4, ww // 8
    maxval = (1 << bit_depth) - 1

    seg = bs > 0
    seg[:, 0] = False
    beta = int(BETA_TABLE[min(max(qp, 0), 51)]) << (bit_depth - 8)
    qts = (qp + 2 * (bs.to(torch.int64) - 1)).clamp(0, 53)
    tcs = _tc_table(str(dev))[qts] << (bit_depth - 8)          # (ns, nc)

    rows = ((torch.arange(ns, device=dev) * 4)[:, None]
            + torch.arange(4, device=dev)[None, :])             # (ns, 4)
    cols = ((torch.arange(nc, device=dev) * 8)[:, None]
            + torch.arange(-4, 4, device=dev)[None, :]).clamp(0, ww - 1)
    ri, ci = rows[:, None, :, None], cols[None, :, None, :]
    blk = plane[ri, ci].to(torch.int64)                          # (ns,nc,4,8)
    p3, p2, p1, p0 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    q0, q1, q2, q3 = blk[..., 4], blk[..., 5], blk[..., 6], blk[..., 7]

    tc = tcs[:, :, None]
    dp0 = (p2[..., 0] - 2 * p1[..., 0] + p0[..., 0]).abs()
    dp3 = (p2[..., 3] - 2 * p1[..., 3] + p0[..., 3]).abs()
    dq0 = (q2[..., 0] - 2 * q1[..., 0] + q0[..., 0]).abs()
    dq3 = (q2[..., 3] - 2 * q1[..., 3] + q0[..., 3]).abs()
    dpq0, dpq3 = dp0 + dq0, dp3 + dq3
    d = dpq0 + dpq3
    do_filter = seg & (d < beta)

    def strong_line(dpq_k, k):
        return ((2 * dpq_k < (beta >> 2))
                & ((p3[..., k] - p0[..., k]).abs()
                   + (q0[..., k] - q3[..., k]).abs() < (beta >> 3))
                & ((p0[..., k] - q0[..., k]).abs() < ((5 * tcs + 1) >> 1)))

    strong = do_filter & strong_line(dpq0, 0) & strong_line(dpq3, 3)
    weak = do_filter & ~strong
    dEp1 = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    dEq1 = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)

    s = strong[..., None]
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

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    w_on = delta.abs() < 10 * tc
    dc = _clip3(-tc, tc, delta)
    wp0 = (p0 + dc).clamp(0, maxval)
    wq0 = (q0 - dc).clamp(0, maxval)
    dcp = _clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + dc) >> 1)
    wp1 = (p1 + dcp).clamp(0, maxval)
    dcq = _clip3(-(tc >> 1), tc >> 1, (((q2 + q0 + 1) >> 1) - q1 - dc) >> 1)
    wq1 = (q1 + dcq).clamp(0, maxval)

    wm = weak[..., None] & w_on
    out = blk.clone()
    out[..., 1] = torch.where(s, sp2, p2)
    out[..., 2] = torch.where(s, sp1, torch.where(wm & dEp1[..., None], wp1,
                                                  p1))
    out[..., 3] = torch.where(s, sp0, torch.where(wm, wp0, p0))
    out[..., 4] = torch.where(s, sq0, torch.where(wm, wq0, q0))
    out[..., 5] = torch.where(s, sq1, torch.where(wm & dEq1[..., None], wq1,
                                                  q1))
    out[..., 6] = torch.where(s, sq2, q2)
    out = out.clamp(0, maxval)
    out = torch.where(do_filter[:, :, None, None], out, blk)
    # adjacent edge windows are disjoint; the clamped columns of the first
    # window are never filtered (seg[:, 0] is False) and write back the
    # values they read
    res = plane.clone()
    res[ri, ci] = out.to(plane.dtype)
    return res


def _filter_chroma_dir(plane, bs_luma, qp_c: int, bit_depth: int):
    """Vertical chroma edges (4:2:0): bS == 2 segments on the chroma 8x8
    grid. bs_luma: the (Hl//4, Wl//8) luma map; every 2nd column applies
    and each luma 4-row segment is 2 chroma rows."""
    hh, ww = plane.shape
    dev = plane.device
    maxval = (1 << bit_depth) - 1
    seg = bs_luma[:, ::2] == 2
    seg[:, 0] = False
    ns, nc = seg.shape
    qt = min(max(qp_c + 2, 0), 53)
    tc_s = int(TC_TABLE[qt]) << (bit_depth - 8)

    rows = ((torch.arange(ns, device=dev) * 2)[:, None]
            + torch.arange(2, device=dev)[None, :]).clamp(0, hh - 1)
    cols = ((torch.arange(nc, device=dev) * 8)[:, None]
            + torch.arange(-2, 2, device=dev)[None, :]).clamp(0, ww - 1)
    ri, ci = rows[:, None, :, None], cols[None, :, None, :]
    blk = plane[ri, ci].to(torch.int64)                          # (ns,nc,2,4)
    p1, p0, q0, q1 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    delta = ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3).clamp(-tc_s, tc_s)
    out = blk.clone()
    out[..., 1] = (p0 + delta).clamp(0, maxval)
    out[..., 2] = (q0 - delta).clamp(0, maxval)
    out = torch.where(seg[:, :, None, None], out, blk)
    res = plane.clone()
    res[ri, ci] = out.to(plane.dtype)
    return res


_POC_NONE = -(10 ** 6)          # reference POC of an unused list


def _bs_motion_rule_dev(rp, rq, mvp, mvq):
    """The bS=1 motion conditions (8.7.2.4) for inter/inter edges, two
    reference lists (mirror of core.deblock._bs_motion_rule). rp/rq:
    (..., 2) reference POCs (_POC_NONE = unused); mvp/mvq: (..., 2, 2).
    The 2-element sort of each side's POC set is a min/max pair."""
    diff_sets = ((torch.minimum(rp[..., 0], rp[..., 1])
                  != torch.minimum(rq[..., 0], rq[..., 1]))
                 | (torch.maximum(rp[..., 0], rp[..., 1])
                    != torch.maximum(rq[..., 0], rq[..., 1])))

    both_bi = (rp != _POC_NONE).all(-1) & (rq != _POC_NONE).all(-1)
    up = torch.where((rp[..., 0] != _POC_NONE)[..., None],
                     mvp[..., 0, :], mvp[..., 1, :])
    uq = torch.where((rq[..., 0] != _POC_NONE)[..., None],
                     mvq[..., 0, :], mvq[..., 1, :])
    uni_diff = ((up - uq).abs() >= 4).any(-1)

    def far(a, b):
        return ((a - b).abs() >= 4).any(-1)

    same_order = rp[..., 0] == rq[..., 0]
    d_same = (far(mvp[..., 0, :], mvq[..., 0, :])
              | far(mvp[..., 1, :], mvq[..., 1, :]))
    d_cross = (far(mvp[..., 0, :], mvq[..., 1, :])
               | far(mvp[..., 1, :], mvq[..., 0, :]))
    bi_distinct_diff = torch.where(same_order, d_same, d_cross)
    same_pic_twice = both_bi & (rp[..., 0] == rp[..., 1])
    bi_same_diff = d_same & d_cross

    mv_rule = torch.where(both_bi,
                          torch.where(same_pic_twice, bi_same_diff,
                                      bi_distinct_diff),
                          uni_diff)
    return diff_sets | mv_rule


def derive_bs_maps(cu_log2_8, inter8, mv8, cbf4, w: int, h: int,
                   tu_log2_8=None, refpoc8=None, mv8_2l=None):
    """Boundary-strength maps from the fast-path decision grids. Returns
    (bs_v (H//4, W//8), bs_h (H//8, W//4)) int8 with edges outside the
    coded area zeroed (intra side -> 2; else cbf or the motion rule -> 1).
    mv8: (nby, nbx, 2) L0 MVs (one reference: an MV difference of >= 1
    full pel). B form: refpoc8 (2, nby, nbx) per-list reference POC
    (_POC_NONE where unused) and mv8_2l (2, nby, nbx, 2) select the
    two-list rule, _bs_motion_rule_dev."""
    nby, nbx = cu_log2_8.shape
    h64, w64 = nby * 8, nbx * 8
    dev = cu_log2_8.device
    tu8 = (torch.clamp_max(cu_log2_8, 5) if tu_log2_8 is None
           else tu_log2_8)
    two_list = refpoc8 is not None

    def one_dir(transpose: bool):
        if transpose:
            cu, it, cb = tu8.T, inter8.T, cbf4.T
            if two_list:
                rp8 = refpoc8.permute(0, 2, 1)
                mv2 = mv8_2l.permute(0, 2, 1, 3)
            else:
                mv = mv8.permute(1, 0, 2)
            hh, wwv = w64, h64
            wlim, hlim = h, w
        else:
            cu, it, cb = tu8, inter8, cbf4
            if two_list:
                rp8, mv2 = refpoc8, mv8_2l
            else:
                mv = mv8
            hh, wwv = h64, w64
            wlim, hlim = w, h
        ns, nc = hh // 4, wwv // 8
        rows4 = torch.arange(ns, device=dev)
        cols8 = torch.arange(nc, device=dev) * 8
        br = rows4 // 2
        bq = cols8 // 8
        bp = torch.clamp_min(cols8 - 1, 0) // 8
        tu_r = cu[br[:, None], bq[None, :]].to(torch.int64)
        edge = (cols8[None, :] % (1 << tu_r)) == 0
        edge = edge & (cols8[None, :] < wlim) & ((rows4 * 4)[:, None] < hlim)

        intra_p = ~it[br[:, None], bp[None, :]]
        intra_q = ~it[br[:, None], bq[None, :]]
        cbf_p = cb[rows4[:, None], (torch.clamp_min(cols8 - 1, 0) // 4)
                   [None, :]]
        cbf_q = cb[rows4[:, None], (cols8 // 4)[None, :]]
        if two_list:
            rpp = rp8[:, br[:, None], bp[None, :]].permute(1, 2, 0)
            rpq = rp8[:, br[:, None], bq[None, :]].permute(1, 2, 0)
            mvp = mv2[:, br[:, None], bp[None, :]].permute(1, 2, 0, 3)
            mvq = mv2[:, br[:, None], bq[None, :]].permute(1, 2, 0, 3)
            mv_diff = _bs_motion_rule_dev(rpp, rpq, mvp, mvq)
        else:
            mvp = mv[br[:, None], bp[None, :]]
            mvq = mv[br[:, None], bq[None, :]]
            mv_diff = ((mvp - mvq).abs() >= 4).any(-1)
        bs1 = (cbf_p | cbf_q) > 0
        bs = torch.where(intra_p | intra_q, 2,
                         torch.where(bs1 | mv_diff, 1, 0))
        return torch.where(edge, bs, 0).to(torch.int8)

    return one_dir(False), one_dir(True)


def deblock_dev(rec_y, rec_cb, rec_cr, bs_v, bs_ht, qp: int, qp_c: int,
                bit_depth: int = 8):
    """Full in-loop deblock of one picture (constant slice QP): all
    vertical edges, then all horizontal on the result. bs_ht: the
    horizontal-edge map in transposed-plane layout."""
    y = _filter_luma_dir(rec_y.to(torch.int32), bs_v, qp, bit_depth)
    y = _filter_luma_dir(y.T, bs_ht, qp, bit_depth).T
    cb = _filter_chroma_dir(rec_cb.to(torch.int32), bs_v, qp_c, bit_depth)
    cb = _filter_chroma_dir(cb.T, bs_ht, qp_c, bit_depth).T
    cr = _filter_chroma_dir(rec_cr.to(torch.int32), bs_v, qp_c, bit_depth)
    cr = _filter_chroma_dir(cr.T, bs_ht, qp_c, bit_depth).T
    return y.contiguous(), cb.contiguous(), cr.contiguous()
