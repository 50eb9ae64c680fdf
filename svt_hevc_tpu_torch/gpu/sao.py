"""SAO on the card: per-CTB decision and picture apply.

PyTorch port of svt_hevc_tpu/tpu/sao.py: picks per-CTB type, class and
offsets from the device statistics (gpu/encode.sao_stats_plane) with the
same float32 math as core/sao.py's stats-based decision, applies the
offsets, and leaves only the small parameter grids for the host.
"""

from __future__ import annotations

import torch

from ..core.sao import SAO_RATE_SCALE
from .encode import _f32, _fma, eo_cat_lut
from .kernels import edge_pad

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2

_EO_NEIGHBORS = (((-1, 0), (1, 0)), ((0, -1), (0, 1)),
                 ((-1, -1), (1, 1)), ((1, -1), (-1, 1)))


def _eo_offsets_gains(eo_cnt, eo_sum, mx: int):
    """(offs (ny,nx,4cls,4) int32, gain (ny,nx,4cls) float32)."""
    c = eo_cnt[..., 1:5].to(torch.float32)
    s = eo_sum[..., 1:5].to(torch.float32)
    o = torch.where(c > 0, torch.round(s / torch.clamp_min(c, 1.0)).clamp(
        -mx, mx), 0.0)
    o = torch.cat([torch.clamp_min(o[..., 0:2], 0.0),
                   torch.clamp_max(o[..., 2:4], 0.0)], -1)
    g = 2.0 * o * s - c * o * o
    keep = g > 0
    offs = torch.where(keep, o, 0.0)
    gain = torch.where(keep, g, 0.0).sum(-1)
    return offs.to(torch.int32), gain


def _bo_offsets_gains(bo_cnt, bo_sum, lam: float, mx: int):
    """(bp (ny,nx) int32, offs (ny,nx,4) int32, score float32)."""
    c = bo_cnt.to(torch.float32)
    s = bo_sum.to(torch.float32)
    ob = torch.where(c > 0, torch.round(s / torch.clamp_min(c, 1.0)).clamp(
        -mx, mx), 0.0)
    gains = torch.clamp_min(
        torch.where(ob != 0, 2.0 * ob * s - c * ob * ob, 0.0), 0.0)
    win = torch.stack([gains[..., k:k + 4].sum(-1) for k in range(29)], -1)
    bp = win.argmax(-1)
    offs = torch.stack(
        [torch.where(torch.gather(gains, -1, (bp + i)[..., None])[..., 0] > 0,
                     torch.gather(ob, -1, (bp + i)[..., None])[..., 0], 0.0)
         for i in range(4)], -1)
    g = _fma(-_f32(lam * SAO_RATE_SCALE),
             9.0 + (offs.abs() + 1.0).sum(-1),
             torch.gather(win, -1, bp[..., None])[..., 0])
    return bp.to(torch.int32), offs.to(torch.int32), g


def sao_decide_dev(stats, lam: float, bit_depth: int = 8):
    """Per-CTB SAO decision from device stats: dict of int32 grids type
    (ny,nx,2 luma/chroma), eo (ny,nx,2), bp (ny,nx,3), offs (ny,nx,3,4) —
    the decisions of core.sao.derive_sao_params_from_stats."""
    mx = (1 << (min(bit_depth, 10) - 5)) - 1
    out_type, out_eo, out_bp, out_offs = [], [], [], []
    cb_type = cb_eo = None
    for comp in range(3):
        st = stats[comp]
        eo_offs, eo_gain = _eo_offsets_gains(st["eo_cnt"], st["eo_sum"], mx)
        eo_rate = SAO_RATE_SCALE * (
            4.0 + (eo_offs.abs() + 1.0).sum(-1).to(torch.float32))
        eo_score = _fma(-lam, eo_rate, eo_gain)
        bo_bp, bo_offs, bo_score = _bo_offsets_gains(st["bo_cnt"],
                                                     st["bo_sum"], lam, mx)
        bo_valid = (bo_score > 0) & (bo_offs != 0).any(-1)

        if comp == 2:
            ec = cb_eo.to(torch.int64)
            eo_sel = torch.gather(
                eo_offs, -2, ec[..., None, None].expand(*ec.shape, 1, 4)
            )[..., 0, :]
            use_edge = cb_type == SAO_EDGE
            use_band = (cb_type == SAO_BAND) & bo_valid
            offs = torch.where(use_edge[..., None], eo_sel,
                               torch.where(use_band[..., None], bo_offs, 0))
            out_bp.append(torch.where(use_band, bo_bp, 0))
            out_offs.append(offs)
            continue

        best_ec = eo_score.argmax(-1)
        best_eo_score = torch.gather(eo_score, -1, best_ec[..., None])[..., 0]
        use_bo = bo_valid & (bo_score > torch.clamp_min(best_eo_score, 0.0))
        use_eo = ~use_bo & (best_eo_score > 0.0)
        tmap = torch.where(use_bo, SAO_BAND,
                           torch.where(use_eo, SAO_EDGE, SAO_OFF))
        eo_sel = torch.gather(
            eo_offs, -2,
            best_ec[..., None, None].expand(*best_ec.shape, 1, 4))[..., 0, :]
        offs = torch.where(use_eo[..., None], eo_sel,
                           torch.where(use_bo[..., None], bo_offs, 0))
        out_type.append(tmap.to(torch.int32))
        out_eo.append(torch.where(use_eo, best_ec, 0).to(torch.int32))
        out_bp.append(torch.where(use_bo, bo_bp, 0))
        out_offs.append(offs)
        if comp == 1:
            cb_type, cb_eo = tmap, torch.where(use_eo, best_ec, 0)

    return {
        "type": torch.stack(out_type, -1).to(torch.int32),
        "eo": torch.stack(out_eo, -1).to(torch.int32),
        "bp": torch.stack(out_bp, -1).to(torch.int32),
        "offs": torch.stack(out_offs, -2).to(torch.int32),
    }


def _eo_cat(plane, ec: int, w: int, h: int):
    """EO category map (0..4) with picture-edge invalidation (8.7.3)."""
    hh, ww = plane.shape
    dev = plane.device
    (ax, ay), (bx, by) = _EO_NEIGHBORS[ec]
    pad = edge_pad(plane, 1)
    c = pad[1:-1, 1:-1]
    na = pad[1 + ay:hh + 1 + ay, 1 + ax:ww + 1 + ax]
    nb = pad[1 + by:hh + 1 + by, 1 + bx:ww + 1 + bx]
    edge = 2 + torch.sign(c - na) + torch.sign(c - nb)
    cat = eo_cat_lut(str(dev))[edge.long()]
    xs = torch.arange(ww, device=dev)[None, :]
    ys = torch.arange(hh, device=dev)[:, None]
    valid = torch.ones((hh, ww), dtype=torch.bool, device=dev)
    if ax != 0 or bx != 0:
        valid = valid & (xs > 0) & (xs < w - 1)
    if ay != 0 or by != 0:
        valid = valid & (ys > 0) & (ys < h - 1)
    return torch.where(valid, cat, 0)


def sao_apply_dev(rec, params, comp: int, ctb: int, w: int, h: int,
                  bit_depth: int = 8):
    """Apply SAO to one 64-aligned plane from the decision grids
    (classification on the pre-SAO input). comp: 0/1/2; chroma planes use
    CTB/2 cells; w/h are THIS plane's coded dims."""
    maxval = (1 << bit_depth) - 1
    c01 = min(comp, 1)
    cell = ctb if comp == 0 else ctb // 2
    hh, ww = rec.shape
    dev = rec.device
    tmap = params["type"][..., c01]
    emap = params["eo"][..., c01]
    bp = params["bp"][..., comp]
    offs = params["offs"][..., comp, :].to(torch.int64)
    ny, nx = tmap.shape

    cyi = (torch.arange(hh, device=dev) // cell).clamp(0, ny - 1)[:, None]
    cxi = (torch.arange(ww, device=dev) // cell).clamp(0, nx - 1)[None, :]

    is_edge = (tmap == SAO_EDGE)[..., None]
    onehot = (emap[..., None] == torch.arange(4, device=dev)).to(torch.int64)
    lut_eo = torch.zeros((ny, nx, 4, 5), dtype=torch.int64, device=dev)
    lut_eo[..., 1:] = (onehot[..., None] * offs[:, :, None, :]
                       * is_edge[..., None])

    is_band = (tmap == SAO_BAND)[..., None]
    ar32 = torch.arange(32, device=dev)
    bandhot = sum(((bp[..., None] + i) % 32 == ar32).to(torch.int64)
                  * offs[..., i:i + 1] for i in range(4))
    lut_bo = torch.where(is_band, bandhot, 0)

    off = torch.zeros((hh, ww), dtype=torch.int64, device=dev)
    for ec in range(4):
        cat = _eo_cat(rec, ec, w, h)
        off = off + lut_eo[cyi, cxi, ec, cat]
    band = (rec >> (bit_depth - 5)).long()
    off = off + lut_bo[cyi, cxi, band]
    return (rec + off).clamp(0, maxval).to(torch.int32)
