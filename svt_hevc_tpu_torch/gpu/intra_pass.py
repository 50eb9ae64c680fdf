"""Closed-loop intra encode pass on the card: wavefront over CTB
anti-diagonals.

PyTorch port of svt_hevc_tpu/tpu/intra_pass.py. CTBs on anti-diagonal
d = 2*row + col run together (the WPP slope); inside a CTB the z-scan
slots run in order, so intra reference samples always see the
reconstruction a decoder in z-scan order would see. The JAX module runs
the (diagonal, slot) steps as one lax.scan; here one step function of
batched tensor ops runs D * slots times. It reads the step's scalars
(diagonal, z-scan offsets) from a device step table through a device
counter, so every step launches the same work: on a CUDA device the pass
runs step 0 eagerly, captures step 1 as a CUDA graph and replays it for
the other steps; on the CPU every step runs eagerly.

Masked writes: the JAX scatter drops rows whose target is out of range
(mode="drop"). The port keeps one spare row below each carried plane and
sends masked writes there, then slices it off; kept writes never share a
destination.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..core.intra import INTRA_PRED_ANGLE, INV_ANGLE, _filter_flag
from .cublas import clear_cublas_workspaces

# Wavefront passes run, (diagonal, slot) steps they took, steps replayed
# from a captured CUDA graph and graphs captured, since the caller last
# zeroed them: which pictures ran the closed-loop intra pass, at what
# sequential depth, and how much of it ran as graph replays (0 on the
# CPU; all steps but each pass's first on a CUDA device).
WAVEFRONT = {"runs": 0, "steps": 0, "graph_steps": 0, "captures": 0}

# Per (thread, CUDA device): [the stream the pass captures and replays
# on (PyTorch's default stream cannot be captured), the newest graph
# captured there]. That graph is never replayed again. It is kept because
# PyTorch captures into a graph's memory pool only while some graph holds
# the pool: each capture takes the pool of the one before, so later
# passes reuse its blocks instead of reserving new ones. release_graphs()
# drops them all at the end of a stream.
_GRAPH_HOMES: dict = {}
_GRAPH_HOMES_LOCK = threading.Lock()

# --------------------------------------------------------------- mode tables

@functools.lru_cache(maxsize=None)
def _mode_tables(n: int):
    """Integer prediction tables for an (n, n) TB: (W (35, n*n, 4n+1),
    shift (35,), offset (35,), filt (35,) bool); see the JAX module."""
    m = 4 * n + 1
    corner = 2 * n
    log2 = n.bit_length() - 1
    w = np.zeros((35, n * n, m), np.int32)
    shift = np.zeros(35, np.int32)
    offset = np.zeros(35, np.int32)

    wp = np.zeros((n, n, m), np.int32)
    for y in range(n):
        for x in range(n):
            wp[y, x, y] += n - 1 - x
            wp[y, x, corner + 1 + n] += x + 1
            wp[y, x, corner + 1 + x] += n - 1 - y
            wp[y, x, n] += y + 1
    w[0] = wp.reshape(n * n, m)
    shift[0], offset[0] = log2 + 1, n

    for mode in range(2, 35):
        angle = INTRA_PRED_ANGLE[mode]
        vertical = mode >= 18

        def ext(k: int) -> int:
            if k == 0:
                return corner
            if k > 0:
                idx = min(k - 1, 2 * n - 1)
                return corner + 1 + idx if vertical else idx
            inv = INV_ANGLE[mode]
            idx = ((k * inv + 128) >> 8) - 1
            if not 0 <= idx < 2 * n:
                raise ValueError(f"reference index {idx} out of range")
            return idx if vertical else corner + 1 + idx

        wa = np.zeros((n, n, m), np.int32)
        for q in range(n):
            iidx = ((q + 1) * angle) >> 5
            ifact = ((q + 1) * angle) & 31
            for p in range(n):
                y, x = (q, p) if vertical else (p, q)
                wa[y, x, ext(p + iidx + 1)] += 32 - ifact
                if ifact:
                    wa[y, x, ext(p + iidx + 2)] += ifact
        w[mode] = wa.reshape(n * n, m)
        shift[mode], offset[mode] = 5, 16

    shift[1], offset[1] = 0, 0
    filt = np.array([_filter_flag(md, n) for md in range(35)], bool)
    return w, shift, offset, filt


@functools.lru_cache(maxsize=None)
def _dev_mode_tables(n: int, device: str):
    w, sh, off, filt = _mode_tables(n)
    return (torch.as_tensor(w.astype(np.float64)).to(device),
            torch.as_tensor(sh.astype(np.int64)).to(device),
            torch.as_tensor(off.astype(np.int64)).to(device),
            torch.as_tensor(filt).to(device))


def _morton_spread(v):
    return (v & 1) | ((v & 2) << 1) | ((v & 4) << 2) | ((v & 8) << 3)


def _zidx(x, y, nctbx: int, ctb_log2: int):
    """z-scan precedence index of luma position (x, y) (6.4.1 MinTbAddrZs
    semantics at 4x4 granularity)."""
    c = ctb_log2
    ctb = (y >> c) * nctbx + (x >> c)
    m = (1 << (c - 2)) - 1
    ix = (x >> 2) & m
    iy = (y >> 2) & m
    return (ctb << (2 * (c - 2))) + (_morton_spread(iy) << 1) \
        + _morton_spread(ix)


def _gather_lt(plane, x0, y0, n2max: int, cur_z, w: int, h: int,
               nctbx: int, ctb_log2: int, scale: int, ph: int, pw: int):
    """Left/top/corner samples and their availability for all CU sizes at
    a batch of positions (one gather of the largest extent). ph/pw: the
    plane's real extent (the carried planes hold a spare row below)."""
    k = torch.arange(n2max, device=x0.device)
    ly = y0[:, None] + k[None, :]
    lx = x0 - 1
    tx = x0[:, None] + k[None, :]
    ty = y0 - 1

    l_av = ((lx >= 0)[:, None] & (ly < h)
            & (_zidx((lx[:, None] * scale).clamp_min(0), ly * scale, nctbx,
                     ctb_log2) < cur_z[:, None]))
    t_av = ((ty >= 0)[:, None] & (tx < w)
            & (_zidx(tx * scale, (ty[:, None] * scale).clamp_min(0), nctbx,
                     ctb_log2) < cur_z[:, None]))
    c_av = ((lx >= 0) & (ty >= 0)
            & (_zidx((lx * scale).clamp_min(0), (ty * scale).clamp_min(0),
                     nctbx, ctb_log2) < cur_z))

    lyc = ly.clamp(0, ph - 1)
    lxc = lx[:, None].clamp(0, pw - 1)
    tyc = ty[:, None].clamp(0, ph - 1)
    txc = tx.clamp(0, pw - 1)
    cyc = ty.clamp(0, ph - 1)
    cxc = lx.clamp(0, pw - 1)
    if plane.ndim == 3:
        lv = plane[:, lyc, lxc]
        tv = plane[:, tyc, txc]
        cv = plane[:, cyc, cxc]
    else:
        lv = plane[lyc, lxc]
        tv = plane[tyc, txc]
        cv = plane[cyc, cxc]
    return lv, l_av, cv, c_av, tv, t_av


def _substitute(lv, l_av, cv, c_av, tv, t_av, n: int, default: int):
    """8.4.4.2.2 substitution for size n: scan order left[2n-1]..left[0],
    corner, top[0]..top[2n-1]; an unavailable head takes the first
    available value later in the scan, then forward fill. Returns
    (R', 4n+1) packed refs."""
    n2 = 2 * n
    lv, tv = lv[..., :n2], tv[..., :n2]
    la, ta = l_av[..., :n2], t_av[..., :n2]
    seq = torch.cat([lv.flip(-1), cv[..., None], tv], dim=-1)
    av = torch.cat([la.flip(-1), c_av[..., None], ta], dim=-1)
    ln = seq.shape[-1]
    any_av = av.any(dim=-1)
    first_idx = torch.argmax(av.to(torch.int32), dim=-1)
    first_val = torch.gather(seq, -1, first_idx[..., None])[..., 0]
    head = torch.where(av[..., 0], seq[..., 0], first_val)
    seq = torch.cat([head[..., None], seq[..., 1:]], dim=-1)
    av = torch.cat([torch.ones_like(av[..., :1]), av[..., 1:]], dim=-1)
    pos = torch.where(av, torch.arange(ln, device=av.device), -1)
    last = torch.cummax(pos, dim=-1).values
    filled = torch.gather(seq, -1, last)
    filled = torch.where(any_av[..., None], filled, default)
    return torch.cat([filled[..., :n2].flip(-1), filled[..., n2:n2 + 1],
                      filled[..., n2 + 1:]], dim=-1)


def _filter_refs(refs: torch.Tensor, n: int) -> torch.Tensor:
    """[1 2 1]/4 smoothing (8.4.4.2.3) of a packed (R, 4n+1) batch."""
    n2 = 2 * n
    left, corner, top = refs[:, :n2], refs[:, n2:n2 + 1], refs[:, n2 + 1:]
    lprev = torch.cat([corner, left[:, :-1]], dim=1)
    lnext = torch.cat([left[:, 1:], left[:, -1:]], dim=1)
    fl = (lprev + 2 * left + lnext + 2) >> 2
    fl = torch.cat([fl[:, :-1], left[:, -1:]], dim=1)
    tprev = torch.cat([corner, top[:, :-1]], dim=1)
    tnext = torch.cat([top[:, 1:], top[:, -1:]], dim=1)
    ft = (tprev + 2 * top + tnext + 2) >> 2
    ft = torch.cat([ft[:, :-1], top[:, -1:]], dim=1)
    fc = (left[:, :1] + 2 * corner + top[:, :1] + 2) >> 2
    return torch.cat([fl, fc, ft], dim=1)


def _predict_batch(refs_u, refs_f, mode, n: int, luma: bool,
                   bit_depth: int):
    """Exact intra prediction of a (R, n, n) batch with per-lane mode.
    The weight contraction is an exact float64 product (integers only)."""
    wt, sh, off, filt = _dev_mode_tables(n, str(refs_u.device))
    log2 = n.bit_length() - 1
    maxval = (1 << bit_depth) - 1
    n2 = 2 * n

    if luma and refs_f is not None:
        refs = torch.where(filt[mode][:, None], refs_f, refs_u)
    else:
        refs = refs_u
    wm = wt[mode]                                            # (R, n*n, 4n+1)
    lin = torch.bmm(wm, refs.to(torch.float64)[:, :, None])[:, :, 0].to(
        torch.int64)
    lin = ((lin + off[mode][:, None]) >> sh[mode][:, None]).reshape(-1, n, n)

    left_u = refs_u[:, :n2]
    top_u = refs_u[:, n2 + 1:]
    corner_u = refs_u[:, n2]
    dc = (top_u[:, :n].sum(1) + left_u[:, :n].sum(1) + n) >> (log2 + 1)
    dcp = dc[:, None, None].expand(lin.shape).clone()
    if luma and n < 32:
        dcp[:, 0, :] = (top_u[:, :n] + 3 * dc[:, None] + 2) >> 2
        dcp[:, :, 0] = (left_u[:, :n] + 3 * dc[:, None] + 2) >> 2
        dcp[:, 0, 0] = (left_u[:, 0] + 2 * dc + top_u[:, 0] + 2) >> 2
    pred = torch.where((mode == 1)[:, None, None], dcp, lin)

    if luma and n < 32:
        vcol = (top_u[:, :1]
                + ((left_u[:, :n] - corner_u[:, None]) >> 1)).clamp(0, maxval)
        hrow = (left_u[:, :1]
                + ((top_u[:, :n] - corner_u[:, None]) >> 1)).clamp(0, maxval)
        pv = pred.clone()
        pv[:, :, 0] = vcol
        pred = torch.where((mode == 26)[:, None, None], pv, pred)
        ph_ = pred.clone()
        ph_[:, 0, :] = hrow
        pred = torch.where((mode == 10)[:, None, None], ph_, pred)
    return pred


def _tq_batch(resid, n: int, qp: int, bit_depth: int, lam=None):
    """Forward DCT + intra quant + dequant + inverse DCT of an (R, n, n)
    residual batch (the encode.dense_tq_size arithmetic with the intra
    rounding offset). lam: optional SSE lambda enabling the per-TU RD
    zero-out."""
    from .encode import _tq_blocks, _tu_zero_rd
    b = resid.to(torch.int32)
    lv, inv = _tq_blocks(b, n, qp, bit_depth, True)
    r = inv(lv)
    if lam is not None:
        lv, r = _tu_zero_rd(b, lv, r, lam)
    return lv, r


def _scatter(plane, vals, x0, y0, n: int, mask, ph: int):
    """Masked disjoint block write in place: rows with mask=False go to
    the spare row ph (the JAX scatter's dropped writes). plane: (H+1, W)
    or stacked (2, H+1, W) with vals (2R, n, n). Masked rows also take
    column 0, since their columns may lie past the plane."""
    r = x0.shape[0]
    a = torch.arange(n, device=x0.device)
    yy = (y0[:, None, None] + a[None, :, None]).expand(r, n, n)
    xx = (x0[:, None, None] + a[None, None, :]).expand(r, n, n)
    yy = torch.where(mask[:, None, None], yy, ph)
    xx = torch.where(mask[:, None, None], xx, 0)
    vals = vals.to(plane.dtype)
    if plane.ndim == 3:
        yy = torch.cat([yy, yy], 0)
        xx = torch.cat([xx, xx], 0)
        cc = torch.arange(2, device=x0.device).repeat_interleave(r)
        cc = cc[:, None, None].expand(2 * r, n, n)
        plane.index_put_((cc, yy, xx), vals)
    else:
        plane.index_put_((yy, xx), vals)


def _spare_row(p: torch.Tensor) -> torch.Tensor:
    """Copy of p (int32) with one spare row appended on the row axis."""
    p = p.to(torch.int32)
    z = torch.zeros((*p.shape[:-2], 1, p.shape[-1]), dtype=torch.int32,
                    device=p.device)
    return torch.cat([p, z], dim=-2)


def step_table(R: int, C: int, ctb_log2: int, min_cu_log2: int):
    """The pass's steps in order (diagonal d outer, z-scan slot k inner) as
    (D * slots, 3) int64 rows (d, zx * unit, zy * unit): the slot's x / y
    offset inside its CTB, zx / zy the even / odd bits of k. R, C: CTB
    rows and columns."""
    nbits = ctb_log2 - min_cu_log2
    slots = 1 << (2 * nbits)
    D = 2 * (R - 1) + C
    k = np.arange(slots)
    zx = sum(((k >> (2 * b)) & 1) << b for b in range(nbits))
    zy = sum(((k >> (2 * b + 1)) & 1) << b for b in range(nbits))
    unit = 1 << min_cu_log2
    tab = np.empty((D, slots, 3), np.int64)
    tab[..., 0] = np.arange(D)[:, None]
    tab[..., 1] = zx * unit
    tab[..., 2] = zy * unit
    return tab.reshape(D * slots, 3)


def _graph_home(dev: torch.device) -> list:
    key = (threading.get_ident(), dev.index)
    with _GRAPH_HOMES_LOCK:
        home = _GRAPH_HOMES.get(key)
        if home is None:
            home = _GRAPH_HOMES[key] = [torch.cuda.Stream(dev), None]
    return home


def release_graphs() -> None:
    """Drop every thread's kept wavefront graph and capture stream. The
    graphs' memory pool then has no holder, and the caching allocator
    frees it when it next frees its cache (torch.cuda.empty_cache(), or
    an allocation that would not fit otherwise). A pass that runs later
    captures into a new pool."""
    with _GRAPH_HOMES_LOCK:
        _GRAPH_HOMES.clear()


def _run_steps(step, n: int, dev: torch.device) -> None:
    """Run step() n times. On a CUDA device: step 0 eagerly (it uploads
    the cached tables and sets up cuBLAS on the capture stream), step 1
    captured once as a CUDA graph (span wf.capture), then n - 1 replays.
    Everything the graph bakes in (shapes, qp, lam, the planes' addresses)
    is constant within one pass, so no later pass replays it."""
    if dev.type != "cuda" or n < 2:
        for _ in range(n):
            step()
        return
    from .encode import stage
    home = _graph_home(dev)
    stream, last = home
    cur = torch.cuda.current_stream(dev)
    stream.wait_stream(cur)
    # cuBLAS keeps a workspace for each stream it has run on (32 MiB on
    # Hopper), allocated on the stream's first matmul. Freed here on entry
    # and on exit, as PyTorch's own graph trees free them, the capture
    # stream's takes the place of the current stream's while the pass runs
    # and is not held after it. The call is private to PyTorch and frees
    # the workspaces of every stream in the process (the next matmul on a
    # stream makes its own again); tests/test_torch_wavefront_graph.py
    # holds on the card that a pass keeps nothing allocated. The clears
    # take cublas.CUBLAS_LOCK: none falls inside another thread's P-chain
    # recording.
    clear_cublas_workspaces()
    try:
        with torch.cuda.stream(stream):
            step()
            with stage("wf.capture"):
                graph = torch.cuda.CUDAGraph()
                # thread_local: CUDA calls of other threads (an
                # EncoderHandle's worker) do not invalidate the capture
                graph.capture_begin(
                    pool=None if last is None else last.pool(),
                    capture_error_mode="thread_local")
                try:
                    step()
                finally:
                    graph.capture_end()
            for _ in range(n - 1):
                graph.replay()
    finally:
        clear_cublas_workspaces()
    cur.wait_stream(stream)
    home[1] = graph
    WAVEFRONT["captures"] += 1
    WAVEFRONT["graph_steps"] += n - 1


def intra_wavefront_pass(src_y, src_cb, src_cr, rec_y, rec_cb, rec_cr,
                         lv_y, lv_cb, lv_cr, cu_log2_8, mode8, intra8,
                         qp: int, qp_c: int, w: int, h: int,
                         bit_depth: int = 8, ctb_log2: int = 6,
                         min_cu_log2: int = 3, lam=None,
                         refine_modes: bool = False):
    """Closed-loop intra encode for all CUs flagged in intra8.

    src_*: int32 source planes at 64-aligned dims. rec_*/lv_*: int32
    reconstruction / level planes to update (I pictures pass zeros).
    cu_log2_8/mode8/intra8: per-8x8-block decision maps. w/h: coded dims.
    Returns (rec_y, rec_cb, rec_cr, lv_y, lv_cb, lv_cr, mode8)."""
    dev = src_y.device
    h64, w64 = src_y.shape
    tile = 1 << ctb_log2
    unit = 1 << min_cu_log2
    R, C = h64 // tile, w64 // tile
    nctbx = C
    maxval = (1 << bit_depth) - 1
    default = 1 << (bit_depth - 1)
    rows = torch.arange(R, device=dev)
    sizes = [n for n in (8, 16, 32) if unit <= n <= tile]
    nmax = sizes[-1]
    ncmax = nmax // 2
    nby, nbx = h64 // 8, w64 // 8
    steps = step_table(R, C, ctb_log2, min_cu_log2)
    WAVEFRONT["runs"] += 1
    WAVEFRONT["steps"] += len(steps)

    src_y = src_y.to(torch.int32)
    src_c = torch.stack([src_cb.to(torch.int32), src_cr.to(torch.int32)])
    rec_y = _spare_row(rec_y)
    rec_c = _spare_row(torch.stack([rec_cb, rec_cr]))
    lv_y = _spare_row(lv_y)
    lv_c = _spare_row(torch.stack([lv_cb, lv_cr]))
    mode_map = _spare_row(mode8)
    cu_log2_8 = cu_log2_8.to(torch.int64)
    mode8 = mode8.to(torch.int64)
    a = torch.arange(nmax, device=dev)
    ac = torch.arange(ncmax, device=dev)
    table = torch.as_tensor(steps).to(dev)
    counter = torch.zeros((), dtype=torch.int64, device=dev)

    def step():
        # this step's (d, zx * unit, zy * unit), read through the counter
        d, zxu, zyu = table.index_select(0, counter.reshape(1))[0]
        cols = d - 2 * rows
        x0 = cols * tile + zxu
        y0 = rows * tile + zyu
        active = (cols >= 0) & (cols < C) & (x0 < w) & (y0 < h)
        x0c = torch.where(active, x0, 0)
        y0c = torch.where(active, y0, 0)
        by = y0c >> 3
        bx = x0c >> 3
        cu_lg = cu_log2_8[by, bx]
        mode = mode8[by, bx]
        is_intra = intra8[by, bx]
        cur_z = _zidx(x0c, y0c, nctbx, ctb_log2)

        glt = _gather_lt(rec_y, x0c, y0c, 2 * nmax, cur_z, w, h, nctbx,
                         ctb_log2, 1, h64, w64)
        xc, yc = x0c >> 1, y0c >> 1
        cglt = _gather_lt(rec_c, xc, yc, 2 * ncmax, cur_z, w // 2,
                          h // 2, nctbx, ctb_log2, 2, h64 // 2,
                          w64 // 2)
        sy = (y0c[:, None, None] + a[None, :, None]).clamp(0, h64 - 1)
        sx = (x0c[:, None, None] + a[None, None, :]).clamp(0, w64 - 1)
        src_max = src_y[sy.expand(R, nmax, nmax),
                        sx.expand(R, nmax, nmax)]
        cyi = (yc[:, None, None] + ac[None, :, None]).clamp(
            0, h64 // 2 - 1)
        cxi = (xc[:, None, None] + ac[None, None, :]).clamp(
            0, w64 // 2 - 1)
        csrc_max = src_c[:, cyi.expand(R, ncmax, ncmax),
                         cxi.expand(R, ncmax, ncmax)]
        csrc_max = csrc_max.reshape(2 * R, ncmax, ncmax)

        for n in sizes:
            lg = n.bit_length() - 1
            sel = (active & is_intra & (cu_lg == lg)
                   & (x0c % n == 0) & (y0c % n == 0))
            refs_u = _substitute(*glt, n, default)
            refs_f = _filter_refs(refs_u, n)
            if refine_modes:
                srcn = src_max[:, :n, :n]
                cands = (0, 1, 26, 10)
                nc_ = 1 + len(cands)
                cm_all = torch.cat(
                    [mode] + [torch.full_like(mode, c) for c in cands])
                p_all = _predict_batch(refs_u.repeat(nc_, 1),
                                       refs_f.repeat(nc_, 1), cm_all, n,
                                       True, bit_depth)
                p_all = p_all.reshape(nc_, R, n, n)
                e = srcn[None] - p_all
                sse = (e * e).sum((-2, -1)).to(torch.float32)
                kbest = torch.argmin(sse, dim=0)
                md_sel = torch.gather(cm_all.reshape(nc_, R), 0,
                                      kbest[None])[0]
                pred = torch.gather(
                    p_all, 0,
                    kbest[None, :, None, None].expand(1, R, n, n))[0]
                kk = n // 8
                off = torch.arange(kk * kk, device=dev)
                yy = by[:, None] + off[None, :] // kk
                xx = bx[:, None] + off[None, :] % kk
                upd = sel[:, None].expand(R, kk * kk)
                yy = torch.where(upd, yy, nby)
                xx = torch.where(upd, xx, 0)
                mode_map.index_put_(
                    (yy, xx),
                    md_sel[:, None].expand(R, kk * kk).to(torch.int32))
            else:
                pred = _predict_batch(refs_u, refs_f, mode, n, True,
                                      bit_depth)
                md_sel = mode
            lv, rr = _tq_batch(src_max[:, :n, :n] - pred, n, qp,
                               bit_depth, lam=lam)
            rec = (pred + rr).clamp(0, maxval)
            _scatter(rec_y, rec, x0c, y0c, n, sel, h64)
            _scatter(lv_y, lv, x0c, y0c, n, sel, h64)

            nc = n // 2
            clv2, cl_av, ccv2, cc_av, ctv2, ct_av = cglt
            crefs = _substitute(
                clv2.reshape(2 * R, -1), torch.cat([cl_av, cl_av]),
                ccv2.reshape(2 * R), torch.cat([cc_av, cc_av]),
                ctv2.reshape(2 * R, -1), torch.cat([ct_av, ct_av]),
                nc, default)
            cpred = _predict_batch(crefs, None,
                                   torch.cat([md_sel, md_sel]), nc,
                                   False, bit_depth)
            clv, crr = _tq_batch(csrc_max[:, :nc, :nc] - cpred, nc,
                                 qp_c, bit_depth, lam=lam)
            crec = (cpred + crr).clamp(0, maxval)
            _scatter(rec_c, crec, xc, yc, nc, sel, h64 // 2)
            _scatter(lv_c, clv, xc, yc, nc, sel, h64 // 2)
        counter.add_(1)

    _run_steps(step, len(steps), dev)

    return (rec_y[:h64], rec_c[0, :h64 // 2], rec_c[1, :h64 // 2],
            lv_y[:h64], lv_c[0, :h64 // 2], lv_c[1, :h64 // 2],
            mode_map[:nby])
