"""Picture analysis on the card.

PyTorch port of svt_hevc_tpu/tpu/analysis.py: the open-loop intra search
(all 35 modes of every block evaluated as one batched contraction of the
block's reference vector with the per-mode weight matrices,
gpu/intra_weights.py, scored by Hadamard SATD), the lookahead's batched
statistics, and the host path's helpers (block variances, per-CTB
activity, the noise-class-gated denoiser, the packed intra search maps).

The intra weights are dyadic and the references integers, so every
product and every partial sum is exact; the contractions run in float64
(exact on the CPU and on the card, independent of TF32 settings) and the
costs come back as float32 like the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .intra_weights import mode_weight_matrix


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], np.float64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


@functools.lru_cache(maxsize=None)
def _tables(n: int, device: str):
    w = torch.as_tensor(mode_weight_matrix(n).astype(np.float64)).to(device)
    t = 4 if n == 4 else 8
    return w, torch.as_tensor(_hadamard(t)).to(device)


def extract_block_refs(y: torch.Tensor, n: int) -> torch.Tensor:
    """Open-loop reference vectors for every aligned NxN block: (gh*gw,
    4N+1) [left[0..2N-1], corner, top[0..2N-1]] from the source plane with
    coordinates clamped into the plane."""
    h, w = y.shape
    dev = y.device
    gh, gw = h // n, w // n
    by = torch.arange(gh, device=dev) * n
    bx = torch.arange(gw, device=dev) * n
    top_y = torch.clamp_min(by - 1, 0)
    left_x = torch.clamp_min(bx - 1, 0)
    k = torch.arange(2 * n, device=dev)
    tx = torch.clamp_max(bx[None, :, None] + k[None, None, :], w - 1)
    top = y[top_y[:, None, None], tx]                        # (gh, gw, 2n)
    ly = torch.clamp_max(by[:, None, None] + k[None, None, :], h - 1)
    left = y[ly, left_x[None, :, None]]                      # (gh, gw, 2n)
    corner = y[top_y[:, None], left_x[None, :]]              # (gh, gw)
    refs = torch.cat([left, corner[..., None], top], dim=-1)
    return refs.reshape(gh * gw, 4 * n + 1)


def _satd(diff: torch.Tensor, n: int, hmat: torch.Tensor) -> torch.Tensor:
    """Hadamard SATD over (..., N, N) blocks in 8x8 (or 4x4) tiles:
    sum|H @ D @ H^T| / t, exact in float64."""
    t = 4 if n == 4 else 8
    lead = diff.shape[:-2]
    nd = len(lead)
    d = diff.reshape(*lead, n // t, t, n // t, t)
    tiles = d.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
    tr = torch.matmul(torch.matmul(hmat, tiles), hmat.T)
    return tr.abs().sum(dim=(-4, -3, -2, -1)) / t


def _search(y: torch.Tensor, n: int):
    h, w = y.shape
    gh, gw = h // n, w // n
    wmat, hmat = _tables(n, str(y.device))
    refs = extract_block_refs(y.to(torch.float64), n)        # (B, 4n+1)
    preds = torch.einsum("br,mpr->bmp", refs, wmat)          # (B, 35, n*n)
    src = (y.to(torch.float64).reshape(gh, n, gw, n).permute(0, 2, 1, 3)
           .reshape(gh * gw, 1, n, n))
    diff = preds.reshape(-1, 35, n, n) - src
    cost = _satd(diff, n, hmat)                              # (B, 35)
    best = torch.argmin(cost, dim=1)
    return preds, cost, best


def intra_search_size(y: torch.Tensor, n: int):
    """Best intra mode per NxN block: (best_mode int32, best_cost float32)
    maps of shape (H//N, W//N); the first mode wins a tie."""
    h, w = y.shape
    gh, gw = h // n, w // n
    _, cost, best = _search(y, n)
    return (best.reshape(gh, gw).to(torch.int32),
            cost.amin(dim=1).reshape(gh, gw).to(torch.float32))


def intra_search_size_pred(y: torch.Tensor, n: int, bit_depth: int = 8):
    """intra_search_size + the winning mode's open-loop prediction plane
    (rounded half to even, clipped, int32)."""
    h, w = y.shape
    gh, gw = h // n, w // n
    preds, cost, best = _search(y, n)
    bp = torch.gather(preds, 1, best[:, None, None].expand(
        -1, 1, preds.shape[2]))[:, 0]
    # the reference's prediction is float32: round it there first
    plane = (bp.to(torch.float32).reshape(gh, gw, n, n).permute(0, 2, 1, 3)
             .reshape(h, w))
    plane = torch.round(plane).clamp(0, (1 << bit_depth) - 1).to(torch.int32)
    return (best.reshape(gh, gw).to(torch.int32),
            cost.amin(dim=1).reshape(gh, gw).to(torch.float32), plane)


# ------------------------------------------------------------- lookahead

_GM_R = 8       # global-motion search radius in 1/16-decimated pixels


def _inv_f32(count: int, device) -> torch.Tensor:
    """The float32 reciprocal of a count: XLA evaluates a float32 mean as
    the sum times this constant, not as a division by the count."""
    return torch.tensor(1.0 / count, dtype=torch.float32, device=device)


def _mean_f32(units: torch.Tensor, scale: int, count: int) -> torch.Tensor:
    """float32 mean of values given as exact int64 sums in 1/scale units:
    the sum converted to float32 once, times the float32 reciprocal of
    the count, which is what the JAX graph's float32 mean gives whenever
    its own float32 sum is exact (below 2^24 units)."""
    s = (units.to(torch.float64) / scale).to(torch.float32)
    return s * _inv_f32(count, units.device)


def lookahead_stats(ys: torch.Tensor) -> dict:
    """Batched lookahead statistics for a run of consecutive lumas.

    Port of svt_hevc_tpu.tpu.analysis.lookahead_stats. ys: (T, H, W)
    integer lumas with H, W multiples of 4; frame 0 is the predecessor
    of the window, and stats come back for frames 1..T-1: zz_sad (the
    zero-MV SAD of the 4x4-mean decimated planes), gm_sad / gm_mv (the
    best of the 289 displacements of a +-8 decimated-pel translation
    search, first minimum in the JAX displacement order, gm_mv = [dx, dy]
    full-pel), variance and 32-bin histograms.

    Exactness: the decimated planes are integer 4x4 sums (1/16 units of
    the JAX float32 means, which are exact), and every SAD is an exact
    int64 sum converted to float32 once (_mean_f32), so the card and the
    CPU agree at any size. The JAX graph sums in float32, so it agrees
    bit for bit while a SAD's sum stays below 2^24 sixteenths (128x64 at
    any content and bit depth; 1080p only while the mean decimated
    difference stays below 8 samples); above that XLA's float32
    accumulation rounds in an order of its own and this port keeps the
    exact value. The variance's squared deviations are float32 as in
    JAX, summed in float64 and rounded to float32 once (JAX: a float32
    reduction), so it can differ from JAX in the last bits of float32."""
    t, h, w = ys.shape
    hd, wd = h // 4, w // 4
    n_dec = hd * wd
    yi = ys.to(torch.int32)
    dec = yi.reshape(t, hd, 4, wd, 4).sum((2, 4), dtype=torch.int32)
    zz_u = (dec[1:] - dec[:-1]).abs().sum((1, 2), dtype=torch.int64)
    zz = _mean_f32(zz_u, 16, n_dec)

    r = _GM_R
    s2 = 2 * r + 1
    prev = dec[:-1]
    pad = torch.cat([prev[:, :1].expand(t - 1, r, wd), prev,
                     prev[:, -1:].expand(t - 1, r, wd)], 1)
    pad = torch.cat([pad[:, :, :1].expand(t - 1, hd + 2 * r, r), pad,
                     pad[:, :, -1:].expand(t - 1, hd + 2 * r, r)], 2)
    cur = dec[1:]
    rows = []
    for dy in range(s2):
        band = pad[:, dy:dy + hd]
        sh = torch.stack([band[:, :, dx:dx + wd] for dx in range(s2)])
        rows.append((cur[None] - sh).abs().sum((2, 3), dtype=torch.int64))
    sads = _mean_f32(torch.cat(rows), 16, n_dec)           # (289, T-1)
    gm_sad = sads.min(0).values
    idx = torch.arange(s2 * s2, device=ys.device)[:, None].expand_as(sads)
    k = torch.where(sads == gm_sad[None], idx, s2 * s2).min(0).values
    gm_mv = torch.stack([(k % s2 - r) * 4, (k // s2 - r) * 4],
                        -1).to(torch.int32)

    n_pix = h * w
    mean = _mean_f32(yi.sum((1, 2), dtype=torch.int64), 1, n_pix)
    dev = yi.to(torch.float32) - mean[:, None, None]
    sq = (dev * dev).to(torch.float64)
    var = sq.sum((1, 2)).to(torch.float32) * _inv_f32(n_pix, ys.device)
    bins = torch.clamp(yi >> 3, 0, 31).to(torch.int64)
    hist = torch.stack([torch.bincount(b.reshape(-1), minlength=32)
                        for b in bins]).to(torch.int32)
    return {"zz_sad": zz, "gm_sad": gm_sad, "gm_mv": gm_mv,
            "variance": var[1:], "hist": hist[1:]}


# ------------------------------------------- the host path's helpers

def block_variance(y: torch.Tensor, n: int) -> torch.Tensor:
    """(H//N, W//N) float32 map of per-NxN-block sample variance.

    Port of svt_hevc_tpu.tpu.analysis.block_variance for integer-valued
    planes (integer or float tensors). The block mean is exact in both
    (an integer sum over a power of two); the squared deviations and
    their sum are exact int64 here, in units of 1/(N*N)^2, and the
    variance is rounded to float32 once, so the card and the CPU agree
    at any size. The JAX graph rounds each float32 square and sums in
    XLA's own order: it agrees bit for bit while those squares and their
    partial sums are exact in float32 (deviations from the block mean
    whose squares stay below 2^24 units, e.g. blocks with an integer
    mean and deviations up to 64), and within a few float32 ulps
    otherwise."""
    h, w = y.shape
    cnt = n * n
    b = (y.to(torch.int64).reshape(h // n, n, w // n, n)
         .permute(0, 2, 1, 3))
    dev = b * cnt - b.sum((-2, -1), keepdim=True)
    ss = (dev * dev).sum((-2, -1))
    return (ss.to(torch.float64) / float(cnt ** 3)).to(torch.float32)


def ctb_activity(y: torch.Tensor, ctb: int) -> torch.Tensor:
    """Per-CTB spatial activity: the mean of the float32 8x8 variances
    inside each CTB (port of svt_hevc_tpu.tpu.analysis.ctb_activity; y
    padded to CTB multiples). The float32 variances are summed exactly
    (in float64: at most 42 significant bits) and the mean is rounded to
    float32 once; the JAX graph sums them in float32 in its own order,
    which is the same value whenever its partial sums are exact."""
    v8 = block_variance(y, 8)
    k = ctb // 8
    h8, w8 = v8.shape
    s = v8.to(torch.float64).reshape(h8 // k, k, w8 // k, k).sum((1, 3))
    return (s / float(k * k)).to(torch.float32)


_BINOMIAL5 = tuple(np.float32(v / 16.0) for v in (1.0, 4.0, 6.0, 4.0, 1.0))


def _binomial5(p: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial ([1,4,6,4,1]/16) blur of a float32 plane,
    edge-replicated: the five weighted rows (then columns) added in the
    JAX graph's order, one float32 add at a time. The products are exact
    (a weight is 1, 3 or 1/16 of a power of two times a sample with at
    most 22 significant bits), so each output is the same float32 on the
    card, on the CPU and in XLA."""
    h, w = p.shape

    def taps(e, n, axis):
        acc = None
        for i, k in enumerate(_BINOMIAL5):
            t = e.narrow(axis, i, n) * float(k)
            acc = t if acc is None else acc + t
        return acc

    e = torch.cat([p[:1].expand(2, w), p, p[-1:].expand(2, w)], 0)
    p = taps(e, h, 0)
    e = torch.cat([p[:, :1].expand(h, 2), p, p[:, -1:].expand(h, 2)], 1)
    return taps(e, w, 1)


def denoise_plane(p: torch.Tensor, maxval: int = 255):
    """Noise-class-gated denoise of one plane (port of
    svt_hevc_tpu.tpu.analysis.denoise_plane): the noise level sigma is
    the mean flat-region residual of a binomial blur, and the plane gets
    no, weak (one blur) or strong (two blurs) filtering with the
    correction clamped to +-(3 sigma + 1). Returns (filtered float32
    plane, float32 sigma as a 0-d tensor).

    Exactness: the blurs are exact at 8 bits (_binomial5); at 10 bits the
    second blur's last pass rounds, in the same order as the JAX graph's.
    The residual sum is exact here (an int64 count of 1/256 units) and
    rounded to float32 once, so the card equals the CPU at any size; the
    JAX graph sums in float32, which equals it while that sum stays
    below 2^24 units (small planes or little noise). 3 sigma + 1 is
    rounded once, as XLA's fused multiply-add does."""
    yf = p.to(torch.float32)
    weak = _binomial5(yf)
    strong = _binomial5(weak)
    resid = (yf - weak).abs()
    gx = torch.diff(yf, dim=1, prepend=yf[:, :1]).abs()
    gy = torch.diff(yf, dim=0, prepend=yf[:1, :]).abs()
    flat = (gx + gy) < float(np.float32(0.06 * maxval))
    units = torch.where(flat, resid * 256.0, 0.0).to(torch.int64).sum()
    num = (units.to(torch.float64) / 256.0).to(torch.float32)
    den = flat.sum().to(torch.float32) + 1.0
    sigma = num / den
    thr = (3.0 * sigma.to(torch.float64) + 1.0).to(torch.float32)

    def clamped(f):
        return yf + torch.maximum(torch.minimum(f - yf, thr), -thr)

    # the noise-class thresholds as float32 values, as JAX compares them
    lo = float(np.float32(0.004 * maxval))
    hi = float(np.float32(0.012 * maxval))
    out = torch.where(sigma < lo, yf,
                      torch.where(sigma < hi, clamped(weak),
                                  clamped(strong)))
    return torch.round(out).clamp(0, maxval), sigma


def analyze_frame(y: torch.Tensor) -> dict:
    """Full analysis of one luma plane (H, W multiples of 64; port of
    svt_hevc_tpu.tpu.analysis.analyze_frame): 2:1 and 4:1 decimations,
    the 8/16/32 block variances and the open-loop intra search's best
    mode and float32 cost per 4/8/16/32 block."""
    yf = y.to(torch.float32)
    out = {"decim2": yf[::2, ::2], "decim4": yf[::4, ::4],
           "var8": block_variance(y, 8), "var16": block_variance(y, 16),
           "var32": block_variance(y, 32)}
    for n in (4, 8, 16, 32):
        out[f"mode{n}"], out[f"cost{n}"] = intra_search_size(yf, n)
    return out


def ois_packed(y: torch.Tensor) -> torch.Tensor:
    """The open-loop intra search maps for n in 4/8/16/32 in ONE int32
    tensor (mode, then the cost rounded half to even, per size): one
    download for the host path (port of
    svt_hevc_tpu.tpu.analysis.ois_packed)."""
    yf = y.to(torch.float32)
    flats = []
    for n in (4, 8, 16, 32):
        mode, cost = intra_search_size(yf, n)
        flats.append(mode.reshape(-1))
        flats.append(torch.round(cost).reshape(-1).to(torch.int32))
    return torch.cat(flats)
