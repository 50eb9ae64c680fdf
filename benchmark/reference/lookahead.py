"""The rate control's QP of every picture, worked out again from the
source: the lookahead's complexities in plain NumPy (float64, from exact
integer sums) and the rate controller of the program's
pipeline/rate_control.py, frozen beside this file (rate_control.py, taken
at commit 2a46a2c; plain Python).

The complexity of a picture is the global-motion-compensated SAD of its
4x4-sum decimated luma against its predecessor's: the least over every
displacement in [-8, 8]^2 decimated samples of the mean absolute
difference (the predecessor edge-padded), in samples; the stream's very
first picture takes sqrt(variance) / 4 instead. The lookahead queue
refills in batches of 2 (la + 1) - queued pictures whenever fewer than
la + 1 are queued, and each picture's window is its own complexity and
the next la queued. The controller follows the coded sizes the stream
gives, picture by picture, as the program's does.
"""

from __future__ import annotations

import itertools
import math
from collections import deque
from types import SimpleNamespace

import numpy as np

from .rate_control import RateControl

GM_R = 8


def _dec(y: np.ndarray) -> np.ndarray:
    """Integer 4x4 sums of an edge-padded plane."""
    h, w = y.shape
    h4, w4 = -(-h // 4) * 4, -(-w // 4) * 4
    p = np.pad(y.astype(np.int64), ((0, h4 - h), (0, w4 - w)), mode="edge")
    return p.reshape(h4 // 4, 4, w4 // 4, 4).sum((1, 3))


def gm_sad(prev: np.ndarray, cur: np.ndarray) -> float:
    """The least mean absolute difference of the decimated planes over
    the displacements (exact integer sums, then one division)."""
    a, b = _dec(prev), _dec(cur)
    hd, wd = b.shape
    pad = np.pad(a, GM_R, mode="edge")
    best = None
    for dy in range(2 * GM_R + 1):
        band = pad[dy:dy + hd]
        for dx in range(2 * GM_R + 1):
            s = int(np.abs(b - band[:, dx:dx + wd]).sum())
            best = s if best is None else min(best, s)
    return best / 16.0 / (hd * wd)


def intra_proxy(y: np.ndarray) -> float:
    """sqrt(population variance) / 4 of the (edge-padded) luma."""
    h, w = y.shape
    h4, w4 = -(-h // 4) * 4, -(-w // 4) * 4
    p = np.pad(y.astype(np.int64), ((0, h4 - h), (0, w4 - w)), mode="edge")
    n = p.size
    s = int(p.sum())
    q = s // n
    d = p - q
    var = float(int((d * d).sum())) / n - ((s - q * n) / n) ** 2
    return math.sqrt(float(np.float32(var))) / 4.0


def windows(lumas, la: int) -> list[list[float]]:
    """Each picture's lookahead window, for as many pictures as lumas
    allows (the queue refills as the program's does)."""
    it = iter(lumas)
    buf: deque = deque()
    prev = None
    out = []
    while True:
        if len(buf) < la + 1:
            batch = list(itertools.islice(it, 2 * (la + 1) - len(buf)))
            if len(batch) < 2 * (la + 1) - len(buf):
                return out         # the source ran out: stop before it
            cx = []
            for i, y in enumerate(batch):
                ref = batch[i - 1] if i else prev
                cx.append(intra_proxy(y) if ref is None else gm_sad(ref, y))
            prev = batch[-1]
            buf.extend(max(c, 1e-3) for c in cx)
        c0 = buf.popleft()
        out.append([c0] + list(itertools.islice(buf, la)))


def rc_qps(rc_cfg: dict, lumas, pictures) -> list[int]:
    """The QP the rate control picks for each picture (in order), given
    the source lumas and the coded pictures (is_idr, bytes) before it."""
    cfg = SimpleNamespace(**rc_cfg)
    rc = RateControl(cfg)
    wins = windows(lumas, rc_cfg["lookahead"])
    qps = []
    for pic, win in zip(pictures, wins):
        qp = rc.pick_qp(pic["is_idr"], window=win, layer=0)
        qp = min(max(qp, cfg.min_qp_allowed), cfg.max_qp_allowed)
        qps.append(qp)
        rc.update_lookahead(8 * len(pic["data"]), qp, win[0],
                            is_idr=pic["is_idr"], layer=0)
    return qps
