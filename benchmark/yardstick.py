"""The benchmark's arithmetic: the card's peaks, the work each kernel launch
must do, the union of device intervals and the percentile of a sample.
Plain Python; the metric readers (benchmark/metrics/) call it.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM (data sheet, at its 700 W limit): HBM bytes per second,
# and float32 operations per second outside the tensor cores. K1 and K2
# do integer and float32 adds and multiply-adds on the CUDA cores; no
# lower bound on their time is tighter than the fastest such rate, so
# their operations are counted against it (a stated lower bound).
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def k1_work(h: int, w: int, n: int, r: int) -> tuple[float, float]:
    """(bytes, operations) one K1 launch (sad_field) must move and do on an
    h x w source: source and reference read once, the (2r+1)^2 SAD fields
    of (h//n) x (w//n) blocks written once, all float32; a subtract, an
    absolute value and an add per sample and displacement."""
    s2n = (2 * r + 1) ** 2
    return (4.0 * (2 * h * w + s2n * (h // n) * (w // n)),
            3.0 * h * w * s2n)


def k2_work(n_planes: int, hp: int, wp: int, n_fields: int, nby: int,
            nbx: int, n: int, taps: int) -> tuple[float, float]:
    """(bytes, operations) of one K2 launch (mc_block): every int32 plane
    (hp x wp) read once, the four int32 block maps of every field read
    once, the int32 prediction written once; the multiply-adds of both
    filter passes, at two operations each."""
    nb = nby * nbx
    m = n + taps - 1
    outs = n_planes * n_fields * nb * n * n
    nbytes = 4.0 * (n_planes * hp * wp + 4 * n_fields * nb + outs)
    return nbytes, 2.0 * n_planes * n_fields * nb * taps * (m * n + n * n)


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S)


def union_ns(intervals, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] covered by at least one (start, end)
    interval: overlapping intervals count once."""
    total = 0
    cur_s = cur_e = None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_ns(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The sub-intervals of [lo, hi] that no interval covers."""
    out = []
    t = lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q% of the sample at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of an empty sample")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
