"""Intra prediction as linear algebra: per-mode weight matrices.

Every HEVC intra mode (planar / DC / angular, including the mode-dependent
[1 2 1] reference smoothing and the DC/H/V boundary filters, excluding only
their rare saturating clips) is a *linear* map from the reference-sample
vector r = [left[0..2N-1], corner, top[0..2N-1]] to the NxN prediction.
This module materialises those maps as float32 matrices
W[mode] in R^(N^2 x (4N+1)), so the TPU search stage can evaluate all 35
modes for thousands of blocks as one refs @ W^T contraction on the MXU —
the TPU-native replacement for the reference's per-mode SIMD kernels
(reference: Source/Lib/ASM_*/EbIntraPrediction16bit_Intrinsic_*.c) and its
open-loop intra search (EbMotionEstimation.c OpenLoopIntraSearchLcu :5053).

The matrices are validated against the normative scalar backend
(svt_hevc_tpu.core.intra) in tests; max deviation is < 1 level (rounding),
which is irrelevant for mode *search* (the normative encode pass re-runs
the exact integer path for the chosen mode).
"""

from __future__ import annotations

import functools

import numpy as np

from ..core.intra import DC, HORIZONTAL, INTRA_PRED_ANGLE, INV_ANGLE, PLANAR, VERTICAL, _filter_flag


def _ref_index(n: int):
    """Index helpers into the packed reference vector (length 4N+1)."""
    corner = 2 * n
    left = lambda i: i                 # noqa: E731
    top = lambda i: 2 * n + 1 + i      # noqa: E731
    return left, corner, top


def _smoothing_matrix(n: int) -> np.ndarray:
    """F: raw refs -> [1 2 1]/4-filtered refs (8.4.4.2.3), luma."""
    m = 4 * n + 1
    left, corner, top = _ref_index(n)
    f = np.zeros((m, m), np.float32)
    n2 = 2 * n
    # filtered left
    f[left(0), [corner, left(0), left(1)]] = [0.25, 0.5, 0.25]
    for i in range(1, n2 - 1):
        f[left(i), [left(i - 1), left(i), left(i + 1)]] = [0.25, 0.5, 0.25]
    f[left(n2 - 1), left(n2 - 1)] = 1.0
    # filtered corner
    f[corner, [left(0), corner, top(0)]] = [0.25, 0.5, 0.25]
    # filtered top
    f[top(0), [corner, top(0), top(1)]] = [0.25, 0.5, 0.25]
    for i in range(1, n2 - 1):
        f[top(i), [top(i - 1), top(i), top(i + 1)]] = [0.25, 0.5, 0.25]
    f[top(n2 - 1), top(n2 - 1)] = 1.0
    return f


def _planar_matrix(n: int) -> np.ndarray:
    left, corner, top = _ref_index(n)
    w = np.zeros((n, n, 4 * n + 1), np.float32)
    d = 1.0 / (2 * n)
    for y in range(n):
        for x in range(n):
            w[y, x, left(y)] += (n - 1 - x) * d
            w[y, x, top(n)] += (x + 1) * d
            w[y, x, top(x)] += (n - 1 - y) * d
            w[y, x, left(n)] += (y + 1) * d
    return w.reshape(n * n, -1)


def _dc_matrix(n: int, luma: bool) -> np.ndarray:
    left, corner, top = _ref_index(n)
    w = np.zeros((n, n, 4 * n + 1), np.float32)
    dc = np.zeros(4 * n + 1, np.float32)
    dc[[left(i) for i in range(n)]] = 1.0 / (2 * n)
    dc[[top(i) for i in range(n)]] = 1.0 / (2 * n)
    w[:, :, :] = dc
    if luma and n < 32:
        w[0, 0] = 0.5 * dc
        w[0, 0, left(0)] += 0.25
        w[0, 0, top(0)] += 0.25
        for x in range(1, n):
            w[0, x] = 0.75 * dc
            w[0, x, top(x)] += 0.25
        for y in range(1, n):
            w[y, 0] = 0.75 * dc
            w[y, 0, left(y)] += 0.25
    return w.reshape(n * n, -1)


def _angular_matrix(n: int, mode: int, luma: bool) -> np.ndarray:
    left, corner, top = _ref_index(n)
    angle = INTRA_PRED_ANGLE[mode]
    vertical = mode >= 18
    main, side = (top, left) if vertical else (left, top)

    # extended reference: ext[k] for k in lo..2n+1 maps to a source ref index
    def ext(k: int) -> int:
        if k == 0:
            return corner
        if k > 0:
            return main(min(k - 1, 2 * n - 1))
        inv = INV_ANGLE[mode]
        idx = ((k * inv + 128) >> 8) - 1
        return side(min(max(idx, 0), 2 * n - 1))

    w = np.zeros((n, n, 4 * n + 1), np.float32)
    for q in range(n):                 # q: main-direction coordinate
        iidx = ((q + 1) * angle) >> 5
        ifact = ((q + 1) * angle) & 31
        for p in range(n):             # p: cross coordinate
            a, b = ext(p + iidx + 1), ext(p + iidx + 2)
            y, x = (q, p) if vertical else (p, q)
            w[y, x, a] += (32 - ifact) / 32.0
            w[y, x, b] += ifact / 32.0
    if luma and n < 32:
        if mode == VERTICAL:
            for y in range(n):
                w[y, 0] = 0.0
                w[y, 0, top(0)] = 1.0
                w[y, 0, left(y)] = 0.5
                w[y, 0, corner] = -0.5
        elif mode == HORIZONTAL:
            for x in range(n):
                w[0, x] = 0.0
                w[0, x, left(0)] = 1.0
                w[0, x, top(x)] = 0.5
                w[0, x, corner] = -0.5
    return w.reshape(n * n, -1)


@functools.lru_cache(maxsize=None)
def mode_weight_matrix(n: int, luma: bool = True) -> np.ndarray:
    """W: (35, N*N, 4N+1) float32, smoothing folded in per mode."""
    smooth = _smoothing_matrix(n)
    out = np.zeros((35, n * n, 4 * n + 1), np.float32)
    for mode in range(35):
        if mode == PLANAR:
            w = _planar_matrix(n)
        elif mode == DC:
            w = _dc_matrix(n, luma)
        else:
            w = _angular_matrix(n, mode, luma)
        if luma and _filter_flag(mode, n):
            w = w @ smooth
        out[mode] = w
    return out
