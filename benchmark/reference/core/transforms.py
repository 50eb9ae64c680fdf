"""HEVC integer transforms (H.265 8.6.4) — numpy normative backend.

The DCT basis matrices are constructed exactly from the spec's odd
coefficient sets via the even/odd recursive (partial-butterfly) structure —
not floats — and validated in tests against the spec's known rows.

Conventions (match the spec and every conformant decoder):
  - residual / coeff arrays are numpy [y][x] row-major
  - coeff array rows = vertical frequency, cols = horizontal frequency
  - forward:  C  = S2( T @ S1( R @ T^T ) )           (encoder, HM-style shifts)
  - inverse:  R' = S4( S3( T^T @ C ) @ T )            (normative, clipped int16)

Analogue of reference Source/Lib/Codec/EbTransforms.c (EstimateTransform
:3268, EstimateInvTransform :3455) re-designed as dense matrix products so
the TPU path (svt_hevc_tpu.tpu.kernels) can run the same math on the MXU.
"""

from __future__ import annotations

import numpy as np

# Spec-mandated odd coefficient sets (first column of odd rows) per size.
_ODD = {
    2: [64],
    4: [83, 36],
    8: [89, 75, 50, 18],
    16: [90, 87, 80, 70, 57, 43, 25, 9],
    32: [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4],
}

# Spec 8.6.4.3: 4x4 DST-VII matrix for intra luma 4x4.
DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], dtype=np.int64)


def _odd_matrix(n: int) -> np.ndarray:
    """O[k][j] = T_N[2k+1][j] for j < N/2, from the odd coefficient set.

    Entry = sign * odd[(m-1)//2] where the angle index m is
    (2j+1)(2k+1) folded into [0, N] with cosine symmetry (period 4N,
    cos(x) = cos(4N - x), cos(x) = -cos(2N - x) in units of pi/(2N)).
    """
    odd = _ODD[n]
    half = n // 2
    out = np.zeros((half, half), dtype=np.int64)
    for k in range(half):
        for j in range(half):
            u = ((2 * j + 1) * (2 * k + 1)) % (4 * n)
            if u > 2 * n:
                u = 4 * n - u
            if u > n:
                u = 2 * n - u
                sign = -1
            else:
                sign = 1
            out[k, j] = sign * odd[(u - 1) // 2]
    return out


def _build_dct(n: int) -> np.ndarray:
    if n == 1:
        return np.array([[64]], dtype=np.int64)
    half = _build_dct(n // 2)
    t = np.zeros((n, n), dtype=np.int64)
    t[0::2, : n // 2] = half
    t[0::2, n // 2:] = half[:, ::-1]            # even rows symmetric
    odd = _odd_matrix(n)
    t[1::2, : n // 2] = odd
    t[1::2, n // 2:] = -odd[:, ::-1]            # odd rows antisymmetric
    return t


DCT = {n: _build_dct(n) for n in (4, 8, 16, 32)}


def _t(n: int, dst: bool) -> np.ndarray:
    return DST4 if (dst and n == 4) else DCT[n]


def inverse_transform(coeff: np.ndarray, bit_depth: int = 8,
                      dst: bool = False) -> np.ndarray:
    """Normative inverse transform (8.6.4): clipped 16-bit intermediates."""
    n = coeff.shape[0]
    t = _t(n, dst)
    c = coeff.astype(np.int64)
    e = np.clip((t.T @ c + 64) >> 7, -32768, 32767)
    bd_shift = 20 - bit_depth
    r = np.clip((e @ t + (1 << (bd_shift - 1))) >> bd_shift, -32768, 32767)
    return r.astype(np.int32)
