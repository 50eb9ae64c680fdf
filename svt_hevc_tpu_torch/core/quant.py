"""Quantization / inverse quantization (H.265 8.6.3, flat scaling lists).

Forward quant is HM-style RDO-free scalar quant (non-normative); dequant is
the normative scaling process. Analogue of reference
Source/Lib/Codec/EbTransforms.c UnifiedQuantizeInvQuantize (:2978) without
the two-stage PM path (that RDOQ analogue lands with the BD-rate work).
"""

from __future__ import annotations

import numpy as np

QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16404, 14564], dtype=np.int64)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)


def transform_shift(log2n: int, bit_depth: int = 8) -> int:
    """MAX_TR_DYNAMIC_RANGE(15) - bitDepth - log2(size)."""
    return 15 - bit_depth - log2n


def quantize(coeff: np.ndarray, qp: int, *, is_intra: bool = True,
             bit_depth: int = 8) -> np.ndarray:
    n = coeff.shape[-1]
    log2n = n.bit_length() - 1
    qp = qp + 6 * (bit_depth - 8)     # qP = Qp + QpBdOffset (8.6.3)
    qbits = 14 + qp // 6 + transform_shift(log2n, bit_depth)
    f = QUANT_SCALES[qp % 6]
    offset = (171 if is_intra else 85) << (qbits - 9)
    c = coeff.astype(np.int64)
    level = (np.abs(c) * f + offset) >> qbits
    level = np.clip(level, 0, 32767)
    return (np.sign(c) * level).astype(np.int32)


def quantize_rdoq(coeff: np.ndarray, qp: int, lam: float, *,
                  is_intra: bool = True, bit_depth: int = 8) -> np.ndarray:
    """Rate-distortion optimized quantization: per-coefficient level choice
    L in {0, floor, floor+1} minimising err^2 * Qstep^2 + lambda * bits(L).

    The pixel-domain step for one level error is Qstep =
    invScale[qp%6] * 2^(qp//6 - 6), independent of TB size and bit depth
    (the transform normalisation cancels). The rate model is a coarse
    coefficient-bit estimate (sig + gt1 + gt2 + Golomb tail) — the
    analogue of the reference's PM two-stage quantizer
    (EbTransforms.c PerformTwoStagePm :2219) without per-context CABAC
    state."""
    n = coeff.shape[-1]
    log2n = n.bit_length() - 1
    qp = qp + 6 * (bit_depth - 8)     # qP = Qp + QpBdOffset (8.6.3)
    qbits = 14 + qp // 6 + transform_shift(log2n, bit_depth)
    f = int(QUANT_SCALES[qp % 6])
    c = coeff.astype(np.int64)
    level_f = np.abs(c).astype(np.float64) * f / (1 << qbits)
    lbase = np.floor(level_f)
    # dequant gain for one level: invScale[qp%6] << (qp//6), normalised by
    # the transform's 2^6 pixel-domain factor
    qstep = float(INV_QUANT_SCALES[qp % 6]) * 2.0 ** ((qp // 6) - 6)

    def bits(lv):
        out = np.where(lv == 0, 0.5, 2.0)
        out = out + np.where(lv > 1, 1.0, 0.0)
        out = out + np.where(lv > 2,
                             2.0 * np.log2(np.maximum(lv - 1, 2)), 0.0)
        return out

    best_l = np.zeros_like(lbase)
    best_j = None
    for cand in (np.zeros_like(lbase), lbase, lbase + 1.0):
        cand = np.maximum(cand, 0.0)
        err = (level_f - cand) * qstep
        j = err * err + lam * bits(cand)
        if best_j is None:
            best_j, best_l = j, cand
        else:
            take = j < best_j
            best_j = np.where(take, j, best_j)
            best_l = np.where(take, cand, best_l)
    lv = np.clip(best_l, 0, 32767).astype(np.int64)
    return (np.sign(c) * lv).astype(np.int32)


def dequantize(level: np.ndarray, qp: int, *, bit_depth: int = 8) -> np.ndarray:
    """Normative scaling (8.6.3) for flat (m=16) scaling lists."""
    n = level.shape[-1]
    log2n = n.bit_length() - 1
    qp = qp + 6 * (bit_depth - 8)     # qP = Qp + QpBdOffset (8.6.3)
    shift = 6 - transform_shift(log2n, bit_depth)   # == log2n + bit_depth - 9
    scale = int(INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    lv = np.clip(level.astype(np.int64), -32768, 32767)
    d = (lv * scale + (1 << (shift - 1))) >> shift
    return np.clip(d, -32768, 32767).astype(np.int32)
