"""Inverse quantization (H.265 8.6.3, flat scaling lists): the normative
scaling process."""

from __future__ import annotations

import numpy as np

INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)


def transform_shift(log2n: int, bit_depth: int = 8) -> int:
    """MAX_TR_DYNAMIC_RANGE(15) - bitDepth - log2(size)."""
    return 15 - bit_depth - log2n


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
