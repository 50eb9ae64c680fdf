"""CABAC bit estimator: duck-typed CabacEncoder that accumulates fractional
bits instead of producing bytes.

Drives rate-distortion decisions (mode decision trials encode through this
instead of the real coder). The probability model is the M-coder state
geometry: p_lps(s) = 0.5 * alpha^s with alpha = (0.01875/0.5)^(1/63), the
design constants of the HEVC arithmetic coder.

Analogue of the reference's CABAC-estimate tables
(Source/Lib/Codec/EbMdRateEstimation.{h,c} and
EbCabacContextModel.c estimation contexts), computed rather than tabulated.
"""

from __future__ import annotations

import math

from .contexts import NEXT_STATE_LPS, NEXT_STATE_MPS

_ALPHA = (0.01875 / 0.5) ** (1.0 / 63.0)

# bits[packed_state][bin]: fractional bits to code `bin` in that state
_BITS = [[0.0, 0.0] for _ in range(128)]
for _s in range(64):
    _p_lps = 0.5 * (_ALPHA ** _s)
    _b_lps = -math.log2(_p_lps)
    _b_mps = -math.log2(1.0 - _p_lps)
    for _mps in range(2):
        _packed = (_s << 1) | _mps
        _BITS[_packed][_mps] = _b_mps
        _BITS[_packed][1 - _mps] = _b_lps


class CabacEstimator:
    """Same bin-level API as CabacEncoder; accumulates .bits."""

    __slots__ = ("ctx", "bits")

    def __init__(self, contexts: list[int]):
        self.ctx = contexts
        self.bits = 0.0

    def encode_bin(self, ctx_idx: int, binval: int) -> None:
        state = self.ctx[ctx_idx]
        self.bits += _BITS[state][binval]
        self.ctx[ctx_idx] = (NEXT_STATE_MPS[state] if binval == (state & 1)
                             else NEXT_STATE_LPS[state])

    def encode_bypass(self, binval: int) -> None:
        self.bits += 1.0

    def encode_bypass_bins(self, value: int, nbits: int) -> None:
        self.bits += nbits

    def encode_terminate(self, binval: int) -> None:
        # ~ -log2(510/512) per zero terminate bin; negligible but honest
        self.bits += 0.0057 if binval == 0 else 7.0
