"""CABAC binary arithmetic decoding (ITU-T H.265 section 9.3.4.3, the
normative decoding process); contexts are the flat packed-state list of
contexts.py."""

from __future__ import annotations

from .contexts import NEXT_STATE_LPS, NEXT_STATE_MPS, RANGE_TAB_LPS


class CabacDecoder:
    """Normative CABAC decoding engine (H.265 9.3.4.3)."""

    __slots__ = ("range", "offset", "_data", "_bitpos", "ctx")

    def __init__(self, data: bytes, contexts: list[int] | None = None,
                 start_bit: int = 0) -> None:
        self._data = data
        self._bitpos = start_bit
        self.ctx = contexts if contexts is not None else []
        self.range = 510
        self.offset = self._read_bits(9)

    def _read_bits(self, n: int) -> int:
        v = 0
        data, pos = self._data, self._bitpos
        for _ in range(n):
            byte_idx = pos >> 3
            bit = (data[byte_idx] >> (7 - (pos & 7))) & 1 if byte_idx < len(data) else 0
            v = (v << 1) | bit
            pos += 1
        self._bitpos = pos
        return v

    def decode_bin(self, ctx_idx: int) -> int:
        state = self.ctx[ctx_idx]
        lps = RANGE_TAB_LPS[state >> 1][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            binval = 1 - (state & 1)
            self.offset -= self.range
            self.range = lps
            self.ctx[ctx_idx] = NEXT_STATE_LPS[state]
        else:
            binval = state & 1
            self.ctx[ctx_idx] = NEXT_STATE_MPS[state]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        return binval

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bits(1)
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bins(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        return 0
