"""Bit-level RBSP reader and the removal of emulation prevention bytes
(ITU-T H.265 section 7.2: u(n), ue(v), se(v)).
"""

from __future__ import annotations


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Strip emulation_prevention_three_byte."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 <= n:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


class BitReader:
    """MSB-first bit reader over an RBSP (for the decoder / tests)."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def u(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.bit()
        return v

    def bit(self) -> int:
        byte_idx = self._pos >> 3
        if byte_idx >= len(self._data):
            # past-the-end bits read as 0 (CABAC renorm may over-read)
            self._pos += 1
            return 0
        b = (self._data[byte_idx] >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return b

    def flag(self) -> bool:
        return bool(self.bit())

    def ue(self) -> int:
        nzeros = 0
        while self.bit() == 0:
            nzeros += 1
            if nzeros > 32:
                raise ValueError("invalid exp-golomb code")
        return (1 << nzeros) - 1 + (self.u(nzeros) if nzeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    @property
    def bit_position(self) -> int:
        return self._pos

    @bit_position.setter
    def bit_position(self, pos: int) -> None:
        self._pos = pos

    def bytes_remaining(self) -> int:
        return len(self._data) - ((self._pos + 7) >> 3)

    def more_rbsp_data(self) -> bool:
        # true if any bit beyond current pos, excluding the final
        # rbsp_stop_one_bit and trailing zeros
        data = self._data
        last = len(data) - 1
        while last >= 0 and data[last] == 0:
            last -= 1
        if last < 0:
            return False
        stop_bit_pos = 8 * last + 7
        b = data[last]
        k = 0
        while (b >> k) & 1 == 0:
            k += 1
        stop_bit_pos -= k
        return self._pos < stop_bit_pos
