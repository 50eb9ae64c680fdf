"""Bit-level RBSP writer/reader + emulation prevention.

Analogue of the reference's bitstream unit
(reference: Source/Lib/Codec/EbBitstreamUnit.c — OutputBitstreamWrite :97,
OutputBitstreamRBSPToPayload :171), re-designed around Python bytearrays.
All syntax follows ITU-T H.265 section 7.2 (u(n), ue(v), se(v)).
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer producing an RBSP (no emulation prevention)."""

    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0       # bit accumulator, _nbits valid LSBs
        self._nbits = 0

    def u(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        if value < 0 or value >> nbits:
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def flag(self, b) -> None:
        self.u(1 if b else 0, 1)

    def ue(self, value: int) -> None:
        """Exp-Golomb unsigned (H.265 9.2)."""
        if value < 0:
            raise ValueError("ue(v) requires non-negative value")
        code = value + 1
        nbits = code.bit_length()
        self.u(0, nbits - 1)
        self.u(code, nbits)

    def se(self, value: int) -> None:
        """Exp-Golomb signed: k>0 -> 2k-1, k<=0 -> -2k."""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def byte_align(self, bit: int = 0) -> None:
        if self._nbits:
            self.u(bit and ((1 << (8 - self._nbits)) - 1), 8 - self._nbits)

    def rbsp_trailing_bits(self) -> None:
        self.u(1, 1)
        self.byte_align()

    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def write_bytes(self, data: bytes) -> None:
        if self._nbits:
            raise ValueError("write_bytes requires byte alignment")
        self._buf += data

    @property
    def bit_position(self) -> int:
        return 8 * len(self._buf) + self._nbits

    def get_bytes(self) -> bytes:
        if self._nbits:
            raise ValueError("bitstream not byte-aligned")
        return bytes(self._buf)


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte per H.265 7.4.2
    (reference semantics: EbBitstreamUnit.c:171 OutputBitstreamRBSPToPayload).
    """
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


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
