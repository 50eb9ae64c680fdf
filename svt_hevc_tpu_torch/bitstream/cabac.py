"""CABAC binary arithmetic codec (ITU-T H.265 section 9.3.4).

Encoder follows the carry-buffered low/range formulation (the same
arithmetic as the spec's EncodeDecision/EncodeBypass/EncodeFlush flowcharts);
decoder follows the normative decoding process 9.3.4.3 exactly — the decoder
is the conformance anchor for roundtrip tests.

Analogue of reference Source/Lib/Codec/EbEntropyCodingUtil.c (EncodeOneBin
:154, EncodeBypassOneBin :196, WriteOut :109), re-designed: contexts are a
flat packed-state list (see contexts.py) so slices/tiles can own independent
cheap-to-clone entropy state (per-tile parallel CABAC is the scaling axis,
reference EbEntropyCodingProcess.c:313).

This Python implementation is the reference backend; svt_hevc_tpu.native
provides the production C backend (equivalence-tested, the analogue of the
reference's C_DEFAULT vs ASM backend pairing).
"""

from __future__ import annotations

from .contexts import (NEXT_STATE_LPS, NEXT_STATE_MPS, RANGE_TAB_LPS,
                       RENORM_TABLE)


class CabacEncoder:
    """Binary arithmetic encoder. Output via .data after finish()."""

    __slots__ = ("low", "range", "bits_left", "num_buffered", "buffered_byte",
                 "buf", "ctx")

    def __init__(self, contexts: list[int] | None = None) -> None:
        self.ctx = contexts if contexts is not None else []
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered = 0
        self.buffered_byte = 0xFF
        self.buf = bytearray()

    # -------------------------------------------------------------- bins
    def encode_bin(self, ctx_idx: int, binval: int) -> None:
        state = self.ctx[ctx_idx]
        lps = RANGE_TAB_LPS[state >> 1][(self.range >> 6) & 3]
        self.range -= lps
        if binval != (state & 1):
            nbits = RENORM_TABLE[lps >> 3]
            self.low = (self.low + self.range) << nbits
            self.range = lps << nbits
            self.ctx[ctx_idx] = NEXT_STATE_LPS[state]
            self.bits_left -= nbits
        else:
            self.ctx[ctx_idx] = NEXT_STATE_MPS[state]
            if self.range >= 256:
                return
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bypass(self, binval: int) -> None:
        self.low <<= 1
        if binval:
            self.low += self.range
        self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bypass_bins(self, value: int, nbits: int) -> None:
        while nbits > 8:
            nbits -= 8
            pattern = value >> nbits
            self.low = (self.low << 8) + self.range * pattern
            value -= pattern << nbits
            self.bits_left -= 8
            if self.bits_left < 12:
                self._write_out()
        if nbits:
            self.low = (self.low << nbits) + self.range * value
            self.bits_left -= nbits
            if self.bits_left < 12:
                self._write_out()

    def encode_terminate(self, binval: int) -> None:
        self.range -= 2
        if binval:
            self.low += self.range
            self.low <<= 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    # ------------------------------------------------------------- output
    def _write_out(self) -> None:
        lead = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= (1 << (32 - self.bits_left)) - 1
        if lead == 0xFF:
            self.num_buffered += 1
        elif self.num_buffered > 0:
            carry = lead >> 8
            self.buf.append((self.buffered_byte + carry) & 0xFF)
            fill = (0xFF + carry) & 0xFF
            for _ in range(self.num_buffered - 1):
                self.buf.append(fill)
            self.buffered_byte = lead & 0xFF
            self.num_buffered = 1
        else:
            self.num_buffered = 1
            self.buffered_byte = lead

    def finish(self) -> None:
        """Flush after the final terminate bin (spec EncodeFlush semantics)."""
        if self.low >> (32 - self.bits_left):
            self.buf.append((self.buffered_byte + 1) & 0xFF)
            for _ in range(self.num_buffered - 1):
                self.buf.append(0x00)
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered > 0:
                self.buf.append(self.buffered_byte)
            for _ in range(self.num_buffered - 1):
                self.buf.append(0xFF)
        nbits = 24 - self.bits_left
        val = (self.low >> 8) & ((1 << nbits) - 1) if nbits > 0 else 0
        # emit remaining bits MSB-first, then the rbsp stop bit + alignment
        bits = []
        for i in range(nbits - 1, -1, -1):
            bits.append((val >> i) & 1)
        bits.append(1)  # rbsp_stop_one_bit
        while len(bits) % 8:
            bits.append(0)
        for i in range(0, len(bits), 8):
            byte = 0
            for b in bits[i:i + 8]:
                byte = (byte << 1) | b
            self.buf.append(byte)

    @property
    def data(self) -> bytes:
        return bytes(self.buf)


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
