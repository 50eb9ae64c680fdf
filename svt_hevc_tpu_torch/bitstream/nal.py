"""NAL unit framing (H.265 7.3.1.1 / 7.4.2, Annex B byte streams).

Analogue of the reference's NAL assembly inside packetization
(reference: Source/Lib/Codec/EbPacketizationProcess.c:121,
EbEntropyCoding.c EncodeNalUnitHeader).
"""

from __future__ import annotations

import enum

from .bitwriter import rbsp_to_ebsp


class NalUnitType(enum.IntEnum):
    TRAIL_N = 0
    TRAIL_R = 1
    RASL_N = 8
    RASL_R = 9
    BLA_W_LP = 16
    IDR_W_RADL = 19
    IDR_N_LP = 20
    CRA_NUT = 21
    VPS_NUT = 32
    SPS_NUT = 33
    PPS_NUT = 34
    AUD_NUT = 35
    EOS_NUT = 36
    EOB_NUT = 37
    FD_NUT = 38
    PREFIX_SEI_NUT = 39
    SUFFIX_SEI_NUT = 40
    UNSPEC62 = 62        # carries the Dolby Vision RPU (reference:
                         # NAL_UNIT_UNSPECIFIED_62 passthrough,
                         # EbPacketizationProcess.c:733-752)


def nal_header(nal_type: NalUnitType, temporal_id: int = 0, layer_id: int = 0) -> bytes:
    """forbidden_zero(1) | nal_unit_type(6) | nuh_layer_id(6) | nuh_temporal_id_plus1(3)."""
    v = (int(nal_type) << 9) | (layer_id << 3) | (temporal_id + 1)
    return bytes([(v >> 8) & 0x7F, v & 0xFF])


def wrap_nal(nal_type: NalUnitType, rbsp: bytes, *, temporal_id: int = 0,
             long_start_code: bool = True) -> bytes:
    """Wrap an RBSP into an Annex-B NAL unit (start code + header + EBSP)."""
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + nal_header(nal_type, temporal_id) + rbsp_to_ebsp(rbsp)


def split_annexb(stream: bytes):
    """Split an Annex-B byte stream into (NalUnitType, ebsp_payload) tuples.

    The payload excludes the 2-byte NAL header.
    """
    out = []
    i = 0
    n = len(stream)
    starts = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # a 4-byte start code owns the zero byte preceding "00 00 01"
        if k + 1 < len(starts) and e > s and stream[e - 1] == 0:
            e -= 1
        nal = stream[s:e]
        if len(nal) < 2:
            continue
        ntype = NalUnitType((nal[0] >> 1) & 0x3F)
        out.append((ntype, nal[2:]))
    return out
