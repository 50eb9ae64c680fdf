"""SEI message syntax (H.265 Annex D / 7.3.5).

Writers for the metadata SEIs the reference emits (reference:
Source/Lib/Codec/EbEntropyCoding.c :8349-9191 — user data, recovery point,
content light level, mastering display) plus parsers for tests. Messages
are wrapped in PREFIX_SEI NAL units by the caller.
"""

from __future__ import annotations

from dataclasses import dataclass

from .bitwriter import BitReader, BitWriter

SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_FILLER_PAYLOAD = 3
SEI_USER_DATA_REGISTERED = 4     # ITU-T T.35
SEI_USER_DATA_UNREGISTERED = 5
SEI_RECOVERY_POINT = 6
SEI_ACTIVE_PARAMETER_SETS = 129
SEI_TEMPORAL_MCTS = 133          # temporal_motion_constrained_tile_sets
SEI_MASTERING_DISPLAY = 137
SEI_CONTENT_LIGHT_LEVEL = 144

# HRD timing-field lengths signalled in hrd_parameters() (headers.py):
# initial_cpb_removal 24 bits, au_cpb_removal 16 bits, dpb_output 6 bits
INITIAL_CPB_LEN = 24
AU_CPB_LEN = 16
DPB_OUT_LEN = 6


def _wrap_payload(payload_type: int, payload: bytes) -> bytes:
    """sei_message(): ff-escaped payload type and size + payload."""
    out = bytearray()
    t = payload_type
    while t >= 255:
        out.append(255)
        t -= 255
    out.append(t)
    s = len(payload)
    while s >= 255:
        out.append(255)
        s -= 255
    out.append(s)
    out += payload
    return bytes(out)


def sei_rbsp(messages: list[bytes]) -> bytes:
    """Assemble one SEI RBSP: the messages + rbsp_trailing_bits."""
    return b"".join(messages) + b"\x80"


def write_buffering_period(initial_cpb_removal_delay: int,
                           initial_cpb_removal_offset: int) -> bytes:
    """buffering_period SEI (D.2.2), NAL HRD only, one CPB, no sub-pic
    params (reference analogue: EbEntropyCoding.c buffering-period SEI,
    :8349+). Delays in 90 kHz clock units, coded in INITIAL_CPB_LEN bits."""
    w = BitWriter()
    w.ue(0)                   # bp_seq_parameter_set_id
    w.flag(0)                 # irap_cpb_params_present_flag
    w.flag(0)                 # concatenation_flag
    w.u(0, AU_CPB_LEN)        # au_cpb_removal_delay_delta_minus1
    w.u(min(initial_cpb_removal_delay, (1 << INITIAL_CPB_LEN) - 1),
        INITIAL_CPB_LEN)      # nal_initial_cpb_removal_delay[0]
    w.u(min(initial_cpb_removal_offset, (1 << INITIAL_CPB_LEN) - 1),
        INITIAL_CPB_LEN)      # nal_initial_cpb_removal_offset[0]
    w.rbsp_trailing_bits()
    return _wrap_payload(SEI_BUFFERING_PERIOD, w.get_bytes())


def write_pic_timing(au_cpb_removal_delay_minus1: int,
                     pic_dpb_output_delay: int,
                     pic_struct: int | None = None) -> bytes:
    """pic_timing SEI (D.2.3): CPB/DPB delays (CpbDpbDelaysPresentFlag = 1
    via hrd_parameters) and, for interlaced signalling
    (frame_field_info_present_flag), pic_struct (1 = top field, 2 =
    bottom field; reference: EbSei.c:92)."""
    w = BitWriter()
    if pic_struct is not None:
        w.u(pic_struct, 4)   # pic_struct
        w.u(0, 2)            # source_scan_type (0 = interlaced)
        w.flag(0)            # duplicate_flag
    w.u(min(au_cpb_removal_delay_minus1, (1 << AU_CPB_LEN) - 1), AU_CPB_LEN)
    w.u(min(pic_dpb_output_delay, (1 << DPB_OUT_LEN) - 1), DPB_OUT_LEN)
    w.rbsp_trailing_bits()
    return _wrap_payload(SEI_PIC_TIMING, w.get_bytes())


def write_user_data_unregistered(uuid: bytes, data: bytes) -> bytes:
    assert len(uuid) == 16
    return _wrap_payload(SEI_USER_DATA_UNREGISTERED, uuid + data)


def write_user_data_registered(t35_bytes: bytes) -> bytes:
    """user_data_registered_itu_t_t35 (D.2.6; reference:
    EncodeRegUserDataSEI, EbEntropyCoding.c:8812): the payload is the raw
    T.35 bytes starting with country code."""
    return _wrap_payload(SEI_USER_DATA_REGISTERED, t35_bytes)


def write_filler_payload(n: int) -> bytes:
    """filler_payload (D.2.4): n bytes of 0xFF. Used to hold the VBV
    buffer down in CBR mode (reference: filler-bit insertion in
    Packetization, EbPacketizationProcess.c:708-723)."""
    return _wrap_payload(SEI_FILLER_PAYLOAD, b"\xff" * n)


def write_recovery_point(recovery_poc_cnt: int = 0, *,
                         exact_match: bool = True,
                         broken_link: bool = False) -> bytes:
    w = BitWriter()
    w.se(recovery_poc_cnt)
    w.flag(exact_match)
    w.flag(broken_link)
    w.rbsp_trailing_bits()
    return _wrap_payload(SEI_RECOVERY_POINT, w.get_bytes())


def write_content_light_level(max_cll: int, max_fall: int) -> bytes:
    w = BitWriter()
    w.u(max_cll, 16)
    w.u(max_fall, 16)
    return _wrap_payload(SEI_CONTENT_LIGHT_LEVEL, w.get_bytes())


def write_mastering_display(primaries: list[tuple[int, int]],
                            white_point: tuple[int, int],
                            max_luma: int, min_luma: int) -> bytes:
    """display_primaries in 0.00002 units (G, B, R order per spec),
    luminance in 0.0001 cd/m^2 units."""
    assert len(primaries) == 3
    w = BitWriter()
    for x, y in primaries:
        w.u(x, 16)
        w.u(y, 16)
    w.u(white_point[0], 16)
    w.u(white_point[1], 16)
    w.u(max_luma, 32)
    w.u(min_luma, 32)
    return _wrap_payload(SEI_MASTERING_DISPLAY, w.get_bytes())


def write_temporal_mcts() -> bytes:
    """temporal_motion_constrained_tile_sets (D.2.29): the
    each_tile_one_tile_set form — every tile is its own independently
    extractable motion-constrained tile set."""
    w = BitWriter()
    w.flag(0)            # mc_all_tiles_exact_sample_value_match_flag
    w.flag(1)            # each_tile_one_tile_set_flag
    # limited_tile_set_display_flag exists only in the
    # !each_tile_one_tile_set_flag branch (D.2.29) — not written here
    w.flag(1)            # max_mcs_tier_level_idc_present_flag
    # with each_tile_one_tile_set: no per-set loop; the flags above fully
    # describe the sets. mcts_max_tier_level follows when present:
    w.flag(0)            # mcts_tier_flag
    w.u(0, 8)            # mcts_level_idc (0 = unspecified)
    w.rbsp_trailing_bits()
    return _wrap_payload(SEI_TEMPORAL_MCTS, w.get_bytes())


def write_active_parameter_sets() -> bytes:
    w = BitWriter()
    w.u(0, 4)            # active_video_parameter_set_id
    w.flag(1)            # self_contained_cvs_flag
    w.flag(0)            # no_parameter_set_update_flag
    w.ue(0)              # num_sps_ids_minus1
    w.ue(0)              # active_seq_parameter_set_id[0]
    w.rbsp_trailing_bits()
    return _wrap_payload(SEI_ACTIVE_PARAMETER_SETS, w.get_bytes())


@dataclass
class SeiMessage:
    payload_type: int
    payload: bytes


def parse_sei_rbsp(rbsp: bytes) -> list[SeiMessage]:
    """Split an SEI RBSP into messages; the final 0x80 is the RBSP
    trailing byte."""
    out = []
    i = 0
    while i < len(rbsp) - 1:
        t = 0
        while rbsp[i] == 255:
            t += 255
            i += 1
        t += rbsp[i]
        i += 1
        s = 0
        while rbsp[i] == 255:
            s += 255
            i += 1
        s += rbsp[i]
        i += 1
        out.append(SeiMessage(t, rbsp[i:i + s]))
        i += s
    return out
