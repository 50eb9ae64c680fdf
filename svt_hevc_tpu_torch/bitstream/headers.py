"""High-level syntax: VPS / SPS / PPS / slice segment header (H.265 7.3.2-7.3.6).

Writers are used by the encoder's packetization stage (analogue of
reference: Source/Lib/Codec/EbEntropyCoding.c CodeVPS/CodeSPS/CodePPS/
CodeSliceHeader :5357,:5931,:6167,:6441); parsers feed the conformance
decoder in svt_hevc_tpu.decoder.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..config import EncoderConfig
from ..level import derive_level
from .bitwriter import BitReader, BitWriter


# --------------------------------------------------------------------- writers

def _write_profile_tier_level(w: BitWriter, cfg: EncoderConfig,
                              max_sub_layers_minus1: int = 0) -> None:
    """profile_tier_level() (H.265 7.3.3): Main (1), Main10 (2) or
    format-range extensions (4) with REXT constraint flags — the reference
    requires REXT for 422/444 (EbEncHandle.c:2454-2456)."""
    profile_idc = cfg.profile
    level, high_tier = derive_level(cfg)
    w.u(0, 2)            # general_profile_space
    w.flag(int(high_tier))   # general_tier_flag
    w.u(profile_idc, 5)
    compat = {4} if profile_idc == 4 else {1, 2}
    for i in range(32):  # general_profile_compatibility_flag[i]
        w.flag(i in compat)
    w.flag(1)            # general_progressive_source_flag
    w.flag(0)            # general_interlaced_source_flag
    w.flag(0)            # general_non_packed_constraint_flag
    w.flag(1)            # general_frame_only_constraint_flag
    if profile_idc == 4:
        # REXT constraint flags (7.3.3): Main 4:2:2 10 / Main 4:4:4 [10]
        w.flag(1)        # general_max_12bit_constraint_flag
        w.flag(1)        # general_max_10bit_constraint_flag
        w.flag(int(cfg.bit_depth == 8 and cfg.chroma_format == 3))  # max_8bit
        w.flag(int(cfg.chroma_format == 2))   # general_max_422chroma
        w.flag(0)        # general_max_420chroma_constraint_flag
        w.flag(0)        # general_max_monochrome_constraint_flag
        w.flag(0)        # general_intra_constraint_flag
        w.flag(0)        # general_one_picture_only_constraint_flag
        w.flag(1)        # general_lower_bit_rate_constraint_flag
        w.u(0, 32)       # general_reserved_zero_34bits (part 1)
        w.u(0, 2)        # general_reserved_zero_34bits (part 2)
    else:
        w.u(0, 32)       # general_reserved_zero_43bits (part 1)
        w.u(0, 11)       # general_reserved_zero_43bits (part 2)
    w.flag(0)            # general_reserved_zero_bit / inbld
    w.u(level.idc, 8)
    assert max_sub_layers_minus1 == 0


def _dpb_size_minus1(cfg: EncoderConfig) -> int:
    """sps/vps_max_dec_pic_buffering_minus1: retained references + the
    current picture (A.4 DPB constraint; reference derives this from the
    prediction structure, EbSequenceControlSet)."""
    hl = cfg.hierarchical_levels
    if cfg.pred_structure == 2:
        return hl + 3           # anchor pair + one per hierarchy layer
    return max(hl + 1, 1)       # one retained picture per temporal layer


def _max_reorder(cfg: EncoderConfig) -> int:
    """sps/vps_max_num_reorder_pics: only random access reorders output.

    The hierarchical-B schedule (_ra_segment) reorders by at most
    `hierarchical_levels` pictures, and 7.4.3.2.1 requires
    max_num_reorder_pics <= max_dec_pic_buffering_minus1 (the reference
    clamps the same way, ComputeNumReorderPics)."""
    if cfg.pred_structure == 2:
        return min(max(cfg.hierarchical_levels, 1), _dpb_size_minus1(cfg))
    return 0


def write_vps(cfg: EncoderConfig) -> bytes:
    w = BitWriter()
    w.u(0, 4)            # vps_video_parameter_set_id
    w.flag(1)            # vps_base_layer_internal_flag
    w.flag(1)            # vps_base_layer_available_flag
    w.u(0, 6)            # vps_max_layers_minus1
    w.u(0, 3)            # vps_max_sub_layers_minus1
    w.flag(1)            # vps_temporal_id_nesting_flag
    w.u(0xFFFF, 16)      # vps_reserved_0xffff_16bits
    _write_profile_tier_level(w, cfg)
    w.flag(1)            # vps_sub_layer_ordering_info_present_flag
    w.ue(_dpb_size_minus1(cfg))   # vps_max_dec_pic_buffering_minus1[0]
    w.ue(_max_reorder(cfg))       # vps_max_num_reorder_pics[0]
    w.ue(0)              # vps_max_latency_increase_plus1[0]
    w.u(0, 6)            # vps_max_layer_id
    w.ue(0)              # vps_num_layer_sets_minus1
    w.flag(0)            # vps_timing_info_present_flag
    w.flag(0)            # vps_extension_flag
    w.rbsp_trailing_bits()
    return w.get_bytes()


def write_sps(cfg: EncoderConfig) -> bytes:
    w = BitWriter()
    w.u(0, 4)            # sps_video_parameter_set_id
    w.u(0, 3)            # sps_max_sub_layers_minus1
    w.flag(1)            # sps_temporal_id_nesting_flag
    _write_profile_tier_level(w, cfg)
    w.ue(0)              # sps_seq_parameter_set_id
    w.ue(cfg.chroma_format)   # chroma_format_idc (1=420, 2=422, 3=444)
    if cfg.chroma_format == 3:
        w.flag(0)        # separate_colour_plane_flag
    w.ue(cfg.coded_width)     # pic_width_in_luma_samples
    w.ue(cfg.coded_height)
    crop = cfg.conf_win_right or cfg.conf_win_bottom
    w.flag(1 if crop else 0)  # conformance_window_flag
    if crop:
        w.ue(0)                    # conf_win_left_offset
        w.ue(cfg.conf_win_right)   # conf_win_right_offset (chroma units)
        w.ue(0)                    # conf_win_top_offset
        w.ue(cfg.conf_win_bottom)
    w.ue(cfg.bit_depth - 8)   # bit_depth_luma_minus8
    w.ue(cfg.bit_depth - 8)   # bit_depth_chroma_minus8
    w.ue(4)              # log2_max_pic_order_cnt_lsb_minus4 -> 8 bits of POC lsb
    w.flag(1)            # sps_sub_layer_ordering_info_present_flag
    w.ue(_dpb_size_minus1(cfg))   # sps_max_dec_pic_buffering_minus1[0]
    w.ue(_max_reorder(cfg))       # sps_max_num_reorder_pics[0]
    w.ue(0)              # sps_max_latency_increase_plus1[0]
    w.ue(0)              # log2_min_luma_coding_block_size_minus3 -> MinCbSizeY=8
    w.ue(cfg.ctb_log2 - 3)    # log2_diff_max_min_luma_coding_block_size
    w.ue(0)              # log2_min_luma_transform_block_size_minus2 -> 4
    w.ue(3)              # log2_diff_max_min_luma_transform_block_size -> max TU 32
    w.ue(2)              # max_transform_hierarchy_depth_inter (RQT)
    w.ue(0)              # max_transform_hierarchy_depth_intra
    w.flag(0)            # scaling_list_enabled_flag
    w.flag(0)            # amp_enabled_flag
    w.flag(1 if cfg.enable_sao else 0)  # sample_adaptive_offset_enabled_flag
    w.flag(0)            # pcm_enabled_flag
    w.ue(0)              # num_short_term_ref_pic_sets
    w.flag(0)            # long_term_ref_pics_present_flag
    w.flag(1 if cfg.tmvp else 0)   # sps_temporal_mvp_enabled_flag
    w.flag(0)            # strong_intra_smoothing_enabled_flag
    w.flag(1)            # vui_parameters_present_flag
    # ---- vui_parameters() (E.2.1): timing info only ----
    w.flag(0)            # aspect_ratio_info_present_flag
    w.flag(0)            # overscan_info_present_flag
    w.flag(0)            # video_signal_type_present_flag
    w.flag(0)            # chroma_loc_info_present_flag
    w.flag(0)            # neutral_chroma_indication_flag
    # progressive only: interlaced input is not supported (the reference's
    # fieldSeqFlag path, EbEncHandle.c:1921, requires pic_struct in every
    # pic_timing SEI — hard-coded 0 until interlaced support lands)
    w.flag(0)            # field_seq_flag
    w.flag(0)            # frame_field_info_present_flag
    w.flag(0)            # default_display_window_flag
    w.flag(1)            # vui_timing_info_present_flag
    w.u(cfg.fps_den, 32)      # vui_num_units_in_tick
    w.u(cfg.fps_num, 32)      # vui_time_scale
    w.flag(0)            # vui_poc_proportional_to_timing_flag
    hrd = getattr(cfg, "enable_hrd", False)
    w.flag(1 if hrd else 0)   # vui_hrd_parameters_present_flag
    if hrd:
        _write_hrd_parameters(w, cfg)
    w.flag(0)            # bitstream_restriction_flag
    w.flag(0)            # sps_extension_present_flag
    w.rbsp_trailing_bits()
    return w.get_bytes()


# HRD scales: BitRate = (value+1) << (6+scale), CpbSize = (value+1) << (4+scale)
HRD_BIT_RATE_SCALE = 4       # 1024-bit/s units
HRD_CPB_SIZE_SCALE = 6       # 1024-bit units


def hrd_rate_size(cfg) -> tuple[int, int]:
    """(max bitrate, CPB size) in bits as actually signalled (rounded up to
    the HRD scale granularity)."""
    rate = cfg.vbv_maxrate or cfg.target_bitrate
    size = cfg.vbv_bufsize or rate
    rv = max((rate + (1 << (6 + HRD_BIT_RATE_SCALE)) - 1)
             >> (6 + HRD_BIT_RATE_SCALE), 1)
    sv = max((size + (1 << (4 + HRD_CPB_SIZE_SCALE)) - 1)
             >> (4 + HRD_CPB_SIZE_SCALE), 1)
    return rv << (6 + HRD_BIT_RATE_SCALE), sv << (4 + HRD_CPB_SIZE_SCALE)


def _write_hrd_parameters(w: BitWriter, cfg) -> None:
    """hrd_parameters() (E.2.2): NAL HRD, one CPB, no sub-pic timing
    (reference analogue: EbEntropyCoding.c CodeHrdParameters :5504)."""
    rate, size = hrd_rate_size(cfg)
    w.flag(1)            # nal_hrd_parameters_present_flag
    w.flag(0)            # vcl_hrd_parameters_present_flag
    w.flag(0)            # sub_pic_hrd_params_present_flag
    w.u(HRD_BIT_RATE_SCALE, 4)
    w.u(HRD_CPB_SIZE_SCALE, 4)
    w.u(23, 5)           # initial_cpb_removal_delay_length_minus1 (24 bits)
    w.u(15, 5)           # au_cpb_removal_delay_length_minus1 (16 bits)
    w.u(5, 5)            # dpb_output_delay_length_minus1 (6 bits)
    # sub-layer 0
    w.flag(1)            # fixed_pic_rate_general_flag
    w.ue(0)              # elemental_duration_in_tc_minus1
    w.ue(0)              # cpb_cnt_minus1
    # nal sub_layer_hrd_parameters(0)
    w.ue((rate >> (6 + HRD_BIT_RATE_SCALE)) - 1)   # bit_rate_value_minus1
    w.ue((size >> (4 + HRD_CPB_SIZE_SCALE)) - 1)   # cpb_size_value_minus1
    w.flag(0)            # cbr_flag (VBR operation)


def write_pps(cfg: EncoderConfig) -> bytes:
    w = BitWriter()
    w.ue(0)              # pps_pic_parameter_set_id
    w.ue(0)              # pps_seq_parameter_set_id
    w.flag(0)            # dependent_slice_segments_enabled_flag
    w.flag(0)            # output_flag_present_flag
    w.u(0, 3)            # num_extra_slice_header_bits
    w.flag(0)            # sign_data_hiding_enabled_flag
    w.flag(0)            # cabac_init_present_flag
    w.ue(0)              # num_ref_idx_l0_default_active_minus1
    w.ue(0)              # num_ref_idx_l1_default_active_minus1
    w.se(0)              # init_qp_minus26
    w.flag(1 if cfg.constrained_intra else 0)  # constrained_intra_pred_flag
    w.flag(0)            # transform_skip_enabled_flag
    aqp = getattr(cfg, "adaptive_qp", False)
    w.flag(1 if aqp else 0)      # cu_qp_delta_enabled_flag
    if aqp:
        w.ue(0)                  # diff_cu_qp_delta_depth (QG = CTB)
    w.se(0)              # pps_cb_qp_offset
    w.se(0)              # pps_cr_qp_offset
    w.flag(0)            # pps_slice_chroma_qp_offsets_present_flag
    w.flag(0)            # weighted_pred_flag
    w.flag(0)            # weighted_bipred_flag
    w.flag(0)            # transquant_bypass_enabled_flag
    tiles = cfg.tile_columns > 1 or cfg.tile_rows > 1
    w.flag(1 if tiles else 0)   # tiles_enabled_flag
    w.flag(0)            # entropy_coding_sync_enabled_flag
    if tiles:
        w.ue(cfg.tile_columns - 1)   # num_tile_columns_minus1
        w.ue(cfg.tile_rows - 1)      # num_tile_rows_minus1
        w.flag(1)                    # uniform_spacing_flag
        # MCTS requires loop filters to stop at tile boundaries
        w.flag(0 if cfg.constrained_motion_tiles else 1)
        #                            # loop_filter_across_tiles_enabled_flag
    w.flag(1)            # pps_loop_filter_across_slices_enabled_flag
    w.flag(1)            # deblocking_filter_control_present_flag
    w.flag(0)            #   deblocking_filter_override_enabled_flag
    w.flag(0 if cfg.enable_deblocking else 1)  # pps_deblocking_filter_disabled_flag
    if cfg.enable_deblocking:
        w.se(0)          # pps_beta_offset_div2
        w.se(0)          # pps_tc_offset_div2
    w.flag(0)            # pps_scaling_list_data_present_flag
    w.flag(0)            # lists_modification_present_flag
    w.ue(0)              # log2_parallel_merge_level_minus2
    w.flag(0)            # slice_segment_header_extension_present_flag
    w.flag(0)            # pps_extension_present_flag
    w.rbsp_trailing_bits()
    return w.get_bytes()


def write_slice_header(cfg: EncoderConfig, *, slice_qp: int, is_idr: bool = True,
                       poc: int = 0, slice_type: int = 2,
                       entry_points: list[int] | None = None,
                       neg_deltas: list[int] | None = None,
                       pos_deltas: list[int] | None = None,
                       first_slice: bool = True,
                       slice_address: int = 0,
                       irap: bool | None = None) -> BitWriter:
    """Write the slice segment header; returns the open BitWriter so slice
    data (CABAC payload) can be appended after byte alignment.

    slice_type: 2 = I, 1 = P, 0 = B. neg_deltas/pos_deltas: the inline
    short-term RPS — each entry is either a bare POC delta (used by the
    current picture) or a (delta, used) pair; used=0 entries keep a
    picture in the DPB for FUTURE pictures without referencing it now
    (7.4.8 sliding-window semantics: anything absent from the RPS is
    evicted). Non-first slices carry slice_segment_address (7.4.7.1)."""
    w = BitWriter()
    if irap is None:
        irap = is_idr        # CRA slices: irap=True with is_idr=False
    w.flag(1 if first_slice else 0)  # first_slice_segment_in_pic_flag
    if irap:
        w.flag(0)        # no_output_of_prior_pics_flag
    w.ue(0)              # slice_pic_parameter_set_id
    if not first_slice:
        n_ctbs = cfg.pic_width_in_ctbs * cfg.pic_height_in_ctbs
        w.u(slice_address, max((n_ctbs - 1).bit_length(), 1))
    w.ue(slice_type)
    if not is_idr:
        w.u(poc & 0xFF, 8)   # slice_pic_order_cnt_lsb (log2_max_poc_lsb = 8)
        w.flag(0)            # short_term_ref_pic_set_sps_flag -> inline RPS
        def entries(lst, default):
            lst = lst if lst is not None else default
            return [e if isinstance(e, tuple) else (e, 1) for e in lst]
        negs = entries(neg_deltas, [1])
        poss = entries(pos_deltas, [])
        w.ue(len(negs))      # num_negative_pics
        w.ue(len(poss))      # num_positive_pics
        prev = 0
        for d, used in negs:  # deltas from current POC, increasing distance
            w.ue(d - prev - 1)        # delta_poc_s0_minus1
            w.flag(used)              # used_by_curr_pic_s0_flag
            prev = d
        prev = 0
        for d, used in poss:
            w.ue(d - prev - 1)        # delta_poc_s1_minus1
            w.flag(used)
            prev = d
        if cfg.tmvp:
            w.flag(1)    # slice_temporal_mvp_enabled_flag
    if cfg.enable_sao:
        w.flag(1)        # slice_sao_luma_flag
        w.flag(1)        # slice_sao_chroma_flag
    if slice_type != 2:
        w.flag(0)        # num_ref_idx_active_override_flag (default: 1 ref)
        if slice_type == 0:
            w.flag(0)    # mvd_l1_zero_flag
        if cfg.tmvp and not is_idr:
            if slice_type == 0:
                w.flag(1)    # collocated_from_l0_flag
            # collocated_ref_idx not signalled: one active ref per list
        w.ue(0)          # five_minus_max_num_merge_cand -> MaxNumMergeCand=5
    w.se(slice_qp - 26)  # slice_qp_delta (init_qp = 26)
    if cfg.enable_sao or cfg.enable_deblocking:
        w.flag(1)        # slice_loop_filter_across_slices_enabled_flag
    if cfg.tile_columns > 1 or cfg.tile_rows > 1:
        # per-tile substream entry points (7.3.6.1; reference analogue:
        # EbEntropyCoding.c :6740 tile entry-point offsets)
        eps = entry_points or []
        w.ue(len(eps))               # num_entry_point_offsets
        if eps:
            ln = max(max(e - 1 for e in eps).bit_length(), 1)
            w.ue(ln - 1)             # offset_len_minus1
            for e in eps:
                w.u(e - 1, ln)       # entry_point_offset_minus1
    # byte_alignment() before slice data
    w.flag(1)            # alignment_bit_equal_to_one
    w.byte_align()
    return w


# --------------------------------------------------------------------- parsers

@dataclass
class Sps:
    chroma_format_idc: int = 1
    width: int = 0               # pic_width_in_luma_samples
    height: int = 0
    conf_win: tuple = (0, 0, 0, 0)   # left, right, top, bottom (chroma units)
    bit_depth: int = 8
    log2_max_poc_lsb: int = 8
    log2_min_cb: int = 3
    log2_ctb: int = 6
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    amp_enabled: bool = False
    sao_enabled: bool = False
    scaling_list_enabled: bool = False
    pcm_enabled: bool = False
    strong_intra_smoothing: bool = False
    temporal_mvp: bool = False


def tile_grid(n_ctb_x: int, n_ctb_y: int, cols: int, rows: int):
    """Uniform tile partitioning (6.5.1): returns (col_bounds, row_bounds)
    in CTB units, each a list of cols+1 / rows+1 boundaries."""
    cb = [(i * n_ctb_x) // cols for i in range(cols + 1)]
    rb = [(j * n_ctb_y) // rows for j in range(rows + 1)]
    return cb, rb


@dataclass
class Pps:
    init_qp: int = 26
    constrained_intra: bool = False
    transform_skip: bool = False
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: bool = False
    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    transquant_bypass: bool = False
    tiles_enabled: bool = False
    tile_columns: int = 1
    tile_rows: int = 1
    loop_filter_across_tiles: bool = True
    entropy_coding_sync: bool = False
    deblocking_disabled: bool = True
    deblocking_control_present: bool = False
    deblocking_override_enabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    loop_filter_across_slices: bool = True


@dataclass
class SliceHeader:
    slice_type: int = 2
    slice_qp: int = 26
    is_idr: bool = True
    poc: int = 0
    sao_luma: bool = False
    sao_chroma: bool = False
    max_num_merge_cand: int = 5
    temporal_mvp: bool = False
    col_from_l0: bool = True
    neg_deltas: list = field(default_factory=list)     # past-ref POC deltas
    pos_deltas: list = field(default_factory=list)     # future-ref POC deltas
    keep_neg: list = field(default_factory=list)       # all RPS neg deltas
    keep_pos: list = field(default_factory=list)       # all RPS pos deltas
    entry_points: list = field(default_factory=list)   # substream byte sizes
    data_bit_offset: int = 0     # bit offset of slice data in the RBSP
    first_slice: bool = True
    slice_address: int = 0       # first CTB raster address (7.4.7.1)
    deblock_disabled: bool = True       # effective (PPS or slice override)
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    cb_qp_offset: int = 0               # slice-level chroma QP offsets
    cr_qp_offset: int = 0


def _parse_profile_tier_level(r: BitReader, max_sub_layers_minus1: int = 0) -> None:
    r.u(2 + 1 + 5)
    r.u(32)
    r.u(4)
    r.u(32)
    r.u(12)
    r.u(8)   # level idc


def parse_sps(rbsp: bytes) -> Sps:
    r = BitReader(rbsp)
    s = Sps()
    r.u(4)                       # sps_video_parameter_set_id
    max_sub_layers_minus1 = r.u(3)
    r.flag()                     # temporal_id_nesting
    _parse_profile_tier_level(r, max_sub_layers_minus1)
    r.ue()                       # sps_seq_parameter_set_id
    s.chroma_format_idc = r.ue()
    if s.chroma_format_idc == 3:
        r.flag()                 # separate_colour_plane_flag
    s.width = r.ue()
    s.height = r.ue()
    if r.flag():                 # conformance_window_flag
        s.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
    s.bit_depth = 8 + r.ue()
    r.ue()                       # bit_depth_chroma_minus8
    s.log2_max_poc_lsb = 4 + r.ue()
    sub_layer_ordering = r.flag()
    for _ in range((max_sub_layers_minus1 + 1) if sub_layer_ordering else 1):
        r.ue(); r.ue(); r.ue()
    s.log2_min_cb = 3 + r.ue()
    s.log2_ctb = s.log2_min_cb + r.ue()
    s.log2_min_tb = 2 + r.ue()
    s.log2_max_tb = s.log2_min_tb + r.ue()
    s.max_transform_hierarchy_depth_inter = r.ue()
    s.max_transform_hierarchy_depth_intra = r.ue()
    s.scaling_list_enabled = r.flag()
    if s.scaling_list_enabled:
        raise NotImplementedError("scaling lists")
    s.amp_enabled = r.flag()
    s.sao_enabled = r.flag()
    s.pcm_enabled = r.flag()
    if s.pcm_enabled:
        raise NotImplementedError("PCM")
    num_st_rps = r.ue()
    if num_st_rps:
        raise NotImplementedError("short-term RPS parsing")
    if r.flag():
        raise NotImplementedError("long-term ref pics")
    s.temporal_mvp = r.flag()    # sps_temporal_mvp_enabled_flag
    s.strong_intra_smoothing = r.flag()
    # ignore VUI / extensions
    return s


def parse_pps(rbsp: bytes) -> Pps:
    r = BitReader(rbsp)
    p = Pps()
    r.ue(); r.ue()               # pps id, sps id
    if r.flag():
        raise NotImplementedError("dependent slice segments")
    r.flag()                     # output_flag_present
    r.u(3)                       # num_extra_slice_header_bits
    p.sign_data_hiding = r.flag()
    p.cabac_init_present = r.flag()
    r.ue(); r.ue()               # num_ref_idx defaults
    p.init_qp = 26 + r.se()
    p.constrained_intra = r.flag()
    p.transform_skip = r.flag()
    p.cu_qp_delta_enabled = r.flag()
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = r.ue()
    p.cb_qp_offset = r.se()
    p.cr_qp_offset = r.se()
    p.slice_chroma_qp_offsets_present = r.flag()
    r.flag(); r.flag()           # weighted pred flags
    p.transquant_bypass = r.flag()
    p.tiles_enabled = r.flag()
    p.entropy_coding_sync = r.flag()
    if p.tiles_enabled:
        p.tile_columns = r.ue() + 1
        p.tile_rows = r.ue() + 1
        if not r.flag():             # uniform_spacing_flag
            raise NotImplementedError("non-uniform tile spacing")
        p.loop_filter_across_tiles = r.flag()
    p.loop_filter_across_slices = r.flag()
    p.deblocking_control_present = r.flag()
    if p.deblocking_control_present:
        p.deblocking_override_enabled = r.flag()
        p.deblocking_disabled = r.flag()
        if not p.deblocking_disabled:
            p.beta_offset_div2 = r.se()
            p.tc_offset_div2 = r.se()
    else:
        p.deblocking_disabled = False
    if r.flag():
        raise NotImplementedError("pps scaling list")
    r.flag()                     # lists_modification_present
    r.ue()                       # log2_parallel_merge_level_minus2
    r.flag()                     # slice_segment_header_extension
    return p


def parse_slice_header(rbsp: bytes, nal_type: int, sps: Sps, pps: Pps) -> SliceHeader:
    r = BitReader(rbsp)
    h = SliceHeader()
    h.is_idr = nal_type in (19, 20)
    h.first_slice = bool(r.flag())
    if 16 <= nal_type <= 23:     # IRAP
        r.flag()                 # no_output_of_prior_pics_flag
    r.ue()                       # slice_pic_parameter_set_id
    if not h.first_slice:
        # dependent_slice_segment_flag absent: parse_pps rejects streams
        # with dependent_slice_segments_enabled_flag set
        ctb = 1 << sps.log2_ctb
        n_ctbs = (((sps.width + ctb - 1) // ctb)
                  * ((sps.height + ctb - 1) // ctb))
        h.slice_address = r.u(max((n_ctbs - 1).bit_length(), 1))
    h.slice_type = r.ue()
    if not h.is_idr:
        h.poc = r.u(sps.log2_max_poc_lsb)
        if not r.flag():         # short_term_ref_pic_set_sps_flag == 0
            n_neg = r.ue()
            n_pos = r.ue()
            prev = 0
            for _ in range(n_neg):
                prev += r.ue() + 1       # delta_poc_s0_minus1
                h.keep_neg.append(prev)  # in DPB whether used now or later
                if r.flag():             # used_by_curr_pic_s0_flag
                    h.neg_deltas.append(prev)
            prev = 0
            for _ in range(n_pos):
                prev += r.ue() + 1
                h.keep_pos.append(prev)
                if r.flag():
                    h.pos_deltas.append(prev)
        if sps.temporal_mvp:
            h.temporal_mvp = bool(r.flag())
    if sps.sao_enabled:
        h.sao_luma = r.flag()
        h.sao_chroma = r.flag()
    if h.slice_type != 2:
        if r.flag():             # num_ref_idx_active_override_flag
            n_ref = r.ue() + 1
            if h.slice_type == 0:
                r.ue()
            if n_ref != 1:
                raise NotImplementedError("multiple active references")
        if h.slice_type == 0:
            if r.flag():         # mvd_l1_zero_flag
                raise NotImplementedError("mvd_l1_zero")
        if h.temporal_mvp:
            if h.slice_type == 0:
                h.col_from_l0 = bool(r.flag())
            # collocated_ref_idx absent: one active reference per list
        h.max_num_merge_cand = 5 - r.ue()
    h.slice_qp = pps.init_qp + r.se()
    if pps.slice_chroma_qp_offsets_present:
        h.cb_qp_offset = r.se()      # slice_cb_qp_offset
        h.cr_qp_offset = r.se()      # slice_cr_qp_offset
    h.deblock_disabled = pps.deblocking_disabled
    h.beta_offset_div2 = pps.beta_offset_div2
    h.tc_offset_div2 = pps.tc_offset_div2
    if pps.deblocking_control_present and pps.deblocking_override_enabled:
        if r.flag():             # deblocking_filter_override_flag
            h.deblock_disabled = bool(r.flag())
            if not h.deblock_disabled:
                h.beta_offset_div2 = r.se()
                h.tc_offset_div2 = r.se()
    if pps.loop_filter_across_slices and (
            h.sao_luma or h.sao_chroma or not pps.deblocking_disabled):
        r.flag()                 # slice_loop_filter_across_slices_enabled_flag
    if pps.tiles_enabled or pps.entropy_coding_sync:
        n_ep = r.ue()
        if n_ep:
            ln = r.ue() + 1
            h.entry_points = [r.u(ln) + 1 for _ in range(n_ep)]
    # byte alignment before slice data
    if r.flag() != 1:
        raise ValueError("alignment_bit_equal_to_one missing")
    r.byte_align()
    h.data_bit_offset = r.bit_position
    return h
