"""High-level syntax: the SPS / PPS / slice segment header parsers (H.265
7.3.2-7.3.6) that feed the decoder beside them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bitwriter import BitReader



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
