"""Encoder configuration.

The TPU-native analogue of ``EB_H265_ENC_CONFIGURATION``
(reference: Source/API/EbApi.h:173-669) plus the derived-dimension logic of
``EbHevcSetParamBasedOnInput`` (reference: Source/Lib/Codec/EbEncHandle.c:1901)
and the validation of ``VerifySettings`` (EbEncHandle.c:2134).

Only the subset wired to working code paths is accepted; everything else
raises at validation time rather than being silently ignored, so the config
surface grows honestly with the implementation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


MIN_CU_SIZE = 8
MAX_SB_SIZE = 64

# per-CTB segment override flags (reference: EB_OV_FLAGS, EbApi.h:52-68;
# applied per LCU in EbEncDecProcess.c:2854-2870). Attach an
# (n_ctb_y, n_ctb_x, 3) int array [flags, qp_ov, deblock_ov] as
# Frame.segment_ov to drive them.
SEG_QP_OV_DIRECT = 1 << 0        # qp_ov is an absolute QP [0..51]
SEG_QP_OV_DELTA = 1 << 1         # qp_ov is a delta [-25..25]
SEG_DENSITY_QP_OV = 1 << 2       # enable the QP override
SEG_DENSITY_DEBLOCK_OV = 1 << 3  # deblock_ov shifts the CTB QP (density)


@dataclass(frozen=True)
class EncoderConfig:
    # --- source description (EbApi.h sourceWidth/sourceHeight/encoderBitDepth) ---
    width: int = 0
    height: int = 0
    bit_depth: int = 8           # 8 or 10 (Main / Main10)
    chroma_format: int = 1       # 1=4:2:0, 2=4:2:2, 3=4:4:4 (EbApi.h
                                 # encoderColorFormat; 422/444 -> MainREXT
                                 # profile, EbEncHandle.c:2454-2456)
    fps_num: int = 50            # frameRateNumerator
    fps_den: int = 1

    # --- coding structure (EbApi.h intraPeriodLength/hierarchicalLevels/...) ---
    intra_period: int = 0        # 0 = all-intra; -1 = first frame only
                                 # (reference -1 semantics); N>0 = I every N+1
    intra_refresh_type: int = 2  # EbApi.h intraRefreshType: 1 = CRA open
                                 # GOP, 2 = IDR closed GOP
    hierarchical_levels: int = 0
    pred_structure: int = 0      # 0 low-delay P, 1 low-delay B, 2 random access

    # --- quality/speed (EbApi.h encMode/qp/tune) ---
    enc_mode: int = 7            # preset 0..11 (M7 = reference default/anchor)
    qp: int = 32                 # 0..51 (EbApi.h qp)
    min_qp_allowed: int = 0      # RC / override QP floor (EbApi.h minQpAllowed)
    max_qp_allowed: int = 51     # RC / override QP ceiling (maxQpAllowed)

    # --- rate control (EbApi.h rateControlMode/targetBitRate/vbv*) ---
    rate_control_mode: int = 0   # 0 = CQP, 1 = VBR/ABR
    target_bitrate: int = 0      # bits/s (rate_control_mode 1)
    vbv_maxrate: int = 0         # bits/s
    vbv_bufsize: int = 0         # bits
    look_ahead_distance: int = -1   # -1 = auto (17 for VBR, like the
                                 # reference default EbEncHandle.c:1888);
                                 # 0 = reactive only; N = window length
    enable_hrd: bool = False     # signal HRD (VUI hrd_parameters +
                                 # buffering period / pic timing SEIs;
                                 # reference: hrdFlag EbApi.h, Vbv_Buf_Calc
                                 # EbRateControlProcess.c:2177)

    # --- block structure ---
    ctb_size: int = 32           # luma CTB size (32 or 64)
    max_tu_size: int = 32

    # --- tools (EbApi.h flags) ---
    enable_deblocking: bool = True    # disableDlfFlag analogue
    enable_sao: bool = True           # enableSaoFlag analogue
    enable_denoise: bool = False      # EbApi.h enableDenoiseFlag: filter
                                      # noisy sources before encoding
    scene_change_detection: bool = True   # EbApi.h sceneChangeDetection
    constrained_intra: bool = False
    # temporal MV prediction (sps_temporal_mvp_enabled_flag; reference
    # candidates EbAdaptiveMotionVectorPrediction.c:1749, map fill
    # EbCodingLoop.c:4500)
    tmvp: bool = True
    # per-LCU adaptive QP, the reference's QPM visual-quality tools
    # (EbApi.h improveSharpness / bitRateReduction; derivation
    # EbEncDecProcess.c QpmDeriveWeightsMinAndMax :1919)
    improve_sharpness: bool = False
    bit_rate_reduction: bool = False
    segment_ov_enabled: bool = False
                                 # accept per-CTB Frame.segment_ov arrays
                                 # (reference: segmentOvEnabled, EbApi.h)
    # multi-chip picture parallelism: batch the independent non-reference
    # leaf pictures of hierarchical GOPs into ONE vmapped fused graph
    # sharded over the device mesh (the TPU-native analogue of the
    # reference's many-pictures-in-flight pipeline, EbEncHandle.c:1645;
    # SURVEY §2.6 "data parallelism over pictures"). Streams are
    # byte-identical to the single-device path (tests/test_mesh_encoder.py)
    mesh_pictures: bool = False

    # --- tiles (EbApi.h tileColumnCount/tileRowCount/tileSliceMode) ---
    tile_columns: int = 1
    tile_rows: int = 1
    tile_slice_mode: int = 0     # 1: one independent slice per tile (MCTS
                                 # packaging; reference tileSliceMode)
    constrained_motion_tiles: bool = False
                                 # motion-constrained tile sets: every MV's
                                 # interpolation window stays inside its
                                 # tile, loop filters stop at tile edges,
                                 # and a temporal MCTS SEI is emitted
                                 # (reference: MCTS conformance test,
                                 # Tests/SVT-HEVC_FunctionalTests.py:1044)

    # --- HDR metadata SEIs (EbApi.h maxCLL/maxFALL/masteringDisplay...) ---
    dolby_vision_profile: int = 0
                                 # 81 enables per-picture Dolby Vision RPU
                                 # passthrough as NAL 62 (reference:
                                 # dolbyVisionProfile, EbApi.h:656)
    code_eos_nal: bool = False   # emit an EOS NAL at end of stream
                                 # (reference: codeEosNal, EbApi.h)
    max_cll: int = 0             # content light level SEI when nonzero
    max_fall: int = 0
    mastering_display: tuple | None = None
                                 # (gx,gy,bx,by,rx,ry,wx,wy,max_l,min_l)
    use_recovery_point_sei: bool = False

    # ------------------------------------------------------------------ derived
    @property
    def ctb_log2(self) -> int:
        return self.ctb_size.bit_length() - 1

    @property
    def pic_width_in_ctbs(self) -> int:
        return (self.width + self.ctb_size - 1) // self.ctb_size

    @property
    def pic_height_in_ctbs(self) -> int:
        return (self.height + self.ctb_size - 1) // self.ctb_size

    @property
    def num_ctbs(self) -> int:
        return self.pic_width_in_ctbs * self.pic_height_in_ctbs

    @property
    def padded_width(self) -> int:
        return self.pic_width_in_ctbs * self.ctb_size

    @property
    def padded_height(self) -> int:
        return self.pic_height_in_ctbs * self.ctb_size

    # chroma subsampling factors (spec Table 6-1)
    @property
    def sub_width_c(self) -> int:
        return 2 if self.chroma_format in (1, 2) else 1

    @property
    def sub_height_c(self) -> int:
        return 2 if self.chroma_format == 1 else 1

    @property
    def profile(self) -> int:
        """general_profile_idc: 1=Main, 2=Main10, 4=MainREXT (the reference
        requires REXT for 422/444 input, EbEncHandle.c:2454-2456)."""
        if self.chroma_format != 1:
            return 4
        return 2 if self.bit_depth == 10 else 1

    # minimum-CU-grid alignment required of the *signalled* picture size
    # (HEVC requires pic dims to be multiples of MinCbSizeY = 8)
    @property
    def conf_win_right(self) -> int:   # in units of SubWidthC luma samples
        return (align_up(self.width, MIN_CU_SIZE) - self.width) \
            // self.sub_width_c

    @property
    def conf_win_bottom(self) -> int:
        return (align_up(self.height, MIN_CU_SIZE) - self.height) \
            // self.sub_height_c

    @property
    def coded_width(self) -> int:
        """pic_width_in_luma_samples signalled in the SPS (multiple of 8)."""
        return align_up(self.width, MIN_CU_SIZE)

    @property
    def coded_height(self) -> int:
        return align_up(self.height, MIN_CU_SIZE)

    def validate(self) -> "EncoderConfig":
        if not (64 <= self.width <= 8192):
            raise ValueError(f"width {self.width} out of range [64, 8192]")
        if not (64 <= self.height <= 4320):
            raise ValueError(f"height {self.height} out of range [64, 4320]")
        if self.bit_depth not in (8, 10):
            raise ValueError("bit_depth must be 8 or 10")
        if self.chroma_format not in (1, 2, 3):
            raise ValueError("chroma_format must be 1 (4:2:0), 2 (4:2:2) "
                             "or 3 (4:4:4)")
        if not (0 <= self.qp <= 51):
            raise ValueError(f"qp {self.qp} out of range [0, 51]")
        if not (0 <= self.min_qp_allowed <= self.max_qp_allowed <= 51):
            raise ValueError("need 0 <= min_qp_allowed <= max_qp_allowed <= 51")
        if self.ctb_size not in (16, 32, 64):
            raise ValueError("ctb_size must be 16, 32 or 64")
        if self.intra_period < -1 or self.intra_period > 255:
            raise ValueError("intra_period out of range [-1, 255]")
        if self.pred_structure not in (0, 1, 2):
            raise ValueError("pred_structure must be 0 (LDP), 1 (LDB), 2 (RA)")
        if not (0 <= self.hierarchical_levels <= 5):
            raise ValueError("hierarchical_levels out of range [0, 5] "
                             "(reference mini-GOPs are 2^n, n<=5)")
        if self.intra_refresh_type not in (1, 2):
            raise ValueError("intra_refresh_type must be 1 (CRA open GOP) "
                             "or 2 (IDR closed GOP)")
        if not (1 <= self.tile_columns <= 20 and 1 <= self.tile_rows <= 22):
            raise ValueError("tile grid out of range (level 6.x caps: 20x22)")
        # level/tier feasibility (reference: VerifySettings level checks +
        # per-level tile caps, EbEncHandle.c:69-76, :2134): raises if the
        # stream does not fit any (level, tier) up to 6.2 High
        from .level import derive_level
        derive_level(self)
        if (self.tile_columns > self.pic_width_in_ctbs
                or self.tile_rows > self.pic_height_in_ctbs):
            raise ValueError("more tiles than CTB columns/rows")
        if (self.constrained_motion_tiles
                and self.tile_columns * self.tile_rows < 2):
            raise ValueError("constrained_motion_tiles requires >1 tile")
        if not (0 <= self.enc_mode <= 11):
            raise ValueError("enc_mode must be in 0..11")
        if self.rate_control_mode not in (0, 1):
            raise ValueError("rate_control_mode must be 0 (CQP) or 1 (VBR)")
        if self.rate_control_mode == 1 and self.target_bitrate <= 0:
            raise ValueError("VBR requires a positive target_bitrate")
        if not (-1 <= self.look_ahead_distance <= 250):
            raise ValueError("look_ahead_distance out of range [-1, 250]")
        if self.enable_hrd and not (self.vbv_maxrate or self.target_bitrate):
            raise ValueError("enable_hrd needs vbv_maxrate or target_bitrate")
        return self

    @property
    def adaptive_qp(self) -> bool:
        """True when per-CTB QP maps (cu_qp_delta signalling) are active."""
        return (self.improve_sharpness or self.bit_rate_reduction
                or self.segment_ov_enabled)

    @property
    def lookahead(self) -> int:
        """Resolved lookahead window length."""
        if self.look_ahead_distance >= 0:
            return self.look_ahead_distance
        return 17 if self.rate_control_mode == 1 else 0

    def replace(self, **kw) -> "EncoderConfig":
        return dataclasses.replace(self, **kw)


def align_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a
