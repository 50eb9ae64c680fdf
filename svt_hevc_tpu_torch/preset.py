"""Preset ladder: enc_mode (0..11) -> feature set.

The analogue of the reference's per-stage signal-derivation functions
(reference: EbPictureDecisionProcess.c SignalDerivationMultiProcessesOq
:376, EbEncDecProcess.c SignalDerivationEncDecKernelOq :1986,
EbMotionEstimationProcess.c SignalDerivationMeKernelOq :308 — ladder table
in SURVEY.md §2.4b). Collapsed to the knobs this encoder exposes today;
the table grows as features land.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PresetFeatures:
    rd_mode_decision: bool      # full RD quadtree search vs fast heuristic
    try_nxn: bool               # evaluate intra NxN at 8x8 CUs in RD
    me_range: int               # host integer refinement radius (unseeded)
    subpel_me: bool             # half/quarter-pel refinement
    all_intra_modes: bool       # 35-mode search vs DC/planar/MPM-only
    rdoq: bool                  # RD-optimized quantization (PM analogue)
    ois_intra: bool             # TPU open-loop intra search drives the MD
                                # candidate shortlist (reference: enhanced-I
                                # OIS candidates at M3-9, SURVEY.md §2.4b;
                                # M0-2 search all 35 modes closed-loop)
    # ---- fast (fused-device) path knobs; each is a static argument of
    # the fused graphs, so presets trade compile variants for speed the
    # way the reference's signal-derivation tables trade C paths
    p_min_intra_log2: int = 4   # smallest intra CU offered in P/B MD
                                # (reference CU-8x8 gating ladder,
                                # EbPictureDecisionProcess.c:425-449);
                                # 6 disables intra in inter pictures
    subpel_min_size: int = 16   # smallest CU size subpel-refined in the
                                # dense ME (PictureLevelSubPelSettingsOq
                                # analogue: selective sub-pel at M6+)
    i_refine_modes: bool = True  # closed-loop mode re-ranking in the
                                # intra wavefront (enhanced-I, M3-9)


def derive_preset(enc_mode: int) -> PresetFeatures:
    """Quality->speed ladder. M0-M5: full RD (RDOQ at M0-M4, matching the
    reference ladder SURVEY.md §2.4b); M6-M9: heuristic with OIS-driven
    mode search; M10-M11: heuristic with reduced tools."""
    if enc_mode <= 2:
        return PresetFeatures(True, True, 12, True, True, True, False,
                              p_min_intra_log2=3, subpel_min_size=8)
    if enc_mode <= 5:
        return PresetFeatures(True, enc_mode <= 4, 8, True, True,
                              enc_mode <= 4, True,
                              p_min_intra_log2=3, subpel_min_size=8)
    if enc_mode <= 7:
        # intra-in-inter off: the intra-fixup wavefront costs ~2 s/frame
        # of sequential scan at 1080p while contributing ~0 bits after
        # gating (measured: byte-identical CIF streams with it off); the
        # reference's ladder similarly strips small/intra tools from
        # inter MD at M6+ (EbEncDecProcess.c:2126-2150)
        return PresetFeatures(False, False, 8, True, True, False, True,
                              p_min_intra_log2=6, subpel_min_size=16)
    if enc_mode <= 9:
        return PresetFeatures(False, False, 8, True, True, False, True,
                              p_min_intra_log2=5, subpel_min_size=32)
    return PresetFeatures(False, False, 4, enc_mode == 10, False, False,
                          True, p_min_intra_log2=6, subpel_min_size=32,
                          i_refine_modes=False)
