"""CTU decoding: the CU-quadtree traversal of the HEVC coding_quadtree /
coding_unit / transform_tree / transform_unit syntax (H.265 7.3.8), with
`CtuDecoder` reading each syntax element, and the normative
reconstruction (intra predict -> dequant -> inverse transform -> clip).
The frozen copy keeps the decoder only.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.contexts import Ctx
from ..bitstream.residual import decode_residual, select_scan
from . import intra
from .inter import (Mi, amvp_candidates, mc_predict_bi, mc_predict_uni,
                    merge_candidates)
from .quant import dequantize
from .transforms import inverse_transform

I_SLICE, P_SLICE, B_SLICE = 2, 1, 0

# spec Table 8-10 (4:2:0): qPi -> QpC for qPi in 30..43
_CHROMA_QP_MAP = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)

# spec Table 8-3 (REXT): luma-derived intra mode -> 4:2:2 chroma mode
MODE_422_MAP = (0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18, 19,
                20, 21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28, 28, 29,
                29, 30, 31)


def chroma_qp(qp_y: int, offset: int = 0, chroma_format: int = 1) -> int:
    """QpC derivation (8.6.1). The Table 8-10 mapping applies only to
    ChromaArrayType 1; 4:2:2 / 4:4:4 use QpC = min(qPi, 51)."""
    if chroma_format != 1:
        return min(max(qp_y + offset, 0), 51)
    q = min(max(qp_y + offset, 0), 57)
    if q < 30:
        return q
    if q > 43:
        return q - 6
    return _CHROMA_QP_MAP[q - 30]


class PictureState:
    """Reconstruction state for one picture: planes + availability + maps.

    Planes use coded (8-aligned) dimensions. avail maps are at 4x4
    granularity of each plane and mark z-order-reconstructed blocks;
    luma_mode / cqt_depth are at 4x4 luma granularity (PU minimum 4x4).
    """

    def __init__(self, coded_w: int, coded_h: int, qp: int, ctb_log2: int,
                 bit_depth: int = 8, chroma_format: int = 1):
        self.w, self.h = coded_w, coded_h
        self.qp = qp
        self.chroma_format = chroma_format
        # chroma subsampling shifts (spec Table 6-1)
        self.ss_x = 1 if chroma_format in (1, 2) else 0
        self.ss_y = 1 if chroma_format == 1 else 0
        self.qp_c = chroma_qp(qp, 0, chroma_format)
        self.ctb_log2 = ctb_log2
        self.bit_depth = bit_depth
        cw_c, ch_c = coded_w >> self.ss_x, coded_h >> self.ss_y
        self.planes = [
            np.zeros((coded_h, coded_w), np.int32),
            np.zeros((ch_c, cw_c), np.int32),
            np.zeros((ch_c, cw_c), np.int32),
        ]
        self.avail = [
            np.zeros((coded_h // 4, coded_w // 4), bool),
            np.zeros((ch_c // 4, cw_c // 4), bool),
            np.zeros((ch_c // 4, cw_c // 4), bool),
        ]
        self.luma_mode = np.full((coded_h // 4, coded_w // 4), -1, np.int32)
        self.cqt_depth = np.zeros((coded_h // 4, coded_w // 4), np.int32)
        # deblocking edge flags on the 8x8 grid (marked in transform_unit):
        # edge_v[s, c]: vertical TB edge at luma column 8c, rows 4s..4s+3
        # edge_h[r, c]: horizontal TB edge at luma row 8r, cols 4c..4c+3
        self.edge_v = np.zeros((coded_h // 4, coded_w // 8), bool)
        self.edge_h = np.zeros((coded_h // 8, coded_w // 4), bool)
        # inter state (4x4 luma granularity, two reference lists)
        self.slice_type = I_SLICE
        self.ref_planes: list | None = None    # [lst][ref] -> [y, cb, cr]
        self.ref_pocs: list = [[], []]         # [lst][ref] -> POC
        self.poc = 0
        self.max_merge = 5
        # transform-tree depth budget for inter CUs (SPS
        # max_transform_hierarchy_depth_inter); intra stays 0
        self.max_tt_depth_inter = 0
        # collocated picture's motion for TMVP (8.5.3.2.7): dict with
        # mv / ref_idx (4x4-gran maps), ref_pocs, poc, from_l0; None
        # disables the temporal candidate
        self.col: dict | None = None
        self.mv = np.zeros((coded_h // 4, coded_w // 4, 2, 2), np.int32)
        self.ref_idx = np.full((coded_h // 4, coded_w // 4, 2), -1, np.int8)
        self.skip = np.zeros((coded_h // 4, coded_w // 4), bool)
        # nonzero-luma-coeff flag of the covering TU (for deblocking bS)
        self.cbf4 = np.zeros((coded_h // 4, coded_w // 4), np.uint8)
        # constrained_intra_pred_flag: intra prediction may only reference
        # intra-coded neighbor samples (7.4.3.3.1)
        self.constrained_intra = False
        # loop_filter_across_tiles_enabled_flag=0 state (MCTS): interior
        # tile boundary positions in luma pixels; DLF zeroes bS on these
        # edges and SAO EO treats across-boundary neighbors as unavailable
        self.filter_across_tiles = True
        self.tile_edges_x: list[int] = []
        self.tile_edges_y: list[int] = []
        # per-CTB adaptive QP (cu_qp_delta, QG = CTB since
        # diff_cu_qp_delta_depth = 0). Reference analogue: QPM per-LCU QP
        # (EbEncDecProcess.c QpmDeriveWeightsMinAndMax :1919, applied :2840).
        self.cu_qp_delta_enabled = False
        self.slice_qp = qp           # SliceQpY (qPY_PREV reset value)
        self.qp_map = None           # encoder: desired per-CTB QP grid
        self.ctb_qp = None           # final per-CTB QP grid (both roles)
        self.prev_qp = qp            # qPY_PREV chain (8.6.1)
        self.qg_pred = qp            # predicted QP of the current QG
        self.qg_qp_coded = False     # IsCuQpDeltaCoded

    def set_qp(self, qp: int) -> None:
        self.qp = qp
        self.qp_c = chroma_qp(qp, 0, self.chroma_format)

    def enable_cu_qp_delta(self, qp_map=None) -> None:
        """Turn on cu_qp_delta coding. qp_map: encoder's desired per-CTB
        QP grid (decoder passes None and learns QPs from the stream)."""
        self.cu_qp_delta_enabled = True
        self.qp_map = qp_map
        ctb = 1 << self.ctb_log2
        self.ctb_qp = np.full(((self.h + ctb - 1) // ctb,
                               (self.w + ctb - 1) // ctb),
                              self.slice_qp, np.int32)

    def qg_begin(self, cx: int, cy: int) -> None:
        """Start the quantization group of CTB (cx, cy): derive qPY_PRED
        (8.6.1; with QG == CTB both spatial neighbors fall outside the QG's
        CTB, so the predictor is always qPY_PREV) and set the working QP —
        the encoder's desired QP, or the prediction until a delta arrives."""
        if not self.cu_qp_delta_enabled:
            return
        self.qg_pred = self.prev_qp
        self.qg_qp_coded = False
        if self.qp_map is not None:
            self.set_qp(int(self.qp_map[cy, cx]))
        else:
            self.set_qp(self.qg_pred)

    def qg_end(self, cx: int, cy: int) -> None:
        """Close the QG: if no cu_qp_delta was coded (no cbf anywhere in
        the CTB) the QP is inferred as the prediction (7.4.9.14)."""
        if not self.cu_qp_delta_enabled:
            return
        final = self.qp if self.qg_qp_coded else self.qg_pred
        self.set_qp(final)
        self.prev_qp = final
        self.ctb_qp[cy, cx] = final

    def intra_avail(self, c_idx: int) -> np.ndarray:
        """Availability map for intra reference samples: the recon map,
        additionally excluding inter-coded samples under constrained
        intra prediction."""
        av = self.avail[c_idx]
        if not self.constrained_intra:
            return av
        not_inter = (self.ref_idx < 0).all(-1)
        if c_idx > 0:
            not_inter = not_inter[::1 << self.ss_y, ::1 << self.ss_x]
        return av & not_inter

    def begin_tile(self) -> None:
        """Reset tile-local prediction state (HEVC tiles break prediction
        and entropy dependencies, 6.3.1). The availability / mode / skip
        maps are only ever consumed tile-locally, so zeroing them makes
        out-of-tile neighbors unavailable exactly per spec; motion / cbf /
        edge maps stay (the in-loop filters are picture-level)."""
        for a in self.avail:
            a[:] = False
        self.luma_mode[:] = -1
        self.skip[:] = False
        self.prev_qp = self.slice_qp     # qPY_PREV resets per tile (8.6.1)

    def mark(self, c_idx: int, x: int, y: int, n: int) -> None:
        self.avail[c_idx][y >> 2:(y + n) >> 2, x >> 2:(x + n) >> 2] = True


def derive_mpm(st: PictureState, xp: int, yp: int) -> list[int]:
    """Luma MPM candidate list (8.4.2). Neighbor modes come from the
    luma_mode map (-1 = unavailable / inter / other tile => treated DC);
    the above neighbor is DC when outside the current CTB row."""
    left = None
    if xp > 0:
        m = int(st.luma_mode[yp >> 2, (xp - 1) >> 2])
        left = m if m >= 0 else None
    above = None
    if yp > 0 and ((yp - 1) >> st.ctb_log2) == (yp >> st.ctb_log2):
        m = int(st.luma_mode[(yp - 1) >> 2, xp >> 2])
        above = m if m >= 0 else None
    return intra.candidate_mode_list(left, above)


def split_cu_ctx(st: PictureState, x0: int, y0: int, depth: int) -> int:
    """split_cu_flag ctxInc (9.3.4.2.2): count of available neighbors with
    greater coding depth."""
    inc = 0
    if x0 > 0 and st.avail[0][y0 >> 2, (x0 - 1) >> 2]:
        inc += int(st.cqt_depth[y0 >> 2, (x0 - 1) >> 2] > depth)
    if y0 > 0 and st.avail[0][(y0 - 1) >> 2, x0 >> 2]:
        inc += int(st.cqt_depth[(y0 - 1) >> 2, x0 >> 2] > depth)
    return inc


def chroma_cand_list(luma_mode: int) -> list[int]:
    """intra_chroma_pred_mode value 0..3 -> mode (spec Table 8-2/8-3)."""
    lst = [intra.PLANAR, intra.VERTICAL, intra.HORIZONTAL, intra.DC]
    if luma_mode in lst:
        lst[lst.index(luma_mode)] = 34
    return lst


def predict_block(st: PictureState, c_idx: int, x0: int, y0: int, n: int,
                  mode: int) -> np.ndarray:
    """Normative intra prediction for one TB from current recon state.
    In 4:4:4 chroma is filtered like luma (REXT 8.4.4.2.3: cIdx == 0 or
    ChromaArrayType == 3)."""
    plane = st.planes[c_idx]
    c444 = st.chroma_format == 3
    left, corner, top = intra.build_ref_samples(
        plane, st.intra_avail(c_idx), x0, y0, n,
        c_idx=c_idx, bit_depth=st.bit_depth)
    left, corner, top = intra.filter_ref_samples(
        left, corner, top, n, mode, c_idx, st.bit_depth,
        strong_smoothing=getattr(st, "strong_intra_smoothing", False),
        chroma444=c444)
    return intra.predict_intra(left, corner, top, n, mode, c_idx,
                               st.bit_depth, chroma444=c444)


def reconstruct_tb(st: PictureState, c_idx: int, x0: int, y0: int, n: int,
                   pred: np.ndarray, levels: np.ndarray | None,
                   is_intra: bool = True) -> None:
    """Dequant + inverse transform + add + clip; marks availability."""
    maxval = (1 << st.bit_depth) - 1
    if levels is None or not levels.any():
        rec = np.clip(pred, 0, maxval)
    else:
        qp = st.qp if c_idx == 0 else st.qp_c
        dst = is_intra and c_idx == 0 and n == 4
        coeff = dequantize(levels, qp, bit_depth=st.bit_depth)
        resid = inverse_transform(coeff, st.bit_depth, dst=dst)
        rec = np.clip(pred + resid, 0, maxval)
    st.planes[c_idx][y0:y0 + n, x0:x0 + n] = rec
    st.mark(c_idx, x0, y0, n)


class _CuCtx:
    """Per-CU transient state shared across the transform tree walk."""

    __slots__ = ("x0", "y0", "log2", "part_nxn", "luma_modes", "chroma_modes",
                 "luma_levels", "chroma_levels", "chroma_cbf",
                 "is_inter", "motion", "pred")

    def __init__(self, x0, y0, log2, part_nxn, luma_modes, chroma_modes,
                 *, is_inter=False, motion=None, pred=None):
        self.x0, self.y0, self.log2 = x0, y0, log2
        self.part_nxn = part_nxn
        self.luma_modes = luma_modes
        self.chroma_modes = chroma_modes     # resolved modes (DM + 422 map
                                             # applied); list of 1, or 4 for
                                             # 4:4:4 NxN
        self.luma_levels = {}                # (x, y) -> levels array
        self.chroma_levels = {}              # (c_idx, x, y) -> levels
        self.chroma_cbf = {}                 # (c_idx, node_x, node_y,
                                             #  node_log2, sub) -> 0/1
        self.is_inter = is_inter
        self.motion = motion                 # ((mvx, mvy), ref_idx)
        self.pred = pred                     # [y, cb, cr] full-CU MC pred

    def chroma_mode_at(self, xc: int, yc: int) -> int:
        """Chroma intra mode for the TB at chroma-plane (xc, yc): for
        4:4:4 NxN each 4x4 chroma TB follows its own PU's signalled mode."""
        if len(self.chroma_modes) == 1:
            return self.chroma_modes[0]
        idx = (1 if xc != self.x0 else 0) + (2 if yc != self.y0 else 0)
        return self.chroma_modes[idx]


class CtuCoderBase:
    """Shared syntax traversal. Subclasses implement the sx_* hooks."""

    is_decoder = False

    def __init__(self, state: PictureState, bac) -> None:
        self.st = state
        self.bac = bac

    # ------------------------------------------------------------ entry point
    def code_ctu(self, x0: int, y0: int) -> None:
        st = self.st
        st.qg_begin(x0 >> st.ctb_log2, y0 >> st.ctb_log2)
        self.coding_quadtree(x0, y0, st.ctb_log2, 0)
        st.qg_end(x0 >> st.ctb_log2, y0 >> st.ctb_log2)

    # -------------------------------------------------------- coding quadtree
    def coding_quadtree(self, x0: int, y0: int, log2: int, depth: int) -> None:
        st = self.st
        size = 1 << log2
        inside = x0 + size <= st.w and y0 + size <= st.h
        if inside and log2 > 3:
            split = self.sx_split_cu(x0, y0, log2, depth,
                                     split_cu_ctx(st, x0, y0, depth))
        else:
            split = 0 if inside else 1     # log2==3 is always fully inside
        if split:
            half = size >> 1
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < st.w and y1 < st.h:
                    self.coding_quadtree(x1, y1, log2 - 1, depth + 1)
        else:
            self.coding_unit(x0, y0, log2, depth)

    # ------------------------------------------------------------ coding unit
    def coding_unit(self, x0: int, y0: int, log2: int, depth: int) -> None:
        st = self.st
        size = 1 << log2
        st.cqt_depth[y0 >> 2:(y0 + size) >> 2, x0 >> 2:(x0 + size) >> 2] = depth

        if st.slice_type != I_SLICE:
            skip = self.sx_skip_flag(x0, y0, log2, self._skip_ctx(x0, y0))
            if skip:
                idx = self.sx_merge_idx(x0, y0, log2)
                motion = self._merge_list(x0, y0, size)[idx]
                self._inter_nocbf(x0, y0, log2, motion, skip=True)
                return
            if not self.sx_pred_mode(x0, y0, log2):
                self._inter_coding_unit(x0, y0, log2, depth)
                return

        part_nxn = bool(self.sx_part_mode(x0, y0)) if log2 == 3 else False
        if part_nxn:
            pu_pos = [(x0, y0), (x0 + 4, y0), (x0, y0 + 4), (x0 + 4, y0 + 4)]
            pu_sz = 4
        else:
            pu_pos = [(x0, y0)]
            pu_sz = size

        prev_flags = self.sx_prev_intra_flags(pu_pos, pu_sz)
        luma_modes = []
        for i, (px, py) in enumerate(pu_pos):
            cand = derive_mpm(st, px, py)
            mode = self.sx_luma_mode(i, px, py, pu_sz, cand, prev_flags[i])
            luma_modes.append(mode)
            st.luma_mode[py >> 2:(py + pu_sz) >> 2,
                         px >> 2:(px + pu_sz) >> 2] = mode

        # intra_chroma_pred_mode: one, or one per PU for 4:4:4 NxN (7.3.8.5);
        # 4:2:2 remaps the derived mode through Table 8-3
        if st.chroma_format == 3 and part_nxn:
            chroma_modes = [self.sx_chroma_mode(px, py, luma_modes[i])
                            for i, (px, py) in enumerate(pu_pos)]
        else:
            chroma_modes = [self.sx_chroma_mode(x0, y0, luma_modes[0])]
        if st.chroma_format == 2:
            chroma_modes = [MODE_422_MAP[m] for m in chroma_modes]
        cu = _CuCtx(x0, y0, log2, part_nxn, luma_modes, chroma_modes)
        self.prepare_cu(cu)
        self.transform_tree(cu, x0, y0, log2, 0, 0, (1,), (1,))

    def prepare_cu(self, cu: _CuCtx) -> None:
        """Encoder hook: forward-compute chroma TBs before cbf emission."""

    # ----------------------------------------------------------- inter CUs
    def _merge_list(self, x0: int, y0: int, n: int):
        """Merge candidate list (8.5.3.2.3); encoder subclasses serve the
        MD pass's cached list."""
        return merge_candidates(self.st, x0, y0, n, self.st.max_merge)

    def _amvp(self, x0: int, y0: int, n: int, lst: int):
        """AMVP candidate pair (8.5.3.2.5+); cached by encoder subclasses."""
        return amvp_candidates(self.st, x0, y0, n, lst)

    def _skip_ctx(self, x0: int, y0: int) -> int:
        st = self.st
        inc = 0
        if x0 > 0 and st.avail[0][y0 >> 2, (x0 - 1) >> 2]:
            inc += int(st.skip[y0 >> 2, (x0 - 1) >> 2])
        if y0 > 0 and st.avail[0][(y0 - 1) >> 2, x0 >> 2]:
            inc += int(st.skip[(y0 - 1) >> 2, x0 >> 2])
        return inc

    def _set_motion(self, x0: int, y0: int, n: int, mi: Mi, skip: bool) -> None:
        st = self.st
        ys, xs = slice(y0 >> 2, (y0 + n) >> 2), slice(x0 >> 2, (x0 + n) >> 2)
        st.mv[ys, xs, 0, 0] = mi.mv0[0]
        st.mv[ys, xs, 0, 1] = mi.mv0[1]
        st.mv[ys, xs, 1, 0] = mi.mv1[0]
        st.mv[ys, xs, 1, 1] = mi.mv1[1]
        st.ref_idx[ys, xs, 0] = mi.ref0
        st.ref_idx[ys, xs, 1] = mi.ref1
        st.skip[ys, xs] = skip
        st.luma_mode[ys, xs] = -1
        # PU/CU boundary deblocking edges on the 8x8 grid
        if x0 % 8 == 0:
            st.edge_v[y0 >> 2:(y0 + n) >> 2, x0 >> 3] = True
        if y0 % 8 == 0:
            st.edge_h[y0 >> 3, x0 >> 2:(x0 + n) >> 2] = True

    def _predict_mi(self, x0: int, y0: int, n: int, mi: Mi):
        """Motion-compensated prediction of one CU (uni or bi)."""
        st = self.st
        if mi.ref0 >= 0 and mi.ref1 >= 0:
            return mc_predict_bi(st.ref_planes[0][mi.ref0], mi.mv0,
                                 st.ref_planes[1][mi.ref1], mi.mv1,
                                 x0, y0, n, st.bit_depth, st.ss_x, st.ss_y)
        lst = 0 if mi.ref0 >= 0 else 1
        return mc_predict_uni(st.ref_planes[lst][mi.ref(lst)], x0, y0, n,
                              mi.mv(lst), st.bit_depth, st.ss_x, st.ss_y)

    def _inter_nocbf(self, x0: int, y0: int, log2: int, mi: Mi,
                     skip: bool) -> None:
        """Skip CU or rqt_root_cbf=0: reconstruction = MC prediction."""
        st = self.st
        n = 1 << log2
        sx, sy = st.ss_x, st.ss_y
        self._set_motion(x0, y0, n, mi, skip)
        py, pcb, pcr = self._predict_mi(x0, y0, n, mi)
        st.planes[0][y0:y0 + n, x0:x0 + n] = py
        st.planes[1][y0 >> sy:(y0 + n) >> sy, x0 >> sx:(x0 + n) >> sx] = pcb
        st.planes[2][y0 >> sy:(y0 + n) >> sy, x0 >> sx:(x0 + n) >> sx] = pcr
        st.mark(0, x0, y0, n)
        for c in (1, 2):
            st.avail[c][y0 >> sy >> 2:(y0 + n) >> sy >> 2,
                        x0 >> sx >> 2:(x0 + n) >> sx >> 2] = True
        st.cbf4[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2] = 0

    def _inter_coding_unit(self, x0: int, y0: int, log2: int, depth: int) -> None:
        st = self.st
        n = 1 << log2
        self.sx_part_mode_inter(x0, y0, log2)     # 2Nx2N only
        merged = self.sx_merge_flag(x0, y0, log2)
        if merged:
            idx = self.sx_merge_idx(x0, y0, log2)
            mi = self._merge_list(x0, y0, n)[idx]
        else:
            if st.slice_type == B_SLICE:
                idc = self.sx_inter_pred_idc(x0, y0, log2, depth)
            else:
                idc = 0                            # PRED_L0
            mvs = [(0, 0), (0, 0)]
            refs = [-1, -1]
            for lst in (0, 1):
                if (idc == 2 or idc == lst):       # L0 when 0/BI, L1 when 1/BI
                    # single active reference: ref_idx not signalled
                    mvd = self.sx_mvd(x0, y0, log2, lst)
                    mvp_idx = self.sx_mvp_flag(x0, y0, log2, lst)
                    pred_mv = self._amvp(x0, y0, n, lst)[mvp_idx]
                    mvs[lst] = (pred_mv[0] + mvd[0], pred_mv[1] + mvd[1])
                    refs[lst] = 0
            mi = Mi(mvs[0], refs[0], mvs[1], refs[1])
        # rqt_root_cbf is only coded when !(PartMode == 2Nx2N && merge_flag)
        # (7.3.8.5); a merge-2Nx2N CU with zero residual must be coded as
        # skip, so for non-skip merge CUs it is inferred 1 (7.4.9.5)
        root_cbf = 1 if merged else self.sx_rqt_root_cbf(x0, y0, log2)
        if not root_cbf:
            self._inter_nocbf(x0, y0, log2, mi, skip=False)
            return
        self._set_motion(x0, y0, n, mi, skip=False)
        pred = self._predict_mi(x0, y0, n, mi)
        cu = _CuCtx(x0, y0, log2, False, [None], [0],
                    is_inter=True, motion=mi, pred=list(pred))
        self.prepare_cu(cu)
        self.transform_tree(cu, x0, y0, log2, 0, 0, (1,), (1,))

    # --------------------------------------------------------- transform tree
    def _chroma_leaf_tbs(self, x0: int, y0: int, log2: int) -> list:
        """Chroma TBs coded for the leaf/chroma-node at luma (x0, y0, log2):
        [(xc, yc, log2c)] in chroma-plane coords. 4:2:2 stacks two square
        TBs vertically (REXT 7.3.8.10); 4:4:4 chroma follows luma size."""
        cf = self.st.chroma_format
        if cf == 3:
            return [(x0, y0, log2)]
        log2c = max(log2 - 1, 2)
        if cf == 1:
            return [(x0 >> 1, y0 >> 1, log2c)]
        nc = 1 << log2c
        return [(x0 >> 1, y0, log2c), (x0 >> 1, y0 + nc, log2c)]

    def transform_tree(self, cu: _CuCtx, x0: int, y0: int, log2: int,
                       depth: int, blk_idx: int,
                       parent_cbf_cb: tuple, parent_cbf_cr: tuple) -> None:
        cf = self.st.chroma_format
        split = (log2 > 5) or (cu.part_nxn and depth == 0)
        # split_transform_flag (7.3.8.8): signalled within the SPS depth
        # budget (MaxTrafoDepth: intra budget + IntraSplitFlag for NxN),
        # BEFORE the chroma cbfs. Our encoder writes
        # max_transform_hierarchy_depth_intra = 0 so its intra CUs never
        # carry the flag, but the decoder must honor other encoders'
        # budgets (e.g. the reference writes 2 — its streams desync a
        # decoder that reads the flag only for inter CUs).
        if not split and 2 < log2 <= 5:
            maxd = (self.st.max_tt_depth_inter if cu.is_inter
                    else (getattr(self.st, "max_tt_depth_intra", 0)
                          + (1 if cu.part_nxn else 0)))
            if depth < maxd:
                split = self.sx_split_transform(cu, x0, y0, log2, depth)
        cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if log2 > 2 or cf == 3:
            # 4:2:2 signals two flags per component — one per stacked
            # chroma TB — at leaves and at log2==3 nodes (7.3.8.8)
            nsub = 2 if (cf == 2 and (not split or log2 == 3)) else 1
            if depth == 0 or parent_cbf_cb[0]:
                cbf_cb = tuple(self.sx_cbf_chroma(cu, x0, y0, log2, depth,
                                                  1, s) for s in range(nsub))
            else:
                cbf_cb = (0,) * nsub
            if depth == 0 or parent_cbf_cr[0]:
                cbf_cr = tuple(self.sx_cbf_chroma(cu, x0, y0, log2, depth,
                                                  2, s) for s in range(nsub))
            else:
                cbf_cr = (0,) * nsub
        if split:
            half = 1 << (log2 - 1)
            for i, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half), (half, half))):
                self.transform_tree(cu, x0 + dx, y0 + dy, log2 - 1,
                                    depth + 1, i, cbf_cb, cbf_cr)
        else:
            if cu.is_inter and depth == 0 and not any(cbf_cb) \
                    and not any(cbf_cr):
                cbf_luma = 1     # inferred (7.4.9.8): rqt_root_cbf was 1
            else:
                cbf_luma = self.sx_cbf_luma(cu, x0, y0, log2, depth)
            self.transform_unit(cu, x0, y0, log2, depth, blk_idx,
                                cbf_luma, cbf_cb, cbf_cr)

    def transform_unit(self, cu: _CuCtx, x0: int, y0: int, log2: int,
                       depth: int, blk_idx: int,
                       cbf_luma: int, cbf_cb: tuple, cbf_cr: tuple) -> None:
        # deblocking edge flags: every luma TB edge on the 8x8 grid has
        # bS=2 in an intra picture (8.7.2.4); CU/PU edges coincide with or
        # contain TB edges in this tree
        st, n = self.st, 1 << log2
        if x0 % 8 == 0:
            st.edge_v[y0 >> 2:(y0 + n) >> 2, x0 >> 3] = True
        if y0 % 8 == 0:
            st.edge_h[y0 >> 3, x0 >> 2:(x0 + n) >> 2] = True
        st.cbf4[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2] = cbf_luma
        # cu_qp_delta: once per QG, at the first TU with any coded cbf
        # (7.3.8.10 — the covering node's chroma cbfs count for every child)
        if (st.cu_qp_delta_enabled and not st.qg_qp_coded
                and (cbf_luma or any(cbf_cb) or any(cbf_cr))):
            self.sx_cu_qp_delta()
        mode_idx = blk_idx if (cu.part_nxn and depth > 0) else 0
        self.tb_luma(cu, x0, y0, log2, cu.luma_modes[mode_idx], cbf_luma)
        if log2 > 2 or st.chroma_format == 3:
            self.tb_chroma(cu, x0, y0, log2, cbf_cb, cbf_cr)
        elif blk_idx == 3:
            # 4x4 luma TBs (4:2:0/4:2:2): the node's chroma TBs are coded
            # with the last child
            self.tb_chroma(cu, x0 - 4, y0 - 4, 3, cbf_cb, cbf_cr)

    # ----------------------------------------------- syntax hooks (subclass)
    def sx_split_cu(self, x0, y0, log2, depth, ctx_inc) -> int:
        raise NotImplementedError

    def sx_skip_flag(self, x0, y0, log2, ctx_inc) -> int:
        raise NotImplementedError

    def sx_pred_mode(self, x0, y0, log2) -> int:
        """1 = intra."""
        raise NotImplementedError

    def sx_part_mode_inter(self, x0, y0, log2) -> None:
        raise NotImplementedError

    def sx_merge_flag(self, x0, y0, log2) -> int:
        raise NotImplementedError

    def sx_merge_idx(self, x0, y0, log2) -> int:
        raise NotImplementedError

    def sx_inter_pred_idc(self, x0, y0, log2, depth) -> int:
        """0 = PRED_L0, 1 = PRED_L1, 2 = PRED_BI."""
        raise NotImplementedError

    def sx_mvd(self, x0, y0, log2, lst) -> tuple[int, int]:
        raise NotImplementedError

    def sx_mvp_flag(self, x0, y0, log2, lst) -> int:
        raise NotImplementedError

    def sx_rqt_root_cbf(self, x0, y0, log2) -> int:
        raise NotImplementedError

    def sx_part_mode(self, x0, y0) -> int:
        raise NotImplementedError

    def sx_prev_intra_flags(self, pu_pos, pu_sz) -> list[int]:
        raise NotImplementedError

    def sx_luma_mode(self, pu_idx, px, py, pu_sz, cand, prev_flag) -> int:
        raise NotImplementedError

    def sx_chroma_mode(self, x0, y0, luma_mode0) -> int:
        raise NotImplementedError

    def sx_split_transform(self, cu, x0, y0, log2, depth) -> int:
        raise NotImplementedError

    def sx_cbf_chroma(self, cu, x0, y0, log2, depth, c_idx, sub) -> int:
        """sub: stacked-TB index (0; 1 = lower TB for 4:2:2)."""
        raise NotImplementedError

    def sx_cbf_luma(self, cu, x0, y0, log2, depth) -> int:
        raise NotImplementedError

    def sx_cu_qp_delta(self) -> None:
        """Code cu_qp_delta_abs/sign (9.3.3.10) and resolve the QG's QP."""
        raise NotImplementedError

    def tb_luma(self, cu, x0, y0, log2, mode, cbf) -> None:
        raise NotImplementedError

    def tb_chroma(self, cu, nx, ny, nlog2, cbf_cb, cbf_cr) -> None:
        """Code the chroma TBs of the node at luma (nx, ny, nlog2);
        cbf_cb/cbf_cr are per-stacked-TB tuples."""
        raise NotImplementedError

    # --------------------------------------------------------- shared helpers
    @staticmethod
    def _mpm_sorted(cand: list[int]) -> list[int]:
        return sorted(cand)

    @staticmethod
    def rem_from_mode(mode: int, cand: list[int]) -> int:
        rem = mode
        for c in sorted(cand, reverse=True):
            if rem > c:
                rem -= 1
        return rem

    @staticmethod
    def mode_from_rem(rem: int, cand: list[int]) -> int:
        mode = rem
        for c in sorted(cand):
            if mode >= c:
                mode += 1
        return mode


def _decode_egk(dec, k: int) -> int:
    v = 0
    while dec.decode_bypass():
        v += 1 << k
        k += 1
        if k > 30:
            raise ValueError("invalid exp-golomb bypass code")
    if k:
        v += dec.decode_bypass_bins(k)
    return v


# ============================================================ decoder subclass

class CtuDecoder(CtuCoderBase):
    """Parses CU syntax from a CabacDecoder and reconstructs the picture."""

    is_decoder = True

    def sx_split_cu(self, x0, y0, log2, depth, ctx_inc):
        return self.bac.decode_bin(Ctx.SPLIT_CU + ctx_inc)

    def sx_skip_flag(self, x0, y0, log2, ctx_inc):
        return self.bac.decode_bin(Ctx.CU_SKIP + ctx_inc)

    def sx_pred_mode(self, x0, y0, log2):
        return self.bac.decode_bin(Ctx.PRED_MODE)

    def sx_part_mode_inter(self, x0, y0, log2):
        if not self.bac.decode_bin(Ctx.PART_MODE):
            raise NotImplementedError("inter partitions other than 2Nx2N")

    def sx_merge_flag(self, x0, y0, log2):
        return self.bac.decode_bin(Ctx.MERGE_FLAG)

    def sx_merge_idx(self, x0, y0, log2):
        cmax = self.st.max_merge - 1
        if cmax == 0 or not self.bac.decode_bin(Ctx.MERGE_IDX):
            return 0
        idx = 1
        while idx < cmax and self.bac.decode_bypass():
            idx += 1
        return idx

    def sx_inter_pred_idc(self, x0, y0, log2, depth):
        # 9.3.3.7: bin0 ctx = cqtDepth; 1 -> BI, else bin1 (ctx 4) L0/L1
        if self.bac.decode_bin(Ctx.INTER_DIR + depth):
            return 2
        return self.bac.decode_bin(Ctx.INTER_DIR + 4)

    def sx_mvd(self, x0, y0, log2, lst):
        bac = self.bac
        gx = bac.decode_bin(Ctx.MVD)
        gy = bac.decode_bin(Ctx.MVD)
        g1x = bac.decode_bin(Ctx.MVD + 1) if gx else 0
        g1y = bac.decode_bin(Ctx.MVD + 1) if gy else 0
        out = []
        for g, g1 in ((gx, g1x), (gy, g1y)):
            if not g:
                out.append(0)
                continue
            mag = 1
            if g1:
                mag = 2 + _decode_egk(bac, 1)
            out.append(-mag if bac.decode_bypass() else mag)
        return out[0], out[1]

    def sx_mvp_flag(self, x0, y0, log2, lst):
        return self.bac.decode_bin(Ctx.MVP)

    def sx_rqt_root_cbf(self, x0, y0, log2):
        return self.bac.decode_bin(Ctx.RQT_ROOT_CBF)

    def sx_part_mode(self, x0, y0):
        # part_mode bin0: 1 = PART_2Nx2N, 0 = PART_NxN (intra, min CB)
        return 0 if self.bac.decode_bin(Ctx.PART_MODE) else 1

    def sx_prev_intra_flags(self, pu_pos, pu_sz):
        return [self.bac.decode_bin(Ctx.PREV_INTRA_LUMA) for _ in pu_pos]

    def sx_luma_mode(self, pu_idx, px, py, pu_sz, cand, prev_flag):
        if prev_flag:
            mpm_idx = 0
            if self.bac.decode_bypass():
                mpm_idx = 1 + self.bac.decode_bypass()
            return cand[mpm_idx]
        rem = self.bac.decode_bypass_bins(5)
        return self.mode_from_rem(rem, cand)

    def sx_chroma_mode(self, x0, y0, luma_mode0):
        if self.bac.decode_bin(Ctx.INTRA_CHROMA) == 0:
            return luma_mode0                      # DM
        idx = self.bac.decode_bypass_bins(2)
        return chroma_cand_list(luma_mode0)[idx]

    def sx_split_transform(self, cu, x0, y0, log2, depth):
        return self.bac.decode_bin(Ctx.SPLIT_TRANSFORM + 5 - log2)

    def sx_cbf_chroma(self, cu, x0, y0, log2, depth, c_idx, sub):
        return self.bac.decode_bin(Ctx.CBF_CHROMA + depth)

    def sx_cbf_luma(self, cu, x0, y0, log2, depth):
        return self.bac.decode_bin(Ctx.CBF_LUMA + (1 if depth == 0 else 0))

    def sx_cu_qp_delta(self):
        """Parse cu_qp_delta_abs (TR cMax=5, bin0 ctx 0, bins 1-4 ctx 1,
        EG0 bypass suffix) + sign; derive QpY per 8.6.1."""
        bac = self.bac
        a = 0
        if bac.decode_bin(Ctx.DQP):
            a = 1
            while a < 5 and bac.decode_bin(Ctx.DQP + 1):
                a += 1
            if a == 5:
                a += _decode_egk(bac, 0)
        delta = 0
        if a:
            delta = -a if bac.decode_bypass() else a
        st = self.st
        off = 6 * (st.bit_depth - 8)          # QpBdOffsetY
        st.set_qp(((st.qg_pred + delta + 52 + 2 * off) % (52 + off)) - off)
        st.qg_qp_coded = True

    def tb_luma(self, cu, x0, y0, log2, mode, cbf):
        n = 1 << log2
        if cu.is_inter:
            pred = cu.pred[0][y0 - cu.y0:y0 - cu.y0 + n,
                              x0 - cu.x0:x0 - cu.x0 + n]
        else:
            pred = predict_block(self.st, 0, x0, y0, n, mode)
        levels = None
        if cbf:
            scan = select_scan(log2, 0, None if cu.is_inter else mode)
            levels = decode_residual(self.bac, log2, 0, scan)
        reconstruct_tb(self.st, 0, x0, y0, n, pred, levels,
                       is_intra=not cu.is_inter)

    def tb_chroma(self, cu, nx, ny, nlog2, cbf_cb, cbf_cr):
        st = self.st
        tbs = self._chroma_leaf_tbs(nx, ny, nlog2)
        c444 = st.chroma_format == 3
        for c_idx, cbfs in ((1, cbf_cb), (2, cbf_cr)):
            for sub, (xc, yc, log2c) in enumerate(tbs):
                n = 1 << log2c
                mode = cu.chroma_mode_at(xc, yc)
                if cu.is_inter:
                    cx0, cy0 = cu.x0 >> st.ss_x, cu.y0 >> st.ss_y
                    pred = cu.pred[c_idx][yc - cy0:yc - cy0 + n,
                                          xc - cx0:xc - cx0 + n]
                else:
                    pred = predict_block(st, c_idx, xc, yc, n, mode)
                levels = None
                if cbfs[sub]:
                    scan = select_scan(log2c, 1,
                                       None if cu.is_inter else mode,
                                       chroma444=c444)
                    levels = decode_residual(self.bac, log2c, c_idx, scan)
                reconstruct_tb(st, c_idx, xc, yc, n, pred, levels,
                               is_intra=not cu.is_inter)
