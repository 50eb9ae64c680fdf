"""CTU coding: shared CU-quadtree traversal for encoder and decoder.

One traversal implements the HEVC coding_quadtree / coding_unit /
transform_tree / transform_unit syntax (H.265 7.3.8); `CtuEncoder` and
`CtuDecoder` subclass only the syntax-element hooks (write-and-return vs
read).  All reconstruction (intra predict -> dequant -> inverse transform ->
clip) goes through the same normative helpers, so encoder recon and decoder
recon cannot drift: the end-to-end test asserts bit-exact equality through
the real coded bitstream.

The encoder is decoder-shaped: at each cbf syntax position it runs the
forward path (predict / residual / transform / quantize) for exactly the
transform block that flag describes, so the flag value is known the moment
it must be emitted and prediction always sees the same reconstructed
neighbors the decoder will see.

Analogue of reference Source/Lib/Codec/EbCodingLoop.c (EncodePass :2989,
EncodeLoop :651) + EbEntropyCoding.c (EncodeLcu :7343) re-designed as a
single role-parameterised walk.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.contexts import Ctx
from ..bitstream.residual import (decode_residual, emit_residual,
                                  select_scan)
from . import intra
from .inter import (Mi, amvp_candidates, mc_predict_bi, mc_predict_uni,
                    merge_candidates, uni_mi)
from .quant import dequantize, quantize, quantize_rdoq
from .transforms import forward_transform, inverse_transform

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


def _encode_egk(bac, v: int, k: int) -> None:
    """k-th order Exp-Golomb, bypass bins (9.3.3.3)."""
    while v >= (1 << k):
        bac.encode_bypass(1)
        v -= 1 << k
        k += 1
    bac.encode_bypass(0)
    if k:
        bac.encode_bypass_bins(v, k)


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


# ============================================================ encoder subclass

class _InterPlan:
    """The encoder's decided coding of one potential inter CU."""

    __slots__ = ("use_inter", "skip", "merge_flag", "merge_idx", "mvd",
                 "mvp_idx", "mi", "idc", "root_cbf", "merge_list", "amvp")

    def __init__(self):
        self.use_inter = False
        self.skip = False
        self.merge_flag = False
        self.merge_idx = 0
        self.mvd = [(0, 0), (0, 0)]      # per list
        self.mvp_idx = [0, 0]
        self.mi = Mi()
        self.idc = 0                      # 0 L0, 1 L1, 2 BI
        self.root_cbf = 1
        # cached spec derivations (the emit walk reuses the MD pass's
        # merge/AMVP lists instead of re-deriving them per CU)
        self.merge_list = None
        self.amvp = [None, None]


# integer refinement radius around the TPU HME seed (full-pel). The
# 3-level HME already localises to ~1 pel; r=2 measured bit-identical to
# r=4 on panning content at 1.6x the speed
SEEDED_ME_RANGE = 2

_H2 = np.array([[1, 1], [1, -1]], np.int64)
_H4 = np.block([[_H2, _H2], [_H2, -_H2]])
_H8 = np.block([[_H4, _H4], [_H4, -_H4]])


def _satd_host(diff: np.ndarray) -> float:
    """Blockwise Hadamard SATD of an (n, n) residual, ~2x SAD scale
    (reference analogue: EbHmCode.c Compute4x4Satd/8x8 used by the MD
    fast loop)."""
    n = diff.shape[0]
    k = 4 if n == 4 else 8
    h = _H4 if k == 4 else _H8
    b = (diff.reshape(n // k, k, n // k, k).transpose(0, 2, 1, 3)
         .astype(np.int64))
    t = h @ b @ h.T
    return float(np.abs(t).sum()) / (k // 2)


def _mvd_bits(v: int) -> int:
    a = abs(v)
    if a == 0:
        return 1
    if a == 1:
        return 3
    return 4 + 2 * max(a - 2, 1).bit_length()


class CtuEncoder(CtuCoderBase):
    """Writes CU syntax with a CabacEncoder while reconstructing exactly as
    the decoder will.

    Decisions: `split_policy(x0, y0, log2, depth) -> bool` chooses the CU
    tree; luma modes are chosen on the fly by SAD against the source from
    the true reconstructed references (closed loop); chroma uses DM.
    A later RD mode-decision stage supplies better policies via the same
    hooks (reference analogue: EbProductCodingLoop.c ModeDecisionLcu :4691).
    """

    is_decoder = False

    def __init__(self, state, bac, src_planes, *, split_policy=None,
                 part_nxn_policy=None, mode_policy=None, me_seed=None,
                 features=None, ois=None, decision_cache=None,
                 mcts_rect=None):
        super().__init__(state, bac)
        # motion-constrained tile set: (tx0, ty0, tx1, ty1) luma pixel rect
        # of the current tile; when set, every chosen MV keeps the full
        # interpolation window inside the rect (reference analogue: MCTS
        # packaging validated by the FunctionalTests MCTS decoder check,
        # Tests/SVT-HEVC_FunctionalTests.py:1044-1059)
        self.mcts_rect = mcts_rect
        from ..preset import derive_preset
        self.src = src_planes        # [y, cb, cr] int arrays, coded dims
        self.split_policy = split_policy or self._default_split
        self.part_nxn_policy = part_nxn_policy or (lambda x0, y0: False)
        self.mode_policy = mode_policy    # optional (x,y,size)->mode override
        self.me_seed = me_seed       # (H//16, W//16, 2) quarter-pel MV field
        self.feat = features if features is not None else derive_preset(7)
        # TPU open-loop intra search products: {n: (mode_map, cost_map)}
        # for n in 4/8/16/32 (reference analogue: OIS results driving MD
        # candidate pruning, EbModeDecisionConfigurationProcess.c:289)
        self.ois = ois
        self._pu_modes: dict[tuple[int, int], int] = {}
        # decision_cache: shared between the decide and emit passes (both
        # see identical reconstruction state, so plans and chosen modes are
        # deterministic replays — compute once, reuse in pass 2)
        if decision_cache is None:
            decision_cache = {"plans": {}, "modes": {}}
        self._plans: dict[tuple[int, int, int], _InterPlan] = \
            decision_cache["plans"]
        self._mode_cache: dict[tuple[int, int, int], tuple] = \
            decision_cache["modes"]

    def _quant(self, coeff, qp, is_intra):
        """Preset-selected quantizer: plain scalar quant or RDOQ
        (reference ladder: RDOQ/PM at M0-M4, SURVEY.md §2.4b)."""
        if self.feat.rdoq:
            lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
            return quantize_rdoq(coeff, qp, lam, is_intra=is_intra,
                                 bit_depth=self.st.bit_depth)
        return quantize(coeff, qp, is_intra=is_intra,
                        bit_depth=self.st.bit_depth)

    # ------------------------------------------------------------- decisions
    def _default_split(self, x0, y0, log2, depth):
        """Variance heuristic placeholder until RD mode decision lands."""
        if log2 <= 4:
            return False
        blk = self.src[0][y0:y0 + (1 << log2), x0:x0 + (1 << log2)]
        return float(np.var(blk.astype(np.float64))) > 900.0

    def _ois_mode(self, px, py, n) -> int | None:
        """Open-loop best mode of the block from the TPU OIS maps (64-CU
        PUs fall back to the covering 32 map)."""
        if self.ois is None:
            return None
        k = min(n, 32)
        mode_map = self.ois[k][0]
        return int(mode_map[py // k, px // k])

    def _choose_luma_mode(self, px, py, n, cand):
        """Returns (mode, sad_cost)."""
        if self.mode_policy is not None:
            got = self.mode_policy(px, py, n)
            if got is not None and got >= 0:
                return got, 0
        hit = self._mode_cache.get((px, py, n))
        if hit is not None:
            return hit
        src = self.src[0][py:py + n, px:px + n].astype(np.int64)
        best_mode, best_cost = 1, None
        left, corner, top = intra.build_ref_samples(
            self.st.planes[0], self.st.intra_avail(0), px, py, n,
            bit_depth=self.st.bit_depth)
        ois_mode = self._ois_mode(px, py, n) if self.feat.ois_intra else None
        if ois_mode is not None:
            # OIS-driven shortlist: open-loop winner + MPMs + planar/DC
            # refined closed-loop (reference enhanced-I MD candidates)
            modes = sorted({ois_mode, intra.PLANAR, intra.DC, *cand})
        elif self.feat.all_intra_modes:
            modes = range(35)
        else:
            modes = sorted({intra.PLANAR, intra.DC, intra.VERTICAL,
                            intra.HORIZONTAL, *cand})
        for mode in modes:
            fl, fc, ft = intra.filter_ref_samples(
                left, corner, top, n, mode, 0, self.st.bit_depth)
            pred = intra.predict_intra(fl, fc, ft, n, mode, 0, self.st.bit_depth)
            bits = (1 + (1 if cand.index(mode) == 0 else 2)
                    if mode in cand else 6)
            # SATD ranking (~2x SAD scale), like the reference's MD fast
            # loop and the TPU OIS — SAD misranks directional residuals
            cost = _satd_host(pred - src) + 6 * bits
            if best_cost is None or cost < best_cost:
                best_mode, best_cost = mode, cost
        self._mode_cache[(px, py, n)] = (best_mode, best_cost)
        return best_mode, best_cost

    # ------------------------------------------------------- MCTS legality
    def _mv_legal(self, x0, y0, w, h, mvq) -> bool:
        """True if the MC interpolation window for quarter-pel MV `mvq`
        stays inside the motion-constrained tile rect (8-tap luma / 4-tap
        chroma margins; mv%8==0 means integer positions on both planes)."""
        rect = self.mcts_rect
        if rect is None:
            return True
        tx0, ty0, tx1, ty1 = rect
        for p0, n, t0, t1, mv in ((x0, w, tx0, tx1, int(mvq[0])),
                                  (y0, h, ty0, ty1, int(mvq[1]))):
            i = mv >> 2
            lo, hi = (0, 0) if mv % 8 == 0 else (4, 4)
            if p0 + i - lo < t0 or p0 + n + i + hi > t1:
                return False
        return True

    def _mi_legal(self, x0, y0, n, mi) -> bool:
        for lst in (0, 1):
            if mi.ref(lst) >= 0 and not self._mv_legal(x0, y0, n, n,
                                                       mi.mv(lst)):
                return False
        return True

    # ------------------------------------------------------- inter decision
    def _plan(self, x0, y0, log2) -> _InterPlan:
        key = (x0, y0, log2)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._compute_plan(x0, y0, log2)
            self._plans[key] = plan
        return plan

    def _merge_list(self, x0, y0, n):
        p = self._plans.get((x0, y0, n.bit_length() - 1))
        if p is not None and p.merge_list is not None:
            return p.merge_list
        return super()._merge_list(x0, y0, n)

    def _amvp(self, x0, y0, n, lst):
        p = self._plans.get((x0, y0, n.bit_length() - 1))
        if p is not None and p.amvp[lst] is not None:
            return p.amvp[lst]
        return super()._amvp(x0, y0, n, lst)

    def _pred_luma_mi(self, x0, y0, n, mi: Mi):
        """Luma-only MC prediction for cost evaluation."""
        from .inter import interp_luma, interp_luma_raw
        st = self.st
        bd = st.bit_depth
        if mi.ref0 >= 0 and mi.ref1 >= 0:
            a = interp_luma_raw(st.ref_planes[0][mi.ref0][0], x0, y0, n, n,
                                mi.mv0[0], mi.mv0[1], bd)
            b = interp_luma_raw(st.ref_planes[1][mi.ref1][0], x0, y0, n, n,
                                mi.mv1[0], mi.mv1[1], bd)
            shift = 15 - bd
            return np.clip((a + b + (1 << (shift - 1))) >> shift,
                           0, (1 << bd) - 1)
        lst = 0 if mi.ref0 >= 0 else 1
        mv = mi.mv(lst)
        return interp_luma(st.ref_planes[lst][mi.ref(lst)][0], x0, y0, n, n,
                           mv[0], mv[1], bd)

    def _motion_search(self, x0, y0, n, pred_mv, lst=0):
        """Integer full search around the better of the AMVP predictor and
        the TPU HME seed, then half- and quarter-pel refinement. Returns
        (sad, (mvx, mvy) quarter-pel). Host analogue of reference
        MotionEstimateLcu (EbMotionEstimation.c:3671); the batched TPU HME
        (svt_hevc_tpu.tpu.me) supplies the search centers."""
        from .inter import _gather_window, interp_luma
        st = self.st
        ref = st.ref_planes[lst][0][0]
        src = self.src[0][y0:y0 + n, x0:x0 + n].astype(np.int64)
        # MCTS: legal integer MV box with the full subpel margin (4 px per
        # side covers 8-tap luma + 4-tap chroma + any quarter-pel probe)
        bounds = None
        if self.mcts_rect is not None:
            tx0, ty0, tx1, ty1 = self.mcts_rect
            bounds = (tx0 - x0 + 4, tx1 - (x0 + n) - 4,
                      ty0 - y0 + 4, ty1 - (y0 + n) - 4)
            if bounds[0] > bounds[1] or bounds[2] > bounds[3]:
                # tile too small for any interpolated window: zero MV only
                w0 = _gather_window(ref, x0, y0, n, n).astype(np.int64)
                return int(np.abs(w0 - src).sum()), (0, 0)
        centers = [(int(pred_mv[0]) >> 2, int(pred_mv[1]) >> 2)]
        r = self.feat.me_range
        if self.me_seed is not None and lst == 0:
            s = self.me_seed[min((y0 + n // 2) >> 4, self.me_seed.shape[0] - 1),
                             min((x0 + n // 2) >> 4, self.me_seed.shape[1] - 1)]
            centers.append((int(s[0]) >> 2, int(s[1]) >> 2))
            r = SEEDED_ME_RANGE     # HME already localised the search
        if bounds is not None:
            centers = [(min(max(c[0], bounds[0]), bounds[1]),
                        min(max(c[1], bounds[2]), bounds[3]))
                       for c in centers]
        if len(centers) > 1 and centers[0] != centers[1]:
            def int_sad(c):
                w = _gather_window(ref, x0 + c[0], y0 + c[1], n, n).astype(np.int64)
                return int(np.abs(w - src).sum())
            centers.sort(key=int_sad)
        cx = x0 + centers[0][0]
        cy = y0 + centers[0][1]
        win = _gather_window(ref, cx - r, cy - r, n + 2 * r, n + 2 * r).astype(np.int64)
        sw = np.lib.stride_tricks.sliding_window_view(win, (n, n))
        sad = np.abs(sw - src).sum(axis=(2, 3))
        if bounds is not None:
            dxs = np.arange(-r, r + 1) + (cx - x0)
            dys = np.arange(-r, r + 1) + (cy - y0)
            illegal = ((dys[:, None] < bounds[2]) | (dys[:, None] > bounds[3])
                       | (dxs[None, :] < bounds[0])
                       | (dxs[None, :] > bounds[1]))
            sad = np.where(illegal, np.int64(1) << 60, sad)
        k = int(np.argmin(sad))
        dy, dx = divmod(k, 2 * r + 1)
        best_mv = ((cx - x0 + dx - r) << 2, (cy - y0 + dy - r) << 2)
        best_sad = int(sad[dy, dx])
        steps = (2, 1) if self.feat.subpel_me else ()
        if best_sad <= n * n:        # < 1 LSB/px residual: subpel can't pay
            steps = ()
        def probe(bx, by, ox, oy):
            p = interp_luma(ref, x0, y0, n, n, bx + ox, by + oy,
                            st.bit_depth).astype(np.int64)
            return int(np.abs(p - src).sum())

        for step in steps:           # half-pel, then quarter-pel
            bx, by = best_mv
            # cross positions first; diagonals only around the best cross
            # direction (the reference's staged sub-pel pattern,
            # EbHevcHalfPelSearch_LCU refinement ordering)
            best_dir = None
            for ox, oy in ((-step, 0), (step, 0), (0, -step), (0, step)):
                s = probe(bx, by, ox, oy)
                if s < best_sad:
                    best_sad, best_mv = s, (bx + ox, by + oy)
                    best_dir = (ox, oy)
            if best_dir is None:     # flat subpel surface: stop refining
                break
            dx = best_dir[0] or None
            dy = best_dir[1] or None
            for ox, oy in (((dx or -step), (dy or -step)),
                           ((dx or step), (dy or step))):
                s = probe(bx, by, ox, oy)
                if s < best_sad:
                    best_sad, best_mv = s, (bx + ox, by + oy)
        return best_sad, best_mv

    def _inter_tb_levels(self, x0, y0, log2, pred3):
        """Quantized levels of all TBs of a (candidate) inter CU. Returns
        (luma_levels dict, chroma_levels dict, any_nonzero)."""
        st = self.st
        luma, chroma = {}, {}
        any_nz = False

        def luma_tb(x, y, lg):
            n = 1 << lg
            p = pred3[0][y - y0:y - y0 + n, x - x0:x - x0 + n]
            resid = self.src[0][y:y + n, x:x + n].astype(np.int64) - p
            lv = self._quant(forward_transform(resid, st.bit_depth, dst=False),
                             st.qp, is_intra=False)
            luma[(x, y)] = lv
            return bool(lv.any())

        def chroma_tb(c_idx, xc, yc, log2c):
            n = 1 << log2c
            cx0, cy0 = x0 >> st.ss_x, y0 >> st.ss_y
            p = pred3[c_idx][yc - cy0:yc - cy0 + n, xc - cx0:xc - cx0 + n]
            resid = self.src[c_idx][yc:yc + n, xc:xc + n].astype(np.int64) - p
            lv = self._quant(forward_transform(resid, st.bit_depth, dst=False),
                             st.qp_c, is_intra=False)
            chroma[(c_idx, xc, yc)] = lv
            return bool(lv.any())

        nodes = [(x0, y0, log2)]
        if log2 > 5:
            h = 1 << (log2 - 1)
            nodes = [(x0 + dx, y0 + dy, log2 - 1)
                     for dx, dy in ((0, 0), (h, 0), (0, h), (h, h))]
        for nx, ny, lg in nodes:
            any_nz |= luma_tb(nx, ny, lg)
        for nx, ny, lg in nodes:
            for c_idx in (1, 2):
                for xc, yc, log2c in self._chroma_leaf_tbs(nx, ny, lg):
                    any_nz |= chroma_tb(c_idx, xc, yc, log2c)
        return luma, chroma, any_nz

    def _compute_plan(self, x0, y0, log2) -> _InterPlan:
        st = self.st
        n = 1 << log2
        is_b = st.slice_type == B_SLICE
        plan = _InterPlan()
        src = self.src[0][y0:y0 + n, x0:x0 + n].astype(np.int64)

        merge_list = merge_candidates(st, x0, y0, n, st.max_merge)
        amvp = [amvp_candidates(st, x0, y0, n, 0),
                amvp_candidates(st, x0, y0, n, 1) if is_b else None]
        plan.merge_list = merge_list
        plan.amvp = amvp

        def sad_of(mi):
            p = self._pred_luma_mi(x0, y0, n, mi).astype(np.int64)
            return int(np.abs(p - src).sum())

        # merge candidates (deduped for evaluation; MCTS-illegal MVs are
        # never selected)
        best = None      # (cost, kind, ...)
        seen = set()
        for idx, m in enumerate(merge_list):
            if m in seen:
                continue
            seen.add(m)
            if not self._mi_legal(x0, y0, n, m):
                continue
            cost = sad_of(m) + 3 * (2 + idx)
            if best is None or cost < best[0]:
                best = (cost, "merge", idx, m)

        # per-list motion search from the AMVP predictors
        me = {}
        lists = (0, 1) if is_b else (0,)
        for lst in lists:
            sad, mv = self._motion_search(x0, y0, n, amvp[lst][0], lst)
            b0 = (_mvd_bits(mv[0] - amvp[lst][0][0])
                  + _mvd_bits(mv[1] - amvp[lst][0][1]))
            b1 = (_mvd_bits(mv[0] - amvp[lst][1][0])
                  + _mvd_bits(mv[1] - amvp[lst][1][1]))
            mvp_i = 1 if b1 < b0 else 0
            me[lst] = (sad, mv, mvp_i, min(b0, b1))
            cost = sad + 3 * (4 + min(b0, b1))
            if best is None or cost < best[0]:
                best = (cost, "amvp", lst, mv, mvp_i)

        if is_b and 0 in me and 1 in me:
            mi_bi = Mi(me[0][1], 0, me[1][1], 0)
            cost = sad_of(mi_bi) + 3 * (5 + me[0][3] + me[1][3])
            if cost < best[0]:
                best = (cost, "bi", mi_bi)

        # intra comparison (2Nx2N): TPU OIS cost when available (the
        # reference's fast-loop intra-vs-inter uses the OIS SADs), else a
        # host closed-loop probe. The open-loop cost predicts from clean
        # source neighbors and so understates the closed-loop cost; the 2x
        # weight restores the inter preference (the same direction as the
        # reference's NFL ordering, which ranks merge/skip first)
        if self.ois is not None:
            if n <= 32:
                intra_cost = 2.0 * float(self.ois[n][1][y0 // n, x0 // n])
            else:
                c32 = self.ois[32][1]
                intra_cost = 2.0 * float(
                    c32[y0 // 32:y0 // 32 + 2, x0 // 32:x0 // 32 + 2].sum())
        else:
            cand = derive_mpm(st, x0, y0)
            _, intra_cost = self._choose_luma_mode(x0, y0, n, cand)
        if intra_cost is not None and intra_cost + 3 * 2 < best[0]:
            plan.use_inter = False
            return plan

        plan.use_inter = True
        if best[1] == "merge":
            plan.merge_flag = True
            plan.merge_idx = best[2]
            plan.mi = best[3]
        elif best[1] == "bi":
            plan.mi = best[2]
            plan.idc = 2
            for lst in (0, 1):
                mv = plan.mi.mv(lst)
                mvp_i = me[lst][2]
                plan.mvp_idx[lst] = mvp_i
                plan.mvd[lst] = (mv[0] - amvp[lst][mvp_i][0],
                                 mv[1] - amvp[lst][mvp_i][1])
        else:
            _, kind, lst, mv, mvp_i = best
            plan.mi = uni_mi(mv, 0, lst)
            plan.idc = lst
            plan.mvp_idx[lst] = mvp_i
            plan.mvd[lst] = (mv[0] - amvp[lst][mvp_i][0],
                             mv[1] - amvp[lst][mvp_i][1])
        pred3 = list(self._predict_mi(x0, y0, n, plan.mi))
        _, _, any_nz = self._inter_tb_levels(x0, y0, log2, pred3)
        plan.root_cbf = int(any_nz)
        plan.skip = bool(plan.merge_flag and not any_nz)
        return plan

    # ---------------------------------------------------------- syntax hooks
    def sx_split_cu(self, x0, y0, log2, depth, ctx_inc):
        split = 1 if self.split_policy(x0, y0, log2, depth) else 0
        self.bac.encode_bin(Ctx.SPLIT_CU + ctx_inc, split)
        return split

    def sx_skip_flag(self, x0, y0, log2, ctx_inc):
        plan = self._plan(x0, y0, log2)
        skip = int(plan.use_inter and plan.skip)
        self.bac.encode_bin(Ctx.CU_SKIP + ctx_inc, skip)
        return skip

    def sx_pred_mode(self, x0, y0, log2):
        plan = self._plan(x0, y0, log2)
        intra_flag = int(not plan.use_inter)
        self.bac.encode_bin(Ctx.PRED_MODE, intra_flag)
        return intra_flag

    def sx_part_mode_inter(self, x0, y0, log2):
        self.bac.encode_bin(Ctx.PART_MODE, 1)      # PART_2Nx2N

    def sx_merge_flag(self, x0, y0, log2):
        plan = self._plan(x0, y0, log2)
        self.bac.encode_bin(Ctx.MERGE_FLAG, int(plan.merge_flag))
        return int(plan.merge_flag)

    def sx_merge_idx(self, x0, y0, log2):
        idx = self._plan(x0, y0, log2).merge_idx
        cmax = self.st.max_merge - 1
        if cmax > 0:
            self.bac.encode_bin(Ctx.MERGE_IDX, int(idx > 0))
            if idx > 0:
                for i in range(1, idx):
                    self.bac.encode_bypass(1)
                if idx < cmax:
                    self.bac.encode_bypass(0)
        return idx

    def sx_inter_pred_idc(self, x0, y0, log2, depth):
        idc = self._plan(x0, y0, log2).idc
        if idc == 2:
            self.bac.encode_bin(Ctx.INTER_DIR + depth, 1)
        else:
            self.bac.encode_bin(Ctx.INTER_DIR + depth, 0)
            self.bac.encode_bin(Ctx.INTER_DIR + 4, idc)
        return idc

    def sx_mvd(self, x0, y0, log2, lst):
        mvd = self._plan(x0, y0, log2).mvd[lst]
        bac = self.bac
        bac.encode_bin(Ctx.MVD, int(mvd[0] != 0))
        bac.encode_bin(Ctx.MVD, int(mvd[1] != 0))
        for v in mvd:
            if v != 0:
                bac.encode_bin(Ctx.MVD + 1, int(abs(v) > 1))
        for v in mvd:
            if v != 0:
                if abs(v) > 1:
                    _encode_egk(bac, abs(v) - 2, 1)
                bac.encode_bypass(int(v < 0))
        return mvd

    def sx_mvp_flag(self, x0, y0, log2, lst):
        idx = self._plan(x0, y0, log2).mvp_idx[lst]
        self.bac.encode_bin(Ctx.MVP, idx)
        return idx

    def sx_rqt_root_cbf(self, x0, y0, log2):
        cbf = self._plan(x0, y0, log2).root_cbf
        self.bac.encode_bin(Ctx.RQT_ROOT_CBF, cbf)
        return cbf

    def sx_part_mode(self, x0, y0):
        nxn = 1 if self.part_nxn_policy(x0, y0) else 0
        self.bac.encode_bin(Ctx.PART_MODE, 0 if nxn else 1)
        return nxn

    def sx_prev_intra_flags(self, pu_pos, pu_sz):
        """Choose every PU mode, then emit all prev_intra flags (the spec
        orders all flags before any mpm_idx / rem bins)."""
        flags = []
        for px, py in pu_pos:
            cand = derive_mpm(self.st, px, py)
            mode, _ = self._choose_luma_mode(px, py, pu_sz, cand)
            self._pu_modes[(px, py)] = mode
            # update the map immediately so the next PU's MPM derivation
            # (both here and in the shared loop) sees it, like the decoder
            self.st.luma_mode[py >> 2:(py + pu_sz) >> 2,
                              px >> 2:(px + pu_sz) >> 2] = mode
            flag = 1 if mode in cand else 0
            self.bac.encode_bin(Ctx.PREV_INTRA_LUMA, flag)
            flags.append(flag)
        return flags

    def sx_luma_mode(self, pu_idx, px, py, pu_sz, cand, prev_flag):
        mode = self._pu_modes.pop((px, py))
        if prev_flag:
            mpm_idx = cand.index(mode)
            if mpm_idx == 0:
                self.bac.encode_bypass(0)
            else:
                self.bac.encode_bypass(1)
                self.bac.encode_bypass(mpm_idx - 1)
        else:
            self.bac.encode_bypass_bins(self.rem_from_mode(mode, cand), 5)
        return mode

    def sx_chroma_mode(self, x0, y0, luma_mode0):
        self.bac.encode_bin(Ctx.INTRA_CHROMA, 0)   # DM
        return luma_mode0

    # ------------------------------------------------------- forward compute
    def prepare_cu(self, cu):
        """Forward-compute all chroma TBs of the CU (their prediction only
        needs chroma recon of prior blocks, never this CU's luma), so the
        aggregate cbf_cb/cr flags exist before emission. For inter CUs the
        luma TBs are also computed here, because cbf_luma can be *inferred*
        (never signalled) and prediction does not depend on recon order."""
        if cu.is_inter:
            self._luma_tree_inter(cu, cu.x0, cu.y0, cu.log2)
        self._chroma_tree(cu, cu.x0, cu.y0, cu.log2, 0)

    def _luma_tree_inter(self, cu, x0, y0, log2):
        if log2 > 5:
            h = 1 << (log2 - 1)
            for dx, dy in ((0, 0), (h, 0), (0, h), (h, h)):
                self._luma_tree_inter(cu, x0 + dx, y0 + dy, log2 - 1)
            return
        st = self.st
        n = 1 << log2
        pred = cu.pred[0][y0 - cu.y0:y0 - cu.y0 + n,
                          x0 - cu.x0:x0 - cu.x0 + n]
        resid = self.src[0][y0:y0 + n, x0:x0 + n].astype(np.int64) - pred
        levels = self._quant(forward_transform(resid, st.bit_depth, dst=False),
                             st.qp, is_intra=False)
        cu.luma_levels[(x0, y0)] = levels
        reconstruct_tb(st, 0, x0, y0, n, pred, levels, is_intra=False)

    def _chroma_tree(self, cu, x0, y0, log2, depth):
        """Forward-compute chroma TBs bottom-up; cbf flags are keyed by
        (c_idx, node_x, node_y, sub) matching the transform-tree signalling
        positions (aggregate single flag at split nodes)."""
        st = self.st
        cf = st.chroma_format
        split = (log2 > 5) or (cu.part_nxn and depth == 0)
        if split and (log2 > 3 or cf == 3):
            half = 1 << (log2 - 1)
            any_cbf = {1: 0, 2: 0}
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                self._chroma_tree(cu, x0 + dx, y0 + dy, log2 - 1, depth + 1)
                for c in (1, 2):
                    child = (c, x0 + dx, y0 + dy, log2 - 1)
                    any_cbf[c] |= (cu.chroma_cbf[child + (0,)]
                                   | cu.chroma_cbf.get(child + (1,), 0))
            for c in (1, 2):
                cu.chroma_cbf[(c, x0, y0, log2, 0)] = any_cbf[c]
            return
        # chroma-leaf node: 1 TB (420/444) or 2 stacked TBs (422)
        for c_idx in (1, 2):
            for sub, (xc, yc, log2c) in enumerate(
                    self._chroma_leaf_tbs(x0, y0, log2)):
                n = 1 << log2c
                if cu.is_inter:
                    cy0, cx0 = cu.y0 >> st.ss_y, cu.x0 >> st.ss_x
                    pred = cu.pred[c_idx][yc - cy0:yc - cy0 + n,
                                          xc - cx0:xc - cx0 + n]
                else:
                    pred = predict_block(st, c_idx, xc, yc, n,
                                         cu.chroma_mode_at(xc, yc))
                src = self.src[c_idx][yc:yc + n, xc:xc + n].astype(np.int64)
                coeff = forward_transform(src - pred, st.bit_depth, dst=False)
                levels = self._quant(coeff, st.qp_c, is_intra=not cu.is_inter)
                cu.chroma_levels[(c_idx, xc, yc)] = levels
                cu.chroma_cbf[(c_idx, x0, y0, log2, sub)] = int(levels.any())
                reconstruct_tb(st, c_idx, xc, yc, n, pred, levels,
                               is_intra=not cu.is_inter)

    def sx_split_transform(self, cu, x0, y0, log2, depth):
        self.bac.encode_bin(Ctx.SPLIT_TRANSFORM + 5 - log2, 0)
        return 0

    def sx_cbf_chroma(self, cu, x0, y0, log2, depth, c_idx, sub):
        cbf = cu.chroma_cbf[(c_idx, x0, y0, log2, sub)]
        self.bac.encode_bin(Ctx.CBF_CHROMA + depth, cbf)
        return cbf

    def sx_cbf_luma(self, cu, x0, y0, log2, depth):
        """Forward-compute the luma TB now (references are final) and emit
        its cbf. Inter TBs were computed in prepare_cu."""
        if cu.is_inter:
            cbf = int(cu.luma_levels[(x0, y0)].any())
            self.bac.encode_bin(Ctx.CBF_LUMA + (1 if depth == 0 else 0), cbf)
            return cbf
        n = 1 << log2
        mode_idx = 0
        if cu.part_nxn and (x0 != cu.x0 or y0 != cu.y0 or log2 == 2):
            mode_idx = ((1 if x0 != cu.x0 else 0) + (2 if y0 != cu.y0 else 0))
        mode = cu.luma_modes[mode_idx]
        pred = predict_block(self.st, 0, x0, y0, n, mode)
        src = self.src[0][y0:y0 + n, x0:x0 + n].astype(np.int64)
        resid = src - pred
        coeff = forward_transform(resid, self.st.bit_depth, dst=(n == 4))
        levels = self._quant(coeff, self.st.qp, is_intra=True)
        cu.luma_levels[(x0, y0)] = levels
        reconstruct_tb(self.st, 0, x0, y0, n, pred, levels)
        cbf = int(levels.any())
        self.bac.encode_bin(Ctx.CBF_LUMA + (1 if depth == 0 else 0), cbf)
        return cbf

    def sx_cu_qp_delta(self):
        """Emit the QG's cu_qp_delta (desired QP minus qPY_PRED)."""
        st, bac = self.st, self.bac
        delta = st.qp - st.qg_pred
        a = abs(delta)
        bac.encode_bin(Ctx.DQP, int(a > 0))
        if a:
            for _ in range(min(a, 5) - 1):
                bac.encode_bin(Ctx.DQP + 1, 1)
            if a < 5:
                bac.encode_bin(Ctx.DQP + 1, 0)
            else:
                _encode_egk(bac, a - 5, 0)
            bac.encode_bypass(int(delta < 0))
        st.qg_qp_coded = True

    # ------------------------------------------------------------ tb payload
    def tb_luma(self, cu, x0, y0, log2, mode, cbf):
        if cbf and not getattr(self.bac, "is_null", False):
            scan = select_scan(log2, 0, mode)
            emit_residual(self.bac, cu.luma_levels[(x0, y0)], 0, scan)

    def tb_chroma(self, cu, nx, ny, nlog2, cbf_cb, cbf_cr):
        if getattr(self.bac, "is_null", False):
            return
        tbs = self._chroma_leaf_tbs(nx, ny, nlog2)
        c444 = self.st.chroma_format == 3
        for c_idx, cbfs in ((1, cbf_cb), (2, cbf_cr)):
            for sub, (xc, yc, log2c) in enumerate(tbs):
                if cbfs[sub]:
                    mode = (None if cu.is_inter
                            else cu.chroma_mode_at(xc, yc))
                    scan = select_scan(log2c, 1, mode, chroma444=c444)
                    emit_residual(self.bac,
                                  cu.chroma_levels[(c_idx, xc, yc)],
                                  c_idx, scan)
