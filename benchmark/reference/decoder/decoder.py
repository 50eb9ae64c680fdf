"""Conformance HEVC decoder for the feature set this encoder emits.

This is the project's stand-in for the HM TAppDecoder oracle used by the
reference's functional tests (reference: Tests/SVT-HEVC_FunctionalTests.py
decode_test :1087, recon bit-match :641): every encode in the test suite is
decoded with this module and the output must bit-match the encoder's own
reconstruction. The decoder shares zero encoder-side decision code — it
consumes only the coded bytes — but reconstructs through the same normative
helpers (intra / transforms / quant), which is exactly the invariant HEVC
mandates of encoder and decoder.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.bitwriter import ebsp_to_rbsp
from ..bitstream.cabac import CabacDecoder
from ..bitstream.contexts import init_contexts
from ..bitstream.headers import parse_pps, parse_slice_header, parse_sps, tile_grid
from ..bitstream.nal import NalUnitType, split_annexb
from ..core.ctu import CtuDecoder, PictureState
from ..core.deblock import deblock_picture
from ..core.sao import SaoCtbParams, apply_sao, decode_sao_ctb
from ..io.yuv import Frame


def decode_stream(stream: bytes) -> list[Frame]:
    """Decode an Annex-B byte stream into output frames in display (POC)
    order. The DPB holds decoded pictures by POC; IDRs start a new coded
    video sequence. Pictures may be split into multiple independent slice
    segments (e.g. one slice per tile, the reference's tileSliceMode)."""
    sps = pps = None
    dpb: dict[int, list] = {}       # poc -> planes
    motion: dict[int, dict] = {}    # poc -> TMVP collocated motion
    out: list[tuple[int, int, Frame]] = []    # (cvs, poc, frame)
    cvs = 0
    cur: _PictureCtx | None = None
    prev_poc_lsb = prev_poc_msb = 0     # PicOrderCnt derivation (8.3.1)
    for nal_type, ebsp in split_annexb(stream):
        rbsp = ebsp_to_rbsp(ebsp)
        if nal_type == NalUnitType.SPS_NUT:
            sps = parse_sps(rbsp)
        elif nal_type == NalUnitType.PPS_NUT:
            pps = parse_pps(rbsp)
        elif nal_type in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP,
                          NalUnitType.CRA_NUT, NalUnitType.TRAIL_R,
                          NalUnitType.TRAIL_N, NalUnitType.RASL_R,
                          NalUnitType.RASL_N):
            if sps is None or pps is None:
                raise ValueError("slice before SPS/PPS")
            hdr = parse_slice_header(rbsp, int(nal_type), sps, pps)
            if not hdr.is_idr:
                # PicOrderCntMsb (8.3.1): the header carries only the LSB
                max_lsb = 1 << sps.log2_max_poc_lsb
                lsb = hdr.poc
                if (lsb < prev_poc_lsb
                        and prev_poc_lsb - lsb >= max_lsb // 2):
                    msb = prev_poc_msb + max_lsb
                elif (lsb > prev_poc_lsb
                        and lsb - prev_poc_lsb > max_lsb // 2):
                    msb = prev_poc_msb - max_lsb
                else:
                    msb = prev_poc_msb
                hdr.poc = msb + lsb
                if nal_type not in (NalUnitType.RASL_R,
                                    NalUnitType.RASL_N):
                    prev_poc_lsb, prev_poc_msb = lsb, msb
            else:
                prev_poc_lsb = prev_poc_msb = 0
            if hdr.first_slice:
                if cur is not None:
                    raise ValueError("new picture before previous finished")
                if nal_type in (NalUnitType.IDR_W_RADL,
                                NalUnitType.IDR_N_LP):
                    dpb.clear()
                    motion.clear()
                    cvs += 1
                else:
                    # RPS-driven DPB eviction (8.3.2): any reference
                    # picture not in the slice's short-term RPS is gone —
                    # exactly the spec behavior an independent decoder
                    # applies, so the encoder cannot rely on stale refs
                    keep = ({hdr.poc - d for d in hdr.keep_neg}
                            | {hdr.poc + d for d in hdr.keep_pos})
                    for stale in [p for p in dpb if p not in keep]:
                        del dpb[stale]
                        motion.pop(stale, None)
                cur = _PictureCtx(hdr, sps, pps, dpb, motion)
            elif cur is None:
                raise ValueError("non-first slice without an open picture")
            cur.decode_slice(rbsp, hdr)
            if cur.done():
                frame, planes, poc = cur.finish()
                dpb[poc] = planes
                motion[poc] = cur.motion()
                out.append((cvs, poc, frame))
                if len(dpb) > 17:
                    dead = min(dpb)
                    del dpb[dead]
                    motion.pop(dead, None)
                cur = None
    if cur is not None:
        raise ValueError("stream ended mid-picture")
    out.sort(key=lambda t: (t[0], t[1]))
    return [f for _, _, f in out]


class _PictureCtx:
    """One picture being assembled from >= 1 independent slice segments."""

    def __init__(self, hdr, sps, pps, dpb, motion=None):
        self.sps, self.pps, self.hdr0 = sps, pps, hdr
        st = PictureState(sps.width, sps.height, hdr.slice_qp, sps.log2_ctb,
                          sps.bit_depth, chroma_format=sps.chroma_format_idc)
        st.constrained_intra = pps.constrained_intra
        st.max_tt_depth_inter = sps.max_transform_hierarchy_depth_inter
        st.max_tt_depth_intra = sps.max_transform_hierarchy_depth_intra
        st.strong_intra_smoothing = sps.strong_intra_smoothing
        if pps.cu_qp_delta_enabled:
            if pps.diff_cu_qp_delta_depth != 0:
                raise NotImplementedError("QG smaller than CTB")
            st.enable_cu_qp_delta()
        if hdr.slice_type != 2:
            # reference list construction (8.3.4) with one active ref per
            # list: L0 = closest past (or closest future if none past);
            # L1 = closest future (or closest past if none future)
            past = [hdr.poc - d for d in hdr.neg_deltas]
            future = [hdr.poc + d for d in hdr.pos_deltas]
            for rp in past + future:
                if rp not in dpb:
                    raise ValueError(f"missing reference POC {rp}")
            l0 = past + future
            l1 = future + past
            if not l0:
                raise ValueError("P/B slice with an empty RPS")
            st.slice_type = hdr.slice_type
            st.ref_planes = [[dpb[l0[0]]], [dpb[l1[0]]] if l1 else []]
            st.ref_pocs = [[l0[0]], [l1[0]] if l1 else []]
            st.poc = hdr.poc
            st.max_merge = hdr.max_num_merge_cand
            if hdr.temporal_mvp and motion is not None:
                col_poc = (l0[0] if hdr.col_from_l0 or not l1 else l1[0])
                col = motion.get(col_poc)
                if col is None:
                    raise ValueError(
                        f"collocated picture {col_poc} has no motion")
                st.col = dict(col, from_l0=hdr.col_from_l0)
        self.st = st
        ctb = 1 << sps.log2_ctb
        self.ctb = ctb
        self.n_ctb_x = (sps.width + ctb - 1) // ctb
        self.n_ctb_y = (sps.height + ctb - 1) // ctb
        self.sao_on = sps.sao_enabled and (hdr.sao_luma or hdr.sao_chroma)
        self.sao_grid = [[SaoCtbParams() for _ in range(self.n_ctb_x)]
                         for _ in range(self.n_ctb_y)] if self.sao_on else None
        # tile-scan CTB sequence: (cx, cy, tile_idx) + per-tile top-left
        col_bd, row_bd = tile_grid(self.n_ctb_x, self.n_ctb_y,
                                   pps.tile_columns, pps.tile_rows)
        if not pps.loop_filter_across_tiles:
            st.filter_across_tiles = False
            st.tile_edges_x = [min(col_bd[i] * ctb, sps.width)
                               for i in range(1, pps.tile_columns)]
            st.tile_edges_y = [min(row_bd[i] * ctb, sps.height)
                               for i in range(1, pps.tile_rows)]
        self.scan: list[tuple[int, int, int]] = []
        self.tile_origin: list[tuple[int, int]] = []
        t = 0
        for tr in range(pps.tile_rows):
            for tc in range(pps.tile_columns):
                self.tile_origin.append((col_bd[tc], row_bd[tr]))
                for cy in range(row_bd[tr], row_bd[tr + 1]):
                    for cx in range(col_bd[tc], col_bd[tc + 1]):
                        self.scan.append((cx, cy, t))
                t += 1
        self.next_idx = 0

    def done(self) -> bool:
        return self.next_idx == len(self.scan)

    def decode_slice(self, rbsp: bytes, hdr) -> None:
        """Decode one slice segment's CTBs (tile-scan order from its
        address until end_of_slice_segment_flag; a new CABAC substream
        starts at the slice start and at every tile boundary, located by
        the slice's entry points)."""
        st = self.st
        if hdr.first_slice:
            start = 0
        else:
            addr = hdr.slice_address
            target = (addr % self.n_ctb_x, addr // self.n_ctb_x)
            start = next(i for i, (cx, cy, _) in enumerate(self.scan)
                         if (cx, cy) == target)
        if start != self.next_idx:
            raise ValueError("slice segments out of order or overlapping")
        data = rbsp[hdr.data_bit_offset // 8:]
        offsets = [0]
        for sz in hdr.entry_points:
            offsets.append(offsets[-1] + sz)
        init_type = {2: 0, 1: 1, 0: 2}[hdr.slice_type]
        i, sub = start, 0
        done = False
        while not done:
            st.begin_tile()
            seg = (data[offsets[sub]:offsets[sub + 1]]
                   if sub + 1 < len(offsets) else data[offsets[sub]:])
            bac = CabacDecoder(seg, init_contexts(hdr.slice_qp,
                                                  init_type=init_type))
            dec = CtuDecoder(st, bac)
            t_cur = self.scan[i][2]
            left_col, top_row = self.tile_origin[t_cur]
            while i < len(self.scan) and self.scan[i][2] == t_cur:
                cx, cy, _ = self.scan[i]
                if self.sao_on:
                    decode_sao_ctb(bac, self.sao_grid, cx, cy,
                                   hdr.sao_luma, hdr.sao_chroma,
                                   bit_depth=self.sps.bit_depth,
                                   left_ok=cx > left_col, up_ok=cy > top_row)
                dec.code_ctu(cx * self.ctb, cy * self.ctb)
                i += 1
                if bac.decode_terminate():   # end_of_slice_segment_flag
                    done = True
                    break
            if not done:
                if i == len(self.scan):
                    raise ValueError("picture ended without end_of_slice")
                if not bac.decode_terminate():
                    raise ValueError("expected end_of_subset_one_bit")
                sub += 1
        self.next_idx = i

    def finish(self):
        st, sps, pps, hdr = self.st, self.sps, self.pps, self.hdr0
        if not hdr.deblock_disabled:
            deblock_picture(st, beta_offset=hdr.beta_offset_div2,
                            tc_offset=hdr.tc_offset_div2)
        if self.sao_on:
            apply_sao(st, self.sao_grid, hdr.sao_luma, hdr.sao_chroma)

        # conformance window crop (offsets in SubWidthC/SubHeightC units)
        left, right, top, bottom = sps.conf_win
        swc = 2 if sps.chroma_format_idc in (1, 2) else 1
        shc = 2 if sps.chroma_format_idc == 1 else 1
        w = sps.width - swc * (left + right)
        h = sps.height - shc * (top + bottom)
        dt = np.uint8 if sps.bit_depth == 8 else np.uint16
        lx, ly = swc * left, shc * top
        frame = Frame(
            y=st.planes[0][ly:ly + h, lx:lx + w].astype(dt),
            cb=st.planes[1][top:top + (h // shc),
                            left:left + (w // swc)].astype(dt),
            cr=st.planes[2][top:top + (h // shc),
                            left:left + (w // swc)].astype(dt),
        )
        return frame, [p.copy() for p in st.planes], hdr.poc

    def motion(self) -> dict:
        """This picture's motion field for later TMVP (8.5.3.2.8
        collocated data): 4x4-granularity MV/ref maps + its reference
        POCs."""
        st = self.st
        return {"mv": st.mv[::4, ::4].copy(),    # 16x16 compression
                "ref_idx": st.ref_idx[::4, ::4].copy(),
                "ref_pocs": [list(st.ref_pocs[0]), list(st.ref_pocs[1])],
                "poc": self.hdr0.poc}
