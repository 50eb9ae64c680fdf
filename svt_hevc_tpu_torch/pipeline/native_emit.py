"""Native full-frame syntax emission: glue between the fast-path maps and
native/emitter.c frame_emit.

One C call per tile replaces the per-CU Python walk (FastCtuEncoder +
CabacRecorder + native CABAC): the C emitter derives merge/AMVP/MPM
legality from the final decision maps, emits every bin, and runs the
arithmetic coder inline. Byte-equality with the Python walk is enforced
by tests/test_native_emitter.py. Reference analogue: the EntropyCoding
process's table-driven LCU emitter (EbEntropyCoding.c EncodeLcu :7343).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..bitstream.contexts import Ctx, init_contexts
from ..native import (EmitBufs, EmitCfg, _residual_bases, frame_emit_lib,
                      i32p, u8p)

# context-base order must match enum CB_* in native/emitter.c
_CB_ORDER = ("SPLIT_CU", "CU_SKIP", "PART_MODE", "PRED_MODE",
             "PREV_INTRA_LUMA", "INTRA_CHROMA", "MERGE_FLAG", "MERGE_IDX",
             "INTER_DIR", "MVD", "MVP", "RQT_ROOT_CBF", "CBF_LUMA",
             "CBF_CHROMA", "SPLIT_TRANSFORM", "DQP", "SAO_MERGE",
             "SAO_TYPE")

_BASES = None


def _bases() -> np.ndarray:
    global _BASES
    if _BASES is None:
        _BASES = np.asarray([getattr(Ctx, n) for n in _CB_ORDER], np.int32)
    return _BASES


def native_emit_available() -> bool:
    return frame_emit_lib() is not None


def _plane_arg(a: np.ndarray):
    """(ptr, row stride in int32 units) for a 2D int32 array whose rows
    are contiguous (a full plane or a [:h, :w] view of one)."""
    a = np.ascontiguousarray(a) if a.strides[1] != 4 else a
    if a.dtype != np.int32:
        a = np.ascontiguousarray(a, np.int32)
    return a, a.strides[0] // 4


def emit_tile_native(cfg, st, maps, sao_np, qp: int, init_type: int,
                     *, ctb_rect=None, last_ctb=None,
                     end_of_subset: bool = False,
                     qp_map: np.ndarray | None = None) -> bytes | None:
    """Emit one tile's slice substream with the native emitter. Returns
    the substream bytes, or None when the native library is unavailable.
    Updates st.mv / st.ref_idx with the final motion field (TMVP source).

    ctb_rect: (cx0, cy0, cx1, cy1) CTB-unit tile rect, default whole
    picture. last_ctb: (cx, cy) of the slice-final CTB (terminate=1)."""
    lib = frame_emit_lib()
    if lib is None:
        return None

    ctb = cfg.ctb_size
    n_ctb_x = (st.w + ctb - 1) // ctb
    n_ctb_y = (st.h + ctb - 1) // ctb
    if ctb_rect is None:
        ctb_rect = (0, 0, n_ctb_x, n_ctb_y)
    if last_ctb is None:
        last_ctb = (n_ctb_x - 1, n_ctb_y - 1)

    c = EmitCfg()
    c.w, c.h = st.w, st.h
    c.ctb_log2 = st.ctb_log2
    c.slice_type = st.slice_type
    c.max_merge = st.max_merge
    c.cur_poc = st.poc
    refs = [st.ref_pocs[0] if st.ref_pocs else [],
            st.ref_pocs[1] if len(st.ref_pocs) > 1 else []]
    c.n_ref0, c.n_ref1 = len(refs[0]), len(refs[1])
    for i, p in enumerate(refs[0][:8]):
        c.ref_pocs0[i] = int(p)
    for i, p in enumerate(refs[1][:8]):
        c.ref_pocs1[i] = int(p)
    col = getattr(st, "col", None)
    keep = []        # keep temp arrays alive across the C call
    if col is not None:
        c.has_col = 1
        c.col_poc = int(col["poc"])
        c.col_from_l0 = 1 if col.get("from_l0", True) else 0
        c.no_backward = int(all(p <= st.poc
                                for rr in st.ref_pocs for p in rr))
        col_mv = np.ascontiguousarray(col["mv"], np.int32)
        col_ref = np.ascontiguousarray(col["ref_idx"], np.int32)
        c.col_h16, c.col_w16 = col_ref.shape[:2]
        for lst, dst in ((0, c.col_ref_pocs0), (1, c.col_ref_pocs1)):
            for i, p in enumerate(col["ref_pocs"][lst][:8]):
                dst[i] = int(p)
        keep += [col_mv, col_ref]
    else:
        c.has_col = 0
        col_mv = np.zeros(1, np.int32)
        col_ref = np.zeros(1, np.int32)
        keep += [col_mv, col_ref]
    c.max_tt_depth_inter = st.max_tt_depth_inter
    c.sao_enabled = 1 if sao_np is not None else 0
    c.bit_depth = st.bit_depth
    c.cu_qp_delta_enabled = 1 if st.cu_qp_delta_enabled else 0
    c.slice_qp = qp
    c.ctb_x0, c.ctb_y0, c.ctb_x1, c.ctb_y1 = ctb_rect
    c.last_ctb_x, c.last_ctb_y = last_ctb
    c.end_of_subset = 1 if end_of_subset else 0

    cu8 = np.ascontiguousarray(maps.cu_log2_8, np.int32)
    c.nby, c.nbx = cu8.shape
    if getattr(maps, "ref8", None) is not None:
        ref8 = np.ascontiguousarray(maps.ref8, np.int32)
        mv8 = np.ascontiguousarray(maps.mv8_2l, np.int32)
    else:
        ref8 = np.empty((2, c.nby, c.nbx), np.int32)
        ref8[0] = np.where(maps.inter8, 0, -1)
        ref8[1] = -1
        mv8 = np.zeros((2, c.nby, c.nbx, 2), np.int32)
        mv8[0] = maps.mv8
    mode8 = np.ascontiguousarray(maps.intra_mode8, np.int32)
    tu8 = np.ascontiguousarray(maps.tu_log2_8, np.int32)

    lv_y, c.stride_y = _plane_arg(maps.lv_y)
    lv_cb, c.stride_c = _plane_arg(maps.lv_cb)
    lv_cr, stride_cr = _plane_arg(maps.lv_cr)
    assert stride_cr == c.stride_c

    if sao_np is not None:
        sao_t = np.ascontiguousarray(sao_np["type"], np.int32)
        sao_e = np.ascontiguousarray(sao_np["eo"], np.int32)
        sao_b = np.ascontiguousarray(sao_np["bp"], np.int32)
        sao_o = np.ascontiguousarray(sao_np["offs"], np.int32)
        c.sao_nx = sao_t.shape[1]
    else:
        sao_t = sao_e = sao_b = sao_o = np.zeros(1, np.int32)
        c.sao_nx = n_ctb_x
    keep += [sao_t, sao_e, sao_b, sao_o]

    ctx = np.asarray(init_contexts(qp, init_type=init_type), np.uint8)
    h4, w4 = st.h // 4, st.w // 4
    mv_out = np.zeros((h4, w4, 2, 2), np.int32)
    ref_out = np.full((h4, w4, 2), -1, np.int32)
    cap = st.w * st.h * 4 + (1 << 20)
    out = np.empty(cap, np.uint8)

    b = EmitBufs()
    b.cu8 = i32p(cu8)
    b.ref8 = i32p(ref8)
    b.mv8 = i32p(mv8)
    b.mode8 = i32p(mode8)
    b.tu8 = i32p(tu8)
    b.lv_y, b.lv_cb, b.lv_cr = i32p(lv_y), i32p(lv_cb), i32p(lv_cr)
    b.sao_type, b.sao_eo = i32p(sao_t), i32p(sao_e)
    b.sao_bp, b.sao_offs = i32p(sao_b), i32p(sao_o)
    b.col_mv, b.col_ref = i32p(col_mv), i32p(col_ref)
    if qp_map is not None:
        qpm = np.ascontiguousarray(qp_map, np.int32)
        b.qp_map = i32p(qpm)
        c.qpm_nx = qpm.shape[1]
        keep.append(qpm)
    else:
        b.qp_map = ctypes.cast(None, type(b.qp_map))
        c.qpm_nx = n_ctb_x
    b.bases = i32p(_bases())
    b.res_bases = i32p(_residual_bases())
    b.ctx = u8p(ctx)
    b.mv_out, b.ref_out = i32p(mv_out), i32p(ref_out)
    b.out = u8p(out)
    b.out_cap = cap

    n = lib.frame_emit(ctypes.byref(c), ctypes.byref(b))
    if n < 0:
        raise RuntimeError(f"native frame_emit error {n}")
    # final motion field: the TMVP collocated source for future pictures
    st.mv = mv_out
    st.ref_idx = ref_out.astype(np.int8)
    del keep
    return out[:n].tobytes()
