"""Native (C) production backends, built on demand with the system
compiler and loaded via ctypes. Python backends in svt_hevc_tpu.bitstream
remain the reference implementations; equivalence is test-enforced
(the analogue of the reference's C_DEFAULT-vs-ASM pairing and asm_test).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


_SOURCES = ("cabac.c", "residual.c", "emitter.c")
_HEADERS = ("cabac_core.h",)


def _build_lib() -> str | None:
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    deps = srcs + [os.path.join(_HERE, h) for h in _HEADERS]
    out = os.path.join(_HERE, "_libsvthevc_native.so")
    if os.path.exists(out) and all(
            os.path.getmtime(out) >= os.path.getmtime(s) for s in deps):
        return out
    # build beside the target and rename into place: concurrent processes
    # (pytest workers) never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run(
                [cc, "-O3", "-fPIC", "-shared", "-o", tmp, *srcs],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
            return out
        except (OSError, subprocess.SubprocessError):
            continue
    return None


def native_cabac_lib():
    """ctypes handle to the native library, or None if unavailable."""
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        path = _build_lib()
        if path is not None:
            lib = ctypes.CDLL(path)
            lib.cabac_encode_ops.restype = ctypes.c_int64
            lib.cabac_encode_ops.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ]
            lib.residual_ops.restype = ctypes.c_int64
            lib.residual_ops.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ]
            _LIB = lib
    return _LIB


def cabac_encode_ops(ops: np.ndarray, contexts: list[int]) -> bytes | None:
    """Run the native arithmetic coder over a recorded op stream.
    Returns the slice payload bytes, or None if the native lib is
    unavailable (callers fall back to the Python backend)."""
    lib = native_cabac_lib()
    if lib is None:
        return None
    ops = np.ascontiguousarray(ops, dtype=np.int32)
    ctx = np.asarray(contexts, dtype=np.uint8)
    cap = max(4096, ops.shape[0] * 2 + 1024)
    out = np.empty(cap, np.uint8)
    n = lib.cabac_encode_ops(
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ops.shape[0],
        ctx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap)
    if n < 0:
        raise RuntimeError(f"native cabac overflow/err {n}")
    return out[:n].tobytes()


_RES_BASES = None


def _residual_bases() -> np.ndarray:
    """Context-base offsets [LAST_X, LAST_Y, SIG_GROUP, SIG, GT1, GT2]
    from the Python context layout (single source of truth)."""
    global _RES_BASES
    if _RES_BASES is None:
        from ..bitstream.contexts import Ctx
        _RES_BASES = np.asarray([Ctx.LAST_X, Ctx.LAST_Y, Ctx.SIG_GROUP,
                                 Ctx.SIG, Ctx.GT1, Ctx.GT2], np.int32)
    return _RES_BASES


def residual_ops_native(coeffs: np.ndarray, c_idx: int,
                        scan_idx: int) -> np.ndarray | None:
    """Bin-op stream (k, 3) int32 for one TB's coefficients via the C
    backend, or None if the native lib is unavailable (callers fall back
    to the Python encoder)."""
    lib = native_cabac_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(coeffs, dtype=np.int32)
    n = c.shape[0]
    cap = 16 * n * n + 256
    out = np.empty((cap, 3), np.int32)
    bases = _residual_bases()
    k = lib.residual_ops(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        c_idx, scan_idx,
        bases.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
    if k < 0:
        raise RuntimeError(f"native residual_ops error {k}")
    return out[:k]


# -------------------------------------------------- full-frame CU emitter

class EmitCfg(ctypes.Structure):
    """Mirrors emit_cfg_t in native/emitter.c."""
    _fields_ = [
        ("w", ctypes.c_int32), ("h", ctypes.c_int32),
        ("ctb_log2", ctypes.c_int32), ("slice_type", ctypes.c_int32),
        ("max_merge", ctypes.c_int32), ("cur_poc", ctypes.c_int32),
        ("n_ref0", ctypes.c_int32), ("n_ref1", ctypes.c_int32),
        ("ref_pocs0", ctypes.c_int32 * 8), ("ref_pocs1", ctypes.c_int32 * 8),
        ("has_col", ctypes.c_int32), ("col_poc", ctypes.c_int32),
        ("col_from_l0", ctypes.c_int32), ("no_backward", ctypes.c_int32),
        ("col_w16", ctypes.c_int32), ("col_h16", ctypes.c_int32),
        ("col_ref_pocs0", ctypes.c_int32 * 8),
        ("col_ref_pocs1", ctypes.c_int32 * 8),
        ("max_tt_depth_inter", ctypes.c_int32),
        ("sao_enabled", ctypes.c_int32), ("bit_depth", ctypes.c_int32),
        ("cu_qp_delta_enabled", ctypes.c_int32),
        ("slice_qp", ctypes.c_int32),
        ("nbx", ctypes.c_int32), ("nby", ctypes.c_int32),
        ("stride_y", ctypes.c_int32), ("stride_c", ctypes.c_int32),
        ("sao_nx", ctypes.c_int32), ("qpm_nx", ctypes.c_int32),
        ("ctb_x0", ctypes.c_int32), ("ctb_y0", ctypes.c_int32),
        ("ctb_x1", ctypes.c_int32), ("ctb_y1", ctypes.c_int32),
        ("last_ctb_x", ctypes.c_int32), ("last_ctb_y", ctypes.c_int32),
        ("end_of_subset", ctypes.c_int32),
    ]


_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class EmitBufs(ctypes.Structure):
    """Mirrors emit_bufs_t in native/emitter.c."""
    _fields_ = [
        ("cu8", _I32P), ("ref8", _I32P), ("mv8", _I32P), ("mode8", _I32P),
        ("tu8", _I32P),
        ("lv_y", _I32P), ("lv_cb", _I32P), ("lv_cr", _I32P),
        ("sao_type", _I32P), ("sao_eo", _I32P), ("sao_bp", _I32P),
        ("sao_offs", _I32P),
        ("col_mv", _I32P), ("col_ref", _I32P),
        ("qp_map", _I32P),
        ("bases", _I32P), ("res_bases", _I32P),
        ("ctx", _U8P),
        ("mv_out", _I32P), ("ref_out", _I32P),
        ("out", _U8P), ("out_cap", ctypes.c_int64),
    ]


_EMIT_READY = False


def frame_emit_lib():
    """Library handle with frame_emit configured, or None."""
    global _EMIT_READY
    lib = native_cabac_lib()
    if lib is None:
        return None
    if not _EMIT_READY:
        lib.frame_emit.restype = ctypes.c_int64
        lib.frame_emit.argtypes = [ctypes.POINTER(EmitCfg),
                                   ctypes.POINTER(EmitBufs)]
        _EMIT_READY = True
    return lib


def i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)
