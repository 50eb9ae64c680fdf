"""HEVC residual coding syntax (H.265 7.3.8.11 / 9.3) — encoder + decoder.

Coefficient-group (4x4 subblock) CABAC coding: last-significant position,
coded_sub_block_flag, sig_coeff_flag, greater1/greater2 flags, signs, and
Golomb-Rice remaining levels. Encoder and decoder live side by side and share
every derivation so they cannot drift.

Analogue of reference Source/Lib/Codec/EbEntropyCoding.c
(EncodeQuantizedCoefficients_generic :1172; scan selection :1346-1372) —
re-derived from the spec, structured for later batched bin-generation on TPU
(collect (ctx, bin) pairs per TU in parallel, arithmetic-code per tile).
"""

from __future__ import annotations

import numpy as np

from .cabac import CabacDecoder, CabacEncoder
from .contexts import Ctx

SCAN_DIAG = 0
SCAN_HOR = 1
SCAN_VER = 2

# spec 9.3.4.2.5: ctxIdxMap for 4x4 sig_coeff_flag
_CTX_IDX_MAP_4X4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)

# spec 9.3.3.1 Table 9-48 (last position binarization helpers):
# groupIdx = [0,1,2,3,4,4,5,5,6,6,6,6,7,7,7,7,8*8,9*8]
_GROUP_IDX = tuple(
    k if k < 4
    else 2 * (k.bit_length() - 1) + ((k >> (k.bit_length() - 2)) & 1)
    for k in range(32)
)
_MIN_IN_GROUP = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24)


def _diag_scan(n: int) -> list[tuple[int, int]]:
    """Up-right diagonal scan order (spec 6.5.3): scanPos -> (x, y)."""
    out = []
    x = y = 0
    while len(out) < n * n:
        while y >= 0:
            if x < n and y < n:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return out


def _scan_xy(log2: int, scan_idx: int) -> np.ndarray:
    n = 1 << log2
    if scan_idx == SCAN_DIAG:
        pos = _diag_scan(n)
    elif scan_idx == SCAN_HOR:
        pos = [(x, y) for y in range(n) for x in range(n)]
    else:
        pos = [(x, y) for x in range(n) for y in range(n)]
    return np.array(pos, dtype=np.int32)


# scan tables: key (log2_size, scan_idx) -> (nPos, 2) array of (x, y).
# For sizes > 4x4 the scan is hierarchical: subblock grid scanned with the
# same pattern, 4x4 pattern within each subblock (spec 6.5.1).
_SCAN_CACHE: dict[tuple[int, int], np.ndarray] = {}


def scan_order(log2: int, scan_idx: int) -> np.ndarray:
    """Full forward scan: scanPos -> (x, y) over the whole TB."""
    key = (log2, scan_idx)
    got = _SCAN_CACHE.get(key)
    if got is not None:
        return got
    inner = _scan_xy(2, scan_idx)
    if log2 == 2:
        full = inner
    else:
        sb = _scan_xy(log2 - 2, scan_idx)
        full = np.empty(((1 << log2) ** 2, 2), dtype=np.int32)
        for s, (sx, sy) in enumerate(sb):
            full[16 * s:16 * s + 16, 0] = 4 * sx + inner[:, 0]
            full[16 * s:16 * s + 16, 1] = 4 * sy + inner[:, 1]
    _SCAN_CACHE[key] = full
    return full


def select_scan(log2: int, c_idx: int, intra_mode: int | None,
                chroma444: bool = False) -> int:
    """Scan selection (spec 7.4.9.11): mode-dependent for intra 4x4 TBs and
    8x8 luma — and 8x8 chroma when ChromaArrayType is 3 (REXT). Matches
    reference EbEntropyCoding.c:1357-1369."""
    if intra_mode is None:
        return SCAN_DIAG
    if log2 == 2 or (log2 == 3 and (c_idx == 0 or chroma444)):
        if 6 <= intra_mode <= 14:
            return SCAN_VER
        if 22 <= intra_mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG


# ------------------------------------------------------------ ctx derivations

def _last_ctx_params(log2: int, c_idx: int) -> tuple[int, int]:
    """(ctxOffset, ctxShift) for last_sig_coeff prefix bins (9.3.4.2.3)."""
    if c_idx == 0:
        return 3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2
    return 15, log2 - 2


def _sig_ctx(xc: int, yc: int, log2: int, c_idx: int, scan_idx: int,
             prev_csbf: int) -> int:
    """sig_coeff_flag ctxInc (spec 9.3.4.2.5). Returns offset into the
    luma(27)+chroma(15) region of Ctx.SIG."""
    if log2 == 2:
        sig = _CTX_IDX_MAP_4X4[(yc << 2) + xc]
    elif xc + yc == 0:
        sig = 0
    else:
        xs, ys = xc >> 2, yc >> 2
        xp, yp = xc & 3, yc & 3
        if prev_csbf == 0:
            sig = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
        elif prev_csbf == 1:
            sig = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev_csbf == 2:
            sig = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            sig = 2
        if c_idx == 0 and (xs + ys) > 0:
            sig += 3
        if log2 == 3:
            sig += 9 if (scan_idx == SCAN_DIAG or c_idx != 0) else 15
        else:
            sig += 21 if c_idx == 0 else 12
    return sig if c_idx == 0 else 27 + sig


# -------------------------------------------------------------------- encoder

def emit_residual(enc, coeffs: np.ndarray, c_idx: int,
                  scan_idx: int) -> None:
    """encode_residual through the fastest available backend: recorders
    take the native C op generator (svt_hevc_tpu/native/residual.c) when
    built; every other sink uses the Python reference implementation."""
    if hasattr(enc, "append_ops"):
        from ..native import residual_ops_native
        arr = residual_ops_native(coeffs, c_idx, scan_idx)
        if arr is not None:
            enc.append_ops(arr)
            return
    encode_residual(enc, coeffs, c_idx, scan_idx)


def encode_residual(enc: CabacEncoder, coeffs: np.ndarray, c_idx: int,
                    scan_idx: int) -> None:
    """Encode one TB's quantized coefficients (nonzero somewhere; caller
    handles the cbf flags). coeffs: (N, N) int array, [y][x]."""
    n = coeffs.shape[0]
    log2 = n.bit_length() - 1
    scan = scan_order(log2, scan_idx)
    vals = coeffs[scan[:, 1], scan[:, 0]].astype(np.int64)
    nz = np.nonzero(vals)[0]
    last = int(nz[-1])

    # ---- last significant coefficient position (9.3.3.1) ----
    lx, ly = int(scan[last, 0]), int(scan[last, 1])
    if scan_idx == SCAN_VER:
        lx, ly = ly, lx
    _encode_last_xy(enc, lx, ly, log2, c_idx)

    num_sb = (n * n) >> 4
    last_sb = last >> 4
    sb_w = max(n >> 2, 1)
    # csbf by subblock spatial position (xS, yS)
    csbf = np.zeros((sb_w, sb_w), dtype=np.int32)
    sb_nonzero = [bool(np.any(vals[16 * s:16 * s + 16])) for s in range(num_sb)]

    c1 = 1
    for sb in range(last_sb, -1, -1):
        sb_pos = 16 * sb
        # subblock coordinates from the *subblock* scan at this level
        sxc = int(scan[sb_pos, 0]) >> 2
        syc = int(scan[sb_pos, 1]) >> 2
        right = int(csbf[syc, sxc + 1]) if sxc + 1 < sb_w else 0
        below = int(csbf[syc + 1, sxc]) if syc + 1 < sb_w else 0
        prev_csbf = right + 2 * below

        explicit_csbf = sb != 0 and sb != last_sb
        coded_flag = sb_nonzero[sb]
        if explicit_csbf:
            enc.encode_bin(Ctx.SIG_GROUP + min(right + below, 1)
                           + (0 if c_idx == 0 else 2), int(coded_flag))
            csbf[syc, sxc] = int(coded_flag)
            if not coded_flag:
                continue
        else:
            csbf[syc, sxc] = 1  # inferred 1 for subblock 0 and the last one

        # ---- significance map ----
        sig_positions: list[int] = []   # scanPos of nonzero, reverse order
        start = last - 1 if sb == last_sb else sb_pos + 15
        if sb == last_sb:
            sig_positions.append(last)
        for sp in range(start, sb_pos - 1, -1):
            is_sig = vals[sp] != 0
            if sp == sb_pos and explicit_csbf and not sig_positions:
                # inferred DC significance (inferSbDcSigCoeffFlag)
                sig_positions.append(sp)
                continue
            xc, yc = int(scan[sp, 0]), int(scan[sp, 1])
            ctx = Ctx.SIG + _sig_ctx(xc, yc, log2, c_idx, scan_idx, prev_csbf)
            enc.encode_bin(ctx, int(is_sig))
            if is_sig:
                sig_positions.append(sp)

        # ---- level coding (HM codeCoeffNxN structure) ----
        abs_vals = [int(abs(vals[sp])) for sp in sig_positions]
        signs = [int(vals[sp] < 0) for sp in sig_positions]
        num = len(abs_vals)

        ctx_set = 2 if (sb > 0 and c_idx == 0) else 0
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        gt1_base = (Ctx.GT1 + 4 * ctx_set) if c_idx == 0 \
            else (Ctx.GT1 + 16 + 4 * ctx_set)
        num_c1 = min(num, 8)
        first_c2 = -1
        for i in range(num_c1):
            sym = int(abs_vals[i] > 1)
            enc.encode_bin(gt1_base + c1, sym)
            if sym:
                c1 = 0
                if first_c2 == -1:
                    first_c2 = i
            elif 0 < c1 < 3:
                c1 += 1
        if first_c2 != -1:
            gt2_ctx = (Ctx.GT2 + ctx_set) if c_idx == 0 \
                else (Ctx.GT2 + 4 + ctx_set)
            enc.encode_bin(gt2_ctx, int(abs_vals[first_c2] > 2))

        for s in signs:
            enc.encode_bypass(s)

        rice = 0
        first_coeff2 = 1
        for i in range(num):
            # value expressible by the coded flags at this position
            cap = 1 if i >= 8 else (3 if i == first_c2 else 2)
            flag_val = min(abs_vals[i], cap)
            escape = (2 + first_coeff2) if i < 8 else 1
            if flag_val == escape:
                _encode_remaining(enc, abs_vals[i] - escape, rice)
            if abs_vals[i] >= 2:
                first_coeff2 = 0
            if abs_vals[i] > (3 << rice):
                rice = min(rice + 1, 4)


def _encode_last_xy(enc: CabacEncoder, lx: int, ly: int, log2: int,
                    c_idx: int) -> None:
    off, shift = _last_ctx_params(log2, c_idx)
    cmax = (log2 << 1) - 1
    for coord, base in ((lx, Ctx.LAST_X), (ly, Ctx.LAST_Y)):
        prefix = _GROUP_IDX[coord]
        for i in range(min(prefix, cmax)):
            enc.encode_bin(base + off + (i >> shift), 1)
        if prefix < cmax:
            enc.encode_bin(base + off + (prefix >> shift), 0)
    for coord in (lx, ly):
        prefix = _GROUP_IDX[coord]
        if prefix > 3:
            nbits = (prefix >> 1) - 1
            enc.encode_bypass_bins(coord - _MIN_IN_GROUP[prefix], nbits)


def _encode_remaining(enc: CabacEncoder, value: int, rice: int) -> None:
    """coeff_abs_level_remaining binarization (spec 9.3.3.13)."""
    if value < (3 << rice):
        length = value >> rice
        enc.encode_bypass_bins((1 << (length + 1)) - 2, length + 1)
        if rice:
            enc.encode_bypass_bins(value & ((1 << rice) - 1), rice)
    else:
        length = rice
        value -= 3 << rice
        while value >= (1 << length):
            value -= 1 << length
            length += 1
        n_ones = 3 + length + 1 - rice
        enc.encode_bypass_bins((1 << n_ones) - 2, n_ones)
        if length:
            enc.encode_bypass_bins(value, length)


# -------------------------------------------------------------------- decoder

def decode_residual(dec: CabacDecoder, log2: int, c_idx: int,
                    scan_idx: int) -> np.ndarray:
    """Decode one TB's coefficients; returns (N, N) int32 [y][x]."""
    n = 1 << log2
    scan = scan_order(log2, scan_idx)
    vals = np.zeros(n * n, dtype=np.int64)

    lx, ly = _decode_last_xy(dec, log2, c_idx)
    if scan_idx == SCAN_VER:
        lx, ly = ly, lx
    # find scanPos of (lx, ly)
    match = np.nonzero((scan[:, 0] == lx) & (scan[:, 1] == ly))[0]
    last = int(match[0])

    num_sb = (n * n) >> 4
    last_sb = last >> 4
    sb_w = max(n >> 2, 1)
    csbf = np.zeros((sb_w, sb_w), dtype=np.int32)

    c1 = 1
    for sb in range(last_sb, -1, -1):
        sb_pos = 16 * sb
        sxc = int(scan[sb_pos, 0]) >> 2
        syc = int(scan[sb_pos, 1]) >> 2
        right = int(csbf[syc, sxc + 1]) if sxc + 1 < sb_w else 0
        below = int(csbf[syc + 1, sxc]) if syc + 1 < sb_w else 0
        prev_csbf = right + 2 * below

        if sb != last_sb and sb != 0:
            coded_flag = bool(dec.decode_bin(
                Ctx.SIG_GROUP + min(right + below, 1)
                + (0 if c_idx == 0 else 2)))
        else:
            coded_flag = True
        csbf[syc, sxc] = int(coded_flag)
        if not coded_flag:
            continue
        explicit_csbf = sb != 0 and sb != last_sb

        sig_positions: list[int] = []
        start = last - 1 if sb == last_sb else sb_pos + 15
        if sb == last_sb:
            sig_positions.append(last)
        for sp in range(start, sb_pos - 1, -1):
            if sp == sb_pos and explicit_csbf and not sig_positions:
                sig_positions.append(sp)
                continue
            xc, yc = int(scan[sp, 0]), int(scan[sp, 1])
            ctx = Ctx.SIG + _sig_ctx(xc, yc, log2, c_idx, scan_idx, prev_csbf)
            if dec.decode_bin(ctx):
                sig_positions.append(sp)

        num = len(sig_positions)
        abs_vals = [1] * num

        ctx_set = 2 if (sb > 0 and c_idx == 0) else 0
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        gt1_base = (Ctx.GT1 + 4 * ctx_set) if c_idx == 0 \
            else (Ctx.GT1 + 16 + 4 * ctx_set)
        num_c1 = min(num, 8)
        first_c2 = -1
        for i in range(num_c1):
            sym = dec.decode_bin(gt1_base + c1)
            if sym:
                c1 = 0
                if first_c2 == -1:
                    first_c2 = i
                abs_vals[i] = 2
            elif 0 < c1 < 3:
                c1 += 1
        if first_c2 != -1:
            gt2_ctx = (Ctx.GT2 + ctx_set) if c_idx == 0 \
                else (Ctx.GT2 + 4 + ctx_set)
            abs_vals[first_c2] += dec.decode_bin(gt2_ctx)

        signs = [dec.decode_bypass() for _ in range(num)]

        rice = 0
        first_coeff2 = 1
        for i in range(num):
            escape = (2 + first_coeff2) if i < 8 else 1
            if abs_vals[i] == escape:
                abs_vals[i] += _decode_remaining(dec, rice)
            if abs_vals[i] >= 2:
                first_coeff2 = 0
            if abs_vals[i] > (3 << rice):
                rice = min(rice + 1, 4)

        for i, sp in enumerate(sig_positions):
            vals[sp] = -abs_vals[i] if signs[i] else abs_vals[i]

    out = np.zeros((n, n), dtype=np.int32)
    out[scan[:, 1], scan[:, 0]] = vals
    return out


def _decode_last_xy(dec: CabacDecoder, log2: int, c_idx: int) -> tuple[int, int]:
    off, shift = _last_ctx_params(log2, c_idx)
    cmax = (log2 << 1) - 1
    prefixes = []
    for base in (Ctx.LAST_X, Ctx.LAST_Y):
        p = 0
        while p < cmax and dec.decode_bin(base + off + (p >> shift)):
            p += 1
        prefixes.append(p)
    coords = []
    for p in prefixes:
        if p > 3:
            nbits = (p >> 1) - 1
            coords.append(_MIN_IN_GROUP[p] + dec.decode_bypass_bins(nbits))
        else:
            coords.append(p)
    return coords[0], coords[1]


def _decode_remaining(dec: CabacDecoder, rice: int) -> int:
    length = 0
    while dec.decode_bypass():
        length += 1
        if length > 32:
            raise ValueError("invalid coeff_abs_level_remaining")
    if length < 3:
        v = (length << rice)
        if rice:
            v += dec.decode_bypass_bins(rice)
        return v
    # escape to exp-golomb: 'length' total ones = 3 + k
    k = length - 3
    v = 3 << rice
    for j in range(k):
        v += (1 << (rice + j))
    return v + dec.decode_bypass_bins(rice + k)
