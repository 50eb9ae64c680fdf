"""Bit-accounting profiler: decode a stream with the port's decoder and
tally CABAC bits consumed per syntax category, per slice type.

The CabacDecoder's `_bitpos` is the exact count of stream bits consumed,
so wrapping each syntax hook with a before/after delta gives an exact
(to the bit) attribution of where the stream's bytes go: where a BD-rate
gap's bits are spent. Works on any stream the port's decoder accepts
(ours always; the reference's M7 low-delay streams in practice, since
they use the same tool subset).

Usage:
  python3 tools/torch_bits_profile.py stream.265 [other.265 ...]

The twin of tools/bits_profile.py on the port's core/ctu.py, core/sao.py
(decode_sao_ctb, as the decoder calls it) and decoder/decoder.py; it
imports nothing of the JAX package. install() patches those modules for
the life of the process: run it in a process of its own.
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CATS = {
    "sx_split_cu": "split",
    "sx_skip_flag": "skip_flag",
    "sx_pred_mode": "mode_flags",
    "sx_part_mode_inter": "mode_flags",
    "sx_part_mode": "mode_flags",
    "sx_merge_flag": "merge",
    "sx_merge_idx": "merge",
    "sx_inter_pred_idc": "mv",
    "sx_mvd": "mv",
    "sx_mvp_flag": "mv",
    "sx_prev_intra_flags": "intra_mode",
    "sx_luma_mode": "intra_mode",
    "sx_chroma_mode": "intra_mode",
    "sx_split_transform": "cbf_rqt",
    "sx_cbf_chroma": "cbf_rqt",
    "sx_cbf_luma": "cbf_rqt",
    "sx_rqt_root_cbf": "cbf_rqt",
    "sx_cu_qp_delta": "qp_delta",
}


class Tally:
    def __init__(self):
        self.bits = defaultdict(lambda: defaultdict(float))   # slice->cat
        self.counts = defaultdict(lambda: defaultdict(int))
        self.slice_type = "?"
        self.cu_sizes = defaultdict(lambda: defaultdict(int))


TALLY = Tally()


def _wrap_method(cls, name, cat):
    orig = getattr(cls, name)

    def wrapped(self, *a, **kw):
        t = TALLY
        p0 = self.bac._bitpos
        r = orig(self, *a, **kw)
        t.bits[t.slice_type][cat] += self.bac._bitpos - p0
        t.counts[t.slice_type][name] += 1
        return r
    setattr(cls, name, wrapped)
    return orig


def install():
    from svt_hevc_tpu_torch.core import ctu as ctu_mod
    from svt_hevc_tpu_torch.decoder import decoder as dec_mod

    for name, cat in CATS.items():
        _wrap_method(ctu_mod.CtuDecoder, name, cat)

    # residual: category by plane
    orig_res = ctu_mod.decode_residual

    def res_wrap(dec, log2, c_idx, scan):
        t = TALLY
        p0 = dec._bitpos
        r = orig_res(dec, log2, c_idx, scan)
        cat = "resid_luma" if c_idx == 0 else "resid_chroma"
        t.bits[t.slice_type][cat] += dec._bitpos - p0
        t.counts[t.slice_type][f"tu{1 << log2}_{'y' if c_idx == 0 else 'c'}"] += 1
        return r
    ctu_mod.decode_residual = res_wrap

    # sao
    orig_sao = dec_mod.decode_sao_ctb

    def sao_wrap(bac, grid, cx, cy, *a, **kw):
        t = TALLY
        p0 = bac._bitpos
        r = orig_sao(bac, grid, cx, cy, *a, **kw)
        t.bits[t.slice_type]["sao"] += bac._bitpos - p0
        return r
    dec_mod.decode_sao_ctb = sao_wrap

    # record slice type + totals per slice
    orig_ds = dec_mod._PictureCtx.decode_slice

    def ds_wrap(self, rbsp, hdr):
        TALLY.slice_type = {0: "B", 1: "P", 2: "I"}.get(hdr.slice_type, "?")
        TALLY.bits[TALLY.slice_type]["total_payload"] += 8 * len(rbsp)
        return orig_ds(self, rbsp, hdr)
    dec_mod._PictureCtx.decode_slice = ds_wrap

    # CU bookkeeping: coding_unit entry tags size + final mode
    orig_cu = ctu_mod.CtuDecoder.coding_unit

    def cu_wrap(self, x0, y0, log2, depth):
        r = orig_cu(self, x0, y0, log2, depth)
        t = TALLY
        t.cu_sizes[t.slice_type][1 << log2] += 1
        return r
    ctu_mod.CtuDecoder.coding_unit = cu_wrap


def profile(path: str):
    global TALLY
    TALLY = Tally()
    from svt_hevc_tpu_torch.decoder.decoder import decode_stream
    with open(path, "rb") as f:
        data = f.read()
    pics = decode_stream(data)
    print(f"\n=== {path}: {len(data)} bytes, {len(pics)} pictures ===")
    for st in sorted(TALLY.bits):
        b = TALLY.bits[st]
        tot = sum(v for k, v in b.items() if k != "total_payload")
        print(f"-- slice type {st}: tallied {tot / 8:.0f} B "
              f"(payload {b.get('total_payload', 0) / 8:.0f} B)")
        for cat, v in sorted(b.items(), key=lambda kv: -kv[1]):
            if cat == "total_payload":
                continue
            print(f"   {cat:>14}: {v / 8:9.0f} B  {100 * v / max(tot, 1):5.1f}%")
        cs = TALLY.cu_sizes[st]
        ncu = sum(cs.values())
        if ncu:
            sizes = " ".join(f"{k}:{100 * v / ncu:.0f}%"
                             for k, v in sorted(cs.items()))
            print(f"   CUs {ncu}  sizes {sizes}")
        cn = TALLY.counts[st]
        nskip = cn.get("sx_skip_flag", 0)
        nmrg = cn.get("sx_merge_flag", 0)
        nmvd = cn.get("sx_mvd", 0)
        print(f"   skip_flags {nskip}  merge_flags {nmrg}  mvd {nmvd}")


if __name__ == "__main__":
    install()
    for p in sys.argv[1:]:
        profile(p)
