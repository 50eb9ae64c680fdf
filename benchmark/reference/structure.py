"""The slice type and the CQP slice QP that the configuration states for
each picture, worked out again from plain data (harness.expectations):
pred_structure, hierarchical_levels, intra_period, qp (None under a rate
control, which rate_control.py judges) and qp_range. Imports nothing.

What it restates of svt_hevc_tpu_torch/pipeline/encoder.py:

- Low delay (pred_structure 0: P, 1: B; encoder.py:1196-1225): a picture
  at rel = its display index less the last IDR's sits at layer 0 where
  rel % 2**hl is 0, else at hl less the trailing zero bits of that
  remainder; under CQP a layer above 0 adds layer + 1 to the QP (capped
  at 51), and every QP is then held to qp_range.
- Random access (pred_structure 2, closed GOP; encoder.py:1353-1443): the
  stream is cut into segments of intra_period + 1 pictures (one segment
  where intra_period is not positive), each opened by an IDR. In a
  segment of n pictures the anchors, every 2**max(hl, 1)-th picture and
  the segment's last, are P slices at the QP; the pictures between two
  anchors are B slices, the middle one at layer 1 and each half's middle
  one layer deeper, at QP + layer + 1 (capped at 51), not held to
  qp_range.

The public rule behind the offsets: SVT-HEVC's CQP path gives an I picture
the base QP and a P or B picture the base QP plus
MOD_QP_OFFSET_LAYER_ARRAY[hierarchical levels][temporal layer]
(EbRateControlProcess.c:2422-2444, table at EbRateControlProcess.h:46);
the JAX package cites the same table for its layer + 1
(svt_hevc_tpu/pipeline/encoder.py:986, rate_control.py:98). The table's
values are not held in this repository, so whether the port's offsets
(0 at an anchor, layer + 1 above it) equal SVT-HEVC's is not checked
here: this module holds the port to its own schedule. HM's CTC random
access configuration (JCTVC-L1100, GOP 8) offsets its anchor by 1 and
layer L by L + 1.
"""

from __future__ import annotations

B_SLICE, P_SLICE, I_SLICE = 0, 1, 2


def ra_layer(r: int, n: int | None, gop: int) -> int:
    """Display position r > 0 of a random-access segment of n pictures
    (None: endless): 0 for an anchor, else the B picture's layer."""
    a = (r - 1) // gop * gop            # the anchor before r
    b = a + gop if n is None else min(a + gop, n - 1)
    if r == b:
        return 0
    layer = 1
    while True:
        m = (a + b) // 2
        if r == m:
            return layer
        a, b = (a, m) if r < m else (m, b)
        layer += 1


def picture_plan(expect: dict, idrs):
    """plan(display index) -> (slice type, CQP slice QP or None) for an
    endless feed, where every mini-GOP is whole. idrs: the display indices
    that the stream codes as IDRs (low delay, where the scene-cut detector
    may add some)."""
    qp, hl = expect["qp"], expect["hierarchical_levels"]
    lo, hi = expect["qp_range"]
    if expect["pred_structure"] == 2:
        period = expect["intra_period"]
        seg = period + 1 if period > 0 else None
        gop = 1 << max(hl, 1)

        def plan(idx):
            r = idx % seg if seg else idx
            if r == 0:
                return I_SLICE, qp
            layer = ra_layer(r, seg, gop)
            if layer == 0:
                return P_SLICE, qp
            return B_SLICE, None if qp is None else min(qp + layer + 1, 51)
        return plan

    idrs = set(idrs)
    inter = B_SLICE if expect["pred_structure"] == 1 else P_SLICE

    def plan(idx):
        base = max((i for i in idrs if i <= idx), default=0)
        pos = (idx - base) % (1 << hl) if hl else 0
        layer = 0 if pos == 0 else hl - ((pos & -pos).bit_length() - 1)
        stype = I_SLICE if idx in idrs else inter
        if qp is None:
            return stype, None
        q = min(qp + layer + 1, 51) if layer else qp
        return stype, min(max(q, lo), hi)
    return plan
