"""Faults planted in the program, for the control and the tests that show
a run with a broken timed path comes out not correct. Each is a context
manager that patches the program while it is open. Not used by the
benchmark's own runs.

- sao_skip (the control of the decoder's check): SAO left out of the
  reconstruction the encoder keeps as its reference, while the stream
  still signals SAO, as the configuration states: the guarantee that the
  stream decodes to the encoder's reconstruction is broken, the step a
  faster in-loop filter would tempt.
- hme_off (the control of the quality check): the hierarchical motion
  search (kernel K1's three levels) cut to nothing, every block's centre
  the zero vector, so only the dense search's few samples around it are
  searched: a coarser search, whose stream is valid and decodes to the
  encoder's reconstruction, and costs more bytes.
- hme_wrong: kernel K1's search gone wrong: every block's centre 8
  samples off the truth in both axes, where the dense search around it
  cannot reach the content's motion.
- intra_off (the control of the quality check where P pictures may hold
  intra CUs): the P pictures' mode decision made to code every CU inter,
  so the intra fixup's wavefront never runs: skipped candidates, whose
  stream is valid and costs more bytes or quality.
- dlf_unchanged: the deblocking step returns the planes it was given.
- stale_reference: the reference state is never updated: every P
  picture predicts from the stream's first reference.
- token_altered: one bit of each P picture's CABAC data flipped where
  the emitter produces it.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name: str, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def sao_skip():
    from svt_hevc_tpu_torch.gpu import sao
    return _patched(sao, "sao_apply_dev", lambda rec, *a, **k: rec)


def hme_off():
    import torch
    from svt_hevc_tpu_torch.gpu import me

    def zero_search(src, ref, n=16, r=4):
        h, w = src.shape
        return (torch.zeros((h // n, w // n, 2), dtype=torch.int32,
                            device=src.device),
                torch.zeros((h // n, w // n), dtype=torch.float32,
                            device=src.device))
    return _patched(me, "hme_search", zero_search)


def hme_wrong():
    from svt_hevc_tpu_torch.gpu import me
    orig = me.hme_search

    def off_search(src, ref, n=16, r=4):
        mv, sad = orig(src, ref, n, r)
        return mv + 32, sad             # quarter-pel: 8 samples
    return _patched(me, "hme_search", off_search)


def intra_off():
    from svt_hevc_tpu_torch.gpu import encode as genc
    orig = genc.decide_tree_dev

    def all_inter(*args, **kw):
        cu_log2_8, inter8, mv8, mode8 = orig(*args, **kw)
        return cu_log2_8, inter8 | True, mv8, mode8
    return _patched(genc, "decide_tree_dev", all_inter)


def dlf_unchanged():
    from svt_hevc_tpu_torch.gpu import dlf
    return _patched(dlf, "deblock_dev", lambda y, cb, cr, *a, **k: (y, cb, cr))


def stale_reference():
    from svt_hevc_tpu_torch.pipeline.encoder import Encoder
    orig = Encoder._dev_ref
    first = {}

    def dev_ref(self, entry, w64, h64, device):
        if id(self) not in first:
            first[id(self)] = orig(self, entry, w64, h64, device)
        return first[id(self)]
    return _patched(Encoder, "_dev_ref", dev_ref)


def token_altered():
    from svt_hevc_tpu_torch.pipeline.encoder import Encoder
    orig = Encoder._encode_fast

    def encode_fast(self, *args, **kw):
        subs = orig(self, *args, **kw)
        last = bytearray(subs[-1])
        last[len(last) // 2] ^= 0x10
        return list(subs[:-1]) + [bytes(last)]
    return _patched(Encoder, "_encode_fast", encode_fast)


FAULTS = {"sao_skip": sao_skip, "hme_off": hme_off, "hme_wrong": hme_wrong,
          "intra_off": intra_off,
          "dlf_unchanged": dlf_unchanged,
          "stale_reference": stale_reference,
          "token_altered": token_altered}
