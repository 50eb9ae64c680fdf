"""Checkpoint / restore of the port's streaming state against the JAX
package, on the CPU.

A stream split across two port encoders (the checkpoint pickled in
between, restored into a fresh encoder) equals the port's continuous
encode and the JAX package's continuous encode; a JAX package checkpoint
restored into the port continues the stream exactly as the JAX package's
own restore does (with lookahead VBR, whose windows end at the cut, so a
split differs from the continuous stream on both sides); and the rate
control state in a checkpoint is a deep copy that later encoding leaves
untouched. Tolerance: byte equality of every stream.
"""

import copy
import pickle

import numpy as np
import pytest

from svt_hevc_tpu.config import EncoderConfig as JCfg
from svt_hevc_tpu.io.yuv import Frame as JFrame
from svt_hevc_tpu.pipeline.encoder import Encoder as JEncoder
from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.decoder.decoder import decode_stream
from svt_hevc_tpu_torch.io.yuv import Frame
from tests.test_torch_encoder import one_torch_thread  # noqa: F401
from tests.test_torch_intra_inter import H, W, intra_frames


def _frames(n, cls, seed=11):
    return [cls(y=y, cb=cb, cr=cr)
            for y, cb, cr in intra_frames(n, W, H, seed=seed)]


def _collect(enc, frames):
    return b"".join(au.data for au in enc.encode_pictures(iter(frames)))


CASES = {
    # M8 IPPP under CQP: reference planes, TMVP motion (host and device)
    "m8_ippp_cqp": (dict(enc_mode=8, qp=32), 8, 4),
    # hierarchical low-delay P under reactive VBR, cut mid mini-GOP:
    # per-layer references and the rate-control state
    "hier2_vbr": (dict(enc_mode=7, qp=34, hierarchical_levels=2,
                       rate_control_mode=1, target_bitrate=150_000,
                       look_ahead_distance=0), 9, 6),
}


def _kw(extra):
    return dict(dict(width=W, height=H, intra_period=-1, fps_num=25,
                     scene_change_detection=False), **extra)


@pytest.mark.parametrize("case", list(CASES))
def test_split_equals_continuous_and_jax(case):
    kw, n, cut = CASES[case]
    cfg = EncoderConfig(**_kw(kw))
    frames = _frames(n, Frame)
    cont = _collect(Encoder(cfg, device="cpu"), frames)
    enc1 = Encoder(cfg, device="cpu")
    head = _collect(enc1, frames[:cut])
    blob = pickle.dumps(enc1.checkpoint())
    enc2 = Encoder(cfg, device="cpu")
    enc2.restore(pickle.loads(blob))
    tail = _collect(enc2, frames[cut:])
    assert head + tail == cont
    assert cont == _collect(JEncoder(JCfg(**_kw(kw))), _frames(n, JFrame))
    dec = decode_stream(enc2.headers() + head + tail)
    assert len(dec) == n


def test_jax_checkpoint_restores_into_the_port():
    """The JAX package's checkpoint (its layout: numpy planes, the device
    motion as numpy, the RC state) restored into the port continues the
    stream as the JAX package's own restore does, at M8 with lookahead
    VBR."""
    kw = _kw(dict(enc_mode=8, qp=32, rate_control_mode=1,
                  target_bitrate=200_000, look_ahead_distance=4))
    je = JEncoder(JCfg(**kw))
    _collect(je, _frames(8, JFrame)[:4])
    blob = pickle.dumps(je.checkpoint())
    je2 = JEncoder(JCfg(**kw))
    je2.restore(pickle.loads(blob))
    want = _collect(je2, _frames(8, JFrame)[4:])
    te = Encoder(EncoderConfig(**kw), device="cpu")
    te.restore(pickle.loads(blob))
    assert _collect(te, _frames(8, Frame)[4:]) == want


def test_checkpoint_rc_state_is_a_deep_copy():
    """Encoding on after a checkpoint (the same encoder restored from it,
    then a second encoder from the same unpickled snapshot) changes
    nothing in the snapshot: both continuations are equal."""
    kw = _kw(dict(enc_mode=7, qp=32, rate_control_mode=1,
                  target_bitrate=200_000, look_ahead_distance=0))
    cfg = EncoderConfig(**kw)
    frames = _frames(8, Frame)
    enc = Encoder(cfg, device="cpu")
    _collect(enc, frames[:4])
    ck = enc.checkpoint()
    assert ck["rc"]["_gain"] is not enc.last_rc._gain
    before = copy.deepcopy(ck["rc"])
    enc.restore(ck)
    tail1 = _collect(enc, frames[4:])
    assert enc.last_rc._frames > before["_frames"]
    assert ck["rc"] == before
    enc2 = Encoder(cfg, device="cpu")
    enc2.restore(ck)
    assert _collect(enc2, frames[4:]) == tail1
    for k in ("ref_planes", "prev_y"):
        assert ck[k] is not None
    assert all(isinstance(v[0], np.ndarray)
               for v in ck["dev_motion"].values())
