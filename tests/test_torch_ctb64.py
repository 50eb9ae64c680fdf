"""The port's fused paths at CTB 64 against the JAX package, on the CPU.

CTB 64 is the configuration of every BD_r05_*.json artifact
(tools/compare_reference.py's run_ours: ctb_size=64, no scene-cut
detection, intra_period=31). At CTB 64 a 4:2:0 single-tile picture still
takes the fused P / B / I paths, now with the 64x64 level in the
quadtree decisions and the merge snaps, 64 z-slots per CTB in the intra
wavefront, DLF and SAO per 64x64 CTB and the emitter's 64x64 CTB walk.
Every stream must be byte-identical to the JAX package's, every
reconstruction equal, and the port's decoder must give the
reconstruction back; one case (pictures 19-23 of the artifacts' clip at
qp 28) decides a near-tie as the JAX graph's fused multiply-add does:
its stream is also held to its recorded digest, and where this process's
XLA compile does not contract multiply-adds (XLA capped at SSE4_2,
tests/test_torch_float32_sites.py) the JAX stream decides the tie the
other way and is held to differ.
The tools' run_ours twin (device="cpu") must give the JAX tool's
stream. One frame size (192x128, three 64x64 CTBs by two)
for every case, so the JAX graphs compile once per picture kind.
"""

import hashlib
import importlib.util
import os

import numpy as np
import pytest

from svt_hevc_tpu.config import EncoderConfig as JCfg
from svt_hevc_tpu.io.yuv import Frame as JFrame
from svt_hevc_tpu.pipeline.encoder import Encoder as JEncoder
from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.gpu import intra_pass
from svt_hevc_tpu_torch.io.yuv import Frame
from tests.test_torch_encoder import make_frames
from tests.test_torch_encoder import one_torch_thread  # noqa: F401
from tests.test_torch_float32_sites import xla_contracts_multiply_add
from tests.test_torch_hostpath import assert_same
from tests.test_torch_intra_inter import intra_frames

W, H = 192, 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name):
    """A module of tools/ by file (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scene_wrap(n, w, h):
    """Pictures 19.. of the BD artifacts' clip (make_clip_scene): its pan
    wraps at picture 22, which leaves a P picture of near-equal costs."""
    tt = load_tool("torch_compare_reference")
    return [(y.astype(np.uint8), cb, cr)
            for y, cb, cr in tt.make_clip_scene(w, h, 19 + n, None)[19:]]


CASES = {
    # (config beyond CTB 64 / qp 32 / intra_period=-1, frames, content)
    "ippp_x4": (dict(), 4, make_frames),
    "ra_hl2_x5": (dict(pred_structure=2, hierarchical_levels=2), 5,
                  make_frames),
    # the artifacts' refresh: IDR period 31, scene-cut detection off
    "ip31_noscd_x4": (dict(intra_period=31, scene_change_detection=False),
                      4, make_frames),
    # a near-tie of the RD leaf costs: decided as the JAX graph decides
    # only with its fused multiply-add (gpu.encode._fma)
    "scene_wrap_qp28_x5": (dict(qp=28, intra_period=31,
                                scene_change_detection=False), 5,
                           scene_wrap),
    # intra CUs in P pictures: the fixup's wavefront at 64 slots per CTB
    "m8_x3": (dict(enc_mode=8), 3, intra_frames),
}


# scene_wrap_qp28_x5's stream: the port's, and the JAX package's under a
# compile that contracts multiply-adds (an AVX-512 or AVX2 compile)
FMA_TIE_STREAM = (2946, "2adaa0de883644172d9cf610e468e630"
                        "6ee1bd36708b9433dfd417aba6aee8eb")


@pytest.mark.parametrize("case", list(CASES))
def test_ctb64_fused_stream_matches_jax(case):
    kw, n, content = CASES[case]
    kw = dict(dict(width=W, height=H, qp=32, intra_period=-1, ctb_size=64),
              **kw)
    pl = content(n, W, H)
    js, jr = JEncoder(JCfg(**kw)).encode([JFrame(*p) for p in pl])
    enc = Encoder(EncoderConfig(**kw), device="cpu")
    before = dict(intra_pass.WAVEFRONT)
    ts, tr = enc.encode([Frame(*p) for p in pl])
    runs = intra_pass.WAVEFRONT["runs"] - before["runs"]
    steps = intra_pass.WAVEFRONT["steps"] - before["steps"]
    if case == "scene_wrap_qp28_x5":
        assert (len(ts), hashlib.sha256(ts).hexdigest()) == FMA_TIE_STREAM
        if not xla_contracts_multiply_add():
            # a host-dependent reference: rounded twice, the tie goes
            # the other way (ROADMAP section 3); the recorded stream
            # stands in for the JAX package's below
            assert js != ts
            js, jr = ts, tr
    assert_same(js, jr, ts, tr)
    # the fused IDR's wavefront: 64 z-slots per CTB along 2 * (2 - 1) + 3
    # CTB diagonals; M8's P pictures run it again for their intra CUs
    if case == "m8_x3":
        assert runs >= 2 and steps > 5 * 64
    else:
        assert (runs, steps) == (1, 5 * 64)


def test_run_ours_twin_matches_jax_tool(tmp_path):
    """tools/torch_compare_reference.run_ours(device="cpu") == the JAX
    tool's run_ours on its own clip (make_clip_scene, 192x128 x4, qp 32,
    M7, intra period 31)."""
    jt = load_tool("compare_reference")
    tt = load_tool("torch_compare_reference")
    clip = str(tmp_path / "scene.yuv")
    frames = tt.make_clip_scene(W, H, 4, clip)
    js, _ = jt.run_ours(clip, W, H, 4, 32, 7, 31)
    ts, _ = tt.run_ours(clip, W, H, 4, 32, 7, 31, device="cpu")
    assert ts == js
    assert tt.psnr_stream(ts, frames) == pytest.approx(
        jt.psnr_stream(js, frames), abs=0)
