"""The port's encoder end to end against the JAX package.

The whole Annex-B stream of svt_hevc_tpu_torch.Encoder(device="cpu")
must be byte-identical to svt_hevc_tpu.pipeline.encoder.Encoder (exact
equality: the JAX package's output does not depend on the backend, and
the port is held to the same bytes). Also: the port's decoder copy
decodes that stream to the port's recon, the port's constant tables equal
the JAX package's, importing the port loads neither JAX nor the JAX
package, Encoder without a device raises where there is no GPU, and
mesh picture parallelism (the one configuration the port refuses) raises
NotImplementedError.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from svt_hevc_tpu.config import EncoderConfig as JCfg
from svt_hevc_tpu.io.yuv import Frame as JFrame
from svt_hevc_tpu.pipeline.encoder import Encoder as JEncoder
from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.io.yuv import Frame


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread per test process: the suite runs in several
    pytest-xdist workers at once, and torch's default of one thread per
    core in each of them oversubscribes the cores several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_frames(n, w, h, seed=7):
    """Textured luma and chroma with a global pan and a moving square
    (the benchmark's content generator), as (y, cb, cr) uint8 tuples."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 128, w + 128)).astype(np.float32)
    cbig = rng.integers(0, 256, (h // 2 + 64, w // 2 + 64)).astype(
        np.float32)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, -1, 0) + np.roll(big, -1, 1)) / 5.0
        cbig = (cbig + np.roll(cbig, 1, 0) + np.roll(cbig, 1, 1)
                + np.roll(cbig, -1, 0) + np.roll(cbig, -1, 1)) / 5.0
    big = big * 0.7 + 64
    cbig = cbig * 0.25 + 96
    out = []
    for i in range(n):
        ox, oy = (2 * i) % 64, i % 64
        y = big[oy:oy + h, ox:ox + w].astype(np.uint8)
        sx, sy = (10 + 7 * i) % max(w - 40, 1), (8 + 5 * i) % max(h - 40, 1)
        y[sy:sy + 24, sx:sx + 24] = 200
        cb = cbig[oy // 2:oy // 2 + h // 2,
                  ox // 2:ox // 2 + w // 2].astype(np.uint8)
        cr = (255 - cbig[oy // 2:oy // 2 + h // 2,
                         ox // 2:ox // 2 + w // 2]).astype(np.uint8)
        cb[sy // 2:sy // 2 + 12, sx // 2:sx // 2 + 12] = 80
        out.append((y, cb, cr))
    return out


@pytest.fixture(scope="module", params=[
    # 120 is a multiple of neither 32 nor 64 (like 1080); frame 3 reaches
    # TMVP
    dict(w=256, h=120, n=4, kw={}),
    # hierarchical low-delay P: non-referenced top-layer pictures, layer
    # QP offsets, RPS entries kept for later pictures
    dict(w=128, h=64, n=5, kw=dict(hierarchical_levels=2)),
    # M10: no sub-pel refinement below 32x32, no closed-loop intra mode
    # refinement
    dict(w=128, h=64, n=3, kw=dict(enc_mode=10)),
], ids=["ippp_256x120", "hier2_128x64", "m10_128x64"])
def streams(request):
    """qp 32, intra_period=-1 streams of both encoders (M7 unless the
    case says otherwise)."""
    p = request.param
    planes = make_frames(p["n"], p["w"], p["h"], seed=3)
    kw = dict(dict(width=p["w"], height=p["h"], qp=32, enc_mode=7,
                   intra_period=-1), **p["kw"])
    s_j, rec_j = JEncoder(JCfg(**kw)).encode(
        [JFrame(y=y, cb=cb, cr=cr) for y, cb, cr in planes])
    s_t, rec_t = Encoder(EncoderConfig(**kw), device="cpu").encode(
        [Frame(y=y, cb=cb, cr=cr) for y, cb, cr in planes])
    return s_j, rec_j, s_t, rec_t


def test_stream_byte_identical_to_jax(streams):
    s_j, rec_j, s_t, rec_t = streams
    assert s_t == s_j
    for a, b in zip(rec_j, rec_t):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p))


def test_scene_cut_restarts_with_an_idr():
    """A scene cut mid-stream (scene-change detection is on by default)
    makes the next picture an IDR: the device DPB and TMVP caches restart,
    and the stream stays byte-identical."""
    planes = make_frames(4, 128, 64, seed=3)
    planes[2:] = [(255 - y, cr, cb) for y, cb, cr in planes[2:]]
    kw = dict(width=128, height=64, qp=32, enc_mode=7, intra_period=-1)
    enc_j = JEncoder(JCfg(**kw))
    aus_j = list(enc_j.encode_pictures(
        [JFrame(y=y, cb=cb, cr=cr) for y, cb, cr in planes]))
    enc_t = Encoder(EncoderConfig(**kw), device="cpu")
    aus_t = list(enc_t.encode_pictures(
        [Frame(y=y, cb=cb, cr=cr) for y, cb, cr in planes]))
    assert [a.is_idr for a in aus_t] == [True, False, True, False]
    assert [a.data for a in aus_t] == [a.data for a in aus_j]


def test_stage_hook_sees_every_stage_and_changes_no_byte():
    """gpu.encode.STAGE_TIMER (what tools/torch_stage_times.py times with)
    is called once per stage of every picture, in pipeline order, and the
    stream is the one encoded without it: low-delay P and random
    access."""
    import contextlib

    import svt_hevc_tpu_torch.gpu.encode as genc

    class Names:
        def __init__(self):
            self.names = []

        @contextlib.contextmanager
        def stage(self, name):
            self.names.append(name)
            yield

    planes = make_frames(3, 128, 64, seed=3)
    frames = [Frame(y=y, cb=cb, cr=cr) for y, cb, cr in planes]
    cfg = EncoderConfig(width=128, height=64, qp=32, enc_mode=7,
                        intra_period=-1)
    plain, _ = Encoder(cfg, device="cpu").encode(frames)
    rec = Names()
    genc.STAGE_TIMER = rec
    try:
        timed, _ = Encoder(cfg, device="cpu").encode(frames)
    finally:
        genc.STAGE_TIMER = None
    assert timed == plain
    i_stages = ["i.upload", "i.intra_search_size_pred8",
                "i.intra_search_size_pred16", "i.intra_search_size_pred32",
                "i.decide_tree_i_dev", "i.intra_wavefront_pass",
                "i._finish_fused"]
    p_stages = ["p.upload", "p.hme_search", "p.dense_md_p",
                "p.decide_tree_dev"] + ["p.merge_snap"] * genc.SNAP_PASSES + [
                "p.encode_pass_p_direct", "p._finish_fused"]
    # one-frame-deep pipelining: picture k+1 is dispatched before picture
    # k is downloaded and emitted
    assert rec.names == (i_stages + p_stages + ["i.download", "i.host_emit"]
                         + p_stages + ["p.download", "p.host_emit"] * 2)

    # random access (I0, P2, B1): no pipelining, and the B picture runs
    # hme_search and dense_md_p once per list
    cfg = EncoderConfig(width=128, height=64, qp=32, enc_mode=7,
                        intra_period=-1, pred_structure=2,
                        hierarchical_levels=2)
    plain, _ = Encoder(cfg, device="cpu").encode(frames)
    rec = Names()
    genc.STAGE_TIMER = rec
    try:
        timed, _ = Encoder(cfg, device="cpu").encode(frames)
    finally:
        genc.STAGE_TIMER = None
    assert timed == plain
    b_stages = (["b.upload"] + ["b.hme_search"] * 2 + ["b.dense_md_p"] * 2
                + ["b.decide_tree_b_dev"]
                + ["b.merge_snap_b"] * genc.SNAP_PASSES
                + ["b.encode_pass_b_direct", "b._finish_fused",
                   "b.download", "b.host_emit"])
    assert rec.names == (i_stages + ["i.download", "i.host_emit"]
                         + p_stages + ["p.download", "p.host_emit"]
                         + b_stages)


def test_port_decoder_decodes_port_stream_to_recon(streams):
    from svt_hevc_tpu_torch.decoder.decoder import decode_stream
    _, _, s_t, rec_t = streams
    dec = decode_stream(s_t)
    assert len(dec) == len(rec_t)
    for d, r in zip(dec, rec_t):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, p), getattr(r, p))


def _table_pairs():
    import svt_hevc_tpu.core.deblock as jdb
    import svt_hevc_tpu.core.inter as jin
    import svt_hevc_tpu.core.quant as jq
    import svt_hevc_tpu.core.transforms as jtr
    import svt_hevc_tpu.tpu.encode as jenc
    import svt_hevc_tpu.tpu.intra_pass as jip
    import svt_hevc_tpu.tpu.intra_weights as jiw
    import svt_hevc_tpu_torch.core.deblock as tdb
    import svt_hevc_tpu_torch.core.inter as tin
    import svt_hevc_tpu_torch.core.quant as tq
    import svt_hevc_tpu_torch.core.transforms as ttr
    import svt_hevc_tpu_torch.gpu.encode as tenc
    import svt_hevc_tpu_torch.gpu.intra_pass as tip
    import svt_hevc_tpu_torch.gpu.intra_weights as tiw
    pairs = []
    for n in (4, 8, 16, 32):
        pairs.append((f"mode_weight_matrix({n})", jiw.mode_weight_matrix(n),
                      tiw.mode_weight_matrix(n)))
        pairs.append((f"DCT[{n}]", jtr.DCT[n], ttr.DCT[n]))
    for n in (4, 8, 16, 32):
        for a, b in zip(jip._mode_tables(n), tip._mode_tables(n)):
            pairs.append((f"intra mode tables({n})", a, b))
    for p in range(4):
        pairs.append((f"LUMA_FILTERS[{p}]", jin.LUMA_FILTERS[p],
                      tin.LUMA_FILTERS[p]))
    for p in range(8):
        pairs.append((f"CHROMA_FILTERS[{p}]", jin.CHROMA_FILTERS[p],
                      tin.CHROMA_FILTERS[p]))
    pairs += [("QUANT_SCALES", jq.QUANT_SCALES, tq.QUANT_SCALES),
              ("INV_QUANT_SCALES", jq.INV_QUANT_SCALES, tq.INV_QUANT_SCALES),
              ("BETA_TABLE", jdb.BETA_TABLE, tdb.BETA_TABLE),
              ("TC_TABLE", jdb.TC_TABLE, tdb.TC_TABLE),
              ("LAMBDA_SAD", jenc.LAMBDA_SAD, tenc.LAMBDA_SAD)]
    for name in ("PAD", "P_MIN_INTRA_LOG2", "INTER_ZERO_LAMBDA_SCALE",
                 "P_LAMBDA_SCALE", "MERGE_BIAS_BITS", "AMVP_BASE_BITS",
                 "TMVP_BITS", "ME_LAMBDA_SCALE", "SNAP_BIAS_BITS",
                 "SNAP_PASSES", "COMPACT_CAP_FRAC"):
        pairs.append((name, getattr(jenc, name), getattr(tenc, name)))
    return pairs


def test_tables_equal_jax():
    """Every constant table and decision constant equals the JAX
    package's, array for array (exact)."""
    for name, a, b in _table_pairs():
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_sse_lambda_tables_equal_jax():
    """The tabulated float32 SSE lambdas are the values the JAX graphs
    compute (0.57 * exp2((qp - 12) / 3) and its P-slice weighting)."""
    import jax
    import jax.numpy as jnp

    import svt_hevc_tpu_torch.gpu.encode as tenc

    @jax.jit
    def lams(qp):
        base = jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3.0)
        return jnp.float32(0.57) * base, 1.5 * jnp.float32(0.57) * base

    lam_i, lam_p = lams(jnp.arange(52, dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(lam_i), tenc._LAM_SSE_I)
    np.testing.assert_array_equal(np.asarray(lam_p), tenc._LAM_SSE_P)


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, svt_hevc_tpu_torch, svt_hevc_tpu_torch.gpu.encode,"
            " svt_hevc_tpu_torch.gpu.intra_pass,"
            " svt_hevc_tpu_torch.decoder.decoder;"
            "bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m == 'svt_hevc_tpu'"
            " or m.startswith('svt_hevc_tpu.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_reads_no_environment_variables():
    """No SVT_* switch (nor any other variable) changes what the port
    does: its sources read no environment."""
    import pathlib

    import svt_hevc_tpu_torch
    root = pathlib.Path(svt_hevc_tpu_torch.__file__).parent
    srcs = sorted(root.rglob("*.py"))
    assert srcs
    for p in srcs:
        text = p.read_text()
        for word in ("os.environ", "getenv", "SVT_"):
            assert word not in text, f"{p.relative_to(root)} reads {word}"


def test_encoder_without_device_needs_a_gpu():
    """No silent CPU fallback: with no CUDA device, Encoder(cfg) raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Encoder(EncoderConfig(width=128, height=64, intra_period=-1))


@pytest.mark.parametrize("kw", [
    dict(constrained_intra=True),
    dict(pred_structure=2, enc_mode=5),
    dict(tile_columns=2),
    dict(enc_mode=4),
    dict(enc_mode=0),
    dict(tile_rows=2),
    dict(chroma_format=2),
    dict(chroma_format=3, rate_control_mode=1, target_bitrate=1000000),
    dict(enable_denoise=True),
    dict(improve_sharpness=True),
])
def test_out_of_slice_config_raises(kw):
    """Mesh picture parallelism (several devices) is the one
    configuration the port refuses, whatever it is combined with."""
    cfg = EncoderConfig(width=256, height=128, intra_period=-1,
                        mesh_pictures=True, **kw)
    with pytest.raises(NotImplementedError):
        Encoder(cfg, device="cpu")
