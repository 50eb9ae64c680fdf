"""The plain reference and the no-JAX guard: what the reference and the
harness import, and the reference's verdict on a small stream that the
port encoded on the CPU."""

import ast
import os
import sys

import numpy as np
import pytest

import harness
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "svt_hevc_tpu"}


def imports(path):
    """(absolute top-level names, relative (level, module)) a file
    imports."""
    tree = ast.parse(open(path).read(), path)
    absolute, relative = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            absolute |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                relative.append((node.level, node.module))
            else:
                absolute.add(node.module.split(".")[0])
    return absolute, relative


def py_files(top):
    for d, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in py_files(BENCH):
        absolute, _ = imports(path)
        assert not absolute & FORBIDDEN, (path, absolute & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for path in py_files(ref):
        absolute, relative = imports(path)
        # the standard library and numpy only
        assert absolute - set(sys.stdlib_module_names) <= {"numpy"}, \
            (path, absolute)
        for level, _ in relative:      # stays inside reference/
            up = os.path.dirname(path)
            for _ in range(level - 1):
                up = os.path.dirname(up)
            assert os.path.commonpath([up, ref]) == ref, path


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert "svt_hevc_tpu_torch" not in harness.forbidden_modules()
    import svt_hevc_tpu_torch  # noqa: F401   the port passes the guard
    assert harness.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla_client", "svt_hevc_tpu.tpu", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in harness.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)


def small_stream(frames=4, bits=8, enc_mode=7):
    from frames import Source, load_mix
    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    from svt_hevc_tpu_torch.io.yuv import Frame
    src = Source(load_mix("reveal" if bits == 10 else "pan"), 320, 256,
                 bits, 2 ** 31 + 3)
    cfg = EncoderConfig(width=320, height=256, qp=32, bit_depth=bits,
                        enc_mode=enc_mode, intra_period=-1)
    enc = Encoder(cfg, device="cpu")
    pics = []
    for au in enc.encode_pictures(Frame(*src.frame(i))
                                  for i in range(frames)):
        r = au.recon
        pics.append({"idx": au.display_idx, "is_idr": au.is_idr,
                     "poc": au.poc, "data": au.data,
                     "planes": (np.asarray(r.y), np.asarray(r.cb),
                                np.asarray(r.cr))})
    motions = enc.checkpoint()["ref_motion"]
    return enc.headers(), pics, motions, harness.expectations(cfg)


@pytest.mark.parametrize("bits,enc_mode", [(8, 7), (10, 8)])
def test_reference_passes_a_port_stream_in_chunks(bits, enc_mode):
    from reference.check import check_stream
    from reference.decoder.decoder import decode_stream
    params, pics, motions, ex = small_stream(5, bits, enc_mode)
    whole = decode_stream(params + b"".join(p["data"] for p in pics))
    assert all(np.array_equal(d.y, p["planes"][0]) for d, p in
               zip(whole, pics))
    v = check_stream(params, pics, motions, ex, workers=3)
    assert v["chunks"] == [(0, 2), (2, 3), (3, 5)]
    assert (v["pictures_checked"], v["pictures_wrong"]) == (5, 0), v


def test_reference_finds_a_changed_sample_and_a_wrong_header():
    from reference.check import check_stream
    params, pics, motions, ex = small_stream(4)
    pics[2]["planes"][1][3, 3] ^= 1
    v = check_stream(params, pics, motions, ex, workers=2)
    assert v["wrong_idx"] == [2], v
    v = check_stream(params, pics, motions, dict(ex, qp=30), workers=2)
    assert v["pictures_wrong"] == 4


def test_chunk_plan_covers_every_picture():
    from reference.check import plan_chunks
    assert plan_chunks(10, 3) == [(0, 3), (3, 7), (7, 10)]
    assert plan_chunks(2, 7) == [(0, 1), (1, 2)]
    big = plan_chunks(1000, 7)
    assert len(big) == 7 and big[0][0] == 0 and big[-1][1] == 1000
    assert all(a == b for (_, a), (b, _) in zip(big, big[1:]))


def test_motion_is_checked_at_every_picture():
    from reference.check import check_stream
    params, pics, motions, ex = small_stream(4)
    idx = pics[1]["idx"]
    bad = {k: dict(v) for k, v in motions.items()}
    poc = pics[1]["poc"]
    bad[poc]["mv"] = bad[poc]["mv"] + 4
    by_idx = {p["idx"]: bad[p["poc"]] for p in pics if p["poc"] in bad}
    v = check_stream(params, pics, by_idx, ex, workers=1)
    assert v["wrong_idx"] == [idx], v


def test_lookahead_windows_are_the_programs():
    from frames import Source, load_mix
    from reference.lookahead import windows
    from svt_hevc_tpu_torch.io.yuv import Frame
    from svt_hevc_tpu_torch.pipeline.encoder import Encoder
    cfg = harness.encoder_config(harness.load_config("vbr10_1080p_m8"),
                                 (320, 256))
    src = Source(load_mix("reveal"), 320, 256, 10, 2 ** 31 + 5)
    frames = [Frame(*src.frame(i)) for i in range(60)]
    got = [w for _, w in Encoder(cfg, device="cpu")._la_frames(
        iter(frames), cfg.lookahead)]
    want = windows([f.y for f in frames], cfg.lookahead)
    assert len(want) == 38          # the windows the source fills whole
    for g, w in zip(got, want):
        assert len(g) == len(w)
        # float32 sums in XLA's order against exact ones: rounding only
        assert np.allclose(g, w, rtol=1e-6, atol=0)


def test_rate_control_qps_are_worked_out_again():
    from frames import Source, load_mix
    from reference.check import rate_control_faults
    from svt_hevc_tpu_torch import Encoder
    from svt_hevc_tpu_torch.io.yuv import Frame
    cfg = harness.encoder_config(harness.load_config("vbr10_1080p_m8"),
                                 (320, 256))
    src = Source(load_mix("reveal"), 320, 256, 10, 2 ** 31 + 9)
    enc = Encoder(cfg, device="cpu")
    pulled = []

    def feed():
        while True:
            pulled.append(len(pulled))
            yield Frame(*src.frame(pulled[-1]))

    gen = enc.encode_pictures(feed())
    pics = [{"idx": au.display_idx, "is_idr": au.is_idr, "data": au.data}
            for au, _ in zip(gen, range(6))]
    gen.close()
    ex = harness.expectations(cfg)
    lumas = [src.frame(i)[0] for i in range(len(pulled))]
    assert rate_control_faults(enc.headers(), pics, ex, lumas) == {}
    ex["rc"] = dict(ex["rc"], target_bitrate=ex["rc"]["target_bitrate"] * 4)
    assert rate_control_faults(enc.headers(), pics, ex, lumas)


_RA: dict = {}


def ra_stream(frames, hl):
    """A random-access stream of a finite list of frames (closed GOP, one
    IDR), 128x64, captured as the harness captures: (parameter sets,
    pictures in decode order, motions by display index, expectations),
    fresh planes on each call."""
    if (frames, hl) not in _RA:
        from frames import Source, load_mix
        from svt_hevc_tpu_torch import Encoder, EncoderConfig
        from svt_hevc_tpu_torch.io.yuv import Frame
        src = Source(load_mix("pan"), 128, 64, 8, 2 ** 31 + 3)
        cfg = EncoderConfig(width=128, height=64, qp=32, enc_mode=7,
                            intra_period=-1, pred_structure=2,
                            hierarchical_levels=hl)
        enc = Encoder(cfg, device="cpu")
        pics, motions = [], {}
        for au in enc.encode_pictures([Frame(*src.frame(i))
                                       for i in range(frames)]):
            r = au.recon
            pics.append({"idx": au.display_idx, "is_idr": au.is_idr,
                         "poc": au.poc, "data": au.data,
                         "planes": (np.asarray(r.y), np.asarray(r.cb),
                                    np.asarray(r.cr))})
            if au.poc in enc._ref_motion:
                motions[au.display_idx] = enc._ref_motion[au.poc]
        _RA[frames, hl] = (enc.headers(), pics, motions,
                           harness.expectations(cfg))
    params, pics, motions, ex = _RA[frames, hl]
    pics = [dict(p, planes=tuple(x.copy() for x in p["planes"]))
            for p in pics]
    return params, pics, motions, ex


def run_tasks(tasks):
    """check_chunk over tasks in this process: the wrong display indices."""
    from reference.check import check_chunk
    return [v["idx"] for t in tasks for v in check_chunk(t)["verdicts"]
            if v["faults"]]


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("frames,hl", [(9, 2), (17, 3)])
def test_reference_passes_a_random_access_stream(frames, hl, workers):
    from reference.check import check_stream
    from reference.decoder.decoder import decode_stream
    params, pics, motions, ex = ra_stream(frames, hl)
    whole = decode_stream(params + b"".join(p["data"] for p in pics))
    by_idx = {p["idx"]: p for p in pics}
    assert all(np.array_equal(d.y, by_idx[i]["planes"][0])
               for i, d in enumerate(whole))
    v = check_stream(params, pics, motions, ex, workers=workers)
    assert (v["pictures_checked"], v["pictures_wrong"]) == (frames, 0), v
    if workers > 1:     # each later chunk starts inside a mini-GOP (a B)
        assert all(pics[a]["idx"] % (1 << hl) for a, _ in v["chunks"][1:])


@pytest.mark.parametrize("frames,hl,idx", [(9, 2, 3), (17, 3, 5)])
def test_a_changed_sample_is_found_in_its_b_picture(frames, hl, idx):
    from reference.check import check_stream
    params, pics, motions, ex = ra_stream(frames, hl)
    pic = next(p for p in pics if p["idx"] == idx)
    pic["planes"][0][7, 9] ^= 1
    v = check_stream(params, pics, motions, ex, workers=3)
    assert v["wrong_idx"] == [idx], v


@pytest.mark.parametrize("idx,want", [(4, (0, 33)), (6, (0, 36)),
                                      (8, (0, 32)), (2, (1, 35))])
def test_a_wrong_expectation_is_found_on_its_picture(idx, want):
    """A B picture's QP expected one off (4: layer 1, 34; 6: layer 2,
    35), an anchor expected as a B, and a B expected as a P."""
    from reference.check import chunk_tasks, plan_chunks
    params, pics, motions, ex = ra_stream(17, 3)
    tasks = chunk_tasks(params, pics, motions, ex, plan_chunks(17, 3))
    assert run_tasks(tasks) == []
    pic = next(p for t in tasks for p in t["pictures"] if p["idx"] == idx)
    assert pic["want"] != want
    pic["want"] = want
    assert run_tasks(tasks) == [idx]


def test_a_chunk_is_seeded_with_its_whole_reference_set():
    """hl 2, chunks of decode order I0 P4 B2 | B1 B3 P8 | B6 B5 B7: the
    second starts with the IDR, P4 and B2 in its buffer (B1 uses I0 and
    B2, B3 uses B2 and P4, P8 uses P4). Planes altered in a seeded
    picture are found on the pictures that use it."""
    from reference.check import chunk_tasks, plan_chunks
    params, pics, motions, ex = ra_stream(9, 2)
    tasks = chunk_tasks(params, pics, motions, ex, plan_chunks(9, 3))
    seed = tasks[1]["seed"]
    assert sorted(r["poc"] for r in seed["refs"]) == [0, 2, 4]
    assert sorted(r["poc"] for r in tasks[2]["seed"]["refs"]) == [4, 8]
    for poc, wrong in ((0, [1]), (4, [3, 8])):
        ref = next(r for r in seed["refs"] if r["poc"] == poc)
        kept = ref["planes"]
        ref["planes"] = (kept[0] ^ 1, kept[1], kept[2])
        assert run_tasks(tasks[1:2]) == wrong, poc
        ref["planes"] = kept
    assert run_tasks(tasks) == []


def test_a_low_delay_chunk_is_seeded_with_the_picture_before_it():
    from reference.check import ChunkDecoder, chunk_tasks, plan_chunks
    params, pics, motions, ex = small_stream(5)
    tasks = chunk_tasks(params, pics, motions, ex, plan_chunks(5, 3))
    max_lsb = 1 << ChunkDecoder(params).sps.log2_max_poc_lsb
    assert tasks[0]["seed"] is None
    for (a, _), t in zip(plan_chunks(5, 3)[1:], tasks[1:]):
        prev = pics[a - 1]
        (ref,) = t["seed"]["refs"]
        assert ref["poc"] == prev["poc"] and ref["planes"] is prev["planes"]
        assert ref["motion"] is motions.get(prev["idx"])
        assert (t["seed"]["prev_lsb"], t["seed"]["prev_msb"]) == (
            prev["poc"] % max_lsb, prev["poc"] - prev["poc"] % max_lsb)


def test_each_picture_is_expected_from_the_configuration():
    from reference.structure import picture_plan
    ld = {"pred_structure": 0, "hierarchical_levels": 0, "intra_period": -1,
          "qp": 32, "qp_range": [0, 51]}
    plan = picture_plan(ld, [0])
    assert [plan(i) for i in range(4)] == [(2, 32)] + [(1, 32)] * 3
    assert picture_plan(dict(ld, qp=None), [0])(5) == (1, None)
    # hierarchical low-delay B, hl 2: layers 0 2 1 2 0 from each IDR, the
    # QP held to qp_range
    hb = dict(ld, pred_structure=1, hierarchical_levels=2, qp_range=[0, 34])
    plan = picture_plan(hb, [0, 6])
    assert [plan(i) for i in range(8)] == [
        (2, 32), (0, 34), (0, 34), (0, 34), (0, 32), (0, 34), (2, 32),
        (0, 34)]
    ra = dict(ld, pred_structure=2, hierarchical_levels=3, intra_period=8)
    plan = picture_plan(ra, [])
    assert [plan(i)[1] for i in range(10)] == [
        32, 36, 35, 36, 34, 36, 35, 36, 32, 32]
    assert [plan(i)[0] for i in (0, 4, 8, 9)] == [2, 0, 1, 2]
