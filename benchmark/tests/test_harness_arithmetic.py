"""The metric arithmetic: fps over the window, p90 over every sample, the
union idle share, and the roofline work equal to chip_smoke's for the
launch dimensions the port records."""

import math

import numpy as np
import pytest
import torch

import harness
import yardstick


def test_fps_is_all_access_units_over_the_window():
    read = harness.reader("fps")
    assert read({"window_aus": 160, "window_s": 40.25}) == 160 / 40.25


def test_p90_is_nearest_rank_over_all_samples():
    read = harness.reader("latency_p90_ms")
    lat = [i / 1000 for i in range(1, 161)]          # 1..160 ms
    assert read({"latencies_s": lat}) == pytest.approx(144.0)
    assert yardstick.percentile([5, 1, 3], 90) == 5
    assert yardstick.percentile(list(range(10)), 90) == 8
    assert read({"latencies_s": []}) is None


def test_union_counts_overlap_once_and_clips():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 60)]
    assert yardstick.union_ns(iv, 0, 50) == 15 + 10 + 10
    assert yardstick.gaps_ns(iv, 0, 50) == [(15, 20), (30, 40)]
    rec = {"trace": {"window_s": 2.0, "busy_s": 0.5}}
    assert harness.reader("device_idle_pct")(rec) == 75.0


def test_k1_work_is_chip_smokes():
    import chip_smoke
    for h, w, r in ((272, 480, 8), (544, 960, 4), (1088, 1920, 4)):
        src = torch.empty((h, w))
        assert yardstick.k1_work(h, w, 16, r) == chip_smoke.k1_work(src, r)


@pytest.mark.parametrize("planes,fields,n,taps", [
    (1, 1, 8, 8), (3, 1, 8, 8), (1, 10, 8, 8), (2, 1, 4, 4), (1, 3, 4, 4)])
def test_k2_work_is_chip_smokes(planes, fields, n, taps):
    import chip_smoke
    nby, nbx = 1088 // 8 // (8 // n), 1920 // 8 // (8 // n)
    hp, wp = nby * n + 2 * 40, nbx * n + 2 * 40
    ext = torch.empty((planes, hp, wp) if planes > 1 else (hp, wp))
    maps = [torch.empty((fields, nby, nbx) if fields > 1 else (nby, nbx))
            for _ in range(4)]
    got = yardstick.k2_work(planes, hp, wp, fields, nby, nbx, n, taps)
    assert got == chip_smoke.k2_work(ext, maps, n, taps)


def test_roofline_readers_use_the_launch_dimensions():
    k1 = (0, 0, 0, 1088, 1920, 16, 4, 0)
    k2 = (0, 1, 1168, 2000, 0, 0, 0, 0, 0, 1, 136, 240, 8, 8, 0, 6, 255, 0)
    b1 = yardstick.bound_s(*yardstick.k1_work(1088, 1920, 16, 4))
    b2 = yardstick.bound_s(*yardstick.k2_work(1, 1168, 2000, 1, 136, 240,
                                              8, 8))
    rec = {"trace": {"kernels": {
        "sad_field": {"launches": [k1, k1], "seconds": [2 * b1, 2 * b1]},
        "mc_block": {"launches": [k2], "seconds": [4 * b2]}}}}
    assert harness.reader("sad_field_roofline")(rec) == pytest.approx(50)
    assert harness.reader("mc_block_roofline")(rec) == pytest.approx(25)
    # a launch the trace did not see: no number rather than a wrong one
    rec["trace"]["kernels"]["mc_block"]["seconds"] = []
    assert harness.reader("mc_block_roofline")(rec) is None


def test_span_readers():
    spans = [("p.dense_md_p", 0.1), ("p.decide_tree_dev", 0.02),
             ("p.merge_snap", 0.01), ("p.merge_snap", 0.01),
             ("p.any_intra", 0.5), ("p.intra_wavefront_pass", 1.26),
             ("p.encode_pass_p_direct", 0.03), ("p._finish_fused", 0.03),
             ("p.download", 0.01), ("p.host_emit", 0.04),
             ("p.dense_md_p", 0.1), ("p.host_emit", 0.06)]
    rec = {"trace": {"spans": spans, "wavefront_steps": 126}}
    assert harness.reader("p_chain_ms")(rec) == pytest.approx(150)
    assert harness.reader("host_emit_ms")(rec) == pytest.approx(50)
    assert harness.reader("wavefront_ms_per_step")(rec) == pytest.approx(10)
    rec["trace"]["wavefront_steps"] = 0
    assert harness.reader("wavefront_ms_per_step")(rec) is None


def test_rate_loss_weighs_psnr_against_bytes():
    from reference.quality import DB_PER_DOUBLING, psnr, quality, \
        rate_loss_pct
    e = {"bytes": 1000, "psnr_y_db": 32.0}
    assert rate_loss_pct(1000, 32.0, e) == 0.0
    assert rate_loss_pct(1100, 32.0, e) == pytest.approx(10.0)
    assert rate_loss_pct(1000, 32.0 - DB_PER_DOUBLING, e) == \
        pytest.approx(100.0)
    assert rate_loss_pct(500, 32.0 - DB_PER_DOUBLING, e) == \
        pytest.approx(0.0)
    a = np.zeros((4, 4), np.uint8)
    assert psnr(a + 1, a, 8) == pytest.approx(10 * math.log10(255 ** 2))
    assert psnr(a + 1, a, 10) == pytest.approx(10 * math.log10(1023 ** 2))
    pics = {i: {"data": b"x" * 10, "planes": (a + 1, None, None)}
            for i in range(3, 6)}
    q = quality(pics, lambda i: a, 8,
                {"first": 3, "count": 3, "expect": {"bytes": 30,
                                                    "psnr_y_db": 48.0}})
    assert q["bytes"] == 30
    assert q["rate_loss_pct"] == pytest.approx(
        100 * (2 ** ((48.0 - 10 * math.log10(255 ** 2)) / 2.5) - 1))
    with pytest.raises(ValueError):
        quality(pics, lambda i: a, 8, {"first": 3, "count": 4,
                                       "expect": e})
