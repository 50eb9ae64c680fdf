"""The check on a random-access stream made the way the harness makes its
streams: `Encoder.encode_pictures` on a finite list of frames (closed
GOP, hierarchical B, one IDR), each access unit captured by
`harness.Run.capture` (on the card its reconstruction read back through
`harness.Readback`), then `check_stream`; sound, and with a fault of
faults.py planted in the program.

    python3 -m pytest benchmark/tests/test_harness_random_access.py -q -s
    python3 -m pytest benchmark/tests/test_harness_random_access.py -q -s -m card

The card's test encodes 33 1080p pictures of the `pan` mix at hl 3, QP
32, M7 (`ldp_1080p_m7_qp32`'s configuration in random access) and checks
them in 7 chunks; it prints each check's seconds.
"""

import contextlib
import dataclasses
import time

import pytest

import harness
from faults import FAULTS

SEED = 2 ** 31 + 17


def encode_and_check(dims, frames, hl, device, fault=None):
    """The check's verdict on a random-access stream of `frames` pictures
    of the pan mix at dims, and its seconds."""
    from frames import Source, load_mix
    from reference.check import check_stream
    from svt_hevc_tpu_torch import Encoder
    from svt_hevc_tpu_torch.io.yuv import Frame
    cfg = harness.encoder_config(harness.load_config("ldp_1080p_m7_qp32"),
                                 dims)
    cfg = dataclasses.replace(cfg, pred_structure=2, hierarchical_levels=hl)
    src = Source(load_mix("pan"), cfg.width, cfg.height, 8, SEED)
    feed = [Frame(*src.frame(i)) for i in range(frames)]
    run = harness.Run.__new__(harness.Run)     # the capture alone
    run.cfg, run.stamps = cfg, harness.NoStages()
    run.pictures, run.motions, run.yielded = [], {}, {}
    run.readback = None
    if device == "cuda":
        run.readback = harness.Readback(cfg.width * cfg.height * 3 // 2)
    run.enc = Encoder(cfg, device=device)
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        for au in run.enc.encode_pictures(feed):
            run.capture(au)
    run._host_planes()
    t = time.perf_counter()
    v = check_stream(run.enc.headers(), run.pictures, run.motions,
                     harness.expectations(cfg), workers=7)
    return v, time.perf_counter() - t


def assert_verdicts(dims, frames, hl, device, faults):
    v, s = encode_and_check(dims, frames, hl, device)
    print(f"sound: {v['pictures_wrong']} of {v['pictures_checked']} wrong, "
          f"chunks {v['chunks']}, check {s:.1f} s")
    assert len(v["chunks"]) == 7
    assert (v["pictures_planned"], v["pictures_checked"],
            v["pictures_wrong"]) == (frames, frames, 0), v["faults"]
    for fault in faults:
        v, s = encode_and_check(dims, frames, hl, device, fault)
        print(f"{fault}: {v['pictures_wrong']} of {v['pictures_checked']} "
              f"wrong, check {s:.1f} s; {v['faults'][:1]}")
        assert v["pictures_checked"] == frames
        assert v["pictures_wrong"] > 0, fault


def test_random_access_stream_on_the_cpu():
    # sao_skip shows nothing at this size (SAO changed no sample when tried)
    assert_verdicts((128, 64), 17, 3, "cpu", ["dlf_unchanged"])


@pytest.mark.card
def test_random_access_1080p_on_the_card(card):
    assert_verdicts((1920, 1080), 33, 3, "cuda",
                    ["sao_skip", "dlf_unchanged"])
