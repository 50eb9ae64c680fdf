"""The port's tracer (svt_hevc_tpu_torch/trace.py) on the CPU, at 128x64.

Off, it records nothing and the stream is the one it gives on; on, every
span carries the picture whose work it is (under one-deep pipelining
too) and the span that encloses it; the lookahead and the download waits
have spans; its counter deltas are the program's counters over the same
interval; the stage hook sees the stages it saw before. Also the
arithmetic of tools/torch_trace_cell.py on synthetic records.
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from svt_hevc_tpu_torch import Encoder, EncoderConfig, trace
from svt_hevc_tpu_torch.gpu import encode as genc
from svt_hevc_tpu_torch.gpu import intra_pass, kernels
from svt_hevc_tpu_torch.io.yuv import Frame

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CQP = dict(width=128, height=64, qp=32, enc_mode=7, intra_period=-1)
P_STAGES = (["p.upload", "p.hme_search", "p.dense_md_p", "p.decide_tree_dev"]
            + ["p.merge_snap"] * genc.SNAP_PASSES
            + ["p.encode_pass_p_direct", "p._finish_fused"])
I_STAGES = ["i.upload", "i.intra_search_size_pred8",
            "i.intra_search_size_pred16", "i.intra_search_size_pred32",
            "i.decide_tree_i_dev", "i.intra_wavefront_pass",
            "i._finish_fused"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames(n, w=128, h=64, seed=3):
    """A panned random texture with flat chroma."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 64, w + 64)).astype(np.uint8)
    cb = np.full((h // 2, w // 2), 100, np.uint8)
    return [Frame(y=big[i:i + h, 2 * i:2 * i + w].copy(), cb=cb,
                  cr=255 - cb) for i in range(n)]


def traced(cfg, fr):
    """(stream, tracer output, counters before, counters after)."""
    base = trace.existing_counters()
    tr = trace.Tracer("cpu").start()
    try:
        stream, _ = Encoder(cfg, device="cpu").encode(fr)
    finally:
        out = tr.stop()
    return stream, out, base, trace.existing_counters()


@pytest.fixture(scope="module")
def cqp():
    """Three CQP low-delay P pictures (I0 P1 P2, pipelined one deep),
    encoded with the tracer off and on."""
    fr = frames(3)
    cfg = EncoderConfig(**CQP)
    idle = trace.Tracer("cpu")          # made, never started
    plain, _ = Encoder(cfg, device="cpu").encode(fr)
    assert idle.rows == [] and trace._ACTIVE is None
    stream, out, base, after = traced(cfg, fr)
    return {"plain": plain, "stream": stream, "out": out, "base": base,
            "after": after}


def test_tracer_off_records_nothing_and_changes_no_byte(cqp):
    assert trace._ACTIVE is None
    assert trace.span("p.x") is trace._NULL
    assert trace.picture(3) is trace._NULL
    assert genc.stage("p.x") is trace._NULL
    assert trace.current_picture() is None
    trace.count("la.frames", 5)
    assert cqp["stream"] == cqp["plain"]
    assert cqp["out"]["device"] == "cpu"
    assert all(s["device_ns"] is None for s in cqp["out"]["spans"])


def test_every_span_carries_its_picture_under_pipelining(cqp):
    """Picture k's download and emit run in picture k+1's iteration and
    still carry k."""
    spans = cqp["out"]["spans"]
    got = [(s["name"], s["pic"]) for s in spans]

    def pic(k, stages):
        return ([("enc.pull", None), ("enc.scene_cut", k),
                 ("pic.dispatch", k)] + [(n, k) for n in stages])

    def done(k, kind):
        return [("pic.complete", k), (f"{kind}.download", k),
                ("wait.download", k), (f"{kind}.host_emit", k),
                ("enc.emit", k)]
    assert got == (pic(0, I_STAGES) + pic(1, P_STAGES) + done(0, "i")
                   + pic(2, P_STAGES) + done(1, "p") + [("enc.pull", None)]
                   + done(2, "p"))
    first = {(s["name"], s["pic"]): s["host_ns"] for s in spans}
    assert first[("p.download", 1)][0] > first[("pic.dispatch", 2)][1]
    for s in spans:
        a, b = s["host_ns"]
        assert a <= b
        assert s["wait"] == (s["name"] == "wait.download")


def test_parents_nest_stages_under_dispatch_and_complete(cqp):
    spans = cqp["out"]["spans"]

    def parent(name, k):
        s = next(s for s in spans if s["name"] == name and s["pic"] == k)
        p = spans[s["parent"]]
        a, b = p["host_ns"]
        assert a <= s["host_ns"][0] <= s["host_ns"][1] <= b
        return p["name"], p["pic"]
    assert parent("p.dense_md_p", 2) == ("pic.dispatch", 2)
    assert parent("p.merge_snap", 1) == ("pic.dispatch", 1)
    assert parent("p.download", 1) == ("pic.complete", 1)
    assert parent("p.host_emit", 2) == ("pic.complete", 2)
    assert parent("wait.download", 1) == ("p.download", 1)
    for name in ("pic.dispatch", "pic.complete", "enc.emit", "enc.pull",
                 "enc.scene_cut"):
        assert all(s["parent"] is None for s in spans if s["name"] == name)


def test_counter_deltas_are_the_program_counters_over_the_interval(cqp):
    base, after, out = cqp["base"], cqp["after"], cqp["out"]
    for group in ("launches", "wavefront", "p_chain"):
        assert out["deltas"][group] == {
            k: after[group][k] - base[group][k] for k in after[group]}
    assert out["deltas"]["wavefront"]["runs"] == 1      # the IDR's
    # every P picture's chain, none of them replayed on the CPU
    assert out["deltas"]["p_chain"]["runs"] > 0
    assert out["deltas"]["p_chain"]["graph_runs"] == 0
    assert out["deltas"]["p_chain"]["captures"] == 0
    # on the CPU every step runs eagerly: no graph
    assert out["deltas"]["wavefront"]["graph_steps"] == 0
    assert out["deltas"]["wavefront"]["captures"] == 0
    assert set(out["deltas"]["launches"]) == {k.name
                                              for k in kernels.KERNELS}
    # launches and steps made inside a tracer's interval, and its own
    # counters
    tr = trace.Tracer("cpu").start()
    try:
        kernels.MC_BLOCK.launches += 3
        intra_pass.WAVEFRONT["steps"] += 7
        trace.count("la.frames", 4)
        trace.count("la.frames")
    finally:
        out = tr.stop()
        kernels.MC_BLOCK.launches -= 3
        intra_pass.WAVEFRONT["steps"] -= 7
    assert out["deltas"]["launches"]["mc_block"] == 3
    assert out["deltas"]["launches"]["sad_field"] == 0
    assert out["deltas"]["wavefront"] == {"runs": 0, "steps": 7,
                                          "graph_steps": 0, "captures": 0}
    assert out["counters"] == {"la.frames": 5} and out["spans"] == []
    with pytest.raises(RuntimeError):
        trace.Tracer("cpu").start().start()
    trace._ACTIVE = None


def test_lookahead_records_its_span_wait_and_frames():
    """VBR with a lookahead of 2: one refill analyses all 5 frames."""
    cfg = EncoderConfig(**CQP, rate_control_mode=1, target_bitrate=150_000,
                        look_ahead_distance=2)
    fr = frames(5)
    plain, _ = Encoder(cfg, device="cpu").encode(fr)
    stream, out, _, _ = traced(cfg, fr)
    assert stream == plain
    spans = out["spans"]
    la = [i for i, s in enumerate(spans) if s["name"] == "la.complexities"]
    assert len(la) == 1 and out["counters"] == {"la.frames": 5}
    assert spans[la[0]]["pic"] is None and spans[la[0]]["parent"] is None
    waits = [s for s in spans if s["name"] == "wait.lookahead"]
    assert len(waits) == 1 and waits[0]["wait"]
    assert waits[0]["parent"] == la[0]
    # the refill pulls six times (the sixth finds the end) before picture
    # 0 is dispatched; VBR pictures are not pipelined, so each completes
    # inside its own dispatch
    names = [s["name"] for s in spans]
    assert names.index("la.complexities") < names.index("pic.dispatch")
    assert names[:6] == ["enc.pull"] * 6
    for s in spans:
        if s["name"] == "pic.complete":
            assert spans[s["parent"]]["name"] == "pic.dispatch"
            assert spans[s["parent"]]["pic"] == s["pic"]


def test_random_access_spans_carry_the_display_index():
    cfg = EncoderConfig(**CQP, pred_structure=2, hierarchical_levels=2)
    fr = frames(3)
    plain, _ = Encoder(cfg, device="cpu").encode(fr)
    stream, out, _, _ = traced(cfg, fr)
    assert stream == plain
    got = [(s["name"], s["pic"]) for s in out["spans"]
           if s["name"] in ("pic.dispatch", "b.decide_tree_b_dev",
                            "p.download")]
    assert got == [("pic.dispatch", 0), ("pic.dispatch", 2),
                   ("p.download", 2), ("pic.dispatch", 1),
                   ("b.decide_tree_b_dev", 1)]


def test_stage_hook_sees_the_same_stages_with_the_tracer_on(cqp):
    """STAGE_TIMER still sees exactly the names it saw without a tracer
    (tests/test_torch_encoder.py), none of the tracer's own spans, and is
    entered outside the tracer's span of the same stage."""
    import time

    class Names:
        def __init__(self):
            self.rows = []

        @contextlib.contextmanager
        def stage(self, name):
            t0 = time.perf_counter_ns()
            yield
            self.rows.append((name, t0, time.perf_counter_ns()))

    rec = Names()
    genc.STAGE_TIMER = rec
    try:
        stream, out, _, _ = traced(EncoderConfig(**CQP), frames(3))
    finally:
        genc.STAGE_TIMER = None
    assert stream == cqp["plain"]
    assert [r[0] for r in rec.rows] == (
        I_STAGES + P_STAGES + ["i.download", "i.host_emit"] + P_STAGES
        + ["p.download", "p.host_emit"] * 2)
    staged = [s for s in out["spans"]
              if s["name"].split(".")[0] in ("i", "p", "b")]
    assert len(staged) == len(rec.rows)
    for s, (name, a, b) in zip(staged, rec.rows):
        assert s["name"] == name
        assert a <= s["host_ns"][0] <= s["host_ns"][1] <= b


# ---------------------------------------------------- the cell tool's reading

def cell_tool():
    """tools/torch_trace_cell.py, with sys.path as it was (the tool puts
    the benchmark's directory first)."""
    import sys
    spec = importlib.util.spec_from_file_location(
        "torch_trace_cell", os.path.join(ROOT, "tools", "torch_trace_cell.py"))
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def span(name, pic, a, b, dev=None, wait=False, parent=None):
    return {"name": name, "pic": pic, "parent": parent, "wait": wait,
            "host_ns": [a, b], "device_ns": dev}


MS = 1_000_000


def test_cell_tool_gives_none_without_samples():
    tool = cell_tool()
    prog = {"spans": [span("enc.pull", None, 0, MS)], "counters": {},
            "deltas": {}}
    assert tool.p_chain_ms(prog) is None
    assert tool.p_chain_ms(prog, "device_ns") is None
    assert tool.lookahead_ms_per_frame(prog) is None
    assert tool.host_wait_ms(prog, [0, 10 * MS]) is None
    assert tool.idle_launching_pct({}) is None
    assert tool.idle_by_span([], []) == {}


def test_cell_tool_groups_the_chain_by_picture():
    tool = cell_tool()
    spans = [span("pic.dispatch", 4, 0, 50 * MS),
             span("p.dense_md_p", 4, 1 * MS, 11 * MS, [2 * MS, 20 * MS]),
             span("p.merge_snap", 4, 11 * MS, 12 * MS, [20 * MS, 22 * MS]),
             span("p.host_emit", 3, 12 * MS, 40 * MS, [22 * MS, 23 * MS]),
             span("pic.dispatch", 5, 60 * MS, 99 * MS),
             span("p._finish_fused", 5, 61 * MS, 66 * MS, None),
             span("la.complexities", None, 70 * MS, 90 * MS),
             span("la.complexities", None, 91 * MS, 95 * MS)]
    prog = {"spans": spans, "counters": {"la.frames": 12}, "deltas": {}}
    assert tool.p_chain_ms(prog) == pytest.approx((11 + 5) / 2)
    # a span without device events is left out of the device sum
    assert tool.p_chain_ms(prog, "device_ns") == pytest.approx(20)
    assert tool.lookahead_ms_per_frame(prog) == pytest.approx(2)


def test_cell_tool_clips_waits_to_the_profiled_part():
    tool = cell_tool()
    spans = [span("pic.dispatch", 1, 0, 10 * MS),
             span("p.any_intra", 1, 2 * MS, 6 * MS, wait=True),
             span("pic.dispatch", 2, 10 * MS, 20 * MS),
             span("wait.download", 1, 12 * MS, 14 * MS, wait=True),
             span("wait.lookahead", None, 18 * MS, 30 * MS, wait=True),
             span("pic.dispatch", 3, 30 * MS, 40 * MS),
             span("p.host_emit", 2, 32 * MS, 35 * MS)]
    prog = {"spans": spans, "counters": {}, "deltas": {}}
    # part 1 holds the dispatch of picture 2 alone (picture 1's began
    # before it); its waits: 3 of the any_intra's 4 ms, 2, and 2 of the
    # lookahead's 12
    assert tool.host_wait_ms(prog, [3 * MS, 20 * MS]) == pytest.approx(
        3 + 2 + 2)
    assert tool.host_wait_ms(prog, [0, 40 * MS]) == pytest.approx(
        (4 + 2 + 12) / 3)


@pytest.mark.parametrize("wavefront,share", [
    (None, None), ({"runs": 0, "steps": 0}, None),
    ({"runs": 2, "steps": 252, "graph_steps": 250, "captures": 2},
     250 / 252),
    ({"runs": 1, "steps": 126}, 0.0)])      # a tree whose pass has no graph
def test_cell_tool_reads_the_wavefront_graph_share(wavefront, share):
    tool = cell_tool()
    deltas = {} if wavefront is None else {"wavefront": wavefront}
    prog = {"spans": [], "counters": {}, "deltas": deltas}
    assert tool.wavefront_graph_share(prog) == share


@pytest.mark.parametrize("p_chain,share", [
    (None, None), ({"runs": 0, "graph_runs": 0, "captures": 0}, None),
    ({"runs": 120, "graph_runs": 119, "captures": 0}, 119 / 120),
    ({"runs": 64, "graph_runs": 0, "captures": 0}, 0.0)])
def test_cell_tool_reads_the_p_chain_graph_share(p_chain, share):
    tool = cell_tool()
    deltas = {} if p_chain is None else {"p_chain": p_chain}
    prog = {"spans": [], "counters": {}, "deltas": deltas}
    assert tool.p_chain_graph_share(prog) == share


def test_cell_tool_sums_the_p_chain_recordings():
    tool = cell_tool()
    prog = {"spans": [span("p.capture", 3, 0, 400 * MS),
                      span("p.dense_md_p", 3, 10, 40)],
            "counters": {}, "deltas": {}}
    assert tool.p_capture(prog) == {"n": 1, "ms": pytest.approx(400.0)}
    assert tool.p_capture({"spans": [], "counters": {}, "deltas": {}}) == {
        "n": 0, "ms": 0.0}


def test_cell_tool_gives_idle_to_the_innermost_span():
    tool = cell_tool()
    spans = [span("pic.dispatch", 1, 0, 100),
             span("p.dense_md_p", 1, 10, 40, parent=0),
             span("p.merge_snap", 1, 50, 60, parent=0),
             span("pic.complete", 0, 100, 150),
             span("wait.download", 0, 110, 120, parent=3)]
    stamps = [("bench.capture", 150, 170), ("bench.source", 0, 300)]
    idle = [[5, 15], [35, 55], [115, 130], [145, 200], [400, 410]]
    got = tool.idle_by_span(spans, idle, stamps)
    want = {"pic.dispatch": (5 + 10) / 1e9, "p.dense_md_p": (5 + 5) / 1e9,
            "p.merge_snap": 5 / 1e9, "wait.download": 5 / 1e9,
            "pic.complete": (10 + 5) / 1e9, "bench.capture": 20 / 1e9,
            "bench.source": 30 / 1e9, None: 10 / 1e9}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k]), k
    assert tool.idle_launching_pct(got) == pytest.approx(
        100 * 15 / (sum(want.values()) * 1e9))
