"""tools/torch_bench.py, bench.py's twin on the port, on the CPU.

The twin's frames equal bench.py's; its timed encode at a small size
(W, H, MAX_FRAMES set on the loaded module) gives the JAX package's
stream for the same configuration; its line carries bench.py's keys plus
device and decoder, under the CPU's metric name; the decode check holds
with the port's decoder and with libde265 where installed; a SIGTERM
still prints one line; the default device without CUDA fails without a
number; and the card == CPU check reports identical streams for a device
pair.
"""

import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from svt_hevc_tpu.config import EncoderConfig as JCfg
from svt_hevc_tpu.pipeline.encoder import Encoder as JEncoder
from svt_hevc_tpu_torch.io import de265_decoder
from tests.test_torch_ctb64 import ROOT, load_tool
from tests.test_torch_encoder import one_torch_thread  # noqa: F401

SW, SH, SN = 256, 128, 6
TOOL = os.path.join(ROOT, "tools", "torch_bench.py")


def load_bench():
    """bench.py by file; the JAX cache settings it puts into the
    environment are taken out again."""
    before = dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k in set(os.environ) - set(before):
        del os.environ[k]
    return mod


def small_tool():
    tool = load_tool("torch_bench")
    tool.W, tool.H, tool.MAX_FRAMES = SW, SH, SN
    return tool


@pytest.fixture(scope="module")
def cpu_run():
    """The twin's run on the CPU at SW x SH x SN: (tool, state, stream,
    access units, frames)."""
    tool = small_tool()
    state = tool.new_state()
    stream, aus, frames = tool.run("cpu", state)
    return tool, state, stream, aus, frames


@pytest.mark.parametrize("n,w,h,seed", [(4, 256, 128, 7), (4, 256, 128, 11),
                                        (2, 1920, 1080, 7)])
def test_make_frames_equals_bench(n, w, h, seed):
    want = load_bench().make_frames(n, w, h, seed=seed)
    got = load_tool("torch_bench").make_frames(n, w, h, seed=seed)
    assert len(got) == len(want)
    for g, f in zip(got, want):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(g, p), getattr(f, p))
            assert getattr(g, p).dtype == getattr(f, p).dtype


def test_smoke_frames_build_on_the_twin():
    """chip_smoke.make_frames takes its planes from the twin's."""
    import chip_smoke
    want = load_bench().make_frames(3, 256, 128, seed=11)
    got = chip_smoke.make_frames(3, 256, 128, seed=11)
    for g, f in zip(got, want):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(g, p), getattr(f, p))


def test_timed_encode_matches_jax(cpu_run):
    tool, state, stream, aus, _ = cpu_run
    frames = load_bench().make_frames(SN, SW, SH)
    js, _ = JEncoder(JCfg(width=SW, height=SH, qp=32, fps_num=50,
                          enc_mode=7, intra_period=-1)).encode(frames)
    assert stream == js
    assert len(aus) == SN
    # every picture after the warm-up ones is a steady one
    assert state["steady_frames"] == SN - tool.WARMUP_FRAMES
    assert state["idr_seconds"] > 0 and state["compile_seconds"] > 0
    assert state["phase"] == "done"


def test_line_has_bench_keys(cpu_run):
    tool, state, _, _, _ = cpu_run
    bench = load_bench()
    out = io.StringIO()
    with redirect_stdout(out):
        bench._emit()
    want = set(json.loads(out.getvalue()))
    got = tool.line(state)
    assert set(got) == want | {"device", "decoder"}
    assert got["metric"] == "full_encode_1080p_m7_ipp_fps_cpu"
    assert got["device"]["platform"] == "cpu"
    assert set(got["device"]) == {"platform", "name", "power_limit_w",
                                  "count"}
    assert got["value"] > 0 and got["steady_frames"] == SN - 3
    assert got["vs_baseline"] == round(got["value"] / 50.0, 4)
    assert got["decode_ok"] is True and got["phase"] == "done"
    json.dumps(got)


def test_decode_check(cpu_run):
    tool, _, stream, aus, frames = cpu_run
    decoders = ["port"] + (["libde265"] if de265_decoder.available()
                           else [])
    recons = [a.recon for a in aus]
    for dec in decoders:
        st = tool.new_state()
        tool.decode_check(stream, recons, frames, st, dec)
        assert st["decode_ok"] is True, dec
        assert st["decoder"] == dec
        assert st["psnr_y"] > 30
    # a picture short of the recon list is a failed check
    st = tool.new_state()
    tool.decode_check(stream, recons + recons[:1], frames, st, "port")
    assert st["decode_ok"] is False


def _run_tool(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def test_sigterm_prints_one_line():
    code = (f"import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('b', {TOOL!r})\n"
            f"t = importlib.util.module_from_spec(spec)\n"
            f"spec.loader.exec_module(t)\n"
            f"t.W, t.H = {SW}, {SH}\n"
            f"sys.exit(t.main(['--device', 'cpu']))\n")
    p = _run_tool("-c", code)
    lines = []
    try:
        for ln in p.stdout:
            lines.append(ln)
            if ln.startswith("warmup"):
                p.send_signal(signal.SIGTERM)
                break
        out, err = p.communicate(timeout=120)
    finally:
        p.kill()
    lines += out.splitlines()
    assert p.returncode == 0, err
    res = json.loads(lines[-1])
    assert res["phase"].endswith("/sig15"), res
    assert res["metric"] == "full_encode_1080p_m7_ipp_fps_cpu"


def test_default_device_without_cuda_fails():
    p = _run_tool(TOOL)
    out, err = p.communicate(timeout=120)
    assert p.returncode != 0
    res = json.loads(out.splitlines()[-1])
    assert "error" in res["phase"] and "CUDA" in res["phase"]
    # no number, and none under the card's metric from the CPU
    assert res["metric"] == "full_encode_1080p_m7_ipp_fps"
    assert res["value"] == 0.0 and res["steady_frames"] == 0
    assert res["idr_seconds"] is None and res["device"]["platform"] is None


def test_gpu_cpu_check_device_pair():
    res = load_tool("torch_bench").gpu_cpu_check(("cpu", "cpu"),
                                                 dims=(128, 64), n=3)
    assert res["identical"] is True
    assert res["bytes_device"] == res["bytes_cpu"] > 0
    assert res["device_platform"] == "cpu" and res["dims"] == [128, 64]
    assert len(res["sha256"]) == 64
