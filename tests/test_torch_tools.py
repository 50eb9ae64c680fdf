"""The port's quality and analysis tools (tools/torch_*.py) against their
JAX twins, on the CPU.

make_clip_scene / make_clip give the JAX tool's arrays and files; bd_rate
gives the JAX tool's numbers and every BD_r05_*.json BD-rate from its
rows; the --artifact check passes on a small artifact of the port's own
rows and fails on a changed row; the frame trace (both decoders) and the
bit-accounting profile print what the JAX tools print on the same stream
(both run in subprocesses: bits_profile's install() patches the decoder's
modules for the life of the process); the host profile runs on the CPU at
128x64; the packed stage split runs at 256x128; and no tools/torch_*.py
imports JAX or the JAX package.
"""

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_ctb64 import load_tool
from tests.test_torch_encoder import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TT = load_tool("torch_compare_reference")
JT = load_tool("compare_reference")
ARTIFACTS = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(ROOT, "BD_r05_*.json")))
ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def run_tool(*args):
    """stdout of a tool run in a process of its own; it must exit 0."""
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, cwd=ROOT, env=ENV, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


@pytest.mark.parametrize("gen", ["make_clip_scene", "make_clip"])
def test_clip_generators_equal_jax_tool(gen, tmp_path):
    got = getattr(TT, gen)(192, 128, 3, str(tmp_path / "t.yuv"))
    want = getattr(JT, gen)(192, 128, 3, str(tmp_path / "j.yuv"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert ((tmp_path / "t.yuv").read_bytes()
            == (tmp_path / "j.yuv").read_bytes())


def _rows(art):
    r = art["rows"]
    return (np.array([x["ref_bytes"] for x in r], float),
            np.array([x["ref_psnr"] for x in r], float),
            np.array([x["ours_bytes"] for x in r], float),
            np.array([x["ours_psnr"] for x in r], float))


@pytest.mark.filterwarnings("ignore:Polyfit may be poorly conditioned")
@pytest.mark.parametrize("name", ARTIFACTS)
def test_bd_rate_reproduces_artifact(name):
    """The twin's bd_rate equals the JAX tool's on the artifact's rows,
    and the artifact's bd_rate_pct (from unrounded PSNR, kept to 2
    decimals) lies within the BD-rates its 3-decimal PSNR columns allow."""
    with open(os.path.join(ROOT, name)) as f:
        art = json.load(f)
    rows = _rows(art)
    assert TT.bd_rate(*rows) == JT.bd_rate(*rows)
    lo, hi = TT.bd_rate_bounds(*rows, 5e-4, 5e-4)
    assert lo <= TT.bd_rate(*rows) <= hi
    assert lo - 0.005 <= art["bd_rate_pct"] <= hi + 0.005
    ps, hl = TT.artifact_structure(art["pred_struct"])
    assert (ps, hl) == ((2, 2) if "_ra_" in name else (0, 0))


def test_artifact_structure_rejects_unknown():
    with pytest.raises(ValueError):
        TT.artifact_structure("LDB-matched")


@pytest.mark.filterwarnings("ignore:Polyfit may be poorly conditioned")
def test_artifact_mode_on_the_cpu(tmp_path, capsys, monkeypatch):
    """--artifact re-encodes each row: exit 0 on an artifact of the port's
    own rows (128x64 x2, three QPs), and check_artifact reports a changed
    byte count, PSNR and BD-rate."""
    w, h, n, ip = 128, 64, 2, 31
    clip = str(tmp_path / "scene.yuv")
    frames = TT.make_clip_scene(w, h, n, clip)
    ours = []
    for qp in (27, 32, 37):
        s, _ = TT.run_ours(clip, w, h, n, qp, 7, ip, device="cpu")
        ours.append((qp, len(s), TT.psnr_stream(s, frames)))
    # reference points: 80% of the bytes at 0.3 dB more
    ref = [(b * 4 // 5, round(p + 0.3, 3)) for _, b, p in ours]
    bd = TT.bd_rate(np.array([r for r, _ in ref], float),
                    np.array([p for _, p in ref]),
                    np.array([b for _, b, _ in ours], float),
                    np.array([p for _, _, p in ours]))
    art = {"preset": 7, "dims": [w, h], "frames": n, "intra_period": ip,
           "pred_struct": "IPPP-matched", "content": "scene",
           "rows": [{"qp": qp, "ours_bytes": b, "ours_psnr": round(p, 3),
                     "ref_bytes": r, "ref_psnr": rp}
                    for (qp, b, p), (r, rp) in zip(ours, ref)],
           "bd_rate_pct": round(bd, 2)}
    path = tmp_path / "art.json"
    path.write_text(json.dumps(art))
    monkeypatch.setattr(sys, "argv", ["torch_compare_reference.py",
                                      "--artifact", str(path),
                                      "--device", "cpu"])
    assert TT.main() == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["ok"] and res["card"] is None
    assert [(r["qp"], r["bytes"]) for r in res["rows"]] == [
        (qp, b) for qp, b, _ in ours]
    bad = json.loads(json.dumps(art))
    bad["rows"][1]["ours_bytes"] += 1
    bad["rows"][2]["ours_psnr"] += 0.001
    bad["bd_rate_pct"] += 0.5
    _, _, fails = TT.check_artifact(bad, res["rows"])
    assert len(fails) == 3, fails
    _, _, fails = TT.check_artifact(art, res["rows"])
    assert fails == []


def test_psnr_stream_decoders_agree_and_cuda_does_not_fall_back(tmp_path):
    w, h, n = 128, 64, 2
    clip = str(tmp_path / "scene.yuv")
    frames = TT.make_clip_scene(w, h, n, clip)
    s, _ = TT.run_ours(clip, w, h, n, 32, 7, 31, device="cpu")
    assert TT.psnr_stream(s, frames) == TT.psnr_stream(s, frames, "de265")
    with pytest.raises(ValueError):
        TT.psnr_stream(s, frames, "hm")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        TT.run_ours(clip, w, h, n, 32, 7, 31)


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    """A port stream (192x128 x4 of make_clip_scene, qp 32, M7, IDR
    period 3 so that two pictures are I) and its clip."""
    d = tmp_path_factory.mktemp("trace")
    clip = str(d / "scene.yuv")
    TT.make_clip_scene(192, 128, 4, clip)
    s, _ = TT.run_ours(clip, 192, 128, 4, 32, 7, 3, device="cpu")
    path = d / "s.265"
    path.write_bytes(s)
    return str(path), clip


@pytest.mark.parametrize("decoder", ["port", "de265"])
def test_frame_trace_matches_jax_tool(stream_file, decoder):
    path, clip = stream_file
    args = [path, "--width", "192", "--height", "128", "--clip", clip]
    want = run_tool("tools/frame_trace.py", *args)
    got = run_tool("tools/torch_frame_trace.py", *args,
                   "--decoder", decoder)
    assert got == want
    assert len(got.splitlines()) == 6


def test_bits_profile_matches_jax_tool(stream_file):
    path, _ = stream_file
    want = run_tool("tools/bits_profile.py", path)
    got = run_tool("tools/torch_bits_profile.py", path)
    assert got == want
    assert "slice type I" in got and "slice type P" in got


def test_profile_encode_runs_on_the_cpu():
    out = run_tool("tools/torch_profile_encode.py", "--device", "cpu",
                   "--width", "128", "--height", "64", "--frames", "3")
    assert "1 pictures in" in out and "cumulative" in out
    assert "card:" not in out


def test_packed_split_runs_on_the_cpu():
    st = load_tool("torch_stage_times")
    ms = st.packed_split(256, 128, device="cpu")
    assert list(ms) == [
        "warmup 2 pictures", "src upload", "hme_search",
        "hme seed download", "ois_packed", "ois download", "phase planes",
        "dense_md_p_packed", "dense_md download + unpack",
        "decide_tree (host)", "encode_pass_p_packed",
        f"encode_pass download ({(256 * 128 * 3 + 256 * 128 * 3 // 32) * 2}"
        f" bytes)"]
    assert all(v >= 0 for v in ms.values())


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p)
    for p in glob.glob(os.path.join(ROOT, "tools", "torch_*.py"))))
def test_tool_imports_no_jax(name):
    with open(os.path.join(ROOT, "tools", name)) as f:
        tree = ast.parse(f.read())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    for m in mods:
        top = m.split(".")[0]
        assert top not in ("jax", "jaxlib", "svt_hevc_tpu"), (name, m)
