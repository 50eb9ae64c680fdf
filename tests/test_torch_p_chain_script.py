"""Replay scripts of the fused P chain (gpu.chain_script).

On the CPU: the key rule (a key seen on two P pictures in a row is
recorded, a repeated new key replaces the kept script, a key that never
repeats stays eager), no script where the tensors lie on the CPU or the
chain reads a device value on the host (min_intra_log2 < 6), the
PCHAIN counts, and the chain's ops holding no host read wherever a key
is made (M6-M7 and M10-M11, 8- and 10-bit, CTB 32 and 64) while M8's
any_intra read is seen. The CPU path stays eager; the parity tests hold
its streams to the JAX package.

On the card (tests marked `card`, skipped without one): a pipelined
1080p M7 CQP stream of 12 pictures is byte-identical with scripts and
with them bypassed, a hook on kernels.MC_BLOCK.launch sees the same 13
K2 launches with the same dimensions on every replayed picture as on an
eager one, and two leaf lanes on cuda:0 give the stream one lane gives.

The file imports no JAX. The card's machine has none, and the shared
tests/conftest.py imports it, so run the file there without it:

    python3 -m pytest --noconftest tests/test_torch_p_chain_script.py -q
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from svt_hevc_tpu_torch import Encoder, EncoderConfig
from svt_hevc_tpu_torch.gpu import kernels
from svt_hevc_tpu_torch.gpu import encode as genc
from svt_hevc_tpu_torch.gpu.chain_script import PChainScripts, chain_key
from svt_hevc_tpu_torch.io.yuv import Frame


@pytest.fixture
def card():
    """The CUDA card's name; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return torch.cuda.get_device_name(0)


def clip(w, h, n, seed, bit_depth=8):
    """n frames: a smoothed seeded texture panned (2, 1) a picture, and a
    flat square moving (7, 5)."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bit_depth) - 1
    tex = rng.integers(0, maxv + 1, (h // 8 + 8, w // 8 + 8))
    tex = np.repeat(np.repeat(tex, 8, 0), 8, 1).astype(np.float64)
    for ax in (0, 1):
        tex = (tex + np.roll(tex, 1, ax) + np.roll(tex, -1, ax)) / 3
    dt = np.uint8 if bit_depth == 8 else np.uint16
    out = []
    for i in range(n):
        y = np.roll(tex, (i, 2 * i), (0, 1))[:h, :w].copy()
        oy, ox = (5 * i) % (h - 24), (7 * i) % (w - 24)
        y[oy:oy + 24, ox:ox + 24] = maxv // 3
        c = np.roll(tex, (i, i), (0, 1))[:h // 2, :w // 2]
        out.append(Frame(y=y.astype(dt), cb=c.astype(dt),
                         cr=(maxv - c).astype(dt)))
    return out


def counts_since(before):
    return {k: v - before[k] for k, v in genc.PCHAIN.items()}


# ------------------------------------------------------------ the key rule

@pytest.mark.parametrize("keys,plans", [
    ("AAAA", ["eager", "record", "replay", "replay"]),
    ("ABAB", ["eager"] * 4),
    ("AABBA", ["eager", "record", "eager", "record", "eager"]),
    ("AABAA", ["eager", "record", "eager", "replay", "replay"]),
    ("AA.AA", ["eager", "record", "eager", "replay", "replay"]),
    ("A.A", ["eager", "eager", "eager"]),
], ids=["repeat", "alternate", "replace", "kept_through_one_other",
        "no_script_key", "broken_by_no_script_key"])
def test_plan_records_a_repeated_key_and_replaces_on_a_repeated_new_one(
        keys, plans):
    """'.' stands for a chain no script may serve (key None)."""
    s = PChainScripts()
    got = []
    for k in keys:
        plan = s.plan(None if k == "." else k)
        got.append(plan)
        if plan == "record":        # what run() keeps
            s.script = type("Kept", (), {"key": k})()
    assert got == plans


class _OnCard:
    """A stand-in for a CUDA tensor: chain_key reads only .device and
    .shape before it decides."""
    device = torch.device("cuda", 0)
    shape = (128, 128)


@pytest.mark.parametrize("where,min_intra_log2", [
    ("cpu", 6), ("cpu", 5), ("card", 5), ("card", 4), ("card", 3)])
def test_no_script_off_the_card_or_with_a_host_read(where, min_intra_log2):
    src = torch.zeros((128, 128), dtype=torch.int32) if where == "cpu" \
        else _OnCard()
    key = chain_key(src, 32, 31, 43.4, 1, 1, True, ctb_log2=5, w=128, h=96,
                    bit_depth=8, dlf=True, sao=True,
                    min_intra_log2=min_intra_log2, subpel_min=16)
    assert key is None


@pytest.mark.parametrize("enc_mode,p_min_intra_log2", [(7, 6), (8, 5)])
def test_cpu_chains_run_eagerly_and_are_counted(enc_mode, p_min_intra_log2,
                                                monkeypatch):
    """Every P picture runs through PChainScripts, each is counted as a
    run, and on the CPU each runs fast_p_fused_dev eagerly: no recording,
    no replay, no script kept."""
    from svt_hevc_tpu_torch.preset import derive_preset
    assert derive_preset(enc_mode).p_min_intra_log2 == p_min_intra_log2
    calls = []
    eager = genc.fast_p_fused_dev

    def counted(*a, **k):
        calls.append(k["min_intra_log2"])
        return eager(*a, **k)

    monkeypatch.setattr(genc, "fast_p_fused_dev", counted)
    cfg = EncoderConfig(width=128, height=64, qp=32, enc_mode=enc_mode,
                        intra_period=-1)
    enc = Encoder(cfg, device="cpu")
    before = dict(genc.PCHAIN)
    gen = enc.encode_pictures(iter(clip(128, 64, 4, seed=3)))
    aus = [next(gen) for _ in range(4)]
    assert enc._p_scripts.script is None
    assert enc._p_scripts.last_key is None
    gen.close()
    assert len(aus) == 4
    assert calls == [p_min_intra_log2] * 3
    assert counts_since(before) == {"runs": 3, "graph_runs": 0,
                                    "captures": 0}


# ------------------------------------------------ no host read in the chain

# ops that read a device value on the host or make a shape from one
_HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
               "_unique", "_unique2", "unique_dim", "unique_consecutive"}


class _HostReads(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        self.ops += 1
        if name in _HOST_READS:
            self.seen[name] += 1
        if name in ("index", "index_put", "index_put_"):
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in args[1]):
                self.seen["bool_index"] += 1
        if (name == "repeat_interleave" and len(args) > 1
                and isinstance(args[1], torch.Tensor)
                and (kwargs or {}).get("output_size") is None):
            self.seen["repeat_interleave_tensor"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("enc_mode,bit_depth,ctb_size,reads", [
    (7, 8, 32, False), (7, 10, 32, False), (6, 8, 32, False),
    (10, 8, 32, False), (11, 8, 32, False), (7, 8, 64, False),
    (11, 10, 64, False), (8, 8, 32, True)])
def test_the_chain_reads_no_device_value_where_scripts_apply(
        enc_mode, bit_depth, ctb_size, reads, monkeypatch):
    """A script bakes the chain's Python values in: every P chain that
    chain_key admits (min_intra_log2 >= 6: M6-M7, M10-M11, 8- and 10-bit,
    CTB 32 and 64) runs its ops without reading a device value on the
    host; M8's chain (min_intra_log2 5) reads any_intra, and the probe
    sees it."""
    modes = []
    eager = genc.fast_p_fused_dev

    def probed(*a, **k):
        m = _HostReads()
        modes.append(m)
        with m:
            return eager(*a, **k)

    monkeypatch.setattr(genc, "fast_p_fused_dev", probed)
    cfg = EncoderConfig(width=128, height=64, qp=32, enc_mode=enc_mode,
                        intra_period=-1, bit_depth=bit_depth,
                        ctb_size=ctb_size)
    list(Encoder(cfg, device="cpu").encode_pictures(
        iter(clip(128, 64, 3, seed=4, bit_depth=bit_depth))))
    assert len(modes) == 2
    for m in modes:
        assert m.ops > 1000
        assert bool(m.seen) == reads, dict(m.seen)
    if reads:
        assert all(m.seen["_local_scalar_dense"] == 1 for m in modes)


def test_the_end_of_a_stream_drops_the_script():
    cfg = EncoderConfig(width=128, height=64, qp=32, enc_mode=7,
                        intra_period=-1)
    enc = Encoder(cfg, device="cpu")
    enc._p_scripts.script = "a kept script"
    enc._p_scripts.last_key = "a key"
    gen = enc.encode_pictures(iter(clip(128, 64, 1, seed=5)))
    next(gen)
    assert enc._p_scripts.script == "a kept script"   # kept while it runs
    gen.close()
    assert enc._p_scripts.script is None
    assert enc._p_scripts.last_key is None


# ----------------------------------------------------------------- the card

CARD_CFG = dict(width=1920, height=1080, qp=32, enc_mode=7, intra_period=-1)


def _bypass(enc):
    """Make the encoder's P chains run eagerly, as before scripts."""
    enc._p_scripts.plan = lambda key: "eager"
    return enc


def _stream(frames, bypass=False, **cfg_kw):
    cfg = EncoderConfig(**{**CARD_CFG, **cfg_kw})
    enc = Encoder(cfg, device="cuda")
    if bypass:
        _bypass(enc)
    data, recons = [], []
    for au in enc.encode_pictures(iter(frames)):
        data.append(au.data)
        recons.append(np.asarray(au.recon.y))
    return data, recons


@pytest.mark.card
def test_scripts_give_the_eager_stream_byte_for_byte(card):
    frames = clip(1920, 1080, 12, seed=18)
    before = dict(genc.PCHAIN)
    got, got_rec = _stream(frames)
    counts = counts_since(before)
    want, want_rec = _stream(frames, bypass=True)
    assert counts == {"runs": 11, "graph_runs": 10, "captures": 1}
    assert [len(d) for d in got] == [len(d) for d in want]
    assert got == want
    for a, b in zip(got_rec, want_rec):
        assert np.array_equal(a, b)


@pytest.mark.card
def test_every_replayed_picture_launches_k2_as_an_eager_one(card):
    """A hook on the instance attribute MC_BLOCK.launch (as the benchmark
    sets one) sees 13 K2 launches on each P picture, replayed or eager,
    with the same dimensions; only the pointers and the stream differ."""
    launches = []
    real = kernels.MC_BLOCK.launch

    def hook(*args):
        launches.append(args)
        return real(*args)

    frames = clip(1920, 1080, 6, seed=19)
    per = {}
    for mode in ("scripts", "eager"):
        enc = Encoder(EncoderConfig(**CARD_CFG), device="cuda")
        if mode == "eager":
            _bypass(enc)
        rows = []
        kernels.MC_BLOCK.launch = hook       # as the benchmark's hook
        try:
            for au in enc.encode_pictures(iter(frames)):
                rows.append([a[1:4] + a[9:17] for a in launches])
                launches.clear()
        finally:
            del kernels.MC_BLOCK.launch
        per[mode] = rows
    # pipelined one deep: a picture's launches fall between two yields
    flat = {m: [a for r in rows for a in r] for m, rows in per.items()}
    assert len(flat["scripts"]) == 13 * 5
    assert flat["scripts"] == flat["eager"]
    assert all(isinstance(v, int) for a in flat["scripts"] for v in a)


@pytest.mark.card
def test_two_lanes_on_one_card_give_the_lone_stream(card, monkeypatch):
    """Leaf lanes (mesh_pictures, hl=1) dispatch two P chains before
    either's outputs are used: both on cuda:0 through the encoder's one
    script, each replay's inputs copied in and outputs cloned out in
    stream order."""
    from svt_hevc_tpu_torch.parallel import pictures
    frames = clip(1920, 1080, 9, seed=20)
    lone, _ = _stream(frames, hierarchical_levels=1)
    monkeypatch.setattr(pictures, "lane_devices",
                        lambda device: [torch.device("cuda", 0)] * 2)
    before = dict(genc.PCHAIN)
    lanes, _ = _stream(frames, hierarchical_levels=1, mesh_pictures=True)
    counts = counts_since(before)
    assert lanes == lone
    assert counts["graph_runs"] > 0, counts
