"""The exact check of the port's decisions, on the card: for seed 7, the
first pictures of each cell's source, encoded by the cell's
configuration through Encoder.encode_pictures, give the JAX package's
stream, byte for byte (its length and sha256, each cell's `jax_record`
in cells/<cell>.json, copied from the records that the port's bring-up
made by encoding the same frames with the JAX package on the CPU;
nothing of JAX is imported). A run's own check (reference/) holds every
seed to the decoder and to the quality it expects; this holds one seed
to every decision.

    python3 -m pytest benchmark/tests -q -m card
"""

import hashlib

import pytest

import harness

CELLS = sorted(c["name"] for c in harness.manifest()["workloads"])


def record(cell):
    """(pictures, bytes, sha256 of the headers and the access units)."""
    r = harness.load_cell(cell)["jax_record"]
    return r["pictures"], r["bytes"], r["sha256"]


def test_every_cell_has_a_record():
    for cell in CELLS:
        assert set(harness.load_cell(cell)["jax_record"]) == {
            "pictures", "bytes", "sha256"}
        frames, n, sha = record(cell)
        assert frames > 0 and n > 0
        assert len(sha) == 64 and int(sha, 16) >= 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_seed_7_prefix_is_the_jax_packages_stream(card, cell):
    from frames import Source, load_mix
    from svt_hevc_tpu_torch import Encoder
    from svt_hevc_tpu_torch.gpu import kernels
    from svt_hevc_tpu_torch.io.yuv import Frame
    todo = [k for k in kernels.KERNELS if k.stale()]
    if todo:
        kernels.build_all(todo)
    frames, n, sha = record(cell)
    c = harness.entry(harness.manifest()["workloads"], cell)
    cfg = harness.encoder_config(harness.load_config(c["config"]))
    src = Source(load_mix(c["traffic"]), cfg.width, cfg.height,
                 cfg.bit_depth, 7)
    enc = Encoder(cfg, device="cuda")
    aus = list(enc.encode_pictures(Frame(*src.frame(i))
                                   for i in range(frames)))
    stream = enc.headers() + b"".join(a.data for a in aus)
    assert (len(stream), hashlib.sha256(stream).hexdigest()) == (n, sha)
