"""Encoder-integrated picture-level parallelism over several devices.

Port of svt_hevc_tpu/parallel/pictures.py. Within a hierarchical
low-delay GOP every non-reference leaf picture (temporal layer ==
hierarchical_levels) depends only on already-coded lower-layer pictures,
so a group of consecutive leaves is independent work. With
EncoderConfig.mesh_pictures the encoder queues such leaves and hands
each group to dispatch_leaf_batch: one lane per device, each lane a
picture's whole device pipeline (gpu.me.hme_search, kernel K1, then
gpu.encode.fast_p_fused_dev, kernel K2), after which the host walks each
lane's maps for the syntax exactly as in the per-picture path.

The JAX package batches the leaves into one vmapped, jitted graph whose
batch axis is sharded over the devices (its _batched_graphs). There is
nothing of that graph to port: its PyTorch equivalent is the lane loop
below, which runs the per-picture graph the port already has on each
lane's device. Every lane is dispatched before any output is moved back,
so lanes on different devices overlap.

Each lane calls the per-picture path's own code (Encoder._dev_ref,
Encoder._col_motion, fast_path.run_fast_p), so the stream is
byte-identical to the one without the flag (tests hold it equal to the
JAX package's mesh_pictures stream). lane_devices is the counterpart of
jax.devices(): the encoder batches only where it lists more than one
device.
"""

from __future__ import annotations

import torch


def lane_devices(device) -> list[torch.device]:
    """The devices leaf lanes run on: every visible CUDA device for an
    encoder on the card, [cpu] for an encoder on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _to(x, dev):
    """Tensors (or tuples of them, or None) moved to `dev`."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return tuple(_to(t, dev) for t in x)


def dispatch_leaf_batch(enc, feat, items):
    """Dispatch a group of independent leaf P pictures, item i on lane
    i % len(lane_devices(enc.device)).

    enc: the Encoder (its device DPB and device motion caches). feat: the
    preset's features. items: dicts {frame, poc, qp, ref (planes, poc),
    col_poc}. Returns one `precomputed` tuple (packed, (rec_y, rec_cb,
    rec_cr), (col16_mv, col16_valid), lv_full) per item, in order, on the
    encoder's device, for Encoder.encode_frame(..., precomputed=...).

    The JAX package pads the batch to a multiple of the device count
    (its sharded batch axis must divide evenly) and discards the padded
    lanes. Lanes here are independent calls, so a partial last round of
    lanes is simply shorter: no padded lane exists whose output could be
    discarded, and each real lane's output is the same either way."""
    from ..core.ctu import PictureState
    from ..gpu import encode as genc
    from ..gpu.me import hme_search
    from ..pipeline.fast_path import run_fast_p

    cfg = enc.cfg
    cw, ch = cfg.coded_width, cfg.coded_height
    w64, h64 = (cw + 63) // 64 * 64, (ch + 63) // 64 * 64
    lanes = lane_devices(enc.device)
    outs = []
    for i, it in enumerate(items):
        dev = lanes[i % len(lanes)]
        fr, ref_poc = it["frame"], it["ref"][1]
        src = genc.prep_planes(fr.y, fr.cb, fr.cr, w64, h64, dev)
        ref = enc._dev_ref(it["ref"], w64, h64, dev)
        mv = hme_search(src[0], ref[0])[0]
        col, tb, td = enc._col_motion(it["col_poc"], it["poc"], ref_poc,
                                      w64, h64, dev)
        st = PictureState(cw, ch, it["qp"], cfg.ctb_log2, cfg.bit_depth,
                          chroma_format=cfg.chroma_format)
        outs.append(run_fast_p(cfg, feat, st, it["qp"], mv, src, ref, col,
                               tb, td, enc._p_scripts))
    # every lane is queued; now bring the outputs to the encoder's device
    return [_to(o, enc.device) for o in outs]
