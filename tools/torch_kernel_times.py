"""Device time of the port's kernels at the 1080p main-path shapes, on one
GPU, for side-by-side runs of two versions of the port in one call.

    python3 tools/torch_kernel_times.py [--root DIR]

Imports svt_hevc_tpu_torch from DIR (default: this repository), builds
that tree's kernels (into DIR/build), checks each against the tree's plain
version (torch.equal) and times, through the tree's own wrappers:

  - K1 sad_field at the three hme_search levels;
  - K2 mc_block on one MV field: luma and chroma, rounded and 14-bit,
    8-bit (a call every version of the wrapper takes).

Each with chip_smoke.py's two timings: device_ms (CUDA events around
R_LAUNCHES back-to-back launches, over the count) and call_ms (the
host-inclusive time of one wrapper call). To compare a change with its
parent commit on one card, unpack the parent into a git-ignored directory
and run parent, change, change, parent:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    for d in build/parent . . build/parent; do
        python3 tools/torch_kernel_times.py --root $d; done

Prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This repository's chip_smoke.py (not DIR's), for its timings and
    inputs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT,
                    help="tree whose svt_hevc_tpu_torch is timed")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _chip_smoke()
    from svt_hevc_tpu_torch.gpu import encode as genc
    from svt_hevc_tpu_torch.gpu import kernels as K
    if not K.__file__.startswith(root + os.sep):
        print(f"FAIL: imported {K.__file__}, not the tree at {root}",
              flush=True)
        return 1
    K.build_all()

    dev = torch.device("cuda")
    planes = cs._kernel_inputs(dev)
    (y0, cb0, _), _ = planes
    rows = {}
    for name, src, ref, r in cs.k1_levels(planes):
        a = (src, ref, 16, r)
        out = K.sad_field(*a)
        cs.check(torch.equal(out, K.sad_field_ref(*a)),
                 f"K1 {name} differs from plain")
        rows[f"sad_field {name}"] = {
            "device_ms": cs.device_ms(lambda: K.sad_field(*a)),
            "call_ms": cs.call_ms(lambda: K.sad_field(*a), 50),
            "bound_ms": cs.bound(*cs.k1_work(src, r))[0]}
    lim = (genc.PAD - 9) * 4
    mv8c = torch.from_numpy(cs.k2_fields(1, 1088 // 8, 1920 // 8)[0]).to(
        dev).clamp(-lim, lim)
    for comp, ext in (("luma", genc._ext_y(y0)), ("chroma",
                                                  genc._ext_c(cb0))):
        for rounded in (False, True):
            a = cs.k2_args(genc, comp, ext, mv8c, rounded, 8)
            cs.check(torch.equal(K.mc_block(*a), K.mc_block_ref(*a)),
                     f"K2 {comp} rounded={rounded} differs from plain")
            rows[f"mc_block {comp} rounded={rounded}"] = {
                "device_ms": cs.device_ms(lambda: K.mc_block(*a)),
                "call_ms": cs.call_ms(lambda: K.mc_block(*a), 50),
                "bound_ms": cs.bound(*cs.k2_work(ext, a[1:5], *a[5:7]))[0]}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"root": os.path.relpath(root, ROOT), "card": card,
                      "launches_per_sample": cs.R_LAUNCHES,
                      "kernels": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
