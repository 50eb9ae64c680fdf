"""How far host-bound encodes overlap on one GPU: N card encodes of
chip_smoke.py's 512x256 x5 variant clips (presets M6 and M10, and
hierarchical low-delay P) one after another in this process, then at
once in N spawned processes on the same card (each warmed up by a
one-picture encode first).

    python3 tools/torch_card_overlap.py [--n 2 3]

An encode of a small clip is a chain of small launches driven by one
host thread, with the card mostly idle, so the wall time of N concurrent
encodes over that of N serial ones says what chip_smoke.py's card worker
processes (CARD_WORKERS) gain. Prints the card and one JSON line: per N,
the serial and the concurrent wall seconds, their ratio, and each
encode's seconds and bytes (the same bytes both ways).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

CONFIGS = (dict(enc_mode=6), dict(enc_mode=10), dict(hierarchical_levels=2))


def encode(kw: dict, n: int = 5):
    """(seconds, bytes) of one card encode of make_frames(n, 512, 256,
    seed=11) under chip_smoke's small-clip config plus kw."""
    import torch
    torch.set_num_threads(1)
    frames = chip_smoke.make_frames(n, 512, 256, seed=11)
    t0 = time.perf_counter()
    hdr, aus = chip_smoke._encode(frames, 512, 256, "cuda", **kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0,
            len(hdr) + sum(len(a.data) for a in aus))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[2, 3],
                    choices=range(1, len(CONFIGS) + 1))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    encode({}, 2)                       # builds the kernels, warms up
    out = {"device": card, "runs": []}
    spawn = multiprocessing.get_context("spawn")
    for n in args.n:
        t0 = time.perf_counter()
        serial = [encode(kw) for kw in CONFIGS[:n]]
        t_serial = time.perf_counter() - t0
        with ProcessPoolExecutor(n, mp_context=spawn) as ex:
            list(ex.map(encode, [{}] * n, [1] * n))
            t0 = time.perf_counter()
            together = list(ex.map(encode, CONFIGS[:n]))
            t_together = time.perf_counter() - t0
        if [b for _, b in serial] != [b for _, b in together]:
            print(f"N={n}: the concurrent encodes' bytes differ",
                  file=sys.stderr)
            return 1
        out["runs"].append({"n": n, "serial_s": t_serial,
                            "concurrent_s": t_together,
                            "ratio": t_together / t_serial,
                            "serial": serial, "concurrent": together})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
