"""The comparison that decides a run's `correct`: the encoder's output held
against a plain decoder.

The decoder here (decoder/, core/, bitstream/ beside this file) is a
frozen copy of svt_hevc_tpu_torch's NumPy conformance decoder, taken at
commit 2a46a2c and cut to its decode path; it imports numpy only and
nothing of the program. It reads only the coded bytes. What it cannot
see, the decisions a valid stream carries, quality.py holds.

A picture is right when its access unit decodes, when every sample of the
three decoded planes equals the encoder's reconstruction (the picture the
encoder keeps as its reference, after DLF and SAO), when its slice header
and the stream's parameter sets say what the configuration states
(`expect`; each picture's slice type and CQP slice QP from structure.py),
and when the decoder's motion field of the picture (TMVP's collocated
source) equals the encoder's.

Decoding is sequential, and a 1080p picture takes about a second on one
host thread, so the pictures are decoded in contiguous chunks of decode
order, one to a worker process, which together cover every picture. A
chunk that starts at an IDR needs nothing but the bytes. Every other
chunk starts from the decoded picture buffer that one decode of the whole
stream holds as it begins the chunk's first picture, once that picture's
slice header has pruned it: the pictures that header's reference picture
set keeps (with reordering and several references, pictures further back
than the one before, and future anchors), each as the encoder's own
reconstruction and motion field, which the chunk that holds it checks,
and the POC state that the picture before left. The slice headers alone
give that buffer: the main process reads every picture's first slice
header in decode order, as the decoder would, and prunes and adds as it
does. So the chunks together equal one decode of the whole stream. The
motion field is checked at every picture.

Closed GOP only: a stream with reordering and several references (random
access, low-delay P or B, hierarchical or not) is judged as a whole
decode would judge it, but open-GOP random access (CRA refresh points
with RASL pictures) is not judged, and its parameter sets are marked
wrong.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ProcessPoolExecutor
import multiprocessing

import numpy as np

from .bitstream.bitwriter import ebsp_to_rbsp
from .bitstream.headers import parse_pps, parse_slice_header, parse_sps
from .bitstream.nal import NalUnitType, split_annexb
from .decoder.decoder import _PictureCtx
from .structure import picture_plan

_SLICES = (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP,
           NalUnitType.CRA_NUT, NalUnitType.TRAIL_R, NalUnitType.TRAIL_N,
           NalUnitType.RASL_R, NalUnitType.RASL_N)
_IDR = (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP)


def parameter_set_faults(param_sets: bytes, expect: dict) -> list[str]:
    """What the stream's SPS / PPS say against the configuration."""
    sps = pps = None
    for nal_type, ebsp in split_annexb(param_sets):
        if nal_type == NalUnitType.SPS_NUT:
            sps = parse_sps(ebsp_to_rbsp(ebsp))
        elif nal_type == NalUnitType.PPS_NUT:
            pps = parse_pps(ebsp_to_rbsp(ebsp))
    if sps is None or pps is None:
        return ["no SPS or PPS"]
    left, right, top, bottom = sps.conf_win
    swc = 2 if sps.chroma_format_idc in (1, 2) else 1
    shc = 2 if sps.chroma_format_idc == 1 else 1
    got = {
        "width": sps.width - swc * (left + right),
        "height": sps.height - shc * (top + bottom),
        "bit_depth": sps.bit_depth,
        "chroma_format": sps.chroma_format_idc,
        "ctb_size": 1 << sps.log2_ctb,
        "sao": sps.sao_enabled,
        "tmvp": sps.temporal_mvp,
        "deblocking": not pps.deblocking_disabled,
        "tiles": (pps.tile_columns, pps.tile_rows),
    }
    want = {k: expect[k] for k in got}
    want["tiles"] = tuple(want["tiles"])
    out = [f"{k}: stream {got[k]}, configuration {want[k]}"
           for k in got if got[k] != want[k]]
    if expect["open_gop"]:
        out.append("open-GOP random access is not judged by this check")
    return out


def slice_faults(hdr, pic: dict, expect: dict) -> list[str]:
    """What one slice header says against the configuration. pic: is_idr
    and want, the slice type and CQP slice QP (or None) that the
    configuration states for the picture."""
    out = []
    want_type, want_qp = pic["want"]
    if hdr.is_idr != pic["is_idr"]:
        out.append(f"IDR {hdr.is_idr}, expected {pic['is_idr']}")
    if hdr.slice_type != want_type:
        out.append(f"slice type {hdr.slice_type}, expected {want_type}")
    if hdr.deblock_disabled == expect["deblocking"]:
        out.append(f"deblocking disabled {hdr.deblock_disabled}")
    if not hdr.is_idr and hdr.temporal_mvp != expect["tmvp"]:
        out.append(f"slice TMVP {hdr.temporal_mvp}")
    if want_qp is not None and hdr.slice_qp != want_qp:
        out.append(f"slice QP {hdr.slice_qp}, CQP {want_qp}")
    lo, hi = expect["qp_range"]
    if not lo <= hdr.slice_qp <= hi:
        out.append(f"slice QP {hdr.slice_qp} outside [{lo}, {hi}]")
    return out


def motion_equal(a: dict, b: dict) -> bool:
    """Two TMVP motion fields alike: vectors, reference indices, POC, and
    the reference POCs of each list that some block uses (a P slice's
    list 1 is empty on one side and unused on both)."""
    if not (np.array_equal(a["mv"], b["mv"])
            and np.array_equal(a["ref_idx"], b["ref_idx"])
            and int(a["poc"]) == int(b["poc"])):
        return False
    used = np.asarray(a["ref_idx"]).reshape(-1, 2).max(0) >= 0
    return all(list(a["ref_pocs"][k]) == list(b["ref_pocs"][k])
               for k in range(2) if used[k])


class ChunkDecoder:
    """decoder.decode_stream's loop, one access unit at a time, which may
    start from a given decoded picture buffer (planes and motion by POC)
    and POC state instead of an IDR."""

    def __init__(self, param_sets: bytes):
        self.sps = self.pps = None
        self.dpb: dict = {}
        self.motion: dict = {}
        self.prev_lsb = self.prev_msb = 0
        for nal_type, ebsp in split_annexb(param_sets):
            self._param(nal_type, ebsp)

    def _param(self, nal_type, ebsp) -> None:
        if nal_type == NalUnitType.SPS_NUT:
            self.sps = parse_sps(ebsp_to_rbsp(ebsp))
        elif nal_type == NalUnitType.PPS_NUT:
            self.pps = parse_pps(ebsp_to_rbsp(ebsp))

    def seed(self, prev_lsb: int, prev_msb: int, refs: list[dict]) -> None:
        """The POC state and the buffer's pictures, {poc, planes, motion
        (or None)}, that a whole decode holds at this point."""
        self.dpb = {r["poc"]: [np.asarray(p, np.int32).copy()
                               for p in r["planes"]] for r in refs}
        self.motion = {r["poc"]: r["motion"] for r in refs
                       if r["motion"] is not None}
        self.prev_lsb, self.prev_msb = prev_lsb, prev_msb

    def slice_header(self, nal_type, ebsp):
        """One slice NAL's rbsp and header, its POC derived (and the POC
        state moved on) as the decoder does."""
        rbsp = ebsp_to_rbsp(ebsp)
        hdr = parse_slice_header(rbsp, int(nal_type), self.sps, self.pps)
        if not hdr.is_idr:
            max_lsb = 1 << self.sps.log2_max_poc_lsb
            lsb = hdr.poc
            if lsb < self.prev_lsb and self.prev_lsb - lsb >= max_lsb // 2:
                msb = self.prev_msb + max_lsb
            elif lsb > self.prev_lsb and lsb - self.prev_lsb > max_lsb // 2:
                msb = self.prev_msb - max_lsb
            else:
                msb = self.prev_msb
            hdr.poc = msb + lsb
            self.prev_lsb, self.prev_msb = lsb, msb
        else:
            self.prev_lsb = self.prev_msb = 0
        return rbsp, hdr

    def prune(self, nal_type, hdr) -> None:
        """A picture's first slice header empties the buffer (IDR) or
        keeps only its reference picture set."""
        if nal_type in _IDR:
            self.dpb.clear()
            self.motion.clear()
            return
        keep = ({hdr.poc - d for d in hdr.keep_neg}
                | {hdr.poc + d for d in hdr.keep_pos})
        for stale in [p for p in self.dpb if p not in keep]:
            del self.dpb[stale]
            self.motion.pop(stale, None)

    def decode(self, au: bytes):
        """Decode one access unit: (frame, motion, slice headers)."""
        cur, headers, out = None, [], None
        for nal_type, ebsp in split_annexb(au):
            if nal_type not in _SLICES:
                self._param(nal_type, ebsp)
                continue
            rbsp, hdr = self.slice_header(nal_type, ebsp)
            headers.append(hdr)
            if hdr.first_slice:
                if cur is not None:
                    raise ValueError("new picture before the previous ended")
                self.prune(nal_type, hdr)
                cur = _PictureCtx(hdr, self.sps, self.pps, self.dpb,
                                  self.motion)
            elif cur is None:
                raise ValueError("a slice without an open picture")
            cur.decode_slice(rbsp, hdr)
            if cur.done():
                frame, planes, poc = cur.finish()
                self.dpb[poc] = planes
                self.motion[poc] = cur.motion()
                out = (frame, self.motion[poc], headers)
                cur = None
        if out is None:
            raise ValueError("the access unit holds no whole picture")
        return out


def dpb_at(param_sets: bytes, pictures: list[dict], starts) -> dict:
    """{decode position a: (prev_lsb, prev_msb, positions)} for each a in
    starts that is not an IDR: the POC state before picture a's slice
    header, and {poc: decode position} of the pictures that a whole
    decode's buffer holds once a's first slice header has pruned it. Read
    from each picture's first slice header alone. A start past a header
    that does not parse gets nothing (its chunk then fails to decode, as
    the whole decode would)."""
    dec = ChunkDecoder(param_sets)
    starts, out = set(starts), {}
    for j, pic in enumerate(pictures):
        state = (dec.prev_lsb, dec.prev_msb)
        try:
            for nal_type, ebsp in split_annexb(pic["data"]):
                if nal_type in _SLICES:
                    _, hdr = dec.slice_header(nal_type, ebsp)
                    break
                dec._param(nal_type, ebsp)
            else:
                raise ValueError("no slice")
        except Exception:       # a fault of the stream, judged by its chunk
            break
        dec.prune(nal_type, hdr)
        if j in starts and nal_type not in _IDR:
            out[j] = (*state, dict(dec.dpb))
        dec.dpb[hdr.poc] = j
    return out


def check_chunk(task: dict) -> dict:
    """Decode one chunk and judge each of its pictures. task: param_sets,
    expect, seed (None, or {prev_lsb, prev_msb, refs: [{poc, planes,
    motion}]}) and pictures, a list of {idx, is_idr, want, data, planes,
    motion (the encoder's, or None)}."""
    t0 = time.perf_counter()
    dec = ChunkDecoder(task["param_sets"])
    if task["seed"] is not None:
        s = task["seed"]
        dec.seed(s["prev_lsb"], s["prev_msb"], s["refs"])
    verdicts = []
    broken = None
    for pic in task["pictures"]:
        faults = []
        if broken is not None:
            faults.append(f"not decodable after picture {broken}")
        else:
            try:
                frame, motion, headers = dec.decode(pic["data"])
            except Exception as e:      # a fault of the stream: judged
                broken = pic["idx"]
                faults.append(f"decode failed: {type(e).__name__}: {e}")
            else:
                for hdr in headers:
                    faults += slice_faults(hdr, pic, task["expect"])
                for name, got, want in zip(("Y", "Cb", "Cr"),
                                           (frame.y, frame.cb, frame.cr),
                                           pic["planes"]):
                    if got.shape != want.shape:
                        faults.append(f"{name} {got.shape} vs the "
                                      f"encoder's {want.shape}")
                        continue
                    bad = int(np.count_nonzero(got.astype(np.int32)
                                               != want.astype(np.int32)))
                    if bad:
                        faults.append(f"{name}: {bad} samples differ from "
                                      f"the encoder's reconstruction")
                if (pic["motion"] is not None
                        and not motion_equal(motion, pic["motion"])):
                    faults.append("motion field differs from the encoder's")
        verdicts.append({"idx": pic["idx"], "faults": faults})
    return {"verdicts": verdicts, "seconds": time.perf_counter() - t0}


def plan_chunks(n: int, workers: int) -> list[tuple[int, int]]:
    """[start, end) chunks that cover pictures 0..n-1, one per worker."""
    k = max(1, min(workers, n))
    bounds = [round(i * n / k) for i in range(k + 1)]
    return [(bounds[i], bounds[i + 1]) for i in range(k)]


def slice_qps(param_sets: bytes, pictures: list[dict]) -> list[int]:
    """The slice QP of each picture's first slice."""
    dec = ChunkDecoder(param_sets)
    out = []
    for pic in pictures:
        for nal_type, ebsp in split_annexb(pic["data"]):
            if nal_type in _SLICES:
                out.append(parse_slice_header(ebsp_to_rbsp(ebsp),
                                              int(nal_type), dec.sps,
                                              dec.pps).slice_qp)
                break
    return out


def rate_control_faults(param_sets, pictures, expect, lumas) -> dict:
    """{display index: fault} where the stream's QP is not the rate
    control's, worked out again from the source (lookahead.py)."""
    from .lookahead import rc_qps
    want = rc_qps(expect["rc"], lumas, pictures)
    got = slice_qps(param_sets, pictures)
    out = {p["idx"]: f"QP {g}, the rate control's {w}"
           for p, g, w in zip(pictures, got, want) if g != w}
    for p in pictures[len(want):]:
        out[p["idx"]] = "no lookahead window from the source"
    return out


def chunk_tasks(param_sets: bytes, pictures: list[dict], motions: dict,
                expect: dict, chunks) -> list:
    """check_chunk's task for each [start, end) chunk: its pictures, each
    with what the configuration states for it (structure.py), and the
    buffer and POC state a whole decode holds where it starts (dpb_at)."""
    plan = picture_plan(expect, [p["idx"] for p in pictures if p["is_idr"]])
    seeds = dpb_at(param_sets, pictures, [a for a, _ in chunks if a])
    tasks = []
    for a, b in chunks:
        seed = None
        if a in seeds:
            prev_lsb, prev_msb, held = seeds[a]
            seed = {"prev_lsb": prev_lsb, "prev_msb": prev_msb, "refs": [
                {"poc": poc, "planes": pictures[j]["planes"],
                 "motion": motions.get(pictures[j]["idx"])}
                for poc, j in held.items()]}
        pics = [dict(p, motion=motions.get(p["idx"]), want=plan(p["idx"]))
                for p in pictures[a:b]]
        tasks.append({"param_sets": param_sets, "expect": expect,
                      "seed": seed, "pictures": pics})
    return tasks


def check_stream(param_sets: bytes, pictures: list[dict], motions: dict,
                 expect: dict, workers: int | None = None,
                 lumas=None) -> dict:
    """Judge an encoded stream. pictures: every access unit in decode order,
    {idx, is_idr, poc, data, planes}; motions: the encoder's motion field
    by display index, where it has one; lumas: the source's lumas of every
    frame the encoder pulled, where the configuration has a lookahead rate
    control (expect["rc"]). Returns pictures_planned, pictures_checked,
    pictures_wrong, the first faults and the seconds."""
    t0 = time.perf_counter()
    if workers is None:
        workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    chunks = plan_chunks(len(pictures), workers)
    faults = [f"parameter sets: {f}"
              for f in parameter_set_faults(param_sets, expect)]
    tasks = chunk_tasks(param_sets, pictures, motions, expect, chunks)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, len(tasks)),
                             mp_context=ctx) as pool:
        running = pool.map(check_chunk, tasks)
        qp_faults = (rate_control_faults(param_sets, pictures, expect, lumas)
                     if expect.get("rc") else {})
        results = list(running)
    verdicts = [v for r in results for v in r["verdicts"]]
    for v in verdicts:
        if v["idx"] in qp_faults:
            v["faults"].append(qp_faults[v["idx"]])
    wrong = [v for v in verdicts if v["faults"]]
    if faults:          # wrong parameter sets make every picture wrong
        wrong = verdicts
    return {
        "pictures_planned": len(pictures),
        "pictures_checked": len(verdicts),
        "pictures_wrong": len(wrong),
        "wrong_idx": [v["idx"] for v in wrong],
        "chunks": chunks,
        "faults": faults + [f"picture {v['idx']}: {'; '.join(v['faults'])}"
                            for v in wrong if v["faults"]][:8],
        "worker_seconds": [r["seconds"] for r in results],
        "seconds": time.perf_counter() - t0,
    }
