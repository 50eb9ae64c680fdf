"""Encoder pipeline on the card: frames -> Annex-B HEVC byte stream.

Port of svt_hevc_tpu/pipeline/encoder.py: CQP, and VBR with or without
lookahead; low-delay P (IPPP, and its hierarchical form), low-delay B,
and random access (hierarchical B, closed GOP with IDR refresh or open
GOP with CRA refresh and RASL pictures; CQP, as in the JAX package);
8-bit and 10-bit, 4:2:0, 4:2:2 and 4:4:4; tiles (with motion-constrained
tile sets and one slice per tile); presets M0-M11; adaptive QP
(sharpness, bit-rate reduction, segment overrides); denoising;
constrained intra; speed control (a dynamic preset) and checkpoint /
restore of the streaming state.

Two paths, chosen per picture as in the JAX package. The fused device
paths (4:2:0, one tile, no RD, no QP map, OIS presets; P and B pictures
also not under constrained intra): I pictures take
gpu.encode.fast_i_fused_dev, P pictures gpu.me.hme_search then
gpu.encode.fast_p_fused_dev, B pictures one hme_search per distinct
reference then gpu.encode.fast_b_fused_dev; the host walk and the native
emitter write the syntax. Reconstructions stay on the device as later
pictures' references (the device DPB), each picture's decided motion
stays on the device as a later P picture's TMVP source, and in
low-delay CQP structures a picture's download and host walk overlap the
next picture's device work (one frame deep). Every other picture takes
the host path: the numpy CTU coder (core/ctu.py, core/rdo.py) in two
passes over the tiles, fed by device helpers — the motion seed from
hme_search (kernel K1), the open-loop intra search maps
(gpu.analysis.ois_packed) and the per-CTB activity of the QP map
(gpu.analysis.ctb_activity). Denoising (gpu.analysis.denoise_plane)
runs before either path. Random access pictures, host-path pictures, and
every picture under VBR or speed control, are encoded one at a time, as
in the JAX package.

Mesh picture parallelism (several devices) raises NotImplementedError.
"""

from __future__ import annotations

import copy
import itertools
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream import sei
from ..bitstream.cabac import CabacEncoder
from ..bitstream.contexts import init_contexts
from ..bitstream.headers import (tile_grid, write_pps, write_slice_header,
                                 write_sps, write_vps)
from ..bitstream.nal import NalUnitType, wrap_nal
from ..bitstream.recorder import CabacRecorder, NullCoder
from ..config import EncoderConfig
from ..core.ctu import CtuEncoder, PictureState
from ..core.deblock import deblock_picture
from ..core.rdo import RdSearch, lambda_sse
from ..core.sao import apply_sao, derive_sao_params, encode_sao_ctb
from ..io.yuv import Frame
from ..native import cabac_encode_ops
from ..preset import derive_preset


def _apply_segment_ov(base: np.ndarray, sov: np.ndarray,
                      lo: int, hi: int) -> np.ndarray:
    """Merge per-CTB segment overrides into a QP map: a direct QP wins
    over a delta QP, which wins over a deblock-density delta; all are
    clipped to [lo, hi]."""
    from ..config import (SEG_DENSITY_DEBLOCK_OV, SEG_DENSITY_QP_OV,
                          SEG_QP_OV_DELTA, SEG_QP_OV_DIRECT)
    sov = np.asarray(sov)
    if sov.shape[:2] != base.shape:
        raise ValueError(f"segment_ov grid {sov.shape[:2]} != CTB grid "
                         f"{base.shape}")
    flags = sov[..., 0].astype(np.int32)
    qp_ov = sov[..., 1].astype(np.int32)
    db_ov = sov[..., 2].astype(np.int32)
    out = base.astype(np.int32).copy()
    direct = ((flags & SEG_DENSITY_QP_OV) != 0) & \
             ((flags & SEG_QP_OV_DIRECT) != 0)
    delta = ((flags & SEG_DENSITY_QP_OV) != 0) & \
            ((flags & SEG_QP_OV_DELTA) != 0) & ~direct
    dbl = ((flags & SEG_DENSITY_DEBLOCK_OV) != 0) & ~direct & ~delta
    out = np.where(direct, qp_ov, out)
    out = np.where(delta, out + np.clip(qp_ov, -25, 25), out)
    out = np.where(dbl, out + np.clip(db_ov, -25, 25), out)
    return np.clip(out, lo, hi)


def pad_plane(plane: np.ndarray, w: int, h: int) -> np.ndarray:
    """Edge-replicate a plane to coded dimensions."""
    out = np.empty((h, w), np.int32)
    ph, pw = plane.shape
    out[:ph, :pw] = plane
    if pw < w:
        out[:ph, pw:] = plane[:, -1:]
    if ph < h:
        out[ph:, :] = out[ph - 1:ph, :]
    return out


def finalize_cabac(rec: CabacRecorder, init_ctx: list[int]) -> bytes:
    """Arithmetic-code a recorded op stream: native C core when available,
    else replay through the Python reference backend (bit-identical)."""
    data = cabac_encode_ops(rec.op_array(), init_ctx)
    if data is not None:
        return data
    enc = CabacEncoder(list(init_ctx))
    for kind, a, v in rec.iter_ops():
        if kind == 0:
            enc.encode_bin(a, v)
        elif kind == 1:
            enc.encode_bypass(v)
        elif kind == 2:
            enc.encode_bypass_bins(v, a)
        else:
            enc.encode_terminate(v)
    enc.finish()
    return enc.data


def dev_me_field(src_y: np.ndarray, ref_y: np.ndarray,
                 device) -> np.ndarray:
    """Per-16x16-block quarter-pel MV field of gpu.me.hme_search (kernel
    K1) on `device`, both planes edge-padded to the 64-aligned grid: the
    host path's motion seed where the picture has no device context (the
    counterpart of svt_hevc_tpu.pipeline.encoder.tpu_me_field). Returns
    the (H64//16, W64//16, 2) int32 [mvx, mvy] field on the host."""
    from ..gpu.me import hme_search
    h, w = src_y.shape
    hh, ww = (h + 63) // 64 * 64, (w + 63) // 64 * 64
    sp = torch.from_numpy(pad_plane(src_y, ww, hh)).to(device)
    rp = torch.from_numpy(pad_plane(ref_y, ww, hh)).to(device)
    return hme_search(sp, rp)[0].cpu().numpy()


def slice_unsupported(cfg: EncoderConfig) -> str | None:
    """Why cfg lies outside the port (naming the later slice that brings
    it), or None when this package encodes it."""
    if cfg.mesh_pictures:
        return "mesh picture parallelism comes with the multi-device slice"
    return None


class _LazyPlanes:
    """List-like [y, cb, cr] post-filter recon planes (coded dims, int32)
    downloaded from the device tensors on first access."""

    def __init__(self, rec_dev, cw: int, ch: int):
        self._dev = rec_dev
        self._cw, self._ch = cw, ch
        self._v = None

    def _get(self):
        if self._v is None:
            y, cb, cr = (p.cpu().numpy() for p in self._dev)
            cw, ch = self._cw, self._ch
            self._v = [y[:ch, :cw].astype(np.int32),
                       cb[:ch // 2, :cw // 2].astype(np.int32),
                       cr[:ch // 2, :cw // 2].astype(np.int32)]
        return self._v

    def __getitem__(self, i):
        return self._get()[i]

    def __iter__(self):
        return iter(self._get())

    def __len__(self):
        return 3


class _LazyFrame:
    """Frame-like recon view over _LazyPlanes: materializes a real Frame
    (display crop + dtype) on first attribute access."""

    def __init__(self, planes: _LazyPlanes, w: int, h: int, wc: int,
                 hc: int, dt):
        object.__setattr__(self, "_spec", (planes, w, h, wc, hc, dt))
        object.__setattr__(self, "_frame", None)

    def _materialize(self) -> Frame:
        if self._frame is None:
            planes, w, h, wc, hc, dt = self._spec
            object.__setattr__(self, "_frame", Frame(
                y=planes[0][:h, :w].astype(dt),
                cb=planes[1][:hc, :wc].astype(dt),
                cr=planes[2][:hc, :wc].astype(dt)))
        return self._frame

    def __getattr__(self, name):
        return getattr(self._materialize(), name)


@dataclass
class EncodedPicture:
    nal_bytes: bytes          # slice NAL (Annex-B)
    recon: Frame              # cropped reconstruction (possibly lazy)
    poc: int = 0
    ref_planes: list | None = None   # full-plane post-filter recon (DPB)


@dataclass
class PendingPicture:
    """A dispatched-but-not-finalized picture: its device work is queued;
    recon/DPB handles already exist so the NEXT frame can be dispatched
    against it, and finish() downloads + walks + assembles the
    bitstream."""
    poc: int
    recon: object
    ref_planes: object
    _finish: object
    _pic: EncodedPicture | None = None

    def finish(self) -> EncodedPicture:
        if self._pic is None:
            self._pic = self._finish()
        return self._pic


@dataclass
class EncodedAu:
    """One coded access unit from the streaming API."""

    data: bytes               # slice NAL(s) + per-AU SEI (Annex-B)
    recon: Frame
    poc: int
    slice_type: int           # 2 I, 1 P, 0 B
    is_idr: bool
    display_idx: int
    decode_idx: int


class Encoder:
    """HEVC encoder (CQP or VBR; low-delay P or B, random access) whose
    pixel stages and device helpers run on the card.

    device: None (the default) or "cuda" runs on the card and raises
    where there is no CUDA device; "cpu" runs every stage with the
    kernels' plain PyTorch versions (the tests' mode)."""

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg.validate()
        why = slice_unsupported(self.cfg)
        if why is not None:
            raise NotImplementedError(why)
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "encoder on the CPU")
        self._frame_idx = 0
        self._ref_planes = None      # previous picture planes (post-filter)
        self._ref_poc = 0
        # (poc, w64, h64) -> device (y, cb, cr) padded int32 reference
        # planes, so P pictures never re-upload references
        self._dev_dpb: dict = {}
        # poc -> motion field of coded reference pictures (TMVP
        # collocated data for the host syntax walk)
        self._ref_motion: dict = {}
        # (poc, w64, h64) -> (col16_mv, col16_valid, ref_poc_l0) device
        # tensors: each picture's decided motion, 16x16-compressed, chained
        # into the next picture's dense MD as the TMVP merge candidate
        self._dev_motion: dict = {}
        self._dev_motion_cap = 6
        self._poc_base = 0
        # dynamic preset of speed control (set_speed_control): enc_mode
        # floats in [cfg.enc_mode, 11], adjusted after each picture
        self._dyn_enc_mode: int | None = None
        self._speed_target_fps: float | None = None
        # streaming state a checkpoint() carries across: the scene-cut
        # context, the per-layer references and the rate-control state
        self._ckpt_prev_y = None
        self._prev_src_y = None      # previous padded source luma (the
        #                              QPM stationary-edge context)
        # the pipelined picture not yet final (PendingPicture): a host-path
        # picture finishes it first
        self._inflight = None
        self._ckpt_ll_last: dict = {}
        self._ckpt_rc_state: dict | None = None
        self._resuming = False
        self.last_rc = None

    # ------------------------------------------------- checkpoint / resume

    def checkpoint(self) -> dict:
        """Snapshot of the streaming state after a completed
        encode_pictures() segment: frame counter, POC base, the reference
        planes per temporal layer (the DPB), the scene-cut context, the
        QPM's previous source luma, the rate-control state (deep-copied)
        and the TMVP motion, host and device. Plain numpy and Python data, picklable and device-free,
        in the JAX package's layout: a fresh Encoder restored from it (on
        any device, and from a JAX package checkpoint too) continues the
        stream byte for byte."""
        rc_state = None
        if self.last_rc is not None:
            rc_state = copy.deepcopy({k: v for k, v in
                                      self.last_rc.__dict__.items()
                                      if k != "cfg"})
        return {
            "frame_idx": self._frame_idx,
            "poc_base": self._poc_base,
            "ll_last": {
                layer: (idx, tuple(np.asarray(p) for p in planes), poc)
                for layer, (idx, planes, poc) in self._ckpt_ll_last.items()},
            "prev_y": (None if self._ckpt_prev_y is None
                       else np.asarray(self._ckpt_prev_y)),
            # the QPM content classes' temporal context (the JAX
            # package's checkpoint leaves it out; restoring one gives
            # None, as there)
            "prev_src_y": (None if self._prev_src_y is None
                           else np.array(self._prev_src_y)),
            "rc": rc_state,
            "ref_planes": (None if self._ref_planes is None
                           else tuple(np.asarray(p)
                                      for p in self._ref_planes)),
            "ref_poc": self._ref_poc,
            "ref_motion": {k: {kk: (vv.copy() if isinstance(vv, np.ndarray)
                                    else copy.deepcopy(vv))
                               for kk, vv in v.items()}
                           for k, v in self._ref_motion.items()},
            "dev_motion": {k: (v[0].cpu().numpy(), v[1].cpu().numpy(),
                               v[2])
                           for k, v in self._dev_motion.items()},
        }

    def restore(self, ckpt: dict) -> None:
        """Restore a checkpoint() snapshot into this (fresh) encoder; the
        device motion goes to this encoder's device, and the next
        encode_pictures() call continues the stream."""
        self._frame_idx = int(ckpt["frame_idx"])
        self._poc_base = int(ckpt["poc_base"])
        self._ckpt_ll_last = {
            layer: (idx, tuple(planes), poc)
            for layer, (idx, planes, poc) in ckpt["ll_last"].items()}
        self._ckpt_prev_y = ckpt["prev_y"]
        self._prev_src_y = ckpt.get("prev_src_y")
        self._ckpt_rc_state = copy.deepcopy(ckpt.get("rc"))
        self._ref_planes = (None if ckpt["ref_planes"] is None
                            else tuple(ckpt["ref_planes"]))
        self._ref_poc = ckpt["ref_poc"]
        self._ref_motion = {k: dict(v)
                            for k, v in ckpt["ref_motion"].items()}
        self._dev_motion = {
            k: (torch.from_numpy(np.array(v[0], np.int32)).to(self.device),
                torch.from_numpy(np.array(v[1], bool)).to(self.device),
                v[2])
            for k, v in ckpt["dev_motion"].items()}
        self._resuming = True

    def set_speed_control(self, target_fps: float) -> None:
        """Enable dynamic-preset speed control toward a target encode
        rate; enc_mode then floats in [cfg.enc_mode, 11]."""
        self._speed_target_fps = target_fps
        self._dyn_enc_mode = self.cfg.enc_mode

    def _flush_inflight(self) -> None:
        """Finish the pipelined picture in flight (a host-path picture
        needs its final motion field as the TMVP source)."""
        if self._inflight is not None:
            self._inflight.finish()
            self._inflight = None

    def _ois_maps(self, y_plane) -> dict:
        """The open-loop intra search on the encoder's device: {n:
        (mode_map, cost_map)} numpy int32 maps for n in 4/8/16/32, fetched
        in one download (gpu.analysis.ois_packed). y_plane: a host plane
        (padded to the 64-aligned grid and uploaded here) or the 64-aligned
        device plane the frame's upload already made."""
        from ..gpu.analysis import ois_packed
        from ..gpu.encode import unpack
        if isinstance(y_plane, np.ndarray):
            h, w = y_plane.shape
            hh, ww = (h + 63) // 64 * 64, (w + 63) // 64 * 64
            dev = torch.from_numpy(pad_plane(y_plane, ww, hh)).to(
                self.device)
        else:
            hh, ww = y_plane.shape
            dev = y_plane
        specs = []
        for n in (4, 8, 16, 32):
            specs.append((f"mode{n}", (hh // n, ww // n), np.int32))
            specs.append((f"cost{n}", (hh // n, ww // n), np.int32))
        got = unpack(ois_packed(dev).cpu().numpy(), specs)
        return {n: (got[f"mode{n}"], got[f"cost{n}"])
                for n in (4, 8, 16, 32)}

    def _denoise(self, frame: Frame) -> Frame:
        """Source denoising on the encoder's device
        (gpu.analysis.denoise_plane): the luma's noise class decides; a
        clean luma returns the frame as it is, else all three planes are
        filtered (a new Frame of the three planes only, as in the JAX
        package)."""
        from ..gpu import encode as genc
        from ..gpu.analysis import denoise_plane
        maxval = (1 << self.cfg.bit_depth) - 1

        def up(p):
            p = np.asarray(p)
            if p.dtype != np.uint8:
                p = p.astype(np.int32)
            return torch.from_numpy(np.ascontiguousarray(p)).to(self.device)

        with genc.stage("pre.denoise"):
            y, sigma = denoise_plane(up(frame.y), maxval=maxval)
            dt = frame.y.dtype
            if float(sigma) < 0.004 * maxval:
                return frame
            cb, _ = denoise_plane(up(frame.cb), maxval=maxval)
            cr, _ = denoise_plane(up(frame.cr), maxval=maxval)
            return Frame(y=y.cpu().numpy().astype(dt),
                         cb=cb.cpu().numpy().astype(dt),
                         cr=cr.cpu().numpy().astype(dt))

    def _derive_qp_map(self, y_plane: np.ndarray, base_qp: int,
                       frame=None) -> np.ndarray:
        """Per-CTB QP from the spatial activity (gpu.analysis.ctb_activity
        on the encoder's device): textured CTBs take a higher QP, and
        under improve_sharpness smooth ones a lower QP; with the frame at
        hand the content classes (grass / skin / dark / stationary edge,
        pipeline/content_class.py) refine the map, else dark CTBs take one
        QP less; bit_rate_reduction biases the map upward."""
        from ..gpu.analysis import ctb_activity
        cfg = self.cfg
        ctb = cfg.ctb_size
        hh = (y_plane.shape[0] + ctb - 1) // ctb * ctb
        ww = (y_plane.shape[1] + ctb - 1) // ctb * ctb
        yp = pad_plane(y_plane.astype(np.int32), ww, hh)
        act = ctb_activity(torch.from_numpy(yp).to(self.device),
                           ctb).cpu().numpy()
        act = np.maximum(act, 1.0)
        gmean = float(np.exp(np.log(act).mean()))
        delta = np.round(1.5 * np.log2(act / gmean))
        lo = -3 if cfg.improve_sharpness else 0
        delta = np.clip(delta, lo, 3)
        if cfg.improve_sharpness and frame is not None:
            from .content_class import classify_ctbs, qp_class_delta
            cwc = ww * frame.cb.shape[1] // y_plane.shape[1]
            chc = hh * frame.cb.shape[0] // y_plane.shape[0]
            classes = classify_ctbs(
                yp,
                pad_plane(np.asarray(frame.cb, np.int32), cwc, chc),
                pad_plane(np.asarray(frame.cr, np.int32), cwc, chc),
                ctb, activity=act, prev_y=self._prev_src_y,
                bit_depth=cfg.bit_depth)
            self._prev_src_y = yp
            self.last_classes = classes
            delta = delta + qp_class_delta(classes)
        elif cfg.improve_sharpness:
            # dark-area protection: banding in dark regions is highly
            # visible, so spend more bits there
            means = yp.reshape(hh // ctb, ctb, ww // ctb, ctb).mean((1, 3))
            delta = np.where(means < 0.2 * (1 << cfg.bit_depth),
                             delta - 1, delta)
        if cfg.bit_rate_reduction:
            delta += 1
        return np.clip(base_qp + delta, 1, 51).astype(np.int32)

    def _col_for(self, col_poc):
        """Collocated motion dict for TMVP, or None. A missing entry for a
        requested collocated POC is an encoder ordering bug."""
        if col_poc is None:
            return None
        ent = self._ref_motion.get(col_poc)
        if ent is None:
            raise RuntimeError(
                f"TMVP collocated motion for POC {col_poc} not registered "
                "(motion-registration/flush ordering bug)")
        return dict(ent, from_l0=True)

    def _frame_is_idr(self, idx: int) -> bool:
        ip = self.cfg.intra_period
        if idx == 0 or ip == 0:
            return True
        if ip < 0:
            return False
        return idx % (ip + 1) == 0

    @staticmethod
    def _scene_cut(prev_y: np.ndarray, cur_y: np.ndarray) -> bool:
        """Region-histogram scene-change detector."""
        h, w = cur_y.shape
        rh, rw = max(h // 4, 1), max(w // 4, 1)
        votes = 0
        regions = 0
        shift = 3 if cur_y.dtype == np.uint8 else 5   # 32 histogram bins
        for ry in range(0, h - rh + 1, rh):
            for rx in range(0, w - rw + 1, rw):
                a = np.bincount(prev_y[ry:ry + rh, rx:rx + rw].ravel() >> shift,
                                minlength=32)
                b = np.bincount(cur_y[ry:ry + rh, rx:rx + rw].ravel() >> shift,
                                minlength=32)
                ahd = np.abs(a - b).sum()
                regions += 1
                if ahd > 0.6 * rh * rw:
                    votes += 1
        return regions > 0 and votes > regions // 2

    def headers(self) -> bytes:
        cfg = self.cfg
        out = (wrap_nal(NalUnitType.VPS_NUT, write_vps(cfg))
               + wrap_nal(NalUnitType.SPS_NUT, write_sps(cfg))
               + wrap_nal(NalUnitType.PPS_NUT, write_pps(cfg)))
        msgs = [sei.write_active_parameter_sets()]
        if cfg.max_cll or cfg.max_fall:
            msgs.append(sei.write_content_light_level(cfg.max_cll, cfg.max_fall))
        if cfg.mastering_display is not None:
            md = cfg.mastering_display
            msgs.append(sei.write_mastering_display(
                [(md[0], md[1]), (md[2], md[3]), (md[4], md[5])],
                (md[6], md[7]), md[8], md[9]))
        if cfg.use_recovery_point_sei:
            msgs.append(sei.write_recovery_point(0))
        if cfg.constrained_motion_tiles:
            msgs.append(sei.write_temporal_mcts())
        out += wrap_nal(NalUnitType.PREFIX_SEI_NUT, sei.sei_rbsp(msgs))
        return out

    def _hrd_sei(self, is_idr: bool, dpb_output_delay: int = 0) -> bytes:
        """Per-AU HRD timing SEIs: buffering_period at each IDR,
        pic_timing on every picture."""
        from ..bitstream.headers import hrd_rate_size
        msgs = []
        if is_idr or not hasattr(self, "_au_since_bp"):
            rate, size = hrd_rate_size(self.cfg)
            delay = int(90000 * 0.9 * size / rate)
            offset = int(90000 * size / rate) - delay
            msgs.append(sei.write_buffering_period(delay, offset))
            self._au_since_bp = 0
        msgs.append(sei.write_pic_timing(max(self._au_since_bp - 1, 0),
                                         dpb_output_delay))
        self._au_since_bp += 1
        return wrap_nal(NalUnitType.PREFIX_SEI_NUT, sei.sei_rbsp(msgs))

    def encode_frame(self, frame: Frame, *, split_policy=None,
                     part_nxn_policy=None, rd: bool | None = None,
                     is_idr: bool | None = None, poc: int = 0,
                     qp: int | None = None, slice_type: int | None = None,
                     refs_l0=None, refs_l1=None,
                     qp_map: np.ndarray | None = None,
                     non_ref: bool = False, retain_pocs=None,
                     pipelined: bool = False, nal_type_override=None):
        """Encode one picture: slice_type 2 (I: an IDR when is_idr, else a
        CRA that keeps the DPB), 1 (P) or 0 (B); None derives I or P from
        is_idr. refs_l0/refs_l1: [(planes, poc)] per list (L0 None: the
        previous picture; a B picture without L1 takes L1 = L0, low-delay
        B). rd: full RD mode decision (None: the preset's). split_policy /
        part_nxn_policy: test policies of the CTU coder. qp_map: explicit
        per-CTB QP grid (overrides the derived QPM map). non_ref: a
        picture no other picture references (kept out of the device DPB
        and the TMVP caches). retain_pocs: POCs that future pictures still
        reference, signalled in the RPS with used_by_curr_pic=0.
        nal_type_override: the NAL unit type (CRA, RASL) where the caller
        sets it. Returns an EncodedPicture, or a PendingPicture when
        pipelined and the picture took a fused device path."""
        from ..gpu import encode as genc
        from ..gpu.me import hme_search
        from .fast_path import run_fast_b, run_fast_i, run_fast_p

        cfg = self.cfg
        if cfg.enable_denoise:
            frame = self._denoise(frame)
        feat = derive_preset(self._dyn_enc_mode if self._dyn_enc_mode
                             is not None else cfg.enc_mode)
        if rd is None:
            rd = feat.rd_mode_decision
        if is_idr is None:
            is_idr = self._ref_planes is None and refs_l0 is None
        if qp is None:
            qp = cfg.qp
        if slice_type is None:
            slice_type = 2 if is_idr else 1
        if not is_idr and refs_l0 is None and slice_type != 2:
            refs_l0 = [(self._ref_planes, self._ref_poc)]
        if slice_type == 0 and not refs_l1:
            refs_l1 = list(refs_l0)          # low-delay B: L1 = L0
        init_type = {2: 0, 1: 1, 0: 2}[slice_type]
        kind = {2: "i", 1: "p", 0: "b"}[slice_type]
        # TMVP collocated picture: list-0 ref 0 (collocated_from_l0 is
        # signalled 1 for B slices)
        col_poc = (refs_l0[0][1]
                   if cfg.tmvp and not is_idr and refs_l0
                   and slice_type != 2 else None)
        cw, ch = cfg.coded_width, cfg.coded_height
        cw_c, ch_c = cw // cfg.sub_width_c, ch // cfg.sub_height_c
        src = [
            pad_plane(frame.y.astype(np.int32), cw, ch),
            pad_plane(frame.cb.astype(np.int32), cw_c, ch_c),
            pad_plane(frame.cr.astype(np.int32), cw_c, ch_c),
        ]
        ctb = cfg.ctb_size
        n_ctb_x = (cw + ctb - 1) // ctb
        n_ctb_y = (ch + ctb - 1) // ctb
        # tile partitioning, CTUs in tile-scan order
        col_bd, row_bd = tile_grid(n_ctb_x, n_ctb_y,
                                   cfg.tile_columns, cfg.tile_rows)
        tiles = []       # [(ctb_order, left_col, top_row, pixel_rect)]
        for tr in range(cfg.tile_rows):
            for tc in range(cfg.tile_columns):
                order = [(cx * ctb, cy * ctb)
                         for cy in range(row_bd[tr], row_bd[tr + 1])
                         for cx in range(col_bd[tc], col_bd[tc + 1])]
                rect = (col_bd[tc] * ctb, row_bd[tr] * ctb,
                        min(col_bd[tc + 1] * ctb, cw),
                        min(row_bd[tr + 1] * ctb, ch))
                tiles.append((order, col_bd[tc], row_bd[tr], rect))
        last_xy = tiles[-1][0][-1]
        mcts = cfg.constrained_motion_tiles
        tile_edges_x = [min(col_bd[i] * ctb, cw)
                        for i in range(1, cfg.tile_columns)]
        tile_edges_y = [min(row_bd[i] * ctb, ch)
                        for i in range(1, cfg.tile_rows)]

        # per-CTB QP map: an explicit map, else the QPM map when a QPM tool
        # asks for it; segment overrides go over either (or a flat map);
        # under adaptive QP without either, a flat map (cu_qp_delta is in
        # the PPS for the whole stream, so every picture codes deltas)
        if qp_map is None and (cfg.improve_sharpness
                               or cfg.bit_rate_reduction):
            with genc.stage(f"{kind}.qp_map"):
                qp_map = self._derive_qp_map(np.asarray(frame.y), qp,
                                             frame=frame)
        if frame.segment_ov is not None:
            if not cfg.segment_ov_enabled:
                raise ValueError("Frame.segment_ov requires "
                                 "segment_ov_enabled=True in the config")
            base = (qp_map if qp_map is not None
                    else np.full((n_ctb_y, n_ctb_x), qp, np.int32))
            qp_map = _apply_segment_ov(base, frame.segment_ov,
                                       cfg.min_qp_allowed,
                                       cfg.max_qp_allowed)
        if qp_map is None and cfg.adaptive_qp:
            qp_map = np.full((n_ctb_y, n_ctb_x), qp, np.int32)

        def new_state():
            s = PictureState(cw, ch, qp, cfg.ctb_log2, cfg.bit_depth,
                             chroma_format=cfg.chroma_format)
            s.constrained_intra = cfg.constrained_intra
            s.max_tt_depth_inter = 2     # matches the SPS (write_sps)
            if mcts:
                s.filter_across_tiles = False
                s.tile_edges_x = tile_edges_x
                s.tile_edges_y = tile_edges_y
            if qp_map is not None:
                s.enable_cu_qp_delta(qp_map)
            if not is_idr and refs_l0:      # a CRA has no reference lists
                s.slice_type = slice_type
                s.ref_planes = [[r[0] for r in refs_l0],
                                [r[0] for r in (refs_l1 or [])]]
                s.ref_pocs = [[r[1] for r in refs_l0],
                              [r[1] for r in (refs_l1 or [])]]
                s.poc = poc
            return s

        # ---- device context (4:2:0, one tile, no test policies): ship the
        # source once and keep the reference planes device-resident
        # between frames; every device stage reads these tensors
        fast_capable = (cfg.chroma_format == 1
                        and cfg.bit_depth in (8, 10)
                        and len(tiles) == 1 and not mcts
                        and split_policy is None
                        and part_nxn_policy is None)
        w64, h64 = (cw + 63) // 64 * 64, (ch + 63) // 64 * 64
        dt = np.uint8 if cfg.bit_depth == 8 else np.uint16
        src_dev = ref_dev = ref1_dev = None
        single_ref = (not is_idr and refs_l0 is not None
                      and len(refs_l0) == 1 and not refs_l1)
        b_pair = (not is_idr and slice_type == 0
                  and refs_l0 is not None and len(refs_l0) == 1
                  and refs_l1 is not None and len(refs_l1) == 1)
        if fast_capable:
            def dev_ref(entry):
                """A reference's device planes: the device DPB's, else (an
                evicted reference) uploaded again from its host planes."""
                got = self._dev_dpb.get((entry[1], w64, h64))
                if got is None:
                    rp = entry[0]
                    got = genc.prep_planes(rp[0].astype(dt),
                                           rp[1].astype(dt),
                                           rp[2].astype(dt), w64, h64,
                                           self.device)
                return got

            with genc.stage(f"{kind}.upload"):
                src_dev = genc.prep_planes(frame.y, frame.cb, frame.cr,
                                           w64, h64, self.device)
            if single_ref:
                ref_dev = dev_ref(refs_l0[0])
            elif b_pair:
                ref_dev = dev_ref(refs_l0[0])
                ref1_dev = (ref_dev if refs_l1[0][1] == refs_l0[0][1]
                            else dev_ref(refs_l1[0]))

        # ---- the fused device paths: no RD, no QP map, OIS presets, and
        # (P/B) no constrained intra; everything else takes the host path
        use_fast = (fast_capable and slice_type == 1 and not rd
                    and single_ref and qp_map is None and feat.ois_intra
                    and not cfg.constrained_intra)
        use_fast_b = (fast_capable and b_pair and not rd
                      and qp_map is None and feat.ois_intra
                      and not cfg.constrained_intra)
        use_fast_i = (fast_capable and slice_type == 2 and not rd
                      and qp_map is None and feat.ois_intra)

        me_seed = mv_dev = mv1_dev = None
        if not is_idr and slice_type != 2:
            if ref_dev is not None:
                with genc.stage(f"{kind}.hme_search"):
                    mv_dev = hme_search(src_dev[0], ref_dev[0])[0]
                if ref1_dev is ref_dev:
                    mv1_dev = mv_dev
                elif ref1_dev is not None:
                    with genc.stage(f"{kind}.hme_search"):
                        mv1_dev = hme_search(src_dev[0], ref1_dev[0])[0]
                if not (use_fast or use_fast_b):
                    me_seed = mv_dev.cpu().numpy()
            else:
                with genc.stage(f"{kind}.dev_me_field"):
                    me_seed = dev_me_field(src[0], refs_l0[0][0][0],
                                           self.device)

        # open-loop intra search maps for the host path's MD shortlist at
        # OIS presets (the fused paths run it inside)
        ois = None
        if feat.ois_intra and not (use_fast or use_fast_i or use_fast_b):
            with genc.stage(f"{kind}.ois_maps"):
                ois = self._ois_maps(src[0] if src_dev is None
                                     else src_dev[0])

        rec_dev = packed = lv_dev = substreams = None
        st = None
        if use_fast or use_fast_i or use_fast_b:
            st = new_state()
            if use_fast_i:
                packed, rec_dev, mot_dev, lv_dev = run_fast_i(
                    cfg, feat, st, qp, src_dev)
            elif use_fast_b:
                packed, rec_dev, mot_dev, lv_dev = run_fast_b(
                    cfg, feat, st, qp, mv_dev, mv1_dev, src_dev, ref_dev,
                    ref1_dev)
            else:
                # device-resident TMVP collocated motion of the L0
                # reference + its POC distances (8.5.3.2.8 tb/td)
                col_ent = (self._dev_motion.get((col_poc, w64, h64))
                           if col_poc is not None else None)
                col_dev = None
                tb = td = 1
                if col_ent is not None:
                    col_dev = (col_ent[0], col_ent[1])
                    tb = poc - refs_l0[0][1]
                    td = (col_poc - col_ent[2]
                          if col_ent[2] is not None else tb)
                packed, rec_dev, mot_dev, lv_dev = run_fast_p(
                    cfg, feat, st, qp, mv_dev, src_dev, ref_dev, col_dev,
                    tb, td)
            if not non_ref:
                if is_idr:
                    self._dev_motion.clear()
                self._dev_motion[(poc, w64, h64)] = (
                    mot_dev[0], mot_dev[1],
                    refs_l0[0][1] if (refs_l0 and not is_idr
                                      and slice_type != 2) else None)
                while len(self._dev_motion) > self._dev_motion_cap:
                    del self._dev_motion[next(iter(self._dev_motion))]
        else:
            # the host path: the previous pipelined picture must be final
            # first (its motion field is this picture's TMVP source)
            self._flush_inflight()
            st, substreams = self._encode_host(
                new_state, src, tiles, last_xy, qp, init_type, rd, feat,
                me_seed, ois, col_poc, split_policy, part_nxn_policy,
                kind)
        slice_per_tile = bool(cfg.tile_slice_mode) and len(tiles) > 1

        all_ref_pocs = ({r[1] for r in (refs_l0 or [])}
                        | {r[1] for r in (refs_l1 or [])})
        keep = set(retain_pocs or ()) | all_ref_pocs
        keep.discard(poc)
        negs = [(poc - rp, int(rp in all_ref_pocs))
                for rp in sorted((p for p in keep if p < poc),
                                 reverse=True)]
        poss = [(rp - poc, int(rp in all_ref_pocs))
                for rp in sorted(p for p in keep if p > poc)]
        nal_type = (nal_type_override if nal_type_override is not None
                    else NalUnitType.IDR_W_RADL if is_idr
                    else NalUnitType.TRAIL_N if non_ref
                    else NalUnitType.TRAIL_R)
        irap = is_idr or nal_type == NalUnitType.CRA_NUT

        # ---- DPB update at dispatch time: a fused picture's device recon
        # becomes the next reference directly (host views download
        # lazily); a host-path picture's planes are uploaded to the device
        # DPB too, so a following fused picture needs no re-upload
        hc, wc = frame.cb.shape
        if rec_dev is not None:
            if is_idr:
                self._dev_dpb.clear()
            if not non_ref:
                self._dev_dpb[(poc, w64, h64)] = rec_dev
                while len(self._dev_dpb) > 6:
                    del self._dev_dpb[next(iter(self._dev_dpb))]
            lazy = _LazyPlanes(rec_dev, cw, ch)
            self._ref_planes = lazy
            self._ref_poc = poc
            recon = _LazyFrame(lazy, frame.width, frame.height, wc, hc, dt)
        else:
            self._ref_planes = [p.copy() for p in st.planes]
            self._ref_poc = poc
            if fast_capable and not non_ref:
                if is_idr:
                    self._dev_dpb.clear()
                with genc.stage(f"{kind}.dpb_upload"):
                    self._dev_dpb[(poc, w64, h64)] = genc.prep_planes(
                        st.planes[0].astype(dt), st.planes[1].astype(dt),
                        st.planes[2].astype(dt), w64, h64, self.device)
                while len(self._dev_dpb) > 6:
                    del self._dev_dpb[next(iter(self._dev_dpb))]
            recon = Frame(
                y=st.planes[0][:frame.height, :frame.width].astype(dt),
                cb=st.planes[1][:hc, :wc].astype(dt),
                cr=st.planes[2][:hc, :wc].astype(dt))
        ref_planes = self._ref_planes

        def _complete() -> EncodedPicture:
            substr = substreams
            if substr is None:
                # a fused picture: fetch the packed device buffer, walk,
                # CABAC. The collocated motion binds HERE: the previous
                # frame's walk has finished by completion order.
                st.col = self._col_for(col_poc)
                from .fast_path import complete_fast
                with genc.stage(f"{kind}.download"):
                    maps, sao_np = complete_fast(cfg, st, packed,
                                                 b_form=use_fast_b,
                                                 lv_dev=lv_dev)
                with genc.stage(f"{kind}.host_emit"):
                    substr = self._encode_fast(
                        st, src, maps, sao_np, qp, feat, tiles[0][0],
                        last_xy, init_type)
            if cfg.tmvp and not non_ref:
                # this picture's final motion field is a future TMVP
                # collocated source
                self._ref_motion[poc] = {
                    "mv": st.mv[::4, ::4].copy(),     # 16x16 compression
                    "ref_idx": st.ref_idx[::4, ::4].copy(),
                    "ref_pocs": [list(st.ref_pocs[0]),
                                 list(st.ref_pocs[1])],
                    "poc": poc}
                for k in [k for k in self._ref_motion
                          if abs(k - poc) > 64]:
                    del self._ref_motion[k]
            if slice_per_tile:
                # one independent slice NAL per tile
                nals = []
                for t_idx, (order, _, _, _) in enumerate(tiles):
                    ax, ay = order[0]
                    addr = ((ay >> cfg.ctb_log2) * n_ctb_x
                            + (ax >> cfg.ctb_log2))
                    w = write_slice_header(cfg, slice_qp=qp, is_idr=is_idr,
                                           poc=poc, slice_type=slice_type,
                                           entry_points=[], neg_deltas=negs,
                                           pos_deltas=poss,
                                           first_slice=t_idx == 0,
                                           slice_address=addr, irap=irap)
                    w.write_bytes(substr[t_idx])
                    nals.append(wrap_nal(nal_type, w.get_bytes()))
                nal = b"".join(nals)
            else:
                w = write_slice_header(cfg, slice_qp=qp, is_idr=is_idr,
                                       poc=poc, slice_type=slice_type,
                                       entry_points=[len(s) for s in
                                                     substr[:-1]],
                                       neg_deltas=negs, pos_deltas=poss,
                                       irap=irap)
                w.write_bytes(b"".join(substr))
                nal = wrap_nal(nal_type, w.get_bytes())

            # per-picture metadata: prefix user-data SEIs before the
            # slice, Dolby Vision RPU as NAL 62 after it
            pre_msgs = []
            if frame.sei_t35 is not None:
                pre_msgs.append(sei.write_user_data_registered(
                    frame.sei_t35))
            if frame.sei_unreg is not None:
                pre_msgs.append(sei.write_user_data_unregistered(
                    frame.sei_unreg[0], frame.sei_unreg[1]))
            out = nal
            if pre_msgs:
                out = wrap_nal(NalUnitType.PREFIX_SEI_NUT,
                               sei.sei_rbsp(pre_msgs)) + out
            if cfg.dolby_vision_profile == 81 and frame.dv_rpu:
                out += wrap_nal(NalUnitType.UNSPEC62, frame.dv_rpu)
            pic = EncodedPicture(nal_bytes=out, recon=recon, poc=poc)
            pic.ref_planes = ref_planes
            return pic

        if pipelined and packed is not None:
            return PendingPicture(poc=poc, recon=recon,
                                  ref_planes=ref_planes, _finish=_complete)
        return _complete()

    def _encode_host(self, new_state, src, tiles, last_xy, qp, init_type,
                     rd, feat, me_seed, ois, col_poc, split_policy,
                     part_nxn_policy, kind):
        """The host path: the numpy CTU coder over the tiles in two passes.
        Pass 1 decides and reconstructs (RdSearch per CTU at RD presets,
        else a decide-only walk whose decisions pass 2 replays), then
        deblocking and SAO run over the picture; pass 2 records each
        tile's syntax (SAO parameters, CTUs, end-of-slice and
        end-of-subset bits), and each tile is arithmetic-coded on its own.
        Returns (the picture state, the tile substreams)."""
        from ..gpu import encode as genc
        cfg = self.cfg
        ctb = cfg.ctb_size
        mcts = cfg.constrained_motion_tiles
        slice_per_tile = bool(cfg.tile_slice_mode) and len(tiles) > 1
        with genc.stage(f"{kind}.pass1"):
            st = new_state()
            st.col = self._col_for(col_poc)
            decisions_all: dict = {}
            # decide-once cache shared with pass 2 (identical recon state
            # => identical plans and modes; pass 2 only replays)
            dcache = {"plans": {}, "modes": {}}
            for order, _, _, rect in tiles:
                st.begin_tile()
                est_ctx = init_contexts(qp, init_type=init_type)
                mrect = rect if mcts else None
                if rd:
                    for x0, y0 in order:
                        rds = RdSearch(st, src, me_seed=me_seed,
                                       try_nxn=feat.try_nxn, features=feat,
                                       ois=ois, mcts_rect=mrect)
                        decisions, est_ctx = rds.compress_ctu(x0, y0,
                                                              est_ctx)
                        decisions_all[(x0, y0)] = decisions
                else:
                    # decide-only walk: its bins are never read
                    enc1 = CtuEncoder(st, NullCoder(est_ctx), src,
                                      split_policy=split_policy,
                                      part_nxn_policy=part_nxn_policy,
                                      me_seed=me_seed, features=feat,
                                      ois=ois, decision_cache=dcache,
                                      mcts_rect=mrect)
                    for x0, y0 in order:
                        enc1.code_ctu(x0, y0)

        with genc.stage(f"{kind}.dlf_sao"):
            if cfg.enable_deblocking:
                deblock_picture(st)
            sao_grid = None
            if cfg.enable_sao:
                sao_grid = derive_sao_params(st, src, lambda_sse(qp))
                apply_sao(st, sao_grid, True, True)

        with genc.stage(f"{kind}.pass2"):
            st2 = new_state()
            st2.col = st.col
            recs = []
            for t_idx, (order, left_col, top_row, rect) in enumerate(tiles):
                st2.begin_tile()
                mrect = rect if mcts else None
                bac = CabacRecorder(init_contexts(qp, init_type=init_type))
                if not rd:
                    enc = CtuEncoder(st2, bac, src,
                                     split_policy=split_policy,
                                     part_nxn_policy=part_nxn_policy,
                                     me_seed=me_seed, features=feat,
                                     ois=ois, decision_cache=dcache,
                                     mcts_rect=mrect)
                for x0, y0 in order:
                    if rd:
                        d = decisions_all[(x0, y0)]
                        enc = CtuEncoder(st2, bac, src,
                                         split_policy=d.split_policy,
                                         part_nxn_policy=d.part_nxn_policy,
                                         mode_policy=d.mode_policy,
                                         me_seed=me_seed, features=feat,
                                         ois=ois, mcts_rect=mrect)
                    if sao_grid is not None:
                        encode_sao_ctb(bac, sao_grid, x0 // ctb, y0 // ctb,
                                       True, True, bit_depth=cfg.bit_depth,
                                       left_ok=x0 // ctb > left_col,
                                       up_ok=y0 // ctb > top_row)
                    enc.code_ctu(x0, y0)
                    # end_of_slice_segment_flag: last CTB of the slice
                    # (the tile in tile-slice mode, else the picture)
                    last = (x0, y0) == (order[-1] if slice_per_tile
                                        else last_xy)
                    bac.encode_terminate(1 if last else 0)
                if not slice_per_tile and t_idx != len(tiles) - 1:
                    bac.encode_terminate(1)      # end_of_subset_one_bit
                recs.append(bac)
        with genc.stage(f"{kind}.cabac"):
            substreams = [finalize_cabac(
                bac, init_contexts(qp, init_type=init_type))
                for bac in recs]
        return st, substreams

    def encode(self, frames, *, rd: bool | None = None,
               frame_qps=None) -> tuple[bytes, list]:
        """Encode an iterable of frames; returns (annex_b_stream, recons in
        display order). rd: full RD mode decision (None: the preset's).
        frame_qps: optional per-frame QP list (not read by random access,
        which takes the configured QP plus its layer offsets)."""
        if self.cfg.pred_structure == 2:
            stream, recons = self._encode_random_access(list(frames), rd=rd)
            if self.cfg.code_eos_nal:
                stream += wrap_nal(NalUnitType.EOS_NUT, b"")
            return stream, recons
        chunks = [self.headers()]
        recons = []
        for au in self.encode_pictures(frames, rd=rd, frame_qps=frame_qps):
            chunks.append(au.data)
            recons.append(au.recon)
        if self.cfg.code_eos_nal:
            chunks.append(wrap_nal(NalUnitType.EOS_NUT, b""))
        return b"".join(chunks), recons

    def encode_pictures(self, frames, *, rd: bool | None = None,
                        frame_qps=None):
        """Streaming form of encode(): yields one EncodedAu per picture in
        decode order, without the parameter-set headers. Random access
        yields each access unit as it is encoded (not pipelined)."""
        from .rate_control import RateControl
        # a new stream never motion-compensates against a previous
        # stream's device-resident references; a resumed stream keeps its
        # restored TMVP motion, which the next picture must see
        self._dev_dpb.clear()
        if not self._resuming:
            self._ref_motion.clear()
        self._resuming = False
        if self.cfg.pred_structure == 2:
            yield from self._ra_pictures(list(frames), rd=rd)
            return
        rc = RateControl(self.cfg)
        self.last_rc = rc
        la = (self.cfg.lookahead
              if rc.mode == 1 and rc.target_bits and frame_qps is None else 0)
        stream = (self._la_frames(frames, la) if la > 0
                  else ((fr, None) for fr in frames))
        prev_y = self._ckpt_prev_y
        b_slices = self.cfg.pred_structure == 1     # low-delay B
        # hierarchical low-delay: layer-L pictures reference the most
        # recent lower-layer picture, top-layer pictures are
        # non-referenced (TRAIL_N), and CQP adds per-layer QP offsets
        hl = self.cfg.hierarchical_levels
        ll_last: dict[int, tuple] = dict(self._ckpt_ll_last)
        if self._ckpt_rc_state is not None:
            rc.__dict__.update(self._ckpt_rc_state)
            self._ckpt_rc_state = None
        pending = None

        def _emit(res, meta):
            pic = res.finish() if isinstance(res, PendingPicture) else res
            m_idx, m_idr, m_stype, m_qp, m_window, m_t0, m_layer = meta
            if self._speed_target_fps is not None:
                fps = 1.0 / max(time.perf_counter() - m_t0, 1e-9)
                if fps < self._speed_target_fps:
                    self._dyn_enc_mode = min(self._dyn_enc_mode + 1, 11)
                elif fps > 2.0 * self._speed_target_fps:
                    self._dyn_enc_mode = max(self._dyn_enc_mode - 1,
                                             self.cfg.enc_mode)
            data = pic.nal_bytes
            # strict-CBR filler: pad the AU so the VBV cannot overflow;
            # filler bits count toward the RC totals
            fill = rc.filler_bits(8 * len(data))
            if fill >= 16 * 8:
                nbytes = fill // 8 - 7   # NAL overhead
                data += wrap_nal(NalUnitType.FD_NUT,
                                 b"\xff" * nbytes + b"\x80")
            if m_window is not None:
                rc.update_lookahead(8 * len(data), m_qp, m_window[0],
                                    is_idr=m_idr, layer=m_layer)
            else:
                rc.update(8 * len(data), m_qp)
            if self.cfg.enable_hrd:
                data = self._hrd_sei(m_idr) + data
            return EncodedAu(data=data, recon=pic.recon, poc=pic.poc,
                             slice_type=m_stype, is_idr=m_idr,
                             display_idx=m_idx, decode_idx=m_idx)

        for fr, window in stream:
            idx = self._frame_idx
            self._frame_idx += 1
            is_idr = self._frame_is_idr(idx)
            if (not is_idr and self.cfg.scene_change_detection
                    and prev_y is not None
                    and self._scene_cut(prev_y, np.asarray(fr.y))):
                is_idr = True
            prev_y = np.asarray(fr.y)
            if is_idr:
                self._ref_planes = None
                self._poc_base = idx
                ll_last.clear()
            rel = idx - self._poc_base
            pos = rel % (1 << hl) if hl else 0
            layer = 0 if pos == 0 else hl - ((pos & -pos).bit_length() - 1)
            non_ref = hl > 0 and layer == hl
            refs_l0 = None
            if hl > 0 and not is_idr:
                lower = [e for lv, e in ll_last.items() if lv < max(layer, 1)]
                ref = max(lower, key=lambda e: e[0])
                refs_l0 = [(ref[1], ref[2])]
            if frame_qps is not None and idx < len(frame_qps):
                qp = int(frame_qps[idx])
            else:
                qp = rc.pick_qp(is_idr, window=window, layer=layer)
                if rc.mode == 0 and layer > 0:
                    qp = min(qp + layer + 1, 51)
            qp = min(max(qp, self.cfg.min_qp_allowed),
                     self.cfg.max_qp_allowed)
            t0 = time.perf_counter()
            # every layer's most recent picture can still be referenced by
            # later pictures: keep them alive in the decoder's DPB
            retain = {e[2] for e in ll_last.values()}
            stype = 2 if is_idr else (0 if b_slices else 1)
            meta = (idx, is_idr, stype, qp, window, t0, layer)
            # one-frame-deep pipelining: dispatch this frame's device work
            # before finalizing the previous frame, so the host walk
            # overlaps the device compute + download. Only under CQP
            # without speed control: rate control needs this picture's
            # bits, and speed control its time, before the next picture
            can_pipe = rc.mode == 0 and self._speed_target_fps is None
            res = self.encode_frame(fr, rd=rd, is_idr=is_idr, poc=rel,
                                    qp=qp, slice_type=stype,
                                    refs_l0=refs_l0, non_ref=non_ref,
                                    retain_pocs=retain, pipelined=can_pipe)
            if hl > 0 and (layer < hl or is_idr):
                ll_last[0 if is_idr else layer] = (idx, res.ref_planes, rel)
            if pending is not None:
                yield _emit(*pending)
                pending = None
                self._inflight = None
            if isinstance(res, PendingPicture):
                pending = (res, meta)
                self._inflight = res
            else:
                yield _emit(res, meta)
        if pending is not None:
            yield _emit(*pending)
            self._inflight = None
        # segment finished: the resumable state checkpoint() carries
        self._ckpt_prev_y = prev_y
        self._ckpt_ll_last = ll_last

    # ------------------------------------------------------------ lookahead

    def _la_complexities(self, lumas: list[np.ndarray],
                         prev_y) -> list[float]:
        """Per-picture complexities for the lookahead RC: one batched
        gpu.analysis.lookahead_stats over [prev] + lumas on the encoder's
        device. The global-motion-compensated decimated SAD against the
        predecessor is the complexity; the stream's very first picture
        (no predecessor) takes a variance-derived intra proxy."""
        from ..gpu.analysis import lookahead_stats
        h, w = lumas[0].shape
        h4, w4 = (h + 3) // 4 * 4, (w + 3) // 4 * 4
        first = prev_y if prev_y is not None else lumas[0]
        stack = np.stack([pad_plane(p.astype(np.int32), w4, h4)
                          for p in [first] + lumas])
        st = lookahead_stats(torch.from_numpy(stack).to(self.device))
        zz = st["gm_sad"].cpu().numpy().astype(np.float64)
        if prev_y is None:
            var = float(st["variance"][0].cpu())
            zz[0] = max(float(np.sqrt(var)) / 4.0, 1e-3)
        return [max(float(c), 1e-3) for c in zz]

    def _la_frames(self, frames, la: int):
        """Sliding lookahead queue: yields (frame, window) where window =
        [this frame's complexity, next <= la complexities]; refills in
        batches of up to 2(la+1) frames so the statistics stay batched."""
        it = iter(frames)
        buf: deque = deque()            # (frame, complexity)
        prev_y = None
        done = False
        while True:
            if not done and len(buf) < la + 1:
                batch = []
                while len(batch) < 2 * (la + 1) - len(buf):
                    try:
                        batch.append(next(it))
                    except StopIteration:
                        done = True
                        break
                if batch:
                    ys = [np.asarray(f.y) for f in batch]
                    cxs = self._la_complexities(ys, prev_y)
                    prev_y = ys[-1]
                    buf.extend(zip(batch, cxs))
            if not buf:
                return
            fr, c0 = buf.popleft()
            yield fr, [c0] + [c for _, c in itertools.islice(buf, la)]

    # ------------------------------------------------------ random access

    def _encode_random_access(self, frames, *, rd=None):
        self._dev_dpb.clear()
        self._ref_motion.clear()
        chunks = [self.headers()]
        recons: list = [None] * len(frames)
        for au in self._ra_pictures(frames, rd=rd):
            chunks.append(au.data)
            recons[au.display_idx] = au.recon
        return b"".join(chunks), recons

    def _ra_pictures(self, frames, *, rd=None):
        """Random access with periodic IDR refresh (closed GOP): the
        stream is cut into independent segments of intra_period+1
        pictures, each a closed hierarchical-B GOP with its own IDR and
        POC base. With intra_refresh_type=1 the stream is one continuous
        open GOP with CRA refresh points and RASL leading pictures
        (_ra_pictures_open). No scene-cut detection runs here."""
        cfg = self.cfg
        if cfg.intra_refresh_type == 1 and cfg.intra_period > 0:
            yield from self._ra_pictures_open(frames, rd=rd)
            return
        seg_len = (cfg.intra_period + 1 if cfg.intra_period > 0
                   else len(frames))
        dec_base = 0
        for seg_start in range(0, len(frames), max(seg_len, 1)):
            seg = frames[seg_start:seg_start + seg_len]
            for au in self._ra_segment(seg, rd=rd):
                yield EncodedAu(
                    data=au.data, recon=au.recon, poc=au.poc,
                    slice_type=au.slice_type, is_idr=au.is_idr,
                    display_idx=seg_start + au.display_idx,
                    decode_idx=dec_base + au.decode_idx)
            dec_base += len(seg)

    @staticmethod
    def _future_refs(schedule) -> list[set]:
        """Per decode position, the POCs that pictures later in decode
        order reference (kept in the DPB as used=0 RPS entries)."""
        out: list[set] = [set() for _ in schedule]
        acc: set = set()
        for i in range(len(schedule) - 1, -1, -1):
            out[i] = acc.copy()
            l0, l1 = schedule[i][2:4]
            acc |= {r for r in (l0, l1) if r is not None}
        return out

    def _ra_segment(self, frames, *, rd=None):
        """Hierarchical-B mini-GOPs: anchors form a P chain, interior
        pictures are bi-predicted from the two enclosing pictures,
        recursively. AUs are yielded in decode order as each is encoded;
        display_idx gives the presentation order."""
        cfg = self.cfg
        gop = 1 << max(cfg.hierarchical_levels, 1)
        n = len(frames)

        schedule = [(0, 2, None, None, 0)]      # (idx, type, l0, l1, layer)
        pos = 0
        while pos + 1 < n:
            end = min(pos + gop, n - 1)
            schedule.append((end, 1, pos, None, 0))

            def rec(a, b, layer):
                if b - a < 2:
                    return
                m = (a + b) // 2
                schedule.append((m, 0, a, b, layer))
                rec(a, m, layer + 1)
                rec(m, b, layer + 1)

            rec(pos, end, 1)
            pos = end

        dpb: dict[int, object] = {}             # poc -> planes
        # DPB output delays: display index minus decode index, shifted so
        # the minimum is zero (output times stay causal under reordering)
        raw = [i - d for d, (i, *_rest) in enumerate(schedule)]
        base_delay = -min(raw) if raw else 0
        future_refs = self._future_refs(schedule)
        for dec_idx, (idx, stype, l0, l1, layer) in enumerate(schedule):
            qp = min(cfg.qp + (layer + 1 if stype == 0 else 0), 51)
            refs_l0 = [(dpb[l0], l0)] if l0 is not None else None
            refs_l1 = [(dpb[l1], l1)] if l1 is not None else None
            retain = {r for r in future_refs[dec_idx]
                      if r != idx and r in dpb}
            pic = self.encode_frame(frames[idx], rd=rd, qp=qp, poc=idx,
                                    is_idr=stype == 2, slice_type=stype,
                                    refs_l0=refs_l0, refs_l1=refs_l1,
                                    retain_pocs=retain)
            dpb[idx] = pic.ref_planes
            data = pic.nal_bytes
            if cfg.enable_hrd:
                data = self._hrd_sei(stype == 2,
                                     idx - dec_idx + base_delay) + data
            yield EncodedAu(data=data, recon=pic.recon, poc=idx,
                            slice_type=stype, is_idr=stype == 2,
                            display_idx=idx, decode_idx=dec_idx)
            # prune pictures older than the current mini-GOP window
            for k in [k for k in dpb if k < idx - 2 * gop]:
                del dpb[k]

    def _ra_pictures_open(self, frames, *, rd=None):
        """CRA open-GOP random access: one continuous coded video
        sequence whose intra refresh points are CRA pictures (POC
        continues, the DPB survives). The hierarchical-B pictures between
        the previous anchor and a CRA reference across it; they decode
        after the CRA but display before it, so they go out as RASL_R /
        RASL_N leading pictures, which a decoder tuning in at the CRA
        drops."""
        cfg = self.cfg
        gop = 1 << max(cfg.hierarchical_levels, 1)
        n = len(frames)
        intra_pos = set(range(0, n, cfg.intra_period + 1))

        # (idx, slice_type, l0, l1, layer, rasl)
        schedule = [(0, 2, None, None, 0, False)]
        pos = 0
        while pos + 1 < n:
            nxt_i = min((p for p in intra_pos if p > pos), default=n - 1)
            end = min(pos + gop, nxt_i, n - 1)
            is_intra = end in intra_pos
            schedule.append((end, 2 if is_intra else 1,
                             None if is_intra else pos, None, 0, False))

            def rec(a, b, layer, rasl):
                if b - a < 2:
                    return
                m = (a + b) // 2
                schedule.append((m, 0, a, b, layer, rasl))
                rec(a, m, layer + 1, rasl)
                rec(m, b, layer + 1, rasl)

            # interior pictures of a CRA-terminated mini-GOP are leading
            # pictures of that CRA (display < CRA <= decode) -> RASL
            rec(pos, end, 1, is_intra)
            pos = end

        dpb: dict[int, object] = {}
        raw = [i - d for d, (i, *_r) in enumerate(schedule)]
        base_delay = -min(raw) if raw else 0
        future_refs = self._future_refs(schedule)
        for dec_idx, (idx, stype, l0, l1, layer, rasl) in \
                enumerate(schedule):
            qp = min(cfg.qp + (layer + 1 if stype == 0 else 0), 51)
            refs_l0 = [(dpb[l0], l0)] if l0 is not None else None
            refs_l1 = [(dpb[l1], l1)] if l1 is not None else None
            retain = {r for r in future_refs[dec_idx]
                      if r != idx and r in dpb}
            is_idr = stype == 2 and idx == 0
            non_ref = (stype == 0 and layer >= cfg.hierarchical_levels
                       and idx not in future_refs[dec_idx])
            nal = None
            if stype == 2 and not is_idr:
                nal = NalUnitType.CRA_NUT
            elif rasl:
                nal = (NalUnitType.RASL_N if non_ref
                       else NalUnitType.RASL_R)
            pic = self.encode_frame(frames[idx], rd=rd, qp=qp, poc=idx,
                                    is_idr=is_idr, slice_type=stype,
                                    refs_l0=refs_l0, refs_l1=refs_l1,
                                    retain_pocs=retain,
                                    nal_type_override=nal)
            dpb[idx] = pic.ref_planes
            data = pic.nal_bytes
            if cfg.enable_hrd:
                data = self._hrd_sei(is_idr,
                                     idx - dec_idx + base_delay) + data
            yield EncodedAu(data=data, recon=pic.recon, poc=idx,
                            slice_type=stype, is_idr=is_idr,
                            display_idx=idx, decode_idx=dec_idx)
            for k in [k for k in dpb if k < idx - 2 * gop]:
                del dpb[k]

    def _encode_fast(self, st, src, maps, sao_np, qp, feat, order, last_xy,
                     init_type) -> list[bytes]:
        """Host half shared by I and P pictures: the native emitter (one C
        call: merge/AMVP/MPM legality from the maps, every bin, the
        arithmetic coder), else the Python walk recording bin ops from the
        device maps plus one CABAC run. Returns the slice substreams."""
        from .fast_path import FastCtuEncoder, sao_grid_from_arrays
        from .native_emit import emit_tile_native
        cfg = self.cfg
        data = emit_tile_native(
            cfg, st, maps, sao_np if cfg.enable_sao else None, qp,
            init_type, last_ctb=(last_xy[0] >> cfg.ctb_log2,
                                 last_xy[1] >> cfg.ctb_log2))
        if data is not None:
            return [data]
        walker = FastCtuEncoder(st, None, src, maps, features=feat)
        ctu_ops = []
        st.begin_tile()
        for x0, y0 in order:
            rec = CabacRecorder()
            walker.bac = rec
            walker.code_ctu(x0, y0)
            ctu_ops.append(rec)

        sao_grid = None
        if cfg.enable_sao:
            ny = (st.h + cfg.ctb_size - 1) // cfg.ctb_size
            nx = (st.w + cfg.ctb_size - 1) // cfg.ctb_size
            sao_grid = sao_grid_from_arrays(sao_np, ny, nx)

        ctb = cfg.ctb_size
        bac = CabacRecorder(init_contexts(qp, init_type=init_type))
        for i, (x0, y0) in enumerate(order):
            if sao_grid is not None:
                encode_sao_ctb(bac, sao_grid, x0 // ctb, y0 // ctb,
                               True, True, bit_depth=cfg.bit_depth)
            bac.extend_from(ctu_ops[i])
            bac.encode_terminate(1 if (x0, y0) == last_xy else 0)
        return [finalize_cabac(bac, init_contexts(qp, init_type=init_type))]
