"""Rate control: CQP, frame-level ABR, lookahead high-level VBR, VBV clamp.

Analogue of the reference's rate-control stack (reference:
Source/Lib/Codec/EbRateControlProcess.c — CQP path :2422, VBR
HighLevelRcInputPictureMode2 :296 / FrameLevelRcInputPictureMode2 :878,
feedback :1664/:2088, VBV Vbv_Buf_Calc :2177; lookahead window feed
EbInitialRateControlProcess.c:849): a pure host-side
pytree-of-scalars controller.

Two VBR operating points:
 - reactive (no lookahead): frame QP adapts multiplicatively toward the
   target bits/frame from a running complexity estimate;
 - lookahead high-level RC: the window's per-picture complexities
   (TPU-batched decimated zero-MV SADs, svt_hevc_tpu.tpu.analysis
   .lookahead_stats) apportion the window bit budget per picture
   (the reference's histogram-queue bit budgeting), and a calibrated
   bits = gain * complexity * 2^(-qp/6) model converts the picture target
   to QP, with feedback updating the gain and a deficit term steering the
   long-run average to the target.

The VBV model clamps QP upward when the buffer would underflow. State is
trivially checkpointable (plain attrs), matching the survey note
(SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import math

from ..config import EncoderConfig


class RateControl:
    """pick_qp() before each frame; update() with the coded size after."""

    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg
        self.mode = cfg.rate_control_mode
        self.fps = cfg.fps_num / max(cfg.fps_den, 1)
        self.target_bits = (cfg.target_bitrate / self.fps
                            if cfg.target_bitrate else 0.0)
        self.qp = float(cfg.qp)
        # complexity: running bits * 2^((qp-base)/6) normaliser
        self._cplx = None
        self._frames = 0
        # VBV (decoder buffer model): fill grows by maxrate/fps per frame,
        # drains by the coded size
        self.vbv_bufsize = float(cfg.vbv_bufsize or 0)
        self.vbv_maxrate = float(cfg.vbv_maxrate or cfg.target_bitrate or 0)
        self.vbv_fill = self.vbv_bufsize * 0.9

        # lookahead high-level RC state (used when a stats window is given):
        # per (is_idr, temporal_layer) rate-model gain, bits = gain * cplx
        # * 2^(-qp/6) (the reference keeps distinct rate models per slice
        # type AND per temporal layer in its parallel-GOP ring,
        # EbRateControlProcess.c:2406-2416 rcModelPtr->layer[], with bits
        # tables per layer in EbRateControlTables.c)
        self._gain: dict = {}
        self._deficit = 0.0        # coded bits minus budget so far
        # cross-GOP clamp state (reference: new-GOP QP is clamped against
        # the previous GOP's first-picture actual QP so consecutive GOPs
        # cannot oscillate, EbRateControlProcess.c:2454-2509)
        self._prev_gop_qp: float | None = None
        self._gop_first = True
        # VBV conformance tracking: an underflow means a frame was too big
        # for the buffer level — the clamp below 0 hides it, so record it
        self.vbv_underflows = 0

    # ------------------------------------------------------------------ api
    def pick_qp(self, is_idr: bool, window=None, layer: int = 0) -> int:
        """window: optional list of per-picture complexities (current frame
        first, then the lookahead frames) from the TPU lookahead stats.
        layer: temporal layer of the picture (selects the per-layer rate
        model, reference EbRateControlProcess.c:2406-2416)."""
        if self.mode == 0 or not self.target_bits:
            return self.cfg.qp
        if is_idr:
            # cross-GOP QP clamp (EbRateControlProcess.c:2454-2509): the
            # new GOP may not jump more than ~4 QP from where the last
            # GOP's first picture actually landed
            if self._prev_gop_qp is not None:
                self.qp = min(max(self.qp, self._prev_gop_qp - 4.0),
                              self._prev_gop_qp + 4.0)
            self._gop_first = True
        if window:
            return self._pick_qp_lookahead(is_idr, window, layer)
        qp = self.qp
        if self._cplx is not None:
            # predicted bits at current qp from the complexity model
            pred = self._cplx * 2.0 ** ((self.cfg.qp - qp) / 6.0)
            err = pred / self.target_bits
            qp += 3.0 * math.log2(max(err, 1e-6))
            qp = min(max(qp, self.qp - 4.0), self.qp + 4.0)
        if is_idr:
            qp -= 3.0          # I frames get a quality boost (ref: CQP offsets)
        elif layer > 0:
            # per-temporal-layer offset in the reactive model (reference
            # MOD_QP_OFFSET_LAYER_ARRAY, EbRateControlProcess.h:46)
            qp += min(layer + 1, 4)
        # VBV clamp: if the buffer is near empty, force coarser quant
        if self.vbv_bufsize > 0:
            headroom = self.vbv_fill / self.vbv_bufsize
            if headroom < 0.15:
                qp += 6.0 * (0.15 - headroom) / 0.15
        return int(min(max(round(qp), 1), 51))

    # -------------------------------------------- lookahead high-level RC
    def _model_key(self, is_idr: bool, layer: int):
        return (bool(is_idr), int(layer))

    def _gain_for(self, is_idr: bool, layer: int):
        """Per-layer gain with graceful fallback: exact model, then any
        same-slice-class layer, then any model at all (bootstrap)."""
        g = self._gain.get(self._model_key(is_idr, layer))
        if g is not None:
            return g
        same = [v for (i, _), v in self._gain.items() if i == bool(is_idr)]
        if same:
            return same[-1]
        anyg = list(self._gain.values())
        return anyg[-1] if anyg else None

    def _pick_qp_lookahead(self, is_idr: bool, window,
                           layer: int = 0) -> int:
        """Apportion the window budget over the lookahead complexities
        (reference HighLevelRcInputPictureMode2: bit budgeting across the
        lookahead histogram queue), then map the picture target to QP via
        the calibrated per-layer rate model."""
        c0 = max(float(window[0]), 1e-3)
        total = sum(max(float(c), 1e-3) for c in window)
        budget = self.target_bits * len(window)
        # steer the long-run average: repay the accumulated deficit over
        # roughly one window
        budget -= self._deficit
        target = max(budget * c0 / total, self.target_bits * 0.1)
        if is_idr:
            # I pictures borrow from the window (repaid via the deficit)
            target *= 2.5
        elif layer > 0:
            # higher layers get a smaller share (they are cheaper to code
            # and mostly non-referenced; reference bit allocation weights
            # per layer, EbRateControlProcess.c HighLevelRc tables)
            target *= max(1.0 - 0.15 * layer, 0.5)
        gain = self._gain_for(is_idr, layer)
        if gain is None:
            # bootstrap: start from the configured QP, calibrate from frame 1
            qp = self.qp
        else:
            qp = 6.0 * math.log2(max(gain * c0 / target, 1e-9))
            # slew limit vs the previous picture (reference: QP smoothing)
            qp = min(max(qp, self.qp - 6.0), self.qp + 6.0)
        if self.vbv_bufsize > 0:
            headroom = self.vbv_fill / self.vbv_bufsize
            if headroom < 0.15:
                qp += 6.0 * (0.15 - headroom) / 0.15
        self.qp = min(max(qp, 1.0), 51.0)
        if self._gop_first:
            self._prev_gop_qp = self.qp
            self._gop_first = False
        return int(min(max(round(qp), 1), 51))

    def update_lookahead(self, coded_bits: int, used_qp: int,
                         cplx: float, is_idr: bool = False,
                         layer: int = 0) -> None:
        """Feedback for the lookahead model (reference
        FrameLevelRcFeedbackPictureMode2 :1664): recalibrate the per-layer
        rate-model gain and integrate the bit deficit."""
        c = max(float(cplx), 1e-3)
        g = coded_bits * 2.0 ** (used_qp / 6.0) / c
        key = self._model_key(is_idr, layer)
        prev = self._gain.get(key)
        self._gain[key] = g if prev is None else 0.6 * prev + 0.4 * g
        self._deficit += coded_bits - self.target_bits
        # cap runaway deficit (e.g. after a scene cut burst)
        lim = 32.0 * self.target_bits
        self._deficit = min(max(self._deficit, -lim), lim)
        self._vbv_advance(coded_bits)

    def _vbv_advance(self, coded_bits: int) -> None:
        if self.vbv_bufsize > 0:
            self.vbv_fill -= coded_bits
            if self.vbv_fill < 0.0:
                self.vbv_underflows += 1
            self.vbv_fill += self.vbv_maxrate / self.fps
            self.vbv_fill = min(max(self.vbv_fill, 0.0), self.vbv_bufsize)

    def filler_bits(self, coded_bits: int) -> int:
        """CBR filler (reference: VBV overflow prevention in
        Packetization, EbPacketizationProcess.c:708-723): bits of filler
        needed so the decoder buffer cannot overflow when maxrate ==
        target bitrate. Returns 0 outside strict-CBR configurations."""
        if not (self.vbv_bufsize > 0 and self.vbv_maxrate
                and self.vbv_maxrate == float(self.cfg.target_bitrate or 0)):
            return 0
        buf = max(self.vbv_fill - coded_bits, 0.0) + self.vbv_maxrate / self.fps
        return int(max(buf - self.vbv_bufsize, 0.0))

    def update(self, coded_bits: int, used_qp: int) -> None:
        if self.mode == 0 or not self.target_bits:
            return
        # complexity normalised to the configured base QP
        norm = coded_bits * 2.0 ** ((used_qp - self.cfg.qp) / 6.0)
        self._cplx = (norm if self._cplx is None
                      else 0.7 * self._cplx + 0.3 * norm)
        self._frames += 1
        self._deficit += coded_bits - self.target_bits
        lim = 32.0 * self.target_bits
        self._deficit = min(max(self._deficit, -lim), lim)
        # track the *unclamped* controller qp so it follows the content;
        # the deficit term steers the long-run average onto the target
        # (pure multiplicative control converges to a biased rate when
        # content complexity drifts)
        pred = self._cplx * 2.0 ** ((self.cfg.qp - self.qp) / 6.0)
        err = pred / self.target_bits
        steer = self._deficit / (8.0 * self.target_bits)
        self.qp = min(max(self.qp + 1.5 * math.log2(max(err, 1e-6))
                          + 0.5 * min(max(steer, -2.0), 2.0), 1.0), 51.0)
        if self._gop_first:
            self._prev_gop_qp = self.qp
            self._gop_first = False
        self._vbv_advance(coded_bits)
