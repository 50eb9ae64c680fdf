"""CABAC op recorder: same bin-level API as CabacEncoder, but records the
op stream instead of doing arithmetic — the native C core
(svt_hevc_tpu/native/cabac.c) then encodes the whole stream in one call.

This is the two-stage entropy design from the build plan (SURVEY.md §7
"two-pass bin generation ... arithmetic-code on host/C++"): syntax
enumeration stays in Python (and later comes from TPU batch stages), the
irreducibly-sequential arithmetic runs in native code. Context state is
still updated live during recording wherever syntax *decisions* depend on
it — they don't in HEVC (only bin values do), so recording is exact.
"""

from __future__ import annotations

import numpy as np

KIND_BIN, KIND_BYPASS, KIND_BYPASS_BINS, KIND_TERMINATE = 0, 1, 2, 3


class NullCoder:
    """Bin sink for decide-only walks (non-RD pass 1): the encoder's
    syntax hooks drive the forward compute, but nobody reads the bins, so
    they are discarded and residual payloads skipped (is_null)."""

    is_null = True
    __slots__ = ("ctx",)

    def __init__(self, contexts=None) -> None:
        self.ctx = contexts if contexts is not None else []

    def encode_bin(self, ctx_idx: int, binval: int) -> None:
        pass

    def encode_bypass(self, binval: int) -> None:
        pass

    def encode_bypass_bins(self, value: int, nbits: int) -> None:
        pass

    def encode_terminate(self, binval: int) -> None:
        pass


class CabacRecorder:
    """Drop-in for CabacEncoder that records ops. `ctx` is kept only so
    code that clones context state keeps working; states are NOT updated
    during recording (the native pass owns them).

    Ops accumulate as a list of tuples plus pre-built int32 chunks (the
    native residual emitter appends whole (k, 3) arrays via append_ops);
    op_array() splices everything in order."""

    __slots__ = ("ctx", "ops", "_chunks")

    def __init__(self, contexts: list[int] | None = None) -> None:
        self.ctx = contexts if contexts is not None else []
        self.ops: list[tuple[int, int, int]] = []
        self._chunks: list[np.ndarray] = []

    def encode_bin(self, ctx_idx: int, binval: int) -> None:
        self.ops.append((KIND_BIN, ctx_idx, binval))

    def encode_bypass(self, binval: int) -> None:
        self.ops.append((KIND_BYPASS, 0, binval))

    def encode_bypass_bins(self, value: int, nbits: int) -> None:
        # split >30-bit runs so each op fits an int32 lane
        while nbits > 24:
            nbits -= 24
            self.ops.append((KIND_BYPASS_BINS, 24, (value >> nbits) & 0xFFFFFF))
            value &= (1 << nbits) - 1
        if nbits:
            self.ops.append((KIND_BYPASS_BINS, nbits, value))

    def encode_terminate(self, binval: int) -> None:
        self.ops.append((KIND_TERMINATE, 0, binval))

    def _flush(self) -> None:
        if self.ops:
            self._chunks.append(
                np.asarray(self.ops, dtype=np.int32).reshape(-1, 3))
            self.ops = []

    def append_ops(self, arr: np.ndarray) -> None:
        """Append a pre-built (k, 3) int32 op chunk in stream order."""
        self._flush()
        self._chunks.append(arr)

    def extend_from(self, other: "CabacRecorder") -> None:
        """Splice another recorder's full stream after this one's."""
        self._flush()
        other._flush()
        self._chunks.extend(other._chunks)

    def op_array(self) -> np.ndarray:
        self._flush()
        if not self._chunks:
            return np.empty((0, 3), np.int32)
        if len(self._chunks) == 1:
            return self._chunks[0]
        return np.concatenate(self._chunks, axis=0)

    def iter_ops(self):
        """All ops in order as (kind, a, v) tuples (Python fallback)."""
        self._flush()
        for chunk in self._chunks:
            for row in chunk:
                yield int(row[0]), int(row[1]), int(row[2])
