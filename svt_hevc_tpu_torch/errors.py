"""Error-code taxonomy of the public API.

The analogue of the reference's error system (reference:
Source/API/EbErrorCodes.h — ~200 numbered codes grouped by subsystem —
and EbErrorHandling.h:15): every failure surfaced through the API
carries a stable numeric code grouped by component, so applications can
branch on codes rather than parse message strings, and the async
handle's error callback can forward them.

Redesigned rather than copied: the reference enumerates per-malloc and
per-thread creation failures (C resource model); a Python/JAX framework
fails along different seams (validation, device/compile, I/O, decode
conformance, internal invariants), so the groups reflect those.
"""

from __future__ import annotations

from enum import IntEnum


class ErrorCode(IntEnum):
    OK = 0

    # 0x1xx — configuration / parameter validation
    BAD_PARAMETER = 0x100
    UNSUPPORTED_DIMENSIONS = 0x101
    UNSUPPORTED_FORMAT = 0x102
    LEVEL_CONSTRAINT = 0x103        # exceeds HEVC level tables (A.6/A.8)
    BAD_PRESET = 0x104
    BAD_RC_CONFIG = 0x105
    BAD_GOP_CONFIG = 0x106
    BAD_TILE_CONFIG = 0x107

    # 0x2xx — encode pipeline runtime
    ENCODE_FAILED = 0x200
    PIPELINE_ORDERING = 0x201       # motion/TMVP registration ordering
    RATE_CONTROL_FAILURE = 0x202
    METADATA_ERROR = 0x203          # SEI / RPU attachment problems

    # 0x3xx — device / compiler
    DEVICE_UNAVAILABLE = 0x300
    COMPILE_FAILED = 0x301
    DEVICE_OOM = 0x302

    # 0x4xx — input/output
    INPUT_FORMAT = 0x400            # malformed frame planes / bit depth
    INPUT_EXHAUSTED = 0x401
    OUTPUT_OVERFLOW = 0x402         # bounded queue back-pressure misuse

    # 0x5xx — internal invariants (bugs; always reportable)
    INTERNAL_ASSERT = 0x500
    BITSTREAM_DESYNC = 0x501        # conformance decoder mismatch
    STATE_CORRUPT = 0x502


class EncoderError(Exception):
    """API-surfaced failure with a stable numeric code.

    The reference returns EB_ERRORTYPE from every API call; Python's
    idiom is an exception carrying the same taxonomy. `code` is an
    ErrorCode; `component` names the subsystem that raised it.
    """

    def __init__(self, code: ErrorCode, message: str,
                 component: str = "encoder"):
        super().__init__(f"[{code.name}/0x{int(code):x}] {component}: "
                         f"{message}")
        self.code = ErrorCode(code)
        self.component = component


def classify(exc: BaseException) -> ErrorCode:
    """Map an arbitrary in-pipeline exception to its taxonomy code (used
    by the async handle when forwarding worker-thread failures)."""
    if isinstance(exc, EncoderError):
        return exc.code
    if isinstance(exc, ValueError):
        return ErrorCode.BAD_PARAMETER
    if isinstance(exc, NotImplementedError):
        return ErrorCode.UNSUPPORTED_FORMAT
    if isinstance(exc, MemoryError):
        return ErrorCode.DEVICE_OOM
    if isinstance(exc, RuntimeError):
        msg = str(exc).lower()
        if "tmvp" in msg or "ordering" in msg:
            return ErrorCode.PIPELINE_ORDERING
        if "resource exhausted" in msg or "out of memory" in msg:
            return ErrorCode.DEVICE_OOM
        return ErrorCode.ENCODE_FAILED
    return ErrorCode.INTERNAL_ASSERT
