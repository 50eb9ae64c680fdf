"""The port's hand-written CUDA kernels, their wrappers and plain versions.

K1 ``sad_field`` (csrc/sad_field.cu) replaces the Pallas
``sad_field_pallas``; K2 ``mc_block`` (csrc/mc_block.cu) replaces
``mc_block_pallas``. K3 ``ordered_sum`` (csrc/ordered_sum.cu) is the
counterpart of an XLA:CPU reduction, not of a Pallas kernel: float32
sums in XLA's order (a ``SumPlan``) where that order decides the
rounding. Each source is compiled by hand with nvcc for sm_90a into
``build/`` at the repository root on first use and bound with ctypes
(plain C entry points; pointers and the stream as c_void_p).

Beside each kernel sits its plain PyTorch version (``sad_field_ref``,
``mc_block_ref``, ``ordered_sum_ref``). A wrapper takes the plain version
only for tensors that lie on the CPU; for a CUDA tensor it launches the
kernel or raises. Every launch adds one to the kernel's ``launches``
count. The build runs ptxas verbosely; each kernel keeps its compiler
output (registers, shared memory, spills) in ``build_log``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaKernel:
    """One csrc/*.cu source built into its own shared library."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    @property
    def lib_path(self) -> str:
        return os.path.join(BUILD, f"lib{self.name}.so")

    def compile_cmd(self) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", self.lib_path,
                os.path.join(CSRC, self.source)]

    def _load(self):
        lib = ctypes.CDLL(self.lib_path)
        fn = getattr(lib, self.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = self.argtypes
        self._fn = fn

    def stale(self) -> bool:
        """Whether the library is missing or older than its source."""
        src = os.path.join(CSRC, self.source)
        return (not os.path.exists(self.lib_path)
                or os.path.getmtime(self.lib_path) < os.path.getmtime(src))

    def fn(self):
        with self._lock:
            if self._fn is None:
                if self.stale():
                    build_all([self])
                self._load()
        return self._fn

    def launch(self, *args) -> None:
        err = self.fn()(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed "
                               f"(cudaError {err})")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int

SAD_FIELD = CudaKernel("sad_field", "sad_field.cu", "sad_field_launch",
                       [_P, _P, _P, _I, _I, _I, _I, _P])
MC_BLOCK = CudaKernel("mc_block", "mc_block.cu", "mc_block_launch",
                      [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _I, _I, _I, _P])
ORDERED_SUM = CudaKernel("ordered_sum", "ordered_sum.cu",
                         "ordered_sum_launch", [_P, _P, *[_I] * 11, _P])
KERNELS = (SAD_FIELD, MC_BLOCK, ORDERED_SUM)


def build_all(kernels=KERNELS) -> float:
    """Compile the given kernels' sources, one nvcc per source, all
    started together. Returns the wall seconds. Raises with the compiler's
    output if any build fails."""
    os.makedirs(BUILD, exist_ok=True)
    t0 = time.perf_counter()
    procs = [(k, subprocess.Popen(k.compile_cmd(), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for k in kernels]
    failed = []
    for k, p in procs:
        out, _ = p.communicate()
        k.build_log = out
        if p.returncode != 0:
            failed.append(f"{k.source}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel instance from `ptxas -v` output:
    registers, shared memory, stack frame and spills."""
    rows, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            frame = ""
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = (f"{m.group(1)} B stack, {m.group(2)} B spill stores, "
                     f"{m.group(3)} B spill loads")
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append(f"{name}: {m.group(1)} registers, "
                        f"{m.group(2) or 0} B smem, {frame}")
            name = None
    return rows


def _kernel_name(mangled: str) -> str:
    """'..15mc_block_kernelILi8ELi8ELb1EEEv..' -> 'mc_block_kernel<8,8,1>';
    '..18ordered_sum_kernelILi8EEEv..' -> 'ordered_sum_kernel<8>'."""
    m = re.search(r"\d+([a-z_]+_kernel)I(.*?)EE", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](-?\d+)", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>"


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def _stream(device: torch.device) -> int:
    """The current stream of `device` (not of the current device)."""
    return torch.cuda.current_stream(device).cuda_stream


def _check_cuda(name: str, tensors, dtype) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} tensors "
                             f"on one device, got {t.dtype} on {t.device}")


def edge_pad(p: torch.Tensor, top: int, bottom: int | None = None,
             left: int | None = None, right: int | None = None):
    """Edge-replicating pad of the last two dims (numpy mode="edge"):
    an index clamp, so it works for every dtype on every device."""
    bottom = top if bottom is None else bottom
    left = top if left is None else left
    right = left if right is None else right
    h, w = p.shape[-2:]
    iy = torch.arange(-top, h + bottom, device=p.device).clamp(0, h - 1)
    ix = torch.arange(-left, w + right, device=p.device).clamp(0, w - 1)
    return p.index_select(-2, iy).index_select(-1, ix)


# ------------------------------------------------------------ K1 SAD field

# the search radii K1 is instantiated for (hme_search: 2r at the coarsest
# level, r below it, with r = 4)
SAD_FIELD_RADII = (4, 8)

def sad_field_ref(src: torch.Tensor, ref: torch.Tensor, n: int,
                  r: int) -> torch.Tensor:
    """Plain version of K1 (the XLA form of me._block_sad_all_disp): SAD
    of every aligned (n, n) block of src vs the edge-padded ref displaced
    by every (dy, dx) in [-r, r]^2 -> (2r+1, 2r+1, H//n, W//n)."""
    h, w = src.shape
    s2 = 2 * r + 1
    pad = edge_pad(ref, r)
    out = torch.empty((s2, s2, h // n, w // n), dtype=src.dtype,
                      device=src.device)
    for dy in range(s2):
        for dx in range(s2):
            diff = (src - pad[dy:dy + h, dx:dx + w]).abs()
            out[dy, dx] = diff.reshape(h // n, n, w // n, n).sum((1, 3))
    return out


def sad_field(src: torch.Tensor, ref: torch.Tensor, n: int,
              r: int) -> torch.Tensor:
    """K1: float32 SAD field (see sad_field_ref)."""
    if src.device.type == "cpu":
        return sad_field_ref(src, ref, n, r)
    if src.device.type != "cuda":
        raise ValueError(f"sad_field: unsupported device {src.device}")
    h, w = src.shape
    if ref.shape != src.shape or h % n or w % n:
        raise ValueError(f"sad_field: shapes {tuple(src.shape)} / "
                         f"{tuple(ref.shape)} vs block {n}")
    if n != 16 or r not in SAD_FIELD_RADII:
        raise ValueError(f"sad_field: the kernel takes n=16 and r in "
                         f"{SAD_FIELD_RADII}, got n={n}, r={r}")
    _check_cuda("sad_field", (src, ref), torch.float32)
    s2 = 2 * r + 1
    out = torch.empty((s2, s2, h // n, w // n), dtype=torch.float32,
                      device=src.device)
    # launch on the tensors' device, whichever device is current
    with torch.cuda.device(src.device):
        SAD_FIELD.launch(src.data_ptr(), ref.data_ptr(), out.data_ptr(),
                         h, w, n, r, _stream(src.device))
    return out


# ---------------------------------------------------------- K2 block MC

@functools.lru_cache(maxsize=None)
def _filter_rows(taps: int, device: str) -> torch.Tensor:
    from ..core.inter import CHROMA_FILTERS, LUMA_FILTERS
    table = ([LUMA_FILTERS[p] for p in range(4)] if taps == 8
             else [CHROMA_FILTERS[p] for p in range(8)])
    return torch.tensor([list(map(int, f)) for f in table],
                        dtype=torch.int32, device=device)


def _filter_table(taps: int, device) -> torch.Tensor:
    """(phases, taps) int32 interpolation filters on `device`, built once
    per device (luma: 4 x 8, chroma: 8 x 4)."""
    return _filter_rows(taps, str(device))


# the (n, taps) pairs K2 is instantiated for: luma 8x8 blocks with the
# 8-tap filters, chroma (4:2:0) 4x4 blocks with the 4-tap filters
MC_BLOCK_SHAPES = ((8, 8), (4, 4))


def _mc_shape(ref_ext, maps, n: int, taps: int, pad: int):
    """Check a K2 call's shapes; return (nby, nbx, output shape).

    ref_ext is one edge-padded plane (hp, wp) or P planes of one shape
    (P, hp, wp); the four maps are alike, (nby, nbx) for one MV field or
    (K, nby, nbx) for K fields. The output is (h, w) with a leading P and
    then K axis where the inputs have them."""
    if (n, taps) not in MC_BLOCK_SHAPES:
        raise ValueError(f"mc_block: (n, taps) = {(n, taps)} not in "
                         f"{MC_BLOCK_SHAPES}")
    if ref_ext.dim() not in (2, 3):
        raise ValueError(f"mc_block: ref_ext of shape "
                         f"{tuple(ref_ext.shape)} is not (hp, wp) or "
                         f"(P, hp, wp)")
    mshape = tuple(maps[0].shape)
    if len(mshape) not in (2, 3) or any(tuple(m.shape) != mshape
                                        for m in maps):
        raise ValueError(f"mc_block: maps of shapes "
                         f"{[tuple(m.shape) for m in maps]} are not four "
                         f"alike (nby, nbx) or (K, nby, nbx)")
    margin = taps // 2
    hp, wp = ref_ext.shape[-2:]
    h = hp - 2 * (pad + margin)
    w = wp - 2 * (pad + margin)
    if h <= 0 or w <= 0 or h % n or w % n or mshape[-2:] != (h // n,
                                                             w // n):
        raise ValueError(f"mc_block: maps {mshape} do not fit a "
                         f"{hp}x{wp} plane padded by {pad + margin} "
                         f"with {n}x{n} blocks")
    lead = tuple(ref_ext.shape[:-2]) + mshape[:-2]
    return h // n, w // n, lead + (h, w)


def _mc_field(ref_ext, sy, sx, fx, fy, n: int, taps: int, pad: int,
              rounded: bool, bit_depth: int) -> torch.Tensor:
    """One plane, one MV field: the (h, w) int32 prediction."""
    hp, wp = ref_ext.shape
    h = hp - 2 * (pad + taps // 2)
    w = wp - 2 * (pad + taps // 2)
    nby, nbx = h // n, w // n
    dev = ref_ext.device
    m = n + taps - 1
    a = torch.arange(m, device=dev)
    rows = (torch.arange(nby, device=dev) * n)[:, None] + sy.long()
    cols = (torch.arange(nbx, device=dev) * n)[None, :] + sx.long()
    ri = (rows[:, :, None, None] + a[None, None, :, None]).clamp(0, hp - 1)
    ci = (cols[:, :, None, None] + a[None, None, None, :]).clamp(0, wp - 1)
    win = ref_ext[ri, ci]                                 # (nby, nbx, m, m)
    filt = _filter_table(taps, dev)
    fh = filt[fx.long()]                                  # (nby, nbx, taps)
    fv = filt[fy.long()]
    mid = torch.zeros((nby, nbx, m, n), dtype=torch.int32, device=dev)
    for k in range(taps):
        mid = mid + fh[..., k, None, None] * win[..., :, k:k + n]
    mid = mid >> (bit_depth - 8)
    out = torch.zeros((nby, nbx, n, n), dtype=torch.int32, device=dev)
    for k in range(taps):
        out = out + fv[..., k, None, None] * mid[..., k:k + n, :]
    out = out >> 6
    if rounded:
        shift = 14 - bit_depth
        out = ((out + (1 << (shift - 1))) >> shift).clamp(
            0, (1 << bit_depth) - 1)
    return out.permute(0, 2, 1, 3).reshape(h, w)


def mc_block_ref(ref_ext, sy, sx, fx, fy, n: int, taps: int, pad: int,
                 rounded: bool, bit_depth: int = 8) -> torch.Tensor:
    """Plain version of K2 (the _mc_raw_*_direct / _mc_pred_*_direct
    forms). ref_ext: edge-padded int32 plane(s), pad + taps//2 per side,
    (hp, wp) or (P, hp, wp); sy/sx: window origins relative to each block
    origin and fx/fy: filter phases, each (nby, nbx) or (K, nby, nbx).
    Returns the int32 prediction of every plane under every field, shaped
    as _mc_shape says: the 14-bit intermediate, or clipped rounded pixels
    when `rounded`. A loop over planes and fields of the one-field form."""
    _, _, shape = _mc_shape(ref_ext, (sy, sx, fx, fy), n, taps, pad)
    planes = ref_ext.reshape(-1, *ref_ext.shape[-2:])
    maps = [t.reshape(-1, *t.shape[-2:]) for t in (sy, sx, fx, fy)]
    out = torch.stack([
        torch.stack([_mc_field(pl, *(t[k] for t in maps), n, taps, pad,
                               rounded, bit_depth)
                     for k in range(maps[0].shape[0])])
        for pl in planes])
    return out.reshape(shape)


def mc_block(ref_ext, sy, sx, fx, fy, n: int, taps: int, pad: int,
             rounded: bool, bit_depth: int = 8) -> torch.Tensor:
    """K2: per-block MC of P planes under K MV fields in one launch (see
    mc_block_ref)."""
    nby, nbx, shape = _mc_shape(ref_ext, (sy, sx, fx, fy), n, taps, pad)
    if ref_ext.device.type == "cpu":
        return mc_block_ref(ref_ext, sy, sx, fx, fy, n, taps, pad, rounded,
                            bit_depth)
    if ref_ext.device.type != "cuda":
        raise ValueError(f"mc_block: unsupported device {ref_ext.device}")
    maps = [t.to(torch.int32).contiguous() for t in (sy, sx, fx, fy)]
    _check_cuda("mc_block", [ref_ext] + maps, torch.int32)
    hp, wp = ref_ext.shape[-2:]
    n_planes = ref_ext.shape[0] if ref_ext.dim() == 3 else 1
    n_fields = maps[0].shape[0] if maps[0].dim() == 3 else 1
    out = torch.empty(shape, dtype=torch.int32, device=ref_ext.device)
    with torch.cuda.device(ref_ext.device):
        MC_BLOCK.launch(ref_ext.data_ptr(), n_planes, hp, wp,
                        *(t.data_ptr() for t in maps), out.data_ptr(),
                        n_fields, nby, nbx, n, taps, bit_depth - 8,
                        (14 - bit_depth) if rounded else 0,
                        (1 << bit_depth) - 1, _stream(ref_ext.device))
    return out


# ------------------------------------------------------ K3 ordered sum

class SumPlan(NamedTuple):
    """An order of float32 adds over a gh x gw grid of values (K3's; see
    csrc/ordered_sum.cu): an oh x ow grid of wh x ww windows after ph rows
    and pw columns of zero padding above and left; in a window the first
    wh - wh % lanes rows go round-robin to `lanes` lanes (each lane adds
    its rows' values row by row, left to right), the lanes are combined
    by halving, then the remaining rows are added row by row; with
    `split` the window's last column is added last, top to bottom; the
    windows of an output row are added left to right, the output rows
    top to bottom. Every sum starts from +0."""
    gh: int
    gw: int
    wh: int
    ww: int
    ph: int = 0
    pw: int = 0
    oh: int = 1
    ow: int = 1
    lanes: int = 1
    split: int = 0


def _plan_window(parts, q: SumPlan, a: int, b: int, acc0):
    """One window's sum under plan q, vectorized over parts' leading axes
    (parts (..., gh, gw) float32)."""
    def add_rows(acc, rows, c0, c1):
        for r in rows:
            if 0 <= r < q.gh:
                for c in range(max(c0, 0), min(c1, q.gw)):
                    acc = acc + parts[..., r, c]
        return acc

    r0, c0 = a * q.wh - q.ph, b * q.ww - q.pw
    body = c0 + q.ww - q.split
    main = q.wh - q.wh % q.lanes
    lanes = [add_rows(acc0, range(r0 + i, r0 + main, q.lanes), c0, body)
             for i in range(q.lanes)]
    h = q.lanes // 2
    while h:
        lanes = [lanes[i] + lanes[i + h] for i in range(h)]
        h //= 2
    w = add_rows(lanes[0], range(r0 + main, r0 + q.wh), c0, body)
    if q.split:
        w = add_rows(w, range(r0, r0 + q.wh), c0 + q.ww - 1, c0 + q.ww)
    return w


def ordered_sum_ref(parts: torch.Tensor, q: SumPlan) -> torch.Tensor:
    """Plain version of K3: the float32 sum of parts (..., L) over its last
    axis, L = gh * gw values of a grid in row-major order, added in plan
    q's order (SumPlan; a left-to-right chain over L values is the plan
    of an L x 1 grid), each add rounded in float32."""
    grid = parts.reshape(*parts.shape[:-1], q.gh, q.gw)
    zero = torch.zeros(parts.shape[:-1], dtype=torch.float32,
                       device=parts.device)
    total = zero
    for a in range(q.oh):
        row = zero
        for b in range(q.ow):
            row = row + _plan_window(grid, q, a, b, zero)
        total = total + row
    return total


def ordered_sum(parts: torch.Tensor, q: SumPlan) -> torch.Tensor:
    """K3: float32 (..., L) -> (...), the sum of each row in plan q's
    order (see ordered_sum_ref)."""
    if parts.dtype != torch.float32:
        raise ValueError(f"ordered_sum: float32 parts, got {parts.dtype}")
    if parts.shape[-1] != q.gh * q.gw:
        raise ValueError(f"ordered_sum: {parts.shape[-1]} values for a "
                         f"{q.gh} x {q.gw} plan")
    if q.lanes not in (1, 2, 4, 8):
        raise ValueError(f"ordered_sum: 1, 2, 4 or 8 lanes, got {tuple(q)}")
    if parts.device.type == "cpu":
        return ordered_sum_ref(parts, q)
    if parts.device.type != "cuda":
        raise ValueError(f"ordered_sum: unsupported device {parts.device}")
    lead, length = parts.shape[:-1], parts.shape[-1]
    cols = parts.reshape(-1, length).t().contiguous()       # (L, N)
    out = torch.empty(lead, dtype=torch.float32, device=parts.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(parts.device):
        ORDERED_SUM.launch(cols.data_ptr(), out.data_ptr(), *q,
                           cols.shape[1], _stream(parts.device))
    return out
