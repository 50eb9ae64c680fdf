"""Open-loop intra search on the card.

PyTorch port of the intra-search part of svt_hevc_tpu/tpu/analysis.py:
all 35 modes of every block evaluated as one batched contraction of the
block's reference vector with the per-mode weight matrices
(gpu/intra_weights.py), scored by Hadamard SATD.

The weights are dyadic and the references integers, so every product and
every partial sum is exact; the contractions run in float64 (exact on the
CPU and on the card, independent of TF32 settings) and the costs come
back as float32 like the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .intra_weights import mode_weight_matrix


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], np.float64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


@functools.lru_cache(maxsize=None)
def _tables(n: int, device: str):
    w = torch.as_tensor(mode_weight_matrix(n).astype(np.float64)).to(device)
    t = 4 if n == 4 else 8
    return w, torch.as_tensor(_hadamard(t)).to(device)


def extract_block_refs(y: torch.Tensor, n: int) -> torch.Tensor:
    """Open-loop reference vectors for every aligned NxN block: (gh*gw,
    4N+1) [left[0..2N-1], corner, top[0..2N-1]] from the source plane with
    coordinates clamped into the plane."""
    h, w = y.shape
    dev = y.device
    gh, gw = h // n, w // n
    by = torch.arange(gh, device=dev) * n
    bx = torch.arange(gw, device=dev) * n
    top_y = torch.clamp_min(by - 1, 0)
    left_x = torch.clamp_min(bx - 1, 0)
    k = torch.arange(2 * n, device=dev)
    tx = torch.clamp_max(bx[None, :, None] + k[None, None, :], w - 1)
    top = y[top_y[:, None, None], tx]                        # (gh, gw, 2n)
    ly = torch.clamp_max(by[:, None, None] + k[None, None, :], h - 1)
    left = y[ly, left_x[None, :, None]]                      # (gh, gw, 2n)
    corner = y[top_y[:, None], left_x[None, :]]              # (gh, gw)
    refs = torch.cat([left, corner[..., None], top], dim=-1)
    return refs.reshape(gh * gw, 4 * n + 1)


def _satd(diff: torch.Tensor, n: int, hmat: torch.Tensor) -> torch.Tensor:
    """Hadamard SATD over (..., N, N) blocks in 8x8 (or 4x4) tiles:
    sum|H @ D @ H^T| / t, exact in float64."""
    t = 4 if n == 4 else 8
    lead = diff.shape[:-2]
    nd = len(lead)
    d = diff.reshape(*lead, n // t, t, n // t, t)
    tiles = d.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
    tr = torch.matmul(torch.matmul(hmat, tiles), hmat.T)
    return tr.abs().sum(dim=(-4, -3, -2, -1)) / t


def _search(y: torch.Tensor, n: int):
    h, w = y.shape
    gh, gw = h // n, w // n
    wmat, hmat = _tables(n, str(y.device))
    refs = extract_block_refs(y.to(torch.float64), n)        # (B, 4n+1)
    preds = torch.einsum("br,mpr->bmp", refs, wmat)          # (B, 35, n*n)
    src = (y.to(torch.float64).reshape(gh, n, gw, n).permute(0, 2, 1, 3)
           .reshape(gh * gw, 1, n, n))
    diff = preds.reshape(-1, 35, n, n) - src
    cost = _satd(diff, n, hmat)                              # (B, 35)
    best = torch.argmin(cost, dim=1)
    return preds, cost, best


def intra_search_size(y: torch.Tensor, n: int):
    """Best intra mode per NxN block: (best_mode int32, best_cost float32)
    maps of shape (H//N, W//N); the first mode wins a tie."""
    h, w = y.shape
    gh, gw = h // n, w // n
    _, cost, best = _search(y, n)
    return (best.reshape(gh, gw).to(torch.int32),
            cost.amin(dim=1).reshape(gh, gw).to(torch.float32))


def intra_search_size_pred(y: torch.Tensor, n: int, bit_depth: int = 8):
    """intra_search_size + the winning mode's open-loop prediction plane
    (rounded half to even, clipped, int32)."""
    h, w = y.shape
    gh, gw = h // n, w // n
    preds, cost, best = _search(y, n)
    bp = torch.gather(preds, 1, best[:, None, None].expand(
        -1, 1, preds.shape[2]))[:, 0]
    # the reference's prediction is float32: round it there first
    plane = (bp.to(torch.float32).reshape(gh, gw, n, n).permute(0, 2, 1, 3)
             .reshape(h, w))
    plane = torch.round(plane).clamp(0, (1 << bit_depth) - 1).to(torch.int32)
    return (best.reshape(gh, gw).to(torch.int32),
            cost.amin(dim=1).reshape(gh, gw).to(torch.float32), plane)
