"""Motion estimation on the card: batched hierarchical full-pel search.

PyTorch port of svt_hevc_tpu/tpu/me.py. Every displacement of a level is
evaluated for all blocks of the picture at once by kernel K1
(gpu/kernels.sad_field, csrc/sad_field.cu); three levels (1/16 area,
1/4 area, full resolution) each search a small window around the
upsampled field of the level above.
"""

from __future__ import annotations

import torch

from .kernels import sad_field


def _block_sad_all_disp(src: torch.Tensor, ref: torch.Tensor, n: int,
                        r: int) -> torch.Tensor:
    """SAD of every aligned (n, n) block of src vs ref displaced by every
    (dy, dx) in [-r, r]^2: (2r+1, 2r+1, H//n, W//n) float32 (kernel K1
    on the card, its plain version on the CPU)."""
    return sad_field(src.to(torch.float32).contiguous(),
                     ref.to(torch.float32).contiguous(), n, r)


def _pick_best(sads: torch.Tensor, r: int):
    """argmin over the displacement grid -> (mvy, mvx) integer-pel maps
    and the minimum; the first displacement wins a tie (torch.argmin
    returns the first minimal index, like jnp.argmin)."""
    s2, _, bh, bw = sads.shape
    flat = sads.reshape(s2 * s2, bh, bw)
    k = torch.argmin(flat, dim=0).to(torch.int32)
    return (torch.div(k, s2, rounding_mode="floor") - r,
            k % s2 - r, flat.amin(dim=0))


def _search_level(src, ref, n: int, r: int, center_y, center_x):
    """Search +/-r around per-block centers (integer-pel maps at this
    level's block grid); centering pre-translates the reference per block
    with a gather whose coordinates are clamped into the plane (the clamp
    JAX's gather applies implicitly)."""
    h, w = src.shape
    if center_y is None:
        sads = _block_sad_all_disp(src, ref, n, r)
        return _pick_best(sads, r)
    dev = src.device
    bh, bw = h // n, w // n
    a = torch.arange(n, device=dev)
    by = torch.arange(bh, device=dev) * n
    bx = torch.arange(bw, device=dev) * n
    ys = (by[:, None, None, None] + center_y[:, :, None, None].long()
          + a[None, None, :, None]).clamp(0, h - 1)         # (bh,bw,n,1)
    xs = (bx[None, :, None, None] + center_x[:, :, None, None].long()
          + a[None, None, None, :]).clamp(0, w - 1)         # (bh,bw,1,n)
    rec = ref[ys, xs]                                        # (bh,bw,n,n)
    rec_plane = rec.permute(0, 2, 1, 3).reshape(h, w)
    sads = _block_sad_all_disp(src, rec_plane, n, r)
    my, mx, sad = _pick_best(sads, r)
    return my + center_y, mx + center_x, sad


def _decimate2(p: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling; exact in float32 (a sum of four values that are
    multiples of 1/4^k below 256, divided by 4)."""
    h, w = p.shape
    return p.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))


def _up2(m: torch.Tensor) -> torch.Tensor:
    return m.repeat_interleave(2, 0).repeat_interleave(2, 1)


def hme_search(src: torch.Tensor, ref: torch.Tensor, n: int = 16,
               r: int = 4):
    """3-level hierarchical full-pel ME for every (n, n) block.

    src/ref: (H, W) planes, H and W multiples of 4n. Returns (mv_q, sad):
    mv_q is (H//n, W//n, 2) int32 [mvx, mvy] in quarter-pel units, sad the
    full-resolution float32 SAD map."""
    src = src.to(torch.float32)
    ref = ref.to(torch.float32)
    s2, r2 = _decimate2(src), _decimate2(ref)
    s4, r4 = _decimate2(s2), _decimate2(r2)
    my4, mx4, _ = _search_level(s4, r4, n, 2 * r, None, None)
    my2, mx2, _ = _search_level(s2, r2, n, r, _up2(my4) * 2, _up2(mx4) * 2)
    my0, mx0, sad = _search_level(src, ref, n, r, _up2(my2) * 2,
                                  _up2(mx2) * 2)
    mv_q = torch.stack([mx0 * 4, my0 * 4], dim=-1).to(torch.int32)
    return mv_q, sad
