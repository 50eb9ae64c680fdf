"""Multi-device sharding of the encoder frontend on torch.distributed.

Port of svt_hevc_tpu/parallel/mesh.py. The JAX package lays the devices
out as a (gop, tile) mesh:

  gop axis  - data parallelism over pictures in flight;
  tile axis - spatial parallelism over picture rows, with the boundary
              rows of each shard exchanged with its neighbours where a
              search window crosses the shard boundary.

Here every rank of the process group is one device of that mesh (a
torch.distributed DeviceMesh with the dimension names "gop" and "tile").
The caller initialises the process group itself (NCCL on the card, gloo
on the CPU, an explicit init_method, rank and world size), and every
function below is called on every rank with that rank's share of the
data. Nothing here reads a rank or an address from the environment.

  make_mesh       - the (gop, tile) mesh over the whole world
  sharded_hme     - row-sharded hierarchical ME (kernel K1 on each shard)
                    with a HALO-row exchange between tile neighbours
  frontend_step   - per-picture analysis shared out over the mesh, and a
                    rate-proxy total summed over the whole mesh
  gop_encode_step - fast_p_fused_packed on each rank's share of the
                    pictures, the packed buffers gathered on every rank
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..gpu.analysis import analyze_frame
from ..gpu.me import hme_search

# full-res halo rows the 3-level HME needs (reach ~44 rows at the default
# n=16, r=4; see gpu.me.hme_search), rounded up to one 64-row slab
HALO = 64


def make_mesh(n_devices: int | None = None, gop: int | None = None):
    """The (gop, tile) DeviceMesh over the process group's ranks: gop
    defaults to 2 where the count is even and above 1, the rest becomes
    tile shards. n_devices, where given, must be the world size (every
    rank is one device of the mesh). The device type follows the
    backend: cuda under NCCL, cpu otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh: {n} devices in a world of {world} "
                         f"ranks (every rank is one device of the mesh)")
    if gop is None:
        gop = 2 if n % 2 == 0 and n > 1 else 1
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (gop, n // gop),
                            mesh_dim_names=("gop", "tile"))


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _exchange_halo(x: torch.Tensor, h: int, mesh):
    """(top, bottom) slabs of h rows for this rank's shard x: the last h
    rows of the tile neighbour above and the first h rows of the one
    below, sent and received in one batch_isend_irecv (peers as global
    ranks). A shard at the picture's top or bottom edge replicates its own
    boundary row instead, as lax.ppermute + jnp.where do in the JAX
    package."""
    g, t = mesh.get_coordinate()
    grid = mesh.mesh
    nt = grid.shape[1]
    x = x.contiguous()
    top = bot = None
    ops = []
    if t > 0:
        up = int(grid[g, t - 1])
        top = torch.empty_like(x[:h])
        ops += [dist.P2POp(dist.isend, x[:h].contiguous(), up),
                dist.P2POp(dist.irecv, top, up)]
    if t < nt - 1:
        down = int(grid[g, t + 1])
        bot = torch.empty_like(x[-h:])
        ops += [dist.P2POp(dist.isend, x[-h:].contiguous(), down),
                dist.P2POp(dist.irecv, bot, down)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if top is None:
        top = x[:1].expand(h, *x.shape[1:])
    if bot is None:
        bot = x[-1:].expand(h, *x.shape[1:])
    return top, bot


def sharded_hme(src_local: torch.Tensor, ref_local: torch.Tensor, mesh,
                n: int = 16, r: int = 4):
    """Row-sharded hierarchical ME. src_local / ref_local: this rank's
    rows of the (H, W) source and reference, tile shard t of the tile
    axis (H a multiple of 64 * tile shards; ranks of one tile index on
    other gop rows hold the same rows). Each rank searches its rows
    against its halo-extended slab (hme_search, three K1 launches) and
    crops HALO // n block rows from each side. Returns (mv_q, sad) of
    this shard's block rows, as hme_search does for a whole picture.
    Block MVs whose search reaches across the picture edge may differ from
    hme_search of the whole picture in the outermost block rows (the halo
    replicates full-res edge rows where the whole-picture search clamps
    decimated planes); both are valid ME seeds."""
    s_loc = src_local.to(torch.float32)
    r_loc = ref_local.to(torch.float32)
    st, sb = _exchange_halo(s_loc, HALO, mesh)
    rt, rb = _exchange_halo(r_loc, HALO, mesh)
    mv, sad = hme_search(torch.cat([st, s_loc, sb]),
                         torch.cat([rt, r_loc, rb]), n, r)
    k = HALO // n
    nb = s_loc.shape[0] // n
    return mv[k:k + nb], sad[k:k + nb]


def _tile_allgather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """(..., H/tile, W) shards of the tile group -> (..., H, W)."""
    group = mesh.get_group("tile")
    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-2)


def frontend_step(mesh):
    """The multi-device frontend step. Returns step(frames_local) ->
    (out, total, first):

    frames_local is this rank's block of the (B, H, W) batch, sharded as
    the JAX package shards it: pictures over the gop axis, rows over the
    tile axis, so (B / gop, H / tile, W). The tile group all-gathers its
    rows into whole pictures and shares the gop row's pictures out, so
    tile rank t analyzes B / (gop * tile) of them (B divisible by the
    world size). out: gpu.analysis.analyze_frame of each of those
    pictures, stacked per key; first: the batch index of the first of
    them; total: the rate proxy (the sum of every picture's cost4..32
    maps, summed in float64 and all_reduced over the whole mesh, which is
    exact for the costs' 1/8 steps, then rounded to float32 once as the
    JAX step's float32 total; equal to it under every compile at the
    tests' size), a Python float on every rank."""
    def step(frames_local: torch.Tensor):
        tile = mesh.shape[1]
        g, t = mesh.get_coordinate()
        whole = _tile_allgather_rows(frames_local, mesh)
        per = whole.shape[0] // tile
        if per * tile != whole.shape[0]:
            raise ValueError(f"frontend_step: {whole.shape[0]} pictures per "
                             f"gop share do not divide over {tile} tiles")
        mine = whole[t * per:(t + 1) * per]
        outs = [analyze_frame(p) for p in mine]
        out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        part = sum(out[f"cost{k}"].to(torch.float64).sum()
                   for k in (4, 8, 16, 32))
        total = part.reshape(1).to(_device(mesh))
        dist.all_reduce(total)
        return (out, float(total[0].to(torch.float32)),
                g * whole.shape[0] + t * per)

    return step


def gop_encode_step(mesh):
    """The multi-device encode step: the whole phase-plane P picture
    (gpu.encode.fast_p_fused_packed at CTB 32, 8-bit) on each rank's
    share of B independent pictures, the gop and tile axes flattened onto
    the batch in rank order. Returns step(src3, ref3, hme_mv, qp, qp_c)
    -> (B, N) int16 packed buffers (gpu.encode.fused_specs layout) on
    every rank. src3 / ref3: (y (b, H, W), cb (b, H/2, W/2), cr) and
    hme_mv (b, H/16, W/16, 2): this rank's b = B / world pictures, batch
    indices rank * b .. rank * b + b - 1. qp / qp_c: shared ints or 0-d
    integer tensors."""
    from ..gpu.encode import fast_p_fused_packed

    def step(src3, ref3, hme_mv, qp, qp_c):
        qp, qp_c = int(qp), int(qp_c)
        h, w = src3[0].shape[1:]
        local = torch.stack([
            fast_p_fused_packed(src3[0][b], src3[1][b], src3[2][b],
                                ref3[0][b], ref3[1][b], ref3[2][b],
                                hme_mv[b], qp, qp_c, ctb_log2=5, w=w, h=h,
                                bit_depth=8)
            for b in range(src3[0].shape[0])])
        # int16 is no collective type of gloo or NCCL: gather as int32
        local = local.to(torch.int32)
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, local)
        return torch.cat(parts).to(torch.int16)

    return step
