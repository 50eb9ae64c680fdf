"""The port's mesh sharding (svt_hevc_tpu_torch.parallel.mesh) on four
gloo ranks against svt_hevc_tpu.parallel on its 8-device CPU mesh.

Each test spawns 4 CPU processes once (torch.distributed over gloo, a
file init_method under tmp_path, a 60 s collective timeout), lays them
out as the port's (gop, tile) mesh, and compares what the ranks write
with the JAX package's functions on the same seeded numpy inputs. A
bounded join fails the test, rather than hanging, when a rank stalls.

Tolerances: make_mesh's axes, every MV and every packed encode buffer
exact; sharded_hme's SAD exact (as tests/test_torch_me.py holds
hme_search's); frontend_step's per-picture analysis as
tests/test_torch_analysis_helpers.py holds analyze_frame's (the block
variances, host-dependent in the reference, equal to the exact values
rounded once, with the JAX values under three compiles within their
measured spread; the rest exact), and its total exact (the port's exact
float64 sum rounded to float32 once is the JAX step's float32 total
under each of three compiles, tests/test_torch_float32_sites.py).
"""

import time
from datetime import timedelta

import numpy as np
import pytest
import torch

WORLD = 4
JOIN_LIMIT_S = 120


# ----------------------------------------------------------- rank side

def _inputs(job: str, tile: int):
    """The seeded numpy inputs of a job (the same on every rank and in the
    test)."""
    rng = np.random.default_rng({"hme": 3, "frontend": 5, "encode": 3}[job])
    if job == "hme":
        h, w = 64 * tile, 128
        ref = rng.integers(0, 255, (h, w)).astype(np.float32)
        src = np.roll(np.roll(ref, 6, axis=0), -3, axis=1)
        return src, ref
    if job == "frontend":
        return rng.integers(0, 255, (4, 64 * tile, 128)).astype(np.int32)
    b, h, w = WORLD, 128, 128
    srcs = rng.integers(0, 255, (b, h, w)).astype(np.int32)
    refs = np.roll(srcs, (0, 3, -2), (0, 1, 2))
    csrc = rng.integers(0, 255, (b, h // 2, w // 2)).astype(np.int32)
    cref = np.roll(csrc, (0, 1, -1), (0, 1, 2))
    return srcs, refs, csrc, cref


def _rank_main(rank, init_file, out_dir, job, gop):
    import torch.distributed as dist

    from svt_hevc_tpu_torch.parallel import mesh as M

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        mesh = M.make_mesh(WORLD, gop=gop)
        g, t = mesh.get_coordinate()
        res = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
               "coord": (g, t)}
        tile = mesh.shape[1]
        if job == "hme":
            src, ref = _inputs(job, tile)
            rows = slice(t * 64, (t + 1) * 64)
            mv, sad = M.sharded_hme(torch.from_numpy(src[rows]),
                                    torch.from_numpy(ref[rows]), mesh)
            top, bot = M._exchange_halo(torch.from_numpy(src[rows]), M.HALO,
                                        mesh)
            res.update(mv=mv.numpy(), sad=sad.numpy(), top=top.numpy(),
                       bot=bot.numpy())
        elif job == "frontend":
            frames = _inputs(job, tile)
            bg = frames.shape[0] // mesh.shape[0]
            rows = frames.shape[1] // tile
            local = frames[g * bg:(g + 1) * bg, t * rows:(t + 1) * rows]
            out, total, first = M.frontend_step(mesh)(torch.from_numpy(local))
            res.update(out={k: v.numpy() for k, v in out.items()},
                       total=total, first=first)
        else:
            from svt_hevc_tpu_torch.gpu.me import hme_search
            srcs, refs, csrc, cref = _inputs(job, tile)
            b = slice(rank, rank + 1)
            mv = torch.stack([hme_search(torch.from_numpy(srcs[rank]),
                                         torch.from_numpy(refs[rank]))[0]])
            got = M.gop_encode_step(mesh)(
                tuple(torch.from_numpy(a[b]) for a in (srcs, csrc, csrc)),
                tuple(torch.from_numpy(a[b]) for a in (refs, cref, cref)),
                mv, torch.tensor(30), 31)
            res.update(packed=got.numpy(), mv=mv.numpy())
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _run_ranks(tmp_path, job, gop=None):
    """Spawn WORLD ranks once; join with a bound, kill on expiry."""
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(str(tmp_path / "init"), str(tmp_path), job, gop),
        nprocs=WORLD, join=False, start_method="spawn")
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() - t0 > JOIN_LIMIT_S:
                pytest.fail(f"{job}: ranks still running after "
                            f"{JOIN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


# ----------------------------------------------------------- test side

def _jax_mesh(gop=None):
    import jax

    from svt_hevc_tpu.parallel import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    return make_mesh(WORLD, gop=gop)


@pytest.mark.parametrize("gop", [None, 1])
def test_sharded_hme_and_make_mesh_match_jax(tmp_path, gop):
    """make_mesh's axes; sharded_hme on every block row, with the tile
    axis 2 (two edge shards) and 4 (interior shards with both
    neighbours); the exchanged halo rows themselves."""
    import jax.numpy as jnp

    from svt_hevc_tpu.parallel import sharded_hme

    jmesh = _jax_mesh(gop)
    res = _run_ranks(tmp_path, "hme", gop)
    shape = (jmesh.shape["gop"], jmesh.shape["tile"])
    tile = shape[1]
    for r, got in enumerate(res):
        assert got["shape"] == shape and got["names"] == ("gop", "tile")
        assert got["coord"] == (r // tile, r % tile)
    src, ref = _inputs("hme", tile)
    mv_j, sad_j = sharded_hme(jnp.asarray(src), jnp.asarray(ref), jmesh)
    for g in range(shape[0]):
        row = [res[g * tile + t] for t in range(tile)]
        np.testing.assert_array_equal(
            np.concatenate([x["mv"] for x in row]), np.asarray(mv_j))
        np.testing.assert_array_equal(
            np.concatenate([x["sad"] for x in row]), np.asarray(sad_j))
        for t, x in enumerate(row):
            up = src[t * 64 - 64:t * 64] if t else np.repeat(src[:1], 64, 0)
            down = (src[(t + 1) * 64:(t + 2) * 64] if t < tile - 1
                    else np.repeat(src[-1:], 64, 0))
            np.testing.assert_array_equal(x["top"], up)
            np.testing.assert_array_equal(x["bot"], down)
    assert np.abs(np.asarray(mv_j)).max() > 0


def test_frontend_step_matches_jax_analyze_frame(tmp_path):
    """Each rank's pictures equal JAX analyze_frame of the whole picture;
    the mesh-wide total equals the JAX frontend_step's."""
    import jax
    import jax.numpy as jnp

    from svt_hevc_tpu.parallel import frontend_step
    from svt_hevc_tpu.tpu.analysis import analyze_frame
    from tests.test_torch_float32_sites import (assert_host_dependent,
                                                np_block_variance)

    jmesh = _jax_mesh()
    res = _run_ranks(tmp_path, "frontend")
    frames = _inputs("frontend", 2)
    step, in_sh = frontend_step(jmesh)
    _, total_j = step(jax.device_put(jnp.asarray(frames, jnp.float32),
                                     in_sh))
    firsts = sorted(x["first"] for x in res)
    assert firsts == list(range(frames.shape[0]))
    for got in res:
        assert got["total"] == float(total_j)
        i = got["first"]
        want = analyze_frame(jnp.asarray(frames[i], jnp.float32))
        assert set(got["out"]) == set(want)
        for k, w in want.items():
            g = got["out"][k][0]
            if k.startswith("var"):
                n = int(k[3:])
                assert_host_dependent(f"af_var{n}/af_frontend_{i}",
                                      "frontend", g,
                                      np_block_variance(frames[i], n))
            else:
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


def test_gop_encode_step_matches_jax_per_picture(tmp_path):
    """Every picture's packed buffer, gathered on every rank, equals JAX
    fast_p_fused_packed of that picture (and the JAX gop_encode_step)."""
    import jax.numpy as jnp

    from svt_hevc_tpu.parallel import gop_encode_step
    from svt_hevc_tpu.tpu.encode import fast_p_fused_packed

    jmesh = _jax_mesh()
    res = _run_ranks(tmp_path, "encode")
    srcs, refs, csrc, cref = _inputs("encode", 2)
    mvs = np.concatenate([x["mv"] for x in res])
    for got in res:
        assert got["packed"].shape[0] == WORLD
        np.testing.assert_array_equal(got["packed"], res[0]["packed"])
    step, _ = gop_encode_step(jmesh)
    want_all = np.asarray(step(
        tuple(jnp.asarray(a) for a in (srcs, csrc, csrc)),
        tuple(jnp.asarray(a) for a in (refs, cref, cref)), jnp.asarray(mvs),
        jnp.int32(30), jnp.int32(31)))
    for b in range(WORLD):
        want = np.asarray(fast_p_fused_packed(
            jnp.asarray(srcs[b]), jnp.asarray(csrc[b]), jnp.asarray(csrc[b]),
            jnp.asarray(refs[b]), jnp.asarray(cref[b]), jnp.asarray(cref[b]),
            jnp.asarray(mvs[b]), jnp.int32(30), jnp.int32(31), ctb_log2=5,
            w=128, h=128, bit_depth=8))
        np.testing.assert_array_equal(res[0]["packed"][b], want, err_msg=b)
        np.testing.assert_array_equal(want_all[b], want, err_msg=b)
