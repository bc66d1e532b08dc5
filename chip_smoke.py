"""Bring-up check of the renderer on the GPU.

Drives the main path once through the entry points a user calls, at the
reference's headline scale, and checks every result against the repo's
independent references (the numpy oracles and the octree walker):

  python chip_smoke.py               one GPU: device, oracle, build, primary,
                                     pt, app
  python chip_smoke.py --four-cards  four GPUs of one host: the sharded
                                     build, primary frame and PT step, each
                                     against its one-card result

Each phase prints one line with its result, its wall time and the card's
name and power limit. When every phase passed, the last line is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU, or when any check fails, it exits non-zero before that line.
The phase functions take their sizes as arguments, so the tests run them at
toy size on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))  # tiecheck, test_pathtracer

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from massivevoxelraytracing_tpu.models import accel as accel_lib  # noqa: E402
from massivevoxelraytracing_tpu.models import raycast, scene  # noqa: E402
from massivevoxelraytracing_tpu.models.pathtracer import PathTracer  # noqa: E402
from massivevoxelraytracing_tpu.ops import camera as camera_ops  # noqa: E402
from massivevoxelraytracing_tpu.utils import hdr, meshgen, runtime  # noqa: E402

# Unique voxels of meshgen.sphere_lattice(6, 4) at 2048^3: a property of the
# scene and the voxelizer, not of the device (54,443,818 from the same XLA
# voxelizer on another backend).
LATTICE_2048_UNIQUE = 54_443_818


def voxel_band(n: int) -> int:
    """Allowed voxel-count difference between two voxelizations of the same
    mesh: cells whose coverage predicate sits on an exact float tie can flip
    when the compiler contracts a multiply-add differently (FMA on the GPU,
    none in numpy). Same band as tests/test_voxelize.py."""
    return max(2, n // 1000)


# Relative tolerance on hit distance between two walkers (tests/tiecheck.py
# defaults): the same slab arithmetic, fused differently by each compiler.
T_RTOL = 1e-5


def card_info() -> str:
    """Card name and power limit, read once in a child process that does not
    touch JAX (so it never competes for the card's memory)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return " | ".join(lines) if lines else "nvidia-smi gave no card"


def peak_gib() -> float | None:
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return None if peak is None else peak / 2**30


def timed(fn, *args, reps: int = 1):
    """(result, seconds per call) of fn(*args), each call ending on the
    device (block_until_ready)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return out, (time.perf_counter() - t0) / reps


def bench_camera(grid_res: int, dps: float, origin=(0.0, 0.0, 0.0)):
    """The benchmark's view of the sphere lattice (bench.py)."""
    extent = float(dps) * grid_res
    center = np.asarray(origin, np.float32) + extent / 2
    return camera_ops.Camera.look_at(
        eye=center + np.array([0.9, 0.4, 1.4]) * extent * 0.9,
        target=center, fovy_deg=40.0,
    )


def cam_args(cam):
    return (jnp.asarray(cam.o), jnp.asarray(cam.right), jnp.asarray(cam.up),
            jnp.asarray(cam.front), jnp.float32(cam.tan_half_fovy))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def device_phase(platform: str = "gpu"):
    d = jax.devices()
    if d[0].platform != platform:
        raise SystemExit(
            f"chip_smoke needs a {platform} device; JAX found "
            f"{d[0].platform} ({d[0].device_kind})"
        )
    return dict(platform=d[0].platform, kind=d[0].device_kind,
                count=len(d), jax=jax.__version__)


def oracle_phase(grid_res: int = 128, n_side: int = 64):
    """Small scenes against the numpy references."""
    import test_pathtracer
    import tiecheck
    from massivevoxelraytracing_tpu.models import cpu_oracle
    from massivevoxelraytracing_tpu.utils import meshprep

    # voxelize an icosphere on the device vs cpu_oracle.voxelize_mesh on the
    # same split triangles
    tri = meshgen.icosphere(3, radius=0.9)
    origin, dps = meshgen.fit_grid(tri, grid_res)
    tri, _, _ = meshprep.split_to_cap(
        tri, np.ones_like(tri), np.zeros_like(tri), origin, dps, grid_res, 4
    )
    uniq, _ = scene.voxelize_unique(
        tri, origin=origin, dps=dps, grid_res=grid_res)
    m_dev = unique_mortons(uniq)
    m_ora, _, _ = cpu_oracle.voxelize_mesh(tri, origin, dps, grid_res, True)
    n_diff = len(np.setxor1d(m_dev, m_ora))
    if n_diff > voxel_band(len(m_ora)):
        raise AssertionError(
            f"voxel sets differ by {n_diff} of {len(m_ora)} "
            f"(band {voxel_band(len(m_ora))})")

    # BrickTree hits of n_side^2 camera rays vs the brute-force slab oracle;
    # every disagreement must classify as a tie or a grazing touch
    tree = scene.build_accel_from_unique(
        uniq, origin=jnp.asarray(origin), dps=dps, grid_res=grid_res,
        accel="brick",
    )
    extent = float(dps) * grid_res
    center = np.asarray(origin) + extent / 2
    cam = camera_ops.Camera.look_at(
        eye=center + np.array([0.8, 0.5, 1.5]) * extent, target=center)
    ro, rd = camera_ops.np_frame_rays(cam, n_side, n_side)
    t, nmaj, vidx = (np.asarray(x) for x in accel_lib.intersect(tree, ro, rd))
    n_tie = tiecheck.classify_all_vs_oracle(
        m_dev, origin, dps, ro, rd, t, nmaj, vidx)

    # analytic transport scenes, with those tests' own tolerances
    test_pathtracer.test_white_furnace()
    test_pathtracer.test_half_sky_floor_analytic_half_albedo()
    return dict(voxels=len(m_ora), voxel_diff=n_diff, rays=len(ro),
                rays_hit=int((t < 1e37).sum()), rays_tie_classified=n_tie,
                white_furnace="ok", half_sky_floor="ok")


def unique_mortons(uniq) -> np.ndarray:
    """The sorted unique voxel stream on the host, as u64 Morton codes."""
    from massivevoxelraytracing_tpu.ops import morton

    n = int(uniq["n_unique"])
    return morton.np_unpack_pair(
        np.asarray(uniq["m_hi"][:n]), np.asarray(uniq["m_lo"][:n]))


def build_lattice(mesh, grid_res: int, accel: str):
    tri, cols = mesh
    return scene.build_scene(
        tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / grid_res,
        grid_res=grid_res, accel=accel, chunk_tris=262144,
    )


def build_phase(mesh, grid_res: int, expect_unique: int | None = None):
    """The full-width scene through build_scene(..., accel="brick")."""
    tree = build_lattice(mesh, grid_res, "brick")
    st = tree.build_stats
    if expect_unique is not None:
        diff = abs(st["n_unique"] - expect_unique)
        if diff > voxel_band(expect_unique):
            raise AssertionError(
                f"{st['n_unique']} unique voxels, expected {expect_unique} "
                f"+- {voxel_band(expect_unique)}")
    info = dict(st, peak_gib=peak_gib())
    return tree, info


@partial(jax.jit, static_argnames=("kind", "depth", "width", "height"))
def _walk_frame(meta, root, lower, upper, cam, *, kind, depth, width, height):
    """The rays render_frame traces (tile-major), through one walker."""
    ro, rd = raycast._gen_rays_tiled(*cam, width=width, height=height)
    return accel_lib.intersect_with(
        kind, depth, meta, root, lower, upper, ro, rd)


def _untile(x, width: int, height: int):
    tile = raycast.TILE
    ntx, nty = -(-width // tile), -(-height // tile)
    y = np.asarray(x).reshape(nty, ntx, tile, tile).transpose(0, 2, 1, 3)
    return y.reshape(nty * tile, ntx * tile)[:height, :width]


def primary_phase(tree, mesh, grid_res: int, width: int, height: int,
                  reps: int = 5):
    """render_frame over the brick tree, timed, then checked ray by ray
    against the octree walker over an octree built from the same voxel
    stream."""
    import tiecheck

    cam = bench_camera(grid_res, 1.0 / grid_res)
    _, compile_s = timed(raycast.render_frame, tree, cam, width, height)
    (img, depth), frame_s = timed(
        raycast.render_frame, tree, cam, width, height, reps=reps)
    depth = np.asarray(depth)

    tri, cols = mesh
    dps = 1.0 / grid_res
    origin = np.zeros(3, np.float32)
    uniq, _ = scene.voxelize_unique(
        tri, cols, origin=origin, dps=dps, grid_res=grid_res,
        chunk_tris=262144)
    if int(uniq["n_unique"]) != tree.n_voxels:
        raise AssertionError("octree and brick builds saw different voxels")
    octree = scene.build_accel_from_unique(
        uniq, origin=jnp.asarray(origin), dps=dps, grid_res=grid_res,
        accel="octree")
    m_sorted = unique_mortons(uniq)
    del uniq
    walks = []
    for tr in (tree, octree):
        kind, d, meta, root = accel_lib.accel_args(tr)
        walks.append([np.asarray(x) for x in _walk_frame(
            meta, root, tr.lower, tr.upper, cam_args(cam),
            kind=kind, depth=d, width=width, height=height)])
    del octree
    (tb, mb, vb), (to, mo, vo) = walks
    ro, rd = (np.asarray(x) for x in raycast._gen_rays_tiled(
        *cam_args(cam), width=width, height=height))
    # at 2048^3 the two walkers' float paths differ enough that a ray
    # grazing a voxel edge can count as a touch in one and not the other;
    # every such ray must prove it (tests/tiecheck.py)
    extent = float(jnp.max(tree.upper - tree.lower))  # the larger root box
    n_classified = tiecheck.classify_walkers_vs_each_other(
        m_sorted, origin, dps, extent, ro, rd, tb, mb, vb, to, mo, vo,
        rtol=T_RTOL)
    if n_classified > max(2, tb.size // 100):  # the CPU tests' bound
        raise AssertionError(
            f"{n_classified} of {tb.size} rays needed classifying")
    # the rendered depth image is the brick walk's t, untiled. The two are
    # separate compilations of the same walk, so a ray grazing an edge
    # within an ulp may flip; more than one pixel in 10^4 is a fault.
    d_walk = _untile(tb, width, height)
    hit = depth < 1e37
    same = (hit == (d_walk < 1e37)) & (
        ~hit | np.isclose(depth, d_walk, rtol=T_RTOL))
    if (~same).sum() > max(2, same.size // 10_000):
        raise AssertionError(
            f"render_frame depth differs from its walk on {(~same).sum()} "
            f"pixels")
    return dict(width=width, height=height, compile_s=compile_s,
                frame_ms=frame_s * 1e3, reps=reps,
                hit_frac=float(hit.mean()),
                rays=int(tb.size), rays_classified=n_classified,
                peak_gib=peak_gib())


def pt_phase(tree, grid_res: int, width: int, height: int, steps: int = 2):
    """PathTracer.step (16 spp) under the benchmark's gradient sky: one
    warm-up step, then `steps` timed steps."""
    pt = PathTracer(width=width, height=height)
    pt.setup()
    pt.load_hdri(hdr.gradient_sky())
    pt.update_scene(tree)
    cam = bench_camera(grid_res, 1.0 / grid_res)
    t0 = time.perf_counter()
    pt.step(cam)
    jax.block_until_ready(pt.accum)
    first_s = time.perf_counter() - t0
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        pt.step(cam)
        jax.block_until_ready(pt.accum)
        step_s.append(time.perf_counter() - t0)
    acc = np.asarray(pt.accum)
    if acc.shape != (width * height, 4) or not np.isfinite(acc).all():
        raise AssertionError("accumulator not finite or misshapen")
    if not np.all(acc[:, 3] == pt.n_batch_spp * pt.steps):
        raise AssertionError("spp column is not 16 per step")
    mean = float((acc[:, :3] / acc[:, 3:]).mean())
    if not mean > 0.01:
        raise AssertionError(f"black frame (mean radiance {mean})")
    return dict(width=width, height=height, spp_per_step=pt.n_batch_spp,
                first_step_s=first_s,
                step_s=step_s,
                mean_radiance=mean, peak_gib=peak_gib())


def app_phase(out_dir: str, width: int, height: int, from_res: int,
              to_res: int, frames: int = 2, scene_name: str = "lattice"):
    """apps/rtcamp.py in this process: re-voxelize + rebuild + one PT step
    per frame, PNGs written by its async writer."""
    from massivevoxelraytracing_tpu.apps import rtcamp
    from massivevoxelraytracing_tpu.utils import png

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rtcamp.main([
            "--scene", scene_name, "--frames", str(frames),
            "--width", str(width), "--height", str(height), "--steps", "1",
            "--from-res", str(from_res), "--to-res", str(to_res),
            "--out", out_dir,
        ])
    log = buf.getvalue()
    print(log, end="", flush=True)
    stats = re.findall(
        r"^\[frame (\d+)\] res\( (\d+) \).*/ update ([0-9.]+) / render "
        r"([0-9.]+)", log, re.M)
    if [int(s[0]) for s in stats] != list(range(frames)):
        raise AssertionError(f"missing per-frame stats lines:\n{log}")
    for f in range(frames):
        img = png.read(os.path.join(out_dir, f"{f:03d}.png"))
        if img.shape != (height, width, 3):
            raise AssertionError(f"frame {f}: PNG shape {img.shape}")
    return dict(frames=[dict(frame=int(f), res=int(r), update_s=float(u),
                             render_s=float(t)) for f, r, u, t in stats],
                peak_gib=peak_gib())


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def sharded_build_phase(mesh, grid_res: int, n_devices: int):
    """parallel/build.py over n_devices against the one-card build."""
    from massivevoxelraytracing_tpu.parallel import build as pbuild

    t0 = time.perf_counter()
    one = build_lattice(mesh, grid_res, "brick")
    one_s = time.perf_counter() - t0
    tri, cols = mesh
    t0 = time.perf_counter()
    sh = pbuild.build_scene_sharded(
        tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / grid_res,
        grid_res=grid_res, accel="brick", n_devices=n_devices,
        chunk_tris=262144,
    )
    sh_s = time.perf_counter() - t0
    n1, n2 = one.build_stats["n_unique"], sh.build_stats["n_unique"]
    if abs(n1 - n2) > voxel_band(n1):
        raise AssertionError(f"sharded build: {n2} voxels vs {n1}")
    # a voxel that flips at a float tie can add or drop at most one node per
    # tree level, so equal voxel counts must give equal node counts
    if abs(one.n_nodes - sh.n_nodes) > one.n_levels * abs(n1 - n2):
        raise AssertionError(
            f"sharded build: {sh.n_nodes} nodes vs {one.n_nodes}")
    return one, dict(voxels_one=n1, voxels_sharded=n2, nodes_one=one.n_nodes,
                     nodes_sharded=sh.n_nodes, first_build_one_s=one_s,
                     first_build_sharded_s=sh_s)


def _rank_image_to_vidx(img) -> np.ndarray:
    """Voxel rank from a frame shaded with a color table whose entry k
    packs k (show_color=True): the 24 bits come back byte by byte."""
    img = np.asarray(img).astype(np.uint32).reshape(-1, 3)
    return img[:, 0] | (img[:, 1] << 8) | (img[:, 2] << 16)


def sharded_primary_phase(tree, mesh, grid_res: int, width: int,
                          height: int, n_devices: int, reps: int = 3):
    """parallel/render.py's tile-row bands over every card against
    render_frame on one card. Both shade with a color table that encodes
    each voxel's rank, so each pixel's hit voxel can be compared and every
    disagreement classified (tests/tiecheck.py)."""
    import dataclasses

    import tiecheck
    from massivevoxelraytracing_tpu.parallel import mesh as mesh_lib
    from massivevoxelraytracing_tpu.parallel import render as prender

    if tree.n_voxels >= 1 << 24:
        raise ValueError("voxel ranks must fit the 24-bit color encoding")
    cam = bench_camera(grid_res, 1.0 / grid_res)
    ranks = jnp.arange(tree.n_voxels, dtype=jnp.uint32)
    rank_tree = dataclasses.replace(tree, color=ranks)
    kind, depth, meta, root = accel_lib.accel_args(tree)
    render = prender.make_sharded_render(
        mesh_lib.make_mesh(n_devices), width=width, height=height,
        kind=kind, depth=depth, show_color=True)
    args = (meta, root, tree.lower, tree.upper, ranks, *cam_args(cam))
    timed(raycast.render_frame, rank_tree, cam, width, height, True)
    (img1, t1), one_s = timed(raycast.render_frame, rank_tree, cam, width,
                              height, True, reps=reps)
    _, compile_s = timed(render, *args)
    (img2, t2), sh_s = timed(render, *args, reps=reps)

    tri, cols = mesh
    dps = 1.0 / grid_res
    origin = np.zeros(3, np.float32)
    uniq, _ = scene.voxelize_unique(
        tri, cols, origin=origin, dps=dps, grid_res=grid_res,
        chunk_tris=262144)
    m_sorted = unique_mortons(uniq)
    ro, rd = (np.stack([_untile(x[:, k], width, height).reshape(-1)
                        for k in range(3)], -1)
              for x in raycast._gen_rays_tiled(
                  *cam_args(cam), width=width, height=height))
    t1, t2 = np.asarray(t1).reshape(-1), np.asarray(t2).reshape(-1)
    z = np.zeros(t1.shape, np.int32)
    n_classified = tiecheck.classify_walkers_vs_each_other(
        m_sorted, origin, dps, float(jnp.max(tree.upper - tree.lower)),
        ro, rd, t1, z, _rank_image_to_vidx(img1),
        t2, z, _rank_image_to_vidx(img2), rtol=T_RTOL)
    return dict(frame_one_ms=one_s * 1e3,
                frame_sharded_ms=sh_s * 1e3,
                sharded_compile_s=compile_s,
                rays_classified=n_classified)


# Sharded vs one-card PT step, same (pixel, sample) indices. Per lane the
# arithmetic is the same, but the two programs fuse it differently (FMA
# contraction) and sum the 16 samples in another order (4 per card, then a
# psum): that moves radiance by a few ulp, and a ulp can flip a hit at a
# voxel edge so that one sample of a pixel takes another path. Hence: the
# frame means agree to 1e-4 relative, and at most 0.5% of pixels differ by
# more than 1e-3 relative.
PT_MEAN_RTOL = 1e-4
PT_PIXEL_RTOL = 1e-3
PT_PIXEL_FRAC = 5e-3


def sharded_pt_phase(tree, grid_res: int, width: int, height: int,
                     n_devices: int):
    """parallel/render.py's sharded 16-spp step (pixels on 'dp', spp on 'sp'
    with a psum) against PathTracer.step on one card."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from massivevoxelraytracing_tpu.models.pathtracer import N_BATCH_SPP
    from massivevoxelraytracing_tpu.ops import hdri as hdri_ops
    from massivevoxelraytracing_tpu.parallel import mesh as mesh_lib
    from massivevoxelraytracing_tpu.parallel import render as prender

    cam = bench_camera(grid_res, 1.0 / grid_res)
    sky = hdr.gradient_sky()
    pt = PathTracer(width=width, height=height)
    pt.setup()
    pt.load_hdri(sky)
    pt.update_scene(tree)
    _, one_first_s = timed(lambda: (pt.step(cam), pt.accum)[1])
    ref = np.asarray(pt.accum)

    m = mesh_lib.make_mesh(n_devices)
    sp = m.devices.shape[1]
    n = width * height
    kind, depth, meta, root = accel_lib.accel_args(tree)
    step = prender.make_sharded_pt_step(
        m, stack_depth=depth, spp_per_device=N_BATCH_SPP // sp, width=width,
        height=height, n_pixels=n, has_emission=tree.has_emission,
        hdri_enabled=True, accel_kind=kind,
    )
    args = (
        meta, root, tree.lower, tree.upper, tree.color, tree.emission,
        pt.pmj_table, hdri_ops.load(sky, scale=1.75), *cam_args(cam)[:4],
        jnp.float32(cam.tan_half_fovy), jnp.float32(cam.lens_r),
        jnp.float32(cam.focus),
        jax.device_put(jnp.zeros((n, 4), jnp.float32), NamedSharding(m, P("dp"))),
        jnp.uint32(0),
    )
    compiled = step.lower(*args).compile()
    mem = compiled.memory_analysis()
    out, sh_s = timed(compiled, *args)
    got = np.asarray(out)
    if not np.all(got[:, 3] == N_BATCH_SPP) or not np.isfinite(got).all():
        raise AssertionError("sharded step: spp column or finiteness")
    a, b = ref[:, :3], got[:, :3]
    mean_rel = abs(b.mean() - a.mean()) / max(abs(a.mean()), 1e-12)
    far = np.abs(b - a) > PT_PIXEL_RTOL * np.maximum(np.abs(a), 1.0)
    frac = float(far.any(-1).mean())
    if mean_rel > PT_MEAN_RTOL or frac > PT_PIXEL_FRAC:
        raise AssertionError(
            f"sharded PT step: mean rel diff {mean_rel:.2e}, "
            f"{frac:.4%} pixels beyond {PT_PIXEL_RTOL}")
    return dict(mesh=dict(zip(m.axis_names, m.devices.shape)),
                step_one_first_s=one_first_s,
                step_sharded_s=sh_s, mean_rel_diff=float(mean_rel),
                pixels_beyond_tol=frac,
                temp_gib_per_card=mem.temp_size_in_bytes / 2**30
                if mem is not None else None)


# ---------------------------------------------------------------------------

def run_phase(card: str, name: str, fn, *args, **kw):
    """Run one phase and print its line. A failing phase prints its line and
    re-raises, so the script exits non-zero before the result line."""
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kw)
    except BaseException:
        print(f"[chip_smoke] {name} FAILED wall_s="
              f"{time.perf_counter() - t0:.3f} card=\"{card}\"", flush=True)
        raise
    info = out[-1] if isinstance(out, tuple) else out
    print(f"[chip_smoke] {name} ok wall_s={time.perf_counter() - t0:.3f} "
          f"card=\"{card}\" {json.dumps(info)}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)
    runtime.setup()

    card = card_info()
    print(f"[chip_smoke] card {card}", flush=True)
    dev = run_phase(card, "device", device_phase)
    mesh = meshgen.sphere_lattice(6, 4)  # 24.4M triangles after the split
    if args.four_cards:
        if dev["count"] < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found {dev['count']}")
        tree, _ = run_phase(card, "sharded_build", sharded_build_phase,
                            mesh, 1024, 4)
        run_phase(card, "sharded_primary", sharded_primary_phase,
                  tree, mesh, 1024, 1920, 1080, 4)
        run_phase(card, "sharded_pt", sharded_pt_phase,
                  tree, 1024, 1920, 1080, 4)
    else:
        run_phase(card, "oracle", oracle_phase)
        tree, _ = run_phase(card, "build", build_phase, mesh, 2048,
                            LATTICE_2048_UNIQUE)
        run_phase(card, "primary", primary_phase, tree, mesh, 2048, 1920, 1080)
        del tree
        tree = build_lattice(mesh, 1024, "brick")
        run_phase(card, "pt", pt_phase, tree, 1024, 1920, 1080)
        del tree
        run_phase(card, "app", app_phase,
                  os.path.join(ROOT, "out", "chip_smoke"), 1440, 900, 1024, 2048)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))


if __name__ == "__main__":
    main()
