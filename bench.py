"""Headline benchmark: primary-ray throughput on a dragon-class scene.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}. Baseline (BASELINE.md): the reference casts 1920x1080 primary rays
over the 2048^3 dragon (55M voxels) in ~2 ms ~= 1.0 Grays/s on an RX 7900
XTX. vs_baseline = our Mrays/s / 1000.

Scene: meshgen.sphere_lattice -- occupancy matches the dragon's density at
every resolution (54.4M unique voxels at 2048^3 vs the dragon's 55M;
~13.6M at the default 1024^3, i.e. the dragon scaled by (res/2048)^2).

A path-traced stage runs after the primary stage and lands in the same
JSON line as pt_* fields: one 16-spp PathTracer step at the same frame size
over the same lattice tree under a gradient sky, counting all traced rays
(1 primary + 8 bounces x (1 NEE any-hit + 1 BSDF) = 17 rays/sample).
Reference: ~200 ms / 16 spp at 1080p over 41M voxels (seminar slide 67).

Runs on a GPU only: on any other platform it exits non-zero.

Environment knobs:
  MVRT_BENCH_RES   grid resolution (default 1024)
  MVRT_BENCH_W/H   frame size (default 1920x1080)
  MVRT_BENCH_ITERS timed frames (default 4)
  MVRT_BENCH_ACCEL brick (default) | octree
  MVRT_BENCH_SCENE lattice (default) | sphere (round-1's weak stand-in)
  MVRT_BENCH_PT    0 disables the path-traced stage (default on)
  MVRT_BENCH_PT_ITERS timed PT steps after the warm step (default 2)
  MVRT_BENCH_BUILD 0 disables the rebuild stage (default on): one cold +
                   one warm scene rebuild of the same lattice mesh,
                   reported as build_ms (warm; the per-frame rebuild cost
                   rtcamp pays -- reference: 135 ms voxelize+build @41M
                   voxels, IntersectorOctreeGPU.hpp:40-241, slide 67)
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from massivevoxelraytracing_tpu.utils import runtime  # noqa: E402

runtime.setup()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from massivevoxelraytracing_tpu.models import accel as accel_lib  # noqa: E402
from massivevoxelraytracing_tpu.models import raycast, scene  # noqa: E402
from massivevoxelraytracing_tpu.ops import camera as camera_ops  # noqa: E402
from massivevoxelraytracing_tpu.utils import hdr, meshgen  # noqa: E402


def device_fields():
    """The device every number below was measured on. Card name and power
    limit come from nvidia-smi in a child process."""
    d = jax.devices()
    if d[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {d[0].platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "device_count": len(d), "nvidia_smi": smi}


def main():
    device = device_fields()
    grid_res = int(os.environ.get("MVRT_BENCH_RES", 1024))
    width = int(os.environ.get("MVRT_BENCH_W", 1920))
    height = int(os.environ.get("MVRT_BENCH_H", 1080))
    iters = int(os.environ.get("MVRT_BENCH_ITERS", 4))
    accel = os.environ.get("MVRT_BENCH_ACCEL", accel_lib.DEFAULT_ACCEL)
    scene_kind = os.environ.get("MVRT_BENCH_SCENE", "lattice")
    if scene_kind == "lattice":
        tri, cols = meshgen.sphere_lattice(6, 4)
        origin = np.zeros(3, np.float32)
        dps = 1.0 / grid_res
        chunk = 262144
    else:
        tri = meshgen.bumpy_sphere(
            int(os.environ.get("MVRT_BENCH_SUBDIV", 5)), radius=0.9
        )
        cols = None
        origin, dps = meshgen.fit_grid(tri, grid_res)
        chunk = 65536
    t0 = time.time()
    tree = scene.build_scene(
        tri, cols, origin=origin, dps=dps, grid_res=grid_res, accel=accel,
        chunk_tris=chunk,
    )
    build_s = time.time() - t0

    lo = np.asarray(origin)
    extent = float(dps) * grid_res
    center = lo + extent / 2
    cam = camera_ops.Camera.look_at(
        eye=center + np.array([0.9, 0.4, 1.4]) * extent * 0.9,
        target=center,
        fovy_deg=40.0,
    )

    def frame():
        _, depth = raycast.render_frame(tree, cam, width, height)
        return jax.block_until_ready(depth)

    t0 = time.time()
    depth = frame()
    compile_s = time.time() - t0
    t0 = time.time()
    for _ in range(iters):
        depth = frame()
    dt = (time.time() - t0) / iters

    mrays = width * height / dt / 1e6
    hit_frac = float(jnp.mean((depth < 1e37).astype(jnp.float32)))
    sys.stderr.write(
        f"[bench] res={grid_res} accel={accel} voxels={tree.n_voxels} "
        f"nodes={tree.n_nodes} build={build_s:.1f}s compile={compile_s:.1f}s "
        f"frame={dt*1e3:.1f}ms hit={hit_frac:.2f}\n"
    )

    fields = {}
    if os.environ.get("MVRT_BENCH_PT", "1") != "0":
        fields.update(pt_stage(tree, cam, width, height, grid_res))
    if (os.environ.get("MVRT_BENCH_BUILD", "1") != "0"
            and scene_kind == "lattice"):
        fields.update(build_stage(tri, cols, dps, grid_res, chunk, accel))
    print(
        json.dumps(
            {
                "metric": (
                    f"primary Mrays/s @{grid_res}^3 dragon-occupancy "
                    f"sphere lattice ({tree.n_voxels/1e6:.1f}M voxels), "
                    f"{width}x{height}, {accel}"
                    if scene_kind == "lattice" else
                    f"primary Mrays/s @{grid_res}^3 procedural "
                    f"dragon-standin, {width}x{height}, {accel}"
                ),
                "value": round(mrays, 2),
                "unit": "Mrays/s",
                "vs_baseline": round(mrays / 1000.0, 4),
                "frame_ms": round(dt * 1e3, 3),
                "compile_s": round(compile_s, 3),
                "device": device,
                **fields,
            }
        )
    )


def build_stage(tri, cols, dps, grid_res, chunk, accel):
    """Cold + warm scene rebuild of the bench lattice mesh (per-frame
    rebuild cost). The warm build is what an animated frame pays: jit
    compiles (or .jax_cache loads) are all charged to the cold build. The
    mesh is jittered so no result can be cached."""
    times = []
    stats = None
    for i in range(2):
        jitter = np.float32(1e-4) * np.float32(i)
        t0 = time.time()
        tree = scene.build_scene(
            tri + jitter, cols, origin=np.zeros(3, np.float32), dps=dps,
            grid_res=grid_res, accel=accel, chunk_tris=chunk,
        )
        times.append(time.time() - t0)
        stats = tree.build_stats
    sys.stderr.write(
        f"[bench-build] res={grid_res} tris={stats['n_triangles']/1e6:.2f}M "
        f"cold={times[0]:.1f}s warm={times[1]:.2f}s "
        f"(split={stats['t_split_s']:.2f} count={stats['t_count_s']:.2f} "
        f"unique={stats['t_unique_s']:.2f} accel={stats['t_accel_s']:.2f})\n"
    )
    return {
        "build_ms": round(times[1] * 1e3, 1),
        "build_cold_s": round(times[0], 1),
        "build_metric": (
            f"warm full scene rebuild @{grid_res}^3 lattice "
            f"({stats['n_triangles']/1e6:.2f}M tris -> "
            f"{stats['n_unique']/1e6:.1f}M voxels; reference: 135 ms "
            f"@41M voxels)"
        ),
    }


def pt_stage(tree, cam, width, height, grid_res):
    """Timed 16-spp PathTracer steps over the same tree, gradient sky.

    Rays per sample: 1 primary + MAX_BOUNCES x (NEE any-hit + BSDF) = 17
    (the lattice has no emissive voxels, so no extra implicit ray).
    Reference point: 200 ms / 16 spp at 1080p over 41M voxels
    (seminar_ushio.pdf slide 67) ~= 2800 Mrays/s counted the same way.
    """
    from massivevoxelraytracing_tpu.models.pathtracer import (
        MAX_BOUNCES, PathTracer,
    )

    iters = int(os.environ.get("MVRT_BENCH_PT_ITERS", 2))
    pt = PathTracer(width=width, height=height)
    pt.setup()
    pt.load_hdri(hdr.gradient_sky())
    pt.update_scene(tree)
    t0 = time.time()
    pt.step(cam)
    jax.block_until_ready(pt.accum)
    first_s = time.time() - t0
    t0 = time.time()
    for _ in range(iters):
        pt.step(cam)
    jax.block_until_ready(pt.accum)
    dt = (time.time() - t0) / iters
    n_spp = pt.n_batch_spp
    rays = width * height * n_spp * (1 + 2 * MAX_BOUNCES)
    mean_rad = float(jnp.mean(pt.accum[:, :3]))
    sys.stderr.write(
        f"[bench-pt] res={grid_res} {width}x{height} {n_spp}spp: "
        f"{dt:.3f} s/step (first {first_s:.1f}s) mean={mean_rad:.4f}\n"
    )
    return {
        "pt_metric": (
            f"path-traced {n_spp}-spp step @{grid_res}^3 lattice, "
            f"{width}x{height}, sky NEE any-hit, {1 + 2 * MAX_BOUNCES} "
            f"rays/sample (reference: 0.2 s @1080p/41M voxels)"
        ),
        "pt_s_per_step": round(dt, 3),
        "pt_first_step_s": round(first_s, 3),
        "pt_mrays": round(rays / dt / 1e6, 2),
    }


if __name__ == "__main__":
    main()
