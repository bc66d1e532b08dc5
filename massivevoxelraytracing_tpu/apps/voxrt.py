"""Headless ray-cast lab (the voxRT/voxRTGPU apps, voxRT.cpp:59-428):
voxelize a scene, build the SVO/DAG, render primary rays with normal or
voxel-color shading, and write PNGs. `--oracle` also renders the same frame
with the brute-force AABB intersector (the Embree stand-in) and reports the
pixel A/B difference -- the reference's dual-intersector fidelity harness.

Usage:
  python -m massivevoxelraytracing_tpu.apps.voxrt --scene torus --res 256 \
      --width 640 --height 360 --mode color --out out/
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils import runtime

runtime.setup()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ..models import accel as accel_lib, cpu_oracle, raycast, scene  # noqa: E402
from ..ops import camera as camera_ops  # noqa: E402
from ..ops import morton  # noqa: E402
from ..utils import meshgen, png  # noqa: E402
from .scenes import load_scene  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="torus",
                    help="torus|sphere|bumpy|soup or a path to .obj/.ply")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--mode", choices=["normal", "color"], default="normal")
    ap.add_argument("--six-separating", type=int, default=1)
    ap.add_argument("--dag", type=int, default=1)
    ap.add_argument("--wire", action="store_true",
                    help="burn a depth-tested voxel wireframe overlay into "
                    "the output (drawVoxelsWire equivalent)")
    ap.add_argument("--wire-max", type=int, default=4096,
                    help="max voxels drawn by --wire")
    ap.add_argument("--oracle-pixels", type=int, default=2048,
                    help="pixels A/B'd by --oracle (full frame if smaller)")
    ap.add_argument("--oracle", action="store_true",
                    help="A/B against the brute-force intersector")
    ap.add_argument(
        "--accel", choices=accel_lib.ACCEL_KINDS,
        default=accel_lib.DEFAULT_ACCEL,
    )
    ap.add_argument("--profile", default=None, help="jax.profiler trace dir")
    ap.add_argument("--out", default="out")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    tri, colors, emissions = load_scene(args.scene)
    origin, dps = meshgen.fit_grid(tri, args.res)

    sw = runtime.Stopwatch()
    tree = scene.build_scene(
        tri, colors, emissions,
        origin=origin, dps=dps, grid_res=args.res,
        six_separating=bool(args.six_separating), dag=bool(args.dag),
        accel=args.accel,
    )
    t_build = sw.lap("build", tree.bricks if hasattr(tree, "bricks") else tree.meta)

    lo = np.asarray(origin)
    extent = float(dps) * args.res
    center = lo + extent / 2
    cam = camera_ops.Camera.look_at(
        eye=center + np.array([0.8, 0.55, 1.6]) * extent,
        target=center,
        fovy_deg=40.0,
    )
    with runtime.profile(args.profile):
        img, depth = raycast.render_frame(
            tree, cam, args.width, args.height, show_color=(args.mode == "color")
        )
    jax.block_until_ready(depth)
    t_render = sw.lap("render", depth)
    img = np.asarray(img)

    out_path = os.path.join(args.out, "voxrt.png")
    png.write(out_path, img)
    print(
        f"[voxrt] res({args.res}) voxels({tree.n_voxels}) nodes({tree.n_nodes}) "
        f"octree({tree.memory_bytes()/1e6:.1f} MB) / "
        f"build {t_build*1e3:.1f} ms / render {t_render*1e3:.1f} ms -> {out_path}"
    )

    if args.wire:
        # drawVoxelsWire equivalent (voxUtil.hpp:79-127): depth-tested voxel
        # wireframe burned into the PNG
        from ..utils import wireframe

        m64, _, _ = cpu_oracle.voxelize_mesh(
            tri, origin, dps, args.res, True, colors, emissions
        )
        img = np.array(img)  # np.asarray over a device buffer is read-only
        wireframe.draw_voxels_wire(
            img, np.asarray(depth), cam, m64, lo, dps,
            max_voxels=args.wire_max,
        )
        wire_path = os.path.join(args.out, "voxrt_wire.png")
        png.write(wire_path, img)
        print(f"[voxrt] wire overlay -> {wire_path}")

    if args.oracle:
        # Rebuild the voxel list host-side and A/B pixels against the
        # brute-force slab oracle: the FULL frame when small enough,
        # otherwise a large random sample (round-1 checked only 200)
        m64, _, _ = cpu_oracle.voxelize_mesh(
            tri, origin, dps, args.res, True, colors, emissions
        )
        n_pix = args.width * args.height
        if n_pix <= args.oracle_pixels:
            sel = np.arange(n_pix)
        else:
            rng = np.random.default_rng(0)
            sel = rng.choice(n_pix, args.oracle_pixels, replace=False)
        n_check = len(sel)
        ro, rd = _pixel_rays(cam, args.width, args.height, sel)
        dn = np.asarray(depth).reshape(-1)[sel]
        bad = 0
        for i in range(n_check):
            to, _, _ = cpu_oracle.intersect_brute_force(m64, lo, dps, ro[i], rd[i])
            dev_hit = dn[i] < 1e37
            if dev_hit != np.isfinite(to):
                bad += 1
            elif dev_hit and not np.isclose(dn[i], to, rtol=3e-5, atol=1e-6):
                bad += 1
        print(f"[voxrt] oracle A/B: {n_check - bad}/{n_check} pixels agree")
        if bad > n_check // 50:
            raise SystemExit("oracle mismatch beyond tolerance")


def _pixel_rays(cam, width, height, sel):
    px = (sel % width).astype(np.int32)
    py = (sel // width).astype(np.int32)
    ro, rd = camera_ops.shoot(
        cam, jnp.asarray(px), jnp.asarray(py), 0.5, 0.5, width, height
    )
    return np.asarray(ro), np.asarray(rd)


if __name__ == "__main__":
    main()
