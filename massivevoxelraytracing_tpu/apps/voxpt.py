"""Progressive path-trace viewer, headless (the voxPTGPU dev app,
voxPTGPU.cpp:11-277): accumulate 16 spp per step on a static frame, save
`render_first.png` at exactly 16 spp (the reference's regression artifact,
voxPTGPU.cpp:196-199) and periodic snapshots; print the live stats the ImGui
panel would show (voxel count, octree bytes, per-phase ms). Supports
checkpoint/resume of the accumulation state.

Usage:
  python -m massivevoxelraytracing_tpu.apps.voxpt --scene torus --res 256 \
      --width 640 --height 360 --steps 8 --out out/pt
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..utils import runtime

runtime.setup()

import jax  # noqa: E402

from ..config import EngineConfig  # noqa: E402
from ..models import accel as accel_lib, scene  # noqa: E402
from ..models.pathtracer import PathTracer  # noqa: E402
from ..ops import camera as camera_ops  # noqa: E402
from ..utils import hdr, meshgen, png  # noqa: E402
from .scenes import load_scene  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="torus")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--steps", type=int, default=8, help="16 spp each")
    ap.add_argument("--six-separating", type=int, default=1)
    ap.add_argument("--dag", type=int, default=1)
    ap.add_argument("--lens-r", type=float, default=0.0)
    ap.add_argument("--hdri", default="procedural")
    ap.add_argument("--snapshot-every", type=int, default=4)
    ap.add_argument("--resume", default=None, help="checkpoint .npz to resume")
    ap.add_argument("--checkpoint", default=None, help="write checkpoint here")
    ap.add_argument(
        "--accel", choices=accel_lib.ACCEL_KINDS,
        default=accel_lib.DEFAULT_ACCEL,
    )
    ap.add_argument("--profile", default=None, help="jax.profiler trace dir")
    ap.add_argument(
        "--build-devices", type=int, default=0,
        help="shard the scene build over N devices (0 = single-device)",
    )
    ap.add_argument("--out", default="out/pt")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    cfg = EngineConfig(
        six_separating=bool(args.six_separating),
        dag=bool(args.dag),
        lens_r=args.lens_r,
    )

    tri, col, emi = load_scene(args.scene)
    origin, dps = meshgen.fit_grid(tri, args.res)

    sw = runtime.Stopwatch()
    build_kw = dict(
        origin=origin, dps=dps, grid_res=args.res,
        six_separating=cfg.six_separating, dag=cfg.dag, cap=cfg.cap,
        chunk_tris=cfg.chunk_tris, accel=args.accel,
    )
    if args.build_devices > 1:
        from ..parallel import build as pbuild

        tree = pbuild.build_scene_sharded(
            tri, col, emi, n_devices=args.build_devices, **build_kw
        )
    else:
        tree = scene.build_scene(tri, col, emi, **build_kw)
    t_build = sw.lap("build", tree.bricks if hasattr(tree, "bricks") else tree.meta)
    print(
        f"[voxpt] res({args.res}) voxels({tree.n_voxels}) nodes({tree.n_nodes}) "
        f"octree({tree.memory_bytes()/1e6:.2f} MB) emissive({tree.has_emission}) "
        f"build {t_build*1e3:.1f} ms"
    )

    pt = PathTracer(
        width=args.width, height=args.height,
        emission_scale=cfg.emission_scale, packet=cfg.ray_packet,
        max_bounces=cfg.max_bounces, n_batch_spp=cfg.n_batch_spp,
        use_pmj=cfg.use_pmj,
    )
    pt.setup()
    if args.hdri == "procedural":
        env = hdr.procedural_sky(512, 256)
        pt.load_hdri(env, env, scale=cfg.hdri_scale)
    elif args.hdri != "none":
        env = hdr.read_hdr(args.hdri)
        pt.load_hdri(env, env, scale=cfg.hdri_scale)
    pt.update_scene(tree)

    extent = float(dps) * args.res
    center = np.asarray(origin) + extent / 2
    cam = camera_ops.Camera.look_at(
        eye=center + np.array([0.8, 0.55, 1.6]) * extent,
        target=center,
        fovy_deg=cfg.fovy_deg,
        lens_r=cfg.lens_r,
    )

    start_step = 0
    if args.resume:
        pt.load_checkpoint(args.resume)
        start_step = pt.steps
        print(f"[voxpt] resumed at {start_step * 16} spp")


    prof = runtime.profile(args.profile)
    prof.__enter__()
    for step in range(start_step, args.steps):
        t0 = time.time()
        pt.step(cam)
        jax.block_until_ready(pt.accum)
        dt = time.time() - t0
        spp = pt.steps * 16
        print(f"[voxpt] step {step}: +16 spp -> {spp} spp ({dt*1e3:.1f} ms)")
        if spp == 16:
            png.write(os.path.join(args.out, "render_first.png"), pt.resolve())
        if args.snapshot_every and (step + 1) % args.snapshot_every == 0:
            png.write(
                os.path.join(args.out, f"snapshot_{spp:04d}spp.png"), pt.resolve()
            )
        if args.checkpoint:
            pt.save_checkpoint(args.checkpoint)

    prof.__exit__(None, None, None)
    png.write(os.path.join(args.out, "render_final.png"), pt.resolve())
    print(f"[voxpt] {pt.steps * 16} spp -> {args.out}/render_final.png")


if __name__ == "__main__":
    main()
