"""Headless batch path-trace renderer -- the RTCamp contest binary
(RTCamp.cpp:25-210): frames [begin, end), per-frame re-voxelization at an
animated grid resolution (dps lerped from boxWide/fromRes to boxWide/toRes),
N path-trace steps of 16 spp each, async PNG writeback overlapping the next
frame's scene decode, per-frame stats line.

Frame-range partitioning across machines (the reference's run.py SSH split)
is the --frame-range flag: run one process per host/slice over DCN.

Usage:
  python -m massivevoxelraytracing_tpu.apps.rtcamp --frame-range 0 8 \
      --frames 24 --width 480 --height 300 --steps 2 --out out/anim
"""

from __future__ import annotations

import argparse
import os
import queue
import threading
import time

import numpy as np

from ..utils import runtime

runtime.setup()

from ..models import accel as accel_lib, scene  # noqa: E402
from ..models.pathtracer import PathTracer  # noqa: E402
from ..ops import camera as camera_ops  # noqa: E402
from ..utils import hdr, meshgen, png  # noqa: E402
from .scenes import animated_scene  # noqa: E402


def next_power_of_two(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frame-range", nargs=2, type=int, default=None,
                    metavar=("BEGIN", "END"))
    ap.add_argument("--frames", type=int, default=24, help="total frames")
    ap.add_argument("--scene", default="torus")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--steps", type=int, default=2,
                    help="PT steps per frame (16 spp each; reference uses 8)")
    ap.add_argument("--from-res", type=int, default=128)
    ap.add_argument("--to-res", type=int, default=256)
    ap.add_argument("--lens-r", type=float, default=0.0)
    ap.add_argument(
        "--accel", choices=accel_lib.ACCEL_KINDS,
        default=accel_lib.DEFAULT_ACCEL,
    )
    ap.add_argument("--hdri", default="procedural",
                    help="'procedural', 'none', or a .hdr path")
    ap.add_argument("--profile", default=None, help="jax.profiler trace dir")
    ap.add_argument(
        "--build-devices", type=int, default=0,
        help="shard the per-frame scene build over N devices "
             "(parallel/build.py; 0 = single-device build)",
    )
    ap.add_argument("--out", default="out/anim")
    args = ap.parse_args(argv)

    begin, end = args.frame_range or (0, args.frames)
    os.makedirs(args.out, exist_ok=True)

    # async PNG writer thread (RTCamp.cpp:173-193's ThreadPool role)
    wq: "queue.Queue[tuple[str, np.ndarray] | None]" = queue.Queue(maxsize=4)

    def writer():
        while True:
            item = wq.get()
            if item is None:
                return
            path, img = item
            png.write(path, img)

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()

    pt = PathTracer(width=args.width, height=args.height)
    pt.setup()
    if args.hdri == "procedural":
        env = hdr.procedural_sky(512, 256)
        pt.load_hdri(env, env)
    elif args.hdri != "none":
        env = hdr.read_hdr(args.hdri)
        pt.load_hdri(env, env)

    # decode the first frame (loadSceneFrame(beginFrame))
    tri, col, emi = animated_scene(args.scene, begin, args.frames)

    sw_total = time.time()
    for frame in range(begin, end):
        t_frame = time.time()
        # animated resolution sweep (RTCamp.cpp:140-142)
        lo, hi = meshgen.mesh_bounds(tri)
        box_wide = float((hi - lo).max()) * 1.02
        mix = frame / max(args.frames, 1)
        dps = (box_wide / args.from_res) * (1 - mix) + (box_wide / args.to_res) * mix
        grid_res = next_power_of_two(int(np.ceil(box_wide / dps)))
        origin = (lo + hi) * 0.5 - grid_res * dps * 0.5

        t0 = time.time()
        if args.build_devices > 1:
            from ..parallel import build as pbuild

            tree = pbuild.build_scene_sharded(
                tri, col, emi, origin=origin, dps=dps, grid_res=grid_res,
                accel=args.accel, n_devices=args.build_devices,
            )
        else:
            tree = scene.build_scene(
                tri, col, emi, origin=origin, dps=dps, grid_res=grid_res,
                accel=args.accel,
            )
        t_update = time.time() - t0

        center = origin + grid_res * dps * 0.5
        cam = camera_ops.Camera.look_at(
            eye=center + np.array([0.9, 0.5, 1.6]) * box_wide,
            target=center,
            fovy_deg=40.0,
            lens_r=args.lens_r,
        )

        t0 = time.time()
        pt.update_scene(tree)
        pt.clear_frame_buffer()
        for _ in range(args.steps):
            pt.step(cam)

        # decode NEXT frame while the device renders (RTCamp.cpp:161)
        if frame + 1 < end:
            tri, col, emi = animated_scene(args.scene, frame + 1, args.frames)

        img = pt.resolve()
        t_render = time.time() - t0

        wq.put((os.path.join(args.out, f"{frame:03d}.png"), img))
        # per-phase build split (the reference's per-frame stats line,
        # RTCamp.cpp:144-152, plus our build_stats): frames after the
        # first in a pow2 bucket measure the WARM per-frame rebuild
        st = getattr(tree, "build_stats", None) or {}
        phases = (
            f" [split {st['t_split_s']:.2f} count {st['t_count_s']:.2f}"
            f" unique {st['t_unique_s']:.2f} accel {st['t_accel_s']:.2f}"
            f" vox {st['n_unique']/1e6:.1f}M]" if st else ""
        )
        print(
            f"[frame {frame}] res( {grid_res} ) total( {time.time()-sw_total:.1f} s ) "
            f"/ update {t_update:.3f} / render {t_render:.3f}{phases}",
            flush=True,
        )

    wq.put(None)
    wt.join()
    print(f"[rtcamp] {end - begin} frames -> {args.out}")


if __name__ == "__main__":
    main()
