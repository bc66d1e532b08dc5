"""Golden-image regression (VERDICT round-1 item: the reference's culture is
pixel A/B + render_first.png eyeballing, voxRT.cpp:316-323 / voxPTGPU.cpp:196;
here the goldens are committed and asserted).

Goldens are rendered by THIS implementation on the CPU test backend and
stored in tests/golden/*.npz. The tests assert near-exact agreement (small
tolerance for cross-version XLA FMA-contraction drift) so any transport or
traversal change that moves pixels fails loudly. Regenerate intentionally
with:  python tests/test_golden.py regen
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

if __name__ == "__main__":
    # standalone regen must run on the SAME platform as the pytest compare
    # (conftest forces CPU; mirror conftest exactly)
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

from massivevoxelraytracing_tpu.models import raycast, scene
from massivevoxelraytracing_tpu.models.pathtracer import PathTracer
from massivevoxelraytracing_tpu.ops import camera as camera_ops
from massivevoxelraytracing_tpu.utils import meshgen

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _scene_and_cam(grid_res=64, accel="brick"):
    tri = meshgen.icosphere(3, radius=0.85)
    origin, dps = meshgen.fit_grid(tri, grid_res)
    lo, hi = meshgen.mesh_bounds(tri)
    col = meshgen.vertex_colors_from_position(tri, lo, hi)
    tree = scene.build_scene(
        tri, col, np.zeros_like(tri),
        origin=origin, dps=dps, grid_res=grid_res, accel=accel,
    )
    center = np.asarray(origin) + 0.5 * float(dps) * grid_res
    extent = float(dps) * grid_res
    cam = camera_ops.Camera.look_at(
        eye=center + np.array([0.8, 0.5, 1.5]) * extent * 0.9,
        target=center, fovy_deg=40.0,
    )
    return tree, cam


def _render_primary(mode):
    tree, cam = _scene_and_cam()
    img, _ = raycast.render_frame(tree, cam, 128, 96, show_color=(mode == "color"))
    return np.asarray(img)


def _render_pt():
    tree, cam = _scene_and_cam(grid_res=32)
    pt = PathTracer(width=96, height=64, packet=1 << 15)
    pt.setup()
    h, w = 16, 32
    ang = np.linspace(0, np.pi, h)[:, None]
    sky = np.stack(
        [np.broadcast_to(0.6 + 0.4 * np.cos(ang), (h, w))] * 3, -1
    ).astype(np.float32)
    pt.load_hdri(sky)
    pt.update_scene(tree)
    pt.step(cam, n_spp=4)
    return np.asarray(pt.resolve()).reshape(64, 96, 3)


CASES = {
    "primary_normal": lambda: _render_primary("normal"),
    "primary_color": lambda: _render_primary("color"),
    "pt_4spp": _render_pt,
}


def _check(name, img):
    path = os.path.join(GOLDEN_DIR, name + ".npz")
    assert os.path.exists(path), f"golden {path} missing; run regen"
    ref = np.load(path)["img"]
    assert img.shape == ref.shape, f"{name}: shape {img.shape} vs {ref.shape}"
    diff = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    # u8 images: allow tiny ulp-level drift on a few boundary pixels, fail
    # on anything that moves real pixels
    frac_off = (diff.max(axis=-1) > 2).mean()
    assert frac_off < 0.002, (
        f"{name}: {frac_off*100:.2f}% of pixels moved by >2/255 "
        f"(max diff {diff.max()})"
    )


def test_golden_primary_normal():
    _check("primary_normal", CASES["primary_normal"]())


def test_golden_primary_color():
    _check("primary_color", CASES["primary_color"]())


def test_golden_pt():
    _check("pt_4spp", CASES["pt_4spp"]())


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        for name, fn in CASES.items():
            img = fn()
            np.savez_compressed(
                os.path.join(GOLDEN_DIR, name + ".npz"), img=img
            )
            print(f"wrote {name}: {img.shape}")
