"""Path-tracer integration tests: white-furnace energy conservation,
emissive-voxel transport, progressive accumulation semantics."""

import numpy as np
import jax.numpy as jnp
import pytest

from massivevoxelraytracing_tpu.models import scene
from massivevoxelraytracing_tpu.models.pathtracer import PathTracer
from massivevoxelraytracing_tpu.ops import camera as camera_ops
from massivevoxelraytracing_tpu.utils import meshgen

W, H = 64, 48


def make_pt(tree, env_img=None, env_scale=1.0):
    pt = PathTracer(width=W, height=H, packet=1024)
    pt.pmj_table = jnp.asarray(
        np.random.default_rng(0).random((128, 4096, 2), np.float32)
    )  # random table is fine for integration tests (pmj tested separately)
    pt.setup()
    if env_img is not None:
        pt.load_hdri(env_img, scale=env_scale)
    pt.update_scene(tree)
    return pt


def sphere_scene(grid_res=32, emissive=False, albedo=1.0):
    tri = meshgen.icosphere(3, radius=0.8)
    origin, dps = meshgen.fit_grid(tri, grid_res)
    col = np.full_like(tri, albedo)
    emi = np.full_like(tri, 0.4 if emissive else 0.0)
    tree = scene.build_scene(
        tri, col, emi, origin=origin, dps=dps, grid_res=grid_res
    )
    return tree, origin, dps


def look_cam(origin, dps, grid_res, dist=2.2):
    extent = float(dps) * grid_res
    center = np.asarray(origin) + extent / 2
    return camera_ops.Camera.look_at(
        eye=center + np.array([0.0, 0.3, 1.0]) * extent * dist,
        target=center,
        fovy_deg=35.0,
    )


def test_white_furnace():
    # albedo-1 sphere in a uniform unit environment: every pixel converges
    # to the env radiance (bounded bounce truncation + MC noise allowed)
    tree, origin, dps = sphere_scene(grid_res=32, albedo=1.0)
    env = np.ones((16, 32, 3), np.float32)
    pt = make_pt(tree, env, env_scale=1.0)
    cam = look_cam(origin, dps, 32)
    pt.step(cam, n_spp=8)
    acc = np.asarray(pt.accum)
    val = acc[:, :3] / acc[:, 3:4]
    mean = val.mean()
    assert abs(mean - 1.0) < 0.08, mean
    # no fireflies / NaNs
    assert np.isfinite(val).all()
    assert val.max() < 4.0


def test_dark_env_black_image():
    tree, origin, dps = sphere_scene(grid_res=16)
    pt = make_pt(tree, None)  # no HDRI: enabled() false, black env
    cam = look_cam(origin, dps, 16)
    pt.step(cam, n_spp=2)
    acc = np.asarray(pt.accum)
    assert np.allclose(acc[:, :3], 0.0)


def test_emissive_voxels_light_the_scene():
    tree, origin, dps = sphere_scene(grid_res=16, emissive=True, albedo=0.7)
    assert tree.has_emission
    pt = make_pt(tree, None)
    cam = look_cam(origin, dps, 16)
    pt.step(cam, n_spp=4)
    acc = np.asarray(pt.accum)
    val = acc[:, :3] / acc[:, 3:4]
    # primary hits see raw (unscaled) emission 0.4; some indirect on top
    img = val.reshape(H, W, 3)
    center = img[H // 2 - 4 : H // 2 + 4, W // 2 - 4 : W // 2 + 4]
    assert center.mean() > 0.3
    assert np.isfinite(val).all()


def test_progressive_accumulation_and_resolve():
    tree, origin, dps = sphere_scene(grid_res=16)
    env = np.ones((8, 16, 3), np.float32) * 0.5
    pt = make_pt(tree, env)
    cam = look_cam(origin, dps, 16)
    pt.step(cam, n_spp=2)
    assert pt.steps == 1
    n1 = np.asarray(pt.accum)[:, 3]
    assert np.all(n1 == 2)
    pt.step(cam, n_spp=2)
    assert np.all(np.asarray(pt.accum)[:, 3] == 4)
    img = pt.resolve()
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    # background pixels = gamma(0.5)
    want = int(255 * 0.5 ** (1 / 2.2) + 0.5)
    corner = img[0, 0]
    assert abs(int(corner[0]) - want) <= 2
    pt.clear_frame_buffer()
    assert pt.steps == 0 and np.all(np.asarray(pt.accum) == 0)


def test_compaction_is_bit_identical(monkeypatch):
    """Inter-bounce octant compaction is a pure lane permutation, so the
    radiance must match the unpermuted loop to the ulp. (Exact bit equality
    is not attainable across two separately compiled graphs: the permutation
    moves XLA fusion boundaries and with them FMA contraction -- measured
    max drift 2e-6 on 0.7% of elements, i.e. 1 ulp at this magnitude.)"""
    import jax
    from massivevoxelraytracing_tpu.models import pathtracer as ptm

    tree, origin, dps = sphere_scene(emissive=True)
    cam = look_cam(origin, dps, 32)
    env = np.full((8, 16, 3), 0.8, np.float32)

    def run():
        pt = make_pt(tree, env_img=env)
        pt.step(cam, n_spp=2)
        return np.asarray(pt.accum)

    monkeypatch.setattr(ptm, "COMPACT_MIN_LANES", 1 << 62)  # force OFF
    ref = run()
    jax.clear_caches()  # same static args would otherwise reuse the trace
    monkeypatch.setattr(ptm, "COMPACT_MIN_LANES", 1)  # force ON
    got = run()
    jax.clear_caches()
    np.testing.assert_allclose(ref, got, rtol=1e-6, atol=4e-6)
    frac_off = np.mean(ref != got)
    assert frac_off < 0.05, f"{frac_off:.3f} of elements drifted: not ulp noise"



@pytest.mark.parametrize(
    "tile_packets,spp_major,packet",
    [(False, False, 1 << 16), (False, True, 1 << 16), (True, False, 1 << 16),
     (True, True, 4096)],
    ids=["scanline-sppminor", "scanline-sppmajor", "tiled-sppminor",
         "tiled-sppmajor-2packets"],
)
def test_packet_layouts_are_pure_relabelings(tile_packets, spp_major, packet):
    """Tile order, spp-major lanes and the pixel-packet split only relabel
    (pixel, sample) lanes, so on a ragged 37x29 frame every layout gives
    the default layout's radiance (to the ulp, as in the compaction test)."""
    tree, origin, dps = sphere_scene(grid_res=16, emissive=True)
    cam = look_cam(origin, dps, 16)
    env = np.full((8, 16, 3), 0.8, np.float32)

    def run(**kw):
        pt = PathTracer(width=37, height=29, **kw)
        pt.pmj_table = make_pt(tree).pmj_table
        pt.setup()
        pt.load_hdri(env, scale=1.0)
        pt.update_scene(tree)
        pt.step(cam, n_spp=2)
        return np.asarray(pt.accum)

    ref = run()  # defaults: tiled, spp-major, one packet
    got = run(tile_packets=tile_packets, spp_major=spp_major, packet=packet)
    assert np.all(got[:, 3] == 2)
    np.testing.assert_allclose(ref, got, rtol=1e-6, atol=4e-6)
    assert np.mean(ref != got) < 0.05


def test_half_sky_floor_analytic_half_albedo():
    """Analytic transport oracle with a NON-uniform environment (the
    white furnace cannot catch directional pdf/table errors -- any
    normalized sampler integrates a constant env to 1). A lambertian
    floor (albedo 1, normal +Y) under an azimuthal HALF sky (E=1 over
    half the azimuth, 0 over the other) receives exactly

        L = (a/pi) * int cos(theta) * [half-space] domega = a/2

    by symmetry, for ANY azimuthal split. Bounce rays leave the flat
    floor upward and terminate on the env WITHOUT contribution (env
    radiance enters only via the primary miss and NEE, matching the
    reference's transport, voxKernel.cu:678-716), so the expectation is
    exact at every bounce depth. This pins the 7-table importance
    sampling, SAT normalization, pdf, and NEE geometry to an analytic
    value."""
    grid_res = 32
    # a big quad floor at y = 0.5, voxelized inside a unit grid
    lo, hi = 0.08, 0.92
    quad = np.asarray(
        [
            [[lo, 0.5, lo], [hi, 0.5, lo], [hi, 0.5, hi]],
            [[lo, 0.5, lo], [hi, 0.5, hi], [lo, 0.5, hi]],
        ],
        np.float32,
    )
    tree = scene.build_scene(
        quad, np.ones_like(quad), np.zeros_like(quad),
        origin=np.zeros(3, np.float32), dps=1.0 / grid_res,
        grid_res=grid_res,
    )
    env = np.zeros((16, 32, 3), np.float32)
    env[:, :16] = 1.0  # azimuthal half-sky
    pt = make_pt(tree, env, env_scale=1.0)
    cam = camera_ops.Camera.look_at(
        eye=np.array([0.5, 0.92, 0.5]), target=np.array([0.5, 0.5, 0.499]),
        fovy_deg=25.0,
    )
    for _ in range(4):
        pt.step(cam, n_spp=16)
    acc = np.asarray(pt.accum).reshape(H, W, 4)
    # central pixels look straight down at the floor
    c = acc[H // 2 - 8 : H // 2 + 8, W // 2 - 8 : W // 2 + 8]
    val = c[..., :3].sum() / c[..., 3].sum() / 3.0
    assert abs(val - 0.5) < 0.02, f"half-sky floor radiance {val} != 0.5"


def test_emissive_ceiling_analytic_radiance():
    """Quantitative emission-transport oracle: a black (albedo 0) ceiling
    emitting Le over an albedo-1 floor, black environment. A floor point
    whose upper hemisphere the ceiling covers receives exactly

        L = a * Le_eff,   Le_eff = emission_scale * packed(0.4)

    (one bounce; the a=0 ceiling reflects nothing, so no series). With
    the planes 1 voxel row apart and ~13:1 extent:gap, cosine-weighted
    coverage is sin^2(atan(13)) ~ 0.994. The emission reaches the
    estimator through BOTH the depth-0 extra implicit ray and the BSDF
    ray, each weighted 1/(1+n) (voxKernel.cu:720-759) -- this pins that
    averaging to unbiasedness plus the emission_scale wiring (7.5,
    IntersectorOctreeGPU.hpp:273)."""
    grid_res = 32
    lo, hi = 0.08, 0.92

    def quad(y):
        return np.asarray(
            [
                [[lo, y, lo], [hi, y, lo], [hi, y, hi]],
                [[lo, y, lo], [hi, y, hi], [lo, y, hi]],
            ],
            np.float32,
        )

    tri = np.concatenate([quad(16.2 / 32), quad(18.2 / 32)])
    col = np.zeros_like(tri)
    col[:2] = 1.0   # floor: albedo 1
    emi = np.zeros_like(tri)
    emi[2:] = 0.4   # ceiling: pure emitter
    tree = scene.build_scene(
        tri, col, emi, origin=np.zeros(3, np.float32), dps=1.0 / grid_res,
        grid_res=grid_res,
    )
    assert tree.has_emission
    env = np.zeros((8, 16, 3), np.float32)  # black sky
    pt = make_pt(tree, env, env_scale=1.0)
    cam = camera_ops.Camera.look_at(
        eye=np.array([0.5, 17.6 / 32, 0.5]),
        target=np.array([0.5, 0.5, 0.4999]),
        fovy_deg=20.0,
    )
    for _ in range(6):
        pt.step(cam, n_spp=16)
    acc = np.asarray(pt.accum).reshape(H, W, 4)
    c = acc[H // 2 - 8 : H // 2 + 8, W // 2 - 8 : W // 2 + 8]
    val = c[..., :3].sum() / c[..., 3].sum() / 3.0
    le_eff = 7.5 * (102 / 255.0)  # emission_scale * quantized 0.4
    assert abs(val / le_eff - 1.0) < 0.05, (val, le_eff)


def test_opaque_ceiling_blocks_sky_anyhit_shadows():
    """End-to-end occlusion oracle for the optimized ANY-HIT shadow path:
    an albedo-1 floor under a UNIFORM unit sky would converge to 1 (the
    furnace), but with an opaque non-emissive ceiling 1 voxel row above
    it, every NEE shadow ray is blocked and every bounce ray terminates
    on dark geometry: the floor must read ~0 (only the ~0.6% rim gap
    leaks). A shadow traversal that false-missed occluders would leak
    the full sky here."""
    grid_res = 32
    lo, hi = 0.08, 0.92

    def quad(y):
        return np.asarray(
            [
                [[lo, y, lo], [hi, y, lo], [hi, y, hi]],
                [[lo, y, lo], [hi, y, hi], [lo, y, hi]],
            ],
            np.float32,
        )

    tri = np.concatenate([quad(16.2 / 32), quad(18.2 / 32)])
    col = np.zeros_like(tri)
    col[:2] = 1.0   # floor: albedo 1; ceiling black, not emissive
    tree = scene.build_scene(
        tri, col, np.zeros_like(tri),
        origin=np.zeros(3, np.float32), dps=1.0 / grid_res,
        grid_res=grid_res,
    )
    env = np.ones((8, 16, 3), np.float32)  # unit sky everywhere
    pt = make_pt(tree, env, env_scale=1.0)
    cam = camera_ops.Camera.look_at(
        eye=np.array([0.5, 17.6 / 32, 0.5]),
        target=np.array([0.5, 0.5, 0.4999]),
        fovy_deg=20.0,
    )
    for _ in range(2):
        pt.step(cam, n_spp=16)
    acc = np.asarray(pt.accum).reshape(H, W, 4)
    c = acc[H // 2 - 8 : H // 2 + 8, W // 2 - 8 : W // 2 + 8]
    val = c[..., :3].sum() / c[..., 3].sum() / 3.0
    assert val < 0.02, f"occluded floor leaked {val} of the sky"
