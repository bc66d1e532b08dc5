"""Multi-chip sharding correctness: the ('dp','sp') sharded PT step must
reproduce the single-chip integrator (same PMJ streams, psum'd spp batch)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from massivevoxelraytracing_tpu.models import scene
from massivevoxelraytracing_tpu.models.pathtracer import pt_sample
from massivevoxelraytracing_tpu.models import accel as accel_lib
from massivevoxelraytracing_tpu.ops import camera as camera_ops
from massivevoxelraytracing_tpu.ops import hdri as hdri_ops, sampling
from massivevoxelraytracing_tpu.ops.hashing import hash_combine
from massivevoxelraytracing_tpu.parallel import mesh as mesh_lib
from massivevoxelraytracing_tpu.parallel import render as prender
from massivevoxelraytracing_tpu.utils import hdr, meshgen


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.parametrize("accel", ["octree", "brick"])
def test_sharded_pt_equals_single_chip(accel, monkeypatch):
    from massivevoxelraytracing_tpu.models import pathtracer as ptm

    # compaction on at this toy size too (it is on at real sizes): its sort
    # mixes per-pixel and per-sample lane state inside the shard
    monkeypatch.setattr(ptm, "COMPACT_MIN_LANES", 1)
    jax.clear_caches()
    grid_res = 16 if accel == "octree" else 64
    tri = meshgen.icosphere(2, radius=0.85)
    origin, dps = meshgen.fit_grid(tri, grid_res)
    col = meshgen.vertex_colors_from_position(tri, *meshgen.mesh_bounds(tri))
    tree = scene.build_scene(
        tri, col, origin=origin, dps=dps, grid_res=grid_res, accel=accel
    )

    extent = float(dps) * grid_res
    center = np.asarray(origin) + extent / 2
    cam = camera_ops.Camera.look_at(
        eye=center + np.array([0.8, 0.5, 1.5]) * extent, target=center
    )
    env = hdri_ops.load(hdr.procedural_sky(32, 16), scale=1.0)
    pmj = jnp.asarray(sampling.make_pmj_table(16, 512))

    m = mesh_lib.make_mesh(8)
    dp, sp = m.devices.shape
    width, height = 16, 8 * dp
    n = width * height

    kind, depth, meta, root = accel_lib.accel_args(tree)
    common = dict(
        accel_kind=kind, stack_depth=depth,
        has_emission=tree.has_emission, hdri_enabled=True,
        extra_implicit=True,
    )
    args_head = (
        meta, root, tree.lower, tree.upper,
        tree.color, tree.emission, pmj, env,
        jnp.asarray(cam.o), jnp.asarray(cam.right), jnp.asarray(cam.up),
        jnp.asarray(cam.front), jnp.float32(cam.tan_half_fovy),
        jnp.float32(cam.lens_r), jnp.float32(cam.focus),
    )
    tail = (
        jnp.float32(1.0 / width), jnp.float32(1.0 / height),
        jnp.float32(width / height),
    )

    # single-chip: the whole spp batch on one wavefront
    spd = 1
    n_spp = sp * spd
    single_flat = pt_sample(
        *args_head, jnp.uint32(0), jnp.uint32(0), *tail,
        jnp.float32(7.5), width=width, pix_packet=n, n_spp=n_spp, **common,
    )
    single = single_flat.reshape(n_spp, n, 3).sum(0)

    # sharded: pixels over dp, spp over sp
    from jax.sharding import NamedSharding, PartitionSpec as P

    s_dp = NamedSharding(m, P("dp"))
    accum = jax.device_put(jnp.zeros((n, 4), jnp.float32), s_dp)
    step = prender.make_sharded_pt_step(
        m, stack_depth=depth, spp_per_device=spd, width=width, height=height,
        n_pixels=n, has_emission=tree.has_emission, hdri_enabled=True,
        accel_kind=kind,
    )
    out = np.asarray(step(*args_head, accum, jnp.uint32(0)))

    jax.clear_caches()  # no compaction-forced trace outlives the patch
    assert np.all(out[:, 3] == n_spp)
    np.testing.assert_allclose(out[:, :3], np.asarray(single), rtol=2e-5, atol=2e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.parametrize("accel", ["brick", "octree"])
def test_sharded_render_matches_single_device(accel):
    """Primary-ray frame sharded as tile-row bands over all 8 devices ==
    the single-device render_frame (tiny tolerance for raygen arithmetic
    fused differently across band shapes)."""
    from massivevoxelraytracing_tpu.models import raycast
    from massivevoxelraytracing_tpu.parallel import render as prender2

    grid_res = 64
    tri = meshgen.icosphere(2, radius=0.85)
    origin, dps = meshgen.fit_grid(tri, grid_res)
    col = meshgen.vertex_colors_from_position(tri, *meshgen.mesh_bounds(tri))
    tree = scene.build_scene(
        tri, col, origin=origin, dps=dps, grid_res=grid_res, accel=accel
    )
    extent = float(dps) * grid_res
    center = np.asarray(origin) + extent / 2
    cam = camera_ops.Camera.look_at(
        eye=center + np.array([0.8, 0.5, 1.5]) * extent, target=center
    )
    width, height = 96, 64
    img1, t1 = raycast.render_frame(tree, cam, width, height, show_color=True)
    img1, t1 = np.asarray(img1), np.asarray(t1)

    kind, depth, meta, root = accel_lib.accel_args(tree)
    m = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("d",))
    render = prender2.make_sharded_render(
        m, width=width, height=height, kind=kind, depth=depth,
        show_color=True,
    )
    color = tree.color if tree.color is not None else jnp.zeros(1, jnp.uint32)
    img2, t2 = render(
        meta, root, tree.lower, tree.upper, color,
        jnp.asarray(cam.o), jnp.asarray(cam.right), jnp.asarray(cam.up),
        jnp.asarray(cam.front), jnp.float32(cam.tan_half_fovy),
    )
    img2, t2 = np.asarray(img2), np.asarray(t2)
    assert img2.shape == img1.shape and t2.shape == t1.shape
    frac_equal = (img1 == img2).all(axis=-1).mean()
    assert frac_equal > 0.999, f"pixel agreement {frac_equal}"
    hit1, hit2 = t1 < 1e37, t2 < 1e37
    assert (hit1 == hit2).mean() > 0.999
    np.testing.assert_allclose(
        np.where(hit1 & hit2, t1, 0.0), np.where(hit1 & hit2, t2, 0.0),
        rtol=1e-5, atol=1e-5,
    )
