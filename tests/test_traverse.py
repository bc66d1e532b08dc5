"""Traversal fidelity vs the brute-force AABB oracle (the Embree-stand-in
pattern from voxRT.cpp:316-323: pixel-level A/B of the two intersectors)."""

import numpy as np
import jax.numpy as jnp
import pytest

from massivevoxelraytracing_tpu.models import cpu_oracle
from massivevoxelraytracing_tpu.ops import morton, octree, traverse

RNG = np.random.default_rng(123)


def make_tree(m_u64, grid_res, lower=(0, 0, 0), dps=1.0 / 16, dag=True):
    n = len(m_u64)
    pad = octree.bucket(n)
    hi, lo = morton.np_pack_pair(m_u64)
    hi = np.concatenate([hi, np.full(pad - n, 0xFFFFFFFF, np.uint32)])
    lo = np.concatenate([lo, np.full(pad - n, 0xFFFFFFFF, np.uint32)])
    lower = np.asarray(lower, np.float32)
    upper = lower + np.float32(dps) * grid_res
    return octree.build_octree(
        jnp.asarray(hi), jnp.asarray(lo), n, grid_res, dag=dag,
        lower=lower, upper=upper,
    )


def random_voxels(grid_res, n):
    coords = RNG.integers(0, grid_res, size=(n, 3)).astype(np.uint32)
    return np.unique(morton.np_encode(coords[:, 0], coords[:, 1], coords[:, 2]))


def compare_vs_bruteforce(m, grid_res, dps, lower, n_rays=400, dag=True):
    tree = make_tree(m, grid_res, lower, dps, dag=dag)
    center = np.asarray(lower) + 0.5 * dps * grid_res
    # rays from a sphere around the grid, aimed at random interior points
    theta = RNG.uniform(0, 2 * np.pi, n_rays)
    phi = np.arccos(RNG.uniform(-1, 1, n_rays))
    rad = 2.0 * dps * grid_res
    ro = center + rad * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1
    )
    target = np.asarray(lower) + dps * grid_res * RNG.uniform(0.1, 0.9, (n_rays, 3))
    rd = (target - ro).astype(np.float32)
    ro = ro.astype(np.float32)

    t, nmaj, vidx = traverse.intersect_octree(tree, ro, rd)
    t = np.asarray(t)
    nmaj = np.asarray(nmaj)
    vidx = np.asarray(vidx)

    from tiecheck import classify_all_vs_oracle

    n_classified = classify_all_vs_oracle(m, lower, dps, ro, rd, t, nmaj, vidx)
    return n_classified, n_rays


@pytest.mark.parametrize("grid_res", [8, 16, 64])
def test_traversal_matches_bruteforce(grid_res):
    dps = 1.0 / grid_res
    m = random_voxels(grid_res, grid_res * grid_res // 2)
    # every single disagreement was classified as a t-tie / grazing touch
    # inside compare_vs_bruteforce (or it raised); bound their count too
    bad, n = compare_vs_bruteforce(m, grid_res, dps, (0.0, 0.0, 0.0))
    assert bad <= max(2, n // 100), f"{bad}/{n} ties is implausibly many"


def test_traversal_dag_equals_naive():
    grid_res = 32
    dps = 1.0 / grid_res
    m = random_voxels(grid_res, 600)
    t1 = make_tree(m, grid_res, (0, 0, 0), dps, dag=True)
    t2 = make_tree(m, grid_res, (0, 0, 0), dps, dag=False)
    ro = np.tile(np.array([[0.5, 0.5, -1.0]], np.float32), (256, 1))
    px = np.stack(
        [RNG.uniform(0, 1, 256), RNG.uniform(0, 1, 256), np.full(256, 1.5)], -1
    ).astype(np.float32)
    rd = px - ro
    ta, na, va = (np.asarray(x) for x in traverse.intersect_octree(t1, ro, rd))
    tb, nb, vb = (np.asarray(x) for x in traverse.intersect_octree(t2, ro, rd))
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(na, nb)
    np.testing.assert_array_equal(va, vb)


def test_single_voxel_probe():
    # a single voxel at a known location; analytic expectations
    grid_res = 8
    dps = 1.0
    m = np.array([morton.np_encode(np.uint32(3), np.uint32(4), np.uint32(2))], np.uint64)
    tree = make_tree(m, grid_res, (0, 0, 0), dps)
    # +x ray straight at the voxel center
    ro = np.array([[-5.0, 4.5, 2.5]], np.float32)
    rd = np.array([[1.0, 0.0, 0.0]], np.float32)
    t, nmaj, vidx = traverse.intersect_octree(tree, ro, rd)
    assert np.isclose(float(t[0]), 8.0)  # entry plane x=3 at t=8
    assert int(nmaj[0]) == 1  # x face
    assert int(vidx[0]) == 0
    # -z ray from above
    ro = np.array([[3.5, 4.5, 20.0]], np.float32)
    rd = np.array([[0.0, 0.0, -1.0]], np.float32)
    t, nmaj, vidx = traverse.intersect_octree(tree, ro, rd)
    assert np.isclose(float(t[0]), 17.0)  # enters z=3 plane at t=17
    assert int(nmaj[0]) == 0
    # miss
    ro = np.array([[-5.0, 0.5, 0.5]], np.float32)
    rd = np.array([[1.0, 0.0, 0.0]], np.float32)
    t, _, _ = traverse.intersect_octree(tree, ro, rd)
    assert float(t[0]) > 1e37


def test_ray_origin_inside_voxel_is_miss_for_that_voxel():
    # the reference only reports entry planes with t > 0 (positive hit only)
    grid_res = 8
    dps = 1.0
    m = random_voxels(grid_res, 200)
    tree = make_tree(m, grid_res, (0, 0, 0), dps)
    x, y, z = morton.np_decode(m[:1])
    ro = np.array([[x[0] + 0.5, y[0] + 0.5, z[0] + 0.5]], np.float32)
    rd = np.array([[0.3, 0.2, 0.9]], np.float32)
    t, _, vidx = traverse.intersect_octree(tree, ro, rd)
    to, no, vo = cpu_oracle.intersect_brute_force(m, (0, 0, 0), dps, ro[0], rd[0])
    dev_hit = float(t[0]) < 1e37
    assert dev_hit == bool(np.isfinite(to))
    if dev_hit:
        assert int(vidx[0]) == vo and vo != 0 or int(vidx[0]) == vo


def test_shadow_rays_agree_on_occlusion():
    grid_res = 16
    dps = 1.0 / grid_res
    m = random_voxels(grid_res, 400)
    tree = make_tree(m, grid_res, (0, 0, 0), dps)
    n = 256
    ro = RNG.uniform(-0.5, 1.5, (n, 3)).astype(np.float32)
    rd = RNG.normal(size=(n, 3)).astype(np.float32)
    t_full, _, _ = traverse.intersect_octree(tree, ro, rd, shadow=False)
    t_shad, _, _ = traverse.intersect_octree(tree, ro, rd, shadow=True)
    np.testing.assert_array_equal(
        np.asarray(t_full) < 1e37, np.asarray(t_shad) < 1e37
    )
    np.testing.assert_allclose(np.asarray(t_full), np.asarray(t_shad))


def test_hit_normal():
    nm = jnp.asarray(np.array([1, 2, 0, -1], np.int32))
    rd = jnp.asarray(
        np.array([[1, 0, 0], [0, -2, 0], [0, 0, 3], [1, 1, 1]], np.float32)
    )
    n = np.asarray(traverse.hit_normal(nm, rd))
    np.testing.assert_array_equal(n[0], [-1, 0, 0])
    np.testing.assert_array_equal(n[1], [0, 1, 0])
    np.testing.assert_array_equal(n[2], [0, 0, -1])
    np.testing.assert_array_equal(n[3], [0, 0, 0])
