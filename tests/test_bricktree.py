"""BrickTree64 must reproduce the octree traversal exactly: same hits, same
entry t, same face axis, same voxel ranks (it is the same voxel set and the
same in-order walk, just 4x-per-axis branching)."""

import numpy as np
import jax.numpy as jnp
import pytest

from massivevoxelraytracing_tpu.models import cpu_oracle
from massivevoxelraytracing_tpu.ops import bricktree, morton, octree, traverse2

RNG = np.random.default_rng(99)


def random_voxels(grid_res, n):
    c = RNG.integers(0, grid_res, size=(n, 3)).astype(np.uint32)
    return np.unique(morton.np_encode(c[:, 0], c[:, 1], c[:, 2]))


def make_both(m_u64, grid_res, dps):
    n = len(m_u64)
    pad = octree.bucket(n)
    hi, lo = morton.np_pack_pair(m_u64)
    hi = np.concatenate([hi, np.full(pad - n, 0xFFFFFFFF, np.uint32)])
    lo = np.concatenate([lo, np.full(pad - n, 0xFFFFFFFF, np.uint32)])
    lower = np.zeros(3, np.float32)
    oct_tree = octree.build_octree(
        jnp.asarray(hi), jnp.asarray(lo), n, grid_res,
        lower=lower, upper=lower + np.float32(dps) * grid_res,
    )
    brick = bricktree.build_bricktree(
        jnp.asarray(hi), jnp.asarray(lo), n, grid_res, lower=lower, dps=dps
    )
    return oct_tree, brick


@pytest.mark.parametrize("grid_res", [8, 16, 64])
def test_brick_equals_octree(grid_res):
    dps = 1.0 / grid_res
    m = random_voxels(grid_res, grid_res * grid_res)
    oct_tree, brick = make_both(m, grid_res, dps)
    assert brick.grid_res >= grid_res  # pow4 padding

    n = 512
    ro = RNG.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    rd = RNG.normal(size=(n, 3)).astype(np.float32)
    t1, m1, v1 = (np.asarray(x) for x in traverse2.intersect_octree2(oct_tree, ro, rd, block=256))
    t2, m2, v2 = (np.asarray(x) for x in bricktree.intersect_bricktree(brick, ro, rd, block=256))
    from tiecheck import classify_vs_each_other

    n_tie = classify_vs_each_other(t1, m1, v1, t2, m2, v2, rtol=1e-5)
    assert n_tie <= n // 100, f"{n_tie}/{n} ties is implausibly many"


def test_brick_vidx_is_rank():
    grid_res = 16
    dps = 1.0 / grid_res
    m = random_voxels(grid_res, 300)
    _, brick = make_both(m, grid_res, dps)
    # shoot a ray straight at a known voxel's center from outside
    for k in (0, len(m) // 2, len(m) - 1):
        x, y, z = morton.np_decode(m[k : k + 1])
        ctr = (np.array([x[0], y[0], z[0]], np.float32) + 0.5) * dps
        ro = np.array([[ctr[0], ctr[1], -3.0]], np.float32)
        rd = np.array([[0.0, 0.0, 1.0]], np.float32)
        t, nm, vi = bricktree.intersect_bricktree(brick, ro, rd)
        if float(t[0]) < 1e37:
            # first voxel along +z in this column: find it via brute force
            to, no, vo = cpu_oracle.intersect_brute_force(
                m, (0, 0, 0), dps, ro[0], rd[0]
            )
            assert int(vi[0]) == vo
            assert np.isclose(float(t[0]), to, rtol=1e-5)


def test_brick_memory_much_smaller_than_octree_naive():
    grid_res = 64
    dps = 1.0 / grid_res
    m = random_voxels(grid_res, 4000)
    oct_tree, brick = make_both(m, grid_res, dps)
    assert brick.memory_bytes() < oct_tree.memory_bytes()


def test_brick_single_level():
    # res 4: the root IS a leaf brick
    m = np.unique(morton.np_encode(
        np.array([0, 1, 3], np.uint32), np.array([0, 2, 3], np.uint32),
        np.array([1, 1, 2], np.uint32)))
    _, brick = make_both(m, 4, 0.25)
    assert brick.n_levels == 1 and brick.n_nodes == 1
    ro = np.array([[0.1, 0.1, -2.0]], np.float32)
    rd = np.array([[0.0, 0.0, 1.0]], np.float32)
    t, nm, vi = bricktree.intersect_bricktree(brick, ro, rd)
    to, no, vo = cpu_oracle.intersect_brute_force(m, (0, 0, 0), 0.25, ro[0], rd[0])
    assert (float(t[0]) < 1e37) == np.isfinite(to)
    if np.isfinite(to):
        assert int(vi[0]) == vo


@pytest.mark.parametrize("shadow", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("grid_res", [8, 16, 64])
def test_brick_matches_bruteforce(grid_res, shadow):
    """Every ray against the brute-force slab oracle. Closest-hit rays must
    agree on (t, face, voxel) up to classified ties; shadow (any-hit) rays
    need only the visibility the path tracer reads from them."""
    from tiecheck import classify_all_vs_oracle, classify_vs_oracle

    dps = 1.0 / grid_res
    m = random_voxels(grid_res, grid_res * grid_res // 2)
    _, brick = make_both(m, grid_res, dps)
    n = 300
    ro = RNG.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    rd = (RNG.uniform(0.1, 0.9, (n, 3)) - ro).astype(np.float32)
    t, nm, vi = (np.asarray(x) for x in
                 bricktree.intersect_bricktree(brick, ro, rd, shadow=shadow))
    lower = (0.0, 0.0, 0.0)
    if not shadow:
        n_tie = classify_all_vs_oracle(m, lower, dps, ro, rd, t, nm, vi)
    else:
        n_tie = 0
        for i in range(n):
            to, _, vo = cpu_oracle.intersect_brute_force(m, lower, dps, ro[i], rd[i])
            if (t[i] < 1e37) != np.isfinite(to):
                n_tie += 1
                classify_vs_oracle(i, m, lower, dps, ro[i], rd[i], t[i],
                                   vi[i], to, vo)
    assert (t < 1e37).any()
    assert n_tie <= max(2, n // 100), f"{n_tie}/{n} ties is implausibly many"


@pytest.mark.parametrize("block", [1024, 4096, 5000])
def test_brick_results_do_not_depend_on_block(block):
    """A ray count that is not a multiple of the block is padded with
    parked rays; each ray's walk is the same whatever block it rides in
    (5000 = the whole packet: one lockstep loop)."""
    from tiecheck import classify_vs_each_other

    grid_res = 64
    m = random_voxels(grid_res, 3000)
    _, brick = make_both(m, grid_res, 1.0 / grid_res)
    ro = RNG.uniform(-1.0, 2.0, (5000, 3)).astype(np.float32)
    rd = (RNG.uniform(0.1, 0.9, (5000, 3)) - ro).astype(np.float32)
    ref = [np.asarray(x) for x in
           bricktree.intersect_bricktree(brick, ro, rd, block=256)]
    got = [np.asarray(x) for x in
           bricktree.intersect_bricktree(brick, ro, rd, block=block)]
    assert got[0].shape == (5000,)
    assert classify_vs_each_other(*ref, *got) == 0
