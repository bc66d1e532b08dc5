"""Unified acceleration-structure interface.

Two traversal-ready structures share the same voxel stream and produce
identical results (tested):
  * VoxelOctree  -- the reference-parity SVO/DAG (8-ary, embedded masks,
                    per-node voxel prefix sums, optional DAG compression);
                    the memory-parity structure.
  * BrickTree    -- 4^3-branching, rank-based, 16 B/node; ~3x fewer
                    row-gathers per ray: the performance structure (default).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import bricktree as brick_ops
from ..ops import traverse as traverse_ops
from ..ops import traverse2 as traverse2_ops
from ..ops.bricktree import BrickTree

ACCEL_KINDS = ("brick", "octree")
DEFAULT_ACCEL = "brick"


def accel_args(tree):
    """(static_kind, static_depth, meta, root) for the jitted render paths."""
    if isinstance(tree, BrickTree):
        return "brick", tree.n_levels, tree.meta, jnp.uint32(tree.root)
    depth = max(int(tree.grid_res).bit_length() - 1, 1)
    return (
        "octree",
        depth,
        traverse2_ops.tree_meta(tree),
        traverse_ops.root_entry_of(tree),
    )


# Rays per lockstep while_loop; larger packets run as a lax.map over blocks
# of this size. The fastest of the 1080p primary-frame sweep on an H100
# (PERF.md): smaller blocks run more loops one after another, larger ones
# keep every lane waiting for the block's longest walk.
BLOCK_FOR_KIND = {"brick": 131072, "octree": 131072}


def intersect_with(kind: str, depth, meta, root, lower, upper, ro, rd,
                   *, shadow: bool = False, block: int | None = None):
    """Dispatch inside jitted code (kind/depth are static)."""
    if block is None:
        block = BLOCK_FOR_KIND[kind]
    if kind == "brick":
        return brick_ops.intersect_rays_brick(
            meta, root, lower, upper, ro, rd,
            n_levels=depth, shadow=shadow, block=block,
        )
    return traverse2_ops.intersect_rays2(
        meta, root, lower, upper, ro, rd,
        stack_depth=depth, shadow=shadow, block=block,
    )


def intersect(tree, ro, rd, *, shadow: bool = False, block: int | None = None):
    kind, depth, meta, root = accel_args(tree)
    return intersect_with(
        kind, depth, meta, root, tree.lower, tree.upper,
        jnp.asarray(ro), jnp.asarray(rd), shadow=shadow, block=block,
    )
