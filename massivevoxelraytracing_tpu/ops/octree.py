"""Bottom-up sparse-voxel-octree / DAG construction from sorted Morton codes.

Reference (IntersectorOctreeGPU.hpp:40-241 + voxKernel.cu:245-435): a host
loop of log2(res) kernel launches; each level groups tasks by parent Morton
with ordered stream compaction, assembles nodes, and deduplicates them with a
lock-free linear-probing hash table (atomicCAS). Level buffer sizes come from
a one-shot boundary pre-count (octreeTaskInit).

Array-program redesign -- everything becomes sorted/segmented array ops:
  * group-by-parent  = neighbor-diff boundary mask + cumsum segment ids
  * node assembly    = scatter into [n_groups, 8] slot arrays (indices are
                       unique by construction, no atomics needed)
  * DAG dedup        = lexicographic sort of (mask, children[0..7]) keys +
                       run-boundary unique + index remap. Deterministic and
                       canonical, unlike the hash table (a win: node order is
                       reproducible).
  * level sizing     = the same one-shot boundary pre-count, read back once
                       (mirrors the reference's single octreeTaskInit readback)

Node layout (SoA, matching OctreeNode semantics, voxCommon.hpp:133-181):
  children u32[N, 8]   0xFFFFFFFF = empty slot or leaf voxel; after
                       embed_masks, bits 24..31 carry the child's own mask
  psum     u32[N, 8]   exclusive prefix sum of per-child voxel counts, used
                       by traversal to derive flat attribute indices
  mask     u32[N]      8-bit occupancy
Root is the last node. Level l nodes occupy [offset_l, offset_l + n_l).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .bits import I32, U32, u32
from . import morton

INVALID = 0xFFFFFFFF


def _c(x):
    return jnp.uint32(x)


def next_pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def bucket(n: int, floor: int = 8) -> int:
    """Static padded size for a dynamic count (pow2 buckets keep the jit
    cache small across frames)."""
    return max(next_pow2(n), floor)


@dataclasses.dataclass
class VoxelOctree:
    """Traversal-ready SVO/DAG + per-voxel attributes."""

    children: jax.Array  # u32 [N, 8], embedded masks
    psum: jax.Array  # u32 [N, 8]
    mask: jax.Array  # u32 [N]
    n_nodes: int
    grid_res: int
    lower: jax.Array  # f32 [3]
    upper: jax.Array  # f32 [3]
    color: jax.Array | None = None  # u32 [n_voxels] packed rgb8
    emission: jax.Array | None = None  # u32 [n_voxels] packed rgb8
    n_voxels: int = 0
    has_emission: bool = False
    meta: jax.Array | None = None  # u32 [N, 16]: children[8] ++ psum[8]

    @property
    def root(self) -> int:
        return self.n_nodes - 1

    def memory_bytes(self) -> int:
        # parity metric with IntersectorOctree::getMemoryConsumption
        # (68B/node: mask + 8 children + 8 psums)
        return self.n_nodes * 68


@partial(jax.jit, static_argnames=("n_levels",))
def level_task_counts(m_hi, m_lo, valid, *, n_levels: int):
    """Distinct-parent counts per level in one pass (octreeTaskInit,
    voxKernel.cu:245-267). counts[l] = #groups at iteration l = #tasks fed
    to iteration l+1."""
    counts = []
    for l in range(n_levels):
        shift = 3 * (l + 1)
        p_hi, p_lo = morton.morton_shr(m_hi, m_lo, shift)
        ne = jnp.concatenate(
            [
                jnp.ones((1,), bool),
                (p_hi[1:] != p_hi[:-1]) | (p_lo[1:] != p_lo[:-1]),
            ]
        )
        counts.append(jnp.sum((ne & valid).astype(I32)))
    return jnp.stack(counts)


@partial(jax.jit, static_argnames=("p_out", "dag"))
def build_level(t_hi, t_lo, t_child, t_nvox, n_in, *, p_out: int, dag: bool):
    """One bottom-up level (bottomUpOctreeBuild, voxKernel.cu:269-424).

    Inputs are task arrays padded to a static size; n_in marks validity.
    Returns dict with node arrays padded to p_out (+ a dump row internally),
    the next level's task arrays (padded p_out), and traced counts.
    """
    p_in = t_hi.shape[0]
    idx = jnp.arange(p_in, dtype=I32)
    valid = idx < n_in

    p_hi, p_lo = morton.parent(t_hi, t_lo)
    slot = (t_lo & _c(7)).astype(I32)

    ne = jnp.concatenate(
        [jnp.ones((1,), bool), (p_hi[1:] != p_hi[:-1]) | (p_lo[1:] != p_lo[:-1])]
    )
    boundary = valid & ne
    gid = jnp.cumsum(boundary.astype(I32)) - 1
    n_groups = jnp.sum(boundary.astype(I32))
    gid = jnp.where(valid, gid, p_out)  # park invalid tasks in the dump row

    children = jnp.full((p_out + 1, 8), _c(INVALID)).at[gid, slot].set(t_child)
    nvox = jnp.zeros((p_out + 1, 8), U32).at[gid, slot].set(t_nvox)
    mask = jnp.zeros((p_out + 1,), U32).at[gid].add(_c(1) << u32(slot))

    psum = jnp.cumsum(nvox, axis=1) - nvox  # exclusive scan per node
    total = jnp.sum(nvox, axis=1)

    # group start -> parent morton
    gstart = jax.ops.segment_min(idx, gid, num_segments=p_out + 1)
    gstart = jnp.minimum(gstart, p_in - 1)
    g_hi = jnp.take(p_hi, gstart)
    g_lo = jnp.take(p_lo, gstart)

    children = children[:p_out]
    nvox = nvox[:p_out]
    mask = mask[:p_out]
    psum = psum[:p_out]
    total = total[:p_out]
    g_hi = g_hi[:p_out]
    g_lo = g_lo[:p_out]

    gidx = jnp.arange(p_out, dtype=I32)
    group_valid = gidx < n_groups

    if dag:
        # canonical dedup: sort groups by (mask, children[0..7]); equal keys
        # collapse to one node (replaces the lock-free hash table,
        # voxKernel.cu:335-405)
        k_mask = jnp.where(group_valid, mask, _c(INVALID))
        keys = (k_mask,) + tuple(children[:, j] for j in range(8))
        sorted_ops = jax.lax.sort(keys + (gidx,), num_keys=9)
        s_keys = sorted_ops[:9]
        s_row = sorted_ops[9]
        diff = jnp.zeros((p_out - 1,), bool)
        for k in s_keys:
            diff = diff | (k[1:] != k[:-1])
        s_valid = s_keys[0] != _c(INVALID)
        uniq_boundary = s_valid & jnp.concatenate([jnp.ones((1,), bool), diff])
        uid = jnp.cumsum(uniq_boundary.astype(I32)) - 1
        n_unique = jnp.sum(uniq_boundary.astype(I32))
        uid_parked = jnp.where(s_valid, uid, p_out)
        # representative (first) sorted position of each unique node
        rep_pos = jax.ops.segment_min(gidx, uid_parked, num_segments=p_out + 1)[
            :p_out
        ]
        rep_pos = jnp.minimum(rep_pos, p_out - 1)
        rep_row = jnp.take(s_row, rep_pos)
        node_children = jnp.take(children, rep_row, axis=0)
        node_psum = jnp.take(psum, rep_row, axis=0)
        node_mask = jnp.take(mask, rep_row)
        # group row -> unique node id
        new_local = jnp.zeros((p_out + 1,), U32).at[s_row].set(uid.astype(U32))
        task_child = new_local[:p_out]
    else:
        n_unique = n_groups
        node_children = children
        node_psum = psum
        node_mask = mask
        task_child = gidx.astype(U32)

    uvalid = gidx < n_unique
    return dict(
        node_children=jnp.where(uvalid[:, None], node_children, _c(INVALID)),
        node_psum=jnp.where(uvalid[:, None], node_psum, _c(0)),
        node_mask=jnp.where(uvalid, node_mask, _c(0)),
        n_unique=n_unique,
        t_hi=jnp.where(group_valid, g_hi, _c(INVALID)),
        t_lo=jnp.where(group_valid, g_lo, _c(INVALID)),
        t_child=jnp.where(group_valid, task_child, _c(INVALID)),
        t_nvox=jnp.where(group_valid, total, _c(0)),
        n_groups=n_groups,
    )


@jax.jit
def _init_tasks(m_hi, n_voxels):
    p0 = m_hi.shape[0]
    valid = jnp.arange(p0, dtype=I32) < n_voxels
    t_child = jnp.full((p0,), _c(INVALID))
    t_nvox = jnp.where(valid, _c(1), _c(0))
    return valid, t_child, t_nvox


@partial(jax.jit, static_argnames=("total_pad",))
def _assemble(level_nodes, offsets, *, total_pad: int):
    """Pack per-level padded node arrays into one global buffer at exact
    offsets (levels written in order: a level's padded tail is overwritten
    by the next level's block), remap child indices to global by adding the
    previous level's offset, and embed child masks into pointer bits 24..31
    (the compact-copy + embedMasks steps, IntersectorOctreeGPU.hpp:219-241)."""
    children = jnp.full((total_pad, 8), _c(INVALID))
    psum = jnp.zeros((total_pad, 8), U32)
    mask = jnp.zeros((total_pad,), U32)
    for l, (ch, ps, mk) in enumerate(level_nodes):
        if l > 0:
            off = offsets[l - 1].astype(U32)
            ch = jnp.where(ch == _c(INVALID), ch, ch + off)
        start = offsets[l]
        children = jax.lax.dynamic_update_slice(children, ch, (start, 0))
        psum = jax.lax.dynamic_update_slice(psum, ps, (start, 0))
        mask = jax.lax.dynamic_update_slice(mask, mk, (start,))

    safe_child = jnp.where(children == _c(INVALID), _c(0), children)
    child_mask = jnp.take(mask, safe_child.astype(I32), mode="clip")
    children = jnp.where(
        children == _c(INVALID), children, children | (child_mask << 24)
    )
    # fused node record: one 16-wide row gather fetches children + psums
    meta = jnp.concatenate([children, psum], axis=1)
    return children, psum, mask, meta


def build_octree(
    m_hi,
    m_lo,
    n_voxels: int,
    grid_res: int,
    *,
    dag: bool = True,
    lower=None,
    upper=None,
    color=None,
    emission=None,
    has_emission: bool = False,
) -> VoxelOctree:
    """Host orchestrator (IntersectorOctreeGPU::build semantics).

    m_hi/m_lo: sorted unique Morton pairs, padded arrays with n_voxels valid.
    Two host readbacks per build, mirroring the reference's round trips:
    the level pre-count and the per-level DAG-unique counts.
    """
    assert grid_res >= 2 and (grid_res & (grid_res - 1)) == 0
    n_levels = int(grid_res).bit_length() - 1

    valid, t_child, t_nvox = _init_tasks(m_hi, jnp.int32(n_voxels))
    counts = np.asarray(
        level_task_counts(m_hi, m_lo, valid, n_levels=n_levels)
    )  # readback 1
    assert counts[-1] == 1, f"top level must collapse to one group, got {counts[-1]}"

    t_hi, t_lo = m_hi, m_lo
    n_in = n_voxels

    level_nodes = []
    n_uniques = []
    for l in range(n_levels):
        p_out = bucket(int(counts[l]))
        out = build_level(
            t_hi, t_lo, t_child, t_nvox, jnp.int32(n_in), p_out=p_out, dag=dag
        )
        level_nodes.append((out["node_children"], out["node_psum"], out["node_mask"]))
        n_uniques.append(out["n_unique"])
        t_hi, t_lo, t_child, t_nvox = (
            out["t_hi"],
            out["t_lo"],
            out["t_child"],
            out["t_nvox"],
        )
        n_in = int(counts[l])

    n_uniques_arr = np.asarray(jnp.stack(n_uniques))  # readback 2
    n_uniques = [int(n) for n in n_uniques_arr]
    offsets = np.concatenate([[0], np.cumsum(n_uniques)])
    total = int(offsets[-1])
    assert total < 0xFFFFFF, "node count exceeds embedded-mask capacity"

    p_max = max(ch.shape[0] for ch, _, _ in level_nodes)
    total_pad = bucket(total + p_max)
    children, psum, mask, meta = _assemble(
        tuple(level_nodes), jnp.asarray(offsets, I32), total_pad=total_pad
    )

    if lower is None:
        lower = jnp.zeros(3, jnp.float32)
    if upper is None:
        upper = jnp.ones(3, jnp.float32)
    return VoxelOctree(
        children=children,
        psum=psum,
        mask=mask,
        n_nodes=total,
        grid_res=grid_res,
        lower=jnp.asarray(lower, jnp.float32),
        upper=jnp.asarray(upper, jnp.float32),
        color=color,
        emission=emission,
        n_voxels=int(n_voxels),
        has_emission=bool(has_emission),
        meta=meta,
    )
