"""Scene build: triangle soup -> voxels -> traversal-ready SVO/DAG.

This is the `updateScene` path of the engine (PathTracer.hpp:141-148 ->
IntersectorOctreeGPU::build, IntersectorOctreeGPU.hpp:40-241): per frame,
re-voxelize the mesh and rebuild the octree.

Large meshes stream through fixed-size triangle chunks (static shapes for
the jit cache) with the reference's exact two-pass structure:
  pass 1 (voxCount): per-chunk dumped-voxel counts, one host readback
  pass 2 (voxelize): per-chunk compaction (valid candidates sort to the
    front) written at running offsets into one global dump buffer; a chunk's
    invalid tail is overwritten by the next chunk's write
  then ONE global sort+unique with true duplicate-mean attributes --
  identical semantics to radix sort + `unique` (voxKernel.cu:117-243).
Host round trips mirror the reference's three readbacks (chunk counts,
unique count, octree level counts)."""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import bricktree as brick_ops
from ..ops import octree as octree_ops
from ..ops import voxelize as vox_ops
from ..ops.bits import U32
from ..utils import meshprep

INVALID = 0xFFFFFFFF
# Above this many dumped voxels, unique runs hierarchically (by groups).
# Sized for a 16 GB device; the right size for 80 GB is not yet measured.
GROUP_DUMPED = 40 << 20


@jax.jit
def _chunk_emit(bufs, cands, off):
    """Sort one chunk's candidates so valid entries lead (keyed by Morton)
    and write them into the global dump buffers at a running offset."""
    valid = cands["valid"]
    key_hi = jnp.where(valid, cands["m_hi"], jnp.uint32(INVALID))
    key_lo = jnp.where(valid, cands["m_lo"], jnp.uint32(INVALID))
    sorted_ops = jax.lax.sort(
        (key_hi, key_lo, cands["color"], cands["emission"]), num_keys=2
    )
    return tuple(
        jax.lax.dynamic_update_slice(b, v, (off,))
        for b, v in zip(bufs, sorted_ops)
    )


@jax.jit
def _make_unique_input(m_hi, m_lo, color, emission):
    return dict(
        valid=m_hi != jnp.uint32(INVALID),
        m_hi=m_hi,
        m_lo=m_lo,
        color=color,
        emission=emission,
    )


def build_accel_from_unique(uniq, *, origin, dps, grid_res, accel, dag=True):
    """Unique-voxel stream -> traversal structure (the tail of the build:
    IntersectorOctreeGPU.hpp:163-239). Shared by the single-device and
    sharded (parallel/build.py) front halves."""
    n_unique = int(uniq["n_unique"])
    pad = octree_ops.bucket(n_unique)
    lower = jnp.asarray(origin, jnp.float32)
    if accel == "brick":
        return brick_ops.build_bricktree(
            uniq["m_hi"][:pad],
            uniq["m_lo"][:pad],
            n_unique,
            grid_res,
            lower=lower,
            dps=float(dps),
            color=uniq["color"][:pad],
            emission=uniq["emission"][:pad],
            has_emission=bool(uniq["has_emission"]),
        )
    upper = lower + jnp.float32(dps) * grid_res
    return octree_ops.build_octree(
        uniq["m_hi"][:pad],
        uniq["m_lo"][:pad],
        n_unique,
        grid_res,
        dag=dag,
        lower=lower,
        upper=upper,
        color=uniq["color"][:pad],
        emission=uniq["emission"][:pad],
        has_emission=bool(uniq["has_emission"]),
    )


def voxelize_unique(
    tri_verts,
    tri_colors=None,
    tri_emissions=None,
    *,
    origin,
    dps,
    grid_res: int,
    six_separating: bool = True,
    cap: int = 4,
    chunk_tris: int = 65536,
):
    """Voxelize + sort/unique: the front half of build_scene. Returns the
    unique-voxel stream (sort_and_unique's dict: Morton-sorted m_hi/m_lo
    with mean color/emission, valid prefix n_unique) and the build stats
    so far. tri_*: f32[T, 3, 3] host arrays."""
    tri_verts = np.asarray(tri_verts, np.float32).reshape(-1, 3, 3)
    if tri_colors is None:
        tri_colors = np.ones_like(tri_verts)
    if tri_emissions is None:
        tri_emissions = np.zeros_like(tri_verts)

    # Per-phase wall times, stamped at the pipeline's natural host
    # sync points (the reference's three readbacks), mirroring the
    # per-phase ms its stats lines surface (seminar_ushio.pdf slide 67:
    # voxelization+build 135 ms @41M voxels).
    t_0 = time.time()
    tri, col, emi = meshprep.split_to_cap(
        tri_verts, tri_colors, tri_emissions, origin, dps, grid_res, cap
    )
    t_split = time.time()
    n_tri = len(tri)
    chunk = min(chunk_tris, octree_ops.bucket(n_tri, floor=1024))
    tri, col, emi = meshprep.pad_triangles(tri, col, emi, chunk)
    n_chunks = len(tri) // chunk
    origin_j = jnp.asarray(origin, jnp.float32)

    def vox_chunk(k):
        sl = slice(k * chunk, (k + 1) * chunk)
        return vox_ops.voxelize_dense(
            jnp.asarray(tri[sl]),
            jnp.asarray(col[sl]),
            jnp.asarray(emi[sl]),
            origin_j,
            float(dps),
            grid_res=grid_res,
            six_separating=six_separating,
            cap=cap,
        )

    # pass 1: counts (voxCount)
    counts = [vox_ops.count_voxels(vox_chunk(k)) for k in range(n_chunks)]
    counts = np.asarray(jnp.stack(counts))  # readback 1
    t_count = time.time()
    total_dumped = int(counts.sum())
    if total_dumped == 0:
        raise ValueError("voxelization produced no voxels")
    offsets = np.concatenate([[0], np.cumsum(counts)])

    # pass 2: emit compacted chunks at running offsets, then sort + unique
    # with true duplicate means (`unique` kernel). Above GROUP_DUMPED the
    # stream is processed HIERARCHICALLY (per-group sort to channel sums,
    # then one merge of the much smaller unique streams), which bounds the
    # global 4-operand sort and its temp space. Attribute means are bitwise
    # identical either way (sum of sums / sum of counts, same integer
    # division).
    cand_per_chunk = chunk * cap * cap * cap
    if total_dumped <= GROUP_DUMPED:
        groups = [(0, n_chunks)]
    else:
        groups = []
        k0 = 0
        acc = 0
        for k in range(n_chunks):
            acc += int(counts[k])
            if acc >= GROUP_DUMPED or k == n_chunks - 1:
                groups.append((k0, k + 1))
                k0 = k + 1
                acc = 0
        if k0 < n_chunks:
            groups.append((k0, n_chunks))

    if len(groups) == 1:
        buf_size = octree_ops.bucket(total_dumped + cand_per_chunk)
        bufs = tuple(
            jnp.full((buf_size,), jnp.uint32(INVALID)) for _ in range(2)
        ) + tuple(jnp.zeros((buf_size,), U32) for _ in range(2))
        for k in range(n_chunks):
            bufs = _chunk_emit(bufs, vox_chunk(k), jnp.int32(int(offsets[k])))
        m_hi, m_lo, colors, emissions = bufs
        uniq = vox_ops.sort_and_unique(
            _make_unique_input(m_hi, m_lo, colors, emissions)
        )
    else:
        parts = []
        part_ns = []
        for (ka, kb) in groups:
            g_dump = int(counts[ka:kb].sum())
            buf_size = octree_ops.bucket(g_dump + cand_per_chunk)
            bufs = tuple(
                jnp.full((buf_size,), jnp.uint32(INVALID)) for _ in range(2)
            ) + tuple(jnp.zeros((buf_size,), U32) for _ in range(2))
            off0 = int(offsets[ka])
            for k in range(ka, kb):
                bufs = _chunk_emit(
                    bufs, vox_chunk(k), jnp.int32(int(offsets[k]) - off0)
                )
            m_hi_g, m_lo_g, col_g, emi_g = bufs
            out, n_u = vox_ops.sort_and_unique_sums(
                m_hi_g, m_lo_g, col_g, emi_g,
                m_hi_g != jnp.uint32(INVALID),
            )
            n_u = int(n_u)  # readback: compact each group before the merge
            parts.append([x[: octree_ops.bucket(n_u)] for x in out])
            part_ns.append(n_u)
        cat = [
            jnp.concatenate([p[i] for p in parts]) for i in range(9)
        ]
        uniq = vox_ops.merge_unique_sums(cat[0], cat[1], cat[2:8], cat[8])
    n_unique = int(uniq["n_unique"])  # readback 2
    t_unique = time.time()
    # observability counters the reference surfaces in its stats lines /
    # ImGui panels (dumped voxels, unique voxels, SURVEY.md section 5)
    stats = dict(
        n_triangles=int(n_tri),
        n_dumped=total_dumped,
        n_unique=n_unique,
        grid_res=grid_res,
        t_split_s=t_split - t_0,
        t_count_s=t_count - t_split,
        t_unique_s=t_unique - t_count,
    )
    return uniq, stats


def build_scene(
    tri_verts,
    tri_colors=None,
    tri_emissions=None,
    *,
    origin,
    dps,
    grid_res: int,
    six_separating: bool = True,
    cap: int = 4,
    dag: bool = True,
    chunk_tris: int = 65536,
    accel: str = "octree",
):
    """Voxelize + build. tri_*: f32[T, 3, 3] host arrays."""
    t_0 = time.time()
    uniq, stats = voxelize_unique(
        tri_verts, tri_colors, tri_emissions, origin=origin, dps=dps,
        grid_res=grid_res, six_separating=six_separating, cap=cap,
        chunk_tris=chunk_tris,
    )
    t_unique = time.time()
    tree = build_accel_from_unique(
        uniq, origin=jnp.asarray(origin, jnp.float32), dps=dps,
        grid_res=grid_res, accel=accel, dag=dag,
    )
    t_accel = time.time()
    stats["n_nodes"] = tree.n_nodes
    stats["accel_bytes"] = tree.memory_bytes()
    stats["t_accel_s"] = t_accel - t_unique
    stats["t_total_s"] = t_accel - t_0
    tree.build_stats = stats
    return tree
