"""Sharded scene build: the voxel stream partitioned over a device mesh.

The reference's build is single-GPU (IntersectorOctreeGPU::build,
IntersectorOctreeGPU.hpp:40-241). Here the per-frame rebuild shards
naturally over the 'dp' axis: triangle chunks are distributed across
devices, each device runs the two-pass voxelize (count -> emit) plus the
GROUP stage of the hierarchical unique (`sort_and_unique_sums` -- per-voxel
channel SUMS + COUNT) entirely locally inside one `shard_map`, and the
small per-device unique streams meet in the partition-invariant merge
(`merge_unique_sums`: sum of sums / sum of counts with the same integer
division -- the exact true-duplicate-mean machinery of the single-device
hierarchical path).

Guarantees (in decreasing strength):
  * PARTITION INVARIANCE: the same scene built over 2 vs 8 devices gives
    bitwise the same tree (tests/test_parallel_build.py) -- device count
    only re-partitions the group axis of sums that commute exactly.
  * vs the single-device build: the coverage PREDICATE here evaluates
    inside one fused scan program, while `build_scene` evaluates it in a
    standalone per-chunk executable. XLA fuses float mul/add chains
    differently across those contexts (measured on XLA:CPU: ~5% of dumped
    candidates flip at exact cell-boundary ties -- duplicates of cells
    already covered, plus rarely a boundary cell itself). The voxel set
    may therefore differ from the single-device build by a small band of
    float-tie boundary cells; attribute semantics are identical. This is
    the same class of drift the reference has between its CPU and GPU
    voxelizers (shared VTContext source, different compilers/FMA).

The emit pass is SELF-CONSISTENT against that drift: each device's write
offsets are carried through the scan from its own in-trace valid counts
(never from the separately-compiled sizing pass), so a context flip can
shift a boundary candidate but can never corrupt or lose buffer rows.
The sizing pass only sizes; a safety re-run with a doubled buffer covers
the (never observed) case where drift crosses a pow2 bucket boundary.

Collective cost: one all_gather of the compacted per-device unique streams
(a few bytes per unique voxel); the dumped-voxel stream -- the
big array -- never leaves its device.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import scene as scene_mod
from ..ops import octree as octree_ops
from ..ops import voxelize as vox_ops
from ..ops.bits import U32
from ..utils import meshprep

INVALID = 0xFFFFFFFF


def make_build_mesh(n_devices: int | None = None) -> Mesh:
    """Flat 1-axis ('dp',) mesh over the first n_devices devices: the build
    has no sample axis, every device owns a contiguous run of chunks."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("dp",))


@functools.lru_cache(maxsize=32)
def _passes(mesh: Mesh, grid_res: int, six_separating: bool, cap: int,
            cand_per_chunk: int):
    """Jitted count + emit/group-unique passes, cached per (mesh, static
    voxelizer params) so per-frame rebuilds reuse the traced programs
    (origin/dps ride as traced arguments; buf as a static arg that only
    changes when the dump total crosses a pow2 bucket)."""

    def vox(tv, tc, te, origin, dps):
        return vox_ops.voxelize_dense(
            tv, tc, te, origin, dps,
            grid_res=grid_res, six_separating=six_separating, cap=cap,
        )

    # pass 1 (voxCount): per-chunk dumped counts, all devices at once;
    # ONE readback (the reference's readback #1)
    @jax.jit
    def count_pass(tv, tc, te, origin, dps):
        def fn(tv, tc, te, origin, dps):
            def body(args):
                return vox_ops.count_voxels(vox(*args, origin, dps))

            return jax.lax.map(body, (tv, tc, te))

        return jax.shard_map(
            fn, mesh=mesh, in_specs=(P("dp"),) * 3 + (P(), P()),
            out_specs=P("dp"),
        )(tv, tc, te, origin, dps)

    # pass 2 (voxelize + group unique), entirely device-local: emit each
    # chunk's sort-compacted candidates at a RUNNING offset carried through
    # the scan (self-consistent with this pass's own valid counts -- see
    # module docstring), then reduce the local stream to per-voxel channel
    # sums. No cross-device traffic until the tiny unique streams merge.
    @functools.partial(jax.jit, static_argnames=("buf",))
    def emit_unique_pass(tv, tc, te, origin, dps, buf):
        def fn(tv, tc, te, origin, dps):
            bufs = tuple(
                jnp.full((buf,), jnp.uint32(INVALID)) for _ in range(2)
            ) + tuple(jnp.zeros((buf,), U32) for _ in range(2))
            # the carry is per-device state: mark it varying over 'dp'
            # (a replicated literal carry trips the scan vma check)
            bufs = tuple(
                jax.lax.pcast(b, ("dp",), to="varying") for b in bufs
            )
            off0 = jax.lax.pcast(jnp.int32(0), ("dp",), to="varying")

            def body(carry, args):
                bufs, off = carry
                cands = vox(*args, origin, dps)
                n_valid = vox_ops.count_voxels(cands)
                # clamp so a (drifted) overflow can only overwrite the
                # buffer tail in place, never scatter out of bounds; the
                # host checks off_end and re-runs bigger if it ever trips
                off_c = jnp.minimum(off, jnp.int32(buf - cand_per_chunk))
                return (
                    scene_mod._chunk_emit(bufs, cands, off_c),
                    off + n_valid,
                ), None

            (bufs, off_end), _ = jax.lax.scan(
                body, (bufs, off0), (tv, tc, te)
            )
            m_hi, m_lo, colors, emissions = bufs
            out, n_u = vox_ops.sort_and_unique_sums(
                m_hi, m_lo, colors, emissions,
                m_hi != jnp.uint32(INVALID),
            )
            return tuple(x[None] for x in out) + (n_u[None], off_end[None])

        return jax.shard_map(
            fn, mesh=mesh, in_specs=(P("dp"),) * 3 + (P(), P()),
            out_specs=P("dp"),
        )(tv, tc, te, origin, dps)

    return count_pass, emit_unique_pass


# merge the compacted [dp, m] streams: the axis-1 slice is local to each
# device; the reshape to one global stream is the build's ONLY cross-device
# traffic (an all_gather of a few bytes per unique voxel, inserted by XLA
# when the sharded stream meets the replicated sort)
@functools.partial(jax.jit, static_argnames=("m",))
def _merge(streams, *, m: int):
    dp = streams[0].shape[0]
    cat = [
        jax.lax.slice(s, (0, 0), (dp, min(m, s.shape[1]))).reshape(-1)
        for s in streams
    ]
    return vox_ops.merge_unique_sums(cat[0], cat[1], cat[2:8], cat[8])


def build_scene_sharded(
    tri_verts,
    tri_colors=None,
    tri_emissions=None,
    *,
    origin,
    dps,
    grid_res: int,
    mesh: Mesh | None = None,
    n_devices: int | None = None,
    six_separating: bool = True,
    cap: int = 4,
    dag: bool = True,
    chunk_tris: int = 65536,
    accel: str = "octree",
):
    """Voxelize + build over a device mesh. Same contract (and bitwise the
    same tree) as models.scene.build_scene."""
    if mesh is None:
        mesh = make_build_mesh(n_devices)
    (dp,) = mesh.devices.shape
    tri_verts = np.asarray(tri_verts, np.float32).reshape(-1, 3, 3)
    if tri_colors is None:
        tri_colors = np.ones_like(tri_verts)
    if tri_emissions is None:
        tri_emissions = np.zeros_like(tri_verts)

    t_0 = time.time()
    tri, col, emi = meshprep.split_to_cap(
        tri_verts, tri_colors, tri_emissions, origin, dps, grid_res, cap
    )
    t_split = time.time()
    n_tri = len(tri)
    chunk = min(chunk_tris, octree_ops.bucket(n_tri, floor=1024))
    # every device owns the same static number of chunks L = n_chunks/dp
    tri, col, emi = meshprep.pad_triangles(tri, col, emi, chunk * dp)
    n_chunks = len(tri) // chunk
    L = n_chunks // dp
    origin_j = jnp.asarray(origin, jnp.float32)
    cand_per_chunk = chunk * cap * cap * cap

    shard = NamedSharding(mesh, P("dp"))
    repl = NamedSharding(mesh, P())

    def stack(x):
        return jax.device_put(
            np.ascontiguousarray(x.reshape(n_chunks, chunk, 3, 3)), shard
        )

    tri_s, col_s, emi_s = stack(tri), stack(col), stack(emi)

    count_pass, emit_unique_pass = _passes(
        mesh, grid_res, six_separating, cap, cand_per_chunk
    )
    counts = np.asarray(
        count_pass(tri_s, col_s, emi_s, origin_j, jnp.float32(dps))
    )  # readback 1
    t_count = time.time()
    total_dumped = int(counts.sum())
    if total_dumped == 0:
        raise ValueError("voxelization produced no voxels")

    # per-device local buffers sized by the worst device's dump total
    # (one static bucket keeps the jit cache warm across frames)
    dev_counts = counts.reshape(dp, L)
    dev_tot = dev_counts.sum(axis=1)

    # pass 2 (voxelize + group unique): see _passes for the body
    buf = octree_ops.bucket(int(dev_tot.max()) + cand_per_chunk)
    for _attempt in range(4):
        *streams, n_us, off_end = emit_unique_pass(
            tri_s, col_s, emi_s, origin_j, jnp.float32(dps), buf=buf
        )
        off_end = np.asarray(off_end)
        if int(off_end.max()) <= buf - cand_per_chunk:
            break
        buf *= 2  # sizing-pass drift crossed the bucket: retry, never corrupt
    else:
        raise RuntimeError("sharded build buffer sizing diverged")
    total_dumped = int(off_end.sum())  # exact dumps of the emit pass itself
    n_us = np.asarray(n_us)  # readback: compact each device's stream
    m = octree_ops.bucket(int(n_us.max()))

    uniq = jax.device_put(_merge(tuple(streams), m=m), repl)
    n_unique = int(uniq["n_unique"])  # readback 2
    t_unique = time.time()

    stats = dict(
        n_triangles=int(n_tri),
        n_dumped=total_dumped,
        n_unique=n_unique,
        grid_res=grid_res,
        n_devices=dp,
    )
    tree = scene_mod.build_accel_from_unique(
        uniq, origin=origin_j, dps=dps, grid_res=grid_res,
        accel=accel, dag=dag,
    )
    t_accel = time.time()
    stats["n_nodes"] = tree.n_nodes
    stats["accel_bytes"] = tree.memory_bytes()
    stats["t_split_s"] = t_split - t_0
    stats["t_count_s"] = t_count - t_split
    stats["t_unique_s"] = t_unique - t_count
    stats["t_accel_s"] = t_accel - t_unique
    stats["t_total_s"] = t_accel - t_0
    tree.build_stats = stats
    return tree
