"""Revelles-style efficient parametric octree traversal over ray packets.

Reference inner loop: octreeTraverse_EfficientParametric (voxCommon.hpp:231-423,
SMALL_STACK variant) -- a per-thread stack walk with gotos. A lockstep SIMD
machine can't branch per lane, so the array form flattens the nested
loops into a *single-step state machine* iterated by lax.while_loop over the
whole ray packet:

  every iteration, each active lane either
    ENTER+ADVANCE: recompute t0 = t1 - dt*scale (the reference's SMALL_STACK
      recompute trick -- ideal here too, it keeps per-lane state at 7 words),
      lazily derive the first-child mask from the t midplanes, find the next
      child boundary, and either
        DESCEND into an occupied, non-behind child (pushing the resumable
        parent state when more siblings remain), or
        ADVANCE the child mask one step, or
        POP the stack / retire.
    Leaf lanes (node == 0xFFFFFFFF) record a hit when the entry plane is in
      front (traversal is in perfect ray order, so the first leaf hit wins,
      matching the reference's break) and retire or pop.

Mirroring of negative ray directions via the vMask XOR and the 1/rd overflow
clamp follow voxCommon.hpp:240-269 exactly. nVoxelsPSum accumulation along
the path yields the flat attribute index (skipped for shadow rays).

Stack storage: 7 channel arrays [R, D] in HBM/VMEM; push/pop are masked
column selects (no scatter -- D = log2(gridRes) is small and static).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .bits import F32, I32, U32, u32
from .octree import VoxelOctree

MAX_FLOAT = jnp.float32(3.402823466e38)
INVALID = 0xFFFFFFFF


def _c(x):
    return jnp.uint32(x)


def _max3(a, b, c):
    return jnp.maximum(a, jnp.maximum(b, c))


def _min3(a, b, c):
    return jnp.minimum(a, jnp.minimum(b, c))


@partial(jax.jit, static_argnames=("stack_depth", "shadow", "max_iters"))
def intersect_rays(
    children_flat,  # u32 [N*8] embedded-mask child pointers
    psum_flat,  # u32 [N*8]
    root_entry,  # u32 scalar: rootIndex | mask[root] << 24
    lower,  # f32 [3]
    upper,  # f32 [3]
    ro,  # f32 [R, 3]
    rd,  # f32 [R, 3]
    *,
    stack_depth: int,
    shadow: bool = False,
    max_iters: int = 100_000,
):
    """Returns (t f32[R] with MAX_FLOAT for miss, n_major i32[R] in
    {1: x, 2: y, 0: z}, v_index u32[R] flat voxel attribute rank)."""
    R = ro.shape[0]
    D = stack_depth

    inv = 1.0 / rd
    neg_x = inv[:, 0] < 0.0
    neg_y = inv[:, 1] < 0.0
    neg_z = inv[:, 2] < 0.0
    vmask = (
        neg_x.astype(U32)
        | (neg_y.astype(U32) << 1)
        | (neg_z.astype(U32) << 2)
    )
    lo = lower[None, :]
    up = upper[None, :]
    mirror = jnp.stack([neg_x, neg_y, neg_z], axis=-1)
    ro_m = jnp.where(mirror, lo + up - ro, ro)
    inv_a = jnp.abs(inv)
    # The reference clamps 1/rd so t0/t1 stay <= MAX_FLOAT (voxCommon.hpp:265-269)
    # but dt = t1 - t0 can still overflow to inf for axis-parallel rays,
    # corrupting the midplane child classification. Clamp to MAX/4 instead so
    # |t| <= MAX/4 and dt <= MAX/2 stays finite (t values this large are
    # effectively "never", semantics unchanged).
    bound = (0.25 * MAX_FLOAT) / jnp.maximum(
        jnp.maximum(jnp.abs(lo - ro_m), jnp.abs(up - ro_m)), 1.0
    )
    inv_a = jnp.minimum(inv_a, bound)

    t0v = (lo - ro_m) * inv_a
    t1v = (up - ro_m) * inv_a
    s_lmax_top = _max3(t0v[:, 0], t0v[:, 1], t0v[:, 2])
    enter_ok = _min3(t1v[:, 0], t1v[:, 1], t1v[:, 2]) >= s_lmax_top

    dtx = t1v[:, 0] - t0v[:, 0]
    dty = t1v[:, 1] - t0v[:, 1]
    dtz = t1v[:, 2] - t0v[:, 2]

    # Derive zero-valued carries from the ray arrays so every while-loop
    # carry component is device-varying under shard_map (constant inits are
    # 'unvarying' and trip the vma check when the body mixes them with
    # sharded data).
    zero_f = (ro[:, 0] + rd[:, 0]) * 0.0
    zero_u = zero_f.astype(U32)
    zero_i = zero_f.astype(I32)
    zstack_f = jnp.broadcast_to(zero_f[:, None], (R, D))
    zstack_u = zstack_f.astype(U32)
    init = dict(
        node=u32(root_entry) + zero_u,
        t1x=t1v[:, 0],
        t1y=t1v[:, 1],
        t1z=t1v[:, 2],
        scale=zero_f + 1.0,
        cm=zero_u + _c(INVALID),
        skipped=zero_u,
        sp=zero_i,
        active=enter_ok,
        t=zero_f + MAX_FLOAT,
        nmajor=zero_i - 1,
        vidx=zero_u,
        it=jnp.int32(0),
        # stack channels
        s_node=zstack_u,
        s_t1x=zstack_f,
        s_t1y=zstack_f,
        s_t1z=zstack_f,
        s_scale=zstack_f,
        s_cm=zstack_u,
        s_skip=zstack_u,
    )

    d_iota = jnp.arange(D, dtype=I32)[None, :]

    def cond(st):
        return jnp.any(st["active"]) & (st["it"] < max_iters)

    def body(st):
        active = st["active"]
        node = st["node"]
        t1x, t1y, t1z = st["t1x"], st["t1y"], st["t1z"]
        scale = st["scale"]
        cm = st["cm"]

        tx0 = t1x - dtx * scale
        ty0 = t1y - dty * scale
        tz0 = t1z - dtz * scale
        s_lmax = _max3(tx0, ty0, tz0)

        isleaf = node == _c(INVALID)

        # --- leaf: hit or pop (voxCommon.hpp:322-335)
        hit = active & isleaf & (0.0 < s_lmax)
        t = jnp.where(hit, s_lmax, st["t"])
        nmajor = jnp.where(
            hit,
            jnp.where(s_lmax == tx0, 1, jnp.where(s_lmax == ty0, 2, 0)),
            st["nmajor"],
        )
        vidx = jnp.where(hit, st["skipped"], st["vidx"])
        active = active & ~hit
        pop_leaf = active & isleaf  # S_lmax <= 0: behind the ray

        # --- interior node
        txm = 0.5 * (tx0 + t1x)
        tym = 0.5 * (ty0 + t1y)
        tzm = 0.5 * (tz0 + t1z)
        cm0 = jnp.where(
            cm == _c(INVALID),
            (txm < s_lmax).astype(U32)
            | ((tym < s_lmax).astype(U32) << 1)
            | ((tzm < s_lmax).astype(U32) << 2),
            cm,
        )
        x1 = jnp.where((cm0 & 1) != 0, t1x, txm)
        y1 = jnp.where((cm0 & 2) != 0, t1y, tym)
        z1 = jnp.where((cm0 & 4) != 0, t1z, tzm)
        s_umin = _min3(x1, y1, z1)
        mv = jnp.where(s_umin == x1, _c(1), jnp.where(s_umin == y1, _c(2), _c(4)))
        has_next = (cm0 & mv) == 0
        child_idx = cm0 ^ vmask

        node_body = node & _c(0xFFFFFF)
        lin = node_body * 8 + child_idx
        lin = jnp.where(isleaf | ~active, _c(0), lin).astype(I32)
        child_ptr = jnp.take(children_flat, lin, mode="clip")
        node_mask = node >> 24
        occupied = ((node_mask >> child_idx) & 1) == 1
        is_behind = s_umin < 0.0

        work = active & ~isleaf
        descend = work & occupied & ~is_behind
        push = descend & has_next
        advance = work & ~descend & has_next
        pop_adv = work & ~descend & ~has_next
        pop = pop_leaf | pop_adv

        # --- push parent (childMask already advanced past mv)
        cm_stored = cm0 | mv
        wcol = (d_iota == st["sp"][:, None]) & push[:, None]
        s_node = jnp.where(wcol, node[:, None], st["s_node"])
        s_t1x = jnp.where(wcol, t1x[:, None], st["s_t1x"])
        s_t1y = jnp.where(wcol, t1y[:, None], st["s_t1y"])
        s_t1z = jnp.where(wcol, t1z[:, None], st["s_t1z"])
        s_scale = jnp.where(wcol, scale[:, None], st["s_scale"])
        s_cm = jnp.where(wcol, cm_stored[:, None], st["s_cm"])
        s_skip = jnp.where(wcol, st["skipped"][:, None], st["s_skip"])
        sp = st["sp"] + push.astype(I32)

        # --- descend / advance updates
        node = jnp.where(descend, child_ptr, node)
        t1x = jnp.where(descend, x1, t1x)
        t1y = jnp.where(descend, y1, t1y)
        t1z = jnp.where(descend, z1, t1z)
        scale = jnp.where(descend, scale * 0.5, scale)
        cm = jnp.where(descend, _c(INVALID), jnp.where(advance, cm_stored, cm))
        if not shadow:
            child_psum = jnp.take(psum_flat, lin, mode="clip")
            skipped = jnp.where(descend, st["skipped"] + child_psum, st["skipped"])
        else:
            skipped = st["skipped"]

        # --- pop
        exhausted = pop & (sp == 0)
        active = active & ~exhausted
        do_pop = pop & (sp > 0)
        sp = sp - do_pop.astype(I32)
        rcol = d_iota == sp[:, None]

        def read(arr, cur, mask1d):
            v = jnp.sum(jnp.where(rcol, arr, jnp.zeros_like(arr)), axis=1)
            return jnp.where(mask1d, v, cur)

        node = read(s_node, node, do_pop)
        t1x = read(s_t1x, t1x, do_pop)
        t1y = read(s_t1y, t1y, do_pop)
        t1z = read(s_t1z, t1z, do_pop)
        scale = read(s_scale, scale, do_pop)
        cm = read(s_cm, cm, do_pop)
        skipped = read(s_skip, skipped, do_pop)

        return dict(
            node=node,
            t1x=t1x,
            t1y=t1y,
            t1z=t1z,
            scale=scale,
            cm=cm,
            skipped=skipped,
            sp=sp,
            active=active,
            t=t,
            nmajor=nmajor,
            vidx=vidx,
            it=st["it"] + 1,
            s_node=s_node,
            s_t1x=s_t1x,
            s_t1y=s_t1y,
            s_t1z=s_t1z,
            s_scale=s_scale,
            s_cm=s_cm,
            s_skip=s_skip,
        )

    out = jax.lax.while_loop(cond, body, init)
    return out["t"], out["nmajor"], out["vidx"]


def root_entry_of(tree: VoxelOctree):
    """rootIndex | mask[root] << 24 (the embedded-mask bootstrap,
    voxCommon.hpp:305-307)."""
    root = tree.root
    return (u32(root) | (tree.mask[root] << 24)).astype(U32)


def intersect_octree(tree: VoxelOctree, ro, rd, shadow: bool = False,
                     max_iters: int = 100_000):
    """Convenience wrapper over a VoxelOctree."""
    depth = int(tree.grid_res).bit_length() - 1
    return intersect_rays(
        tree.children.reshape(-1),
        tree.psum.reshape(-1),
        root_entry_of(tree),
        tree.lower,
        tree.upper,
        jnp.asarray(ro, F32),
        jnp.asarray(rd, F32),
        stack_depth=max(depth, 1),
        shadow=shadow,
        max_iters=max_iters,
    )


def hit_normal(n_major, rd):
    """Face normal from the major axis + ray sign (getHitN,
    voxCommon.hpp:565-577). n_major: i32[R], rd: f32[R, 3] -> f32[R, 3]."""
    sx = jnp.where(0.0 < rd[:, 0], -1.0, 1.0)
    sy = jnp.where(0.0 < rd[:, 1], -1.0, 1.0)
    sz = jnp.where(0.0 < rd[:, 2], -1.0, 1.0)
    zero = jnp.zeros_like(sx)
    nx = jnp.where(n_major == 1, sx, zero)
    ny = jnp.where(n_major == 2, sy, zero)
    nz = jnp.where(n_major == 0, sz, zero)
    return jnp.stack([nx, ny, nz], axis=-1)
