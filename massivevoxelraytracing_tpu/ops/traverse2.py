"""Traversal v2: one-iteration-per-node-visit parametric octree walk.

v1 (traverse.py) is a faithful port of the reference's advance-one-axis
state machine: each while iteration advances a lane by at most one child
slot, so a node visit costs up to 5 iterations and every iteration pays the
full packet. v2 restructures the same traversal (same visit order, same
results) around a per-node *child selection*: compute all 8 children's
entry/exit times at once (they are static selects of t0/tM/t1 -- no
memory traffic), mask by occupancy / behind / resume-key, and take the
lexicographic minimum (entry, octant). Each iteration then either descends, records a leaf
hit, or pops -- one node visit per iteration, ~5x fewer iterations.

Extras over v1:
  * tail-descend elision: no push when no further sibling is valid, so the
    stack stays shallow (the reference's hasNext check, voxCommon.hpp:368).
  * resume keys (entry time + octant) replace the childMask, enabling the
    8-wide selection.
  * rays stream through a lax.map over fixed sub-blocks inside one jit:
    small blocks cut lockstep tail waste (every lane waits for its block's
    longest walk); one compile for any ray count.

Semantics match octreeTraverse_EfficientParametric (voxCommon.hpp:231-423):
mirror-by-XOR for negative directions, positive-entry hits only, in-order
early exit, nVoxelsPSum accumulation for the attribute index.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .bits import I32, U32, u32
from .octree import VoxelOctree

MAX_FLOAT = jnp.float32(3.402823466e38)
NEG_INF = jnp.float32(-3.402823466e38)
INVALID = 0xFFFFFFFF


def _c(x):
    return jnp.uint32(x)


def _max3(a, b, c):
    return jnp.maximum(a, jnp.maximum(b, c))


def _min3(a, b, c):
    return jnp.minimum(a, jnp.minimum(b, c))


def _traverse_block(meta, root_entry, lower, upper,
                    ro, rd, *, stack_depth: int, shadow: bool,
                    max_iters: int):
    """Core walk for one ray block [R, 3]."""
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

    zero_f = (ro[:, 0] + rd[:, 0]) * 0.0
    zero_u = zero_f.astype(U32)
    zero_i = zero_f.astype(I32)
    zst_f = jnp.broadcast_to(zero_f[:, None], (R, D))
    zst_u = zst_f.astype(U32)

    init = dict(
        node=u32(root_entry) + zero_u,
        t1x=t1v[:, 0], t1y=t1v[:, 1], t1z=t1v[:, 2],
        scale=zero_f + 1.0,
        rk_t=zero_f + NEG_INF,  # resume key: entry time
        rk_c=zero_i - 1,  # resume key: octant
        skipped=zero_u,
        sp=zero_i,
        active=enter_ok,
        t=zero_f + MAX_FLOAT,
        nmajor=zero_i - 1,
        vidx=zero_u,
        it=jnp.int32(0),
        s_node=zst_u, s_t1x=zst_f, s_t1y=zst_f, s_t1z=zst_f,
        s_scale=zst_f, s_rkt=zst_f, s_rkc=zst_u, s_skip=zst_u,
    )

    d_iota = jnp.arange(D, dtype=I32)[None, :]

    def cond(st):
        return jnp.any(st["active"]) & (st["it"] < max_iters)

    def body(st):
        active = st["active"]
        node = st["node"]
        t1x, t1y, t1z = st["t1x"], st["t1y"], st["t1z"]
        scale = st["scale"]

        hs = 0.5 * scale
        tmx = t1x - dtx * hs
        tmy = t1y - dty * hs
        tmz = t1z - dtz * hs
        tx0 = t1x - dtx * scale
        ty0 = t1y - dty * scale
        tz0 = t1z - dtz * scale

        node_mask = node >> 24

        # --- 8-wide child selection (static unroll; all [R] vector ops)
        best_t = jnp.full((R,), MAX_FLOAT)
        best_c = jnp.full((R,), 8, I32)
        n_valid = jnp.zeros((R,), I32)
        ex_sel = [(tmx, t1x), (tmy, t1y), (tmz, t1z)]
        en_sel = [(tx0, tmx), (ty0, tmy), (tz0, tmz)]
        for c in range(8):
            ex = _min3(
                ex_sel[0][(c >> 0) & 1],
                ex_sel[1][(c >> 1) & 1],
                ex_sel[2][(c >> 2) & 1],
            )
            en = _max3(
                en_sel[0][(c >> 0) & 1],
                en_sel[1][(c >> 1) & 1],
                en_sel[2][(c >> 2) & 1],
            )
            real = u32(c) ^ vmask
            occ = ((node_mask >> real) & 1) == 1
            after_resume = (en > st["rk_t"]) | (
                (en == st["rk_t"]) & (c > st["rk_c"])
            )
            valid = occ & (en < ex) & (ex > 0.0) & after_resume
            n_valid = n_valid + valid.astype(I32)
            better = valid & (
                (en < best_t) | ((en == best_t) & (jnp.int32(c) < best_c))
            )
            best_t = jnp.where(better, en, best_t)
            best_c = jnp.where(better, jnp.int32(c), best_c)
        any_other = n_valid > 1  # a sibling remains after taking the best

        found = active & (best_c < 8)
        pop = active & ~found

        # ONE row gather per iteration: node record = children[8] ++ psum[8]
        real_best = (best_c.astype(U32) ^ vmask) & _c(7)
        nrow = jnp.where(found, node & _c(0xFFFFFF), _c(0)).astype(I32)
        row = jnp.take(meta, nrow, axis=0, mode="clip")  # [R, 16]
        child_ptr = jnp.zeros_like(node)
        child_psum = jnp.zeros_like(node)
        for k in range(8):
            sel = real_best == k
            child_ptr = jnp.where(sel, row[:, k], child_ptr)
            child_psum = jnp.where(sel, row[:, 8 + k], child_psum)
        is_leaf_child = child_ptr == _c(INVALID)

        # --- leaf: in-order first hit wins (positive entries only, and
        # en > 0 is implied by ex > 0 ... no: entry can be <= 0 with exit > 0
        # when the origin is inside; those must be skipped, continue siblings.
        hit = found & is_leaf_child & (best_t > 0.0)
        t_out = jnp.where(hit, best_t, st["t"])
        # best child's per-axis entries/exits via selects on best_c bits
        bx = (best_c & 1) != 0
        by = (best_c & 2) != 0
        bz = (best_c & 4) != 0
        ex_x = jnp.where(bx, t1x, tmx)
        ex_y = jnp.where(by, t1y, tmy)
        ex_z = jnp.where(bz, t1z, tmz)
        en_xa = jnp.where(bx, tmx, tx0)
        en_ya = jnp.where(by, tmy, ty0)
        en_za = jnp.where(bz, tmz, tz0)
        nmaj_new = jnp.where(
            best_t == en_xa, 1, jnp.where(best_t == en_ya, 2, 0)
        )
        nmajor = jnp.where(hit, nmaj_new, st["nmajor"])
        if not shadow:
            skipped_here = st["skipped"] + child_psum
        else:
            skipped_here = st["skipped"]
        vidx = jnp.where(hit, skipped_here, st["vidx"])
        active = active & ~hit

        # leaf we must skip (entry <= 0): stay on this node, resume past it
        skip_leaf = found & is_leaf_child & ~hit
        # interior child: descend
        descend = found & ~is_leaf_child & active
        push = descend & any_other

        # --- push current node with resume key = taken child
        wcol = (d_iota == st["sp"][:, None]) & push[:, None]
        s_node = jnp.where(wcol, node[:, None], st["s_node"])
        s_t1x = jnp.where(wcol, t1x[:, None], st["s_t1x"])
        s_t1y = jnp.where(wcol, t1y[:, None], st["s_t1y"])
        s_t1z = jnp.where(wcol, t1z[:, None], st["s_t1z"])
        s_scale = jnp.where(wcol, scale[:, None], st["s_scale"])
        s_rkt = jnp.where(wcol, best_t[:, None], st["s_rkt"])
        s_rkc = jnp.where(wcol, best_c.astype(U32)[:, None], st["s_rkc"])
        s_skip = jnp.where(wcol, st["skipped"][:, None], st["s_skip"])
        sp = st["sp"] + push.astype(I32)

        # --- state updates
        node = jnp.where(descend, child_ptr, node)
        t1x = jnp.where(descend, ex_x, t1x)
        t1y = jnp.where(descend, ex_y, t1y)
        t1z = jnp.where(descend, ex_z, t1z)
        scale = jnp.where(descend, hs, scale)
        rk_t = jnp.where(
            descend, NEG_INF, jnp.where(skip_leaf, best_t, st["rk_t"])
        )
        rk_c = jnp.where(
            descend, -1, jnp.where(skip_leaf, best_c, st["rk_c"])
        )
        # only a real descend accumulates the attribute prefix sum
        if not shadow:
            skipped = jnp.where(descend, skipped_here, st["skipped"])
        else:
            skipped = st["skipped"]

        # --- pop
        exhausted = pop & (sp == 0)
        active = active & ~exhausted
        do_pop = pop & (sp > 0) & active
        sp = sp - do_pop.astype(I32)
        rcol = d_iota == sp[:, None]

        def read(arr, cur, m):
            v = jnp.sum(jnp.where(rcol, arr, jnp.zeros_like(arr)), axis=1)
            return jnp.where(m, v, cur)

        node = read(s_node, node, do_pop)
        t1x = read(s_t1x, t1x, do_pop)
        t1y = read(s_t1y, t1y, do_pop)
        t1z = read(s_t1z, t1z, do_pop)
        scale = read(s_scale, scale, do_pop)
        rk_t = read(s_rkt, rk_t, do_pop)
        rk_c = jnp.where(
            do_pop,
            jnp.sum(jnp.where(rcol, s_rkc, jnp.zeros_like(s_rkc)), axis=1).astype(I32),
            rk_c,
        )
        skipped = read(s_skip, skipped, do_pop)

        return dict(
            node=node, t1x=t1x, t1y=t1y, t1z=t1z, scale=scale,
            rk_t=rk_t, rk_c=rk_c, skipped=skipped, sp=sp, active=active,
            t=t_out, nmajor=nmajor, vidx=vidx, it=st["it"] + 1,
            s_node=s_node, s_t1x=s_t1x, s_t1y=s_t1y, s_t1z=s_t1z,
            s_scale=s_scale, s_rkt=s_rkt, s_rkc=s_rkc, s_skip=s_skip,
        )

    out = jax.lax.while_loop(cond, body, init)
    return out["t"], out["nmajor"], out["vidx"]


@partial(
    jax.jit,
    static_argnames=("stack_depth", "shadow", "max_iters", "block"),
)
def intersect_rays2(
    meta, root_entry, lower, upper, ro, rd,
    *, stack_depth: int, shadow: bool = False, max_iters: int = 100_000,
    block: int = 65536,
):
    """v2 entry point: rays processed in `block`-sized sub-packets via
    lax.map (one compile for any ray count; block trades lockstep tail waste
    against per-iteration dispatch overhead)."""
    return map_ray_blocks(
        lambda ro_b, rd_b: _traverse_block(
            meta, root_entry, lower, upper, ro_b, rd_b,
            stack_depth=stack_depth, shadow=shadow, max_iters=max_iters,
        ),
        ro, rd, block,
    )


def map_ray_blocks(walk, ro, rd, block: int):
    """Run a lockstep walk `walk(ro, rd) -> (t, nmajor, vidx)` over rays in
    sequential sub-packets of `block` rays. A ray count that is not a
    multiple of `block` is padded with rays parked far outside every scene
    (they retire on iteration 0); their results are dropped."""
    R = ro.shape[0]
    if R <= block:
        return walk(ro, rd)
    nb = -(-R // block)
    pad = nb * block - R
    if pad:
        ro = jnp.concatenate([ro, jnp.full((pad, 3), 1e9, ro.dtype)])
        rd = jnp.concatenate([rd, jnp.ones((pad, 3), rd.dtype)])
    t, nmaj, vidx = jax.lax.map(
        lambda args: walk(*args),
        (ro.reshape(nb, block, 3), rd.reshape(nb, block, 3)),
    )
    return t.reshape(-1)[:R], nmaj.reshape(-1)[:R], vidx.reshape(-1)[:R]


def tree_meta(tree: VoxelOctree):
    if tree.meta is not None:
        return tree.meta
    return jnp.concatenate([tree.children, tree.psum], axis=1)


def intersect_octree2(tree: VoxelOctree, ro, rd, shadow: bool = False,
                      max_iters: int = 100_000, block: int = 65536):
    depth = max(int(tree.grid_res).bit_length() - 1, 1)
    import numpy as np

    ro = jnp.asarray(np.asarray(ro, np.float32))
    rd = jnp.asarray(np.asarray(rd, np.float32))
    from .traverse import root_entry_of

    return intersect_rays2(
        tree_meta(tree),
        root_entry_of(tree),
        tree.lower,
        tree.upper,
        ro,
        rd,
        stack_depth=max(depth, 1),
        shadow=shadow,
        max_iters=max_iters,
        block=block,
    )
