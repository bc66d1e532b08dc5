"""BrickTree64: a 4^3-branching sparse voxel tree, the production
structure.

Traversal speed is set largely by *node visits per ray*, each one a
dependent row-gather. An octree does one gather per 2x-halving; a 64-ary
tree does one per 4x-halving AND makes sibling stepping, occupancy tests,
child indexing, and voxel ranking pure register arithmetic:

  node record (u32 x 4, one row-gather):
    [mask_lo, mask_hi, base, 0]   64-bit cell occupancy over the 4^3 grid
  interior: child index = base + popcount64(mask & below(cell))   (children
            of a node are contiguous because nodes are built morton-sorted)
  leaf:     voxel rank  = base + popcount64(mask & below(cell))   (base =
            rank of the brick's first voxel in the sorted unique array)

so the flat attribute indexing that the reference threads through
nVoxelsPSum accumulation (voxCommon.hpp:390) falls out of popcounts with no
per-level state. The tree is built straight from the same sorted Morton
voxel stream as the octree (shift 6 per level instead of 3); rendering
results are bit-identical in content to the octree traversal (same voxel
set, same in-order first hit, same ranks).

Grid resolutions that aren't powers of 4 are padded up: the root simply
covers a larger empty box.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .bits import I32, U32, popcount32, u32
from . import morton
from .traverse2 import map_ray_blocks

INVALID = 0xFFFFFFFF
MAX_FLOAT = jnp.float32(3.402823466e38)
NEG_INF = jnp.float32(-3.402823466e38)


def _c(x):
    return jnp.uint32(x)


@dataclasses.dataclass
class BrickTree:
    meta: jax.Array  # u32 [N, 4]: mask_lo, mask_hi, base, pad
    n_nodes: int
    root: int
    n_levels: int  # brick levels (each covers 4x per axis)
    grid_res: int  # padded to a power of 4
    lower: jax.Array  # f32 [3]
    upper: jax.Array  # f32 [3] = lower + dps * grid_res (padded)
    color: jax.Array | None = None
    emission: jax.Array | None = None
    n_voxels: int = 0
    has_emission: bool = False

    def memory_bytes(self) -> int:
        return self.n_nodes * 16


def pad_res_pow4(grid_res: int) -> int:
    levels = (int(grid_res).bit_length() - 1 + 1) // 2  # ceil(log2/2)
    return 4 ** max(levels, 1)


@partial(jax.jit, static_argnames=("n_levels",))
def _level_counts64(m_hi, m_lo, valid, *, n_levels: int):
    counts = []
    for l in range(n_levels):
        p_hi, p_lo = morton.morton_shr(m_hi, m_lo, 6 * (l + 1))
        ne = jnp.concatenate(
            [jnp.ones((1,), bool), (p_hi[1:] != p_hi[:-1]) | (p_lo[1:] != p_lo[:-1])]
        )
        counts.append(jnp.sum((ne & valid).astype(I32)))
    return jnp.stack(counts)


@partial(jax.jit, static_argnames=("p_out",))
def _build_level64(t_hi, t_lo, n_in, child_start, *, p_out: int):
    """Group tasks (sorted mortons of the level below) by 64-cell parents.

    child_start: global index of the first task's node in the level below
    (0 for the voxel level, where `base` means voxel rank instead).
    Returns node mask_lo/mask_hi/base arrays (padded p_out) + parent mortons.
    """
    p_in = t_hi.shape[0]
    idx = jnp.arange(p_in, dtype=I32)
    valid = idx < n_in

    p_hi, p_lo = morton.morton_shr(t_hi, t_lo, 6)
    cell = (t_lo & _c(63)).astype(I32)

    ne = jnp.concatenate(
        [jnp.ones((1,), bool), (p_hi[1:] != p_hi[:-1]) | (p_lo[1:] != p_lo[:-1])]
    )
    boundary = valid & ne
    gid = jnp.cumsum(boundary.astype(I32)) - 1
    n_groups = jnp.sum(boundary.astype(I32))
    gid = jnp.where(valid, gid, p_out)

    bit_lo = jnp.where(cell < 32, _c(1) << u32(jnp.minimum(cell, 31)), _c(0))
    bit_hi = jnp.where(cell >= 32, _c(1) << u32(jnp.maximum(cell - 32, 0)), _c(0))
    mask_lo = jnp.zeros((p_out + 1,), U32).at[gid].add(bit_lo)
    mask_hi = jnp.zeros((p_out + 1,), U32).at[gid].add(bit_hi)

    gstart = jax.ops.segment_min(idx, gid, num_segments=p_out + 1)
    gstart = jnp.minimum(gstart, p_in - 1)
    base = (gstart.astype(U32) + u32(child_start))[:p_out]
    g_hi = jnp.take(p_hi, gstart)[:p_out]
    g_lo = jnp.take(p_lo, gstart)[:p_out]

    gidx = jnp.arange(p_out, dtype=I32)
    gv = gidx < n_groups
    return dict(
        mask_lo=jnp.where(gv, mask_lo[:p_out], _c(0)),
        mask_hi=jnp.where(gv, mask_hi[:p_out], _c(0)),
        base=jnp.where(gv, base, _c(0)),
        t_hi=jnp.where(gv, g_hi, _c(INVALID)),
        t_lo=jnp.where(gv, g_lo, _c(INVALID)),
        n_groups=n_groups,
    )


@partial(jax.jit, static_argnames=("total_pad",))
def _assemble64(levels, offsets, *, total_pad: int):
    meta = jnp.zeros((total_pad, 4), U32)
    for l, lv in enumerate(levels):
        block = jnp.stack(
            [lv["mask_lo"], lv["mask_hi"], lv["base"], jnp.zeros_like(lv["base"])],
            axis=1,
        )
        meta = jax.lax.dynamic_update_slice(meta, block, (offsets[l], 0))
    return meta


def build_bricktree(
    m_hi, m_lo, n_voxels: int, grid_res: int, *,
    lower=None, dps: float = 1.0, color=None, emission=None,
    has_emission: bool = False,
) -> BrickTree:
    """Build from sorted unique Morton pairs (padded arrays, n_voxels valid)."""
    res4 = pad_res_pow4(grid_res)
    n_levels = (int(res4).bit_length() - 1) // 2
    assert n_levels >= 1

    from .octree import bucket

    p0 = m_hi.shape[0]
    valid = jnp.arange(p0, dtype=I32) < n_voxels
    counts = np.asarray(_level_counts64(m_hi, m_lo, valid, n_levels=n_levels))
    assert counts[-1] == 1, f"root must be single, got {counts[-1]}"

    # level l node array size = counts[l]; bases reference level l-1 nodes
    # (or voxel ranks for l = 0). Offsets in the global meta array go
    # bottom-up: level 0 first.
    offsets = [0]
    for l in range(n_levels):
        offsets.append(offsets[-1] + int(counts[l]))
    total = offsets[-1]

    levels = []
    t_hi, t_lo = m_hi, m_lo
    n_in = n_voxels
    for l in range(n_levels):
        p_out = bucket(int(counts[l]))
        child_start = 0 if l == 0 else offsets[l - 1]
        out = _build_level64(
            t_hi, t_lo, jnp.int32(n_in), jnp.uint32(child_start), p_out=p_out
        )
        levels.append(out)
        t_hi, t_lo = out["t_hi"], out["t_lo"]
        n_in = int(counts[l])

    p_max = max(lv["mask_lo"].shape[0] for lv in levels)
    total_pad = bucket(total + p_max)
    meta = _assemble64(
        tuple(levels), jnp.asarray(offsets[:-1], I32), total_pad=total_pad
    )

    if lower is None:
        lower = np.zeros(3, np.float32)
    lower = jnp.asarray(lower, jnp.float32)
    upper = lower + jnp.float32(dps) * res4
    return BrickTree(
        meta=meta,
        n_nodes=total,
        root=total - 1,
        n_levels=n_levels,
        grid_res=res4,
        lower=lower,
        upper=upper,
        color=color,
        emission=emission,
        n_voxels=int(n_voxels),
        has_emission=bool(has_emission),
    )


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def _popcount64_below(mask_lo, mask_hi, cell):
    """popcount of mask bits strictly below `cell` (i32 [R] in [0, 64))."""
    c = cell.astype(I32)
    below_lo = jnp.where(
        c >= 32,
        _c(0xFFFFFFFF),
        (_c(1) << u32(jnp.clip(c, 0, 31))) - _c(1),
    )
    below_hi = jnp.where(
        c >= 32,
        (_c(1) << u32(jnp.clip(c - 32, 0, 31))) - _c(1),
        _c(0),
    )
    # c == 32 gives below_hi == 0 correctly; c == 63 -> (1<<31)-1 correct.
    return popcount32(mask_lo & below_lo) + popcount32(mask_hi & below_hi)


def _bit_at(mask_lo, mask_hi, cell):
    c = cell.astype(I32)
    lo = (mask_lo >> u32(jnp.clip(c, 0, 31))) & _c(1)
    hi = (mask_hi >> u32(jnp.clip(c - 32, 0, 31))) & _c(1)
    return jnp.where(c < 32, lo, hi) == 1


# cell morton decode tables (static): cell c -> (x, y, z) in [0, 4)
_CX = [((c >> 0) & 1) | (((c >> 3) & 1) << 1) for c in range(64)]
_CY = [((c >> 1) & 1) | (((c >> 4) & 1) << 1) for c in range(64)]
_CZ = [((c >> 2) & 1) | (((c >> 5) & 1) << 1) for c in range(64)]


def _traverse_block64(meta, root, n_levels, lower, upper, ro, rd,
                      *, shadow: bool, max_iters: int):
    R = ro.shape[0]
    D = n_levels  # stack depth bound (root is never pushed after descent...)

    inv = 1.0 / rd
    neg_x = inv[:, 0] < 0.0
    neg_y = inv[:, 1] < 0.0
    neg_z = inv[:, 2] < 0.0
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
    s_top = jnp.maximum(t0v[:, 0], jnp.maximum(t0v[:, 1], t0v[:, 2]))
    enter_ok = jnp.minimum(t1v[:, 0], jnp.minimum(t1v[:, 1], t1v[:, 2])) >= s_top

    # mirrored-cell XOR pattern: complementing a 2-bit coord = XOR 0b11,
    # spread over both morton levels of the cell index
    vm64 = (
        neg_x.astype(U32) * _c(0b001001)
        | neg_y.astype(U32) * _c(0b010010)
        | neg_z.astype(U32) * _c(0b100100)
    )

    dtx = t1v[:, 0] - t0v[:, 0]
    dty = t1v[:, 1] - t0v[:, 1]
    dtz = t1v[:, 2] - t0v[:, 2]

    zero_f = (ro[:, 0] + rd[:, 0]) * 0.0
    zero_u = zero_f.astype(U32)
    zero_i = zero_f.astype(I32)
    zst_f = jnp.broadcast_to(zero_f[:, None], (R, D))
    zst_u = zst_f.astype(U32)

    init = dict(
        node=u32(root) + zero_u,
        # interior/leaf discrimination by tree level: track depth instead of
        # a pointer tag. depth counts down: n_levels-1 = root level ... 0 =
        # leaf bricks.
        depth=zero_i + (n_levels - 1),
        t1x=t1v[:, 0], t1y=t1v[:, 1], t1z=t1v[:, 2],
        scale=zero_f + 1.0,
        rk_t=zero_f + NEG_INF,
        rk_c=zero_i - 1,
        sp=zero_i,
        active=enter_ok,
        t=zero_f + MAX_FLOAT,
        nmajor=zero_i - 1,
        vidx=zero_u,
        it=jnp.int32(0),
        s_node=zst_u, s_depth=zst_u, s_t1x=zst_f, s_t1y=zst_f, s_t1z=zst_f,
        s_scale=zst_f, s_rkt=zst_f, s_rkc=zst_u,
    )

    d_iota = jnp.arange(D, dtype=I32)[None, :]

    def cond(st):
        return jnp.any(st["active"]) & (st["it"] < max_iters)

    def body(st):
        active = st["active"]
        node = st["node"]
        t1x, t1y, t1z = st["t1x"], st["t1y"], st["t1z"]
        scale = st["scale"]

        # node meta row (the ONE gather)
        nrow = jnp.where(active, node, _c(0)).astype(I32)
        row = jnp.take(meta, nrow, axis=0, mode="clip")  # [R, 4]
        mask_lo = row[:, 0]
        mask_hi = row[:, 1]
        base = row[:, 2]

        # cell boundaries: tb_a[k] = t1 - dt*scale*(1 - k/4), k = 0..4
        qs = scale * 0.25
        tbx = [t1x - dtx * (scale - qs * k) for k in range(5)]
        tby = [t1y - dty * (scale - qs * k) for k in range(5)]
        tbz = [t1z - dtz * (scale - qs * k) for k in range(5)]

        best_t = jnp.full((R,), MAX_FLOAT)
        best_c = jnp.full((R,), 64, I32)
        n_valid = jnp.zeros((R,), I32)
        rk_t = st["rk_t"]
        rk_c = st["rk_c"]
        for c in range(64):
            x, y, z = _CX[c], _CY[c], _CZ[c]
            en = jnp.maximum(tbx[x], jnp.maximum(tby[y], tbz[z]))
            ex = jnp.minimum(tbx[x + 1], jnp.minimum(tby[y + 1], tbz[z + 1]))
            real_c = u32(c) ^ vm64
            occ = _bit_at(mask_lo, mask_hi, real_c)
            after = (en > rk_t) | ((en == rk_t) & (c > rk_c))
            valid = occ & (en < ex) & (ex > 0.0) & after
            n_valid = n_valid + valid.astype(I32)
            better = valid & (en < best_t)  # strict: first (lowest c) wins ties
            best_t = jnp.where(better, en, best_t)
            best_c = jnp.where(better, jnp.int32(c), best_c)
        any_other = n_valid > 1

        found = active & (best_c < 64)
        pop = active & ~found

        real_best = (best_c.astype(U32) ^ vm64) & _c(63)
        rank = _popcount64_below(mask_lo, mask_hi, real_best)
        target = base + rank  # child node index or voxel rank
        is_leaf = st["depth"] == 0

        hit = found & is_leaf & (best_t > 0.0)
        t_out = jnp.where(hit, best_t, st["t"])
        # per-axis entry of the best cell for the face normal
        bx = best_c & 3
        # reconstruct best cell coords
        cbx = (best_c & 1) | (((best_c >> 3) & 1) << 1)
        cby = ((best_c >> 1) & 1) | (((best_c >> 4) & 1) << 1)
        cbz = ((best_c >> 2) & 1) | (((best_c >> 5) & 1) << 1)
        sel = lambda tb, k: (
            jnp.where(k == 0, tb[0],
            jnp.where(k == 1, tb[1],
            jnp.where(k == 2, tb[2], tb[3])))
        )
        en_xa = sel(tbx, cbx)
        en_ya = sel(tby, cby)
        en_za = sel(tbz, cbz)
        nmaj_new = jnp.where(best_t == en_xa, 1, jnp.where(best_t == en_ya, 2, 0))
        nmajor = jnp.where(hit, nmaj_new, st["nmajor"])
        vidx = jnp.where(hit, target, st["vidx"])
        active = active & ~hit

        skip_leaf = found & is_leaf & ~hit
        descend = found & ~is_leaf & active
        push = descend & any_other

        wcol = (d_iota == st["sp"][:, None]) & push[:, None]
        s_node = jnp.where(wcol, node[:, None], st["s_node"])
        s_depth = jnp.where(wcol, st["depth"].astype(U32)[:, None], st["s_depth"])
        s_t1x = jnp.where(wcol, t1x[:, None], st["s_t1x"])
        s_t1y = jnp.where(wcol, t1y[:, None], st["s_t1y"])
        s_t1z = jnp.where(wcol, t1z[:, None], st["s_t1z"])
        s_scale = jnp.where(wcol, scale[:, None], st["s_scale"])
        s_rkt = jnp.where(wcol, best_t[:, None], st["s_rkt"])
        s_rkc = jnp.where(wcol, best_c.astype(U32)[:, None], st["s_rkc"])
        sp = st["sp"] + push.astype(I32)

        # descend state
        ex_x = sel(tbx[1:], cbx)  # tbx[cbx+1]
        ex_y = sel(tby[1:], cby)
        ex_z = sel(tbz[1:], cbz)
        node = jnp.where(descend, target, node)
        depth = jnp.where(descend, st["depth"] - 1, st["depth"])
        t1x = jnp.where(descend, ex_x, t1x)
        t1y = jnp.where(descend, ex_y, t1y)
        t1z = jnp.where(descend, ex_z, t1z)
        scale = jnp.where(descend, qs, scale)
        rk_t2 = jnp.where(descend, NEG_INF, jnp.where(skip_leaf, best_t, rk_t))
        rk_c2 = jnp.where(descend, -1, jnp.where(skip_leaf, best_c, rk_c))

        # pop
        exhausted = pop & (sp == 0)
        active = active & ~exhausted
        do_pop = pop & (sp > 0) & active
        sp = sp - do_pop.astype(I32)
        rcol = d_iota == sp[:, None]

        def read(arr, cur, m):
            v = jnp.sum(jnp.where(rcol, arr, jnp.zeros_like(arr)), axis=1)
            return jnp.where(m, v, cur)

        node = read(s_node, node, do_pop)
        depth = jnp.where(
            do_pop,
            jnp.sum(jnp.where(rcol, s_depth, jnp.zeros_like(s_depth)), axis=1).astype(I32),
            depth,
        )
        t1x = read(s_t1x, t1x, do_pop)
        t1y = read(s_t1y, t1y, do_pop)
        t1z = read(s_t1z, t1z, do_pop)
        scale = read(s_scale, scale, do_pop)
        rk_t2 = read(s_rkt, rk_t2, do_pop)
        rk_c2 = jnp.where(
            do_pop,
            jnp.sum(jnp.where(rcol, s_rkc, jnp.zeros_like(s_rkc)), axis=1).astype(I32),
            rk_c2,
        )

        return dict(
            node=node, depth=depth, t1x=t1x, t1y=t1y, t1z=t1z, scale=scale,
            rk_t=rk_t2, rk_c=rk_c2, sp=sp, active=active,
            t=t_out, nmajor=nmajor, vidx=vidx, it=st["it"] + 1,
            s_node=s_node, s_depth=s_depth, s_t1x=s_t1x, s_t1y=s_t1y,
            s_t1z=s_t1z, s_scale=s_scale, s_rkt=s_rkt, s_rkc=s_rkc,
        )

    out = jax.lax.while_loop(cond, body, init)
    return out["t"], out["nmajor"], out["vidx"]


@partial(jax.jit, static_argnames=("n_levels", "shadow", "max_iters", "block"))
def intersect_rays_brick(
    meta, root, lower, upper, ro, rd, *, n_levels: int, shadow: bool = False,
    max_iters: int = 100_000, block: int = 8192,
):
    root = jnp.uint32(root) if not hasattr(root, "dtype") else root
    return map_ray_blocks(
        lambda ro_b, rd_b: _traverse_block64(
            meta, root, n_levels, lower, upper, ro_b, rd_b,
            shadow=shadow, max_iters=max_iters,
        ),
        ro, rd, block,
    )


def intersect_bricktree(tree: BrickTree, ro, rd, shadow: bool = False,
                        block: int = 8192):
    ro = jnp.asarray(np.asarray(ro, np.float32))
    rd = jnp.asarray(np.asarray(rd, np.float32))
    return intersect_rays_brick(
        tree.meta, jnp.uint32(tree.root), tree.lower, tree.upper, ro, rd,
        n_levels=tree.n_levels, shadow=shadow, block=block,
    )
