"""Triangle voxelization as array ops (Schwarz-Seidel conservative / 6-separating).

Reference pipeline (voxKernel.cu:58-243): one GPU thread per triangle runs
nested x/y/z range loops with atomics for allocation. The design here
replaces the serial loops and atomics with a *dense candidate-grid predicate*:

  1. Host pre-pass subdivides triangles until each one's voxel bbox fits a
     static cap B per axis (utils/meshprep.py), keeping coverage identical
     (the Schwarz test is an exact triangle/box overlap test, so a partition
     of the triangle covers exactly the union of its parts).
  2. `voxelize_dense` evaluates the closed-form coverage predicate for all
     B^3 candidate cells of every triangle at once -- pure VPU element-wise
     math, no data-dependent control flow.
  3. `sort_and_unique` compacts: lexicographic sort on the (hi, lo) Morton
     pair (invalid candidates get an impossible all-ones key and sink to the
     end), then boundary-mask + segment-sum dedup with integer-mean colors,
     replacing the reference's radix sort + chained-scan ordered compaction
     (StreamCompaction.hpp) -- ordering is deterministic for free under XLA.

The coverage predicate is the same math as VTContext (voxelization.hpp:124-337)
in closed form: per-axis 2D edge functions with conservative/6-separating
offsets, a z plane-slab range, and the bbox clip. See models/cpu_oracle.py for
the loop-form cross-check.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .bits import F32, I32, U32, u32
from . import morton


def _c(x):
    return jnp.uint32(x)


# ---------------------------------------------------------------------------
# attribute packing
# ---------------------------------------------------------------------------

def pack_rgb8(r, g, b):
    """float [0,1] rgb -> packed u32 (r | g<<8 | b<<16 | 0xFF<<24),
    quantized like the reference's (uint8)(v * 255 + 0.5)."""
    q = lambda v: jnp.clip(v * 255.0 + 0.5, 0.0, 255.0).astype(U32)
    return q(r) | (q(g) << 8) | (q(b) << 16) | _c(0xFF000000)


def unpack_rgb8(p):
    p = u32(p)
    return p & _c(0xFF), (p >> 8) & _c(0xFF), (p >> 16) & _c(0xFF)


def rgb8_to_f32(p):
    """Packed u32 -> f32[..., 3] in [0, 1] (rawReflectance, renderCommon.hpp:160)."""
    r, g, b = unpack_rgb8(p)
    s = jnp.float32(1.0 / 255.0)
    return jnp.stack(
        [r.astype(F32) * s, g.astype(F32) * s, b.astype(F32) * s], axis=-1
    )


# ---------------------------------------------------------------------------
# per-triangle context (vectorized VTContext, voxelization.hpp:146-224)
# ---------------------------------------------------------------------------

def _proj(p, axis: int):
    """Static-axis projection: (p[a], p[(a+1)%3]); remainder is p[(a+2)%3].

    Matches project2plane / project2plane_reminder (voxelization.hpp:15-82):
    axis 0 -> (x, y | z), axis 1 -> (y, z | x), axis 2 -> (z, x | y).
    """
    return p[..., axis], p[..., (axis + 1) % 3], p[..., (axis + 2) % 3]


def triangle_contexts(v, six_separating: bool, origin, dps, grid_res: int):
    """v: f32[T, 3, 3] triangle vertices. Returns dict of per-triangle arrays."""
    v = jnp.asarray(v, F32)
    origin = jnp.asarray(origin, F32)
    dps = jnp.float32(dps)
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    e01 = v1 - v0
    e12 = v2 - v1
    n = jnp.cross(e01, e12)

    ax, ay, az = jnp.abs(n[:, 0]), jnp.abs(n[:, 1]), jnp.abs(n[:, 2])
    major = jnp.where(
        ax < ay, jnp.where(ay < az, 0, 2), jnp.where(ax < az, 0, 1)
    ).astype(I32)

    bb_lo = jnp.minimum(jnp.minimum(v0, v1), v2)
    bb_hi = jnp.maximum(jnp.maximum(v0, v1), v2)
    lower = jnp.floor((bb_lo - origin) / dps).astype(I32)
    upper = jnp.floor((bb_hi - origin) / dps).astype(I32)
    lower = jnp.maximum(lower, 0)
    upper = jnp.minimum(upper, grid_res - 1)

    # edge functions for every axis (static unroll over the 3 projections)
    edges = [[None] * 3 for _ in range(3)]  # [axis][edge] = (nex, ney, d)
    for axis in range(3):
        pu0, pv0, _ = _proj(v0, axis)
        pu1, pv1, _ = _proj(v1, axis)
        pu2, pv2, _ = _proj(v2, axis)
        rem = _proj(n, axis)[2]
        n_sign = jnp.where(0.0 < rem, jnp.float32(1.0), jnp.float32(-1.0))
        us = (pu0, pu1, pu2)
        vs = (pv0, pv1, pv2)
        for edge in range(3):
            au, av = us[edge], vs[edge]
            bu, bv = us[(edge + 1) % 3], vs[(edge + 1) % 3]
            nex = -(bv - av) * n_sign
            ney = (bu - au) * n_sign
            if not six_separating:
                d = (
                    jnp.maximum(nex * dps, 0.0)
                    + jnp.maximum(ney * dps, 0.0)
                    - (nex * au + ney * av)
                )
            else:
                d = (
                    nex * (dps * 0.5 - au)
                    + ney * (dps * 0.5 - av)
                    + 0.5 * dps * jnp.maximum(jnp.abs(nex), jnp.abs(ney))
                )
            edges[axis][edge] = (nex, ney, d)

    def sel3(a0, a1, a2):
        return jnp.where(major == 0, a0, jnp.where(major == 1, a1, a2))

    o = origin
    o_u = sel3(o[0], o[1], o[2]) * jnp.ones_like(n[:, 0])
    o_v = sel3(o[1], o[2], o[0]) * jnp.ones_like(n[:, 0])
    o_w = sel3(o[2], o[0], o[1]) * jnp.ones_like(n[:, 0])
    lo_u = sel3(lower[:, 0], lower[:, 1], lower[:, 2])
    lo_v = sel3(lower[:, 1], lower[:, 2], lower[:, 0])
    lo_w = sel3(lower[:, 2], lower[:, 0], lower[:, 1])
    up_u = sel3(upper[:, 0], upper[:, 1], upper[:, 2])
    up_v = sel3(upper[:, 1], upper[:, 2], upper[:, 0])
    up_w = sel3(upper[:, 2], upper[:, 0], upper[:, 1])

    n_u = sel3(n[:, 0], n[:, 1], n[:, 2])
    n_v = sel3(n[:, 1], n[:, 2], n[:, 0])
    n_w = sel3(n[:, 2], n[:, 0], n[:, 1])
    v0_u = sel3(v0[:, 0], v0[:, 1], v0[:, 2])
    v0_v = sel3(v0[:, 1], v0[:, 2], v0[:, 0])
    v0_w = sel3(v0[:, 2], v0[:, 0], v0[:, 1])
    kx = -n_u / n_w
    ky = -n_v / n_w
    K = -kx * v0_u - ky * v0_v + v0_w
    c_max = K + dps * (jnp.maximum(kx, 0.0) + jnp.maximum(ky, 0.0))
    c_min = K + dps * (jnp.minimum(kx, 0.0) + jnp.minimum(ky, 0.0))
    c_six = K + 0.5 * dps * (kx + ky)

    degenerate = (n[:, 0] == 0.0) & (n[:, 1] == 0.0) & (n[:, 2] == 0.0)
    empty = degenerate | jnp.any(upper < lower, axis=-1)

    # major-axis edge consts, selected per triangle
    edges_major = []
    for edge in range(3):
        nex = sel3(edges[0][edge][0], edges[1][edge][0], edges[2][edge][0])
        ney = sel3(edges[0][edge][1], edges[1][edge][1], edges[2][edge][1])
        dd = sel3(edges[0][edge][2], edges[1][edge][2], edges[2][edge][2])
        edges_major.append((nex, ney, dd))

    return dict(
        major=major,
        lo_u=lo_u, lo_v=lo_v, lo_w=lo_w,
        up_u=up_u, up_v=up_v, up_w=up_w,
        o_u=o_u, o_v=o_v, o_w=o_w,
        kx=kx, ky=ky, c_max=c_max, c_min=c_min, c_six=c_six,
        edges=edges, edges_major=edges_major,
        empty=empty, dps=dps,
        v0=v0, v1=v1, v2=v2,
    )


def coverage_mask(ctx, X, Y, Z, six_separating: bool):
    """Coverage predicate at projected integer coords X/Y/Z (i32[T, C]).

    X runs along the major axis, Y the next, Z the remainder -- the same
    variables the reference's loops iterate. Returns (ok bool[T, C],
    (r0, r1, r2) f32[T, C] real-space corner coords).
    """
    dps = ctx["dps"]
    e = lambda a: a[:, None]
    xc = e(ctx["o_u"]) + X.astype(F32) * dps
    yc = e(ctx["o_v"]) + Y.astype(F32) * dps
    zc = e(ctx["o_w"]) + Z.astype(F32) * dps

    ok = (
        (e(ctx["lo_u"]) <= X) & (X <= e(ctx["up_u"]))
        & (e(ctx["lo_v"]) <= Y) & (Y <= e(ctx["up_v"]))
        & (e(ctx["lo_w"]) <= Z) & (Z <= e(ctx["up_w"]))
        & ~e(ctx["empty"])
    )

    # major-axis edge functions (== yRangeInclusive, voxelization.hpp:230-269)
    for nex, ney, d in ctx["edges_major"]:
        ok &= e(nex) * xc + e(ney) * yc + e(d) >= 0.0

    # z slab (zRangeInclusive, voxelization.hpp:270-299)
    var = e(ctx["kx"]) * xc + e(ctx["ky"]) * yc
    if six_separating:
        indexf = (var + e(ctx["c_six"]) - e(ctx["o_w"])) / dps
        zf = jnp.floor(indexf)
        zmax = zf.astype(I32)
        zmin = jnp.where(indexf == zf, zmax - 1, zmax)
    else:
        zmin = jnp.floor((var + e(ctx["c_min"]) - e(ctx["o_w"])) / dps).astype(I32)
        zmax = jnp.floor((var + e(ctx["c_max"]) - e(ctx["o_w"])) / dps).astype(I32)
    zmin = jnp.maximum(zmin, e(ctx["lo_w"]))
    zmax = jnp.minimum(zmax, e(ctx["up_w"]))
    ok &= (zmin <= Z) & (Z <= zmax)

    # real-space corner point of the candidate cell
    major = ctx["major"][:, None]
    r0 = jnp.where(major == 0, xc, jnp.where(major == 1, zc, yc))
    r1 = jnp.where(major == 0, yc, jnp.where(major == 1, xc, zc))
    r2 = jnp.where(major == 0, zc, jnp.where(major == 1, yc, xc))

    # intersect(p): the two non-major axes' edge tests, skipped when the bbox
    # is flat along the remainder axis (voxelization.hpp:311-336)
    flat = e(ctx["lo_w"] == ctx["up_w"])
    rr = (r0, r1, r2)
    for axis in range(3):
        pu = rr[axis]
        pv = rr[(axis + 1) % 3]
        ax_ok = jnp.ones_like(ok)
        for edge in range(3):
            nex, ney, d = ctx["edges"][axis][edge]
            ax_ok &= e(nex) * pu + e(ney) * pv + e(d) >= 0.0
        ok &= ax_ok | flat | (major == axis)

    return ok, rr


def closest_barycentric(v0, v1, v2, p):
    """Clamped barycentric coords of the closest point on the triangle
    (vectorMath.hpp:249-284), vectorized over leading dims."""
    d0 = v0 - p
    d1 = v1 - p
    d2 = v2 - p
    e0 = v2 - v0
    e1 = v0 - v1
    e2 = v1 - v2
    ng = jnp.cross(e2, e0)
    dot = lambda a, b: jnp.sum(a * b, axis=-1)
    U = dot(jnp.cross(d2, d0), ng)
    V = dot(jnp.cross(d0, d1), ng)
    W = dot(jnp.cross(d1, d2), ng)
    # branch ladder as nested selects (first true branch wins, like the
    # reference's if/else-if chain)
    u_neg = U < 0.0
    v_neg = ~u_neg & (V < 0.0)
    w_neg = ~u_neg & ~v_neg & (W < 0.0)
    V = jnp.where(u_neg, dot(-d0, e0), jnp.where(v_neg, V, jnp.where(w_neg, dot(d1, e2), V)))
    W = jnp.where(u_neg, dot(d2, e0), jnp.where(v_neg, dot(-d1, e1), W))
    U = jnp.where(v_neg, dot(d0, e1), jnp.where(w_neg, dot(-d2, e2), U))
    bc = jnp.maximum(jnp.stack([U, V, W], axis=-1), 0.0)
    return bc / jnp.sum(bc, axis=-1, keepdims=True)


@partial(jax.jit, static_argnames=("six_separating", "grid_res", "cap"))
def voxelize_dense(
    tri_verts,
    tri_colors,
    tri_emissions,
    origin,
    dps,
    *,
    grid_res: int,
    six_separating: bool = True,
    cap: int = 4,
):
    """Emit candidate voxels for T triangles whose voxel bbox fits cap^3.

    Args: tri_verts/colors/emissions f32[T, 3, 3]; origin f32[3]; dps scalar.
    Returns dict with flattened [T*cap^3] arrays: valid bool, m_hi/m_lo u32
    Morton pair, color/emission packed u32. (Equivalent of the voxelize
    kernel, voxKernel.cu:91-166; allocation sizing comes from summing
    `valid` instead of atomicAdd.)
    """
    ctx = triangle_contexts(tri_verts, six_separating, origin, dps, grid_res)
    T = tri_verts.shape[0]
    C = cap * cap * cap

    # candidate offsets in projected space
    off = jnp.arange(cap, dtype=I32)
    OX, OY, OZ = jnp.meshgrid(off, off, off, indexing="ij")
    OX = OX.reshape(1, C)
    OY = OY.reshape(1, C)
    OZ = OZ.reshape(1, C)
    X = ctx["lo_u"][:, None] + OX
    Y = ctx["lo_v"][:, None] + OY
    Z = ctx["lo_w"][:, None] + OZ

    ok, (r0, r1, r2) = coverage_mask(ctx, X, Y, Z, six_separating)

    # integer grid coords (unproject)
    major = ctx["major"][:, None]
    i0 = jnp.where(major == 0, X, jnp.where(major == 1, Z, Y))
    i1 = jnp.where(major == 0, Y, jnp.where(major == 1, X, Z))
    i2 = jnp.where(major == 0, Z, jnp.where(major == 1, Y, X))
    m_hi, m_lo = morton.encode(
        i0.astype(U32) & _c(0x1FFFFF),
        i1.astype(U32) & _c(0x1FFFFF),
        i2.astype(U32) & _c(0x1FFFFF),
    )

    # attributes at the closest barycentric point of the cell corner
    p = jnp.stack([r0, r1, r2], axis=-1)  # [T, C, 3]
    v0 = ctx["v0"][:, None, :]
    v1 = ctx["v1"][:, None, :]
    v2 = ctx["v2"][:, None, :]
    bc = closest_barycentric(v0, v1, v2, p)  # [T, C, 3]
    c0, c1, c2 = tri_colors[:, 0], tri_colors[:, 1], tri_colors[:, 2]
    e0, e1, e2 = tri_emissions[:, 0], tri_emissions[:, 1], tri_emissions[:, 2]
    # NOTE the reference's rotation: color = bc.x*c1 + bc.y*c2 + bc.z*c0
    # (voxKernel.cu:147-149)
    col = (
        bc[..., 0:1] * c1[:, None, :]
        + bc[..., 1:2] * c2[:, None, :]
        + bc[..., 2:3] * c0[:, None, :]
    )
    emi = (
        bc[..., 0:1] * e1[:, None, :]
        + bc[..., 1:2] * e2[:, None, :]
        + bc[..., 2:3] * e0[:, None, :]
    )
    col_p = pack_rgb8(col[..., 0], col[..., 1], col[..., 2])
    emi_p = pack_rgb8(emi[..., 0], emi[..., 1], emi[..., 2])

    return dict(
        valid=ok.reshape(-1),
        m_hi=m_hi.reshape(-1),
        m_lo=m_lo.reshape(-1),
        color=col_p.reshape(-1),
        emission=emi_p.reshape(-1),
    )


@jax.jit
def count_voxels(cands):
    """Total dumped voxels (the voxCount pass, voxKernel.cu:58-90)."""
    return jnp.sum(cands["valid"].astype(jnp.int32))


@jax.jit
def sort_and_unique_sums(m_hi, m_lo, color, emission, valid):
    """Group stage of the HIERARCHICAL unique used at production scale
    (>= ~50M dumped voxels, where one global 4-operand sort of the whole
    stream plus XLA's sort temp exceeds HBM): sort one group's candidates
    and reduce duplicates to per-voxel CHANNEL SUMS + COUNT, so groups can
    later be merged with exact true-duplicate means (sum of sums / sum of
    counts) -- bitwise the same attributes the single-pass path computes."""
    key_hi = jnp.where(valid, m_hi, _c(0xFFFFFFFF))
    key_lo = jnp.where(valid, m_lo, _c(0xFFFFFFFF))
    s_hi, s_lo, s_col, s_emi = jax.lax.sort(
        (key_hi, key_lo, color, emission), num_keys=2
    )
    n = s_hi.shape[0]
    s_valid = s_hi != _c(0xFFFFFFFF)
    prev_ne = jnp.concatenate(
        [
            jnp.ones((1,), bool),
            (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1]),
        ]
    )
    boundary = s_valid & prev_ne
    seg = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    n_unique = jnp.sum(boundary.astype(jnp.int32))
    seg = jnp.where(s_valid, seg, n)

    def ch_sums(packed):
        r, g, b = unpack_rgb8(packed)
        return [
            jax.ops.segment_sum(
                ch.astype(jnp.uint32), seg, num_segments=n + 1
            )[:-1]
            for ch in (r, g, b)
        ]

    sums = ch_sums(s_col) + ch_sums(s_emi)
    count = jax.ops.segment_sum(
        s_valid.astype(jnp.uint32), seg, num_segments=n + 1
    )[:-1]
    first_idx = jnp.minimum(
        jax.ops.segment_min(
            jnp.arange(n, dtype=jnp.int32), seg, num_segments=n + 1
        )[:-1],
        n - 1,
    )
    live = jnp.arange(n) < n_unique
    out = [
        jnp.where(live, jnp.take(s_hi, first_idx), _c(0xFFFFFFFF)),
        jnp.where(live, jnp.take(s_lo, first_idx), _c(0xFFFFFFFF)),
    ] + [jnp.where(live, s, _c(0)) for s in sums] + [
        jnp.where(live, count, _c(0))
    ]
    return out, n_unique


@jax.jit
def merge_unique_sums(hi, lo, sums6, count):
    """Merge stage: concatenated per-group (key, sums, count) rows ->
    final unique voxels with true-duplicate-mean attributes."""
    ops = jax.lax.sort(tuple([hi, lo] + sums6 + [count]), num_keys=2)
    s_hi, s_lo = ops[0], ops[1]
    s_sums = ops[2:8]
    s_count = ops[8]
    n = s_hi.shape[0]
    s_valid = s_hi != _c(0xFFFFFFFF)
    prev_ne = jnp.concatenate(
        [
            jnp.ones((1,), bool),
            (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1]),
        ]
    )
    boundary = s_valid & prev_ne
    seg = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    n_unique = jnp.sum(boundary.astype(jnp.int32))
    seg = jnp.where(s_valid, seg, n)
    tot = [
        jax.ops.segment_sum(s, seg, num_segments=n + 1)[:-1] for s in s_sums
    ]
    cnt = jax.ops.segment_sum(s_count, seg, num_segments=n + 1)[:-1]
    cnt = jnp.maximum(cnt, 1)

    def pack3(chs):
        means = [(s // cnt).astype(U32) for s in chs]
        return means[0] | (means[1] << 8) | (means[2] << 16) | _c(0xFF000000)

    mean_col = pack3(tot[0:3])
    mean_emi = pack3(tot[3:6])
    first_idx = jnp.minimum(
        jax.ops.segment_min(
            jnp.arange(n, dtype=jnp.int32), seg, num_segments=n + 1
        )[:-1],
        n - 1,
    )
    live = jnp.arange(n) < n_unique
    has_emission = jnp.any(live & ((mean_emi & _c(0x00FFFFFF)) != 0))
    return dict(
        m_hi=jnp.where(live, jnp.take(s_hi, first_idx), _c(0xFFFFFFFF)),
        m_lo=jnp.where(live, jnp.take(s_lo, first_idx), _c(0xFFFFFFFF)),
        color=jnp.where(live, mean_col, _c(0)),
        emission=jnp.where(live, mean_emi, _c(0)),
        n_unique=n_unique,
        has_emission=has_emission,
    )


def sort_and_unique(cands):
    """Sort candidates by Morton and deduplicate with integer-mean attributes.

    Replaces radix sort (tinyhipradixsort) + the `unique` ordered-compaction
    kernel (voxKernel.cu:170-243). Invalid candidates get the impossible key
    (0xFFFFFFFF, 0xFFFFFFFF) -- real codes are < 2^63 -- and sink to the end.

    Returns dict: m_hi/m_lo/color/emission arrays of the same padded length
    (valid prefix = n_unique), n_unique i32, has_emission bool.
    """
    valid = cands["valid"]
    key_hi = jnp.where(valid, cands["m_hi"], _c(0xFFFFFFFF))
    key_lo = jnp.where(valid, cands["m_lo"], _c(0xFFFFFFFF))
    s_hi, s_lo, s_col, s_emi = jax.lax.sort(
        (key_hi, key_lo, cands["color"], cands["emission"]), num_keys=2
    )
    n = s_hi.shape[0]
    s_valid = s_hi != _c(0xFFFFFFFF)

    prev_ne = jnp.concatenate(
        [
            jnp.ones((1,), bool),
            (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1]),
        ]
    )
    boundary = s_valid & prev_ne
    seg = jnp.cumsum(boundary.astype(jnp.int32)) - 1  # -1 for invalid prefix-less
    n_unique = jnp.sum(boundary.astype(jnp.int32))
    seg = jnp.where(s_valid, seg, n)  # park invalid rows in a dump segment

    ones = s_valid.astype(jnp.int32)
    counts = jax.ops.segment_sum(ones, seg, num_segments=n + 1)[:-1]

    def mean_channels(packed):
        r, g, b = unpack_rgb8(packed)
        sums = [
            jax.ops.segment_sum(ch.astype(jnp.int32), seg, num_segments=n + 1)[:-1]
            for ch in (r, g, b)
        ]
        cnt = jnp.maximum(counts, 1)
        means = [s // cnt for s in sums]
        return (
            means[0].astype(U32)
            | (means[1].astype(U32) << 8)
            | (means[2].astype(U32) << 16)
            | _c(0xFF000000)
        )

    mean_col = mean_channels(s_col)
    mean_emi = mean_channels(s_emi)

    first_idx = jax.ops.segment_min(
        jnp.arange(n, dtype=jnp.int32), seg, num_segments=n + 1
    )[:-1]
    first_idx = jnp.minimum(first_idx, n - 1)
    out_hi = jnp.take(s_hi, first_idx)
    out_lo = jnp.take(s_lo, first_idx)

    seg_valid = jnp.arange(n) < n_unique
    has_emission = jnp.any(seg_valid & ((mean_emi & _c(0x00FFFFFF)) != 0))

    return dict(
        m_hi=jnp.where(seg_valid, out_hi, _c(0xFFFFFFFF)),
        m_lo=jnp.where(seg_valid, out_lo, _c(0xFFFFFFFF)),
        color=jnp.where(seg_valid, mean_col, _c(0)),
        emission=jnp.where(seg_valid, mean_emi, _c(0)),
        n_unique=n_unique,
        has_emission=has_emission,
    )
