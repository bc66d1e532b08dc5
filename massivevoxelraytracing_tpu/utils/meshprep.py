"""Host-side triangle preparation for the dense candidate-grid voxelizer.

The device voxelizer evaluates a static cap^3 candidate grid per triangle
(ops/voxelize.py), so triangles whose voxel-space bbox exceeds the cap are
subdivided here by longest-edge bisection. Coverage is preserved: the
Schwarz-Seidel predicate is an exact triangle/box overlap test, so the union
of the parts' coverage equals the whole's. Duplicated voxels along the cut
are removed by the sort+unique pass (attribute means shift negligibly, the
same situation the reference already has for voxels shared by several
triangles, voxKernel.cu:194-223).
"""

from __future__ import annotations

import numpy as np

F = np.float32


def bbox_extent_in_voxels(verts: np.ndarray, origin, dps, grid_res: int):
    """Max per-axis voxel-index extent (inclusive count) of each triangle's
    clipped bbox. verts: [T, 3, 3]."""
    origin = np.asarray(origin, F)
    lo = verts.min(axis=1)
    hi = verts.max(axis=1)
    l = np.floor((lo - origin) / F(dps)).astype(np.int64)
    u = np.floor((hi - origin) / F(dps)).astype(np.int64)
    l = np.maximum(l, 0)
    u = np.minimum(u, grid_res - 1)
    ext = np.maximum(u - l + 1, 0)
    return ext.max(axis=1)


def split_to_cap(verts, colors, emissions, origin, dps, grid_res: int, cap: int):
    """Bisect triangles at their longest edge until every bbox fits cap^3.

    verts/colors/emissions: f32[T, 3, 3]. Returns the enlarged arrays.
    Vertex attributes at the new midpoint are linearly interpolated.
    """
    verts = np.asarray(verts, F).reshape(-1, 3, 3)
    colors = np.asarray(colors, F).reshape(-1, 3, 3)
    emissions = np.asarray(emissions, F).reshape(-1, 3, 3)

    from . import native

    out = native.split_to_cap(
        verts, colors, emissions, origin, dps, grid_res, cap
    )
    if out is not None:
        return out

    for _ in range(64):  # bounded: each pass halves the longest edge
        ext = bbox_extent_in_voxels(verts, origin, dps, grid_res)
        big = ext > cap
        if not big.any():
            break
        keep_v, keep_c, keep_e = verts[~big], colors[~big], emissions[~big]
        v = verts[big]
        c = colors[big]
        e = emissions[big]
        # longest edge: 0=(v0,v1), 1=(v1,v2), 2=(v2,v0)
        e01 = np.linalg.norm(v[:, 1] - v[:, 0], axis=1)
        e12 = np.linalg.norm(v[:, 2] - v[:, 1], axis=1)
        e20 = np.linalg.norm(v[:, 0] - v[:, 2], axis=1)
        which = np.argmax(np.stack([e01, e12, e20], axis=1), axis=1)

        a_idx = which  # edge (a, b) with a = which, b = (which+1)%3
        b_idx = (which + 1) % 3
        o_idx = (which + 2) % 3
        t = np.arange(len(v))
        va = v[t, a_idx]
        vb = v[t, b_idx]
        vo = v[t, o_idx]
        vm = (va + vb) * F(0.5)
        ca, cb, co = c[t, a_idx], c[t, b_idx], c[t, o_idx]
        cm = (ca + cb) * F(0.5)
        ea, eb, eo = e[t, a_idx], e[t, b_idx], e[t, o_idx]
        em = (ea + eb) * F(0.5)

        t1_v = np.stack([va, vm, vo], axis=1)
        t2_v = np.stack([vm, vb, vo], axis=1)
        t1_c = np.stack([ca, cm, co], axis=1)
        t2_c = np.stack([cm, cb, co], axis=1)
        t1_e = np.stack([ea, em, eo], axis=1)
        t2_e = np.stack([em, eb, eo], axis=1)

        verts = np.concatenate([keep_v, t1_v, t2_v])
        colors = np.concatenate([keep_c, t1_c, t2_c])
        emissions = np.concatenate([keep_e, t1_e, t2_e])
    return verts, colors, emissions


def pad_triangles(verts, colors, emissions, multiple: int):
    """Pad the triangle count to a multiple (degenerate zero triangles at the
    end voxelize to nothing) so jit shapes bucket nicely."""
    n = len(verts)
    m = (-n) % multiple
    if m == 0:
        return verts, colors, emissions
    z = np.zeros((m, 3, 3), F)
    return (
        np.concatenate([verts, z]),
        np.concatenate([colors, z]),
        np.concatenate([emissions, z]),
    )


def next_pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()
