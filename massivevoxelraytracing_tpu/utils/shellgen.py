"""Procedural terrain voxels in Morton-cube order, for reference-scale
builds (the 16k^3 / 654M-voxel axis, renderer_introduction.pdf p.8).

Emits the voxelization of a smooth analytic heightfield h(x, y) --
column-filled down to the lowest 4-neighbor top so the surface is
watertight from any view direction -- as a stream of sorted unique Morton
chunks. Chunks are Morton-aligned cubes of side `cube` visited in Morton
order of their cube coordinates: cube Mortons are the high bits of their
voxels' Mortons, so the concatenated stream is globally sorted and
brick-aligned, the input a streamed (chunk-at-a-time) tree build needs. Total voxel count
is available analytically (tile pass only) before any generation, so demos
can calibrate amplitude/frequency to a target occupancy without building.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import morton
from ..ops.bits import I32, U32
from ..ops.voxelize import pack_rgb8

INVALID = 0xFFFFFFFF


def _compact3(m: int) -> int:
    """Host: every 3rd bit of m (bit 0, 3, 6, ...) -> packed int."""
    out = 0
    b = 0
    while m:
        out |= (m & 1) << b
        m >>= 3
        b += 1
    return out


class Terrain:
    """Two-octave sine terrain on a grid_res^3 grid.

    h/R = base + a1 sin(2pi f1 x/R + p) sin(2pi f1 y/R + p')
               + a2 sin(2pi f2 x/R + q) cos(2pi f2 y/R + q')

    Mean column run ~= 1 + E[max 4-neighbor drop]; with the default knobs
    that is ~2-3 voxels, so total ~= (2..3) * grid_res^2. kmax caps the
    fill run (steeper columns truncate; the defaults stay under it)."""

    def __init__(self, grid_res: int, cube: int | None = None, *,
                 a1: float = 0.07, f1: float = 8.0,
                 a2: float = 0.015, f2: float = 27.0,
                 base: float = 0.5, kmax: int = 8, color: bool = False):
        if cube is None:
            cube = max(16, min(1024, grid_res // 4))
        assert grid_res % cube == 0 and cube % 16 == 0
        self.R = grid_res
        self.Q = cube
        self.nc = grid_res // cube
        self.kmax = kmax
        self.color = color
        self.params = (a1, f1, a2, f2, base)
        self._tile_cache: dict[tuple[int, int], tuple[int, int, int]] = {}

    def _height(self, x, y):
        a1, f1, a2, f2, base = self.params
        R = float(self.R)
        u = x / R
        v = y / R
        two_pi = 2.0 * np.pi
        h = (
            base
            + a1 * jnp.sin(two_pi * f1 * u + 0.7) * jnp.sin(two_pi * f1 * v + 1.3)
            + a2 * jnp.sin(two_pi * f2 * u + 2.1) * jnp.cos(two_pi * f2 * v + 0.4)
        )
        return h * R

    def _runs(self, x, y):
        """Per-column fill run [zbot, ztop] (i32), x/y f32 broadcastable."""
        ztop = jnp.floor(self._height(x, y)).astype(I32)
        ztop = jnp.clip(ztop, 0, self.R - 1)
        zn = ztop
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            n = jnp.floor(self._height(x + dx, y + dy)).astype(I32)
            zn = jnp.minimum(zn, jnp.clip(n, 0, self.R - 1))
        zbot = jnp.maximum(zn, ztop - (self.kmax - 1))
        return zbot, ztop

    @partial(jax.jit, static_argnums=0)
    def _tile_info(self, cx, cy):
        Q = self.Q
        x = (cx * Q + jnp.arange(Q, dtype=I32))[:, None].astype(jnp.float32)
        y = (cy * Q + jnp.arange(Q, dtype=I32))[None, :].astype(jnp.float32)
        zbot, ztop = self._runs(x, y)
        count = jnp.sum(ztop - zbot + 1)  # <= Q^2 * kmax << 2^31
        return jnp.stack([count, jnp.min(zbot), jnp.max(ztop)])

    def tile_info(self, cx: int, cy: int) -> tuple[int, int, int]:
        """(voxel count, zmin, zmax) of tile column (cx, cy); cached."""
        key = (cx, cy)
        if key not in self._tile_cache:
            c, zmin, zmax = np.asarray(
                self._tile_info(jnp.int32(cx), jnp.int32(cy))
            )
            self._tile_cache[key] = (int(c), int(zmin), int(zmax))
        return self._tile_cache[key]

    def total_voxels(self) -> int:
        return sum(
            self.tile_info(cx, cy)[0]
            for cx in range(self.nc) for cy in range(self.nc)
        )

    @partial(jax.jit, static_argnums=0)
    def _cube_chunk(self, cx, cy, cz):
        Q, kmax = self.Q, self.kmax
        x = (cx * Q + jnp.arange(Q, dtype=I32))[:, None].astype(jnp.float32)
        y = (cy * Q + jnp.arange(Q, dtype=I32))[None, :].astype(jnp.float32)
        zbot, ztop = self._runs(x, y)
        lo = jnp.maximum(zbot, cz * Q)
        hi = jnp.minimum(ztop, cz * Q + (Q - 1))
        xi = jnp.broadcast_to(x.astype(I32), (Q, Q))[:, :, None]
        yi = jnp.broadcast_to(y.astype(I32), (Q, Q))[:, :, None]
        z = lo[:, :, None] + jnp.arange(kmax, dtype=I32)[None, None, :]
        valid = z <= hi[:, :, None]
        m_hi, m_lo = morton.encode_magicbits(
            jnp.broadcast_to(xi, z.shape).astype(U32).reshape(-1),
            jnp.broadcast_to(yi, z.shape).astype(U32).reshape(-1),
            z.astype(U32).reshape(-1),
        )
        v = valid.reshape(-1)
        m_hi = jnp.where(v, m_hi, jnp.uint32(INVALID))
        m_lo = jnp.where(v, m_lo, jnp.uint32(INVALID))
        if not self.color:
            m_hi, m_lo = jax.lax.sort((m_hi, m_lo), num_keys=2)
            return m_hi, m_lo, jnp.sum(v.astype(I32))
        # altitude/steepness banded colormap, packed rgb8 riding the sort
        a1, f1, a2, f2, base = self.params
        amp = max(a1 + a2, 1e-6) * self.R
        rel = jnp.clip(
            (z.astype(jnp.float32) - (base * self.R - amp)) / (2.0 * amp),
            0.0, 1.0,
        ).reshape(-1)
        steep = jnp.broadcast_to(
            (ztop - zbot)[:, :, None] >= 4, z.shape
        ).reshape(-1)
        grass = jnp.array([0.23, 0.43, 0.16], jnp.float32)
        rock = jnp.array([0.43, 0.39, 0.36], jnp.float32)
        snow = jnp.array([0.92, 0.93, 0.96], jnp.float32)
        w_rock = jnp.clip((rel - 0.55) / 0.2, 0.0, 1.0)[:, None]
        w_snow = jnp.clip((rel - 0.88) / 0.06, 0.0, 1.0)[:, None]
        rgb = grass + (rock - grass) * w_rock
        rgb = jnp.where(steep[:, None], rock, rgb)
        rgb = rgb + (snow - rgb) * w_snow
        col = pack_rgb8(rgb[:, 0], rgb[:, 1], rgb[:, 2])
        m_hi, m_lo, col = jax.lax.sort((m_hi, m_lo, col), num_keys=2)
        return m_hi, m_lo, jnp.sum(v.astype(I32)), col

    def chunks(self):
        """Yield (m_hi, m_lo, n[, color]) per non-empty cube, in cube
        Morton order."""
        Q = self.Q
        for mc in range(self.nc ** 3):
            cx = _compact3(mc)
            cy = _compact3(mc >> 1)
            cz = _compact3(mc >> 2)
            _, zmin, zmax = self.tile_info(cx, cy)
            if cz * Q > zmax or (cz + 1) * Q <= zmin:
                continue
            yield self._cube_chunk(
                jnp.int32(cx), jnp.int32(cy), jnp.int32(cz)
            )
