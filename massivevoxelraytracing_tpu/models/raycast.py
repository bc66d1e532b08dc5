"""Primary-ray renderer (the `render` kernel + voxRTGPU app behavior,
voxKernel.cu:437-483): one ray per pixel, face-normal or voxel-color shading.

Rays stream through FIXED-SIZE packets: the traversal+shade graph compiles
once per (packet, tree-bucket) combination and is reused for any frame size,
so a new frame size costs no recompile (the analog of the reference
compiling its kernels once at startup, PathTracer.hpp:52-68)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import camera as camera_ops
from ..ops.voxelize import rgb8_to_f32
from . import accel as accel_lib

MAX_RAY_PACKET = 1 << 21  # up to 2M rays per render dispatch; render_rays adapts downward


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


@partial(jax.jit, static_argnames=("show_color",))
def _shade_flat(color_table, rd, t, nmaj, vidx, *, show_color: bool):
    from ..ops import traverse

    hit = t < 1e37
    if show_color:
        col = rgb8_to_f32(jnp.take(color_table, vidx.astype(jnp.int32), mode="clip"))
    else:
        hn = traverse.hit_normal(nmaj, rd)
        col = (hn + 1.0) * 0.5
    rgb = jnp.where(hit[:, None], col, 0.0)
    img = jnp.clip(rgb * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    return img, t


@partial(jax.jit, static_argnames=("kind", "depth", "show_color"))
def _render_packet(
    meta, root, lower, upper, color_table,
    ro, rd, *, kind: str, depth: int, show_color: bool,
):
    t, nmaj, vidx = accel_lib.intersect_with(
        kind, depth, meta, root, lower, upper, ro, rd
    )
    return _shade_flat(color_table, rd, t, nmaj, vidx, show_color=show_color)


def render_rays(tree, ro: np.ndarray, rd: np.ndarray,
                show_color: bool = False, packet: int | None = None):
    """Render arbitrary ray arrays in pow2-bucketed packets (one compile per
    bucket; padding rays start outside the root box and retire on iteration
    zero). Returns (u8[N, 3], f32[N])."""
    kind, depth, meta, root = accel_lib.accel_args(tree)
    color = tree.color if tree.color is not None else jnp.zeros(1, jnp.uint32)
    n = len(ro)
    if packet is None:
        packet = min(MAX_RAY_PACKET, max(_next_pow2(n), 8192))
    n_pad = -(-n // packet) * packet
    if n_pad != n:
        far = np.full((n_pad - n, 3), 1e9, np.float32)
        ro = np.concatenate([ro, far])
        rd = np.concatenate([rd, np.ones((n_pad - n, 3), np.float32)])
    imgs = []
    ts = []
    for k in range(n_pad // packet):
        sl = slice(k * packet, (k + 1) * packet)
        img, t = _render_packet(
            meta, root, tree.lower, tree.upper, color,
            jnp.asarray(ro[sl]), jnp.asarray(rd[sl]),
            kind=kind, depth=depth, show_color=show_color,
        )
        imgs.append(img)
        ts.append(t)
    img = jnp.concatenate(imgs)[:n]
    t = jnp.concatenate(ts)[:n]
    return img, t


def tile_order(width: int, height: int, tile_w: int = 128, tile_h: int = 128):
    """Pixel permutation putting rectangular tiles contiguous: traversal
    blocks get spatially coherent rays (similar depth complexity), cutting
    the lockstep iteration count (the role the reference's 256-pixel thread
    blocks play, voxKernel.cu:448)."""
    idx = np.arange(width * height)
    px = idx % width
    py = idx // width
    key = (
        (py // tile_h) * ((width + tile_w - 1) // tile_w) + (px // tile_w)
    ) * (tile_w * tile_h) + (py % tile_h) * tile_w + (px % tile_w)
    order = np.argsort(key, kind="stable")
    return order


_ORDER_CACHE: dict = {}


def _cached_order(width: int, height: int, packet: int):
    """Device-resident tile permutation, padded to the packet size with -1
    (padding lanes become rays parked at 1e9, inactive from iteration 0)."""
    key = (width, height, packet)
    if key not in _ORDER_CACHE:
        order = tile_order(width, height)
        inv = np.argsort(order)
        n = width * height
        n_pad = -(-n // packet) * packet
        order_pad = np.full(n_pad, -1, np.int32)
        order_pad[:n] = order
        _ORDER_CACHE[key] = (jnp.asarray(order_pad), jnp.asarray(inv))
    return _ORDER_CACHE[key]


TILE = 128  # pixel tile edge: traversal blocks get spatially coherent rays


@partial(jax.jit, static_argnames=("width", "height"))
def _gen_rays_tiled(
    cam_o, cam_right, cam_up, cam_front, tan_half_fovy,
    *, width: int, height: int,
):
    """Device-side ray generation from camera scalars (per-frame H2D = a few
    floats instead of a 48 MB ray upload), directly in 128x128-tile-major
    order (arithmetic on the lane index -- no order array), so the final
    un-permutation is a pure reshape/transpose instead of two 2M-row
    gathers."""
    return _gen_rays_band(
        cam_o, cam_right, cam_up, cam_front, tan_half_fovy,
        jnp.int32(0), width=width, height=height,
        band_tile_rows=-(-height // TILE),
    )


def _gen_rays_band(
    cam_o, cam_right, cam_up, cam_front, tan_half_fovy, py0,
    *, width: int, height: int, band_tile_rows: int,
):
    """Tile-major ray gen for a band of tile rows starting at pixel row py0
    (the per-device slice of the sharded render; py0=0 + full rows = the
    whole frame). Rays outside the real frame park at 1e9."""
    ntx = -(-width // TILE)
    nty = band_tile_rows
    w2 = ntx * TILE
    h2 = nty * TILE
    n_pad = w2 * h2
    lane = jnp.arange(n_pad, dtype=jnp.int32)
    ti = lane // (TILE * TILE)
    k = lane % (TILE * TILE)
    px = (ti % ntx) * TILE + (k % TILE)
    py = (ti // ntx) * TILE + (k // TILE) + py0
    live = (px < width) & (py < height)
    pxf = px.astype(jnp.float32)
    pyf = py.astype(jnp.float32)
    th = tan_half_fovy
    u = (-th + 2.0 * th * (pxf + 0.5) / width) * (width / height)
    v = th - 2.0 * th * (pyf + 0.5) / height
    rd = u[:, None] * cam_right + v[:, None] * cam_up + cam_front
    ro = jnp.where(live[:, None], cam_o[None, :], 1e9)
    return ro, rd


@partial(jax.jit, static_argnames=("width", "height", "show_color"))
def _shade_untile(
    color_table, rd, t, nmaj, vidx,
    *, width: int, height: int, show_color: bool,
):
    return _shade_untile_band(
        color_table, rd, t, nmaj, vidx, width=width,
        band_tile_rows=-(-height // TILE), rows_out=height,
        show_color=show_color,
    )


def _shade_untile_band(
    color_table, rd, t, nmaj, vidx,
    *, width: int, band_tile_rows: int, rows_out: int, show_color: bool,
):
    ntx = -(-width // TILE)
    nty = band_tile_rows
    img, t = _shade_flat(color_table, rd, t, nmaj, vidx,
                         show_color=show_color)

    def untile(x):
        c = x.shape[1:]
        y = x.reshape((nty, ntx, TILE, TILE) + c)
        y = jnp.transpose(y, (0, 2, 1, 3) + tuple(4 + i for i in range(len(c))))
        return y.reshape((nty * TILE, ntx * TILE) + c)[:rows_out, :width]

    return untile(img), untile(t)


@partial(jax.jit, static_argnames=("width", "height", "kind", "depth",
                                   "show_color"))
def _render_frame_device(
    meta, root, lower, upper, color_table,
    cam_o, cam_right, cam_up, cam_front, tan_half_fovy,
    *, width: int, height: int, kind: str, depth: int, show_color: bool,
):
    """Whole frame in one dispatch: device raygen, traversal, shading."""
    ro, rd = _gen_rays_tiled(
        cam_o, cam_right, cam_up, cam_front, tan_half_fovy,
        width=width, height=height,
    )
    t, nmaj, vidx = accel_lib.intersect_with(
        kind, depth, meta, root, lower, upper, ro, rd
    )
    return _shade_untile(
        color_table, rd, t, nmaj, vidx,
        width=width, height=height, show_color=show_color,
    )


def render_frame(tree, cam: camera_ops.Camera,
                 width: int, height: int, show_color: bool = False):
    """Returns DEVICE arrays (u8[H, W, 3] image, f32[H, W] depth); callers
    np.asarray() only what they need on the host."""
    kind, depth, meta, root = accel_lib.accel_args(tree)
    color = tree.color if tree.color is not None else jnp.zeros(1, jnp.uint32)
    cam_args = (
        jnp.asarray(cam.o), jnp.asarray(cam.right), jnp.asarray(cam.up),
        jnp.asarray(cam.front), jnp.float32(cam.tan_half_fovy),
    )
    return _render_frame_device(
        meta, root, tree.lower, tree.upper, color, *cam_args,
        width=width, height=height, kind=kind, depth=depth,
        show_color=show_color,
    )
