"""Radiance .hdr (RGBE) IO + a procedural sky for asset-free testing.

Stands in for prlib's HDR loader (PathTracer::loadHDRI reads
monks_forest_s.hdr / monks_forest_2k_primary.hdr, RTCamp.cpp:123)."""

from __future__ import annotations

import numpy as np


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE -> f32 [H, W, 3]. Supports -Y +X scanline order with
    new-style RLE."""
    with open(path, "rb") as f:
        data = f.read()
    # header: lines until an empty line, then the resolution line
    p = 0
    while True:
        e = data.index(b"\n", p)
        if e == p:  # empty line ends the header
            break
        p = e + 1
    res_end = data.index(b"\n", e + 1)
    res_line = data[e + 1 : res_end].decode()
    toks = res_line.split()
    assert toks[0] == "-Y" and toks[2] == "+X", f"unsupported layout {res_line}"
    h, w = int(toks[1]), int(toks[3])

    from . import native

    fast = native.hdr_decode(data[res_end + 1 :], w, h)
    if fast is not None:
        return fast
    pix = np.frombuffer(data[res_end + 1 :], np.uint8)

    out = np.zeros((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        if (
            len(pix) - p >= 4
            and pix[p] == 2
            and pix[p + 1] == 2
            and (int(pix[p + 2]) << 8 | int(pix[p + 3])) == w
        ):
            p += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = int(pix[p])
                    p += 1
                    if cnt > 128:  # run
                        out[y, x : x + cnt - 128, c] = pix[p]
                        p += 1
                        x += cnt - 128
                    else:  # literal
                        out[y, x : x + cnt, c] = pix[p : p + cnt]
                        p += cnt
                        x += cnt
        else:  # flat scanline
            row = pix[p : p + 4 * w].reshape(w, 4)
            out[y] = row
            p += 4 * w
    rgbe = out.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e.astype(np.int32) - 136), 0.0)
    return (rgbe[..., :3] + 0.5) * scale[..., None] * (e > 0)[..., None]


def write_hdr(path: str, img: np.ndarray) -> None:
    """f32 [H, W, 3] -> flat (non-RLE) Radiance file."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    m = img.max(axis=2)
    e = np.zeros((h, w), np.int32)
    mant = np.zeros_like(img)
    nz = m > 1e-32
    e[nz] = np.frexp(m[nz])[1]
    scale = np.where(nz, np.ldexp(1.0, -e) * 256.0, 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def procedural_sky(width: int = 512, height: int = 256,
                   sun_dir=(0.5, 0.6, 0.3), sun_intensity: float = 200.0,
                   sun_radius: float = 0.02, ground=0.25) -> np.ndarray:
    """Gradient sky + bright sun disc: gives the importance sampler a sharp
    peak to find (like the reference's forest HDRIs have the sky/sun)."""
    sun = np.asarray(sun_dir, np.float64)
    sun /= np.linalg.norm(sun)
    y = (np.arange(height) + 0.5) / height
    x = (np.arange(width) + 0.5) / width
    theta = y * np.pi
    phi = x * 2 * np.pi - np.pi
    st = np.sin(theta)[:, None]
    dirs = np.stack(
        [np.cos(phi)[None, :] * st, np.cos(theta)[:, None] * np.ones((1, width)),
         np.sin(phi)[None, :] * st],
        axis=-1,
    )
    up = dirs[..., 1]
    sky = np.stack(
        [0.35 + 0.25 * up, 0.5 + 0.3 * up, 0.8 + 0.2 * up], axis=-1
    ).clip(0)
    grd = np.array([ground, ground * 0.9, ground * 0.7])
    img = np.where(up[..., None] > 0, sky, grd[None, None])
    cosang = (dirs * sun[None, None]).sum(-1)
    disc = cosang > np.cos(sun_radius)
    img = img + disc[..., None] * sun_intensity
    return img.astype(np.float32)


def gradient_sky(height: int = 64, width: int = 128) -> np.ndarray:
    """Smooth blue-white sky that dims with the polar angle and has no sun:
    the benchmark's environment (every NEE sample sees some light)."""
    ang = np.linspace(0, np.pi, height)[:, None]
    return np.stack([
        np.broadcast_to(0.6 + 0.4 * np.cos(ang), (height, width)),
        np.broadcast_to(0.7 + 0.3 * np.cos(ang), (height, width)),
        np.broadcast_to(0.9 + 0.1 * np.cos(ang), (height, width)),
    ], -1).astype(np.float32)
