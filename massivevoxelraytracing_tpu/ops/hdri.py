"""HDR environment map: equirect radiance + importance-sampling tables.

Reference (renderCommon.hpp:175-481 + voxKernel.cu:485-608): per-texel
importance = luminance x solid angle (optionally cosine-weighted toward one
of +-X/+-Y/+-Z), accumulated into an f64 2-D prefix table on the GPU
(buildSATh/buildSATv block scans) and normalized to u32. Seven tables total:
one unweighted + six axis-cosine-weighted, selected per shading point when
|N . axis| > 0.8. Sampling is a binary search of the column marginal then the
row conditional; PDF = pSelection / solidAngle. A separate hi-res "primary"
image serves camera-visible env lookups.

The table build is a host numpy f64 cumsum (it runs once per
HDRI load, not per frame -- the reference only GPU'd it because the data was
already there); sampling runs on device as vectorized binary searches over
the u32 tables (upper_bound_f, renderCommon.hpp:182-202).
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from .bits import I32, u32

AXES = np.array(
    [
        [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
    ],
    np.float32,
)


@dataclasses.dataclass
class HDRI:
    """Device-side environment state (HDRI struct equivalent). Registered as
    a pytree (arrays = leaves, dims/scale = static) so it can cross jit
    boundaries like the reference passes the whole struct as a kernel arg
    (PathTracer.hpp:158-167).

    Two sampling backends over identical texel distributions:
      sats        u32 2-D prefix tables + binary search (the reference's
                  exact scheme, ~22 dependent gathers per sample)
      alias_*     Walker alias tables (2 gathers per sample) -- the default
                  on this gather-rate-bound backend; same distribution.
    """

    pixels: jax.Array  # f32 [H, W, 3] secondary (sampling) image
    pixels_primary: jax.Array  # f32 [Hp, Wp, 3] camera-visible image
    sats: jax.Array  # u32 [7, H, W]: [0]=unweighted, [1..6]=axis tables
    alias_prob: jax.Array  # f32 [7, H*W]: acceptance probability
    alias_idx: jax.Array  # i32 [7, H*W]: alias target
    alias_pdf: jax.Array  # f32 [7, H*W]: texel selection probability
    width: int
    height: int
    width_primary: int
    height_primary: int
    scale: float = 1.75  # m_scale (renderCommon.hpp:480)
    use_alias: bool = True

    @property
    def enabled(self) -> bool:
        return self.scale > 0.0


jax.tree_util.register_dataclass(
    HDRI,
    data_fields=["pixels", "pixels_primary", "sats", "alias_prob",
                 "alias_idx", "alias_pdf"],
    meta_fields=["width", "height", "width_primary", "height_primary",
                 "scale", "use_alias"],
)


def _build_alias(weights: np.ndarray):
    """Walker alias method (O(n) construction). weights: f64 [N].
    Returns (prob f32, alias i32, pdf f32)."""
    n = len(weights)
    total = weights.sum()
    if total <= 0:
        weights = np.ones_like(weights)
        total = float(n)
    p = weights / total
    scaled = p * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias.astype(np.int32), p.astype(np.float32)


def _solid_angle_weights(width: int, height: int) -> np.ndarray:
    y = np.arange(height, dtype=np.float64)
    d_theta = np.pi / height
    d_phi = 2.0 * np.pi / width
    theta = y * d_theta
    # dH = cos(theta) - cos(theta+dTheta) = 2 sin(dT/2) sin(dT/2 + theta)
    dh = 2.0 * np.sin(d_theta * 0.5) * np.sin(d_theta * 0.5 + theta)
    return (dh * d_phi)[:, None]  # [H, 1]


def _texel_dirs(width: int, height: int) -> np.ndarray:
    """Center direction of each texel (HDRIstoreImportance cosWeighted path)."""
    y = np.arange(height, dtype=np.float64)
    x = np.arange(width, dtype=np.float64)
    d_theta = np.pi / height
    d_phi = 2.0 * np.pi / width
    theta = y * d_theta
    s_y = 0.5 * (np.cos(theta) + np.cos(theta + d_theta))  # mix(.., 0.5)
    phi = d_phi * (x + 0.5) + np.pi
    s_x = np.cos(phi)
    s_z = np.sin(phi)
    sin_theta = np.sqrt(np.maximum(1.0 - s_y**2, 0.0))
    dirs = np.zeros((height, width, 3))
    dirs[..., 0] = s_x[None, :] * sin_theta[:, None]
    dirs[..., 1] = s_y[:, None]
    dirs[..., 2] = s_z[None, :] * sin_theta[:, None]
    return dirs


def _build_sat_u32(importance: np.ndarray) -> np.ndarray:
    """Row-then-column inclusive 2-D prefix (buildSATh + buildSATv),
    normalized to u32 (buildSAT2u32)."""
    sat = np.cumsum(np.cumsum(importance, axis=1), axis=0)
    total = sat[-1, -1]
    if total <= 0:
        total = 1.0
    return (sat / total * float(0xFFFFFFFF)).astype(np.uint32)


def load(pixels: np.ndarray, pixels_primary: np.ndarray | None = None,
         scale: float = 1.75, use_alias: bool = True) -> HDRI:
    """Build the 7 sampling tables from an f32 [H, W, 3] radiance image."""
    pixels = np.asarray(pixels, np.float32)
    h, w = pixels.shape[:2]
    lum = (
        0.2126 * pixels[..., 0]
        + 0.7152 * pixels[..., 1]
        + 0.0722 * pixels[..., 2]
    ).astype(np.float64)
    sr = _solid_angle_weights(w, h)
    dirs = _texel_dirs(w, h)
    importances = [lum * sr]
    for axis in AXES:
        cosw = np.maximum((dirs * axis[None, None]).sum(-1), 0.0)
        importances.append(lum * sr * cosw)
    sats = [_build_sat_u32(imp) for imp in importances]
    probs, aliases, pdfs = zip(
        *[_build_alias(imp.reshape(-1)) for imp in importances]
    )
    if pixels_primary is None:
        pixels_primary = pixels
    pixels_primary = np.asarray(pixels_primary, np.float32)
    return HDRI(
        pixels=jnp.asarray(pixels[..., :3]),
        pixels_primary=jnp.asarray(pixels_primary[..., :3]),
        sats=jnp.asarray(np.stack(sats)),
        alias_prob=jnp.asarray(np.stack(probs)),
        alias_idx=jnp.asarray(np.stack(aliases)),
        alias_pdf=jnp.asarray(np.stack(pdfs)),
        width=w,
        height=h,
        width_primary=pixels_primary.shape[1],
        height_primary=pixels_primary.shape[0],
        scale=scale,
        use_alias=use_alias,
    )


def get_spherical(n):
    """Direction -> equirect uv, forward +x, up +y (renderCommon.hpp:175-180)."""
    phi = jnp.arctan2(n[..., 2], n[..., 0]) + jnp.pi
    theta = jnp.arctan2(
        jnp.sqrt(n[..., 0] ** 2 + n[..., 2] ** 2), n[..., 1]
    )
    return phi / (2.0 * jnp.pi), theta / jnp.pi


def sample_nearest(env: HDRI, direction, primary: bool):
    """Nearest-texel radiance lookup (HDRI::sampleNearest)."""
    w = env.width_primary if primary else env.width
    h = env.height_primary if primary else env.height
    img = env.pixels_primary if primary else env.pixels
    u, v = get_spherical(direction)
    x = jnp.clip(u * w, 0.0, w - 1.0).astype(I32)
    y = jnp.clip(v * h, 0.0, h - 1.0).astype(I32)
    c = img[y, x]
    return c * jnp.float32(env.scale)


def _upper_bound(f, n: int, b):
    """Vectorized upper_bound_f (renderCommon.hpp:182-202): smallest i with
    f(i) > b, probing f at traced indices."""
    steps = max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1)
    i = jnp.zeros_like(b, dtype=I32)
    j = jnp.full_like(i, n)

    def body(_, ij):
        i, j = ij
        cont = i < j
        m = (i + j) // 2
        le = f(m) <= b
        i2 = jnp.where(cont & le, m + 1, i)
        j2 = jnp.where(cont & ~le, m, j)
        return i2, j2

    i, j = jax.lax.fori_loop(0, steps, body, (i, j))
    return i


def select_table(env: HDRI, n, axis_aligned: bool):
    """Table index per shading normal (importanceSample's if-chain with
    k = 0.8, renderCommon.hpp:371-398). Returns i32[...] in [0, 6]."""
    if not axis_aligned:
        return jnp.zeros(n.shape[:-1], I32)
    k = 0.8
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    idx = jnp.zeros(nx.shape, I32)
    # reversed chain so the first true condition wins
    idx = jnp.where(nz < -k, 6, idx)
    idx = jnp.where(k < nz, 5, idx)
    idx = jnp.where(ny < -k, 4, idx)
    idx = jnp.where(k < ny, 3, idx)
    idx = jnp.where(nx < -k, 2, idx)
    idx = jnp.where(k < nx, 1, idx)
    return idx


def importance_sample(env: HDRI, n, u0, u1, u2, u3, axis_aligned: bool = True):
    """Returns (direction f32[R,3], L f32[R,3], sr_pdf f32[R]).

    Mirrors HDRI::importanceSample (renderCommon.hpp:367-435): binary-search
    the column marginal (bottom row of the SAT), then the row conditional
    within the column, then jitter inside the texel.
    """
    w, h = env.width, env.height
    table = select_table(env, n, axis_aligned)

    if env.use_alias:
        # Walker alias sampling: identical texel distribution, 3 gathers
        # (vs ~22 dependent binary-search probes)
        nt = w * h
        j = jnp.clip((u0 * nt).astype(I32), 0, nt - 1)
        lin = table * nt + j
        pa = jnp.take(env.alias_prob.reshape(-1), lin, mode="clip")
        ja = jnp.take(env.alias_idx.reshape(-1), lin, mode="clip")
        texel = jnp.where(u1 < pa, j, ja)
        p_sel = jnp.take(
            env.alias_pdf.reshape(-1), table * nt + texel, mode="clip"
        )
        X = texel % w
        Y = texel // w
        return _finish_sample(env, X, Y, p_sel, u2, u3)

    sats = env.sats.reshape(7, -1)  # [7, H*W]
    base = table  # row selector into sats

    # flat gather: value at [table_i, y_i, x_i]
    def gather(y, x):
        lin = base * (w * h) + y * w + x
        return jnp.take(sats.reshape(-1), lin, mode="clip")

    inv_max = jnp.float32(1.0 / float(0xFFFFFFFF))

    def ps_h(x):
        # prefix-sum-exclusive along columns: sat[H-1, x-1], 0 for x <= 0
        v = gather(jnp.full_like(x, h - 1), jnp.maximum(x - 1, 0))
        return jnp.where(x <= 0, u32(0), v)

    X = _upper_bound(lambda m: ps_h(m).astype(jnp.float32) * inv_max, w, u0) - 1
    X = jnp.clip(X, 0, w - 1)

    vol = ps_h(X + 1) - ps_h(X)
    vol_f = jnp.maximum(vol.astype(jnp.float32), 1.0)

    def ps_v(y):
        # within column X: sat[y-1, X] - sat[y-1, X-1], 0 for y <= 0
        ym = jnp.maximum(y - 1, 0)
        s1 = gather(ym, X)
        s0 = jnp.where(X <= 0, u32(0), gather(ym, jnp.maximum(X - 1, 0)))
        return jnp.where(y <= 0, u32(0), s1 - s0)

    Y = _upper_bound(lambda m: ps_v(m).astype(jnp.float32) / vol_f, h, u1) - 1
    Y = jnp.clip(Y, 0, h - 1)

    # 2x2 SAT corner difference = texel count (getCount)
    a = jnp.where((X <= 0) | (Y <= 0), u32(0),
                  gather(jnp.maximum(Y - 1, 0), jnp.maximum(X - 1, 0)))
    b_ = jnp.where(Y <= 0, u32(0), gather(jnp.maximum(Y - 1, 0), X))
    c_ = jnp.where(X <= 0, u32(0), gather(Y, jnp.maximum(X - 1, 0)))
    d_ = gather(Y, X)
    p_sel = ((d_ - b_) + (a - c_)).astype(jnp.float32) * inv_max

    return _finish_sample(env, X, Y, p_sel, u2, u3)


def _finish_sample(env: HDRI, X, Y, p_sel, u2, u3):
    """Texel -> jittered direction, radiance, solid-angle pdf
    (renderCommon.hpp:408-434)."""
    w, h = env.width, env.height
    d_theta = jnp.float32(np.pi / h)
    d_phi = jnp.float32(2.0 * np.pi / w)
    theta = Y.astype(jnp.float32) * d_theta
    dh = 2.0 * jnp.sin(d_theta * 0.5) * jnp.sin(d_theta * 0.5 + theta)
    sr = dh * d_phi

    s_y = jnp.cos(theta) * (1.0 - u2) + jnp.cos(theta + d_theta) * u2
    phi = d_phi * (X.astype(jnp.float32) + u3) + jnp.pi
    s_x = jnp.cos(phi)
    s_z = jnp.sin(phi)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - s_y * s_y, 0.0))
    direction = jnp.stack([s_x * sin_theta, s_y, s_z * sin_theta], axis=-1)
    sr_pdf = jnp.maximum(p_sel, 1e-20) / sr

    flat_img = env.pixels.reshape(-1, 3)
    L = jnp.take(flat_img, Y * w + X, axis=0, mode="clip") * jnp.float32(env.scale)
    return direction, L, sr_pdf
