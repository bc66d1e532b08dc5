"""Progressive diffuse path tracer -- the renderPT megakernel + PathTracer
facade (voxKernel.cu:610-777, PathTracer.hpp:14-170).

Light transport per sample (matching the reference exactly):
  thin-lens primary ray -> miss: primary-HDRI lookup; hit: voxel emission.
  Then up to 8 diffuse bounces; per bounce:
    NEE: one shadow ray toward an HDRI importance sample drawn from the
      axis-aligned cosine-weighted table of the hit normal; contribution
      T * (R/pi) * cos * E / pdf on visibility. No MIS; emissive voxels get
      no shadow rays (deliberate, reference seminar slide 67).
    EXTRA_IMPLICIT_SAMPLING: at depth 0 only, when the scene has emissive
      voxels, one extra cosine-sampled ray picks up emission, averaged
      1/(1+n) with the BSDF ray's depth-0 emission pickup.
    BSDF ray: cosine hemisphere; emission picked up on hit (T *= R first).
  PMJ(0,2) sample dims consumed in a fixed order per (pixel, spp) stream.

Array form: the whole sample is a fixed 8-bounce loop over ray arrays
with active masks (the reference megakernel's loop), each traversal a
lockstep packet walk. The spp batch is the leading loop on the host
(nBatchSpp=16 per step, PathTracer.hpp:150-159). Accumulation: f32 (r, g, b, n) per pixel; resolve
divides by n and applies gamma 1/2.2 (renderResolve, voxKernel.cu:779-795).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import camera as camera_ops
from ..ops import hdri as hdri_ops
from ..ops import rng as rng_ops
from ..ops import sampling, traverse
from . import accel as accel_lib
from ..ops.bits import I32, U32, u32
from ..ops.hashing import hash_combine
from ..ops.octree import VoxelOctree
from ..ops.voxelize import rgb8_to_f32

MAX_BOUNCES = 8
N_BATCH_SPP = 16  # nBatchSpp (voxKernel.cu:631)
RAY_PACKET = 1 << 21  # max (pixel x spp) rays per pt_sample dispatch
COMPACT_MIN_LANES = 1 << 14  # inter-bounce compaction pays off above this


def _sample2d(table, spp, dim, stream):
    return sampling.pmj_sample2d(table, spp, u32(dim), stream)


def _ckpt_path(path: str) -> str:
    """np.savez silently appends .npz; normalize so save/load agree."""
    return path if path.endswith(".npz") else path + ".npz"


@partial(
    jax.jit,
    static_argnames=(
        "width", "pix_packet", "n_spp",
        "accel_kind", "stack_depth", "has_emission", "hdri_enabled",
        "extra_implicit", "max_bounces", "use_pmj", "use_compact",
        "spp_major",
    ),
)
def pt_sample(
    meta,
    root_entry,
    lower,
    upper,
    color_table,
    emission_table,
    pmj_table,
    env: hdri_ops.HDRI,
    cam_o,
    cam_right,
    cam_up,
    cam_front,
    tan_half_fovy,
    lens_r,
    focus,
    pix_start,
    spp_base,
    inv_w,
    inv_h,
    aspect,
    emission_scale,
    pix_perm=None,
    *,
    width: int,
    pix_packet: int,
    n_spp: int,
    accel_kind: str = "octree",
    stack_depth: int,
    has_emission: bool,
    hdri_enabled: bool,
    extra_implicit: bool,
    max_bounces: int = MAX_BOUNCES,
    use_pmj: bool = True,
    use_compact: bool = True,
    spp_major: bool = False,
):
    """Path-traced samples for (pixel, spp) lanes generated ON DEVICE from
    two scalars (pix_start, spp_base): lane r = s * pix_packet + p covers
    pixel pix_start + p at sample spp_base + s -- the whole n_spp batch of a
    pixel packet rides one wavefront so every traversal dispatch is
    amortized over the full batch (the reference's 256-pixel x 16-spp task
    striping, voxKernel.cu:631-642). Host->device traffic per call is a few
    scalars. Returns f32[R, 3] with R = pix_packet * n_spp.
    """
    R = pix_packet * n_spp
    lane = jnp.arange(R, dtype=jnp.uint32)
    # pix_perm (optional) maps packet-linear lane position -> pixel index
    # in 32x32 TILE order (PathTracer._pixel_perm): a 1024-lane traversal
    # block becomes a square screen tile instead of a ~2-row scanline
    # strip, so primary (and first-bounce) packets touch far fewer
    # distinct bricks per block and the lockstep walk's slowest lane is
    # closer to its average. Pure per-lane relabeling: each pixel's
    # PMJ stream, spp sequence, and radiance are unchanged, so the
    # resolved image is bit-identical (the caller un-permutes with the
    # inverse). Entries >= width*height are padding: their rows render
    # harmlessly and are dropped by the caller.
    # spp_major: lane r = p * n_spp + s -- a 1024-lane traversal block
    # holds 1024/n_spp CONSECUTIVE pixels x the full spp batch, so all of
    # a pixel's samples (near-identical primary rays, same-origin bounce
    # rays) share one traversal block. The default layout
    # (r = s * pix_packet + p) spreads a pixel's spp across n_spp distinct
    # blocks. Pure relabeling either way: each (pixel, spp) lane computes
    # the same radiance, and the caller's spp-sum runs in the same s order
    # -- resolved images are bit-identical.
    if spp_major:
        pix_off = lane // jnp.uint32(n_spp)
        spp_off = lane % jnp.uint32(n_spp)
    else:
        pix_off = lane % jnp.uint32(pix_packet)
        spp_off = lane // jnp.uint32(pix_packet)
    pix_idx = u32(pix_start) + pix_off
    if pix_perm is not None:
        pix_idx = jnp.take(pix_perm, pix_idx, mode="clip")
    px = pix_idx % jnp.uint32(width)
    py = pix_idx // jnp.uint32(width)  # rows past the frame render harmlessly
    # and their radiance is sliced away by the caller
    # MurmurHash32(0).combine(pixelIdx) (voxKernel.cu:648-653)
    stream = hash_combine(jnp.uint32(0), pix_idx)
    spp = u32(spp_base) + spp_off

    # Sample dims are consumed in the reference's fixed order: camera (0),
    # lens (1), then per bounce the NEE pair (2 dims, with an HDRI), the
    # depth-0 extra implicit ray (1 dim, emissive scenes only) and the BSDF
    # ray (1 dim). draw() returns the rng state it was given, advanced.
    if use_pmj:
        def draw(rng, dim, spp, stream):
            return rng, _sample2d(pmj_table, spp, dim, stream)
        rng0 = ()
    else:
        # USE_PMJ=0 fallback: a per-(pixel, spp) PCG32 stream
        # (renderCommon.hpp:86-117, voxKernel.cu:656-659); dims are implicit
        # in the order of the draws
        from ..ops.bits import uniformf

        def draw(rng, dim, spp, stream):
            state, inc = rng
            state, a = rng_ops.pcg32_next(state, inc)
            state, b = rng_ops.pcg32_next(state, inc)
            return (state, inc), (uniformf(a), uniformf(b))
        rng0 = rng_ops.pcg32_init(hash_combine(stream, spp), stream)

    def intersect(ro, rd, shadow):
        return accel_lib.intersect_with(
            accel_kind, stack_depth, meta, root_entry, lower, upper, ro, rd,
            shadow=shadow,
        )

    # --- thin-lens primary (voxKernel.cu:662-667)
    rng, (cu0, cu1) = draw(rng0, 0, spp, stream)
    rng, (lu0, lu1) = draw(rng, 1, spp, stream)
    xf = (px.astype(jnp.float32) + cu0) * inv_w
    yf = (py.astype(jnp.float32) + cu1) * inv_h
    fx = focus * (-tan_half_fovy + 2.0 * tan_half_fovy * xf) * aspect
    fy = focus * (tan_half_fovy - 2.0 * tan_half_fovy * yf)
    lx = -lens_r + 2.0 * lens_r * lu0
    ly = -lens_r + 2.0 * lens_r * lu1
    rd = (
        (fx - lx)[:, None] * cam_right
        + (fy - ly)[:, None] * cam_up
        + focus * cam_front
    )
    ro = cam_o + lx[:, None] * cam_right + ly[:, None] * cam_up

    T = jnp.ones((R, 3), jnp.float32)
    L = jnp.zeros((R, 3), jnp.float32)

    t, nmaj, vidx = intersect(ro, rd, False)

    # --- primary emissions (voxKernel.cu:677-689)
    miss = t >= 1e37
    if hdri_enabled:
        env_col = hdri_ops.sample_nearest(env, rd, primary=True)
        L = jnp.where(miss[:, None], env_col, L)
    le = rgb8_to_f32(jnp.take(emission_table, vidx.astype(jnp.int32), mode="clip"))
    L = jnp.where(miss[:, None], L, le)  # Le raw, unscaled on primary hit

    n_extra = 1 if (extra_implicit and has_emission) else 0
    dims_per_bounce = (2 if hdri_enabled else 0) + 1

    # --- inter-bounce compaction (SURVEY.md section 7.7: "sort/partition
    # rays by aliveness -- StreamCompaction's role reappears here", plus the
    # octant re-sorting of section 2.8): lockstep traversal blocks pay for
    # their slowest lane, so from bounce 1 on, lanes are permuted so that
    # dead lanes pool into blocks that retire in one probe round and alive
    # lanes group by direction octant for coherent walks. Pure permutation:
    # every per-lane quantity (PMJ stream/spp, throughput, radiance) rides
    # along, so the result is bit-identical to the unpermuted loop; one
    # sort at the end restores original lane order.
    # use_compact arrives resolved from PathTracer.step (auto: on above
    # COMPACT_MIN_LANES); compaction is a pure permutation, so on/off is
    # bit-identical -- the static arg exists for on-chip A/B timing
    compact = use_compact and use_pmj and R >= COMPACT_MIN_LANES
    orig = jnp.arange(R, dtype=jnp.uint32)

    def _bits(x):
        return jax.lax.bitcast_convert_type(x, jnp.uint32)

    def _f32(x):
        return jax.lax.bitcast_convert_type(x, jnp.float32)

    def bounce(depth, st, first: bool):
        """One diffuse bounce. `first` (static) marks depth 0, the only
        bounce with the extra implicit ray and without compaction; the
        later bounces run as one lax.fori_loop body, so the compiled
        program holds the traversal loops of two bounces, not eight."""
        ro, rd, T, L, t, nmaj, vidx, stream, spp, orig, rng = st
        miss = t >= 1e37
        alive = ~miss
        if compact and not first:
            octant = (
                (rd[:, 0] < 0).astype(jnp.uint32)
                + 2 * (rd[:, 1] < 0).astype(jnp.uint32)
                + 4 * (rd[:, 2] < 0).astype(jnp.uint32)
            )
            key = jnp.where(alive, octant, jnp.uint32(8))
            # ONE stable multi-operand sort carries every per-lane quantity
            # with the key (in place of a key sort plus an [R, 18] row
            # gather). Second key: the hit-voxel rank, MONOTONE in Morton
            # order -- lanes bouncing off nearby voxels pack into the same
            # traversal blocks, so each block touches few distinct bricks.
            # Pure permutation either way: radiance is bit-identical.
            (_, vidx, stream, spp, orig, nmaj1, tb,
             rox, roy, roz, rdx, rdy, rdz,
             tx, ty, tz, lx, ly, lz) = jax.lax.sort(
                (key, vidx, stream, spp, orig, u32(nmaj + 1),
                 _bits(t),
                 _bits(ro[:, 0]), _bits(ro[:, 1]), _bits(ro[:, 2]),
                 _bits(rd[:, 0]), _bits(rd[:, 1]), _bits(rd[:, 2]),
                 _bits(T[:, 0]), _bits(T[:, 1]), _bits(T[:, 2]),
                 _bits(L[:, 0]), _bits(L[:, 1]), _bits(L[:, 2])),
                num_keys=2,
            )
            nmaj = nmaj1.astype(I32) - 1
            t = _f32(tb)
            ro = jnp.stack([_f32(rox), _f32(roy), _f32(roz)], axis=1)
            rd = jnp.stack([_f32(rdx), _f32(rdy), _f32(rdz)], axis=1)
            T = jnp.stack([_f32(tx), _f32(ty), _f32(tz)], axis=1)
            L = jnp.stack([_f32(lx), _f32(ly), _f32(lz)], axis=1)
            miss = t >= 1e37
            alive = ~miss
        refl = rgb8_to_f32(
            jnp.take(color_table, vidx.astype(jnp.int32), mode="clip")
        )
        hit_n = traverse.hit_normal(nmaj, rd)
        # dead lanes park far outside the root box: their NEE / implicit /
        # BSDF traversals all retire on iteration 0
        hit_p = jnp.where(
            alive[:, None], ro + rd * jnp.where(miss, 0.0, t)[:, None], 1e9
        )

        # Draw the bounce's sample dims in the reference's fixed order.
        # The NEE shadow ray traces SEPARATELY with the any-hit kernel
        # (shadow=True): visibility is a boolean, so any-hit early-out
        # (voxCommon.hpp:326-334 isShadowRay) keeps radiance bit-identical
        # while occluded lanes retire on their first leaf instead of
        # walking to the closest hit -- at 8 bounces NEE is ~half of all
        # traversals. The depth-0 implicit ray and the BSDF ray still ride
        # one concatenated closest-hit batch (one traversal dispatch).
        dim = 2 + depth * dims_per_bounce + (0 if first else n_extra)
        dir_s = emissive = pdf = None
        if hdri_enabled:
            rng, u01 = draw(rng, dim, spp, stream)
            rng, u23 = draw(rng, dim + 1, spp, stream)
            dim = dim + 2
            dir_s, emissive, pdf = hdri_ops.importance_sample(
                env, hit_n, u01[0], u01[1], u23[0], u23[1], axis_aligned=True
            )
        dir_e = None
        if n_extra and first:
            rng, eu = draw(rng, dim, spp, stream)
            dim = dim + 1
            dir_e = sampling.sample_lambertian(eu[0], eu[1], hit_n)
        rng, bu = draw(rng, dim, spp, stream)
        dir_b = sampling.sample_lambertian(bu[0], bu[1], hit_n)
        ro = jnp.where(alive[:, None], hit_p, 1e9)
        rd = jnp.where(alive[:, None], dir_b, rd)

        ro_sets = [hit_p] * (dir_e is not None) + [ro]
        rd_sets = [d for d in (dir_e, rd) if d is not None]
        t_all, nm_all, vi_all = intersect(
            jnp.concatenate(ro_sets) if len(ro_sets) > 1 else ro_sets[0],
            jnp.concatenate(rd_sets) if len(rd_sets) > 1 else rd_sets[0],
            False,
        )
        k = 0
        if dir_s is not None:
            # NEE to the env (voxKernel.cu:697-716), any-hit
            t_s, _, _ = intersect(hit_p, dir_s, True)
            vis = alive & (t_s >= 1e37)
            cosw = jnp.maximum(jnp.sum(hit_n * dir_s, axis=-1), 0.0)
            contrib = T * (refl / jnp.pi) * (cosw / pdf)[:, None] * emissive
            L = jnp.where(vis[:, None], L + contrib, L)

        T = jnp.where(alive[:, None], T * refl, T)

        if dir_e is not None:
            # one extra implicit emission ray (voxKernel.cu:720-738)
            t_e = t_all[k * R:(k + 1) * R]
            v_e = vi_all[k * R:(k + 1) * R]
            k += 1
            le_e = rgb8_to_f32(
                jnp.take(emission_table, v_e.astype(jnp.int32), mode="clip")
            ) * emission_scale
            pick = alive & (t_e < 1e37)
            L = jnp.where(
                pick[:, None], L + T * le_e / float(1 + n_extra), L
            )

        # BSDF ray (voxKernel.cu:741-759). Dead lanes park at 1e9 so their
        # traversal retires on iteration 0 instead of re-walking the tree.
        t_n = t_all[k * R:]
        nmaj_n = nm_all[k * R:]
        vidx_n = vi_all[k * R:]
        # only alive lanes advance their hit state
        new_hit = alive & (t_n < 1e37)
        le_b = rgb8_to_f32(
            jnp.take(emission_table, vidx_n.astype(jnp.int32), mode="clip")
        ) * emission_scale
        w_depth0 = 1.0 / float(1 + n_extra) if first else 1.0
        L = jnp.where(new_hit[:, None], L + T * le_b * w_depth0, L)

        nmaj = jnp.where(new_hit, nmaj_n, nmaj)
        vidx = jnp.where(new_hit, vidx_n, vidx)
        # dead lanes stay dead: a miss carries t = +inf into the next bounce
        t = jnp.where(new_hit, t_n, jnp.float32(jnp.inf))
        return ro, rd, T, L, t, nmaj, vidx, stream, spp, orig, rng

    st = (ro, rd, T, L, t, nmaj, vidx, stream, spp, orig, rng)
    if max_bounces >= 1:
        st = bounce(0, st, True)
    if max_bounces >= 2:
        st = jax.lax.fori_loop(
            1, max_bounces, lambda d, s: bounce(d, s, False), st
        )
    L, orig = st[3], st[9]

    if compact and max_bounces >= 2:
        # restore original lane order: sort by orig (a permutation of
        # [0, R)) carrying the radiance, in place of an at[orig].set
        # scatter
        _, lx, ly, lz = jax.lax.sort(
            (orig, L[:, 0], L[:, 1], L[:, 2]), num_keys=1
        )
        L = jnp.stack([lx, ly, lz], axis=1)
    return L


@dataclasses.dataclass
class PathTracer:
    """Engine facade (PathTracer.hpp:14-170): owns the scene tree, HDRI,
    PMJ table, and the progressive accumulation buffer."""

    width: int
    height: int
    tree: VoxelOctree | None = None
    env: hdri_ops.HDRI | None = None
    pmj_table: jax.Array | None = None
    accum: jax.Array | None = None  # f32 [W*H, 4]
    steps: int = 0
    spp_done: int = 0  # cumulative samples accumulated (PMJ sample base)
    emission_scale: float = 7.5  # m_emissionScale (IntersectorOctreeGPU.hpp:273)
    packet: int = RAY_PACKET
    max_bounces: int = MAX_BOUNCES
    n_batch_spp: int = N_BATCH_SPP
    use_pmj: bool = True
    compact: bool | None = None  # None = auto (on above COMPACT_MIN_LANES)
    tile_packets: bool = True  # 32x32-tile pixel order inside packets
    spp_major: bool = True  # block = consecutive pixels x full spp batch
    _perm_cache: tuple | None = None

    def setup(self):
        if self.pmj_table is None:
            self.pmj_table = jnp.asarray(sampling.make_pmj_table())
        self.clear_frame_buffer()

    def load_hdri(self, pixels, pixels_primary=None, scale: float = 1.75):
        self.env = hdri_ops.load(pixels, pixels_primary, scale=scale)

    def update_scene(self, tree: VoxelOctree):
        self.tree = tree

    def clear_frame_buffer(self):
        self.accum = jnp.zeros((self.width * self.height, 4), jnp.float32)
        self.steps = 0
        self.spp_done = 0

    def _pixel_perm(self, pix_packet: int):
        """(perm, inv, n_pad): perm[j] = pixel index rendered at packet
        -linear position j, in 32x32 screen-tile raster order (so each
        1024-lane traversal block is a square tile -- see pt_sample);
        inv[pixel] = j. Padding positions carry the out-of-frame sentinel
        n_pad (their rays render harmlessly, radiance dropped). n_pad is
        the packet-rounded tile cover of the frame."""
        key = (self.width, self.height, pix_packet, self.tile_packets)
        if self._perm_cache is not None and self._perm_cache[0] == key:
            return self._perm_cache[1:]
        n = self.width * self.height
        if not self.tile_packets:
            n_pad = -(-n // pix_packet) * pix_packet
            out = (None, None, n_pad)
        else:
            ts = 32
            wt = -(-self.width // ts)
            ht = -(-self.height // ts)
            n_tiles = wt * ht * ts * ts
            n_pad = -(-max(n, n_tiles) // pix_packet) * pix_packet
            idx = np.arange(n_tiles, dtype=np.int64)
            t, within = idx // (ts * ts), idx % (ts * ts)
            x = (t % wt) * ts + within % ts
            y = (t // wt) * ts + within // ts
            pix = y * self.width + x
            oob = (x >= self.width) | (y >= self.height)
            perm_np = np.full(n_pad, n_pad, np.uint32)
            perm_np[:n_tiles] = np.where(oob, n_pad, pix)
            pos = np.nonzero(perm_np < n)[0]
            inv_np = np.zeros(n, np.uint32)
            inv_np[perm_np[pos]] = pos
            out = (jnp.asarray(perm_np), jnp.asarray(inv_np), n_pad)
        self._perm_cache = (key,) + out
        return out

    def step(self, cam: camera_ops.Camera, n_spp: int | None = None):
        """One progressive step: +n_spp samples per pixel."""
        if n_spp is None:
            n_spp = self.n_batch_spp
        assert self.tree is not None and self.pmj_table is not None
        tree = self.tree
        env = self.env
        if env is None:
            # disabled env: zero-radiance 1x1 (isEnabled() == false path)
            env = hdri_ops.load(np.zeros((1, 1, 3), np.float32), scale=0.0)
        kind, depth, acc_meta, acc_root = accel_lib.accel_args(tree)

        n = self.width * self.height
        # pixel sub-packet: the spp batch multiplies the wavefront width;
        # adapt to the frame (pow2 buckets) but cap pixels * n_spp * 2 at
        # packet -- the bounce loop traces implicit+BSDF rays as one
        # concatenated closest-hit batch (up to 2x the lane width; NEE
        # traces separately as any-hit). The cap bounds device memory; on
        # an H100 a 1080p 16-spp step at this cap peaks near 8 GiB, and
        # larger packets are not yet measured.
        np2 = 1 << max(n - 1, 1).bit_length()
        pix_packet = max(min(self.packet // (max(n_spp, 1) * 2), np2), 1024)
        perm, inv_perm, n_pad = self._pixel_perm(pix_packet)

        parts = []
        for k in range(n_pad // pix_packet):
            li = pt_sample(
                acc_meta,
                acc_root,
                tree.lower,
                tree.upper,
                tree.color if tree.color is not None else jnp.zeros(1, U32),
                tree.emission if tree.emission is not None else jnp.zeros(1, U32),
                self.pmj_table,
                env,
                jnp.asarray(cam.o),
                jnp.asarray(cam.right),
                jnp.asarray(cam.up),
                jnp.asarray(cam.front),
                jnp.float32(cam.tan_half_fovy),
                jnp.float32(cam.lens_r),
                jnp.float32(cam.focus),
                jnp.uint32(k * pix_packet),
                jnp.uint32(self.spp_done),
                jnp.float32(1.0 / self.width),
                jnp.float32(1.0 / self.height),
                jnp.float32(self.width / self.height),
                jnp.float32(self.emission_scale),
                perm,
                width=self.width,
                pix_packet=pix_packet,
                n_spp=n_spp,
                accel_kind=kind,
                stack_depth=depth,
                has_emission=tree.has_emission,
                hdri_enabled=self.env is not None and env.scale > 0,
                extra_implicit=True,
                max_bounces=self.max_bounces,
                use_pmj=self.use_pmj,
                use_compact=(True if self.compact is None
                             else bool(self.compact)),
                spp_major=self.spp_major,
            )
            if self.spp_major:
                parts.append(li.reshape(pix_packet, n_spp, 3).sum(1))
            else:
                parts.append(li.reshape(n_spp, pix_packet, 3).sum(0))
        radiance = jnp.concatenate(parts)
        if inv_perm is not None:
            # tile order -> pixel order (see _pixel_perm)
            radiance = jnp.take(radiance, inv_perm, axis=0)
        radiance = radiance[:n]
        self.accum = self.accum + jnp.concatenate(
            [radiance, jnp.full((n, 1), float(n_spp), jnp.float32)], axis=1
        )
        self.steps += 1
        self.spp_done += n_spp

    def save_checkpoint(self, path: str, frame: int = 0):
        """Serialize progressive state (accum buffer, spp steps, frame) --
        the minimal restart point the reference lacks (SURVEY.md section 5:
        'serialize (accum buffer, spp, frame index) -- trivial')."""
        np.savez(
            _ckpt_path(path),
            accum=np.asarray(self.accum),
            steps=np.int64(self.steps),
            spp_done=np.int64(self.spp_done),
            frame=np.int64(frame),
            width=np.int64(self.width),
            height=np.int64(self.height),
        )

    def load_checkpoint(self, path: str) -> int:
        """Restore progressive state; returns the stored frame index."""
        z = np.load(_ckpt_path(path))
        assert int(z["width"]) == self.width and int(z["height"]) == self.height, (
            "checkpoint resolution mismatch"
        )
        self.accum = jnp.asarray(z["accum"])
        self.steps = int(z["steps"])
        self.spp_done = (
            int(z["spp_done"]) if "spp_done" in z else self.steps * N_BATCH_SPP
        )
        return int(z["frame"])

    def resolve(self) -> np.ndarray:
        """accum -> u8 image with 1/2.2 gamma (renderResolve)."""
        acc = np.asarray(self.accum)
        w = np.maximum(acc[:, 3:4], 1e-8)
        rgb = np.clip(acc[:, :3] / w, 0.0, None) ** (1.0 / 2.2)
        img = np.clip(255.0 * rgb + 0.5, 0, 255).astype(np.uint8)
        return img.reshape(self.height, self.width, 3)
