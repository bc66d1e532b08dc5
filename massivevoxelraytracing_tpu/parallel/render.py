"""Sharded progressive render step over a ('dp', 'sp') mesh.

Design (SURVEY.md section 2.8 mapping): rays/pixels shard over 'dp', the spp
batch shards over 'sp' and is reduced with a psum; the SVO/DAG node
tables and attributes are replicated per chip (they are small after DAG
compression -- 61 MB for 55M voxels in the reference's headline scene).
This is the multi-chip form of one PathTracer::step (+16 spp,
PathTracer.hpp:150-159)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P



def make_sharded_render(mesh: Mesh, *, width: int, height: int,
                        kind: str, depth, show_color: bool = False):
    """Primary-ray frame (the `render` debug kernel, voxKernel.cu:437-483)
    over every device of the mesh: 128-pixel tile-row bands shard across a
    flattened device axis, each device runs raygen -> traversal -> shading
    on its band with the scene tables replicated; the assembled frame comes
    back row-sharded. Per-lane results are identical to the single-device
    render_frame (the traversal kernels run on fixed-size blocks whose
    float context does not depend on the frame partition)."""
    from ..models import raycast

    devs = mesh.devices.reshape(-1)
    d = len(devs)
    flat = Mesh(devs, ("rows",))
    nty = -(-height // raycast.TILE)
    band_nty = -(-nty // d)
    band_rows = band_nty * raycast.TILE

    def render(meta, root, lower, upper, color_table, cam_o, cam_right,
               cam_up, cam_front, tan_half_fovy):
        def shard_fn(meta, root, lower, upper, color_table, cam_o,
                     cam_right, cam_up, cam_front, tan_half_fovy):
            r_idx = jax.lax.axis_index("rows").astype(jnp.int32)
            py0 = r_idx * jnp.int32(band_rows)
            ro, rd = raycast._gen_rays_band(
                cam_o, cam_right, cam_up, cam_front, tan_half_fovy, py0,
                width=width, height=height, band_tile_rows=band_nty,
            )
            from ..models import accel as accel_lib

            t, nmaj, vidx = accel_lib.intersect_with(
                kind, depth, meta, root, lower, upper, ro, rd
            )
            return raycast._shade_untile_band(
                color_table, rd, t, nmaj, vidx, width=width,
                band_tile_rows=band_nty, rows_out=band_rows,
                show_color=show_color,
            )

        img, t = jax.shard_map(
            shard_fn,
            mesh=flat,
            in_specs=(P(),) * 10,
            out_specs=P("rows"),
        )(meta, root, lower, upper, color_table, cam_o, cam_right,
          cam_up, cam_front, tan_half_fovy)
        return img[:height], t[:height]

    return jax.jit(render)


def make_sharded_pt_step(mesh: Mesh, *, stack_depth: int,
                         spp_per_device: int = 2, width: int, height: int,
                         n_pixels: int, has_emission: bool,
                         hdri_enabled: bool, emission_scale: float = 7.5,
                         accel_kind: str = "octree"):
    """The FULL progressive path-trace step over the ('dp','sp') mesh:
    pixels shard over 'dp' (each dp-shard generates its pixel lanes on
    device from its axis index), the spp batch shards over 'sp' (each
    sp-shard draws different PMJ sample indices) and reduces with a psum; the SVO/DAG, attributes, HDRI tables, and PMJ table are
    replicated. This is PathTracer::step (+spp) in its multi-chip form."""
    from ..models.pathtracer import pt_sample

    dp = mesh.devices.shape[0]
    assert n_pixels % dp == 0
    shard_pixels = n_pixels // dp

    def step(meta, root_entry, lower, upper, color_table, emission_table,
             pmj_table, env, cam_o, cam_right, cam_up, cam_front,
             tan_half_fovy, lens_r, focus, accum, spp_base):
        def shard_fn(meta, root_entry, lower, upper, color_table,
                     emission_table, pmj_table, env, cam_o, cam_right,
                     cam_up, cam_front, tan_half_fovy, lens_r, focus,
                     accum, spp_base):
            dp_idx = jax.lax.axis_index("dp").astype(jnp.uint32)
            sp_idx = jax.lax.axis_index("sp").astype(jnp.uint32)
            pix_start = dp_idx * jnp.uint32(shard_pixels)
            li = pt_sample(
                meta, root_entry, lower, upper, color_table,
                emission_table, pmj_table, env, cam_o, cam_right,
                cam_up, cam_front, tan_half_fovy, lens_r, focus,
                pix_start,
                spp_base + sp_idx * jnp.uint32(spp_per_device),
                jnp.float32(1.0 / width), jnp.float32(1.0 / height),
                jnp.float32(width / height),
                jnp.float32(emission_scale),
                width=width, pix_packet=shard_pixels, n_spp=spp_per_device,
                accel_kind=accel_kind,
                stack_depth=stack_depth, has_emission=has_emission,
                hdri_enabled=hdri_enabled, extra_implicit=True,
            )
            total = li.reshape(spp_per_device, shard_pixels, 3).sum(0)
            total = jax.lax.psum(total, "sp")
            n_sp = jax.lax.psum(1, "sp")
            new_n = jnp.float32(spp_per_device * n_sp)
            return accum + jnp.concatenate(
                [total, jnp.broadcast_to(new_n, (shard_pixels, 1))], axis=1
            )

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(
                P(), P(), P(), P(), P(), P(), P(), P(),  # scene + tables replicated
                P(), P(), P(), P(), P(), P(), P(),       # camera scalars
                P("dp"),                                  # accum sharded
                P(),
            ),
            out_specs=P("dp"),
            # pt_sample's bounce loop carries per-pixel (stream), per-sample
            # (spp) and per-lane (orig) state, and the inter-bounce
            # compaction sort mixes them, so their varying-axes types differ
            # between the lax.fori_loop's entry and exit; pt_sample cannot
            # reconcile them without naming this mesh's axes
            check_vma=False,
        )(meta, root_entry, lower, upper, color_table, emission_table,
          pmj_table, env, cam_o, cam_right, cam_up, cam_front,
          tan_half_fovy, lens_r, focus, accum, spp_base)

    return jax.jit(step)
