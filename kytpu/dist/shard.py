"""Sharded wavefront rendering over a ("tile", "spp") mesh.

Replaces the reference's OpenMP row loop (ky.cpp:3696-3701) with an SPMD
shard_map: every device owns a strip of flat pixels ("tile" axis) and a
slice of the per-pixel sample budget ("spp" axis). The body renders its
(samples x pixels) block with the same lane function as the single-device
path (kytpu.integrator.render.trace_lanes) — per-lane RNG keys depend only
on (seed, sample_id, pixel_id), so the sharded render is bitwise identical
to the unsharded one for any mesh shape.

Collective structure (the whole communication story):
  - one `psum` of the per-pixel partial sums over the "spp" axis per pass;
  - film tiles never move: the output is laid out sharded over "tile"
    and only re-assembled by the host when the caller converts to numpy.
Gradients: shard_map transposes the replicated scene input into a psum of
per-device cotangents — exactly the "psum for parameter grads" design
(SURVEY.md §2.3) — with zero extra code.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kytpu.integrator import path as kpath
from kytpu.integrator.render import trace_lanes


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _shard_body(scene, key, px, py, pid, sid, *, cfg, mode, aov):
    """Per-device block: px/py/pid are the local pixel strip (Ploc,),
    sid the local sample slice (Sloc,). Returns (Ploc, 3) partial sums
    reduced over the full sample axis."""
    s_loc = sid.shape[0]
    p_loc = pid.shape[0]
    lane_px = jnp.tile(px, s_loc)
    lane_py = jnp.tile(py, s_loc)
    lane_pid = jnp.tile(pid, s_loc)
    lane_sid = jnp.repeat(sid, p_loc)
    out = trace_lanes(scene, key, lane_px, lane_py, lane_pid, lane_sid,
                      cfg, mode, aov)
    partial = out.reshape(s_loc, p_loc, 3).sum(axis=0)
    return jax.lax.psum(partial, "spp")


@functools.partial(jax.jit,
                   static_argnames=("mesh", "cfg", "mode", "aov"))
def _render_chunk(scene, key, px, py, pid, sid, mesh, cfg, mode, aov):
    body = functools.partial(_shard_body, cfg=cfg, mode=mode, aov=aov)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P("tile"), P("tile"), P("tile"), P("spp")),
        out_specs=P("tile", None),
        check_vma=False,
    )
    return fn(scene, key, px, py, pid, sid)


def render_sharded(scene, mesh: Mesh, spp: int = 16, seed: int = 1234,
                   cfg: kpath.PathConfig | None = None, mode: str = "path",
                   aov: str | None = None, clamp: bool = True,
                   samples_per_chunk: int | None = None):
    """Render a full frame on a ("tile", "spp") mesh; returns (H, W, 3).

    `samples_per_chunk` bounds lanes-in-flight per device (HBM control for
    large spp); it must be a multiple of the "spp" axis size. The result is
    identical to kytpu.integrator.render.render at the same seed.
    """
    cfg = cfg or kpath.PathConfig()
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    n_tile = mesh.shape["tile"]
    n_spp = mesh.shape["spp"]
    if spp % n_spp:
        raise ValueError(f"spp={spp} not divisible by spp-axis size {n_spp}")

    npad = _pad_to(npix, n_tile)
    ys, xs = np.divmod(np.arange(npad, dtype=np.int64) % npix, w)
    px = jnp.asarray(xs.astype(np.float32))
    py = jnp.asarray(ys.astype(np.float32))
    # padding lanes re-render pixel 0..pad-1; their output is sliced away
    pid = jnp.asarray((np.arange(npad, dtype=np.int64) % npix).astype(np.int32))

    tile_sh = NamedSharding(mesh, P("tile"))
    spp_sh = NamedSharding(mesh, P("spp"))
    px = jax.device_put(px, tile_sh)
    py = jax.device_put(py, tile_sh)
    pid = jax.device_put(pid, tile_sh)

    key = jax.random.key(seed)
    k = samples_per_chunk or spp
    k = max(n_spp, (k // n_spp) * n_spp)

    accum = jnp.zeros((npad, 3), jnp.float32)
    s0 = 0
    while s0 < spp:
        kk = min(k, spp - s0)
        sid = jax.device_put(
            jnp.arange(s0, s0 + kk, dtype=jnp.int32), spp_sh)
        accum = accum + _render_chunk(scene, key, px, py, pid, sid,
                                      mesh, cfg, mode, aov)
        s0 += kk

    img = (accum[:npix] / float(spp)).reshape(h, w, 3)
    if clamp:
        img = jnp.clip(img, 0.0, 1.0)
    return img


def render_tiles(scene, mesh: Mesh, **kw):
    """Like render_sharded but returns the flat (npix_padded, 3) array still
    laid out sharded over "tile" — for pipelines that keep tiles device-local
    (checkpointing partial films, per-host encoding)."""
    img = render_sharded(scene, mesh, clamp=False, **kw)
    return img.reshape(-1, 3)


def render_sharded_pallas(scene, mesh: Mesh, spp: int = 16, seed: int = 1234,
                          kernel_cfg=None, clamp: bool = True,
                          interpret: bool = False, engine: str = "auto"):
    """Sharded render through the fused Pallas megakernel.

    Same ("tile", "spp") decomposition as render_sharded — pixels sharded
    over tile, samples over spp, one psum per pass — but each device runs
    the megakernel on its lane shard (a pallas_call inside shard_map).
    The DEFAULT sampler ("random") is implemented as the kernel's "hash"
    sampler here: every in-kernel draw is a stateless function of
    (seed, pixel id, sample index, draw site), and camera jitter is keyed
    by (pixel, sample), so the sharded image is MESH-SHAPE-INVARIANT and
    matches the single-device render_pallas(cfg.sampler="hash") up to f32
    reduction order. kernel_cfg.sampler == "sobol" gets the same
    invariance with low-discrepancy points. The one exception is
    nee="single", whose scalar per-tile light pick depends on the tile
    decomposition. Pass kernel_cfg.sampler == "tile" to force the
    tile-keyed hash streams (the single-device "random" sampler;
    reproducible per mesh shape only).

    engine: "pallas" (the baked-geometry megakernel), "bigscene" (the
    table-driven megakernel, O(1) compile in the surface count), or
    "auto" — bigscene.use_table_kernel, integrator.render's routing. Both tracers share the lane
    signature, so the mesh decomposition is identical.
    """
    import dataclasses

    from kytpu.kernels import wavefront as kwf
    from kytpu.scene import scene as kscene_mod

    cfg = kernel_cfg or kwf.KernelConfig()
    if cfg.sampler == "random":
        # the sharded default is the decomposition-invariant hash sampler
        cfg = dataclasses.replace(cfg, sampler="hash")
    elif cfg.sampler == "tile":
        # explicit opt-in to the tile-keyed streams
        cfg = dataclasses.replace(cfg, sampler="random")
    if engine == "auto":
        from kytpu.kernels import bigscene as kbig
        engine = "bigscene" if kbig.use_table_kernel(scene) else "pallas"
    if engine == "bigscene":
        from kytpu.kernels import bigscene as kbig
        tracer = kbig.make_bigscene_tracer(scene, cfg, interpret=interpret)
    else:
        tracer = kwf.make_pallas_tracer(scene, cfg, interpret=interpret)
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    n_tile = mesh.shape["tile"]
    n_spp = mesh.shape["spp"]
    if spp % n_spp:
        raise ValueError(f"spp={spp} not divisible by spp axis {n_spp}")

    npad = _pad_to(npix, n_tile)
    pid = jnp.asarray((np.arange(npad, dtype=np.int64) % npix)
                      .astype(np.int32))
    px = (pid % w).astype(jnp.float32)
    py = (pid // w).astype(jnp.float32)

    tile_sh = NamedSharding(mesh, P("tile"))
    px = jax.device_put(px, tile_sh)
    py = jax.device_put(py, tile_sh)
    pid = jax.device_put(pid, tile_sh)
    sid = jax.device_put(jnp.arange(spp, dtype=jnp.int32),
                         NamedSharding(mesh, P("spp")))
    key = jax.random.key(seed)

    use_sobol = cfg.sampler == "sobol"
    use_hash = cfg.sampler == "hash"

    def body(scene, px, py, pid, sid):
        s_loc = sid.shape[0]
        p_loc = pid.shape[0]
        lane_pid = jnp.tile(pid, s_loc)
        lane_sid = jnp.repeat(sid, p_loc)
        if use_sobol:
            # identical construction to render_pallas' sobol path: camera
            # jitter from per-pixel (0,2) streams indexed by sample, path
            # RNG a pure fn of (seed, pixel, sample, site) — mesh-invariant
            from kytpu.core import rng as krng
            cam_keys = jax.vmap(
                lambda p_: jax.random.fold_in(key, p_))(lane_pid)
            u = krng.uniform2(cam_keys, "sobol", lane_sid)
        elif use_hash:
            # identical construction to render_pallas' hash path: jitter
            # keys and in-kernel streams keyed by (pixel, sample) only
            cam_keys = jax.vmap(jax.random.fold_in, (None, 0))(
                key, lane_sid * jnp.int32(npix) + lane_pid)
            u = jax.vmap(lambda k: jax.random.uniform(k, (2,)))(cam_keys)
        else:
            keys = jax.vmap(
                lambda s_, p_: jax.random.fold_in(
                    jax.random.fold_in(key, s_), p_)
            )(lane_sid, lane_pid)
            u = jax.vmap(lambda k: jax.random.uniform(k, (2,)))(keys)
        lane_px = jnp.tile(px, s_loc) + u[:, 0]
        lane_py = jnp.tile(py, s_loc) + u[:, 1]
        o, d = kscene_mod.generate_rays(cam, jnp.stack([lane_px, lane_py], -1))
        if use_sobol or use_hash:
            out = tracer(scene, o, d, jnp.int32(seed), lane_sid, lane_pid)
        else:
            ti = jax.lax.axis_index("tile")
            si = jax.lax.axis_index("spp")
            dev_seed = (jnp.int32(seed)
                        + ti.astype(jnp.int32) * jnp.int32(7919)
                        + si.astype(jnp.int32) * jnp.int32(104729))
            out = tracer(scene, o, d, dev_seed)
        partial = out.reshape(s_loc, p_loc, 3).sum(axis=0)
        return jax.lax.psum(partial, "spp")

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P("tile"), P("tile"), P("tile"), P("spp")),
        out_specs=P("tile", None),
        check_vma=False,
    ))
    accum = fn(scene, px, py, pid, sid)
    img = (accum[:npix] / float(spp)).reshape(h, w, 3)
    if clamp:
        img = jnp.clip(img, 0.0, 1.0)
    return img
