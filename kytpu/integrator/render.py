"""Frame rendering: camera-sample generation, spp batching, film assembly.

Replaces the reference's `integrator_t::render` OpenMP pixel loop
(ky.cpp:3689-3729) with a flat ray wavefront: every (pixel, sample) pair is
one SoA lane; passes are chunked so arbitrarily large (resolution x spp)
renders fit in HBM; the per-pixel mean is clamped to [0,1] at the end exactly
like the reference's film accumulation (clamp01(L), ky.cpp:3726) unless
`clamp=False` (HDR / inverse-rendering paths).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from kytpu.core import rng as krng
from kytpu.integrator import fast as kfast
from kytpu.integrator import path as kpath
from kytpu.scene import scene as kscene


def trace_lanes(scene, key, px, py, pixel_ids, sample_ids, cfg, mode, aov):
    """One wavefront pass: (n,) lanes of (pixel, sample) pairs -> (n,3).

    Pure and shardable: each lane's RNG stream is a function of
    (root key, sample_id, pixel_id) only, so any partition of the lanes
    across passes or devices produces bitwise-identical radiance.
    """
    if getattr(cfg, "sampler", "random") == "sobol":
        # low-discrepancy mode: keys fold ONLY the pixel id, so each
        # (pixel, bounce, purpose) site owns one scramble; the sample id
        # is the Sobol point index (core/lds.py). Still sharding-invariant:
        # a lane's draws depend on (root key, pixel_id, sample_id) alone.
        keys = jax.vmap(lambda p: jax.random.fold_in(key, p))(pixel_ids)
        index = sample_ids
    else:
        keys = jax.vmap(
            lambda s, p: jax.random.fold_in(jax.random.fold_in(key, s), p)
        )(sample_ids, pixel_ids)
        index = None
    k_cam, k_path = krng.split_channels(keys, 2)
    u = krng.uniform2(k_cam, cfg.sampler, index)
    if getattr(cfg, "filter", "box") == "tent":
        # smallpt's 2x2-subpixel tent filter (smallpt.cpp:107-118,
        # completing the reference's empty filter region, ky.cpp:1525):
        # samples cycle the 4 subpixels; the tent warp
        # dx = sqrt(2u)-1 | 1-sqrt(2-2u) spreads each subpixel's samples
        # over (-1, 1) around its center, overlapping pixel borders
        r1 = 2.0 * u[:, 0]
        r2 = 2.0 * u[:, 1]
        dx = jnp.where(r1 < 1.0, jnp.sqrt(r1) - 1.0,
                       1.0 - jnp.sqrt(jnp.maximum(2.0 - r1, 0.0)))
        dy = jnp.where(r2 < 1.0, jnp.sqrt(r2) - 1.0,
                       1.0 - jnp.sqrt(jnp.maximum(2.0 - r2, 0.0)))
        sub = sample_ids % 4
        u = jnp.stack([((sub % 2).astype(jnp.float32) + 0.5 + dx) * 0.5,
                       ((sub // 2).astype(jnp.float32) + 0.5 + dy) * 0.5],
                      axis=-1)
    elif getattr(cfg, "strata", None) and cfg.sampler == "stratified":
        # jittered camera strata over the sample index (completes the
        # reference's stratified_sampler_t stub, ky.cpp:978-985)
        a, b = cfg.strata
        s = sample_ids % (a * b)
        u = jnp.stack([((s % a).astype(jnp.float32) + u[:, 0]) / a,
                       ((s // a).astype(jnp.float32) + u[:, 1]) / b], axis=-1)
    p_film = jnp.stack([px + u[:, 0], py + u[:, 1]], axis=-1)
    o, d = kscene.generate_rays(scene.camera, p_film)

    if mode == "aov":
        return kpath.li_aov(scene, o, d, k_path, aov)
    if mode == "direct":
        return kpath.li_direct_lighting(scene, o, d, k_path, cfg, index)
    if mode == "fast" or isinstance(cfg, kfast.FastConfig):
        return kfast.li_path_fast(scene, o, d, k_path, cfg, index)
    return kpath.li_path(scene, o, d, k_path, cfg, index)


_render_pass = jax.jit(trace_lanes, static_argnames=("cfg", "mode", "aov"))


def _render_mean(scene, spp, seed, cfg, mode, aov, rays_per_pass):
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h

    ys, xs = np.divmod(np.arange(npix, dtype=np.int64), w)
    px_all = xs.astype(np.float32)
    py_all = ys.astype(np.float32)

    key = krng.root_key(seed)
    k = max(1, min(spp, rays_per_pass // max(npix, 1)))
    pix_chunk = min(npix, rays_per_pass)

    accum = jnp.zeros((npix, 3), jnp.float32)
    for p0 in range(0, npix, pix_chunk):
        p1 = min(p0 + pix_chunk, npix)
        pc = p1 - p0
        s0 = 0
        while s0 < spp:
            kk = min(k, spp - s0)
            pid = np.tile(np.arange(p0, p1, dtype=np.int32), kk)
            sid = np.repeat(np.arange(s0, s0 + kk, dtype=np.int32), pc)
            px = np.tile(px_all[p0:p1], kk)
            py = np.tile(py_all[p0:p1], kk)
            out = _render_pass(scene, key, jnp.asarray(px), jnp.asarray(py),
                               jnp.asarray(pid), jnp.asarray(sid),
                               cfg, mode, aov)
            accum = accum.at[p0:p1].add(
                out.reshape(kk, pc, 3).sum(axis=0))
            s0 += kk
    mean = accum / float(spp)
    return mean.reshape(h, w, 3)


def render(scene, spp: int = 16, seed: int = 1234,
           cfg: kpath.PathConfig | None = None, mode: str = "path",
           aov: str | None = None, clamp: bool = True,
           rays_per_pass: int = 1 << 20, engine: str = "jnp",
           interpret: bool | None = None):
    """Render a full frame; returns (H, W, 3) float32.

    mode: "path" (the wavefront path tracer), "fast" (production
    single-sample-MIS), "direct" (NEE only), or "aov" with aov in
    {"position","normal","basecolor"}.
    engine: "jnp" (XLA op graph), "pallas" (the fused megakernel; ignores
    mode/cfg.variant — it always runs the production transport), or
    "bigscene" (the table-driven megakernel: O(1) compile in the surface
    count, for scenes with hundreds-plus surfaces). "pallas" routes to
    "bigscene" by bigscene.use_table_kernel (past 64 surfaces, when the
    table kernel can take the scene) — baked-constant compiles blow up
    there.
    `clamp` reproduces the reference's per-pixel clamp01-of-the-mean
    (ky.cpp:3726); disable for HDR output or differentiable use.
    `interpret` (kernel engines): run the Pallas kernels in the
    interpreter; None chooses it exactly when JAX's default backend is
    the CPU.
    """
    if engine == "pallas":
        from kytpu.kernels import bigscene as kbig
        if kbig.use_table_kernel(scene):
            engine = "bigscene"
    if engine == "bigscene":
        from kytpu.kernels import bigscene as kbig
        from kytpu.kernels import wavefront as kwf
        if isinstance(cfg, kwf.KernelConfig):
            kcfg = cfg
        else:
            kcfg = kwf.KernelConfig(
                max_depth=getattr(cfg, "max_depth", 5),
                sampler=("sobol" if getattr(cfg, "sampler", "") == "sobol"
                         else "random"),
                shadow=getattr(cfg, "shadow", "parity"))
        return kbig.render_bigscene(scene, spp=spp, seed=seed, cfg=kcfg,
                                    clamp=clamp,
                                    rays_per_pass=rays_per_pass,
                                    interpret=kwf.resolve_interpret(
                                        interpret))
    if engine == "pallas":
        from kytpu.kernels import wavefront as kwf
        if isinstance(cfg, kwf.KernelConfig):
            kcfg = cfg
        else:
            # PathConfig(sampler="sobol") maps to the kernel's in-kernel
            # Owen-Sobol lanes
            kcfg = kwf.KernelConfig(
                max_depth=getattr(cfg, "max_depth", 5),
                sampler=("sobol" if getattr(cfg, "sampler", "") == "sobol"
                         else "random"),
                shadow=getattr(cfg, "shadow", "parity"))
        return kwf.render_pallas(scene, spp=spp, seed=seed, cfg=kcfg,
                                 clamp=clamp, rays_per_pass=rays_per_pass,
                                 interpret=kwf.resolve_interpret(interpret))
    # "fast"/"path" are accepted aliases of "jnp" (the cfg TYPE selects
    # the integrator inside trace_lanes)
    if engine not in ("jnp", "fast", "path"):
        raise ValueError(
            f"unknown engine {engine!r}: expected 'jnp', 'pallas' or "
            "'bigscene'")
    cfg = cfg or kpath.PathConfig()
    if cfg.sampler == "stratified" and cfg.strata == (1, 1):
        import dataclasses
        cfg = dataclasses.replace(cfg, strata=krng.stratum_grid(spp))
    img = _render_mean(scene, spp, seed, cfg, mode, aov, rays_per_pass)
    if clamp:
        img = jnp.clip(img, 0.0, 1.0)
    return img


def render_aov(scene, which: str, spp: int = 10, seed: int = 1234, **kw):
    return render(scene, spp=spp, seed=seed, mode="aov", aov=which, **kw)


def render_region(scene, x0: int, y0: int, x1: int, y1: int, spp: int = 16,
                  seed: int = 1234, cfg: kpath.PathConfig | None = None,
                  mode: str = "path", aov: str | None = None,
                  clamp: bool = True):
    """Re-render just the [x0,x1) x [y0,y1) film rectangle -> (y1-y0, x1-x0, 3).

    The pixel-bisection harness (integrator_t::debug_area, ky.cpp:3733-3771).
    Pixel ids match the full-frame render, so a region lane reproduces its
    full-frame radiance bitwise at the same seed.
    """
    cfg = cfg or kpath.PathConfig()
    w = scene.camera.width
    rw, rh = x1 - x0, y1 - y0
    xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
    pid = (ys * w + xs).reshape(-1).astype(np.int32)
    px = xs.reshape(-1).astype(np.float32)
    py = ys.reshape(-1).astype(np.float32)
    key = krng.root_key(seed)
    accum = jnp.zeros((rw * rh, 3), jnp.float32)
    for s in range(spp):
        sid = np.full(pid.shape, s, np.int32)
        accum = accum + _render_pass(
            scene, key, jnp.asarray(px), jnp.asarray(py),
            jnp.asarray(pid), jnp.asarray(sid), cfg, mode, aov)
    img = (accum / float(spp)).reshape(rh, rw, 3)
    if clamp:
        img = jnp.clip(img, 0.0, 1.0)
    return img


def debug_area(scene, full_img, x0: int, y0: int, x1: int, y1: int, **kw):
    """Composite a re-rendered region into full_img with a red border
    (ky.cpp:3747-3762). Returns a numpy (H, W, 3) copy."""
    out = np.array(full_img, np.float32, copy=True)
    region = np.asarray(render_region(scene, x0, y0, x1, y1, **kw))
    out[y0:y1, x0:x1] = region
    red = np.array([1.0, 0.0, 0.0], np.float32)
    out[y0, x0:x1] = red
    out[y1 - 1, x0:x1] = red
    out[y0:y1, x0] = red
    out[y0:y1, x1 - 1] = red
    return out


def debug_pixel(scene, x: int, y: int, **kw):
    """Single-pixel re-render (integrator_t::debug_pixel, ky.cpp:3773-3787)."""
    return render_region(scene, x, y, x + 1, y + 1, **kw)[0, 0]
