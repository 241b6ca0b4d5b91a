"""Production wavefront integrator: single-sample MIS path tracing.

The reference's `both_mis` estimator draws an INDEPENDENT BSDF sample per
light per vertex (ky.cpp:3981-4029 inside the per-light loop, 3864-3869),
so a bounce with L lights costs 2L+1 full scene sweeps. This module is the
Accelerator-first production formulation with the same expectation:

  - the extension ray doubles as the BSDF-side MIS sample for EVERY light:
    when it hits an emitter (or the environment), the emission is weighted
    by balance MIS against that light's solid-angle pdf. This is the classic
    Veach one-sample-per-technique estimator (E[contribution] identical to
    the reference's per-light draws, because a per-light BSDF draw only
    contributes when it happens to hit that light);
  - the L shadow rays of light-side NEE are stacked into ONE batched
    occlusion sweep;
  - all of a bounce's uniforms come from ONE fused counter-based draw
    (4 + 2L floats per lane) instead of a fold/split tree.

Per bounce: 1 closest-hit sweep + 1 (L*N)-lane occlusion sweep, versus the
reference formulation's 2L+1 sweeps — the geometry work drops ~5x for the
Veach scene while converging to the same image (tests/test_fast.py checks
agreement with the reference-exact integrator and the numpy oracle).

Documented deviation: delta (point/directional) lights receive their FULL
light-sampled contribution here. The reference's both_mis strategy halves
them (0.5*Lb + 0.5*Ll where Lb is identically zero for delta lights,
ky.cpp:4076-4088 + 3889-3892) — a bug kytpu.light.nee replicates for
strategy-parity but the production integrator corrects.

Differentiability: identical detached-sampling discipline to
kytpu.integrator.path — directions, pdfs, and discrete decisions are
stop_gradient-ed; radiance/albedo numerators carry gradients.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from kytpu import bsdf as kbsdf
from kytpu.core import math as km
from kytpu.light import lights as klights
from kytpu.scene import scene as kscene
from kytpu.scene import shapes as kshapes

_sg = jax.lax.stop_gradient


@dataclass(frozen=True)
class FastConfig:
    """Static config for the fused integrator (hashable jit key)."""

    max_depth: int = 5
    rr_start: int = 3
    unroll: int = 1
    # "random": ONE fused threefry call per bounce (fastest).
    # "debug": every draw 0.5 (reference debug_sampler_t, ky.cpp:922-947).
    # "sobol": per-purpose Owen-scrambled (0,2) draws (core/lds.py) — the
    # per-lane key must fold only the pixel id and the caller passes the
    # sample index (render.trace_lanes does both); each (pixel, bounce,
    # purpose) site owns one scramble, so the fused single-call layout is
    # traded for a fold/split tree on this path only.
    sampler: str = "random"   # "random" | "debug" | "sobol"
    filter: str = "box"       # "box" | "tent" (smallpt's 2x2 tent filter)
    # "parity" replicates the reference's shadow-ray self-occlusion quirk
    # (see kytpu.scene.scene.occluded); "robust" measures the shadow tmax
    # from the actual offset origin (physically correct)
    shadow: str = "parity"    # "parity" | "robust"


def _draws(keys, bounce, n_draws: int, sampler: str):
    """All of this bounce's uniforms in one fused threefry call: (N, n)."""
    if sampler == "debug":
        return jnp.full((keys.shape[0], n_draws), 0.5, jnp.float32)
    return jax.vmap(
        lambda k: jax.random.uniform(jax.random.fold_in(k, bounce), (n_draws,))
    )(keys)


def _draws_sobol(keys, bounce, n_lights: int, index):
    """Per-purpose Owen-Sobol draws laid out in _draws' column order:
    lobe | L x (2 light) | 2 bsdf | 1 rr. `keys` fold only the pixel id;
    `index` is the per-lane sample id (the Sobol point index)."""
    from kytpu.core import rng as krng
    kb = krng.bounce_key(keys, bounce)
    parts = krng.split_channels(kb, n_lights + 3)
    cols = [krng.uniform(parts[0], (), "sobol", index)[:, None]]
    for i in range(n_lights):
        cols.append(krng.uniform2(parts[1 + i], "sobol", index))
    cols.append(krng.uniform2(parts[n_lights + 1], "sobol", index))
    cols.append(krng.uniform(parts[n_lights + 2], (), "sobol", index)[:, None])
    return jnp.concatenate(cols, axis=-1)


def _hit_light_pdf(scene, prev_o, prev_n, d, light_index):
    """Solid-angle pdf of the light the extension ray hit (0 if none).

    Unrolls the (static, small) light list and selects by the hit surface's
    light id; delta lights return 0 (a BSDF ray cannot hit them).
    """
    pdf = jnp.zeros(d.shape[0], d.dtype)
    for i, kind in enumerate(scene.lights.kinds):
        if klights.is_delta_light(kind) or kind == klights.ENV:
            continue
        pi = klights.pdf_li(scene.lights, i, prev_o, prev_n, d)
        pdf = jnp.where(light_index == i, pi, pdf)
    return pdf


def _env_index(scene):
    for i, kind in enumerate(scene.lights.kinds):
        if kind == klights.ENV:
            return i
    return None


def li_path_fast(scene: kscene.Scene, o, d, keys, cfg: FastConfig,
                 index=None):
    """Radiance for a batch of primary rays; (N, 3).

    With cfg.sampler == "sobol", `keys` must be sample-independent
    (pixel-folded only) and `index` the per-lane sample ids."""
    if cfg.sampler not in ("random", "debug", "sobol"):
        raise ValueError(f"fast engine: unsupported sampler {cfg.sampler!r}")
    if cfg.sampler == "sobol" and index is None:
        raise ValueError("fast engine: sampler='sobol' needs the per-lane "
                         "sample index (render.trace_lanes passes it)")
    n = o.shape[0]
    f32 = o.dtype
    L = scene.n_lights
    n_draws = 2 * L + 4   # lobe | L x 2 light | 2 bsdf | 1 rr
    env_i = _env_index(scene)

    def body(carry, bounce):
        o, d, beta, big_l, alive, prev_n, spec_prev, pdf_prev = carry

        hit = kscene.intersect(scene, o, d)
        if cfg.sampler == "sobol":
            u = _sg(_draws_sobol(keys, bounce, L, index))
        else:
            u = _sg(_draws(keys, bounce, n_draws, cfg.sampler))

        # ---- emission with BSDF-side MIS weight ----
        le = jnp.where(hit.valid[:, None], hit.emission, 0.0)
        pdf_l_hit = _sg(_hit_light_pdf(scene, o, prev_n, d, hit.light_index))
        full = (bounce == 0) | spec_prev
        w_emit = jnp.where(full, 1.0,
                           km.safe_div(pdf_prev, pdf_prev + pdf_l_hit))
        big_l = big_l + jnp.where(alive[:, None], beta * le * w_emit[:, None],
                                  0.0)
        if env_i is not None:
            le_env = scene.env_radiance(n)
            pdf_env = _sg(klights.pdf_li(scene.lights, env_i, o, prev_n, d))
            w_env = jnp.where(full, 1.0,
                              km.safe_div(pdf_prev, pdf_prev + pdf_env))
            big_l = big_l + jnp.where(
                (alive & ~hit.valid)[:, None], beta * le_env * w_env[:, None],
                0.0)

        cont = alive & hit.valid & (bounce < cfg.max_depth)

        # ---- resolve material (plastic lobe pick consumes u[:, 0]) ----
        mk = scene.mat_kind[hit.sid]
        params = kbsdf.resolve_bsdf(
            mk, scene.diffuse_at(hit.sid, hit.uv), scene.mat_specular[hit.sid],
            scene.mat_exponent[hit.sid], scene.mat_eta[hit.sid],
            scene.mat_d_prob[hit.sid], scene.mat_s_prob[hit.sid], u[:, 0])
        delta = kbsdf.is_delta(params)
        nee_act = cont & ~delta

        # ---- light-side NEE: sample every light, batch the shadow rays ----
        if L:
            contribs = []
            sh_o, sh_d, sh_t = [], [], []
            for i, kind in enumerate(scene.lights.kinds):
                u2 = u[:, 1 + 2 * i:3 + 2 * i]
                ls = klights.sample_li(scene.lights, i, scene.world_radius,
                                       hit.position, hit.normal, u2)
                wi = _sg(ls.wi)
                pdf_l = _sg(ls.pdf)
                f_cos = kbsdf.eval_world(params, hit.normal, hit.wo, wi) \
                    * km.absdot(wi, hit.normal)[:, None]
                if klights.is_delta_light(kind):
                    w = km.safe_div(1.0, pdf_l)
                else:
                    pdf_b = _sg(kbsdf.pdf_world(params, hit.normal, hit.wo, wi))
                    w = km.safe_div(1.0, pdf_l + pdf_b)
                ok = nee_act & (pdf_l > 0.0) \
                    & ~jnp.all(ls.li <= 0.0, axis=-1) \
                    & ~jnp.all(f_cos <= 0.0, axis=-1)
                contribs.append((ok, f_cos * ls.li * w[:, None]))
                o_i = kshapes.offset_ray_origin(hit.position, hit.normal, wi)
                sh_o.append(o_i)
                sh_d.append(wi)
                d_from = o_i if cfg.shadow == "robust" else hit.position
                sh_t.append(km.distance(d_from, ls.position)
                            - km.SHADOW_EPSILON)
            oc_o = jnp.concatenate(sh_o, 0)
            oc_d = jnp.concatenate(sh_d, 0)
            oc_t = jnp.concatenate(sh_t, 0)
            if cfg.shadow == "robust":
                # exclude each light's own emitting surface from its lanes
                # of the stacked sweep (see kscene.occluded_from)
                skip = jnp.concatenate(
                    [jnp.full((n,), scene.lights.surface_ids[i], jnp.int32)
                     for i in range(L)])
                occ = kshapes.any_hit(scene.geometry, oc_o, oc_d, oc_t,
                                      skip_row=skip).reshape(L, n)
            elif scene.accel is not None:
                from kytpu.scene import accel as kaccel
                occ = kaccel.grid_any_hit(scene.accel, scene.geometry,
                                          oc_o, oc_d, oc_t).reshape(L, n)
            else:
                occ = kshapes.any_hit(scene.geometry, oc_o, oc_d,
                                      oc_t).reshape(L, n)
            ld = jnp.zeros((n, 3), f32)
            for i, (ok, c) in enumerate(contribs):
                ld = ld + jnp.where((ok & ~occ[i])[:, None], c, 0.0)
            big_l = big_l + beta * ld

        # ---- extension ray == next bounce's BSDF-side MIS sample ----
        bs = kbsdf.sample_world(params, hit.normal, hit.wo,
                                u[:, 2 * L + 1:2 * L + 3])
        wi = _sg(bs.wi)
        pdf = _sg(bs.pdf)
        ok = cont & ~jnp.all(bs.f <= 0.0, axis=-1) & (pdf != 0.0)
        throughput = bs.f * km.safe_div(km.absdot(wi, hit.normal), pdf)[:, None]

        # Russian roulette (iteration-variant rule, ky.cpp:4601-4613)
        beta_new = beta * throughput
        q = _sg(jnp.maximum(0.05, 1.0 - km.max_component(beta_new)))
        rr_on = bounce > cfg.rr_start
        kill = rr_on & (u[:, 2 * L + 3] < q)
        beta_new = beta_new * jnp.where(rr_on, km.safe_div(1.0, 1.0 - q),
                                        1.0)[:, None]

        alive_n = ok & ~kill
        sel = alive_n[:, None]
        return ((jnp.where(sel, kshapes.offset_ray_origin(
                    hit.position, hit.normal, wi), o),
                 jnp.where(sel, wi, d),
                 jnp.where(sel, beta_new, beta),
                 big_l,
                 alive_n,
                 jnp.where(sel, hit.normal, prev_n),
                 jnp.where(alive_n, bs.delta, spec_prev),
                 jnp.where(alive_n, pdf, pdf_prev)),
                None)

    init = (o, d,
            jnp.ones((n, 3), f32), jnp.zeros((n, 3), f32),
            jnp.ones((n,), bool),
            -d,                       # "previous normal" placeholder
            jnp.zeros((n,), bool),
            jnp.ones((n,), f32))
    (_, _, _, big_l, _, _, _, _), _ = jax.lax.scan(
        body, init, jnp.arange(cfg.max_depth + 1), unroll=cfg.unroll)
    return big_l
