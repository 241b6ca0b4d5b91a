"""Next-event estimation: six selectable direct-lighting strategies with MIS.

Data-parallel inversion of the reference's estimator suite (ky.cpp:3798-4090).
Each estimator is vectorized over the whole ray wavefront; the per-light loop
(<= 5 lights in every reference scene) unrolls statically, so each light's
shadow/MIS rays compile into specialized intersection sweeps.

Strategies (direct_sample_enum_t, ky.cpp:3608-3623):
  - "idle":        contribute nothing (emission-only rendering)
  - "bsdf":        sample the BSDF, hit the light            (ky.cpp:3889-3930)
  - "light":       sample the light, test occlusion          (ky.cpp:3933-3962)
  - "bsdf_mis":    BSDF sampling with folded one-sample balance weight
                   Ld = 2 f cos Li / (pdf_b + pdf_l)         (ky.cpp:3968-4033)
  - "light_mis":   light sampling with the dual weight       (ky.cpp:4035-4074)
  - "both_mis":    0.5 * bsdf_mis + 0.5 * light_mis, sharing the same
                   random draws                              (ky.cpp:4076-4088)

Light selection: "all" loops every light (sample_all_light, ky.cpp:3834-3872);
"single" picks one uniformly and divides by 1/L (ky.cpp:3813-3832).

Differentiability: every pdf and sampled direction is stop_gradient-ed
(detached sampling); radiance and BSDF numerators carry gradients.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kytpu.core import math as km
from kytpu.core import rng as krng
from kytpu import bsdf as kbsdf
from kytpu.light import lights as klights
from kytpu.scene import scene as kscene
from kytpu.scene import shapes as kshapes

STRATEGIES = ("idle", "bsdf", "light", "bsdf_mis", "light_mis", "both_mis")

_sg = jax.lax.stop_gradient


def _black(f):
    """color_t::is_black — all components <= 0 (ky.cpp:258)."""
    return jnp.all(f <= 0.0, axis=-1)


def _estimate_by_bsdf(scene, i, hit, params, u_bsdf, active, mis: bool):
    """BSDF-sampled direct light for light i (ky.cpp:3889-3930 / 3968-4033).

    active already excludes delta-BSDF lanes (skip_specular) and misses.
    """
    kind = scene.lights.kinds[i]
    if klights.is_delta_light(kind):
        return jnp.zeros_like(hit.position)

    bs = kbsdf.sample_world(params, hit.normal, hit.wo, u_bsdf)
    wi = _sg(bs.wi)
    pdf_b = _sg(bs.pdf)
    f_cos = bs.f * km.absdot(wi, hit.normal)[:, None]
    ok = active & ~_black(f_cos) & (pdf_b > 0.0)

    o = kshapes.offset_ray_origin(hit.position, hit.normal, wi)
    h2 = kscene.intersect(scene, o, wi)
    li_hit = jnp.where((h2.light_index == i)[:, None], h2.emission, 0.0)
    if kind == klights.ENV:
        li_miss = scene.env_radiance(wi.shape[0])
    else:
        li_miss = jnp.zeros_like(li_hit)
    li = jnp.where(h2.valid[:, None], li_hit, li_miss)
    ok = ok & ~_black(li)

    if mis:
        pdf_l = _sg(klights.pdf_li(scene.lights, i, hit.position, hit.normal, wi))
        w = jnp.where(pdf_l > 0.0,
                      km.safe_div(2.0, pdf_b + pdf_l), 0.0)
        ld = f_cos * li * w[:, None]
    else:
        ld = f_cos * li * km.safe_div(1.0, pdf_b)[:, None]
    return jnp.where(ok[:, None], ld, 0.0)


def _estimate_by_emitter(scene, i, hit, params, u_light, active, mis: bool,
                         shadow: str = "parity"):
    """Light-sampled direct light for light i (ky.cpp:3933-3962 / 4035-4074).

    shadow="parity" replicates the reference's self-occlusion quirk
    (tmax measured from the unoffset point, see kscene.occluded);
    "robust" measures tmax from the actual offset ray origin."""
    kind = scene.lights.kinds[i]
    ls = klights.sample_li(scene.lights, i, scene.world_radius,
                           hit.position, hit.normal, u_light)
    wi = _sg(ls.wi)
    pdf_l = _sg(ls.pdf)
    ok = active & ~_black(ls.li) & (pdf_l > 0.0)

    if shadow == "robust":
        o = kshapes.offset_ray_origin(hit.position, hit.normal, wi)
        dist = km.distance(o, ls.position)
        shadowed = kscene.occluded_from(scene, o, wi,
                                        dist - km.SHADOW_EPSILON,
                                        skip_row=scene.lights.surface_ids[i])
    else:
        dist = km.distance(hit.position, ls.position)
        shadowed = kscene.occluded(scene, hit.position, hit.normal, wi, dist)
    ok = ok & ~shadowed

    f_cos = kbsdf.eval_world(params, hit.normal, hit.wo, wi) \
        * km.absdot(wi, hit.normal)[:, None]
    ok = ok & ~_black(f_cos)

    if mis and not klights.is_delta_light(kind):
        pdf_b = _sg(kbsdf.pdf_world(params, hit.normal, hit.wo, wi))
        ld = 2.0 * f_cos * ls.li * km.safe_div(1.0, pdf_l + pdf_b)[:, None]
    else:
        ld = f_cos * ls.li * km.safe_div(1.0, pdf_l)[:, None]
    return jnp.where(ok[:, None], ld, 0.0)


def _estimate_one_light(scene, i, hit, params, u_light, u_bsdf, active,
                        strategy: str, shadow: str = "parity"):
    if strategy == "idle":
        return jnp.zeros_like(hit.position)
    if strategy == "bsdf":
        return _estimate_by_bsdf(scene, i, hit, params, u_bsdf, active, False)
    if strategy == "light":
        return _estimate_by_emitter(scene, i, hit, params, u_light, active,
                                    False, shadow)
    if strategy == "bsdf_mis":
        return _estimate_by_bsdf(scene, i, hit, params, u_bsdf, active, True)
    if strategy == "light_mis":
        return _estimate_by_emitter(scene, i, hit, params, u_light, active,
                                    True, shadow)
    if strategy == "both_mis":
        # Replicated reference QUIRK: for delta lights Lb is identically 0
        # (ky.cpp:3889-3892) yet the 0.5/0.5 combination still applies, so
        # both_mis halves point/directional light contributions relative to
        # the "light" strategy (ky.cpp:4076-4088). kytpu.integrator.fast
        # corrects this in the production path.
        # The reference passes the SAME draws to both halves (ky.cpp:4081-4082)
        lb = _estimate_by_bsdf(scene, i, hit, params, u_bsdf, active, True)
        ll = _estimate_by_emitter(scene, i, hit, params, u_light, active,
                                  True, shadow)
        return 0.5 * lb + 0.5 * ll
    raise ValueError(f"unknown strategy {strategy!r}")


def sample_all_lights(scene, hit, params, keys, active, strategy: str,
                      light_selection: str = "all", sampler: str = "random",
                      index=None, shadow: str = "parity"):
    """Direct lighting at the hit wavefront. Returns (N,3).

    `active` must already mask out misses and (for skip-specular semantics)
    delta-BSDF lanes. `keys` is the per-ray key array for this bounce's NEE.
    """
    n_lights = scene.n_lights
    if n_lights == 0 or strategy == "idle":
        return jnp.zeros_like(hit.position)

    if light_selection == "single":
        # VARIANCE-ONLY in the jnp engines: lights are heterogeneous
        # (point/direction/area-rect/area-sphere/env dispatch statically by
        # kind), so the selected light is evaluated by masking every light's
        # estimator — the variance is cut to one sample but the COST stays
        # O(L). Only the Pallas kernels' per-tile scalar pick realizes the
        # O(1) cost saving. (A per-lane parameter gather would need the
        # light types homogenized first.)
        k_sel, k_draw = krng.split_channels(keys, 2)
        u_sel = krng.uniform(k_sel, sampler=sampler, index=index)
        idx = jnp.minimum((u_sel * n_lights).astype(jnp.int32), n_lights - 1)
        k_l, k_b = krng.split_channels(k_draw, 2)
        u_light = krng.uniform2(k_l, sampler, index)
        u_bsdf = krng.uniform2(k_b, sampler, index)
        ld = jnp.zeros_like(hit.position)
        for i in range(n_lights):
            contrib = _estimate_one_light(
                scene, i, hit, params, u_light, u_bsdf,
                active & (idx == i), strategy, shadow)
            ld = ld + contrib
        return ld * float(n_lights)

    ld = jnp.zeros_like(hit.position)
    for i in range(n_lights):
        ki = krng.bounce_key(keys, 1000 + i)
        k_l, k_b = krng.split_channels(ki, 2)
        u_light = krng.uniform2(k_l, sampler, index)
        u_bsdf = krng.uniform2(k_b, sampler, index)
        ld = ld + _estimate_one_light(
            scene, i, hit, params, u_light, u_bsdf, active, strategy, shadow)
    return ld
