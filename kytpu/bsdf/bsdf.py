"""Vectorized BSDFs: Lambert, perfect mirror, Fresnel glass, modified Phong.

Data-parallel inversion of the reference's BSDF/material layers
(ky.cpp:1914-2686): instead of `material_t::scattering` heap-allocating a
virtual `bsdf_t` per hit (ky.cpp:3083), every ray lane carries a small
`BsdfParams` record (type id + colors + scalars) resolved from the hit
surface's material row. eval/pdf/sample compute all four models elementwise
and select by type id — pure elementwise code, no dispatch, no allocation.

Model parity targets (re-derived, not transcribed):
  - Lambert rho/pi, cosine-hemisphere sampling     (ky.cpp:2217-2268)
  - perfect mirror delta lobe f = R/|cos|, pdf = 1 (ky.cpp:2279-2316)
  - Fresnel glass: exact-Fresnel reflect probability, Russian-roulette
    branch between reflection and refraction       (ky.cpp:2337-2412)
  - modified Phong (Lafortune): rho (e+2)/2pi cos^e alpha, cosine-lobe
    sampling about the mirror direction            (ky.cpp:2477-2555)
  - materials: matte/mirror/glass/plastic with plastic's stochastic
    luminance-weighted lobe pick                   (ky.cpp:2566-2682)

Divergence from the reference (documented deviations):
  - Phong eval clamps cos_alpha to >= 0. The reference computes
    pow(cos_alpha, e) unclamped, which for its even integer-valued exponents
    is a positive denormal (~0) when cos_alpha < 0; jnp.power would yield NaN,
    so clamping reproduces the same value to within ~1e-27.
  - plastic's lobe pick draws from the ray's own fold_in stream instead of a
    process-global mt19937 shared across threads (a data race in the
    reference, ky.cpp:2663+2681).

Differentiability: sampled directions and pdfs are wrapped in stop_gradient
by the integrator (detached sampling); the throughput numerators (albedo,
reflectance, Fresnel factors) stay differentiable.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from kytpu.core import frame as kframe
from kytpu.core import math as km

# BSDF kinds (per-ray, after material resolution)
LAMBERT = 0
MIRROR = 1
GLASS = 2
PHONG = 3

# material kinds (per-surface table)
MAT_MATTE = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_PLASTIC = 3


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BsdfParams:
    """Per-ray-lane resolved BSDF (SoA over the batch)."""

    kind: jax.Array      # (N,) int32 in {LAMBERT, MIRROR, GLASS, PHONG}
    color: jax.Array     # (N,3) albedo / mirror reflectance / glass reflectance / phong specular
    color2: jax.Array    # (N,3) glass transmittance
    eta: jax.Array       # (N,) interior IOR (glass)
    exponent: jax.Array  # (N,) phong exponent


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BsdfSample:
    f: jax.Array          # (N,3) BSDF value (with delta-lobe 1/|cos| folding)
    wi: jax.Array         # (N,3) local or world depending on API level
    pdf: jax.Array        # (N,)
    delta: jax.Array      # (N,) bool — sampled lobe is specular (delta)


def is_delta(params: BsdfParams) -> jax.Array:
    return (params.kind == MIRROR) | (params.kind == GLASS)


def resolve_bsdf(mat_kind, diffuse, specular, exponent, eta,
                 d_prob, s_prob, u_lobe) -> BsdfParams:
    """Material row -> per-lane BSDF, with plastic's stochastic lobe pick.

    All args are gathered per-ray arrays; u_lobe: (N,) uniform draw.
    Plastic picks the Phong lobe with probability s_prob, scaling the chosen
    lobe's reflectance by 1/prob (ky.cpp:2661-2672).
    """
    pick_spec = u_lobe < s_prob
    plastic_kind = jnp.where(pick_spec, PHONG, LAMBERT)
    plastic_color = jnp.where(
        pick_spec[:, None],
        specular / jnp.maximum(s_prob, 1e-12)[:, None],
        diffuse / jnp.maximum(d_prob, 1e-12)[:, None],
    )

    kind = jnp.select(
        [mat_kind == MAT_MATTE, mat_kind == MAT_MIRROR, mat_kind == MAT_GLASS],
        [jnp.full_like(mat_kind, LAMBERT),
         jnp.full_like(mat_kind, MIRROR),
         jnp.full_like(mat_kind, GLASS)],
        plastic_kind,
    )
    color = jnp.select(
        [(mat_kind == MAT_MATTE)[:, None].repeat(3, -1),
         (mat_kind == MAT_MIRROR)[:, None].repeat(3, -1),
         (mat_kind == MAT_GLASS)[:, None].repeat(3, -1)],
        [diffuse, specular, specular],
        plastic_color,
    )
    return BsdfParams(kind=kind, color=color, color2=diffuse,
                      eta=eta, exponent=exponent)


# ---------------------------------------------------------------------------
# local-frame eval / pdf / sample (z = shading normal)
# ---------------------------------------------------------------------------


def _same_hemisphere(wo, wi):
    return wo[..., 2] * wi[..., 2] > 0


def _phong_lobe(wo, wi, exponent):
    """(eval_rgb_scale, pdf) of the modified-Phong lobe; color applied by
    caller. The cos^e factor is evaluated at cos clamped away from 0 and
    masked after, so d val/d exponent = val*log(cos) stays finite at
    grazing alpha (pow(0,e) has a nan exponent-cotangent) — exponent is a
    trainable parameter (diff.params)."""
    wr = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    cos_alpha = km.dot(wr, wi)
    cos_safe = jnp.maximum(cos_alpha, 1e-12)
    powa = jnp.power(cos_safe, exponent)
    front = _same_hemisphere(wo, wi) & (cos_alpha > 0.0)
    val = jnp.where(front, (exponent + 2.0) * km.INV_2PI * powa, 0.0)
    pdf = jnp.where(cos_alpha > 0.0,
                    (exponent + 1.0) * powa * km.INV_2PI, 0.0)
    return val, pdf


def eval_local(params: BsdfParams, wo, wi):
    """f(wo, wi) in the local frame. Delta lobes evaluate to 0."""
    same = _same_hemisphere(wo, wi)
    f_lambert = jnp.where(same[:, None], params.color * km.INV_PI, 0.0)
    phong_val, _ = _phong_lobe(wo, wi, params.exponent)
    f_phong = params.color * phong_val[:, None]
    f = jnp.select(
        [(params.kind == LAMBERT)[:, None].repeat(3, -1),
         (params.kind == PHONG)[:, None].repeat(3, -1)],
        [f_lambert, f_phong],
        jnp.zeros_like(f_lambert),
    )
    return f


def pdf_local(params: BsdfParams, wo, wi):
    """Solid-angle pdf. Note the reference's Phong pdf has NO same-hemisphere
    gate (ky.cpp:2502-2508) — replicated."""
    same = _same_hemisphere(wo, wi)
    pdf_lambert = jnp.where(
        same, km.cosine_hemisphere_pdf(jnp.abs(wi[..., 2])), 0.0)
    _, pdf_phong = _phong_lobe(wo, wi, params.exponent)
    return jnp.select(
        [params.kind == LAMBERT, params.kind == PHONG],
        [pdf_lambert, pdf_phong],
        jnp.zeros_like(pdf_lambert),
    )


def _phong_cosine_lobe_sample(u, exponent):
    phi = km.TWO_PI * u[..., 0]
    cos_theta = jnp.power(u[..., 1], 1.0 / (exponent + 1.0))
    sin_theta = km.safe_sqrt(1.0 - cos_theta * cos_theta)
    return jnp.stack(
        [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta],
        axis=-1)


def sample_local(params: BsdfParams, wo, u2) -> BsdfSample:
    """Sample wi ~ the lobe; returns f, wi, pdf, delta-flag (all (N,...)).

    Computes every model's sample and selects by kind — the data-parallel equivalent of
    virtual dispatch. The glass branch consumes u2[...,0] as its
    reflect/refract Russian-roulette draw (ky.cpp:2375).
    """
    n = wo.shape[0]
    mirror_wi = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)

    # --- Lambert ---
    wi_lam = km.cosine_hemisphere_sample(u2)
    wi_lam = jnp.where(
        (wo[..., 2] < 0)[:, None],
        wi_lam * jnp.array([1.0, 1.0, -1.0], wo.dtype), wi_lam)
    same_lam = _same_hemisphere(wo, wi_lam)
    f_lam = jnp.where(same_lam[:, None], params.color * km.INV_PI, 0.0)
    pdf_lam = jnp.where(
        same_lam, km.cosine_hemisphere_pdf(jnp.abs(wi_lam[..., 2])), 0.0)

    # --- mirror ---
    abs_cos_m = jnp.maximum(jnp.abs(mirror_wi[..., 2]), 1e-12)
    f_mir = params.color / abs_cos_m[:, None]
    pdf_mir = jnp.ones(n, wo.dtype)

    # --- glass ---
    fr = km.fresnel_dielectric(wo[..., 2], jnp.ones_like(params.eta), params.eta)
    take_reflect = u2[..., 0] < fr
    into = wo[..., 2] > 0
    n_loc = jnp.where(
        into[:, None],
        jnp.array([0.0, 0.0, 1.0], wo.dtype),
        jnp.array([0.0, 0.0, -1.0], wo.dtype))
    eta_ratio = jnp.where(into, 1.0 / params.eta, params.eta)
    wt, refr_ok = km.refract(wo, n_loc, eta_ratio)
    wi_gl = jnp.where(take_reflect[:, None], mirror_wi, wt)
    abs_cos_g = jnp.maximum(jnp.abs(wi_gl[..., 2]), 1e-12)
    f_refl = params.color * (fr / abs_cos_g)[:, None]
    f_refr = params.color2 * ((1.0 - fr) / abs_cos_g)[:, None]
    f_gl = jnp.where(take_reflect[:, None], f_refl,
                     jnp.where(refr_ok[:, None], f_refr, 0.0))
    pdf_gl = jnp.where(take_reflect, fr,
                       jnp.where(refr_ok, 1.0 - fr, 0.0))

    # --- phong ---
    # detached sampling: the sample MAP u->wi must not carry the exponent's
    # gradient (f/pdf is differentiated at fixed samples; a wi that moves
    # with the exponent would add an uncorrected reparameterization term)
    lobe = _phong_cosine_lobe_sample(
        u2, jax.lax.stop_gradient(params.exponent))
    wr = mirror_wi  # reflect(wo, z)
    s, t, nf = kframe.make_frame(wr)
    wi_ph = kframe.to_world(s, t, nf, lobe)
    wi_ph = jnp.where(
        (wo[..., 2] < 0)[:, None],
        wi_ph * jnp.array([1.0, 1.0, -1.0], wo.dtype), wi_ph)
    ph_val, pdf_ph = _phong_lobe(wo, wi_ph, params.exponent)
    f_ph = params.color * ph_val[:, None]

    kinds = params.kind
    sel3 = lambda k: (kinds == k)[:, None].repeat(3, -1)  # noqa: E731
    wi = jnp.select([sel3(LAMBERT), sel3(MIRROR), sel3(GLASS)],
                    [wi_lam, mirror_wi, wi_gl], wi_ph)
    f = jnp.select([sel3(LAMBERT), sel3(MIRROR), sel3(GLASS)],
                   [f_lam, f_mir, f_gl], f_ph)
    pdf = jnp.select([kinds == LAMBERT, kinds == MIRROR, kinds == GLASS],
                     [pdf_lam, pdf_mir, pdf_gl], pdf_ph)
    delta = (kinds == MIRROR) | (kinds == GLASS)
    return BsdfSample(f=f, wi=wi, pdf=pdf, delta=delta)


# ---------------------------------------------------------------------------
# world-frame wrappers (the reference's bsdf_t world<->local shim,
# ky.cpp:2147-2210)
# ---------------------------------------------------------------------------


def eval_world(params: BsdfParams, normal, wo_world, wi_world):
    s, t, n = kframe.make_frame(normal)
    return eval_local(params,
                      kframe.to_local(s, t, n, wo_world),
                      kframe.to_local(s, t, n, wi_world))


def pdf_world(params: BsdfParams, normal, wo_world, wi_world):
    s, t, n = kframe.make_frame(normal)
    return pdf_local(params,
                     kframe.to_local(s, t, n, wo_world),
                     kframe.to_local(s, t, n, wi_world))


def eval_and_pdf_world(params: BsdfParams, normal, wo_world, wi_world):
    s, t, n = kframe.make_frame(normal)
    wo = kframe.to_local(s, t, n, wo_world)
    wi = kframe.to_local(s, t, n, wi_world)
    return eval_local(params, wo, wi), pdf_local(params, wo, wi)


def sample_world(params: BsdfParams, normal, wo_world, u2) -> BsdfSample:
    s, t, n = kframe.make_frame(normal)
    smp = sample_local(params, kframe.to_local(s, t, n, wo_world), u2)
    return BsdfSample(f=smp.f, wi=kframe.to_world(s, t, n, smp.wi),
                      pdf=smp.pdf, delta=smp.delta)
