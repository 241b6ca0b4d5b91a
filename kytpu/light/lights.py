"""Lights: point / directional / area (rect, sphere) / constant environment.

Data-parallel inversion of the reference's light hierarchy (ky.cpp:2690-3064):
lights live in one SoA table whose *kinds* are static metadata, so the
per-light NEE loop (at most a handful of lights) unrolls at trace time into
kind-specialized vector code with zero dynamic dispatch.

Parity targets (re-derived):
  - point light Li = I/d^2, pdf 1                    (ky.cpp:2825-2853)
  - directional light Li = E, virtual position at 2*world_radius
    (ky.cpp:2891-2901), world sphere from preprocess (ky.cpp:3555-3563)
  - area light: one-sided radiance (ky.cpp:2957-2960); sample via the
    shape's solid-angle sampling (rect: bilinear position + area->solid-angle
    conversion, ky.cpp:1028-1051+1307-1315; sphere: uniform-cone with Taylor
    fallback, ky.cpp:1419-1513)
  - environment light: uniform-sphere direction with the reference's
    1/(2 pi^2 sin(theta)) pdf                        (ky.cpp:3026-3052)

Quirk replicated intentionally: the reference's inside-a-sphere-light
solid-angle conversion divides by |dot(shade_normal, -wi)| rather than the
light-surface normal (ky.cpp:1436); we reproduce that to stay estimator-
equivalent.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from kytpu.core import frame as kframe
from kytpu.core import math as km

POINT = 0
DIRECTION = 1
AREA_RECT = 2
AREA_SPHERE = 3
ENV = 4


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Lights:
    """SoA light table; row i is light i. kinds/surface_ids are static."""

    kinds: tuple = field(metadata=dict(static=True), default=())
    surface_ids: tuple = field(metadata=dict(static=True), default=())

    emit: jax.Array = None       # (L,3) intensity I / irradiance E / radiance L
    position: jax.Array = None   # (L,3) point-light position
    direction: jax.Array = None  # (L,3) directional-light direction (unit)
    # area-rect shape params
    p0: jax.Array = None         # (L,3)
    p1: jax.Array = None
    p2: jax.Array = None
    p3: jax.Array = None
    normal: jax.Array = None     # (L,3) canonical rect normal
    area: jax.Array = None       # (L,)
    # area-sphere shape params
    center: jax.Array = None     # (L,3)
    radius: jax.Array = None     # (L,)


def is_delta_light(kind: int) -> bool:
    return kind in (POINT, DIRECTION)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class LightSample:
    position: jax.Array  # (N,3) point on/toward the light
    wi: jax.Array        # (N,3) unit, shade point -> light
    pdf: jax.Array       # (N,) solid-angle pdf
    li: jax.Array        # (N,3) incident radiance


def _rect_sample(p0, p1, p2, n_l, area, radiance, p, u2) -> LightSample:
    light_pos = p1[None] + u2[:, 0:1] * (p0 - p1)[None] + u2[:, 1:2] * (p2 - p1)[None]
    wi_vec = light_pos - p
    d2 = km.length_squared(wi_vec)
    wi = km.safe_normalize(wi_vec)
    cos_l = km.absdot(jnp.broadcast_to(n_l[None], wi.shape), -wi)
    pdf = km.safe_div(d2, cos_l * area)
    pdf = jnp.where(jnp.isfinite(pdf) & (d2 > 0), pdf, 0.0)
    facing = km.dot(n_l[None], -wi) > 0.0
    li = jnp.where((facing & (pdf > 0))[:, None], radiance[None], 0.0)
    return LightSample(position=light_pos, wi=wi, pdf=pdf, li=li)


def _sphere_sample(center, radius, radiance, p, n_shade, u2) -> LightSample:
    c = center[None]
    d2c = km.distance_squared(p, c)
    inside = d2c <= radius * radius

    # --- outside: uniform cone toward the sphere (ky.cpp:1445-1500) ---
    dist = jnp.sqrt(jnp.maximum(d2c, 1e-20))
    inv_dist = 1.0 / dist
    sin_max = radius * inv_dist
    sin2_max = sin_max * sin_max
    inv_sin_max = km.safe_div(1.0, sin_max, 1.0)
    cos_max = km.safe_sqrt(1.0 - sin2_max)

    cos_theta = (cos_max - 1.0) * u2[:, 0] + 1.0
    sin2 = 1.0 - cos_theta * cos_theta
    # Taylor fallback for tiny subtended angles (ky.cpp:1470-1476)
    tiny = sin2_max < 0.00068523
    sin2 = jnp.where(tiny, sin2_max * u2[:, 0], sin2)
    cos_theta = jnp.where(tiny, km.safe_sqrt(1.0 - sin2), cos_theta)

    cos_alpha = sin2 * inv_sin_max + cos_theta * km.safe_sqrt(
        1.0 - sin2 * inv_sin_max * inv_sin_max)
    sin_alpha = km.safe_sqrt(1.0 - cos_alpha * cos_alpha)
    phi = u2[:, 1] * km.TWO_PI

    to_c = (c - p) * inv_dist[:, None]
    s, t, nf = kframe.make_frame(to_c)
    n_cone = km.spherical_to_direction_in_frame(
        sin_alpha, cos_alpha, phi, -s, -t, -nf)
    pos_cone = c + radius * n_cone
    # 1 - cos_max without cancellation (sin2 / (1 + cos)): the naive
    # difference keeps ~2 significant digits for small, distant lights
    pdf_cone = km.safe_div(1.0, km.TWO_PI * sin2_max / (1.0 + cos_max))
    pdf_cone = jnp.where(jnp.isfinite(pdf_cone), pdf_cone, 0.0)

    # --- inside: uniform area sample (ky.cpp:1422-1443) ---
    dir_u = km.uniform_sphere_sample(u2)
    pos_in = c + radius * dir_u
    wi_in_vec = pos_in - p
    d2_in = km.length_squared(wi_in_vec)
    wi_in = km.safe_normalize(wi_in_vec)
    area = 4.0 * km.PI * radius * radius
    # reference divides by |dot(SHADE normal, -wi)| here (ky.cpp:1436)
    pdf_in = km.safe_div(d2_in, area * km.absdot(n_shade, -wi_in))
    pdf_in = jnp.where(jnp.isfinite(pdf_in) & (d2_in > 0), pdf_in, 0.0)

    pos = jnp.where(inside[:, None], pos_in, pos_cone)
    n_l = jnp.where(inside[:, None], dir_u, n_cone)
    pdf = jnp.where(inside, pdf_in, pdf_cone)
    wi = km.safe_normalize(pos - p)
    facing = km.dot(n_l, -wi) > 0.0
    li = jnp.where((facing & (pdf > 0))[:, None], radiance[None], 0.0)
    return LightSample(position=pos, wi=wi, pdf=pdf, li=li)


def sample_li(lights: Lights, i: int, world_radius, p, n_shade, u2) -> LightSample:
    """Sample a direction to light i from shade points p (N,3).

    i and the light kind are Python-static; each call compiles to that
    light's specialized sampler.
    """
    kind = lights.kinds[i]
    n = p.shape[0]
    radiance = lights.emit[i]

    if kind == POINT:
        lp = lights.position[i][None]
        wi = km.safe_normalize(lp - p)
        li = radiance[None] / jnp.maximum(km.distance_squared(lp, p), 1e-20)[:, None]
        return LightSample(position=jnp.broadcast_to(lp, (n, 3)), wi=wi,
                           pdf=jnp.ones(n, p.dtype), li=li)

    if kind == DIRECTION:
        wi = jnp.broadcast_to(-lights.direction[i][None], (n, 3))
        pos = p + wi * (2.0 * world_radius)
        li = jnp.broadcast_to(radiance[None], (n, 3))
        return LightSample(position=pos, wi=wi, pdf=jnp.ones(n, p.dtype), li=li)

    if kind == AREA_RECT:
        return _rect_sample(lights.p0[i], lights.p1[i], lights.p2[i],
                            lights.normal[i], lights.area[i], radiance, p, u2)

    if kind == AREA_SPHERE:
        return _sphere_sample(lights.center[i], lights.radius[i], radiance,
                              p, n_shade, u2)

    if kind == ENV:
        # Replicated reference QUIRK (ky.cpp:3029-3035): the direction is
        # uniform on the sphere (density 1/4pi) but the reported pdf is the
        # angle-space density 1/(2 pi^2 sin theta). The mismatch biases the
        # light-sampled env estimator exactly as the reference's does;
        # kept for estimator-level parity (see tests/test_lights.py).
        wi = km.uniform_sphere_sample(u2)
        sin_theta = jnp.sin(km.spherical_theta(wi))
        pdf = jnp.where(sin_theta == 0.0, 0.0,
                        1.0 / (2.0 * km.PI * km.PI * jnp.maximum(sin_theta, 1e-20)))
        pos = p + wi * (2.0 * world_radius)
        li = jnp.broadcast_to(radiance[None], (n, 3))
        return LightSample(position=pos, wi=wi, pdf=pdf, li=li)

    raise ValueError(f"unknown light kind {kind}")


def _rect_reintersect_pdf(p0, p1, p2, p3, n_l, area, p, n_shade, wi):
    """shape_t::pdf_direction for a single rectangle (ky.cpp:1055-1090):
    spawn an offset ray, intersect only this rect, convert area->solid angle.
    """
    o = km.offset_ray_origin(p, n_shade, wi)
    oa = p0[None] - o
    ob = p1[None] - o
    oc = p2[None] - o
    od = p3[None] - o
    v0d = km.dot(jnp.cross(oc, ob), wi)
    v1d = km.dot(jnp.cross(ob, oa), wi)
    v2d = km.dot(jnp.cross(oa, od), wi)
    v3d = km.dot(jnp.cross(od, oc), wi)
    inside = ((v0d < 0) & (v1d < 0) & (v2d < 0) & (v3d < 0)) | \
             ((v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0))
    denom = km.dot(jnp.broadcast_to(n_l[None], wi.shape), wi)
    t = km.safe_div(km.dot(n_l[None], oa), denom, jnp.inf)
    hit = inside & (t > km.SHAPE_EPSILON) & jnp.isfinite(t)
    hit_p = o + t[:, None] * wi
    d2 = km.distance_squared(p, hit_p)
    pdf = km.safe_div(d2, km.absdot(n_l[None], -wi) * area)
    pdf = jnp.where(hit & jnp.isfinite(pdf), pdf, 0.0)
    return pdf


def _sphere_reintersect_pdf(center, radius, p, n_shade, wi):
    """Generic re-intersect pdf for shade points inside the sphere."""
    o = km.offset_ray_origin(p, n_shade, wi)
    oc = center[None] - o
    neg_b = km.dot(oc, wi)
    discr = neg_b * neg_b - km.length_squared(oc) + radius * radius
    sq = km.safe_sqrt(discr)
    t1, t2 = neg_b - sq, neg_b + sq
    t1_ok = t1 > km.SHAPE_EPSILON
    t2_ok = t2 > km.SHAPE_EPSILON
    t = jnp.where(t1_ok, t1, t2)
    hit = (discr >= 0) & (t1_ok | t2_ok)
    hit_p = o + t[:, None] * wi
    n_hit = km.safe_normalize(hit_p - center[None])
    area = 4.0 * km.PI * radius * radius
    pdf = km.safe_div(km.distance_squared(p, hit_p),
                      km.absdot(n_hit, -wi) * area)
    return jnp.where(hit & jnp.isfinite(pdf), pdf, 0.0)


def pdf_li(lights: Lights, i: int, p, n_shade, wi):
    """Solid-angle pdf of light i for direction wi from shade points p —
    light_t::pdf_Li (used by the BSDF-side MIS weight)."""
    kind = lights.kinds[i]
    n = p.shape[0]

    if kind in (POINT, DIRECTION):
        return jnp.zeros(n, p.dtype)

    if kind == AREA_RECT:
        return _rect_reintersect_pdf(
            lights.p0[i], lights.p1[i], lights.p2[i], lights.p3[i],
            lights.normal[i], lights.area[i], p, n_shade, wi)

    if kind == AREA_SPHERE:
        c, r = lights.center[i], lights.radius[i]
        d2c = km.distance_squared(p, c[None])
        inside = d2c <= r * r
        sin2_max = km.safe_div(r * r, d2c, 1.0)
        cos_max = km.safe_sqrt(1.0 - sin2_max)
        pdf_cone = km.safe_div(1.0, km.TWO_PI * sin2_max / (1.0 + cos_max))
        pdf_cone = jnp.where(jnp.isfinite(pdf_cone), pdf_cone, 0.0)
        pdf_in = _sphere_reintersect_pdf(c, r, p, n_shade, wi)
        return jnp.where(inside, pdf_in, pdf_cone)

    if kind == ENV:
        sin_theta = jnp.sin(km.spherical_theta(wi))
        return jnp.where(
            sin_theta == 0.0, 0.0,
            1.0 / (2.0 * km.PI * km.PI * jnp.maximum(sin_theta, 1e-20)))

    raise ValueError(f"unknown light kind {kind}")


def light_power(lights: Lights, i: int, world_radius):
    """Total emitted power (ky.cpp:2822, 2930, 3555-3574)."""
    kind = lights.kinds[i]
    e = lights.emit[i]
    if kind == POINT:
        return 4.0 * km.PI * e
    if kind == DIRECTION:
        return e * (km.PI * world_radius * world_radius)
    if kind == AREA_RECT:
        return e * lights.area[i] * km.PI
    if kind == AREA_SPHERE:
        r = lights.radius[i]
        return e * (4.0 * km.PI * r * r) * km.PI
    if kind == ENV:
        return e * (km.PI * world_radius * world_radius)
    raise ValueError(f"unknown light kind {kind}")
