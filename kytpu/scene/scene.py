"""Scene: geometry + per-surface material/light bindings + lights.

Data-parallel inversion of the reference's surface/scene layer
(ky.cpp:3068-3237): `surface_t` bound a BSDF and emission onto the
intersection at hit time via heap allocation (ky.cpp:3077-3088); here the
binding is a gather from dense per-surface tables indexed by the winning
surface row of the intersection argmin.

The Scene is a frozen pytree so it can flow through jit/grad/shard_map; all
differentiable quantities (material colors, emission, light radiance) are
leaves, while structural data (light kinds, counts) is static metadata so the
per-light NEE loop specializes at trace time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from kytpu.core import math as km
from kytpu.scene import accel as kaccel
from kytpu.scene import shapes as kshapes
from kytpu.scene import texture as ktex
from kytpu.light.lights import Lights


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Camera:
    """Perspective pinhole camera (ky.cpp:1859-1906, left-handed basis).

    right/up are pre-scaled by tan(fov/2) (and aspect) at build time.
    """

    position: jax.Array  # (3,)
    front: jax.Array     # (3,) unit
    right: jax.Array     # (3,) scaled
    up: jax.Array        # (3,) scaled
    width: int = field(metadata=dict(static=True), default=0)
    height: int = field(metadata=dict(static=True), default=0)


def make_camera(position, front, up, fov_degrees, width, height) -> Camera:
    import numpy as np

    position = np.asarray(position, np.float32)
    front = np.asarray(front, np.float64)
    front = front / np.linalg.norm(front)
    up0 = np.asarray(up, np.float64)
    up0 = up0 / np.linalg.norm(up0)
    tan_fov = np.tan(np.radians(fov_degrees) / 2.0)
    aspect = width / height
    right = np.cross(up0, front)
    right = right / np.linalg.norm(right) * tan_fov * aspect
    up_scaled = np.cross(front, right)
    up_scaled = up_scaled / np.linalg.norm(up_scaled) * tan_fov
    return Camera(
        position=jnp.asarray(position),
        front=jnp.asarray(front, jnp.float32),
        right=jnp.asarray(right, jnp.float32),
        up=jnp.asarray(up_scaled, jnp.float32),
        width=int(width),
        height=int(height),
    )


def generate_rays(cam: Camera, p_film):
    """p_film: (N, 2) continuous film coords in [0,W)x[0,H).

    direction = front + right*(x/W - 0.5) + up*(0.5 - y/H), normalized
    (ky.cpp:1884-1892).
    """
    sx = (p_film[:, 0] / cam.width - 0.5)[:, None]
    sy = (0.5 - p_film[:, 1] / cam.height)[:, None]
    d = cam.front[None] + sx * cam.right[None] + sy * cam.up[None]
    d = km.normalize(d)
    o = jnp.broadcast_to(cam.position[None], d.shape)
    return o, d


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Scene:
    camera: Camera
    geometry: kshapes.Geometry

    # per-surface tables, row-aligned with the global surface index
    mat_kind: jax.Array      # (M,) int32 in MAT_*
    mat_diffuse: jax.Array   # (M,3) matte albedo / plastic diffuse / glass transmission
    mat_specular: jax.Array  # (M,3) mirror & plastic specular / glass reflection
    mat_exponent: jax.Array  # (M,)
    mat_eta: jax.Array       # (M,)
    mat_d_prob: jax.Array    # (M,) plastic lobe probabilities
    mat_s_prob: jax.Array    # (M,)
    emission: jax.Array      # (M,3) area-light radiance (zeros otherwise)
    light_index: jax.Array   # (M,) int32 index into lights, -1 if none

    lights: Lights

    world_center: jax.Array  # (3,)
    world_radius: jax.Array  # ()

    has_env: bool = field(metadata=dict(static=True), default=False)
    env_radiance_: jax.Array | None = None  # (3,) when has_env

    # textures (beyond parity — the reference's texture region is an empty
    # stub, ky.cpp:2559-2563). tex_id maps surface row -> texture row (-1 =
    # untextured); has_textures is static so untextured scenes trace
    # zero texture code.
    has_textures: bool = field(metadata=dict(static=True), default=False)
    tex_id: jax.Array | None = None      # (M,) int32, -1 if none
    textures: "ktex.Textures | None" = None

    # optional uniform-grid accelerator (beyond parity — the reference's
    # accel_t is a stub, ky.cpp:3097-3115; see scene/accel.py). When set,
    # closest-hit/occlusion run the batched DDA instead of the O(N) sweep.
    accel: "kaccel.Grid | None" = None

    @property
    def n_lights(self) -> int:
        return len(self.lights.kinds)

    def diffuse_at(self, sid, uv):
        """Per-lane diffuse/transmission color: the mat_diffuse row,
        replaced by the bound texture's value where one exists."""
        base = self.mat_diffuse[sid]
        if not self.has_textures:
            return base
        tid = self.tex_id[sid]
        tv = ktex.eval_texture(self.textures, jnp.maximum(tid, 0), uv)
        return jnp.where((tid >= 0)[:, None], tv, base)

    def env_radiance(self, n: int):
        """Environment radiance for n rays (0 when the scene has no env
        light) — `scene_t::environment_lighting` (ky.cpp:3231-3237)."""
        if self.has_env:
            return jnp.broadcast_to(self.env_radiance_[None], (n, 3))
        return jnp.zeros((n, 3), jnp.float32)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Hit:
    """Batched surface interaction (the reference's isect_t, ky.cpp:642-692).

    All fields defined for every lane; `valid` masks real hits. Lanes that
    miss get sid=0 gathers — harmless garbage that downstream masks discard.
    """

    t: jax.Array          # (N,)
    valid: jax.Array      # (N,) bool
    position: jax.Array   # (N,3)
    normal: jax.Array     # (N,3) per-shape orientation rules applied
    wo: jax.Array         # (N,3) = -ray direction
    sid: jax.Array        # (N,) int32 global surface row
    emission: jax.Array   # (N,3) one-sided emitted radiance toward wo
    light_index: jax.Array  # (N,) int32 light id of the hit surface (-1)
    uv: jax.Array         # (N,2) texture coords (zeros in untextured scenes)


def intersect(scene: Scene, o, d, tmax=None) -> Hit:
    """Closest-hit over the whole scene + material/light binding."""
    n = o.shape[0]
    if tmax is None:
        tmax = jnp.full((n,), jnp.inf, o.dtype)
    if scene.accel is not None:
        t, sid, valid = kaccel.grid_closest_hit(
            scene.accel, scene.geometry, o, d, tmax)
    else:
        t, sid, valid = kshapes.closest_hit(scene.geometry, o, d, tmax)
    t_safe = jnp.where(valid, t, 1.0)
    position = o + t_safe[:, None] * d
    normal = kshapes.surface_normal(scene.geometry, sid, position, d)
    wo = -d
    # one-sided emission toward wo, evaluated with the (possibly flipped)
    # hit normal — matches area_light_t::areal_radiance at surface_t bind
    # time (ky.cpp:2957-2960 via 3084).
    radiance = scene.emission[sid]
    facing = km.dot(normal, wo) > 0.0
    emission = jnp.where((valid & facing)[:, None], radiance, 0.0)
    light_index = jnp.where(valid, scene.light_index[sid], -1)
    if scene.has_textures:
        uv = kshapes.surface_uv(scene.geometry, sid, position)
    else:
        uv = jnp.zeros((n, 2), o.dtype)
    return Hit(t=t, valid=valid, position=position, normal=normal, wo=wo,
               sid=sid, emission=emission, light_index=light_index, uv=uv)


def occluded(scene: Scene, position, normal, direction, dist):
    """Shadow query from a surface point (ky.cpp:3187-3206): offset origin,
    tmax = dist - 2e-3.

    Reference QUIRK (replicated for pixel parity): `dist` is measured from
    the UNOFFSET shading point while the ray traces from the offset origin
    (ky.cpp:614 + 3193), so the sampled light's own surface re-enters the
    [eps, dist - 2e-3] window whenever RAY_OFFSET*cos(theta) > 2e-3 — the
    light-sampled estimator self-occludes on surfaces facing the light
    frontally (n.wi > ~0.2). PathConfig/FastConfig/KernelConfig
    `shadow="robust"` opts out via `occluded_from` below."""
    o = kshapes.offset_ray_origin(position, normal, direction)
    tmax = dist - km.SHADOW_EPSILON
    if scene.accel is not None:
        return kaccel.grid_any_hit(scene.accel, scene.geometry, o,
                                   direction, tmax)
    return kshapes.any_hit(scene.geometry, o, direction, tmax)


def occluded_from(scene: Scene, o, direction, tmax, skip_row=None):
    """Shadow query with the caller's origin/tmax (the robust shadow mode:
    tmax measured from the actual offset origin AND the sampled light's own
    surface row excluded via skip_row, so a light can never self-occlude
    its NEE samples). The grid accelerator has no row exclusion, so robust
    shadow rays always use the SoA sweeps (shadow rays are a minority of a
    bounce's work; the grid is opt-in and measured slower anyway)."""
    if skip_row is None and scene.accel is not None:
        return kaccel.grid_any_hit(scene.accel, scene.geometry, o,
                                   direction, tmax)
    return kshapes.any_hit(scene.geometry, o, direction, tmax, skip_row)


def spawn_ray(position, normal, direction):
    """Offset continuation-ray origin (isect_t::spawn_ray, ky.cpp:665-668)."""
    return kshapes.offset_ray_origin(position, normal, direction)
