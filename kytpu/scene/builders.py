"""Scene factories: Cornell box, Veach MIS, smallpt spheres.

Parity targets: create_cornell_box_scene (ky.cpp:3240-3432) and
create_mis_scene (ky.cpp:3434-3533). Geometry/topology is assembled on the
host in numpy; material colors and light radiance flow through jnp so a
caller can pass traced overrides and differentiate the render with respect
to them (inverse rendering).

Documented deviation: the reference's Veach scene crosses two light/shape
bindings — the 901.803-radiance light is constructed on ball2's shape but
bound to ball1's surface, and vice versa for the 100-radiance light
(ky.cpp:3497-3528). That makes light-sampled and BSDF-sampled estimators
disagree on those two spheres. We bind them consistently by default
(radiance follows the surface binding: ball1 emits 901.803, ball2 emits 100,
each light sampling its own sphere); pass `replicate_reference_swap=True`
for bit-faithful reproduction of the reference's inconsistency.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from kytpu import bsdf as kbsdf
from kytpu.core import math as km
from kytpu.light import lights as klights
from kytpu.scene import scene as kscene
from kytpu.scene import shapes as kshapes
from kytpu.scene import texture as ktex

# cornell_box_enum_t flags (ky.cpp:3121-3145)
LIGHT_AREA = "light_area"
LIGHT_DIRECTION = "light_direction"
LIGHT_POINT = "light_point"
LIGHT_ENVIRONMENT = "light_environment"
LARGE_MIRROR_SPHERE = "large_mirror_sphere"
LARGE_GLASS_SPHERE = "large_glass_sphere"
SMALL_MIRROR_SPHERE = "small_mirror_sphere"
SMALL_GLASS_SPHERE = "small_glass_sphere"
BOTH_SMALL_SPHERES = frozenset({SMALL_MIRROR_SPHERE, SMALL_GLASS_SPHERE})
DEFAULT_SCENE = BOTH_SMALL_SPHERES | {LIGHT_AREA}


class _SceneAssembler:
    """Collects surfaces/materials/lights, then freezes a Scene pytree."""

    def __init__(self):
        self.geo = kshapes.GeometryBuilder()
        self._mats = []     # per surface: (kind, diffuse, specular, exp, eta)
        self._emission = []  # per surface: (3,) traced or ndarray
        self._light_of_surface = []  # per surface: light index or -1
        self._lights = []   # dicts
        self._textures = []  # dicts for scene/texture.build
        self._env = None

    # -- textures ----------------------------------------------------------
    def add_checker(self, color_a, color_b, scale=(1.0, 1.0)) -> int:
        """Procedural checkerboard texture; returns the texture slot to pass
        as `texture=` to a material. Colors are differentiable leaves."""
        self._textures.append(dict(kind=ktex.CHECKER, color_a=color_a,
                                   color_b=color_b, scale=scale))
        return len(self._textures) - 1

    def add_image_texture(self, image, scale=(1.0, 1.0)) -> int:
        """(H, W, 3) image texture, wrap-addressed bilinear; differentiable
        w.r.t. the texels. All images in one scene share a resolution."""
        self._textures.append(dict(kind=ktex.IMAGE, image=image, scale=scale))
        return len(self._textures) - 1

    # -- materials -------------------------------------------------------
    @staticmethod
    def matte(color, texture: int = -1):
        return dict(kind=kbsdf.MAT_MATTE, diffuse=color,
                    specular=jnp.zeros(3), exponent=0.0, eta=1.0,
                    texture=texture)

    @staticmethod
    def mirror(color):
        return dict(kind=kbsdf.MAT_MIRROR, diffuse=jnp.zeros(3),
                    specular=color, exponent=0.0, eta=1.0)

    @staticmethod
    def glass(eta, reflection=None, transmission=None):
        one = jnp.ones(3)
        return dict(kind=kbsdf.MAT_GLASS,
                    diffuse=one if transmission is None else transmission,
                    specular=one if reflection is None else reflection,
                    exponent=0.0, eta=eta)

    @staticmethod
    def plastic(diffuse, specular, shininess, texture: int = -1):
        return dict(kind=kbsdf.MAT_PLASTIC, diffuse=diffuse,
                    specular=specular, exponent=shininess, eta=1.0,
                    texture=texture)

    # -- surfaces ----------------------------------------------------------
    def surface(self, shape_handle: int, material: dict,
                emission=None, light_slot: int | None = None):
        """shape_handle is the GeometryBuilder insertion-order handle."""
        self._mats.append(material)
        self._emission.append(jnp.zeros(3) if emission is None else emission)
        self._light_of_surface.append(-1 if light_slot is None else light_slot)
        return shape_handle

    def reserve_light(self) -> int:
        self._lights.append(None)
        return len(self._lights) - 1

    def set_light(self, slot: int, **kw):
        self._lights[slot] = kw

    def add_light(self, **kw) -> int:
        self._lights.append(kw)
        return len(self._lights) - 1

    # -- freeze ------------------------------------------------------------
    def build(self, camera: kscene.Camera,
              accel: str | None = "auto") -> kscene.Scene:
        """accel: "grid" opts into the uniform-grid DDA accelerator
        (scene/accel.py), None disables it. "auto" (default) currently
        means None at every scale: the dense chunked sweep stays until a
        measurement shows a scale where the gather-based grid wins."""
        geometry, surf_ids = self.geo.build()
        n_surf = geometry.n_surfaces
        order = np.argsort(surf_ids)  # assembler order -> row order
        assert sorted(surf_ids) == list(range(n_surf)), \
            "every shape must be bound to exactly one surface"

        def row(i):
            return self._mats[order[i]]

        mat_kind = jnp.asarray(np.array(
            [row(i)["kind"] for i in range(n_surf)], np.int32))
        mat_diffuse = jnp.stack(
            [jnp.asarray(row(i)["diffuse"], jnp.float32) for i in range(n_surf)])
        mat_specular = jnp.stack(
            [jnp.asarray(row(i)["specular"], jnp.float32) for i in range(n_surf)])
        mat_exponent = jnp.asarray(np.array(
            [row(i)["exponent"] for i in range(n_surf)], np.float32))
        mat_eta = jnp.asarray(np.array(
            [row(i)["eta"] for i in range(n_surf)], np.float32))

        # plastic lobe probabilities from luminance (ky.cpp:2653-2658)
        dl = km.luminance(mat_diffuse)
        sl = km.luminance(mat_specular)
        tot = jnp.maximum(dl + sl, 1e-12)
        is_plastic = mat_kind == kbsdf.MAT_PLASTIC
        mat_d_prob = jnp.where(is_plastic, dl / tot, 1.0)
        mat_s_prob = jnp.where(is_plastic, sl / tot, 0.0)

        emission = jnp.stack(
            [jnp.asarray(self._emission[order[i]], jnp.float32)
             for i in range(n_surf)])
        light_index = jnp.asarray(np.array(
            [self._light_of_surface[order[i]] for i in range(n_surf)],
            np.int32))

        lights = self._freeze_lights(surf_ids)
        center, radius = self.geo.bounding_sphere()

        env = [l for l in self._lights if l["kind"] == klights.ENV]
        # texture binding (plastic lobe probabilities stay luminance-of-base:
        # the pick is a sampling choice, so a spatially-varying diffuse only
        # changes variance, not the estimator's expectation)
        tex_id = jnp.asarray(np.array(
            [row(i).get("texture", -1) for i in range(n_surf)], np.int32))
        return kscene.Scene(
            camera=camera, geometry=geometry,
            mat_kind=mat_kind, mat_diffuse=mat_diffuse,
            mat_specular=mat_specular, mat_exponent=mat_exponent,
            mat_eta=mat_eta, mat_d_prob=mat_d_prob, mat_s_prob=mat_s_prob,
            emission=emission, light_index=light_index, lights=lights,
            world_center=jnp.asarray(center, jnp.float32),
            world_radius=jnp.asarray(radius, jnp.float32),
            has_env=bool(env),
            env_radiance_=(jnp.asarray(env[0]["emit"], jnp.float32)
                           if env else jnp.zeros(3)),
            has_textures=bool(self._textures),
            tex_id=tex_id,
            textures=ktex.build(self._textures),
            accel=self._build_accel(geometry, accel),
        )

    @staticmethod
    def _build_accel(geometry, accel):
        from kytpu.scene import accel as kaccel
        if accel == "grid":
            return kaccel.build_grid(geometry)
        return None

    def _freeze_lights(self, surf_ids) -> klights.Lights:
        L = len(self._lights)
        z3 = np.zeros(3, np.float32)

        def get(l, k, default):
            v = l.get(k)
            return default if v is None else v

        kinds, sids = [], []
        emit, pos, dirn, p0, p1, p2, p3, nrm = [], [], [], [], [], [], [], []
        area, center, radius = [], [], []
        for l in self._lights:
            kinds.append(l["kind"])
            handle = l.get("surface_handle")
            sids.append(-1 if handle is None else surf_ids[handle])
            emit.append(jnp.asarray(l["emit"], jnp.float32))
            pos.append(get(l, "position", z3))
            dirn.append(get(l, "direction", z3))
            p0.append(get(l, "p0", z3))
            p1.append(get(l, "p1", z3))
            p2.append(get(l, "p2", z3))
            p3.append(get(l, "p3", z3))
            nrm.append(get(l, "normal", z3))
            area.append(get(l, "area", 0.0))
            center.append(get(l, "center", z3))
            radius.append(get(l, "radius", 0.0))

        def st(xs):
            if L == 0:
                return jnp.zeros((0, 3), jnp.float32)
            return jnp.stack([jnp.asarray(x, jnp.float32) for x in xs])

        def st1(xs):
            return jnp.asarray(np.array(xs, np.float32))

        return klights.Lights(
            kinds=tuple(kinds), surface_ids=tuple(sids),
            emit=st(emit), position=st(pos), direction=st(dirn),
            p0=st(p0), p1=st(p1), p2=st(p2), p3=st(p3), normal=st(nrm),
            area=st1(area), center=st(center), radius=st1(radius))


def _rect_light_params(pts, flip=False):
    """Canonical rect shape params for an area light (p0..p3, normal, area)."""
    q0, q1, q2, q3 = [np.asarray(p, np.float64) for p in pts]
    n = np.cross(q1 - q0, q2 - q0)
    n = n / np.linalg.norm(n)
    if flip:
        n = -n
    area = float(np.linalg.norm(np.cross(q0 - q1, q2 - q1)))
    return dict(p0=q0, p1=q1, p2=q2, p3=q3, normal=n, area=area)


# ---------------------------------------------------------------------------
# Cornell box (ky.cpp:3240-3432, SmallVCM-derived)
# ---------------------------------------------------------------------------


def cornell_box(flags=DEFAULT_SCENE, width: int = 256, height: int = 256,
                overrides: dict | None = None,
                floor_checker: bool = False,
                back_image=None) -> kscene.Scene:
    """flags: set of the LIGHT_*/SPHERE_* strings above.

    overrides: optional dict of traced leaves for inverse rendering —
    keys: 'white','red','green','blue','glossy_diffuse','glossy_specular',
    'light_radiance','env_radiance','point_intensity','dir_irradiance'
    (+ 'checker_a','checker_b' with floor_checker).

    Texture demos (beyond parity): floor_checker swaps the glossy floor for
    a checkered matte; back_image pastes an (H, W, 3) image texture on the
    back wall (the inverse-texture recovery target in cli/inverse).
    """
    flags = frozenset(flags)
    ov = overrides or {}
    if LARGE_MIRROR_SPHERE in flags and LARGE_GLASS_SPHERE in flags:
        raise ValueError("cannot set both large balls")

    cam = kscene.make_camera(
        position=(-0.0439815, 4.12529, 0.222539),
        front=(0.00688625, -0.998505, -0.0542161),
        up=(3.73896e-4, -0.0542148, 0.998529),
        fov_degrees=80.0, width=width, height=height)

    a = _SceneAssembler()
    m_black = a.matte(jnp.zeros(3))
    m_white = a.matte(ov.get("white", jnp.full(3, 0.8)))
    m_red = a.matte(ov.get("red", jnp.asarray([0.803922, 0.152941, 0.152941])))
    m_green = a.matte(ov.get("green", jnp.asarray([0.156863, 0.803922, 0.172549])))
    m_blue = a.matte(ov.get("blue", jnp.asarray([0.156863, 0.172549, 0.803922])))
    m_glossy = a.plastic(ov.get("glossy_diffuse", jnp.full(3, 0.1)),
                         ov.get("glossy_specular", jnp.full(3, 0.7)), 90.0)
    m_mirror = a.mirror(jnp.ones(3))
    m_glass = a.glass(1.6)
    if floor_checker:
        checker = a.add_checker(ov.get("checker_a", jnp.full(3, 0.73)),
                                ov.get("checker_b", jnp.full(3, 0.18)),
                                scale=(6.0, 6.0))
        m_glossy = a.matte(jnp.full(3, 0.73), texture=checker)
    if back_image is not None:
        tex = a.add_image_texture(back_image)
        m_blue = a.matte(jnp.full(3, 0.5), texture=tex)

    cb = np.array([
        [-1.27029, -1.30455, -1.28002],
        [ 1.28975, -1.30455, -1.28002],
        [ 1.28975, -1.30455,  1.28002],
        [-1.27029, -1.30455,  1.28002],
        [-1.27029,  1.25549, -1.28002],
        [ 1.28975,  1.25549, -1.28002],
        [ 1.28975,  1.25549,  1.28002],
        [-1.27029,  1.25549,  1.28002],
    ])
    g = a.geo
    a.surface(g.add_rectangle(cb[3], cb[0], cb[4], cb[7]), m_green)   # left
    a.surface(g.add_rectangle(cb[1], cb[2], cb[6], cb[5]), m_red)     # right
    a.surface(g.add_rectangle(cb[2], cb[3], cb[7], cb[6]), m_white)   # top
    a.surface(g.add_rectangle(cb[0], cb[1], cb[5], cb[4]), m_glossy)  # bottom
    a.surface(g.add_rectangle(cb[0], cb[3], cb[2], cb[1]), m_blue)    # back

    large_radius = 0.8
    large_center = (cb[0] + cb[4] + cb[5] + cb[1]) / 4.0 + np.array([0, 0, large_radius])
    small_radius = 0.5
    left_wall_center = (cb[0] + cb[4]) / 2.0 + np.array([0, 0, small_radius])
    right_wall_center = (cb[1] + cb[5]) / 2.0 + np.array([0, 0, small_radius])
    length_x = right_wall_center[0] - left_wall_center[0]
    left_center = left_wall_center + np.array([2.0 * length_x / 7.0, 0, 0])
    right_center = right_wall_center - np.array([2.0 * length_x / 7.0, 0, 0])

    if LARGE_MIRROR_SPHERE in flags:
        a.surface(g.add_sphere(large_center, large_radius), m_mirror)
    elif LARGE_GLASS_SPHERE in flags:
        a.surface(g.add_sphere(large_center, large_radius), m_glass)
    if SMALL_MIRROR_SPHERE in flags:
        a.surface(g.add_sphere(left_center, small_radius), m_mirror)
    if SMALL_GLASS_SPHERE in flags:
        a.surface(g.add_sphere(right_center, small_radius), m_glass)

    if LIGHT_AREA in flags:
        lb = np.array([
            [-0.25, -0.25, 1.26002],
            [ 0.25, -0.25, 1.26002],
            [ 0.25, -0.25, 1.28002],
            [-0.25, -0.25, 1.28002],
            [-0.25,  0.25, 1.26002],
            [ 0.25,  0.25, 1.26002],
            [ 0.25,  0.25, 1.28002],
            [-0.25,  0.25, 1.28002],
        ])
        a.surface(g.add_rectangle(lb[3], lb[7], lb[4], lb[0]), m_white)
        a.surface(g.add_rectangle(lb[1], lb[5], lb[6], lb[2]), m_white)
        a.surface(g.add_rectangle(lb[4], lb[7], lb[6], lb[5]), m_white)
        a.surface(g.add_rectangle(lb[0], lb[1], lb[2], lb[3]), m_white)
        radiance = ov.get("light_radiance", jnp.full(3, 25.0))
        bottom2_pts = (lb[0], lb[4], lb[5], lb[1])
        slot = a.add_light(kind=klights.AREA_RECT, emit=radiance,
                           surface_handle=None,  # filled below
                           **_rect_light_params(bottom2_pts))
        h = a.surface(g.add_rectangle(*bottom2_pts), m_black,
                      emission=radiance, light_slot=slot)
        a._lights[slot]["surface_handle"] = h

    if LIGHT_DIRECTION in flags:
        a.add_light(kind=klights.DIRECTION,
                    emit=ov.get("dir_irradiance", jnp.asarray([10.0, 4.0, 0.0])),
                    direction=np.array([-1.0, -1.5, -1.0])
                    / np.linalg.norm([-1.0, -1.5, -1.0]))

    if LIGHT_POINT in flags:
        intensity = ov.get("point_intensity",
                           jnp.full(3, 70.0 * km.INV_4PI))
        a.add_light(kind=klights.POINT, emit=intensity,
                    position=np.array([0.0, 0.5, 1.0]))

    if LIGHT_ENVIRONMENT in flags:
        env = ov.get("env_radiance",
                     jnp.asarray([135.0, 206.0, 250.0]) / 255.0)
        a.add_light(kind=klights.ENV, emit=env)

    return a.build(cam)


# ---------------------------------------------------------------------------
# Veach MIS scene (ky.cpp:3434-3533, mitsuba veach_mis port)
# ---------------------------------------------------------------------------


def veach_mis(width: int = 512, height: int = 308,
              overrides: dict | None = None,
              replicate_reference_swap: bool = False) -> kscene.Scene:
    ov = overrides or {}
    cam = kscene.make_camera(
        position=(0.0, 2.0, -15.0), front=(0.0, -4.0, 12.5),
        up=(0.0, 1.0, 0.0), fov_degrees=50.0, width=width, height=height)

    a = _SceneAssembler()
    m_black = a.matte(jnp.zeros(3))
    m_gray = a.matte(ov.get("gray", jnp.full(3, 0.4)))
    m_silver = a.plastic(
        ov.get("silver_diffuse", jnp.asarray([0.07, 0.09, 0.13])),
        ov.get("silver_specular", jnp.ones(3)), 5000.0)
    g = a.geo

    a.surface(g.add_rectangle((-10, -4.14615, 10), (-10, -4.14615, -10),
                              (10, -4.14615, -10), (10, -4.14615, 10),
                              flip_normal=True), m_gray)
    a.surface(g.add_rectangle((-10, -10, 2), (-10, 10, 2),
                              (10, 10, 2), (10, -10, 2),
                              flip_normal=True), m_gray)
    planks = [
        ((4, -2.70651, -0.25609), (4, -2.08375, 0.526323),
         (-4, -2.08375, 0.526323), (-4, -2.70651, -0.25609)),
        ((4, -3.28825, -1.36972), (4, -2.83856, -0.476536),
         (-4, -2.83856, -0.476536), (-4, -3.28825, -1.36972)),
        ((4, -3.73096, -2.70046), (4, -3.43378, -1.74564),
         (-4, -3.43378, -1.74564), (-4, -3.73096, -2.70046)),
        ((4, -3.99615, -4.0667), (4, -3.82069, -3.08221),
         (-4, -3.82069, -3.08221), (-4, -3.99615, -4.0667)),
    ]
    for pts in planks:
        a.surface(g.add_rectangle(*pts, flip_normal=True), m_silver)

    balls = [((10.0, 10.0, -4.0), 0.5), ((-3.75, 0.0, 0.0), 0.03333),
             ((-1.25, 0.0, 0.0), 0.1), ((1.25, 0.0, 0.0), 0.3),
             ((3.75, 0.0, 0.0), 0.9)]
    radiances = [800.0, 901.803, 100.0, 11.1111, 1.23457]
    # index of the sphere each light's *shape* samples; the reference
    # crosses lights 1 and 2 between ball1 and ball2 (see module docstring).
    shape_of_light = [0, 2, 1, 3, 4] if replicate_reference_swap \
        else [0, 1, 2, 3, 4]

    for i, ((c, r), rad) in enumerate(zip(balls, radiances)):
        emit = ov.get(f"light{i}_radiance", jnp.full(3, rad))
        sc, sr = balls[shape_of_light[i]]
        slot = a.add_light(kind=klights.AREA_SPHERE, emit=emit,
                           center=np.asarray(sc), radius=sr,
                           surface_handle=None)
        h = a.surface(g.add_sphere(c, r), m_black, emission=emit,
                      light_slot=slot)
        a._lights[slot]["surface_handle"] = h

    return a.build(cam)


# ---------------------------------------------------------------------------
# smallpt-style Cornell spheres (BASELINE.json config 1)
# ---------------------------------------------------------------------------


def smallpt(width: int = 256, height: int = 256,
            overrides: dict | None = None) -> kscene.Scene:
    """The classic 9-sphere smallpt Cornell box, scaled by 1/100 so the
    framework's fixed geometric epsilons (tuned for unit-scale scenes) hold
    in float32. Behavioral reference: smallpt2pbrt/smallpt.cpp:18-29 scene
    table (re-derived; radiance/albedo values are the published smallpt
    constants). The huge wall spheres exercise the numerically-stable
    quadratic in intersect_sphere.
    """
    ov = overrides or {}
    s = 0.01  # scene scale
    # smallpt advances every ray origin 140 units along its direction, which
    # places the effective pinhole inside the box; replicate with the central
    # direction so the camera isn't stuck behind the (black) front wall.
    front = np.array([0.0, -0.042612, -1.0])
    front = front / np.linalg.norm(front)
    pos = (np.array([50.0, 52.0, 295.6]) + 140.0 * front) * s
    cam = kscene.make_camera(
        position=pos,
        front=front,
        up=(0.0, 1.0, 0.0),
        fov_degrees=float(2.0 * np.degrees(np.arctan(0.5135 / 2.0))),
        width=width, height=height)

    a = _SceneAssembler()
    g = a.geo

    def sph(cx, cy, cz, r):
        return g.add_sphere((cx * s, cy * s, cz * s), r * s)

    m = _SceneAssembler
    a.surface(sph(1e5 + 1, 40.8, 81.6, 1e5), m.matte(jnp.asarray([0.75, 0.25, 0.25])))
    a.surface(sph(-1e5 + 99, 40.8, 81.6, 1e5), m.matte(jnp.asarray([0.25, 0.25, 0.75])))
    a.surface(sph(50, 40.8, 1e5, 1e5), m.matte(ov.get("back", jnp.full(3, 0.75))))
    a.surface(sph(50, 40.8, -1e5 + 170, 1e5), m.matte(jnp.zeros(3)))
    a.surface(sph(50, 1e5, 81.6, 1e5), m.matte(jnp.full(3, 0.75)))
    a.surface(sph(50, -1e5 + 81.6, 81.6, 1e5), m.matte(jnp.full(3, 0.75)))
    a.surface(sph(27, 16.5, 47, 16.5), m.mirror(jnp.full(3, 0.999)))
    a.surface(sph(73, 16.5, 78, 16.5), m.glass(1.5, jnp.full(3, 0.999),
                                               jnp.full(3, 0.999)))

    emit = ov.get("light_radiance", jnp.full(3, 12.0))
    c_l = (50 * s, (681.6 - 0.27) * s, 81.6 * s)
    r_l = 600 * s
    slot = a.add_light(kind=klights.AREA_SPHERE, emit=emit,
                       center=np.asarray(c_l), radius=r_l,
                       surface_handle=None)
    h = a.surface(g.add_sphere(c_l, r_l), m.matte(jnp.zeros(3)),
                  emission=emit, light_slot=slot)
    a._lights[slot]["surface_handle"] = h
    return a.build(cam)


def random_spheres(n: int = 100, width: int = 256, height: int = 256,
                   seed: int = 0, accel: str | None = "auto") -> kscene.Scene:
    """Procedural scene-scale stress scene: `n` spheres on a ground plane.

    Beyond parity (the reference has no accelerator and tops out at ~16
    surfaces per scene, ky.cpp:3097-3115 + 3240-3533). kytpu's closest-hit
    is a vectorized O(N) SoA sweep, which stays dense and branch-free to
    hundreds of surfaces; this factory provides arbitrary-N scenes for
    measuring that scaling (benchmarks/run.py --scale). Past 64 surfaces
    engine="pallas" routes to the table-driven kernel (O(1) compile in N);
    the baked megakernel's compile time grows with N.

    Layout: ray-marchable ground rectangle, `n` pseudo-random spheres
    (70% matte, 15% mirror, 10% glass, 5% glossy plastic), one sphere
    area light overhead, and a dim sky environment light.
    """
    rng = np.random.default_rng(seed)
    m = _SceneAssembler
    a = _SceneAssembler()
    g = a.geo

    # ground grows with n so rejection placement doesn't saturate
    half = max(12.0, 1.1 * float(np.sqrt(n)))
    a.surface(g.add_rectangle((-half, 0.0, -half), (-half, 0.0, half),
                              (half, 0.0, half), (half, 0.0, -half)),
              m.matte(jnp.full(3, 0.65)))

    # Poisson-ish placement: reject overlaps against accepted spheres
    placed = []
    tries = 0
    while len(placed) < n and tries < 40 * n:
        tries += 1
        r = float(rng.uniform(0.25, 0.7))
        x = float(rng.uniform(-half * 0.85, half * 0.85))
        z = float(rng.uniform(-half * 0.85, half * 0.85))
        if any((x - px) ** 2 + (z - pz) ** 2 < (r + pr + 0.05) ** 2
               for px, pz, pr in placed):
            continue
        placed.append((x, z, r))
    for x, z, r in placed:
        u = float(rng.uniform())
        col = jnp.asarray(rng.uniform(0.2, 0.95, 3).astype(np.float32))
        if u < 0.70:
            mat = m.matte(col)
        elif u < 0.85:
            mat = m.mirror(jnp.full(3, 0.95))
        elif u < 0.95:
            mat = m.glass(1.5)
        else:
            mat = m.plastic(col * 0.3, jnp.full(3, 0.6),
                            float(rng.uniform(30.0, 200.0)))
        a.surface(g.add_sphere((x, r, z), r), mat)

    emit = jnp.full(3, 40.0 * max(1.0, (half / 12.0) ** 2))
    c_l, r_l = (0.0, 1.2 * half, 0.0), 0.2 * half
    slot = a.add_light(kind=klights.AREA_SPHERE, emit=emit,
                       center=np.asarray(c_l), radius=r_l,
                       surface_handle=None)
    h = a.surface(g.add_sphere(c_l, r_l), m.matte(jnp.zeros(3)),
                  emission=emit, light_slot=slot)
    a._lights[slot]["surface_handle"] = h
    a.add_light(kind=klights.ENV, emit=jnp.asarray([0.15, 0.18, 0.25]))

    cam = kscene.make_camera(
        position=(0.0, 0.58 * half, 1.83 * half), front=(0.0, -0.28, -1.0),
        up=(0.0, 1.0, 0.0), fov_degrees=55.0, width=width, height=height)
    return a.build(cam, accel=accel)


def mesh_scene(verts, faces, material: dict | None = None,
               width: int = 256, height: int = 256, ground: bool = True,
               light_scale: float = 1.0,
               accel: str | None = "auto") -> kscene.Scene:
    """A triangle mesh on a ground plane under a sphere light + dim sky.

    Beyond parity (the reference has no mesh path; its triangle_t is placed
    one at a time, ky.cpp:1165-1242). (verts, faces) come from
    `scene/mesh.py` (icosphere/torus/load_obj) or any (V, 3)/(F, 3) pair
    with outward CCW winding. Each face becomes one one-sided triangle
    surface row, so the scene works in every engine: the chunked jnp
    sweeps at any size and the table-driven big-scene megakernel
    (kernels/bigscene.py) past 64 surfaces. Degenerate (zero-area) faces
    are dropped. The camera auto-frames the mesh bounds.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    if faces.size == 0:
        raise ValueError("mesh_scene: empty face list")
    m = _SceneAssembler
    a = _SceneAssembler()
    g = a.geo
    mat = m.plastic(jnp.asarray([0.20, 0.22, 0.26]),
                    jnp.asarray([0.5, 0.5, 0.5]), 64.0) \
        if material is None else material

    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    c = 0.5 * (lo + hi)
    extent = float(np.linalg.norm(hi - lo))
    extent = extent if extent > 0 else 1.0

    tri = verts[faces]                                    # (F, 3, 3)
    area2 = np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    kept = 0
    for f in range(len(faces)):
        if area2[f] <= 1e-12 * extent * extent:
            continue                                      # degenerate face
        a.surface(g.add_triangle(tri[f, 0], tri[f, 1], tri[f, 2]), mat)
        kept += 1
    if kept == 0:
        raise ValueError("mesh_scene: every face was degenerate")

    if ground:
        half = 2.5 * extent
        y0 = float(lo[1])
        a.surface(g.add_rectangle((c[0] - half, y0, c[2] - half),
                                  (c[0] - half, y0, c[2] + half),
                                  (c[0] + half, y0, c[2] + half),
                                  (c[0] + half, y0, c[2] - half)),
                  m.matte(jnp.full(3, 0.6)))

    emit = jnp.full(3, 28.0 * float(light_scale))
    c_l = (float(c[0] - 0.7 * extent), float(hi[1] + 1.4 * extent),
           float(c[2] + 0.5 * extent))
    r_l = 0.25 * extent
    slot = a.add_light(kind=klights.AREA_SPHERE, emit=emit,
                       center=np.asarray(c_l), radius=r_l,
                       surface_handle=None)
    h = a.surface(g.add_sphere(c_l, r_l), m.matte(jnp.zeros(3)),
                  emission=emit, light_slot=slot)
    a._lights[slot]["surface_handle"] = h
    a.add_light(kind=klights.ENV, emit=jnp.asarray([0.12, 0.14, 0.20]))

    cam = kscene.make_camera(
        position=(c[0], c[1] + 0.45 * extent, c[2] + 1.35 * extent),
        front=(0.0, -0.3, -1.0), up=(0.0, 1.0, 0.0),
        fov_degrees=45.0, width=width, height=height)
    return a.build(cam, accel=accel)
