"""Fused Pallas wavefront path-tracing megakernel (Pallas through Triton).

The entire bounce loop of the production integrator
(kytpu/integrator/fast.py) runs inside ONE pallas_call: ray state stays in
registers as (R, 128) component planes for the whole path — no HBM traffic
between bounces — while XLA's op-by-op execution of the jnp formulation
round-trips every intermediate through HBM.

Design:
  - lanes are (R, 128) planes; each 3-vector is three planes (kernels/v3.py)
  - scene GEOMETRY is baked into the instruction stream as python-float
    constants (one compiled kernel per scene geometry — the Embree/OptiX
    "compiled scene" model); the static surface loop replaces both the
    reference's virtual shape dispatch (ky.cpp:1009) and the jnp path's
    (N, S) broadcast sweep
  - MATERIAL/EMISSION color tables are small global arrays read as scalars
    (L1/L2-resident), so renders stay parameterized for inverse rendering
    without recompiles
  - per-surface record selection is a static masked-sum loop; image
    textures are fetched with 4 gathered loads per channel
  - RNG is a stateless integer hash keyed by (seed, tile, lane, draw site)
    or, for the "hash"/"sobol" samplers, by (seed, pixel, sample, site);
    draw order is fixed by the static program, so images are reproducible
    and interpret mode on the CPU draws the same streams as the GPU
  - programs run in parallel in no order: adjoints are reduced over each
    block's lanes in-kernel, written as one row per program of a
    (grid, P) partial table, and summed over the grid in XLA

The estimator is the same single-sample-MIS transport as fast.py (emission
MIS-weighted against the light pdf of the ray that found it; light-side NEE
per light, or one uniformly-picked light with KernelConfig(nee="single");
iteration-rule Russian roulette), so the kernel converges to the same
image; only the RNG stream differs. tests/test_kernel.py checks both
against each other.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from kytpu import bsdf as kbsdf
from kytpu.core import math as km
from kytpu.kernels.v3 import V3, make_frame, to_local, to_world, v3_full, v3_zeros
from kytpu.light import lights as klights
from kytpu.scene import shapes as kshapes

LANE = 128


@dataclass(frozen=True)
class KernelConfig:
    max_depth: int = 5
    rr_start: int = 3
    # lanes per program = rows * 128; a power of two (Triton blocks). The
    # GPU default keeps about one lane per thread at NUM_WARPS warps, so
    # the bounce loop's ray state stays in registers
    rows: int = 1
    nee: str = "all"        # "all" lights per vertex | "single" uniform pick
    # "random": stateless integer hash keyed by (seed, program id, lane
    # position in the block, draw site).
    # "sobol": in-kernel hash-based Owen-scrambled (0,2)-sequence (Burley,
    # JCGT 2020) — the kernel takes two extra int32 lane planes
    # (sample index, pixel id); every draw site gets an independently
    # shuffled+scrambled copy of the first two Sobol dimensions. Pure int
    # arithmetic, so interpret mode == GPU bitwise.
    # "hash": stateless lowbias32 streams keyed by (seed, pixel id, sample
    # id, draw site) — same extra lane planes as sobol. Every draw is
    # independent of where the lane sits in the launch, so renders are
    # invariant to pass chunking AND to the device-mesh shape (the sharded
    # renderers' default; dist/shard.py).
    sampler: str = "random"
    # "parity" replicates the reference's shadow-ray self-occlusion quirk
    # (tmax measured from the unoffset shading point, ky.cpp:3193 + 614 —
    # see extract_static's NB and kytpu.scene.scene.occluded); "robust"
    # shortens each NEE tmax by the origin offset's along-ray component so
    # a light's own surface never occludes its own samples (physically
    # correct; deviates from reference renders)
    shadow: str = "parity"
    # Phong exponents become a traced table instead of baked
    # constants: the diff tracer takes an exponent argument and returns its
    # gradient (replay and residual backwards). Costs the _ipow
    # static-exponent fast path, so it is off for the pure-render/bench
    # configurations.
    trainable_exponent: bool = False
    # Table-kernel (bigscene) geometry culling. "cone": per-sweep the tile
    # computes its rays' bounding cone (scalar reductions), and each
    # Morton-sorted UNROLL-row block is skipped via lax.cond when its
    # bounding sphere cannot meet the cone — exact-conservative, so
    # renders are bitwise identical to "off". The baked kernel ignores it.
    cull: str = "cone"          # "cone" | "cone+nee" | "off"


# warps per program: with rows=1 a 128-lane block gives each thread one
# lane, the register-resident layout the bounce loop is written for
NUM_WARPS = 4


def pallas_call(kernel, *, interpret: bool, name: str, **kw):
    """pl.pallas_call through Triton (interpret=True runs Pallas' generic
    interpreter, on the CPU in the tests)."""
    return pl.pallas_call(
        kernel, backend="triton", interpret=bool(interpret), name=name,
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        **kw)


def resolve_interpret(interpret) -> bool:
    """An explicit interpret flag as given; None means interpret exactly
    when JAX's default backend is the CPU (where Pallas has no compiler).
    Never chosen from the device kind, and never a fallback."""
    if interpret is None:
        return jax.default_backend() == "cpu"
    return bool(interpret)


def pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def store_partials(ref, planes):
    """Write each plane's sum over the block's lanes into this program's
    row of a (grid, pow2_at_least(len(planes))) partial table. Programs
    run in parallel, so per-program rows summed over the grid in XLA take
    the place of a cross-program accumulator."""
    for k, v in enumerate(planes):
        ref[0, k] = jnp.sum(v)


def sum_partials(parts, n: int):
    """(grid, P_pad) partial table -> the (n,) grid-summed adjoints (the
    padding columns are never written)."""
    return parts[:, :n].sum(axis=0)


# ---------------------------------------------------------------------------
# static scene extraction (host side; python floats -> baked constants)
# ---------------------------------------------------------------------------


def _f(x):
    return [float(v) for v in np.asarray(x).reshape(-1)]


def _dual_basis(e1, e2):
    """In-plane dual vectors f1, f2 with (a e1 + b e2).f1 == a etc."""
    e11 = float(np.dot(e1, e1))
    e22 = float(np.dot(e2, e2))
    e12 = float(np.dot(e1, e2))
    det = e11 * e22 - e12 * e12
    f1 = (e22 * e1 - e12 * e2) / det
    f2 = (e11 * e2 - e12 * e1) / det
    return f1, f2


def extract_static(scene):
    # bulk-fetch every leaf to host up front: the per-element np.asarray
    # reads below would otherwise each pay a device-to-host round trip
    scene = jax.device_get(scene)
    g = scene.geometry
    planar = []
    for i in range(g.n_planar):
        kind = int(np.asarray(g.pl_kind[i]))
        p0 = np.asarray(g.pl_p0[i], np.float64)
        p1 = np.asarray(g.pl_p1[i], np.float64)
        p2 = np.asarray(g.pl_p2[i], np.float64)
        p3 = np.asarray(g.pl_p3[i], np.float64)
        rec = dict(
            kind=kind,
            p0=_f(p0), p1=_f(p1), p2=_f(p2), p3=_f(p3), n=_f(g.pl_normal[i]),
            radius=float(np.asarray(g.pl_radius[i])),
        )
        # precomputed barycentric/bilinear dual bases (hot-loop fast path);
        # rects must be parallelograms for the 2D test to equal the
        # reference's 4-edge-plane quad test
        if kind == kshapes.TRI:
            f1, f2 = _dual_basis(p1 - p0, p2 - p0)
            rec.update(anchor=_f(p0), f1=_f(f1), f2=_f(f2), fast=True)
        elif kind == kshapes.RECT and \
                np.allclose(p3, p0 + p2 - p1, rtol=1e-5, atol=1e-7):
            f1, f2 = _dual_basis(p0 - p1, p2 - p1)
            rec.update(anchor=_f(p1), f1=_f(f1), f2=_f(f2), fast=True)
        else:
            rec.update(fast=False)
        # uv parameterization (scene/texture.py conventions), baked for
        # in-kernel checker evaluation: anchor + dual basis for tri/rect,
        # frame axes for disks
        if kind == kshapes.TRI:
            uf1, uf2 = _dual_basis(p1 - p0, p2 - p0)
            rec.update(uv_anchor=_f(p0), uv_f1=_f(uf1), uv_f2=_f(uf2))
        elif kind == kshapes.RECT:
            uf1, uf2 = _dual_basis(p0 - p1, p2 - p1)
            rec.update(uv_anchor=_f(p1), uv_f1=_f(uf1), uv_f2=_f(uf2))
        else:  # disk: u = .5 + rel.s/(2r), v = .5 + rel.t/(2r)
            nn = np.asarray(rec["n"], np.float64)
            nn = nn / np.linalg.norm(nn)
            helper = np.array([0.0, 1.0, 0.0]) if abs(nn[0]) > 0.99 \
                else np.array([1.0, 0.0, 0.0])
            tt = np.cross(nn, helper)
            tt = tt / np.linalg.norm(tt)
            ss = np.cross(tt, nn)
            inv2r = 0.5 / max(rec["radius"], 1e-12)
            rec.update(uv_anchor=_f(p0), uv_f1=_f(ss * inv2r),
                       uv_f2=_f(tt * inv2r), uv_disk=True)
        planar.append(rec)
    spheres = []
    for i in range(g.n_sphere):
        spheres.append(dict(c=_f(g.sp_center[i]),
                            r=float(np.asarray(g.sp_radius[i]))))

    def _surface_inside_ball_possible(c, r):
        """Conservative: can ANY scene surface point lie strictly inside the
        ball (c, r)? Shading points live on surfaces, so if False the
        sphere-light inside-branch is statically dead (see _light_sample).
        The light's own coincident sphere shape contributes only boundary
        points (d^2 == r^2), handled by the boundary no-NEE rule, so it is
        excluded."""
        c = np.asarray(c, np.float64)
        for s in planar:
            pts = [np.asarray(s[k], np.float64)
                   for k in ("p0", "p1", "p2", "p3")]
            if s["kind"] == kshapes.TRI:
                pts = pts[:3]
            n = np.asarray(s["n"], np.float64)
            n = n / max(np.linalg.norm(n), 1e-30)
            if abs(np.dot(n, c - pts[0])) >= r:
                continue
            centroid = np.mean(pts, axis=0)
            circum = max(np.linalg.norm(p - centroid) for p in pts)
            if np.linalg.norm(c - centroid) < r + circum:
                return True
        for s in spheres:
            ci = np.asarray(s["c"], np.float64)
            dist = np.linalg.norm(ci - c)
            if dist < 1e-9 and abs(s["r"] - r) < 1e-9:
                continue   # the light's own shape: boundary-only
            if abs(dist - s["r"]) < r:
                return True
        return False

    mats = dict(
        kind=[int(k) for k in np.asarray(scene.mat_kind)],
        exponent=[float(v) for v in np.asarray(scene.mat_exponent)],
        eta=[float(v) for v in np.asarray(scene.mat_eta)],
        d_prob=[float(v) for v in np.asarray(scene.mat_d_prob)],
        s_prob=[float(v) for v in np.asarray(scene.mat_s_prob)],
        light_index=[int(v) for v in np.asarray(scene.light_index)],
    )
    # which BSDF lobes this scene can ever evaluate: material kinds are
    # static per surface row, so absent lobes are pruned from the compiled
    # kernel (the same "compiled scene" specialization as the baked geometry)
    mk = set(mats["kind"])
    lobes = set()
    if kbsdf.MAT_MATTE in mk or kbsdf.MAT_PLASTIC in mk:
        lobes.add(kbsdf.LAMBERT)
    if kbsdf.MAT_PLASTIC in mk:
        lobes.add(kbsdf.PHONG)
    if kbsdf.MAT_MIRROR in mk:
        lobes.add(kbsdf.MIRROR)
    if kbsdf.MAT_GLASS in mk:
        lobes.add(kbsdf.GLASS)
    mats["lobes"] = frozenset(lobes)
    li = scene.lights
    lights = []
    for i, kind in enumerate(li.kinds):
        rec = dict(
            kind=int(kind),
            position=_f(li.position[i]), direction=_f(li.direction[i]),
            p0=_f(li.p0[i]), p1=_f(li.p1[i]), p2=_f(li.p2[i]),
            p3=_f(li.p3[i]), normal=_f(li.normal[i]),
            area=float(np.asarray(li.area[i])),
            center=_f(li.center[i]), radius=float(np.asarray(li.radius[i])),
        )
        if int(kind) == klights.AREA_SPHERE:
            rec["inside_possible"] = _surface_inside_ball_possible(
                rec["center"], rec["radius"])
        lights.append(rec)
    # NB a sphere light's own shape MUST stay in its NEE occlusion sweep:
    # the reference measures the shadow-ray distance from the UNOFFSET
    # shading point but traces from the offset origin (ky.cpp:3193 + 614),
    # so the sampled sphere itself re-enters the ray's [eps, dist-2e-3]
    # window whenever 1e-2*cos(theta) > 2e-3 — i.e. the reference
    # self-occludes ~70% of cone-sampled sphere NEE, and every engine here
    # replicates that for pixel parity (measured: "fixing" it brightens
    # veach by ~50%).
    occl_skip = _occl_skip_rows(planar, spheres, mats, lights)
    # texture bindings (in-kernel support is planar-only; the tracer
    # factories below reject anything else before we get here). Checker
    # rows carry parity + color-table indices; image rows carry the atlas
    # tile geometry for the in-kernel gathered bilinear fetch.
    textures = []
    n_textures = 0
    if getattr(scene, "has_textures", False):
        from kytpu.scene import texture as ktex_mod
        n_textures = scene.textures.n_textures
        tex_id = np.asarray(scene.tex_id)
        tscale = np.asarray(scene.textures.scale)
        tkind = np.asarray(scene.textures.kind)
        timg_idx = np.asarray(scene.textures.image_index)
        th, tw = scene.textures.image.shape[1:3]
        for m in range(len(tex_id)):
            ti = int(tex_id[m])
            if ti >= 0:
                rec = dict(
                    row=m, tex=ti,
                    kind=("image" if int(tkind[ti]) == ktex_mod.IMAGE
                          else "checker"),
                    scale=(float(tscale[ti, 0]), float(tscale[ti, 1])))
                if rec["kind"] == "image":
                    rec.update(img=int(timg_idx[ti]), tw=int(tw),
                               th=int(th))
                textures.append(rec)

    return dict(planar=planar, spheres=spheres, mats=mats, lights=lights,
                world_radius=float(np.asarray(scene.world_radius)),
                has_env=scene.has_env, textures=textures,
                n_textures=n_textures, occl_skip=occl_skip)


def _occl_skip_rows(planar, spheres, mats, lights):
    """Per-light sets of PLANAR surface rows statically proven unable to
    occlude any of that light's NEE shadow rays — pruned from the compiled
    occlusion sweeps (the scene-specialization counterpart of the baked
    geometry; big for box scenes whose walls are one-sided boundaries).

    Surface s (plane n, offset c) is skippable for light i iff, for one
    orientation sigma, (a) every sample point of light i lies strictly on
    the sigma side (>= 1e-3 — both segment endpoints on one side of a
    plane means no crossing), and (b) every scene surface — the shadow-ray
    ORIGINS, which are shading points offset by +-RAY_OFFSET along their
    own surface normal (ky.cpp:614) — stays on the sigma side even after
    the worst-case offset excursion RAY_OFFSET * |n . n_host| toward the
    plane. A host surface whose normal is parallel to the plane (a floor
    vertex touching a wall plane) has zero excursion, so box corners don't
    defeat the proof. Delta-position (point) lights use their position;
    direction/environment lights sample at 2*world_radius in arbitrary
    directions, so nothing is skippable for them. A light's own emitting
    surface is never skipped (the self-occlusion quirk above must keep
    firing)."""
    n_pl = len(planar)
    skips = [set() for _ in lights]
    if not lights:
        return skips

    def _poly_pts(s):
        k = 3 if s["kind"] == kshapes.TRI else 4
        return [np.asarray(s[f"p{j}"], np.float64) for j in range(k)]

    for row, s in enumerate(planar):
        n = np.asarray(s["n"], np.float64)
        nl = np.linalg.norm(n)
        if nl < 1e-12:
            continue
        n = n / nl
        c = float(np.dot(n, np.asarray(s["p0"], np.float64)))

        # signed-distance range of every scene surface, minus its
        # worst-case shading-origin excursion toward this plane
        lo = hi = 0.0   # row's own surface: coplanar, excursion-free
        for u_row, u in enumerate(planar):
            if u_row == row:
                continue
            nu = np.asarray(u["n"], np.float64)
            nu = nu / max(np.linalg.norm(nu), 1e-30)
            exc = km.RAY_OFFSET * abs(float(np.dot(n, nu)))
            if u["kind"] == kshapes.DISK:
                d0 = float(np.dot(n, np.asarray(u["p0"], np.float64))) - c
                r_in = u["radius"] * float(
                    np.sqrt(max(0.0, 1.0 - np.dot(n, nu) ** 2)))
                dmin, dmax = d0 - r_in, d0 + r_in
            else:
                ds = [float(np.dot(n, p)) - c for p in _poly_pts(u)]
                dmin, dmax = min(ds), max(ds)
            lo = min(lo, dmin - exc)
            hi = max(hi, dmax + exc)
        for sp in spheres:
            d0 = float(np.dot(n, np.asarray(sp["c"], np.float64))) - c
            exc = km.RAY_OFFSET   # sphere normals: any direction
            lo = min(lo, d0 - sp["r"] - exc)
            hi = max(hi, d0 + sp["r"] + exc)

        for i, lt in enumerate(lights):
            kind = lt["kind"]
            if kind in (klights.DIRECTION, klights.ENV):
                continue
            if mats["light_index"][row] == i:
                continue   # the light's own surface stays in its sweep
            if kind == klights.POINT:
                q = [float(np.dot(n, np.asarray(lt["position"],
                                                np.float64))) - c] * 2
            elif kind == klights.AREA_RECT:
                pts = [np.asarray(lt[f"p{j}"], np.float64) for j in range(4)]
                dq = [float(np.dot(n, p)) - c for p in pts]
                q = [min(dq), max(dq)]
            else:   # AREA_SPHERE: samples anywhere on the sphere
                d0 = float(np.dot(n, np.asarray(lt["center"],
                                                np.float64))) - c
                q = [d0 - lt["radius"], d0 + lt["radius"]]
            # -1e-6 tolerance: geometry exactly touching the plane with a
            # perpendicular host normal (box corners) is crossing-free —
            # the shading origin stays in-plane and t = 0 < SHAPE_EPSILON
            if q[0] >= 1e-3 and lo >= -1e-6:
                skips[i].add(row)
            elif q[1] <= -1e-3 and hi <= 1e-6:
                skips[i].add(row)
    return skips


def _cv3(v):  # constant V3 from a python float triple (broadcasts with planes)
    return V3(np.float32(v[0]), np.float32(v[1]), np.float32(v[2]))


# ---------------------------------------------------------------------------
# in-kernel helpers (all operate on (R, 128) planes)
# ---------------------------------------------------------------------------


def _bits_to_unit(bits):
    # 24-bit mantissa trick, all int32: a logical >>8 of the random word is
    # a non-negative int32 in [0, 2^24)
    return jax.lax.shift_right_logical(bits, jnp.int32(8)).astype(
        jnp.float32) * np.float32(1.0 / (1 << 24))


# -- int32 Owen-Sobol machinery (logical shifts, wrapping muls, no uint32) ---


def _i32(c: int):
    c &= 0xFFFFFFFF
    return np.int32(c - (1 << 32) if c >= (1 << 31) else c)


def _srl(x, k: int):
    return jax.lax.shift_right_logical(x, jnp.int32(k))


def _rev_bits(x):
    """Bit reversal of an int32 plane (5 swap stages)."""
    x = (_srl(x, 1) & np.int32(0x55555555)) | ((x & np.int32(0x55555555)) << 1)
    x = (_srl(x, 2) & np.int32(0x33333333)) | ((x & np.int32(0x33333333)) << 2)
    x = (_srl(x, 4) & np.int32(0x0F0F0F0F)) | ((x & np.int32(0x0F0F0F0F)) << 4)
    x = (_srl(x, 8) & np.int32(0x00FF00FF)) | ((x & np.int32(0x00FF00FF)) << 8)
    return _srl(x, 16) | (x << 16)


def _superset_xor(x):
    """z_j = XOR_{k >= j, j subset k} x_k — the GF(2) superset (odd-zeta)
    transform in 5 word-parallel stages. bit-reverse(z) is a valid second
    (0,2)-sequence partner to the radical inverse (generator matrix =
    Pascal/Sierpinski, upper-triangular with odd diagonal, via Lucas'
    theorem) — same elementary-interval guarantees as the direction-number
    dim-2 in core/lds.py:66-74, NOT bitwise equal to it, and 5 ops instead
    of a 32-step loop (test_kernel.py proves the (0,2) property)."""
    x = x ^ (_srl(x, 1) & np.int32(0x55555555))
    x = x ^ (_srl(x, 2) & np.int32(0x33333333))
    x = x ^ (_srl(x, 4) & np.int32(0x0F0F0F0F))
    x = x ^ (_srl(x, 8) & np.int32(0x00FF00FF))
    return x ^ (_srl(x, 16) & np.int32(0x0000FFFF))


def _lk_hash(x, seed):
    """Laine-Karras permutation: an Owen scramble of the reversed-bit tree
    (same constants as core/lds.py:50-58)."""
    x = x + seed
    x = x ^ (x * _i32(0x6C50B47C))
    x = x ^ (x * _i32(0xB82F1E52))
    x = x ^ (x * _i32(0xC7AFE638))
    x = x ^ (x * _i32(0x8D22F6E6))
    return x


def _pix_hash(pid, seed):
    """Per-lane scramble base from (pixel id, render seed): lowbias32."""
    x = pid ^ (seed * np.int32(-1640531527))           # 0x9E3779B9
    x = x ^ _srl(x, 16)
    x = x * _i32(0x21F0AAAD)
    x = x ^ _srl(x, 15)
    x = x * _i32(0x735A2D97)
    return x ^ _srl(x, 15)


def _site_seeds(ctr):
    """Three decorrelated 32-bit constants for draw site `ctr` (an int32
    scalar, concrete or traced — the kernels' bounce loop makes the site
    index a loop variable): a Weyl step through a lowbias32 mix."""
    x = jnp.asarray(ctr, jnp.int32) * np.int32(-1640531527) \
        + _i32(0x632BE59B)
    out = []
    for _ in range(3):
        x = x + np.int32(-1640531527)                  # 0x9E3779B9
        z = x ^ _srl(x, 16)
        z = z * _i32(0x21F0AAAD)
        z = z ^ _srl(z, 15)
        z = z * _i32(0x735A2D97)
        out.append(z ^ _srl(z, 15))
    return out


# draw sites reserved per bounce: the kernels' bounce loop advances the
# site base by this much per iteration, so each bounce draws from its own
# sites (a body draws at most 4 times: lobe pick, NEE, extension, RR)
SITES_PER_BOUNCE = 8


class _Rng:
    """Per-kernel-instance uniform source: a stateless lowbias32-style
    integer hash of (seed, draw counter, lane id).

    sobol=(sample_index_plane, pixel_hash_plane) switches every draw to a
    hash-based Owen-scrambled Sobol (0,2)-sequence: uniform2() yields one
    2D point of a per-site shuffled+scrambled (0,2) pair, uniform() a
    scrambled van-der-Corput value. Draw sites are indexed by
    base + a trace-time counter (at_bounce sets the base from the bounce
    index, which may be the traced loop variable), so forward and
    replay-backward streams align exactly as in the plain hash mode.

    per_lane=True: `seed_scalar` is a PLANE of per-lane seeds (a hash of
    (render seed, pixel id, sample id)); draws are then a pure function of
    that key and the draw site, independent of where the lane sits in the
    launch — this is the mesh-shape-invariant "hash" sampler used by the
    sharded renderers (each lane produces identical streams under any
    device/tile decomposition).
    """

    def __init__(self, seed_scalar, sobol=None, per_lane: bool = False):
        self.seed = seed_scalar
        self.base = 0
        self.ctr = 0
        self.per_lane = per_lane
        self.sobol = sobol is not None
        if sobol is not None:
            si, ph = sobol
            self.si_rev = _rev_bits(si)   # rev(index): shared by all sites
            self.ph = ph

    def at_bounce(self, bounce):
        """Start the draw sites of bounce `bounce` (int or traced int32)."""
        self.base = bounce * SITES_PER_BOUNCE
        self.ctr = 0

    def _site(self):
        self.ctr += 1
        assert self.ctr <= SITES_PER_BOUNCE, "raise SITES_PER_BOUNCE"
        return self.base + self.ctr

    def uniform2(self, shape):
        """One 2D point: stratified (0,2) pair under sobol, else two
        independent draws."""
        if not self.sobol:
            return self.uniform(shape), self.uniform(shape)
        c1, c2, c3 = _site_seeds(self._site())
        # index shuffle (Owen shuffle in reversed-bit space): t = rev(i)
        t = _lk_hash(self.si_rev, self.ph ^ c1)
        i = _rev_bits(t)
        # dim0 = rev(i) = t; Owen value scramble nested(d0) = rev(lk(rev(d0)))
        u1 = _bits_to_unit(_rev_bits(_lk_hash(i, self.ph ^ c2)))
        # dim1 = rev(superset(i)); nested(d1) = rev(lk(superset(i)))
        u2 = _bits_to_unit(_rev_bits(_lk_hash(_superset_xor(i),
                                              self.ph ^ c3)))
        return u1, u2

    def uniform(self, shape):
        if self.sobol:
            c1, c2, _ = _site_seeds(self._site())
            t = _lk_hash(self.si_rev, self.ph ^ c1)
            return _bits_to_unit(
                _rev_bits(_lk_hash(_rev_bits(t), self.ph ^ c2)))
        step = jnp.asarray(self._site(), jnp.int32) * np.int32(668265263)
        if self.per_lane:
            # seed is already a unique-per-lane plane; mixing in the lane
            # position would break decomposition invariance
            x = self.seed + step
        else:
            lane = (jax.lax.broadcasted_iota(jnp.int32, shape, 0)
                    * np.int32(shape[-1])
                    + jax.lax.broadcasted_iota(jnp.int32, shape, 1))
            x = self.seed + lane * np.int32(374761393) + step
        x = x ^ jax.lax.shift_right_logical(x, jnp.int32(17))
        x = x * np.int32(-315667899)            # 0xed5ad4bb
        x = x ^ jax.lax.shift_right_logical(x, jnp.int32(11))
        x = x * np.int32(-1404298415)           # 0xac4c1b51
        x = x ^ jax.lax.shift_right_logical(x, jnp.int32(15))
        x = x * np.int32(830770091)             # 0x31848bab
        x = x ^ jax.lax.shift_right_logical(x, jnp.int32(14))
        return _bits_to_unit(x)


def _safe_div(num, den, fallback=0.0):
    ok = den != 0.0
    return jnp.where(ok, num / jnp.where(ok, den, 1.0), fallback)


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def _ipow(x, n: int):
    """x**n (static integer n >= 1) by square-and-multiply: ~log2(n) muls
    instead of a multi-pass exp/log pow. Relative rounding error is
    ~popcount+log2(n) ulps (~2e-6 for n=5000), far inside MC tolerance."""
    r = None
    while n:
        if n & 1:
            r = x if r is None else r * x
        n >>= 1
        if n:
            x = x * x
    return r



def _kappa(exponent, wo_l: V3, wi_l: V3):
    """d log f_phong / d e at FIXED wi: 1/(e+2) + log cos_alpha (clamped).

    The single definition behind every exponent adjoint — the replay
    accumulators and the residual "Bk"/"tuk" planes must stay in lockstep.
    Callers mask the result to phong lanes (where cos_alpha > 0, so the
    clamp never fires on a contributing lane)."""
    return _kappa_dot(exponent, V3(-wo_l.x, -wo_l.y, wo_l.z).dot(wi_l))


def _kappa_dot(exponent, cos_alpha):
    """_kappa on the precomputed (frame-invariant) mirror dot."""
    cos_a = jnp.maximum(cos_alpha, 1e-12)
    return _safe_div(np.float32(1.0), exponent + 2.0) + jnp.log(cos_a)


def _static_exponent(mats):
    """The single static integer Phong exponent shared by every glossy
    surface, or None (mixed/fractional exponents fall back to jnp.power)."""
    vals = {float(v) for v in mats["exponent"] if float(v) != 0.0}
    if len(vals) == 1:
        e = vals.pop()
        if e.is_integer() and 1.0 <= e <= 1e6:
            return e
    return None


def _planar_hit(s, o: V3, d: V3):
    """(t, inside) for one baked planar surface.

    fast path: plane hit + precomputed dual-basis 2D inclusion (~2.4x fewer
    ops than the 4-cross-product SmallVCM test, same accepted set for
    triangles and parallelogram rects up to fp rounding).

    Division is raw (not _safe_div): a parallel ray gives t = ±inf/nan, and
    every caller gates on `inside & (eps < t < tmax)`, which inf/nan
    comparisons reject — the guard would only add ops."""
    nrm = _cv3(s["n"])
    if s["kind"] == kshapes.DISK:
        p0 = _cv3(s["p0"])
        t = nrm.dot(p0 - o) / nrm.dot(d)
        hp = o + d * t
        inside = (hp - p0).length_squared() <= np.float32(s["radius"] ** 2)
        return t, inside
    if s.get("fast"):
        anchor = _cv3(s["anchor"])
        # numerator folded: n.(anchor - o) == (n.anchor) - n.o with the
        # first dot a host constant (saves 3 vector subs per surface)
        c_n = np.float32(np.dot(s["n"], np.asarray(s["anchor"], np.float64)))
        t = (c_n - nrm.dot(o)) / nrm.dot(d)
        rel = o + d * t - anchor
        a = rel.dot(_cv3(s["f1"]))
        b = rel.dot(_cv3(s["f2"]))
        if s["kind"] == kshapes.TRI:
            inside = (a >= 0) & (b >= 0) & (a + b <= 1.0)
        else:
            inside = (a >= 0) & (a <= 1.0) & (b >= 0) & (b <= 1.0)
        return t, inside
    p0, p1 = _cv3(s["p0"]), _cv3(s["p1"])
    p2, p3 = _cv3(s["p2"]), _cv3(s["p3"])
    oa = p0 - o
    ob = p1 - o
    oc = p2 - o
    od = p3 - o
    v0d = oc.cross(ob).dot(d)
    v1d = ob.cross(oa).dot(d)
    v2d = oa.cross(od).dot(d)
    v3d = od.cross(oc).dot(d)
    if s["kind"] == kshapes.TRI:
        inside = ((v0d < 0) & (v1d < 0) & (v3d < 0)) | \
                 ((v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0))
    else:
        inside = ((v0d < 0) & (v1d < 0) & (v2d < 0) & (v3d < 0)) | \
                 ((v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0))
    t = nrm.dot(oa) / nrm.dot(d)
    return t, inside


def _closest_hit(static, o: V3, d: V3):
    """Baked-geometry closest hit. Returns (t, sid, valid, normal).

    The sweep carries only (t, sid); the winner's normal is resolved
    ONCE post-loop from sid (planar normals are host constants; sphere
    normals need a single hit-point build instead of one per candidate
    sphere) — ~40 fewer ops per lane per bounce than carrying the
    normal through the loop."""
    shp = o.x.shape
    t_best = jnp.full(shp, np.float32(np.inf))
    sid = jnp.full(shp, np.int32(-1))

    for row, s in enumerate(static["planar"]):
        t, inside = _planar_hit(s, o, d)
        accept = inside & (t > km.SHAPE_EPSILON) & (t < t_best)
        t_best = jnp.where(accept, t, t_best)
        sid = jnp.where(accept, np.int32(row), sid)

    base = len(static["planar"])
    for j, s in enumerate(static["spheres"]):
        c = _cv3(s["c"])
        r = np.float32(s["r"])
        oc = c - o
        neg_b = oc.dot(d)
        perp = oc - d * neg_b
        discr = r * r - perp.length_squared()
        sq = _safe_sqrt(discr)
        cc = oc.length_squared() - r * r
        sgn = jnp.where(neg_b >= 0.0, np.float32(1.0), np.float32(-1.0))
        q = neg_b + sgn * sq
        tq = cc / q        # raw div: q==0 -> inf/nan, rejected by the gates
        t1 = jnp.minimum(q, tq)
        t2 = jnp.maximum(q, tq)
        t1_ok = t1 > km.SHAPE_EPSILON
        t2_ok = t2 > km.SHAPE_EPSILON
        t = jnp.where(t1_ok, t1, t2)
        accept = (discr >= 0) & (t1_ok | t2_ok) & (t < t_best)
        t_best = jnp.where(accept, t, t_best)
        sid = jnp.where(accept, np.int32(base + j), sid)

    valid = sid >= 0

    # ---- post-loop normal resolve ----
    zero = jnp.zeros(shp, jnp.float32)
    nx, ny, nz = zero, zero, zero
    is_rect = sid < np.int32(-1)   # statically-false mask
    for row, s in enumerate(static["planar"]):
        m = sid == row
        n = s["n"]
        nx = jnp.where(m, np.float32(n[0]), nx)
        ny = jnp.where(m, np.float32(n[1]), ny)
        nz = jnp.where(m, np.float32(n[2]), nz)
        if s["kind"] == kshapes.RECT:
            is_rect = is_rect | m
    # rect normals flip toward the ray (one flip for the winner instead
    # of one per candidate row)
    flip = is_rect & (nx * d.x + ny * d.y + nz * d.z > 0)
    n_best = V3(jnp.where(flip, -nx, nx), jnp.where(flip, -ny, ny),
                jnp.where(flip, -nz, nz))
    if static["spheres"]:
        cx, cy, cz = zero, zero, zero
        inv_r = jnp.ones(shp, jnp.float32)
        for j, s in enumerate(static["spheres"]):
            m = sid == base + j
            c = s["c"]
            cx = jnp.where(m, np.float32(c[0]), cx)
            cy = jnp.where(m, np.float32(c[1]), cy)
            cz = jnp.where(m, np.float32(c[2]), cz)
            inv_r = jnp.where(m, np.float32(1.0 / s["r"]), inv_r)
        n_sp = V3((o.x + d.x * t_best - cx) * inv_r,
                  (o.y + d.y * t_best - cy) * inv_r,
                  (o.z + d.z * t_best - cz) * inv_r)
        n_best = n_sp.where(sid >= base, n_best)

    return t_best, sid, valid, n_best


def _any_hit(static, o: V3, d: V3, tmax, skip_sphere: int | None = None,
             skip_rows=(), skip_light=None):
    """Baked-geometry occlusion test in (SHAPE_EPSILON, tmax).

    Boolean-only: the sphere test needs no stable-quadratic division — a
    boundary crossing in range means root t1 or t2 = neg_b -+ sq lies in
    (eps, tmax), the reference's two-root gate (ky.cpp:1375-1382). The
    cancellation error of the naive small root is ~1e-4 relative, absorbed
    by the shadow epsilons. skip_sphere omits a sphere-light's own geometry
    (see extract_static); skip_rows omits planar rows statically proven
    non-occluding (_occl_skip_rows).
    """
    # mask born from a compare (not a bool literal tensor)
    hit = jnp.zeros_like(tmax) > 0.0
    n_pl = len(static["planar"])
    li_of = static["mats"]["light_index"]

    def gate(row):
        if skip_light is None or li_of[row] < 0:
            return None
        return skip_light != np.int32(li_of[row])

    for row, s in enumerate(static["planar"]):
        if row in skip_rows:
            continue
        t, inside = _planar_hit(s, o, d)
        h = inside & (t > km.SHAPE_EPSILON) & (t < tmax)
        g = gate(row)
        hit = hit | (h if g is None else h & g)
    for j, s in enumerate(static["spheres"]):
        if j == skip_sphere:
            continue
        c = _cv3(s["c"])
        r = np.float32(s["r"])
        oc = c - o
        neg_b = oc.dot(d)
        perp = oc - d * neg_b
        discr = r * r - perp.length_squared()
        # sqrt-free root-in-range test (see _any_hit_multi's sphere loop)
        a_c = neg_b - km.SHAPE_EPSILON
        b_c = neg_b - tmax
        a2 = a_c * a_c
        b2 = b_c * b_c
        a_pos = a_c > 0.0
        b_neg = b_c < 0.0
        in1 = a_pos & (discr < a2) & (b_neg | (discr > b2))
        in2 = (a_pos | (discr > a2)) & b_neg & (discr < b2)
        h = (discr >= 0) & (in1 | in2)
        g = gate(n_pl + j)
        hit = hit | (h if g is None else h & g)
    return hit


def _any_hit_multi(static, hp: V3, n_shade: V3, rays, skips,
                   robust: bool = False, sphere_skips=None, nd=None):
    """K-ray occlusion: all NEE shadow rays of one bounce leave the SAME
    shading point hp (offset +-RAY_OFFSET along n_shade by each ray's
    n.d sign, ky.cpp:614), so every per-surface term that depends only on
    (hp, n_shade) — the plane numerator, the dual-basis base coordinates,
    the sphere center offset — is computed once and shared by all K rays
    (~25% fewer sweep ops than K independent _any_hit calls at K=4).

    rays:  [(wi: V3, tmax: plane), ...]
    skips: per-ray iterables of planar rows to omit (_occl_skip_rows).
    Returns one hit mask per ray. Same math as _any_hit up to fp
    reassociation (the offset origin is folded into each dot product).
    """
    eps = km.SHAPE_EPSILON
    K = len(rays)
    if nd is None:
        nd = [n_shade.dot(wi) for wi, _ in rays]
    se = [jnp.where(nd[k] < 0.0, np.float32(-km.RAY_OFFSET),
                    np.float32(km.RAY_OFFSET)) for k in range(K)]
    if robust:
        # measure tmax from the actual offset origin: |q - o'| =~
        # dist - se*(n.wi) to first order (the dropped se^2 term is far
        # inside the 2e-3 shadow epsilon)
        rays = [(rays[k][0], rays[k][1] - se[k] * nd[k]) for k in range(K)]
    hits = [rays[k][1] < rays[k][1] - 1.0 for k in range(K)]  # false masks
    o_k = None   # per-ray origins, built lazily for the non-fast fallback

    def origins():
        nonlocal o_k
        if o_k is None:
            o_k = [hp + n_shade * se[k] for k in range(K)]
        return o_k

    for row, s in enumerate(static["planar"]):
        which = [k for k in range(K) if row not in skips[k]]
        if not which:
            continue
        if s["kind"] == kshapes.DISK or not s.get("fast"):
            for k in which:
                t, inside = _planar_hit(s, origins()[k], rays[k][0])
                hits[k] = hits[k] | (inside & (t > eps) & (t < rays[k][1]))
            continue
        nrm = _cv3(s["n"])
        f1, f2 = _cv3(s["f1"]), _cv3(s["f2"])
        anchor = np.asarray(s["anchor"], np.float64)
        c_n = np.float32(np.dot(s["n"], anchor))
        c_1 = np.float32(np.dot(s["f1"], anchor))
        c_2 = np.float32(np.dot(s["f2"], anchor))
        # shared: numerator / dual coords at hp, and their offset rates
        num_h = c_n - nrm.dot(hp)
        num_n = nrm.dot(n_shade)
        a_h = f1.dot(hp) - c_1
        a_n = f1.dot(n_shade)
        b_h = f2.dot(hp) - c_2
        b_n = f2.dot(n_shade)
        for k in which:
            wi, tmax = rays[k]
            num = num_h - se[k] * num_n
            t = num / nrm.dot(wi)   # raw div: gates reject inf/nan
            a = (a_h + se[k] * a_n) + t * f1.dot(wi)
            b = (b_h + se[k] * b_n) + t * f2.dot(wi)
            if s["kind"] == kshapes.TRI:
                inside = (a >= 0) & (b >= 0) & (a + b <= 1.0)
            else:
                inside = (a >= 0) & (a <= 1.0) & (b >= 0) & (b <= 1.0)
            hits[k] = hits[k] | (inside & (t > eps) & (t < tmax))

    off2 = np.float32(km.RAY_OFFSET * km.RAY_OFFSET)
    for j, s in enumerate(static["spheres"]):
        which_s = [k for k in range(K)
                   if sphere_skips is None or j not in sphere_skips[k]]
        if not which_s:
            continue
        c = _cv3(s["c"])
        r = np.float32(s["r"])
        vc = c - hp
        vc2 = vc.length_squared()
        vcn = vc.dot(n_shade)
        for k in which_s:
            wi, tmax = rays[k]
            neg_b = vc.dot(wi) - se[k] * nd[k]
            oc2 = vc2 - 2.0 * se[k] * vcn + off2   # |n_shade| == 1
            discr = r * r - oc2 + neg_b * neg_b
            # sqrt-free root-in-range test: with sq = sqrt(discr) >= 0,
            # A = neg_b - eps, B = neg_b - tmax,
            #   t1 = neg_b - sq in (eps, tmax)  <=>  sq < A  and  sq > B
            #   t2 = neg_b + sq in (eps, tmax)  <=>  sq > -A and  sq < -B
            # and each one-sided compare of sq rewrites to a sign test
            # plus a compare of discr against A*A / B*B (sqrts were ~25
            # ops per bounce here; measured on the veach NEE sweep)
            a_c = neg_b - eps
            b_c = neg_b - tmax
            a2 = a_c * a_c
            b2 = b_c * b_c
            a_pos = a_c > 0.0
            b_neg = b_c < 0.0
            in1 = a_pos & (discr < a2) & (b_neg | (discr > b2))
            in2 = (a_pos | (discr > a2)) & b_neg & (discr < b2)
            hits[k] = hits[k] | ((discr >= 0) & (in1 | in2))
    return hits


def _select_rows(sid, rows, values):
    """Masked-sum selection: values[i] is a python float for surface rows[i]."""
    out = jnp.zeros(sid.shape, jnp.float32)
    for row, v in zip(rows, values):
        if v != 0.0:
            out = out + jnp.where(sid == row, np.float32(v), np.float32(0.0))
    return out


def _select_table3(sid, table_ref, m_rows):
    """V3 gather-free select from an (M, 3) table by sid plane.

    m_rows is a row count or an iterable of the rows whose value can ever
    be consumed downstream (statically known from the material kinds)."""
    rows = range(m_rows) if isinstance(m_rows, int) else m_rows
    x = jnp.zeros(sid.shape, jnp.float32)
    y = jnp.zeros(sid.shape, jnp.float32)
    z = jnp.zeros(sid.shape, jnp.float32)
    for m in rows:
        mask = sid == m
        x = jnp.where(mask, table_ref[m, 0], x)
        y = jnp.where(mask, table_ref[m, 1], y)
        z = jnp.where(mask, table_ref[m, 2], z)
    return V3(x, y, z)


def _checker_parity(static, rec, hp: V3):
    """Checker "even"-cell mask at hit position hp for one textured row.

    uv comes from the baked per-surface anchor + dual basis (planar only;
    the tracer factories reject sphere-bound and image textures before a
    kernel is built — see _kernel_texture_support): 2 dot products +
    2 floors + a parity compare, pure elementwise code.
    """
    s = static["planar"][rec["row"]]
    rel = hp - _cv3(s["uv_anchor"])
    u = rel.dot(_cv3(s["uv_f1"]))
    v = rel.dot(_cv3(s["uv_f2"]))
    if s.get("uv_disk"):
        u = u + np.float32(0.5)
        v = v + np.float32(0.5)
    pu = jnp.floor(u * np.float32(rec["scale"][0])).astype(jnp.int32)
    pv = jnp.floor(v * np.float32(rec["scale"][1])).astype(jnp.int32)
    return ((pu + pv) & 1) == 0


def _checker_color(rec, even, texa_ref, texb_ref) -> V3:
    t = rec["tex"]
    return V3(jnp.where(even, texa_ref[t, 0], texb_ref[t, 0]),
              jnp.where(even, texa_ref[t, 1], texb_ref[t, 1]),
              jnp.where(even, texa_ref[t, 2], texb_ref[t, 2]))


def _image_uv_xy(static, rec, hp: V3):
    """Continuous texel coordinates (x, y) of hit hp on one image-textured
    row (texel-center convention, wrapped into [-0.5, dim-0.5)) — the two
    planes the residual backward caches to rebuild the bilinear taps
    without re-intersecting (see _residual_layout)."""
    s = static["planar"][rec["row"]]
    rel = hp - _cv3(s["uv_anchor"])
    u = rel.dot(_cv3(s["uv_f1"]))
    v = rel.dot(_cv3(s["uv_f2"]))
    if s.get("uv_disk"):
        u = u + np.float32(0.5)
        v = v + np.float32(0.5)
    su = u * np.float32(rec["scale"][0])
    sv = v * np.float32(rec["scale"][1])
    tw, th = rec["tw"], rec["th"]
    x = (su - jnp.floor(su)) * np.float32(tw) - np.float32(0.5)
    y = (sv - jnp.floor(sv)) * np.float32(th) - np.float32(0.5)
    return x, y


def image_taps(img, tw: int, th: int, x, y):
    """Bilinear taps from continuous texel coords (texel-center
    convention, WRAP addressing), mirroring scene/texture._bilinear; used
    on kernel planes and on XLA arrays alike. x in [-0.5, tw-0.5) puts
    floor(x) in [-1, tw-1], so the wrap is one select per axis; the final
    clamps keep lanes whose coordinates are not finite (rays that hit
    nothing) inside the atlas. `img` is the image index (int or int32
    array). Returns (4 int32 flat indices into the (ti_n*th*tw) atlas,
    4 f32 weights)."""
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    xi0 = x0.astype(jnp.int32)
    yi0 = y0.astype(jnp.int32)
    xi0 = jnp.where(xi0 < 0, np.int32(tw - 1), xi0)
    yi0 = jnp.where(yi0 < 0, np.int32(th - 1), yi0)
    xi1 = jnp.where(xi0 + 1 >= tw, np.int32(0), xi0 + 1)
    yi1 = jnp.where(yi0 + 1 >= th, np.int32(0), yi0 + 1)
    xi0, xi1 = (jnp.clip(v, 0, tw - 1) for v in (xi0, xi1))
    yi0, yi1 = (jnp.clip(v, 0, th - 1) for v in (yi0, yi1))
    base = img * np.int32(th * tw)
    idx = (base + yi0 * np.int32(tw) + xi0,
           base + yi0 * np.int32(tw) + xi1,
           base + yi1 * np.int32(tw) + xi0,
           base + yi1 * np.int32(tw) + xi1)
    wts = ((1.0 - fx) * (1.0 - fy), fx * (1.0 - fy),
           (1.0 - fx) * fy, fx * fy)
    return idx, wts


def _image_color(rec, xy, timg_ref) -> V3:
    """Gathered bilinear fetch: 4 loads per channel from the flattened
    (ti_n*th*tw, 3) atlas."""
    idx, wts = image_taps(rec["img"], rec["tw"], rec["th"], *xy)
    out = []
    for c in range(3):
        v = None
        for i, w in zip(idx, wts):
            term = timg_ref[i, c] * w
            v = term if v is None else v + term
        out.append(v)
    return V3(*out)


# texture-adjoint planes written per shading bounce by the backward
# kernels: continuous texel coords, image index (as f32) and the diffuse
# VALUE adjoint on image-textured lanes (0 elsewhere); texel_adjoint
# scatters them into the atlas gradient in XLA
TEX_PLANES = 6


def image_hit_planes(static, sid, tex_xy, shp):
    """(x, y, img) planes of the image-textured row each lane hit (0
    elsewhere); tex_xy is aligned with static["textures"] (None entries
    for checker rows)."""
    tx = jnp.zeros(shp, jnp.float32)
    ty = jnp.zeros(shp, jnp.float32)
    ti = jnp.zeros(shp, jnp.float32)
    for rec, xy in zip(static["textures"], tex_xy):
        if xy is None:
            continue
        onrow = sid == rec["row"]
        tx = jnp.where(onrow, xy[0], tx)
        ty = jnp.where(onrow, xy[1], ty)
        ti = jnp.where(onrow, np.float32(rec["img"]), ti)
    return tx, ty, ti


def texel_adjoint(tplanes, n: int, img_shape):
    """d(atlas) from the backward kernels' (TEX_PLANES * D, rows, 128)
    texture-adjoint planes: the bilinear taps are rebuilt from the cached
    coordinates and the weighted adjoints scatter-add into the texels."""
    ti_n, th, tw, _ = img_shape
    t = tplanes.reshape(-1, TEX_PLANES, tplanes.shape[-2] * tplanes.shape[-1])
    t = t[:, :, :n]
    x, y, img = (t[:, k].reshape(-1) for k in range(3))
    adj = jnp.stack([t[:, k].reshape(-1) for k in (3, 4, 5)], axis=-1)
    idx, wts = image_taps(img.astype(jnp.int32), tw, th, x, y)
    ids = jnp.concatenate(idx)
    vals = jnp.concatenate([w[:, None] * adj for w in wts])
    d = jax.ops.segment_sum(vals, ids, num_segments=ti_n * th * tw)
    return d.reshape(img_shape)


def _apply_textures(static, texa_ref, texb_ref, timg_ref, sid, hp: V3,
                    diffuse: V3, parities=None, tex_xy=None) -> V3:
    """Replace the diffuse color on textured surface rows, masked by sid.
    `parities`: precomputed checker even-masks; `tex_xy`: precomputed
    image texel coordinates (lists aligned with static["textures"]; None
    entries recomputed here)."""
    for i, rec in enumerate(static["textures"]):
        if rec.get("kind") == "image":
            xy = tex_xy[i] if tex_xy is not None else None
            if xy is None:
                xy = _image_uv_xy(static, rec, hp)
            col = _image_color(rec, xy, timg_ref)
        else:
            even = parities[i] if parities is not None \
                and parities[i] is not None \
                else _checker_parity(static, rec, hp)
            col = _checker_color(rec, even, texa_ref, texb_ref)
        diffuse = col.where(sid == rec["row"], diffuse)
    return diffuse


def _offset_origin(p: V3, n: V3, d: V3) -> V3:
    s = jnp.where(n.dot(d) < 0.0, np.float32(-km.RAY_OFFSET),
                  np.float32(km.RAY_OFFSET))
    return p + n * s


# -- BSDF (plane port of kytpu/bsdf/bsdf.py local-frame models) --------------


def _fresnel_dielectric(ci, eta):
    ci = jnp.clip(ci, -1.0, 1.0)
    entering = ci > 0.0
    ei = jnp.where(entering, np.float32(1.0), eta)
    et = jnp.where(entering, eta, np.float32(1.0))
    c = jnp.abs(ci)
    si = _safe_sqrt(1.0 - c * c)
    st = ei / et * si
    tir = st >= 1.0
    ct = _safe_sqrt(1.0 - jnp.minimum(st, 1.0) ** 2)
    r_par = _safe_div(et * c - ei * ct, et * c + ei * ct)
    r_per = _safe_div(ei * c - et * ct, ei * c + et * ct)
    fr = 0.5 * (r_par * r_par + r_per * r_per)
    return jnp.where(tir, np.float32(1.0), fr)


def _sin_from_phi_cos(cos_phi, u):
    """sin(2*pi*u) given cos(2*pi*u): one multi-pass transcendental instead
    of two. sign(sin) = +1 iff u <= 0.5."""
    s = _safe_sqrt(1.0 - cos_phi * cos_phi)
    return jnp.where(u <= 0.5, s, -s)


def _concentric_disk(u1, u2):
    x = 2.0 * u1 - 1.0
    y = 2.0 * u2 - 1.0
    xd = jnp.abs(x) > jnp.abs(y)
    r = jnp.where(xd, x, y)
    ratio = jnp.where(xd, _safe_div(y, x), _safe_div(x, y))
    theta = jnp.where(xd, np.float32(km.PI_OVER_4) * ratio,
                      np.float32(km.PI_OVER_2) - np.float32(km.PI_OVER_4) * ratio)
    deg = (x == 0.0) & (y == 0.0)
    ct = jnp.cos(theta)
    # theta in [-pi/4, 3pi/4]: sin(theta) >= 0 iff theta >= 0
    st = _safe_sqrt(1.0 - ct * ct)
    st = jnp.where(theta >= 0.0, st, -st)
    px = jnp.where(deg, 0.0, r * ct)
    py = jnp.where(deg, 0.0, r * st)
    return px, py


def _bsdf_sample(kind, color: V3, color2: V3, eta, exponent, wo: V3, u1, u2,
                 lobes=frozenset((kbsdf.LAMBERT, kbsdf.MIRROR, kbsdf.GLASS,
                                  kbsdf.PHONG)), static_exp=None):
    """Local-frame sample of the 4 models + select (bsdf.py:174-238).

    Only lobes in `lobes` (the material kinds statically present in the
    scene) are compiled; u1/u2 are drawn by the caller so the RNG stream is
    independent of the pruning. Returns
    (f: V3, wi: V3, pdf, delta_mask, f_unit, glass_refract) where
    f == (glass_refract ? color2 : color) * f_unit — the linear-in-color
    factorization the path-replay backward needs.
    """
    mirror_wi = V3(-wo.x, -wo.y, wo.z)
    # (wi, f, pdf, f_unit) per present lobe, selected by the kind plane
    cand = {}

    if kbsdf.LAMBERT in lobes:
        px, py = _concentric_disk(u1, u2)
        lz = _safe_sqrt(1.0 - px * px - py * py)
        wi_lam = V3(px, py, jnp.where(wo.z < 0, -lz, lz))
        same_lam = wo.z * wi_lam.z > 0
        f_lam = color * (np.float32(km.INV_PI))
        f_lam = f_lam.where(same_lam, v3_zeros(wo.x))
        pdf_lam = jnp.where(same_lam,
                            jnp.abs(wi_lam.z) * np.float32(km.INV_PI), 0.0)
        unit_lam = jnp.where(same_lam, np.float32(km.INV_PI), 0.0)
        cand[kbsdf.LAMBERT] = (wi_lam, f_lam, pdf_lam, unit_lam)

    if kbsdf.MIRROR in lobes:
        abs_cos_m = jnp.maximum(jnp.abs(mirror_wi.z), 1e-12)
        f_mir = color * (1.0 / abs_cos_m)
        cand[kbsdf.MIRROR] = (mirror_wi, f_mir, jnp.ones_like(u1),
                              1.0 / abs_cos_m)

    take_refl = None
    if kbsdf.GLASS in lobes:
        fr = _fresnel_dielectric(wo.z, eta)
        take_refl = u1 < fr
        into = wo.z > 0
        nz = jnp.where(into, np.float32(1.0), np.float32(-1.0))
        n_loc = V3(jnp.zeros_like(nz), jnp.zeros_like(nz), nz)
        eta_ratio = jnp.where(into, 1.0 / eta, eta)
        cos_i = n_loc.dot(wo)
        sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
        sin2_t = eta_ratio * eta_ratio * sin2_i
        refr_ok = sin2_t < 1.0
        cos_t = _safe_sqrt(1.0 - jnp.minimum(sin2_t, 1.0))
        wt = (-wo) * eta_ratio + n_loc * (eta_ratio * cos_i - cos_t)
        wi_gl = mirror_wi.where(take_refl, wt)
        abs_cos_g = jnp.maximum(jnp.abs(wi_gl.z), 1e-12)
        unit_gl = jnp.where(take_refl, fr / abs_cos_g,
                            jnp.where(refr_ok, (1.0 - fr) / abs_cos_g, 0.0))
        f_gl = (color * (fr / abs_cos_g)).where(
            take_refl, (color2 * ((1.0 - fr) / abs_cos_g)).where(
                refr_ok, v3_zeros(wo.x)))
        pdf_gl = jnp.where(take_refl, fr, jnp.where(refr_ok, 1.0 - fr, 0.0))
        cand[kbsdf.GLASS] = (wi_gl, f_gl, pdf_gl, unit_gl)

    if kbsdf.PHONG in lobes:
        phi = np.float32(km.TWO_PI) * u1
        if static_exp is not None:
            cos_t_p = jnp.power(u2, np.float32(1.0 / (static_exp + 1.0)))
        else:
            cos_t_p = jnp.power(u2, 1.0 / (exponent + 1.0))
        sin_t_p = _safe_sqrt(1.0 - cos_t_p * cos_t_p)
        cphi = jnp.cos(phi)
        lobe = V3(cphi * sin_t_p, _sin_from_phi_cos(cphi, u1) * sin_t_p,
                  cos_t_p)
        s_f, t_f, n_f = make_frame(mirror_wi)
        wi_ph = to_world(s_f, t_f, n_f, lobe)
        wi_ph = V3(wi_ph.x, wi_ph.y, jnp.where(wo.z < 0, -wi_ph.z, wi_ph.z))
        cos_alpha = jnp.maximum(mirror_wi.dot(wi_ph), 0.0)
        same_ph = wo.z * wi_ph.z > 0
        if static_exp is not None:
            powa = _ipow(cos_alpha, int(static_exp))
            e2 = np.float32((static_exp + 2.0) * km.INV_2PI)
            e1 = np.float32((static_exp + 1.0) * km.INV_2PI)
        else:
            powa = jnp.power(cos_alpha, exponent)
            e2 = (exponent + 2.0) * np.float32(km.INV_2PI)
            e1 = (exponent + 1.0) * np.float32(km.INV_2PI)
        ph_val = jnp.where(same_ph, e2 * powa, 0.0)
        pdf_ph = e1 * powa
        cand[kbsdf.PHONG] = (wi_ph, color * ph_val, pdf_ph, ph_val)

    order = [k for k in (kbsdf.LAMBERT, kbsdf.MIRROR, kbsdf.GLASS,
                         kbsdf.PHONG) if k in cand]
    wi, f, pdf, f_unit = cand[order[-1]]
    for k in reversed(order[:-1]):
        is_k = kind == k
        wi_k, f_k, pdf_k, unit_k = cand[k]
        wi = wi_k.where(is_k, wi)
        f = f_k.where(is_k, f)
        pdf = jnp.where(is_k, pdf_k, pdf)
        f_unit = jnp.where(is_k, unit_k, f_unit)

    false_mask = u1 < -1.0   # statically-absent lobes: mask from a compare
    is_gls = (kind == kbsdf.GLASS) if kbsdf.GLASS in cand else false_mask
    is_mir = (kind == kbsdf.MIRROR) if kbsdf.MIRROR in cand else false_mask
    delta = is_mir | is_gls
    glass_refract = (is_gls & ~take_refl) if take_refl is not None \
        else false_mask
    return f, wi, pdf, delta, f_unit, glass_refract


def _bsdf_eval_pdf(kind, color: V3, exponent, wo: V3, wi: V3,
                   lobes=frozenset((kbsdf.LAMBERT, kbsdf.PHONG)),
                   static_exp=None):
    """Local-frame eval + pdf for the non-delta lobes (bsdf.py:136-162).

    Returns (f: V3, pdf, f_unit) with f == color * f_unit; only the
    statically-present lobes are compiled."""
    same = wo.z * wi.z > 0
    has_lam = kbsdf.LAMBERT in lobes
    has_ph = kbsdf.PHONG in lobes

    unit_lam = pdf_lam = None
    if has_lam:
        unit_lam = jnp.where(same, np.float32(km.INV_PI), 0.0)
        pdf_lam = jnp.where(same, jnp.abs(wi.z) * np.float32(km.INV_PI), 0.0)

    ph = pdf_ph = None
    if has_ph:
        wr = V3(-wo.x, -wo.y, wo.z)
        cos_alpha = jnp.maximum(wr.dot(wi), 0.0)
        if static_exp is not None:
            powa = _ipow(cos_alpha, int(static_exp))
            e2 = np.float32((static_exp + 2.0) * km.INV_2PI)
            e1 = np.float32((static_exp + 1.0) * km.INV_2PI)
        else:
            powa = jnp.power(cos_alpha, exponent)
            e2 = (exponent + 2.0) * np.float32(km.INV_2PI)
            e1 = (exponent + 1.0) * np.float32(km.INV_2PI)
        ph = jnp.where(same, e2 * powa, 0.0)
        pdf_ph = e1 * powa

    zero = jnp.zeros_like(wo.x)
    if has_lam and has_ph:
        is_lam = kind == kbsdf.LAMBERT
        is_ph = kind == kbsdf.PHONG
        f_unit = jnp.where(is_lam, unit_lam, jnp.where(is_ph, ph, 0.0))
        pdf = jnp.where(is_lam, pdf_lam, jnp.where(is_ph, pdf_ph, 0.0))
    elif has_lam:
        is_lam = kind == kbsdf.LAMBERT
        f_unit = jnp.where(is_lam, unit_lam, 0.0)
        pdf = jnp.where(is_lam, pdf_lam, 0.0)
    elif has_ph:
        is_ph = kind == kbsdf.PHONG
        f_unit = jnp.where(is_ph, ph, 0.0)
        pdf = jnp.where(is_ph, pdf_ph, 0.0)
    else:
        f_unit = zero
        pdf = zero
    return color * f_unit, pdf, f_unit


def _bsdf_eval_pdf_dots(kind, exponent, wo_z, wi_z, cos_alpha,
                        lobes=frozenset((kbsdf.LAMBERT, kbsdf.PHONG)),
                        static_exp=None):
    """_bsdf_eval_pdf on precomputed frame-invariant dot products.

    The lambert/phong eval depends on the local wi only through wi_l.z
    (= n.wi, already computed for the shadow sweep) and the mirror dot
    cos_alpha (= reflect(wo, n).wi, frame-invariant) — so the all-lights
    NEE block can skip the per-light to_local entirely (~15 ops per
    light per bounce on veach). Returns (pdf, f_unit)."""
    same = wo_z * wi_z > 0
    has_lam = kbsdf.LAMBERT in lobes
    has_ph = kbsdf.PHONG in lobes

    unit_lam = pdf_lam = None
    if has_lam:
        unit_lam = jnp.where(same, np.float32(km.INV_PI), 0.0)
        pdf_lam = jnp.where(same, jnp.abs(wi_z) * np.float32(km.INV_PI),
                            0.0)

    ph = pdf_ph = None
    if has_ph:
        cos_a = jnp.maximum(cos_alpha, 0.0)
        if static_exp is not None:
            powa = _ipow(cos_a, int(static_exp))
            e2 = np.float32((static_exp + 2.0) * km.INV_2PI)
            e1 = np.float32((static_exp + 1.0) * km.INV_2PI)
        else:
            powa = jnp.power(cos_a, exponent)
            e2 = (exponent + 2.0) * np.float32(km.INV_2PI)
            e1 = (exponent + 1.0) * np.float32(km.INV_2PI)
        ph = jnp.where(same, e2 * powa, 0.0)
        pdf_ph = e1 * powa

    zero = jnp.zeros_like(wo_z)
    if has_lam and has_ph:
        is_lam = kind == kbsdf.LAMBERT
        is_ph = kind == kbsdf.PHONG
        f_unit = jnp.where(is_lam, unit_lam, jnp.where(is_ph, ph, 0.0))
        pdf = jnp.where(is_lam, pdf_lam, jnp.where(is_ph, pdf_ph, 0.0))
    elif has_lam:
        is_lam = kind == kbsdf.LAMBERT
        f_unit = jnp.where(is_lam, unit_lam, 0.0)
        pdf = jnp.where(is_lam, pdf_lam, 0.0)
    elif has_ph:
        is_ph = kind == kbsdf.PHONG
        f_unit = jnp.where(is_ph, ph, 0.0)
        pdf = jnp.where(is_ph, pdf_ph, 0.0)
    else:
        f_unit = zero
        pdf = zero
    return pdf, f_unit


# -- lights (plane port of kytpu/light/lights.py) ----------------------------


def _one_minus_cos(sin2, cos):
    """1 - cos from sin^2 = 1 - cos^2 without cancellation."""
    return sin2 / (1.0 + cos)


def _light_sample(lt, world_radius, p: V3, n_shade: V3, u1, u2, azim=None):
    """sample_Li for baked light lt. Returns (wi, pdf, li_scalar, dist,
    phit).

    The incident radiance factors as Li = emit (x) li_scalar with emit the
    light's (traced, table) color triple and li_scalar a per-lane scalar
    plane — the factorization the coefficient-cache backward stores one
    plane per light of (see _make_bwd_res_kernel).

    phit: the light's solid-angle pdf for a BSDF ray leaving p, when that
    pdf is DIRECTION-FREE (uniform-cone sphere lights: 1/(2pi(1-cos_max)),
    0 inside) — the kernel carries it to the next bounce and skips the
    per-bounce _hit_light_pdf recomputation (the extension origin differs
    from p only by the ±1e-2 offset, which _hit_light_pdf's contract
    already calls inside MC noise). None when the pdf depends on the
    direction (rect area lights, inside-branch spheres): callers fall
    back to _hit_light_pdf.

    azim: optional precomputed (cos(2*pi*u2), sin(2*pi*u2)) planes — the
    sphere/env azimuth transcendentals depend only on the shared u2 draw,
    so the all-lights NEE block computes them ONCE for every light."""
    kind = lt["kind"]
    if kind == klights.POINT:
        lp = _cv3(lt["position"])
        vec = lp - p
        d2 = jnp.maximum(vec.length_squared(), 1e-20)
        dist = jnp.sqrt(d2)
        wi = vec * (1.0 / dist)
        return wi, jnp.ones_like(u1), 1.0 / d2, dist, jnp.zeros_like(u1)

    if kind == klights.DIRECTION:
        dr = _cv3(lt["direction"])
        wi = v3_full(u1, -dr.x, -dr.y, -dr.z)
        dist = jnp.full_like(u1, np.float32(2.0 * world_radius))
        return (wi, jnp.ones_like(u1), jnp.ones_like(u1), dist,
                jnp.zeros_like(u1))

    if kind == klights.AREA_RECT:
        p0, p1, p2 = _cv3(lt["p0"]), _cv3(lt["p1"]), _cv3(lt["p2"])
        n_l = _cv3(lt["normal"])
        area = np.float32(lt["area"])
        lp = p1 + (p0 - p1) * u1 + (p2 - p1) * u2
        vec = lp - p
        d2 = jnp.maximum(vec.length_squared(), 1e-20)
        dist = jnp.sqrt(d2)
        wi = vec * (1.0 / dist)
        cos_l = n_l.dot(-wi)
        pdf = _safe_div(d2, jnp.abs(cos_l) * area)
        facing = cos_l > 0
        li_s = jnp.where(facing, np.float32(1.0), np.float32(0.0))
        pdf = jnp.where(facing & (pdf > 0) & jnp.isfinite(pdf), pdf, 0.0)
        return wi, pdf, li_s, dist, None

    if kind == klights.AREA_SPHERE:
        c = _cv3(lt["center"])
        r = np.float32(lt["radius"])
        vec_c = c - p
        d2c = jnp.maximum(vec_c.length_squared(), 1e-20)
        inv_dc = jax.lax.rsqrt(d2c)
        dist_c = d2c * inv_dc
        inv_d2c = inv_dc * inv_dc   # ~2ulp of 1/d2c; saves a divide

        # outside: cone sampling with Taylor fallback (ky.cpp:1419-1501).
        # The reference's angle-at-center construction (cos_alpha =
        # sin2*dc/r + cos_t*sqrt(1 - sin2*(dc/r)^2), lp = c + r*n_cone) is
        # the law-of-cosines route to the NEAREST cone-ray/sphere
        # intersection, so we take the direct route: the sampled point is
        # p + wi*ds with ds = dc*cos_t - sqrt(r^2 - d2c*sin2) — identical
        # mapping (u1,u2) -> lp with 4 fewer sqrt/div ops and no final
        # normalization (wi comes straight from the cone frame).
        sin2_max = jnp.minimum(r * r * inv_d2c, 1.0)
        cos_max = _safe_sqrt(1.0 - sin2_max)
        # 1 - cos in cancellation-free form: for small lights 1 - cos_max
        # is ~1e-5, where the naive difference keeps ~2 significant digits
        # and the pdf then depends on how the sqrt rounds (the reference's
        # Taylor fallback, ky.cpp:1419-1501, covered the same ill
        # conditioning for the sample; this form covers it for both)
        omc_max = _one_minus_cos(sin2_max, cos_max)
        omc = omc_max * u1                       # 1 - cos_t
        cos_t = 1.0 - omc
        sin2 = omc * (2.0 - omc)
        sin_t = _safe_sqrt(sin2)
        if azim is None:
            cphi = jnp.cos(u2 * np.float32(km.TWO_PI))
            sphi = _sin_from_phi_cos(cphi, u2)
        else:
            cphi, sphi = azim
        to_c = vec_c * inv_dc
        s_f, t_f, n_f = make_frame(to_c)
        # azimuth mirrored (phi + pi) to land on the reference's exact
        # (u1,u2) -> point mapping (its n_cone negates the tangent axes)
        wi_cone = s_f * (-sin_t * cphi) + t_f * (-sin_t * sphi) \
            + n_f * cos_t
        depth2 = r * r - d2c * sin2
        ds = dist_c * cos_t - _safe_sqrt(depth2)
        q_cone = np.float32(km.TWO_PI) * omc_max
        pdf_cone = jnp.where(q_cone > 0.0, np.float32(1.0) / q_cone, 0.0)
        # the surface cosine at the sampled point is sqrt(depth2)/r, so
        # "facing" (n_l.(-wi) > 0, ky.cpp:1497) is just depth2 > 0
        outside = d2c > r * r
        ok_cone = (depth2 > 0) & (q_cone > 0.0) & outside

        if not lt.get("inside_possible", True):
            # no scene surface can sit strictly inside this light's ball
            # (extract_static proof); boundary points (a path re-scattering
            # off the light's own surface) take NO NEE toward it — and the
            # matching _hit_light_pdf returns 0 there, so MIS routes full
            # weight to BSDF sampling. Unbiased, and the whole uniform-area
            # branch below compiles away.
            li_s = jnp.where(ok_cone, np.float32(1.0), np.float32(0.0))
            phit = jnp.where(outside, pdf_cone, np.float32(0.0))
            return wi_cone, pdf_cone, li_s, ds, phit

        # inside: uniform area sample (ky.cpp:1422-1443)
        inside = ~outside
        z_u = 1.0 - 2.0 * u1
        r_u = _safe_sqrt(1.0 - z_u * z_u)
        dir_u = V3(r_u * cphi, r_u * sphi, z_u)
        lp_in = c + dir_u * r
        vec_in = lp_in - p
        d2_in = jnp.maximum(vec_in.length_squared(), 1e-20)
        inv_d_in = jax.lax.rsqrt(d2_in)
        wi_in = vec_in * inv_d_in
        area = np.float32(4.0 * np.pi * r * r)
        pdf_in = _safe_div(d2_in, area * jnp.abs(n_shade.dot(-wi_in)))
        pdf_in = jnp.where(jnp.isfinite(pdf_in), pdf_in, 0.0)
        ok_in = (dir_u.dot(-wi_in) > 0) & (pdf_in > 0)

        wi = wi_in.where(inside, wi_cone)
        pdf = jnp.where(inside, pdf_in, pdf_cone)
        ok = jnp.where(inside, ok_in, ok_cone)
        dist = jnp.where(inside, d2_in * inv_d_in, ds)
        li_s = jnp.where(ok, np.float32(1.0), np.float32(0.0))
        return wi, pdf, li_s, dist, None

    if kind == klights.ENV:
        # replicated reference quirk: uniform-sphere direction, angle-space
        # pdf (ky.cpp:3029-3035)
        z_u = 1.0 - 2.0 * u1
        r_u = _safe_sqrt(1.0 - z_u * z_u)
        if azim is None:
            cphi = jnp.cos(np.float32(km.TWO_PI) * u2)
            sphi = _sin_from_phi_cos(cphi, u2)
        else:
            cphi, sphi = azim
        wi = V3(r_u * cphi, r_u * sphi, z_u)
        sin_theta = _safe_sqrt(1.0 - wi.z * wi.z)
        pdf = jnp.where(sin_theta == 0.0, 0.0,
                        np.float32(1.0 / (2.0 * np.pi * np.pi))
                        / jnp.maximum(sin_theta, 1e-20))
        dist = jnp.full_like(u1, np.float32(2.0 * world_radius))
        return wi, pdf, jnp.ones_like(u1), dist, jnp.zeros_like(u1)

    raise ValueError(f"unknown light kind {kind}")


def _hit_light_pdf(lights, li_idx, o: V3, d: V3, t, nrm):
    """Solid-angle pdf of the area light the extension ray hit, computed
    FROM the hit record instead of re-intersecting every light
    (_light_pdf): the squared distance is t^2 and the light-surface cosine
    is |nrm.d|. Equal to the reference's re-intersection form
    (ky.cpp:1055-1090) up to its double ray-origin offset (~1e-2), which is
    inside MC noise. The inside-a-sphere-light case uses the hit surface's
    own record, which coincides with the light's shape except under the
    veach replicate_reference_swap quirk — where a shading point inside a
    light sphere does not occur.
    """
    pdf = jnp.zeros_like(t)
    t2 = t * t
    cos_l = jnp.abs(nrm.dot(d))
    for i, lt in enumerate(lights):
        kind = lt["kind"]
        if kind not in (klights.AREA_RECT, klights.AREA_SPHERE):
            continue
        if kind == klights.AREA_RECT:
            pi = _safe_div(t2, cos_l * np.float32(lt["area"]))
        else:
            c = _cv3(lt["center"])
            r = np.float32(lt["radius"])
            d2c = jnp.maximum((c - o).length_squared(), 1e-20)
            inside = d2c <= r * r
            sin2_max = jnp.minimum(r * r / d2c, 1.0)
            cos_max = _safe_sqrt(1.0 - sin2_max)
            pdf_cone = _safe_div(np.float32(1.0), np.float32(km.TWO_PI)
                                 * _one_minus_cos(sin2_max, cos_max))
            pdf_cone = jnp.where(jnp.isfinite(pdf_cone), pdf_cone, 0.0)
            if not lt.get("inside_possible", True):
                # matches _light_sample's no-NEE-from-the-boundary rule:
                # pdf 0 inside => the MIS weight of a BSDF-sampled hit is 1
                pi = jnp.where(inside, np.float32(0.0), pdf_cone)
            else:
                area = np.float32(4.0 * np.pi * lt["radius"] ** 2)
                pdf_in = _safe_div(t2, cos_l * area)
                pi = jnp.where(inside, pdf_in, pdf_cone)
        pdf = jnp.where(li_idx == i, pi, pdf)
    return pdf


def _light_pdf(lt, p: V3, n_shade: V3, wi: V3):
    """pdf_Li for baked light lt (lights.py:232-266)."""
    kind = lt["kind"]
    if kind in (klights.POINT, klights.DIRECTION):
        return jnp.zeros_like(p.x)

    if kind == klights.AREA_RECT:
        p0, p1 = _cv3(lt["p0"]), _cv3(lt["p1"])
        p2, p3 = _cv3(lt["p2"]), _cv3(lt["p3"])
        n_l = _cv3(lt["normal"])
        area = np.float32(lt["area"])
        o = _offset_origin(p, n_shade, wi)
        oa = p0 - o
        ob = p1 - o
        oc = p2 - o
        od = p3 - o
        v0d = oc.cross(ob).dot(wi)
        v1d = ob.cross(oa).dot(wi)
        v2d = oa.cross(od).dot(wi)
        v3d = od.cross(oc).dot(wi)
        inside = ((v0d < 0) & (v1d < 0) & (v2d < 0) & (v3d < 0)) | \
                 ((v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0))
        t = _safe_div(n_l.dot(oa), n_l.dot(wi), np.float32(np.inf))
        hit = inside & (t > km.SHAPE_EPSILON) & jnp.isfinite(t)
        hp = o + wi * t
        d2 = (hp - p).length_squared()
        pdf = _safe_div(d2, jnp.abs(n_l.dot(-wi)) * area)
        return jnp.where(hit & jnp.isfinite(pdf), pdf, 0.0)

    if kind == klights.AREA_SPHERE:
        c = _cv3(lt["center"])
        r = np.float32(lt["radius"])
        d2c = jnp.maximum((c - p).length_squared(), 1e-20)
        inside = d2c <= r * r
        sin2_max = jnp.minimum(r * r / d2c, 1.0)
        cos_max = _safe_sqrt(1.0 - sin2_max)
        pdf_cone = _safe_div(np.float32(1.0), np.float32(km.TWO_PI)
                             * _one_minus_cos(sin2_max, cos_max))
        pdf_cone = jnp.where(jnp.isfinite(pdf_cone), pdf_cone, 0.0)
        if not lt.get("inside_possible", True):
            # boundary/inside points take no NEE toward this light
            # (see _light_sample) — pdf 0 keeps MIS weights consistent
            return jnp.where(inside, np.float32(0.0), pdf_cone)
        # inside: re-intersect pdf
        o = _offset_origin(p, n_shade, wi)
        oc = c - o
        neg_b = oc.dot(wi)
        discr = neg_b * neg_b - oc.length_squared() + r * r
        sq = _safe_sqrt(discr)
        t1, t2 = neg_b - sq, neg_b + sq
        t1_ok = t1 > km.SHAPE_EPSILON
        t2_ok = t2 > km.SHAPE_EPSILON
        t = jnp.where(t1_ok, t1, t2)
        hit = (discr >= 0) & (t1_ok | t2_ok)
        hp = o + wi * t
        n_hit = (hp - c).normalize()
        area = np.float32(4.0 * np.pi * r * r)
        pdf_in = _safe_div((hp - p).length_squared(),
                           jnp.abs(n_hit.dot(-wi)) * area)
        pdf_in = jnp.where(hit & jnp.isfinite(pdf_in), pdf_in, 0.0)
        return jnp.where(inside, pdf_in, pdf_cone)

    if kind == klights.ENV:
        sin_theta = _safe_sqrt(1.0 - wi.z * wi.z)
        return jnp.where(sin_theta == 0.0, 0.0,
                         np.float32(1.0 / (2.0 * np.pi * np.pi))
                         / jnp.maximum(sin_theta, 1e-20))

    raise ValueError(f"unknown light kind {kind}")


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def store_texel_planes(ref, bounce, static, sid, xyi, adj: V3):
    """Write one shading bounce's texture-adjoint planes (TEX_PLANES):
    the hit's (x, y, img) and the diffuse-value adjoint, masked to lanes
    on image-textured rows."""
    on_img = sid < -1   # statically-false mask
    for rec in static["textures"]:
        if rec.get("kind") == "image":
            on_img = on_img | (sid == rec["row"])
    base = TEX_PLANES * bounce
    for k, v in enumerate(xyi):
        ref[base + k] = v
    for k, v in enumerate((adj.x, adj.y, adj.z)):
        ref[base + 3 + k] = jnp.where(on_img, v, 0.0)


def _route_checker_adjoint(static, sid, even_of, adj: V3, acc_ta, acc_tb):
    """Add the diffuse-value adjoint of checker-textured lanes to the
    color_a/color_b accumulators by cell parity (even_of: per-rec even
    masks, or one shared even-mask plane); return the adjoint with every
    textured row's share zeroed (the diffuse table is unused there)."""
    for i, rec in enumerate(static["textures"]):
        onrow = sid == rec["row"]
        if rec.get("kind") != "image":
            even = even_of[i] if isinstance(even_of, list) else even_of
            t = rec["tex"]
            acc_ta[t] = acc_ta[t] + adj.where(onrow & even, v3_zeros(adj.x))
            acc_tb[t] = acc_tb[t] + adj.where(onrow & ~even, v3_zeros(adj.x))
        adj = v3_zeros(adj.x).where(onrow, adj)
    return adj


def _partial_planes(acc_d, acc_s, acc_e, acc_env, acc_x, acc_tex):
    """Flatten the backward's per-lane accumulators in _unpack_partials'
    order: diffuse, specular, emission (3 per row), env (3), exponent (1
    per row), checker color_a then color_b (3 per texture)."""
    planes = []
    for acc in (acc_d, acc_s, acc_e, [acc_env]):
        for v in acc:
            planes.extend([v.x, v.y, v.z])
    if acc_x is not None:
        planes.extend(acc_x)
    if acc_tex is not None:
        for acc in acc_tex:
            for v in acc:
                planes.extend([v.x, v.y, v.z])
    return planes


def _n_partials(m_rows: int, t_rows: int, texp: bool) -> int:
    return 9 * m_rows + 3 + (m_rows if texp else 0) + 6 * t_rows


def _unpack_partials(parts, m_rows: int, t_rows: int, texp: bool):
    """(grid, P_pad) partial table -> (dd, ds, de, denv, dexp|None,
    dta|None, dtb|None)."""
    v = sum_partials(parts, _n_partials(m_rows, t_rows, texp))
    m3 = 3 * m_rows
    dd = v[0:m3].reshape(m_rows, 3)
    ds = v[m3:2 * m3].reshape(m_rows, 3)
    de = v[2 * m3:3 * m3].reshape(m_rows, 3)
    denv = v[3 * m3:3 * m3 + 3]
    off = 3 * m3 + 3
    dexp = None
    if texp:
        dexp = v[off:off + m_rows]
        off += m_rows
    dta = dtb = None
    if t_rows:
        dta = v[off:off + 3 * t_rows].reshape(t_rows, 3)
        dtb = v[off + 3 * t_rows:off + 6 * t_rows].reshape(t_rows, 3)
    return dd, ds, de, denv, dexp, dta, dtb


def _full_mis(bounce, spec_prev, has_delta):
    """Whether the emission found at this bounce takes full weight (camera
    rays and rays leaving a delta lobe): a python bool where `bounce` is a
    python int, else a traced mask."""
    if isinstance(bounce, int):
        if bounce == 0:
            return True
        return (spec_prev != 0) if has_delta else False
    first = bounce == 0
    return (first | (spec_prev != 0)) if has_delta else first


def _rr_active(bounce, cfg: KernelConfig):
    """Russian roulette at this bounce: python bool, or a traced scalar
    mask inside the bounce loop (False when no loop bounce reaches it)."""
    if isinstance(bounce, int):
        return bounce > cfg.rr_start
    if cfg.max_depth - 1 <= cfg.rr_start:
        return False
    return bounce > cfg.rr_start


def _bounce_mix(bounce):
    """Per-bounce odd-constant mix of the nee="single" light pick."""
    return (jnp.asarray(bounce, jnp.int32) * np.int32(668265263)) \
        & np.int32(0x7fffffff)


def _lights_have_phit(lights, world_radius) -> bool:
    """Whether every light's sample carries a direction-free hit pdf
    (_light_sample's phit, a static property of the light kind)."""
    def probe(lt):
        z = jnp.zeros((1, LANE), jnp.float32)
        return _light_sample(lt, world_radius, V3(z, z, z),
                             V3(z, z, z + 1.0), z, z)[4]
    return all(jax.eval_shape(lambda lt=lt: probe(lt)) is not None
               for lt in lights)


def _affine_index(layout, max_depth):
    """index(tag) for a per-bounce plane layout whose non-horizon bounces
    all hold the same planes: tag = (name, bounce, *rest), bounce a python
    int (looked up) or traced (bounce * per_bounce + offset)."""
    if max_depth == 0:
        return lambda tag: layout[tag]
    per_b = sum(1 for tag in layout if tag[1] == 0)
    offs = {}
    for tag, k in layout.items():
        name, b, *rest = tag
        if b == 0:
            offs[(name, *rest)] = k
    for tag, k in layout.items():
        name, b, *rest = tag
        if b < max_depth:
            assert k == b * per_b + offs[(name, *rest)], tag

    def index(tag):
        name, b, *rest = tag
        if isinstance(b, int):
            return layout[tag]
        return b * per_b + offs[(name, *rest)]
    return index


def _residual_layout(static, cfg: KernelConfig):
    """Plane order of the coefficient cache written by the residual forward
    and consumed by _make_bwd_res_kernel. Returns ({tag: index}, count).

    Per bounce the cache stores: "wb" (hit-emission MIS weight, fully
    masked), "wenv" (env-miss weight, env scenes), one "B" plane per NEE
    light (B' = li_scalar * f_unit * |cos| * okf * lobe_scale — every NEE
    radiance/adjoint term is bilinear in (table color, light emit) with
    coefficient B'), and "tu" (extension throughput unit incl. lobe scale,
    pdf division, RR compensation, alive mask). One extra int32 plane per
    bounce packs sid+1 (bits 0-7), lobe_is_phong (bit 8), to_spec_t (bit 9).

    With cfg.trainable_exponent (+ a glossy material) each "B"/"tu" plane
    gets a kappa-weighted partner "Bk"/"tuk" = plane * (1/(e+2) + log
    cos_a), pre-masked to phong lanes — the exponent adjoint is then as
    bilinear in the cache as the color adjoints, and the backward never
    needs the exponent itself.

    Image-textured scenes add two planes per shading bounce: "tx"/"ty",
    the continuous texel coordinates of the hit on its image row (0
    elsewhere) — the backward rebuilds the 4 bilinear taps + weights from
    them (pure floor/mask/FMA), so the diffuse VALUE and the per-texel
    adjoints never need re-intersection.
    """
    has_env = any(lt["kind"] == klights.ENV for lt in static["lights"])
    has_img = any(r.get("kind") == "image"
                  for r in static.get("textures", []))
    n_b = 1 if (cfg.nee == "single" and len(static["lights"]) > 1) \
        else len(static["lights"])
    texp = cfg.trainable_exponent
    tags = []
    for b in range(cfg.max_depth + 1):
        tags.append(("wb", b))
        if has_env:
            tags.append(("wenv", b))
        if b < cfg.max_depth:
            for i in range(n_b):
                tags.append(("B", b, i))
                if texp:
                    tags.append(("Bk", b, i))
            tags.append(("tu", b))
            if texp:
                tags.append(("tuk", b))
            if has_img:
                tags.append(("tx", b))
                tags.append(("ty", b))
    return {t: k for k, t in enumerate(tags)}, len(tags)


def _make_kernel(static, cfg: KernelConfig, grad: bool = False,
                 residual: bool = False):
    """Build the kernel body.

    grad=False, residual=False: forward — writes (Lx, Ly, Lz) planes.
    grad=False, residual=True: forward + coefficient cache — additionally
    writes the residual planes of _residual_layout, from which the
    backward recovers every adjoint without re-tracing (the production
    backward; see _make_bwd_res_kernel).
    grad=True:  path-replay backward (PRB, Vicini et al. 2021 style, under
    detached sampling): replays the exact forward RNG stream, maintains the
    per-channel tail radiance R_b = E_b + T_b * R_{b+1} seeded with the
    forward output L, and accumulates the adjoints of every linear-in-color
    factor — emission (hit + NEE light terms), diffuse and specular tables —
    scaled by the upstream cotangent g. Outputs one row per program of
    the (grid, P) partial table (_partial_layout), plus the per-lane
    texture-adjoint planes (TEX_PLANES per shading bounce) on
    image-textured scenes. Kept as the O(1)-memory backward
    (backward="replay").
    """
    mats = static["mats"]
    lights = static["lights"]
    M = len(mats["kind"])
    L = len(lights)
    tex_recs = static.get("textures", [])
    n_tex = static.get("n_textures", 0) if tex_recs else 0
    img_recs = [r for r in tex_recs if r.get("kind") == "image"]
    world_radius = static["world_radius"]
    lobes = mats["lobes"]
    eval_lobes = lobes & {kbsdf.LAMBERT, kbsdf.PHONG}
    static_exp = _static_exponent(mats)
    has_plastic = kbsdf.MAT_PLASTIC in mats["kind"]
    has_glass = kbsdf.MAT_GLASS in mats["kind"]
    has_delta = bool(lobes & {kbsdf.MIRROR, kbsdf.GLASS})
    # adjoint-eligible rows: a matte row never reads the specular table, a
    # mirror row never reads the diffuse table — their adjoints are
    # identically zero and are pruned from the backward accumulation loops
    rows_d = [m for m in range(M) if mats["kind"][m] != kbsdf.MAT_MIRROR]
    rows_s = [m for m in range(M) if mats["kind"][m] != kbsdf.MAT_MATTE]
    # emission lives only on light-bound surface rows (the reference's
    # emission comes from the area_light binding, ky.cpp:3084): non-light
    # rows are structurally zero, so the hit-emission select and its
    # adjoint scatter skip them
    rows_e = [m for m in range(M) if mats["light_index"][m] >= 0]
    env_i = next((i for i, lt in enumerate(lights)
                  if lt["kind"] == klights.ENV), None)
    # light index -> emitting surface row (for NEE emission adjoints)
    light_row = {}
    for m in range(M):
        li = mats["light_index"][m]
        if li >= 0 and li not in light_row:
            light_row[li] = m
    # robust shadow mode: statically drop each light's OWN geometry from its
    # NEE occlusion rays (a convex emitter can never legitimately occlude
    # its own near-side samples; under parity it spuriously does, see
    # extract_static's NB). Free at runtime — pruned rows just vanish from
    # the unrolled sweep.
    n_pl = len(static["planar"])
    if cfg.shadow == "robust":
        occl_skips, sph_skips = [], []
        for i in range(L):
            rows = set(static["occl_skip"][i])
            ss = set()
            r = light_row.get(i, -1)
            if 0 <= r < n_pl:
                rows.add(r)
            elif r >= n_pl:
                ss.add(r - n_pl)
            occl_skips.append(frozenset(rows))
            sph_skips.append(frozenset(ss))
    else:
        occl_skips = static["occl_skip"]
        sph_skips = None
    if residual:
        res_ix, res_n = _residual_layout(static, cfg)

    use_sobol = cfg.sampler == "sobol"
    use_hash = cfg.sampler == "hash"
    use_texp = cfg.trainable_exponent
    if use_texp:
        static_exp = None   # exponents come from the traced table
        rows_x = [m for m in range(M)
                  if mats["kind"][m] == kbsdf.MAT_PLASTIC]

    carry_phits = not (cfg.nee == "single" and L > 1) \
        and _lights_have_phit(lights, world_radius)
    if residual:
        ridx = _affine_index(res_ix, cfg.max_depth)

    def kernel(*refs):
        resf_ref = resi_ref = None
        (seed_ref, diffuse_ref, specular_ref, emission_ref) = refs[:4]
        rest = list(refs[4:])
        exponent_ref = rest.pop(0) if use_texp else None
        texa_ref = rest.pop(0) if tex_recs else None
        texb_ref = rest.pop(0) if tex_recs else None
        timg_ref = rest.pop(0) if img_recs else None
        (light_emit_ref, env_ref,
         ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref) = rest[:8]
        rest = rest[8:]
        if use_sobol or use_hash:
            si_ref = rest.pop(0)    # per-lane sample index (int32)
            pix_ref = rest.pop(0)   # per-lane pixel id (int32)
        if grad:
            (gx_ref, gy_ref, gz_ref, flx_ref, fly_ref, flz_ref,
             part_ref) = rest[:7]
            tadj_ref = rest[7] if img_recs else None
        elif residual:
            (lx_ref, ly_ref, lz_ref, resf_ref, resi_ref) = rest
            # residual planes are stored as they are computed
            # (resf_ref[k] = plane): no held-live plane list
        else:
            (lx_ref, ly_ref, lz_ref) = rest
        pid = pl.program_id(0)
        tile_seed = seed_ref[0] + pid * np.int32(2654435761 & 0x7fffffff)
        if use_sobol:
            rng = _Rng(tile_seed,
                       sobol=(si_ref[:], _pix_hash(pix_ref[:], seed_ref[0])))
        elif use_hash:
            # mesh-invariant stateless streams: per-lane key from
            # (render seed, pixel id, sample id), independent of tile/device
            lane_seed = _pix_hash(si_ref[:],
                                  _pix_hash(pix_ref[:], seed_ref[0]))
            rng = _Rng(lane_seed, per_lane=True)
        else:
            rng = _Rng(tile_seed)

        o = V3(ox_ref[:], oy_ref[:], oz_ref[:])
        d = V3(dx_ref[:], dy_ref[:], dz_ref[:])
        shp = o.x.shape
        beta = v3_full(o.x, 1.0, 1.0, 1.0)
        big_l = v3_zeros(o.x)
        alive = jnp.zeros(shp, jnp.float32) < 1.0
        # carried masks live as int32 planes
        spec_prev = jnp.zeros(shp, jnp.int32)
        pdf_prev = jnp.ones(shp, jnp.float32)
        # previous bounce's direction-free per-light hit pdfs (see
        # _light_sample phit); None until a NEE block provides them all
        phits_prev = None

        if grad:
            g = V3(gx_ref[:], gy_ref[:], gz_ref[:])
            r_tail = V3(flx_ref[:], fly_ref[:], flz_ref[:])
            acc_d = [v3_zeros(o.x) for _ in range(M)]
            acc_s = [v3_zeros(o.x) for _ in range(M)]
            acc_e = [v3_zeros(o.x) for _ in range(M)]
            acc_env = v3_zeros(o.x)   # d env_radiance (env light only)
            if use_texp:
                acc_x = [jnp.zeros(shp, jnp.float32) for _ in range(M)]
            if tex_recs:
                acc_ta = [v3_zeros(o.x) for _ in range(n_tex)]
                acc_tb = [v3_zeros(o.x) for _ in range(n_tex)]

            def row_add(acc, rows, sid, val: V3):
                for m in rows:
                    mrow = sid == m
                    acc[m] = V3(acc[m].x + jnp.where(mrow, val.x, 0.0),
                                acc[m].y + jnp.where(mrow, val.y, 0.0),
                                acc[m].z + jnp.where(mrow, val.z, 0.0))

            def row_add1(acc, rows, sid, val):
                for m in rows:
                    acc[m] = acc[m] + jnp.where(sid == m, val, 0.0)

        def step(bounce, st):
            """One bounce; `bounce` is the fori_loop's traced index, or the
            python int max_depth for the horizon vertex."""
            horizon = isinstance(bounce, int) and bounce == cfg.max_depth
            o, d, beta, big_l = st["o"], st["d"], st["beta"], st["big_l"]
            alive = st["alive"] != 0
            spec_prev, pdf_prev = st["spec_prev"], st["pdf_prev"]
            phits_prev = st.get("phits")
            if grad:
                r_tail, acc_env = st["r_tail"], st["acc_env"]
                acc_d, acc_s, acc_e = (list(st[k]) for k in
                                       ("acc_d", "acc_s", "acc_e"))
                acc_x = list(st["acc_x"]) if use_texp else None
                acc_ta = list(st["acc_ta"]) if tex_recs else None
                acc_tb = list(st["acc_tb"]) if tex_recs else None
            else:
                acc_e = acc_env = None

            def pack():
                out = dict(o=o, d=d, beta=beta, big_l=big_l,
                           alive=alive.astype(jnp.int32),
                           spec_prev=spec_prev, pdf_prev=pdf_prev)
                if carry_phits:
                    out["phits"] = list(phits_prev)
                if grad:
                    out.update(r_tail=r_tail, acc_d=acc_d, acc_s=acc_s,
                               acc_e=acc_e, acc_env=acc_env)
                    if use_texp:
                        out["acc_x"] = acc_x
                    if tex_recs:
                        out.update(acc_ta=acc_ta, acc_tb=acc_tb)
                return out

            rng.at_bounce(bounce)
            t, sid, valid, nrm = _closest_hit(static, o, d)
            t_safe = jnp.where(valid, t, 1.0)
            hp = o + d * t_safe
            wo = -d

            # one-sided emission of the hit surface
            facing = nrm.dot(wo) > 0.0
            emit_v = _select_table3(sid, emission_ref, rows_e)
            emit_mask = valid & facing
            le = V3(jnp.where(emit_mask, emit_v.x, 0.0),
                    jnp.where(emit_mask, emit_v.y, 0.0),
                    jnp.where(emit_mask, emit_v.z, 0.0))

            # MIS weight vs the pdf of the light this ray found, computed
            # from the hit record (no per-light re-intersection)
            # without delta lobes spec_prev is always 0
            full = _full_mis(bounce, spec_prev, has_delta)
            if full is True:
                w_emit = jnp.ones(shp, jnp.float32)
            else:
                li_idx = jnp.full(shp, np.int32(-1))
                for m in range(M):
                    if mats["light_index"][m] >= 0:
                        li_idx = jnp.where(sid == m,
                                           np.int32(mats["light_index"][m]),
                                           li_idx)
                if phits_prev is not None:
                    pdf_l_hit = jnp.zeros(shp, jnp.float32)
                    for i in range(L):
                        pdf_l_hit = jnp.where(li_idx == i, phits_prev[i],
                                              pdf_l_hit)
                else:
                    pdf_l_hit = _hit_light_pdf(lights, li_idx, o, d,
                                               t_safe, nrm)
                w_emit = jnp.where(full, np.float32(1.0),
                                   _safe_div(pdf_prev, pdf_prev + pdf_l_hit))
            wb = jnp.where(alive, w_emit, 0.0)
            e_term = le * wb
            big_l = big_l + beta * e_term

            if grad:
                # d emission[sid] from the hit-emission term
                wbm = jnp.where(emit_mask, wb, 0.0)
                row_add(acc_e, rows_e, sid, g * beta * wbm)
            elif residual:
                resf_ref[ridx(("wb", bounce))] = \
                    jnp.where(emit_mask, wb, 0.0)

            if env_i is not None:
                env = V3(env_ref[0, 0] * jnp.ones(shp, jnp.float32),
                         env_ref[0, 1] * jnp.ones(shp, jnp.float32),
                         env_ref[0, 2] * jnp.ones(shp, jnp.float32))
                if full is True:
                    w_env = np.float32(1.0)
                else:
                    pdf_env = _light_pdf(lights[env_i], o, nrm, d)
                    w_env = jnp.where(full, np.float32(1.0),
                                      _safe_div(pdf_prev, pdf_prev + pdf_env))
                wenv = jnp.where(alive & ~valid, w_env, 0.0)
                e_term = e_term + env * wenv
                big_l = big_l + beta * env * wenv
                if grad:
                    # miss-emission term is linear in env radiance
                    acc_env = acc_env + g * beta * wenv
                elif residual:
                    resf_ref[ridx(("wenv", bounce))] = wenv

            if horizon:
                if residual:
                    resi_ref[bounce] = sid + 1
                return pack()   # horizon vertex: only its emission terms

            cont = alive & valid

            # material resolution (plastic stochastic lobe pick); selects
            # and the lobe-pick draw are pruned to the kinds present
            if use_texp:
                # traced per-row exponents from the table (plastic rows only —
                # the others never evaluate the phong lobe)
                exponent = jnp.zeros(shp, jnp.float32)
                for m in rows_x:
                    exponent = jnp.where(sid == m, exponent_ref[m], exponent)
            elif static_exp is not None:
                exponent = np.float32(0.0)
            else:
                exponent = _select_rows(sid, range(M), mats["exponent"])
            eta = _select_rows(sid, range(M), mats["eta"]) if has_glass \
                else np.float32(1.0)
            diffuse = _select_table3(sid, diffuse_ref, rows_d)
            if tex_recs:
                tex_par = [None if rec.get("kind") == "image"
                           else _checker_parity(static, rec, hp)
                           for rec in tex_recs]
                tex_xy = [_image_uv_xy(static, rec, hp)
                          if rec.get("kind") == "image" else None
                          for rec in tex_recs]
                diffuse = _apply_textures(static, texa_ref, texb_ref,
                                          timg_ref, sid, hp, diffuse,
                                          tex_par, tex_xy)
            specular = _select_table3(sid, specular_ref, rows_s)
            mk = jnp.zeros(shp, jnp.int32)
            for m in range(M):
                if mats["kind"][m] != 0:
                    mk = jnp.where(sid == m, np.int32(mats["kind"][m]), mk)
            is_matte = mk == kbsdf.MAT_MATTE
            is_mirror = mk == kbsdf.MAT_MIRROR
            is_glass = mk == kbsdf.MAT_GLASS
            is_plastic = mk == kbsdf.MAT_PLASTIC
            if has_plastic:
                u_lobe = rng.uniform(shp)
                s_prob = _select_rows(sid, range(M), mats["s_prob"])
                d_prob = _select_rows(sid, range(M), mats["d_prob"])
                pick_spec = u_lobe < s_prob
                plastic_kind = jnp.where(pick_spec, np.int32(kbsdf.PHONG),
                                         np.int32(kbsdf.LAMBERT))
                inv_sp = 1.0 / jnp.maximum(s_prob, 1e-12)
                inv_dp = 1.0 / jnp.maximum(d_prob, 1e-12)
                plastic_col = (specular * inv_sp).where(pick_spec,
                                                        diffuse * inv_dp)
                lobe_is_phong = is_plastic & pick_spec
                lobe_scale = jnp.where(is_plastic,
                                       jnp.where(pick_spec, inv_sp, inv_dp),
                                       1.0)
            else:
                plastic_kind = np.int32(kbsdf.LAMBERT)
                plastic_col = diffuse
                lobe_is_phong = is_plastic & (sid < -1)   # statically false
                lobe_scale = np.float32(1.0)
            kind = jnp.where(is_matte, np.int32(kbsdf.LAMBERT),
                             jnp.where(is_mirror, np.int32(kbsdf.MIRROR),
                                       jnp.where(is_glass, np.int32(kbsdf.GLASS),
                                                 plastic_kind)))
            color = diffuse.where(is_matte,
                                  specular.where(is_mirror | is_glass,
                                                 plastic_col))
            color2 = diffuse
            if has_delta:
                delta = is_mirror | is_glass
                nee_act = cont & ~delta
            else:
                nee_act = cont

            # local frame at hit
            s_f, t_f, n_f = make_frame(nrm)
            wo_l = to_local(s_f, t_f, n_f, wo)
            # frame-invariant NEE eval inputs: the mirror direction in
            # WORLD space (one build per bounce) replaces the per-light
            # to_local (see _bsdf_eval_pdf_dots)
            if kbsdf.PHONG in eval_lobes:
                wr_w = nrm * (wo_l.z * 2.0) - wo
            else:
                wr_w = None

            # ---- light-side NEE ----
            # one (sample, eval, shadow, accumulate) block for light i; the
            # per-light balance weights stay valid under single-light
            # selection because each light's light/bsdf weight pair sums to
            # 1 independently (see docs/DESIGN.md).
            # Every NEE term is bilinear in (raw table color, light emit)
            # with per-lane coefficient
            #   B' = li_scalar * f_unit * |cos| * okf * lobe_scale:
            #   contribution = col_tbl (x) emit * B'
            #   d emit       = g*beta (x) col_tbl * B'
            #   d col_tbl    = g*beta (x) emit * B'
            # which is what the residual mode caches (one plane per light).
            # col_tbl = the raw table entry the eval color came from
            # (specular for the plastic phong pick, else diffuse; delta
            # kinds never reach NEE eval so B' = 0 there).
            col_nee_tbl = specular.where(lobe_is_phong, diffuse) \
                if has_plastic else diffuse

            def nee_light(i, lt, smp, occ, sel_scale, nd_i):
                nonlocal acc_e, acc_env, addc_diff, addc_spec, addx
                emit_l = V3(light_emit_ref[i, 0], light_emit_ref[i, 1],
                            light_emit_ref[i, 2])
                wi, pdf_l, li_s, dist, _phit = smp
                cos_aw = wr_w.dot(wi) if wr_w is not None \
                    else jnp.zeros(shp, jnp.float32)
                pdf_b, f_unit_e = _bsdf_eval_pdf_dots(
                    kind, exponent, wo_l.z, nd_i, cos_aw, eval_lobes,
                    static_exp)
                ucos = f_unit_e * jnp.abs(nd_i)
                if lt["kind"] in (klights.POINT, klights.DIRECTION):
                    w = np.float32(1.0) / pdf_l
                else:
                    # raw div: ok gates on pdf_l > 0, so the masked lanes'
                    # inf never escapes the where below
                    w = np.float32(1.0) / (pdf_l + pdf_b)
                # li_s/ucos multiply into bp (all finite), so their
                # != 0 gates are redundant with the product being zero
                ok = nee_base & (pdf_l > 0.0)
                okf = jnp.where(ok & ~occ, w * sel_scale, 0.0)
                bp = li_s * ucos * okf * lobe_scale
                contrib = col_nee_tbl * emit_l * bp

                if use_texp and (grad or residual):
                    kap = _kappa_dot(exponent, cos_aw)
                if residual:
                    resf_ref[ridx(("B", bounce, i))] = bp
                    if use_texp:
                        resf_ref[ridx(("Bk", bounce, i))] = \
                            jnp.where(lobe_is_phong, bp * kap, 0.0)
                if grad:
                    gb = g * beta
                    # d light emission (linear in Li): goes to the light's
                    # emitting surface row if it has one, or to the env
                    # radiance leaf for the environment light
                    if i in light_row:
                        add = gb * col_nee_tbl * bp
                        r = light_row[i]
                        acc_e[r] = V3(acc_e[r].x + add.x,
                                      acc_e[r].y + add.y,
                                      acc_e[r].z + add.z)
                    elif lt["kind"] == klights.ENV:
                        acc_env = acc_env + gb * col_nee_tbl * bp
                    # d material color (linear in eval): target by lobe.
                    # Deferred: every NEE/extension term of this bounce
                    # shares one sid plane, so the per-row scatter happens
                    # ONCE per bounce on the summed planes (see below).
                    addc = gb * emit_l * bp
                    to_spec = lobe_is_phong
                    if has_plastic:
                        addc_spec = addc_spec + V3(
                            jnp.where(to_spec, addc.x, 0.0),
                            jnp.where(to_spec, addc.y, 0.0),
                            jnp.where(to_spec, addc.z, 0.0))
                        addc_diff = addc_diff + V3(
                            jnp.where(to_spec, 0.0, addc.x),
                            jnp.where(to_spec, 0.0, addc.y),
                            jnp.where(to_spec, 0.0, addc.z))
                    else:
                        # only lambert lobes reach NEE eval
                        addc_diff = addc_diff + addc
                    if use_texp:
                        # d f_unit/d e = f_unit * (1/(e+2) + log cos_a) at
                        # the (fixed) light-sampled wi; the contribution
                        # cotangent is dot(addc, col_nee_tbl)
                        dsum = (addc.x * col_nee_tbl.x
                                + addc.y * col_nee_tbl.y
                                + addc.z * col_nee_tbl.z)
                        addx = addx + jnp.where(lobe_is_phong, dsum * kap,
                                                0.0)
                return contrib

            if grad:
                # bounce-local material-color adjoint planes; scattered to
                # the per-row accumulators once per bounce (after the
                # extension term) since sid is shared by all terms
                addc_diff = v3_zeros(o.x)
                addc_spec = v3_zeros(o.x)
                addx = jnp.zeros(shp, jnp.float32) if use_texp else None

            ld = v3_zeros(o.x)
            # common per-bounce NEE gate (hoisted out of the per-light
            # blocks): a black eval color kills every light's term
            nee_base = nee_act & ~color.is_black()
            if cfg.nee == "single" and L > 1:
                # one uniformly-chosen light per (tile, bounce), compensated
                # by L. The scalar pick keeps all SIMD lanes coherent, and
                # lax.switch runs ONLY the chosen light's sampler; the
                # (heavier) BSDF eval + occlusion sweep + adjoints run once
                # on the switch outputs.
                u1, u2 = rng.uniform2(shp)
                c = tile_seed + _bounce_mix(bounce)
                c = c ^ jax.lax.shift_right_logical(c, jnp.int32(16))
                c = c * np.int32(-2048144789)   # 0x85ebca6b
                c = c ^ jax.lax.shift_right_logical(c, jnp.int32(13))
                if use_sobol:
                    # sobol passes hold the SEED fixed and advance only the
                    # per-lane sample index, so a hash of tile_seed alone
                    # would freeze the pick forever (a biased estimator that
                    # never averages over lights). Rotating the hash by the
                    # tile's sample index makes the pick cycle round-robin
                    # through all L lights as samples accumulate —
                    # STRATIFIED light selection (exactly uniform whenever
                    # spp % L == 0). si is constant within a tile whenever
                    # npix >= tile lanes (render_pallas orders lanes
                    # pixel-major per sample); reading lane 0 keeps the
                    # pick scalar either way.
                    c = c + si_ref[0, 0]
                elif use_hash:
                    # same stratified rotation (hash passes also hold the
                    # seed fixed and advance the sample index); the scalar
                    # pick itself stays tile-indexed, so nee="single" keeps
                    # its documented mesh-shape-variance under sharding
                    c = c + si_ref[0, 0]
                pick = jax.lax.rem(c & np.int32(0x7fffffff), np.int32(L))

                def mk_branch(i, lt):
                    def br(u1, u2):
                        wi, pdf_l, li_s, dist, _phit = _light_sample(
                            lt, world_radius, hp, nrm, u1, u2)
                        is_delta_l = np.float32(
                            1.0 if lt["kind"] in (klights.POINT,
                                                  klights.DIRECTION) else 0.0)
                        return (wi.x, wi.y, wi.z, pdf_l,
                                li_s * jnp.ones(shp, jnp.float32), dist,
                                jnp.full(shp, is_delta_l))
                    return br

                outs = jax.lax.switch(
                    pick, [mk_branch(i, lt) for i, lt in enumerate(lights)],
                    u1, u2)
                wi = V3(outs[0], outs[1], outs[2])
                pdf_l = outs[3]
                li_s = outs[4]
                dist = outs[5]
                is_delta_l = outs[6] > 0.5
                # emit of the picked light (scalar table read)
                emit_l = V3(light_emit_ref[pick, 0], light_emit_ref[pick, 1],
                            light_emit_ref[pick, 2])
                wi_l = to_local(s_f, t_f, n_f, wi)
                _, pdf_b, f_unit_e = _bsdf_eval_pdf(kind, color, exponent,
                                                    wo_l, wi_l, eval_lobes,
                                                    static_exp)
                ucos = f_unit_e * jnp.abs(wi_l.z)
                w = jnp.where(is_delta_l,
                              _safe_div(np.float32(1.0), pdf_l),
                              _safe_div(np.float32(1.0), pdf_l + pdf_b))
                ok = nee_base & (pdf_l > 0.0)
                # light identity is dynamic here: only rows skippable for
                # EVERY light can be pruned from the shared sweep
                tm = dist - km.SHADOW_EPSILON
                if cfg.shadow == "robust":
                    tm = tm - np.float32(km.RAY_OFFSET) * jnp.abs(nrm.dot(wi))
                occ = _any_hit(static, _offset_origin(hp, nrm, wi), wi, tm,
                               skip_rows=frozenset.intersection(
                                   *[frozenset(s)
                                     for s in static["occl_skip"]]),
                               skip_light=(pick if cfg.shadow == "robust"
                                           else None))
                okf = jnp.where(ok & ~occ, w * np.float32(L), 0.0)
                bp = li_s * ucos * okf * lobe_scale
                ld = col_nee_tbl * emit_l * bp

                if use_texp and (grad or residual):
                    kap1 = _kappa(exponent, wo_l, wi_l)
                if residual:
                    resf_ref[ridx(("B", bounce, 0))] = bp
                    if use_texp:
                        resf_ref[ridx(("Bk", bounce, 0))] = \
                            jnp.where(lobe_is_phong, bp * kap1, 0.0)
                if grad:
                    gb = g * beta
                    add = gb * col_nee_tbl * bp
                    for i in range(L):
                        if i in light_row:
                            selm = (pick == i).astype(jnp.float32)
                            r = light_row[i]
                            acc_e[r] = V3(acc_e[r].x + add.x * selm,
                                          acc_e[r].y + add.y * selm,
                                          acc_e[r].z + add.z * selm)
                        elif lights[i]["kind"] == klights.ENV:
                            selm = (pick == i).astype(jnp.float32)
                            acc_env = acc_env + add * selm
                    addc = gb * emit_l * bp
                    to_spec = lobe_is_phong
                    if has_plastic:
                        addc_spec = addc_spec + V3(
                            jnp.where(to_spec, addc.x, 0.0),
                            jnp.where(to_spec, addc.y, 0.0),
                            jnp.where(to_spec, addc.z, 0.0))
                        addc_diff = addc_diff + V3(
                            jnp.where(to_spec, 0.0, addc.x),
                            jnp.where(to_spec, 0.0, addc.y),
                            jnp.where(to_spec, 0.0, addc.z))
                    else:
                        addc_diff = addc_diff + addc
                    if use_texp:
                        dsum = (addc.x * col_nee_tbl.x
                                + addc.y * col_nee_tbl.y
                                + addc.z * col_nee_tbl.z)
                        addx = addx + jnp.where(lobe_is_phong, dsum * kap1,
                                                0.0)
            else:
                # ONE (u1, u2) pair shared by every light's NEE sample:
                # each light term is an independently unbiased estimator, so
                # correlating them across lights changes no expectation (the
                # sum's variance is unchanged to first order because the
                # lights' sample maps are unrelated), and it saves
                # 2*(L-1) RNG draws per bounce (~4% of the veach forward).
                # Sampling all lights BEFORE shading lets the occlusion
                # sweeps merge (_any_hit_multi shares the per-surface hp/n
                # terms) and the azimuth transcendentals be computed once.
                u1, u2 = rng.uniform2(shp)
                azim = None
                if any(lt["kind"] in (klights.AREA_SPHERE, klights.ENV)
                       for lt in lights):
                    cphi_s = jnp.cos(np.float32(km.TWO_PI) * u2)
                    azim = (cphi_s, _sin_from_phi_cos(cphi_s, u2))
                smps = [_light_sample(lt, world_radius, hp, nrm, u1, u2,
                                      azim) for lt in lights]
                # n.wi per shadow ray: shared between the occlusion
                # sweep's origin offsets and the NEE eval's wi_l.z
                nds = [nrm.dot(smp[0]) for smp in smps]
                if carry_phits:
                    phits_prev = [smp[4] for smp in smps]
                occs = _any_hit_multi(
                    static, hp, nrm,
                    [(smp[0], smp[3] - km.SHADOW_EPSILON) for smp in smps],
                    occl_skips, robust=(cfg.shadow == "robust"),
                    sphere_skips=sph_skips, nd=nds)
                for i, lt in enumerate(lights):
                    ld = ld + nee_light(i, lt, smps[i], occs[i],
                                        np.float32(1.0), nds[i])
            big_l = big_l + beta * ld
            e_term = e_term + ld

            # ---- extension sample ----
            u1, u2 = rng.uniform2(shp)
            f_s, wi_l, pdf_s, delta_s, f_unit_s, glass_refract = _bsdf_sample(
                kind, color, color2, eta, exponent, wo_l, u1, u2, lobes,
                static_exp)
            wi_w = to_world(s_f, t_f, n_f, wi_l)
            ok = cont & ~f_s.is_black() & (pdf_s != 0.0)
            thr = f_s * _safe_div(jnp.abs(wi_l.z), pdf_s)

            beta_new = beta * thr
            # kill lanes whose throughput overflows f32 (compounded grazing
            # delta bounces: f = R/|cos| per vertex) — an inf beta would NaN
            # the whole accumulator at the next masked add via inf*0
            ok = ok & (beta_new.max_component() < np.float32(np.inf))
            # no RR draw at all when no bounce reaches rr_start (fwd and
            # bwd replay decide identically, keeping streams aligned)
            rr_on = _rr_active(bounce, cfg)
            if rr_on is False:
                scale = np.float32(1.0)
                alive_n = ok
            else:
                u_rr = rng.uniform(shp)
                q = jnp.maximum(np.float32(0.05),
                                1.0 - beta_new.max_component())
                kill = (u_rr < q) & rr_on
                scale = jnp.where(rr_on, _safe_div(np.float32(1.0), 1.0 - q),
                                  np.float32(1.0))
                beta_new = beta_new * scale
                alive_n = ok & ~kill

            if residual:
                t_unit = f_unit_s * _safe_div(jnp.abs(wi_l.z), pdf_s) * scale
                tu_plane = jnp.where(alive_n, t_unit * lobe_scale, 0.0)
                resf_ref[ridx(("tu", bounce))] = tu_plane
                if use_texp:
                    resf_ref[ridx(("tuk", bounce))] = jnp.where(
                        lobe_is_phong,
                        tu_plane * _kappa(exponent, wo_l, wi_l), 0.0)
                if has_delta or has_plastic:
                    to_spec_t = (is_mirror | (is_glass & ~glass_refract)
                                 | lobe_is_phong)
                else:
                    to_spec_t = sid < -1   # statically false
                # packed per-bounce int plane: sid+1 | lobe_is_phong<<8
                # | to_spec_t<<9 | checker_even<<10 (masks as compare-born
                # int32; the parity bit lets the residual backward
                # reconstruct the textured diffuse value without hp)
                packed = (
                    (sid + 1)
                    + lobe_is_phong.astype(jnp.int32) * np.int32(256)
                    + to_spec_t.astype(jnp.int32) * np.int32(512))
                if tex_recs:
                    tex_even = jnp.zeros(shp, jnp.int32)
                    for ti, rec in enumerate(tex_recs):
                        if tex_par[ti] is None:   # image rec: xy planes below
                            continue
                        onrow = sid == rec["row"]
                        tex_even = jnp.where(
                            onrow & tex_par[ti], np.int32(1), tex_even)
                    packed = packed + tex_even * np.int32(1024)
                resi_ref[bounce] = packed
                if img_recs:
                    # continuous texel coords of the hit on its image row
                    # (the bilinear taps are a pure function of these)
                    tx_pl = jnp.zeros(shp, jnp.float32)
                    ty_pl = jnp.zeros(shp, jnp.float32)
                    for ti, rec in enumerate(tex_recs):
                        if tex_xy[ti] is None:
                            continue
                        onrow = sid == rec["row"]
                        tx_pl = jnp.where(onrow, tex_xy[ti][0], tx_pl)
                        ty_pl = jnp.where(onrow, tex_xy[ti][1], ty_pl)
                    resf_ref[ridx(("tx", bounce))] = tx_pl
                    resf_ref[ridx(("ty", bounce))] = ty_pl

            if grad:
                # tail radiance for the NEXT vertex:
                # R_{b+1} = (R_b - E_b) / T_b  per channel, 0 where the path
                # ends (T=0 there, all later E are 0)
                t_eff = thr * scale
                t_x = jnp.where(alive_n, t_eff.x, 0.0)
                t_y = jnp.where(alive_n, t_eff.y, 0.0)
                t_z = jnp.where(alive_n, t_eff.z, 0.0)
                r_next = V3(_safe_div(r_tail.x - e_term.x, t_x),
                            _safe_div(r_tail.y - e_term.y, t_y),
                            _safe_div(r_tail.z - e_term.z, t_z))
                r_next = V3(jnp.where(alive_n, r_next.x, 0.0),
                            jnp.where(alive_n, r_next.y, 0.0),
                            jnp.where(alive_n, r_next.z, 0.0))
                # throughput adjoint: T = base_color * lobe_scale * t_unit
                t_unit = f_unit_s * _safe_div(jnp.abs(wi_l.z), pdf_s) * scale
                coeff_t = jnp.where(alive_n, t_unit * lobe_scale, 0.0)
                addt = g * beta * r_next * coeff_t
                # target: specular for mirror / glass-reflect / plastic-phong;
                # diffuse for matte / glass-refract / plastic-lambert
                if has_delta or has_plastic:
                    to_spec_t = (is_mirror | (is_glass & ~glass_refract)
                                 | lobe_is_phong)
                    addc_spec = addc_spec + V3(
                        jnp.where(to_spec_t, addt.x, 0.0),
                        jnp.where(to_spec_t, addt.y, 0.0),
                        jnp.where(to_spec_t, addt.z, 0.0))
                    addc_diff = addc_diff + V3(
                        jnp.where(to_spec_t, 0.0, addt.x),
                        jnp.where(to_spec_t, 0.0, addt.y),
                        jnp.where(to_spec_t, 0.0, addt.z))
                else:
                    addc_diff = addc_diff + addt
                if use_texp:
                    # throughput factor of a phong extension vertex:
                    # T = color * (e+2)/2pi cos^e a * |cos|/pdf * scale with
                    # pdf DETACHED (a replayed number), so
                    # dT/de = T * (1/(e+2) + log cos_a) at the fixed wi
                    kap_s = _kappa(exponent, wo_l, wi_l)
                    # dot with the RAW table color (coeff_t already carries
                    # lobe_scale; `color` is the lobe-scaled resolve)
                    dsum_t = (addt.x * col_nee_tbl.x
                              + addt.y * col_nee_tbl.y
                              + addt.z * col_nee_tbl.z)
                    addx = addx + jnp.where(lobe_is_phong, dsum_t * kap_s,
                                            0.0)
                # the single per-bounce row scatter of all material-color
                # adjoint terms (L NEE lights + the extension sample).
                # On textured rows the diffuse VALUE came from the texture,
                # so route the adjoint there (checker colors by the hit's
                # cell parity; image texels through the texture-adjoint
                # planes) and zero the diffuse-table share.
                if tex_recs:
                    if img_recs:
                        store_texel_planes(
                            tadj_ref, bounce, static, sid,
                            image_hit_planes(static, sid, tex_xy, shp),
                            addc_diff)
                    addc_diff = _route_checker_adjoint(
                        static, sid, tex_par, addc_diff, acc_ta, acc_tb)
                row_add(acc_d, rows_d, sid, addc_diff)
                if has_delta or has_plastic:
                    row_add(acc_s, rows_s, sid, addc_spec)
                if use_texp:
                    row_add1(acc_x, rows_x, sid, addx)
                r_tail = r_next

            o = _offset_origin(hp, nrm, wi_w).where(alive_n, o)
            d = wi_w.where(alive_n, d)
            beta = beta_new.where(alive_n, beta)
            if has_delta:
                spec_prev = jnp.where(alive_n, delta_s.astype(jnp.int32),
                                      spec_prev)
            pdf_prev = jnp.where(alive_n, pdf_s, pdf_prev)
            alive = alive_n
            return pack()

        st = dict(o=o, d=d, beta=beta, big_l=big_l,
                  alive=alive.astype(jnp.int32), spec_prev=spec_prev,
                  pdf_prev=pdf_prev)
        if carry_phits:
            st["phits"] = [jnp.zeros(shp, jnp.float32) for _ in range(L)]
        if grad:
            st.update(r_tail=r_tail, acc_d=acc_d, acc_s=acc_s, acc_e=acc_e,
                      acc_env=acc_env)
            if use_texp:
                st["acc_x"] = acc_x
            if tex_recs:
                st.update(acc_ta=acc_ta, acc_tb=acc_tb)
        # bounces 0..max_depth-1 share one traced body (the compiled kernel
        # holds one copy of the transport, not max_depth); the horizon
        # vertex runs after the loop with only its emission terms
        st = jax.lax.fori_loop(0, cfg.max_depth, step, st)
        st = step(cfg.max_depth, st)
        big_l = st["big_l"]
        if grad:
            acc_d, acc_s, acc_e, acc_env = (st["acc_d"], st["acc_s"],
                                            st["acc_e"], st["acc_env"])
            acc_x = st["acc_x"] if use_texp else None
            if tex_recs:
                acc_ta, acc_tb = st["acc_ta"], st["acc_tb"]

        if grad:
            store_partials(part_ref, _partial_planes(
                acc_d, acc_s, acc_e, acc_env,
                acc_x if use_texp else None,
                (acc_ta, acc_tb) if tex_recs else None))
        else:
            lx_ref[:] = big_l.x
            ly_ref[:] = big_l.y
            lz_ref[:] = big_l.z

    return kernel


def _make_bwd_res_kernel(static, cfg: KernelConfig):
    """Coefficient-cache backward: consumes the residual planes written by
    the residual forward (_residual_layout) and computes every table
    adjoint with pure select/FMA arithmetic — no intersection sweeps, no
    NEE occlusion rays, no BSDF math, no RNG. Same adjoint algebra as the
    replay backward (grad=True in _make_kernel): the tail radiance
    R_{b+1} = (R_b - E_b) / T_b is peeled per bounce, where E_b and T_b are
    reconstructed bilinearly from the cached coefficients and the (traced)
    color tables, so inverse-rendering parameter updates reuse one compile.
    """
    mats = static["mats"]
    lights = static["lights"]
    M = len(mats["kind"])
    L = len(lights)
    single = cfg.nee == "single" and L > 1
    rows_d = [m for m in range(M) if mats["kind"][m] != kbsdf.MAT_MIRROR]
    rows_s = [m for m in range(M) if mats["kind"][m] != kbsdf.MAT_MATTE]
    rows_e = [m for m in range(M) if mats["light_index"][m] >= 0]
    env_i = next((i for i, lt in enumerate(lights)
                  if lt["kind"] == klights.ENV), None)
    light_row = {}
    for m in range(M):
        li = mats["light_index"][m]
        if li >= 0 and li not in light_row:
            light_row[li] = m
    has_spec = any(mats["kind"][m] != kbsdf.MAT_MATTE for m in range(M))
    use_texp = cfg.trainable_exponent
    rows_x = [m for m in range(M) if mats["kind"][m] == kbsdf.MAT_PLASTIC]
    tex_recs = static.get("textures", [])
    n_tex = static.get("n_textures", 0) if tex_recs else 0
    img_recs = [r for r in tex_recs if r.get("kind") == "image"]
    res_ix, _ = _residual_layout(static, cfg)
    ridx = _affine_index(res_ix, cfg.max_depth)

    def kernel(*refs):
        (seed_ref, diffuse_ref, specular_ref, emission_ref) = refs[:4]
        rest = list(refs[4:])
        texa_ref = rest.pop(0) if tex_recs else None
        texb_ref = rest.pop(0) if tex_recs else None
        timg_ref = rest.pop(0) if img_recs else None
        (light_emit_ref, env_ref,
         gx_ref, gy_ref, gz_ref, flx_ref, fly_ref, flz_ref,
         resf_ref, resi_ref, part_ref) = rest[:11]
        tadj_ref = rest[11] if img_recs else None
        pid = pl.program_id(0)
        g = V3(gx_ref[:], gy_ref[:], gz_ref[:])
        r_tail = V3(flx_ref[:], fly_ref[:], flz_ref[:])
        shp = g.x.shape
        beta = v3_full(g.x, 1.0, 1.0, 1.0)
        acc_d = [v3_zeros(g.x) for _ in range(M)]
        acc_s = [v3_zeros(g.x) for _ in range(M)]
        acc_e = [v3_zeros(g.x) for _ in range(M)]
        acc_env = v3_zeros(g.x)
        if use_texp:
            acc_x = [jnp.zeros(shp, jnp.float32) for _ in range(M)]
        if tex_recs:
            acc_ta = [v3_zeros(g.x) for _ in range(n_tex)]
            acc_tb = [v3_zeros(g.x) for _ in range(n_tex)]

        def row_add(acc, rows, sid, val: V3):
            for m in rows:
                mrow = sid == m
                acc[m] = V3(acc[m].x + jnp.where(mrow, val.x, 0.0),
                            acc[m].y + jnp.where(mrow, val.y, 0.0),
                            acc[m].z + jnp.where(mrow, val.z, 0.0))

        def row_add1(acc, rows, sid, val):
            for m in rows:
                acc[m] = acc[m] + jnp.where(sid == m, val, 0.0)

        if single:
            tile_seed = seed_ref[0] + pid * np.int32(2654435761 & 0x7fffffff)

        def step(bounce, st):
            horizon = isinstance(bounce, int) and bounce == cfg.max_depth
            beta, r_tail, acc_env = st["beta"], st["r_tail"], st["acc_env"]
            acc_d, acc_s, acc_e = (list(st[k]) for k in
                                   ("acc_d", "acc_s", "acc_e"))
            acc_x = list(st["acc_x"]) if use_texp else None
            acc_ta = list(st["acc_ta"]) if tex_recs else None
            acc_tb = list(st["acc_tb"]) if tex_recs else None

            def pack():
                out = dict(beta=beta, r_tail=r_tail, acc_env=acc_env,
                           acc_d=acc_d, acc_s=acc_s, acc_e=acc_e)
                if use_texp:
                    out["acc_x"] = acc_x
                if tex_recs:
                    out.update(acc_ta=acc_ta, acc_tb=acc_tb)
                return out

            ib = resi_ref[bounce]
            sid = (ib & np.int32(255)) - 1
            wb = resf_ref[ridx(("wb", bounce))]
            gb = g * beta
            # hit-emission adjoint (wb is fully masked in the forward)
            row_add(acc_e, rows_e, sid, gb * wb)
            if env_i is not None:
                wenv = resf_ref[ridx(("wenv", bounce))]
                acc_env = acc_env + gb * wenv
            if horizon:
                return pack()

            lobe_is_phong = (ib & np.int32(256)) != 0
            to_spec_t = (ib & np.int32(512)) != 0
            diff_sel = _select_table3(sid, diffuse_ref, rows_d)
            if tex_recs:
                # the forward cached the checker parity (bit 10) and, for
                # image rows, the continuous texel coords ("tx"/"ty"): the
                # diffuse VALUE on textured rows is the texture color
                tex_even = (ib & np.int32(1024)) != 0
                if img_recs:
                    tx_pl = resf_ref[ridx(("tx", bounce))]
                    ty_pl = resf_ref[ridx(("ty", bounce))]
                for rec in tex_recs:
                    if rec.get("kind") == "image":
                        col = _image_color(rec, (tx_pl, ty_pl), timg_ref)
                    else:
                        col = _checker_color(rec, tex_even, texa_ref,
                                             texb_ref)
                    diff_sel = col.where(sid == rec["row"], diff_sel)
            spec_sel = _select_table3(sid, specular_ref, rows_s) \
                if has_spec else v3_zeros(g.x)
            emit_sel = _select_table3(sid, emission_ref, rows_e)
            col_nee = spec_sel.where(lobe_is_phong, diff_sel)
            addx = jnp.zeros(shp, jnp.float32) if use_texp else None

            # E_b = hit emission + env miss + NEE, all bilinear in cache
            e_term = emit_sel * wb
            if env_i is not None:
                env = V3(env_ref[0, 0], env_ref[0, 1], env_ref[0, 2])
                e_term = e_term + env * wenv
            if single:
                c = tile_seed + _bounce_mix(bounce)
                c = c ^ jax.lax.shift_right_logical(c, jnp.int32(16))
                c = c * np.int32(-2048144789)   # 0x85ebca6b
                c = c ^ jax.lax.shift_right_logical(c, jnp.int32(13))
                pick = jax.lax.rem(c & np.int32(0x7fffffff), np.int32(L))
                bp = resf_ref[ridx(("B", bounce, 0))]
                emit_l = V3(light_emit_ref[pick, 0],
                            light_emit_ref[pick, 1], light_emit_ref[pick, 2])
                e_term = e_term + col_nee * emit_l * bp
                add = gb * col_nee * bp
                for i in range(L):
                    if i in light_row:
                        selm = (pick == i).astype(jnp.float32)
                        r = light_row[i]
                        acc_e[r] = V3(acc_e[r].x + add.x * selm,
                                      acc_e[r].y + add.y * selm,
                                      acc_e[r].z + add.z * selm)
                    elif lights[i]["kind"] == klights.ENV:
                        selm = (pick == i).astype(jnp.float32)
                        acc_env = acc_env + add * selm
                addc = gb * emit_l * bp
                addc_diff = V3(jnp.where(lobe_is_phong, 0.0, addc.x),
                               jnp.where(lobe_is_phong, 0.0, addc.y),
                               jnp.where(lobe_is_phong, 0.0, addc.z))
                addc_spec = V3(jnp.where(lobe_is_phong, addc.x, 0.0),
                               jnp.where(lobe_is_phong, addc.y, 0.0),
                               jnp.where(lobe_is_phong, addc.z, 0.0))
                if use_texp:
                    bk = resf_ref[ridx(("Bk", bounce, 0))]
                    addx = addx + (gb.x * emit_l.x * col_nee.x
                                   + gb.y * emit_l.y * col_nee.y
                                   + gb.z * emit_l.z * col_nee.z) * bk
            else:
                addc_diff = v3_zeros(g.x)
                addc_spec = v3_zeros(g.x)
                for i, lt in enumerate(lights):
                    bp = resf_ref[ridx(("B", bounce, i))]
                    emit_l = V3(light_emit_ref[i, 0], light_emit_ref[i, 1],
                                light_emit_ref[i, 2])
                    e_term = e_term + col_nee * emit_l * bp
                    if i in light_row:
                        add = gb * col_nee * bp
                        r = light_row[i]
                        acc_e[r] = V3(acc_e[r].x + add.x, acc_e[r].y + add.y,
                                      acc_e[r].z + add.z)
                    elif lt["kind"] == klights.ENV:
                        acc_env = acc_env + gb * col_nee * bp
                    addc = gb * emit_l * bp
                    addc_spec = addc_spec + V3(
                        jnp.where(lobe_is_phong, addc.x, 0.0),
                        jnp.where(lobe_is_phong, addc.y, 0.0),
                        jnp.where(lobe_is_phong, addc.z, 0.0))
                    addc_diff = addc_diff + V3(
                        jnp.where(lobe_is_phong, 0.0, addc.x),
                        jnp.where(lobe_is_phong, 0.0, addc.y),
                        jnp.where(lobe_is_phong, 0.0, addc.z))
                    if use_texp:
                        bk = resf_ref[ridx(("Bk", bounce, i))]
                        addx = addx + (gb.x * emit_l.x * col_nee.x
                                       + gb.y * emit_l.y * col_nee.y
                                       + gb.z * emit_l.z * col_nee.z) * bk

            # extension: T_b = ext_tbl (x) tu; peel the tail radiance
            tu = resf_ref[ridx(("tu", bounce))]
            ext_tbl = spec_sel.where(to_spec_t, diff_sel)
            t_eff = ext_tbl * tu
            r_next = V3(_safe_div(r_tail.x - e_term.x, t_eff.x),
                        _safe_div(r_tail.y - e_term.y, t_eff.y),
                        _safe_div(r_tail.z - e_term.z, t_eff.z))
            addt = gb * r_next * tu
            addc_spec = addc_spec + V3(jnp.where(to_spec_t, addt.x, 0.0),
                                       jnp.where(to_spec_t, addt.y, 0.0),
                                       jnp.where(to_spec_t, addt.z, 0.0))
            addc_diff = addc_diff + V3(jnp.where(to_spec_t, 0.0, addt.x),
                                       jnp.where(to_spec_t, 0.0, addt.y),
                                       jnp.where(to_spec_t, 0.0, addt.z))
            if use_texp:
                # tuk is pre-masked to phong lanes, whose raw ext color is
                # the specular table
                tuk = resf_ref[ridx(("tuk", bounce))]
                addx = addx + (gb.x * r_next.x * spec_sel.x
                               + gb.y * r_next.y * spec_sel.y
                               + gb.z * r_next.z * spec_sel.z) * tuk
            if tex_recs:
                # route textured rows' diffuse adjoints to the texture
                # leaves (checker colors by cached parity; image texels
                # through the texture-adjoint planes), zero the table share
                if img_recs:
                    store_texel_planes(
                        tadj_ref, bounce, static, sid,
                        image_hit_planes(static, sid,
                                         [(tx_pl, ty_pl) if r.get("kind")
                                          == "image" else None
                                          for r in tex_recs], shp),
                        addc_diff)
                addc_diff = _route_checker_adjoint(
                    static, sid, tex_even, addc_diff, acc_ta, acc_tb)
            row_add(acc_d, rows_d, sid, addc_diff)
            if has_spec:
                row_add(acc_s, rows_s, sid, addc_spec)
            if use_texp:
                row_add1(acc_x, rows_x, sid, addx)
            beta = beta * t_eff
            r_tail = r_next
            return pack()

        st = dict(beta=beta, r_tail=r_tail, acc_env=acc_env, acc_d=acc_d,
                  acc_s=acc_s, acc_e=acc_e)
        if use_texp:
            st["acc_x"] = acc_x
        if tex_recs:
            st.update(acc_ta=acc_ta, acc_tb=acc_tb)
        st = jax.lax.fori_loop(0, cfg.max_depth, step, st)
        st = step(cfg.max_depth, st)
        acc_d, acc_s, acc_e, acc_env = (st["acc_d"], st["acc_s"], st["acc_e"],
                                        st["acc_env"])
        acc_x = st["acc_x"] if use_texp else None
        if tex_recs:
            acc_ta, acc_tb = st["acc_ta"], st["acc_tb"]

        store_partials(part_ref, _partial_planes(
            acc_d, acc_s, acc_e, acc_env, acc_x if use_texp else None,
            (acc_ta, acc_tb) if tex_recs else None))

    return kernel


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------


def _kernel_texture_support(scene):
    """None if the megakernel can evaluate this scene's textures in-kernel
    (checker or image textures on planar surfaces; image atlases of any
    size are fetched with gathered loads), else a reason string. Sphere UVs
    still need the jnp engines."""
    if not getattr(scene, "has_textures", False):
        return None
    tex_id = np.asarray(scene.tex_id)
    n_planar = scene.geometry.n_planar
    for m in range(len(tex_id)):
        if int(tex_id[m]) >= 0 and m >= n_planar:
            return ("the megakernel evaluates textures on planar surfaces "
                    "only — sphere UV textures need the jnp engines")
    return None


def _static_digest(static, extra=()):
    """Content hash of the baked-constant scene extraction (plus any
    closure defaults) — the memo key for compiled tracers."""
    import hashlib

    h = hashlib.sha1()

    def walk(v):
        if isinstance(v, dict):
            for k in sorted(v):
                h.update(str(k).encode())
                walk(v[k])
        elif isinstance(v, (list, tuple)):
            h.update(b"[")
            for x in v:
                walk(x)
        elif isinstance(v, (np.ndarray, jnp.ndarray)):
            a = np.asarray(v)
            h.update(str(a.dtype).encode() + str(a.shape).encode()
                     + a.tobytes())
        else:
            h.update(repr(v).encode())

    walk(static)
    walk(list(extra))
    return h.hexdigest()


# tracer memo: rebuilding a tracer re-traces the whole kernel builder
# (seconds of host time per call even with the persistent compile cache),
# so render_pallas/make_train_step callers that recreate tracers per frame
# would otherwise pay it every time
_TRACER_MEMO: dict = {}


def lane_planes(v, npad: int):
    """(n,) or (n, k) lane array -> zero-padded (npad // 128, 128) planes
    (one per column)."""
    n = v.shape[0]
    cols = [v] if v.ndim == 1 else [v[:, i] for i in range(v.shape[1])]
    return [jnp.pad(c, (0, npad - n)).reshape(npad // LANE, LANE)
            for c in cols]


def lane_grid(n: int, rows: int):
    """(padded lane count, grid size) for n lanes in rows*128-lane blocks."""
    tile = rows * LANE
    npad = ((n + tile - 1) // tile) * tile
    return npad, npad // tile


def _check_rows(cfg: KernelConfig):
    if cfg.rows < 1 or cfg.rows & (cfg.rows - 1):
        raise ValueError(f"KernelConfig.rows must be a power of two "
                         f"(Triton blocks); got {cfg.rows}")


def make_pallas_tracer(scene, cfg: KernelConfig | None = None,
                       interpret: bool = False):
    """Build a jitted lane tracer for `scene`'s (static) geometry.

    Returns fn(scene, o, d, seed) -> (N, 3) radiance, where only the
    material/emission tables of `scene` are read as traced values (so the
    same compiled kernel serves parameter updates / inverse rendering);
    `seed` is a traced int32 scalar. One Triton compile per
    (geometry, cfg, lane count).

    With cfg.sampler == "sobol" the signature gains two (N,) int32 lane
    arrays: fn(scene, o, d, seed, sample_index, pixel_id) — the Owen
    scramble is a pure function of (seed, pixel_id, draw site), and
    sample_index walks the (0,2)-sequence, so accumulating passes with a
    FIXED seed and increasing sample indices yields stratified pixels.
    """
    cfg = cfg or KernelConfig()
    _check_rows(cfg)
    tex_err = _kernel_texture_support(scene)
    if tex_err:
        raise NotImplementedError(tex_err)
    static = extract_static(scene)
    memo_key = ("fwd", _static_digest(static), cfg, bool(interpret))
    cached = _TRACER_MEMO.get(memo_key)
    if cached is not None:
        return cached
    kernel = _make_kernel(static, cfg)
    n_lights = int(scene.n_lights)
    has_env = bool(scene.has_env)
    has_tex = bool(static["textures"])
    has_img = any(r.get("kind") == "image" for r in static["textures"])
    use_sobol = cfg.sampler in ("sobol", "hash")  # kernel takes si/pix planes
    use_texp = cfg.trainable_exponent

    @jax.jit
    def trace(scene, o, d, seed, si=None, pix=None):
        n = o.shape[0]
        npad, grid = lane_grid(n, cfg.rows)
        blk = pl.BlockSpec((cfg.rows, LANE), lambda i: (i, 0))
        whole = pl.BlockSpec()
        light_emit = (scene.lights.emit if n_lights
                      else jnp.zeros((1, 3), jnp.float32))
        env = (scene.env_radiance_ if has_env
               else jnp.zeros(3, jnp.float32)).reshape(1, 3)
        extra = ([*lane_planes(si.astype(jnp.int32), npad),
                  *lane_planes(pix.astype(jnp.int32), npad)]
                 if use_sobol else [])
        tables = [scene.mat_diffuse, scene.mat_specular, scene.emission]
        if use_texp:
            tables.append(scene.mat_exponent)
        if has_tex:
            tables += [scene.textures.color_a, scene.textures.color_b]
        if has_img:
            tables.append(scene.textures.image.reshape(-1, 3))
        tables += [light_emit, env]
        lanes = [*lane_planes(o, npad), *lane_planes(d, npad), *extra]
        out = pallas_call(
            kernel, interpret=interpret, name="kytpu_fwd",
            grid=(grid,),
            in_specs=[whole] * (1 + len(tables)) + [blk] * len(lanes),
            out_specs=[blk] * 3,
            out_shape=[jax.ShapeDtypeStruct((npad // LANE, LANE),
                                            jnp.float32)] * 3,
        )(jnp.asarray(seed, jnp.int32).reshape(1), *tables, *lanes)
        return jnp.stack([v.reshape(-1)[:n] for v in out], axis=-1)

    _TRACER_MEMO[memo_key] = trace
    return trace


def render_lanes_pallas(scene, o, d, seed: int, cfg: KernelConfig | None = None,
                       interpret: bool = False):
    """One-shot convenience wrapper around make_pallas_tracer."""
    tracer = make_pallas_tracer(scene, cfg, interpret)
    return tracer(scene, o, d, jnp.int32(seed))


def make_pallas_diff_tracer(scene, cfg: KernelConfig | None = None,
                            interpret: bool = False,
                            backward: str = "residual"):
    """Differentiable megakernel tracer (detached-sampling gradients).

    Returns fn(diffuse, specular, emission, env, o, d, seed) -> (N, 3)
    radiance with a custom VJP returning
    (d_diffuse, d_specular, d_emission, d_env), including the NEE
    light-emission adjoints routed to each light's emitting surface row
    exactly as diff.params.set_params ties them; `env` is the (3,)
    environment radiance (pass zeros for env-free scenes — its cotangent is
    then zero). Ray-origin/direction cotangents are zero (geometry
    derivatives are out of scope, as in the jnp detached-sampling path).

    Textured scenes (planar, in-kernel-supported; see
    _kernel_texture_support) gain positional args after emission (or after
    exponent when trainable_exponent): fn(..., texa, texb[, timg], env, o,
    d, seed) — the (T, 3) checker color tables and, when image textures are
    bound, the (ti_n, th, tw, 3) texel atlas — with exact adjoints. The
    diffuse-value adjoint at a textured vertex routes to color_a/color_b by
    the hit's cell parity (recomputed in the replay backward, cached as
    res_ints bit 10 in the residual backward), or to the 4 bilinear-tap
    texels by their weights: the backward kernels write per-lane texture
    coordinates and adjoints (TEX_PLANES per bounce) and texel_adjoint
    scatter-adds them in XLA (bilinear is linear in the texels, so the
    adjoint is exact); the diffuse-table share on textured rows is
    identically zero.

    backward="residual" (production): the forward kernel additionally
    writes a compact per-bounce coefficient cache (~7 planes/bounce, see
    _residual_layout) and the backward kernel is pure table-select + FMA
    arithmetic — no re-tracing, no occlusion sweeps, no RNG.
    backward="replay": path-replay backprop (PRB, Vicini et al. 2021
    style) — O(1) memory, the backward re-runs the whole transport with
    the same RNG stream.

    Both backwards reduce their table adjoints over each program's lanes
    in-kernel and write one row per program of a (grid, P) partial table,
    summed over the grid in XLA (_unpack_partials).

    When the function is evaluated WITHOUT differentiation, the plain
    forward kernel runs (no residual writes).

    With cfg.sampler == "sobol" the returned fn takes two extra (N,) int32
    arrays (sample_index, pixel_id) after `seed`; they are nondifferentiable
    and must be identical between the forward and backward (the replay
    backward re-draws the same Owen-Sobol stream from them).

    With cfg.trainable_exponent the signature becomes
    fn(diffuse, specular, emission, exponent, env, o, d, seed[, si, pix])
    and the VJP additionally returns d_exponent per material row (both
    backwards; the residual forward caches kappa-weighted "Bk"/"tuk"
    partner planes, see _residual_layout). The signature is keyed on the
    cfg ALONE — a scene with no glossy material simply gets zero exponent
    gradients.
    """
    cfg = cfg or KernelConfig()
    _check_rows(cfg)
    assert backward in ("residual", "replay"), backward
    tex_err = _kernel_texture_support(scene)
    if tex_err:
        raise NotImplementedError(tex_err)
    static = extract_static(scene)
    # closure defaults baked into the returned fn (beyond the static
    # extraction): the exponent table and texture defaults, and the
    # light->surface-row adjoint routing
    _extra = (np.asarray(scene.mat_exponent),
              np.asarray(scene.textures.color_a)
              if getattr(scene, "has_textures", False) else 0,
              np.asarray(scene.textures.color_b)
              if getattr(scene, "has_textures", False) else 0,
              np.asarray(scene.textures.image)
              if getattr(scene, "has_textures", False) else 0,
              [int(v) for v in np.asarray(scene.lights.surface_ids)]
              if scene.n_lights else [],
              [int(v) for v in np.asarray(scene.lights.kinds)]
              if scene.n_lights else [])
    memo_key = ("diff", _static_digest(static, _extra), cfg, backward,
                bool(interpret))
    cached = _TRACER_MEMO.get(memo_key)
    if cached is not None:
        return cached
    use_texp = cfg.trainable_exponent
    fwd_kernel = _make_kernel(static, cfg)
    if backward == "residual":
        fwd_res_kernel = _make_kernel(static, cfg, residual=True)
        bwd_res_kernel = _make_bwd_res_kernel(static, cfg)
        _, res_n = _residual_layout(static, cfg)
    else:
        bwd_kernel = _make_kernel(static, cfg, grad=True)
    m_rows = int(scene.mat_kind.shape[0])
    n_lights = int(scene.n_lights)
    has_tex = bool(static["textures"])
    t_rows = static["n_textures"] if has_tex else 0
    has_img = any(r.get("kind") == "image" for r in static["textures"])
    img_shape = tuple(scene.textures.image.shape) if has_img else (0, 3)
    light_rows = [int(v) for v in np.asarray(scene.lights.surface_ids)] \
        if n_lights else []
    env_row = next((i for i, k in enumerate(scene.lights.kinds)
                    if int(k) == klights.ENV), None) if n_lights else None
    n_part = pow2_at_least(_n_partials(m_rows, t_rows, use_texp))
    n_bounce = cfg.max_depth + 1
    use_sobol = cfg.sampler in ("sobol", "hash")  # kernel takes si/pix planes
    blk = pl.BlockSpec((cfg.rows, LANE), lambda i: (i, 0))
    whole = pl.BlockSpec()

    def stk(nplanes):
        return pl.BlockSpec((nplanes, cfg.rows, LANE), lambda i: (0, i, 0))

    def _light_emit_of(emission, env):
        if not n_lights:
            return jnp.zeros((1, 3), jnp.float32)
        rows = jnp.asarray([max(r, 0) for r in light_rows], jnp.int32)
        has = jnp.asarray([r >= 0 for r in light_rows])[:, None]
        emit = jnp.where(has, emission[rows], scene.lights.emit)
        if env_row is not None:
            emit = emit.at[env_row].set(env)
        return emit

    def _tables(diffuse, specular, emission, exponent, texa, texb, timg,
                env, with_exp=True):
        """Whole-array kernel inputs, in the kernels' ref order."""
        tabs = [diffuse, specular, emission]
        if use_texp and with_exp:
            tabs.append(exponent)
        if has_tex:
            tabs += [texa, texb]
        if has_img:
            tabs.append(timg.reshape(-1, 3))
        return tabs + [_light_emit_of(emission, env), env.reshape(1, 3)]

    def _lanes(o, d, si, pix, npad):
        lanes = [*lane_planes(o, npad), *lane_planes(d, npad)]
        if use_sobol:
            lanes += [*lane_planes(si.astype(jnp.int32), npad),
                      *lane_planes(pix.astype(jnp.int32), npad)]
        return lanes

    def _seed(seed):
        return jnp.asarray(seed, jnp.int32).reshape(1)

    @jax.custom_vjp
    def trace(diffuse, specular, emission, exponent, texa, texb, timg, env,
              o, d, seed, si=None, pix=None):
        return _fwd_impl(diffuse, specular, emission, exponent, texa, texb,
                         timg, env, o, d, seed, si, pix)

    def _fwd_impl(diffuse, specular, emission, exponent, texa, texb, timg,
                  env, o, d, seed, si, pix):
        n = o.shape[0]
        npad, grid = lane_grid(n, cfg.rows)
        tabs = _tables(diffuse, specular, emission, exponent, texa, texb,
                       timg, env)
        lanes = _lanes(o, d, si, pix, npad)
        out = pallas_call(
            fwd_kernel, interpret=interpret, name="kytpu_fwd",
            grid=(grid,),
            in_specs=[whole] * (1 + len(tabs)) + [blk] * len(lanes),
            out_specs=[blk] * 3,
            out_shape=[jax.ShapeDtypeStruct((npad // LANE, LANE),
                                            jnp.float32)] * 3,
        )(_seed(seed), *tabs, *lanes)
        return jnp.stack([v.reshape(-1)[:n] for v in out], axis=-1)

    def _fwd(diffuse, specular, emission, exponent, texa, texb, timg, env,
             o, d, seed, si=None, pix=None):
        if backward == "replay":
            big_l = _fwd_impl(diffuse, specular, emission, exponent, texa,
                              texb, timg, env, o, d, seed, si, pix)
            return big_l, (diffuse, specular, emission, exponent, texa,
                           texb, timg, env, o, d, seed, si, pix, big_l,
                           None, None)
        n = o.shape[0]
        npad, grid = lane_grid(n, cfg.rows)
        rows = npad // LANE
        tabs = _tables(diffuse, specular, emission, exponent, texa, texb,
                       timg, env)
        lanes = _lanes(o, d, si, pix, npad)
        *lplanes, resf, resi = pallas_call(
            fwd_res_kernel, interpret=interpret, name="kytpu_fwd_residual",
            grid=(grid,),
            in_specs=[whole] * (1 + len(tabs)) + [blk] * len(lanes),
            out_specs=[blk, blk, blk, stk(res_n), stk(n_bounce)],
            out_shape=[jax.ShapeDtypeStruct((rows, LANE), jnp.float32)] * 3
            + [jax.ShapeDtypeStruct((res_n, rows, LANE), jnp.float32),
               jax.ShapeDtypeStruct((n_bounce, rows, LANE), jnp.int32)],
        )(_seed(seed), *tabs, *lanes)
        big_l = jnp.stack([v.reshape(-1)[:n] for v in lplanes], axis=-1)
        return big_l, (diffuse, specular, emission, None, texa, texb, timg,
                       env, o, d, seed, si, pix, big_l, resf, resi)

    def _bwd(res, g):
        (diffuse, specular, emission, exponent, texa, texb, timg, env, o, d,
         seed, si, pix, big_l, resf, resi) = res
        n = o.shape[0]
        npad, grid = lane_grid(n, cfg.rows)
        rows = npad // LANE
        gl = [*lane_planes(g, npad), *lane_planes(big_l, npad)]
        part_spec = pl.BlockSpec((1, n_part), lambda i: (i, 0))
        out_specs = [part_spec]
        out_shape = [jax.ShapeDtypeStruct((grid, n_part), jnp.float32)]
        if has_img:
            n_tex_planes = TEX_PLANES * cfg.max_depth
            out_specs.append(stk(n_tex_planes))
            out_shape.append(jax.ShapeDtypeStruct((n_tex_planes, rows, LANE),
                                                  jnp.float32))
        if backward == "residual":
            tabs = _tables(diffuse, specular, emission, exponent, texa,
                           texb, timg, env, with_exp=False)
            outs = pallas_call(
                bwd_res_kernel, interpret=interpret,
                name="kytpu_bwd_residual", grid=(grid,),
                in_specs=[whole] * (1 + len(tabs)) + [blk] * len(gl)
                + [stk(res_n), stk(n_bounce)],
                out_specs=out_specs, out_shape=out_shape,
            )(_seed(seed), *tabs, *gl, resf, resi)
        else:
            tabs = _tables(diffuse, specular, emission, exponent, texa,
                           texb, timg, env)
            lanes = _lanes(o, d, si, pix, npad) + gl
            outs = pallas_call(
                bwd_kernel, interpret=interpret, name="kytpu_bwd_replay",
                grid=(grid,),
                in_specs=[whole] * (1 + len(tabs)) + [blk] * len(lanes),
                out_specs=out_specs, out_shape=out_shape,
            )(_seed(seed), *tabs, *lanes)
        dd, ds, de, denv, dexp, dta, dtb = _unpack_partials(
            outs[0], m_rows, t_rows, use_texp)
        if dexp is None:
            dexp = jnp.zeros((m_rows,), jnp.float32)
        if dta is None:
            dta = jnp.zeros((t_rows, 3), jnp.float32)
            dtb = jnp.zeros((t_rows, 3), jnp.float32)
        dti = (texel_adjoint(outs[1], n, img_shape) if has_img
               else jnp.zeros(img_shape, jnp.float32))
        return (dd, ds, de, dexp, dta, dtb, dti, denv,
                jnp.zeros_like(o), jnp.zeros_like(d), None, None, None)

    trace.defvjp(_fwd, _bwd)
    trace_jit = jax.jit(trace)
    # defaults for non-trainable slots (cotangents are discarded): the
    # exponent table and the scene's texture tables. Public positional
    # order: diffuse, specular, emission, [exponent if trainable_exponent],
    # [texa, texb if textured], [timg (ti_n, th, tw, 3) if image-textured],
    # env, o, d, seed, [si, pix if sobol].
    exp0 = scene.mat_exponent
    tex_a0 = scene.textures.color_a if has_tex \
        else jnp.zeros((0, 3), jnp.float32)
    tex_b0 = scene.textures.color_b if has_tex \
        else jnp.zeros((0, 3), jnp.float32)
    timg0 = scene.textures.image if has_img \
        else jnp.zeros((0, 3), jnp.float32)

    def public(diffuse, specular, emission, *rest):
        rest = list(rest)
        exponent = rest.pop(0) if use_texp else exp0
        texa = rest.pop(0) if has_tex else tex_a0
        texb = rest.pop(0) if has_tex else tex_b0
        timg = rest.pop(0) if has_img else timg0
        env, o, d, seed = rest[:4]
        si, pix = (rest[4], rest[5]) if len(rest) > 4 else (None, None)
        return trace_jit(diffuse, specular, emission, exponent, texa, texb,
                         timg, env, o, d, seed, si, pix)

    _TRACER_MEMO[memo_key] = public
    return public


def render_pallas(scene, spp: int = 16, seed: int = 1234,
                  cfg: KernelConfig | None = None, clamp: bool = True,
                  rays_per_pass: int = 1 << 22, interpret: bool = False,
                  tracer=None):
    """Full-frame render through the megakernel -> (H, W, 3) float32.

    Camera ray generation + jitter run as (cheap) XLA ops outside the
    kernel; each pass traces up to rays_per_pass lanes. With the default
    sampler, pass seeds fold the pass index so every sample draws an
    independent in-kernel stream; with cfg.sampler == "sobol" the seed is
    held FIXED and the per-lane sample index advances instead — camera
    jitter and every in-kernel draw site walk per-pixel Owen-scrambled
    (0,2)-sequences (camera dims via core/lds.py, path dims in-kernel).
    """
    import numpy as np

    from kytpu.core import rng as krng
    from kytpu.scene import scene as kscene

    cfg = cfg or KernelConfig()
    use_sobol = cfg.sampler == "sobol"
    use_hash = cfg.sampler == "hash"
    if tracer is None:
        tracer = make_pallas_tracer(scene, cfg, interpret)
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    k = max(1, min(spp, rays_per_pass // max(npix, 1)))

    pid = jnp.asarray(np.arange(npix, dtype=np.int32))
    px0 = (pid % w).astype(jnp.float32)
    py0 = (pid // w).astype(jnp.float32)
    key = jax.random.key(seed)

    # one_pass is cached on the (memoized) tracer so repeated full-frame
    # renders don't re-trace the kernel builder every call; everything
    # seed-dependent is a traced argument
    pass_memo = getattr(tracer, "_render_passes", None)
    if pass_memo is None:
        pass_memo = {}
        try:
            tracer._render_passes = pass_memo
        except AttributeError:   # jit wrappers without settable attrs
            pass
    pass_key = (k, w, h, cfg.sampler,
                _static_digest([np.asarray(cam.position),
                                np.asarray(cam.front),
                                np.asarray(cam.right), np.asarray(cam.up)]))
    one_pass = pass_memo.get(pass_key)
    if one_pass is None:
        if use_sobol:
            pid_k = jnp.tile(pid, k)

            @jax.jit
            def one_pass(scene, cam_keys, s_base, seed_val):
                si = s_base + jnp.repeat(jnp.arange(k, dtype=jnp.int32),
                                         npix)
                u = krng.uniform2(cam_keys, "sobol", si)
                px = jnp.tile(px0, k) + u[:, 0]
                py = jnp.tile(py0, k) + u[:, 1]
                o, d = kscene.generate_rays(cam, jnp.stack([px, py], -1))
                out = tracer(scene, o, d, seed_val, si, pid_k)
                return out.reshape(k, npix, 3).sum(axis=0)
        elif use_hash:
            # mesh/pass-decomposition-invariant: camera jitter keyed by
            # (pixel, sample), in-kernel streams by (seed, pixel, sample)
            pid_k = jnp.tile(pid, k)

            @jax.jit
            def one_pass(scene, key, s_base, seed_val):
                si = s_base + jnp.repeat(jnp.arange(k, dtype=jnp.int32),
                                         npix)
                cam_keys = jax.vmap(jax.random.fold_in, (None, 0))(
                    key, si * jnp.int32(npix) + pid_k)
                u = jax.vmap(lambda kk: jax.random.uniform(kk, (2,)))(
                    cam_keys)
                px = jnp.tile(px0, k) + u[:, 0]
                py = jnp.tile(py0, k) + u[:, 1]
                o, d = kscene.generate_rays(cam, jnp.stack([px, py], -1))
                out = tracer(scene, o, d, seed_val, si, pid_k)
                return out.reshape(k, npix, 3).sum(axis=0)
        else:
            @jax.jit
            def one_pass(scene, kk, seed_val):
                u = jax.random.uniform(kk, (k * npix, 2))
                px = jnp.tile(px0, k) + u[:, 0]
                py = jnp.tile(py0, k) + u[:, 1]
                o, d = kscene.generate_rays(cam, jnp.stack([px, py], -1))
                out = tracer(scene, o, d, seed_val)
                return out.reshape(k, npix, 3).sum(axis=0)

        pass_memo[pass_key] = one_pass

    if use_sobol:
        # camera-jitter draw site: per-pixel keys, sample-independent
        cam_keys = jax.vmap(lambda p: jax.random.fold_in(key, p))(
            jnp.tile(pid, k))

    accum = jnp.zeros((npix, 3), jnp.float32)
    s0 = 0
    p = 0
    while s0 < spp:
        if use_sobol:
            accum = accum + one_pass(scene, cam_keys, jnp.int32(p * k),
                                     jnp.int32(seed))
        elif use_hash:
            accum = accum + one_pass(scene, key, jnp.int32(p * k),
                                     jnp.int32(seed))
        else:
            accum = accum + one_pass(scene, jax.random.fold_in(key, p),
                                     jnp.int32(seed + 7919 * p))
        s0 += k
        p += 1
    img = (accum / float(p * k)).reshape(h, w, 3)
    if clamp:
        img = jnp.clip(img, 0.0, 1.0)
    return img
