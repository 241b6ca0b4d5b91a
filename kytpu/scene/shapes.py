"""Structure-of-arrays geometry and batched ray intersection.

Data-parallel inversion of the reference's shape layer (ky.cpp:991-1521): instead
of virtual `shape_t::intersect` with a mutable shrinking ray tmax, all shapes
live in two dense SoA tables (planar: triangle/rectangle/disk, and spheres),
every ray tests every row in one fused elementwise sweep, and the closest hit
is an argmin over the surface axis. This trades the CPU's early-out for
perfect vectorization — at the reference's scene sizes (<= 16 surfaces) the
sweep is a handful of vector ops per ray.

Behavioral parity notes (constants required for pixel parity):
  - minimum hit distance epsilon = 1e-3          (ky.cpp:1093)
  - rectangle normals flip toward the ray at hit (ky.cpp:1289); triangles,
    disks and spheres do NOT flip.
  - rectangle area() is the full parallelogram |cross(p0-p1, p2-p1)|
    (ky.cpp:1304).
  - sphere intersection takes the near root, falling back to the far root
    (ky.cpp:1375-1382).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from kytpu.core import math as km

# planar sub-kinds
TRI = 0
RECT = 1
DISK = 2


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Geometry:
    """All scene geometry as two SoA blocks.

    Surfaces get a single global row index: planar rows occupy [0, P),
    sphere rows occupy [P, P+S).
    """

    # planar block (P rows); triangles store p3 == p0
    pl_kind: jax.Array    # (P,) int32 in {TRI, RECT, DISK}
    pl_p0: jax.Array      # (P, 3)
    pl_p1: jax.Array
    pl_p2: jax.Array
    pl_p3: jax.Array
    pl_normal: jax.Array  # (P, 3) unit, canonical orientation
    pl_radius: jax.Array  # (P,) disk radius (0 otherwise)
    pl_area: jax.Array    # (P,)

    # sphere block (S rows)
    sp_center: jax.Array  # (S, 3)
    sp_radius: jax.Array  # (S,)
    sp_area: jax.Array    # (S,)

    @property
    def n_planar(self) -> int:
        return self.pl_p0.shape[0]

    @property
    def n_sphere(self) -> int:
        return self.sp_center.shape[0]

    @property
    def n_surfaces(self) -> int:
        return self.n_planar + self.n_sphere


# ---------------------------------------------------------------------------
# builders (host-side, numpy) — one call per shape, stacked at the end
# ---------------------------------------------------------------------------


class GeometryBuilder:
    """Accumulates shapes on the host; `build()` freezes them into SoA arrays.

    Returns the global surface row index for each added shape so callers can
    bind materials / lights to rows. Planar shapes must be added before the
    row ids are meaningful, so the builder assigns ids only at build();
    use the returned handles.
    """

    def __init__(self):
        self._planar = []   # (kind, p0, p1, p2, p3, normal, radius, area)
        self._spheres = []  # (center, radius)
        self._handles = []  # ("pl"|"sp", local_index) in insertion order

    def add_triangle(self, p0, p1, p2, flip_normal=False) -> int:
        p0, p1, p2 = map(np.asarray, (p0, p1, p2))
        n = np.cross(p1 - p0, p2 - p0)
        area = 0.5 * np.linalg.norm(n)
        n = n / np.linalg.norm(n)
        if flip_normal:
            n = -n
        self._planar.append((TRI, p0, p1, p2, p0.copy(), n, 0.0, area))
        self._handles.append(("pl", len(self._planar) - 1))
        return len(self._handles) - 1

    def add_rectangle(self, p0, p1, p2, p3, flip_normal=False) -> int:
        p0, p1, p2, p3 = map(np.asarray, (p0, p1, p2, p3))
        n = np.cross(p1 - p0, p2 - p0)
        n = n / np.linalg.norm(n)
        if flip_normal:
            n = -n
        area = float(np.linalg.norm(np.cross(p0 - p1, p2 - p1)))
        self._planar.append((RECT, p0, p1, p2, p3, n, 0.0, area))
        self._handles.append(("pl", len(self._planar) - 1))
        return len(self._handles) - 1

    def add_disk(self, position, normal, radius) -> int:
        position = np.asarray(position)
        normal = np.asarray(normal, dtype=np.float64)
        normal = normal / np.linalg.norm(normal)
        area = float(np.pi * radius * radius)
        self._planar.append(
            (DISK, position, position.copy(), position.copy(), position.copy(),
             normal, float(radius), area)
        )
        self._handles.append(("pl", len(self._planar) - 1))
        return len(self._handles) - 1

    def add_sphere(self, center, radius) -> int:
        self._spheres.append((np.asarray(center), float(radius)))
        self._handles.append(("sp", len(self._spheres) - 1))
        return len(self._handles) - 1

    def build(self) -> tuple[Geometry, list[int]]:
        """Returns (geometry, surface_ids) — surface_ids[i] is the global row
        of the i-th added shape."""
        P = len(self._planar)
        f32 = np.float32

        def stack3(idx):
            if P == 0:
                return np.zeros((0, 3), f32)
            return np.stack([np.asarray(sh[idx], f32) for sh in self._planar])

        geom = Geometry(
            pl_kind=jnp.asarray(
                np.array([sh[0] for sh in self._planar], np.int32)),
            pl_p0=jnp.asarray(stack3(1)),
            pl_p1=jnp.asarray(stack3(2)),
            pl_p2=jnp.asarray(stack3(3)),
            pl_p3=jnp.asarray(stack3(4)),
            pl_normal=jnp.asarray(stack3(5)),
            pl_radius=jnp.asarray(
                np.array([sh[6] for sh in self._planar], f32)),
            pl_area=jnp.asarray(
                np.array([sh[7] for sh in self._planar], f32)),
            sp_center=jnp.asarray(
                np.stack([c for c, _ in self._spheres]).astype(f32)
                if self._spheres else np.zeros((0, 3), f32)),
            sp_radius=jnp.asarray(
                np.array([r for _, r in self._spheres], f32)),
            sp_area=jnp.asarray(
                np.array([4.0 * np.pi * r * r for _, r in self._spheres], f32)),
        )
        ids = []
        for block, local in self._handles:
            ids.append(local if block == "pl" else P + local)
        return geom, ids

    def world_bound(self):
        """Host-side AABB over all shapes (mirrors ky.cpp:3209-3219)."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for kind, p0, p1, p2, p3, n, radius, _ in self._planar:
            if kind == DISK:
                # frame-based extent like ky.cpp:1134-1139
                s, t = _onb_np(n)
                off = np.abs(s) * radius + np.abs(t) * radius
                lo = np.minimum(lo, p0 - off)
                hi = np.maximum(hi, p0 + off)
            else:
                pts = [p0, p1, p2] + ([p3] if kind == RECT else [])
                for p in pts:
                    lo = np.minimum(lo, p)
                    hi = np.maximum(hi, p)
        for c, r in self._spheres:
            lo = np.minimum(lo, c - r)
            hi = np.maximum(hi, c + r)
        return lo, hi

    def bounding_sphere(self):
        """(center, radius) of the world bound (ky.cpp:506-512)."""
        lo, hi = self.world_bound()
        center = 0.5 * (lo + hi)
        radius = float(np.linalg.norm(hi - center))
        return center, radius


def _onb_np(n):
    helper = np.array([0.0, 1.0, 0.0]) if abs(n[0]) > 0.99 else np.array([1.0, 0.0, 0.0])
    t = np.cross(n, helper)
    t = t / np.linalg.norm(t)
    s = np.cross(t, n)
    s = s / np.linalg.norm(s)
    return s, t


# ---------------------------------------------------------------------------
# batched intersection sweeps
# ---------------------------------------------------------------------------


def planar_test(oN, dN, tmaxN, kind, p0, p1, p2, p3, normal, radius):
    """Core planar hit test over broadcastable parameter tables.

    oN, dN: (N, 1, 3); tmaxN: (N, 1); shape tables: (1, P, ...) for the
    dense sweep or (N, I, ...) for gathered per-ray candidate lists (the
    grid accelerator). Returns (t, accept) with the broadcast (N, *) shape.

    Uses the SmallVCM sign-of-cross-products inside test for tri/rect
    (ky.cpp:1183-1212 / 1261-1296): the ray is inside the polygon iff the
    edge-plane dot products all share a sign. Triangles store p3 == p0, which
    degenerates the fourth edge test to exactly 0 — it is ignored for the
    all-negative case via the kind mask and harmlessly passes the >= 0 case.
    """
    oa = p0 - oN
    ob = p1 - oN
    oc = p2 - oN
    od = p3 - oN

    v0d = km.dot(jnp.cross(oc, ob), dN)
    v1d = km.dot(jnp.cross(ob, oa), dN)
    v2d = km.dot(jnp.cross(oa, od), dN)
    v3d = km.dot(jnp.cross(od, oc), dN)

    is_tri = kind == TRI
    is_disk = kind == DISK

    all_neg = (v0d < 0) & (v1d < 0) & (v3d < 0) & ((v2d < 0) | is_tri)
    all_pos = (v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0)
    inside_poly = all_neg | all_pos

    denom = km.dot(normal, dN)
    t = km.safe_div(km.dot(normal, oa), denom, fallback=jnp.inf)

    hit_p = oN + t[..., None] * dN
    in_disk = km.distance(hit_p, p0) <= radius

    inside = jnp.where(is_disk, in_disk, inside_poly)
    accept = inside & (t > km.SHAPE_EPSILON) & (t < tmaxN)
    return t, accept


def sphere_test(oN, dN, tmaxN, center, radius):
    """Core sphere hit test over broadcastable tables (see planar_test).

    Same roots as the reference's quadratic (ky.cpp:1336-1392) but computed
    stably for float32: the discriminant uses the perpendicular-distance form
    r^2 - |oc - (oc.d)d|^2 and the two roots come from Vieta's formula
    (t_a * t_b = |oc|^2 - r^2) so huge spheres (smallpt's 1e5-radius walls)
    don't suffer catastrophic cancellation.
    """
    oc = center - oN
    neg_b = km.dot(oc, dN)
    perp = oc - neg_b[..., None] * dN               # component of oc normal to d
    discr = radius**2 - km.length_squared(perp)
    sq = km.safe_sqrt(discr)
    c = km.length_squared(oc) - radius**2
    sgn = jnp.where(neg_b >= 0.0, 1.0, -1.0)
    q = neg_b + sgn * sq                            # no cancellation
    tq = km.safe_div(c, q)
    t1 = jnp.minimum(q, tq)                         # near root
    t2 = jnp.maximum(q, tq)                         # far root
    t1_ok = (t1 > km.SHAPE_EPSILON) & (t1 < tmaxN)
    t2_ok = (t2 > km.SHAPE_EPSILON) & (t2 < tmaxN)
    t = jnp.where(t1_ok, t1, t2)
    accept = (discr >= 0) & (t1_ok | t2_ok)
    return t, accept


def intersect_planar(geom: Geometry, o, d, tmax):
    """Hit parameter t for every (ray, planar-row) pair.

    o, d: (N, 3); tmax: (N,). Returns (t, accept): (N, P) each.
    """
    return planar_test(
        o[:, None, :], d[:, None, :], tmax[:, None],
        geom.pl_kind[None], geom.pl_p0[None], geom.pl_p1[None],
        geom.pl_p2[None], geom.pl_p3[None], geom.pl_normal[None],
        geom.pl_radius[None])


def intersect_sphere(geom: Geometry, o, d, tmax):
    """Near-then-far root sphere test. Returns (t, accept): (N, S)."""
    return sphere_test(o[:, None, :], d[:, None, :], tmax[:, None],
                       geom.sp_center[None], geom.sp_radius[None])


# Above this many total surfaces the sweeps switch from one dense
# (N, S)-shaped pass to a lax.scan over surface chunks: peak memory drops
# from O(N*S) to O(N*CHUNK) so million-lane batches survive thousand-surface
# scenes (the dense 1M x 1026 sweep needs ~24 GB of HBM; chunked ~1 GB).
_SWEEP_CHUNK = 128


def _pad_chunks(a, chunk, fill):
    """(S, ...) -> (C, chunk, ...) with `fill` padding rows."""
    s = a.shape[0]
    c = -(-s // chunk)
    pad = c * chunk - s
    if pad:
        a = jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)
    return a.reshape((c, chunk) + a.shape[1:])


class _GeomView:
    """Duck-typed chunk of Geometry for the intersect_* sweeps."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _planar_chunks(geom: Geometry):
    # zero-padded rows are rejected: normal 0 -> denom 0 -> t = inf
    return dict(
        pl_kind=_pad_chunks(geom.pl_kind, _SWEEP_CHUNK, 0),
        pl_p0=_pad_chunks(geom.pl_p0, _SWEEP_CHUNK, 0.0),
        pl_p1=_pad_chunks(geom.pl_p1, _SWEEP_CHUNK, 0.0),
        pl_p2=_pad_chunks(geom.pl_p2, _SWEEP_CHUNK, 0.0),
        pl_p3=_pad_chunks(geom.pl_p3, _SWEEP_CHUNK, 0.0),
        pl_normal=_pad_chunks(geom.pl_normal, _SWEEP_CHUNK, 0.0),
        pl_radius=_pad_chunks(geom.pl_radius, _SWEEP_CHUNK, 0.0),
    )


def _sphere_chunks(geom: Geometry):
    # far-away zero-radius padding: discriminant < 0 -> never accepted
    return dict(
        sp_center=_pad_chunks(geom.sp_center, _SWEEP_CHUNK, 1e30),
        sp_radius=_pad_chunks(geom.sp_radius, _SWEEP_CHUNK, 0.0),
    )


def _scan_closest(chunks, intersect, o, d, tmax, base, t_best, sid_best):
    n_chunks = next(iter(chunks.values())).shape[0]
    bases = base + jnp.arange(n_chunks, dtype=jnp.int32) * _SWEEP_CHUNK

    def body(carry, xs):
        tb, sb = carry
        ch_base, ch = xs
        t, acc = intersect(_GeomView(**ch), o, d, tmax)
        tm = jnp.where(acc, t, jnp.inf)
        i = jnp.argmin(tm, axis=1).astype(jnp.int32)
        tc = jnp.take_along_axis(tm, i[:, None], axis=1)[:, 0]
        better = tc < tb
        return (jnp.where(better, tc, tb),
                jnp.where(better, ch_base + i, sb)), None

    (t_best, sid_best), _ = jax.lax.scan(body, (t_best, sid_best),
                                         (bases, chunks))
    return t_best, sid_best


def closest_hit(geom: Geometry, o, d, tmax):
    """Global closest hit over both blocks.

    Returns (t, surface_id, valid): (N,), (N,) int32, (N,) bool.
    surface_id indexes the global row space (planar first, then spheres).
    """
    if geom.n_planar + geom.n_sphere > 2 * _SWEEP_CHUNK:
        n = o.shape[0]
        t_best = jnp.full((n,), jnp.inf, o.dtype)
        sid = jnp.zeros((n,), jnp.int32)
        if geom.n_planar:
            t_best, sid = _scan_closest(
                _planar_chunks(geom), intersect_planar, o, d, tmax, 0,
                t_best, sid)
        if geom.n_sphere:
            t_best, sid = _scan_closest(
                _sphere_chunks(geom), intersect_sphere, o, d, tmax,
                geom.n_planar, t_best, sid)
        return t_best, sid, jnp.isfinite(t_best)
    ts = []
    accs = []
    if geom.n_planar:
        tp, ap = intersect_planar(geom, o, d, tmax)
        ts.append(tp)
        accs.append(ap)
    if geom.n_sphere:
        tsph, asph = intersect_sphere(geom, o, d, tmax)
        ts.append(tsph)
        accs.append(asph)
    t_all = jnp.concatenate(ts, axis=1)
    a_all = jnp.concatenate(accs, axis=1)
    t_masked = jnp.where(a_all, t_all, jnp.inf)
    sid = jnp.argmin(t_masked, axis=1).astype(jnp.int32)
    t_best = jnp.take_along_axis(t_masked, sid[:, None], axis=1)[:, 0]
    valid = jnp.isfinite(t_best)
    return t_best, sid, valid


def _scan_any(chunks, intersect, o, d, tmax, hit, base, skip_row):
    n_chunks = next(iter(chunks.values())).shape[0]
    bases = base + jnp.arange(n_chunks, dtype=jnp.int32) * _SWEEP_CHUNK

    def body(carry, xs):
        ch_base, ch = xs
        _, acc = intersect(_GeomView(**ch), o, d, tmax)
        if skip_row is not None:
            rows = ch_base + jnp.arange(_SWEEP_CHUNK, dtype=jnp.int32)
            acc = acc & (rows[None, :] != skip_row[:, None])
        return carry | jnp.any(acc, axis=1), None

    hit, _ = jax.lax.scan(body, hit, (bases, chunks))
    return hit


def any_hit(geom: Geometry, o, d, tmax, skip_row=None):
    """Occlusion query: does ANY surface hit in (eps, tmax)? (N,) bool.

    skip_row: optional global surface row(s) to exclude — a python int or an
    (N,) int32 array (per-lane). Used by the robust shadow mode to exclude
    a light's own emitting surface from its NEE occlusion sweep; -1 entries
    skip nothing.
    """
    if skip_row is not None:
        skip_row = jnp.broadcast_to(jnp.asarray(skip_row, jnp.int32),
                                    (o.shape[0],))
    hit = jnp.zeros(o.shape[0], dtype=bool)
    if geom.n_planar + geom.n_sphere > 2 * _SWEEP_CHUNK:
        if geom.n_planar:
            hit = _scan_any(_planar_chunks(geom), intersect_planar,
                            o, d, tmax, hit, 0, skip_row)
        if geom.n_sphere:
            hit = _scan_any(_sphere_chunks(geom), intersect_sphere,
                            o, d, tmax, hit, geom.n_planar, skip_row)
        return hit
    if geom.n_planar:
        _, ap = intersect_planar(geom, o, d, tmax)
        if skip_row is not None:
            rows = jnp.arange(geom.n_planar, dtype=jnp.int32)
            ap = ap & (rows[None, :] != skip_row[:, None])
        hit = hit | jnp.any(ap, axis=1)
    if geom.n_sphere:
        _, asp = intersect_sphere(geom, o, d, tmax)
        if skip_row is not None:
            rows = geom.n_planar + jnp.arange(geom.n_sphere, dtype=jnp.int32)
            asp = asp & (rows[None, :] != skip_row[:, None])
        hit = hit | jnp.any(asp, axis=1)
    return hit


def surface_normal(geom: Geometry, sid, position, d):
    """Normal at the hit, with the reference's per-shape orientation rules.

    sid: (N,) global surface row, position: (N, 3) hit point, d: (N, 3) ray
    direction. Rectangles flip toward the ray (ky.cpp:1289); triangles and
    disks keep their canonical normal; spheres use the outward geometric
    normal (hit - center)/|...| (ky.cpp:1389) which faces inward when the ray
    starts inside.
    """
    P = geom.n_planar
    is_planar = sid < P
    pl_idx = jnp.clip(sid, 0, max(P - 1, 0))
    sp_idx = jnp.clip(sid - P, 0, max(geom.n_sphere - 1, 0))

    if P:
        n_pl = geom.pl_normal[pl_idx]
        kind = geom.pl_kind[pl_idx]
        flip = (kind == RECT) & (km.dot(n_pl, d) > 0)
        n_pl = jnp.where(flip[:, None], -n_pl, n_pl)
    else:
        n_pl = jnp.zeros_like(position)

    if geom.n_sphere:
        c = geom.sp_center[sp_idx]
        n_sp = km.normalize(position - c)
    else:
        n_sp = jnp.zeros_like(position)

    return jnp.where(is_planar[:, None], n_pl, n_sp)


def _gram_uv(r, e1, e2):
    """Solve r = u*e1 + v*e2 in the plane via the 2x2 Gram system; exact for
    skewed bases (barycentric coords for triangles, parallelogram coords for
    the reference's rects)."""
    a = km.length_squared(e1)
    b = km.dot(e1, e2)
    c = km.length_squared(e2)
    det = a * c - b * b
    r1 = km.dot(r, e1)
    r2 = km.dot(r, e2)
    u = km.safe_div(c * r1 - b * r2, det)
    v = km.safe_div(a * r2 - b * r1, det)
    return u, v


def surface_uv(geom: Geometry, sid, position):
    """Texture coordinates at the hit (see scene/texture.py for the
    conventions). sid: (N,) global surface row; position: (N, 3). -> (N, 2).

    The reference's texture region is an empty stub (ky.cpp:2559-2563); the
    parameterizations here are the standard ones per shape.
    """
    from kytpu.core import frame as kframe

    P = geom.n_planar
    is_planar = sid < P
    pl_idx = jnp.clip(sid, 0, max(P - 1, 0))
    sp_idx = jnp.clip(sid - P, 0, max(geom.n_sphere - 1, 0))

    if P:
        kind = geom.pl_kind[pl_idx]
        p0 = geom.pl_p0[pl_idx]
        p1 = geom.pl_p1[pl_idx]
        p2 = geom.pl_p2[pl_idx]
        # triangle: barycentric over (p0; p1-p0, p2-p0)
        ut, vt = _gram_uv(position - p0, p1 - p0, p2 - p0)
        # rectangle: corner p1 with edges to p0 (u) and p2 (v) — the corner
        # the reference's area/normal formulas pivot on (ky.cpp:1261, 1304)
        ur, vr = _gram_uv(position - p1, p0 - p1, p2 - p1)
        # disk: frame coords around the center, mapped to [0,1]^2
        s_ax, t_ax, _ = kframe.make_frame(geom.pl_normal[pl_idx])
        inv2r = km.safe_div(0.5, geom.pl_radius[pl_idx])
        rd = position - p0
        ud = 0.5 + km.dot(rd, s_ax) * inv2r
        vd = 0.5 + km.dot(rd, t_ax) * inv2r
        u_pl = jnp.select([kind == TRI, kind == RECT], [ut, ur], ud)
        v_pl = jnp.select([kind == TRI, kind == RECT], [vt, vr], vd)
    else:
        u_pl = jnp.zeros(position.shape[0], position.dtype)
        v_pl = u_pl

    if geom.n_sphere:
        n = km.normalize(position - geom.sp_center[sp_idx])
        theta = jnp.arccos(jnp.clip(n[..., 2], -1.0, 1.0))
        phi = jnp.arctan2(n[..., 1], n[..., 0])
        phi = jnp.where(phi < 0.0, phi + km.TWO_PI, phi)
        u_sp = phi * km.INV_2PI
        v_sp = theta * km.INV_PI
    else:
        u_sp = jnp.zeros(position.shape[0], position.dtype)
        v_sp = u_sp

    return jnp.stack([jnp.where(is_planar, u_pl, u_sp),
                      jnp.where(is_planar, v_pl, v_sp)], axis=-1)


# re-export: the offset lives in core.math so light sampling can use it
# without importing this module (avoids an import cycle).
offset_ray_origin = km.offset_ray_origin
