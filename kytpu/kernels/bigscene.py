"""Table-driven Pallas megakernel (Pallas through Triton) for LARGE
scenes (hundreds to thousands of surfaces).

The baked megakernel (kernels/wavefront.py) bakes geometry into the
instruction stream — the lowest per-ray cost, but code size and compile
time grow O(N) and the per-surface-row material machinery (select chains,
adjoint accumulators) assumes a handful of rows. This variant keeps the
same register-resident bounce loop but sweeps geometry with
`jax.lax.fori_loop` over SoA parameter tables:

  - one (rows, cols) table per shape class (tri/rect = shared layout,
    disk, sphere), geometry columns first, material columns after — the
    closest-hit loop reads whole rows as scalars (uniform across the
    block, so every thread reads the same L1-resident address) and
    CARRIES the winning hit's material through the sweep;
  - occlusion loops read only the geometry columns;
  - the sweeps walk UNROLL-row blocks of the Morton-sorted tables, and
    each block can be skipped by a conservative cone cull;
  - tables are global arrays read through L1/L2.

Transport is the same single-sample-MIS estimator as the baked kernel
(emission MIS-weighted against the light pdf of the ray that found it,
per-light NEE with the merged multi-ray occlusion sweep, iteration-rule
Russian roulette, ky.cpp:4523-4618 semantics), so it converges to the
same image as the jnp engines and the baked kernel. Differentiable
(make_bigscene_diff_tracer: residual or path-replay backward with
hit-row-tagged adjoint planes segment-summed in XLA), sampler-complete
(the stateless hash streams and the in-kernel Owen-Sobol lanes of the
baked kernel) and textured (checker and image textures on planar rows,
through the baked kernel's texture code).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from kytpu import bsdf as kbsdf
from kytpu.core import math as km
from kytpu.kernels import wavefront as wf
from kytpu.kernels.v3 import V3, make_frame, to_local, to_world, v3_full, v3_zeros
from kytpu.light import lights as klights
from kytpu.scene import shapes as kshapes

LANE = 128
UNROLL = 8

# planar table columns: geometry (occlusion loops read only these) ...
PG_NX, PG_NY, PG_NZ, PG_CN = 0, 1, 2, 3          # plane normal, n.anchor
PG_F1X, PG_F1Y, PG_F1Z, PG_K1 = 4, 5, 6, 7       # dual basis 1, f1.anchor
PG_F2X, PG_F2Y, PG_F2Z, PG_K2 = 8, 9, 10, 11     # dual basis 2, f2.anchor
PLANAR_GEO_COLS = 12
# disk table: normal, n.anchor, center, radius^2
DG_NX, DG_NY, DG_NZ, DG_CN, DG_PX, DG_PY, DG_PZ, DG_R2 = range(8)
DISK_GEO_COLS = 8
# sphere table: center, radius
SG_CX, SG_CY, SG_CZ, SG_R = range(4)
SPHERE_GEO_COLS = 4
# material columns appended after the geometry columns of every class
M_DIFX, M_DIFY, M_DIFZ = 0, 1, 2
M_SPCX, M_SPCY, M_SPCZ = 3, 4, 5
M_EMIX, M_EMIY, M_EMIZ = 6, 7, 8
M_KIND, M_EXP, M_ETA, M_SPROB, M_DPROB, M_LIX = 9, 10, 11, 12, 13, 14
M_ROW = 15   # global surface row (for the backward's adjoint scatter)
MAT_COLS = 16


def _pad_rows(a, mult=UNROLL):
    n = a.shape[0]
    npad = ((n + mult - 1) // mult) * mult if n else 0
    if npad == n:
        return a
    return np.concatenate([a, np.zeros((npad - n,) + a.shape[1:],
                                       a.dtype)], axis=0)


def _morton3(points: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """30-bit Morton keys of points quantized over [lo, hi]."""
    span = np.maximum(hi - lo, 1e-20)
    q = np.clip(((points - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1])
                                                << np.uint64(1)) \
        | spread(q[:, 2])


def _block_bounds(centers, radii):
    """Per-UNROLL-block bounding spheres of (already sorted, unpadded)
    per-entry bounds. Returns (n_blocks, 4) [cx cy cz r]; blocks made
    entirely of padding get r = -1 (miss every cull test)."""
    n = len(radii)
    npad = ((n + UNROLL - 1) // UNROLL) * UNROLL if n else 0
    out = np.zeros((npad // UNROLL if npad else 0, 4), np.float32)
    for b in range(out.shape[0]):
        i0, i1 = b * UNROLL, min((b + 1) * UNROLL, n)
        if i0 >= n:
            out[b] = [0, 0, 0, -1.0]
            continue
        cs = np.asarray(centers[i0:i1], np.float64)
        rs = np.asarray(radii[i0:i1], np.float64)
        lo = (cs - rs[:, None]).min(axis=0)
        hi = (cs + rs[:, None]).max(axis=0)
        c = (lo + hi) * 0.5
        r = float(np.max(np.linalg.norm(cs - c, axis=-1) + rs))
        out[b] = [c[0], c[1], c[2], r * 1.0001 + 1e-6]   # conservative pad
    return out


# above this many surface rows the baked kernel's O(N) unrolled sweeps
# make compiles grow past what a render is worth; the table kernel's
# compile is O(1) in the surface count
TABLE_KERNEL_MIN_ROWS = 64


def ineligibility(scene):
    """None if the table kernel can render `scene`, else the reason: it
    needs triangles, parallelogram rects, disks and spheres, with textures
    on planar rows only."""
    err = wf._kernel_texture_support(scene)
    if err:
        return err
    g = jax.device_get(scene.geometry)
    for i in range(g.n_planar):
        if int(np.asarray(g.pl_kind[i])) != kshapes.RECT:
            continue
        p0, p1, p2, p3 = (np.asarray(v[i], np.float64)
                          for v in (g.pl_p0, g.pl_p1, g.pl_p2, g.pl_p3))
        if not np.allclose(p3, p0 + p2 - p1, rtol=1e-5, atol=1e-7):
            return ("the table-driven kernel supports triangles, "
                    "parallelogram rectangles, disks and spheres — rect "
                    f"{i} is not a parallelogram")
    return None


def use_table_kernel(scene) -> bool:
    """The routing rule of every engine="pallas" entry point: the table
    kernel for scenes past TABLE_KERNEL_MIN_ROWS surface rows that it can
    render, the baked kernel otherwise."""
    return (int(scene.mat_kind.shape[0]) > TABLE_KERNEL_MIN_ROWS
            and ineligibility(scene) is None)


def extract_tables(scene):
    """Host-side extraction: geometry as numpy column blocks per shape
    class + the surface-row index of each table row (for gathering the
    traced material columns), plus the baked light records of
    wavefront.extract_static (lights are few; they stay constants).

    Rows within each class are sorted by the Morton code of their bound
    centers, so each UNROLL-row block is spatially compact; per-block
    bounding spheres feed the in-kernel cone cull (cfg.cull).

    Returns (static, tables) where tables = {class: (geo_np, rows_np,
    bounds_np)}. Raises NotImplementedError for scenes table_eligible
    rejects (callers route by that predicate first).
    """
    err = ineligibility(scene)
    if err:
        raise NotImplementedError(err)
    static = wf.extract_static(scene)
    tris, rects, disks = [], [], []
    tri_rows, rect_rows, disk_rows = [], [], []
    tri_b, rect_b, disk_b = [], [], []   # per-entry (center, radius)

    def vert_bound(verts):
        v = np.asarray(verts, np.float64)
        c = (v.min(axis=0) + v.max(axis=0)) * 0.5
        return c, float(np.max(np.linalg.norm(v - c, axis=-1)))

    for row, s in enumerate(static["planar"]):
        if s["kind"] == kshapes.DISK:
            n = np.asarray(s["n"], np.float64)
            p0 = np.asarray(s["p0"], np.float64)
            disks.append(list(n) + [float(np.dot(n, p0))] + list(p0)
                         + [s["radius"] ** 2])
            disk_rows.append(row)
            disk_b.append((p0, float(s["radius"])))
            continue
        if not s.get("fast"):
            raise NotImplementedError(
                "the table-driven kernel supports triangles, parallelogram "
                "rectangles, disks and spheres — this rect is not a "
                "parallelogram (use the baked megakernel / jnp engines)")
        n = np.asarray(s["n"], np.float64)
        anchor = np.asarray(s["anchor"], np.float64)
        f1 = np.asarray(s["f1"], np.float64)
        f2 = np.asarray(s["f2"], np.float64)
        rec = (list(n) + [float(np.dot(n, anchor))]
               + list(f1) + [float(np.dot(f1, anchor))]
               + list(f2) + [float(np.dot(f2, anchor))])
        if s["kind"] == kshapes.TRI:
            tris.append(rec)
            tri_rows.append(row)
            tri_b.append(vert_bound([s["p0"], s["p1"], s["p2"]]))
        else:
            rects.append(rec)
            rect_rows.append(row)
            rect_b.append(vert_bound([s["p0"], s["p1"], s["p2"], s["p3"]]))
    spheres = [list(np.asarray(s["c"], np.float64)) + [s["r"]]
               for s in static["spheres"]]
    sph_rows = [len(static["planar"]) + j for j in range(len(spheres))]
    sph_b = [(np.asarray(s["c"], np.float64), float(s["r"]))
             for s in static["spheres"]]

    # scene-wide AABB of bound centers for Morton quantization
    all_c = [c for bs in (tri_b, rect_b, disk_b, sph_b) for c, _ in bs]
    if all_c:
        allc = np.asarray(all_c, np.float64)
        lo, hi = allc.min(axis=0), allc.max(axis=0)
    else:
        lo = hi = np.zeros(3)

    def blk(lst, rows, bounds, cols):
        geo = np.asarray(lst, np.float32).reshape(len(lst), cols)
        rows = np.asarray(rows, np.int32)
        if len(bounds) > 1:
            centers = np.asarray([c for c, _ in bounds], np.float64)
            order = np.argsort(np.asarray(_morton3(centers, lo, hi)),
                               kind="stable")
            geo = geo[order]
            rows = rows[order]
            bounds = [bounds[i] for i in order]
        bnp = _block_bounds([c for c, _ in bounds],
                            [r for _, r in bounds])
        return _pad_rows(geo), _pad_rows(rows), bnp

    tables = {
        "tri": blk(tris, tri_rows, tri_b, PLANAR_GEO_COLS),
        "rect": blk(rects, rect_rows, rect_b, PLANAR_GEO_COLS),
        "disk": blk(disks, disk_rows, disk_b, DISK_GEO_COLS),
        "sphere": blk(spheres, sph_rows, sph_b, SPHERE_GEO_COLS),
    }
    # global surface row -> (table kind, table row); lets the robust shadow
    # mode skip a light's own geometry inside the table sweeps. Uses the
    # POST-SORT table order (rows_np holds the global row of each entry).
    table_of_row = {}
    n_real = {"tri": len(tris), "rect": len(rects), "disk": len(disks),
              "sphere": len(spheres)}
    for name in ("tri", "rect", "disk", "sphere"):
        for ti, row in enumerate(np.asarray(tables[name][1])[:n_real[name]]):
            table_of_row[int(row)] = (name, ti)
    static["table_of_row"] = table_of_row
    return static, tables


def _mat_cols(scene, rows_np, diffuse=None, specular=None, emission=None,
              exponent=None):
    """Traced (rows, MAT_COLS) material block gathered by surface row.

    diffuse/specular/emission/exponent override the scene tables (the diff
    tracer passes its differentiable arguments here so the gathers are
    traced functions of them)."""
    rows = jnp.asarray(rows_np, jnp.int32)
    npad = rows.shape[0]
    if npad == 0:
        return jnp.zeros((0, MAT_COLS), jnp.float32)
    diffuse = scene.mat_diffuse if diffuse is None else diffuse
    specular = scene.mat_specular if specular is None else specular
    emission = scene.emission if emission is None else emission
    exponent = scene.mat_exponent if exponent is None else exponent
    cols = jnp.concatenate([
        diffuse[rows],
        specular[rows],
        emission[rows],
        scene.mat_kind[rows].astype(jnp.float32)[:, None],
        exponent[rows][:, None],
        scene.mat_eta[rows][:, None],
        scene.mat_s_prob[rows][:, None],
        scene.mat_d_prob[rows][:, None],
        scene.light_index[rows].astype(jnp.float32)[:, None],
        rows.astype(jnp.float32)[:, None],
    ], axis=-1)
    return cols.astype(jnp.float32)


class _Carry:
    """Closest-hit sweep carry: winner's t, normal and material columns."""

    FIELDS = ("t", "nx", "ny", "nz", "difx", "dify", "difz",
              "spcx", "spcy", "spcz", "emix", "emiy", "emiz",
              "kind", "exp", "eta", "sprob", "dprob", "lix", "row")

    @staticmethod
    def init(shp):
        z = jnp.zeros(shp, jnp.float32)
        vals = {f: z for f in _Carry.FIELDS}
        vals["t"] = jnp.full(shp, np.float32(np.inf))
        vals["lix"] = z - 1.0
        vals["row"] = z - 1.0
        return tuple(vals[f] for f in _Carry.FIELDS)

    @staticmethod
    def select(carry, accept, t, n: V3, mat):
        """mat: list of MAT_COLS traced scalars (table row slice)."""
        vals = dict(zip(_Carry.FIELDS, carry))
        new = dict(t=t, nx=n.x, ny=n.y, nz=n.z,
                   difx=mat[M_DIFX], dify=mat[M_DIFY], difz=mat[M_DIFZ],
                   spcx=mat[M_SPCX], spcy=mat[M_SPCY], spcz=mat[M_SPCZ],
                   emix=mat[M_EMIX], emiy=mat[M_EMIY], emiz=mat[M_EMIZ],
                   kind=mat[M_KIND], exp=mat[M_EXP], eta=mat[M_ETA],
                   sprob=mat[M_SPROB], dprob=mat[M_DPROB], lix=mat[M_LIX],
                   row=mat[M_ROW])
        return tuple(jnp.where(accept, new[f], vals[f])
                     for f in _Carry.FIELDS)


def _planar_row_test(tab_ref, s, o: V3, d: V3, tri: bool):
    """(t, inside, n) for planar table row s (padded rows have n = 0 =>
    t = 0/0 = nan, rejected by every comparison)."""
    n = V3(tab_ref[s, PG_NX], tab_ref[s, PG_NY], tab_ref[s, PG_NZ])
    t = (tab_ref[s, PG_CN] - n.dot(o)) / n.dot(d)
    f1 = V3(tab_ref[s, PG_F1X], tab_ref[s, PG_F1Y], tab_ref[s, PG_F1Z])
    f2 = V3(tab_ref[s, PG_F2X], tab_ref[s, PG_F2Y], tab_ref[s, PG_F2Z])
    a = (f1.dot(o) - tab_ref[s, PG_K1]) + t * f1.dot(d)
    b = (f2.dot(o) - tab_ref[s, PG_K2]) + t * f2.dot(d)
    if tri:
        inside = (a >= 0) & (b >= 0) & (a + b <= 1.0)
    else:
        inside = (a >= 0) & (a <= 1.0) & (b >= 0) & (b <= 1.0)
    return t, inside, n


def _disk_row_test(tab_ref, s, o: V3, d: V3):
    n = V3(tab_ref[s, DG_NX], tab_ref[s, DG_NY], tab_ref[s, DG_NZ])
    t = (tab_ref[s, DG_CN] - n.dot(o)) / n.dot(d)
    p0 = V3(tab_ref[s, DG_PX], tab_ref[s, DG_PY], tab_ref[s, DG_PZ])
    hp = o + d * t
    inside = (hp - p0).length_squared() <= tab_ref[s, DG_R2]
    return t, inside, n


def _sphere_row_parts(tab_ref, s, o: V3, d: V3):
    """Cancellation-free quadratic setup, bitwise-matching the baked
    kernel's _closest_hit: the naive discr = r^2 - |oc|^2 + (oc.d)^2
    loses ~|oc|^2 * eps absolutely, which at a grazing hit far from the
    origin fakes/shifts roots by O(0.1 r) — the hit normal then comes out
    non-unit, the shading frame skews, and pow(cos_alpha > 1, exponent)
    overflows downstream. perp-decomposition keeps the error local."""
    c = V3(tab_ref[s, SG_CX], tab_ref[s, SG_CY], tab_ref[s, SG_CZ])
    r = tab_ref[s, SG_R]
    oc = c - o
    neg_b = oc.dot(d)
    perp = oc - d * neg_b
    discr = r * r - perp.length_squared()
    cc = oc.length_squared() - r * r
    return c, r, cc, neg_b, discr


def _block(i, body, cy):
    """The UNROLL rows of block i (an inner loop: one copy of the row
    test in the compiled kernel keeps compiles short)."""
    return jax.lax.fori_loop(i * UNROLL, (i + 1) * UNROLL, body, cy)


def _fori(n_rows, body, carry):
    """fori_loop over padded table rows, in UNROLL-row blocks."""
    if n_rows == 0:
        return carry
    return jax.lax.fori_loop(0, n_rows // UNROLL,
                             lambda i, cy: _block(i, body, cy), carry)


def _fori_culled(n_rows, body, carry, block_pred):
    """_fori, but each UNROLL-row block is skipped entirely (lax.cond on
    a block-uniform scalar, so the whole program branches together) when
    block_pred(i) says no ray can meet the block's bounding sphere."""
    if n_rows == 0:
        return carry
    if block_pred is None:
        return _fori(n_rows, body, carry)

    def outer(i, cy):
        return jax.lax.cond(block_pred(i), lambda c: _block(i, body, c),
                            lambda c: c, cy)

    return jax.lax.fori_loop(0, n_rows // UNROLL, outer, carry)


def _ray_cone(o: V3, d: V3, extra_ro=0.0):
    """Scalar bounding cone of a tile's rays: origins inside the sphere
    (O, ro), unit directions within angle acos(cos_min) of axis a. All
    eight values are rank-0 (full-plane reductions happen ONCE per sweep;
    per-block tests are then pure scalar math)."""
    xlo, xhi = jnp.min(o.x), jnp.max(o.x)
    ylo, yhi = jnp.min(o.y), jnp.max(o.y)
    zlo, zhi = jnp.min(o.z), jnp.max(o.z)
    ox = (xlo + xhi) * 0.5
    oy = (ylo + yhi) * 0.5
    oz = (zlo + zhi) * 0.5
    ro = jnp.sqrt((xhi - xlo) ** 2 + (yhi - ylo) ** 2
                  + (zhi - zlo) ** 2) * 0.5 + np.float32(extra_ro)
    sx, sy, sz = jnp.sum(d.x), jnp.sum(d.y), jnp.sum(d.z)
    sl = jnp.sqrt(sx * sx + sy * sy + sz * sz)
    inv = np.float32(1.0) / jnp.maximum(sl, np.float32(1e-20))
    ax, ay, az = sx * inv, sy * inv, sz * inv
    cos_min = jnp.min(ax * d.x + ay * d.y + az * d.z)
    sin_min = jnp.sqrt(jnp.maximum(np.float32(1.0) - cos_min * cos_min,
                                   np.float32(0.0)))
    # non-finite inputs must disable culling, not mis-cull: a NaN poisons
    # cos_min, and every comparison on it is False — detect and force the
    # "always hit" state (cos_min = -1)
    fin = jnp.isfinite(ox + oy + oz + ro + cos_min)
    cos_min = jnp.where(fin, cos_min, np.float32(-1.0))
    sin_min = jnp.where(fin, sin_min, np.float32(0.0))
    ro = jnp.where(fin, ro, np.float32(np.inf))
    return (ox, oy, oz, ro, ax, ay, az, cos_min, sin_min)


def _cone_hits_block(cone, bref, i, tmax=None):
    """Conservative scalar test: can ANY ray of the cone meet block i's
    bounding sphere? (Supporting-halfspace distance bound — skips only
    when the true distance to the cone exceeds R, so culling never
    changes the image.) tmax (scalar) additionally prunes blocks farther
    than the longest ray."""
    ox, oy, oz, ro, ax, ay, az, cos_min, sin_min = cone
    cx, cy_, cz, r = bref[i, 0], bref[i, 1], bref[i, 2], bref[i, 3]
    R = r + ro
    vx, vy, vz = cx - ox, cy_ - oy, cz - oz
    d2 = vx * vx + vy * vy + vz * vz
    a1 = vx * ax + vy * ay + vz * az
    e = jnp.sqrt(jnp.maximum(d2 - a1 * a1, np.float32(0.0)))
    dist = cos_min * e - sin_min * a1
    hit = (d2 <= R * R) | (dist <= R)
    # obtuse cones are non-convex — the halfspace bound is invalid there,
    # so fall back to "always hit" (no culling when rays are incoherent)
    hit = hit | (cos_min <= np.float32(0.0))
    hit = hit & (r >= np.float32(0.0))      # r < 0 marks all-padding blocks
    if tmax is not None:
        hit = hit & (d2 <= (R + tmax) * (R + tmax))
    return hit


def _closest_hit_tables(refs, counts, o: V3, d: V3, bounds=None,
                        cull_on=True):
    """Table-sweep closest hit. Returns the _Carry tuple (+ valid mask).

    bounds: optional (tri_b, rect_b, disk_b, sph_b) block-bound refs —
    enables the per-block cone cull (exact-conservative; identical
    results, fewer row tests on coherent tiles)."""
    tri_ref, rect_ref, disk_ref, sph_ref = refs
    carry = _Carry.init(o.x.shape)
    preds = [None] * 4
    if bounds is not None:
        cone = _ray_cone(o, d)
        preds = [
            (lambda i, b=b: _cull_gate(_cone_hits_block(cone, b, i),
                                       cull_on))
            if b is not None else None for b in bounds]

    def planar_body(tri, geo_cols):
        def body(s, cy):
            ref = tri_ref if tri else rect_ref
            t, inside, n = _planar_row_test(ref, s, o, d, tri)
            t_best = cy[0]
            accept = inside & (t > km.SHAPE_EPSILON) & (t < t_best)
            if not tri:
                flip = n.dot(d) > 0
                n = V3(jnp.where(flip, -n.x, n.x),
                       jnp.where(flip, -n.y, n.y),
                       jnp.where(flip, -n.z, n.z))
            mat = [ref[s, geo_cols + c] for c in range(MAT_COLS)]
            return _Carry.select(cy, accept, t, n, mat)
        return body

    carry = _fori_culled(counts["tri"], planar_body(True, PLANAR_GEO_COLS),
                         carry, preds[0])
    carry = _fori_culled(counts["rect"],
                         planar_body(False, PLANAR_GEO_COLS), carry,
                         preds[1])

    def disk_body(s, cy):
        t, inside, n = _disk_row_test(disk_ref, s, o, d)
        accept = inside & (t > km.SHAPE_EPSILON) & (t < cy[0])
        mat = [disk_ref[s, DISK_GEO_COLS + c] for c in range(MAT_COLS)]
        return _Carry.select(cy, accept, t, n, mat)

    carry = _fori_culled(counts["disk"], disk_body, carry, preds[2])

    def sph_body(s, cy):
        c, r, cc, neg_b, discr = _sphere_row_parts(sph_ref, s, o, d)
        sq = wf._safe_sqrt(discr)
        sgn = jnp.where(neg_b >= 0.0, np.float32(1.0), np.float32(-1.0))
        q = neg_b + sgn * sq
        tq = cc / q    # raw div: q==0 -> inf/nan, rejected by the gates
        t1 = jnp.minimum(q, tq)
        t2 = jnp.maximum(q, tq)
        t1_ok = t1 > km.SHAPE_EPSILON
        t = jnp.where(t1_ok, t1, t2)
        accept = (discr >= 0) & (r > 0) \
            & (t1_ok | (t2 > km.SHAPE_EPSILON)) & (t < cy[0])
        n = (o + d * t - c) * (np.float32(1.0) / jnp.maximum(r, 1e-20))
        mat = [sph_ref[s, SPHERE_GEO_COLS + c] for c in range(MAT_COLS)]
        return _Carry.select(cy, accept, t, n, mat)

    carry = _fori_culled(counts["sphere"], sph_body, carry, preds[3])
    return carry


def _any_hit_tables(refs, counts, hp: V3, n_shade: V3, rays,
                    robust: bool = False, own=None, bounds=None, nd=None,
                    cull_on=True):
    """Merged K-ray occlusion over the tables (geometry columns only);
    the wavefront._any_hit_multi algebra with traced per-row scalars.

    The hit accumulators are fori_loop CARRIES, so they live as int32
    planes; masks inside the body stay compare-born. Returns K bool
    masks.

    own: per-ray (table kind, table row) of the sampled light's own
    geometry, or None — the robust shadow mode gates that row out of ray
    k's sweep with a scalar loop-index compare."""
    tri_ref, rect_ref, disk_ref, sph_ref = refs
    eps = km.SHAPE_EPSILON
    K = len(rays)
    if nd is None:
        nd = [n_shade.dot(wi) for wi, _ in rays]
    se = [jnp.where(nd[k] < 0.0, np.float32(-km.RAY_OFFSET),
                    np.float32(km.RAY_OFFSET)) for k in range(K)]
    if robust:
        # KernelConfig(shadow="robust"): tmax from the actual offset origin
        # (first-order; see wavefront._any_hit_multi)
        rays = [(rays[k][0], rays[k][1] - se[k] * nd[k]) for k in range(K)]
    one = np.int32(1)
    hits = tuple(jnp.zeros(hp.x.shape, jnp.int32) for _ in range(K))

    preds = [None] * 4
    if bounds is not None:
        # one cone per shadow ray (origins = the tile's shading points,
        # inflated by the origin offset; tmax prunes blocks beyond the
        # farthest light sample). A block is swept if ANY ray's cone can
        # reach it — shadow cones toward compact lights are tight, so
        # most blocks skip even on incoherent bounces.
        cones = [(_ray_cone(hp, wi, extra_ro=km.RAY_OFFSET),
                  jnp.max(jnp.where(jnp.isnan(tmax), np.float32(np.inf),
                                    tmax))) for wi, tmax in rays]

        def union_pred(b):
            def pred(i):
                h = None
                for cone, tm in cones:
                    hk = _cone_hits_block(cone, b, i, tmax=tm)
                    h = hk if h is None else (h | hk)
                return _cull_gate(h, cull_on)
            return pred

        preds = [union_pred(b) if b is not None else None for b in bounds]

    def planar_body(tri):
        ref = tri_ref if tri else rect_ref

        def body(s, hs):
            n = V3(ref[s, PG_NX], ref[s, PG_NY], ref[s, PG_NZ])
            f1 = V3(ref[s, PG_F1X], ref[s, PG_F1Y], ref[s, PG_F1Z])
            f2 = V3(ref[s, PG_F2X], ref[s, PG_F2Y], ref[s, PG_F2Z])
            num_h = ref[s, PG_CN] - n.dot(hp)
            num_n = n.dot(n_shade)
            a_h = f1.dot(hp) - ref[s, PG_K1]
            a_n = f1.dot(n_shade)
            b_h = f2.dot(hp) - ref[s, PG_K2]
            b_n = f2.dot(n_shade)
            name = "tri" if tri else "rect"
            out = []
            for k in range(K):
                wi, tmax = rays[k]
                t = (num_h - se[k] * num_n) / n.dot(wi)
                a = (a_h + se[k] * a_n) + t * f1.dot(wi)
                b = (b_h + se[k] * b_n) + t * f2.dot(wi)
                if tri:
                    inside = (a >= 0) & (b >= 0) & (a + b <= 1.0)
                else:
                    inside = (a >= 0) & (a <= 1.0) & (b >= 0) & (b <= 1.0)
                h = inside & (t > eps) & (t < tmax)
                if own is not None and own[k] is not None \
                        and own[k][0] == name:
                    h = h & (s != np.int32(own[k][1]))
                out.append(jnp.where(h, one, hs[k]))
            return tuple(out)
        return body

    hits = _fori_culled(counts["tri"], planar_body(True), hits,
                        preds[0])
    hits = _fori_culled(counts["rect"], planar_body(False), hits,
                        preds[1])

    def disk_body(s, hs):
        n = V3(disk_ref[s, DG_NX], disk_ref[s, DG_NY], disk_ref[s, DG_NZ])
        p0 = V3(disk_ref[s, DG_PX], disk_ref[s, DG_PY], disk_ref[s, DG_PZ])
        num_h = disk_ref[s, DG_CN] - n.dot(hp)
        num_n = n.dot(n_shade)
        r2 = disk_ref[s, DG_R2]
        out = []
        for k in range(K):
            wi, tmax = rays[k]
            t = (num_h - se[k] * num_n) / n.dot(wi)
            o_k = hp + n_shade * se[k]
            rel = o_k + wi * t - p0
            inside = rel.length_squared() <= r2
            h = inside & (t > eps) & (t < tmax)
            if own is not None and own[k] is not None \
                    and own[k][0] == "disk":
                h = h & (s != np.int32(own[k][1]))
            out.append(jnp.where(h, one, hs[k]))
        return tuple(out)

    hits = _fori_culled(counts["disk"], disk_body, hits, preds[2])
    off2 = np.float32(km.RAY_OFFSET * km.RAY_OFFSET)

    def sph_body(s, hs):
        c = V3(sph_ref[s, SG_CX], sph_ref[s, SG_CY], sph_ref[s, SG_CZ])
        r = sph_ref[s, SG_R]
        vc = c - hp
        vc2 = vc.length_squared()
        vcn = vc.dot(n_shade)
        out = []
        for k in range(K):
            wi, tmax = rays[k]
            neg_b = vc.dot(wi) - se[k] * nd[k]
            oc2 = vc2 - 2.0 * se[k] * vcn + off2
            discr = r * r - oc2 + neg_b * neg_b
            # sqrt-free root-in-range test (wavefront._any_hit_multi)
            a_c = neg_b - eps
            b_c = neg_b - tmax
            a2 = a_c * a_c
            b2 = b_c * b_c
            a_pos = a_c > 0.0
            b_neg = b_c < 0.0
            in1 = a_pos & (discr < a2) & (b_neg | (discr > b2))
            in2 = (a_pos | (discr > a2)) & b_neg & (discr < b2)
            h = (discr >= 0) & (r > 0) & (in1 | in2)
            if own is not None and own[k] is not None \
                    and own[k][0] == "sphere":
                h = h & (s != np.int32(own[k][1]))
            out.append(jnp.where(h, one, hs[k]))
        return tuple(out)

    hits = _fori_culled(counts["sphere"], sph_body, hits, preds[3])
    return [h != 0 for h in hits]


def _bigres_layout(cfg: wf.KernelConfig, L: int, has_env: bool,
                   has_img: bool = False):
    """Plane order of the table kernel's coefficient cache (the residual
    backward's input; the bigscene analog of wavefront._residual_layout).
    Per shading bounce: "wb" (emission-MIS weight, fully masked), "wenv"
    (env scenes), one "B" per NEE light ("Bk" kappa partners with
    trainable exponents), "tu"/"tuk", and the hit's table colors
    "dif"/"spc"/"emi" (3 planes each) — at thousands of surface rows the
    backward cannot re-select them from tables, so the forward caches the
    VALUES ("dif" holds the POST-texture diffuse on textured rows; the
    per-texture adjoint routing uses the parity bit / "tx"/"ty" planes,
    and the row-tagged diffuse share is zeroed there). With image
    textures ("tx"/"ty") the continuous texel coordinates of the hit are
    cached per bounce, exactly as wavefront._residual_layout. The horizon
    bounce stores only wb/wenv/emi. The per-bounce int plane packs
    (row+1) | phong<<20 | to_spec<<21 | checker_even<<22."""
    texp = cfg.trainable_exponent
    tags = []
    for b in range(cfg.max_depth + 1):
        tags.append(("wb", b))
        if has_env:
            tags.append(("wenv", b))
        for c in range(3):
            tags.append(("emi", b, c))
        if b < cfg.max_depth:
            for i in range(L):
                tags.append(("B", b, i))
                if texp:
                    tags.append(("Bk", b, i))
            tags.append(("tu", b))
            if texp:
                tags.append(("tuk", b))
            for c in range(3):
                tags.append(("dif", b, c))
            for c in range(3):
                tags.append(("spc", b, c))
            if has_img:
                tags.append(("tx", b))
                tags.append(("ty", b))
    return {t: i for i, t in enumerate(tags)}, len(tags)


def _cull_gate(hit, cull_on):
    """A block is swept if its cone test hits or the cull is off (cull_on:
    python True, or a traced scalar mask)."""
    return hit if cull_on is True else hit | ~cull_on


def _first_bounce(bounce, bounds, sweep):
    """sweep(bounds, cull_on) with the cone cull on at bounce 0 only: it
    pays only on coherent camera rays. Inside the bounce loop the cull
    predicate is or-ed with `bounce != 0`, so one copy of the sweep
    serves every bounce."""
    if bounds is None:
        return sweep(None, True)
    if isinstance(bounce, int):
        return sweep(bounds if bounce == 0 else None, True)
    return sweep(bounds, bounce == 0)


def _tex_partial_planes(acc_ta, acc_tb):
    """Checker color_a then color_b adjoint planes (3 per texture), the
    order _unpack_tex_partials reads them back in."""
    return [c for acc in (acc_ta, acc_tb) for v in acc for c in (v.x, v.y,
                                                                 v.z)]


def _unpack_tex_partials(parts, t_rows: int):
    v = wf.sum_partials(parts, 6 * t_rows)
    return (v[:3 * t_rows].reshape(t_rows, 3),
            v[3 * t_rows:].reshape(t_rows, 3))


def _make_kernel(static, counts, cfg: wf.KernelConfig, grad: bool = False,
                 residual: bool = False):
    """Forward transport over the geometry/material tables — the
    single-sample-MIS estimator of wavefront._make_kernel (ky.cpp
    path_tracing_iteration_t semantics) with every per-surface-row select
    replaced by the carried hit-record columns.

    grad=True builds the path-replay backward (same structure as the baked
    kernel's grad mode): it re-runs the transport on the same RNG stream
    carrying the tail radiance R_{b+1} = (R_b - E_b)/T_b, and instead of
    per-material-row accumulators (impossible at thousands of rows) it
    WRITES per-bounce per-lane adjoint-contribution planes tagged with the
    hit row — the caller segment-sums them into the (M, 3) gradients in
    XLA. Output layout (dout, planes):
      bounce b in [0, max_depth):  9 planes [dd.xyz, ds.xyz, de.xyz]
      horizon bounce:              3 planes [de.xyz]
      then 3 planes d_env and 3*L planes d_light_emit (per-lane sums over
      bounces; L = len(lights)); rows_out: (max_depth+1) int32 planes of
      sid+1 (0 = miss). Textured scenes add the checker-color partial
      table (one row per program) and, with image textures, the
      wavefront.TEX_PLANES texture-adjoint planes per shading bounce."""
    lights = static["lights"]
    L = len(lights)
    world_radius = static["world_radius"]
    # statically-present lobes from the scene's material kinds
    mk = set(static["mats"]["kind"])
    lobes = set()
    if kbsdf.MAT_MATTE in mk or kbsdf.MAT_PLASTIC in mk:
        lobes.add(kbsdf.LAMBERT)
    if kbsdf.MAT_PLASTIC in mk:
        lobes.add(kbsdf.PHONG)
    if kbsdf.MAT_MIRROR in mk:
        lobes.add(kbsdf.MIRROR)
    if kbsdf.MAT_GLASS in mk:
        lobes.add(kbsdf.GLASS)
    lobes = frozenset(lobes)
    eval_lobes = lobes & {kbsdf.LAMBERT, kbsdf.PHONG}
    has_plastic = kbsdf.MAT_PLASTIC in mk
    has_delta = bool(lobes & {kbsdf.MIRROR, kbsdf.GLASS})
    env_i = next((i for i, lt in enumerate(lights)
                  if lt["kind"] == klights.ENV), None)
    use_sobol = cfg.sampler == "sobol"
    use_hash = cfg.sampler == "hash"
    use_texp = cfg.trainable_exponent
    tex_recs = static.get("textures", [])
    img_recs = [r for r in tex_recs if r.get("kind") == "image"]
    n_tex = static.get("n_textures", 0)
    # robust shadow mode: per-light (table, row) of its own geometry
    own_geo = None
    if cfg.shadow == "robust":
        li_of = static["mats"]["light_index"]
        own_of_light = {}
        for m, li in enumerate(li_of):
            if li >= 0 and li not in own_of_light:
                own_of_light[li] = static["table_of_row"].get(m)
        own_geo = [own_of_light.get(i) for i in range(L)]

    use_cull = cfg.cull != "off"
    carry_phits = wf._lights_have_phit(lights, world_radius)
    PB = 10 if use_texp else 9   # dout planes per bounce (dd ds de [dx])

    def kernel(seed_ref, tri_ref, rect_ref, disk_ref, sph_ref,
               *rest_refs):
        out_refs = list(rest_refs)
        texa_ref = out_refs.pop(0) if tex_recs else None
        texb_ref = out_refs.pop(0) if tex_recs else None
        timg_ref = out_refs.pop(0) if img_recs else None
        if use_cull:
            # per-UNROLL-block bounding spheres for the cone cull
            bounds = tuple(
                (out_refs.pop(0) if counts[k] else None)
                for k in ("tri", "rect", "disk", "sphere"))
        else:
            bounds = None
        (light_emit_ref, env_ref,
         ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref) = out_refs[:8]
        out_refs = out_refs[8:]
        refs = (tri_ref, rect_ref, disk_ref, sph_ref)
        if use_sobol or use_hash:
            # per-lane sample-index / pixel-id planes precede the outputs
            si_ref = out_refs.pop(0)
            pix_ref = out_refs.pop(0)
        pid = pl.program_id(0)
        tile_seed = seed_ref[0] + pid * np.int32(2654435761 & 0x7fffffff)
        if use_sobol:
            rng = wf._Rng(tile_seed,
                          sobol=(si_ref[:],
                                 wf._pix_hash(pix_ref[:], seed_ref[0])))
        elif use_hash:
            # mesh-invariant stateless streams (see wavefront._Rng)
            lane_seed = wf._pix_hash(si_ref[:],
                                     wf._pix_hash(pix_ref[:], seed_ref[0]))
            rng = wf._Rng(lane_seed, per_lane=True)
        else:
            rng = wf._Rng(tile_seed)

        if grad:
            # (gx gy gz flx fly flz) inputs precede the outputs
            (gx_ref, gy_ref, gz_ref, flx_ref, fly_ref, flz_ref,
             dout_ref, rows_ref, *acc_refs) = out_refs
            part_ref = acc_refs.pop(0) if tex_recs else None
            tadj_ref = acc_refs.pop(0) if img_recs else None
            g = V3(gx_ref[:], gy_ref[:], gz_ref[:])
            r_tail = V3(flx_ref[:], fly_ref[:], flz_ref[:])
            def put(base, *planes):
                """Store dout planes from index `base` (affine in the
                bounce: PB planes per bounce, then the horizon's 3, the
                env's 3 and 3 per light)."""
                for k, v in enumerate(planes):
                    dout_ref[base + k] = v
            acc_env = v3_zeros(g.x)
            acc_le = [v3_zeros(g.x) for _ in range(L)]  # d light_emit
            if tex_recs:
                # textures are FEW even at scene scale: per-texture V3
                # accumulators live in-kernel exactly as in the baked
                # kernel (wavefront.py grad mode), reduced per program
                # into the partial table
                acc_ta = [v3_zeros(gx_ref[:]) for _ in range(n_tex)]
                acc_tb = [v3_zeros(gx_ref[:]) for _ in range(n_tex)]
        elif residual:
            lx_ref, ly_ref, lz_ref, resf_ref, resi_ref = out_refs
            res_ix, res_n = _bigres_layout(cfg, L, env_i is not None,
                                           bool(img_recs))
            ridx = wf._affine_index(res_ix, cfg.max_depth)
        else:
            lx_ref, ly_ref, lz_ref = out_refs

        o = V3(ox_ref[:], oy_ref[:], oz_ref[:])
        d = V3(dx_ref[:], dy_ref[:], dz_ref[:])
        shp = o.x.shape
        beta = v3_full(o.x, 1.0, 1.0, 1.0)
        big_l = v3_zeros(o.x)
        alive = jnp.zeros(shp, jnp.float32) < 1.0
        spec_prev = jnp.zeros(shp, jnp.int32)
        pdf_prev = jnp.ones(shp, jnp.float32)
        phits_prev = None   # wavefront._light_sample phit carry

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
                acc_le = list(st["acc_le"])
                acc_ta = list(st["acc_ta"]) if tex_recs else None
                acc_tb = list(st["acc_tb"]) if tex_recs else None

            def pack():
                out = dict(o=o, d=d, beta=beta, big_l=big_l,
                           alive=alive.astype(jnp.int32),
                           spec_prev=spec_prev, pdf_prev=pdf_prev)
                if carry_phits:
                    out["phits"] = list(phits_prev)
                if grad:
                    out.update(r_tail=r_tail, acc_env=acc_env,
                               acc_le=acc_le)
                    if tex_recs:
                        out.update(acc_ta=acc_ta, acc_tb=acc_tb)
                return out

            rng.at_bounce(bounce)
            # whole-tile dead skip: path death is spatially clustered
            # (sky/miss regions of the film die together) and lanes are
            # pixel-ordered, so whole tiles go dead early — skip their
            # sweeps entirely (alive fractions measured on random_spheres:
            # 0.64/0.23/0.13/0.08 at bounces 0-3)
            # the cone cull only pays for itself on COHERENT rays; after
            # bounce 0 directions are hemispherical (obtuse cones test
            # every block and the 129 scalar tests are pure overhead —
            # measured net-negative), so cull only the primary sweep
            def closest(_):
                return _first_bounce(
                    bounce, bounds,
                    lambda b, on: _closest_hit_tables(refs, counts, o, d,
                                                      bounds=b, cull_on=on))
            any_alive = jnp.max(jnp.where(alive, np.float32(1.0),
                                          np.float32(0.0))) > 0.0
            cy = jax.lax.cond(any_alive, closest,
                              lambda _: _Carry.init(o.x.shape), None)
            (t, nx, ny, nz, difx, dify, difz, spcx, spcy, spcz,
             emix, emiy, emiz, kindf, expo, eta, sprob, dprob, lixf,
             rowf) = cy
            valid = jnp.isfinite(t) & (t < np.float32(np.inf))
            nrm = V3(nx, ny, nz)
            t_safe = jnp.where(valid, t, 1.0)
            hp = o + d * t_safe
            wo = -d

            facing = nrm.dot(wo) > 0.0
            emit_mask = valid & facing
            le = V3(jnp.where(emit_mask, emix, 0.0),
                    jnp.where(emit_mask, emiy, 0.0),
                    jnp.where(emit_mask, emiz, 0.0))

            full = wf._full_mis(bounce, spec_prev, has_delta)
            if full is True:
                w_emit = jnp.ones(shp, jnp.float32)
            else:
                li_idx = lixf.astype(jnp.int32)
                if phits_prev is not None:
                    pdf_l_hit = jnp.zeros(shp, jnp.float32)
                    for i in range(L):
                        pdf_l_hit = jnp.where(li_idx == i, phits_prev[i],
                                              pdf_l_hit)
                else:
                    pdf_l_hit = wf._hit_light_pdf(lights, li_idx, o, d,
                                                  t_safe, nrm)
                w_emit = jnp.where(full, np.float32(1.0),
                                   wf._safe_div(pdf_prev,
                                                pdf_prev + pdf_l_hit))
            wb = jnp.where(alive, w_emit, 0.0)
            e_term = le * wb
            big_l = big_l + beta * e_term
            if grad:
                # d emission[row] of the hit-emission term
                wbm = jnp.where(emit_mask, wb, 0.0)
                de_b = g * beta * wbm
            elif residual:
                resf_ref[ridx(("wb", bounce))] = \
                    jnp.where(emit_mask, wb, 0.0)
                for c, v in enumerate((emix, emiy, emiz)):
                    resf_ref[ridx(("emi", bounce, c))] = v

            if env_i is not None:
                env = V3(env_ref[0, 0] * jnp.ones(shp, jnp.float32),
                         env_ref[0, 1] * jnp.ones(shp, jnp.float32),
                         env_ref[0, 2] * jnp.ones(shp, jnp.float32))
                if full is True:
                    w_env = np.float32(1.0)
                else:
                    pdf_env = wf._light_pdf(lights[env_i], o, nrm, d)
                    w_env = jnp.where(full, np.float32(1.0),
                                      wf._safe_div(pdf_prev,
                                                   pdf_prev + pdf_env))
                wenv = jnp.where(alive & ~valid, w_env, 0.0)
                e_term = e_term + env * wenv
                big_l = big_l + beta * env * wenv
                if grad:
                    acc_env = acc_env + g * beta * wenv
                elif residual:
                    resf_ref[ridx(("wenv", bounce))] = wenv

            if grad:
                rows_ref[bounce] = ((rowf.astype(jnp.int32) + np.int32(1))
                                    * valid.astype(jnp.int32))
            if horizon:
                if grad:
                    put(PB * cfg.max_depth, de_b.x, de_b.y, de_b.z)
                if residual:
                    resi_ref[bounce] = \
                        (rowf.astype(jnp.int32) + np.int32(1)) \
                        * valid.astype(jnp.int32)
                return pack()
            cont = alive & valid

            # material resolution from the carried columns
            diffuse = V3(difx, dify, difz)
            if tex_recs:
                # textured rows are FEW even in big scenes: the baked
                # kernel's static per-rec machinery applies unchanged,
                # selected by the carried global row. Parity masks /
                # texel coordinates are kept for the adjoint routing
                # (grad) and the coefficient cache (residual).
                sid_i = rowf.astype(jnp.int32)
                tex_par = [None if rec.get("kind") == "image"
                           else wf._checker_parity(static, rec, hp)
                           for rec in tex_recs]
                tex_xy = [wf._image_uv_xy(static, rec, hp)
                          if rec.get("kind") == "image" else None
                          for rec in tex_recs]
                diffuse = wf._apply_textures(
                    static, texa_ref, texb_ref, timg_ref,
                    sid_i, hp, diffuse, tex_par, tex_xy)
            specular = V3(spcx, spcy, spcz)
            is_matte = kindf == np.float32(kbsdf.MAT_MATTE)
            is_mirror = kindf == np.float32(kbsdf.MAT_MIRROR)
            is_glass = kindf == np.float32(kbsdf.MAT_GLASS)
            is_plastic = kindf == np.float32(kbsdf.MAT_PLASTIC)
            if has_plastic:
                u_lobe = rng.uniform(shp)
                pick_spec = u_lobe < sprob
                plastic_kind = jnp.where(pick_spec, np.int32(kbsdf.PHONG),
                                         np.int32(kbsdf.LAMBERT))
                inv_sp = 1.0 / jnp.maximum(sprob, 1e-12)
                inv_dp = 1.0 / jnp.maximum(dprob, 1e-12)
                plastic_col = (specular * inv_sp).where(pick_spec,
                                                        diffuse * inv_dp)
                lobe_is_phong = is_plastic & pick_spec
                lobe_scale = jnp.where(is_plastic,
                                       jnp.where(pick_spec, inv_sp, inv_dp),
                                       1.0)
            else:
                plastic_kind = np.int32(kbsdf.LAMBERT)
                plastic_col = diffuse
                lobe_is_phong = is_plastic & (t < -1.0)  # statically false
                lobe_scale = np.float32(1.0)
            kind = jnp.where(is_matte, np.int32(kbsdf.LAMBERT),
                             jnp.where(is_mirror, np.int32(kbsdf.MIRROR),
                                       jnp.where(is_glass,
                                                 np.int32(kbsdf.GLASS),
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

            s_f, t_f, n_f = make_frame(nrm)
            wo_l = to_local(s_f, t_f, n_f, wo)
            # world-space mirror direction for the per-light NEE eval
            # (wavefront._bsdf_eval_pdf_dots; one build per bounce)
            wr_w = (nrm * (wo_l.z * 2.0) - wo) \
                if kbsdf.PHONG in eval_lobes else None
            col_nee_tbl = specular.where(lobe_is_phong, diffuse) \
                if has_plastic else diffuse

            # ---- NEE: sample all lights, merged occlusion, accumulate ----
            u1, u2 = rng.uniform2(shp)
            azim = None
            if any(lt["kind"] in (klights.AREA_SPHERE, klights.ENV)
                   for lt in lights):
                cphi_s = jnp.cos(np.float32(km.TWO_PI) * u2)
                azim = (cphi_s, wf._sin_from_phi_cos(cphi_s, u2))
            smps = [wf._light_sample(lt, world_radius, hp, nrm, u1, u2,
                                     azim) for lt in lights]
            nds = [nrm.dot(smp[0]) for smp in smps]
            if carry_phits:
                phits_prev = [smp[4] for smp in smps]
            # whole-tile NEE skip mirrors the closest-hit one: if no lane
            # in this tile does NEE at this bounce, the occlusion sweep
            # never runs (bool results cross the cond as int32 planes)
            any_nee = jnp.max(jnp.where(nee_act, np.float32(1.0),
                                        np.float32(0.0))) > 0.0

            # cull="cone+nee" (opt-in): shadow rays toward COMPACT
            # lights (sphere/rect/point) converge on the light, so their
            # sweep is block-culled at EVERY depth, in a separate group
            # from unbounded lights (env/direction — arbitrary directions
            # at 2*world_radius would widen the union cone to pass every
            # block). It can pay only when lanes are spatially binned:
            # camera-order tiles have screen-wide hp clouds past bounce 0,
            # so the cones stay fat. Default "cone": one merged sweep,
            # culled at the primary bounce only.
            if cfg.cull == "cone+nee":
                compact_i = [i for i, lt in enumerate(lights)
                             if lt["kind"] not in (klights.ENV,
                                                   klights.DIRECTION)]
                wide_i = [i for i in range(L) if i not in compact_i]

                def occ_sweep(_):
                    rays_all = [(smp[0], smp[3] - km.SHADOW_EPSILON)
                                for smp in smps]
                    hs = [None] * L

                    def group(idxs, grp_bounds):
                        if not idxs:
                            return
                        sub = _any_hit_tables(
                            refs, counts, hp, nrm,
                            [rays_all[i] for i in idxs],
                            robust=(cfg.shadow == "robust"),
                            own=([own_geo[i] for i in idxs]
                                 if own_geo is not None else None),
                            bounds=grp_bounds, nd=[nds[i] for i in idxs])
                        for j, i in enumerate(idxs):
                            hs[i] = sub[j]

                    group(compact_i, bounds if use_cull else None)
                    group(wide_i, None)
                    return tuple(jnp.where(h, np.int32(1), np.int32(0))
                                 for h in hs)
            else:
                def occ_sweep(_):
                    def sweep(b, on):
                        hs = _any_hit_tables(
                            refs, counts, hp, nrm,
                            [(smp[0], smp[3] - km.SHADOW_EPSILON)
                             for smp in smps],
                            robust=(cfg.shadow == "robust"), own=own_geo,
                            bounds=b, nd=nds, cull_on=on)
                        return tuple(jnp.where(h, np.int32(1), np.int32(0))
                                     for h in hs)
                    return _first_bounce(bounce, bounds, sweep)

            occs_i = jax.lax.cond(
                any_nee, occ_sweep,
                lambda _: tuple(jnp.zeros(shp, jnp.int32)
                                for _ in lights), None)
            occs = [h != 0 for h in occs_i]
            ld = v3_zeros(o.x)
            nee_base = nee_act & ~color.is_black()
            if grad:
                # bounce-local color adjoints (every term of this bounce
                # attaches to the SAME carried hit row)
                addc_diff = v3_zeros(o.x)
                addc_spec = v3_zeros(o.x)
                addx = jnp.zeros(shp, jnp.float32) if use_texp else None
                gb = g * beta
            for i, lt in enumerate(lights):
                emit_l = V3(light_emit_ref[i, 0], light_emit_ref[i, 1],
                            light_emit_ref[i, 2])
                wi, pdf_l, li_s, dist, _phit = smps[i]
                cos_aw = wr_w.dot(wi) if wr_w is not None \
                    else jnp.zeros(shp, jnp.float32)
                pdf_b, f_unit_e = wf._bsdf_eval_pdf_dots(
                    kind, expo, wo_l.z, nds[i], cos_aw, eval_lobes, None)
                ucos = f_unit_e * jnp.abs(nds[i])
                if lt["kind"] in (klights.POINT, klights.DIRECTION):
                    w = wf._safe_div(np.float32(1.0), pdf_l)
                else:
                    w = wf._safe_div(np.float32(1.0), pdf_l + pdf_b)
                ok = nee_base & (pdf_l > 0.0) & (li_s != 0.0) \
                    & (ucos != 0.0)
                okf = jnp.where(ok & ~occs[i], w, 0.0)
                bp = li_s * ucos * okf * lobe_scale
                ld = ld + col_nee_tbl * emit_l * bp
                if residual:
                    resf_ref[ridx(("B", bounce, i))] = bp
                    if use_texp:
                        resf_ref[ridx(("Bk", bounce, i))] = jnp.where(
                            lobe_is_phong,
                            bp * wf._kappa_dot(expo, cos_aw), 0.0)
                if grad:
                    # d light emission (linear in Li; routed to the light's
                    # emitting surface row / env leaf by the caller)
                    acc_le[i] = acc_le[i] + gb * col_nee_tbl * bp
                    # d material color (linear in eval): target by lobe
                    addc = gb * emit_l * bp
                    if has_plastic:
                        addc_spec = addc_spec + V3(
                            jnp.where(lobe_is_phong, addc.x, 0.0),
                            jnp.where(lobe_is_phong, addc.y, 0.0),
                            jnp.where(lobe_is_phong, addc.z, 0.0))
                        addc_diff = addc_diff + V3(
                            jnp.where(lobe_is_phong, 0.0, addc.x),
                            jnp.where(lobe_is_phong, 0.0, addc.y),
                            jnp.where(lobe_is_phong, 0.0, addc.z))
                    else:
                        addc_diff = addc_diff + addc
                    if use_texp:
                        # d f_unit/d e at the FIXED light-sampled wi
                        # (wavefront._kappa; same detached-pdf convention
                        # as wavefront.py's trainable-exponent replay)
                        kap = wf._kappa_dot(expo, cos_aw)
                        dsum = (addc.x * col_nee_tbl.x
                                + addc.y * col_nee_tbl.y
                                + addc.z * col_nee_tbl.z)
                        addx = addx + jnp.where(lobe_is_phong, dsum * kap,
                                                0.0)
            big_l = big_l + beta * ld
            if grad:
                e_term = e_term + ld

            # ---- extension sample ----
            u1, u2 = rng.uniform2(shp)
            f_s, wi_l, pdf_s, delta_s, f_unit_s, glass_refract = \
                wf._bsdf_sample(kind, color, color2, eta, expo, wo_l,
                                u1, u2, lobes, None)
            wi_w = to_world(s_f, t_f, n_f, wi_l)
            ok = cont & ~f_s.is_black() & (pdf_s != 0.0)
            thr = f_s * wf._safe_div(jnp.abs(wi_l.z), pdf_s)
            beta_new = beta * thr
            # kill f32-overflow lanes (see wavefront._make_kernel)
            ok = ok & (beta_new.max_component() < np.float32(np.inf))
            rr_on = wf._rr_active(bounce, cfg)
            if rr_on is False:
                scale = np.float32(1.0)
                alive_n = ok
            else:
                u_rr = rng.uniform(shp)
                q = jnp.maximum(np.float32(0.05),
                                1.0 - beta_new.max_component())
                kill = (u_rr < q) & rr_on
                scale = jnp.where(rr_on,
                                  wf._safe_div(np.float32(1.0), 1.0 - q),
                                  np.float32(1.0))
                beta_new = beta_new * scale
                alive_n = ok & ~kill

            if residual:
                t_unit = f_unit_s * wf._safe_div(jnp.abs(wi_l.z),
                                                 pdf_s) * scale
                tu_plane = jnp.where(alive_n, t_unit * lobe_scale, 0.0)
                resf_ref[ridx(("tu", bounce))] = tu_plane
                if use_texp:
                    resf_ref[ridx(("tuk", bounce))] = jnp.where(
                        lobe_is_phong,
                        tu_plane * wf._kappa(expo, wo_l, wi_l), 0.0)
                for c, v in enumerate((diffuse.x, diffuse.y,
                                       diffuse.z)):
                    resf_ref[ridx(("dif", bounce, c))] = v
                for c, v in enumerate((spcx, spcy, spcz)):
                    resf_ref[ridx(("spc", bounce, c))] = v
                if has_delta or has_plastic:
                    to_spec_res = (is_mirror | (is_glass & ~glass_refract)
                                   | lobe_is_phong)
                else:
                    to_spec_res = valid & ~valid   # statically false
                packed = (
                    (rowf.astype(jnp.int32) + np.int32(1))
                    * valid.astype(jnp.int32)
                    + lobe_is_phong.astype(jnp.int32) * np.int32(1 << 20)
                    + to_spec_res.astype(jnp.int32) * np.int32(1 << 21))
                if tex_recs:
                    # a lane's row matches at most one texture rec, so one
                    # combined checker-even bit suffices (wavefront's
                    # res_ints bit-10 convention, here bit 22)
                    tex_even = jnp.zeros(shp, jnp.int32)
                    for ti, rec in enumerate(tex_recs):
                        if tex_par[ti] is None:
                            continue
                        onrow = sid_i == np.int32(rec["row"])
                        tex_even = jnp.where(onrow & tex_par[ti],
                                             np.int32(1), tex_even)
                    packed = packed + tex_even * np.int32(1 << 22)
                resi_ref[bounce] = packed
                if img_recs:
                    # continuous texel coords of the hit on its image row
                    # (bilinear taps are a pure function of these)
                    tx_pl = jnp.zeros(shp, jnp.float32)
                    ty_pl = jnp.zeros(shp, jnp.float32)
                    for ti, rec in enumerate(tex_recs):
                        if tex_xy[ti] is None:
                            continue
                        onrow = sid_i == np.int32(rec["row"])
                        tx_pl = jnp.where(onrow, tex_xy[ti][0], tx_pl)
                        ty_pl = jnp.where(onrow, tex_xy[ti][1], ty_pl)
                    resf_ref[ridx(("tx", bounce))] = tx_pl
                    resf_ref[ridx(("ty", bounce))] = ty_pl

            if grad:
                # tail radiance for the NEXT vertex:
                # R_{b+1} = (R_b - E_b) / T_b, 0 where the path ends
                t_eff = thr * scale
                t_x = jnp.where(alive_n, t_eff.x, 0.0)
                t_y = jnp.where(alive_n, t_eff.y, 0.0)
                t_z = jnp.where(alive_n, t_eff.z, 0.0)
                r_next = V3(wf._safe_div(r_tail.x - e_term.x, t_x),
                            wf._safe_div(r_tail.y - e_term.y, t_y),
                            wf._safe_div(r_tail.z - e_term.z, t_z))
                r_next = V3(jnp.where(alive_n, r_next.x, 0.0),
                            jnp.where(alive_n, r_next.y, 0.0),
                            jnp.where(alive_n, r_next.z, 0.0))
                # throughput adjoint: T = base_color * lobe_scale * t_unit
                t_unit = f_unit_s * wf._safe_div(jnp.abs(wi_l.z),
                                                 pdf_s) * scale
                coeff_t = jnp.where(alive_n, t_unit * lobe_scale, 0.0)
                addt = g * beta * r_next * coeff_t
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
                    # phong extension throughput: dT/de = T * kappa at the
                    # fixed sampled wi (pdf detached — a replayed number)
                    kap_s = wf._kappa(expo, wo_l, wi_l)
                    dsum_t = (addt.x * col_nee_tbl.x
                              + addt.y * col_nee_tbl.y
                              + addt.z * col_nee_tbl.z)
                    addx = addx + jnp.where(lobe_is_phong, dsum_t * kap_s,
                                            0.0)
                if tex_recs:
                    # the diffuse VALUE on textured rows came from the
                    # texture, so its adjoint routes to the texture leaves
                    # (checker colors by cell parity, image texels through
                    # the texture-adjoint planes — wavefront's replay
                    # routing) and the row-tagged diffuse share is zeroed
                    if img_recs:
                        wf.store_texel_planes(
                            tadj_ref, bounce, static, sid_i,
                            wf.image_hit_planes(static, sid_i, tex_xy, shp),
                            addc_diff)
                    addc_diff = wf._route_checker_adjoint(
                        static, sid_i, tex_par, addc_diff, acc_ta, acc_tb)
                put(PB * bounce, addc_diff.x, addc_diff.y, addc_diff.z,
                    addc_spec.x, addc_spec.y, addc_spec.z,
                    de_b.x, de_b.y, de_b.z, *([addx] if use_texp else []))
                r_tail = r_next

            o = wf._offset_origin(hp, nrm, wi_w).where(alive_n, o)
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
            st.update(r_tail=r_tail, acc_env=acc_env, acc_le=acc_le)
            if tex_recs:
                st.update(acc_ta=acc_ta, acc_tb=acc_tb)
        # bounces 0..max_depth-1 share one traced body; the horizon vertex
        # runs after the loop with only its emission terms
        st = jax.lax.fori_loop(0, cfg.max_depth, step, st)
        st = step(cfg.max_depth, st)
        big_l = st["big_l"]
        if grad:
            acc_env, acc_le = st["acc_env"], st["acc_le"]
            if tex_recs:
                acc_ta, acc_tb = st["acc_ta"], st["acc_tb"]

        if grad:
            base = PB * cfg.max_depth + 3
            put(base, acc_env.x, acc_env.y, acc_env.z)
            for i in range(L):
                put(base + 3 + 3 * i, acc_le[i].x, acc_le[i].y, acc_le[i].z)
            if tex_recs:
                wf.store_partials(part_ref, _tex_partial_planes(acc_ta,
                                                                acc_tb))
        else:
            lx_ref[:] = big_l.x
            ly_ref[:] = big_l.y
            lz_ref[:] = big_l.z

    return kernel


def _make_res_bwd_kernel(static, cfg: wf.KernelConfig, L: int,
                         has_env: bool):
    """Coefficient-cache backward for the table kernel: NO geometry
    sweeps, NO RNG — pure algebra over the _bigres_layout planes (the
    bigscene analog of wavefront's residual backward, emitting row-tagged adjoint planes instead of per-row accumulators).
    Walks bounces FORWARD carrying (beta, tail radiance); every adjoint
    term is bilinear in (cached coefficient, cached color, light emit).
    Textured rows route the diffuse-value adjoint to the texture leaves
    (checker parity from res_ints bit 22; image texels through the
    texture-adjoint planes built from the cached "tx"/"ty" planes) and
    zero the row-tagged diffuse share — wavefront's residual-texture
    convention."""
    use_texp = cfg.trainable_exponent
    tex_recs = static.get("textures", [])
    img_recs = [r for r in tex_recs if r.get("kind") == "image"]
    n_tex = static.get("n_textures", 0)
    res_ix, res_n = _bigres_layout(cfg, L, has_env, bool(img_recs))
    B = cfg.max_depth
    PB = 10 if use_texp else 9   # dout planes per bounce (dd ds de [dx])
    ridx = wf._affine_index(res_ix, B)

    def kernel(light_emit_ref, env_ref, gx_ref, gy_ref, gz_ref,
               flx_ref, fly_ref, flz_ref, resf_ref, resi_ref, dout_ref,
               *acc_refs):
        acc_refs = list(acc_refs)
        part_ref = acc_refs.pop(0) if tex_recs else None
        tadj_ref = acc_refs.pop(0) if img_recs else None
        g = V3(gx_ref[:], gy_ref[:], gz_ref[:])
        r_tail = V3(flx_ref[:], fly_ref[:], flz_ref[:])
        shp = g.x.shape
        beta = v3_full(g.x, 1.0, 1.0, 1.0)
        def put(base, *planes):
            for k, v in enumerate(planes):
                dout_ref[base + k] = v

        acc_env = v3_zeros(g.x)
        acc_le = [v3_zeros(g.x) for _ in range(L)]
        if tex_recs:
            acc_ta = [v3_zeros(g.x) for _ in range(n_tex)]
            acc_tb = [v3_zeros(g.x) for _ in range(n_tex)]

        def rf(tag):
            return resf_ref[ridx(tag)]

        def step(bounce, st):
            horizon = isinstance(bounce, int) and bounce == B
            beta, r_tail, acc_env = st["beta"], st["r_tail"], st["acc_env"]
            acc_le = list(st["acc_le"])
            acc_ta = list(st["acc_ta"]) if tex_recs else None
            acc_tb = list(st["acc_tb"]) if tex_recs else None

            def pack():
                out = dict(beta=beta, r_tail=r_tail, acc_env=acc_env,
                           acc_le=acc_le)
                if tex_recs:
                    out.update(acc_ta=acc_ta, acc_tb=acc_tb)
                return out

            ib = resi_ref[bounce]
            wb = rf(("wb", bounce))
            emi = V3(rf(("emi", bounce, 0)), rf(("emi", bounce, 1)),
                     rf(("emi", bounce, 2)))
            gb = g * beta
            de_b = gb * wb
            e_term = emi * wb
            if has_env:
                wenv = rf(("wenv", bounce))
                env = V3(env_ref[0, 0], env_ref[0, 1], env_ref[0, 2])
                e_term = e_term + env * wenv
                acc_env = acc_env + gb * wenv
            if horizon:
                put(PB * B, de_b.x, de_b.y, de_b.z)
                return pack()

            phong = (ib & np.int32(1 << 20)) != 0
            spec_t = (ib & np.int32(1 << 21)) != 0
            dif = V3(rf(("dif", bounce, 0)), rf(("dif", bounce, 1)),
                     rf(("dif", bounce, 2)))
            spc = V3(rf(("spc", bounce, 0)), rf(("spc", bounce, 1)),
                     rf(("spc", bounce, 2)))
            col_nee = spc.where(phong, dif)
            addc_diff = v3_zeros(g.x)
            addc_spec = v3_zeros(g.x)
            addx = jnp.zeros(shp, jnp.float32) if use_texp else None
            for i in range(L):
                bp = rf(("B", bounce, i))
                emit_l = V3(light_emit_ref[i, 0], light_emit_ref[i, 1],
                            light_emit_ref[i, 2])
                e_term = e_term + col_nee * emit_l * bp
                acc_le[i] = acc_le[i] + gb * col_nee * bp
                addc = gb * emit_l * bp
                addc_spec = addc_spec + V3(
                    jnp.where(phong, addc.x, 0.0),
                    jnp.where(phong, addc.y, 0.0),
                    jnp.where(phong, addc.z, 0.0))
                addc_diff = addc_diff + V3(
                    jnp.where(phong, 0.0, addc.x),
                    jnp.where(phong, 0.0, addc.y),
                    jnp.where(phong, 0.0, addc.z))
                if use_texp:
                    bk = rf(("Bk", bounce, i))
                    addx = addx + (gb.x * emit_l.x * col_nee.x
                                   + gb.y * emit_l.y * col_nee.y
                                   + gb.z * emit_l.z * col_nee.z) * bk

            # extension: T_b = ext color (x) tu; peel the tail radiance
            tu = rf(("tu", bounce))
            ext_tbl = spc.where(spec_t, dif)
            t_eff = ext_tbl * tu
            r_next = V3(wf._safe_div(r_tail.x - e_term.x, t_eff.x),
                        wf._safe_div(r_tail.y - e_term.y, t_eff.y),
                        wf._safe_div(r_tail.z - e_term.z, t_eff.z))
            addt = gb * r_next * tu
            addc_spec = addc_spec + V3(jnp.where(spec_t, addt.x, 0.0),
                                       jnp.where(spec_t, addt.y, 0.0),
                                       jnp.where(spec_t, addt.z, 0.0))
            addc_diff = addc_diff + V3(jnp.where(spec_t, 0.0, addt.x),
                                       jnp.where(spec_t, 0.0, addt.y),
                                       jnp.where(spec_t, 0.0, addt.z))
            if use_texp:
                # tuk is pre-masked to phong lanes, whose raw extension
                # color is the specular table
                tuk = rf(("tuk", bounce))
                addx = addx + (gb.x * r_next.x * spc.x
                               + gb.y * r_next.y * spc.y
                               + gb.z * r_next.z * spc.z) * tuk
            if tex_recs:
                sid = (ib & np.int32((1 << 20) - 1)) - 1
                even = (ib & np.int32(1 << 22)) != 0
                if img_recs:
                    xy = (rf(("tx", bounce)), rf(("ty", bounce)))
                    wf.store_texel_planes(
                        tadj_ref, bounce, static, sid,
                        wf.image_hit_planes(
                            static, sid,
                            [xy if r.get("kind") == "image" else None
                             for r in tex_recs], shp),
                        addc_diff)
                addc_diff = wf._route_checker_adjoint(
                    static, sid, even, addc_diff, acc_ta, acc_tb)
            put(PB * bounce, addc_diff.x, addc_diff.y, addc_diff.z,
                addc_spec.x, addc_spec.y, addc_spec.z,
                de_b.x, de_b.y, de_b.z, *([addx] if use_texp else []))
            beta = beta * t_eff
            r_tail = r_next
            return pack()

        st = dict(beta=beta, r_tail=r_tail, acc_env=acc_env, acc_le=acc_le)
        if tex_recs:
            st.update(acc_ta=acc_ta, acc_tb=acc_tb)
        st = jax.lax.fori_loop(0, B, step, st)
        st = step(B, st)
        acc_env, acc_le = st["acc_env"], st["acc_le"]
        if tex_recs:
            acc_ta, acc_tb = st["acc_ta"], st["acc_tb"]
        put(PB * B + 3, acc_env.x, acc_env.y, acc_env.z)
        for i in range(L):
            put(PB * B + 6 + 3 * i, acc_le[i].x, acc_le[i].y, acc_le[i].z)
        if tex_recs:
            wf.store_partials(part_ref, _tex_partial_planes(acc_ta, acc_tb))

    return kernel


_TRACER_MEMO: dict = {}


def _check_sampler(cfg):
    if cfg.sampler not in ("random", "sobol", "hash"):
        raise NotImplementedError(
            "bigscene kernel: sampler must be 'random', 'sobol' or 'hash'")


def _geo_inputs(tables, counts, use_cull):
    geo_np = {k: tables[k][0] for k in tables}
    rows_np = {k: tables[k][1] for k in tables}
    bnds = [jnp.asarray(tables[k][2])
            for k in ("tri", "rect", "disk", "sphere")
            if counts[k]] if use_cull else []
    return geo_np, rows_np, bnds


_GEO_COLS = {"tri": PLANAR_GEO_COLS, "rect": PLANAR_GEO_COLS,
             "disk": DISK_GEO_COLS, "sphere": SPHERE_GEO_COLS}


def _tables(scene, geo_np, rows_np, diffuse=None, specular=None,
            emission=None, exponent=None):
    """The four (rows, geo + MAT_COLS) geometry/material tables (an
    all-padding UNROLL-row block stands in for an empty class)."""
    tabs = []
    for k in ("tri", "rect", "disk", "sphere"):
        g = jnp.asarray(geo_np[k])
        m = _mat_cols(scene, rows_np[k], diffuse, specular, emission,
                      exponent)
        tabs.append(jnp.concatenate([g, m], axis=-1) if g.shape[0]
                    else jnp.zeros((UNROLL, _GEO_COLS[k] + MAT_COLS),
                                   jnp.float32))
    return tabs


def make_bigscene_tracer(scene, cfg: wf.KernelConfig | None = None,
                         interpret: bool = False):
    """Jitted lane tracer over the geometry tables.

    Returns fn(scene, o, d, seed) -> (N, 3) radiance. Geometry columns are
    host constants of the table arrays; the material columns are traced
    (gathered from scene.mat_* per call), so parameter updates reuse the
    compile. One Triton compile per (geometry digest, cfg) — compile time
    is O(1) in the surface count (fori_loop sweeps).

    With cfg.sampler == "sobol" the signature gains two (N,) int32 lane
    arrays — fn(scene, o, d, seed, sample_index, pixel_id) — with the same
    fixed-seed / advancing-sample-index accumulation convention as the
    baked kernel (wavefront.make_pallas_tracer)."""
    cfg = cfg or wf.KernelConfig()
    _check_sampler(cfg)
    wf._check_rows(cfg)
    static, tables = extract_tables(scene)
    memo_key = ("big", wf._static_digest(static), cfg, bool(interpret))
    cached = _TRACER_MEMO.get(memo_key)
    if cached is not None:
        return cached
    counts = {k: tables[k][0].shape[0] for k in tables}
    kernel = _make_kernel(static, counts, cfg)
    n_lights = int(scene.n_lights)
    has_env = bool(scene.has_env)
    geo_np, rows_np, bnds = _geo_inputs(tables, counts, cfg.cull != "off")
    tex_recs = static.get("textures", [])
    has_img = any(r.get("kind") == "image" for r in tex_recs)
    use_sobol = cfg.sampler in ("sobol", "hash")  # kernel takes si/pix

    @jax.jit
    def trace(scene, o, d, seed, si=None, pix=None):
        n = o.shape[0]
        npad, grid = wf.lane_grid(n, cfg.rows)
        lanes = [*wf.lane_planes(o, npad), *wf.lane_planes(d, npad)]
        if use_sobol:
            lanes += [*wf.lane_planes(si.astype(jnp.int32), npad),
                      *wf.lane_planes(pix.astype(jnp.int32), npad)]
        tex_in = ([scene.textures.color_a, scene.textures.color_b]
                  if tex_recs else [])
        if has_img:
            tex_in.append(scene.textures.image.reshape(-1, 3))
        light_emit = (scene.lights.emit if n_lights
                      else jnp.zeros((1, 3), jnp.float32))
        env = (scene.env_radiance_ if has_env
               else jnp.zeros(3, jnp.float32)).reshape(1, 3)
        whole_in = [jnp.asarray(seed, jnp.int32).reshape(1),
                    *_tables(scene, geo_np, rows_np), *tex_in, *bnds,
                    light_emit, env]
        blk = pl.BlockSpec((cfg.rows, LANE), lambda i: (i, 0))
        out = wf.pallas_call(
            kernel, interpret=interpret, name="kytpu_table_fwd",
            grid=(grid,),
            in_specs=[pl.BlockSpec()] * len(whole_in) + [blk] * len(lanes),
            out_specs=[blk] * 3,
            out_shape=[jax.ShapeDtypeStruct((npad // LANE, LANE),
                                            jnp.float32)] * 3,
        )(*whole_in, *lanes)
        return jnp.stack([v.reshape(-1)[:n] for v in out], axis=-1)

    _TRACER_MEMO[memo_key] = trace
    return trace


def make_bigscene_diff_tracer(scene, cfg: wf.KernelConfig | None = None,
                              interpret: bool = False,
                              backward: str = "residual"):
    """Differentiable table-kernel tracer.

    backward="residual" (default): the forward caches the per-bounce
    transport coefficients (_bigres_layout) and the backward is pure
    cache algebra — no geometry sweeps at all. backward="replay" re-traces
    the transport on the same RNG stream (no cache memory traffic).

    Returns fn(diffuse, specular, emission, env, o, d, seed) -> (N, 3)
    radiance with a custom VJP producing (d_diffuse, d_specular,
    d_emission, d_env) — detached-sampling gradients identical in
    semantics to wavefront.make_pallas_diff_tracer(backward="replay"),
    but scaled to thousands of surfaces: the backward kernel writes
    per-bounce per-lane adjoint contributions tagged with the hit row and
    XLA segment-sums them into the (M, 3) tables. NEE light-emission
    adjoints are routed to each light's emitting surface row exactly as
    diff.params.set_params ties them.

    With cfg.sampler == "sobol" the returned fn takes two extra (N,) int32
    arrays (sample_index, pixel_id) after `seed`; they are
    nondifferentiable and must be identical between forward and backward
    (the replay backward re-draws the same Owen-Sobol stream from them)."""
    cfg = cfg or wf.KernelConfig()
    _check_sampler(cfg)
    wf._check_rows(cfg)
    static, tables = extract_tables(scene)
    if backward not in ("replay", "residual"):
        raise ValueError(f"backward must be replay|residual: {backward!r}")
    memo_key = ("bigdiff", wf._static_digest(static), cfg, bool(interpret),
                backward)
    cached = _TRACER_MEMO.get(memo_key)
    if cached is not None:
        return cached
    counts = {k: tables[k][0].shape[0] for k in tables}
    residual = backward == "residual"
    L = len(static["lights"])
    res_env = any(lt["kind"] == klights.ENV for lt in static["lights"])
    tex_recs = static.get("textures", [])
    has_tex = bool(tex_recs)
    has_img = any(r.get("kind") == "image" for r in tex_recs)
    t_rows = static.get("n_textures", 0) if has_tex else 0
    img_shape = tuple(scene.textures.image.shape) if has_img else (0, 3)
    fwd_kernel = _make_kernel(static, counts, cfg, residual=residual)
    if residual:
        bwd_kernel = _make_res_bwd_kernel(static, cfg, L, res_env)
        res_ix, res_n = _bigres_layout(cfg, L, res_env, has_img)
    else:
        bwd_kernel = _make_kernel(static, counts, cfg, grad=True)
    n_lights = int(scene.n_lights)
    m_rows = int(scene.mat_kind.shape[0])
    geo_np, rows_np, bnds = _geo_inputs(tables, counts, cfg.cull != "off")
    B = cfg.max_depth            # bounces with extension terms
    use_texp = cfg.trainable_exponent
    PB = 10 if use_texp else 9   # per-bounce planes (dd ds de [dx])
    P = PB * B + 6 + 3 * L       # dout planes (see _make_kernel grad doc)
    n_part = wf.pow2_at_least(6 * t_rows)
    light_rows = [int(v) for v in np.asarray(scene.lights.surface_ids)] \
        if n_lights else []
    light_kinds = [int(v) for v in np.asarray(scene.lights.kinds)] \
        if n_lights else []
    lights_emit_const = (np.asarray(scene.lights.emit) if n_lights
                         else np.zeros((1, 3), np.float32))
    use_sobol = cfg.sampler in ("sobol", "hash")  # kernel takes si/pix
    blk = pl.BlockSpec((cfg.rows, LANE), lambda i: (i, 0))
    whole = pl.BlockSpec()

    def stk(nplanes):
        return pl.BlockSpec((nplanes, cfg.rows, LANE), lambda i: (0, i, 0))

    def _light_emit_of(emission, env):
        if not n_lights:
            return jnp.zeros((1, 3), jnp.float32)
        rows = jnp.asarray([max(r, 0) for r in light_rows], jnp.int32)
        has = jnp.asarray([r >= 0 for r in light_rows])[:, None]
        emit = jnp.where(has, emission[rows],
                         jnp.asarray(lights_emit_const))
        for i, k in enumerate(light_kinds):
            if k == klights.ENV:
                emit = emit.at[i].set(env)
        return emit

    def _whole_in(diffuse, specular, emission, exponent, texa, texb, timg,
                  env, seed):
        """Whole-array inputs of the forward / replay kernels."""
        tex_in = [texa, texb] if has_tex else []
        if has_img:
            tex_in.append(timg.reshape(-1, 3))
        return [jnp.asarray(seed, jnp.int32).reshape(1),
                *_tables(scene, geo_np, rows_np, diffuse, specular,
                         emission, exponent),
                *tex_in, *bnds, _light_emit_of(emission, env),
                env.reshape(1, 3)]

    def _lanes(o, d, si, pix, npad):
        lanes = [*wf.lane_planes(o, npad), *wf.lane_planes(d, npad)]
        if use_sobol:
            lanes += [*wf.lane_planes(si.astype(jnp.int32), npad),
                      *wf.lane_planes(pix.astype(jnp.int32), npad)]
        return lanes

    @jax.custom_vjp
    def trace(diffuse, specular, emission, exponent, texa, texb, timg,
              env, o, d, seed, si=None, pix=None):
        return _fwd_impl(diffuse, specular, emission, exponent, texa,
                         texb, timg, env, o, d, seed, si, pix)

    def _fwd_impl(diffuse, specular, emission, exponent, texa, texb,
                  timg, env, o, d, seed, si, pix, want_res=False):
        n = o.shape[0]
        npad, grid = wf.lane_grid(n, cfg.rows)
        rows = npad // LANE
        whole_in = _whole_in(diffuse, specular, emission, exponent, texa,
                             texb, timg, env, seed)
        lanes = _lanes(o, d, si, pix, npad)
        res_specs, res_shapes = [], []
        if residual:
            res_specs = [stk(res_n), stk(B + 1)]
            res_shapes = [
                jax.ShapeDtypeStruct((res_n, rows, LANE), jnp.float32),
                jax.ShapeDtypeStruct((B + 1, rows, LANE), jnp.int32)]
        out = wf.pallas_call(
            fwd_kernel, interpret=interpret,
            name="kytpu_table_fwd_residual" if residual
            else "kytpu_table_fwd",
            grid=(grid,),
            in_specs=[whole] * len(whole_in) + [blk] * len(lanes),
            out_specs=[blk] * 3 + res_specs,
            out_shape=[jax.ShapeDtypeStruct((rows, LANE), jnp.float32)] * 3
            + res_shapes,
        )(*whole_in, *lanes)
        big_l = jnp.stack([v.reshape(-1)[:n] for v in out[:3]], axis=-1)
        if want_res:
            return big_l, out[3], out[4]
        return big_l

    def _fwd(diffuse, specular, emission, exponent, texa, texb, timg,
             env, o, d, seed, si=None, pix=None):
        if residual:
            big_l, resf, resi = _fwd_impl(
                diffuse, specular, emission, exponent, texa, texb, timg,
                env, o, d, seed, si, pix, want_res=True)
            return big_l, (diffuse, specular, emission, exponent, texa,
                           texb, timg, env, o, d, seed, si, pix, big_l,
                           resf, resi)
        big_l = _fwd_impl(diffuse, specular, emission, exponent, texa,
                          texb, timg, env, o, d, seed, si, pix)
        return big_l, (diffuse, specular, emission, exponent, texa, texb,
                       timg, env, o, d, seed, si, pix, big_l, None, None)

    def _bwd(res, g):
        (diffuse, specular, emission, exponent, texa, texb, timg, env, o,
         d, seed, si, pix, big_l, resf, resi) = res
        n = o.shape[0]
        npad, grid = wf.lane_grid(n, cfg.rows)
        rows = npad // LANE
        gl = [*wf.lane_planes(g, npad), *wf.lane_planes(big_l, npad)]
        out_specs = [stk(P)]
        out_shape = [jax.ShapeDtypeStruct((P, rows, LANE), jnp.float32)]
        if not residual:
            out_specs.append(stk(B + 1))
            out_shape.append(jax.ShapeDtypeStruct((B + 1, rows, LANE),
                                                  jnp.int32))
        if has_tex:
            out_specs.append(pl.BlockSpec((1, n_part), lambda i: (i, 0)))
            out_shape.append(jax.ShapeDtypeStruct((grid, n_part),
                                                  jnp.float32))
        if has_img:
            n_tp = wf.TEX_PLANES * B
            out_specs.append(stk(n_tp))
            out_shape.append(jax.ShapeDtypeStruct((n_tp, rows, LANE),
                                                  jnp.float32))
        if residual:
            # cache-algebra backward: no geometry, no RNG, no sweeps
            outs = wf.pallas_call(
                bwd_kernel, interpret=interpret,
                name="kytpu_table_bwd_residual", grid=(grid,),
                in_specs=[whole, whole] + [blk] * len(gl)
                + [stk(res_n), stk(B + 1)],
                out_specs=out_specs, out_shape=out_shape,
            )(_light_emit_of(emission, env), env.reshape(1, 3), *gl,
              resf, resi)
            outs = list(outs)
            dout = outs.pop(0)
            sid1 = (resi.reshape(B + 1, -1)[:, :n]
                    & np.int32((1 << 20) - 1))
        else:
            whole_in = _whole_in(diffuse, specular, emission, exponent,
                                 texa, texb, timg, env, seed)
            lanes = _lanes(o, d, si, pix, npad) + gl
            outs = list(wf.pallas_call(
                bwd_kernel, interpret=interpret,
                name="kytpu_table_bwd_replay", grid=(grid,),
                in_specs=[whole] * len(whole_in) + [blk] * len(lanes),
                out_specs=out_specs, out_shape=out_shape,
            )(*whole_in, *lanes))
            dout = outs.pop(0)
            sid1 = outs.pop(0).reshape(B + 1, -1)[:, :n]   # (B+1, n)
        dout = dout.reshape(P, -1)[:, :n]                   # (P, n)
        if has_tex:
            dta, dtb = _unpack_tex_partials(outs.pop(0), t_rows)
        else:
            dta = jnp.zeros((t_rows, 3), jnp.float32)
            dtb = jnp.zeros((t_rows, 3), jnp.float32)
        dti = (wf.texel_adjoint(outs.pop(0), n, img_shape) if has_img
               else jnp.zeros(img_shape, jnp.float32))

        # per-bounce PB-column contribution rows -> segment-sum by sid+1
        data = [dout[PB * b:PB * b + PB].T for b in range(B)]
        horizon = jnp.concatenate(
            [jnp.zeros((n, 6), jnp.float32), dout[PB * B:PB * B + 3].T]
            + ([jnp.zeros((n, 1), jnp.float32)] if use_texp else []),
            axis=-1)
        data.append(horizon)
        flat = jnp.concatenate(data, axis=0)              # ((B+1)*n, PB)
        ids = sid1.reshape(-1)
        seg = jax.ops.segment_sum(flat, ids, num_segments=m_rows + 1)[1:]
        dd, ds, de = seg[:, 0:3], seg[:, 3:6], seg[:, 6:9]
        dxp = seg[:, 9] if use_texp else None
        denv = dout[PB * B + 3:PB * B + 6].sum(axis=-1)
        for i in range(L):
            dle = dout[PB * B + 6 + 3 * i:PB * B + 9 + 3 * i].sum(axis=-1)
            r = light_rows[i] if i < len(light_rows) else -1
            if r >= 0:
                de = de.at[r].add(dle)
            elif i < len(light_kinds) and light_kinds[i] == klights.ENV:
                denv = denv + dle
        dxp = dxp if use_texp else jnp.zeros_like(exponent)
        return (dd, ds, de, dxp, dta, dtb, dti, denv,
                None, None, None, None, None)

    trace.defvjp(_fwd, _bwd)
    # public positional order mirrors wavefront.make_pallas_diff_tracer:
    # diffuse, specular, emission, [exponent if trainable_exponent],
    # [texa, texb if textured], [timg if image-textured], env, o, d,
    # seed, [si, pix if sobol]
    exp_const = jnp.asarray(scene.mat_exponent)
    tex_a0 = scene.textures.color_a if has_tex \
        else jnp.zeros((0, 3), jnp.float32)
    tex_b0 = scene.textures.color_b if has_tex \
        else jnp.zeros((0, 3), jnp.float32)
    timg0 = scene.textures.image if has_img \
        else jnp.zeros((0, 3), jnp.float32)

    def public(diffuse, specular, emission, *rest):
        rest = list(rest)
        exponent = rest.pop(0) if use_texp else exp_const
        texa = rest.pop(0) if has_tex else tex_a0
        texb = rest.pop(0) if has_tex else tex_b0
        timg = rest.pop(0) if has_img else timg0
        env, o, d, seed = rest[:4]
        si, pix = (rest[4], rest[5]) if len(rest) > 4 else (None, None)
        return trace(diffuse, specular, emission, exponent, texa, texb,
                     timg, env, o, d, seed, si, pix)

    _TRACER_MEMO[memo_key] = public
    return public


def render_bigscene(scene, spp: int = 16, seed: int = 1234,
                    cfg: wf.KernelConfig | None = None, clamp: bool = True,
                    rays_per_pass: int = 1 << 22, interpret: bool = False):
    """Full-frame render through the table-driven kernel -> (H, W, 3)."""
    from kytpu.kernels.wavefront import render_pallas

    tracer = make_bigscene_tracer(scene, cfg, interpret)
    return render_pallas(scene, spp=spp, seed=seed, cfg=cfg, clamp=clamp,
                         rays_per_pass=rays_per_pass, interpret=interpret,
                         tracer=tracer)
