"""Uniform-grid ray-traversal accelerator.

The reference's accelerator is an empty stub — `accel_t` stores the surface
list and traversal is a brute-force linear scan (ky.cpp:3097-3115, 3172-3184).
kytpu's dense SoA sweep (scene/shapes.py) is the vectorized equivalent and
wins below a few hundred surfaces, but it is O(N) per ray; this module is the
beyond-parity scaling story for thousand-surface scenes.

Batched design — a uniform grid, not a BVH, because the traversal must be
a *batched* fixed-structure loop, not per-ray pointer chasing:

  - the grid is baked on the host into two dense (cells, Imax) int32 candidate
    tables (planar rows / sphere rows, -1-padded), a pytree of static-shaped
    arrays that flows through jit/shard_map like any other scene data;
  - traversal is one `lax.while_loop` over the whole ray batch (3D-DDA, the
    classic Amanatides-Woo walk): each iteration gathers every lane's current
    cell candidates and runs the same vectorized planar/sphere hit tests as
    the dense sweep (shapes.planar_test/sphere_test) on the gathered rows, so
    the math — and every parity epsilon — is shared with the reference path;
  - a lane retires when its running-best hit is closer than the next cell
    boundary (the standard grid-correctness criterion), when it leaves the
    grid, or when t exceeds tmax; the loop ends when every lane has retired.

Cost model: brute force tests all N surfaces per ray with dense math; the
grid tests (visited cells) x (padded cell occupancy) with *gathered*
parameters, so it wins only where a gathered candidate test is cheap
relative to a dense one. Where gathers were expensive the sweep won at
every scale tried, so the grid is an OPT-IN (`accel="grid"`), fully tested
against the sweep oracle; `accel="auto"` resolves to the sweep until a
measurement on the GPU shows a scale where the grid wins.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from kytpu.core import math as km
from kytpu.scene import shapes as kshapes


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Grid:
    """Baked uniform grid over the scene AABB (frozen pytree)."""

    cell_pl: jax.Array   # (C, Ip) int32 planar rows per cell, -1 padded
    cell_sp: jax.Array   # (C, Is) int32 sphere rows per cell, -1 padded
    lo: jax.Array        # (3,) grid AABB min
    inv_h: jax.Array     # (3,) 1 / cell size
    h: jax.Array         # (3,) cell size
    dims: tuple = field(metadata=dict(static=True), default=(1, 1, 1))

    @property
    def n_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]


# ---------------------------------------------------------------------------
# host-side bake
# ---------------------------------------------------------------------------


def _surface_aabbs(geom: kshapes.Geometry):
    """Per-surface AABBs (numpy): returns (pl_lo, pl_hi), (sp_lo, sp_hi)."""
    pl_lo = pl_hi = np.zeros((0, 3), np.float64)
    if geom.n_planar:
        pts = np.stack([np.asarray(geom.pl_p0, np.float64),
                        np.asarray(geom.pl_p1, np.float64),
                        np.asarray(geom.pl_p2, np.float64),
                        np.asarray(geom.pl_p3, np.float64)], axis=1)
        pl_lo = pts.min(axis=1)
        pl_hi = pts.max(axis=1)
        # disks: p1..p3 == p0, extend by the in-plane radius extent
        kind = np.asarray(geom.pl_kind)
        is_disk = kind == kshapes.DISK
        if is_disk.any():
            n = np.asarray(geom.pl_normal, np.float64)
            r = np.asarray(geom.pl_radius, np.float64)[:, None]
            # |s|*r + |t|*r per axis == r * sqrt(1 - n_axis^2)
            ext = r * np.sqrt(np.maximum(0.0, 1.0 - n * n))
            pl_lo = np.where(is_disk[:, None], pl_lo - ext, pl_lo)
            pl_hi = np.where(is_disk[:, None], pl_hi + ext, pl_hi)
    sp_lo = sp_hi = np.zeros((0, 3), np.float64)
    if geom.n_sphere:
        c = np.asarray(geom.sp_center, np.float64)
        r = np.asarray(geom.sp_radius, np.float64)[:, None]
        sp_lo, sp_hi = c - r, c + r
    return (pl_lo, pl_hi), (sp_lo, sp_hi)


def build_grid(geom: kshapes.Geometry, resolution: int | None = None) -> Grid:
    """Bake the grid on the host. `resolution` caps the max axis cell count;
    by default it follows the classic density heuristic (~cbrt of the
    surface count per axis, scaled by AABB aspect, capped at 64)."""
    (pl_lo, pl_hi), (sp_lo, sp_hi) = _surface_aabbs(geom)
    all_lo = np.concatenate([pl_lo, sp_lo])
    all_hi = np.concatenate([pl_hi, sp_hi])
    if all_lo.shape[0] == 0:
        raise ValueError("cannot build a grid over empty geometry")
    lo = all_lo.min(axis=0)
    hi = all_hi.max(axis=0)
    extent = np.maximum(hi - lo, 1e-6)
    # pad slightly so boundary hits stay strictly inside
    lo = lo - 1e-4 * extent
    hi = hi + 1e-4 * extent
    extent = hi - lo

    n_surf = geom.n_surfaces
    if resolution is None:
        resolution = int(np.clip(np.ceil((4.0 * n_surf) ** (1.0 / 3.0)),
                                 2, 64))
    # per-axis dims proportional to extent, longest axis = resolution
    dims = np.maximum(
        1, np.round(resolution * extent / extent.max())).astype(int)
    h = extent / dims
    inv_h = 1.0 / h

    def cells_of(a_lo, a_hi):
        c0 = np.clip(np.floor((a_lo - lo) * inv_h).astype(int), 0, dims - 1)
        c1 = np.clip(np.floor((a_hi - lo) * inv_h).astype(int), 0, dims - 1)
        return c0, c1

    def bucket(a_lo, a_hi):
        buckets = [[] for _ in range(int(np.prod(dims)))]
        for row in range(a_lo.shape[0]):
            c0, c1 = cells_of(a_lo[row], a_hi[row])
            for ix in range(c0[0], c1[0] + 1):
                for iy in range(c0[1], c1[1] + 1):
                    for iz in range(c0[2], c1[2] + 1):
                        lin = (ix * dims[1] + iy) * dims[2] + iz
                        buckets[lin].append(row)
        imax = max(1, max(len(b) for b in buckets))
        table = np.full((len(buckets), imax), -1, np.int32)
        for lin, b in enumerate(buckets):
            table[lin, :len(b)] = b
        return table

    return Grid(
        cell_pl=jnp.asarray(bucket(pl_lo, pl_hi)),
        cell_sp=jnp.asarray(bucket(sp_lo, sp_hi)),
        lo=jnp.asarray(lo, jnp.float32),
        inv_h=jnp.asarray(inv_h, jnp.float32),
        h=jnp.asarray(h, jnp.float32),
        dims=tuple(int(x) for x in dims),
    )


# ---------------------------------------------------------------------------
# device-side traversal
# ---------------------------------------------------------------------------


def _enter_grid(grid: Grid, o, d):
    """Slab test against the grid AABB; returns (t_enter, t_exit, inside).
    t_enter is clamped at 0 for rays starting inside."""
    hi = grid.lo + grid.h * jnp.asarray(grid.dims, jnp.float32)
    inv_d = km.safe_div(1.0, d, fallback=jnp.inf)
    ta = (grid.lo[None] - o) * inv_d
    tb = (hi[None] - o) * inv_d
    t0 = jnp.minimum(ta, tb).max(axis=-1)
    t1 = jnp.maximum(ta, tb).min(axis=-1)
    t_enter = jnp.maximum(t0, 0.0)
    return t_enter, t1, t1 >= t_enter


def _test_cell(grid: Grid, geom: kshapes.Geometry, o, d, tmax, cell_lin,
               t_best, sid_best, want_closest: bool):
    """Test all candidates of each lane's cell; fold into (t_best, sid)."""
    oN = o[:, None, :]
    dN = d[:, None, :]
    tN = tmax[:, None]
    hit_any = jnp.zeros(o.shape[0], bool)
    if geom.n_planar:
        idx = grid.cell_pl[cell_lin]            # (N, Ip)
        live = idx >= 0
        i = jnp.maximum(idx, 0)
        t, acc = kshapes.planar_test(
            oN, dN, tN, geom.pl_kind[i], geom.pl_p0[i], geom.pl_p1[i],
            geom.pl_p2[i], geom.pl_p3[i], geom.pl_normal[i],
            geom.pl_radius[i])
        acc = acc & live
        if want_closest:
            tm = jnp.where(acc, t, jnp.inf)
            j = jnp.argmin(tm, axis=1)
            tc = jnp.take_along_axis(tm, j[:, None], 1)[:, 0]
            better = tc < t_best
            t_best = jnp.where(better, tc, t_best)
            sid_best = jnp.where(
                better, jnp.take_along_axis(i, j[:, None], 1)[:, 0],
                sid_best)
        else:
            hit_any = hit_any | jnp.any(acc, axis=1)
    if geom.n_sphere:
        idx = grid.cell_sp[cell_lin]            # (N, Is)
        live = idx >= 0
        i = jnp.maximum(idx, 0)
        t, acc = kshapes.sphere_test(oN, dN, tN, geom.sp_center[i],
                                     geom.sp_radius[i])
        acc = acc & live
        if want_closest:
            tm = jnp.where(acc, t, jnp.inf)
            j = jnp.argmin(tm, axis=1)
            tc = jnp.take_along_axis(tm, j[:, None], 1)[:, 0]
            better = tc < t_best
            t_best = jnp.where(better, tc, t_best)
            sid_best = jnp.where(
                better,
                geom.n_planar + jnp.take_along_axis(i, j[:, None], 1)[:, 0],
                sid_best)
        else:
            hit_any = hit_any | jnp.any(acc, axis=1)
    return t_best, sid_best, hit_any


def _traverse(grid: Grid, geom: kshapes.Geometry, o, d, tmax,
              want_closest: bool):
    """Batched Amanatides-Woo DDA. Returns (t_best, sid_best, hit_flag)."""
    n = o.shape[0]
    f32 = o.dtype
    dims = jnp.asarray(grid.dims, jnp.int32)
    dims_f = jnp.asarray(grid.dims, f32)

    t_enter, t_exit, inside = _enter_grid(grid, o, d)
    # entry point, nudged into the grid interior
    p = o + (t_enter + 1e-5)[:, None] * d
    cell_f = (p - grid.lo[None]) * grid.inv_h[None]
    cell = jnp.clip(jnp.floor(cell_f).astype(jnp.int32), 0, dims[None] - 1)

    step = jnp.where(d >= 0, 1, -1).astype(jnp.int32)
    # t at the next boundary along each axis
    next_f = jnp.where(d >= 0, cell.astype(f32) + 1.0, cell.astype(f32))
    bound = grid.lo[None] + next_f * grid.h[None]
    inv_d = km.safe_div(1.0, d, fallback=jnp.inf)
    t_next = jnp.where(jnp.isinf(inv_d), jnp.inf, (bound - o) * inv_d)
    t_delta = jnp.abs(grid.h[None] * inv_d)

    t_best0 = jnp.full((n,), jnp.inf, f32)
    sid0 = jnp.zeros((n,), jnp.int32)
    hit0 = jnp.zeros((n,), bool)
    active0 = inside & (t_enter < tmax)

    def cond(state):
        return jnp.any(state[0])

    def body(state):
        active, cell, t_next, t_best, sid, hit = state
        cell_lin = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        # only active lanes contribute: inactive lanes test against tmax=-inf
        tmax_eff = jnp.where(active, tmax, -jnp.inf)
        t_best, sid, hit_any = _test_cell(
            grid, geom, o, d, tmax_eff, cell_lin, t_best, sid, want_closest)
        hit = hit | hit_any
        # advance DDA
        axis = jnp.argmin(t_next, axis=1)
        t_boundary = jnp.take_along_axis(t_next, axis[:, None], 1)[:, 0]
        onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        new_cell = cell + onehot * step
        # where, not +onehot*delta: 0 * inf = nan on zero-direction axes
        new_t_next = jnp.where(onehot != 0, t_next + t_delta, t_next)
        out = (jnp.any(new_cell < 0, axis=1)
               | jnp.any(new_cell >= dims[None], axis=1))
        if want_closest:
            # retire when the best hit is before the cell boundary just
            # crossed (grid correctness criterion), or out/past tmax
            done = (t_best <= t_boundary) | out | (t_boundary > tmax)
        else:
            done = hit | out | (t_boundary > tmax)
        active = active & ~done
        cell = jnp.where(active[:, None], new_cell, cell)
        t_next = jnp.where(active[:, None], new_t_next, t_next)
        return (active, cell, t_next, t_best, sid, hit)

    state = (active0, cell, t_next, t_best0, sid0, hit0)
    state = jax.lax.while_loop(cond, body, state)
    _, _, _, t_best, sid, hit = state
    return t_best, sid, hit


def grid_closest_hit(grid: Grid, geom: kshapes.Geometry, o, d, tmax):
    """Drop-in for shapes.closest_hit: (t, surface_id, valid)."""
    t_best, sid, _ = _traverse(grid, geom, o, d, tmax, want_closest=True)
    return t_best, sid, jnp.isfinite(t_best)


def grid_any_hit(grid: Grid, geom: kshapes.Geometry, o, d, tmax):
    """Drop-in for shapes.any_hit: (N,) bool occlusion flags."""
    _, _, hit = _traverse(grid, geom, o, d, tmax, want_closest=False)
    return hit
