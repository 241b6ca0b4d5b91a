"""Uniform-grid accelerator: bake + DDA traversal vs the brute-force sweep.

The dense SoA sweep (shapes.closest_hit / any_hit) is the oracle: the grid
must return the same hits on any ray set. The reference has no accelerator
(accel_t stub, ky.cpp:3097-3115) — this is the beyond-parity scaling path.
"""

import jax
import jax.numpy as jnp
import numpy as np

from kytpu.scene import accel as kaccel
from kytpu.scene import builders
from kytpu.scene import shapes as kshapes


def _random_rays(n, rng, lo=-15.0, hi=15.0):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _scene_geom(n=60, seed=3):
    scene = builders.random_spheres(n=n, seed=seed, accel=None)
    return scene.geometry


def test_grid_matches_bruteforce_closest():
    geom = _scene_geom()
    grid = kaccel.build_grid(geom)
    rng = np.random.default_rng(0)
    o, d = _random_rays(4096, rng)
    tmax = jnp.full((4096,), jnp.inf, jnp.float32)

    t0, sid0, v0 = kshapes.closest_hit(geom, o, d, tmax)
    t1, sid1, v1 = kaccel.grid_closest_hit(grid, geom, o, d, tmax)

    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))
    hit = np.asarray(v0)
    np.testing.assert_allclose(np.asarray(t0)[hit], np.asarray(t1)[hit],
                               rtol=1e-5)
    # surface ids must agree except at exact-tie distances
    same = np.asarray(sid0)[hit] == np.asarray(sid1)[hit]
    assert same.mean() > 0.999, same.mean()


def test_grid_matches_bruteforce_anyhit():
    geom = _scene_geom()
    grid = kaccel.build_grid(geom)
    rng = np.random.default_rng(1)
    o, d = _random_rays(4096, rng)
    for tm in (0.5, 3.0, np.inf):
        tmax = jnp.full((4096,), tm, jnp.float32)
        h0 = np.asarray(kshapes.any_hit(geom, o, d, tmax))
        h1 = np.asarray(kaccel.grid_any_hit(grid, geom, o, d, tmax))
        # boundary-epsilon cases (hits within ~1e-5 of tmax) may differ;
        # demand exact agreement on >99.9% and no systematic bias
        assert (h0 == h1).mean() > 0.999, (tm, (h0 != h1).sum())


def test_grid_rays_from_inside_and_outside():
    geom = _scene_geom(n=20, seed=9)
    grid = kaccel.build_grid(geom)
    # rays starting far outside the grid AABB pointing in, and pointing away
    o = jnp.asarray([[0.0, 5.0, 60.0], [0.0, 5.0, 60.0]], jnp.float32)
    d = jnp.asarray([[0.0, -0.08, -1.0], [0.0, 0.0, 1.0]], jnp.float32)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    tmax = jnp.full((2,), jnp.inf, jnp.float32)
    t0, _, v0 = kshapes.closest_hit(geom, o, d, tmax)
    t1, _, v1 = kaccel.grid_closest_hit(grid, geom, o, d, tmax)
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))
    if bool(v0[0]):
        np.testing.assert_allclose(float(t0[0]), float(t1[0]), rtol=1e-5)


def test_grid_axis_aligned_rays():
    """Zero direction components exercise the inf t_next guards."""
    geom = _scene_geom(n=30, seed=4)
    grid = kaccel.build_grid(geom)
    rng = np.random.default_rng(2)
    o = rng.uniform(-10, 10, (512, 3)).astype(np.float32)
    axes = rng.integers(0, 3, 512)
    signs = rng.choice([-1.0, 1.0], 512)
    d = np.zeros((512, 3), np.float32)
    d[np.arange(512), axes] = signs
    o, d = jnp.asarray(o), jnp.asarray(d)
    tmax = jnp.full((512,), jnp.inf, jnp.float32)
    t0, _, v0 = kshapes.closest_hit(geom, o, d, tmax)
    t1, _, v1 = kaccel.grid_closest_hit(grid, geom, o, d, tmax)
    assert (np.asarray(v0) == np.asarray(v1)).mean() > 0.999
    both = np.asarray(v0) & np.asarray(v1)
    np.testing.assert_allclose(np.asarray(t0)[both], np.asarray(t1)[both],
                               rtol=1e-4)


def test_grid_render_matches_sweep_render():
    """End-to-end: a 300-sphere scene renders the same with and without
    the accelerator (same estimator, same RNG -> same hits)."""
    from kytpu.integrator.render import render
    from kytpu.integrator.path import PathConfig
    sc_grid = builders.random_spheres(n=300, width=48, height=48, seed=5,
                                      accel="grid")
    sc_none = builders.random_spheres(n=300, width=48, height=48, seed=5,
                                      accel=None)
    assert sc_grid.accel is not None and sc_none.accel is None
    cfg = PathConfig(max_depth=2)
    a = np.asarray(render(sc_grid, spp=2, seed=7, cfg=cfg, mode="fast"))
    b = np.asarray(render(sc_none, spp=2, seed=7, cfg=cfg, mode="fast"))
    # identical up to rare distance ties / boundary epsilons
    close = np.isclose(a, b, atol=1e-4).mean()
    assert close > 0.999, close


def test_accel_opt_in():
    # "auto" keeps the dense sweep; the grid is explicit opt-in
    auto = builders.random_spheres(n=300, seed=0)
    assert auto.accel is None
    big = builders.random_spheres(n=300, seed=0, accel="grid")
    assert big.accel is not None
    # grid cells hold every surface exactly where its AABB lands
    g = big.accel
    n_items = int((np.asarray(g.cell_sp) >= 0).sum())
    assert n_items >= big.geometry.n_sphere  # every sphere appears >= once
