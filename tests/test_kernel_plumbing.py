"""CPU tests of the kernels' surroundings: the per-program partial-adjoint
tables, the gathered texture fetch and its XLA scatter-add adjoint, lane
padding, the engine routing predicate and the compile-cache helper.

Kernels run in Pallas' interpreter here; tests/test_gpu.py compiles the
same kernels for the card."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from kytpu.kernels import bigscene as bs
from kytpu.kernels import wavefront as wf
from kytpu.scene import builders
from kytpu.scene import scene as kscene
from kytpu.scene import texture as ktex


@pytest.mark.parametrize("rows,n_planes", [(1, 5), (8, 3), (2, 9)])
def test_partial_table_sums_to_lane_total(rows, n_planes):
    """store_partials writes one row per program; sum_partials over the
    grid equals the plain sum of every plane over all lanes."""
    rng = np.random.default_rng(rows)
    grid = 4
    x = rng.normal(size=(n_planes, grid * rows, 128)).astype(np.float32)
    n_part = wf.pow2_at_least(n_planes)

    def kernel(x_ref, part_ref):
        wf.store_partials(part_ref, [x_ref[k] for k in range(n_planes)])

    parts = wf.pallas_call(
        kernel, interpret=True, name="partials_test", grid=(grid,),
        in_specs=[pl.BlockSpec((n_planes, rows, 128), lambda i: (0, i, 0))],
        out_specs=pl.BlockSpec((1, n_part), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((grid, n_part), jnp.float32),
    )(jnp.asarray(x))
    got = np.asarray(wf.sum_partials(parts, n_planes))
    np.testing.assert_allclose(got, x.sum(axis=(1, 2)), rtol=1e-5,
                               atol=1e-4)


def test_partial_layout_round_trip():
    """_partial_planes and _unpack_partials agree on the table layout."""
    m, t = 3, 2
    shp = (1, 128)

    def v3(c):
        return wf.V3(*(jnp.full(shp, c + k / 10.0) for k in range(3)))

    planes = wf._partial_planes(
        [v3(1), v3(2), v3(3)], [v3(4), v3(5), v3(6)],
        [v3(7), v3(8), v3(9)], v3(10), [jnp.full(shp, 11.0 + r)
                                        for r in range(m)],
        ([v3(12), v3(13)], [v3(14), v3(15)]))
    assert len(planes) == wf._n_partials(m, t, True)
    row = jnp.stack([p.sum() for p in planes])
    n_part = wf.pow2_at_least(len(planes))
    parts = jnp.zeros((2, n_part)).at[0, :len(planes)].set(row)
    dd, ds, de, denv, dexp, dta, dtb = wf._unpack_partials(parts, m, t,
                                                           True)
    np.testing.assert_allclose(np.asarray(dd[1]), 128 * np.array(
        [2.0, 2.1, 2.2]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ds[2]), 128 * np.array(
        [6.0, 6.1, 6.2]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(denv), 128 * np.array(
        [10.0, 10.1, 10.2]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(dexp), 128 * np.array(
        [11.0, 12.0, 13.0]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(dtb[1]), 128 * np.array(
        [15.0, 15.1, 15.2]), rtol=1e-6)


def _gather_fetch(atlas, img, st, rows=2):
    """The kernel's gathered bilinear fetch (wavefront._image_color) run in
    a pallas_call over (rows, 128) lane planes."""
    ti_n, th, tw, _ = atlas.shape
    n = st.shape[0]
    npad, grid = wf.lane_grid(n, rows)

    def kernel(timg_ref, x_ref, y_ref, i_ref, ox, oy, oz):
        x = (x_ref[...] - jnp.floor(x_ref[...])) * np.float32(tw) - 0.5
        y = (y_ref[...] - jnp.floor(y_ref[...])) * np.float32(th) - 0.5
        idx, wts = wf.image_taps(i_ref[...], tw, th, x, y)
        for c, ref in enumerate((ox, oy, oz)):
            v = None
            for i, w in zip(idx, wts):
                term = timg_ref[i, c] * w
                v = term if v is None else v + term
            ref[...] = v

    blk = pl.BlockSpec((rows, 128), lambda i: (i, 0))
    out = wf.pallas_call(
        kernel, interpret=True, name="gather_test", grid=(grid,),
        in_specs=[pl.BlockSpec()] + [blk] * 3, out_specs=[blk] * 3,
        out_shape=[jax.ShapeDtypeStruct((npad // 128, 128),
                                        jnp.float32)] * 3,
    )(atlas.reshape(-1, 3), *wf.lane_planes(st, npad),
      *wf.lane_planes(img, npad))
    return jnp.stack([o.reshape(-1)[:n] for o in out], axis=-1)


@pytest.mark.parametrize("size", [24, 256])
def test_gather_fetch_and_scatter_adjoint_match_bilinear(size):
    """The kernel's gathered fetch equals scene/texture._bilinear, and
    texel_adjoint (XLA scatter-add of per-lane coordinates and adjoints)
    equals jax.grad of the reference bilinear."""
    rng = np.random.default_rng(size)
    ti_n = 2
    atlas = jnp.asarray(rng.uniform(0, 1, (ti_n, size, size, 3)),
                        jnp.float32)
    n = 700
    st = jnp.asarray(rng.uniform(-3, 3, (n, 2)), jnp.float32)
    img = jnp.asarray(rng.integers(0, ti_n, n), jnp.int32)
    ref = ktex._bilinear(atlas, img, st)
    got = _gather_fetch(atlas, img, st)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)

    adj = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    g_ref = jax.grad(lambda a: jnp.sum(ktex._bilinear(a, img, st) * adj))(
        atlas)
    frac = st - jnp.floor(st)
    x = frac[:, 0] * size - 0.5
    y = frac[:, 1] * size - 0.5
    depth = 1
    npad = 768
    planes = [jnp.pad(v, (0, npad - n)).reshape(npad // 128, 128)
              for v in (x, y, img.astype(jnp.float32),
                        adj[:, 0], adj[:, 1], adj[:, 2])]
    tplanes = jnp.stack(planes)[None].reshape(
        wf.TEX_PLANES * depth, npad // 128, 128)
    g = wf.texel_adjoint(tplanes, n, atlas.shape)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n", [300, 129])
def test_lane_padding_is_invisible(n):
    """Lane counts that are not a multiple of the block pad with zeros and
    slice back: under the per-lane hash sampler the first n lanes of a
    padded launch equal a launch of exactly those lanes."""
    scene = builders.cornell_box(width=16, height=16)
    cfg = wf.KernelConfig(max_depth=2, rows=2, sampler="hash")
    tracer = wf.make_pallas_tracer(scene, cfg, interpret=True)
    big = 512
    pid = jnp.arange(big, dtype=jnp.int32) % 256
    px = (pid % 16).astype(jnp.float32) + 0.5
    py = (pid // 16).astype(jnp.float32) + 0.5
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    si = jnp.arange(big, dtype=jnp.int32) // 256
    full = np.asarray(tracer(scene, o, d, jnp.int32(4), si, pid))
    part = np.asarray(tracer(scene, o[:n], d[:n], jnp.int32(4), si[:n],
                             pid[:n]))
    assert part.shape == (n, 3)
    # equal up to the CPU compiler's vectorization of the two launch sizes
    np.testing.assert_allclose(part, full[:n], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(wf.lane_planes(o[:n], 384)[0])
                                  .reshape(-1)[n:], 0.0)


def test_rows_must_be_power_of_two():
    scene = builders.cornell_box(width=8, height=8)
    with pytest.raises(ValueError, match="power of two"):
        wf.make_pallas_tracer(scene, wf.KernelConfig(rows=3), interpret=True)


def test_routing_predicate():
    """use_table_kernel routes by input: surface count past the threshold
    and a scene the table sweeps can represent. No exception is swallowed:
    ineligible scenes name their reason."""
    small = builders.cornell_box(width=8, height=8)
    assert int(small.mat_kind.shape[0]) <= bs.TABLE_KERNEL_MIN_ROWS
    assert bs.ineligibility(small) is None
    assert not bs.use_table_kernel(small)
    big = builders.random_spheres(n=80, width=8, height=8, seed=0)
    assert int(big.mat_kind.shape[0]) > bs.TABLE_KERNEL_MIN_ROWS
    assert bs.use_table_kernel(big)


@pytest.mark.parametrize("env_value", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_value):
    """enable_compile_cache follows JAX_COMPILATION_CACHE_DIR when it is
    set, else the fixed in-checkout directory that .gitignore lists."""
    from kytpu.utils import compile_cache as cc
    if env_value is None:
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
        want = cc.DEFAULT_DIR
    else:
        want = str(tmp_path / env_value)
        monkeypatch.setenv(cc.ENV_VAR, want)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert cc.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cc.DEFAULT_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
