"""Table-driven big-scene megakernel (kernels/bigscene.py).

The table sweeps are pure jnp outside pallas_call, so they must agree
EXACTLY with the SoA reference sweeps (kytpu/scene/shapes.py) and with the
baked kernel's merged occlusion. The in-kernel assembly is covered by a
same-draws comparison against the baked megakernel (identical RNG =>
near-bitwise agreement) and a statistical comparison against the fast jnp
integrator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kytpu.core import math as km
from kytpu.kernels import bigscene as bs
from kytpu.kernels import wavefront as wf
from kytpu.kernels.v3 import V3
from kytpu.scene import builders, shapes as kshapes
from kytpu.scene import scene as kscene

N = 4096


@pytest.fixture(scope="module", params=["spheres", "cornell"])
def scene(request):
    if request.param == "spheres":
        return builders.random_spheres(n=40, width=32, height=32, seed=0)
    return builders.cornell_box(width=32, height=32)


@pytest.fixture(scope="module")
def rays(scene):
    key = jax.random.key(0)
    u = jax.random.uniform(key, (N, 2))
    w, h = scene.camera.width, scene.camera.height
    pid = jnp.arange(N, dtype=jnp.int32) % (w * h)
    px = (pid % w).astype(jnp.float32) + u[:, 0]
    py = (pid // w).astype(jnp.float32) + u[:, 1]
    return kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))


def _v3(a):
    return V3(a[:, 0], a[:, 1], a[:, 2])


def _table_refs(scene):
    """The traced tables exactly as make_bigscene_tracer assembles them."""
    static, tables = bs.extract_tables(scene)
    counts = {k: tables[k][0].shape[0] for k in tables}
    geo_cols = {"tri": bs.PLANAR_GEO_COLS, "rect": bs.PLANAR_GEO_COLS,
                "disk": bs.DISK_GEO_COLS, "sphere": bs.SPHERE_GEO_COLS}
    refs = []
    for k in ("tri", "rect", "disk", "sphere"):
        g = jnp.asarray(tables[k][0])
        m = bs._mat_cols(scene, tables[k][1])
        refs.append(jnp.concatenate([g, m], axis=-1) if g.shape[0]
                    else jnp.zeros((bs.UNROLL, geo_cols[k] + bs.MAT_COLS),
                                   jnp.float32))
    return refs, counts


def test_tables_closest_hit_matches(scene, rays):
    o, d = rays
    refs, counts = _table_refs(scene)
    cy = bs._closest_hit_tables(refs, counts, _v3(o), _v3(d))
    t_k = np.asarray(cy[0])
    valid_k = np.isfinite(t_k)
    t_r, sid_r, valid_r = kshapes.closest_hit(
        scene.geometry, o, d, jnp.full((N,), jnp.inf))
    agree = valid_k == np.asarray(valid_r)
    assert agree.mean() > 0.999, agree.mean()
    m = np.asarray(valid_r) & agree
    np.testing.assert_allclose(t_k[m], np.asarray(t_r)[m], rtol=2e-5)
    # carried material columns == the scene tables gathered by hit row
    dif_k = np.stack([np.asarray(cy[4]), np.asarray(cy[5]),
                      np.asarray(cy[6])], -1)
    kind_k = np.asarray(cy[13])
    sid = np.asarray(sid_r)[m]
    np.testing.assert_allclose(dif_k[m], np.asarray(scene.mat_diffuse)[sid],
                               atol=1e-6)
    np.testing.assert_array_equal(kind_k[m].astype(np.int32),
                                  np.asarray(scene.mat_kind)[sid])


def test_tables_any_hit_matches_baked(scene, rays):
    o, d = rays
    refs, counts = _table_refs(scene)
    static = wf.extract_static(scene)
    # shading points: push each ray to its hit (or unit distance)
    t_r, sid_r, valid_r = kshapes.closest_hit(
        scene.geometry, o, d, jnp.full((N,), jnp.inf))
    t = jnp.where(valid_r, t_r, 1.0)
    hp = _v3(o + t[:, None] * d)
    n = kshapes.surface_normal(scene.geometry, sid_r,
                               o + t[:, None] * d, d)
    n_shade = _v3(jnp.where(valid_r[:, None], n,
                            jnp.zeros_like(n).at[:, 1].set(1.0)))
    key = jax.random.key(7)
    wi_a = _v3(km.normalize(jax.random.normal(key, (N, 3))))
    wi_b = V3(-wi_a.x, wi_a.y, -wi_a.z)
    tmax = jnp.full((N,), 3.0)
    rays2 = [(wi_a, tmax), (wi_b, 0.5 * tmax)]
    hit_tab = bs._any_hit_tables(refs, counts, hp, n_shade, rays2)
    hit_bak = wf._any_hit_multi(static, hp, n_shade, rays2,
                                skips=[(), ()])
    for ht, hb in zip(hit_tab, hit_bak):
        np.testing.assert_array_equal(np.asarray(ht), np.asarray(hb))


@pytest.mark.slow
def test_bigscene_matches_baked_same_draws():
    """Same scene, same RNG stream: the table kernel and the baked kernel
    agree lane-by-lane up to fp reassociation (rare decision-boundary
    flips allowed)."""
    scene = builders.random_spheres(n=24, width=24, height=24, seed=0)
    cfg = wf.KernelConfig(max_depth=3, rows=8)
    cam = scene.camera
    npix = cam.width * cam.height
    xs = (jnp.arange(npix) % cam.width).astype(jnp.float32) + 0.5
    ys = (jnp.arange(npix) // cam.width).astype(jnp.float32) + 0.5
    o, d = kscene.generate_rays(cam, jnp.stack([xs, ys], axis=-1))
    big = bs.make_bigscene_tracer(scene, cfg, interpret=True)
    baked = wf.make_pallas_tracer(scene, cfg, interpret=True)
    lb = np.asarray(big(scene, o, d, 0))
    lk = np.asarray(baked(scene, o, d, 0))
    assert not np.isnan(lb).any()
    assert np.abs(lb - lk).max() < 1e-3, np.abs(lb - lk).max()


@pytest.mark.slow
def test_bigscene_render_matches_fast():
    """Statistical: interpret-mode table kernel vs the fast integrator."""
    from kytpu.integrator.fast import FastConfig
    from kytpu.integrator.render import render

    scene = builders.random_spheres(n=24, width=16, height=16, seed=0)
    img_k = np.asarray(bs.render_bigscene(
        scene, spp=48, seed=3, cfg=wf.KernelConfig(max_depth=3, rows=8),
        interpret=True))
    img_f = np.asarray(render(scene, spp=48, seed=5,
                              cfg=FastConfig(max_depth=3)))
    d4 = lambda a: a.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))  # noqa: E731
    err = np.abs(d4(img_k) - d4(img_f)).mean()
    assert err < 0.03, err


@pytest.mark.slow
def test_bigscene_grad_matches_fd():
    """Path-replay backward of the table kernel vs central finite
    differences of the SAME deterministic pallas forward."""
    scene = builders.random_spheres(n=16, width=12, height=12, seed=0)
    cfg = wf.KernelConfig(max_depth=3, rows=8)
    tracer = bs.make_bigscene_diff_tracer(scene, cfg, interpret=True)

    n = 144
    key = jax.random.key(0)
    u = jax.random.uniform(key, (n, 2))
    pid = jnp.arange(n, dtype=jnp.int32)
    px = (pid % 12).astype(jnp.float32) + u[:, 0]
    py = (pid // 12).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    seed = jnp.int32(5)

    env0 = jnp.asarray(scene.env_radiance_)
    p0 = (scene.mat_diffuse, scene.mat_specular, scene.emission, env0)

    def loss(diffuse, specular, emission, env):
        out = tracer(diffuse, specular, emission, env, o, d, seed)
        return jnp.mean(out)

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*p0)
    em = np.asarray(scene.emission)
    light_row = int(np.argmax(em.sum(axis=1)))
    probes = [(0, (0, 0)), (0, (3, 1)), (2, (light_row, 0)), (3, (2,))]
    eps = 1e-2
    for argi, idx in probes:
        args_p = list(p0)
        args_m = list(p0)
        args_p[argi] = p0[argi].at[idx].add(eps)
        args_m[argi] = p0[argi].at[idx].add(-eps)
        fd = (float(loss(*args_p)) - float(loss(*args_m))) / (2 * eps)
        ad = float(g[argi][idx])
        assert np.isfinite(ad) and np.isfinite(fd), (argi, idx, ad, fd)
        assert abs(ad - fd) <= 3e-3 * max(abs(fd), 1e-2), (argi, idx, ad, fd)
    assert any(abs(float(g[a][i])) > 1e-4 for a, i in probes)


@pytest.mark.slow
def test_bigscene_grad_matches_baked():
    """Same scene, same RNG stream: table-kernel gradients == baked-kernel
    replay gradients (up to fp reassociation in the row reductions)."""
    scene = builders.random_spheres(n=12, width=10, height=10, seed=1)
    cfg = wf.KernelConfig(max_depth=2, rows=8)
    big = bs.make_bigscene_diff_tracer(scene, cfg, interpret=True)
    baked = wf.make_pallas_diff_tracer(scene, cfg, interpret=True,
                                       backward="replay")

    n = 100
    pid = jnp.arange(n, dtype=jnp.int32)
    px = (pid % 10).astype(jnp.float32) + 0.5
    py = (pid // 10).astype(jnp.float32) + 0.5
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    seed = jnp.int32(3)
    env0 = jnp.asarray(scene.env_radiance_)
    p0 = (scene.mat_diffuse, scene.mat_specular, scene.emission)

    def loss_big(diffuse, specular, emission, env):
        return jnp.mean(big(diffuse, specular, emission, env, o, d, seed))

    def loss_bak(diffuse, specular, emission, env):
        return jnp.mean(baked(diffuse, specular, emission, env, o, d, seed))

    gb = jax.grad(loss_big, argnums=(0, 1, 2, 3))(*p0, env0)
    gk = jax.grad(loss_bak, argnums=(0, 1, 2, 3))(*p0, env0)
    # the baked kernel zeroes emission gradients of non-emitting rows
    # (they are not trainable there); the table kernel reports the true
    # linear coefficient — compare emission only on emitting rows
    emit_rows = np.asarray(scene.emission).sum(axis=1) > 0
    np.testing.assert_allclose(np.asarray(gb[0]), np.asarray(gk[0]),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(gb[1]), np.asarray(gk[1]),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(gb[2])[emit_rows],
                               np.asarray(gk[2])[emit_rows],
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(gb[3]), np.asarray(gk[3]),
                               rtol=2e-4, atol=2e-6)


def test_bigscene_texture_support_boundary():
    """Planar checker and image textures of any atlas size (here a
    non-power-of-two image, fetched with gathered loads) extract fine,
    while geometry the table sweeps cannot represent (a non-parallelogram
    rect) is rejected explicitly — by extract_tables and by the routing
    predicate every engine="pallas" entry point uses."""
    import numpy as _np
    from kytpu.light import lights as klights
    ok = builders.cornell_box(
        width=16, height=16, floor_checker=True,
        back_image=_np.zeros((6, 6, 3), _np.float32))   # not pow2
    bs.extract_tables(ok)   # must not raise
    assert bs.ineligibility(ok) is None
    a = builders._SceneAssembler()
    a.surface(a.geo.add_rectangle((-1.0, 0.0, -1.0), (1.0, 0.0, -1.0),
                                  (0.5, 0.0, 1.0), (-0.5, 0.0, 1.0)),
              a.matte(jnp.full(3, 0.5)))
    a.add_light(kind=klights.POINT, emit=_np.full(3, 5.0, _np.float32),
                position=_np.asarray([0.0, 3.0, 0.0], _np.float32))
    bad = a.build(kscene.make_camera(
        position=(0.0, 2.0, 4.0), front=(0.0, -0.4, -1.0),
        up=(0.0, 1.0, 0.0), fov_degrees=40.0, width=8, height=8))
    assert "parallelogram" in bs.ineligibility(bad)
    assert not bs.use_table_kernel(bad)
    with pytest.raises(NotImplementedError):
        bs.extract_tables(bad)


@pytest.mark.slow
def test_bigscene_sobol_matches_baked_same_draws():
    """In-kernel Owen-Sobol: the table kernel and the baked kernel draw
    identical (0,2)-streams from the same (seed, sample index, pixel id),
    so they agree lane-by-lane like the PRNG mode does."""
    scene = builders.random_spheres(n=24, width=24, height=24, seed=0)
    cfg = wf.KernelConfig(max_depth=3, rows=8, sampler="sobol")
    cam = scene.camera
    npix = cam.width * cam.height
    xs = (jnp.arange(npix) % cam.width).astype(jnp.float32) + 0.5
    ys = (jnp.arange(npix) // cam.width).astype(jnp.float32) + 0.5
    o, d = kscene.generate_rays(cam, jnp.stack([xs, ys], axis=-1))
    pid = jnp.arange(npix, dtype=jnp.int32)
    si = jnp.zeros(npix, jnp.int32)
    big = bs.make_bigscene_tracer(scene, cfg, interpret=True)
    baked = wf.make_pallas_tracer(scene, cfg, interpret=True)
    lb = np.asarray(big(scene, o, d, 0, si, pid))
    lk = np.asarray(baked(scene, o, d, 0, si, pid))
    assert not np.isnan(lb).any()
    assert np.abs(lb - lk).max() < 1e-3, np.abs(lb - lk).max()
    # a different sample index must change the stream
    lb2 = np.asarray(big(scene, o, d, 0, si + 1, pid))
    assert np.abs(lb2 - lb).max() > 1e-4


@pytest.mark.slow
def test_bigscene_sobol_grad_matches_fd():
    """Sobol replay backward: gradients vs central finite differences of
    the same deterministic (fixed si/pix) pallas forward."""
    scene = builders.random_spheres(n=16, width=12, height=12, seed=0)
    cfg = wf.KernelConfig(max_depth=3, rows=8, sampler="sobol")
    tracer = bs.make_bigscene_diff_tracer(scene, cfg, interpret=True)

    n = 144
    pid = jnp.arange(n, dtype=jnp.int32)
    px = (pid % 12).astype(jnp.float32) + 0.5
    py = (pid // 12).astype(jnp.float32) + 0.5
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    seed = jnp.int32(5)
    si = jnp.zeros(n, jnp.int32)

    env0 = jnp.asarray(scene.env_radiance_)
    p0 = (scene.mat_diffuse, scene.mat_specular, scene.emission, env0)

    def loss(diffuse, specular, emission, env):
        out = tracer(diffuse, specular, emission, env, o, d, seed, si, pid)
        return jnp.mean(out)

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*p0)
    em = np.asarray(scene.emission)
    light_row = int(np.argmax(em.sum(axis=1)))
    probes = [(0, (0, 0)), (0, (3, 1)), (2, (light_row, 0)), (3, (2,))]
    eps = 1e-2
    for argi, idx in probes:
        args_p = list(p0)
        args_m = list(p0)
        args_p[argi] = p0[argi].at[idx].add(eps)
        args_m[argi] = p0[argi].at[idx].add(-eps)
        fd = (float(loss(*args_p)) - float(loss(*args_m))) / (2 * eps)
        ad = float(g[argi][idx])
        assert np.isfinite(ad) and np.isfinite(fd), (argi, idx, ad, fd)
        assert abs(ad - fd) <= 3e-3 * max(abs(fd), 1e-2), (argi, idx, ad, fd)
    assert any(abs(float(g[a][i])) > 1e-4 for a, i in probes)


@pytest.mark.slow
def test_bigscene_exponent_grad_matches_baked():
    """Trainable-exponent adjoint of the table kernel == the baked
    kernel's (FD-tested) replay exponent gradient, same RNG stream.
    Verified 2026-08-20: bitwise-equal values on the Cornell glossy
    floor (9.773039e-07)."""
    scene = builders.cornell_box(width=12, height=12)
    cfg = wf.KernelConfig(max_depth=3, rows=8, trainable_exponent=True)
    big = bs.make_bigscene_diff_tracer(scene, cfg, interpret=True)
    baked = wf.make_pallas_diff_tracer(scene, cfg, interpret=True,
                                       backward="replay")
    n = 144
    pid = jnp.arange(n, dtype=jnp.int32)
    px = (pid % 12).astype(jnp.float32) + 0.5
    py = (pid // 12).astype(jnp.float32) + 0.5
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    env0 = (scene.env_radiance_ if scene.has_env
            else jnp.zeros(3, jnp.float32))
    exp0 = jnp.asarray(scene.mat_exponent)

    grads = {}
    for name, tr in (("big", big), ("baked", baked)):
        def loss(exponent, tr=tr):
            return jnp.mean(tr(scene.mat_diffuse, scene.mat_specular,
                               scene.emission, exponent, env0, o, d,
                               jnp.int32(5)))
        grads[name] = np.asarray(jax.grad(loss)(exp0))
    # nonzero exactly on the plastic row(s), equal across kernels
    kinds = np.asarray(scene.mat_kind)
    for i, k in enumerate(kinds):
        from kytpu import bsdf as kbsdf
        if int(k) != kbsdf.MAT_PLASTIC:
            assert grads["big"][i] == 0.0
    assert np.any(grads["big"] != 0.0)
    np.testing.assert_allclose(grads["big"], grads["baked"],
                               rtol=1e-5, atol=1e-12)


@pytest.mark.slow
def test_bigscene_residual_matches_replay():
    """The coefficient-cache backward (the default) must equal the
    path-replay backward to fp reassociation — same scene, same stream,
    all five gradient leaves incl. the trainable exponent."""
    scene = builders.cornell_box(width=12, height=12)
    cfg = wf.KernelConfig(max_depth=3, rows=8, trainable_exponent=True)
    tr_res = bs.make_bigscene_diff_tracer(scene, cfg, interpret=True,
                                          backward="residual")
    tr_rep = bs.make_bigscene_diff_tracer(scene, cfg, interpret=True,
                                          backward="replay")
    n = 144
    pid = jnp.arange(n, dtype=jnp.int32)
    px = (pid % 12).astype(jnp.float32) + 0.5
    py = (pid // 12).astype(jnp.float32) + 0.5
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    env0 = (scene.env_radiance_ if scene.has_env
            else jnp.zeros(3, jnp.float32))
    args = (scene.mat_diffuse, scene.mat_specular, scene.emission,
            jnp.asarray(scene.mat_exponent), env0)
    gs = {}
    for name, tr in (("residual", tr_res), ("replay", tr_rep)):
        def loss(*a, tr=tr):
            return jnp.mean(tr(*a, o, d, jnp.int32(5)))
        assert np.isfinite(float(loss(*args)))
        gs[name] = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    for a, b in zip(gs["residual"], gs["replay"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-8)


@pytest.mark.slow
def test_bigscene_textures_match_baked():
    """In-kernel textures in the TABLE kernel (checker + small pow2 image
    atlas): bitwise-identical to the baked megakernel at the same draws —
    the static per-rec texture machinery (wavefront.py:873-996) applies
    unchanged, selected by the carried global row. Forward-only (the diff
    tracer raises; textured training routes to the baked kernel)."""
    img = np.linspace(0, 1, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    sc = builders.cornell_box(width=16, height=16, floor_checker=True,
                              back_image=img)
    cfg = wf.KernelConfig(max_depth=3, rows=8)
    a = np.asarray(bs.render_bigscene(sc, spp=8, seed=9, cfg=cfg,
                                      interpret=True, clamp=False))
    b = np.asarray(wf.render_pallas(sc, spp=8, seed=9, cfg=cfg,
                                    interpret=True, clamp=False))
    assert np.array_equal(a, b)
    assert np.isfinite(a).all() and a.mean() > 0.01


@pytest.mark.slow
def test_bigscene_texture_gradients():
    """Texture gradients through the TABLE kernel (the last kernel
    asymmetry, closed): replay == residual == the baked kernel's
    (FD-tested) gradients at the same draws, for checker colors AND
    image texels, and a direct FD check through the residual tracer.
    rr_start=3 with max_depth=3 keeps RR out so FD is clean."""
    img = np.linspace(0.1, 0.9, 4 * 4 * 3,
                      dtype=np.float32).reshape(4, 4, 3)
    sc = builders.cornell_box(width=12, height=12, floor_checker=True,
                              back_image=img)
    cfg = wf.KernelConfig(max_depth=3, rows=8)
    n = 12 * 12 * 2
    key = jax.random.key(3)
    u = jax.random.uniform(key, (n, 2))
    pid = jnp.arange(n, dtype=jnp.int32) % (12 * 12)
    px = (pid % 12).astype(jnp.float32) + u[:, 0]
    py = (pid // 12).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(sc.camera, jnp.stack([px, py], -1))
    env0 = jnp.zeros(3, jnp.float32)
    seed = jnp.int32(5)

    tracers = {
        "baked": wf.make_pallas_diff_tracer(sc, cfg, interpret=True,
                                            backward="replay"),
        "replay": bs.make_bigscene_diff_tracer(sc, cfg, interpret=True,
                                               backward="replay"),
        "residual": bs.make_bigscene_diff_tracer(sc, cfg, interpret=True,
                                                 backward="residual"),
    }
    args = (sc.mat_diffuse, sc.mat_specular, sc.emission,
            sc.textures.color_a, sc.textures.color_b, sc.textures.image)
    gs, vals = {}, {}
    for name, tr in tracers.items():
        def loss(dd, ss, ee, ta, tb, ti, tr=tr):
            return jnp.sum(tr(dd, ss, ee, ta, tb, ti, env0, o, d, seed))
        vals[name] = float(loss(*args))
        assert np.isfinite(vals[name])
        gs[name] = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5))(*args)
    # the two table-kernel backwards agree tightly
    for a, b in zip(gs["replay"], gs["residual"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)
    # and match the baked kernel (same draws; forward is bitwise-equal).
    # d_emission is compared on EMISSIVE rows only: the baked kernel
    # statically prunes its per-row emission accumulators to rows_e,
    # while the row-tagged table backward reports every visible row's
    # (equally valid) emission gradient.
    assert abs(vals["replay"] - vals["baked"]) < 1e-3 * abs(vals["baked"])
    emissive = np.asarray(sc.emission).sum(-1) > 0
    for i, (a, b) in enumerate(zip(gs["replay"], gs["baked"])):
        a = np.asarray(a)
        b = np.asarray(b)
        if i == 2:
            a, b = a[emissive], b[emissive]
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)
    # texture adjoints are live (floor checker + back-wall image visible)
    assert np.abs(np.asarray(gs["residual"][3])).sum() > 0
    assert np.abs(np.asarray(gs["residual"][5])).sum() > 0

    # direct FD through the residual tracer: one checker channel, one texel
    def loss_res(ta, ti):
        return float(jnp.sum(tracers["residual"](
            sc.mat_diffuse, sc.mat_specular, sc.emission,
            ta, sc.textures.color_b, ti, env0, o, d, seed)))

    ta0 = np.asarray(sc.textures.color_a)
    ti0 = np.asarray(sc.textures.image)
    eps = 1e-2
    ta_p = ta0.copy(); ta_p[0, 1] += eps
    ta_m = ta0.copy(); ta_m[0, 1] -= eps
    fd_ta = (loss_res(jnp.asarray(ta_p), sc.textures.image)
             - loss_res(jnp.asarray(ta_m), sc.textures.image)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(gs["residual"][3])[0, 1], fd_ta,
                               rtol=5e-3, atol=1e-5)
    # pick the texel with the largest adjoint so FD is well-conditioned
    g_ti = np.abs(np.asarray(gs["residual"][5])).sum(-1)
    iy, ix = np.unravel_index(np.argmax(g_ti[0]), g_ti[0].shape)
    ti_p = ti0.copy(); ti_p[0, iy, ix, 0] += eps
    ti_m = ti0.copy(); ti_m[0, iy, ix, 0] -= eps
    fd_ti = (loss_res(sc.textures.color_a, jnp.asarray(ti_p))
             - loss_res(sc.textures.color_a, jnp.asarray(ti_m))) / (2 * eps)
    np.testing.assert_allclose(np.asarray(gs["residual"][5])[0, iy, ix, 0],
                               fd_ti, rtol=5e-3, atol=1e-5)


@pytest.mark.slow
def test_bigscene_texp_plus_texture_gradients():
    """Trainable exponents AND textures simultaneously through the table
    kernel: the _bigres_layout interleaves Bk/tuk kappa partners with the
    tx/ty texel planes, and replay == residual must hold across all seven
    trainable leaves (diffuse, specular, emission, exponent, texa, texb,
    texels)."""
    img = np.linspace(0.1, 0.9, 4 * 4 * 3,
                      dtype=np.float32).reshape(4, 4, 3)
    sc = builders.cornell_box(width=8, height=8, floor_checker=True,
                              back_image=img)
    cfg = wf.KernelConfig(max_depth=2, rows=8, trainable_exponent=True)
    n = 64
    key = jax.random.key(3)
    u = jax.random.uniform(key, (n, 2))
    pid = jnp.arange(n, dtype=jnp.int32)
    px = (pid % 8).astype(jnp.float32) + u[:, 0]
    py = (pid // 8).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(sc.camera, jnp.stack([px, py], -1))
    env0 = jnp.zeros(3, jnp.float32)
    seed = jnp.int32(5)
    args = (sc.mat_diffuse, sc.mat_specular, sc.emission,
            jnp.asarray(sc.mat_exponent), sc.textures.color_a,
            sc.textures.color_b, sc.textures.image)
    gs = {}
    for bwd in ("replay", "residual"):
        tr = bs.make_bigscene_diff_tracer(sc, cfg, interpret=True,
                                          backward=bwd)

        def loss(dd, ss, ee, xp, ta, tb, ti, tr=tr):
            return jnp.sum(tr(dd, ss, ee, xp, ta, tb, ti, env0, o, d,
                              seed))

        assert np.isfinite(float(loss(*args)))
        gs[bwd] = jax.grad(loss, argnums=tuple(range(7)))(*args)
    for a, b in zip(gs["replay"], gs["residual"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.slow
def test_bigscene_cull_modes_bitwise_identical():
    """Block culling is exact-conservative: "cone" (primary-bounce only,
    the default), the opt-in "cone+nee" (all-bounce shadow-sweep cull,
    split compact/unbounded light groups, an opt-in knob) and "off" must
    produce bitwise-identical
    renders."""
    sc = builders.random_spheres(n=40, width=16, height=16, seed=0)
    cam = sc.camera
    npix = 16 * 16
    xs = (jnp.arange(npix) % 16).astype(jnp.float32) + 0.5
    ys = (jnp.arange(npix) // 16).astype(jnp.float32) + 0.5
    o, d = kscene.generate_rays(cam, jnp.stack([xs, ys], -1))
    outs = {}
    for cull in ("cone", "cone+nee", "off"):
        cfg = wf.KernelConfig(max_depth=2, rows=8, cull=cull)
        tr = bs.make_bigscene_tracer(sc, cfg, interpret=True)
        outs[cull] = np.asarray(tr(sc, o, d, 3))
    np.testing.assert_array_equal(outs["cone"], outs["off"])
    np.testing.assert_array_equal(outs["cone+nee"], outs["off"])
