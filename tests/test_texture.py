"""Textures: UV parameterizations, checker/image evaluation, gradients,
and engine agreement on textured scenes.

The reference's texture region is an empty stub (ky.cpp:2559-2563), so
these tests pin kytpu's own conventions (scene/texture.py docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kytpu.core import math as km
from kytpu.integrator.render import render, render_aov
from kytpu.integrator.path import PathConfig
from kytpu.scene import builders, shapes as kshapes, texture as ktex


# ---------------------------------------------------------------------------
# surface_uv
# ---------------------------------------------------------------------------


def _uv(geom, sid, pts):
    return np.asarray(kshapes.surface_uv(
        geom, jnp.full((len(pts),), sid, jnp.int32),
        jnp.asarray(pts, jnp.float32)))


def test_rect_uv_corners():
    g = kshapes.GeometryBuilder()
    p0, p1, p2, p3 = (1, 0, 0), (0, 0, 0), (0, 2, 0), (1, 2, 0)
    g.add_rectangle(p0, p1, p2, p3)
    geom, _ = g.build()
    uv = _uv(geom, 0, [p1, p0, p2, p3, (0.5, 1.0, 0.0)])
    np.testing.assert_allclose(
        uv, [[0, 0], [1, 0], [0, 1], [1, 1], [0.5, 0.5]], atol=1e-5)


def test_rect_uv_skewed_parallelogram():
    g = kshapes.GeometryBuilder()
    # parallelogram: p0 = p1 + a, p3 = p2 + a with a shear
    p1 = np.array([0.0, 0.0, 0.0])
    a = np.array([1.0, 0.3, 0.0])
    b = np.array([0.2, 2.0, 0.0])
    g.add_rectangle(p1 + a, p1, p1 + b, p1 + a + b)
    geom, _ = g.build()
    uv = _uv(geom, 0, [p1 + 0.25 * a + 0.75 * b])
    np.testing.assert_allclose(uv, [[0.25, 0.75]], atol=1e-5)


def test_triangle_uv_barycentric():
    g = kshapes.GeometryBuilder()
    p0, p1, p2 = (0, 0, 0), (3, 0, 0), (0, 2, 0)
    g.add_triangle(p0, p1, p2)
    geom, _ = g.build()
    uv = _uv(geom, 0, [p0, p1, p2, (1.0, 2.0 / 3.0, 0.0)])
    np.testing.assert_allclose(
        uv, [[0, 0], [1, 0], [0, 1], [1 / 3, 1 / 3]], atol=1e-5)


def test_sphere_uv():
    g = kshapes.GeometryBuilder()
    g.add_sphere((0, 0, 0), 1.0)
    geom, _ = g.build()
    uv = _uv(geom, 0, [(0, 0, 1), (1, 0, 0), (0, 1, 0), (0, 0, -1),
                       (-1, 0, 0)])
    np.testing.assert_allclose(uv[0, 1], 0.0, atol=1e-5)          # north pole
    np.testing.assert_allclose(uv[1], [0.0, 0.5], atol=1e-5)      # +x equator
    np.testing.assert_allclose(uv[2], [0.25, 0.5], atol=1e-5)     # +y
    np.testing.assert_allclose(uv[3, 1], 1.0, atol=1e-5)          # south pole
    np.testing.assert_allclose(uv[4], [0.5, 0.5], atol=1e-5)      # -x


def test_disk_uv():
    g = kshapes.GeometryBuilder()
    g.add_disk((0, 0, 0), (0, 0, 1), 2.0)
    geom, _ = g.build()
    # frame for n=+z: s=(1,0,0), t=(0,1,0)
    uv = _uv(geom, 0, [(0, 0, 0), (2, 0, 0), (0, -2, 0)])
    np.testing.assert_allclose(
        uv, [[0.5, 0.5], [1.0, 0.5], [0.5, 0.0]], atol=1e-5)


# ---------------------------------------------------------------------------
# texture evaluation
# ---------------------------------------------------------------------------


def test_checker_eval():
    tex = ktex.build([dict(kind=ktex.CHECKER, color_a=jnp.asarray([1., 0., 0.]),
                           color_b=jnp.asarray([0., 0., 1.]),
                           scale=(2.0, 2.0))])
    uv = jnp.asarray([[0.1, 0.1],    # cell (0,0) -> even -> A
                      [0.6, 0.1],    # cell (1,0) -> odd  -> B
                      [0.6, 0.6],    # cell (1,1) -> even -> A
                      [0.1, 0.6]])   # cell (0,1) -> odd  -> B
    out = np.asarray(ktex.eval_texture(tex, jnp.zeros(4, jnp.int32), uv))
    np.testing.assert_allclose(
        out, [[1, 0, 0], [0, 0, 1], [1, 0, 0], [0, 0, 1]], atol=1e-6)


def _numpy_bilinear(img, u, v):
    h, w = img.shape[:2]
    u, v = u % 1.0, v % 1.0
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0
    xi0, yi0 = int(x0) % w, int(y0) % h
    xi1, yi1 = (xi0 + 1) % w, (yi0 + 1) % h
    top = img[yi0, xi0] * (1 - fx) + img[yi0, xi1] * fx
    bot = img[yi1, xi0] * (1 - fx) + img[yi1, xi1] * fx
    return top * (1 - fy) + bot * fy


def test_image_bilinear():
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (8, 16, 3)).astype(np.float32)
    tex = ktex.build([dict(kind=ktex.IMAGE, image=img)])
    # texel centers reproduce texels exactly
    uv_c = jnp.asarray([[(3 + 0.5) / 16, (5 + 0.5) / 8]])
    out = np.asarray(ktex.eval_texture(tex, jnp.zeros(1, jnp.int32), uv_c))
    np.testing.assert_allclose(out[0], img[5, 3], atol=1e-6)
    # random points match the numpy reference (incl. wrap across edges)
    uvs = rng.uniform(-1, 2, (32, 2)).astype(np.float32)
    out = np.asarray(ktex.eval_texture(
        tex, jnp.zeros(32, jnp.int32), jnp.asarray(uvs)))
    want = np.stack([_numpy_bilinear(img, u, v) for u, v in uvs])
    np.testing.assert_allclose(out, want, atol=2e-5)


def test_image_gradients_are_partition_of_unity():
    """Bilinear lookup is linear in the texels: the gradient of a lane's
    output channel w.r.t. the atlas is 4 weights summing to exactly 1."""
    img = jnp.zeros((4, 4, 3), jnp.float32)
    tex = ktex.build([dict(kind=ktex.IMAGE, image=img)])
    uv = jnp.asarray([[0.33, 0.71]])

    def f(atlas):
        import dataclasses
        t = dataclasses.replace(tex, image=atlas)
        return ktex.eval_texture(t, jnp.zeros(1, jnp.int32), uv)[0, 0]

    g = np.asarray(jax.grad(f)(tex.image))[0, :, :, 0]
    assert np.count_nonzero(g) == 4
    np.testing.assert_allclose(g.sum(), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# scene integration
# ---------------------------------------------------------------------------


def test_textured_basecolor_aov():
    scene = builders.cornell_box(width=48, height=48, floor_checker=True)
    img = np.asarray(render_aov(scene, "basecolor", spp=1))
    # the floor occupies the image bottom; its lambertian basecolor is
    # checker/pi -> exactly two distinct colors present there
    floor = img[40:, :, :]
    vals = np.unique(floor.round(4).reshape(-1, 3), axis=0)
    vals = vals[np.abs(vals).sum(1) > 0]
    a = 0.73 * km.INV_PI
    b = 0.18 * km.INV_PI
    assert any(np.allclose(v, [a, a, a], atol=2e-3) for v in vals)
    assert any(np.allclose(v, [b, b, b], atol=2e-3) for v in vals)


def test_untextured_scene_unchanged():
    """Adding the texture subsystem must not disturb untextured renders:
    uv is zeros and diffuse_at falls back to mat_diffuse."""
    scene = builders.cornell_box(width=32, height=32)
    assert not scene.has_textures
    img = np.asarray(render(scene, spp=4, seed=3,
                                    cfg=PathConfig(max_depth=2)))
    assert np.isfinite(img).all() and img.max() > 0


def test_path_fast_agree_on_textured_scene():
    scene = builders.cornell_box(width=64, height=64, floor_checker=True)
    cfg = PathConfig(max_depth=3)
    a = np.asarray(render(scene, spp=48, seed=11, cfg=cfg,
                                  mode="path"))
    b = np.asarray(render(scene, spp=48, seed=12, cfg=cfg,
                                  mode="fast"))

    def down(x, f=8):
        h, w, _ = x.shape
        return x.reshape(h // f, f, w // f, f, 3).mean((1, 3))

    err = np.abs(down(a) - down(b)).mean()
    assert err < 0.02, err


@pytest.mark.slow
def test_texture_params_roundtrip_and_grad():
    img = np.full((4, 4, 3), 0.5, np.float32)
    scene = builders.cornell_box(width=16, height=16, floor_checker=True,
                                 back_image=img)
    from kytpu.diff import params as kparams
    names = ("tex_color_a", "tex_image")
    p = kparams.get_params(scene, names)
    assert p["tex_image"].shape == (1, 4, 4, 3)
    p2 = {k: v + 0.1 for k, v in p.items()}
    s2 = kparams.set_params(scene, p2)
    np.testing.assert_allclose(np.asarray(s2.textures.image),
                               img[None] + 0.1, atol=1e-6)

    # gradient of a tiny render w.r.t. the checker color and the texels:
    # nonzero, and AD == FD at fixed samples (the lookup is linear)
    from kytpu.diff.inverse import render_once
    key = jax.random.key(0)
    cfg = PathConfig(max_depth=2)

    def loss(params):
        return render_once(kparams.set_params(scene, params), key, 2,
                           cfg).mean()

    g = jax.grad(loss)(p)
    ga = float(np.asarray(g["tex_color_a"]).sum())
    gi = float(np.asarray(g["tex_image"]).sum())
    assert ga > 0 and gi > 0
    # all-ones directional FD == sum of the gradient (fixed samples)
    eps = 1e-2
    for name, gsum in (("tex_color_a", ga), ("tex_image", gi)):
        fd = (loss({**p, name: p[name] + eps}) -
              loss({**p, name: p[name] - eps})) / (2 * eps)
        np.testing.assert_allclose(float(fd), gsum, rtol=5e-3, atol=1e-6)


@pytest.mark.slow
def test_megakernel_checker_matches_fast():
    """The megakernel evaluates planar checker textures in-kernel (baked
    anchor + dual-basis uv, global color tables); statistical agreement
    with the jnp fast engine."""
    from kytpu.kernels import wavefront as kwf
    from kytpu.integrator.fast import FastConfig
    scene = builders.cornell_box(width=48, height=48, floor_checker=True)
    img_k = np.asarray(kwf.render_pallas(
        scene, spp=32, seed=3, cfg=kwf.KernelConfig(max_depth=3, rows=8),
        interpret=True))
    img_f = np.asarray(render(scene, spp=32, seed=5,
                              cfg=FastConfig(max_depth=3), mode="fast"))

    def down(x, f=8):
        h, w, _ = x.shape
        return x.reshape(h // f, f, w // f, f, 3).mean((1, 3))

    err = np.abs(down(img_k) - down(img_f)).mean()
    assert err < 0.03, err


@pytest.mark.parametrize("backward", ["replay", "residual"])
@pytest.mark.slow
def test_megakernel_checker_gradients_match_fd(backward):
    """Checker-color adjoints through the megakernel, both backwards:
    AD == central FD of the SAME deterministic kernel forward (the
    diffuse-value adjoint routes to color_a/color_b by cell parity;
    the diffuse-table share on textured rows is zero)."""
    import jax
    from kytpu.kernels import wavefront as kwf
    from kytpu.scene import scene as kscene
    scene = builders.cornell_box(width=8, height=8, floor_checker=True)
    cfg = kwf.KernelConfig(max_depth=3, rows=8)
    tracer = kwf.make_pallas_diff_tracer(scene, cfg, interpret=True,
                                         backward=backward)
    n = 64
    key = jax.random.key(0)
    u = jax.random.uniform(key, (n, 2))
    pid = jnp.arange(n, dtype=jnp.int32)
    px = (pid % 8).astype(jnp.float32) + u[:, 0]
    py = (pid // 8).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    seed = jnp.int32(5)
    env0 = jnp.zeros(3, jnp.float32)
    p0 = (scene.textures.color_a, scene.textures.color_b)

    def loss(texa, texb):
        out = tracer(scene.mat_diffuse, scene.mat_specular, scene.emission,
                     texa, texb, env0, o, d, seed)
        return jnp.mean(out)

    g = jax.grad(loss, argnums=(0, 1))(*p0)
    eps = 1e-2
    checked = 0
    for argi in (0, 1):
        for ch in (0, 2):
            args_p = list(p0)
            args_m = list(p0)
            args_p[argi] = p0[argi].at[0, ch].add(eps)
            args_m[argi] = p0[argi].at[0, ch].add(-eps)
            fd = (float(loss(*args_p)) - float(loss(*args_m))) / (2 * eps)
            ad = float(g[argi][0, ch])
            assert np.isfinite(ad) and np.isfinite(fd), (argi, ch, ad, fd)
            assert abs(ad - fd) <= 3e-3 * max(abs(fd), 1e-2), \
                (argi, ch, ad, fd)
            checked += abs(ad) > 1e-4
    assert checked >= 2  # both checker colors carry real gradient

    # the floor row's diffuse-table gradient must be zero (value unused)
    def loss_d(diffuse):
        out = tracer(diffuse, scene.mat_specular, scene.emission,
                     *p0, env0, o, d, seed)
        return jnp.mean(out)

    gd = np.asarray(jax.grad(loss_d)(scene.mat_diffuse))
    floor_row = 3  # cornell floor is the 4th surface added
    np.testing.assert_allclose(gd[floor_row], 0.0, atol=1e-8)


def test_pallas_train_step_recovers_checker_colors():
    """make_train_step(engine='pallas', names=('tex_color_a','tex_color_b'))
    routes checker-color gradients through the kernel backward and reduces
    the loss toward the true colors (interpret mode)."""
    import jax
    from kytpu.diff import get_params, set_params
    from kytpu.diff.inverse import make_train_step, render_once
    scene = builders.cornell_box(width=8, height=8, floor_checker=True)
    # depth >= 2 needed: at this tiny film the checker grads ride the
    # wall->floor bounce, and depth-1 leaves them exactly zero
    cfg = PathConfig(max_depth=2)
    key = jax.random.key(11)
    target = jax.lax.stop_gradient(render_once(scene, key, spp=2, cfg=cfg))
    names = ("tex_color_a", "tex_color_b")
    true = get_params(scene, names)
    wrong = set_params(scene, {n: v * 0.4 for n, v in true.items()})
    step, params, opt = make_train_step(wrong, target, spp=2, cfg=cfg,
                                        engine="pallas", names=names)
    losses = []
    for i in range(3):
        params, opt, loss = step(params, opt, key)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


@pytest.mark.slow
def test_megakernel_image_matches_fast():
    """The megakernel evaluates image textures in-kernel (baked uv dual
    basis + gathered bilinear taps from the flattened atlas); statistical
    agreement with the jnp fast engine's bilinear."""
    from kytpu.kernels import wavefront as kwf
    from kytpu.integrator.fast import FastConfig
    rng = np.random.default_rng(3)
    img = rng.uniform(0.1, 0.9, (8, 8, 3)).astype(np.float32)
    scene = builders.cornell_box(width=48, height=48, back_image=img)
    img_k = np.asarray(kwf.render_pallas(
        scene, spp=32, seed=3, cfg=kwf.KernelConfig(max_depth=3, rows=8),
        interpret=True))
    img_f = np.asarray(render(scene, spp=32, seed=5,
                              cfg=FastConfig(max_depth=3), mode="fast"))

    def down(x, f=8):
        h, w, _ = x.shape
        return x.reshape(h // f, f, w // f, f, 3).mean((1, 3))

    err = np.abs(down(img_k) - down(img_f)).mean()
    assert err < 0.03, err


def test_megakernel_rejects_unsupported_textures():
    """Sphere UV textures stay on the jnp engines: both tracer factories
    and the table-kernel routing predicate refuse them explicitly."""
    from kytpu.kernels import bigscene as kbig
    from kytpu.kernels import wavefront as kwf
    from kytpu.light import lights as klights
    from kytpu.scene import scene as kscene
    a = builders._SceneAssembler()
    tex = a.add_checker(jnp.asarray([0.9, 0.1, 0.1]),
                        jnp.asarray([0.1, 0.1, 0.9]))
    a.surface(a.geo.add_sphere((0.0, 0.0, 0.0), 1.0),
              a.matte(jnp.full(3, 0.5), texture=tex))
    a.add_light(kind=klights.POINT, emit=np.full(3, 5.0, np.float32),
                position=np.asarray([0.0, 3.0, 0.0], np.float32))
    cam = kscene.make_camera(position=(0.0, 0.0, 4.0), front=(0.0, 0.0, -1.0),
                             up=(0.0, 1.0, 0.0), fov_degrees=40.0,
                             width=8, height=8)
    sc = a.build(cam)
    with pytest.raises(NotImplementedError):
        kwf.make_pallas_tracer(sc, interpret=True)
    with pytest.raises(NotImplementedError):
        kwf.make_pallas_diff_tracer(sc, interpret=True)
    assert kbig.ineligibility(sc) is not None
    assert not kbig.use_table_kernel(sc)


def test_megakernel_separable_image_matches_fast():
    """Non-power-of-two atlases go through the same gathered bilinear
    fetch (wavefront._image_color: 4 loads per channel, wrap by select).
    Statistical agreement with the jnp fast engine's bilinear on a
    non-power-of-two 24x24 atlas."""
    from kytpu.kernels import wavefront as kwf
    from kytpu.integrator.fast import FastConfig
    rng = np.random.default_rng(7)
    img = rng.uniform(0.1, 0.9, (24, 24, 3)).astype(np.float32)
    scene = builders.cornell_box(width=32, height=32, back_image=img)
    img_k = np.asarray(kwf.render_pallas(
        scene, spp=32, seed=3, cfg=kwf.KernelConfig(max_depth=2, rows=8),
        interpret=True))
    img_f = np.asarray(render(scene, spp=64, seed=5,
                              cfg=FastConfig(max_depth=2), mode="fast"))

    def down(x, f=8):
        h, w, _ = x.shape
        return x.reshape(h // f, f, w // f, f, 3).mean((1, 3))

    err = np.abs(down(img_k) - down(img_f)).mean()
    assert err < 0.03, err


@pytest.mark.parametrize("backward", ["replay", "residual"])
@pytest.mark.slow
def test_megakernel_separable_image_gradients_match_fd(backward):
    """Per-texel adjoints on a 16x16 atlas, both backwards: the kernels
    write per-lane texture coordinates and adjoints, and
    wavefront.texel_adjoint scatter-adds them into the atlas in XLA.
    AD == central FD of the same deterministic kernel forward."""
    from kytpu.kernels import wavefront as kwf
    from kytpu.scene import scene as kscene
    rng = np.random.default_rng(5)
    img = rng.uniform(0.2, 0.8, (16, 16, 3)).astype(np.float32)  # 256 > 64
    scene = builders.cornell_box(width=8, height=8, back_image=img)
    cfg = kwf.KernelConfig(max_depth=3, rows=8)
    tracer = kwf.make_pallas_diff_tracer(scene, cfg, interpret=True,
                                         backward=backward)
    n = 64
    key = jax.random.key(0)
    u = jax.random.uniform(key, (n, 2))
    pid = jnp.arange(n, dtype=jnp.int32)
    px = (pid % 8).astype(jnp.float32) + u[:, 0]
    py = (pid // 8).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    seed = jnp.int32(5)
    env0 = jnp.zeros(3, jnp.float32)
    texa, texb = scene.textures.color_a, scene.textures.color_b
    timg0 = scene.textures.image

    def loss(timg):
        out = tracer(scene.mat_diffuse, scene.mat_specular, scene.emission,
                     texa, texb, timg, env0, o, d, seed)
        return jnp.mean(out)

    g = np.asarray(jax.grad(loss)(timg0))
    assert g.shape == timg0.shape
    gsum = float(g.sum())
    assert np.isfinite(g).all() and gsum > 0
    eps = 1e-2
    fd = (float(loss(timg0 + eps)) - float(loss(timg0 - eps))) / (2 * eps)
    np.testing.assert_allclose(fd, gsum, rtol=5e-3, atol=1e-6)
    for flat in np.argsort(-g.reshape(-1))[:3]:
        idx = np.unravel_index(int(flat), g.shape)
        fd = (float(loss(timg0.at[idx].add(eps)))
              - float(loss(timg0.at[idx].add(-eps)))) / (2 * eps)
        ad = float(g[idx])
        assert abs(ad - fd) <= 3e-3 * max(abs(fd), 1e-2), (idx, ad, fd)

    # the image row's diffuse-table gradient must be zero (value unused)
    def loss_d(diffuse):
        out = tracer(diffuse, scene.mat_specular, scene.emission,
                     texa, texb, timg0, env0, o, d, seed)
        return jnp.mean(out)

    gd = np.asarray(jax.grad(loss_d)(scene.mat_diffuse))
    img_row = int(np.argmax(np.asarray(scene.tex_id) >= 0))
    np.testing.assert_allclose(gd[img_row], 0.0, atol=1e-8)


@pytest.mark.parametrize("backward", ["replay", "residual"])
@pytest.mark.slow
def test_megakernel_image_gradients_match_fd(backward):
    """Per-texel image-atlas adjoints through the megakernel, both
    backwards: AD == central FD of the SAME deterministic kernel forward.
    The diffuse-value adjoint at an image-textured vertex routes to the 4
    bilinear-tap texels by their weights (replayed in the replay backward;
    rebuilt from the cached tx/ty coordinate planes in the residual
    backward), and the diffuse-table share on the image row is zero."""
    from kytpu.kernels import wavefront as kwf
    from kytpu.scene import scene as kscene
    rng = np.random.default_rng(5)
    img = rng.uniform(0.2, 0.8, (4, 4, 3)).astype(np.float32)
    scene = builders.cornell_box(width=8, height=8, back_image=img)
    cfg = kwf.KernelConfig(max_depth=3, rows=8)
    tracer = kwf.make_pallas_diff_tracer(scene, cfg, interpret=True,
                                         backward=backward)
    n = 64
    key = jax.random.key(0)
    u = jax.random.uniform(key, (n, 2))
    pid = jnp.arange(n, dtype=jnp.int32)
    px = (pid % 8).astype(jnp.float32) + u[:, 0]
    py = (pid // 8).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    seed = jnp.int32(5)
    env0 = jnp.zeros(3, jnp.float32)
    texa, texb = scene.textures.color_a, scene.textures.color_b
    timg0 = scene.textures.image

    def loss(timg):
        out = tracer(scene.mat_diffuse, scene.mat_specular, scene.emission,
                     texa, texb, timg, env0, o, d, seed)
        return jnp.mean(out)

    g = np.asarray(jax.grad(loss)(timg0))
    assert g.shape == timg0.shape
    gsum = float(g.sum())
    assert np.isfinite(g).all() and gsum > 0
    # bilinear is linear in the texels: all-ones directional FD == grad sum
    eps = 1e-2
    fd = (float(loss(timg0 + eps)) - float(loss(timg0 - eps))) / (2 * eps)
    np.testing.assert_allclose(fd, gsum, rtol=5e-3, atol=1e-6)
    # single-texel FD at the three strongest texels
    for flat in np.argsort(-g.reshape(-1))[:3]:
        idx = np.unravel_index(int(flat), g.shape)
        fd = (float(loss(timg0.at[idx].add(eps)))
              - float(loss(timg0.at[idx].add(-eps)))) / (2 * eps)
        ad = float(g[idx])
        assert abs(ad - fd) <= 3e-3 * max(abs(fd), 1e-2), (idx, ad, fd)

    # the image row's diffuse-table gradient must be zero (value unused)
    def loss_d(diffuse):
        out = tracer(diffuse, scene.mat_specular, scene.emission,
                     texa, texb, timg0, env0, o, d, seed)
        return jnp.mean(out)

    gd = np.asarray(jax.grad(loss_d)(scene.mat_diffuse))
    img_row = int(np.argmax(np.asarray(scene.tex_id) >= 0))
    np.testing.assert_allclose(gd[img_row], 0.0, atol=1e-8)


@pytest.mark.slow
def test_pallas_train_step_recovers_image_texels():
    """make_train_step(engine='pallas', names=('tex_image',)) routes
    per-texel gradients through the kernel backward and reduces the loss
    toward the painted texture (interpret mode)."""
    from kytpu.diff import get_params, set_params
    from kytpu.diff.inverse import make_train_step, render_once
    rng = np.random.default_rng(9)
    img = rng.uniform(0.2, 0.8, (4, 4, 3)).astype(np.float32)
    scene = builders.cornell_box(width=8, height=8, back_image=img)
    cfg = PathConfig(max_depth=2)
    key = jax.random.key(13)
    target = jax.lax.stop_gradient(render_once(scene, key, spp=2, cfg=cfg))
    names = ("tex_image",)
    true = get_params(scene, names)
    wrong = set_params(scene, {n: jnp.full_like(v, 0.5)
                               for n, v in true.items()})
    step, params, opt = make_train_step(wrong, target, spp=2, cfg=cfg,
                                        engine="pallas", names=names)
    losses = []
    for i in range(3):
        params, opt, loss = step(params, opt, key)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
