"""Megakernel component equivalence: the plane-SoA functions in
kytpu/kernels/wavefront.py are pure jnp, so outside pallas_call they must
reproduce the reference jnp implementations EXACTLY (same formulas, same
draws). The in-kernel assembly is covered by the statistical render
comparison (test_kernel_render_matches_fast)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kytpu import bsdf as kbsdf
from kytpu.core import frame as kframe
from kytpu.core import math as km
from kytpu.kernels import wavefront as wf
from kytpu.kernels.v3 import V3
from kytpu.light import lights as klights
from kytpu.scene import builders, shapes as kshapes
from kytpu.scene import scene as kscene

N = 4096


@pytest.fixture(scope="module")
def scene():
    return builders.veach_mis(width=32, height=20)


@pytest.fixture(scope="module")
def rays(scene):
    key = jax.random.key(0)
    u = jax.random.uniform(key, (N, 2))
    w, h = 32, 20
    pid = jnp.arange(N, dtype=jnp.int32) % (w * h)
    px = (pid % w).astype(jnp.float32) + u[:, 0]
    py = (pid // w).astype(jnp.float32) + u[:, 1]
    return kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))


def _v3(a):
    return V3(a[:, 0], a[:, 1], a[:, 2])


def test_closest_hit_matches(scene, rays):
    o, d = rays
    static = wf.extract_static(scene)
    t_k, sid_k, valid_k, n_k = wf._closest_hit(static, _v3(o), _v3(d))
    t_r, sid_r, valid_r = kshapes.closest_hit(
        scene.geometry, o, d, jnp.full((N,), jnp.inf))
    # the kernel's dual-basis inclusion test may disagree with the
    # 4-cross-product test for rays within fp rounding of a polygon edge
    agree = (np.asarray(valid_k) == np.asarray(valid_r))
    assert agree.mean() > 0.999, agree.mean()
    m = np.asarray(valid_r) & agree
    same_sid = np.asarray(sid_k)[m] == np.asarray(sid_r)[m]
    assert same_sid.mean() > 0.999
    m[m] &= same_sid
    np.testing.assert_allclose(np.asarray(t_k)[m], np.asarray(t_r)[m],
                               rtol=1e-5)
    n_r = kshapes.surface_normal(scene.geometry, sid_r, o + t_r[:, None] * d, d)
    for c, plane in zip(range(3), (n_k.x, n_k.y, n_k.z)):
        np.testing.assert_allclose(np.asarray(plane)[m],
                                   np.asarray(n_r)[m, c], atol=2e-5)


def test_any_hit_matches(scene, rays):
    o, d = rays
    static = wf.extract_static(scene)
    tmax = jnp.full((N,), 3.0)
    h_k = wf._any_hit(static, _v3(o), _v3(d), tmax)
    h_r = kshapes.any_hit(scene.geometry, o, d, tmax)
    agree = np.asarray(h_k) == np.asarray(h_r)
    assert agree.mean() > 0.999, agree.mean()


def test_fresnel_matches():
    ci = jnp.linspace(-1, 1, 1001)
    eta = jnp.full_like(ci, 1.6)
    a = wf._fresnel_dielectric(ci, eta)
    b = km.fresnel_dielectric(ci, jnp.ones_like(ci), eta)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("kind", [kbsdf.LAMBERT, kbsdf.MIRROR, kbsdf.GLASS,
                                  kbsdf.PHONG])
def test_bsdf_sample_matches(kind):
    key = jax.random.key(3)
    u = jax.random.uniform(key, (N, 2))
    wo = km.normalize(jax.random.normal(jax.random.fold_in(key, 1), (N, 3)))
    color = jnp.tile(jnp.asarray([[0.8, 0.6, 0.4]]), (N, 1))
    color2 = jnp.tile(jnp.asarray([[0.5, 0.7, 0.9]]), (N, 1))
    eta = jnp.full((N,), 1.6)
    expo = jnp.full((N,), 32.0)
    params = kbsdf.BsdfParams(kind=jnp.full((N,), kind, jnp.int32),
                              color=color, color2=color2, eta=eta,
                              exponent=expo)
    ref = kbsdf.sample_local(params, wo, u)
    f_k, wi_k, pdf_k, delta_k, f_unit, glass_refr = wf._bsdf_sample(
        jnp.full((N,), kind, jnp.int32), _v3(color), _v3(color2), eta, expo,
        _v3(wo), u[:, 0], u[:, 1])
    np.testing.assert_allclose(np.asarray(wi_k.x), np.asarray(ref.wi[:, 0]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(wi_k.z), np.asarray(ref.wi[:, 2]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(pdf_k), np.asarray(ref.pdf),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(f_k.x), np.asarray(ref.f[:, 0]),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(delta_k), np.asarray(ref.delta))


def test_bsdf_eval_pdf_matches():
    key = jax.random.key(5)
    wo = km.normalize(jax.random.normal(key, (N, 3)))
    wi = km.normalize(jax.random.normal(jax.random.fold_in(key, 1), (N, 3)))
    color = jnp.tile(jnp.asarray([[0.8, 0.6, 0.4]]), (N, 1))
    for kind in (kbsdf.LAMBERT, kbsdf.PHONG):
        params = kbsdf.BsdfParams(
            kind=jnp.full((N,), kind, jnp.int32), color=color, color2=color,
            eta=jnp.ones((N,)), exponent=jnp.full((N,), 12.0))
        f_r = kbsdf.eval_local(params, wo, wi)
        pdf_r = kbsdf.pdf_local(params, wo, wi)
        f_k, pdf_k, _unit = wf._bsdf_eval_pdf(
            jnp.full((N,), kind, jnp.int32), _v3(color),
            jnp.full((N,), 12.0), _v3(wo), _v3(wi))
        np.testing.assert_allclose(np.asarray(f_k.y), np.asarray(f_r[:, 1]),
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(pdf_k), np.asarray(pdf_r),
                                   rtol=2e-4, atol=1e-6)


def test_light_sample_pdf_match(scene):
    """Kernel light sampling == klights for every light, same draws."""
    static = wf.extract_static(scene)
    key = jax.random.key(7)
    u = jax.random.uniform(key, (N, 2))
    p = jax.random.normal(jax.random.fold_in(key, 1), (N, 3)) * 2.0
    n_sh = km.normalize(jax.random.normal(jax.random.fold_in(key, 2), (N, 3)))
    wr = scene.world_radius
    for i, lt in enumerate(static["lights"]):
        ref = klights.sample_li(scene.lights, i, wr, p, n_sh, u)
        emit = np.asarray(scene.lights.emit[i])
        wi_k, pdf_k, li_s, dist_k, _phit = wf._light_sample(
            lt, float(np.asarray(wr)), _v3(p), _v3(n_sh),
            u[:, 0], u[:, 1])
        # when extract_static proves no surface sits inside this sphere
        # light's ball, the kernel takes no NEE from inside/boundary points
        # (li_s = 0, matching pdf 0 in _light_pdf/_hit_light_pdf) — parity
        # holds on the outside lanes, which are the only reachable ones
        cmp = np.ones(N, bool)
        if lt["kind"] == wf.klights.AREA_SPHERE \
                and not lt.get("inside_possible", True):
            d2c = np.sum((np.asarray(p) - np.asarray(lt["center"]))**2, -1)
            inside = d2c <= lt["radius"] ** 2
            cmp = ~inside
            assert (np.asarray(li_s)[inside] == 0).all()
        np.testing.assert_allclose(np.asarray(wi_k.x)[cmp],
                                   np.asarray(ref.wi[:, 0])[cmp], atol=5e-5)
        np.testing.assert_allclose(np.asarray(pdf_k)[cmp],
                                   np.asarray(ref.pdf)[cmp],
                                   rtol=2e-3, atol=1e-5)
        # Li factorization: emit (x) li_scalar == reference Li
        li_k = np.broadcast_to(np.asarray(li_s), (N,))[:, None] * emit[None]
        np.testing.assert_allclose(li_k[cmp], np.asarray(ref.li)[cmp],
                                   rtol=2e-3, atol=1e-5)
        # pdf_li parity at the sampled directions
        pdf2_r = klights.pdf_li(scene.lights, i, p, n_sh, ref.wi)
        pdf2_k = wf._light_pdf(lt, _v3(p), _v3(n_sh), wi_k)
        np.testing.assert_allclose(np.asarray(pdf2_k)[cmp],
                                   np.asarray(pdf2_r)[cmp],
                                   rtol=2e-3, atol=1e-5)


@pytest.mark.slow
def test_kernel_render_matches_fast():
    """Statistical: interpret-mode megakernel render vs fast integrator."""
    from kytpu.integrator.fast import FastConfig
    from kytpu.integrator.render import render

    scene = builders.cornell_box(width=16, height=16)
    img_k = np.asarray(wf.render_pallas(
        scene, spp=48, seed=3, cfg=wf.KernelConfig(max_depth=3, rows=8),
        interpret=True))
    img_f = np.asarray(render(scene, spp=48, seed=5,
                              cfg=FastConfig(max_depth=3)))
    d4 = lambda a: a.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))  # noqa: E731
    err = np.abs(d4(img_k) - d4(img_f)).mean()
    assert err < 0.03, err


@pytest.mark.slow
def test_prb_gradients_match_fd():
    """Path-replay backward vs central finite differences of the SAME
    deterministic pallas forward (fixed seed => exact agreement up to f32)."""
    scene = builders.cornell_box(width=8, height=8)
    cfg = wf.KernelConfig(max_depth=3, rows=8)
    tracer = wf.make_pallas_diff_tracer(scene, cfg, interpret=True)

    n = 64
    key = jax.random.key(0)
    u = jax.random.uniform(key, (n, 2))
    pid = jnp.arange(n, dtype=jnp.int32)
    px = (pid % 8).astype(jnp.float32) + u[:, 0]
    py = (pid // 8).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    seed = jnp.int32(5)

    env0 = jnp.zeros(3, jnp.float32)
    p0 = (scene.mat_diffuse, scene.mat_specular, scene.emission)

    def loss(diffuse, specular, emission):
        out = tracer(diffuse, specular, emission, env0, o, d, seed)
        return jnp.mean(out)

    g = jax.grad(loss, argnums=(0, 1, 2))(*p0)
    em = np.asarray(scene.emission)
    light_row = int(np.argmax(em.sum(axis=1)))
    probes = [(0, (2, 0)), (0, (0, 1)), (2, (light_row, 0)), (1, (3, 0))]
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
    # gradients must be nontrivial
    assert any(abs(float(g[a][i])) > 1e-4 for a, i in probes)


@pytest.mark.slow
def test_pallas_train_step_reduces_loss():
    """Inverse rendering through the PRB kernel (interpret mode)."""
    from kytpu.diff import get_params, set_params
    from kytpu.diff.inverse import make_train_step, render_once
    from kytpu.integrator.path import PathConfig

    scene = builders.cornell_box(width=8, height=8)
    cfg = PathConfig(max_depth=2)
    key = jax.random.key(11)
    target = jax.lax.stop_gradient(render_once(scene, key, spp=2, cfg=cfg))
    wrong = set_params(scene, {
        "mat_diffuse": get_params(scene)["mat_diffuse"] * 0.4})
    step, params, opt = make_train_step(wrong, target, spp=2, cfg=cfg,
                                        engine="pallas")
    losses = []
    for i in range(4):
        params, opt, loss = step(params, opt, key)
        losses.append(float(loss))
    assert np.isfinite(losses).all() if hasattr(np, "isfinite") else True
    assert losses[-1] < losses[0], losses


@pytest.mark.slow
def test_pallas_train_step_with_exponent():
    """make_train_step(engine="pallas", names=...+mat_exponent) routes
    through the trainable-exponent replay kernel and reduces loss, moving
    the perturbed exponent toward its true value."""
    from kytpu.diff import get_params, set_params
    from kytpu.diff.inverse import make_train_step, render_once
    from kytpu.diff.params import TRAINABLE
    from kytpu.integrator.path import PathConfig

    scene = builders.cornell_box(width=8, height=8)
    cfg = PathConfig(max_depth=2)
    key = jax.random.key(13)
    target = jax.lax.stop_gradient(render_once(scene, key, spp=2, cfg=cfg))
    names = TRAINABLE + ("mat_exponent",)
    true_exp = get_params(scene, names)["mat_exponent"]
    wrong = set_params(scene, {"mat_exponent": true_exp * 0.5})
    step, params, opt = make_train_step(wrong, target, spp=2, cfg=cfg,
                                        engine="pallas", names=names)
    losses = []
    for i in range(3):
        params, opt, loss = step(params, opt, key)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    g = np.asarray(params["mat_exponent"] - true_exp * 0.5)
    assert np.isfinite(g).all()


@pytest.mark.slow
def test_single_light_nee_matches_all():
    """nee="single" (uniform pick x L compensation) converges to nee="all"."""
    scene = builders.veach_mis(width=24, height=15)
    a = np.asarray(wf.render_pallas(
        scene, spp=48, seed=3, cfg=wf.KernelConfig(max_depth=3, rows=8),
        interpret=True, clamp=False))
    s = np.asarray(wf.render_pallas(
        scene, spp=48, seed=7,
        cfg=wf.KernelConfig(max_depth=3, rows=8, nee="single"),
        interpret=True, clamp=False))
    assert abs(a.mean() - s.mean()) / a.mean() < 0.25  # MC tolerance
    assert np.isfinite(s).all()


@pytest.mark.slow
def test_single_light_nee_sobol_cycles_lights():
    """Under the sobol sampler the seed is FIXED across passes, so the
    single-NEE light pick must rotate with the sample index (stratified
    round-robin) or the estimator would freeze on one light per
    (tile, bounce) and never converge. Regression: sobol+single matches
    sobol+all on the 5-light Veach scene."""
    scene = builders.veach_mis(width=24, height=15)
    a = np.asarray(wf.render_pallas(
        scene, spp=40, seed=3,
        cfg=wf.KernelConfig(max_depth=3, rows=8, sampler="sobol"),
        interpret=True, clamp=False))
    s = np.asarray(wf.render_pallas(
        scene, spp=40, seed=3,
        cfg=wf.KernelConfig(max_depth=3, rows=8, nee="single",
                            sampler="sobol"),
        interpret=True, clamp=False))
    assert np.isfinite(s).all()
    assert abs(a.mean() - s.mean()) / a.mean() < 0.25
    # per-region agreement (a frozen pick biases whole image regions);
    # image is (15, 24): 3x4 tiles of 5x6 pixels
    d3 = lambda x: x.reshape(3, 5, 4, 6, 3).mean(axis=(1, 3))  # noqa: E731
    rel = np.abs(d3(a) - d3(s)) / np.maximum(d3(a), 0.05)
    assert rel.mean() < 0.35, rel.mean()


@pytest.mark.slow
def test_trainable_exponent_without_glossy_scene():
    """cfg.trainable_exponent keys the tracer SIGNATURE on the cfg alone:
    a scene with no glossy material still takes the exponent argument and
    returns identically-zero exponent gradients (no hidden arity switch)."""
    scene = builders.smallpt(width=8, height=8)
    cfg = wf.KernelConfig(max_depth=2, rows=8, trainable_exponent=True)
    tr = wf.make_pallas_diff_tracer(scene, cfg, interpret=True,
                                    backward="replay")
    n = 64
    pid = jnp.arange(n, dtype=jnp.int32)
    u = jax.random.uniform(jax.random.key(0), (n, 2))
    px = (pid % 8).astype(jnp.float32) + u[:, 0]
    py = (pid // 8).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    env0 = jnp.zeros(3, jnp.float32)

    def loss(ex):
        return jnp.mean(tr(scene.mat_diffuse, scene.mat_specular,
                           scene.emission, ex, env0, o, d, jnp.int32(5)))

    val = float(loss(scene.mat_exponent))
    g = np.asarray(jax.grad(loss)(scene.mat_exponent))
    assert np.isfinite(val)
    np.testing.assert_array_equal(g, 0.0)


@pytest.mark.slow
def test_prb_gradients_env_scene():
    """PRB replay handles the environment-light branch, including the
    d/d env_radiance adjoint (miss-emission term + env NEE)."""
    flags = builders.BOTH_SMALL_SPHERES | {builders.LIGHT_ENVIRONMENT,
                                           builders.LIGHT_AREA}
    scene = builders.cornell_box(flags, width=8, height=8)
    cfg = wf.KernelConfig(max_depth=2, rows=8)
    tracer = wf.make_pallas_diff_tracer(scene, cfg, interpret=True)

    n = 64
    key = jax.random.key(2)
    u = jax.random.uniform(key, (n, 2))
    pid = jnp.arange(n, dtype=jnp.int32)
    px = (pid % 8).astype(jnp.float32) + u[:, 0]
    py = (pid // 8).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    seed = jnp.int32(9)
    p0 = (scene.mat_diffuse, scene.mat_specular, scene.emission,
          scene.env_radiance_)

    def loss(diffuse, specular, emission, env):
        return jnp.mean(tracer(diffuse, specular, emission, env, o, d, seed))

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*p0)
    eps = 1e-2
    for argi, idx in [(0, (0, 0)), (0, (4, 2)), (3, (0,)), (3, (2,))]:
        ap = list(p0); am = list(p0)
        ap[argi] = p0[argi].at[idx].add(eps)
        am[argi] = p0[argi].at[idx].add(-eps)
        fd = (float(loss(*ap)) - float(loss(*am))) / (2 * eps)
        ad = float(g[argi][idx])
        assert np.isfinite(ad) and np.isfinite(fd)
        assert abs(ad - fd) <= 5e-3 * max(abs(fd), 1e-2), (argi, idx, ad, fd)
    # env radiance must actually receive gradient in an env-lit scene
    assert abs(float(g[3][0])) > 1e-5


def test_sobol_bit_machinery():
    """The in-kernel int32 Owen-Sobol primitives agree bitwise with the
    uint32 reference in core/lds.py where they implement the same map, and
    the (dim0, dim1) pair is a genuine (0,2)-sequence (every elementary
    interval of every 2^m-aligned block holds exactly one point), both raw
    and through the full shuffle+scramble path."""
    from kytpu.core import lds

    idx = np.random.default_rng(0).integers(0, 2**31, 2048).astype(np.int32)
    i_u32 = jnp.asarray(idx.view(np.uint32))
    i_i32 = jnp.asarray(idx)
    np.testing.assert_array_equal(
        np.asarray(wf._rev_bits(i_i32)).view(np.uint32),
        np.asarray(lds.reverse_bits(i_u32)))
    np.testing.assert_array_equal(
        np.asarray(wf._lk_hash(i_i32, np.int32(12345))).view(np.uint32),
        np.asarray(lds._laine_karras(i_u32, jnp.uint32(12345))))

    def assert_02(x, y, total):
        for m in range(0, 7):
            n = 1 << m
            for blk in range(total // n):
                xs, ys = x[blk * n:(blk + 1) * n], y[blk * n:(blk + 1) * n]
                for a in range(m + 1):
                    cells = set(zip((xs * (1 << a)).astype(int),
                                    (ys * (1 << (m - a))).astype(int)))
                    assert len(cells) == n, (m, blk, a)

    i = jnp.arange(256, dtype=jnp.int32)
    d0 = np.asarray(wf._rev_bits(i)).view(np.uint32) / 2**32
    d1 = np.asarray(wf._rev_bits(wf._superset_xor(i))).view(np.uint32) / 2**32
    assert_02(d0, d1, 256)

    ph = jnp.full((256,), np.int32(-1234567))
    rng = wf._Rng(np.int32(42), sobol=(i, ph))
    u1, u2 = rng.uniform2((256,))
    assert_02(np.asarray(u1), np.asarray(u2), 256)
    # 1D sites are stratified too
    u = np.asarray(rng.uniform((256,)))
    assert sorted(set((u * 256).astype(int))) == list(range(256))
    # distinct draw sites are decorrelated: same strata test must FAIL
    u1b, _ = rng.uniform2((256,))
    cells = set(zip((np.asarray(u1) * 16).astype(int),
                    (np.asarray(u1b) * 16).astype(int)))
    assert 150 < len(cells) < 256


@pytest.mark.slow
def test_sobol_kernel_render_matches_fast():
    """In-kernel Owen-Sobol render converges to the fast-integrator mean."""
    from kytpu.integrator.fast import FastConfig
    from kytpu.integrator.render import render

    scene = builders.cornell_box(width=16, height=16)
    img_k = np.asarray(wf.render_pallas(
        scene, spp=48, seed=3,
        cfg=wf.KernelConfig(max_depth=3, rows=8, sampler="sobol"),
        interpret=True))
    img_f = np.asarray(render(scene, spp=48, seed=5,
                              cfg=FastConfig(max_depth=3)))
    d4 = lambda a: a.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))  # noqa: E731
    err = np.abs(d4(img_k) - d4(img_f)).mean()
    assert err < 0.03, err


@pytest.mark.slow
def test_sobol_prb_gradients():
    """Replay backward re-draws the identical Owen-Sobol stream from
    (seed, sample index, pixel id): residual and replay backwards agree,
    and both match finite differences of the deterministic forward."""
    scene = builders.cornell_box(width=8, height=8)
    cfg = wf.KernelConfig(max_depth=3, rows=8, sampler="sobol")
    n = 64
    pid = jnp.arange(n, dtype=jnp.int32)
    si = jnp.full((n,), 2, jnp.int32)
    key = jax.random.key(0)
    u = jax.random.uniform(key, (n, 2))
    px = (pid % 8).astype(jnp.float32) + u[:, 0]
    py = (pid // 8).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    seed = jnp.int32(5)
    env0 = jnp.zeros(3, jnp.float32)
    p0 = (scene.mat_diffuse, scene.mat_specular, scene.emission)

    grads, losses = [], []
    for bw in ("residual", "replay"):
        tracer = wf.make_pallas_diff_tracer(scene, cfg, interpret=True,
                                            backward=bw)

        def loss(diffuse, specular, emission):
            return jnp.mean(tracer(diffuse, specular, emission, env0,
                                   o, d, seed, si, pid))

        val, g = jax.value_and_grad(loss, argnums=(0, 1, 2))(*p0)
        losses.append(float(val))
        grads.append(g)
        if bw == "replay":
            em = np.asarray(scene.emission)
            light_row = int(np.argmax(em.sum(axis=1)))
            eps = 1e-2
            for argi, idx in [(0, (2, 0)), (2, (light_row, 0))]:
                ap = list(p0); am = list(p0)
                ap[argi] = p0[argi].at[idx].add(eps)
                am[argi] = p0[argi].at[idx].add(-eps)
                fd = (float(loss(*ap)) - float(loss(*am))) / (2 * eps)
                ad = float(g[argi][idx])
                assert abs(ad - fd) <= 3e-3 * max(abs(fd), 1e-2), \
                    (argi, idx, ad, fd)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for a, b in zip(grads[0], grads[1]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-5)


@pytest.mark.slow
def test_trainable_exponent_forward_and_grad():
    """KernelConfig(trainable_exponent=True): the forward matches the
    baked-exponent kernel, and d/d exponent matches central FD exactly.

    Exactness construction (point light, depth 2, loss restricted to lanes
    whose PRIMARY hit is not the glossy floor): the floor is then reached
    only through e-independent sample maps (camera/lambert/delta), its NEE
    term uses a light-sampled wi (delta weight, no pdf_b), and its
    extension feeds the zero horizon (no area emitters) — so the detached
    estimator is exactly differentiable in e at common random numbers.
    With floor-primary lanes included, FD picks up the expectation-only
    sample-map term (~3% here), which detached AD intentionally excludes."""
    scene = builders.cornell_box(
        flags=builders.BOTH_SMALL_SPHERES | {builders.LIGHT_POINT},
        width=8, height=8)
    n = 64
    pid = jnp.arange(n, dtype=jnp.int32)
    u = jax.random.uniform(jax.random.key(0), (n, 2))
    px = (pid % 8).astype(jnp.float32) + u[:, 0]
    py = (pid // 8).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    seed = jnp.int32(5)
    env0 = jnp.zeros(3, jnp.float32)
    exp0 = scene.mat_exponent
    row = int(np.argmax(np.asarray(exp0)))
    assert float(exp0[row]) > 0

    cfg_t = wf.KernelConfig(max_depth=2, rows=8, trainable_exponent=True)
    cfg_b = wf.KernelConfig(max_depth=2, rows=8)
    tr_b = wf.make_pallas_diff_tracer(scene, cfg_b, interpret=True,
                                      backward="replay")
    out_b = tr_b(scene.mat_diffuse, scene.mat_specular, scene.emission,
                 env0, o, d, seed)

    # mask: lanes whose primary hit is NOT the glossy-floor surface
    hit0 = kscene.intersect(scene, o, d)
    keep = jnp.asarray(np.asarray(hit0.sid) != row)[:, None]

    ads = []
    for bw in ("replay", "residual"):
        tr_t = wf.make_pallas_diff_tracer(scene, cfg_t, interpret=True,
                                          backward=bw)
        out_t = tr_t(scene.mat_diffuse, scene.mat_specular, scene.emission,
                     exp0, env0, o, d, seed)
        np.testing.assert_allclose(np.asarray(out_t), np.asarray(out_b),
                                   rtol=2e-4, atol=1e-6)

        def loss(ex, tr=tr_t):
            out = tr(scene.mat_diffuse, scene.mat_specular,
                     scene.emission, ex, env0, o, d, seed)
            return jnp.mean(jnp.where(keep, out, 0.0))

        g = jax.grad(loss)(exp0)
        eps = 1.0
        fd = (float(loss(exp0.at[row].add(eps)))
              - float(loss(exp0.at[row].add(-eps)))) / (2 * eps)
        ad = float(g[row])
        ads.append(ad)
        assert np.isfinite(ad) and abs(fd) > 1e-9, (bw, ad, fd)
        assert abs(ad - fd) <= 2e-3 * max(abs(fd), 1e-7), (bw, ad, fd)
        # non-plastic rows have identically zero exponent gradient
        zero_rows = np.asarray(exp0) == 0
        np.testing.assert_array_equal(np.asarray(g)[zero_rows], 0.0)

        # color gradients through the trainable-exponent tracer still match
        # the baked tracer (same estimator, same stream)
        g_t = jax.grad(lambda dd: jnp.mean(
            tr_t(dd, scene.mat_specular, scene.emission, exp0, env0, o, d,
                 seed)))(scene.mat_diffuse)
        g_r = jax.grad(lambda dd: jnp.mean(
            tr_b(dd, scene.mat_specular, scene.emission, env0, o, d,
                 seed)))(scene.mat_diffuse)
        np.testing.assert_allclose(np.asarray(g_t), np.asarray(g_r),
                                   rtol=2e-3, atol=1e-7)
    # the two backwards are algebraic routes to the same exponent adjoint
    np.testing.assert_allclose(ads[0], ads[1], rtol=1e-4)


@pytest.mark.slow
def test_residual_backward_matches_replay():
    """The coefficient-cache backward (backward="residual") and the
    path-replay backward (backward="replay") are two algebraic routes to
    the SAME detached-sampling adjoint: identical forward radiance and
    near-identical (f32 rounding) gradients, across all-NEE, single-NEE
    and env-lit scenes."""
    cases = [
        (builders.cornell_box(width=8, height=8),
         wf.KernelConfig(max_depth=3, rows=8)),
        (builders.veach_mis(width=16, height=10),
         wf.KernelConfig(max_depth=3, rows=8, nee="single")),
        (builders.cornell_box(
            builders.BOTH_SMALL_SPHERES | {builders.LIGHT_ENVIRONMENT,
                                           builders.LIGHT_AREA},
            width=8, height=8),
         wf.KernelConfig(max_depth=2, rows=8)),
    ]
    for scene, cfg in cases:
        n = 64
        key = jax.random.key(4)
        u = jax.random.uniform(key, (n, 2))
        pid = jnp.arange(n, dtype=jnp.int32)
        w = scene.camera.width
        px = (pid % w).astype(jnp.float32) + u[:, 0]
        py = (pid // w).astype(jnp.float32) + u[:, 1]
        o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
        env0 = (scene.env_radiance_ if scene.has_env
                else jnp.zeros(3, jnp.float32))
        p0 = (scene.mat_diffuse, scene.mat_specular, scene.emission, env0)
        seed = jnp.int32(7)

        outs, grads = [], []
        for bw in ("residual", "replay"):
            tracer = wf.make_pallas_diff_tracer(scene, cfg, interpret=True,
                                                backward=bw)

            def loss(diffuse, specular, emission, env):
                return jnp.mean(tracer(diffuse, specular, emission, env,
                                       o, d, seed))

            val, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(*p0)
            outs.append(float(val))
            grads.append(g)
        # same forward estimator (identical RNG stream)
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5)
        for a, b in zip(grads[0], grads[1]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-3, atol=2e-5)


def test_v3_dot_constant_folding_semantics():
    """V3.dot folds exact-0 / +-1 CONSTANT components at trace time
    (compilers cannot fold x*0 under IEEE): results must equal the full dot
    bitwise for finite operands, the all-zero case must return a
    correctly-shaped zero, and const-const dots must stay scalars."""
    import numpy as np

    from kytpu.kernels import v3 as kv3
    from kytpu.kernels.v3 import V3

    rng = np.random.default_rng(0)
    w = V3(*(jnp.asarray(rng.standard_normal(64), jnp.float32)
             for _ in range(3)))
    for c in ((0.0, 1.0, 0.0), (0.0, 0.0, -1.0), (0.5, 0.0, -2.0),
              (1.0, 1.0, 1.0), (0.3, 0.7, -0.2)):
        cv = V3(np.float32(c[0]), np.float32(c[1]), np.float32(c[2]))
        folded = np.asarray(cv.dot(w))
        full = np.asarray(np.float32(c[0]) * np.asarray(w.x)
                          + np.float32(c[1]) * np.asarray(w.y)
                          + np.float32(c[2]) * np.asarray(w.z))
        np.testing.assert_array_equal(folded, full)
        # argument order must not matter
        np.testing.assert_array_equal(np.asarray(w.dot(cv)), folded)
    # all-zero constant: zero plane of the traced operand's shape
    z = V3(np.float32(0), np.float32(0), np.float32(0)).dot(w)
    assert np.asarray(z).shape == (64,) and not np.asarray(z).any()
    # const-const dot stays a scalar
    a = V3(np.float32(0), np.float32(2), np.float32(0))
    b = V3(np.float32(3), np.float32(4), np.float32(5))
    assert float(a.dot(b)) == 8.0
    # the helper itself: 0-const factors vanish, +-1 pass through
    assert kv3._cmul(0.0, w.x) is None
    assert kv3._cmul(1.0, w.x) is w.x
