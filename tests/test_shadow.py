"""Shadow modes: reference-parity self-occlusion quirk vs robust NEE.

The reference measures a shadow ray's tmax from the UNOFFSET shading point
while tracing from the origin offset +-1e-2 along the normal (ky.cpp:3193 +
614), so the sampled light's own surface re-enters the shadow window
whenever n.wi > ~0.2 — light-sampled NEE silently dies on surfaces facing a
light frontally. kytpu replicates that by default (shadow="parity", proven
pixel parity) and offers shadow="robust" (tmax from the actual offset
origin) as the physically-correct opt-in in every engine.

The oracle for robustness: the BSDF-sampled direct-light estimator never
traces capped shadow rays, so it is immune to the quirk. Robust
light-sampled means must match BSDF-sampled means; parity means must not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kytpu.integrator import fast as kfast
from kytpu.integrator import path as kpath
from kytpu.light import lights as klights
from kytpu.scene import builders
from kytpu.scene import scene as kscene

N = 8192


def _plane_under_sphere_light():
    """One matte ground rect + one overhead sphere light, no env: every
    shading normal faces the light frontally (n.wi ~ 0.5-1), the regime
    where the parity quirk kills 100% of light-sampled NEE."""
    m = builders._SceneAssembler
    a = builders._SceneAssembler()
    g = a.geo
    a.surface(g.add_rectangle((-4, 0, -4), (-4, 0, 4), (4, 0, 4), (4, 0, -4)),
              m.matte(jnp.full(3, 0.7)))
    emit = jnp.full(3, 6.0)
    c_l, r_l = (0.0, 2.5, 0.0), 1.0
    slot = a.add_light(kind=klights.AREA_SPHERE, emit=emit,
                       center=np.asarray(c_l), radius=r_l,
                       surface_handle=None)
    h = a.surface(g.add_sphere(c_l, r_l), m.matte(jnp.zeros(3)),
                  emission=emit, light_slot=slot)
    a._lights[slot]["surface_handle"] = h
    cam = kscene.make_camera(position=(0.0, 1.5, 6.0), front=(0.0, -0.25, -1.0),
                             up=(0.0, 1.0, 0.0), fov_degrees=45.0,
                             width=16, height=16)
    return a.build(cam)


@pytest.fixture(scope="module")
def scene():
    return _plane_under_sphere_light()


def _ground_rays(scene, n):
    """Downward rays hitting the ground BESIDE the light's silhouette (so
    no lane collects bounce-0 emission; everything below is direct/indirect
    transport). n.wi toward the light stays in (0.5, 0.9): squarely inside
    the quirk's occlusion regime."""
    key = jax.random.key(7)
    u = jax.random.uniform(key, (n, 2))
    ox = 1.5 + u[:, 0] * 2.0
    oz = (u[:, 1] - 0.5) * 3.0
    o = jnp.stack([ox, jnp.full((n,), 4.0), oz], -1)
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (n, 3))
    return o, d


def _li_mean(scene, o, d, cfg, mode="path"):
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.key(3), jnp.arange(o.shape[0]))
    if mode == "fast":
        out = kfast.li_path_fast(scene, o, d, keys, cfg)
    else:
        out = kpath.li_path(scene, o, d, keys, cfg, None)
    return float(jnp.mean(out))


class TestJnpEngines:
    def test_parity_quirk_kills_frontal_light_sampling(self, scene):
        o, d = _ground_rays(scene, N)
        cfg = kpath.PathConfig(max_depth=1, strategy="light")
        m_parity = _li_mean(scene, o, d, cfg)
        m_robust = _li_mean(scene, o, d,
                            dataclasses.replace(cfg, shadow="robust"))
        # the quirk occludes ~94% of cone samples here (only rim samples,
        # where the offset pushes the shifted ray off the sphere, survive);
        # robust occludes none
        assert m_parity < 0.25 * m_robust
        assert m_robust > 0.05

    def test_robust_light_matches_bsdf_oracle(self, scene):
        o, d = _ground_rays(scene, N)
        m_light = _li_mean(scene, o, d, kpath.PathConfig(
            max_depth=1, strategy="light", shadow="robust"))
        m_bsdf = _li_mean(scene, o, d, kpath.PathConfig(
            max_depth=1, strategy="bsdf"))
        np.testing.assert_allclose(m_light, m_bsdf, rtol=0.06)

    def test_fast_engine_robust_matches_path(self, scene):
        o, d = _ground_rays(scene, N)
        m_fast = _li_mean(scene, o, d,
                          kfast.FastConfig(max_depth=1, shadow="robust"),
                          mode="fast")
        m_path = _li_mean(scene, o, d, kpath.PathConfig(
            max_depth=1, strategy="both_mis", shadow="robust"))
        np.testing.assert_allclose(m_fast, m_path, rtol=0.06)

    def test_robust_unbiased_at_depth(self, scene):
        # full transport: robust both_mis == robust bsdf-only expectation
        o, d = _ground_rays(scene, N)
        m_mis = _li_mean(scene, o, d, kpath.PathConfig(
            max_depth=3, strategy="both_mis", shadow="robust"))
        m_bsdf = _li_mean(scene, o, d, kpath.PathConfig(
            max_depth=3, strategy="bsdf"))
        np.testing.assert_allclose(m_mis, m_bsdf, rtol=0.08)


class TestKernels:
    def test_wavefront_kernel_robust_matches_jnp(self, scene):
        from kytpu.kernels import wavefront as wf
        o, d = _ground_rays(scene, 4096)
        cfg = wf.KernelConfig(max_depth=1, shadow="robust")
        tracer = wf.make_pallas_tracer(scene, cfg, interpret=True)
        out_k = np.asarray(tracer(scene, o, d, jnp.int32(11)))
        m_jnp = _li_mean(scene, o, d,
                         kfast.FastConfig(max_depth=1, shadow="robust"),
                         mode="fast")
        np.testing.assert_allclose(out_k.mean(), m_jnp, rtol=0.08)
        # and the kernel's parity mode keeps the quirk
        tracer_p = wf.make_pallas_tracer(scene, wf.KernelConfig(max_depth=1),
                                         interpret=True)
        out_p = np.asarray(tracer_p(scene, o, d, jnp.int32(11)))
        assert out_p.mean() < 0.3 * out_k.mean()

    def test_bigscene_kernel_robust_matches_jnp(self):
        from kytpu.kernels import bigscene as bs
        from kytpu.kernels import wavefront as wf
        scene = builders.random_spheres(n=24, width=24, height=24, seed=1)
        key = jax.random.key(0)
        u = jax.random.uniform(key, (2048, 2))
        w, h = scene.camera.width, scene.camera.height
        pid = jnp.arange(2048, dtype=jnp.int32) % (w * h)
        px = (pid % w).astype(jnp.float32) + u[:, 0]
        py = (pid // w).astype(jnp.float32) + u[:, 1]
        o, d = kscene.generate_rays(scene.camera,
                                    jnp.stack([px, py], -1))
        cfg = wf.KernelConfig(max_depth=1, shadow="robust")
        tr = bs.make_bigscene_tracer(scene, cfg, interpret=True)
        out = np.asarray(tr(scene, o, d, jnp.int32(5)))
        m_jnp = _li_mean(scene, o, d,
                         kfast.FastConfig(max_depth=1, shadow="robust"),
                         mode="fast")
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out.mean(), m_jnp, rtol=0.1)
