"""Kernels compiled for the card against the same kernels in Pallas'
interpreter on the CPU device (identical hash-sampler streams).

Marked `gpu`: without a GPU the `gpu` fixture skips them. On the card run
`KYTPU_TEST_GPU=1 python -m pytest -o addopts="" -m gpu tests/test_gpu.py`
(python chip_smoke.py runs them in its own process)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kytpu.kernels import bigscene as bs
from kytpu.kernels import wavefront as wf
from kytpu.scene import builders
from kytpu.scene import scene as kscene

pytestmark = pytest.mark.gpu


def _lanes(scene, n):
    w, h = scene.camera.width, scene.camera.height
    lane = jnp.arange(n, dtype=jnp.int32)
    pid = lane % (w * h)
    u = jax.random.uniform(jax.random.key(0), (n, 2))
    px = (pid % w).astype(jnp.float32) + u[:, 0]
    py = (pid // w).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    return o, d, lane // (w * h), pid


def _on_cpu(fn, *args):
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return fn(*jax.device_put(args, cpu))


def _close_per_lane(a, b):
    a, b = np.asarray(a), np.asarray(b)
    rel = np.abs(a - b).max(-1) / np.maximum(np.abs(b).max(-1), 1e-3)
    assert np.isfinite(a).all()
    # branch flips on near-ties under FMA contraction: <= 0.1% of lanes
    assert (rel > 1e-3).mean() <= 1e-3, (rel > 1e-3).mean()


def test_baked_forward_matches_interpreter(gpu):
    scene = builders.cornell_box(width=64, height=64)
    o, d, si, pid = _lanes(scene, 8192)

    def run(scene, o, d, si, pid, interpret):
        cfg = wf.KernelConfig(max_depth=3, sampler="hash",
                              rows=8 if interpret else wf.KernelConfig().rows)
        tr = wf.make_pallas_tracer(scene, cfg, interpret=interpret)
        return tr(scene, o, d, jnp.int32(9), si, pid)

    _close_per_lane(run(scene, o, d, si, pid, False),
                    _on_cpu(lambda *a: run(*a, True), scene, o, d, si, pid))


def test_baked_vjp_matches_interpreter(gpu, backward="residual"):
    rng = np.random.default_rng(1)
    scene = builders.cornell_box(
        width=32, height=32, floor_checker=True,
        back_image=rng.uniform(0.2, 0.8, (24, 24, 3)).astype(np.float32))
    o, d, si, pid = _lanes(scene, 4096)

    def grads(scene, o, d, si, pid, interpret):
        cfg = wf.KernelConfig(max_depth=3, sampler="hash",
                              rows=8 if interpret else wf.KernelConfig().rows)
        tr = wf.make_pallas_diff_tracer(scene, cfg, interpret=interpret,
                                        backward=backward)
        env0 = jnp.zeros(3, jnp.float32)
        tex = (scene.textures.color_a, scene.textures.color_b,
               scene.textures.image)

        def loss(dif, emi, ta, tb, ti):
            return jnp.mean(tr(dif, scene.mat_specular, emi, ta, tb, ti,
                               env0, o, d, jnp.int32(2), si, pid))
        return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            scene.mat_diffuse, scene.emission, *tex)

    g_gpu = grads(scene, o, d, si, pid, False)
    g_cpu = _on_cpu(lambda *a: grads(*a, True), scene, o, d, si, pid)
    for a, b in zip(g_gpu, g_cpu):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 5e-3 * max(np.abs(b).max(), 1e-9)


def test_table_forward_matches_interpreter(gpu):
    scene = builders.random_spheres(n=100, width=32, height=32, seed=3)
    assert bs.use_table_kernel(scene)
    o, d, si, pid = _lanes(scene, 4096)

    def run(scene, o, d, si, pid, interpret):
        cfg = wf.KernelConfig(max_depth=3, sampler="hash",
                              rows=8 if interpret else wf.KernelConfig().rows)
        tr = bs.make_bigscene_tracer(scene, cfg, interpret=interpret)
        return tr(scene, o, d, jnp.int32(4), si, pid)

    _close_per_lane(run(scene, o, d, si, pid, False),
                    _on_cpu(lambda *a: run(*a, True), scene, o, d, si, pid))
