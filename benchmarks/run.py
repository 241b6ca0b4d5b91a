"""Multi-config benchmark report (BASELINE.json's `configs`).

Runs the production configurations on one GPU and prints one JSON line
per config, each naming the device, the card and its power limit:

  python benchmarks/run.py [--quick] [--scale]

Each time is the median over calls ended by block_until_ready, after a
warm-up call that compiles. Without a GPU the script exits non-zero.

Configs (BASELINE.md):
  1. cornell64   — smallpt-style Cornell, 256x256 @ 64 spp render throughput
  2. veach256    — Veach MIS 512x308 @ 256 spp-equivalent fwd rays/s
  3. veach_fwd_bwd — the headline (same as bench.py)
  4. aov         — deterministic AOV pass throughput
  5. inverse_step — one inverse-rendering optimization step (fwd+bwd+adam)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from kytpu.utils.compile_cache import enable_compile_cache
from kytpu.utils.device import device_record, require_gpu


def _time(fn, n=4):
    """Median seconds per call of fn(i) (an i-dependent seed or key), each
    call ended by block_until_ready, after one warm-up call that
    compiles."""
    jax.block_until_ready(fn(0))
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(1 + i))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller passes (CI smoke)")
    ap.add_argument("--scale", action="store_true",
                    help="scene-scale sweep: jnp-engine rays/s vs sphere "
                         "count (random_spheres scenes)")
    args = ap.parse_args()
    enable_compile_cache()
    require_gpu()
    dev = device_record()

    from kytpu.diff import get_params
    from kytpu.diff.inverse import make_train_step, render_once
    from kytpu.integrator.path import PathConfig
    from kytpu.integrator.render import render
    from kytpu.kernels import wavefront as kwf
    from kytpu.scene import builders, scene as kscene

    results = []
    quick = args.quick

    if args.scale:
        # scene-scale sweep: the closest-hit is a vectorized O(N) sweep;
        # this measures the rays/s falloff with surface count on the jnp
        # fast engine and the table megakernel
        from kytpu.integrator.fast import FastConfig
        from kytpu.integrator.render import trace_lanes
        n_lanes = 1 << (18 if quick else 20)
        sizes = (16, 64, 256) if quick else (16, 64, 256, 1024)
        for n_sph in sizes:
            # at the largest size also measure the opt-in grid DDA against
            # the production dense sweep
            accels = (None,) if n_sph < 1024 or quick else (None, "grid")
            for accel in accels:
                sc = builders.random_spheres(n=n_sph, width=256, height=256,
                                             accel=accel)
                npix = 256 * 256
                pid = jnp.arange(n_lanes, dtype=jnp.int32) % npix
                sid = jnp.zeros(n_lanes, jnp.int32)
                px = (pid % 256).astype(jnp.float32)
                py = (pid // 256).astype(jnp.float32)
                key = jax.random.key(1)
                fn = jax.jit(lambda k, sc=sc: trace_lanes(
                    sc, k, px, py, pid, sid, FastConfig(max_depth=3),
                    "fast", None))
                dt = _time(lambda i: fn(jax.random.fold_in(key, i)),
                           n=2)
                kind = "grid" if sc.accel is not None else "sweep"
                results.append(dict(
                    metric=f"scale_{n_sph}_spheres_{kind}_rays_per_s",
                    value=n_lanes / dt, unit="rays/s",
                    config=f"{sc.geometry.n_surfaces} surfaces, depth 3, "
                           f"{n_lanes} lanes, jnp fast, accel={kind}"))
            if n_sph >= 256:
                # table-driven megakernel (kernels/bigscene.py): O(1)
                # compile in N, the production path at this scale
                from kytpu.kernels import bigscene as kbig
                sc = builders.random_spheres(n=n_sph, width=256, height=256)
                o, d = kscene.generate_rays(
                    sc.camera, jnp.stack([px + 0.5, py + 0.5], axis=-1))
                big = kbig.make_bigscene_tracer(
                    sc, kwf.KernelConfig(max_depth=3))
                dt = _time(lambda i, sc=sc, big=big, o=o, d=d:
                           big(sc, o, d, i), n=2)
                results.append(dict(
                    metric=f"scale_{n_sph}_spheres_bigscene_rays_per_s",
                    value=n_lanes / dt, unit="rays/s",
                    config=f"{sc.geometry.n_surfaces} surfaces, depth 3, "
                           f"{n_lanes} lanes, table megakernel"))
        for r in results:
            r["value"] = round(float(r["value"]), 6 if r["unit"] == "s" else 2)
            r["device"] = dev
            print(json.dumps(r))
        return

    # 1. cornell render throughput (megakernel, full frame)
    size = 128 if quick else 256
    spp = 16 if quick else 64
    scene = builders.cornell_box(width=size, height=size)
    kcfg = kwf.KernelConfig(max_depth=5)
    dt = _time(lambda i: kwf.render_pallas(scene, spp=spp, seed=1 + i,
                                           cfg=kcfg), n=8)
    rays = size * size * spp
    results.append(dict(metric="cornell_render_rays_per_s", value=rays / dt,
                        unit="rays/s", config=f"{size}x{size}@{spp}spp"))

    # 2. veach forward rays/s at production batch
    scene_v = builders.veach_mis(width=512, height=308)
    tracer = kwf.make_pallas_tracer(scene_v, kcfg)
    n = 1 << (20 if quick else 22)
    npix = 512 * 308
    key = jax.random.key(0)
    u = jax.random.uniform(key, (n, 2))
    pid = jnp.arange(n, dtype=jnp.int32) % npix
    px = (pid % 512).astype(jnp.float32) + u[:, 0]
    py = (pid // 512).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene_v.camera, jnp.stack([px, py], -1))
    jax.block_until_ready((o, d))
    dt = _time(lambda i: tracer(scene_v, o, d, jnp.int32(3 + i)))
    results.append(dict(metric="veach_fwd_rays_per_s", value=n / dt,
                        unit="rays/s", config=f"{n} lanes, depth 5"))

    # 3. AOV pass (deterministic geometry oracle)
    dt = _time(lambda i: render(scene_v, spp=4, seed=1 + i, mode="aov",
                                aov="normal"), n=8)
    results.append(dict(metric="aov_normal_rays_per_s",
                        value=npix * 4 / dt, unit="rays/s",
                        config="512x308@4spp"))

    # 4. one inverse-rendering step through the kernel backward
    size_i = 32 if quick else 64
    scene_i = builders.cornell_box(width=size_i, height=size_i)
    cfg_i = PathConfig(max_depth=3)
    target = jax.lax.stop_gradient(
        render_once(scene_i, jax.random.key(7), spp=2, cfg=cfg_i))
    step, params, opt = make_train_step(scene_i, target, spp=4, cfg=cfg_i,
                                        engine="pallas")
    k = jax.random.key(0)

    def one(i):
        p2, o2, loss = step(params, opt, jax.random.fold_in(k, i))
        return loss
    dt = _time(one)
    results.append(dict(metric="inverse_step_seconds", value=dt, unit="s",
                        config=f"cornell {size_i}^2 @4spp depth3 residual"))

    for r in results:
        r["value"] = round(float(r["value"]), 6 if r["unit"] == "s" else 2)
        r["device"] = dev
        print(json.dumps(r))


if __name__ == "__main__":
    main()
