"""Headline benchmark: primary rays/s on one GPU, Veach MIS, depth 5.

Times the production Pallas megakernels (kytpu/kernels/wavefront.py for
the headline scene, kytpu/kernels/bigscene.py for random_spheres(1024))
against XLA's compile of the plain jnp fast engine (integrator/fast.py
through trace_lanes) at the same shapes, forward and forward+backward
(the backward differentiates the render w.r.t. the material/emission
tables: the kernels' residual VJP, XLA autodiff for the jnp engine).

  python bench.py                  # every measurement
  python bench.py --rows 1,2,4     # also sweep the kernels' block height

Prints one JSON line per measurement, each naming the device, the card and
its power limit; the LAST line is the headline (Veach forward+backward
through the baked kernel). Runs only on a GPU: without one it exits
non-zero, and a kernel that fails to compile fails the run. Each time is
the median over repeated calls, each ended by block_until_ready, after a
warm-up call that compiles; compile time is reported separately.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import jax
import jax.numpy as jnp

from kytpu.utils.compile_cache import enable_compile_cache
from kytpu.utils.device import device_record, require_gpu

LANES = 1 << 22
W, H = 512, 308
SPHERES = 1024
SPHERE_LANES = 1 << 20
REPEATS = 5


def _rays(scene, n):
    from kytpu.scene import scene as kscene

    w, h = scene.camera.width, scene.camera.height
    npix = w * h
    u = jax.random.uniform(jax.random.key(0), (n, 2))
    pid = jnp.arange(n, dtype=jnp.int32) % npix
    px = (pid % w).astype(jnp.float32) + u[:, 0]
    py = (pid // w).astype(jnp.float32) + u[:, 1]
    o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
    return jax.block_until_ready((o, d))


def _time(fn):
    """(compile-and-first-call seconds, median seconds per call)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(0))
    first = time.perf_counter() - t0
    times = []
    for i in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i + 1))
        times.append(time.perf_counter() - t0)
    return first, statistics.median(times)


def kernel_programs(scene, n, rows, table, interpret=False):
    """(fwd, fwd_bwd, args) for the baked or table kernel: jitted programs
    of explicit arguments — fwd(scene, o, d, seed) and
    fwd_bwd(diffuse, specular, emission, o, d, seed) — and the arguments
    they are timed on (chip_smoke.py compiles the same programs, so a
    shared compile cache serves both)."""
    from kytpu.kernels import bigscene as kbig
    from kytpu.kernels import wavefront as kwf

    cfg = kwf.KernelConfig(max_depth=5, rows=rows)
    mk_fwd = kbig.make_bigscene_tracer if table else kwf.make_pallas_tracer
    mk_diff = (kbig.make_bigscene_diff_tracer if table
               else kwf.make_pallas_diff_tracer)
    tracer = mk_fwd(scene, cfg, interpret=interpret)
    diff = mk_diff(scene, cfg, interpret=interpret)
    env0 = jnp.zeros(3, jnp.float32)

    @jax.jit
    def fwd_bwd(diffuse, specular, emission, o, d, seed):
        def loss(dd, ss, ee):
            return jnp.sum(diff(dd, ss, ee, env0, o, d, seed)) / n
        return jax.value_and_grad(loss, argnums=(0, 1, 2))(
            diffuse, specular, emission)

    o, d = _rays(scene, n)
    return tracer, fwd_bwd, (scene.mat_diffuse, scene.mat_specular,
                             scene.emission, o, d)


def _kernel(scene, n, rows, table):
    """(fwd, fwd+bwd) timing closures for the baked or table kernel."""
    tracer, fwd_bwd, (dif, spc, emi, o, d) = kernel_programs(scene, n, rows,
                                                             table)
    return (lambda i: tracer(scene, o, d, jnp.int32(i)),
            lambda i: fwd_bwd(dif, spc, emi, o, d, jnp.int32(i)))


def _jnp(scene, n, backward):
    from kytpu.diff.params import get_params, set_params
    from kytpu.integrator import fast as kfast
    from kytpu.integrator.render import trace_lanes

    cfg = kfast.FastConfig(max_depth=5)
    w, h = scene.camera.width, scene.camera.height
    pid = jnp.arange(n, dtype=jnp.int32) % (w * h)
    sid = jnp.zeros(n, jnp.int32)
    px = (pid % w).astype(jnp.float32)
    py = (pid // w).astype(jnp.float32)
    key = jax.random.key(1234)

    def fwd(params, k, px, py, pid, sid):
        out = trace_lanes(set_params(scene, params), k, px, py, pid, sid,
                          cfg, "fast", None)
        return jnp.sum(out) / n

    step = jax.jit(jax.value_and_grad(fwd) if backward else fwd)
    params = get_params(scene)
    return lambda i: step(params, jax.random.fold_in(key, i), px, py, pid,
                          sid)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="",
                    help="comma-separated kernel block heights to sweep "
                         "(default: the KernelConfig default only)")
    args = ap.parse_args()
    enable_compile_cache()
    require_gpu()
    from kytpu.kernels import wavefront as kwf
    from kytpu.scene import builders

    dev = device_record()
    default_rows = kwf.KernelConfig().rows
    rows_list = sorted({default_rows} | {int(r) for r in args.rows.split(",")
                                         if r})

    def emit(metric, n, first, per_call, engine, config):
        rec = {"metric": metric, "value": round(n / per_call, 1),
               "unit": "rays/s", "seconds_per_call": round(per_call, 6),
               "first_call_seconds": round(first, 3), "engine": engine,
               "config": config, "device": dev}
        print(json.dumps(rec), flush=True)
        return rec

    veach = builders.veach_mis(width=W, height=H)
    spheres = builders.random_spheres(SPHERES)
    vcfg = f"veach_mis {W}x{H}, {LANES} lanes, depth 5"
    scfg = (f"random_spheres({SPHERES}) 256x256, {SPHERE_LANES} lanes, "
            f"depth 5")
    emit("veach_fwd_rays_per_s", LANES, *_time(_jnp(veach, LANES, False)),
         "jnp_fast_xla", vcfg)
    emit("veach_fwd_bwd_rays_per_s", LANES,
         *_time(_jnp(veach, LANES, True)), "jnp_fast_xla", vcfg)
    emit("spheres_fwd_rays_per_s", SPHERE_LANES,
         *_time(_jnp(spheres, SPHERE_LANES, False)), "jnp_fast_xla", scfg)
    for rows in rows_list:
        fwd, fwd_bwd = _kernel(spheres, SPHERE_LANES, rows, table=True)
        emit("spheres_fwd_rays_per_s", SPHERE_LANES, *_time(fwd),
             "pallas_table", f"{scfg}, rows={rows}")
        emit("spheres_fwd_bwd_rays_per_s", SPHERE_LANES, *_time(fwd_bwd),
             "pallas_table_residual", f"{scfg}, rows={rows}")
    headline = None
    for rows in sorted(rows_list, key=lambda r: r == default_rows):
        fwd, fwd_bwd = _kernel(veach, LANES, rows, table=False)
        emit("veach_fwd_rays_per_s", LANES, *_time(fwd), "pallas_baked",
             f"{vcfg}, rows={rows}")
        headline = emit("veach_fwd_bwd_rays_per_s", LANES, *_time(fwd_bwd),
                        "pallas_baked_residual", f"{vcfg}, rows={rows}")
    # the default-rows headline is printed last
    assert headline["config"].endswith(f"rows={default_rows}")


if __name__ == "__main__":
    main()
