#!/usr/bin/env python3
"""On-card proof that the path tracer runs on one NVIDIA GPU.

Phases, in one process (one JAX process per card):

  device     JAX platform, device kind and count, card name and power limit
  compile    every Pallas kernel (Triton route) compiled at real width:
             compile seconds and XLA's memory analysis per program
  stream     same stream: the GPU kernels against the same kernels in
             Pallas' interpreter on the CPU device (hash sampler)
  reference  the baked kernel against the plain jnp engine (Veach MIS
             image and parameter gradients) within 3x the noise floor
             measured between two jnp seeds
  table      the table kernel on random_spheres(1024) against the jnp
             engine, same rule
  main       the main path through the entry points users call:
             render(engine="pallas") on the reference production frame
             and make_train_step(engine="pallas") steps
  tests      the `gpu`-marked pytest tests, run in this process

Usage:
  python chip_smoke.py                      # one GPU, every phase
  python chip_smoke.py --mesh4              # four GPUs: sharded render and
                                            # sharded train step only
  python chip_smoke.py --phases device,compile
  python chip_smoke.py --rehearse-cpu       # tiny sizes, interpret mode,
                                            # CPU; never prints a result

The last line printed is one JSON object: {"ok": ..., "device": {...}}.
Times are informational and printed beside the card's name and power
limit. A phase that fails makes the script exit non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

PHASES = ("device", "compile", "stream", "reference", "table", "main",
          "tests")

# real widths (the benchmark's headline shape and the deployments the
# main path serves) and the tiny rehearsal sizes
FULL = dict(
    veach=(512, 308), lanes=1 << 22, table_lanes=1 << 20, n_spheres=1024,
    sphere_film=(256, 256),
    stream_lanes=1 << 16, stream_table_lanes=1 << 14, stream_film=(256, 256),
    ref_spp=256, table_launches=4, frame=(1024, 1024), frame_spp=64,
    train_film=(256, 256), train_spp=64, train_steps=5,
    table_train_film=(256, 256), table_train_spp=16, table_train_steps=2,
    mesh_film=(256, 256), mesh_spp=8)
TINY = dict(
    veach=(32, 20), lanes=1 << 10, table_lanes=1 << 9, n_spheres=80,
    sphere_film=(16, 16),
    stream_lanes=1 << 9, stream_table_lanes=1 << 8, stream_film=(16, 16),
    ref_spp=8, table_launches=2, frame=(32, 32), frame_spp=4,
    train_film=(16, 16), train_spp=4, train_steps=3,
    table_train_film=(8, 8), table_train_spp=2, table_train_steps=2,
    mesh_film=(16, 16), mesh_spp=4)

# same-stream tolerance: per-lane relative error, and the share of lanes
# allowed past it (branch flips on near-ties under FMA contraction)
STREAM_RTOL = 1e-3
STREAM_BAD_SHARE = 1e-3
NOISE_FACTOR = 3.0


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self, args):
        self.args = args
        self.sz = TINY if args.rehearse_cpu else FULL
        self.interp = bool(args.rehearse_cpu)
        self.cfg_rows = None
        self.failed: list[str] = []

    # -- helpers ----------------------------------------------------------
    def stamp(self) -> str:
        return f"[{self.dev['kind']} | {self.card}]"

    def timed(self, fn, *a):
        import jax
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a))
        return out, time.perf_counter() - t0

    def rays(self, scene, n, seed=0):
        """n lanes over the film (pixel-major, sample index advancing per
        film pass) with a fixed jitter: (o, d, sample ids, pixel ids)."""
        import jax
        import jax.numpy as jnp
        from kytpu.scene import scene as kscene
        w, h = scene.camera.width, scene.camera.height
        npix = w * h
        lane = jnp.arange(n, dtype=jnp.int32)
        pid = lane % npix
        si = lane // npix
        u = jax.random.uniform(jax.random.key(seed), (n, 2))
        px = (pid % w).astype(jnp.float32) + u[:, 0]
        py = (pid // w).astype(jnp.float32) + u[:, 1]
        o, d = kscene.generate_rays(scene.camera, jnp.stack([px, py], -1))
        return o, d, si, pid

    # -- phases -----------------------------------------------------------
    def phase_device(self):
        import jax
        from kytpu.utils.device import card_info
        self.card = card_info()
        devs = jax.devices()
        self.dev = {"platform": devs[0].platform,
                    "kind": devs[0].device_kind, "count": len(devs)}
        log(f"device: platform={self.dev['platform']} "
            f"kind={self.dev['kind']} count={self.dev['count']}")
        log(f"card (nvidia-smi name, power.limit): {self.card}")
        if self.dev["platform"] != "gpu" and not self.args.rehearse_cpu:
            raise SystemExit("no GPU found: chip_smoke.py runs only on "
                             "the card")

    def _compile(self, label, jitted, *args):
        """Compile a jitted program (through the persistent cache, which
        bench.py then hits) and print seconds and memory analysis."""
        t0 = time.perf_counter()
        compiled = jitted.lower(*args).compile()
        dt = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
        stats = {f: getattr(mem, f, None) for f in fields} if mem else {}
        log(f"compile {label}: {dt:.1f} s  memory_analysis={stats}")
        return compiled

    def phase_compile(self):
        import jax
        import jax.numpy as jnp
        import bench
        from kytpu.kernels import bigscene as kbig
        from kytpu.kernels import wavefront as kwf
        from kytpu.scene import builders
        sz = self.sz
        cfg = kwf.KernelConfig(max_depth=5)
        self.cfg_rows = cfg.rows
        log(f"compile: KernelConfig(max_depth=5, rows={cfg.rows}, "
            f"sampler={cfg.sampler!r}), {kwf.NUM_WARPS} warps "
            f"{self.stamp()}")
        self.programs = {}
        self.diff_programs = {}
        for name, scene, n, table, mk_diff in (
                ("baked/veach", builders.veach_mis(*sz["veach"]),
                 sz["lanes"], False, kwf.make_pallas_diff_tracer),
                (f"table/random_spheres({sz['n_spheres']})",
                 builders.random_spheres(sz["n_spheres"], *sz["sphere_film"]),
                 sz["table_lanes"], True, kbig.make_bigscene_diff_tracer)):
            fwd, fwd_bwd, (dif, spc, emi, o, d) = bench.kernel_programs(
                scene, n, cfg.rows, table, interpret=self.interp)
            seed = jnp.int32(1)
            self._compile(f"{name} forward, {n} lanes", fwd, scene, o, d,
                          seed)
            self._compile(f"{name} forward+residual backward, {n} lanes",
                          fwd_bwd, dif, spc, emi, o, d, seed)
            replay = mk_diff(scene, cfg, backward="replay",
                             interpret=self.interp)
            env0 = jnp.zeros(3, jnp.float32)

            @jax.jit
            def fwd_replay(dif, spc, emi, o, d, seed, replay=replay):
                return jax.grad(lambda a, b, c: jnp.mean(
                    replay(a, b, c, env0, o, d, seed)),
                    argnums=(0, 1, 2))(dif, spc, emi)

            self._compile(f"{name} forward+replay backward, {n} lanes",
                          fwd_replay, dif, spc, emi, o, d, seed)
            self.programs[name] = (scene, fwd, o, d)
            self.diff_programs[name] = (fwd_bwd, (dif, spc, emi, o, d))

    def _stream_pair(self, label, mk, scene, n, rows_cpu):
        """A kernel compiled for the GPU against the same kernel in Pallas'
        interpreter on the CPU device, on the same n lanes with the hash
        sampler (per-lane streams keyed by seed, pixel, sample and site,
        so the CPU side may use another block height)."""
        import jax
        import jax.numpy as jnp
        import numpy as np
        from kytpu.kernels import wavefront as kwf
        cpu = jax.devices("cpu")[0]
        seed = jnp.int32(17)
        o, d, si, pid = self.rays(scene, n)

        def run(scene, o, d, si, pid, rows, interpret):
            cfg = kwf.KernelConfig(max_depth=5, sampler="hash", rows=rows)
            return mk(scene, cfg, interpret=interpret)(scene, o, d, seed,
                                                       si, pid)

        out_g, t_g = self.timed(run, scene, o, d, si, pid,
                                kwf.KernelConfig().rows, self.interp)
        with jax.default_device(cpu):
            args = jax.device_put((scene, o, d, si, pid), cpu)
            out_c, t_c = self.timed(run, *args, rows_cpu, True)
        g, c = np.asarray(out_g), np.asarray(out_c)
        rel = np.abs(g - c).max(-1) / np.maximum(np.abs(c).max(-1), 1e-3)
        bad = float((rel > STREAM_RTOL).mean())
        ok = bool(np.isfinite(g).all()) and bad <= STREAM_BAD_SHARE
        log(f"stream {label}: {n} lanes, hash sampler, f32; per-lane "
            f"rel=max_c|gpu-cpu|/max(max_c|cpu|,1e-3): share>{STREAM_RTOL:g}"
            f" = {bad:.2e} (limit {STREAM_BAD_SHARE:g}), max abs "
            f"{np.abs(g - c).max():.3e}  gpu {t_g:.1f} s, cpu interpret "
            f"{t_c:.1f} s (both incl. compile)  {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"stream {label} out of tolerance")

    def phase_stream(self):
        from kytpu.kernels import bigscene as kbig
        from kytpu.kernels import wavefront as kwf
        from kytpu.scene import builders
        sz = self.sz
        self._stream_pair(
            f"baked forward, cornell_box {sz['stream_film']}, depth 5",
            kwf.make_pallas_tracer, builders.cornell_box(
                width=sz["stream_film"][0], height=sz["stream_film"][1]),
            sz["stream_lanes"], 64)
        self._stream_pair(
            f"table forward, random_spheres({sz['n_spheres']}), depth 5",
            kbig.make_bigscene_tracer, builders.random_spheres(
                sz["n_spheres"], *sz["sphere_film"]),
            sz["stream_table_lanes"], 16)

    def _noise_rule(self, label, kernel, ref_a, ref_b, what):
        import numpy as np
        err = float(np.mean(np.abs(np.asarray(kernel) - np.asarray(ref_a))))
        floor = float(np.mean(np.abs(np.asarray(ref_a) - np.asarray(ref_b))))
        finite = bool(np.isfinite(np.asarray(kernel)).all())
        ok = finite and err <= NOISE_FACTOR * floor
        log(f"{label}: {what} mean|kernel-jnp| = {err:.4e}, noise floor "
            f"mean|jnp_a-jnp_b| = {floor:.4e}, limit {NOISE_FACTOR:g}x "
            f"floor; f32, reference under default_matmul_precision"
            f"('highest')  {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} {what} outside the noise rule")

    def _jnp_grads(self, scene, n, seed, chunk):
        """(d_diffuse, d_specular, d_emission) of sum(radiance)/n over the
        kernel programs' lanes (pixel = lane % npix), through the jnp fast
        engine's detached-sampling autodiff, in chunks of `chunk` lanes."""
        import jax
        import jax.numpy as jnp
        from kytpu.diff.params import set_params
        from kytpu.integrator import fast as kfast
        from kytpu.integrator.render import trace_lanes
        cfg = kfast.FastConfig(max_depth=5)
        w, h = scene.camera.width, scene.camera.height
        names = ("mat_diffuse", "mat_specular", "emission")

        @jax.jit
        def g(params, key, lane0):
            lane = lane0 + jnp.arange(chunk, dtype=jnp.int32)
            pid, sid = lane % (w * h), lane // (w * h)
            px = (pid % w).astype(jnp.float32)
            py = (pid // w).astype(jnp.float32)

            def loss(p):
                sc = set_params(scene, dict(zip(names, p)))
                out = trace_lanes(sc, key, px, py, pid, sid, cfg, "fast",
                                  None)
                return jnp.sum(out) / n
            return jax.grad(loss)(params)

        p0 = tuple(getattr(scene, k) for k in names)
        tot = None
        with jax.default_matmul_precision("highest"):
            for c in range(n // chunk):
                gc = g(p0, jax.random.key(seed), jnp.int32(c * chunk))
                tot = gc if tot is None else jax.tree.map(jnp.add, tot, gc)
        return jax.block_until_ready(tot)

    def _grad_rule(self, label, name, chunk):
        """The compiled real-width residual VJP (bench.kernel_programs)
        against jnp autodiff over the same lanes, two jnp seeds setting
        the noise floor."""
        import jax.numpy as jnp
        import numpy as np
        scene, _, o, d = self.programs[name]
        n = o.shape[0]
        fwd_bwd, args = self.diff_programs[name]
        (_, gk), t_k = self.timed(lambda: fwd_bwd(*args, jnp.int32(5)))
        ga, t_j = self.timed(lambda: self._jnp_grads(scene, n, 6, chunk))
        gb = self._jnp_grads(scene, n, 7, chunk)
        # the kernels define emission only on light-bound rows (elsewhere
        # it is structurally zero and gets no adjoint); the jnp engine
        # differentiates every row's emission, so compare the rows both
        # define
        lit = np.asarray(scene.light_index) >= 0
        flat = [np.concatenate([np.asarray(g[0]).ravel(),
                                np.asarray(g[1]).ravel(),
                                np.asarray(g[2])[lit].ravel()])
                for g in (gk, ga, gb)]
        log(f"{label}: kernel residual VJP {t_k:.1f} s, jnp autodiff "
            f"{t_j:.1f} s (incl. compile) {self.stamp()}")
        self._noise_rule(label, flat[0], flat[1], flat[2],
                         f"gradients of sum(radiance)/{n} over {n} lanes "
                         f"(diffuse, specular, emission of light rows)")

    def _image_rule(self, label, scene, spp, kernel_img):
        import jax
        from kytpu.integrator import fast as kfast
        from kytpu.integrator.render import render
        with jax.default_matmul_precision("highest"):
            refs = []
            for seed in (21, 22):
                img, t_j = self.timed(lambda s=seed: render(
                    scene, spp=spp, seed=s, mode="fast",
                    cfg=kfast.FastConfig(max_depth=5), clamp=False,
                    rays_per_pass=self.sz["lanes"]))
                refs.append(img)
        w, h = scene.camera.width, scene.camera.height
        log(f"{label}: {w}x{h} @ {spp} spp, depth 5; jnp render "
            f"{t_j:.1f} s {self.stamp()}")
        self._noise_rule(label, kernel_img, refs[0], refs[1], "image")

    def phase_reference(self):
        from kytpu.integrator.render import render
        from kytpu.scene import builders
        sz = self.sz
        if not hasattr(self, "programs"):
            self.phase_compile()
        scene = builders.veach_mis(*sz["veach"])
        img, t = self.timed(lambda: render(
            scene, spp=sz["ref_spp"], seed=11, engine="pallas", clamp=False))
        log(f"reference veach_mis: render(engine='pallas', spp="
            f"{sz['ref_spp']}) {t:.1f} s (incl. compile) {self.stamp()}")
        self._image_rule("reference veach_mis", scene, sz["ref_spp"], img)
        self._grad_rule("reference veach_mis", "baked/veach",
                        sz["lanes"] // 4)

    def phase_table(self):
        import jax.numpy as jnp
        from kytpu.scene import builders
        sz = self.sz
        if not hasattr(self, "programs"):
            self.phase_compile()
        name = f"table/random_spheres({sz['n_spheres']})"
        scene, fwd, o, d = self.programs[name]
        w, h = scene.camera.width, scene.camera.height
        n = o.shape[0]
        per = n // (w * h)          # samples per pixel in one launch
        acc = None
        for s in range(sz["table_launches"]):
            out = fwd(scene, o, d, jnp.int32(100 + s)).reshape(per, h, w, 3)
            acc = out.sum(0) if acc is None else acc + out.sum(0)
        img = acc / float(per * sz["table_launches"])
        self._image_rule(f"table random_spheres({sz['n_spheres']})",
                         scene,
                         per * sz["table_launches"], img)
        self._grad_rule(f"table random_spheres({sz['n_spheres']})", name, n)

    def _train(self, label, scene, spp, steps, names, scale):
        import jax
        import jax.numpy as jnp
        import numpy as np
        from kytpu.diff import get_params, set_params
        from kytpu.diff.inverse import make_train_step
        from kytpu.integrator.path import PathConfig
        from kytpu.integrator.render import render
        cfg = PathConfig(max_depth=5)
        target = render(scene, spp=4 * spp, seed=1, engine="pallas",
                        clamp=False)
        true = get_params(scene, names)
        wrong = set_params(scene, {k: v * s for (k, v), s in
                                   zip(true.items(), scale)})
        step, params, opt = make_train_step(wrong, target, spp=spp, cfg=cfg,
                                            engine="pallas", names=names,
                                            interpret=self.interp)
        key = jax.random.key(3)   # fixed samples: the loss tracks params
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, key)
            jax.block_until_ready(params)
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        err0 = sum(float(jnp.abs(wrong_v - true[k]).mean())
                   for k, wrong_v in get_params(wrong, names).items())
        err1 = sum(float(jnp.abs(params[k] - true[k]).mean())
                   for k in names)
        w, h = scene.camera.width, scene.camera.height
        ok = bool(np.isfinite(losses).all()) and losses[-1] < losses[0]
        log(f"main {label}: {w}x{h} @ {spp} spp/step, {steps} steps "
            f"make_train_step(engine='pallas', names={names}); losses "
            + " ".join(f"{v:.5f}" for v in losses)
            + f"; mean|param-true| {err0:.4f} -> {err1:.4f}; step times "
            + " ".join(f"{t:.2f}" for t in times)
            + f" s (first incl. compile) {self.stamp()}  "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: loss did not fall")

    def phase_main(self):
        import numpy as np
        from kytpu.integrator.render import render
        from kytpu.scene import builders
        sz = self.sz
        fw, fh = sz["frame"]
        scene = builders.cornell_box(width=fw, height=fh)
        _, t_c = self.timed(lambda: render(scene, spp=4, engine="pallas"))
        img, t = self.timed(lambda: render(scene, spp=sz["frame_spp"],
                                           engine="pallas"))
        img = np.asarray(img)
        ok = img.shape == (fh, fw, 3) and bool(np.isfinite(img).all()) \
            and 0.02 < float(img.mean()) < 0.9
        log(f"main frame: render(cornell_box({fw},{fh}), "
            f"spp={sz['frame_spp']}, engine='pallas'), depth 5, both-MIS: "
            f"{t:.2f} s ({fw * fh * sz['frame_spp'] / t / 1e6:.1f} M "
            f"camera rays/s; 4-spp warm-up incl. compile {t_c:.1f} s), "
            f"mean {img.mean():.4f} {self.stamp()}  "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("production frame out of range")
        tw, th = sz["train_film"]
        self._train("cornell albedo+emission",
                    builders.cornell_box(width=tw, height=th),
                    sz["train_spp"], sz["train_steps"],
                    ("mat_diffuse", "emission"), (0.5, 0.6))
        tw, th = sz["table_train_film"]
        self._train(f"random_spheres({sz['n_spheres']}) albedo",
                    builders.random_spheres(sz["n_spheres"], tw, th),
                    sz["table_train_spp"], sz["table_train_steps"],
                    ("mat_diffuse",), (0.5,))

    def phase_tests(self):
        import pytest
        os.environ["KYTPU_TEST_GPU"] = "1"
        here = os.path.dirname(os.path.abspath(__file__))
        rc = pytest.main(["-q", "-o", "addopts=", "-p", "no:cacheprovider",
                          "-m", "gpu", os.path.join(here, "tests",
                                                    "test_gpu.py")])
        log(f"tests: pytest -m gpu tests/test_gpu.py exit code {int(rc)}")
        if int(rc) != 0:
            raise AssertionError("gpu-marked tests failed")

    def phase_mesh4(self):
        import jax
        import jax.numpy as jnp
        import numpy as np
        from kytpu.diff.inverse import make_train_step
        from kytpu.dist.mesh import make_mesh
        from kytpu.dist.shard import render_sharded_pallas
        from kytpu.integrator.path import PathConfig
        from kytpu.integrator.render import render
        from kytpu.kernels import wavefront as kwf
        from kytpu.scene import builders
        from kytpu.diff import get_params, set_params
        devs = jax.devices()
        if len(devs) < 4 and not self.args.rehearse_cpu:
            raise AssertionError(f"--mesh4 needs 4 devices, have "
                                 f"{len(devs)}")
        mesh = make_mesh(devs[:4], shape=(2, 2))
        w, h = self.sz["mesh_film"]
        spp = self.sz["mesh_spp"]
        scene = builders.cornell_box(width=w, height=h)
        img_s, t_s = self.timed(lambda: render_sharded_pallas(
            scene, mesh, spp=spp, seed=3, clamp=False,
            interpret=self.interp))
        img_u, t_u = self.timed(lambda: kwf.render_pallas(
            scene, spp=spp, seed=3, clamp=False, interpret=self.interp,
            cfg=kwf.KernelConfig(sampler="hash")))
        img_s, img_u = np.asarray(img_s), np.asarray(img_u)
        diff = float(np.abs(img_s - img_u).max())
        ok_img = bool(np.allclose(img_s, img_u, rtol=1e-5, atol=1e-6))
        log(f"mesh4 render_sharded_pallas {dict(mesh.shape)} {w}x{h} @ "
            f"{spp} spp vs single-device hash render: max|diff| "
            f"{diff:.3e} (f32 reduction order: rtol 1e-5, atol 1e-6); "
            f"sharded {t_s:.1f} s, single {t_u:.1f} s (incl. compile) "
            f"{self.stamp()}  {'PASS' if ok_img else 'FAIL'}")
        cfg = PathConfig(max_depth=3)
        target = render(scene, spp=spp, seed=1, engine="pallas",
                        clamp=False)
        names = ("mat_diffuse", "emission")
        wrong = set_params(scene, {k: v * 0.6 for k, v in
                                   get_params(scene, names).items()})
        key = jax.random.key(1)
        step_m, p_m, o_m = make_train_step(
            wrong, target, spp=spp, cfg=cfg, mesh=mesh, engine="pallas",
            names=names, interpret=self.interp)
        p_m, o_m, loss_m = step_m(p_m, o_m, key)
        step_u, p_u, o_u = make_train_step(
            wrong, target, spp=spp, cfg=cfg, engine="pallas", names=names,
            kernel_sampler="hash", interpret=self.interp)
        p_u, o_u, loss_u = step_u(p_u, o_u, key)
        pdiff = max(float(jnp.abs(p_m[k] - p_u[k]).max()) for k in names)
        ok_train = bool(jnp.isclose(loss_m, loss_u, rtol=1e-5)) \
            and pdiff <= 1e-5
        log(f"mesh4 sharded make_train_step vs single-device hash step: "
            f"loss {float(loss_m):.6f} vs {float(loss_u):.6f}, max|param "
            f"diff| {pdiff:.2e} (limit 1e-5)  "
            f"{'PASS' if ok_train else 'FAIL'}")
        if not (ok_img and ok_train):
            raise AssertionError("mesh4 disagrees with single device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="four GPUs: the sharded render and train step "
                         "against single-device runs, and nothing else")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="tiny sizes in interpret mode on the CPU (never "
                         "prints a result)")
    args = ap.parse_args(argv)
    if args.rehearse_cpu:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        if args.mesh4:
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                       " --xla_force_host_platform_device"
                                       "_count=4").strip()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from kytpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    smoke = Smoke(args)
    smoke.phase_device()     # exits non-zero without a GPU
    phases = ["mesh4"] if args.mesh4 else \
        [p for p in args.phases.split(",") if p and p != "device"]
    for name in phases:
        if name not in PHASES + ("mesh4",):
            raise SystemExit(f"unknown phase {name!r}")
        t0 = time.perf_counter()
        log(f"--- phase {name}")
        try:
            getattr(smoke, f"phase_{name}")()
        except Exception:
            traceback.print_exc()
            smoke.failed.append(name)
            log(f"--- phase {name} FAILED after "
                f"{time.perf_counter() - t0:.1f} s")
        else:
            log(f"--- phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    if args.rehearse_cpu:
        log(f"rehearsal done; failed phases: {smoke.failed or 'none'}")
        return 3 if not smoke.failed else 1
    print(json.dumps({"ok": not smoke.failed, "device": smoke.dev}),
          flush=True)
    return 0 if not smoke.failed else 1


if __name__ == "__main__":
    sys.exit(main())
