"""Inverse rendering: differentiable render, loss, and optimization steps.

The estimator uses detached sampling (every sampled direction, pdf, lobe and
RR decision is stop_gradient-ed in kytpu.integrator.path / light.nee), so
the gradient of the Monte Carlo estimate w.r.t. material colors, emission
and light radiance is itself an unbiased estimate of the gradient of the
true radiance — the standard differentiable-path-tracing construction.

`make_train_step` returns one fully-jitted optimization step. With a mesh it
becomes the pod-sharded training step: pixels sharded over "tile", samples
over "spp", scene parameters replicated; the shard_map transpose emits the
psum over parameter gradients, and the loss is computed on tile-local film
strips so the film never crosses the mesh.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from kytpu.diff import losses as klosses
from kytpu.diff.params import get_params, set_params
from kytpu.integrator import path as kpath
from kytpu.integrator.render import trace_lanes


def _lane_ids(w: int, h: int, spp: int):
    npix = w * h
    pid = jnp.tile(jnp.arange(npix, dtype=jnp.int32), spp)
    sid = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)
    px = (pid % w).astype(jnp.float32)
    py = (pid // w).astype(jnp.float32)
    return px, py, pid, sid


def render_once(scene, key, spp: int, cfg: kpath.PathConfig):
    """Single-pass traced render -> (H, W, 3), unclamped (differentiable)."""
    w, h = scene.camera.width, scene.camera.height
    px, py, pid, sid = _lane_ids(w, h, spp)
    out = trace_lanes(scene, key, px, py, pid, sid, cfg, "path", None)
    return out.reshape(spp, h, w, 3).mean(axis=0)


def render_loss(params, scene, target, key, spp: int,
                cfg: kpath.PathConfig, loss_fn=klosses.relmse):
    img = render_once(set_params(scene, params), key, spp, cfg)
    return loss_fn(img, target)


def _sharded_loss(params, scene, target_flat, key, px, py, pid, sid,
                  spp, cfg, loss_fn, mesh):
    """Loss over tile-local film strips; scalar is psum-reduced implicitly
    by the replicated out_spec (mean of per-tile means over equal strips)."""

    def body(params, scene, target_flat, key, px, py, pid, sid):
        sc = set_params(scene, params)
        s_loc, p_loc = sid.shape[0], pid.shape[0]
        out = trace_lanes(sc, key,
                          jnp.tile(px, s_loc), jnp.tile(py, s_loc),
                          jnp.tile(pid, s_loc), jnp.repeat(sid, p_loc),
                          cfg, "path", None)
        partial = out.reshape(s_loc, p_loc, 3).sum(axis=0)
        img = jax.lax.psum(partial, "spp") / float(spp)
        loss_tile = loss_fn(img, target_flat)
        return jax.lax.pmean(loss_tile, "tile")

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P("tile"), P(), P("tile"), P("tile"),
                  P("tile"), P("spp")),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, scene, target_flat, key, px, py, pid, sid)


def make_train_step(scene, target, spp: int = 4,
                    cfg: kpath.PathConfig | None = None,
                    optimizer=None, loss_fn=klosses.relmse, mesh=None,
                    engine: str = "jnp", param_spaces: dict | None = None,
                    names: tuple | None = None,
                    kernel_sampler: str | None = None,
                    interpret: bool | None = None):
    """Build (step, params0, opt_state0).

    step(params, opt_state, key) -> (params, opt_state, loss); jitted.
    With `mesh`, the whole step runs SPMD over ("tile", "spp").
    engine="pallas" differentiates through the megakernel's coefficient-
    cache/path-replay backward instead of XLA autodiff. With a mesh it is
    the pod-sharded production step (SURVEY.md §2.3's psum-grad design on
    the fast engine): lanes shard over ("tile", "spp") exactly like
    dist.shard.render_sharded_pallas, the per-pixel partials psum over
    "spp", the loss is computed on tile-local film strips, and the
    shard_map transpose of the replicated parameter tables emits one psum
    over the kernel-computed gradients.
    `kernel_sampler` (engine="pallas") picks the in-kernel sampler:
    default "random" (tile-keyed hash) single-device, "hash" under a mesh —
    the hash/sobol streams are pure functions of (key, pixel, sample,
    site), making the sharded step MESH-SHAPE-INVARIANT and comparable
    lane-for-lane with a single-device kernel_sampler="hash" step.
    `param_spaces` (e.g. {"emission": "log"}) optimizes selected parameters
    in softplus-log space (see diff.params.make_codec); params stay in
    natural space at the step boundary, so callers and checkpoints are
    unaffected.
    `names` selects the trainable leaves (diff.params.TRAINABLE by
    default; add "mat_exponent" to recover Phong glossiness — under
    engine="pallas" this switches the kernel to its trainable-exponent
    backward).
    `interpret` (engine="pallas"): run the kernels in Pallas' interpreter;
    None chooses it exactly when JAX's default backend is the CPU.
    """
    from kytpu.diff.params import TRAINABLE, make_codec

    cfg = cfg or kpath.PathConfig(max_depth=3)
    optimizer = optimizer or optax.adam(2e-2)
    encode, decode = make_codec(param_spaces)
    names = names or TRAINABLE
    params0 = get_params(scene, names)
    opt_state0 = optimizer.init(encode(params0))
    w, h = scene.camera.width, scene.camera.height

    if engine == "pallas":
        from kytpu.kernels import wavefront as kwf
        from kytpu.scene import scene as kscene_mod
        train_exp = "mat_exponent" in names
        if kernel_sampler is None:
            kernel_sampler = "hash" if mesh is not None else "random"
        if mesh is not None and kernel_sampler not in ("hash", "sobol"):
            raise ValueError(
                "mesh pallas train step needs a decomposition-invariant "
                f"sampler ('hash' or 'sobol'); got {kernel_sampler!r}")
        kcfg = kwf.KernelConfig(max_depth=cfg.max_depth,
                                trainable_exponent=train_exp,
                                sampler=kernel_sampler)
        interpret = kwf.resolve_interpret(interpret)
        env0 = (scene.env_radiance_ if scene.has_env
                else jnp.zeros(3, jnp.float32))
        has_tex = bool(scene.has_textures)
        has_img = False
        if has_tex:
            import numpy as np
            from kytpu.scene import texture as ktex_mod
            tid = np.asarray(scene.tex_id)
            kinds = np.asarray(scene.textures.kind)
            has_img = any(int(kinds[int(t)]) == ktex_mod.IMAGE
                          for t in tid if int(t) >= 0)
        # scene-scale routing (the rule of every engine="pallas" entry
        # point, bigscene.use_table_kernel): past TABLE_KERNEL_MIN_ROWS
        # surfaces train through the table kernel when it can take the
        # scene, else through the baked kernel
        from kytpu.kernels import bigscene as kbig
        if kbig.use_table_kernel(scene):
            tracer = kbig.make_bigscene_diff_tracer(scene, kcfg,
                                                    interpret=interpret)
        else:
            tracer = kwf.make_pallas_diff_tracer(scene, kcfg,
                                                 interpret=interpret)
        npix = w * h
        cam = scene.camera
        use_lds = kcfg.sampler in ("hash", "sobol")

        def _tracer_params(params):
            exp_arg = ((params["mat_exponent"],) if train_exp else ())
            tex_arg = ()
            if has_tex:
                tex_arg = (params.get("tex_color_a", scene.textures.color_a),
                           params.get("tex_color_b", scene.textures.color_b))
                if has_img:
                    tex_arg = tex_arg + (
                        params.get("tex_image", scene.textures.image),)
            return (params.get("mat_diffuse", scene.mat_diffuse),
                    params.get("mat_specular", scene.mat_specular),
                    params.get("emission", scene.emission),
                    *exp_arg, *tex_arg,
                    params.get("env_radiance_", env0))

        def trace_block(params, key, pid, sid):
            """(S, P, 3) kernel radiance for the sid x pid lane block.

            Under the hash/sobol samplers every draw (camera jitter and
            every in-kernel site) is a pure function of (key, pixel id,
            sample id), so the block's lanes are independent of how they
            are sharded — the construction mirrored from
            dist.shard.render_sharded_pallas."""
            s_loc, p_loc = sid.shape[0], pid.shape[0]
            lane_pid = jnp.tile(pid, s_loc)
            lane_sid = jnp.repeat(sid, p_loc)
            if kcfg.sampler == "sobol":
                from kytpu.core import rng as krng
                cam_keys = jax.vmap(
                    lambda p_: jax.random.fold_in(key, p_))(lane_pid)
                u = krng.uniform2(cam_keys, "sobol", lane_sid)
            elif kcfg.sampler == "hash":
                cam_keys = jax.vmap(jax.random.fold_in, (None, 0))(
                    key, lane_sid * jnp.int32(npix) + lane_pid)
                u = jax.vmap(lambda k: jax.random.uniform(k, (2,)))(cam_keys)
            else:
                u = jax.random.uniform(key, (s_loc * p_loc, 2))
            px = (lane_pid % w).astype(jnp.float32) + u[:, 0]
            py = (lane_pid // w).astype(jnp.float32) + u[:, 1]
            o, d = kscene_mod.generate_rays(cam, jnp.stack([px, py], -1))
            seed = jax.random.randint(key, (), 0, 2**31 - 1, jnp.int32)
            extra = (lane_sid, lane_pid) if use_lds else ()
            out = tracer(*_tracer_params(params), o, d, seed, *extra)
            return out.reshape(s_loc, p_loc, 3)

        if mesh is not None:
            n_tile = mesh.shape["tile"]
            n_spp = mesh.shape["spp"]
            if npix % n_tile or spp % n_spp:
                raise ValueError(
                    f"pixels {npix} / spp {spp} not divisible by mesh "
                    f"{dict(mesh.shape)}")
            tile_sh = NamedSharding(mesh, P("tile"))
            pid_sh = jax.device_put(jnp.arange(npix, dtype=jnp.int32),
                                    tile_sh)
            sid_sh = jax.device_put(jnp.arange(spp, dtype=jnp.int32),
                                    NamedSharding(mesh, P("spp")))
            target_sh = jax.device_put(
                jnp.asarray(target, jnp.float32).reshape(-1, 3), tile_sh)

            def sharded_loss(params, key, target_flat, pid, sid):
                def body(params, key, target_flat, pid, sid):
                    block = trace_block(params, key, pid, sid)
                    img = jax.lax.psum(block.sum(axis=0), "spp") / float(spp)
                    return jax.lax.pmean(loss_fn(img, target_flat), "tile")

                fn = jax.shard_map(
                    body, mesh=mesh,
                    in_specs=(P(), P(), P("tile"), P("tile"), P("spp")),
                    out_specs=P(), check_vma=False)
                return fn(params, key, target_flat, pid, sid)

            # sharded operands enter through the jit boundary (closing over
            # arrays spanning non-addressable devices fails multi-process)
            @jax.jit
            def step_mesh(params, opt_state, key, target_flat, pid, sid):
                theta = encode(params)
                loss, grads = jax.value_and_grad(
                    lambda th: sharded_loss(decode(th), key, target_flat,
                                            pid, sid))(theta)
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      theta)
                params = decode(optax.apply_updates(theta, updates))
                params = jax.tree.map(lambda p: jnp.clip(p, 0.0, None),
                                      params)
                return params, opt_state, loss

            def step(params, opt_state, key):
                return step_mesh(params, opt_state, key, target_sh,
                                 pid_sh, sid_sh)

            return step, params0, opt_state0

        pid0 = jnp.arange(npix, dtype=jnp.int32)
        sid0 = jnp.arange(spp, dtype=jnp.int32)

        def loss_of(params, key):
            img = trace_block(params, key, pid0, sid0).mean(axis=0)
            return loss_fn(img.reshape(h, w, 3), target)
    elif mesh is None:
        def loss_of(params, key):
            return render_loss(params, scene, target, key, spp, cfg, loss_fn)
    else:
        n_tile = mesh.shape["tile"]
        n_spp = mesh.shape["spp"]
        if (w * h) % n_tile or spp % n_spp:
            raise ValueError(
                f"pixels {w*h} / spp {spp} not divisible by mesh {mesh.shape}")
        px, py, pid, sid = _lane_ids(w, h, 1)
        sid = jnp.arange(spp, dtype=jnp.int32)
        tile_sh = NamedSharding(mesh, P("tile"))
        px = jax.device_put(px, tile_sh)
        py = jax.device_put(py, tile_sh)
        pid = jax.device_put(pid, tile_sh)
        sid = jax.device_put(sid, NamedSharding(mesh, P("spp")))
        target_flat = jax.device_put(
            jnp.asarray(target, jnp.float32).reshape(-1, 3), tile_sh)

        # sharded operands must enter through the jit boundary (closing
        # over arrays that span non-addressable devices is an error in
        # multi-process runs), so the mesh step threads them as arguments
        @jax.jit
        def step_mesh(params, opt_state, key, target_flat, px, py, pid, sid):
            def loss_of(params, key):
                return _sharded_loss(params, scene, target_flat, key,
                                     px, py, pid, sid, spp, cfg, loss_fn,
                                     mesh)
            theta = encode(params)
            loss, grads = jax.value_and_grad(
                lambda th: loss_of(decode(th), key))(theta)
            updates, opt_state = optimizer.update(grads, opt_state, theta)
            params = decode(optax.apply_updates(theta, updates))
            params = jax.tree.map(lambda p: jnp.clip(p, 0.0, None), params)
            return params, opt_state, loss

        def step(params, opt_state, key):
            return step_mesh(params, opt_state, key, target_flat,
                             px, py, pid, sid)

        return step, params0, opt_state0

    @jax.jit
    def step(params, opt_state, key):
        theta = encode(params)
        loss, grads = jax.value_and_grad(
            lambda th: loss_of(decode(th), key))(theta)
        updates, opt_state = optimizer.update(grads, opt_state, theta)
        params = decode(optax.apply_updates(theta, updates))
        params = jax.tree.map(lambda p: jnp.clip(p, 0.0, None), params)
        return params, opt_state, loss

    return step, params0, opt_state0


def recover(scene, target, n_steps: int = 100, seed: int = 0, **kw):
    """Run an inverse-rendering loop; returns (recovered_scene, losses)."""
    step, params, opt_state = make_train_step(scene, target, **kw)
    key = jax.random.key(seed)
    hist = []
    for i in range(n_steps):
        params, opt_state, loss = step(params, opt_state,
                                       jax.random.fold_in(key, i))
        hist.append(float(loss))
    return set_params(scene, params), hist
