"""Inverse-rendering demo: recover Cornell-box albedos + emission.

BASELINE.md config 5. Renders a target image with the true scene, perturbs
the material/emission tables, then gradient-descends back. Run:

  python -m kytpu.cli.inverse --size 32 --spp 4 --steps 60 [--mesh 4,2]

Prints the loss curve and the final per-parameter recovery error.

--mode texture runs the texture-recovery variant instead: the target scene
carries a painted image texture on the back wall; optimization starts from
a flat gray texture and recovers the texels through the render (bilinear
lookup is linear in the texels, so per-texel gradients are exact —
scene/texture.py).
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from kytpu.diff import get_params, set_params, make_train_step
from kytpu.diff.inverse import render_once
from kytpu.integrator.path import PathConfig
from kytpu.scene import builders
from kytpu.utils import RenderTimer, save_checkpoint


def demo_texture(n: int = 16) -> np.ndarray:
    """A recognizable (n, n, 3) test pattern: RGB gradient + yellow ring."""
    y, x = np.mgrid[0:n, 0:n] / max(n - 1, 1)
    img = np.stack([x, y, 1.0 - 0.5 * (x + y)], -1)
    r = np.hypot(x - 0.5, y - 0.5)
    img[np.abs(r - 0.3) < 0.08] = (0.9, 0.9, 0.1)
    return img.astype(np.float32)


def run_texture_recovery(args):
    """Recover a painted back-wall texture from renders."""
    cfg = PathConfig(max_depth=args.depth, strategy="both_mis")
    true_img = demo_texture(args.tex_res)
    scene = builders.cornell_box(width=args.size, height=args.size,
                                 back_image=true_img)
    key = jax.random.key(args.seed)
    target_spp = args.target_spp or (32 if args.resample else args.spp)
    timer = RenderTimer()
    with timer.phase("target", rays=args.size**2 * target_spp):
        target = jax.lax.stop_gradient(
            render_once(scene, key, spp=target_spp, cfg=cfg))

    gray = np.full_like(true_img, 0.5)
    scene_w = builders.cornell_box(width=args.size, height=args.size,
                                   back_image=gray)
    import optax
    step, params, opt_state = make_train_step(
        scene_w, target, spp=args.spp, cfg=cfg,
        optimizer=optax.adam(args.lr), names=("tex_image",))
    rays_per_step = args.size**2 * args.spp
    for i in range(args.steps):
        step_key = jax.random.fold_in(key, 1 + i) if args.resample else key
        with timer.phase("optimize", rays=rays_per_step):
            params, opt_state, loss = step(params, opt_state, step_key)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")
    got = np.asarray(params["tex_image"][0])
    print(f"tex_image: mean abs error {np.abs(gray - true_img).mean():.4f}"
          f" -> {np.abs(got - true_img).mean():.4f}")
    print(timer.report())


def main(argv=None):
    from kytpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=("albedo", "texture"), default="albedo")
    p.add_argument("--tex-res", type=int, default=16,
                   help="texture resolution for --mode texture")
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target-spp", type=int, default=None,
                   help="spp of the synthetic target (defaults to --spp "
                        "for common-random-numbers mode, 32 with "
                        "--resample)")
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--recover-emission", action="store_true",
                   help="also halve+recover emission (harder: brightness "
                        "is partially ambiguous between albedo and "
                        "emission at low resolution)")
    p.add_argument("--emission-space", choices=("log", "linear"),
                   default="log",
                   help="optimize emission in softplus-log space (default: "
                        "one shared lr conditions albedo+emission jointly) "
                        "or linear space (falls back to a per-group "
                        "lr-scaled adam)")
    p.add_argument("--resample", action="store_true",
                   help="draw fresh sample paths every step (default keeps "
                        "common random numbers, the standard "
                        "variance-reduction for inverse rendering)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=20)
    p.add_argument("--mesh", type=lambda s: tuple(map(int, s.split(","))),
                   default=None)
    args = p.parse_args(argv)

    if args.mode == "texture":
        return run_texture_recovery(args)

    cfg = PathConfig(max_depth=args.depth, strategy="both_mis")
    scene = builders.cornell_box(width=args.size, height=args.size)
    key = jax.random.key(args.seed)

    target_spp = args.target_spp or (32 if args.resample else args.spp)
    timer = RenderTimer()
    with timer.phase("target", rays=args.size**2 * target_spp):
        target = jax.lax.stop_gradient(
            render_once(scene, key, spp=target_spp, cfg=cfg))

    true = get_params(scene)
    rng = np.random.default_rng(args.seed)
    # Perturb albedos (and optionally emission — magnitudes ~25, so it
    # gets a proportionally larger adam learning rate; adam steps are
    # unit-scaled per parameter and a shared lr could never close a
    # 12-unit gap).
    wrong = {
        "mat_diffuse": jnp.asarray(
            np.clip(np.asarray(true["mat_diffuse"])
                    * rng.uniform(0.3, 1.6, true["mat_diffuse"].shape), 0, 1),
            jnp.float32),
        "mat_specular": true["mat_specular"],
        "emission": (true["emission"] * 0.5 if args.recover_emission
                     else true["emission"]),
    }
    scene_w = set_params(scene, wrong)

    mesh = None
    if args.mesh:
        from kytpu.dist import make_mesh
        mesh = make_mesh(shape=args.mesh)

    # only optimize what was perturbed: without --recover-emission the
    # emission tables start at the truth, and training them anyway lets
    # MC noise walk them away from it (visible at small --steps)
    names = (("mat_diffuse", "mat_specular", "emission")
             if args.recover_emission else ("mat_diffuse", "mat_specular"))

    import optax
    if args.emission_space == "log":
        # log-space emission: multiplicative steps, one shared lr suffices
        optimizer = optax.adam(args.lr)
        param_spaces = {"emission": "log"} if args.recover_emission else None
    else:
        # linear space needs a proportionally larger emission lr: adam
        # steps are unit-scaled per parameter and a shared lr could never
        # close a 12-unit radiance gap
        emission_scale = float(np.asarray(true["emission"]).max()) or 1.0
        optimizer = optax.multi_transform(
            {"color": optax.adam(args.lr),
             "emission": optax.adam(args.lr * emission_scale)},
            {n: ("emission" if n == "emission" else "color")
             for n in names})
        param_spaces = None
    step, params, opt_state = make_train_step(
        scene_w, target, spp=args.spp, cfg=cfg, mesh=mesh,
        optimizer=optimizer, param_spaces=param_spaces, names=names)

    rays_per_step = args.size**2 * args.spp
    for i in range(args.steps):
        step_key = jax.random.fold_in(key, 1 + i) if args.resample else key
        with timer.phase("optimize", rays=rays_per_step):
            params, opt_state, loss = step(params, opt_state, step_key)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")
        if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint, (params, opt_state), step=i + 1)

    report = ("mat_diffuse", "emission") if args.recover_emission \
        else ("mat_diffuse",)
    for name in report:
        err0 = float(jnp.abs(wrong[name] - true[name]).mean())
        err1 = float(jnp.abs(params[name] - true[name]).mean())
        print(f"{name}: mean abs error {err0:.4f} -> {err1:.4f}")
    print(timer.report())


if __name__ == "__main__":
    main()
