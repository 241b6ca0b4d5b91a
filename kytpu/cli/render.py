"""Config-driven render drivers.

Reproduces the reference's six driver programs (ky.cpp:4675-4905) as
subcommands of `python -m kytpu.cli.render`:

  single     render_single_scene  (ky.cpp:4675-4713): 1024^2 Cornell box,
             both small spheres + environment light, PT-iteration depth 5.
  debug      render_debug         (ky.cpp:4715-4738): 1x3 AOV grid
             (position/normal/basecolor) over the Veach scene.
  integrators render_multiple_integrator (ky.cpp:4740-4777): 4 Cornell light
             variants x 5 integrators montage.
  strategies render_direct_sample_enum   (ky.cpp:4779-4817): 4 light variants
             x 5 direct-sampling strategies montage.
  scenes     render_multiple_scene       (ky.cpp:4819-4876): 3 strategies x
             4 scenes montage.
  mis        render_mis_scene            (ky.cpp:4878-4905): 2x3 grid of the
             6 strategies over the Veach MIS scene.

All drivers accept --mesh t,s to run SPMD over a ("tile","spp") device mesh.
"""

from __future__ import annotations

import argparse
import time

from kytpu.film.film import FilmGrid, to_srgb_u8
from kytpu.film import io as fio
from kytpu.integrator.path import PathConfig
from kytpu.integrator.render import render
from kytpu.scene import builders


def _render(scene, spp, seed, cfg=None, mode="path", aov=None, mesh=None,
            engine="jnp"):
    if mesh is not None:
        from kytpu.dist import make_mesh, render_sharded, render_sharded_pallas
        m = make_mesh(shape=mesh)
        if engine == "pallas":
            from kytpu.kernels.wavefront import KernelConfig
            kcfg = KernelConfig(max_depth=getattr(cfg, "max_depth", 5))
            return render_sharded_pallas(scene, m, spp=spp, seed=seed,
                                         kernel_cfg=kcfg)
        return render_sharded(scene, m, spp=spp, seed=seed, cfg=cfg,
                              mode=mode, aov=aov)
    return render(scene, spp=spp, seed=seed, cfg=cfg, mode=mode, aov=aov,
                  engine=engine if mode == "path" else "jnp")


def _save(path: str, img) -> None:
    fio.write_image(path, img)
    print(f"wrote {path}")


# the four Cornell lighting variants used by the matrix drivers
# (lighting_enum_t x cornell_box_enum_t, ky.cpp:4744-4756)
_CORNELL_VARIANTS = [
    ("area", builders.BOTH_SMALL_SPHERES | {builders.LIGHT_AREA}),
    ("direction", builders.BOTH_SMALL_SPHERES | {builders.LIGHT_DIRECTION}),
    ("point", builders.BOTH_SMALL_SPHERES | {builders.LIGHT_POINT}),
    ("environment", builders.BOTH_SMALL_SPHERES | {builders.LIGHT_ENVIRONMENT}),
]

_INTEGRATORS = [  # integrator_enum_t subset used by the matrix (ky.cpp:4762)
    ("direct", dict(mode="direct")),
    ("simple", dict(cfg_kw=dict(variant="simple"))),
    ("recursion", dict(cfg_kw=dict(variant="recursion"))),
    ("defered", dict(cfg_kw=dict(variant="defered"))),
    ("iteration", dict(cfg_kw=dict(variant="iteration"))),
]

_STRATEGIES = ["bsdf", "light", "bsdf_mis", "light_mis", "both_mis"]


def cmd_single(args):
    flags = builders.BOTH_SMALL_SPHERES | {builders.LIGHT_ENVIRONMENT,
                                           builders.LIGHT_AREA}
    scene = builders.cornell_box(flags, width=args.size, height=args.size)
    cfg = PathConfig(max_depth=args.depth, variant="iteration",
                     strategy="both_mis", sampler=args.sampler,
                     filter=args.filter)
    t0 = time.perf_counter()
    img = _render(scene, args.spp, args.seed, cfg, mesh=args.mesh,
                  engine=args.engine)
    dt = time.perf_counter() - t0
    print(f"{dt:.3f} seconds, {args.size}x{args.size} @ {args.spp} spp")
    _save(args.out or "single.bmp", img)


def cmd_debug(args):
    scene = builders.veach_mis(width=args.size, height=args.size * 308 // 512)
    grid = FilmGrid(1, 3, scene.camera.width, scene.camera.height)
    for aov in ("position", "normal", "basecolor"):
        grid.place(_render(scene, args.spp, args.seed, mode="aov", aov=aov,
                           mesh=args.mesh))
    _save(args.out or "render_debug.bmp", grid.pixels)


def cmd_integrators(args):
    grid = FilmGrid(len(_CORNELL_VARIANTS), len(_INTEGRATORS),
                    args.size, args.size)
    for _, flags in _CORNELL_VARIANTS:
        scene = builders.cornell_box(flags, width=args.size, height=args.size)
        for _, spec in _INTEGRATORS:
            cfg = PathConfig(max_depth=args.depth, strategy="both_mis",
                             **spec.get("cfg_kw", {}))
            grid.place(_render(scene, args.spp, args.seed, cfg,
                               mode=spec.get("mode", "path"), mesh=args.mesh))
    _save(args.out or "integrators.bmp", grid.pixels)


def cmd_strategies(args):
    grid = FilmGrid(len(_CORNELL_VARIANTS), len(_STRATEGIES),
                    args.size, args.size)
    for _, flags in _CORNELL_VARIANTS:
        scene = builders.cornell_box(flags, width=args.size, height=args.size)
        for s in _STRATEGIES:
            cfg = PathConfig(max_depth=args.depth, strategy=s)
            grid.place(_render(scene, args.spp, args.seed, cfg,
                               mesh=args.mesh))
    _save(args.out or "strategies.bmp", grid.pixels)


def cmd_scenes(args):
    """3 strategies x 4 lighting variants (render_multiple_scene,
    ky.cpp:4819-4876): {point x10, direction x40, area x40, environment x10}
    spp x {bsdf, light, both_mis}, both small spheres in every cell. The
    per-scene spp factors are the reference's (scaled by --spp / 40)."""
    variants = [
        (builders.LIGHT_POINT, 10),
        (builders.LIGHT_DIRECTION, 40),
        (builders.LIGHT_AREA, 40),
        (builders.LIGHT_ENVIRONMENT, 10),
    ]
    strategies = ["bsdf", "light", "both_mis"]
    grid = FilmGrid(len(strategies), len(variants), args.size, args.size)
    for s in strategies:
        for flag, spp_ref in variants:
            scene = builders.cornell_box(
                builders.BOTH_SMALL_SPHERES | {flag},
                width=args.size, height=args.size)
            cfg = PathConfig(max_depth=args.depth, strategy=s)
            spp = max(1, spp_ref * args.spp // 40)
            grid.place(_render(scene, spp, args.seed, cfg, mesh=args.mesh))
    _save(args.out or "multi_scene.bmp", grid.pixels)


def cmd_textured(args):
    """Texture demo (beyond parity): Cornell with a checkered floor and a
    painted back-wall image texture, plus a spheres stress scene rendered
    through the grid accelerator."""
    from kytpu.cli.inverse import demo_texture
    scene = builders.cornell_box(
        builders.BOTH_SMALL_SPHERES | {builders.LIGHT_AREA},
        width=args.size, height=args.size,
        floor_checker=True, back_image=demo_texture(32))
    cfg = PathConfig(max_depth=args.depth, strategy="both_mis",
                     sampler=args.sampler)
    t0 = time.perf_counter()
    img = _render(scene, args.spp, args.seed, cfg, mesh=args.mesh)
    print(f"{time.perf_counter() - t0:.3f} seconds (textured cornell)")
    _save(args.out or "textured.bmp", img)


def cmd_spheres(args):
    """Grid-accelerator demo: a procedural many-sphere scene
    (builders.random_spheres; 'auto' accel = uniform grid past 256
    surfaces)."""
    scene = builders.random_spheres(n=args.n, width=args.size,
                                    height=args.size, seed=args.seed)
    cfg = PathConfig(max_depth=args.depth, strategy="both_mis")
    t0 = time.perf_counter()
    img = _render(scene, args.spp, args.seed, cfg, mesh=args.mesh,
                  mode="fast")
    dt = time.perf_counter() - t0
    accel = "grid" if scene.accel is not None else "sweep"
    print(f"{dt:.3f} seconds, {scene.geometry.n_surfaces} surfaces "
          f"({accel})")
    _save(args.out or "spheres.bmp", img)


def cmd_trimesh(args):
    """Triangle-mesh demo (scene/mesh.py, beyond parity): an icosphere,
    torus, or loaded OBJ on a ground plane. With --engine pallas the scene
    auto-routes to the table-driven big-scene megakernel past 64 faces."""
    from kytpu.scene import mesh as kmesh
    if args.obj:
        v, f = kmesh.load_obj(args.obj)
        label = args.obj
    elif args.shape == "torus":
        v, f = kmesh.torus(nu=2 * args.res, nv=args.res)
        label = f"torus({2 * args.res}x{args.res})"
    else:
        v, f = kmesh.icosphere(args.sub)
        label = f"icosphere({args.sub})"
    scene = builders.mesh_scene(v, f, width=args.size,
                                height=args.size * 2 // 3)
    cfg = PathConfig(max_depth=args.depth, strategy="both_mis",
                     sampler=args.sampler)
    t0 = time.perf_counter()
    img = _render(scene, args.spp, args.seed, cfg, mesh=args.mesh,
                  mode="fast" if args.engine == "jnp" else "path",
                  engine=args.engine)
    print(f"{time.perf_counter() - t0:.3f} seconds, {len(f)} triangles "
          f"({label}, engine={args.engine})")
    _save(args.out or "trimesh.bmp", img)


def cmd_mis(args):
    w = args.size
    h = args.size * 308 // 512
    scene = builders.veach_mis(width=w, height=h)
    grid = FilmGrid(2, 3, w, h)
    for s in ("bsdf", "light", "idle", "bsdf_mis", "light_mis", "both_mis"):
        cfg = PathConfig(max_depth=args.depth, strategy=s)
        grid.place(_render(scene, args.spp, args.seed, cfg, mesh=args.mesh))
    _save(args.out or "veach_mis.bmp", grid.pixels)


def main(argv=None):
    p = argparse.ArgumentParser(prog="kytpu.cli.render", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    cmds = dict(single=cmd_single, debug=cmd_debug,
                integrators=cmd_integrators, strategies=cmd_strategies,
                scenes=cmd_scenes, mis=cmd_mis, textured=cmd_textured,
                spheres=cmd_spheres, trimesh=cmd_trimesh)
    defaults = dict(single=(1024, 16), debug=(512, 10),
                    integrators=(256, 16), strategies=(256, 16),
                    scenes=(256, 16), mis=(512, 10), textured=(512, 64),
                    spheres=(512, 32), trimesh=(384, 24))
    for name, fn in cmds.items():
        sp = sub.add_parser(name)
        size0, spp0 = defaults[name]
        sp.add_argument("--size", type=int, default=size0)
        sp.add_argument("--spp", type=int, default=spp0)
        sp.add_argument("--depth", type=int, default=5)
        sp.add_argument("--seed", type=int, default=1234)
        sp.add_argument("--out", type=str, default=None)
        sp.add_argument("--mesh", type=lambda s: tuple(map(int, s.split(","))),
                        default=None, help="t,s mesh shape for SPMD render")
        sp.add_argument("--engine", choices=("jnp", "pallas", "bigscene"),
                        default="jnp",
                        help="pallas = fused GPU megakernel (production "
                             "estimator; the strategy-matrix drivers always "
                             "use the jnp engine); bigscene = table-driven "
                             "megakernel for hundreds+ surfaces (O(1) "
                             "compile; pallas auto-routes there when the "
                             "scene is large and eligible)")
        sp.add_argument("--sampler",
                        choices=("random", "stratified", "sobol", "debug"),
                        default="random",
                        help="sobol = Owen-scrambled (0,2)-sequences "
                             "(in-kernel under --engine pallas)")
        sp.add_argument("--filter", choices=("box", "tent"), default="box",
                        help="tent = smallpt's 2x2 tent camera filter "
                             "(jnp engines)")
        if name == "spheres":
            sp.add_argument("--n", type=int, default=512,
                            help="sphere count (grid accel past 256)")
        if name == "trimesh":
            sp.add_argument("--shape", choices=("icosphere", "torus"),
                            default="torus")
            sp.add_argument("--sub", type=int, default=3,
                            help="icosphere subdivisions (20*4^s faces)")
            sp.add_argument("--res", type=int, default=24,
                            help="torus tube segments (faces = 4*res^2)")
            sp.add_argument("--obj", type=str, default=None,
                            help="render a Wavefront OBJ file instead")
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    from kytpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
