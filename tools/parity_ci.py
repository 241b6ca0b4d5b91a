"""One-command pixel-parity gate: kytpu vs the COMPILED reference renderer.

Builds /root/reference/ky.cpp (tools/reference_build), renders the
reference's production config (cornell both_small_spheres |
light_environment, 1024^2, depth 5, iterative PT, both_mis — ky.cpp:4675)
with BOTH renderers at equal spp, renders kytpu twice at different seeds
for a pure-Monte-Carlo noise floor, and FAILS if the cross-renderer
difference exceeds ``--tolerance`` times that floor (default 1.5, from the
round-1 measurements: 0.0055 cross vs 0.0042 floor).

Intended as the periodic parity job:

    python tools/parity_ci.py            # full gate, 64 spp
    python tools/parity_ci.py --spp 16   # quicker, noisier floor
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BIN = "/tmp/ky_ref"


def build_reference() -> None:
    if os.path.exists(REF_BIN):
        return
    subprocess.run(
        ["sh", os.path.join(REPO, "tools", "reference_build",
                            "build_reference.sh")], check=True)


def render_reference(spp: int) -> str:
    # argv[1] is 4*spp (smallpt convention, ky.cpp:4690)
    subprocess.run([REF_BIN, str(4 * spp)], cwd="/tmp", check=True,
                   env={**os.environ, "OMP_NUM_THREADS":
                        str(os.cpu_count() or 8)})
    return "/tmp/single.bmp"


def render_kytpu(spp: int, seed: int, path: str) -> str:
    import numpy as np

    from kytpu.film import io as fio
    from kytpu.integrator import path as kpath
    from kytpu.integrator.render import render
    from kytpu.scene import builders

    flags = builders.BOTH_SMALL_SPHERES | {builders.LIGHT_ENVIRONMENT}
    scene = builders.cornell_box(flags, width=1024, height=1024)
    cfg = kpath.PathConfig(max_depth=5, variant="iteration",
                           strategy="both_mis")
    img = np.asarray(render(scene, spp=spp, seed=seed, cfg=cfg))
    fio.write_bmp(path, img)
    return path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--tolerance", type=float, default=1.5,
                    help="max cross-renderer diff as a multiple of the "
                         "seed-to-seed noise floor")
    ap.add_argument("--down", type=int, default=8,
                    help="downsample factor for noise cancellation")
    args = ap.parse_args()
    return main_with_args(args.spp, args.tolerance, args.down)


def main_with_args(spp: int = 64, tolerance: float = 1.5,
                   down: int = 8) -> int:
    """Programmatic entry (tests/test_parity.py runs this via -m parity)."""
    import types
    args = types.SimpleNamespace(spp=spp, tolerance=tolerance, down=down)

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from compare_reference import main as compare

    build_reference()
    ref_bmp = render_reference(args.spp)

    import jax

    jax.config.update("jax_compilation_cache_dir",
                      os.environ.get("JAX_COMPILATION_CACHE_DIR",
                                     "/tmp/jaxcache"))
    ours_a = render_kytpu(args.spp, seed=1234, path="/tmp/parity_a.bmp")
    ours_b = render_kytpu(args.spp, seed=977, path="/tmp/parity_b.bmp")

    print("cross (reference vs kytpu):")
    cross = compare(ref_bmp, ours_a, args.down)
    print("noise floor (kytpu seed 1234 vs 977):")
    floor = compare(ours_a, ours_b, args.down)

    limit = args.tolerance * max(floor, 1e-4)
    ok = cross <= limit
    print(f"parity: cross {cross:.4f} vs limit {limit:.4f} "
          f"({args.tolerance}x floor {floor:.4f}) -> "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
