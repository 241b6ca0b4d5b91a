"""kytpu — a differentiable path tracer in JAX/XLA/Pallas.

A brand-new physically-based rendering framework with the capabilities of the
reference C++ path tracer (infancy/ky, see SURVEY.md), re-designed for data-parallel accelerators:

- **Wavefront integration**: the iterative path-tracing loop
  (reference: ky.cpp:4523-4618) becomes a masked, fixed-depth `lax.scan` over a
  structure-of-arrays ray batch — no recursion, no per-hit heap allocation,
  no virtual dispatch.
- **Pure-functional RNG**: threefry key folding per (pixel, sample, bounce)
  replaces the reference's cloned mt19937 streams (and fixes its
  identical-rows-seed bug, ky.cpp:833+954).
- **Differentiable end-to-end**: detached-sampling reparameterization gives
  unbiased gradients of the radiance estimate w.r.t. material albedo, emission
  and light parameters.
- **Sharded**: rays/tiles shard over a `jax.sharding.Mesh`; film and gradient
  reductions ride ICI collectives.
"""

__version__ = "0.1.0"

from kytpu.core import math as kmath  # noqa: F401

# primary user-facing surface
from kytpu.scene import builders  # noqa: F401
from kytpu.integrator.render import (  # noqa: F401
    render, render_aov, render_region, debug_area, debug_pixel)
from kytpu.integrator.path import PathConfig  # noqa: F401
from kytpu.integrator.fast import FastConfig  # noqa: F401
