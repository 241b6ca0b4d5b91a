"""Pallas kernels (Triton route): the fused wavefront path-tracing
megakernels.

`wavefront.make_pallas_tracer` runs the entire bounce loop of the
production integrator (kytpu.integrator.fast) inside one Pallas kernel:
ray state lives in registers as (rows, 128) component planes for the whole
path, scene geometry is baked into the instruction stream as compile-time
constants, and material/light color tables are small global arrays read as
scalars, so renders stay parameterized. `bigscene` is the table-driven
variant for scenes with hundreds of surfaces. See kernels/v3.py for the plane-SoA vector
algebra the kernel is written in.
"""

from kytpu.kernels.wavefront import render_lanes_pallas  # noqa: F401
