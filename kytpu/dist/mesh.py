"""Device meshes for sharded rendering.

The reference's only parallelism is an OpenMP row loop (ky.cpp:3696-3701).
The accelerator equivalent is a 2D logical mesh:

  - "tile": pixels (the film is sharded; each device owns a contiguous strip
    of flat pixel rows — the moral equivalent of OpenMP's dynamic row chunks,
    but with compile-time-known ownership so film tiles never migrate).
  - "spp":  samples-per-pixel (Monte Carlo replication; partial sums are
    reduced with one psum over this axis per pass).

The cards of one host are joined all to all (NVLink), so the mesh shape
follows the algorithm alone: the only collective is one psum over "spp" per
pass. Across hosts, "tile" should map to the host dimension, so film tiles
stay host-local and only the spp psum crosses the slower links.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def default_mesh_shape(n_devices: int, spp: int | None = None) -> tuple[int, int]:
    """Pick (tile, spp) axis sizes for n_devices.

    Prefers sample-axis parallelism up to 4-way (keeps per-device pixel
    strips large, so each device's kernel launches stay full), then tiles.
    """
    s = 1
    if spp is None:
        spp = 1 << 30
    for cand in (4, 2):
        if n_devices % cand == 0 and spp % cand == 0 and spp >= cand:
            s = cand
            break
    return n_devices // s, s


def make_mesh(devices=None, shape: tuple[int, int] | None = None,
              spp: int | None = None) -> Mesh:
    """Create a ("tile", "spp") mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = default_mesh_shape(n, spp)
    t, s = shape
    if t * s != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_grid = np.asarray(devices).reshape(t, s)
    return Mesh(dev_grid, axis_names=("tile", "spp"))
