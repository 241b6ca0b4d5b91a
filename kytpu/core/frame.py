"""Orthonormal shading frames, batched.

Batched replacement for the reference's `frame_t` (ky.cpp:526-578,
SmallVCM-style construction): frames are just three (N, 3) arrays, and the
world<->local transforms are elementwise dot products — no objects, no
per-hit allocation.
"""

from __future__ import annotations

import jax.numpy as jnp

from kytpu.core import math as km


def make_frame(n):
    """Build (s, t, n) from unit normal(s) n: (..., 3).

    Branch-free version of the SmallVCM recipe: pick the helper axis
    (0,1,0) when |n.x| > 0.99 else (1,0,0), then t = normalize(n x helper),
    s = normalize(t x n).
    """
    n = km.normalize(n)
    use_y = (jnp.abs(n[..., 0]) > 0.99)[..., None]
    helper = jnp.where(
        use_y,
        jnp.array([0.0, 1.0, 0.0], dtype=n.dtype),
        jnp.array([1.0, 0.0, 0.0], dtype=n.dtype),
    )
    t = km.normalize(jnp.cross(n, helper))
    s = km.normalize(jnp.cross(t, n))
    return s, t, n


def to_local(s, t, n, w_world):
    return jnp.stack(
        [km.dot(s, w_world), km.dot(t, w_world), km.dot(n, w_world)], axis=-1
    )


def to_world(s, t, n, w_local):
    return (
        w_local[..., 0:1] * s + w_local[..., 1:2] * t + w_local[..., 2:3] * n
    )
