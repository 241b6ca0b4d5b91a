"""UV-mapped textures: procedural checkerboard + bilinear image lookup.

Beyond parity: the reference declares an empty `texture` region and never
fills it (ky.cpp:2559-2563), so this subsystem has no C++ counterpart to
mirror — it is designed for batched evaluation from scratch:

  - all texture state is two dense device tables (a (T,) parameter SoA and
    one stacked (Ti, H, W, 3) image atlas), so a ray batch evaluates every
    texture with gathers + selects, no per-hit dispatch;
  - bilinear filtering is LINEAR in the texels, so `jax.grad` through a
    render gives exact per-texel gradients — image textures are trainable
    parameters (inverse rendering can recover a painted texture from
    renders, see diff.params / cli.inverse);
  - procedural checker colors are likewise differentiable leaves.

UV conventions (shapes.surface_uv):
  sphere    u = phi/2pi in [0,1), v = theta/pi (z-up, matching the
            reference's spherical_theta/phi, ky.cpp:410-439)
  rectangle u along p0-p1, v along p2-p1 (Gram solve; exact on the
            reference's parallelogram rects, ky.cpp:1245-1323)
  triangle  barycentric (b1, b2) over (p0, p1, p2)
  disk      concentric frame coords mapped to [0,1]^2
Addressing is WRAP (uv scaled by per-texture tiling, then fract).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

CHECKER = 0
IMAGE = 1


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Textures:
    """All scene textures as dense tables (a frozen pytree).

    Rows with kind=CHECKER use (color_a, color_b); rows with kind=IMAGE use
    image[image_index]. Every image shares one (H, W) resolution so the
    atlas is a single static-shaped array.
    """

    kind: jax.Array         # (T,) int32 in {CHECKER, IMAGE}
    color_a: jax.Array      # (T, 3) checker "even" color (differentiable)
    color_b: jax.Array      # (T, 3) checker "odd" color (differentiable)
    scale: jax.Array        # (T, 2) uv tiling factors
    image_index: jax.Array  # (T,) int32 row into `image`; -1 for procedural
    image: jax.Array        # (Ti, H, W, 3) f32 texel atlas (differentiable)

    @property
    def n_textures(self) -> int:
        return self.kind.shape[0]


def empty() -> Textures:
    f32 = jnp.float32
    return Textures(
        kind=jnp.zeros((0,), jnp.int32),
        color_a=jnp.zeros((0, 3), f32),
        color_b=jnp.zeros((0, 3), f32),
        scale=jnp.ones((0, 2), f32),
        image_index=jnp.full((0,), -1, jnp.int32),
        image=jnp.zeros((0, 1, 1, 3), f32),
    )


def build(entries: list[dict]) -> Textures:
    """Freeze a list of texture dicts (from builders) into device tables.

    Each entry: {"kind": CHECKER|IMAGE, "color_a", "color_b", "scale",
    "image": (H, W, 3) array or None}. All images must share one resolution.
    """
    if not entries:
        return empty()
    f32 = np.float32
    z3 = np.zeros(3, f32)
    imgs = [np.asarray(e["image"], f32) for e in entries
            if e.get("image") is not None]
    if imgs:
        shp = imgs[0].shape
        for im in imgs:
            if im.shape != shp:
                raise ValueError(
                    f"all image textures must share one resolution; "
                    f"got {im.shape} vs {shp}")
        atlas = np.stack(imgs)
    else:
        atlas = np.zeros((0, 1, 1, 3), f32)
    img_idx, k = [], 0
    for e in entries:
        if e.get("image") is not None:
            img_idx.append(k)
            k += 1
        else:
            img_idx.append(-1)
    return Textures(
        kind=jnp.asarray(np.array([e["kind"] for e in entries], np.int32)),
        color_a=jnp.stack([jnp.asarray(e.get("color_a", z3), jnp.float32)
                           for e in entries]),
        color_b=jnp.stack([jnp.asarray(e.get("color_b", z3), jnp.float32)
                           for e in entries]),
        scale=jnp.asarray(np.array([e.get("scale", (1.0, 1.0))
                                    for e in entries], f32)),
        image_index=jnp.asarray(np.array(img_idx, np.int32)),
        image=jnp.asarray(atlas),
    )


def _bilinear(atlas, img_idx, st):
    """Wrap-addressed bilinear fetch. atlas: (Ti, H, W, 3); img_idx: (N,)
    valid rows; st: (N, 2) in tile space (already scaled). Linear in the
    texels => exact texel gradients under autodiff."""
    h, w = atlas.shape[1], atlas.shape[2]
    frac = st - jnp.floor(st)                       # wrap to [0,1)
    # texel-center convention: uv 0.5/w hits texel 0's center
    x = frac[:, 0] * w - 0.5
    y = frac[:, 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    xi0 = jnp.mod(x0.astype(jnp.int32), w)
    yi0 = jnp.mod(y0.astype(jnp.int32), h)
    xi1 = jnp.mod(xi0 + 1, w)
    yi1 = jnp.mod(yi0 + 1, h)
    c00 = atlas[img_idx, yi0, xi0]
    c01 = atlas[img_idx, yi0, xi1]
    c10 = atlas[img_idx, yi1, xi0]
    c11 = atlas[img_idx, yi1, xi1]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def eval_texture(tex: Textures, tid, uv):
    """Evaluate textures for a ray batch. tid: (N,) int32 rows (callers clip
    to valid range and mask lanes without a texture); uv: (N, 2). -> (N, 3).
    """
    st = uv * tex.scale[tid]
    ij = jnp.floor(st).astype(jnp.int32)
    even = ((ij[:, 0] + ij[:, 1]) & 1) == 0
    out = jnp.where(even[:, None], tex.color_a[tid], tex.color_b[tid])
    if tex.image.shape[0]:  # static: scenes without image textures skip this
        img_idx = jnp.clip(tex.image_index[tid], 0, tex.image.shape[0] - 1)
        img = _bilinear(tex.image, img_idx, st)
        out = jnp.where((tex.kind[tid] == IMAGE)[:, None], img, out)
    return out
