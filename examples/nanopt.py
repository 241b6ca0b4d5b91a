"""nanopt, the wavefront way — a minimal JAX path tracer in ~100 lines.

The reference grows from a 110-line CPU tracer (smallpt2pbrt/nanopt.cpp:
8 spheres, diffuse+mirror, recursive radiance, OpenMP rows) to the full
framework. This is the same pedagogy for the data-parallel design: one ray per lane,
a masked `lax.scan` instead of recursion, counter-based RNG instead of
erand48, and the whole image as a single jitted wavefront.

  python examples/nanopt.py [spp]   # writes nanopt.ppm
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

# scene: 8 spheres — walls / mirror ball / light (nanopt.cpp:26-37 layout,
# scaled by 1/100 for float32). Row: center xyz, radius, albedo rgb,
# emission rgb, is_mirror. Huge spheres approximate the box walls; e.g. the
# left wall is a radius-1000 sphere whose surface sits at x = 0.01.
S = np.array([
    # cx,       cy,       cz,        r,    ar,  ag,  ab,   er, eg, eb, mir
    [-1e3+.01,  .408,     .816,      1e3,  .75, .25, .25,  0,  0,  0,  0],  # left (x=.01)
    [1e3+.99,   .408,     .816,      1e3,  .25, .25, .75,  0,  0,  0,  0],  # right (x=.99)
    [.5,        .408,     -1e3,      1e3,  .75, .75, .75,  0,  0,  0,  0],  # back (z=0)
    [.5,        .408,     1e3+1.70,  1e3,  0,   0,   0,    0,  0,  0,  0],  # front (z=1.70)
    [.5,        -1e3,     .816,      1e3,  .75, .75, .75,  0,  0,  0,  0],  # floor (y=0)
    [.5,        1e3+.816, .816,      1e3,  .75, .75, .75,  0,  0,  0,  0],  # ceiling (y=.816)
    [.27,       .165,     .47,       .165, .999,.999,.999, 0,  0,  0,  1],  # mirror ball
    [.5,        6.8133,   .816,      6.0,  0,   0,   0,   12, 12, 12,  0],  # light
], np.float32)
C, R, ALB, EMI, MIR = (jnp.asarray(S[:, :3]), jnp.asarray(S[:, 3]),
                       jnp.asarray(S[:, 4:7]), jnp.asarray(S[:, 7:10]),
                       jnp.asarray(S[:, 10]))


def hit(o, d):
    oc = C[None] - o[:, None]                       # (N, 8, 3)
    b = jnp.einsum("nsk,nk->ns", oc, d)
    disc = b * b - jnp.sum(oc * oc, -1) + R[None] ** 2
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1, t2 = b - sq, b + sq
    t = jnp.where(t1 > 1e-4, t1, jnp.where(t2 > 1e-4, t2, jnp.inf))
    t = jnp.where(disc >= 0, t, jnp.inf)
    i = jnp.argmin(t, 1)
    tb = jnp.take_along_axis(t, i[:, None], 1)[:, 0]
    return tb, i, jnp.isfinite(tb)


def radiance(o, d, key, depth=5):
    n_lanes = o.shape[0]

    def body(carry, b):
        o, d, beta, acc, alive = carry
        t, i, ok = hit(o, d)
        acc = acc + jnp.where((alive & ok)[:, None], beta * EMI[i], 0.0)
        p = o + t[:, None] * d
        n = (p - C[i]) / R[i][:, None]
        n = jnp.where(jnp.einsum("nk,nk->n", n, d)[:, None] < 0, n, -n)
        u = jax.random.uniform(jax.random.fold_in(key, b), (n_lanes, 2))
        # cosine hemisphere about n
        w = n
        a = jnp.where(jnp.abs(w[:, :1]) > 0.9,
                      jnp.asarray([[0.0, 1.0, 0.0]]),
                      jnp.asarray([[1.0, 0.0, 0.0]]))
        v = jnp.cross(w, a); v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
        uu = jnp.cross(v, w)
        r1 = 2 * jnp.pi * u[:, 0]
        r2 = u[:, 1]; r2s = jnp.sqrt(r2)
        d_diff = (uu * (jnp.cos(r1) * r2s)[:, None]
                  + v * (jnp.sin(r1) * r2s)[:, None]
                  + w * jnp.sqrt(1 - r2)[:, None])
        d_mirr = d - 2 * jnp.einsum("nk,nk->n", n, d)[:, None] * n
        d_new = jnp.where(MIR[i][:, None] > 0, d_mirr, d_diff)
        beta = beta * jnp.where(alive[:, None], ALB[i], 1.0)
        alive = alive & ok & (jnp.max(ALB[i], -1) > 0)
        return (p + 1e-3 * d_new, d_new, beta, acc, alive), None

    init = (o, d, jnp.ones_like(o), jnp.zeros_like(o),
            jnp.ones(n_lanes, bool))
    (_, _, _, acc, _), _ = jax.lax.scan(body, init, jnp.arange(depth))
    return acc


def main(spp=16, w=256, h=256):
    key = jax.random.key(0)
    ys, xs = np.divmod(np.arange(w * h), w)
    cam_o = jnp.asarray([0.5, 0.52, 2.956])
    cam_d = jnp.asarray([0.0, -0.042612, -1.0])
    cam_d = cam_d / jnp.linalg.norm(cam_d)
    cx = jnp.asarray([w * 0.5135 / h, 0.0, 0.0])
    cy = jnp.cross(cx, cam_d); cy = cy / jnp.linalg.norm(cy) * 0.5135
    acc = jnp.zeros((w * h, 3))
    render = jax.jit(radiance)
    for s in range(spp):
        u = jax.random.uniform(jax.random.fold_in(key, 1000 + s), (w * h, 2))
        px = (jnp.asarray(xs) + u[:, 0]) / w - 0.5
        py = -((jnp.asarray(ys) + u[:, 1]) / h - 0.5)
        d = cx[None] * px[:, None] + cy[None] * py[:, None] + cam_d[None]
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        # smallpt advances the origin 140 units (1.4 scaled) into the box
        acc = acc + render(jnp.broadcast_to(cam_o, (w * h, 3)) + 1.4 * d, d,
                           jax.random.fold_in(key, s))
    img = np.asarray(jnp.clip(acc / spp, 0, 1)).reshape(h, w, 3)
    g = (np.clip(img, 0, 1) ** (1 / 2.2) * 255 + 0.5).astype(np.uint8)
    with open("nanopt.ppm", "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write(" ".join(map(str, g.reshape(-1))))
    print("wrote nanopt.ppm")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
