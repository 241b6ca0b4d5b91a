"""Component-plane ("structure of planes") 3-vector algebra.

Inside a Pallas kernel a (N, 3) vector array would be a non-power-of-two
block and would interleave components across threads. Instead each
3-vector field is three separate (rows, 128) planes, and this module gives
them vector-algebra semantics so kernel code reads like the jnp reference
implementation (kytpu/core/math.py) it mirrors.

Everything is plain jnp on whatever array shape the components have, so the
same code runs inside pallas_call, in interpreter mode, and in unit tests
on (N,)-shaped numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


def _const_of(v):
    """The python float of a baked scalar constant, else None (traced)."""
    if isinstance(v, (float, int, np.floating, np.integer)):
        return float(v)
    return None


def _cmul(a, b):
    """a * b with trace-time folding of exact 0 / +-1 CONSTANT factors.

    Scene geometry is baked into the kernels as host constants, and
    axis-aligned boxes (cornell, the veach floor/wall planes) make most
    normal / dual-basis components exactly 0 or +-1. The kernel compilers do NOT
    fold x*0 -> 0 (invalid under IEEE without fast-math), so without
    this every such dead multiply executes. Folding here is
    exact for finite operands (the skipped terms are identically +-0)."""
    ca, cb = _const_of(a), _const_of(b)
    c, v = (ca, b) if ca is not None else (cb, a)
    if c is None:
        return a * b
    if c == 0.0:
        return None
    if c == 1.0:
        return v
    if c == -1.0:
        return -v
    return np.float32(c) * v


@dataclass(frozen=True)
class V3:
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic (component-wise; scalar or plane operands) --
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def dot(self, o: "V3"):
        terms = [t for t in (_cmul(self.x, o.x), _cmul(self.y, o.y),
                             _cmul(self.z, o.z)) if t is not None]
        if not terms:
            for v in (self.x, self.y, self.z, o.x, o.y, o.z):
                if _const_of(v) is None:
                    return jnp.zeros_like(v)
            return np.float32(0.0)
        r = terms[0]
        for t in terms[1:]:
            r = r + t
        return r

    def cross(self, o: "V3") -> "V3":
        return V3(self.y * o.z - self.z * o.y,
                  self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def length_squared(self):
        return self.dot(self)

    def length(self):
        return jnp.sqrt(self.length_squared())

    def normalize(self) -> "V3":
        inv = jax.lax.rsqrt(jnp.maximum(self.length_squared(), 1e-20))
        return self * inv

    def max_component(self):
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def where(self, cond, other: "V3") -> "V3":
        """cond ? self : other (per lane)."""
        return V3(jnp.where(cond, self.x, other.x),
                  jnp.where(cond, self.y, other.y),
                  jnp.where(cond, self.z, other.z))

    def is_black(self):
        return (self.x <= 0.0) & (self.y <= 0.0) & (self.z <= 0.0)


def v3_full(like, x, y, z) -> V3:
    """Broadcast three python/scalar constants to `like`'s plane shape."""
    ones = jnp.ones_like(like)
    return V3(ones * x, ones * y, ones * z)


# V3 crosses lax.fori_loop / lax.cond boundaries inside the kernels
jax.tree_util.register_dataclass(V3, data_fields=["x", "y", "z"],
                                 meta_fields=[])


def v3_zeros(like) -> V3:
    z = jnp.zeros_like(like)
    return V3(z, z, z)


def make_frame(n: V3) -> tuple[V3, V3, V3]:
    """Orthonormal basis about unit n — SmallVCM/frame_t construction
    (ky.cpp:566-571 via kytpu/core/frame.py).

    The helper cross product is specialized to the one-hot helper axis
    ((0,1,0) when |n.x| > 0.99 else (1,0,0)) and both normalizations use
    rsqrt — per-frame cost drops by 2 divides and ~6 mul/sub versus
    the generic cross form, at <=1ulp value drift (frames are built 7x
    per bounce in the veach NEE path: hit + 5 lights + phong sample)."""
    use_y = jnp.abs(n.x) > 0.99
    zero = jnp.zeros_like(n.x)
    t = V3(jnp.where(use_y, -n.z, zero),
           jnp.where(use_y, zero, n.z),
           jnp.where(use_y, n.x, -n.y))
    t = t * jax.lax.rsqrt(jnp.maximum(t.length_squared(), 1e-20))
    s = t.cross(n)
    s = s * jax.lax.rsqrt(jnp.maximum(s.length_squared(), 1e-20))
    return s, t, n


def to_local(s: V3, t: V3, n: V3, w: V3) -> V3:
    return V3(w.dot(s), w.dot(t), w.dot(n))


def to_world(s: V3, t: V3, n: V3, w: V3) -> V3:
    return s * w.x + t * w.y + n * w.z
