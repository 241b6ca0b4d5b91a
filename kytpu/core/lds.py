"""Hash-based Owen-scrambled Sobol sampling (low-discrepancy lanes).

Goes beyond the reference's sampler hierarchy (ky.cpp:877-985 — random /
debug / a stratified stub): a padded (0,2)-sequence sampler in the style of
Burley, "Practical Hash-Based Owen Scrambling" (JCGT 2020). Every draw site
(pixel, bounce, purpose) gets its own independently shuffled + scrambled
copy of the first two Sobol dimensions; the point index is the sample id.
Pairs across sites are decorrelated by the index shuffle, so the estimator
stays unbiased while each site's draws are stratified to ~O(log n / n)
discrepancy instead of O(n^-1/2).

Everything is uint32 bit arithmetic + one uint->float ladder, vectorized
over lanes — XLA maps it straight onto vector units (these helpers are for the
jnp integrators; the Pallas kernel keeps its on-core PRNG).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# direction numbers ("v" array) for the second Sobol dimension: primitive
# polynomial x^2 + x + 1, initial m = (1, 3) (Joe & Kuo tables). Dimension
# one needs no table — its matrix is the bit reversal.
def _sobol_dim1_directions() -> np.ndarray:
    m = [1, 3]
    a = 1                      # polynomial coefficient bits (degree s=2)
    s = 2
    for k in range(s, 32):
        new = m[k - s] ^ (m[k - s] << s)
        for i in range(1, s):
            if (a >> (s - 1 - i)) & 1:
                new ^= m[k - i] << i
        m.append(new)
    return np.array([m[k] << (31 - k) for k in range(32)], dtype=np.uint32)


_DIRS1 = _sobol_dim1_directions()


def reverse_bits(x):
    x = ((x >> 16) & jnp.uint32(0x0000FFFF)) | ((x & jnp.uint32(0x0000FFFF)) << 16)
    x = ((x >> 8) & jnp.uint32(0x00FF00FF)) | ((x & jnp.uint32(0x00FF00FF)) << 8)
    x = ((x >> 4) & jnp.uint32(0x0F0F0F0F)) | ((x & jnp.uint32(0x0F0F0F0F)) << 4)
    x = ((x >> 2) & jnp.uint32(0x33333333)) | ((x & jnp.uint32(0x33333333)) << 2)
    x = ((x >> 1) & jnp.uint32(0x55555555)) | ((x & jnp.uint32(0x55555555)) << 1)
    return x


def _laine_karras(x, seed):
    """Random permutation of [0, 2^32) that preserves low-bit blocks —
    an Owen scramble of the reversed-bit representation."""
    x = x + seed
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    return x


def nested_uniform_scramble(x, seed):
    """Owen scramble of x's bit tree (root = MSB)."""
    return reverse_bits(_laine_karras(reverse_bits(x), seed))


def sobol_point2(idx):
    """First two Sobol dimensions of point `idx` as uint32 fractions."""
    idx = idx.astype(jnp.uint32)
    d0 = reverse_bits(idx)
    d1 = jnp.zeros_like(idx)
    for k in range(32):
        bit = (idx >> jnp.uint32(k)) & jnp.uint32(1)
        d1 = d1 ^ (bit * jnp.uint32(_DIRS1[k]))
    return d0, d1


def _to_unit(x):
    # top 24 bits -> [0, 1): exact in f32, never returns 1.0
    return (x >> jnp.uint32(8)).astype(jnp.float32) * np.float32(1.0 / (1 << 24))


def owen_sobol2(idx, seed_shuffle, seed0, seed1):
    """Shuffled, Owen-scrambled 2D Sobol draw.

    idx: (N,) integer sample indices; seeds: (N,) uint32 per-lane hashes
    (derive them from the (pixel, bounce, purpose) PRNG key so the scramble
    is constant across samples of one pixel). Returns two (N,) f32 in [0,1).
    """
    i = nested_uniform_scramble(idx.astype(jnp.uint32), seed_shuffle)
    d0, d1 = sobol_point2(i)
    return (_to_unit(nested_uniform_scramble(d0, seed0)),
            _to_unit(nested_uniform_scramble(d1, seed1)))


def owen_sobol1(idx, seed_shuffle, seed0):
    """1D variant (bit-reversal radical inverse only)."""
    i = nested_uniform_scramble(idx.astype(jnp.uint32), seed_shuffle)
    d0 = reverse_bits(i)
    return _to_unit(nested_uniform_scramble(d0, seed0))
