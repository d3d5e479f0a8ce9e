"""Counter-based RNG for reproducible, shard-invariant sampling.

Replaces the reference's stateful PCG32 (``core/rng.h:61-64``). A stateful
generator serializes; here every sample dimension is instead a pure hash of
``(pixel_id, sample_index, dimension, seed)`` so any ray can compute any of
its sample values independently, in any order, on any shard — the render is
bit-identical regardless of device mesh layout.

The hash is pcg4d (Jarzynski & Olano, JCGT 2020) — the standard GPU-renderer
choice; passes practical equidistribution tests and is 10 integer ops.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32
# 1/2^32 in float64 then cast keeps us strictly inside [0,1)
_INV_U32 = float(1.0 / 4294967296.0)
# numpy, not jnp: a module-level jnp computation would initialize the
# default JAX backend at import time (before any CLI --cpu override)
import numpy as _np  # noqa: E402

ONE_MINUS_EPS = float(_np.nextafter(_np.float32(1.0), _np.float32(0.0)))


def pcg4d(a, b, c, d):
    """4-in/4-out mixing hash (uint32 arrays, broadcastable)."""
    v0 = a.astype(_U32)
    v1 = b.astype(_U32)
    v2 = c.astype(_U32)
    v3 = d.astype(_U32)
    mul = _U32(1664525)
    inc = _U32(1013904223)
    v0 = v0 * mul + inc
    v1 = v1 * mul + inc
    v2 = v2 * mul + inc
    v3 = v3 * mul + inc
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def hash_u32(a, b=0, c=0, d=0):
    """Single uint32 hash of up to four uint32 inputs."""
    a = jnp.asarray(a)
    b = jnp.broadcast_to(jnp.asarray(b, _U32), a.shape)
    c = jnp.broadcast_to(jnp.asarray(c, _U32), a.shape)
    d = jnp.broadcast_to(jnp.asarray(d, _U32), a.shape)
    return pcg4d(a, b, c, d)[0]


def u32_to_uniform(u) -> jnp.ndarray:
    """Map uint32 → float32 in [0, 1): top 24 bits / 2²⁴.

    The floor-of-top-24-bits form (rather than round(u)·2⁻³²) is chosen
    because it is exactly expressible on every backend — the (u>>8)
    value fits float32's mantissa, so the fused path kernel
    (ops/fused_path.py) reproduces THIS function bit-for-bit via an int32
    cast. Max output is
    (2²⁴−1)/2²⁴ < 1, so no OneMinusEpsilon clamp is needed."""
    return (u >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) \
        * jnp.float32(1.0 / 16777216.0)


def uniform(pixel_id, sample_idx, dim, seed=0) -> jnp.ndarray:
    """One uniform float in [0,1) per element; the Sampler::Get1D analogue."""
    u = pcg4d(jnp.asarray(pixel_id),
              jnp.broadcast_to(jnp.asarray(sample_idx, _U32),
                               jnp.shape(pixel_id)),
              jnp.broadcast_to(jnp.asarray(dim, _U32), jnp.shape(pixel_id)),
              jnp.broadcast_to(jnp.asarray(seed, _U32),
                               jnp.shape(pixel_id)))[0]
    return u32_to_uniform(u)


def uniform2(pixel_id, sample_idx, dim, seed=0):
    """Two uniforms (the Sampler::Get2D analogue); uses two hash outputs."""
    out = pcg4d(jnp.asarray(pixel_id),
                jnp.broadcast_to(jnp.asarray(sample_idx, _U32),
                                 jnp.shape(pixel_id)),
                jnp.broadcast_to(jnp.asarray(dim, _U32), jnp.shape(pixel_id)),
                jnp.broadcast_to(jnp.asarray(seed, _U32),
                                 jnp.shape(pixel_id)))
    return u32_to_uniform(out[0]), u32_to_uniform(out[1])
