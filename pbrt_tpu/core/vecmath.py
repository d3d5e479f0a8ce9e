"""Vector/geometry math over batched ``(..., 3)`` arrays.

JAX counterpart of the reference's ``core/geometry.h`` (Vector3f,
Point3f, Normal3f, Ray, Bounds3f — /root/reference/src/core/geometry.h:1023-1060).
There are no separate Point/Vector/Normal classes: everything is a jnp array
with a trailing dimension of 3 (or 4 for wavelength packets), so every op
vectorizes across the ray batch ("structure of arrays").

Rays are pytrees (see :class:`Ray`) carrying origin/direction/tmax and the
hero-wavelength packet ``wvls`` (fork addition, core/geometry.h:1039).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

Array = Any

INF = jnp.inf
MACHINE_EPS = jnp.finfo(jnp.float32).eps * 0.5
SHADOW_EPS = 1e-3  # conservative ray-offset epsilon (replaces EFloat bounds)


def gamma(n: int) -> float:
    """pbrt's gamma(n) FP error bound (core/pbrt.h)."""
    g = n * float(MACHINE_EPS)
    return g / (1.0 - g)


# ---------------------------------------------------------------------------
# basic ops
# ---------------------------------------------------------------------------

def dot(a: Array, b: Array) -> Array:
    return jnp.sum(a * b, axis=-1)


def absdot(a: Array, b: Array) -> Array:
    return jnp.abs(dot(a, b))


def cross(a: Array, b: Array) -> Array:
    return jnp.cross(a, b)


def length_squared(v: Array) -> Array:
    return jnp.sum(v * v, axis=-1)


def length(v: Array) -> Array:
    return jnp.sqrt(length_squared(v))


def normalize(v: Array) -> Array:
    return v * jax.lax.rsqrt(jnp.maximum(length_squared(v), 1e-30))[..., None]


def distance(a: Array, b: Array) -> Array:
    return length(a - b)


def distance_squared(a: Array, b: Array) -> Array:
    return length_squared(a - b)


def lerp(t: Array, a: Array, b: Array) -> Array:
    return (1.0 - t) * a + t * b


def face_forward(n: Array, v: Array) -> Array:
    """Flip n so it lies in the same hemisphere as v (geometry.h Faceforward)."""
    return jnp.where(dot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v1: Array):
    """Build an orthonormal basis around unit vector v1 (geometry.h:237).

    Uses the branchless Duff et al. construction (stable, vectorizes cleanly —
    unlike the reference's if/else on |x|>|y|).
    """
    s = jnp.where(v1[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + v1[..., 2])
    b = v1[..., 0] * v1[..., 1] * a
    v2 = jnp.stack(
        [1.0 + s * v1[..., 0] ** 2 * a, s * b, -s * v1[..., 0]], axis=-1)
    v3 = jnp.stack([b, s + v1[..., 1] ** 2 * a, -v1[..., 1]], axis=-1)
    return v2, v3


def spherical_direction(sin_theta: Array, cos_theta: Array, phi: Array,
                        x: Array = None, y: Array = None, z: Array = None) -> Array:
    """geometry.h SphericalDirection; optional basis (x,y,z)."""
    d = jnp.stack([sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi),
                   cos_theta], axis=-1)
    if x is None:
        return d
    return (d[..., 0:1] * x + d[..., 1:2] * y + d[..., 2:3] * z)


def spherical_theta(v: Array) -> Array:
    return jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))


def spherical_phi(v: Array) -> Array:
    p = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(p < 0.0, p + 2.0 * jnp.pi, p)


def reflect(wo: Array, n: Array) -> Array:
    """reflection.h Reflect: -wo + 2 dot(wo,n) n."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi: Array, n: Array, eta: Array):
    """reflection.h Refract. Returns (wt, valid_mask).

    ``eta`` is eta_i/eta_t; n is oriented to the same side as wi.
    """
    cos_theta_i = dot(n, wi)
    sin2_theta_i = jnp.maximum(0.0, 1.0 - cos_theta_i * cos_theta_i)
    sin2_theta_t = eta * eta * sin2_theta_i
    valid = sin2_theta_t < 1.0
    cos_theta_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_theta_t))
    wt = (eta[..., None] * -wi
          + (eta * cos_theta_i - cos_theta_t)[..., None] * n)
    return wt, valid


def offset_ray_origin(p: Array, n: Array, w: Array) -> Array:
    """Robust shadow-ray origin offset (interaction.h:66-80 / OffsetRayOrigin).

    The reference tracks EFloat error bounds; a scaled-normal offset is
    cheaper and adequate for float32 scenes (scale chosen per pbrt-v4's
    practice of offsetting along the normal).
    """
    nf = face_forward(n, w)
    scale = SHADOW_EPS * jnp.maximum(1.0, jnp.max(jnp.abs(p), axis=-1))
    return p + scale[..., None] * nf


# ---------------------------------------------------------------------------
# Ray pytree
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Ray:
    """A batch of rays (geometry.h:1023-1044). ``wvls`` is the fork's
    4-wavelength hero packet (geometry.h:1039); zeros when not in HWSS mode."""
    o: Array        # (..., 3)
    d: Array        # (..., 3)
    tmax: Array     # (...,)
    wvls: Array     # (..., 4)

    def at(self, t: Array) -> Array:
        return self.o + t[..., None] * self.d


def make_ray(o: Array, d: Array, tmax: Array = None, wvls: Array = None) -> Ray:
    if tmax is None:
        tmax = jnp.full(o.shape[:-1], INF, o.dtype)
    if wvls is None:
        wvls = jnp.zeros(o.shape[:-1] + (4,), o.dtype)
    return Ray(o=o, d=d, tmax=tmax, wvls=wvls)


# ---------------------------------------------------------------------------
# Bounds3
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Bounds3:
    """Axis-aligned bounding boxes, batched (geometry.h Bounds3f)."""
    lo: Array  # (..., 3)
    hi: Array  # (..., 3)

    def diagonal(self) -> Array:
        return self.hi - self.lo

    def surface_area(self) -> Array:
        d = self.diagonal()
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    def centroid(self) -> Array:
        return 0.5 * (self.lo + self.hi)


def bounds_union(a: Bounds3, b: Bounds3) -> Bounds3:
    return Bounds3(jnp.minimum(a.lo, b.lo), jnp.maximum(a.hi, b.hi))


def bounds_intersect_p(lo: Array, hi: Array, o: Array, inv_d: Array,
                       tmax: Array) -> Array:
    """Slab test, batched; mirrors Bounds3::IntersectP (geometry.h:1388+).

    Returns a bool mask. Robust to inf*0 via jnp.minimum/maximum NaN rules
    handled by clipping.
    """
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tnear = jnp.minimum(t0, t1)
    tfar = jnp.maximum(t0, t1)
    # pbrt scales tFar by (1 + 2*gamma(3)) for conservative traversal
    tfar = tfar * (1.0 + 2.0 * gamma(3))
    t_enter = jnp.max(tnear, axis=-1)
    t_exit = jnp.min(tfar, axis=-1)
    return (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter < tmax)
