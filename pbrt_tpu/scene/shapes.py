"""Vectorized shape intersection & area sampling.

JAX counterpart of ``src/shapes/`` + the ``Shape`` interface
(core/shape.h:51-80). Shapes live in SoA arrays; every routine is batched
over rays (and usually over primitives too, as an all-pairs (R, P) test that
XLA fuses — the BVH in scene/bvh.py narrows P for large scenes).

Implemented shape families and their reference counterparts:
- triangles    — shapes/triangle.cpp (watertight Möller–Trumbore variant)
- spheres      — shapes/sphere.cpp (full spheres; world-space center/radius)
- aaplanes     — shapes/plane.cpp (fork's AAPlaneShape :15-115)
- disks        — shapes/disk.cpp
- cylinders    — shapes/cylinder.cpp
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from pbrt_tpu.core import vecmath
from pbrt_tpu.core.vecmath import absdot, cross, dot, length_squared, normalize
from pbrt_tpu.core.sampling import (uniform_sample_sphere,
                                    uniform_sample_triangle,
                                    uniform_sample_cone, uniform_cone_pdf)

Array = Any
BIG = 1e30


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Hit:
    """Batched hit records — SurfaceInteraction's SoA analogue
    (core/interaction.h; wavelength fields ride on the integrator state)."""
    valid: Array    # (R,) bool
    t: Array        # (R,)
    p: Array        # (R,3)
    ng: Array       # (R,3) geometric normal
    ns: Array       # (R,3) shading normal
    uv: Array       # (R,2)
    prim_id: Array  # (R,) global primitive index (-1 = miss)
    # ∂p/∂u (unnormalized): the u-parametric tangent. Triangle uv gradient
    # solve (triangle.cpp:157-168); drives hair fiber frames + anisotropy.
    dpdu: Array = None  # (R,3) or None when the intersector skips it
    # ∂p/∂v: completes the parametric frame; exact for triangles, the
    # frame-completing cross product elsewhere. Feeds EWA anisotropic
    # texture filtering (core/mipmap.h:103).
    dpdv: Array = None  # (R,3) or None


# ---------------------------------------------------------------------------
# Triangles (shapes/triangle.cpp)
# ---------------------------------------------------------------------------

def intersect_triangles(o: Array, d: Array, tmax: Array,
                        v0: Array, v1: Array, v2: Array):
    """All-pairs ray×triangle test.

    o,d: (R,3); v0..v2: (T,3) static, or (R,T,3) per-ray (motion-blur verts
    already interpolated to each ray's time). Returns (t, u, v, hit): each
    (R,T). Möller–Trumbore with backface hits allowed (pbrt intersects both
    sides)."""
    V0 = v0 if v0.ndim == 3 else v0[None]   # (1|R, T, 3)
    V1 = v1 if v1.ndim == 3 else v1[None]
    V2 = v2 if v2.ndim == 3 else v2[None]
    e1 = V1 - V0
    e2 = V2 - V0
    ro = o[:, None, :] - V0               # (R,T,3)
    rd = d[:, None, :]                    # (R,1,3)
    pvec = jnp.cross(rd, e2)              # (R,T,3)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    u = jnp.sum(ro * pvec, axis=-1) * inv_det
    qvec = jnp.cross(ro, e1)
    v = jnp.sum(rd * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > 1e-4) & (t < tmax[:, None]))
    return t, u, v, hit


def intersect_triangle_paired(o: Array, d: Array, tmax: Array,
                              v0: Array, v1: Array, v2: Array):
    """Per-ray ray×triangle test (one triangle per ray; all args (R,...)).
    Returns (t, u, v, hit): each (R,)."""
    e1 = v1 - v0
    e2 = v2 - v0
    ro = o - v0
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    u = jnp.sum(ro * pvec, axis=-1) * inv_det
    qvec = jnp.cross(ro, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > 1e-4) & (t < tmax))
    return t, u, v, hit


def triangle_normal(v0: Array, v1: Array, v2: Array) -> Array:
    return normalize(cross(v1 - v0, v2 - v0))


def triangle_area(v0: Array, v1: Array, v2: Array) -> Array:
    return 0.5 * vecmath.length(cross(v1 - v0, v2 - v0))


def sample_triangle(v0, v1, v2, u):
    """Uniform area sampling (triangle.cpp Triangle::Sample).
    v0..v2, u broadcastable; returns (p, n, area_pdf_times_area=1/area)."""
    b = uniform_sample_triangle(u)
    p = (b[..., 0:1] * v0 + b[..., 1:2] * v1
         + (1.0 - b[..., 0:1] - b[..., 1:2]) * v2)
    n = triangle_normal(v0, v1, v2)
    area = triangle_area(v0, v1, v2)
    return p, n, 1.0 / jnp.maximum(area, 1e-20)


# ---------------------------------------------------------------------------
# Spheres (shapes/sphere.cpp) — world-space center + radius
# ---------------------------------------------------------------------------

def intersect_spheres(o: Array, d: Array, tmax: Array,
                      center: Array, radius: Array):
    """All-pairs ray×sphere. o,d: (R,3); center: (S,3), radius: (S,).
    Returns (t, hit): (R,S). Stable quadratic per sphere.cpp:141-150."""
    oc = o[:, None, :] - center[None, :, :]           # (R,S,3)
    a = jnp.sum(d * d, axis=-1)[:, None]              # (R,1)
    b = 2.0 * jnp.sum(oc * d[:, None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None, :]
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.sign(b) * sq)
    q = jnp.where(b == 0.0, -0.5 * sq, q)
    t0 = q / jnp.maximum(a, 1e-20)
    t1 = c / jnp.where(jnp.abs(q) > 1e-20, q, 1e-20)
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    t = jnp.where(tn > 1e-4, tn, tf)
    hit = ok & (t > 1e-4) & (t < tmax[:, None])
    return t, hit


def intersect_sphere_paired(o: Array, d: Array, tmax: Array,
                            center: Array, radius: Array):
    """Per-ray ray×sphere (one sphere per ray). Returns (t, hit): (R,)."""
    oc = o - center
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(oc * d, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.sign(b) * sq)
    q = jnp.where(b == 0.0, -0.5 * sq, q)
    t0 = q / jnp.maximum(a, 1e-20)
    t1 = c / jnp.where(jnp.abs(q) > 1e-20, q, 1e-20)
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    t = jnp.where(tn > 1e-4, tn, tf)
    hit = ok & (t > 1e-4) & (t < tmax)
    return t, hit


def sphere_normal_uv(p: Array, center: Array, radius: Array):
    n = normalize(p - center)
    phi = vecmath.spherical_phi(n)
    theta = vecmath.spherical_theta(n)
    uv = jnp.stack([phi * (0.5 / jnp.pi), theta / jnp.pi], axis=-1)
    return n, uv


def sample_sphere_from_ref(center, radius, ref_p, u):
    """Cone sampling toward the sphere from a reference point
    (sphere.cpp Sphere::Sample(ref,u) — solid-angle strategy).
    Falls back to uniform-area when ref is inside. Batched over ref_p/u.
    Returns (p, n, pdf_solid_angle)."""
    dc = center - ref_p
    dist2 = length_squared(dc)
    inside = dist2 <= radius * radius * (1.0 + 1e-4)

    # --- outside: sample cone of directions subtending the sphere
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
    sin_theta_max2 = jnp.clip(radius * radius / dist2, 0.0, 1.0)
    cos_theta_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_theta_max2))
    wc = normalize(dc)
    wcx, wcy = vecmath.coordinate_system(wc)
    dir_local = uniform_sample_cone(u, cos_theta_max)
    w = (dir_local[..., 0:1] * wcx + dir_local[..., 1:2] * wcy
         + dir_local[..., 2:3] * wc)
    # project to sphere surface: find t of closest approach hit
    cos_theta = dir_local[..., 2]
    ds = (dist * cos_theta
          - jnp.sqrt(jnp.maximum(
              radius * radius - dist2 * (1.0 - cos_theta * cos_theta), 0.0)))
    p_out = ref_p + ds[..., None] * w
    n_out = normalize(p_out - center)
    pdf_out = uniform_cone_pdf(cos_theta_max)

    # --- inside: uniform area sampling, pdf converted to solid angle
    d_sph = uniform_sample_sphere(u)
    p_in = center + radius[..., None] * d_sph if jnp.ndim(radius) \
        else center + radius * d_sph
    n_in = d_sph
    wi = p_in - ref_p
    d2 = length_squared(wi)
    wi = normalize(wi)
    area = 4.0 * jnp.pi * radius * radius
    pdf_in = d2 / jnp.maximum(absdot(n_in, -wi) * area, 1e-12)

    p = jnp.where(inside[..., None], p_in, p_out)
    n = jnp.where(inside[..., None], n_in, n_out)
    pdf = jnp.where(inside, pdf_in, pdf_out)
    return p, n, pdf


def sphere_pdf_wi(center, radius, ref_p, wi):
    """Pdf of sample_sphere_from_ref w.r.t. solid angle for direction wi,
    assuming wi actually hits the sphere (caller masks)."""
    dc = center - ref_p
    dist2 = length_squared(dc)
    inside = dist2 <= radius * radius * (1.0 + 1e-4)
    sin_theta_max2 = jnp.clip(radius * radius / jnp.maximum(dist2, 1e-20),
                              0.0, 1.0)
    cos_theta_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_theta_max2))
    pdf_cone = uniform_cone_pdf(cos_theta_max)
    # inside: area-based conversion (approximate with first hit)
    t, hit = intersect_sphere_paired(
        ref_p, wi, jnp.full(ref_p.shape[:-1], BIG),
        jnp.broadcast_to(center, ref_p.shape),
        jnp.broadcast_to(radius, ref_p.shape[:-1]))
    p = ref_p + t[..., None] * wi
    n = normalize(p - center)
    area = 4.0 * jnp.pi * radius * radius
    pdf_area = (t * t) / jnp.maximum(absdot(n, -wi) * area, 1e-12)
    pdf = jnp.where(inside, pdf_area, pdf_cone)
    return jnp.where(hit, pdf, 0.0)


# ---------------------------------------------------------------------------
# AAPlane (fork: shapes/plane.cpp:15-115)
# ---------------------------------------------------------------------------

def _axis_onehot(ax: Array) -> Array:
    return jax.nn.one_hot(ax, 3, dtype=jnp.float32)


def _select_component(v: Array, i: Array) -> Array:
    """v[..., i] per element via one-hot dot instead of a per-ray
    take_along_axis gather (see ops/fastgather.py)."""
    from pbrt_tpu.ops import fastgather
    return fastgather.select_component(v, i)


def aaplane_axes(ax: Array):
    """Return (ax0, ax1) per plane.cpp's ctor:
    ax0 = {z:0, x:1, y:2}[axis], ax1 = {z:1, x:2, y:0}[axis]."""
    ax0 = jnp.where(ax == 2, 0, jnp.where(ax == 0, 1, 2))
    ax1 = jnp.where(ax == 2, 1, jnp.where(ax == 0, 2, 0))
    return ax0, ax1


def aaplane_normal(ax: Array, facing_fw: Array) -> Array:
    """plane.cpp:95-104 Normal(): +axis, negated when not facing forward."""
    n = _axis_onehot(ax)
    return jnp.where(facing_fw[..., None], n, -n)


def aaplane_area(lo: Array, hi: Array, ax: Array) -> Array:
    ax0, ax1 = aaplane_axes(ax)
    d = hi - lo
    take = _select_component  # one-hot dot, not a per-ray gather
    return take(d, ax0) * take(d, ax1)


def intersect_aaplanes(o: Array, d: Array, tmax: Array,
                       lo: Array, hi: Array, ax: Array):
    """All-pairs ray×axis-aligned-rectangle (plane.cpp:15-55).
    o,d: (R,3); lo,hi: (P,3); ax: (P,). Returns (t, u, v, hit): (R,P)."""
    axo = _axis_onehot(ax)                                  # (P,3)
    d_ax = jnp.sum(d[:, None, :] * axo[None], axis=-1)      # (R,P)
    o_ax = jnp.sum(o[:, None, :] * axo[None], axis=-1)
    lo_ax = jnp.sum(lo * axo, axis=-1)                      # (P,)
    t = (lo_ax[None] - o_ax) / jnp.where(jnp.abs(d_ax) > 1e-12, d_ax, 1e-12)
    p = o[:, None, :] + t[..., None] * d[:, None, :]        # (R,P,3)
    ax0, ax1 = aaplane_axes(ax)
    oh0 = jax.nn.one_hot(ax0, 3, dtype=p.dtype)     # (P,3)
    oh1 = jax.nn.one_hot(ax1, 3, dtype=p.dtype)
    take_b = _select_component
    p0 = jnp.sum(p * oh0[None], axis=-1)            # (R,P)
    p1 = jnp.sum(p * oh1[None], axis=-1)
    lo0, lo1 = take_b(lo, ax0), take_b(lo, ax1)
    hi0, hi1 = take_b(hi, ax0), take_b(hi, ax1)
    u = (p0 - lo0[None]) / jnp.maximum(hi0 - lo0, 1e-12)[None]
    v = (p1 - lo1[None]) / jnp.maximum(hi1 - lo1, 1e-12)[None]
    hit = ((jnp.abs(d_ax) > 1e-12) & (t > 1e-4) & (t < tmax[:, None])
           & (p0 > lo0[None]) & (p0 < hi0[None])
           & (p1 > lo1[None]) & (p1 < hi1[None]))
    return t, u, v, hit


def intersect_aaplane_paired(o: Array, d: Array, tmax: Array,
                             lo: Array, hi: Array, ax: Array):
    """Per-ray ray×aaplane test (one plane per ray; all args (R,...)).
    Returns (t, u, v, hit): each (R,)."""
    axo = _axis_onehot(ax)                       # (R,3)
    d_ax = jnp.sum(d * axo, axis=-1)
    o_ax = jnp.sum(o * axo, axis=-1)
    lo_ax = jnp.sum(lo * axo, axis=-1)
    t = (lo_ax - o_ax) / jnp.where(jnp.abs(d_ax) > 1e-12, d_ax, 1e-12)
    p = o + t[..., None] * d
    ax0, ax1 = aaplane_axes(ax)
    take = _select_component
    p0, p1 = take(p, ax0), take(p, ax1)
    lo0, lo1 = take(lo, ax0), take(lo, ax1)
    hi0, hi1 = take(hi, ax0), take(hi, ax1)
    u = (p0 - lo0) / jnp.maximum(hi0 - lo0, 1e-12)
    v = (p1 - lo1) / jnp.maximum(hi1 - lo1, 1e-12)
    hit = ((jnp.abs(d_ax) > 1e-12) & (t > 1e-4) & (t < tmax)
           & (p0 > lo0) & (p0 < hi0) & (p1 > lo1) & (p1 < hi1))
    return t, u, v, hit


def sample_aaplane(lo, hi, ax, facing_fw, u):
    """Uniform area sampling (plane.cpp:57-78 Sample).
    lo,hi: (...,3); u: (...,2). Returns (p, n, area_pdf)."""
    ax0, ax1 = aaplane_axes(ax)
    take = _select_component
    oh = _axis_onehot(ax)
    oh0 = jax.nn.one_hot(ax0, 3, dtype=jnp.float32)
    oh1 = jax.nn.one_hot(ax1, 3, dtype=jnp.float32)
    p = (oh * jnp.sum(lo * oh, axis=-1, keepdims=True)
         + oh0 * (take(lo, ax0)
                  + (take(hi, ax0) - take(lo, ax0)) * u[..., 0])[..., None]
         + oh1 * (take(lo, ax1)
                  + (take(hi, ax1) - take(lo, ax1)) * u[..., 1])[..., None])
    n = aaplane_normal(ax, facing_fw)
    pdf = 1.0 / jnp.maximum(aaplane_area(lo, hi, ax), 1e-20)
    return p, n, pdf


def aaplane_in_front(p: Array, lo: Array, ax: Array, facing_fw: Array
                     ) -> Array:
    """plane.cpp:109-115 InFront half-space test; batched over p."""
    take = _select_component
    p_ax = jnp.sum(p * _axis_onehot(ax), axis=-1)
    lo_ax = take(lo, ax) if lo.ndim == p.ndim else jnp.sum(
        lo * _axis_onehot(ax), axis=-1)
    return jnp.where(facing_fw, p_ax > lo_ax, p_ax < lo_ax)


def aaplane_corners(lo: Array, hi: Array, ax: Array):
    """V0..V3 corner accessors (plane.cpp:85-107): V0=lo, V2=hi,
    V1 = lo with ax1 from hi, V3 = lo with ax0 from hi."""
    ax0, ax1 = aaplane_axes(ax)
    oh = _axis_onehot(ax)
    oh0 = jax.nn.one_hot(ax0, 3, dtype=jnp.float32)
    oh1 = jax.nn.one_hot(ax1, 3, dtype=jnp.float32)
    v0 = lo
    v2 = hi
    v1 = oh * jnp.sum(lo * oh, -1, keepdims=True) \
        + oh0 * jnp.sum(lo * oh0, -1, keepdims=True) \
        + oh1 * jnp.sum(hi * oh1, -1, keepdims=True)
    v3 = oh * jnp.sum(lo * oh, -1, keepdims=True) \
        + oh0 * jnp.sum(hi * oh0, -1, keepdims=True) \
        + oh1 * jnp.sum(lo * oh1, -1, keepdims=True)
    return v0, v1, v2, v3


# ---------------------------------------------------------------------------
# Disks (shapes/disk.cpp) — world-space center/normal/radius
# ---------------------------------------------------------------------------

def intersect_disks(o: Array, d: Array, tmax: Array,
                    center: Array, normal: Array, radius: Array,
                    inner_radius: Array):
    """All-pairs ray×disk. center,normal: (D,3); radius: (D,)."""
    denom = jnp.sum(d[:, None, :] * normal[None], axis=-1)   # (R,D)
    t = jnp.sum((center[None] - o[:, None, :]) * normal[None], axis=-1) \
        / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
    p = o[:, None, :] + t[..., None] * d[:, None, :]
    r2 = jnp.sum((p - center[None]) ** 2, axis=-1)
    hit = ((jnp.abs(denom) > 1e-12) & (t > 1e-4) & (t < tmax[:, None])
           & (r2 <= (radius * radius)[None])
           & (r2 >= (inner_radius * inner_radius)[None]))
    return t, hit


# ---------------------------------------------------------------------------
# Cubic Bézier curves (shapes/curve.cpp) — analytic intersection
# ---------------------------------------------------------------------------

CURVE_SEGMENTS = 32  # static refinement: pbrt recurses to maxDepth≈5 and
                     # runs the same linear-segment leaf test on each of
                     # 2^depth spans (curve.cpp:147-163 leaf math); a fixed
                     # fori over 32 spans is the compiler-friendly
                     # equivalent (no divergent recursion)


def bezier_point(cp: Array, u: Array) -> Array:
    """Cubic Bézier evaluation; cp (...,4,3), u (...)."""
    u = u[..., None]
    u1 = 1.0 - u
    return (u1 ** 3 * cp[..., 0, :] + 3 * u1 ** 2 * u * cp[..., 1, :]
            + 3 * u1 * u ** 2 * cp[..., 2, :] + u ** 3 * cp[..., 3, :])


def bezier_tangent(cp: Array, u: Array) -> Array:
    u = u[..., None]
    u1 = 1.0 - u
    return 3.0 * (u1 ** 2 * (cp[..., 1, :] - cp[..., 0, :])
                  + 2 * u1 * u * (cp[..., 2, :] - cp[..., 1, :])
                  + u ** 2 * (cp[..., 3, :] - cp[..., 2, :]))


def _ray_frame(d: Array):
    """Orthonormal ray-space frame: z along the (normalized) direction
    (the LookAt objectToRay of curve.cpp:93-104)."""
    from pbrt_tpu.core import vecmath
    dn = normalize(d)
    e1, e2 = vecmath.coordinate_system(dn)
    return dn, e1, e2


def curve_slerp_normal(n: Array, u: Array):
    """Ribbon orientation normal at parameter u: spherical lerp between
    the u=0/1 normals (curve.cpp:44-58 + :169 Slerp). n: (...,2,3);
    u broadcastable to n[...,0,0]. Returns (...,3) (unnormalized-safe)."""
    n0 = n[..., 0, :]
    n1 = n[..., 1, :]
    cosang = jnp.clip(jnp.sum(n0 * n1, -1), -1.0, 1.0)
    ang = jnp.arccos(cosang)
    sinang = jnp.sin(ang)
    safe = sinang > 1e-4
    s0 = jnp.where(safe, jnp.sin((1.0 - u) * ang)
                   / jnp.maximum(sinang, 1e-9), 1.0 - u)
    s1 = jnp.where(safe, jnp.sin(u * ang)
                   / jnp.maximum(sinang, 1e-9), u)
    return s0[..., None] * n0 + s1[..., None] * n1


def intersect_curves(o: Array, d: Array, tmax: Array, cp: Array, w: Array,
                     n: Array = None):
    """All-pairs ray×curve (curve.cpp Curve::intersect).

    o,d: (R,3); cp: (N,4,3) world-space control points; w: (N,2) widths at
    u=0/1; n: (N,2,3) ribbon orientation normals or None (zero rows =
    flat/cylinder). Returns (t, u, v, hit): each (R,N); v ∈ [0,1] is the
    offset across the width (hair h = 2v−1), t in units of |d|=1 rays.

    Per span [u_i, u_{i+1}]: project onto the ray frame, closest approach
    of the 2D chord to the ray axis, width test at the interpolated u —
    exactly the reference's recursion-leaf segment test, scanned over
    CURVE_SEGMENTS static spans. Ribbon rows scale the visible width by
    |n(u)·d| (curve.cpp:165-172).
    """
    R = o.shape[0]
    N = cp.shape[0]
    dn, e1, e2 = _ray_frame(d)
    inv_len_d = 1.0  # callers pass unit-ish d; t reported along dn
    is_ribbon = (jnp.sum(n[:, 0] * n[:, 0], -1) > 1e-12) if n is not None \
        else None

    def ray_space(p_world):
        q = p_world - o[:, None, :]
        return jnp.stack([jnp.sum(q * e1[:, None, :], -1),
                          jnp.sum(q * e2[:, None, :], -1),
                          jnp.sum(q * dn[:, None, :], -1)], axis=-1)

    us = jnp.linspace(0.0, 1.0, CURVE_SEGMENTS + 1)
    w0 = w[None, :, 0]
    w1 = w[None, :, 1]

    best = (jnp.full((R, N), BIG), jnp.zeros((R, N)), jnp.zeros((R, N)),
            jnp.zeros((R, N), bool), ray_space(bezier_point(cp[None], us[0]
                                                            * jnp.ones((1, N)))))

    def body(i, carry):
        bt, bu, bv, bh, a = carry
        ui = us[i]
        uj = us[i + 1]
        b = ray_space(bezier_point(cp[None], uj * jnp.ones((1, N))))
        abx = b[..., 0] - a[..., 0]
        aby = b[..., 1] - a[..., 1]
        denom = jnp.maximum(abx * abx + aby * aby, 1e-12)
        s = jnp.clip(-(a[..., 0] * abx + a[..., 1] * aby) / denom, 0.0, 1.0)
        pc = a + s[..., None] * (b - a)
        u_hit = ui + s * (uj - ui)
        hw = 0.5 * (w0 * (1.0 - u_hit) + w1 * u_hit)
        if is_ribbon is not None:
            nhit = curve_slerp_normal(n[None], u_hit)        # (R,N,3)
            cosr = jnp.abs(jnp.sum(nhit * dn[:, None, :], -1)) \
                / jnp.maximum(jnp.linalg.norm(nhit, axis=-1), 1e-9)
            hw = jnp.where(is_ribbon[None], hw * cosr, hw)
        dist2 = pc[..., 0] ** 2 + pc[..., 1] ** 2
        t = pc[..., 2]
        hit = (dist2 <= hw * hw) & (t > 1e-4) & (t < tmax[:, None]) \
            & (t < bt)
        # side of the chord → v sign (curve.cpp:173-180 hitWidth offset)
        side = pc[..., 0] * (-aby) + pc[..., 1] * abx
        dist = jnp.sqrt(jnp.maximum(dist2, 0.0))
        v = 0.5 + jnp.sign(side) * dist / jnp.maximum(2.0 * hw, 1e-9)
        bt = jnp.where(hit, t, bt)
        bu = jnp.where(hit, u_hit, bu)
        bv = jnp.where(hit, jnp.clip(v, 0.0, 1.0), bv)
        bh = bh | hit
        return bt, bu, bv, bh, b

    bt, bu, bv, bh, _ = jax.lax.fori_loop(0, CURVE_SEGMENTS, body, best)
    return bt, bu, bv, bh


def curve_hit_frame(o: Array, d: Array, cp: Array, w: Array, u: Array,
                    v: Array, p: Array, nrows: Array = None):
    """Shading attributes at a curve hit: dpdu = fiber tangent (drives the
    hair BSDF frame); normal = view-perpendicularized −d (flat/cylinder
    shading normal role, curve.cpp:213-230), or the slerped orientation
    normal for ribbon rows (curve.cpp Ribbon dpdv, :213-218).
    cp: (R,4,3) gathered rows; nrows: (R,2,3) gathered ribbon normals."""
    tang = bezier_tangent(cp, u)
    tang = normalize(tang)
    dn = normalize(d)
    n = -dn + tang * jnp.sum(dn * tang, -1, keepdims=True)
    n = normalize(jnp.where(jnp.sum(n * n, -1, keepdims=True) > 1e-12, n,
                            jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]),
                                             n.shape)))
    if nrows is not None:
        is_rib = jnp.sum(nrows[:, 0] * nrows[:, 0], -1) > 1e-12
        n_rib = curve_slerp_normal(nrows, u)
        n_rib = normalize(jnp.where(
            jnp.sum(n_rib * n_rib, -1, keepdims=True) > 1e-12, n_rib,
            n))
        n = jnp.where(is_rib[..., None], n_rib, n)
    return tang, n
