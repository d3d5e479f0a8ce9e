"""Light portals: frustum tests + the three sampling strategies.

JAX counterpart of the fork's ``src/portals/`` (Portal interface
portal.h:8-34, AAPortal aaportal.cpp) + PortalArealight estimator dispatch
(lights/portal_arealight.cpp:29-239). Everything is batched over shading
points with the portal dimension padded to lights.MAXP.

Reference semantics preserved:
- InFront: half-space test against the portal plane (aaportal.cpp:101 via
  plane.cpp:109-115).
- InFrustum: the reference short-circuits ``true`` (aaportal.cpp:101-103);
  we keep the frustum-plane precompute available but match that behavior.
- Visible-portal selection: uniform among in-front portals
  (portal_arealight.cpp:44-98); behind-all → fall back to light sampling;
  zero-weight → black.
- SamplePortal: uniform area on the portal, solid-angle pdf
  (aaportal.cpp:73-86).
- SampleProj: project the light rect from the shading point onto the portal
  plane, clip against the portal rect, sample the clipped rect
  (aaportal.cpp:114-159). Two reference bugs are *not* reproduced: it reuses
  u.x for both rect axes (we use u.x/u.y) and never guards an empty clip
  (we return pdf=0); both are clear implementation slips against the
  thesis's stated estimator.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from pbrt_tpu.core import vecmath
from pbrt_tpu.core.vecmath import absdot, normalize
from pbrt_tpu.scene import shapes

Array = Any


def portals_in_front(p: Array, g_lights) -> Array:
    """(R, MAXP) mask: portal j of each ray's light is valid and p is on the
    forward side (portal_arealight.cpp:52-56)."""
    R = p.shape[0]
    maxp = g_lights.portal_lo.shape[1]
    pexp = p[:, None, :]  # (R,1,3)
    in_front = shapes.aaplane_in_front(
        jnp.broadcast_to(pexp, (R, maxp, 3)).reshape(R * maxp, 3),
        g_lights.portal_lo.reshape(R * maxp, 3),
        g_lights.portal_ax.reshape(R * maxp),
        g_lights.portal_facing.reshape(R * maxp)).reshape(R, maxp)
    valid = jnp.arange(maxp)[None, :] < g_lights.n_portals[:, None]
    return in_front & valid


def select_visible_portal(in_front: Array, u: Array):
    """Uniformly pick one in-front portal per ray
    (portal_arealight.cpp:75-98's Distribution1D over dist[i]=1).

    Returns (portal_idx (R,), select_pdf (R,), behind_all (R,)).
    """
    w = in_front.astype(jnp.float32)
    count = jnp.sum(w, axis=-1)
    behind_all = count == 0.0
    # k-th visible portal with k = floor(u * count)
    k = jnp.minimum((u * count).astype(jnp.int32),
                    jnp.maximum(count.astype(jnp.int32) - 1, 0))
    csum = jnp.cumsum(w, axis=-1)  # rank of portal j among visible = csum-1
    is_kth = in_front & ((csum - 1.0).astype(jnp.int32) == k[:, None])
    idx = jnp.argmax(is_kth, axis=-1)
    pdf = jnp.where(behind_all, 0.0, 1.0 / jnp.maximum(count, 1.0))
    return idx, pdf, behind_all


def _gather_portal(g_lights, pidx: Array):
    # one-hot contraction over the portal slot (ops/fastgather.py) instead
    # of an advanced-index per-ray gather
    from pbrt_tpu.ops import fastgather
    return (fastgather.select_row(g_lights.portal_lo, pidx),
            fastgather.select_row(g_lights.portal_hi, pidx),
            fastgather.select_row(g_lights.portal_ax, pidx),
            fastgather.select_row(g_lights.portal_facing, pidx))


def sample_portal(g_lights, pidx: Array, ref_p: Array, u: Array):
    """AAPortal::SamplePortal (aaportal.cpp:73-86): uniform point on the
    portal rect; pdf w.r.t. solid angle from ref_p.
    Returns (wi (R,3), pdf (R,), p_portal (R,3))."""
    lo, hi, ax, fw = _gather_portal(g_lights, pidx)
    p, n, area_pdf = shapes.sample_aaplane(lo, hi, ax, fw, u)
    to_p = p - ref_p
    d2 = vecmath.length_squared(to_p)
    wi = normalize(to_p)
    pdf = d2 * area_pdf / jnp.maximum(absdot(n, -wi), 1e-9)
    return wi, pdf, p


def pdf_portal(g_lights, pidx: Array, ref_p: Array, wi: Array) -> Array:
    """AAPortal::Pdf_Portal (aaportal.cpp:88-99): solid-angle pdf of
    sample_portal for direction wi (0 if the portal is missed)."""
    lo, hi, ax, fw = _gather_portal(g_lights, pidx)
    R = ref_p.shape[0]
    t, _, _, hit = shapes.intersect_aaplane_paired(
        ref_p, wi, jnp.full(R, vecmath.INF), lo, hi, ax)
    n = shapes.aaplane_normal(ax, fw)
    area = shapes.aaplane_area(lo, hi, ax)
    pdf = (t * t) / jnp.maximum(absdot(n, -wi) * area, 1e-9)
    return jnp.where(hit, pdf, 0.0)


def _take_axis(v: Array, i: Array) -> Array:
    from pbrt_tpu.ops import fastgather
    return fastgather.select_component(v, i)


def sample_projection(g_lights, pidx: Array, light_lo: Array,
                      light_hi: Array, light_ax: Array, ref_p: Array,
                      u: Array):
    """AAPortal::SampleProj (aaportal.cpp:114-159): sample the clipped
    projection of the light rect through the portal plane as seen from
    ref_p. Light plane must be parallel to the portal plane (shared axis),
    as in the reference. Returns (wi, pdf, p_sampled)."""
    lo, hi, ax, fw = _gather_portal(g_lights, pidx)
    ax0, ax1 = shapes.aaplane_axes(ax)

    plane_c = _take_axis(lo, ax)             # portal plane coordinate
    # project light corners lo/hi from ref_p onto the portal plane:
    # point = lc + t * (ref_p - lc), t s.t. point[ax] == plane_c
    def project(lc):
        dvec = ref_p - lc
        d_ax = _take_axis(dvec, ax)
        lc_ax = _take_axis(lc, ax)
        t = (plane_c - lc_ax) / jnp.where(jnp.abs(d_ax) > 1e-12, d_ax, 1e-12)
        return lc + t[..., None] * dvec, jnp.abs(d_ax) > 1e-12

    proj_lo, ok_lo = project(light_lo)
    proj_hi, ok_hi = project(light_hi)

    # clipped rect on each tangent axis (reference computes
    # [max(portal.lo, projLo), min(portal.hi, projHi)] — we additionally
    # order the projected pair and guard empty overlap)
    def clip_axis(axis_sel):
        a = _take_axis(proj_lo, axis_sel)
        b = _take_axis(proj_hi, axis_sel)
        pmin = jnp.minimum(a, b)
        pmax = jnp.maximum(a, b)
        cmin = jnp.maximum(_take_axis(lo, axis_sel), pmin)
        cmax = jnp.minimum(_take_axis(hi, axis_sel), pmax)
        return cmin, jnp.maximum(cmax - cmin, 0.0)

    c0, len0 = clip_axis(ax0)
    c1, len1 = clip_axis(ax1)
    area = len0 * len1
    ok = ok_lo & ok_hi & (area > 1e-12)

    import jax
    oh = jax.nn.one_hot(ax, 3, dtype=jnp.float32)
    oh0 = jax.nn.one_hot(ax0, 3, dtype=jnp.float32)
    oh1 = jax.nn.one_hot(ax1, 3, dtype=jnp.float32)
    sampled = (oh * plane_c[..., None]
               + oh0 * (c0 + u[..., 0] * len0)[..., None]
               + oh1 * (c1 + u[..., 1] * len1)[..., None])
    to_p = sampled - ref_p
    d2 = vecmath.length_squared(to_p)
    wi = normalize(to_p)
    n = shapes.aaplane_normal(ax, fw)
    pdf = d2 / jnp.maximum(absdot(n, -wi) * area, 1e-9)
    return wi, jnp.where(ok, pdf, 0.0), sampled


def pdf_projection(g_lights, pidx: Array, light_lo: Array, light_hi: Array,
                   light_ax: Array, ref_p: Array, wi: Array) -> Array:
    """Pdf of sample_projection for direction wi (the reference's Pdf_Proj
    is unimplemented, aaportal.cpp:161-164; provided here for tests/MIS)."""
    lo, hi, ax, fw = _gather_portal(g_lights, pidx)
    ax0, ax1 = shapes.aaplane_axes(ax)
    plane_c = _take_axis(lo, ax)

    def project(lc):
        dvec = ref_p - lc
        d_ax = _take_axis(dvec, ax)
        lc_ax = _take_axis(lc, ax)
        t = (plane_c - lc_ax) / jnp.where(jnp.abs(d_ax) > 1e-12, d_ax, 1e-12)
        return lc + t[..., None] * dvec

    proj_lo = project(light_lo)
    proj_hi = project(light_hi)

    def clip_axis(axis_sel):
        a = _take_axis(proj_lo, axis_sel)
        b = _take_axis(proj_hi, axis_sel)
        cmin = jnp.maximum(_take_axis(lo, axis_sel), jnp.minimum(a, b))
        cmax = jnp.minimum(_take_axis(hi, axis_sel), jnp.maximum(a, b))
        return cmin, jnp.maximum(cmax - cmin, 0.0)

    c0, len0 = clip_axis(ax0)
    c1, len1 = clip_axis(ax1)
    area = len0 * len1

    # does wi hit the clipped rect?
    R = ref_p.shape[0]
    t, _, _, hit_plane = shapes.intersect_aaplane_paired(
        ref_p, wi, jnp.full(R, vecmath.INF), lo, hi, ax)
    p = ref_p + t[..., None] * wi
    p0 = _take_axis(p, ax0)
    p1 = _take_axis(p, ax1)
    inside = (hit_plane & (p0 >= c0) & (p0 <= c0 + len0)
              & (p1 >= c1) & (p1 <= c1 + len1) & (area > 1e-12))
    n = shapes.aaplane_normal(ax, fw)
    pdf = (t * t) / jnp.maximum(absdot(n, -wi) * area, 1e-9)
    return jnp.where(inside, pdf, 0.0)
