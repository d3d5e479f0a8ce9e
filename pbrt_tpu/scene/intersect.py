"""Unified ray–scene intersection over all primitive families.

JAX counterpart of Scene::Intersect/IntersectP (core/scene.{h,cpp})
+ BVHAccel traversal (accelerators/bvh.cpp).

Two paths:
- **Brute force**: all-pairs (R, P) tests min-reduced per family — pure
  elementwise work that XLA fuses with its min-reduce, optimal for small
  scenes (a cornell box is ~32 primitives and beats any tree).
- **BVH**: for large meshes; flattened-node traversal in scene/bvh.py,
  dispatched here when ``scene.bvh`` is present.

All routines return SoA Hit records; shading normals are interpolated for
triangles (triangle.cpp:231-260).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from pbrt_tpu.core import vecmath
from pbrt_tpu.core.vecmath import normalize
from pbrt_tpu.scene import shapes
from pbrt_tpu.scene.shapes import Hit

Array = Any
BIG = 1e30


def _tri_verts(scene, time):
    """Triangle vertices at each ray's time: (T,3) static, (R,T,3) when the
    scene has two-keyframe motion (AnimatedTransform shape lerp)."""
    g = scene.geom
    if scene.has_motion and time is not None:
        t = time[:, None, None]
        return (g.tri_v0[None] + t * g.tri_dv0[None],
                g.tri_v1[None] + t * g.tri_dv1[None],
                g.tri_v2[None] + t * g.tri_dv2[None])
    return g.tri_v0, g.tri_v1, g.tri_v2


def intersect(scene, o: Array, d: Array, tmax: Array, time=None) -> Hit:
    """Closest-hit query. o,d: (R,3); tmax: (R,); time: (R,) shutter times
    for motion-blurred scenes (None = shutter start). Returns Hit (R,...)."""
    if scene.bvh is not None:
        from pbrt_tpu.scene import bvh as bvh_mod
        from pbrt_tpu.scene import kdtree as kd_mod
        if isinstance(scene.bvh, kd_mod.KdTree):
            return kd_mod.intersect_kd(scene, o, d, tmax)
        return bvh_mod.intersect_bvh(scene, o, d, tmax, time=time)
    return _intersect_brute(scene, o, d, tmax, time=time)


def intersect_p(scene, o: Array, d: Array, tmax: Array, time=None) -> Array:
    """Any-hit (shadow) query → occluded mask (R,)."""
    if scene.bvh is not None:
        from pbrt_tpu.scene import bvh as bvh_mod
        from pbrt_tpu.scene import kdtree as kd_mod
        if isinstance(scene.bvh, kd_mod.KdTree):
            return kd_mod.intersect_p_kd(scene, o, d, tmax)
        return bvh_mod.intersect_p_bvh(scene, o, d, tmax, time=time)
    return _intersect_p_brute(scene, o, d, tmax, time=time)


def _family_best(t: Array, hit: Array):
    """Reduce an all-pairs (R,P) result to per-ray best (t, idx, any).
    min instead of gather-at-argmin (no per-ray index gather; see
    ops/fastgather.py)."""
    t_masked = jnp.where(hit, t, BIG)
    idx = jnp.argmin(t_masked, axis=-1)
    tbest = jnp.min(t_masked, axis=-1)
    return tbest, idx, tbest < BIG


def _at_argmin(v: Array, idx: Array) -> Array:
    """v[r, idx[r]] via one-hot dot (no per-ray index gather)."""
    from pbrt_tpu.ops import fastgather
    return fastgather.select_along_last(v, idx)


def _intersect_brute(scene, o: Array, d: Array, tmax: Array,
                     time=None) -> Hit:
    g = scene.geom
    R = o.shape[0]
    best_t = jnp.minimum(tmax, BIG)
    prim_id = jnp.full(R, -1, jnp.int32)

    results = {}
    if scene.n_tri:
        tv0, tv1, tv2 = _tri_verts(scene, time)
        t, u, v, h = shapes.intersect_triangles(o, d, best_t, tv0, tv1, tv2)
        tb, idx, any_h = _family_best(t, h)
        ub = _at_argmin(u, idx)
        vb = _at_argmin(v, idx)
        results["tri"] = (tb, idx, any_h, ub, vb)
        upd = any_h & (tb < best_t)
        best_t = jnp.where(upd, tb, best_t)
        prim_id = jnp.where(upd, idx, prim_id)
    if scene.n_sph:
        t, h = shapes.intersect_spheres(o, d, best_t, g.sph_center,
                                        g.sph_radius)
        tb, idx, any_h = _family_best(t, h)
        results["sph"] = (tb, idx, any_h)
        upd = any_h & (tb < best_t)
        best_t = jnp.where(upd, tb, best_t)
        prim_id = jnp.where(upd, scene.n_tri + idx, prim_id)
    if scene.n_pln:
        t, u, v, h = shapes.intersect_aaplanes(o, d, best_t, g.pln_lo,
                                               g.pln_hi, g.pln_ax)
        tb, idx, any_h = _family_best(t, h)
        ub = _at_argmin(u, idx)
        vb = _at_argmin(v, idx)
        results["pln"] = (tb, idx, any_h, ub, vb)
        upd = any_h & (tb < best_t)
        best_t = jnp.where(upd, tb, best_t)
        prim_id = jnp.where(upd, scene.n_tri + scene.n_sph + idx, prim_id)
    if scene.n_dsk:
        t, h = shapes.intersect_disks(o, d, best_t, g.dsk_center,
                                      g.dsk_normal, g.dsk_radius,
                                      g.dsk_inner)
        tb, idx, any_h = _family_best(t, h)
        results["dsk"] = (tb, idx, any_h)
        upd = any_h & (tb < best_t)
        best_t = jnp.where(upd, tb, best_t)
        prim_id = jnp.where(upd,
                            scene.n_tri + scene.n_sph + scene.n_pln + idx,
                            prim_id)
    if scene.n_crv:
        t, u, v, h = shapes.intersect_curves(o, d, best_t, scene.geom.crv_cp,
                                             scene.geom.crv_w,
                                             scene.geom.crv_n)
        tb, idx, any_h = _family_best(t, h)
        ub = _at_argmin(u, idx)
        vb = _at_argmin(v, idx)
        results["crv"] = (tb, idx, any_h, ub, vb)
        upd = any_h & (tb < best_t)
        best_t = jnp.where(upd, tb, best_t)
        prim_id = jnp.where(
            upd, scene.n_tri + scene.n_sph + scene.n_pln + scene.n_dsk
            + idx, prim_id)

    if scene.inst is not None:
        from pbrt_tpu.scene import instances as inst_mod
        best_t, prim_id = inst_mod.update_closest(scene, o, d, best_t,
                                                  prim_id)
    return finalize_hit(scene, o, d, best_t, prim_id, results, time=time)


def finalize_hit(scene, o, d, t, prim_id, results=None, time=None) -> Hit:
    """Compute hit attributes (p, ng, ns, uv) from (t, prim_id)."""
    g = scene.geom
    R = o.shape[0]
    valid = prim_id >= 0
    # park missed rays at their origin: a t of BIG would overflow squared
    # distances downstream (inf → NaN in masked-lane gradients)
    p = o + jnp.where(valid, t, 0.0)[..., None] * d
    ng = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (R, 3))
    ns = ng
    uv = jnp.zeros((R, 2))
    dpdu = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), (R, 3))

    nt, nsp, npl = scene.n_tri, scene.n_sph, scene.n_pln
    from pbrt_tpu.ops import fastgather
    if nt:
        ti = jnp.clip(prim_id, 0, nt - 1)
        gt = fastgather.make_row_gather(nt, ti)  # shared one-hot gather
        is_tri = valid & (prim_id < nt)
        hv0, hv1, hv2 = gt(g.tri_v0), gt(g.tri_v1), gt(g.tri_v2)
        if scene.has_motion and time is not None:
            tt = time[:, None]
            hv0 = hv0 + tt * gt(g.tri_dv0)
            hv1 = hv1 + tt * gt(g.tri_dv1)
            hv2 = hv2 + tt * gt(g.tri_dv2)
        ngt = shapes.triangle_normal(hv0, hv1, hv2)
        # recompute barycentrics at hit point (cheap, avoids carrying u,v
        # through BVH traversal): project onto triangle basis
        e1 = hv1 - hv0
        e2 = hv2 - hv0
        rp = p - hv0
        d00 = vecmath.dot(e1, e1)
        d01 = vecmath.dot(e1, e2)
        d11 = vecmath.dot(e2, e2)
        d20 = vecmath.dot(rp, e1)
        d21 = vecmath.dot(rp, e2)
        denom = jnp.maximum(d00 * d11 - d01 * d01, 1e-20)
        bu = (d11 * d20 - d01 * d21) / denom
        bv = (d00 * d21 - d01 * d20) / denom
        bu = jnp.clip(bu, 0.0, 1.0)
        bv = jnp.clip(bv, 0.0, 1.0)
        w = jnp.clip(1.0 - bu - bv, 0.0, 1.0)
        nst = normalize(w[..., None] * gt(g.tri_n0)
                        + bu[..., None] * gt(g.tri_n1)
                        + bv[..., None] * gt(g.tri_n2))
        uvt = (w[..., None] * gt(g.tri_uv0) + bu[..., None] * gt(g.tri_uv1)
               + bv[..., None] * gt(g.tri_uv2))
        ng = jnp.where(is_tri[..., None], ngt, ng)
        ns = jnp.where(is_tri[..., None], nst, ns)
        uv = jnp.where(is_tri[..., None], uvt, uv)
        # ∂p/∂u from the uv parameterization (triangle.cpp:157-168)
        duv1 = gt(g.tri_uv1) - gt(g.tri_uv0)
        duv2 = gt(g.tri_uv2) - gt(g.tri_uv0)
        det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
        inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(
            jnp.abs(det) > 1e-12, det, 1.0), 0.0)
        dpdu_t = (duv2[..., 1:2] * e1 - duv1[..., 1:2] * e2) * inv[..., None]
        dpdv_t = (-duv2[..., 0:1] * e1 + duv1[..., 0:1] * e2) * inv[..., None]
        # degenerate uvs → arbitrary in-plane tangent
        t1_fb, t2_fb = vecmath.coordinate_system(ngt)
        ok_uv = (jnp.abs(det) > 1e-12)[..., None]
        dpdu_t = jnp.where(ok_uv, dpdu_t, t1_fb)
        dpdv_t = jnp.where(ok_uv, dpdv_t, t2_fb)
        dpdu = jnp.where(is_tri[..., None], dpdu_t, dpdu)
        dpdv_tri = dpdv_t
    if nsp:
        si = jnp.clip(prim_id - nt, 0, nsp - 1)
        gs = fastgather.make_row_gather(nsp, si)
        is_sph = valid & (prim_id >= nt) & (prim_id < nt + nsp)
        sph_c = gs(g.sph_center)
        nsph, uvs = shapes.sphere_normal_uv(p, sph_c, gs(g.sph_radius))
        ng = jnp.where(is_sph[..., None], nsph, ng)
        ns = jnp.where(is_sph[..., None], nsph, ns)
        uv = jnp.where(is_sph[..., None], uvs, uv)
        # ∂p/∂u = 2π·(−y, x, 0) in sphere-local coords (sphere.cpp:145)
        pl = p - sph_c
        dpdu_s = 2.0 * jnp.pi * jnp.stack(
            [-pl[..., 1], pl[..., 0], jnp.zeros_like(pl[..., 0])], axis=-1)
        t1_fbs, _ = vecmath.coordinate_system(nsph)
        dpdu_s = jnp.where(
            (vecmath.length_squared(dpdu_s) > 1e-12)[..., None],
            dpdu_s, t1_fbs)
        dpdu = jnp.where(is_sph[..., None], dpdu_s, dpdu)
    if npl:
        pi = jnp.clip(prim_id - nt - nsp, 0, npl - 1)
        gp = fastgather.make_row_gather(npl, pi)
        is_pln = valid & (prim_id >= nt + nsp) & (prim_id < nt + nsp + npl)
        npln = shapes.aaplane_normal(gp(g.pln_ax), gp(g.pln_facing))
        ng = jnp.where(is_pln[..., None], npln, ng)
        ns = jnp.where(is_pln[..., None], npln, ns)
    if scene.n_dsk:
        di = jnp.clip(prim_id - nt - nsp - npl, 0, scene.n_dsk - 1)
        is_dsk = valid & (prim_id >= nt + nsp + npl) \
            & (prim_id < nt + nsp + npl + scene.n_dsk)
        nd = fastgather.gather_rows(g.dsk_normal, di)
        ng = jnp.where(is_dsk[..., None], nd, ng)
        ns = jnp.where(is_dsk[..., None], nd, ns)

    # orient geometric normal to the shading normal's hemisphere is NOT done
    # (pbrt keeps ng independent); shading normal faceforwarded to ng
    ns = vecmath.face_forward(ns, ng)
    # ∂p/∂v: exact uv-gradient for triangles (triangle.cpp:157-168); the
    # frame-completing cross product (|dpdv|≈|dpdu|, in-plane, ⊥ dpdu) for
    # analytic shapes — aspect-preserving default for the EWA footprint
    if scene.n_crv:
        # curves: u/v from the brute-path cache when present, else a
        # rescan of the hit curve (single curve per ray)
        crv_base = nt + nsp + npl + scene.n_dsk
        is_crv = valid & (prim_id >= crv_base) \
            & (prim_id < scene.n_base_prims)
        ci = jnp.clip(prim_id - crv_base, 0, scene.n_crv - 1)
        gc = fastgather.make_row_gather(scene.n_crv, ci)
        cp_r = gc(g.crv_cp)
        w_r = gc(g.crv_w)
        if results is not None and "crv" in results:
            _, _, _, u_c, v_c = results["crv"]
        else:
            tt, uu, vv, hh = shapes.intersect_curves(
                o, d, t + 1e-3, g.crv_cp, g.crv_w, g.crv_n)
            u_c = _at_argmin(uu, ci)
            v_c = _at_argmin(vv, ci)
        n_rows = gc(g.crv_n) if g.crv_n is not None else None
        tang, n_c = shapes.curve_hit_frame(o, d, cp_r, w_r, u_c, v_c, p,
                                           nrows=n_rows)
        ng = jnp.where(is_crv[..., None], n_c, ng)
        ns = jnp.where(is_crv[..., None], n_c, ns)
        uv = jnp.where(is_crv[..., None],
                       jnp.stack([u_c, v_c], -1), uv)
        dpdu = jnp.where(is_crv[..., None], tang, dpdu)
    dpdv = vecmath.cross(ng, dpdu)
    if nt:
        is_tri = valid & (prim_id < nt)
        dpdv = jnp.where(is_tri[..., None], dpdv_tri, dpdv)
    if scene.inst is not None and scene.n_vprims:
        from pbrt_tpu.scene import instances as inst_mod
        ng, ns, uv, dpdu, dpdv = inst_mod.finalize_instance_hits(
            scene, o, d, t, prim_id, p, ng, ns, uv, dpdu, dpdv)
        ns = vecmath.face_forward(ns, ng)
    return Hit(valid=valid, t=t, p=p, ng=ng, ns=ns, uv=uv,
               prim_id=jnp.where(valid, prim_id, -1), dpdu=dpdu, dpdv=dpdv)


def _intersect_p_brute(scene, o: Array, d: Array, tmax: Array,
                       time=None) -> Array:
    g = scene.geom
    occluded = jnp.zeros(o.shape[0], bool)
    if scene.n_tri:
        tv0, tv1, tv2 = _tri_verts(scene, time)
        _, _, _, h = shapes.intersect_triangles(o, d, tmax, tv0, tv1, tv2)
        occluded |= h.any(-1)
    if scene.n_sph:
        _, h = shapes.intersect_spheres(o, d, tmax, g.sph_center,
                                        g.sph_radius)
        occluded |= h.any(-1)
    if scene.n_pln:
        _, _, _, h = shapes.intersect_aaplanes(o, d, tmax, g.pln_lo,
                                               g.pln_hi, g.pln_ax)
        occluded |= h.any(-1)
    if scene.n_dsk:
        _, h = shapes.intersect_disks(o, d, tmax, g.dsk_center,
                                      g.dsk_normal, g.dsk_radius,
                                      g.dsk_inner)
        occluded |= h.any(-1)
    if scene.n_crv:
        _, _, _, h = shapes.intersect_curves(o, d, tmax, g.crv_cp,
                                             g.crv_w, g.crv_n)
        occluded |= h.any(-1)
    if scene.inst is not None:
        from pbrt_tpu.scene import instances as inst_mod
        occluded = occluded | inst_mod.any_hit(scene, o, d, tmax)
    return occluded


def unoccluded(scene, p0: Array, n0: Array, p1: Array) -> Array:
    """VisibilityTester::Unoccluded (core/light.cpp:56-62): segment test
    between offset endpoints."""
    d = p1 - p0
    o = vecmath.offset_ray_origin(p0, n0, d)
    dist = vecmath.length(d)
    dn = d / jnp.maximum(dist, 1e-12)[..., None]
    # shorten to avoid re-hitting the light itself
    tmax = dist * (1.0 - 1e-3)
    return ~intersect_p(scene, o, dn, tmax)
