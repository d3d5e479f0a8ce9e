"""Object instancing: shared object-space geometry + per-instance transforms.

JAX counterpart of ``TransformedPrimitive`` (core/primitive.h:92-117)
and the ObjectBegin/ObjectInstance API (core/api.cpp pbrtObjectBegin/
pbrtObjectInstance): an instanced object's triangles are stored ONCE in
object space; each instance adds only a 4x4 transform pair. Intersection
transforms the ray into object space per instance (one matrix per
ray-instance pair, not per triangle) and takes the closest hit, so scene
memory is O(pool + instances), not O(instances x triangles).

Virtual primitive ids: instanced hits get ids in
[base_n, base_n + n_vprims); Scene.prim_mat / prim_light are extended with
one entry per (instance, pool triangle) pair (int32 — 27x smaller than
duplicated vertex data), so every integrator's material/light gather works
unchanged. Like the reference, area lights inside instanced objects are
not supported (pbrt warns and ignores; pbrtObjectInstance path).

The per-object instance walk is a fori_loop (sequential over instances,
vectorized over rays x the object's triangles) with a slab bbox early-out
per instance. A K-candidate two-level traversal is the planned perf path
for large instance counts.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.scene import shapes

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class InstanceTable:
    o2w: Array          # (I,4,4) object→world
    w2o: Array          # (I,4,4) world→object
    inst_ids: Array     # (I,) int32: instance ids grouped by object —
                        # slice [obj_inst_start[o] : +count] = object o's
    vstart: Array       # (I,) int32: first virtual-prim id per instance
    pool_v0: Array      # (P,3) object-space shared triangles
    pool_v1: Array
    pool_v2: Array
    pool_uv0: Array     # (P,2)
    pool_uv1: Array
    pool_uv2: Array
    pool_n0: Array      # (P,3) object-space per-vertex shading normals
    pool_n1: Array      # (face normal when the mesh has none)
    pool_n2: Array
    vprim_inst: Array   # (V,) int32 virtual prim → instance
    vprim_tri: Array    # (V,) int32 virtual prim → pool triangle
    obj_lo: Array       # (O,3) object-space bbox
    obj_hi: Array       # (O,3)
    # static per-object layout: ((tri_start, tri_count,
    #                             inst_start, inst_count), ...)
    obj_layout: tuple = dataclasses.field(metadata=dict(static=True),
                                          default=())

    @property
    def n_vprims(self) -> int:
        return self.vprim_inst.shape[0]


def _xform_p(m: Array, p: Array) -> Array:
    """Apply a (4,4) to points (R,3)."""
    return _xform_v(m, p) + m[:3, 3]


def _xform_v(m: Array, v: Array) -> Array:
    # exact to float32: a GPU may run a float32 dot in TF32
    return jnp.matmul(v, m[:3, :3].T, precision=jax.lax.Precision.HIGHEST)


def _ray_box(o, inv_d, lo, hi, tmax):
    """Slab test vs one AABB; returns hit mask (R,)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tn <= tf) & (tf > 1e-5) & (tn < tmax)


def update_closest(scene, o, d, best_t, prim_id):
    """Fold instanced geometry into a closest-hit result (t, prim_id)."""
    it = scene.inst
    if it is None or it.n_vprims == 0:
        return best_t, prim_id
    base_n = scene.n_base_prims
    from pbrt_tpu.scene import intersect as isect_mod

    for obj_i, (ts, tc, is_, ic) in enumerate(it.obj_layout):
        v0 = it.pool_v0[ts:ts + tc]
        v1 = it.pool_v1[ts:ts + tc]
        v2 = it.pool_v2[ts:ts + tc]
        lo = it.obj_lo[obj_i]
        hi = it.obj_hi[obj_i]
        ids = jax.lax.dynamic_slice_in_dim(it.inst_ids, is_, ic)

        def body(k, carry, v0=v0, v1=v1, v2=v2, lo=lo, hi=hi, ids=ids):
            bt, bp = carry
            i = ids[k]
            m = it.w2o[i]
            o_l = _xform_p(m, o)
            d_l = _xform_v(m, d)
            # bbox early-out in object space (TransformedPrimitive's
            # WorldBound role): skip the triangle tests for rays missing
            # the instance entirely
            inv_d = 1.0 / jnp.where(jnp.abs(d_l) > 1e-12, d_l,
                                    jnp.where(d_l >= 0, 1e-12, -1e-12))
            in_box = _ray_box(o_l, inv_d, lo, hi, bt)
            # direction left unnormalized → object-space t == world t
            t, _, _, h = shapes.intersect_triangles(
                o_l, d_l, jnp.where(in_box, bt, -1.0), v0, v1, v2)
            tb, idx, anyh = isect_mod._family_best(t, h)
            upd = anyh & (tb < bt) & in_box
            bp = jnp.where(upd, base_n + it.vstart[i] + idx, bp)
            bt = jnp.where(upd, tb, bt)
            return bt, bp

        best_t, prim_id = jax.lax.fori_loop(0, ic, body, (best_t, prim_id))
    return best_t, prim_id


def any_hit(scene, o, d, tmax):
    """Instanced-geometry shadow query → occluded mask (R,)."""
    it = scene.inst
    if it is None or it.n_vprims == 0:
        return jnp.zeros(o.shape[0], bool)
    occ = jnp.zeros(o.shape[0], bool)
    for obj_i, (ts, tc, is_, ic) in enumerate(it.obj_layout):
        v0 = it.pool_v0[ts:ts + tc]
        v1 = it.pool_v1[ts:ts + tc]
        v2 = it.pool_v2[ts:ts + tc]
        lo = it.obj_lo[obj_i]
        hi = it.obj_hi[obj_i]
        ids = jax.lax.dynamic_slice_in_dim(it.inst_ids, is_, ic)

        def body(k, occ, v0=v0, v1=v1, v2=v2, lo=lo, hi=hi, ids=ids):
            i = ids[k]
            m = it.w2o[i]
            o_l = _xform_p(m, o)
            d_l = _xform_v(m, d)
            inv_d = 1.0 / jnp.where(jnp.abs(d_l) > 1e-12, d_l,
                                    jnp.where(d_l >= 0, 1e-12, -1e-12))
            in_box = _ray_box(o_l, inv_d, lo, hi, tmax) & ~occ
            _, _, _, h = shapes.intersect_triangles(
                o_l, d_l, jnp.where(in_box, tmax, -1.0), v0, v1, v2)
            return occ | (h.any(-1) & in_box)

        occ = jax.lax.fori_loop(0, ic, body, occ)
    return occ


def finalize_instance_hits(scene, o, d, t, prim_id, p, ng, ns, uv, dpdu,
                           dpdv):
    """Hit attributes for virtual (instanced) prims, matching
    TransformedPrimitive::Intersect's full SurfaceInteraction transform
    (core/primitive.cpp:90-100): world-space triangle from the instance's
    o2w, *interpolated* shading normals via the inverse-transpose
    (Transform::operator()(SurfaceInteraction), core/transform.cpp:358),
    and exact dpdu/dpdv from the uv parameterization
    (triangle.cpp:157-168)."""
    it = scene.inst
    base_n = scene.n_base_prims
    vi = jnp.clip(prim_id - base_n, 0, it.n_vprims - 1)
    is_v = (prim_id >= base_n) & (prim_id < base_n + it.n_vprims)
    i = it.vprim_inst[vi]
    j = it.vprim_tri[vi]
    m = it.o2w[i]
    v0 = _xform_p_batched(m, it.pool_v0[j])
    v1 = _xform_p_batched(m, it.pool_v1[j])
    v2 = _xform_p_batched(m, it.pool_v2[j])
    ngv = shapes.triangle_normal(v0, v1, v2)
    # barycentrics at the hit point (same recompute as base triangles)
    e1 = v1 - v0
    e2 = v2 - v0
    rp = p - v0
    d00 = jnp.sum(e1 * e1, -1)
    d01 = jnp.sum(e1 * e2, -1)
    d11 = jnp.sum(e2 * e2, -1)
    d20 = jnp.sum(rp * e1, -1)
    d21 = jnp.sum(rp * e2, -1)
    den = jnp.maximum(d00 * d11 - d01 * d01, 1e-20)
    bu = jnp.clip((d11 * d20 - d01 * d21) / den, 0.0, 1.0)
    bv = jnp.clip((d00 * d21 - d01 * d20) / den, 0.0, 1.0)
    w = jnp.clip(1.0 - bu - bv, 0.0, 1.0)
    uvv = (w[..., None] * it.pool_uv0[j] + bu[..., None] * it.pool_uv1[j]
           + bv[..., None] * it.pool_uv2[j])
    from pbrt_tpu.core import vecmath
    # interpolated object-space shading normal → world via the instance's
    # inverse-transpose: n_w,i = Σ_j w2o[j,i]·n_o,j
    n_obj = (w[..., None] * it.pool_n0[j] + bu[..., None] * it.pool_n1[j]
             + bv[..., None] * it.pool_n2[j])
    w2o = it.w2o[i]
    nsv = vecmath.normalize(
        jnp.einsum("rji,rj->ri", w2o[:, :3, :3], n_obj,
                   precision=jax.lax.Precision.HIGHEST))
    # exact ∂p/∂u, ∂p/∂v from the uv parameterization on the world-space
    # triangle (triangle.cpp:157-168), with the arbitrary-frame fallback
    # for degenerate uvs
    duv1 = it.pool_uv1[j] - it.pool_uv0[j]
    duv2 = it.pool_uv2[j] - it.pool_uv0[j]
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    inv = jnp.where(jnp.abs(det) > 1e-12,
                    1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0), 0.0)
    dpdu_v = (duv2[..., 1:2] * e1 - duv1[..., 1:2] * e2) * inv[..., None]
    dpdv_v = (-duv2[..., 0:1] * e1 + duv1[..., 0:1] * e2) * inv[..., None]
    t1_fb, t2_fb = vecmath.coordinate_system(ngv)
    ok_uv = (jnp.abs(det) > 1e-12)[..., None]
    dpdu_v = jnp.where(ok_uv, dpdu_v, t1_fb)
    dpdv_v = jnp.where(ok_uv, dpdv_v, t2_fb)
    ng = jnp.where(is_v[..., None], ngv, ng)
    ns = jnp.where(is_v[..., None], nsv, ns)
    uv = jnp.where(is_v[..., None], uvv, uv)
    dpdu = jnp.where(is_v[..., None], dpdu_v, dpdu)
    dpdv = jnp.where(is_v[..., None], dpdv_v, dpdv)
    return ng, ns, uv, dpdu, dpdv


def _xform_p_batched(m: Array, p: Array) -> Array:
    """(R,4,4) x (R,3) points."""
    return jnp.einsum("rij,rj->ri", m[:, :3, :3], p,
                      precision=jax.lax.Precision.HIGHEST) + m[:, :3, 3]


def build_instance_table(objects, instances) -> tuple:
    """Host-side build.

    objects: list of dicts {tris: [(v0,v1,v2,(uv0,uv1,uv2) or None,
    (n0,n1,n2) or None, mat)], ...}; instances: list of (obj_id,
    o2w 4x4 np) tuples. Returns (InstanceTable, vprim_mat (V,) np.int32).
    """
    pool_v = [[], [], []]
    pool_uv = [[], [], []]
    pool_n = [[], [], []]
    pool_mat = []
    obj_tri_range = []
    obj_lo, obj_hi = [], []
    for ob in objects:
        s = len(pool_mat)
        for (v0, v1, v2, uvs, nrm, mat) in ob["tris"]:
            pool_v[0].append(v0)
            pool_v[1].append(v1)
            pool_v[2].append(v2)
            if uvs is None:
                uvs = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0))
            if nrm is None:
                fn = np.cross(np.asarray(v1, np.float64) - v0,
                              np.asarray(v2, np.float64) - v0)
                ln = np.linalg.norm(fn)
                fn = (fn / ln if ln > 0 else np.array([0.0, 0.0, 1.0]))
                nrm = (fn, fn, fn)
            for k in range(3):
                pool_uv[k].append(uvs[k])
                pool_n[k].append(np.asarray(nrm[k], np.float32))
            pool_mat.append(mat)
        c = len(pool_mat) - s
        obj_tri_range.append((s, c))
        vs = np.asarray(pool_v[0][s:s + c] + pool_v[1][s:s + c]
                        + pool_v[2][s:s + c], np.float32).reshape(-1, 3)
        if len(vs):
            obj_lo.append(vs.min(0) - 1e-5)
            obj_hi.append(vs.max(0) + 1e-5)
        else:
            obj_lo.append(np.zeros(3, np.float32))
            obj_hi.append(np.zeros(3, np.float32))

    # group instances by object
    n_obj = len(objects)
    by_obj = [[] for _ in range(n_obj)]
    o2w_list, w2o_list = [], []
    for idx, (obj_id, m) in enumerate(instances):
        by_obj[obj_id].append(idx)
        m = np.asarray(m, np.float32).reshape(4, 4)
        o2w_list.append(m)
        w2o_list.append(np.linalg.inv(m).astype(np.float32))

    inst_ids = []
    layout = []
    for ob in range(n_obj):
        ts, tc = obj_tri_range[ob]
        layout.append((ts, tc, len(inst_ids), len(by_obj[ob])))
        inst_ids.extend(by_obj[ob])

    n_inst = len(instances)
    vstart = np.zeros(n_inst, np.int32)
    vprim_inst, vprim_tri, vprim_mat = [], [], []
    v = 0
    for i, (obj_id, _) in enumerate(instances):
        ts, tc = obj_tri_range[obj_id]
        vstart[i] = v
        vprim_inst.extend([i] * tc)
        vprim_tri.extend(range(ts, ts + tc))
        vprim_mat.extend(pool_mat[ts:ts + tc])
        v += tc

    table = InstanceTable(
        o2w=jnp.asarray(np.stack(o2w_list)),
        w2o=jnp.asarray(np.stack(w2o_list)),
        inst_ids=jnp.asarray(np.asarray(inst_ids, np.int32)),
        vstart=jnp.asarray(vstart),
        pool_v0=jnp.asarray(np.asarray(pool_v[0], np.float32).reshape(-1, 3)),
        pool_v1=jnp.asarray(np.asarray(pool_v[1], np.float32).reshape(-1, 3)),
        pool_v2=jnp.asarray(np.asarray(pool_v[2], np.float32).reshape(-1, 3)),
        pool_uv0=jnp.asarray(np.asarray(pool_uv[0], np.float32)
                             .reshape(-1, 2)),
        pool_uv1=jnp.asarray(np.asarray(pool_uv[1], np.float32)
                             .reshape(-1, 2)),
        pool_uv2=jnp.asarray(np.asarray(pool_uv[2], np.float32)
                             .reshape(-1, 2)),
        pool_n0=jnp.asarray(np.asarray(pool_n[0], np.float32)
                            .reshape(-1, 3)),
        pool_n1=jnp.asarray(np.asarray(pool_n[1], np.float32)
                            .reshape(-1, 3)),
        pool_n2=jnp.asarray(np.asarray(pool_n[2], np.float32)
                            .reshape(-1, 3)),
        vprim_inst=jnp.asarray(np.asarray(vprim_inst, np.int32)),
        vprim_tri=jnp.asarray(np.asarray(vprim_tri, np.int32)),
        obj_lo=jnp.asarray(np.stack(obj_lo)),
        obj_hi=jnp.asarray(np.stack(obj_hi)),
        obj_layout=tuple(layout),
    )
    return table, np.asarray(vprim_mat, np.int32)
