"""SAH kd-tree accelerator.

JAX counterpart of ``accelerators/kdtreeaccel.cpp`` (KdTreeAccel:
SAH build :265, flattened KdAccelNode array, iterative traversal :350).
Host-side recursive build over triangle bounds; device-side traversal is
the classic near/far stack walk as a vmapped ``lax.while_loop``.

Selected via ``Accelerator "kdtree"`` in scenes (api.cpp:788-801); the BVH
remains the default (bvh.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.scene import shapes

Array = Any

MAX_PRIMS_PER_LEAF = 4
STACK_DEPTH = 64
ISECT_COST = 80.0
TRAV_COST = 1.0
EMPTY_BONUS = 0.5


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KdTree:
    split_pos: Array    # (N,) split plane (leaf: unused)
    axis: Array         # (N,) 0/1/2, 3 = leaf
    above_child: Array  # (N,) interior: index of above child; leaf: prim
    #                     offset into prim_ids
    n_prims: Array      # (N,) leaf prim count
    prim_ids: Array     # (E,) leaf→triangle index lists (concatenated)
    world_lo: Array     # (3,)
    world_hi: Array     # (3,)
    v0: Array           # (T,3) triangles (original order)
    v1: Array
    v2: Array
    max_leaf: int = dataclasses.field(metadata=dict(static=True),
                                      default=MAX_PRIMS_PER_LEAF)


def build_kdtree(scene, max_depth=None) -> KdTree:
    v0 = np.asarray(scene.geom.tri_v0)[:scene.n_tri]
    v1 = np.asarray(scene.geom.tri_v1)[:scene.n_tri]
    v2 = np.asarray(scene.geom.tri_v2)[:scene.n_tri]
    n = v0.shape[0]
    lo_p = np.minimum(np.minimum(v0, v1), v2)
    hi_p = np.maximum(np.maximum(v0, v1), v2)
    wlo = lo_p.min(0) - 1e-4
    whi = hi_p.max(0) + 1e-4
    if max_depth is None:
        max_depth = int(round(8 + 1.3 * np.log2(max(n, 1))))

    split_pos, axis, above, nprims, prim_ids = [], [], [], [], []

    def make_leaf(ids):
        split_pos.append(0.0)
        axis.append(3)
        above.append(len(prim_ids))
        nprims.append(len(ids))
        prim_ids.extend(ids)
        return len(axis) - 1

    def build(ids, blo, bhi, depth):
        if len(ids) <= MAX_PRIMS_PER_LEAF or depth == 0:
            return make_leaf(ids)
        # SAH over candidate planes = prim bound edges on the widest axis
        # (kdtreeaccel.cpp:265-340, retry axes simplified to best axis)
        d = bhi - blo
        best = None
        total_sa = 2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
        inv_sa = 1.0 / max(total_sa, 1e-12)
        old_cost = ISECT_COST * len(ids)
        for ax in np.argsort(-d):
            edges = np.concatenate([lo_p[ids, ax], hi_p[ids, ax]])
            edges = np.unique(edges)
            edges = edges[(edges > blo[ax]) & (edges < bhi[ax])]
            if len(edges) == 0:
                continue
            if len(edges) > 32:
                edges = edges[np.linspace(0, len(edges) - 1, 32,
                                          dtype=int)]
            for e in edges:
                nb = (lo_p[ids, ax] < e).sum()
                na = (hi_p[ids, ax] > e).sum()
                d0 = d.copy()
                d0[ax] = e - blo[ax]
                d1 = d.copy()
                d1[ax] = bhi[ax] - e
                sa0 = 2 * (d0[0] * d0[1] + d0[1] * d0[2] + d0[2] * d0[0])
                sa1 = 2 * (d1[0] * d1[1] + d1[1] * d1[2] + d1[2] * d1[0])
                eb = EMPTY_BONUS if (nb == 0 or na == 0) else 0.0
                cost = TRAV_COST + ISECT_COST * (1 - eb) * inv_sa \
                    * (sa0 * nb + sa1 * na)
                if best is None or cost < best[0]:
                    best = (cost, ax, e)
            if best is not None:
                break
        if best is None or best[0] > old_cost:
            return make_leaf(ids)
        _, ax, e = best
        # prims flat on the split plane (lo==hi==e) must land in one child
        below_ids = [i for i in ids if lo_p[i, ax] < e
                     or (lo_p[i, ax] == e and hi_p[i, ax] == e)]
        above_ids = [i for i in ids if hi_p[i, ax] > e]
        my = len(axis)
        split_pos.append(float(e))
        axis.append(int(ax))
        above.append(-1)
        nprims.append(0)
        blo2 = blo.copy()
        bhi2 = bhi.copy()
        bhi2[ax] = e
        build(below_ids, blo2, bhi2, depth - 1)
        blo3 = blo.copy()
        blo3[ax] = e
        above[my] = len(axis)
        build(above_ids, blo3, bhi.copy(), depth - 1)
        return my

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        build(list(range(n)), wlo.astype(np.float64),
              whi.astype(np.float64), max_depth)
    finally:
        sys.setrecursionlimit(old_limit)

    return KdTree(
        split_pos=jnp.asarray(np.asarray(split_pos, np.float32)),
        axis=jnp.asarray(np.asarray(axis, np.int32)),
        above_child=jnp.asarray(np.asarray(above, np.int32)),
        n_prims=jnp.asarray(np.asarray(nprims, np.int32)),
        prim_ids=jnp.asarray(np.asarray(prim_ids or [0], np.int32)),
        max_leaf=int(max(nprims) if nprims else 1),
        world_lo=jnp.asarray(wlo.astype(np.float32)),
        world_hi=jnp.asarray(whi.astype(np.float32)),
        v0=jnp.asarray(v0), v1=jnp.asarray(v1), v2=jnp.asarray(v2))


def _traverse_one(kd: KdTree, o, d, tmax):
    """KdTreeAccel::Intersect's tMin/tMax stack walk (:350+)."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)
    # clip ray to world bounds
    t0s = (kd.world_lo - o) * inv_d
    t1s = (kd.world_hi - o) * inv_d
    tn = jnp.max(jnp.minimum(t0s, t1s))
    tf = jnp.min(jnp.maximum(t0s, t1s))
    t_min0 = jnp.maximum(tn, 0.0)
    t_max0 = jnp.minimum(tf, tmax)

    # stack of (node, tmin, tmax)
    sn = jnp.zeros(STACK_DEPTH, jnp.int32)
    s0 = jnp.zeros(STACK_DEPTH)
    s1 = jnp.zeros(STACK_DEPTH)
    sn = sn.at[0].set(0)
    s0 = s0.at[0].set(t_min0)
    s1 = s1.at[0].set(t_max0)
    sp0 = jnp.where(t_min0 <= t_max0, 1, 0)

    def cond(state):
        sp, _, _, _, best_t, _ = state
        return sp > 0

    def step(state):
        sp, sn, s0, s1, best_t, best_i = state
        sp = sp - 1
        node = sn[sp]
        tmin = s0[sp]
        tmaxn = jnp.minimum(s1[sp], best_t)
        skip = tmin > tmaxn
        ax = kd.axis[node]
        is_leaf = ax == 3

        # leaf: test prims
        off = kd.above_child[node]
        cnt = kd.n_prims[node]

        def leaf_body(k, carry):
            bt, bi = carry
            valid = k < cnt
            pi = kd.prim_ids[jnp.clip(off + k,
                                      0, kd.prim_ids.shape[0] - 1)]
            t, _, _, h = shapes.intersect_triangle_paired(
                o[None], d[None], bt[None], kd.v0[pi][None],
                kd.v1[pi][None], kd.v2[pi][None])
            h = h[0] & valid
            upd = h & (t[0] < bt)
            return (jnp.where(upd, t[0], bt), jnp.where(upd, pi, bi))

        bt2, bi2 = jax.lax.fori_loop(0, kd.max_leaf, leaf_body,
                                     (best_t, best_i))
        take = is_leaf & ~skip
        best_t = jnp.where(take, bt2, best_t)
        best_i = jnp.where(take, bi2, best_i)

        # interior: compute near/far, push far then near
        axc = jnp.clip(ax, 0, 2)
        t_plane = (kd.split_pos[node] - o[axc]) * inv_d[axc]
        below_first = (o[axc] < kd.split_pos[node]) \
            | ((o[axc] == kd.split_pos[node]) & (d[axc] <= 0))
        first = jnp.where(below_first, node + 1, kd.above_child[node])
        second = jnp.where(below_first, kd.above_child[node], node + 1)
        hit_near_only = (t_plane > tmaxn) | (t_plane <= 0)
        hit_far_only = t_plane < tmin
        do_node = ~is_leaf & ~skip
        # push far (visited second)
        push_both = do_node & ~hit_near_only & ~hit_far_only
        sn = sn.at[sp].set(jnp.where(push_both, second, sn[sp]))
        s0 = s0.at[sp].set(jnp.where(push_both, t_plane, s0[sp]))
        s1 = s1.at[sp].set(jnp.where(push_both, tmaxn, s1[sp]))
        # push the single/near node on top. Precedence matters: pbrt tests
        # (tPlane > tMax || tPlane <= 0) *before* (tPlane < tMin)
        # (kdtreeaccel.cpp:410-418) — both can hold when the plane is
        # behind the origin
        single = jnp.where(hit_near_only, first,
                           jnp.where(hit_far_only, second, first))
        top = jnp.where(push_both, sp + 1, sp)
        sn = sn.at[top].set(jnp.where(do_node, single, sn[top]))
        s0 = s0.at[top].set(jnp.where(do_node, tmin, s0[top]))
        s1 = s1.at[top].set(jnp.where(
            do_node, jnp.where(push_both, t_plane, tmaxn), s1[top]))
        sp = jnp.where(do_node, top + 1, sp)
        return (sp, sn, s0, s1, best_t, best_i)

    state = (sp0, sn, s0, s1, tmax, jnp.int32(-1))
    _, _, _, _, t, i = jax.lax.while_loop(cond, step, state)
    return t, i


def kdtree_intersect_tris(kd: KdTree, o, d, tmax):
    t, i = jax.vmap(lambda oo, dd, tt: _traverse_one(kd, oo, dd, tt))(
        o, d, tmax)
    return t, i, i >= 0


# ---------------------------------------------------------------------------
# scene-level entry points (dispatched from scene/intersect.py when the
# aggregate is a KdTree — Accelerator "kdtree")
# ---------------------------------------------------------------------------

def intersect_kd(scene, o, d, tmax):
    from pbrt_tpu.scene import intersect as isect_mod

    g = scene.geom
    R = o.shape[0]
    best_t = jnp.minimum(tmax, isect_mod.BIG)
    prim_id = jnp.full(R, -1, jnp.int32)
    t, tri_idx, h = kdtree_intersect_tris(scene.bvh, o, d, best_t)
    upd = h & (t < best_t)
    best_t = jnp.where(upd, t, best_t)
    prim_id = jnp.where(upd, tri_idx, prim_id)
    for fam, off in (("sph", scene.n_tri),
                     ("pln", scene.n_tri + scene.n_sph),
                     ("dsk", scene.n_tri + scene.n_sph + scene.n_pln)):
        n = getattr(scene, "n_" + fam)
        if not n:
            continue
        if fam == "sph":
            tf, hf = shapes.intersect_spheres(o, d, best_t, g.sph_center,
                                              g.sph_radius)
        elif fam == "pln":
            tf, _, _, hf = shapes.intersect_aaplanes(
                o, d, best_t, g.pln_lo, g.pln_hi, g.pln_ax)
        else:
            tf, hf = shapes.intersect_disks(o, d, best_t, g.dsk_center,
                                            g.dsk_normal, g.dsk_radius,
                                            g.dsk_inner)
        tb, idx, anyh = isect_mod._family_best(tf, hf)
        upd = anyh & (tb < best_t)
        best_t = jnp.where(upd, tb, best_t)
        prim_id = jnp.where(upd, off + idx, prim_id)
    return isect_mod.finalize_hit(scene, o, d, best_t, prim_id)


def intersect_p_kd(scene, o, d, tmax):
    hit = intersect_kd(scene, o, d, tmax)
    return hit.valid
