"""BVH: host-side binned-SAH build + flattened on-device traversal.

JAX counterpart of ``accelerators/bvh.{h,cpp}``: the recursive
pointer-based build (bvh.cpp:203-260) runs on host (numpy / native C++, cold
path) and is flattened into the depth-first LinearBVHNode array layout
(bvh.cpp:223, bvh.h:88) as SoA device arrays.

Traversal is **stackless**, unlike the reference's explicit-stack walk
(bvh.cpp:299-365): per-lane stacks would lower to (R, depth) scatters every
step. Instead the flat DFS layout is threaded with
octant-ordered hit/miss links (a "threaded BVH"): for each of the 8 ray
direction octants, `first[o,i]` is the near child of interior node i and
`miss[o,i]` is the node that follows once i's subtree is done or skipped.
Device state per ray is then just (node, best_t, best_i) and each
`lax.while_loop` step is a handful of row gathers + selects over the whole
ray batch — no scatters, no vmap. Near-first ordering is preserved per
octant, so the shrinking best_t prunes far subtrees exactly like the
reference's ordered stack traversal.

The BVH covers the *triangle* family only — the only family that grows to
10^5+ primitives (killeroo-simple has ~100k tris); spheres/aaplanes/disks
(a handful per scene) stay on the all-pairs path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core import vecmath
from pbrt_tpu.scene import shapes

Array = Any

LEAF_MAX = 4
STACK_DEPTH = 64
N_BUCKETS = 12


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FlatBVH:
    lo: Array          # (N,3) node bounds
    hi: Array          # (N,3)
    right: Array       # (N,) interior: index of 2nd child; leaf: prim offset
    count: Array       # (N,) 0 = interior, else leaf prim count
    axis: Array        # (N,) split axis
    prim_order: Array  # (P,) triangle index permutation
    # leaf-ordered triangle copies for contiguous gathers
    v0: Array          # (P,3)
    v1: Array
    v2: Array
    # threaded (stackless) traversal links, one set per direction octant:
    # nodes8[o*N+i] = [lo, hi, first_if_hit, next_if_miss_or_done, off, cnt]
    # packed as (8N, 8) f32 with int fields bitcast — ONE row gather per
    # traversal step. tri9 = (P+pad, 9) [v0|v1|v2] — one row gather per
    # leaf primitive test.
    nodes8: Array = None      # (8N, 8) float32
    tri9: Array = None        # (P_pad, 9) float32


def build_bvh(builder, scene, split_method: str = "sah") -> FlatBVH:
    """BVH build (BVHAccel::recursiveBuild, bvh.cpp:203+), iterative with
    an explicit stack; flattened directly.

    ``split_method`` mirrors bvh.h:58 SplitMethod: "sah" (binned, the
    default — native C++ builder pbrt_tpu/native/bvh_builder.cpp when
    available), "middle" (centroid-midpoint partition), "equal"
    (EqualCounts median split), "hlbvh" (30-bit Morton-ordered build —
    splits follow Morton bit prefixes like HLBVH's LBVH treelets;
    the upper-level SAH pass is folded into the same prefix splits,
    documented delta)."""
    v0 = np.asarray(scene.geom.tri_v0)[:scene.n_tri]
    v1 = np.asarray(scene.geom.tri_v1)[:scene.n_tri]
    v2 = np.asarray(scene.geom.tri_v2)[:scene.n_tri]
    n = v0.shape[0]
    lo_p = np.minimum(np.minimum(v0, v1), v2)
    hi_p = np.maximum(np.maximum(v0, v1), v2)
    dv = None
    if scene.has_motion:
        # node bounds must cover the whole shutter interval: union of the
        # two keyframes (AnimatedTransform::MotionBounds role)
        dv = tuple(np.asarray(x)[:scene.n_tri] for x in
                   (scene.geom.tri_dv0, scene.geom.tri_dv1,
                    scene.geom.tri_dv2))
        e0, e1, e2 = v0 + dv[0], v1 + dv[1], v2 + dv[2]
        lo_p = np.minimum(lo_p, np.minimum(np.minimum(e0, e1), e2))
        hi_p = np.maximum(hi_p, np.maximum(np.maximum(e0, e1), e2))
    cent = 0.5 * (lo_p + hi_p)

    native = _build_native(lo_p, hi_p, v0, v1, v2,
                           allow_sbvh=(split_method == "sah"
                                       and not scene.has_motion)) \
        if split_method == "sah" else None
    if native is not None:
        lo_a, hi_a, right_a, count_a, axis_a, order = native
        return _finish_flat(lo_a, hi_a, right_a, count_a, axis_a, order,
                            v0, v1, v2, dv)

    order = np.arange(n)
    morton = None
    if split_method == "hlbvh":
        # 30-bit Morton codes over the centroid bounds (bvh.cpp:203-204)
        clo_all = cent.min(0)
        cext = np.maximum(cent.max(0) - clo_all, 1e-12)
        q = np.minimum(((cent - clo_all) / cext) * 1024.0,
                       1023.0).astype(np.uint32)

        def _spread(x):
            x = (x | (x << 16)) & 0x030000FF
            x = (x | (x << 8)) & 0x0300F00F
            x = (x | (x << 4)) & 0x030C30C3
            x = (x | (x << 2)) & 0x09249249
            return x

        morton = (_spread(q[:, 0]) << 2) | (_spread(q[:, 1]) << 1) \
            | _spread(q[:, 2])
        perm = np.argsort(morton, kind="stable")
        order = order[perm]
        morton = morton[perm]
    nodes = []  # dicts: lo, hi, right, count, axis, offset

    def make_leaf(lo, hi, start, count):
        nodes.append(dict(lo=lo, hi=hi, right=start, count=count, axis=0))
        return len(nodes) - 1

    # stack entries: (range_start, range_end, parent_idx, is_second_child)
    stack = [(0, n, -1, False)]
    while stack:
        start, end, parent, second = stack.pop()
        idxs = order[start:end]
        lo = lo_p[idxs].min(0)
        hi = hi_p[idxs].max(0)
        my_idx = len(nodes)
        if second and parent >= 0:
            nodes[parent]["right"] = my_idx
        count = end - start
        if count <= LEAF_MAX:
            make_leaf(lo, hi, start, count)
            continue
        c = cent[idxs]
        clo, chi = c.min(0), c.max(0)
        dim = int(np.argmax(chi - clo))
        if chi[dim] - clo[dim] < 1e-12:
            make_leaf(lo, hi, start, count)
            continue
        if split_method == "middle":
            # SplitMethod::Middle (bvh.cpp): centroid-midpoint partition
            pmid = 0.5 * (clo[dim] + chi[dim])
            left_mask = c[:, dim] < pmid
            if left_mask.sum() in (0, count):
                left_mask = np.zeros(count, bool)
                left_mask[np.argsort(c[:, dim],
                                     kind="stable")[:count // 2]] = True
            mid = _partition(order, idxs, left_mask, start, end)
        elif split_method == "equal":
            # SplitMethod::EqualCounts: median split along dim
            left_mask = np.zeros(count, bool)
            left_mask[np.argsort(c[:, dim],
                                 kind="stable")[:count // 2]] = True
            mid = _partition(order, idxs, left_mask, start, end)
        elif split_method == "hlbvh":
            # order is Morton-sorted: split where the highest differing
            # bit of the range's codes flips (LBVH treelet emission)
            m0, m1 = morton[start], morton[end - 1]
            if m0 == m1:
                mid = start + count // 2
            else:
                bit = int(m0 ^ m1).bit_length() - 1
                thresh = (int(m1) >> bit) << bit
                mid = start + int(np.searchsorted(morton[start:end],
                                                  thresh, side="left"))
                if mid in (start, end):
                    mid = start + count // 2
        else:
            # binned SAH
            b = np.minimum(((c[:, dim] - clo[dim]) / (chi[dim] - clo[dim])
                            * N_BUCKETS).astype(np.int32), N_BUCKETS - 1)
            costs = np.full(N_BUCKETS - 1, np.inf)
            for split in range(N_BUCKETS - 1):
                left = b <= split
                nl = left.sum()
                nr = count - nl
                if nl == 0 or nr == 0:
                    continue
                llo = lo_p[idxs[left]].min(0)
                lhi = hi_p[idxs[left]].max(0)
                rlo = lo_p[idxs[~left]].min(0)
                rhi = hi_p[idxs[~left]].max(0)
                sa = lambda a, bb: max(1e-12, 2.0 * (
                    (bb[0] - a[0]) * (bb[1] - a[1]) + (bb[1] - a[1])
                    * (bb[2] - a[2]) + (bb[2] - a[2]) * (bb[0] - a[0])))
                costs[split] = nl * sa(llo, lhi) + nr * sa(rlo, rhi)
            split = int(np.argmin(costs))
            if not np.isfinite(costs[split]):
                mid = start + count // 2
            else:
                mid = _partition(order, idxs, b <= split, start, end)
        nodes.append(dict(lo=lo, hi=hi, right=-1, count=0, axis=dim))
        # push right first so left is processed next (depth-first: left
        # child = my_idx + 1)
        stack.append((mid, end, my_idx, True))
        stack.append((start, mid, my_idx, False))

    N = len(nodes)
    lo_a = np.stack([nd["lo"] for nd in nodes]).astype(np.float32)
    hi_a = np.stack([nd["hi"] for nd in nodes]).astype(np.float32)
    right_a = np.asarray([nd["right"] for nd in nodes], np.int32)
    count_a = np.asarray([nd["count"] for nd in nodes], np.int32)
    axis_a = np.asarray([nd["axis"] for nd in nodes], np.int32)
    return _finish_flat(lo_a, hi_a, right_a, count_a, axis_a, order,
                        v0, v1, v2, dv)


def _partition(order, idxs, left_mask, start, end):
    left_ids = idxs[left_mask]
    right_ids = idxs[~left_mask]
    order[start:start + len(left_ids)] = left_ids
    order[start + len(left_ids):end] = right_ids
    return start + len(left_ids)


def _finish_flat(lo_a, hi_a, right_a, count_a, axis_a, order, v0, v1, v2,
                 dv):
    """Assemble the FlatBVH device arrays + the threaded layout."""
    nodes8, tri9 = _pack_threaded(lo_a, hi_a, right_a, count_a, axis_a,
                                  v0[order], v1[order], v2[order],
                                  dv=None if dv is None else
                                  tuple(x[order] for x in dv))
    return FlatBVH(
        lo=jnp.asarray(lo_a), hi=jnp.asarray(hi_a),
        right=jnp.asarray(right_a), count=jnp.asarray(count_a),
        axis=jnp.asarray(axis_a), prim_order=jnp.asarray(order, jnp.int32),
        v0=jnp.asarray(v0[order]), v1=jnp.asarray(v1[order]),
        v2=jnp.asarray(v2[order]),
        nodes8=jnp.asarray(nodes8), tri9=jnp.asarray(tri9))


def _build_native(lo_p: np.ndarray, hi_p: np.ndarray, v0=None, v1=None,
                  v2=None, allow_sbvh=True):
    """Call the C++ builder; None if the native lib is unavailable.

    Prefers the SBVH build (spatial splits with clipped-reference
    duplication — Stich et al. 2009; cuts packet-traversal node entries
    on overlap-heavy meshes) when triangle vertices are supplied; the
    emitted prim order may contain DUPLICATE references, which every
    downstream consumer indexes through (leaf tables are built from
    v0[order]). PBRT_TPU_NO_SBVH=1 or motion blur (refit semantics need
    1:1 refs) falls back to plain binned SAH."""
    import ctypes
    import os

    from pbrt_tpu import native

    lib = native.load()
    if lib is None:
        return None
    n = lo_p.shape[0]
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)

    use_sbvh = (allow_sbvh and v0 is not None
                and hasattr(lib, "bvh_build_sbvh")
                and not os.environ.get("PBRT_TPU_NO_SBVH"))
    if use_sbvh:
        order_cap = 2 * max(n, 1)
        cap = 2 * order_cap
        v0c = np.ascontiguousarray(v0, np.float32)
        v1c = np.ascontiguousarray(v1, np.float32)
        v2c = np.ascontiguousarray(v2, np.float32)
        node_lo = np.empty((cap, 3), np.float32)
        node_hi = np.empty((cap, 3), np.float32)
        right = np.empty(cap, np.int32)
        count = np.empty(cap, np.int32)
        axis = np.empty(cap, np.int32)
        order = np.empty(order_cap, np.int32)
        n_refs = ctypes.c_int(0)
        nn = lib.bvh_build_sbvh(
            v0c.ctypes.data_as(fp), v1c.ctypes.data_as(fp),
            v2c.ctypes.data_as(fp), ctypes.c_int(n),
            ctypes.c_int(LEAF_MAX),
            node_lo.ctypes.data_as(fp), node_hi.ctypes.data_as(fp),
            right.ctypes.data_as(ip), count.ctypes.data_as(ip),
            axis.ctypes.data_as(ip), order.ctypes.data_as(ip),
            ctypes.c_int(order_cap), ctypes.byref(n_refs))
        if nn > 0:
            return (node_lo[:nn], node_hi[:nn], right[:nn], count[:nn],
                    axis[:nn], order[:n_refs.value])
        # capacity exceeded (pathological duplication) → SAH fallback

    cap = 2 * max(n, 1)
    lo_c = np.ascontiguousarray(lo_p, np.float32)
    hi_c = np.ascontiguousarray(hi_p, np.float32)
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    right = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    axis = np.empty(cap, np.int32)
    order = np.empty(n, np.int32)
    nn = lib.bvh_build_sah(
        lo_c.ctypes.data_as(fp), hi_c.ctypes.data_as(fp),
        ctypes.c_int(n), ctypes.c_int(LEAF_MAX),
        node_lo.ctypes.data_as(fp), node_hi.ctypes.data_as(fp),
        right.ctypes.data_as(ip), count.ctypes.data_as(ip),
        axis.ctypes.data_as(ip), order.ctypes.data_as(ip))
    if nn <= 0:
        return None
    return (node_lo[:nn], node_hi[:nn], right[:nn], count[:nn], axis[:nn],
            order)


# ---------------------------------------------------------------------------
# threaded links (host, build time)
# ---------------------------------------------------------------------------

def _octant_links(right: np.ndarray, count: np.ndarray, axis: np.ndarray):
    """Hit/miss successor links of the DFS-flat BVH for the 8 direction
    octants. For octant o at interior node i the near child is left (i+1)
    when direction bit (o >> axis[i]) & 1 == 0, else right[i]; ``miss`` is
    the node visited after i's subtree is exhausted or skipped.

    DFS layout ⇒ parent index < child index; far-child miss pointers form
    ancestor chains resolved by pointer jumping (log passes, no Python
    per-node loop). Returns (first (8,N), miss (8,N)) int32, miss sentinel
    = N (traversal done).
    """
    N = right.shape[0]
    interior = count == 0
    idx = np.arange(N, dtype=np.int32)
    left = idx + 1
    ii = np.nonzero(interior)[0]
    parent = np.full(N, -1, np.int32)
    parent[left[ii]] = ii
    parent[right[ii]] = ii

    first = np.zeros((8, N), np.int32)
    miss = np.empty((8, N), np.int32)
    has_parent = parent >= 0
    p_safe = np.maximum(parent, 0)
    for o in range(8):
        bit = (o >> axis) & 1                       # per-node direction bit
        near = np.where(bit == 0, left, right).astype(np.int32)
        far = np.where(bit == 0, right, left).astype(np.int32)
        first[o] = np.where(interior, near, 0)
        # a node's miss: root → N; near child of p → far sibling;
        # far child of p → miss[p] (chase ancestors)
        pbit = bit[p_safe]
        p_near = np.where(pbit == 0, left[p_safe], right[p_safe])
        is_near = has_parent & (idx == p_near)
        is_far = has_parent & ~is_near
        base = np.where(is_near,
                        np.where(pbit == 0, right[p_safe], left[p_safe]),
                        N).astype(np.int32)        # root/far placeholder N
        # src chain: far children take their parent's value
        src = np.where(is_far, parent, idx).astype(np.int32)
        for _ in range(max(1, int(np.ceil(np.log2(max(N, 2)))) + 1)):
            nxt = src[src]
            if np.array_equal(nxt, src):
                break
            src = nxt
        miss[o] = base[src]
    return first, miss


def _pack_threaded(bvh_lo, bvh_hi, right, count, axis, v0, v1, v2, dv=None):
    """Pack per-octant node rows (8N, 10) + padded leaf triangles (P+pad, 9)
    so each traversal step is one node-row gather and one 4-row tri gather.
    With two-keyframe motion (``dv``), tri rows widen to 18 columns
    [v0|v1|v2|dv0|dv1|dv2] and the leaf test lerps by ray time."""
    N = right.shape[0]
    first, miss = _octant_links(right, count, axis)
    lo = np.asarray(bvh_lo, np.float32)
    hi = np.asarray(bvh_hi, np.float32)
    P = v0.shape[0]
    pad = LEAF_MAX
    # leaf off/cnt; interior nodes point at the degenerate pad rows
    is_leaf = count > 0
    off = np.where(is_leaf, right, P).astype(np.int32)
    cnt = count.astype(np.int32)
    rows = np.empty((8, N, 10), np.float32)
    rows[:, :, 0:3] = lo[None]
    rows[:, :, 3:6] = hi[None]
    rows[:, :, 6] = first.astype(np.int32).view(np.float32)
    rows[:, :, 7] = miss.astype(np.int32).view(np.float32)
    rows[:, :, 8] = off.view(np.float32)[None]
    rows[:, :, 9] = cnt.view(np.float32)[None]
    width = 9 if dv is None else 18
    tri9 = np.zeros((P + pad, width), np.float32)
    tri9[:P, 0:3] = v0
    tri9[:P, 3:6] = v1
    tri9[:P, 6:9] = v2
    if dv is not None:
        tri9[:P, 9:12] = dv[0]
        tri9[:P, 12:15] = dv[1]
        tri9[:P, 15:18] = dv[2]
    return rows.reshape(8 * N, 10), tri9


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def _traverse_batch(bvh: FlatBVH, o, d, tmax, any_hit: bool, time=None):
    """Stackless threaded traversal over the whole (R,) ray batch in one
    ``lax.while_loop`` — per-step work is vector gathers + selects, no
    scatters, no vmap. Role of BVHAccel::Intersect's ordered stack walk
    (bvh.cpp:299-365) with identical near-first visit order per octant."""
    R = o.shape[0]
    N = bvh.lo.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)
    octant = ((d[:, 0] < 0).astype(jnp.int32)
              | ((d[:, 1] < 0).astype(jnp.int32) << 1)
              | ((d[:, 2] < 0).astype(jnp.int32) << 2))
    base = octant * N

    def cond(state):
        cur, _, _ = state
        return jnp.any(cur < N)

    def step(state):
        cur, best_t, best_i = state
        active = cur < N
        rows = bvh.nodes8[base + jnp.minimum(cur, N - 1)]      # (R,10)
        n_lo, n_hi = rows[:, 0:3], rows[:, 3:6]
        first = jax.lax.bitcast_convert_type(rows[:, 6], jnp.int32)
        miss = jax.lax.bitcast_convert_type(rows[:, 7], jnp.int32)
        off = jax.lax.bitcast_convert_type(rows[:, 8], jnp.int32)
        cnt = jax.lax.bitcast_convert_type(rows[:, 9], jnp.int32)

        hit_box = active & vecmath.bounds_intersect_p(n_lo, n_hi, o, inv_d,
                                                      best_t)
        is_leaf = cnt > 0
        do_leaf = hit_box & is_leaf

        # up to LEAF_MAX triangles in one gather: (R,4,9|18)
        k = jnp.arange(LEAF_MAX, dtype=jnp.int32)
        pidx = jnp.where(do_leaf[:, None], off[:, None] + k[None, :],
                         bvh.tri9.shape[0] - LEAF_MAX + k[None, :])
        tr = bvh.tri9[pidx]                                     # (R,4,9|18)
        w0, w1, w2 = tr[..., 0:3], tr[..., 3:6], tr[..., 6:9]
        if tr.shape[-1] == 18 and time is not None:
            tt = time[:, None, None]
            w0 = w0 + tt * tr[..., 9:12]
            w1 = w1 + tt * tr[..., 12:15]
            w2 = w2 + tt * tr[..., 15:18]
        t4, _, _, h4 = shapes.intersect_triangle_paired(
            o[:, None, :], d[:, None, :],
            jnp.broadcast_to(best_t[:, None], (R, LEAF_MAX)),
            w0, w1, w2)
        h4 = h4 & (k[None, :] < cnt[:, None]) & do_leaf[:, None]
        t4 = jnp.where(h4, t4, jnp.inf)
        kbest = jnp.argmin(t4, axis=1)
        tbest = jnp.take_along_axis(t4, kbest[:, None], axis=1)[:, 0]
        upd = (tbest < best_t) & do_leaf
        best_t = jnp.where(upd, tbest, best_t)
        best_i = jnp.where(upd, off + kbest, best_i)

        nxt = jnp.where(hit_box & ~is_leaf, first, miss)
        if any_hit:
            nxt = jnp.where(best_i >= 0, N, nxt)
        cur = jnp.where(active, nxt, cur)
        return (cur, best_t, best_i)

    state = (jnp.zeros(R, jnp.int32), tmax, jnp.full(R, -1, jnp.int32))
    _, t, i = jax.lax.while_loop(cond, step, state)
    return t, i


def _traverse(bvh: FlatBVH, o, d, tmax, any_hit: bool):
    """Single-ray stack traversal; vmapped. Returns (t, leaf_prim_idx)."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)

    def cond(state):
        sp, _, _, _, stop = state
        return (sp > 0) & ~stop

    def step(state):
        sp, stack, best_t, best_i, stop = state
        sp = sp - 1
        node = stack[sp]
        n_lo = bvh.lo[node]
        n_hi = bvh.hi[node]
        hit_box = vecmath.bounds_intersect_p(n_lo, n_hi, o, inv_d, best_t)

        cnt = bvh.count[node]
        is_leaf = cnt > 0

        # leaf: test up to LEAF_MAX triangles
        off = bvh.right[node]

        def leaf_body(k, carry):
            bt, bi = carry
            pi = off + k
            valid = k < cnt
            t, _, _, h = shapes.intersect_triangle_paired(
                o[None], d[None], bt[None], bvh.v0[pi][None],
                bvh.v1[pi][None], bvh.v2[pi][None])
            h = h[0] & valid
            t = t[0]
            upd = h & (t < bt)
            return (jnp.where(upd, t, bt), jnp.where(upd, pi, bi))

        bt2, bi2 = jax.lax.fori_loop(0, LEAF_MAX, leaf_body,
                                     (best_t, best_i))
        take_leaf = hit_box & is_leaf
        best_t = jnp.where(take_leaf, bt2, best_t)
        best_i = jnp.where(take_leaf, bi2, best_i)

        # interior: push children, near child on top
        near_second = d[bvh.axis[node]] < 0.0
        c1 = node + 1
        c2 = bvh.right[node]
        first = jnp.where(near_second, c2, c1)
        second = jnp.where(near_second, c1, c2)
        do_push = hit_box & ~is_leaf
        stack = stack.at[sp].set(jnp.where(do_push, second, stack[sp]))
        stack = stack.at[sp + 1].set(jnp.where(do_push, first,
                                               stack[sp + 1]))
        sp = jnp.where(do_push, sp + 2, sp)

        stop = any_hit & (best_i >= 0)
        return (sp, stack, best_t, best_i, stop)

    stack0 = jnp.zeros(STACK_DEPTH, jnp.int32)
    state = (jnp.int32(1), stack0, tmax, jnp.int32(-1), jnp.bool_(False))
    _, _, t, i, _ = jax.lax.while_loop(cond, step, state)
    return t, i


def _use_stack_traversal() -> bool:
    import os
    return bool(os.environ.get("PBRT_TPU_BVH_STACK"))


def bvh_intersect_tris(bvh: FlatBVH, o, d, tmax, time=None):
    """Closest triangle hit via BVH. Returns (t, global_tri_idx, hit)."""
    if bvh.nodes8 is not None and not _use_stack_traversal():
        t, leaf_i = _traverse_batch(bvh, o, d, tmax, False, time=time)
    else:
        t, leaf_i = jax.vmap(lambda oo, dd, tt: _traverse(bvh, oo, dd, tt,
                                                          False))(o, d, tmax)
    hit = leaf_i >= 0
    tri_idx = jnp.where(hit, bvh.prim_order[jnp.maximum(leaf_i, 0)], -1)
    return t, tri_idx, hit


def bvh_intersect_p_tris(bvh: FlatBVH, o, d, tmax, time=None):
    if bvh.nodes8 is not None and not _use_stack_traversal():
        _, leaf_i = _traverse_batch(bvh, o, d, tmax, True, time=time)
    else:
        _, leaf_i = jax.vmap(lambda oo, dd, tt: _traverse(bvh, oo, dd, tt,
                                                          True))(o, d, tmax)
    return leaf_i >= 0


# ---------------------------------------------------------------------------
# scene-level entry points (dispatched from scene/intersect.py)
# ---------------------------------------------------------------------------

def intersect_bvh(scene, o, d, tmax, time=None):
    from pbrt_tpu.scene import intersect as isect_mod
    g = scene.geom
    R = o.shape[0]
    best_t = jnp.minimum(tmax, isect_mod.BIG)
    prim_id = jnp.full(R, -1, jnp.int32)

    t, tri_idx, h = bvh_intersect_tris(scene.bvh, o, d, best_t, time=time)
    upd = h & (t < best_t)
    best_t = jnp.where(upd, t, best_t)
    prim_id = jnp.where(upd, tri_idx, prim_id)

    # non-triangle families: brute force
    if scene.n_sph:
        ts, hs = shapes.intersect_spheres(o, d, best_t, g.sph_center,
                                          g.sph_radius)
        tb, idx, anyh = isect_mod._family_best(ts, hs)
        upd = anyh & (tb < best_t)
        best_t = jnp.where(upd, tb, best_t)
        prim_id = jnp.where(upd, scene.n_tri + idx, prim_id)
    if scene.n_pln:
        tp, _, _, hp = shapes.intersect_aaplanes(o, d, best_t, g.pln_lo,
                                                 g.pln_hi, g.pln_ax)
        tb, idx, anyh = isect_mod._family_best(tp, hp)
        upd = anyh & (tb < best_t)
        best_t = jnp.where(upd, tb, best_t)
        prim_id = jnp.where(upd, scene.n_tri + scene.n_sph + idx, prim_id)
    if scene.n_dsk:
        td, hd = shapes.intersect_disks(o, d, best_t, g.dsk_center,
                                        g.dsk_normal, g.dsk_radius,
                                        g.dsk_inner)
        tb, idx, anyh = isect_mod._family_best(td, hd)
        upd = anyh & (tb < best_t)
        best_t = jnp.where(upd, tb, best_t)
        prim_id = jnp.where(
            upd, scene.n_tri + scene.n_sph + scene.n_pln + idx, prim_id)
    if scene.n_crv:
        tc, uc, vc, hc = shapes.intersect_curves(o, d, best_t, g.crv_cp,
                                                 g.crv_w, g.crv_n)
        tb, idx, anyh = isect_mod._family_best(tc, hc)
        upd = anyh & (tb < best_t)
        best_t = jnp.where(upd, tb, best_t)
        prim_id = jnp.where(
            upd, scene.n_tri + scene.n_sph + scene.n_pln + scene.n_dsk
            + idx, prim_id)

    if scene.inst is not None:
        from pbrt_tpu.scene import instances as inst_mod
        best_t, prim_id = inst_mod.update_closest(scene, o, d, best_t,
                                                  prim_id)
    return isect_mod.finalize_hit(scene, o, d, best_t, prim_id, time=time)


def intersect_p_bvh(scene, o, d, tmax, time=None):
    g = scene.geom
    occ = bvh_intersect_p_tris(scene.bvh, o, d, tmax, time=time)
    if scene.n_sph:
        _, h = shapes.intersect_spheres(o, d, tmax, g.sph_center,
                                        g.sph_radius)
        occ |= h.any(-1)
    if scene.n_pln:
        _, _, _, h = shapes.intersect_aaplanes(o, d, tmax, g.pln_lo,
                                               g.pln_hi, g.pln_ax)
        occ |= h.any(-1)
    if scene.n_dsk:
        _, h = shapes.intersect_disks(o, d, tmax, g.dsk_center,
                                      g.dsk_normal, g.dsk_radius,
                                      g.dsk_inner)
        occ |= h.any(-1)
    if scene.n_crv:
        _, _, _, h = shapes.intersect_curves(o, d, tmax, g.crv_cp,
                                             g.crv_w, g.crv_n)
        occ |= h.any(-1)
    if scene.inst is not None:
        from pbrt_tpu.scene import instances as inst_mod
        occ = occ | inst_mod.any_hit(scene, o, d, tmax)
    return occ
