"""Monolithic fused path-bounce kernel (Pallas through Triton) for small
diffuse portal scenes — the cornell-class workload of bench.py.

Motivation: the generic wavefront loop (integrators/render.py _li_loop)
runs each bounce as many separate XLA fusions, each a full sweep of the
2M-lane ray state through device memory, traces 3 closest-hit sweeps per
bounce, and its VJP traces every one of them again. This kernel
collapses the ENTIRE bounce loop — per-bounce closest-hit (all-pairs
against a broadcast-loaded prim table), portal-projection NEE (one
shadow/emission closest-hit), cosine continuation and russian roulette —
into ONE pass over the ray batch: each program owns a 1-D block of
``BLOCK`` rays whose state (o, d, beta, masks) stays in registers across
all bounces and never round-trips device memory.

Differentiation (detached-sampling design, SURVEY.md §7): the kernel
emits, per bounce, a handful of *parameter-independent* scalar residuals
(hit material id, NEE geometric factor, continuation cos/pdf factor,
survival masks), and a tiny XLA ``replay`` reconstructs
L(kd, emit | residuals) from them. Sampled directions and pdfs do not
depend on (kd, emit) for diffuse surfaces, so grads of the replay equal
grads of the full estimator (russian-roulette compensation 1/(1−q) is
recomputed from beta inside the replay so its kd-dependence
differentiates exactly like the reference path; the survival *decisions*
are a.e. constant). The pallas call sits behind lax.stop_gradient —
gradients flow only through the replay.

Scope gate (Scene.fused_profile, scene/types.py): all-matte (lambertian,
sigma 0) materials, triangles + ONE aaplane that is the scene's single
one-sided area light, RGB, no media/SSS/motion/instancing/textures; two
light modes (static `mode`): 1 = single-portal projection-strategy
portal light (the fork's light-through-opening scenario,
lights/portal_arealight.cpp:29-239 + aaportal.cpp SampleProj; light-only
NEE, 2 sweeps/bounce), 0 = plain diffuse area light (the classic
cornell-box class; full two-sample-MIS NEE per EstimateDirect,
integrator.cpp:142-250 — light half + BSDF half, 3 sweeps/bounce).
Everything else, and every backend but the GPU, runs the generic
wavefront loop.

Semantics mirrored 1:1 from the XLA path (file:line refs inline):
integrators/render.py _li_loop, integrators/common.py estimate_direct,
scene/portals.py sample_projection, scene/lights.py sample_li/
area_light_L, scene/materials.py matte bsdf, core/rng.py pcg4d,
core/sampling.py concentric disk, core/vecmath.py offset_ray_origin.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

Array = Any

BLOCK = 256         # rays per program (power of two: Triton block rule)
NUM_WARPS = 4
CLUSTER = 32        # triangles per cull cluster (mini-BVH leaves)
CLUSTER_MIN_TRI = 64  # below this the flat all-pairs sweep wins
BIG = 1e30
INV_PI = 1.0 / np.pi
SHADOW_EPS = 1e-3   # vecmath.SHADOW_EPS
_DIM_BASE = 6       # integrators/render.py _bounce_dims
_DIM_STRIDE = 10
_PCG_MUL = 1664525
_PCG_INC = 1013904223

# residual `code` bit layout (per bounce, per lane)
_MAT_MASK = 7       # bits 0-2: hit material row
_B_ALIVE = 8        # bit 3: lane survives into next bounce
_B_RRDIV = 16       # bit 4: russian-roulette 1/(1-q) compensation applied
_B_EMIT = 32        # bit 5: camera/specular-chain emission hit (bounce 0)


def eligible(scene, cfg, power_distr=None, time=None) -> bool:
    """Static dispatch gate for the fused path (checked at trace time):
    the GPU backend and a scene + config inside the kernel's profile."""
    return (jax.default_backend() == "gpu"
            and getattr(scene, "fused_profile", None) is not None
            and power_distr is None and time is None
            and cfg.sampler == "independent"
            and cfg.light_strategy == "uniform"
            and not cfg.collect_stats)


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

def _axes_of(ax: int):
    """plane.cpp ctor tangent axes (scene/shapes.py aaplane_axes)."""
    return {2: (0, 1), 0: (1, 2), 1: (2, 0)}[ax]


def _u32_const(x: int):
    return jnp.uint32(x % (1 << 32))


def _kernel(tri_ref, msc_ref, kd_ref, clu_ref, ox_ref, oy_ref, oz_ref,
            dx_ref, dy_ref, dz_ref, pid_ref, sid_ref, code_out, knee_out,
            kc_out, *, n_tri, n_b, ax, pl_facing, portal_facing, n_mat,
            seed, rr_threshold, mode, n_clu):
    ax0, ax1 = _axes_of(ax)
    f32 = jnp.float32
    sgn_pl = 1.0 if pl_facing else -1.0          # light-plane normal sign

    ox = ox_ref[...]
    oy = oy_ref[...]
    oz = oz_ref[...]
    dx = dx_ref[...]
    dy = dy_ref[...]
    dz = dz_ref[...]
    zero = ox * 0.0
    one = zero + 1.0

    mul = jnp.uint32(_PCG_MUL)
    inc = jnp.uint32(_PCG_INC)
    pid_v0 = pid_ref[...].astype(jnp.uint32) * mul + inc
    sid_v1 = sid_ref[...].astype(jnp.uint32) * mul + inc

    def unif(dim):
        # core/rng.py pcg4d → u32_to_uniform, bit-exact; the dim and seed
        # lanes are static, so their LCG step folds to constants
        v0, v1 = pid_v0, sid_v1
        v2 = _u32_const(dim * _PCG_MUL + _PCG_INC)
        v3 = _u32_const(seed * _PCG_MUL + _PCG_INC)
        v0 = v0 + v1 * v3
        v1 = v1 + v2 * v0
        v2 = v2 + v0 * v1
        v3 = v3 + v1 * v2
        v0 = v0 ^ (v0 >> 16)
        v1 = v1 ^ (v1 >> 16)
        v2 = v2 ^ (v2 >> 16)
        v3 = v3 ^ (v3 >> 16)
        v0 = v0 + v1 * v3
        # floor-top-24-bits form of rng.u32_to_uniform (bit-exact)
        return (v0 >> jnp.uint32(8)).astype(jnp.int32).astype(f32) \
            * f32(1.0 / 16777216.0)

    # scene scalars
    pl_lo = [msc_ref[0, k] for k in range(3)]
    pl_hi = [msc_ref[0, 3 + k] for k in range(3)]
    pl_mat = msc_ref[0, 6]
    po_lo = [msc_ref[0, 7 + k] for k in range(3)]
    po_hi = [msc_ref[0, 10 + k] for k in range(3)]

    def sweep(rox, roy, roz, rdx, rdy, rdz, want_attrs):
        """Closest-hit over triangles + the aaplane (the tests of
        scene/shapes.py intersect_triangles / intersect_aaplanes). Every
        lane reads the same table row, so the loads are broadcasts."""
        bt = zero + BIG
        bp = jnp.full(zero.shape, -1, jnp.int32)
        carry0 = (bt, bp)
        if want_attrs:
            carry0 = (bt, bp, zero, zero, zero, zero)

        def tri_body(i, carry):
            bt_, bp_ = carry[0], carry[1]
            v0x = tri_ref[i, 0]
            v0y = tri_ref[i, 1]
            v0z = tri_ref[i, 2]
            e1x = tri_ref[i, 3]
            e1y = tri_ref[i, 4]
            e1z = tri_ref[i, 5]
            e2x = tri_ref[i, 6]
            e2y = tri_ref[i, 7]
            e2z = tri_ref[i, 8]
            px = rdy * e2z - rdz * e2y
            py = rdz * e2x - rdx * e2z
            pz = rdx * e2y - rdy * e2x
            det = e1x * px + e1y * py + e1z * pz
            inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
            rx = rox - v0x
            ry = roy - v0y
            rz = roz - v0z
            u = (rx * px + ry * py + rz * pz) * inv_det
            qx = ry * e1z - rz * e1y
            qy = rz * e1x - rx * e1z
            qz = rx * e1y - ry * e1x
            v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            hit = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
                   & (u + v <= 1.0) & (t > 1e-4) & (t < bt_))
            out = (jnp.where(hit, t, bt_), jnp.where(hit, i, bp_))
            if want_attrs:
                out += tuple(jnp.where(hit, tri_ref[i, 9 + k], carry[2 + k])
                             for k in range(4))
            return out

        if n_clu == 0:
            carry = jax.lax.fori_loop(0, n_tri, tri_body, carry0)
        else:
            # mini-BVH: triangles are grouped into CLUSTER-row leaves
            # (builder order preserved — culling is conservative, so
            # results are bit-identical to the flat sweep); a
            # block-uniform slab test against the cluster AABB skips the
            # whole leaf when NO lane's [0, t_best] segment overlaps it.
            def _inv(dd):
                mag = jnp.maximum(jnp.abs(dd), 1e-30)
                return jnp.where(dd >= 0.0, 1.0, -1.0) / mag

            ivx = _inv(rdx)
            ivy = _inv(rdy)
            ivz = _inv(rdz)

            def clu_body(ci, carry):
                bt_ = carry[0]
                tnear = zero - BIG
                tfar = zero + BIG
                for k, (ro, iv) in enumerate(
                        ((rox, ivx), (roy, ivy), (roz, ivz))):
                    t0 = (clu_ref[ci, k] - ro) * iv
                    t1 = (clu_ref[ci, 3 + k] - ro) * iv
                    tnear = jnp.maximum(tnear, jnp.minimum(t0, t1))
                    tfar = jnp.minimum(tfar, jnp.maximum(t0, t1))
                ov = (tfar >= jnp.maximum(tnear, 0.0)) & (tnear <= bt_)

                def inner(c):
                    return jax.lax.fori_loop(
                        0, CLUSTER,
                        lambda j, cc: tri_body(ci * CLUSTER + j, cc), c)

                # block-wide any() as a max over an int mask (Triton has
                # no boolean reduction)
                any_ov = jnp.max(ov.astype(jnp.int32)) > 0
                return jax.lax.cond(any_ov, inner, lambda c: c, carry)

            carry = jax.lax.fori_loop(0, n_clu, clu_body, carry0)
        bt, bp = carry[0], carry[1]

        # the single aaplane (static axis; plane.cpp:15-55 slab test)
        o_ax = (rox, roy, roz)[ax]
        d_ax = (rdx, rdy, rdz)[ax]
        t = (pl_lo[ax] - o_ax) / jnp.where(jnp.abs(d_ax) > 1e-12, d_ax,
                                           1e-12)
        h0 = (rox, roy, roz)[ax0] + t * (rdx, rdy, rdz)[ax0]
        h1 = (rox, roy, roz)[ax1] + t * (rdx, rdy, rdz)[ax1]
        hitp = ((jnp.abs(d_ax) > 1e-12) & (t > 1e-4) & (t < bt)
                & (h0 > pl_lo[ax0]) & (h0 < pl_hi[ax0])
                & (h1 > pl_lo[ax1]) & (h1 < pl_hi[ax1]))
        bt = jnp.where(hitp, t, bt)
        bp = jnp.where(hitp, n_tri, bp)
        if not want_attrs:
            return bt, bp
        axis_n = [0.0, 0.0, 0.0]
        axis_n[ax] = sgn_pl
        nxb, nyb, nzb = (jnp.where(hitp, axis_n[k], carry[2 + k])
                         for k in range(3))
        mb = jnp.where(hitp, pl_mat, carry[5])
        return bt, bp, nxb, nyb, nzb, mb

    # ---- per-lane state across bounces
    beta = [one, one, one]
    active = zero < 1.0     # all True
    spec = zero < 1.0
    cox, coy, coz = ox, oy, oz
    cdx, cdy, cdz = dx, dy, dz

    for b in range(n_b):
        base = _DIM_BASE + b * _DIM_STRIDE

        bt, bp, nx, ny, nz, matf = sweep(cox, coy, coz, cdx, cdy, cdz,
                                         True)
        hitv = bp >= 0
        # finalize_hit: p = o + where(valid, t, 0)·d
        tv = jnp.where(hitv, bt, 0.0)
        px = cox + tv * cdx
        py = coy + tv * cdy
        pz = coz + tv * cdz

        # emission at camera/specular vertices (render.py _li_loop
        # path.cpp:291-310 role): light = the aaplane, one-sided
        is_lp = bp == n_tri
        d_axc = (cdx, cdy, cdz)[ax]
        front_cam = (sgn_pl * (-d_axc)) > 0.0
        kemit = active & spec & is_lp & front_cam

        active = active & hitv

        if b == n_b - 1:
            # pbrt's termination order (path.cpp:23-24): the final
            # iteration collects emission only — no NEE, no continuation
            code = matf.astype(jnp.int32) + jnp.where(kemit, _B_EMIT, 0)
            code_out[b, :] = code
            knee_out[b, :] = zero
            kc_out[b, :] = zero
            continue

        # shading frame (Duff; vecmath.coordinate_system)
        s = jnp.where(nz >= 0.0, 1.0, -1.0)
        a = -1.0 / (s + nz)
        bb = nx * ny * a
        t1x = 1.0 + s * nx * nx * a
        t1y = s * bb
        t1z = -s * nx
        t2x = bb
        t2y = s + ny * ny * a
        t2z = -ny
        woz = -(cdx * nx + cdy * ny + cdz * nz)

        # ---------------- NEE (estimate_direct, portal projection)
        u_l0 = unif(base + 1)
        u_l1 = unif(base + 2)

        # fallback: uniform point on the light rect (sample_aaplane)
        lp = [None, None, None]
        lp[ax] = pl_lo[ax] + zero
        lp[ax0] = pl_lo[ax0] + (pl_hi[ax0] - pl_lo[ax0]) * u_l0
        lp[ax1] = pl_lo[ax1] + (pl_hi[ax1] - pl_lo[ax1]) * u_l1
        tox = lp[0] - px
        toy = lp[1] - py
        toz = lp[2] - pz
        d2l = tox * tox + toy * toy + toz * toz
        rl = jax.lax.rsqrt(jnp.maximum(d2l, 1e-30))
        wlx_f = tox * rl
        wly_f = toy * rl
        wlz_f = toz * rl
        area_l = (pl_hi[ax0] - pl_lo[ax0]) * (pl_hi[ax1] - pl_lo[ax1])
        cos_l = jnp.abs((wlx_f, wly_f, wlz_f)[ax])
        pdf_fb = d2l / (jnp.maximum(area_l, 1e-20)
                        * jnp.maximum(cos_l, 1e-9))

        # portal in-front half-space test (aaportal.cpp:101 / plane.cpp
        # InFront): forward side of the portal plane
        p_axv = (px, py, pz)[ax]
        if portal_facing:
            in_front = p_axv > po_lo[ax]
        else:
            in_front = p_axv < po_lo[ax]

        # projection sampling (aaportal.cpp SampleProj via
        # scene/portals.py sample_projection): project the light rect's
        # lo/hi corners through the portal plane, clip, sample
        po_c = po_lo[ax]

        def project(lc):
            dvx = px - lc[0]
            dvy = py - lc[1]
            dvz = pz - lc[2]
            d_axv = (dvx, dvy, dvz)[ax]
            tt = (po_c - lc[ax]) / jnp.where(jnp.abs(d_axv) > 1e-12,
                                             d_axv, 1e-12)
            pr0 = lc[ax0] + tt * (dvx, dvy, dvz)[ax0]
            pr1 = lc[ax1] + tt * (dvx, dvy, dvz)[ax1]
            return pr0, pr1, jnp.abs(d_axv) > 1e-12

        plo0, plo1, ok_lo = project(pl_lo)
        phi0, phi1, ok_hi = project(pl_hi)
        cmin0 = jnp.maximum(po_lo[ax0], jnp.minimum(plo0, phi0))
        cmax0 = jnp.minimum(po_hi[ax0], jnp.maximum(plo0, phi0))
        len0 = jnp.maximum(cmax0 - cmin0, 0.0)
        cmin1 = jnp.maximum(po_lo[ax1], jnp.minimum(plo1, phi1))
        cmax1 = jnp.minimum(po_hi[ax1], jnp.maximum(plo1, phi1))
        len1 = jnp.maximum(cmax1 - cmin1, 0.0)
        area_p = len0 * len1
        okp = ok_lo & ok_hi & (area_p > 1e-12)
        sp = [None, None, None]
        sp[ax] = po_c + zero
        sp[ax0] = cmin0 + u_l0 * len0
        sp[ax1] = cmin1 + u_l1 * len1
        tpx = sp[0] - px
        tpy = sp[1] - py
        tpz = sp[2] - pz
        d2p = tpx * tpx + tpy * tpy + tpz * tpz
        rp = jax.lax.rsqrt(jnp.maximum(d2p, 1e-30))
        wpx = tpx * rp
        wpy = tpy * rp
        wpz = tpz * rp
        # pdf = d2 / max(|dot(n_portal, -wi)|·area, 1e-9), n = ±axis
        cos_p = jnp.abs((wpx, wpy, wpz)[ax])
        pdf_pj = jnp.where(okp, d2p / jnp.maximum(cos_p * area_p, 1e-9),
                           0.0)

        if mode == 1:
            use_portal = in_front  # strategy==projection, behind→fallback
            wix = jnp.where(use_portal, wpx, wlx_f)
            wiy = jnp.where(use_portal, wpy, wly_f)
            wiz = jnp.where(use_portal, wpz, wlz_f)
            pdf_nee = jnp.where(use_portal, pdf_pj, pdf_fb)
        else:
            # mode 0: plain diffuse area light — the light half of
            # estimate_direct's two-sample MIS samples the rect
            # uniformly (the fallback sampler above IS Sample_Li)
            wix, wiy, wiz = wlx_f, wly_f, wlz_f
            pdf_nee = pdf_fb

        # shadow/emission closest-hit from the offset origin
        # (trace_radiance → offset_ray_origin, vecmath.py:133-142)
        ndw = nx * wix + ny * wiy + nz * wiz
        nfs = jnp.where(ndw < 0.0, -1.0, 1.0)
        scale = SHADOW_EPS * jnp.maximum(
            1.0, jnp.maximum(jnp.abs(px),
                             jnp.maximum(jnp.abs(py), jnp.abs(pz))))
        o2x = px + scale * nfs * nx
        o2y = py + scale * nfs * ny
        o2z = pz + scale * nfs * nz
        bt2, bp2 = sweep(o2x, o2y, o2z, wix, wiy, wiz, False)
        # emission toward the shading point travels along -wi: one-sided
        # L requires dot(n_light, -wi) > 0 (lights.py area_light_L)
        wi_axc = (wix, wiy, wiz)[ax]
        le_front = (sgn_pl * (-wi_axc)) > 0.0
        le_hit = (bp2 == n_tri) & le_front

        # f = kd/π·|cos|·refl; ld = f·li/pdf (portal single-sample
        # estimator, portal_arealight.cpp:103-115; /psel with one portal
        # = /1). knee excludes kd/π and emit → replay multiplies them.
        refl = (woz * ndw) > 0.0
        ok_nee = active & (pdf_nee > 0.0) & refl & le_hit
        knee = jnp.where(ok_nee, jnp.abs(ndw)
                         / jnp.maximum(pdf_nee, 1e-20), 0.0)

        if mode == 0:
            # plain area light: two-sample MIS (EstimateDirect,
            # integrator.cpp:142-250). Light half above gets the power
            # heuristic against the cosine scatter pdf; then the BSDF
            # half samples a cosine direction (mis_u dims, matching the
            # XLA path's estimate_direct streams) and adds
            # |cos|·w_b/pdf_b when its closest hit is the emitting side
            # of the light plane. Both halves share the kd/π·emit
            # factor, so they fold into the SAME knee residual.
            p_scat = jnp.where(refl, jnp.abs(ndw) * f32(INV_PI), 0.0)
            w_l = (pdf_nee * pdf_nee) / jnp.maximum(
                pdf_nee * pdf_nee + p_scat * p_scat, 1e-20)
            knee = knee * w_l

            wbx_l, wby_l, wbz_l = _cosine_dir(unif(base + 4),
                                              unif(base + 5), woz)
            wbx = wbx_l * t1x + wby_l * t2x + wbz_l * nx
            wby = wbx_l * t1y + wby_l * t2y + wbz_l * ny
            wbz = wbx_l * t1z + wby_l * t2z + wbz_l * nz
            pdf_b = jnp.abs(wbz_l) * f32(INV_PI)
            ndw_b = nx * wbx + ny * wby + nz * wbz
            nfs_b = jnp.where(ndw_b < 0.0, -1.0, 1.0)
            o3x = px + scale * nfs_b * nx
            o3y = py + scale * nfs_b * ny
            o3z = pz + scale * nfs_b * nz
            bt3, bp3 = sweep(o3x, o3y, o3z, wbx, wby, wbz, False)
            wb_ax = (wbx, wby, wbz)[ax]
            le_front3 = (sgn_pl * (-wb_ax)) > 0.0
            hit_l3 = (bp3 == n_tri) & le_front3
            # Pdf_Li along wb (lights.py pdf_li area branch): the plane
            # IS the closest hit when hit_l3, so bt3 is its distance
            pdf_li_b = (bt3 * bt3) / jnp.maximum(
                jnp.abs(wb_ax) * area_l, 1e-9)
            w_b = (pdf_b * pdf_b) / jnp.maximum(
                pdf_b * pdf_b + pdf_li_b * pdf_li_b, 1e-20)
            knee_b = jnp.where(active & hit_l3 & (pdf_b > 0.0),
                               jnp.abs(ndw_b) * w_b
                               / jnp.maximum(pdf_b, 1e-20), 0.0)
            knee = knee + knee_b

        # ---------------- continuation (matte cosine lobe)
        wcx, wcy, wcz = _cosine_dir(unif(base + 7), unif(base + 8), woz)
        # world direction through the shading frame
        wwx = wcx * t1x + wcy * t2x + wcz * nx
        wwy = wcx * t1y + wcy * t2y + wcz * ny
        wwz = wcx * t1z + wcy * t2z + wcz * nz
        pdf_c = jnp.abs(wcz) * f32(INV_PI)
        cos_c = jnp.abs(nx * wwx + ny * wwy + nz * wwz)
        refl_c = (woz * wcz) > 0.0
        kc = jnp.where(refl_c, cos_c * f32(INV_PI)
                       / jnp.maximum(pdf_c, 1e-20), 0.0)

        # beta tracking (for RR decisions + alive) — kd gathered by
        # per-lane select over the ≤8 material rows
        mi = matf.astype(jnp.int32)
        kdv = [zero, zero, zero]
        for mrow in range(n_mat):
            sel = mi == mrow
            for c in range(3):
                kdv[c] = jnp.where(sel, kd_ref[mrow, c], kdv[c])
        bn = [beta[c] * kdv[c] * kc for c in range(3)]
        bmax = jnp.maximum(bn[0], jnp.maximum(bn[1], bn[2]))
        alive = active & (pdf_c > 0.0) & (bmax > 0.0)
        rr_div = zero > 1.0    # False
        if b > 3:
            # russian roulette (path.cpp:362-370); eta_scale = 1 (matte)
            do_rr = bmax < rr_threshold
            q = jnp.maximum(0.05, 1.0 - bmax)
            u_rr = unif(base + 9)
            killed = do_rr & (u_rr < q)
            rr_div = do_rr & ~killed
            inv = 1.0 / jnp.maximum(1.0 - q, 1e-6)
            bn = [jnp.where(rr_div, v * inv, v) for v in bn]
            alive = alive & ~killed

        # residuals
        code = (mi + jnp.where(alive, _B_ALIVE, 0)
                + jnp.where(rr_div, _B_RRDIV, 0)
                + jnp.where(kemit, _B_EMIT, 0))
        code_out[b, :] = code
        knee_out[b, :] = knee
        kc_out[b, :] = kc

        # state update (render.py _li_loop tail)
        beta = [jnp.where(alive, bn[c], beta[c]) for c in range(3)]
        ndw2 = nx * wwx + ny * wwy + nz * wwz
        nfs2 = jnp.where(ndw2 < 0.0, -1.0, 1.0)
        cox = jnp.where(alive, px + scale * nfs2 * nx, cox)
        coy = jnp.where(alive, py + scale * nfs2 * ny, coy)
        coz = jnp.where(alive, pz + scale * nfs2 * nz, coz)
        cdx = jnp.where(alive, wwx, cdx)
        cdy = jnp.where(alive, wwy, cdy)
        cdz = jnp.where(alive, wwz, cdz)
        spec = spec & ~alive       # matte: never specular
        active = alive


def _cosine_dir(u0, u1, woz):
    """Cosine-hemisphere direction in the local frame, flipped to wo's
    side: concentric disk (sampling.py:178-190) lifted to the sphere."""
    f32 = jnp.float32
    uxo = 2.0 * u0 - 1.0
    uyo = 2.0 * u1 - 1.0
    zero_d = (uxo == 0.0) & (uyo == 0.0)
    use_x = jnp.abs(uxo) > jnp.abs(uyo)
    r = jnp.where(use_x, uxo, uyo)
    pi4 = f32(np.pi / 4)
    pi2 = f32(np.pi / 2)
    theta = jnp.where(
        use_x, pi4 * (uyo / jnp.where(uxo == 0.0, 1.0, uxo)),
        pi2 - pi4 * (uxo / jnp.where(uyo == 0.0, 1.0, uyo)))
    r = jnp.where(zero_d, 0.0, r)
    theta = jnp.where(zero_d, 0.0, theta)
    ddx = r * jnp.cos(theta)
    ddy = r * jnp.sin(theta)
    ddz = jnp.sqrt(jnp.maximum(0.0, 1.0 - ddx * ddx - ddy * ddy))
    sflip = jnp.sign(woz + 1e-20)
    return ddx * sflip, ddy * sflip, ddz * sflip


# ---------------------------------------------------------------------------
# host wrapper + replay
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("n_tri", "n_b", "ax", "pl_facing",
                              "portal_facing", "n_mat", "seed",
                              "rr_threshold", "mode", "n_clu", "interpret"))
def _impl(tri_tab, msc, kd, clu, o, d, pid, sidx, *, n_tri, n_b, ax,
          pl_facing, portal_facing, n_mat, seed, rr_threshold, mode,
          n_clu=0, interpret=False):
    """Residuals (code, knee, kc), each (n_b, R), for R rays. The ray
    batch is padded to a multiple of ``BLOCK``; padded lanes are dropped."""
    R = o.shape[0]
    pad = -R % BLOCK
    Rpad = R + pad

    def pad1(x, fill):
        return jnp.pad(x, (0, pad), constant_values=fill) if pad else x

    comps = [pad1(o[:, k], 0.0) for k in range(3)]
    comps += [pad1(d[:, k], 1.0) for k in range(3)]
    comps += [pad1(pid.astype(jnp.int32), 0),
              pad1(sidx.astype(jnp.int32), 0)]

    kernel = functools.partial(
        _kernel, n_tri=n_tri, n_b=n_b, ax=ax, pl_facing=pl_facing,
        portal_facing=portal_facing, n_mat=n_mat, seed=seed,
        rr_threshold=rr_threshold, mode=mode, n_clu=n_clu)
    tables = (tri_tab, msc, kd, clu)
    whole = [pl.BlockSpec(t.shape, lambda i: (0, 0)) for t in tables]
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    res_spec = pl.BlockSpec((n_b, BLOCK), lambda i: (0, i))
    # under shard_map the residuals vary over the mesh axes the rays do
    vma = frozenset().union(*(jax.typeof(x).vma for x in comps))
    code, knee, kc = pl.pallas_call(
        kernel,
        grid=(Rpad // BLOCK,),
        in_specs=whole + [ray_spec] * 8,
        out_specs=[res_spec] * 3,
        out_shape=[jax.ShapeDtypeStruct((n_b, Rpad), dt, vma=vma)
                   for dt in (jnp.int32, jnp.float32, jnp.float32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="fused_path",
    )(*tables, *comps)
    return code[:, :R], knee[:, :R], kc[:, :R]


def replay(kd, emit, code, knee, kc, rr_threshold=1.0):
    """Differentiable reconstruction of L from the kernel's residuals.

    Mirrors the _li_loop accumulation exactly: per bounce, emission +
    NEE with the *entering* beta, then beta ← beta·kd[m]·kc with the RR
    1/(1−q) compensation recomputed from beta (so ∂L/∂kd flows through
    the RR normalization just as in the autodiff of the generic path).
    kd: (M,C); emit: (C,); code/knee/kc: (NB,R)."""
    from pbrt_tpu.ops import fastgather

    nb, R = code.shape
    C = kd.shape[-1]
    beta = jnp.ones((R, C))
    L = jnp.zeros((R, C))
    for b in range(nb):
        cb = code[b]
        m = cb & _MAT_MASK
        alive = (cb & _B_ALIVE) > 0
        rr_div = (cb & _B_RRDIV) > 0
        kem = (cb & _B_EMIT) > 0
        kd_b = fastgather.gather_rows(kd, m)
        L = L + jnp.where(kem[:, None], beta * emit[None], 0.0)
        L = L + beta * kd_b * (knee[b] * INV_PI)[:, None] * emit[None]
        bn = beta * kd_b * kc[b][:, None]
        bmax = jnp.max(bn, axis=-1)
        q = jnp.maximum(0.05, 1.0 - bmax)
        bn = jnp.where(rr_div[:, None],
                       bn / jnp.maximum(1.0 - q, 1e-6)[:, None], bn)
        beta = jnp.where(alive[:, None], bn, beta)
    return L


def pack_fused(scene, mode):
    """Trace-time packing of the prim/scene tables.

    tri_tab rows are [v0 | e1 | e2 | n | material | 0 0 0] (16 floats).
    For scenes past CLUSTER_MIN_TRI triangles, also emits a (n_clu, 8)
    cluster-AABB table over contiguous CLUSTER-row runs (builder order —
    preserving the exact flat-sweep hit results) for the kernel's
    block-uniform leaf culling; rows are padded to a cluster multiple
    with degenerate (e1=e2=0 → det=0 → never hit) copies of the last
    triangle so the padded rows cannot expand the final cluster's box."""
    g = scene.geom
    nt = scene.n_tri
    v0 = g.tri_v0[:nt]
    e1 = g.tri_v1[:nt] - v0
    e2 = g.tri_v2[:nt] - v0
    n = jnp.cross(e1, e2)
    n = n * jax.lax.rsqrt(jnp.maximum(jnp.sum(n * n, -1, keepdims=True),
                                      1e-30))
    matf = scene.prim_mat[:nt].astype(jnp.float32)[:, None]
    tri_tab = jnp.concatenate(
        [v0, e1, e2, n, matf, jnp.zeros((nt, 3))], axis=-1)
    n_clu = 0
    clu = jnp.zeros((1, 8), jnp.float32)
    if nt > CLUSTER_MIN_TRI:
        n_clu = -(-nt // CLUSTER)
        pad = n_clu * CLUSTER - nt
        if pad:
            prow = tri_tab[-1:].at[:, 3:9].set(0.0)
            tri_tab = jnp.concatenate(
                [tri_tab, jnp.tile(prow, (pad, 1))], axis=0)
        p0 = v0
        p1 = v0 + e1
        p2 = v0 + e2
        lo = jnp.minimum(jnp.minimum(p0, p1), p2)
        hi = jnp.maximum(jnp.maximum(p0, p1), p2)
        if pad:
            lo = jnp.concatenate([lo, jnp.tile(lo[-1:], (pad, 1))], 0)
            hi = jnp.concatenate([hi, jnp.tile(hi[-1:], (pad, 1))], 0)
        lo = jnp.min(lo.reshape(n_clu, CLUSTER, 3), axis=1)
        hi = jnp.max(hi.reshape(n_clu, CLUSTER, 3), axis=1)
        # conservative float padding so slab-test rounding can't cull a
        # box the exact triangle test would hit
        eps = 1e-5 * jnp.maximum(jnp.abs(lo), jnp.abs(hi)) + 1e-6
        clu = jnp.concatenate(
            [lo - eps, hi + eps, jnp.zeros((n_clu, 2))], axis=-1)
    if mode == 1:
        po_lo = scene.lights.portal_lo[0, 0]
        po_hi = scene.lights.portal_hi[0, 0]
    else:
        po_lo = jnp.zeros(3)
        po_hi = jnp.zeros(3)
    msc = jnp.concatenate([
        g.pln_lo[0], g.pln_hi[0],
        scene.prim_mat[nt:nt + 1].astype(jnp.float32),
        po_lo, po_hi, jnp.zeros(3)])[None, :]
    return tri_tab, msc, clu, n_clu


def li_path_fused(scene, o, d, pid, sidx, cfg, interpret=False):
    """Fused-path Li: residual kernel + XLA replay. Drop-in for _li_loop
    under the `eligible` gate; (R,C) radiance out."""
    ax, pl_facing, portal_facing, n_mat, mode = scene.fused_profile
    n_b = cfg.max_depth + 1
    tri_tab, msc, clu, n_clu = pack_fused(scene, mode)
    code, knee, kc = _impl(
        jax.lax.stop_gradient(tri_tab), jax.lax.stop_gradient(msc),
        jax.lax.stop_gradient(scene.materials.kd),
        jax.lax.stop_gradient(clu), o, d, pid, sidx,
        n_tri=scene.n_tri, n_b=n_b, ax=ax, pl_facing=pl_facing,
        portal_facing=portal_facing, n_mat=n_mat, seed=cfg.seed,
        rr_threshold=cfg.rr_threshold, mode=mode, n_clu=n_clu,
        interpret=interpret)
    code = jax.lax.stop_gradient(code)
    knee = jax.lax.stop_gradient(knee)
    kc = jax.lax.stop_gradient(kc)
    return replay(scene.materials.kd, scene.lights.emit[0], code, knee,
                  kc, rr_threshold=cfg.rr_threshold)
