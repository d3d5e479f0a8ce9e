"""Volumetric path tracing.

JAX counterpart of ``integrators/volpath.cpp``: per segment the
current medium is sampled for a scattering event (volpath.cpp:55-79); medium
interactions do NEE with transmittance-weighted visibility and continue by
Henyey–Greenstein phase sampling; surface interactions behave like `path`.

Media attach per primitive (MediumInterface, core/medium.h:114 +
GeometricPrimitive): rays carry a per-lane medium id that switches when a
transmissive boundary is crossed (SurfaceInteraction::SpawnRay picking
inside/outside, core/interaction.h:66-80), and shadow rays accumulate
transmittance segment-by-segment through null-material boundaries
(VisibilityTester::Tr, core/light.cpp:64-85). The legacy scene-global
``camera_medium`` is treated as media=(m,) with camera_med=0.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from pbrt_tpu.core import vecmath
from pbrt_tpu.core.sampling import power_heuristic
from pbrt_tpu.core.vecmath import absdot
from pbrt_tpu.integrators import common
from pbrt_tpu.scene import intersect as isect_mod
from pbrt_tpu.scene import lights as lights_mod
from pbrt_tpu.scene import materials as mat_mod
from pbrt_tpu.scene import media as media_mod

Array = Any

# shadow rays pass through at most this many null-material boundaries
# (VisibilityTester::Tr's unbounded while loop, bounded for a static
# trip count)
_TR_SEGMENTS = 4


def _effective_media(scene):
    media = tuple(getattr(scene, "media", ()) or ())
    cam_med = getattr(scene, "camera_med", -1)
    legacy = getattr(scene, "camera_medium", None)
    if not media and legacy is not None:
        media = (legacy,)
        cam_med = 0
    return media, cam_med


def _crossing_medium(scene, prim_id, entering):
    """Medium id after crossing prim_id (inside when entering)."""
    from pbrt_tpu.ops import fastgather
    m_in = fastgather.gather_rows(scene.prim_med_in, prim_id)
    m_out = fastgather.gather_rows(scene.prim_med_out, prim_id)
    return jnp.where(entering, m_in, m_out)


def tr_segmented(scene, media, med0, p0, p1, seed):
    """Transmittance p0→p1 through up to _TR_SEGMENTS null-material
    boundaries (VisibilityTester::Tr): real-material hits block; null hits
    accumulate the current medium's Tr and switch medium. Returns (R,C)."""
    C = scene.n_channels
    R = p0.shape[0]

    def body(i, carry):
        p, med, tr, done, blocked = carry
        seg = p1 - p
        dist = vecmath.length(seg)
        dn = seg / jnp.maximum(dist, 1e-12)[..., None]
        hit = isect_mod.intersect(scene, p, dn, dist * (1.0 - 1e-3))
        mat_t = scene.mat_at(hit.prim_id)
        # NONE rows are pass-through boundaries
        g = mat_mod.gather_materials(scene.materials, mat_t)
        null_mat = g.mtype == mat_mod.NONE
        passes = hit.valid & null_mat
        blocks = hit.valid & ~null_mat

        p_seg_end = jnp.where(hit.valid[..., None], hit.p, p1)
        tr_seg = media_mod.transmittance_set(
            media, med, p, p_seg_end, seed + jnp.uint32(i * 7919)) \
            if media else jnp.ones((R, C))
        tr = jnp.where(done[..., None], tr, tr * tr_seg)
        blocked = blocked | (~done & blocks)
        # cross the null boundary: switch medium, restart past the surface
        entering = vecmath.dot(dn, hit.ng) < 0
        med_next = _crossing_medium(scene, hit.prim_id, entering)
        med = jnp.where(~done & passes, med_next, med)
        p_next = vecmath.offset_ray_origin(hit.p, hit.ng, dn)
        p = jnp.where((~done & passes)[..., None], p_next, p)
        done = done | ~passes
        return p, med, tr, done, blocked

    # derive carries from p0 so their vma type matches loop outputs under
    # shard_map (same pattern as render._li_loop)
    zero_r = p0[..., 0] * 0.0
    tr0 = jnp.ones((R, C)) + zero_r[..., None]
    done0 = zero_r != 0.0
    _, _, tr, _, blocked = jax.lax.fori_loop(
        0, _TR_SEGMENTS, body, (p0, med0 + zero_r.astype(med0.dtype), tr0,
                                done0, done0))
    return jnp.where(blocked[..., None], 0.0, tr), blocked


def li_volpath(scene, o, d, pid, sidx, sfn, cfg, power_distr, time=None,
               cam=None):
    media, cam_med = _effective_media(scene)
    if not media:
        from pbrt_tpu.integrators.render import li_path
        return li_path(scene, o, d, pid, sidx, sfn, cfg, power_distr)

    from pbrt_tpu.integrators.render import _bounce_dims, _sample2
    R = o.shape[0]
    C = scene.n_channels
    zero_r = o[..., 0] * 0.0
    L = jnp.zeros((R, C)) + zero_r[..., None]
    beta = jnp.ones((R, C)) + zero_r[..., None]
    active = zero_r == 0.0
    specular = zero_r == 0.0
    o_cur, d_cur = o, d
    cur_med = jnp.full(R, cam_med, jnp.int32) + (zero_r).astype(jnp.int32)

    def nee_from(p, ns_or_wo, is_medium, cur_med, mp, wo_world, b, dims,
                 hit):
        """NEE valid at both surface and medium vertices
        (volpath.cpp handleMedia path in EstimateDirect)."""
        u_sel = sfn(pid, sidx, dims["select"], cfg.seed)
        u_l = _sample2(sfn, pid, sidx, dims["light_u"], cfg.seed)
        light_idx, sel_pmf = common.choose_light(scene, u_sel, power_distr)
        ls = lights_mod.sample_li(scene, light_idx, p, u_l)
        # offset surface origins off the surface before the segmented trace
        p_from = jnp.where(
            is_medium[..., None], p,
            vecmath.offset_ray_origin(p, ns_or_wo, ls["wi"]))
        tr, blocked = tr_segmented(
            scene, media, cur_med, p_from, ls["p_light"],
            pid * jnp.uint32(2654435761)
            ^ sidx * jnp.uint32(0xb5297a4d) + jnp.uint32(b))
        # scattering term
        t1, t2 = common.shading_frame(hit, mp)
        t1 = jnp.where(is_medium[..., None],
                       common.make_frame(ns_or_wo)[0], t1)
        t2 = jnp.where(is_medium[..., None],
                       common.make_frame(ns_or_wo)[1], t2)
        wi_loc = common.to_local(t1, t2, ns_or_wo, ls["wi"])
        wo_loc = common.to_local(t1, t2, ns_or_wo, wo_world)
        h_hair = common.hair_offset(mp, hit)
        f_surf = mat_mod.bsdf_f(mp, wo_loc, wi_loc, h=h_hair,
                                fourier=scene.fourier) \
            * absdot(ls["wi"], ns_or_wo)[..., None]
        sp_surf = mat_mod.bsdf_pdf(mp, wo_loc, wi_loc, h=h_hair,
                                   fourier=scene.fourier)
        cos_t = vecmath.dot(wo_world, ls["wi"])
        g_lane = media_mod.phase_g_set(media, cur_med)
        ph = media_mod.hg_phase(cos_t, g_lane)
        f_med = jnp.broadcast_to(ph[..., None], (R, C))
        f = jnp.where(is_medium[..., None], f_med, f_surf)
        sp = jnp.where(is_medium, ph, sp_surf)
        w = jnp.where(ls["is_delta"], 1.0,
                      power_heuristic(1.0, ls["pdf"] * sel_pmf, 1.0, sp))
        ld = f * ls["li"] * tr * (
            w / jnp.maximum(ls["pdf"] * sel_pmf, 1e-20))[..., None]
        ld = jnp.where((~blocked & (ls["pdf"] > 0))[..., None], ld, 0.0)

        # ---- scattering-strategy half of the two-sample MIS
        # (EstimateDirect's second half with handleMedia,
        # integrator.cpp:128-186): sample the BSDF (surface) or the
        # phase function (medium), trace toward it, and count THIS
        # light's radiance with transmittance and the complementary
        # power-heuristic weight. r4: this half was missing while the
        # light half was already MIS-down-weighted — non-delta lights
        # lost their scatter-sampled share in volumetric scenes.
        # static python int: samplers with host-side scrambling tables
        # (halton/sobol) require a concrete seed (samplers/__init__.py
        # `int(seed)`) — a jnp scalar here crashed every scene-file
        # volpath render with a low-discrepancy sampler
        sseed = int(cfg.seed) ^ 0x777
        u_bl = sfn(pid, sidx, dims["mis_lobe"], sseed)
        u_bu = _sample2(sfn, pid, sidx, dims["mis_u"], sseed)
        wi_b_loc, f_b, pdf_b, flags_b = mat_mod.bsdf_sample(
            mp, wo_loc, u_bl, u_bu, h=h_hair, fourier=scene.fourier)
        wi_b_surf = common.to_world(t1, t2, ns_or_wo, wi_b_loc)
        g_l2 = media_mod.phase_g_set(media, cur_med)
        wi_b_med, ph_b = media_mod.sample_hg(wo_world, u_bu, g_l2)
        wi_b = jnp.where(is_medium[..., None], wi_b_med, wi_b_surf)
        f_b = jnp.where(is_medium[..., None],
                        jnp.broadcast_to(ph_b[..., None], f_b.shape), f_b)
        pdf_b2 = jnp.where(is_medium, ph_b, pdf_b)
        cos_b = jnp.where(is_medium, 1.0, absdot(wi_b, ns_or_wo))
        is_spec_b = ~is_medium & ((flags_b & mat_mod.FLAG_SPECULAR) > 0)

        o_b = jnp.where(is_medium[..., None], p,
                        vecmath.offset_ray_origin(p, ns_or_wo, wi_b))
        # IntersectTr semantics (scene.cpp:59-83, used by EstimateDirect's
        # handleMedia BSDF half): walk THROUGH null-material boundaries,
        # accumulating each segment's Tr and switching media, until a
        # REAL surface or escape — a plain closest-hit would stop at the
        # fog boundary and never find the light behind it
        seed_b = pid * jnp.uint32(0x85ebca6b) \
            ^ sidx * jnp.uint32(0x68e31da4) + jnp.uint32(b)
        R_ = p.shape[0]
        o_walk = o_b
        med_walk = cur_med
        tr_b = jnp.ones((R_, C))
        found = jnp.zeros(R_, bool)
        hit_b = isect_mod.intersect(scene, o_walk, wi_b,
                                    jnp.full(R_, vecmath.INF))
        for k in range(_TR_SEGMENTS):
            seg_end = jnp.where(
                hit_b.valid[..., None], hit_b.p,
                o_walk + (2.0 * scene.world_radius()) * wi_b)
            tr_k = media_mod.transmittance_set(
                media, med_walk, o_walk, seg_end,
                seed_b + jnp.uint32(k * 104729))
            tr_b = jnp.where(found[..., None], tr_b, tr_b * tr_k)
            g_k = mat_mod.gather_materials(
                scene.materials, scene.mat_at(hit_b.prim_id))
            is_null_k = hit_b.valid & (g_k.mtype == mat_mod.NONE)
            found = found | ~is_null_k        # real hit or escape
            if k == _TR_SEGMENTS - 1:
                break
            entering_k = vecmath.dot(wi_b, hit_b.ng) < 0
            med_nk = _crossing_medium(scene, hit_b.prim_id, entering_k)
            med_walk = jnp.where(~found & is_null_k, med_nk, med_walk)
            o_nk = vecmath.offset_ray_origin(hit_b.p, hit_b.ng, wi_b)
            o_walk = jnp.where((~found)[..., None], o_nk, o_walk)
            hit_nk = isect_mod.intersect(scene, o_walk, wi_b,
                                         jnp.full(R_, vecmath.INF))
            import dataclasses as _dc
            hit_b = _dc.replace(
                hit_nk, **{f: jnp.where(
                    found if getattr(hit_b, f).ndim == 1
                    else found[..., None], getattr(hit_b, f),
                    getattr(hit_nk, f))
                    for f in ("valid", "t", "p", "ng", "ns", "prim_id")})
        blocked_b = jnp.zeros(R_, bool)
        hit_b_light = jnp.where(hit_b.valid,
                                scene.light_at(hit_b.prim_id), -1)
        gb = lights_mod.gather_lights(scene.lights,
                                      jnp.maximum(light_idx, 0))
        li_b = lights_mod.area_light_L(gb.emit, gb.two_sided, hit_b.ng,
                                       -wi_b)
        li_b = jnp.where((hit_b_light == light_idx)[..., None], li_b, 0.0)
        is_inf_b = gb.ltype == lights_mod.INFINITE
        li_b = jnp.where((is_inf_b & ~hit_b.valid)[..., None],
                         lights_mod.escaped_radiance(scene, wi_b), li_b)
        light_pdf_b = lights_mod.pdf_li(scene, light_idx, p, wi_b) \
            * sel_pmf
        w_b = power_heuristic(1.0, pdf_b2, 1.0, light_pdf_b)
        ld_b = f_b * li_b * tr_b * (
            cos_b * w_b / jnp.maximum(pdf_b2, 1e-20))[..., None]
        good_b = (~ls["is_delta"]) & (pdf_b2 > 0) & ~is_spec_b \
            & ~blocked_b
        return ld + jnp.where(good_b[..., None], ld_b, 0.0)

    def body(b, state):
        L, beta, active, specular, o_cur, d_cur, cur_med = state
        dims = _bounce_dims(b)
        hit = isect_mod.intersect(scene, o_cur, d_cur,
                                  jnp.full(R, vecmath.INF))
        t_max = jnp.where(hit.valid, hit.t, 2.0 * scene.world_radius())

        # ---- medium event sampling in the lane's current medium
        # (volpath.cpp:55-66)
        u_med = sfn(pid, sidx, dims["mis_lobe"], cfg.seed)
        # r4: the tracking seeds must mix the SAMPLE index too — with
        # (pixel, bounce) only, every spp sample reused ONE delta-tracking
        # realization per pixel (no averaging over medium randomness;
        # surfaced as block-scale noise on the grid-medium oracle)
        seed = pid * jnp.uint32(0x9e3779b9) \
            ^ sidx * jnp.uint32(0x1b873593) + jnp.uint32(b)
        t_m, in_medium, w_med, w_surf = media_mod.sample_distance_set(
            media, cur_med, o_cur, d_cur, t_max, u_med, seed)
        beta = jnp.where(active[..., None],
                         beta * jnp.where(in_medium[..., None], w_med,
                                          w_surf), beta)
        p_med = o_cur + t_m[..., None] * d_cur

        # ---- emission on surface path (camera/specular only), attenuated
        light_id = scene.light_at(hit.prim_id)
        light_id = jnp.where(hit.valid, light_id, -1)
        gl = lights_mod.gather_lights(scene.lights,
                                      jnp.maximum(light_id, 0))
        le = lights_mod.area_light_L(gl.emit, gl.two_sided, hit.ng, -d_cur)
        le = jnp.where((light_id >= 0)[..., None], le, 0.0)
        env = lights_mod.escaped_radiance(scene, d_cur)
        emit = jnp.where(hit.valid[..., None], le, env)
        take_emit = active & specular & ~in_medium
        L = L + jnp.where(take_emit[..., None], beta * emit, 0.0)

        mp = mat_mod.gather_materials(
            scene.materials,
            scene.mat_at(hit.prim_id))
        is_null = mp.mtype == mat_mod.NONE

        # ---- subsurface relocation on real surface vertices: pbrt's
        # volpath runs the same bssrdf block as path
        # (volpath.cpp:151-163); lanes whose distance sample scattered
        # in the medium are not surface vertices this bounce
        wo_w = -d_cur
        if scene.has_sss:
            hit, mp, beta, _, wo_w = common.subsurface_transport(
                scene, hit, mp, beta, -d_cur, pid, sidx, sfn, cfg.seed,
                dims, eligible=~in_medium)

        # ---- NEE from the actual vertex (medium point or surface point);
        # null-material surfaces are not scattering vertices
        p_v = jnp.where(in_medium[..., None], p_med, hit.p)
        ns_v = jnp.where(in_medium[..., None], -d_cur, hit.ns)
        alive_v = active & (in_medium | (hit.valid & ~is_null))
        ld = nee_from(p_v, ns_v, in_medium, cur_med, mp, wo_w, b, dims,
                      hit)
        # no NEE on the final iteration (volpath.cpp:85,113 break BEFORE
        # scattering — r5 depth-convention fix, see render.py _li_loop)
        L = L + jnp.where((alive_v & (b < cfg.max_depth))[..., None],
                          beta * ld, 0.0)

        # ---- continuation: phase sample (medium) or BSDF sample (surface)
        u_cl = sfn(pid, sidx, dims["cont_lobe"], cfg.seed)
        u_cu = _sample2(sfn, pid, sidx, dims["cont_u"], cfg.seed)
        # pbrt convention: wo points back along the incoming ray; forward
        # scattering (g>0) then concentrates wi near -wo = d_cur
        g_lane = media_mod.phase_g_set(media, cur_med)
        wi_med, _ = media_mod.sample_hg(-d_cur, u_cu, g_lane)

        t1, t2 = common.shading_frame(hit, mp)
        wo = common.to_local(t1, t2, hit.ns, wo_w)
        wi_loc, f, pdf, flags = mat_mod.bsdf_sample(
            mp, wo, u_cl, u_cu, h=common.hair_offset(mp, hit),
            fourier=scene.fourier)
        wi_surf = common.to_world(t1, t2, hit.ns, wi_loc)
        thr_surf = f * (absdot(wi_surf, hit.ns)
                        / jnp.maximum(pdf, 1e-20))[..., None]
        is_spec = (flags & mat_mod.FLAG_SPECULAR) > 0
        is_trans = (flags & mat_mod.FLAG_TRANSMISSION) > 0

        wi = jnp.where(in_medium[..., None], wi_med, wi_surf)
        thr = jnp.where(in_medium[..., None], 1.0, thr_surf)  # HG: f/pdf=1
        ok_surf = ~in_medium & hit.valid & (pdf > 0)
        alive = active & (in_medium | ok_surf)
        beta_new = beta * thr
        alive = alive & (jnp.max(beta_new, -1) > 0) & (b < cfg.max_depth)

        # ---- medium switch at transmissive boundary crossings
        # (SpawnRay picking MediumInterface inside/outside)
        crossed = alive & ~in_medium & is_trans
        entering = vecmath.dot(wi, hit.ng) < 0
        med_next = _crossing_medium(scene, hit.prim_id, entering)
        cur_med = jnp.where(crossed, med_next, cur_med)

        # russian roulette
        rr_max = jnp.max(beta_new, -1)
        q = jnp.maximum(0.05, 1.0 - rr_max)
        u_rr = sfn(pid, sidx, dims["rr"], cfg.seed)
        do_rr = (b > 3) & (rr_max < cfg.rr_threshold)
        killed = do_rr & (u_rr < q)
        beta_new = jnp.where((do_rr & ~killed)[..., None],
                             beta_new / jnp.maximum(1 - q, 1e-6)[..., None],
                             beta_new)
        alive = alive & ~killed

        o_next = jnp.where(
            in_medium[..., None], p_med,
            vecmath.offset_ray_origin(hit.p, hit.ng, wi))
        beta = jnp.where(alive[..., None], beta_new, beta)
        o_cur = jnp.where(alive[..., None], o_next, o_cur)
        d_cur = jnp.where(alive[..., None], wi, d_cur)
        # null boundaries PRESERVE the incoming specular state (pbrt:
        # `if (!isect.bsdf) { ray = SpawnRay; bounces--; continue; }`
        # touches neither bounces nor specularBounce). r4 fix: forcing
        # specular=True here made every emitter seen THROUGH a null
        # boundary count at weight 1 on top of the previous vertex's
        # MIS-weighted NEE (+16% on the volpath oracle's fog sphere)
        specular = jnp.where(
            alive, jnp.where(is_null & ~in_medium, specular,
                             is_spec & ~in_medium), specular)
        active = alive
        return (L, beta, active, specular, o_cur, d_cur, cur_med)

    state = (L, beta, active, specular, o_cur, d_cur, cur_med)
    state = jax.lax.fori_loop(0, cfg.max_depth + 1, body, state)
    return state[0]
