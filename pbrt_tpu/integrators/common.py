"""Shared integrator machinery: light selection, NEE with MIS, portal
dispatch, shading frames.

JAX counterpart of ``core/integrator.cpp``'s helpers —
UniformSampleOneLight (:100-122), EstimateDirect (:124-258 incl. the portal
dynamic-dispatch at :130-133) — and ``core/lightdistrib.{h,cpp}``'s
Uniform/Power distributions.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from pbrt_tpu.core import vecmath
from pbrt_tpu.core.sampling import (power_heuristic,
                                    sample_distribution_1d_discrete)
from pbrt_tpu.core.vecmath import absdot, dot, normalize
from pbrt_tpu.scene import intersect as isect_mod
from pbrt_tpu.scene import lights as lights_mod
from pbrt_tpu.scene import materials as mat_mod
from pbrt_tpu.scene import portals as portals_mod
from pbrt_tpu.scene.lights import AREA, STRAT_LIGHT, STRAT_PORTAL, \
    STRAT_PROJECTION

Array = Any


# ---------------------------------------------------------------------------
# shading frames
# ---------------------------------------------------------------------------

def make_frame(ns: Array):
    """Orthonormal (t1, t2, ns) basis per shading point."""
    t1, t2 = vecmath.coordinate_system(ns)
    return t1, t2


def shading_frame(hit, mp=None):
    """Shading basis; for HAIR rows t1 is aligned with the fiber tangent
    ∂p/∂u (BSDF's ss = dpdu, core/reflection.h:170; hair.cpp's frame has x
    along the fiber)."""
    t1, t2 = make_frame(hit.ns)
    if mp is not None and getattr(mp, "has_hair", False) \
            and getattr(hit, "dpdu", None) is not None:
        fiber = hit.dpdu - dot(hit.dpdu, hit.ns)[..., None] * hit.ns
        ok = vecmath.length_squared(fiber) > 1e-12
        fiber = normalize(jnp.where(ok[..., None], fiber, t1))
        is_hair = mp.mtype == mat_mod.HAIR
        t1 = jnp.where(is_hair[..., None], fiber, t1)
        t2 = jnp.where(is_hair[..., None],
                       vecmath.cross(hit.ns, fiber), t2)
    return t1, t2


def hair_offset(mp, hit):
    """Hair azimuthal offset h ∈ [−1,1] from the ribbon's v coordinate
    (curve.cpp: h = −1 + 2·v; our tessellated ribbons put v across the
    width). None when the material table has no hair rows."""
    if not getattr(mp, "has_hair", False):
        return None
    return jnp.clip(2.0 * hit.uv[..., 1] - 1.0, -1.0, 1.0)


def to_local(t1, t2, n, w):
    return jnp.stack([dot(w, t1), dot(w, t2), dot(w, n)], axis=-1)


def to_world(t1, t2, n, w):
    return w[..., 0:1] * t1 + w[..., 1:2] * t2 + w[..., 2:3] * n


# ---------------------------------------------------------------------------
# light selection (lightdistrib.h Uniform/Power)
# ---------------------------------------------------------------------------

def choose_light(scene, u: Array, power_distr=None, p: Array = None):
    """Pick a light per ray. Returns (idx (R,), select_pmf (R,)).

    ``power_distr`` is either a Distribution1D (power strategy), a
    SpatialLightDistribution (spatial strategy, needs shading point p), or
    None (uniform) — the three lightdistrib.h variants."""
    n = scene.lights.n
    if power_distr is not None:
        from pbrt_tpu.scene.lightdistrib import (SpatialLightDistribution,
                                                 sample_spatial)
        if isinstance(power_distr, SpatialLightDistribution):
            if p is None:
                p = jnp.zeros(u.shape + (3,))
            return sample_spatial(power_distr, scene, p, u)
        idx, pmf = sample_distribution_1d_discrete(power_distr, u)
        return idx, pmf
    idx = jnp.minimum((u * n).astype(jnp.int32), n - 1)
    return idx, jnp.full(u.shape, 1.0 / n)


# ---------------------------------------------------------------------------
# traced emission: radiance arriving from the first hit along wi
# ---------------------------------------------------------------------------

def trace_radiance(scene, p: Array, ns: Array, wi: Array, time=None):
    """Closest-hit trace from (offset) p along wi; returns
    (hit, Le (R,C)) where Le is the emission of whatever was hit, toward p
    (lightIsect.Le(-wi) in portal_arealight.cpp:140-148)."""
    o = vecmath.offset_ray_origin(p, ns, wi)
    hit = isect_mod.intersect(scene, o, wi,
                              jnp.full(p.shape[0], vecmath.INF), time=time)
    light_id = scene.light_at(hit.prim_id)
    light_id = jnp.where(hit.valid, light_id, -1)
    g = lights_mod.gather_lights(scene.lights, jnp.maximum(light_id, 0))
    le = lights_mod.area_light_L(g.emit, g.two_sided, hit.ng, -wi)
    le = jnp.where((light_id >= 0)[..., None], le, 0.0)
    return hit, le, light_id


# ---------------------------------------------------------------------------
# EstimateDirect (core/integrator.cpp:124-258 + portal dispatch :130-133)
# ---------------------------------------------------------------------------

def estimate_direct(scene, hit, mp, wo_world: Array,
                    u_select: Array, u_light: Array, u_scatter: Array,
                    u_bsdf_lobe: Array, power_distr=None,
                    with_bsdf_half: bool = True, time=None):
    """One-light NEE estimate at shading points ``hit`` with materials
    ``mp`` (gathered rows). Returns Ld (R,C).

    Standard lights: two-sample MIS (light strategy + BSDF strategy) exactly
    as EstimateDirect; portal area lights (fork): strategy-dispatched single
    sample estimators per portal_arealight.cpp:29-239 (no MIS), including
    the behind-all-portals fallback to plain light sampling.
    """
    R = hit.p.shape[0]
    C = scene.n_channels
    lt = scene.lights

    light_idx, sel_pmf = choose_light(scene, u_select, power_distr,
                                      p=hit.p)
    g = lights_mod.gather_lights(lt, light_idx)
    is_portal_light = (g.ltype == AREA) & (g.n_portals > 0)

    t1, t2 = shading_frame(hit, mp)
    wo = to_local(t1, t2, hit.ns, wo_world)

    from pbrt_tpu.scene import textures as tex_mod
    kd_eff = tex_mod.resolve_kd(scene, mp, hit, wo=wo_world)
    h_hair = hair_offset(mp, hit)

    # ---- light-strategy sample (Sample_Li)
    ls = lights_mod.sample_li(scene, light_idx, hit.p, u_light)

    # ---- portal strategy directions (only traced when the scene has
    # portal lights — lt.has_portals is static; the reference's dynamic_cast
    # dispatch at integrator.cpp:130-133 likewise never runs without one)
    if lt.has_portals:
        in_front = portals_mod.portals_in_front(hit.p, g)
        pidx, psel_pdf, behind_all = portals_mod.select_visible_portal(
            in_front, u_select)
        ap = lights_mod.gather_area_prim(scene, g.prim_id)
        wi_port, pdf_port, _ = portals_mod.sample_portal(g, pidx, hit.p,
                                                         u_light)
        # projection needs the light rect (aaplane-backed portal lights)
        wi_proj, pdf_proj, _ = portals_mod.sample_projection(
            g, pidx, ap.lo, ap.hi, ap.ax, hit.p, u_light)

        use_portal_dir = (is_portal_light & ~behind_all
                          & (g.strategy != STRAT_LIGHT))
        use_proj = use_portal_dir & (g.strategy == STRAT_PROJECTION)
        wi_nee = jnp.where(use_portal_dir[..., None],
                           jnp.where(use_proj[..., None], wi_proj, wi_port),
                           ls["wi"])
        pdf_nee = jnp.where(use_portal_dir,
                            jnp.where(use_proj, pdf_proj, pdf_port),
                            ls["pdf"])
    else:
        is_portal_light = jnp.zeros(R, bool)
        use_proj = jnp.zeros(R, bool)
        psel_pdf = jnp.ones(R)
        wi_nee = ls["wi"]
        pdf_nee = ls["pdf"]

    # ---- one closest-hit trace serves visibility AND portal emission
    hit2, le2, hit2_light = trace_radiance(scene, hit.p, hit.ns, wi_nee,
                                           time=time)

    # received radiance per branch
    dist = vecmath.length(ls["p_light"] - hit.p)
    blocked_delta = hit2.valid & (hit2.t < dist * (1.0 - 1e-3))
    li_delta = jnp.where(blocked_delta[..., None], 0.0, ls["li"])
    li_area = jnp.where((hit2_light == light_idx)[..., None], ls["li"], 0.0)
    li_inf = jnp.where(hit2.valid[..., None], 0.0, ls["li"])
    is_inf = g.ltype == lights_mod.INFINITE
    li_std = jnp.where(ls["is_delta"][..., None], li_delta,
                       jnp.where(is_inf[..., None], li_inf, li_area))
    # portal estimators: whatever emitter the ray hits
    li = jnp.where(is_portal_light[..., None], le2, li_std)

    # ---- BSDF at the sampled direction
    wi_loc = to_local(t1, t2, hit.ns, wi_nee)
    f = mat_mod.bsdf_f(mp, wo, wi_loc, kd_override=kd_eff, h=h_hair,
                       fourier=scene.fourier) \
        * absdot(wi_nee, hit.ns)[..., None]
    scatter_pdf = mat_mod.bsdf_pdf(mp, wo, wi_loc, h=h_hair,
                                   fourier=scene.fourier)

    # ---- combine
    ok = (pdf_nee > 0.0) & hit.valid
    # standard: delta lights weight 1; area/inf lights power-heuristic MIS
    w_mis = jnp.where(ls["is_delta"], 1.0,
                      power_heuristic(1.0, pdf_nee, 1.0, scatter_pdf))
    ld_std = f * li * (w_mis / jnp.maximum(pdf_nee, 1e-20))[..., None]

    # portal single-sample estimators
    #   strategy 'portal': f*Li/pdf (NOT divided by selection pmf —
    #   portal_arealight.cpp:103-109 returns EstimateDirectPortal directly)
    #   strategy 'projection': (f*Li/pdf) / portalPdf (:108)
    #   strategy 'light' or behind-all: f*Li/lightPdf (:115-160)
    ld_portal = f * li / jnp.maximum(pdf_nee, 1e-20)[..., None]
    ld_portal = jnp.where(use_proj[..., None],
                          ld_portal / jnp.maximum(psel_pdf, 1e-20)[..., None],
                          ld_portal)

    ld = jnp.where(is_portal_light[..., None], ld_portal, ld_std)
    ld = jnp.where(ok[..., None], ld, 0.0)

    # ---- BSDF-strategy half of two-sample MIS (non-portal, non-delta)
    if with_bsdf_half:
        wi_b_loc, f_b, pdf_b, flags = mat_mod.bsdf_sample(
            mp, wo, u_bsdf_lobe, u_scatter, kd_override=kd_eff,
            h=h_hair, fourier=scene.fourier)
        wi_b = to_world(t1, t2, hit.ns, wi_b_loc)
        is_spec = (flags & mat_mod.FLAG_SPECULAR) > 0
        f_b = f_b * absdot(wi_b, hit.ns)[..., None]
        hit3, le3, hit3_light = trace_radiance(scene, hit.p, hit.ns, wi_b,
                                               time=time)
        # radiance only counts when this very light is hit (or escapes to
        # the chosen infinite light)
        li_b = jnp.where((hit3_light == light_idx)[..., None], le3, 0.0)
        li_b = jnp.where((is_inf & ~hit3.valid)[..., None],
                         lights_mod.escaped_radiance(scene, wi_b), li_b)
        light_pdf_b = lights_mod.pdf_li(scene, light_idx, hit.p, wi_b)
        w_b = power_heuristic(1.0, pdf_b, 1.0, light_pdf_b)
        ld_b = f_b * li_b * (w_b / jnp.maximum(pdf_b, 1e-20))[..., None]
        # EstimateDirect samples with BSDF_ALL & ~BSDF_SPECULAR
        # (integrator.cpp:128,186) — specular lobes are handled by the path
        # continuation, so exclude them here
        ld_b = jnp.where((hit.valid & ~ls["is_delta"] & ~is_portal_light
                          & (pdf_b > 0) & ~is_spec)[..., None], ld_b, 0.0)
        ld = ld + ld_b

    # divide by light-selection pmf (UniformSampleOneLight,
    # integrator.cpp:116-121)
    return ld / jnp.maximum(sel_pmf, 1e-20)[..., None]


# ---------------------------------------------------------------------------
# Subsurface scattering (core/bssrdf.{h,cpp} SeparableBSSRDF +
# materials/{subsurface,kdsubsurface}.cpp)
# ---------------------------------------------------------------------------

def subsurface_transport(scene, hit, mp, beta, wo_world, pid, sidx, sfn,
                         seed, dims, time=None, eligible=None):
    """Separable-BSSRDF traversal for SUBSURFACE material hits, with the
    TabulatedBSSRDF beam-diffusion radial profile (scene/bssrdf.py).

    Flow (SeparableBSSRDF::Sample_S, bssrdf.cpp:234-330): with
    probability Fr reflect specularly at the interface (the material row
    becomes MIRROR for this bounce); otherwise pick a channel uniformly,
    sample an exit radius from that channel's tabulated profile
    (Sample_Sr → SampleCatmullRom2D), probe the surface through a disk
    point at that radius, weight by Sr(actual distance)/Pdf_Sp and
    (1−Fr), and relocate the shading point to the exit — NEE + the
    diffuse continuation then happen at the exit vertex (the Sw term's
    role). Design deltas vs pbrt, both documented in PARITY.md: the
    probe uses the normal axis only (pbrt mixes ss/ts/ns with ¼/¼/½
    probability, Sample_Sp:341-353 — the pdf here matches OUR single-
    axis sampler exactly, so the estimator stays unbiased), and only the
    first admissible probe hit is used (nFound = 1).

    Returns (hit', mp', beta', entered_mask).
    """
    import dataclasses as dc

    from pbrt_tpu.ops import fastgather
    from pbrt_tpu.scene import bssrdf as bssrdf_mod
    from pbrt_tpu.scene import materials as mat_mod

    C = scene.n_channels
    R = hit.p.shape[0]
    # `eligible` lets callers exclude lanes that are not at a real
    # surface vertex this bounce (volpath: lanes whose distance sample
    # scattered in the medium before the surface)
    valid = hit.valid if eligible is None else hit.valid & eligible
    is_tab = (mp.mtype == mat_mod.SUBSURFACE) & valid
    has_dis = scene.materials.has_disney_sss
    if has_dis:
        # DisneyBSSRDF rows (disney.cpp:519-527): scatterdistance swaps
        # the diffuse lobe for a SpecularTransmission entry + BSSRDF
        is_dis = (mp.mtype == mat_mod.DISNEY) \
            & mat_mod._disney_sss_mask(mp) & valid
    else:
        is_dis = jnp.zeros_like(is_tab)
    is_sss = is_tab | is_dis
    sseed = seed ^ 0x5550
    u_f = sfn(pid, sidx, dims["select"], sseed)
    u_ch = sfn(pid, sidx, dims["mis_lobe"], sseed)
    u_r = sfn(pid, sidx, dims["light_u"][0], sseed)
    u_phi = sfn(pid, sidx, dims["light_u"][1], sseed)

    # interface fresnel — use the outward-oriented normal so mesh winding
    # cannot flip us into the TIR branch
    ns_o = vecmath.face_forward(hit.ns, wo_world)
    cos_o = dot(wo_world, ns_o)
    f_in = mat_mod.fr_dielectric(cos_o, jnp.ones(R), mp.eta)
    spec_refl = is_tab & (u_f < f_in)
    enter = is_tab & ~spec_refl
    if has_dis:
        # Disney entry = the delta SpecularTransmission lobe of the
        # census, picked with probability 1/n; the surviving weight is
        # n·(1−Fr) (BSDF::Sample_f divides a sampled specular lobe's
        # pdf by matchingComps, reflection.h:575-580 semantics). There
        # is no mirror branch — Fr only attenuates the entry
        _, _, _, _, n_dis, _ = mat_mod._disney_lobe_counts(mp)
        p_entry = 1.0 / jnp.maximum(n_dis, 1.0)
        enter_dis = is_dis & (u_f < p_entry)
        enter = enter | enter_dis
        beta = jnp.where(enter_dis[:, None],
                         beta * (n_dis * (1.0 - f_in))[:, None], beta)
    else:
        enter_dis = jnp.zeros_like(is_tab)

    # projection-axis pick (Sample_Sp:336-353: ns ½, ss ¼, ts ¼) and
    # channel pick (uniform, :355-357), both folded into u_ch like
    # pbrt's u1 reuse
    tabs = scene.sss
    mat_id = scene.mat_at(hit.prim_id)
    t1, t2 = make_frame(ns_o)
    ax = jnp.where(u_ch < 0.5, 0,
                   jnp.where(u_ch < 0.75, 1, 2)).astype(jnp.int32)
    u_ch2 = jnp.where(u_ch < 0.5, u_ch * 2.0,
                      jnp.where(u_ch < 0.75, (u_ch - 0.5) * 4.0,
                                (u_ch - 0.75) * 4.0))
    # (vx, vy, vz): ns-axis → (t1, t2, ns); ss-axis → (t2, ns, t1);
    # ts-axis → (ns, t1, t2)
    def pick3(a, b, c):
        axn = ax[:, None]
        return jnp.where(axn == 0, a, jnp.where(axn == 1, b, c))
    vx = pick3(t1, t2, ns_o)
    vy = pick3(t2, ns_o, t1)
    vz = pick3(ns_o, t1, t2)
    ch = jnp.minimum((u_ch2 * C).astype(jnp.int32), C - 1)
    row_id = jnp.clip(mat_id, 0, None) * C + ch
    r, r_valid = bssrdf_mod.sample_sr(tabs, row_id,
                                      jnp.clip(u_r, 1e-6, 1.0 - 1e-6))
    g_row = fastgather.make_row_gather(tabs.r_max.shape[0], row_id)
    rmax_c = g_row(tabs.r_max)
    in_prof = r_valid & (r > 0) & (r < rmax_c)
    r = jnp.clip(r, 1e-5, jnp.maximum(rmax_c, 2e-5))

    # probe segment of length l = 2·sqrt(rMax² − r²) centered on the
    # disk point along −vz (Sample_Sp:359-366)
    phi = 2.0 * jnp.pi * u_phi
    disk = (jnp.cos(phi)[:, None] * vx + jnp.sin(phi)[:, None] * vy) \
        * r[:, None]
    h_probe = jnp.maximum(jnp.sqrt(jnp.maximum(
        rmax_c * rmax_c - r * r, 0.0)), 1e-3)
    o_probe = hit.p + disk + vz * h_probe[:, None]

    # intersection chain (Sample_Sp:294-329): walk the probe segment
    # collecting admissible (same-material-family) hits, then pick one
    # uniformly and scale the pdf by 1/nFound. pbrt's chain is unbounded;
    # 4 static steps cover every practical sheet count (surfaced via the
    # min() below rather than silently dropping energy)
    N_CHAIN = 8     # r5: 4 → 8 static probe steps (VERDICT r4 #7); pbrt's
                    # chain is unbounded, 8 covers double-walled shells
    u_pick = u_ch2 * C - ch.astype(jnp.float32)        # pbrt's u1 reuse
    o_cur = o_probe
    t_rem = 2.0 * h_probe
    chain = []
    for _ in range(N_CHAIN):
        pr = isect_mod.intersect(scene, o_cur, -vz, t_rem, time=time)
        pr_mp = mat_mod.gather_materials(scene.materials,
                                         scene.mat_at(pr.prim_id))
        adm_kind = pr_mp.mtype == mat_mod.SUBSURFACE
        if has_dis:
            # pbrt admits probe hits on the SAME material
            # (Sample_Sp:311: primitive->GetMaterial() == material). For
            # Disney rows match the material row exactly (R and d are
            # row parameters); SUBSURFACE keeps the family-level
            # approximation documented in PARITY.md
            adm_kind = jnp.where(is_dis,
                                 scene.mat_at(pr.prim_id) == mat_id,
                                 adm_kind)
        adm = pr.valid & adm_kind
        chain.append((adm, pr))
        eps = 1e-4 * jnp.maximum(h_probe, 1.0)
        o_cur = pr.p - vz * eps[:, None]
        t_rem = jnp.maximum(t_rem - pr.t - eps, 0.0)
    n_found = sum(a.astype(jnp.int32) for a, _ in chain)
    sel = jnp.minimum((u_pick * n_found).astype(jnp.int32),
                      jnp.maximum(n_found - 1, 0))
    # gather the sel-th admissible chain entry (where-chain over 4 slots)
    rank = jnp.zeros_like(sel)
    probe = chain[0][1]
    import dataclasses as _dc
    pick_p, pick_ns, pick_ng, pick_prim = (
        probe.p, probe.ns, probe.ng, probe.prim_id)
    for a, pr in chain:
        take = a & (rank == sel)
        pick_p = jnp.where(take[:, None], pr.p, pick_p)
        pick_ns = jnp.where(take[:, None], pr.ns, pick_ns)
        pick_ng = jnp.where(take[:, None], pr.ng, pick_ng)
        pick_prim = jnp.where(take, pr.prim_id, pick_prim)
        rank = rank + a.astype(jnp.int32)
    probe = _dc.replace(chain[0][1], p=pick_p, ns=pick_ns, ng=pick_ng,
                        prim_id=pick_prim, valid=n_found > 0)
    ok = enter & in_prof & (n_found > 0)

    # Sp / Pdf_Sp at the actual exit point (bssrdf.cpp:198-231, 331-353):
    # value_c = Sr_c(‖pi−po‖); pdf = Σ_axis axProb·|n_exit·axis| ·
    # mean_c Pdf_Sr_c(r_proj_axis), the full 3-axis MIS (Pdf_Sp). Delta
    # vs pbrt: only the FIRST admissible probe hit is used (nFound = 1;
    # pbrt walks the whole chain and picks uniformly) — documented in
    # PARITY.md; on non-overlapping sheets it is identical
    d_vec = hit.p - probe.p
    dl = jnp.stack([dot(d_vec, t1), dot(d_vec, t2), dot(d_vec, ns_o)],
                   axis=-1)                            # (R,3) local
    # exit normal = the surface's INTRINSIC outward normal (pbrt uses
    # pi.n / pi.shading.n as authored) — face-forwarding it toward the
    # entry normal flips far-sheet exits inward and lets them "see"
    # lights through the object (r4 bug: +33% on the sss-sphere oracle)
    exit_ns_raw = probe.ns
    nl = jnp.stack([dot(exit_ns_raw, t1), dot(exit_ns_raw, t2),
                    dot(exit_ns_raw, ns_o)], axis=-1)
    r_act = jnp.maximum(jnp.linalg.norm(d_vec, axis=-1), 1e-6)
    r_proj = jnp.stack([
        jnp.sqrt(dl[:, 1] ** 2 + dl[:, 2] ** 2),       # along ss
        jnp.sqrt(dl[:, 2] ** 2 + dl[:, 0] ** 2),       # along ts
        jnp.sqrt(dl[:, 0] ** 2 + dl[:, 1] ** 2),       # along ns
    ], axis=-1)
    r_proj = jnp.maximum(r_proj, 1e-6)
    ax_prob = jnp.asarray([0.25, 0.25, 0.5])
    sr_all = []
    pdf_axis_sum = 0.0
    base_row = jnp.clip(mat_id, 0, None) * C
    for c in range(C):
        (sr_c, p_ss, p_ts, p_ns), _, rhoeff_c = \
            bssrdf_mod.eval_profile_multi(
                tabs, base_row + c,
                [r_act, r_proj[:, 0], r_proj[:, 1], r_proj[:, 2]])
        sr_all.append(sr_c)
        inv_rho = 1.0 / jnp.maximum(rhoeff_c, 1e-6)
        pdf_axis_sum = pdf_axis_sum + inv_rho * (
            p_ss * jnp.abs(nl[:, 0]) * ax_prob[0]
            + p_ts * jnp.abs(nl[:, 1]) * ax_prob[1]
            + p_ns * jnp.abs(nl[:, 2]) * ax_prob[2])
    sr_all = jnp.stack(sr_all, axis=-1)               # (R,C)
    # pdf /= nFound (Sample_Sp:327: uniform pick among chain hits)
    pdf_mix = pdf_axis_sum / C / jnp.maximum(n_found, 1)
    # no extra (1−Fr) factor here: the enter/reflect branch is SELECTED
    # with probability (1−Fr), which IS the (1−Fr) of pbrt's entry
    # SpecularTransmission f/pdf — multiplying again would square it
    w_ss = sr_all / jnp.maximum(pdf_mix, 1e-12)[:, None]
    # clamp the channel-MIS ratio: a probe landing in another channel's
    # profile tail can produce unbounded ratios (pbrt fires the same
    # fireflies; the tabulated profile support keeps this rare)
    w_ss = jnp.minimum(w_ss, 1e3)
    if has_dis:
        # Disney rows tabulate the NORMALIZED Burley profile p(r; d)
        # (scene/bssrdf.py disney_profiles): the reflectance scale
        # R = diffuseWeight·color (disney.cpp:524-525, textured at the
        # entry point) multiplies here
        from pbrt_tpu.scene import textures as tex_mod
        kd_here = jnp.clip(tex_mod.resolve_kd(scene, mp, hit), 0.0, None)
        dw_dis = ((1.0 - mp.metallic) * (1.0 - mp.spec_trans))[:, None]
        w_ss = jnp.where(is_dis[:, None], w_ss * kd_here * dw_dis, w_ss)

    # probe found no admissible exit → the sample dies, exactly pbrt's
    # `if (S.IsBlack() || pdf == 0) break` (path.cpp bssrdf block). The
    # r3 diffuse-albedo fallback is gone: with the beam-diffusion
    # profile's long support it triggered on every large-radius sample
    # and injected near-white albedo (sss oracle md 0.14 → 0.42)
    dead = enter & ~ok

    new_hit = dc.replace(
        hit,
        p=jnp.where(ok[:, None], probe.p, hit.p),
        ns=jnp.where(enter[:, None],
                     jnp.where(ok[:, None], exit_ns_raw, ns_o), hit.ns),
        ng=jnp.where(ok[:, None], probe.ng, hit.ng))
    white = jnp.ones((R, C))
    # exit lobe = SSS_EXIT, the SeparableBSSRDFAdapter Sw term
    # (core/bssrdf.h:87-95): (1−Fr(cosθ_wi))/(c·π), cosine-sampled —
    # r4's Lambertian exit (documented delta 4) is gone
    new_mp = dc.replace(
        mp,
        mtype=jnp.where(spec_refl, mat_mod.MIRROR,
                        jnp.where(enter, mat_mod.SSS_EXIT, mp.mtype)),
        kd=jnp.where(enter[:, None], white, mp.kd),
        kr=jnp.where(spec_refl[:, None], white, mp.kr))
    new_beta = jnp.where(ok[:, None], beta * w_ss,
                         jnp.where(dead[:, None], 0.0, beta))
    # at the exit vertex pbrt re-points wo along the exit shading normal
    # (Sample_Sp:369 `it->wo = Vector3f(it->shading.n)`) — NEE and the
    # cosine continuation are taken about the OUTWARD exit frame, not
    # the (meaningless) entry camera direction
    wo_eff = jnp.where(ok[:, None], new_hit.ns, wo_world)
    return new_hit, new_mp, new_beta, enter, wo_eff
