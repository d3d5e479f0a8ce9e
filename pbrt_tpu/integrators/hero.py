"""Hero-wavelength spectral sampling (HWSS) integrators.

JAX counterpart of the fork's spectral pipeline:
- ``hero`` base: 4-wavelength packets sampled from the light-power spectral
  distribution with West et al.'s rotation trick
  (integrators/hero.{h,cpp}:46-48,59-65,125-134; nWvls=4 hero.h:57).
- ``hero_path`` (integrators/hero_path.cpp): BSDF-sampling-only spectral
  path tracing; on the first dispersive transmission the throughput
  collapses to the four packet bins, per-wavelength pdf products
  ``pathWvlPdf`` accumulate, and emission is weighted by
  1/(wvlPdf · Σᵢ pathWvlPdfᵢ).
- ``hero_path_mis`` (integrators/hero_path_mis.cpp): adds NEE with the HWSS
  MIS weights of Wilkie et al. 2014 (:183-218, :256-270).

Scenes must be built with the 60-bin SAMPLED spectrum config; the radiance
image is (H,W,60) and converts to RGB via core/spectrum.spectrum_to_rgb.
Wavelength-dependent BSDFs: dispersive glass via Cauchy eta(λ)
(materials/dispersive_glass.cpp:62-64; reflection.h:345-380) — the
reference allocates 4 BSDFs per hit (memory.h AllocUndeclared); here the
per-λ evaluation is an eta-override re-evaluation, free of allocation.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from pbrt_tpu.core import spectrum as spec_mod
from pbrt_tpu.core import vecmath
from pbrt_tpu.core.vecmath import absdot, dot
from pbrt_tpu.integrators import common
from pbrt_tpu.scene import intersect as isect_mod
from pbrt_tpu.scene import lights as lights_mod
from pbrt_tpu.scene import materials as mat_mod

Array = Any

N_WVLS = 4          # hero.h:57
DIM_WVL = 5         # sample dimension carrying the wavelength uniform


def sample_hero_wavelengths(scene, pid, sidx, sfn, seed):
    """hero.cpp:125-134: rotate one uniform into 4, invert the light-power
    spectral CDF. Returns (wvls (R,4), wvl_idx (R,4), pmf (R,4))."""
    power = jnp.sum(scene.lights.power, axis=0)  # (60,)
    distr = spec_mod.make_spectral_distribution(power)
    u0 = sfn(pid, sidx, DIM_WVL, seed)
    wvls = []
    pmfs = []
    for i in range(N_WVLS):
        u = spec_mod.rotate_sample(u0, i, N_WVLS)
        lam, pmf = spec_mod.sample_wavelength(distr, u)
        wvls.append(lam)
        pmfs.append(pmf)
    wvls = jnp.stack(wvls, axis=-1)
    pmfs = jnp.stack(pmfs, axis=-1)
    idx = spec_mod.index_from_wavelength(wvls)
    return wvls, idx, pmfs


def _wvl_pdf_spectrum(idx, pmfs, C):
    """wvlPdf Spectrum: ones except the packet bins hold their pmf
    (hero_path.cpp:75-79)."""
    R = idx.shape[0]
    out = jnp.ones((R, C))
    chan = jnp.arange(C)
    for i in range(N_WVLS):
        out = jnp.where(chan[None, :] == idx[:, i:i + 1], pmfs[:, i:i + 1],
                        out)
    return out


def _scatter_bins(idx, vals, C):
    """(R,4) values → (R,C) spectrum with vals at packet bins (+=)."""
    chan = jnp.arange(C)
    out = jnp.zeros((idx.shape[0], C))
    for i in range(N_WVLS):
        out = out + jnp.where(chan[None, :] == idx[:, i:i + 1],
                              vals[:, i:i + 1], 0.0)
    return out


def _pdf_emitter_hero(scene, hit, light_id, d_cur, t_hit):
    """PdfEmitterHero (hero_path_mis.cpp:46-78): area-measure→solid-angle
    emitter density × uniform light-selection pmf."""
    ap = lights_mod.gather_area_prim(scene, jnp.where(
        light_id >= 0,
        lights_mod.gather_lights(scene.lights,
                                 jnp.maximum(light_id, 0)).prim_id, -1))
    from pbrt_tpu.scene import shapes
    area_tri = shapes.triangle_area(ap.v0, ap.v1, ap.v2)
    area_pln = shapes.aaplane_area(ap.lo, ap.hi, ap.ax)
    area_sph = 4.0 * jnp.pi * ap.radius * ap.radius
    area = jnp.where(ap.is_pln, area_pln,
                     jnp.where(ap.is_sph, area_sph, area_tri))
    em_pdf = (t_hit * t_hit) / jnp.maximum(
        absdot(hit.ng, -d_cur) * area, 1e-9)
    n_lights = scene.lights.n
    return jnp.where(light_id >= 0, em_pdf / n_lights, 0.0)


def _li_hero(scene, o, d, pid, sidx, sfn, cfg, power_distr, use_nee):
    """Shared HWSS wavefront loop (hero_path.cpp / hero_path_mis.cpp)."""
    R = o.shape[0]
    C = scene.n_channels
    assert C == spec_mod.N_SPECTRAL_SAMPLES, \
        "hero integrators need a SAMPLED-spectrum scene"

    wvls, wvl_idx, wvl_pmfs = sample_hero_wavelengths(scene, pid, sidx, sfn,
                                                      cfg.seed)
    wvl_pdf = _wvl_pdf_spectrum(wvl_idx, wvl_pmfs, C)
    hero_bin = wvl_idx[:, 0]

    zero_r = o[..., 0] * 0.0
    L = jnp.zeros((R, C)) + zero_r[..., None]
    beta = jnp.ones((R, C)) + zero_r[..., None]
    active = zero_r == 0.0
    is_wvl_dep = zero_r != 0.0          # False, varying
    last_spec = zero_r != 0.0
    path_wvl_pdf = jnp.ones((R, N_WVLS)) + zero_r[..., None]
    prev_path_wvl_pdf = jnp.ones((R, N_WVLS)) + zero_r[..., None]
    bsdf_pdf_prev = jnp.zeros(R) + zero_r
    eta_scale = jnp.ones(R) + zero_r
    o_cur, d_cur = o, d

    from pbrt_tpu.integrators.render import _bounce_dims, _sample2

    def body(b, state):
        (L, beta, active, is_wvl_dep, last_spec, path_wvl_pdf,
         prev_path_wvl_pdf, bsdf_pdf_prev, eta_scale, o_cur, d_cur) = state
        dims = _bounce_dims(b)
        hit = isect_mod.intersect(scene, o_cur, d_cur,
                                  jnp.full(R, vecmath.INF))

        light_id = scene.light_at(hit.prim_id)
        light_id = jnp.where(hit.valid, light_id, -1)
        gl = lights_mod.gather_lights(scene.lights,
                                      jnp.maximum(light_id, 0))
        le = lights_mod.area_light_L(gl.emit, gl.two_sided, hit.ng, -d_cur)
        le = jnp.where((light_id >= 0)[..., None], le, 0.0)
        env = lights_mod.escaped_radiance(scene, d_cur)
        emit = jnp.where(hit.valid[..., None], le, env)

        if use_nee:
            # MIS weight against emitter sampling (hero_path_mis): area
            # emitters via PdfEmitterHero; escaped rays via the infinite
            # light's Pdf_Li (hero_path_mis.cpp:160-171)
            em_pdf = _pdf_emitter_hero(scene, hit, light_id, d_cur, hit.t)
            em_pdf = jnp.where(hit.valid, em_pdf,
                               lights_mod.infinite_pdf_li(scene, d_cur))
            em_pdf = jnp.where(last_spec | (b == 0), 0.0, em_pdf)
            denom_h = wvl_pdf * jnp.sum(
                path_wvl_pdf + prev_path_wvl_pdf * em_pdf[..., None],
                axis=-1)[..., None]
            w_hwss = 1.0 / jnp.maximum(denom_h, 1e-20)
            w_scalar = jnp.where(
                ((b == 0) | last_spec)[..., None], 1.0,
                (bsdf_pdf_prev / jnp.maximum(bsdf_pdf_prev + em_pdf,
                                             1e-20))[..., None])
            w = jnp.where(is_wvl_dep[..., None], w_hwss, w_scalar)
        else:
            # hero_path: no MIS — full weight, but the HWSS collapse still
            # divides by wvlPdf·Σ pathWvlPdf (hero_path.cpp:94-110)
            w_hwss = 1.0 / jnp.maximum(
                wvl_pdf * jnp.sum(path_wvl_pdf, axis=-1)[..., None], 1e-20)
            w = jnp.where(is_wvl_dep[..., None], w_hwss, 1.0)
        L = L + jnp.where(active[..., None], beta * emit * w, 0.0)

        active = active & hit.valid
        mp = mat_mod.gather_materials(
            scene.materials,
            scene.mat_at(hit.prim_id))
        t1, t2 = common.make_frame(hit.ns)
        wo = common.to_local(t1, t2, hit.ns, -d_cur)

        # ---- NEE: SampleEmitterHero (hero_path_mis.cpp:80-116,199-238)
        if use_nee:
            u_sel = sfn(pid, sidx, dims["select"], cfg.seed)
            u_l = _sample2(sfn, pid, sidx, dims["light_u"], cfg.seed)
            light_idx, sel_pmf = common.choose_light(
                scene, u_sel, power_distr, p=hit.p)
            ls = lights_mod.sample_li(scene, light_idx, hit.p, u_l)
            vis = isect_mod.unoccluded(
                scene, hit.p, hit.ns,
                ls["p_light"]) & (ls["pdf"] > 0) & active
            em_pdf_nee = ls["pdf"] * sel_pmf
            li = ls["li"] / jnp.maximum(em_pdf_nee, 1e-20)[..., None]
            wi_loc = common.to_local(t1, t2, hit.ns, ls["wi"])
            f_nee = mat_mod.bsdf_f(mp, wo, wi_loc)
            pdf_nee_b = mat_mod.bsdf_pdf(mp, wo, wi_loc)
            # HWSS vs scalar MIS weight (:205-227)
            is_disp = mp.mtype == mat_mod.DISPERSIVE_GLASS
            # per-λ f/pdf: non-dispersive current bsdf is λ-independent;
            # dispersive current bsdf is specular → f=0, pdf=0 per λ
            f_h = _scatter_bins(
                wvl_idx,
                jnp.stack([jnp.take_along_axis(
                    f_nee, jnp.clip(wvl_idx[:, i:i + 1], 0, C - 1),
                    axis=-1)[:, 0] for i in range(N_WVLS)], -1)
                * jnp.where(is_disp[..., None], 0.0, 1.0), C)
            pdf_h = jnp.where(is_disp[..., None], 0.0,
                              pdf_nee_b[..., None]) \
                * jnp.ones((R, N_WVLS))
            denom = wvl_pdf * jnp.sum(
                path_wvl_pdf * em_pdf_nee[..., None]
                + path_wvl_pdf * pdf_h, axis=-1)[..., None]
            w_nee_h = em_pdf_nee[..., None] / jnp.maximum(denom, 1e-20)
            w_nee_s = (em_pdf_nee / jnp.maximum(
                em_pdf_nee + pdf_nee_b, 1e-20))[..., None]
            use_h = (is_wvl_dep | is_disp)[..., None]
            f_sel = jnp.where(use_h, f_h, f_nee)
            w_nee = jnp.where(use_h, w_nee_h, w_nee_s)
            cosw = absdot(ls["wi"], hit.ns)[..., None]
            contrib = beta * li * f_sel * cosw * w_nee
            # no NEE on the final iteration (hero_path_mis.cpp:228
            # breaks before the emitter sample — r5 depth fix)
            L = L + jnp.where((vis & (b < cfg.max_depth))[..., None],
                              contrib, 0.0)

        # ---- continuation (Sample_f at the hero wavelength)
        u_cl = sfn(pid, sidx, dims["cont_lobe"], cfg.seed)
        u_cu = _sample2(sfn, pid, sidx, dims["cont_u"], cfg.seed)
        is_disp = mp.mtype == mat_mod.DISPERSIVE_GLASS
        eta_hero = jnp.where(
            is_disp, mat_mod.cauchy_eta(mp.cauchy_b, mp.cauchy_c,
                                        wvls[:, 0]), mp.eta)
        wi_loc, f, pdf, flags = mat_mod.bsdf_sample(
            mp, wo, u_cl, u_cu, eta_override=eta_hero)
        wi = common.to_world(t1, t2, hit.ns, wi_loc)
        is_spec = (flags & mat_mod.FLAG_SPECULAR) > 0
        is_trans = (flags & mat_mod.FLAG_TRANSMISSION) > 0
        cur_wvl_dep = is_disp & is_trans   # hero_path.cpp:144
        now_dep = is_wvl_dep | cur_wvl_dep

        cosw = absdot(wi, hit.ns)
        # scalar path: beta *= f cos / pdf
        beta_scalar = beta * f * (cosw / jnp.maximum(pdf, 1e-20))[..., None]
        # HWSS path: collapse to hero bin, no pdf divide (:147-160)
        f_collapsed = spec_mod.zero_all_bins_but(f, hero_bin)
        # rotated wavelengths: non-dispersive same-bsdf eval; dispersive
        # specular contributes 0
        f_other = mat_mod.bsdf_f(mp, wo, wi_loc)
        pdf_other = mat_mod.bsdf_pdf(mp, wo, wi_loc)
        add_other = jnp.zeros((R, C))
        chan = jnp.arange(C)
        for i in range(1, N_WVLS):
            fi = jnp.take_along_axis(
                f_other, jnp.clip(wvl_idx[:, i:i + 1], 0, C - 1),
                axis=-1)[:, 0]
            fi = jnp.where(cur_wvl_dep, 0.0, fi)
            add_other = add_other + jnp.where(
                chan[None, :] == wvl_idx[:, i:i + 1], fi[..., None], 0.0)
        f_hwss = f_collapsed + add_other
        beta_hwss = beta * f_hwss * cosw[..., None]
        new_pwp = jnp.concatenate(
            [path_wvl_pdf[:, :1] * pdf[..., None],
             path_wvl_pdf[:, 1:] * jnp.where(cur_wvl_dep[..., None], 0.0,
                                             pdf_other[..., None])],
            axis=-1)

        beta_new = jnp.where(now_dep[..., None], beta_hwss, beta_scalar)
        prev_pwp_new = jnp.where(now_dep[..., None], path_wvl_pdf,
                                 prev_path_wvl_pdf)
        pwp_new = jnp.where(now_dep[..., None], new_pwp, path_wvl_pdf)

        alive = active & (pdf > 0) & (jnp.max(beta_new, -1) > 0) \
            & (b < cfg.max_depth)
        eta_sc = jnp.where(is_spec & is_trans,
                           jnp.where(dot(-d_cur, hit.ng) > 0,
                                     eta_hero * eta_hero,
                                     1.0 / jnp.maximum(
                                         eta_hero * eta_hero, 1e-9)), 1.0)
        eta_scale = eta_scale * jnp.where(alive, eta_sc, 1.0)

        # russian roulette (:167-176)
        rr_max = jnp.max(beta_new, -1) * eta_scale
        q = jnp.maximum(0.05, 1.0 - rr_max)
        u_rr = sfn(pid, sidx, dims["rr"], cfg.seed)
        do_rr = (b > 3) & (rr_max < cfg.rr_threshold)
        killed = do_rr & (u_rr < q)
        beta_new = jnp.where((do_rr & ~killed)[..., None],
                             beta_new / jnp.maximum(1 - q, 1e-6)[..., None],
                             beta_new)
        alive = alive & ~killed

        o_next = vecmath.offset_ray_origin(hit.p, hit.ng, wi)
        beta = jnp.where(alive[..., None], beta_new, beta)
        o_cur = jnp.where(alive[..., None], o_next, o_cur)
        d_cur = jnp.where(alive[..., None], wi, d_cur)
        path_wvl_pdf = jnp.where(alive[..., None], pwp_new, path_wvl_pdf)
        prev_path_wvl_pdf = jnp.where(alive[..., None], prev_pwp_new,
                                      prev_path_wvl_pdf)
        is_wvl_dep = jnp.where(alive, now_dep, is_wvl_dep)
        last_spec = jnp.where(alive, is_spec, last_spec)
        bsdf_pdf_prev = jnp.where(alive, pdf, bsdf_pdf_prev)
        active = alive
        return (L, beta, active, is_wvl_dep, last_spec, path_wvl_pdf,
                prev_path_wvl_pdf, bsdf_pdf_prev, eta_scale, o_cur, d_cur)

    state = (L, beta, active, is_wvl_dep, last_spec, path_wvl_pdf,
             prev_path_wvl_pdf, bsdf_pdf_prev, eta_scale, o_cur, d_cur)
    state = jax.lax.fori_loop(0, cfg.max_depth + 1, body, state)
    return state[0]


def li_hero_path(scene, o, d, pid, sidx, sfn, cfg, power_distr, time=None,
                 cam=None):
    return _li_hero(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    use_nee=False)


def li_hero_path_mis(scene, o, d, pid, sidx, sfn, cfg, power_distr, time=None,
                     cam=None):
    return _li_hero(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    use_nee=True)
