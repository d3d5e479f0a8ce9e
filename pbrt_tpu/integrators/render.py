"""Render driver + the sampler-integrator family as wavefront programs.

JAX counterpart of SamplerIntegrator::Render's tile loop
(core/integrator.cpp:526-637) and the integrators `directlighting`
(integrators/directlighting.cpp), `path` (integrators/path.cpp), `mypath`
(fork, integrators/mypath.cpp), `whitted` (whitted.cpp) and
`ambientocclusion` (ao.cpp).

Structure: one jitted ``render_pass`` evaluates a batch of (pixel, sample)
camera rays fully — the per-bounce recursion of Li() becomes a
``lax.fori_loop`` with active masks — and accumulates into the film. The
host loops over spp chunks to bound memory; pbrt's 16×16 tile pool
(integrator.cpp:533-546) maps to the sample-batch axis, which
pbrt_tpu/parallel shards across devices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core import vecmath
from pbrt_tpu.core.vecmath import absdot, dot
from pbrt_tpu.integrators import common
from pbrt_tpu.scene import camera as cam_mod
from pbrt_tpu.scene import film as film_mod
from pbrt_tpu.scene import intersect as isect_mod
from pbrt_tpu.scene import lights as lights_mod
from pbrt_tpu.scene import materials as mat_mod
from pbrt_tpu.samplers import make_sampler

Array = Any

# per-bounce sample-dimension layout
# (0-5: pixel xy, lens xy, time, hero wavelength)
_DIM_BASE = 6
_DIM_STRIDE = 10


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    integrator: str = "path"       # path | direct | whitted | ao | mypath
    sampler: str = "independent"
    max_depth: int = 5
    rr_threshold: float = 1.0
    light_strategy: str = "uniform"   # uniform | power
    ao_radius: float = 1e6
    ao_cos_sample: bool = True
    seed: int = 0
    # static: also return per-bounce live-lane counts from the path loop
    # (bench dead-lane accounting; off in production renders)
    collect_stats: bool = False


def _bounce_dims(b):
    base = _DIM_BASE + b * _DIM_STRIDE
    return dict(select=base, light_u=(base + 1, base + 2), mis_lobe=base + 3,
                mis_u=(base + 4, base + 5), cont_lobe=base + 6,
                cont_u=(base + 7, base + 8), rr=base + 9)


def _sample2(sfn, pid, sidx, dims, seed):
    return jnp.stack([sfn(pid, sidx, dims[0], seed),
                      sfn(pid, sidx, dims[1], seed)], axis=-1)


# ---------------------------------------------------------------------------
# integrators (Li over a ray batch)
# ---------------------------------------------------------------------------

def li_direct(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
              time=None, cam=None):
    """`directlighting` with UniformSampleOne strategy
    (integrators/directlighting.cpp:49-101) + specular recursion up to
    max_depth via the wavefront loop."""
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=False, time=time)


def li_path(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
            time=None, cam=None):
    """`path` (integrators/path.cpp): NEE every bounce + BSDF continuation,
    emission collected on camera/specular vertices only, Russian roulette.

    On the GPU, scenes matching the fused profile (Scene.fused_profile —
    the cornell class: all-matte + one area or projection-strategy portal
    light) run the monolithic Pallas bounce kernel instead of the
    wavefront loop; the two paths produce matching pixels (identical
    sample streams — tests/test_fused_path.py)."""
    from pbrt_tpu.ops import fused_path
    if fused_path.eligible(scene, cfg, power_distr, time):
        return fused_path.li_path_fused(scene, o, d, pid, sidx, cfg)
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=True, time=time)


def li_mypath(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
              time=None, cam=None):
    """fork `mypath` (integrators/mypath.cpp:31-142): path tracing whose
    direct estimation is light-sampling only (no BSDF half) — portal
    dispatch intact."""
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=True, bsdf_half=False, time=time)


def li_whitted(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
               time=None, cam=None):
    """`whitted` (integrators/whitted.cpp): direct from all lights (delta
    semantics retained via the same NEE estimator) + specular recursion."""
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=False, time=time)


def li_ao(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
          time=None, cam=None):
    """`ambientocclusion` (integrators/ao.cpp:57-103)."""
    R = o.shape[0]
    C = scene.n_channels
    hit = isect_mod.intersect(scene, o, d, jnp.full(R, vecmath.INF),
                              time=time)
    dims = _bounce_dims(0)
    u = _sample2(sfn, pid, sidx, dims["light_u"], cfg.seed)
    from pbrt_tpu.core.sampling import (cosine_sample_hemisphere,
                                        uniform_sample_hemisphere, INV_PI)
    # frame on the geometry FACING THE RAY (ao.cpp:77 Faceforward(n,
    # -ray.d)) — without it, back-facing windings send the AO hemisphere
    # through the surface (r4: the floor rendered unoccluded)
    n_ao = vecmath.face_forward(hit.ns, -d)
    t1, t2 = common.make_frame(n_ao)
    # pbrt's estimator is Dot(wi,n)/pdf with NO albedo normalization
    # (ao.cpp:97-98): cosine sampling contributes π per unoccluded ray,
    # uniform contributes 2π·cosθ (r4 fix — we previously divided by π,
    # rendering 1/π of the reference's AO values)
    if cfg.ao_cos_sample:
        w_loc = cosine_sample_hemisphere(u)
        ratio = jnp.full(R, jnp.pi)
    else:
        w_loc = uniform_sample_hemisphere(u)
        ratio = 2.0 * jnp.pi * w_loc[..., 2]
    w = common.to_world(t1, t2, n_ao, w_loc)
    o2 = vecmath.offset_ray_origin(hit.p, n_ao, w)
    occ = isect_mod.intersect_p(scene, o2, w,
                                jnp.full(R, cfg.ao_radius), time=time)
    vis = jnp.where(hit.valid, (~occ).astype(jnp.float32) * ratio, 0.0)
    return jnp.broadcast_to(vis[..., None], (R, C))


def _li_loop(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
             nee=True, indirect=True, bsdf_half=True, time=None):
    """Shared wavefront loop (PathIntegrator::Li shape, path.cpp /
    mypath.cpp:31-142). Bounce count is a static unroll via fori_loop with
    per-bounce dims."""
    R = o.shape[0]
    C = scene.n_channels
    # derive initial carries from o so their vma type matches the loop
    # outputs under shard_map (constants are mesh-invariant; loop outputs
    # aren't — see shard_map scan-vma docs)
    zero_r = o[..., 0] * 0.0
    L = jnp.zeros((R, C)) + zero_r[..., None]
    beta = jnp.ones((R, C)) + zero_r[..., None]
    active = zero_r == 0.0
    specular = zero_r == 0.0  # bounce 0 counts emission
    eta_scale = jnp.ones(R) + zero_r
    o_cur, d_cur = o, d

    n_bounces = cfg.max_depth + 1 if indirect else min(cfg.max_depth + 1, 8)

    live_counts = jnp.zeros(n_bounces) if cfg.collect_stats else None

    def body(b, state):
        L, beta, active, specular, eta_scale, o_cur, d_cur, lv = state
        if cfg.collect_stats:
            lv = lv.at[b].set(jnp.sum(active.astype(jnp.float32)))
        # pbrt's termination order (path.cpp:23-24 `if (!foundIntersection
        # || bounces >= maxDepth) break;`): the FINAL iteration collects
        # emission only — no NEE, no continuation. r5 fix: we previously
        # ran a full NEE level on it, computing one bounce MORE transport
        # than the reference for the same "maxdepth" (caught by the
        # env-cavity oracle at 4.3% — open scenes hid it inside MC
        # tolerances).
        last = b >= (n_bounces - 1)
        dims = _bounce_dims(b)
        hit = isect_mod.intersect(scene, o_cur, d_cur,
                                  jnp.full(R, vecmath.INF), time=time)

        # emitted radiance at camera/specular vertices (path.cpp:291-310)
        light_id = scene.light_at(hit.prim_id)
        light_id = jnp.where(hit.valid, light_id, -1)
        gl = lights_mod.gather_lights(scene.lights,
                                      jnp.maximum(light_id, 0))
        le = lights_mod.area_light_L(gl.emit, gl.two_sided, hit.ng, -d_cur)
        le = jnp.where((light_id >= 0)[..., None], le, 0.0)
        env = lights_mod.escaped_radiance(scene, d_cur)
        emit = jnp.where(hit.valid[..., None], le, env)
        L = L + jnp.where((active & specular)[..., None], beta * emit, 0.0)

        active = active & hit.valid
        mp = mat_mod.gather_materials(
            scene.materials,
            scene.mat_at(hit.prim_id))

        # subsurface: relocate SUBSURFACE-material hits to their
        # profile-sampled exit points (or specular-reflect at the
        # interface); NEE + continuation then run at the exit vertex,
        # about the exit frame (wo := exit normal, Sample_Sp:369)
        wo_w = -d_cur
        if scene.has_sss and indirect:
            hit, mp, beta, _, wo_w = common.subsurface_transport(
                scene, hit, mp, beta, -d_cur, pid, sidx, sfn, cfg.seed,
                dims, time=time)

        # NEE
        if nee:
            u_sel = sfn(pid, sidx, dims["select"], cfg.seed)
            u_l = _sample2(sfn, pid, sidx, dims["light_u"], cfg.seed)
            u_ml = sfn(pid, sidx, dims["mis_lobe"], cfg.seed)
            u_mu = _sample2(sfn, pid, sidx, dims["mis_u"], cfg.seed)
            ld = common.estimate_direct(
                scene, hit, mp, wo_w, u_sel, u_l, u_mu, u_ml,
                power_distr=power_distr, with_bsdf_half=bsdf_half,
                time=time)
            L = L + jnp.where((active & ~last)[..., None], beta * ld, 0.0)

        # continuation (path.cpp:320-360)
        t1, t2 = common.shading_frame(hit, mp)
        wo = common.to_local(t1, t2, hit.ns, wo_w)
        u_cl = sfn(pid, sidx, dims["cont_lobe"], cfg.seed)
        u_cu = _sample2(sfn, pid, sidx, dims["cont_u"], cfg.seed)
        from pbrt_tpu.scene import textures as tex_mod
        kd_eff = tex_mod.resolve_kd(scene, mp, hit, wo=-d_cur)
        wi_loc, f, pdf, flags = mat_mod.bsdf_sample(
            mp, wo, u_cl, u_cu, kd_override=kd_eff,
            h=common.hair_offset(mp, hit), fourier=scene.fourier)
        wi = common.to_world(t1, t2, hit.ns, wi_loc)
        is_spec = (flags & mat_mod.FLAG_SPECULAR) > 0
        is_trans = (flags & mat_mod.FLAG_TRANSMISSION) > 0
        if not indirect:
            # whitted/direct continue through *specular* lobes only
            cont_ok = is_spec
        else:
            cont_ok = jnp.ones(R, bool)
        throughput = f * (absdot(wi, hit.ns)
                          / jnp.maximum(pdf, 1e-20))[..., None]
        beta_new = beta * throughput
        alive = (active & ~last & cont_ok & (pdf > 0)
                 & (jnp.max(beta_new, axis=-1) > 0))
        # eta scaling for russian roulette (path.cpp:344-352)
        eta = mp.eta
        entering = dot(-d_cur, hit.ng) > 0
        eta_sc = jnp.where(is_spec & is_trans,
                           jnp.where(entering, eta * eta,
                                     1.0 / jnp.maximum(eta * eta, 1e-9)),
                           1.0)
        eta_scale = eta_scale * jnp.where(alive, eta_sc, 1.0)

        # russian roulette (path.cpp:362-370)
        if indirect:
            rr_beta_max = jnp.max(beta_new, axis=-1) * eta_scale
            q = jnp.maximum(0.05, 1.0 - rr_beta_max)
            u_rr = sfn(pid, sidx, dims["rr"], cfg.seed)
            do_rr = (b > 3) & (rr_beta_max < cfg.rr_threshold)
            killed = do_rr & (u_rr < q)
            beta_new = jnp.where((do_rr & ~killed)[..., None],
                                 beta_new / jnp.maximum(1.0 - q, 1e-6)[
                                     ..., None], beta_new)
            alive = alive & ~killed

        o_next = vecmath.offset_ray_origin(hit.p, hit.ng, wi)
        beta = jnp.where(alive[..., None], beta_new, beta)
        o_cur = jnp.where(alive[..., None], o_next, o_cur)
        d_cur = jnp.where(alive[..., None], wi, d_cur)
        specular = jnp.where(alive, is_spec if nee else True, specular)
        active = alive
        return (L, beta, active, specular, eta_scale, o_cur, d_cur, lv)

    state = (L, beta, active, specular, eta_scale, o_cur, d_cur,
             live_counts)
    # fori_loop: one traced bounce body (dims are computed from the traced
    # bounce index — counter-based sampling makes this free), keeping
    # compile time flat in max_depth
    state = jax.lax.fori_loop(0, n_bounces, body, state)
    if cfg.collect_stats:
        return state[0], state[7]
    return state[0]


def _li_volpath(*args, **kw):
    from pbrt_tpu.integrators.volpath import li_volpath
    return li_volpath(*args, **kw)


def _li_bdpt(*args, **kw):
    from pbrt_tpu.integrators.bdpt import li_bdpt
    return li_bdpt(*args, **kw)


def _li_bdpt_t1(*args, **kw):
    from pbrt_tpu.integrators.bdpt import li_bdpt_t1
    return li_bdpt_t1(*args, **kw)


def _li_hero_path(*args, **kw):
    from pbrt_tpu.integrators.hero import li_hero_path
    return li_hero_path(*args, **kw)


def _li_hero_path_mis(*args, **kw):
    from pbrt_tpu.integrators.hero import li_hero_path_mis
    return li_hero_path_mis(*args, **kw)


_INTEGRATORS = {"path": li_path, "direct": li_direct,
                "directlighting": li_direct, "whitted": li_whitted,
                "ao": li_ao, "ambientocclusion": li_ao, "mypath": li_mypath,
                "volpath": _li_volpath, "bdpt": _li_bdpt,
                "bdpt_t1": _li_bdpt_t1,
                "hero_path": _li_hero_path,
                "hero_path_mis": _li_hero_path_mis}


# ---------------------------------------------------------------------------
# render pass (one spp chunk over the full image) + driver
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg", "width", "height",
                                             "chunk", "crop"))
def render_pass(scene, cam, filt, cfg: RenderConfig, width: int, height: int,
                chunk: int, spp_offset, power_distr=None, crop=None):
    """Evaluate `chunk` samples for every pixel; returns (H,W,C) sum of
    filter-weighted radiance (divide by total spp outside).

    ``crop`` = (px0, py0, wc, hc) static cropped pixel bounds
    (Film::croppedPixelBounds, core/film.cpp:58-66); sampler streams stay
    keyed by full-image pixel position so a crop renders the identical
    samples as the full frame."""
    px0, py0, wc, hc = crop if crop is not None else (0, 0, width, height)
    n_pix = wc * hc
    lid = jnp.tile(jnp.arange(n_pix, dtype=jnp.uint32), chunk)
    sidx = (jnp.repeat(jnp.arange(chunk, dtype=jnp.uint32), n_pix)
            + spp_offset.astype(jnp.uint32))
    sfn = make_sampler(cfg.sampler, resolution=(width, height))

    px = (px0 + lid % wc).astype(jnp.float32)
    py = (py0 + lid // wc).astype(jnp.float32)
    pid = (py.astype(jnp.uint32) * jnp.uint32(width)
           + px.astype(jnp.uint32))
    u_film = _sample2(sfn, pid, sidx, (0, 1), cfg.seed)
    off, w_filt = film_mod.sample_filter_offset(filt, u_film)
    p_film = jnp.stack([px + 0.5, py + 0.5], axis=-1) + off

    u_lens = _sample2(sfn, pid, sidx, (2, 3), cfg.seed)
    u_time = sfn(pid, sidx, 4, cfg.seed)
    rays = cam_mod.generate_rays(cam, p_film, u_lens, u_time)

    if power_distr is None and cfg.light_strategy == "power":
        power_distr = lights_mod.power_distribution(scene.lights)
    li_fn = _INTEGRATORS[cfg.integrator]
    if scene.has_motion and cfg.integrator in (
            "path", "direct", "directlighting", "whitted", "ao",
            "ambientocclusion", "mypath"):
        t_ray = cam.shutter_open + u_time * (cam.shutter_close
                                             - cam.shutter_open)
        L = li_fn(scene, rays.o, rays.d, pid, sidx, sfn, cfg, power_distr,
                  time=t_ray, cam=cam)
    else:
        L = li_fn(scene, rays.o, rays.d, pid, sidx, sfn, cfg, power_distr,
                  cam=cam)

    live = None
    if cfg.collect_stats:
        L, live = L

    # clamp NaN/negative/inf to black (integrator.cpp:592-613)
    bad = (~jnp.isfinite(L)).any(-1) | (jnp.sum(L, -1) < -1e-5)
    L = jnp.where(bad[..., None], 0.0, L)

    contrib = L * w_filt[..., None]
    img = jnp.sum(contrib.reshape(chunk, n_pix, -1), axis=0)
    img = img.reshape(hc, wc, -1)
    if cfg.collect_stats:
        return img, live
    return img


def _iparam(ip, name, default):
    """Read one integrator parameter from either a frontend Params bag
    (has .one) or a plain dict (programmatic callers)."""
    if ip is None:
        return default
    if hasattr(ip, "one"):
        return ip.one(name, default)
    return ip.get(name, default)


def _even_chunk(spp: int, cap: int) -> int:
    """The largest divisor of `spp` that is at most `cap`, when it keeps at
    least half the pass size: every pass then has one shape, so render()
    compiles one program instead of a second one for a leftover chunk."""
    d = max(k for k in range(1, cap + 1) if spp % k == 0)
    return d if 2 * d >= cap else cap


def render(scene, cam, spp: int = 16, integrator: str = "path",
           sampler: str = "independent", filter_name: str = "box",
           filter_kwargs: dict = None, max_depth: int = 5, seed: int = 0,
           chunk_spp: int = None, light_strategy: str = "uniform",
           rr_threshold: float = 1.0, crop_window=None,
           integrator_params=None) -> jnp.ndarray:
    """Full render → (H, W, C) radiance image. Host loop over spp chunks.

    ``crop_window`` = (x0, x1, y0, y1) NDC fractions (Options::cropWindow /
    Film "float cropwindow", core/film.cpp:58-66); the returned image is the
    cropped region only.

    Like the reference's MakeIntegrator switch (core/api.cpp:1789-1812),
    every scene-file integrator keyword dispatches from here — the
    non-tile-based algorithms (bdpt with its t=1 light-tracing splats, mlt,
    sppm — bdpt.cpp:302 / mlt.cpp:165 / sppm.cpp:63 override Render
    entirely) route to their dedicated drivers, parameterized by
    ``integrator_params`` (the scene file's Integrator ParamSet)."""
    res = np.asarray(cam.resolution)
    width, height = int(res[0]), int(res[1])
    ip = integrator_params
    if integrator == "bdpt":
        from pbrt_tpu.integrators.bdpt import render_bdpt
        return render_bdpt(scene, cam, spp=spp, max_depth=max_depth,
                           seed=seed)
    if integrator == "mlt":
        from pbrt_tpu.integrators.mlt import render_mlt
        # pbrt ignores the sampler's pixelsamples for MLT
        # (mlt.cpp:270-276: everything comes from the integrator ParamSet)
        return render_mlt(
            scene, cam,
            mutations_per_pixel=int(_iparam(ip, "mutationsperpixel", spp)),
            n_chains=int(_iparam(ip, "chains", 4096)),
            n_bootstrap=int(_iparam(ip, "bootstrapsamples", 16384)),
            max_depth=max_depth, seed=seed)
    if integrator == "sppm":
        from pbrt_tpu.integrators.sppm import render_sppm
        ppi = int(_iparam(ip, "photonsperiteration", -1))
        if ppi <= 0:
            ppi = width * height   # pbrt: -1 → film pixel count (sppm.cpp)
        # pbrt's default initial search radius is 1.0 world units
        # (sppm.cpp:514); callers not going through a scene file can ask
        # for the resolution-adaptive heuristic via render_sppm directly
        radius = float(_iparam(ip, "radius", 1.0))
        return render_sppm(
            scene, cam,
            n_iterations=int(_iparam(ip, "iterations",
                                     _iparam(ip, "numiterations", 64))),
            photons_per_iter=ppi,
            initial_radius=radius,
            max_depth=max_depth, seed=seed)
    crop = None
    if crop_window is not None:
        x0, x1, y0, y1 = [float(v) for v in crop_window]
        px0 = int(np.ceil(width * min(x0, x1)))
        px1 = max(px0 + 1, int(np.ceil(width * max(x0, x1))))
        py0 = int(np.ceil(height * min(y0, y1)))
        py1 = max(py0 + 1, int(np.ceil(height * max(y0, y1))))
        crop = (px0, py0, min(px1, width) - px0, min(py1, height) - py0)
    filt = film_mod.make_filter(filter_name, **(filter_kwargs or {}))
    cfg = RenderConfig(integrator=integrator, sampler=sampler,
                       max_depth=max_depth, seed=seed,
                       light_strategy=light_strategy,
                       rr_threshold=rr_threshold)
    if chunk_spp is None:
        # bound rays/pass: the XLA CPU path materializes (R, P)
        # intermediates, so keep CPU passes small; accelerators thrive on
        # large batches
        target = 65_536 if jax.default_backend() == "cpu" else 2_000_000
        chunk_spp = _even_chunk(
            spp, max(1, min(spp, int(target // (width * height)) or 1)))
    power_distr = None
    if light_strategy == "spatial":
        from pbrt_tpu.scene.lightdistrib import build_spatial_distribution
        power_distr = build_spatial_distribution(scene)
    out_h = crop[3] if crop else height
    out_w = crop[2] if crop else width
    img = jnp.zeros((out_h, out_w, scene.n_channels))
    done = 0
    while done < spp:
        c = min(chunk_spp, spp - done)
        img = img + render_pass(scene, cam, filt, cfg, width, height, c,
                                jnp.asarray(done, jnp.uint32), power_distr,
                                crop=crop)
        done += c
    return img / spp


render_image = render
