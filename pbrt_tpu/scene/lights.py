"""Light table: point, spot, distant, diffuse-area, infinite, portal-area.

JAX counterpart of ``src/lights/`` + the Light interface
(core/light.h:62-126). Lights are rows of an SoA table; Sample_Li/Pdf_Li are
batched over shading points with branchless type dispatch. The fork's
PortalArealight (lights/portal_arealight.{h,cpp}) is an AREA row with
portal rows attached (padded (L, MAXP) arrays) and a strategy tag; portal
sampling itself lives in scene/portals.py.

Area lights bind to a primitive (one light row per emissive primitive, as
pbrt creates one DiffuseAreaLight per Shape — core/api.cpp pbrtShape).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core import vecmath
from pbrt_tpu.core.sampling import (Distribution2D, distribution_2d_pdf,
                                    make_distribution_2d,
                                    sample_distribution_2d,
                                    uniform_sample_sphere, INV_4PI)
from pbrt_tpu.core.vecmath import absdot, dot, normalize
from pbrt_tpu.scene import shapes

Array = Any

POINT = 0
SPOT = 1
DISTANT = 2
AREA = 3
INFINITE = 4
GONIO = 5
PROJECTION = 6

# portal strategies (lights/portal_arealight.h:12)
STRAT_LIGHT = 0
STRAT_PORTAL = 1
STRAT_PROJECTION = 2

MAXP = 4  # hard cap on portals per light (lamp scene uses 2)
# build_light_table sizes the portal axis to the scene's actual max
# (min 1): every ray pays O(n_slots) portal-selection work per bounce
# (PROFILE_r03: the padded slots were ~half the bounce loop)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LightTable:
    ltype: Array        # (L,) int32
    emit: Array         # (L,C) radiance (area/infinite/distant) or intensity
    pos: Array          # (L,3)
    dir: Array          # (L,3) normalized (spot/distant)
    cos_total: Array    # (L,) spot outer cone
    cos_falloff: Array  # (L,) spot inner cone
    prim_id: Array      # (L,) area light's global prim (−1)
    two_sided: Array    # (L,) bool
    # portal extension (fork)
    strategy: Array     # (L,) int32
    n_portals: Array    # (L,) int32
    portal_lo: Array    # (L,MAXP,3)
    portal_hi: Array    # (L,MAXP,3)
    portal_ax: Array    # (L,MAXP) int32
    portal_facing: Array  # (L,MAXP) bool
    # goniometric/projection intensity map (lights/goniometric.cpp,
    # lights/projection.cpp); shared single map per scene like env_map
    gonio_map: Array    # (Hg,Wg,C) lat-long (gonio) or projector image
    proj_fov: Array     # (L,) projection light field of view (deg)
    # environment map (first INFINITE light): lat-long radiance map
    env_map: Array      # (H,W,C)
    env_distr: Distribution2D
    # power distribution over lights (PowerLightDistribution analogue)
    power: Array        # (L,C)
    # sorted tuple of light types present: the batched Sample_Li/Pdf_Li only
    # *trace* the type families a scene instantiates (same specialization as
    # MaterialTable.present — pbrt's virtual dispatch never executes absent
    # subclasses). Empty = unknown → trace everything.
    present: tuple = dataclasses.field(metadata=dict(static=True),
                                       default=())
    # static: any portal area light in the scene? (guards tracing the whole
    # portal-strategy machinery in estimate_direct)
    has_portals: bool = dataclasses.field(metadata=dict(static=True),
                                          default=True)

    @property
    def n(self) -> int:
        return self.ltype.shape[0]


def _lt_present(lt: LightTable, *types: int) -> bool:
    """Static check: can any of `types` occur in this table?"""
    if not lt.present:
        return True
    return any(tt in lt.present for tt in types)


def build_light_table(builder, scene) -> LightTable:
    """Host-side: builder.light_rows (dicts) → LightTable.

    Row keys: type ('point'|'spot'|'distant'|'area'|'infinite'),
    L/I (spectrum), pos, dir/to, cone_angle, cone_delta, prim (global id),
    two_sided, portals=[(lo,hi,ax,facing)...], strategy, env_map (H,W,3 rgb).
    """
    rows = builder.light_rows
    C = builder.cfg.n_channels
    L = max(1, len(rows))
    tmap = {"point": POINT, "spot": SPOT, "distant": DISTANT, "area": AREA,
            "infinite": INFINITE, "goniometric": GONIO,
            "projection": PROJECTION}
    smap = {"light": STRAT_LIGHT, "portal": STRAT_PORTAL,
            "projection": STRAT_PROJECTION}

    ltype = np.full(L, POINT, np.int32)
    emit = np.zeros((L, C), np.float32)
    pos = np.zeros((L, 3), np.float32)
    ldir = np.tile(np.array([0, 0, 1], np.float32), (L, 1))
    cos_total = np.full(L, -1.0, np.float32)
    cos_falloff = np.full(L, -1.0, np.float32)
    prim_id = np.full(L, -1, np.int32)
    two_sided = np.zeros(L, bool)
    strategy = np.zeros(L, np.int32)
    n_portals = np.zeros(L, np.int32)
    maxp = max([1] + [min(len(r.get("portals", [])), MAXP)
                      for r in rows])
    p_lo = np.zeros((L, maxp, 3), np.float32)
    p_hi = np.zeros((L, maxp, 3), np.float32)
    p_ax = np.full((L, maxp), 2, np.int32)
    p_fw = np.zeros((L, maxp), bool)
    env_map = np.zeros((1, 1, C), np.float32)
    gonio_map = np.ones((1, 1, C), np.float32)
    proj_fov = np.full(L, 45.0, np.float32)

    def resolve_prim(pr):
        """prim may be a resolved global index or a deferred
        (family, local_idx) pair — family offsets only settle once parsing
        finishes, so resolution happens here at build time."""
        if isinstance(pr, tuple):
            return builder.prim_index(*pr)
        return int(pr)

    for i, r in enumerate(rows):
        ltype[i] = tmap[r.get("type", "point")]
        e = np.asarray(r.get("L", r.get("I", np.ones(C))), np.float32)
        sc = np.asarray(r.get("scale", np.ones(C)), np.float32)
        emit[i] = np.broadcast_to(e * sc, (C,))
        pos[i] = np.asarray(r.get("pos", (0, 0, 0)), np.float32)
        d = np.asarray(r.get("dir", (0, 0, 1)), np.float32)
        ldir[i] = d / max(np.linalg.norm(d), 1e-12)
        if ltype[i] == SPOT:
            ang = float(r.get("cone_angle", 30.0))
            delta = float(r.get("cone_delta", 5.0))
            cos_total[i] = np.cos(np.radians(ang))
            cos_falloff[i] = np.cos(np.radians(ang - delta))
        prim_id[i] = resolve_prim(r.get("prim", -1))
        two_sided[i] = bool(r.get("two_sided", False))
        strategy[i] = smap[r.get("strategy", "light")]
        portals = r.get("portals", [])
        n_portals[i] = len(portals)
        for j, (plo, phi, pax, pfw) in enumerate(portals[:maxp]):
            p_lo[i, j] = plo
            p_hi[i, j] = phi
            p_ax[i, j] = pax
            p_fw[i, j] = pfw
        if ltype[i] in (GONIO, PROJECTION):
            proj_fov[i] = float(r.get("fov", 45.0))
            if r.get("map") is not None:
                gm = np.asarray(r["map"], np.float32)
                if gm.shape[-1] != C:
                    from pbrt_tpu.core import spectrum as spec_mod
                    gm = np.asarray(spec_mod.from_rgb(
                        jnp.asarray(gm), builder.cfg))
                gonio_map = gm
        if ltype[i] == INFINITE and r.get("env_map") is not None:
            em = np.asarray(r["env_map"], np.float32)
            if em.shape[-1] != C:
                from pbrt_tpu.core import spectrum as spec_mod
                em = np.asarray(spec_mod.from_rgb(
                    jnp.asarray(em), builder.cfg))
            env_map = em

    # env importance distribution over luminance-ish (mean channel),
    # weighted by sin(theta) (lights/infinite.cpp:58-70)
    h = env_map.shape[0]
    sin_theta = np.sin((np.arange(h) + 0.5) / h * np.pi)[:, None]
    env_f = env_map.mean(-1) * sin_theta + 1e-9
    env_distr = make_distribution_2d(jnp.asarray(env_f, jnp.float32))

    # Power() per light (for PowerLightDistribution; light.h Power)
    wr = float(np.linalg.norm(
        np.asarray(scene.world_hi) - np.asarray(scene.world_lo)) / 2 + 1e-3)
    power = np.zeros((L, C), np.float32)
    for i, r in enumerate(rows):
        if ltype[i] == POINT:
            power[i] = 4 * np.pi * emit[i]
        elif ltype[i] == SPOT:
            power[i] = emit[i] * 2 * np.pi * (
                1 - 0.5 * (cos_falloff[i] + cos_total[i]))
        elif ltype[i] == DISTANT:
            power[i] = emit[i] * np.pi * wr * wr
        elif ltype[i] == AREA:
            area = _prim_area_host(builder, int(prim_id[i]))
            power[i] = emit[i] * area * np.pi * (2.0 if two_sided[i] else 1.0)
        elif ltype[i] == INFINITE:
            power[i] = env_map.mean((0, 1)) * emit[i] * np.pi * wr * wr
        elif ltype[i] == GONIO:
            power[i] = 4 * np.pi * emit[i] * gonio_map.mean((0, 1))
        elif ltype[i] == PROJECTION:
            power[i] = emit[i] * gonio_map.mean((0, 1)) * 2 * np.pi \
                * (1 - np.cos(np.radians(proj_fov[i]) / 2))
    if not rows:
        emit[0] = 0.0

    return LightTable(
        ltype=jnp.asarray(ltype), emit=jnp.asarray(emit),
        pos=jnp.asarray(pos), dir=jnp.asarray(ldir),
        cos_total=jnp.asarray(cos_total), cos_falloff=jnp.asarray(cos_falloff),
        prim_id=jnp.asarray(prim_id), two_sided=jnp.asarray(two_sided),
        strategy=jnp.asarray(strategy), n_portals=jnp.asarray(n_portals),
        portal_lo=jnp.asarray(p_lo), portal_hi=jnp.asarray(p_hi),
        portal_ax=jnp.asarray(p_ax), portal_facing=jnp.asarray(p_fw),
        gonio_map=jnp.asarray(gonio_map), proj_fov=jnp.asarray(proj_fov),
        env_map=jnp.asarray(env_map), env_distr=env_distr,
        power=jnp.asarray(power),
        present=tuple(sorted({int(v) for v in ltype} or {POINT})),
        has_portals=bool((n_portals > 0).any()))


def _prim_area_host(builder, gid: int) -> float:
    nt, ns = len(builder.tris), len(builder.spheres)
    npl = len(builder.planes)
    if gid < 0:
        return 0.0
    if gid < nt:
        r = builder.tris[gid]
        v0, v1, v2 = (np.asarray(r[k], np.float64) for k in
                      ("v0", "v1", "v2"))
        return float(0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0)))
    gid -= nt
    if gid < ns:
        return float(4 * np.pi * builder.spheres[gid]["radius"] ** 2)
    gid -= ns
    if gid < npl:
        r = builder.planes[gid]
        lo = np.asarray(r["lo"], np.float64)
        hi = np.asarray(r["hi"], np.float64)
        ax = r["ax"]
        ax0 = {2: 0, 0: 1, 1: 2}[ax]
        ax1 = {2: 1, 0: 2, 1: 0}[ax]
        return float((hi[ax0] - lo[ax0]) * (hi[ax1] - lo[ax1]))
    gid -= npl
    return float(np.pi * builder.disks[gid]["radius"] ** 2)


# ---------------------------------------------------------------------------
# Gathering per-ray light rows & area-prim geometry
# ---------------------------------------------------------------------------

def gather_lights(lt: LightTable, idx: Array) -> LightTable:
    # small-table row gather (ops/fastgather.py: select/one-hot forms
    # instead of per-ray index gathers)
    from pbrt_tpu.ops import fastgather
    g = fastgather.make_row_gather(lt.n, idx)
    return LightTable(
        ltype=g(lt.ltype), emit=g(lt.emit), pos=g(lt.pos), dir=g(lt.dir),
        cos_total=g(lt.cos_total), cos_falloff=g(lt.cos_falloff),
        prim_id=g(lt.prim_id), two_sided=g(lt.two_sided),
        strategy=g(lt.strategy), n_portals=g(lt.n_portals),
        portal_lo=g(lt.portal_lo), portal_hi=g(lt.portal_hi),
        portal_ax=g(lt.portal_ax), portal_facing=g(lt.portal_facing),
        gonio_map=lt.gonio_map, proj_fov=g(lt.proj_fov),
        env_map=lt.env_map, env_distr=lt.env_distr, power=lt.power)


@dataclasses.dataclass
class AreaPrim:
    """Per-ray gathered geometry of an area light's primitive."""
    is_tri: Array
    is_sph: Array
    is_pln: Array
    v0: Array
    v1: Array
    v2: Array
    center: Array
    radius: Array
    lo: Array
    hi: Array
    ax: Array
    facing: Array


def gather_area_prim(scene, prim_id: Array) -> AreaPrim:
    g = scene.geom
    nt, ns = scene.n_tri, scene.n_sph
    is_tri = (prim_id >= 0) & (prim_id < nt)
    is_sph = (prim_id >= nt) & (prim_id < nt + ns)
    is_pln = (prim_id >= nt + ns) & (prim_id
                                     < nt + ns + scene.n_pln)
    ti = jnp.clip(prim_id, 0, max(nt - 1, 0))
    si = jnp.clip(prim_id - nt, 0, max(ns - 1, 0))
    pi = jnp.clip(prim_id - nt - ns, 0, max(scene.n_pln - 1, 0))
    from pbrt_tpu.ops import fastgather
    gt = fastgather.make_row_gather(max(nt, 1), ti)
    gs = fastgather.make_row_gather(max(ns, 1), si)
    gp = fastgather.make_row_gather(max(scene.n_pln, 1), pi)
    return AreaPrim(
        is_tri=is_tri, is_sph=is_sph, is_pln=is_pln,
        v0=gt(g.tri_v0), v1=gt(g.tri_v1), v2=gt(g.tri_v2),
        center=gs(g.sph_center), radius=gs(g.sph_radius),
        lo=gp(g.pln_lo), hi=gp(g.pln_hi), ax=gp(g.pln_ax),
        facing=gp(g.pln_facing))


def area_light_L(lt_emit: Array, two_sided: Array, n_light: Array,
                 w: Array) -> Array:
    """DiffuseAreaLight::L (lights/diffuse.h:60-66): emit iff twoSided or
    the outgoing direction w is on the normal side."""
    front = dot(n_light, w) > 0.0
    ok = two_sided | front
    return jnp.where(ok[..., None], lt_emit, 0.0)


# ---------------------------------------------------------------------------
# Sample_Li / Pdf_Li (batched, branchless type dispatch)
# ---------------------------------------------------------------------------

def sample_li(scene, light_idx: Array, ref_p: Array, u: Array):
    """Light::Sample_Li analogue.

    light_idx: (R,) chosen light per ray; ref_p: (R,3); u: (R,2).
    Returns dict with wi (R,3), li (R,C), pdf (R,) [solid angle],
    p_light (R,3) (for shadow rays; for distant/infinite a far point),
    is_delta (R,), n_light (R,3).
    """
    lt = scene.lights
    g = gather_lights(lt, light_idx)
    wr = scene.world_radius()
    C = g.emit.shape[-1]
    R = ref_p.shape[0]

    # --- point / spot (cheap; li_pt also feeds spot/gonio/projection)
    to_l = g.pos - ref_p
    d2 = vecmath.length_squared(to_l)
    wi_pt = normalize(to_l)
    li_pt = g.emit / jnp.maximum(d2, 1e-12)[..., None]
    if _lt_present(lt, SPOT):
        # spot falloff (lights/spot.cpp Falloff)
        cos_t = dot(-wi_pt, g.dir)
        delta_cos = jnp.maximum(g.cos_falloff - g.cos_total, 1e-6)
        t = jnp.clip((cos_t - g.cos_total) / delta_cos, 0.0, 1.0)
        falloff = t * t * (t * t)  # (delta^2)^2 quartic per spot.cpp
        li_spot = li_pt * jnp.where(cos_t < g.cos_total, 0.0,
                                    jnp.where(cos_t > g.cos_falloff, 1.0,
                                              falloff))[..., None]

    # --- distant: wi = -dir, sample point far away
    wi_dist = -g.dir
    p_dist = ref_p + wi_dist * (2.0 * wr)

    # --- area: sample the bound primitive
    if _lt_present(lt, AREA):
        ap = gather_area_prim(scene, g.prim_id)
        p_tri, n_tri, ipdf_tri = shapes.sample_triangle(ap.v0, ap.v1, ap.v2,
                                                        u)
        p_pln, n_pln, ipdf_pln = shapes.sample_aaplane(ap.lo, ap.hi, ap.ax,
                                                       ap.facing, u)
        p_sph, n_sph, pdf_sph_sa = shapes.sample_sphere_from_ref(
            ap.center, ap.radius, ref_p, u)
        p_area = jnp.where(ap.is_sph[..., None], p_sph,
                           jnp.where(ap.is_pln[..., None], p_pln, p_tri))
        n_area = jnp.where(ap.is_sph[..., None], n_sph,
                           jnp.where(ap.is_pln[..., None], n_pln, n_tri))
        to_area = p_area - ref_p
        d2a = vecmath.length_squared(to_area)
        wi_area = normalize(to_area)
        # area pdf → solid angle (shape.cpp Shape::Pdf(ref,wi))
        area_pdf = jnp.where(ap.is_pln, ipdf_pln, ipdf_tri)
        cos_l = absdot(n_area, -wi_area)
        pdf_area = jnp.where(
            ap.is_sph, pdf_sph_sa,
            d2a * area_pdf / jnp.maximum(cos_l, 1e-9))
        li_area = area_light_L(g.emit, g.two_sided, n_area, -wi_area)
        li_area = jnp.where((d2a > 1e-12)[..., None], li_area, 0.0)

    # --- infinite: importance-sample env map (lights/infinite.cpp:108-140)
    if _lt_present(lt, INFINITE):
        uv, pdf_uv = sample_distribution_2d(lt.env_distr, u)
        theta = uv[..., 1] * jnp.pi
        phi = uv[..., 0] * 2.0 * jnp.pi
        sin_t_env = jnp.sin(theta)
        wi_inf = jnp.stack([sin_t_env * jnp.cos(phi), jnp.cos(theta),
                            sin_t_env * jnp.sin(phi)], axis=-1)
        pdf_inf = pdf_uv / jnp.maximum(2.0 * jnp.pi * jnp.pi * sin_t_env,
                                       1e-9)
        li_inf = env_radiance(lt, wi_inf) * g.emit
        p_inf = ref_p + wi_inf * (2.0 * wr)
        # constant (1×1) env maps degenerate → uniform sphere sampling
        const_env = lt.env_map.shape[0] * lt.env_map.shape[1] == 1
        if const_env:
            wi_inf = uniform_sample_sphere(u)
            pdf_inf = jnp.full(R, INV_4PI)
            li_inf = jnp.broadcast_to(lt.env_map[0, 0], (R, C)) * g.emit
            p_inf = ref_p + wi_inf * (2.0 * wr)

    # goniometric: point intensity modulated by a lat-long map along -wi
    # (lights/goniometric.cpp Scale); projection: modulated by projecting
    # -wi through the projector window (lights/projection.cpp)
    Hg, Wg = lt.gonio_map.shape[0], lt.gonio_map.shape[1]
    wl = -wi_pt
    if _lt_present(lt, GONIO):
        theta_g = jnp.arccos(jnp.clip(wl[..., 1], -1.0, 1.0))
        phi_g = jnp.arctan2(wl[..., 2], wl[..., 0])
        phi_g = jnp.where(phi_g < 0, phi_g + 2 * jnp.pi, phi_g)
        gx = jnp.clip((phi_g / (2 * jnp.pi) * Wg).astype(jnp.int32), 0,
                      Wg - 1)
        gy = jnp.clip((theta_g / jnp.pi * Hg).astype(jnp.int32), 0, Hg - 1)
        li_gonio = li_pt * lt.gonio_map[gy, gx]
    if _lt_present(lt, PROJECTION):
        # projection: dir is +z of the light frame (g.dir); map uv from the
        # perspective projection, black outside the fov cone
        cos_p = dot(wl, g.dir)
        tan_half = jnp.tan(jnp.radians(g.proj_fov) / 2.0)
        t1p, t2p = vecmath.coordinate_system(g.dir)
        x_p = dot(wl, t1p) / jnp.maximum(cos_p, 1e-6)
        y_p = dot(wl, t2p) / jnp.maximum(cos_p, 1e-6)
        inside_p = (cos_p > 0) & (jnp.abs(x_p) < tan_half) \
            & (jnp.abs(y_p) < tan_half)
        px_ = jnp.clip(((x_p / tan_half * 0.5 + 0.5) * Wg).astype(jnp.int32),
                       0, Wg - 1)
        py_ = jnp.clip(((y_p / tan_half * 0.5 + 0.5) * Hg).astype(jnp.int32),
                       0, Hg - 1)
        li_proj = li_pt * lt.gonio_map[py_, px_] \
            * jnp.where(inside_p, 1.0, 0.0)[..., None]

    is_pt = g.ltype == POINT
    is_spot = g.ltype == SPOT
    is_dist = g.ltype == DISTANT
    is_area = g.ltype == AREA
    is_inf = g.ltype == INFINITE

    def selv(default, *pairs):
        out = default
        for c, v in pairs:
            cc = c
            while cc.ndim < v.ndim:
                cc = cc[..., None]
            out = jnp.where(cc, v, out)
        return out

    is_gonio = g.ltype == GONIO
    is_proj = g.ltype == PROJECTION
    wi_rows, li_rows, pdf_rows, p_rows, n_rows = [], [], [], [], []
    if _lt_present(lt, SPOT):
        li_rows.append((is_spot, li_spot))
    if _lt_present(lt, GONIO):
        li_rows.append((is_gonio, li_gonio))
    if _lt_present(lt, PROJECTION):
        li_rows.append((is_proj, li_proj))
    if _lt_present(lt, DISTANT):
        wi_rows.append((is_dist, wi_dist))
        li_rows.append((is_dist, g.emit * jnp.ones((R, 1))))
        p_rows.append((is_dist, p_dist))
    if _lt_present(lt, AREA):
        wi_rows.append((is_area, wi_area))
        li_rows.append((is_area, li_area))
        pdf_rows.append((is_area, pdf_area))
        p_rows.append((is_area, p_area))
        n_rows.append((is_area, n_area))
    if _lt_present(lt, INFINITE):
        wi_rows.append((is_inf, wi_inf))
        li_rows.append((is_inf, li_inf))
        pdf_rows.append((is_inf, pdf_inf))
        p_rows.append((is_inf, p_inf))
    wi = selv(wi_pt, *wi_rows)
    li = selv(li_pt, *li_rows)
    pdf = selv(jnp.ones(R), *pdf_rows)
    p_light = selv(g.pos, *p_rows)
    n_light = selv(-wi, *n_rows)
    is_delta = is_pt | is_spot | is_dist | is_gonio | is_proj
    return dict(wi=wi, li=li, pdf=pdf, p_light=p_light, n_light=n_light,
                is_delta=is_delta)


def pdf_li(scene, light_idx: Array, ref_p: Array, wi: Array) -> Array:
    """Light::Pdf_Li analogue (solid-angle density of sample_li for wi)."""
    lt = scene.lights
    g = gather_lights(lt, light_idx)
    R = ref_p.shape[0]
    pdf = jnp.zeros(R)

    if _lt_present(lt, AREA):
        # area: intersect the bound primitive along wi (paired: one
        # prim/ray)
        ap = gather_area_prim(scene, g.prim_id)
        tmax = jnp.full(R, vecmath.INF)
        t_tri, _, _, hit_tri = shapes.intersect_triangle_paired(
            ref_p, wi, tmax, ap.v0, ap.v1, ap.v2)
        t_pln, _, _, hit_pln = shapes.intersect_aaplane_paired(
            ref_p, wi, tmax, ap.lo, ap.hi, ap.ax)
        area_tri = shapes.triangle_area(ap.v0, ap.v1, ap.v2)
        area_pln = shapes.aaplane_area(ap.lo, ap.hi, ap.ax)
        n_tri = shapes.triangle_normal(ap.v0, ap.v1, ap.v2)
        n_pln = shapes.aaplane_normal(ap.ax, ap.facing)
        t_hit = jnp.where(ap.is_pln, t_pln, t_tri)
        hit = jnp.where(ap.is_pln, hit_pln, hit_tri)
        n_l = jnp.where(ap.is_pln[..., None], n_pln, n_tri)
        area = jnp.where(ap.is_pln, area_pln, area_tri)
        pdf_flat = jnp.where(
            hit,
            (t_hit * t_hit) / jnp.maximum(absdot(n_l, -wi) * area, 1e-9),
            0.0)
        pdf_sph = shapes.sphere_pdf_wi(ap.center, ap.radius, ref_p, wi) \
            if scene.n_sph else jnp.zeros(R)
        pdf_area = jnp.where(ap.is_sph, pdf_sph, pdf_flat)
        pdf = jnp.where(g.ltype == AREA, pdf_area, pdf)

    if _lt_present(lt, INFINITE):
        # infinite env pdf
        const_env = lt.env_map.shape[0] * lt.env_map.shape[1] == 1
        if const_env:
            pdf_inf = jnp.full(R, INV_4PI)
        else:
            theta = jnp.arccos(jnp.clip(wi[..., 1], -1, 1))
            phi = jnp.arctan2(wi[..., 2], wi[..., 0])
            phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
            uv = jnp.stack([phi / (2 * jnp.pi), theta / jnp.pi], axis=-1)
            sin_t = jnp.maximum(jnp.sin(theta), 1e-6)
            pdf_inf = distribution_2d_pdf(lt.env_distr, uv) \
                / (2.0 * jnp.pi * jnp.pi * sin_t)
        pdf = jnp.where(g.ltype == INFINITE, pdf_inf, pdf)
    return pdf


def infinite_pdf_li(scene, d: Array) -> Array:
    """Solid-angle pdf of the infinite light's Sample_Li for direction d,
    already multiplied by the uniform light-selection pmf
    (InfiniteAreaLight::Pdf_Li, lights/infinite.cpp:142-152)."""
    lt = scene.lights
    if not _lt_present(lt, INFINITE):
        return jnp.zeros(d.shape[:-1])
    has_inf = jnp.any(lt.ltype == INFINITE)
    const_env = lt.env_map.shape[0] * lt.env_map.shape[1] == 1
    if const_env:
        pdf = jnp.full(d.shape[:-1], INV_4PI)
    else:
        theta = jnp.arccos(jnp.clip(d[..., 1], -1, 1))
        phi = jnp.arctan2(d[..., 2], d[..., 0])
        phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
        uv = jnp.stack([phi / (2 * jnp.pi), theta / jnp.pi], axis=-1)
        sin_t = jnp.maximum(jnp.sin(theta), 1e-6)
        pdf = distribution_2d_pdf(lt.env_distr, uv) \
            / (2.0 * jnp.pi * jnp.pi * sin_t)
    return jnp.where(has_inf, pdf / lt.n, 0.0)


def env_radiance(lt: LightTable, d: Array) -> Array:
    """InfiniteAreaLight::Le(ray) lookup (lights/infinite.cpp:94-106) for
    unit directions d (R,3); world frame with +y up lat-long."""
    h, w = lt.env_map.shape[0], lt.env_map.shape[1]
    if h * w == 1:
        return jnp.broadcast_to(lt.env_map[0, 0], d.shape[:-1]
                                + (lt.env_map.shape[-1],))
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 2], d[..., 0])
    phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
    x = jnp.clip((phi / (2 * jnp.pi) * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((theta / jnp.pi * h).astype(jnp.int32), 0, h - 1)
    return lt.env_map[y, x]


def escaped_radiance(scene, d: Array) -> Array:
    """Sum of infinite lights' Le along escaped rays (scene.h:50-74
    infiniteLights loop)."""
    lt = scene.lights
    if not _lt_present(lt, INFINITE):
        return jnp.zeros(d.shape[:-1] + (lt.emit.shape[-1],))
    is_inf = lt.ltype == INFINITE
    base = env_radiance(lt, d)  # (R,C)
    # scale by each infinite light's emit; support a single env map shared
    scale = jnp.sum(jnp.where(is_inf[:, None], lt.emit, 0.0), axis=0)
    return base * scale


def power_distribution(lt: LightTable):
    """PowerLightDistribution's CDF over lights (lightdistrib.cpp)."""
    from pbrt_tpu.core.sampling import make_distribution_1d
    p = jnp.sum(lt.power, axis=-1)
    return make_distribution_1d(jnp.maximum(p, 0.0))


def emission_scale(lt, g, d_emit):
    """Direction-dependent emission modulation of a DELTA-position light
    along emission direction ``d_emit`` (R,3): spot quartic cone falloff
    (spot.cpp Falloff), goniometric lat-long map (goniometric.cpp Scale),
    projection window (projection.cpp Projection). 1.0 for other types.
    Returns (R, C). Shared by BDPT light subpaths / s=1 connections and
    SPPM photon emission (r4)."""
    import jax.numpy as jnp

    from pbrt_tpu.core import vecmath
    from pbrt_tpu.core.vecmath import dot

    R = d_emit.shape[0]
    C = lt.emit.shape[-1]
    out = jnp.ones((R, C))
    if _lt_present(lt, SPOT):
        cos_t = dot(d_emit, g.dir)
        dcos = jnp.maximum(g.cos_falloff - g.cos_total, 1e-6)
        t = jnp.clip((cos_t - g.cos_total) / dcos, 0.0, 1.0)
        fall = jnp.where(cos_t < g.cos_total, 0.0,
                         jnp.where(cos_t > g.cos_falloff, 1.0,
                                   (t * t) * (t * t)))
        out = jnp.where((g.ltype == SPOT)[..., None], fall[..., None],
                        out)
    Hg, Wg = lt.gonio_map.shape[0], lt.gonio_map.shape[1]
    if _lt_present(lt, GONIO):
        theta_g = jnp.arccos(jnp.clip(d_emit[..., 1], -1.0, 1.0))
        phi_g = jnp.arctan2(d_emit[..., 2], d_emit[..., 0])
        phi_g = jnp.where(phi_g < 0, phi_g + 2 * jnp.pi, phi_g)
        gx = jnp.clip((phi_g / (2 * jnp.pi) * Wg).astype(jnp.int32), 0,
                      Wg - 1)
        gy = jnp.clip((theta_g / jnp.pi * Hg).astype(jnp.int32), 0,
                      Hg - 1)
        out = jnp.where((g.ltype == GONIO)[..., None],
                        lt.gonio_map[gy, gx], out)
    if _lt_present(lt, PROJECTION):
        cos_p = dot(d_emit, g.dir)
        tan_half = jnp.tan(jnp.radians(g.proj_fov) / 2.0)
        t1p, t2p = vecmath.coordinate_system(g.dir)
        x_p = dot(d_emit, t1p) / jnp.maximum(cos_p, 1e-6)
        y_p = dot(d_emit, t2p) / jnp.maximum(cos_p, 1e-6)
        inside = (cos_p > 0) & (jnp.abs(x_p) < tan_half) \
            & (jnp.abs(y_p) < tan_half)
        px_ = jnp.clip(((x_p / tan_half * 0.5 + 0.5) * Wg)
                       .astype(jnp.int32), 0, Wg - 1)
        py_ = jnp.clip(((y_p / tan_half * 0.5 + 0.5) * Hg)
                       .astype(jnp.int32), 0, Hg - 1)
        out = jnp.where((g.ltype == PROJECTION)[..., None],
                        lt.gonio_map[py_, px_]
                        * jnp.where(inside, 1.0, 0.0)[..., None], out)
    return out
