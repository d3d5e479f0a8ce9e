"""Material table + branchless BSDF evaluation/sampling in local frames.

JAX counterpart of ``core/reflection.{h,cpp}`` (BSDF/BxDF :164-221 and
the lobe zoo §2.4 of SURVEY.md) + ``src/materials/``. pbrt allocates per-hit
BSDF objects with virtual lobes; here materials are rows of an SoA table,
shading points gather their row, and f/pdf/sample are computed for *all*
implemented lobe families then combined with type masks — no branches, pure
vector code.

Local frame convention (reflection.h): z = shading normal; wo, wi unit
vectors; cos_theta = z component.

Material types (MakeMaterial, core/api.cpp:497-583):
  MATTE (lambertian / Oren–Nayar), MIRROR, GLASS (smooth or rough dielectric),
  PLASTIC (lambert + TR microfacet w/ dielectric fresnel), METAL (TR
  microfacet w/ conductor fresnel), DISPERSIVE_GLASS (fork,
  materials/dispersive_glass.cpp — Cauchy eta(λ)), UBER, SUBSTRATE
  (FresnelBlend), TRANSLUCENT, MIX, NONE (pass-through).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core import vecmath
from pbrt_tpu.core.sampling import (INV_PI, concentric_sample_disk,
                                    cosine_sample_hemisphere)

Array = Any

# material type tags
MATTE = 0
MIRROR = 1
GLASS = 2
PLASTIC = 3
METAL = 4
DISPERSIVE_GLASS = 5
UBER = 6
SUBSTRATE = 7
TRANSLUCENT = 8
NONE = 9          # medium interface / null material → pass-through
DISNEY = 10
SUBSURFACE = 11
HAIR = 12         # materials/hair.cpp — Marschner/Chiang fiber BSDF
FOURIER = 13      # materials/fourier.cpp — measured FourierBSDF tables
SSS_EXIT = 14     # SeparableBSSRDFAdapter (core/bssrdf.h:153-168): the
                  # Fresnel-weighted Sw exit lobe at a BSSRDF exit vertex

# sampled-lobe flags (BxDFType analogue, reflection.h:70-80)
FLAG_SPECULAR = 1
FLAG_TRANSMISSION = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MaterialTable:
    """(M, ...) SoA of material parameters; C = spectrum channels."""
    mtype: Array       # (M,) int32
    kd: Array          # (M,C) diffuse reflectance
    ks: Array          # (M,C) glossy reflectance
    kr: Array          # (M,C) specular reflection scale
    kt: Array          # (M,C) specular transmission scale
    eta: Array         # (M,) dielectric IOR (scalar)
    metal_eta: Array   # (M,C) conductor eta
    metal_k: Array     # (M,C) conductor absorption
    roughness: Array   # (M,) microfacet alpha (already remapped)
    ndf: Array         # (M,) int32 NDF tag: 0 TR (GGX), 1 Beckmann
                       # (core/microfacet.h:48-105)
    sigma: Array       # (M,) Oren–Nayar sigma (degrees)
    cauchy_b: Array    # (M,) dispersive glass: eta(λ)=B + C/λ², λ in µm
    cauchy_c: Array    # (M,)
    # subsurface (materials/{subsurface,kdsubsurface}.cpp): Burley
    # normalized-diffusion parameters derived from sigma_a/sigma_s'
    sss_sigma_a: Array     # (M,C)
    sss_sigma_s: Array     # (M,C)
    # disney principled parameters (materials/disney.cpp)
    metallic: Array        # (M,)
    spec_tint: Array       # (M,)
    sheen: Array           # (M,)
    sheen_tint: Array      # (M,)
    clearcoat: Array       # (M,)
    clearcoat_gloss: Array  # (M,)
    # disney transmission / thin-surface family (disney.cpp:488-616)
    anisotropic: Array     # (M,) 0..1, aspect = sqrt(1 - 0.9·aniso)
    spec_trans: Array      # (M,) specular transmission weight
    diff_trans: Array      # (M,) raw difftrans (halved at eval, :490-491)
    flatness: Array        # (M,) thin-surface fake-subsurface blend
    thin: Array            # (M,) 0/1 thin-surface flag
    scatter_d: Array       # (M,C) disney scatterdistance; non-black on a
                           # non-thin row swaps DisneyDiffuse for a
                           # DisneyBSSRDF (disney.cpp:506-527)
    # hair fiber parameters (materials/hair.cpp; absorption rides in
    # sss_sigma_a)
    beta_m: Array          # (M,) longitudinal roughness
    beta_n: Array          # (M,) azimuthal roughness
    hair_alpha: Array      # (M,) scale tilt, degrees
    # fourier: index into the scene's stacked FourierBSDF tables (−1 none)
    fourier_id: Array      # (M,) int32
    # texture hooks (−1 = constant): resolved by scene/textures.py
    kd_tex: Array      # (M,) int32
    sigma_tex: Array   # (M,) int32
    bump_tex: Array    # (M,) int32
    # static family flags let bsdf_* skip whole lobe families at trace time
    # (pure-Python bools, uniform across the table)
    has_hair: bool = dataclasses.field(metadata=dict(static=True),
                                       default=False)
    has_fourier: bool = dataclasses.field(metadata=dict(static=True),
                                          default=False)
    # static: any Beckmann-NDF row? (guards tracing the Beckmann math)
    has_beckmann: bool = dataclasses.field(metadata=dict(static=True),
                                           default=False)
    # static: any Disney row with spectrans>0 or thin? (guards tracing the
    # Disney transmission lobes — disney.cpp:566-589 only builds them then)
    has_disney_trans: bool = dataclasses.field(metadata=dict(static=True),
                                               default=False)
    # static: any non-thin Disney row with non-black scatterdistance?
    # (guards the DisneyBSSRDF entry lobe + subsurface relocation)
    has_disney_sss: bool = dataclasses.field(metadata=dict(static=True),
                                             default=False)
    # sorted tuple of material types present in the table. pbrt's virtual
    # dispatch only executes the BxDF subclasses a scene instantiates; the
    # branchless equivalent is to only *trace* the present families —
    # absent lobe families never enter the XLA program (compile time and
    # runtime both scale with the scene's material diversity, not the
    # framework's). Empty tuple = unknown → trace everything.
    present: tuple = dataclasses.field(metadata=dict(static=True),
                                       default=())


def make_material_table(rows: list[dict], n_channels: int) -> MaterialTable:
    """Host-side builder from a list of parameter dicts."""
    m = max(1, len(rows))
    f = lambda k, d: np.array(
        [r.get(k, d) for r in rows] or [d], np.float32)
    fc = lambda k, d: np.array(
        [np.broadcast_to(np.asarray(r.get(k, d), np.float32), (n_channels,))
         for r in rows] or [np.full(n_channels, d, np.float32)], np.float32)
    i32 = lambda k, d: np.array([r.get(k, d) for r in rows] or [d], np.int32)
    return MaterialTable(
        mtype=jnp.asarray(i32("type", MATTE)),
        kd=jnp.asarray(fc("kd", 0.5)),
        ks=jnp.asarray(fc("ks", 0.25)),
        kr=jnp.asarray(fc("kr", 1.0)),
        kt=jnp.asarray(fc("kt", 1.0)),
        eta=jnp.asarray(f("eta", 1.5)),
        metal_eta=jnp.asarray(fc("metal_eta", 0.2)),
        metal_k=jnp.asarray(fc("metal_k", 3.9)),
        # default 0 = smooth (glass.cpp's default); metal/plastic set their
        # own nonzero defaults at creation (parser/_make_material)
        roughness=jnp.asarray(f("roughness", 0.0)),
        ndf=jnp.asarray(i32("ndf", NDF_TR)),
        sigma=jnp.asarray(f("sigma", 0.0)),
        cauchy_b=jnp.asarray(f("cauchy_b", 1.5)),
        cauchy_c=jnp.asarray(f("cauchy_c", 0.0)),
        sss_sigma_a=jnp.asarray(fc("sss_sigma_a", 0.01)),
        sss_sigma_s=jnp.asarray(fc("sss_sigma_s", 1.0)),
        metallic=jnp.asarray(f("metallic", 0.0)),
        spec_tint=jnp.asarray(f("spec_tint", 0.0)),
        sheen=jnp.asarray(f("sheen", 0.0)),
        sheen_tint=jnp.asarray(f("sheen_tint", 0.5)),
        clearcoat=jnp.asarray(f("clearcoat", 0.0)),
        clearcoat_gloss=jnp.asarray(f("clearcoat_gloss", 1.0)),
        anisotropic=jnp.asarray(f("anisotropic", 0.0)),
        spec_trans=jnp.asarray(f("spec_trans", 0.0)),
        diff_trans=jnp.asarray(f("diff_trans", 1.0)),
        flatness=jnp.asarray(f("flatness", 0.0)),
        thin=jnp.asarray(f("thin", 0.0)),
        scatter_d=jnp.asarray(fc("scatter_d", 0.0)),
        beta_m=jnp.asarray(f("beta_m", 0.3)),
        beta_n=jnp.asarray(f("beta_n", 0.3)),
        hair_alpha=jnp.asarray(f("hair_alpha", 2.0)),
        fourier_id=jnp.asarray(i32("fourier_id", -1)),
        kd_tex=jnp.asarray(i32("kd_tex", -1)),
        sigma_tex=jnp.asarray(i32("sigma_tex", -1)),
        bump_tex=jnp.asarray(i32("bump_tex", -1)),
        has_hair=any(r.get("type") == HAIR for r in rows),
        has_beckmann=any(r.get("ndf") == NDF_BECKMANN for r in rows),
        has_disney_trans=any(
            r.get("type") == DISNEY
            and (r.get("spec_trans", 0.0) > 0 or r.get("thin", 0.0))
            for r in rows),
        has_disney_sss=any(
            r.get("type") == DISNEY
            and float(np.max(np.asarray(r.get("scatter_d", 0.0)))) > 0
            and not r.get("thin", 0.0)
            for r in rows),
        has_fourier=any(r.get("type") == FOURIER for r in rows),
        present=_close_present(
            {int(r.get("type", MATTE)) for r in rows} or {MATTE},
            disney_sss=any(
                r.get("type") == DISNEY
                and float(np.max(np.asarray(r.get("scatter_d", 0.0)))) > 0
                and not r.get("thin", 0.0)
                for r in rows)),
    )


def _close_present(types: set, disney_sss: bool = False) -> tuple:
    """Close the present-type set under runtime row rewrites:
    subsurface_transport (integrators/common.py) turns SUBSURFACE rows into
    SSS_EXIT (Sw exit lobe) or MIRROR (interface reflection), and entered
    DisneyBSSRDF rows (scatterdistance) into SSS_EXIT."""
    if SUBSURFACE in types:
        types = types | {MATTE, MIRROR, SSS_EXIT}
    if disney_sss:
        types = types | {MATTE, SSS_EXIT}
    return tuple(sorted(types))


def _present(mp: MaterialTable, *types: int) -> bool:
    """Static check: can any of `types` occur in this table? Used to skip
    tracing whole lobe families (see MaterialTable.present)."""
    if not mp.present:
        return True
    return any(tt in mp.present for tt in types)


def gather_materials(table: MaterialTable, mat_id: Array) -> MaterialTable:
    """Gather per-ray material rows (mat_id: (R,)) — one-hot matmul path
    (ops/fastgather.py) instead of per-ray index gathers."""
    from pbrt_tpu.ops import fastgather
    return fastgather.gather_tree(table, mat_id, table.mtype.shape[0])


# ---------------------------------------------------------------------------
# local-frame helpers (reflection.h:47-124)
# ---------------------------------------------------------------------------

def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def same_hemisphere(wo, wi):
    return wo[..., 2] * wi[..., 2] > 0.0


def roughness_to_alpha(rough):
    """TrowbridgeReitzDistribution::RoughnessToAlpha (microfacet.h:122)."""
    rough = jnp.maximum(rough, 1e-3)
    x = jnp.log(rough)
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


# ---------------------------------------------------------------------------
# Fresnel (reflection.h:281-318)
# ---------------------------------------------------------------------------

def fr_dielectric(cos_theta_i: Array, eta_i: Array, eta_t: Array) -> Array:
    """Exact dielectric Fresnel (reflection.cpp FrDielectric), batched.
    Handles both sides via sign of cos_theta_i."""
    ci = jnp.clip(cos_theta_i, -1.0, 1.0)
    entering = ci > 0.0
    ei = jnp.where(entering, eta_i, eta_t)
    et = jnp.where(entering, eta_t, eta_i)
    ci = jnp.abs(ci)
    # sqrt floors keep d/dx sqrt(max(0,x)) finite at the clamp (inf·0=NaN
    # otherwise — poisons grads of every masked lane under jnp.where)
    si = jnp.sqrt(jnp.maximum(1.0 - ci * ci, 1e-12))
    st = ei / et * si
    tir = st >= 1.0
    ct = jnp.sqrt(jnp.maximum(1.0 - st * st, 1e-12))
    r_par = (et * ci - ei * ct) / jnp.maximum(et * ci + ei * ct, 1e-12)
    r_perp = (ei * ci - et * ct) / jnp.maximum(ei * ci + et * ct, 1e-12)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return jnp.where(tir, 1.0, f)


def fr_conductor(cos_theta_i: Array, eta: Array, k: Array) -> Array:
    """Conductor Fresnel (reflection.cpp FrConductor); eta,k: (...,C)."""
    ci = jnp.clip(jnp.abs(cos_theta_i), 0.0, 1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - si2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * eta2 * k2, 0.0))
    t1 = a2b2 + ci2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-12)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


# ---------------------------------------------------------------------------
# Trowbridge–Reitz (GGX) microfacet distribution (core/microfacet.{h,cpp})
# ---------------------------------------------------------------------------

def tr_d(wh: Array, alpha: Array) -> Array:
    """Isotropic TR NDF D(wh)."""
    c2 = wh[..., 2] ** 2
    s2 = jnp.maximum(0.0, 1.0 - c2)
    a2 = alpha * alpha
    e = c2 + s2 / jnp.maximum(a2, 1e-12)
    denom = jnp.pi * a2 * e * e
    return jnp.where(wh[..., 2] > 0, 1.0 / jnp.maximum(denom, 1e-12), 0.0)


def tr_lambda(w: Array, alpha: Array) -> Array:
    c = jnp.clip(jnp.abs(w[..., 2]), 1e-6, 1.0)
    tan2 = (1.0 - c * c) / (c * c)
    return 0.5 * (-1.0 + jnp.sqrt(1.0 + alpha * alpha * tan2))


def tr_g(wo: Array, wi: Array, alpha: Array) -> Array:
    return 1.0 / (1.0 + tr_lambda(wo, alpha) + tr_lambda(wi, alpha))


def tr_g1(w: Array, alpha: Array) -> Array:
    return 1.0 / (1.0 + tr_lambda(w, alpha))


def tr_sample_wh(wo: Array, u: Array, alpha: Array) -> Array:
    """Sample the *visible* normal distribution (heitz 2018 VNDF trick),
    matching pbrt's sampleVisibleArea=true default (microfacet.cpp:269+)."""
    # stretch view
    sign = jnp.sign(wo[..., 2:3] + 1e-20)
    v = sign * wo  # operate in upper hemisphere
    vh = vecmath.normalize(
        jnp.stack([alpha * v[..., 0], alpha * v[..., 1], v[..., 2]], axis=-1))
    # orthonormal basis around vh
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = jnp.where(
        (lensq > 1e-9)[..., None],
        jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(lensq)], axis=-1)
        / jnp.sqrt(jnp.maximum(lensq, 1e-12))[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), vh.shape))
    t2 = jnp.cross(vh, t1)
    # parameterize projected area
    d = concentric_sample_disk(u)
    p1 = d[..., 0]
    p2_ = d[..., 1]
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1)) + s * p2_
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))[..., None]
          * vh)
    wh = vecmath.normalize(
        jnp.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                   jnp.maximum(1e-6, nh[..., 2])], axis=-1))
    return sign * wh


def tr_pdf_wh(wo: Array, wh: Array, alpha: Array) -> Array:
    """VNDF pdf: D(wh) G1(wo) |wo·wh| / |cos wo| (microfacet.h:157)."""
    return (tr_d(wh, alpha) * tr_g1(wo, alpha)
            * jnp.abs(vecmath.dot(wo, wh))
            / jnp.maximum(abs_cos_theta(wo), 1e-6))


# --- anisotropic TR (TrowbridgeReitzDistribution with alphax != alphay,
# microfacet.cpp:115-133; needed by the Disney BSDF's "anisotropic"
# parameter, materials/disney.cpp:541-545)

def tr_d_aniso(wh: Array, ax: Array, ay: Array) -> Array:
    """Anisotropic TR NDF, the ((x/ax)²+(y/ay)²+z²)⁻² form of
    TrowbridgeReitzDistribution::D (microfacet.cpp:115)."""
    e = (wh[..., 0] / ax) ** 2 + (wh[..., 1] / ay) ** 2 + wh[..., 2] ** 2
    denom = jnp.pi * ax * ay * e * e
    return jnp.where(wh[..., 2] > 0, 1.0 / jnp.maximum(denom, 1e-12), 0.0)


def tr_lambda_aniso(w: Array, ax: Array, ay: Array) -> Array:
    """TrowbridgeReitzDistribution::Lambda (microfacet.cpp:123-133) with
    the direction-dependent interpolated alpha."""
    c = jnp.clip(jnp.abs(w[..., 2]), 1e-6, 1.0)
    s2 = jnp.maximum(0.0, 1.0 - c * c)
    # alpha²(φ) = cos²φ·ax² + sin²φ·ay², with cos²φ = x²/sin²θ
    x2 = w[..., 0] ** 2
    y2 = w[..., 1] ** 2
    a2 = jnp.where(s2 > 1e-12,
                   (x2 * ax * ax + y2 * ay * ay)
                   / jnp.maximum(x2 + y2, 1e-12),
                   ax * ax)
    tan2 = s2 / (c * c)
    return 0.5 * (-1.0 + jnp.sqrt(1.0 + a2 * tan2))


def tr_g1_aniso(w: Array, ax: Array, ay: Array) -> Array:
    return 1.0 / (1.0 + tr_lambda_aniso(w, ax, ay))


def tr_sample_wh_aniso(wo: Array, u: Array, ax: Array, ay: Array) -> Array:
    """Anisotropic visible-normal sampling (Heitz 2018, the
    sampleVisibleArea path of TrowbridgeReitz::Sample_wh)."""
    sign = jnp.sign(wo[..., 2:3] + 1e-20)
    v = sign * wo
    vh = vecmath.normalize(
        jnp.stack([ax * v[..., 0], ay * v[..., 1], v[..., 2]], axis=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = jnp.where(
        (lensq > 1e-9)[..., None],
        jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(lensq)], axis=-1)
        / jnp.sqrt(jnp.maximum(lensq, 1e-12))[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), vh.shape))
    t2 = jnp.cross(vh, t1)
    d = concentric_sample_disk(u)
    p1 = d[..., 0]
    p2_ = d[..., 1]
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1)) + s * p2_
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))[..., None]
          * vh)
    wh = vecmath.normalize(
        jnp.stack([ax * nh[..., 0], ay * nh[..., 1],
                   jnp.maximum(1e-6, nh[..., 2])], axis=-1))
    return sign * wh


def tr_pdf_wh_aniso(wo: Array, wh: Array, ax: Array, ay: Array) -> Array:
    """VNDF pdf, anisotropic: D(wh) G1(wo) |wo·wh| / |cos wo|."""
    whu = wh * jnp.sign(wh[..., 2:3] + 1e-20)
    return (tr_d_aniso(whu, ax, ay) * tr_g1_aniso(wo, ax, ay)
            * jnp.abs(vecmath.dot(wo, wh))
            / jnp.maximum(abs_cos_theta(wo), 1e-6))


# ---------------------------------------------------------------------------
# Beckmann–Spizzichino distribution (core/microfacet.h:48-105)
# ---------------------------------------------------------------------------

NDF_TR = 0
NDF_BECKMANN = 1


def beck_d(wh: Array, alpha: Array) -> Array:
    """Isotropic Beckmann NDF (microfacet.cpp BeckmannDistribution::D)."""
    c2 = wh[..., 2] ** 2
    s2 = jnp.maximum(0.0, 1.0 - c2)
    tan2 = s2 / jnp.maximum(c2, 1e-12)
    a2 = jnp.maximum(alpha * alpha, 1e-12)
    d = jnp.exp(-tan2 / a2) / (jnp.pi * a2 * jnp.maximum(c2 * c2, 1e-12))
    return jnp.where(wh[..., 2] > 0, d, 0.0)


def beck_lambda(w: Array, alpha: Array) -> Array:
    """Beckmann Λ, rational approximation (microfacet.cpp:89-97)."""
    c = jnp.clip(jnp.abs(w[..., 2]), 1e-6, 1.0)
    abs_tan = jnp.sqrt(jnp.maximum(0.0, 1.0 - c * c)) / c
    a = 1.0 / jnp.maximum(alpha * abs_tan, 1e-9)
    lam = ((1.0 - 1.259 * a + 0.396 * a * a)
           / jnp.maximum(3.535 * a + 2.181 * a * a, 1e-9))
    return jnp.where(a >= 1.6, 0.0, lam)


def beck_g(wo: Array, wi: Array, alpha: Array) -> Array:
    return 1.0 / (1.0 + beck_lambda(wo, alpha) + beck_lambda(wi, alpha))


def beck_sample_wh_full(wo: Array, u: Array, alpha: Array) -> Array:
    """Full-distribution Beckmann wh sampling (microfacet.cpp Sample_wh,
    !sampleVisibleArea branch: tan²θ = −α² ln(1−u₁)); flipped to wo's
    hemisphere. Kept for A/B variance comparison — the matching pdf
    (beck_pdf_wh_full = D·|cosθ|) keeps the estimator exact."""
    u1 = jnp.minimum(u[..., 0], 0.99999)
    tan2t = -alpha * alpha * jnp.log1p(-u1)
    phi = 2.0 * jnp.pi * u[..., 1]
    cost = 1.0 / jnp.sqrt(1.0 + tan2t)
    sint = jnp.sqrt(jnp.maximum(0.0, 1.0 - cost * cost))
    wh = jnp.stack([sint * jnp.cos(phi), sint * jnp.sin(phi), cost], axis=-1)
    return wh * jnp.sign(wo[..., 2:3] + 1e-20)


def beck_pdf_wh_full(wo: Array, wh: Array, alpha: Array) -> Array:
    """Full-distribution pdf D(wh)·|cosθh| (microfacet.cpp Pdf)."""
    return beck_d(wh, alpha) * abs_cos_theta(wh)


def beck_g1(w: Array, alpha: Array) -> Array:
    return 1.0 / (1.0 + beck_lambda(w, alpha))


_SQRT_PI_INV = 0.5641895835477563  # 1/sqrt(pi)


def _beck_sample11(cos_ti: Array, u1: Array, u2: Array):
    """Slope-space sampling of the visible Beckmann P22 at normal-incidence
    stretch (microfacet.cpp BeckmannSample11:39-118): erf-domain numerical
    CDF inversion — 10 guarded Newton/bisection steps — vectorized and
    branchless; the normal-incidence closed form is where-merged."""
    from jax.scipy.special import erf, erfinv
    sin_ti = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_ti * cos_ti))
    cos_s = jnp.clip(cos_ti, 1e-6, 1.0)
    tan_ti = sin_ti / cos_s
    cot_ti = cos_s / jnp.maximum(sin_ti, 1e-12)
    c_hi = erf(cot_ti)
    sx = jnp.maximum(u1, 1e-6)
    theta_i = jnp.arccos(jnp.clip(cos_ti, -1.0, 1.0))
    fit = 1.0 + theta_i * (-0.876 + theta_i * (0.4265 - 0.0594 * theta_i))
    norm = 1.0 / (1.0 + c_hi + _SQRT_PI_INV * tan_ti
                  * jnp.exp(-cot_ti * cot_ti))

    def body(_, st):
        a, c, b = st
        b = jnp.where((b >= a) & (b <= c), b, 0.5 * (a + c))
        inv_erf = erfinv(jnp.clip(b, -0.999999, 0.999999))
        value = (norm * (1.0 + b + _SQRT_PI_INV * tan_ti
                         * jnp.exp(-inv_erf * inv_erf)) - sx)
        deriv = norm * (1.0 - inv_erf * tan_ti)
        c = jnp.where(value > 0, b, c)
        a = jnp.where(value > 0, a, b)
        step = value / jnp.where(jnp.abs(deriv) > 1e-12, deriv,
                                 jnp.where(deriv >= 0, 1e-12, -1e-12))
        b = jnp.where(jnp.abs(value) < 1e-5, b, b - step)
        return a, c, b

    a0 = jnp.full_like(c_hi, -1.0)
    b0 = c_hi - (1.0 + c_hi) * jnp.power(jnp.maximum(1.0 - sx, 1e-12), fit)
    _, _, b = jax.lax.fori_loop(0, 10, body, (a0, c_hi, b0))
    slope_x = erfinv(jnp.clip(b, -0.999999, 0.999999))
    slope_y = erfinv(jnp.clip(2.0 * jnp.maximum(u2, 1e-6) - 1.0,
                              -0.999999, 0.999999))
    # normal incidence (cosThetaI > .9999): exact polar closed form
    r = jnp.sqrt(-jnp.log1p(-jnp.minimum(u1, 0.999999)))
    phi = 2.0 * jnp.pi * u2
    near_n = cos_ti > 0.9999
    slope_x = jnp.where(near_n, r * jnp.cos(phi), slope_x)
    slope_y = jnp.where(near_n, r * jnp.sin(phi), slope_y)
    return slope_x, slope_y


def beck_sample_wh(wo: Array, u: Array, alpha: Array) -> Array:
    """Visible-normal Beckmann sampling — the reference's default
    (microfacet.h:105 sampleVisibleArea=true; microfacet.cpp
    BeckmannSample:120-140): stretch wo by α, sample the slope-space P22,
    rotate/unstretch, flip to wo's hemisphere."""
    flip = wo[..., 2:3] < 0
    wi = jnp.where(flip, -wo, wo)
    wi_s = vecmath.normalize(
        jnp.stack([alpha * wi[..., 0], alpha * wi[..., 1], wi[..., 2]],
                  axis=-1))
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - wi_s[..., 2] ** 2))
    cos_phi = jnp.where(sin_t > 1e-9, wi_s[..., 0]
                        / jnp.maximum(sin_t, 1e-12), 1.0)
    sin_phi = jnp.where(sin_t > 1e-9, wi_s[..., 1]
                        / jnp.maximum(sin_t, 1e-12), 0.0)
    sx, sy = _beck_sample11(wi_s[..., 2], u[..., 0], u[..., 1])
    tmp = cos_phi * sx - sin_phi * sy
    sy = sin_phi * sx + cos_phi * sy
    sx = tmp
    sx = alpha * sx
    sy = alpha * sy
    wh = vecmath.normalize(
        jnp.stack([-sx, -sy, jnp.ones_like(sx)], axis=-1))
    return jnp.where(flip, -wh, wh)


def beck_pdf_wh(wo: Array, wh: Array, alpha: Array) -> Array:
    """Visible-normal pdf D(wh)·G1(wo)·|wo·wh| / |cosθo|
    (microfacet.cpp MicrofacetDistribution::Pdf, sampleVisibleArea)."""
    return (beck_d(wh, alpha) * beck_g1(wo, alpha)
            * jnp.abs(vecmath.dot(wo, wh))
            / jnp.maximum(abs_cos_theta(wo), 1e-6))


# --- NDF dispatch: helpers take an optional per-row ndf tag; None → TR
# (static specialization like MaterialTable.present — Beckmann math only
# enters the program when a material row requests it)

def mf_d(wh, alpha, ndf=None):
    d = tr_d(wh, alpha)
    return d if ndf is None else jnp.where(ndf == NDF_BECKMANN,
                                           beck_d(wh, alpha), d)


def mf_g(wo, wi, alpha, ndf=None):
    g = tr_g(wo, wi, alpha)
    return g if ndf is None else jnp.where(ndf == NDF_BECKMANN,
                                           beck_g(wo, wi, alpha), g)


def mf_sample_wh(wo, u, alpha, ndf=None):
    wh = tr_sample_wh(wo, u, alpha)
    if ndf is None:
        return wh
    return jnp.where((ndf == NDF_BECKMANN)[..., None],
                     beck_sample_wh(wo, u, alpha), wh)


def mf_pdf_wh(wo, wh, alpha, ndf=None):
    p = tr_pdf_wh(wo, wh, alpha)
    return p if ndf is None else jnp.where(ndf == NDF_BECKMANN,
                                           beck_pdf_wh(wo, wh, alpha), p)


# ---------------------------------------------------------------------------
# Lobe evaluation (non-specular lobes contribute to f/pdf)
# ---------------------------------------------------------------------------

def _oren_nayar_f(kd, sigma_deg, wo, wi):
    """OrenNayar::f (reflection.cpp:86+); sigma in degrees."""
    sigma = jnp.radians(sigma_deg)
    s2 = sigma * sigma
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    sin_theta_i = jnp.sqrt(jnp.maximum(0.0, 1.0 - wi[..., 2] ** 2))
    sin_theta_o = jnp.sqrt(jnp.maximum(0.0, 1.0 - wo[..., 2] ** 2))
    # cos(phi_i - phi_o)
    denom_i = jnp.maximum(sin_theta_i, 1e-6)
    denom_o = jnp.maximum(sin_theta_o, 1e-6)
    cos_dphi = ((wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1])
                / (denom_i * denom_o))
    max_cos = jnp.where((sin_theta_i > 1e-4) & (sin_theta_o > 1e-4),
                        jnp.maximum(0.0, cos_dphi), 0.0)
    abs_ci = jnp.abs(wi[..., 2])
    abs_co = jnp.abs(wo[..., 2])
    sin_alpha = jnp.where(abs_ci > abs_co, sin_theta_o, sin_theta_i)
    tan_beta = jnp.where(abs_ci > abs_co,
                         sin_theta_i / jnp.maximum(abs_ci, 1e-6),
                         sin_theta_o / jnp.maximum(abs_co, 1e-6))
    return kd * (INV_PI
                 * (A + B * max_cos * sin_alpha * tan_beta))[..., None]


def _microfacet_reflection_f(Rs, alpha, fresnel, wo, wi, ndf=None):
    """MicrofacetReflection::f (reflection.cpp:303+). ``fresnel`` maps
    cos(wh·wi) → (...,C)."""
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh = wo + wi
    degenerate = (vecmath.length_squared(wh) < 1e-12) | (ci < 1e-6) \
        | (co < 1e-6)
    wh = vecmath.normalize(wh)
    F = fresnel(vecmath.dot(wi, wh))
    f = (Rs * (mf_d(wh, alpha, ndf) * mf_g(wo, wi, alpha, ndf))[..., None] * F
         / jnp.maximum(4.0 * ci * co, 1e-6)[..., None])
    return jnp.where(degenerate[..., None], 0.0, f)


def _microfacet_reflection_pdf(alpha, wo, wi, ndf=None):
    wh = vecmath.normalize(wo + wi)
    pdf = mf_pdf_wh(wo, wh, alpha, ndf) / jnp.maximum(
        4.0 * jnp.abs(vecmath.dot(wo, wh)), 1e-6)
    return jnp.where(same_hemisphere(wo, wi), pdf, 0.0)


def _microfacet_transmission_f(Kt, alpha, eta, wo, wi, ndf=None):
    """MicrofacetTransmission::f (reflection.cpp:338+), radiance mode.

    eta: (R,) dielectric IOR (etaB with etaA=1); valid only for wo/wi in
    opposite hemispheres.
    """
    cos_o = cos_theta(wo)
    cos_i = cos_theta(wi)
    # etaT/etaI as seen from wo's side of the boundary
    eta_p = jnp.where(cos_o > 0.0, eta, 1.0 / eta)
    wh = wo + wi * eta_p[..., None]
    degenerate = (vecmath.length_squared(wh) < 1e-12) \
        | (jnp.abs(cos_i * cos_o) < 1e-7)
    # double-where: masked lanes must not see normalize(0) (NaN grads)
    wh = jnp.where(degenerate[..., None],
                   jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), wh.shape),
                   wh)
    wh = vecmath.normalize(wh)
    # orient into the upper hemisphere (D is defined there)
    wh = wh * jnp.sign(wh[..., 2:3] + 1e-20)
    dot_o = vecmath.dot(wo, wh)
    dot_i = vecmath.dot(wi, wh)
    valid = (dot_o * dot_i < 0.0) & ~same_hemisphere(wo, wi) & ~degenerate
    F = fr_dielectric(dot_o, jnp.ones_like(eta), eta)
    sqrt_denom = dot_o + eta_p * dot_i
    factor = 1.0 / eta_p  # radiance-transport scaling (reflection.cpp:352)
    val = ((1.0 - F) * jnp.abs(
        mf_d(wh, alpha, ndf) * mf_g(wo, wi, alpha, ndf) * eta_p * eta_p
        * jnp.abs(dot_i) * jnp.abs(dot_o) * factor * factor
        / jnp.maximum(jnp.abs(cos_i * cos_o * sqrt_denom * sqrt_denom),
                      1e-10)))
    return jnp.where(valid[..., None], Kt * val[..., None], 0.0)


def _microfacet_transmission_pdf(alpha, eta, wo, wi, ndf=None):
    """MicrofacetTransmission::Pdf: VNDF pdf(wh) · |dwh/dwi|."""
    cos_o = cos_theta(wo)
    eta_p = jnp.where(cos_o > 0.0, eta, 1.0 / eta)
    wh = wo + wi * eta_p[..., None]
    degenerate = vecmath.length_squared(wh) < 1e-12
    wh = jnp.where(degenerate[..., None],
                   jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), wh.shape),
                   wh)
    wh = vecmath.normalize(wh)
    dot_o = vecmath.dot(wo, wh)
    dot_i = vecmath.dot(wi, wh)
    valid = (dot_o * dot_i < 0.0) & ~same_hemisphere(wo, wi) & ~degenerate
    whu = wh * jnp.sign(wh[..., 2:3] + 1e-20)
    sqrt_denom = dot_o + eta_p * dot_i
    dwh_dwi = jnp.abs((eta_p * eta_p * dot_i)
                      / jnp.maximum(sqrt_denom * sqrt_denom, 1e-10))
    return jnp.where(valid, mf_pdf_wh(wo, whu, alpha, ndf) * dwh_dwi, 0.0)


def _pow5(x):
    return x * x * x * x * x


def _fresnel_moment1(eta):
    """First Fresnel reflectance moment (bssrdf.cpp:43-53), jnp form for
    per-ray eta. Both fit branches traced; selected by eta<1."""
    e = eta
    e2 = e * e
    e3 = e2 * e
    e4 = e3 * e
    e5 = e4 * e
    lo = (0.45966 - 1.73965 * e + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * e - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return jnp.where(e < 1.0, lo, hi)


def _sss_exit_sw(mp: MaterialTable, wi):
    """SeparableBSSRDF::Sw (core/bssrdf.h:89-92): the Fresnel-weighted
    exit lobe at a BSSRDF exit vertex — (1 − Fr(cosθ_wi)) / (c·π) with
    c = 1 − 2·FresnelMoment1(1/η).

    No η² adjoint factor (SeparableBSSRDFAdapter::f:159-163): pbrt pairs
    it with the 1/η² of the entry SpecularTransmission in radiance mode;
    our entry is a probability branch with no η factor, so both are
    omitted — the product matches."""
    C = mp.kd.shape[-1]
    c_norm = 1.0 - 2.0 * _fresnel_moment1(1.0 / jnp.maximum(mp.eta, 1e-3))
    fr = fr_dielectric(cos_theta(wi), jnp.ones_like(mp.eta), mp.eta)
    sw = (1.0 - fr) / jnp.maximum(c_norm * jnp.pi, 1e-6)
    return sw[..., None] * jnp.ones((1, C))


def _disney_lum(c):
    """Spectrum::y() used for the Disney tint normalization
    (disney.cpp:494: `Float lum = c.y()`)."""
    from pbrt_tpu.core import spectrum as spec_mod
    if c.shape[-1] == 3:
        return spec_mod.luminance(c, spec_mod.RGB)
    if c.shape[-1] == spec_mod.SAMPLED.n_channels:
        return spec_mod.luminance(c, spec_mod.SAMPLED)
    return jnp.mean(c, axis=-1)


def _disney_alphas(mp: MaterialTable):
    """Disney microfacet alphas (disney.cpp:541-545): alpha = roughness²
    (NOT the RoughnessToAlpha log remap), split by the anisotropy aspect."""
    aspect = jnp.sqrt(1.0 - mp.anisotropic * 0.9)
    r2 = mp.roughness * mp.roughness
    ax = jnp.maximum(0.001, r2 / aspect)
    ay = jnp.maximum(0.001, r2 * aspect)
    return ax, ay


def _disney_trans_alphas(mp: MaterialTable):
    """Alphas of the transmission distribution: the shared (ax, ay) for
    solid surfaces; for thin, roughness is IOR-scaled first
    (disney.cpp:573-578, Burley 2015 fig. 15)."""
    ax, ay = _disney_alphas(mp)
    aspect = jnp.sqrt(1.0 - mp.anisotropic * 0.9)
    rscaled = (0.65 * mp.eta - 0.35) * mp.roughness
    r2 = rscaled * rscaled
    axs = jnp.maximum(0.001, r2 / aspect)
    ays = jnp.maximum(0.001, r2 * aspect)
    thin = mp.thin > 0.5
    return jnp.where(thin, axs, ax), jnp.where(thin, ays, ay)


def _gtr1(cos_h, alpha):
    """GTR1 NDF (disney.cpp:252-256)."""
    a2 = alpha * alpha
    return (a2 - 1.0) / jnp.maximum(
        jnp.pi * jnp.log(jnp.maximum(a2, 1e-9))
        * (1.0 + (a2 - 1.0) * cos_h * cos_h), 1e-9)


def _smith_g_ggx(cos_t, alpha):
    """smithG_GGX (disney.cpp:259-264): 1/(cosθ + √(α²+cos²θ−α²cos²θ)) —
    the cosines of the standard G1 are folded in, so clearcoat f is
    weight·Gr·Fr·Dr/4 with no extra 1/(4 cosθo cosθi)."""
    a2 = alpha * alpha
    c2 = cos_t * cos_t
    return 1.0 / jnp.maximum(cos_t + jnp.sqrt(a2 + c2 - a2 * c2), 1e-6)


def _disney_cc_gloss(mp: MaterialTable):
    return (1.0 - mp.clearcoat_gloss) * 0.1 + mp.clearcoat_gloss * 0.001


def _disney_sss_mask(mp: MaterialTable):
    """Rows whose DisneyDiffuse lobe is replaced by {SpecularTransmission
    entry + DisneyBSSRDF} (disney.cpp:506-527: non-thin, diffuseWeight>0,
    scatterdistance non-black)."""
    dw = (1.0 - mp.metallic) * (1.0 - mp.spec_trans)
    return ((jnp.max(mp.scatter_d, axis=-1) > 0)
            & ~(mp.thin > 0.5) & (dw > 0))


def _disney_lobe_counts(mp: MaterialTable):
    """Per-row lobe census matching DisneyMaterial::
    ComputeScatteringFunctions (disney.cpp:504-589). pbrt's BSDF::Sample_f
    picks uniformly among the added lobes and BSDF::Pdf averages their
    pdfs; the four diffuse-family lobes (DisneyDiffuse, FakeSS, Retro,
    Sheen) all cosine-sample, so they fold into one cosine lobe with
    multiplicity k_diff.

    scatterdistance rows (non-thin) swap DisneyDiffuse for a delta
    SpecularTransmission BSSRDF-entry lobe (:519-527): k_diff drops by
    one and n_entry = 1 joins the census. The entry lobe counts in
    n_total (BSDF::Pdf's matchingComps includes specular components) but
    is SAMPLED by subsurface_transport, not by the direction sampler.

    Returns (k_diff, n_cc, n_mt, n_lt, n_total, n_entry), all (R,)
    float."""
    thin = mp.thin > 0.5
    dw = (1.0 - mp.metallic) * (1.0 - mp.spec_trans)
    has_diff = dw > 0
    k_diff = jnp.where(
        has_diff,
        jnp.where(thin, 3.0, 2.0) + (mp.sheen > 0).astype(jnp.float32),
        0.0)
    n_entry = jnp.zeros_like(k_diff)
    if mp.has_disney_sss:
        sss = _disney_sss_mask(mp)
        k_diff = jnp.where(sss, k_diff - 1.0, k_diff)
        n_entry = jnp.where(sss, 1.0, 0.0)
    n_cc = (mp.clearcoat > 0).astype(jnp.float32)
    n_mt = (mp.spec_trans > 0).astype(jnp.float32)
    n_lt = thin.astype(jnp.float32)       # LambertianTransmission (:585-589)
    # +1 = MicrofacetReflection
    n = k_diff + 1.0 + n_cc + n_mt + n_lt + n_entry
    return k_diff, n_cc, n_mt, n_lt, n, n_entry


def _disney_f_refl(mp: MaterialTable, kd, wo, wi):
    """Reflection-side Disney lobes (disney.cpp:92-363 lobe classes, wired
    per :504-564): Burley diffuse + fake-subsurface + retro + sheen +
    anisotropic-GGX specular with DisneyFresnel + GTR1 clearcoat."""
    C = kd.shape[-1]
    c = jnp.maximum(kd, 0.0)
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh = wo + wi
    wh_ok = vecmath.length_squared(wh) > 1e-12
    wh = jnp.where(wh_ok[..., None],
                   wh, jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]),
                                        wh.shape))
    wh = vecmath.normalize(wh)
    cos_d = vecmath.dot(wi, wh)

    lum = _disney_lum(c)
    tint = jnp.where((lum > 0)[..., None],
                     c / jnp.maximum(lum, 1e-6)[..., None], 1.0)

    strans = mp.spec_trans
    dw = (1.0 - mp.metallic) * (1.0 - strans)   # diffuseWeight (:489)
    dt = mp.diff_trans * 0.5                     # (:490-491)
    thin = mp.thin > 0.5
    rough = mp.roughness

    fo = _pow5(1.0 - co)
    fi = _pow5(1.0 - ci)
    # DisneyDiffuse (:105-112); thin blends it against FakeSS by flatness
    # and scales by (1-dt) (:508-512)
    base_diff = c * (INV_PI * (1.0 - 0.5 * fo) * (1.0 - 0.5 * fi)
                     )[..., None]
    # DisneyFakeSS — Hanrahan–Krueger approximation (:139-156)
    fss90 = cos_d * cos_d * rough
    fss = (1.0 + fo * (fss90 - 1.0)) * (1.0 + fi * (fss90 - 1.0))
    ss = 1.25 * (fss * (1.0 / jnp.maximum(co + ci, 1e-6) - 0.5) + 0.5)
    fake_ss = c * (INV_PI * ss)[..., None]
    w_base = jnp.where(thin, (1.0 - mp.flatness) * (1.0 - dt), 1.0)
    w_fake = jnp.where(thin, mp.flatness * (1.0 - dt), 0.0)
    if mp.has_disney_sss:
        # scatterdistance rows have no DisneyDiffuse lobe — the BSSRDF
        # replaces it (:519-527); retro and sheen stay
        w_base = jnp.where(_disney_sss_mask(mp), 0.0, w_base)
    # DisneyRetro (:182-197)
    rr = 2.0 * rough * cos_d * cos_d
    retro = c * (INV_PI * rr * (fo + fi + fo * fi * (rr - 1.0)))[..., None]
    # DisneySheen (:216-224)
    csheen = (1.0 - mp.sheen_tint)[..., None] + mp.sheen_tint[..., None] \
        * tint
    sheen = mp.sheen[..., None] * csheen * _pow5(1.0 - jnp.abs(cos_d)
                                                 )[..., None]
    diffuse_part = dw[..., None] * (w_base[..., None] * base_diff
                                    + w_fake[..., None] * fake_ss
                                    + retro + sheen)

    # MicrofacetReflection with DisneyMicrofacetDistribution (separable
    # G1·G1, :347-363) and DisneyFresnel (:326-344):
    # lerp(metallic, FrDielectric, FrSchlick(Cspec0))
    ax, ay = _disney_alphas(mp)
    r0 = ((mp.eta - 1.0) / (mp.eta + 1.0)) ** 2
    cspec0 = ((1.0 - mp.metallic)[..., None]
              * r0[..., None] * ((1.0 - mp.spec_tint)[..., None]
                                 + mp.spec_tint[..., None] * tint)
              + mp.metallic[..., None] * c)
    fr_d = fr_dielectric(cos_d, jnp.ones_like(mp.eta), mp.eta)
    fr_schlick = cspec0 + (1.0 - cspec0) * _pow5(
        1.0 - jnp.abs(cos_d))[..., None]
    f_spec_fres = ((1.0 - mp.metallic)[..., None] * fr_d[..., None]
                   + mp.metallic[..., None] * fr_schlick)
    g_sep = tr_g1_aniso(wo, ax, ay) * tr_g1_aniso(wi, ax, ay)
    spec = (tr_d_aniso(wh, ax, ay) * g_sep
            / jnp.maximum(4.0 * ci * co, 1e-6))[..., None] * f_spec_fres

    # DisneyClearcoat (:266-283): weight·Gr·Fr·Dr/4, Gr = smithG_GGX(.25)²
    gloss = _disney_cc_gloss(mp)
    d_cc = _gtr1(jnp.abs(wh[..., 2]), gloss)
    f_cc = 0.04 + 0.96 * _pow5(1.0 - jnp.abs(vecmath.dot(wo, wh)))
    g_cc = _smith_g_ggx(co, 0.25) * _smith_g_ggx(ci, 0.25)
    cc = (0.25 * mp.clearcoat * d_cc * f_cc * g_cc)[..., None] \
        * jnp.ones((1, C))

    out = diffuse_part + spec + cc
    ok = same_hemisphere(wo, wi) & wh_ok
    return jnp.where(ok[..., None], out, 0.0)


def _disney_f_trans(mp: MaterialTable, kd, wo, wi):
    """Transmission-side Disney lobes (disney.cpp:566-589):
    MicrofacetTransmission with T = strans·√c (+ thin roughness scaling)
    and, for thin surfaces, LambertianTransmission dt·c."""
    c = jnp.maximum(kd, 0.0)
    T = mp.spec_trans[..., None] * jnp.sqrt(c)
    axt, ayt = _disney_trans_alphas(mp)
    # thin surfaces use the plain TR distribution (correlated G,
    # microfacet.h:113); solid uses DisneyMicrofacet (separable G1·G1)
    sep_g = ~(mp.thin > 0.5)
    mt = _mt_f_aniso(T, axt, ayt, mp.eta, wo, wi, sep_g=sep_g)
    dt = mp.diff_trans * 0.5
    lt = (dt[..., None] * c) * INV_PI
    lt = jnp.where((mp.thin > 0.5)[..., None], lt, 0.0)
    return jnp.where(same_hemisphere(wo, wi)[..., None], 0.0, mt + lt)


def _disney_f(mp: MaterialTable, kd, wo, wi):
    """Full Disney BSDF f(wo, wi) — reflection + (when the table has
    spectrans/thin rows) transmission lobes."""
    out = _disney_f_refl(mp, kd, wo, wi)
    if mp.has_disney_trans:
        out = out + _disney_f_trans(mp, kd, wo, wi)
    return out


def _mt_f_aniso(T, ax, ay, eta, wo, wi, sep_g):
    """Anisotropic MicrofacetTransmission::f (reflection.cpp:279-304),
    radiance mode; `sep_g` (R,) bool selects Disney's separable G1·G1 over
    the correlated Smith G."""
    cos_o = cos_theta(wo)
    cos_i = cos_theta(wi)
    eta_p = jnp.where(cos_o > 0.0, eta, 1.0 / eta)
    wh = wo + wi * eta_p[..., None]
    degenerate = (vecmath.length_squared(wh) < 1e-12) \
        | (jnp.abs(cos_i * cos_o) < 1e-7)
    wh = jnp.where(degenerate[..., None],
                   jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), wh.shape),
                   wh)
    wh = vecmath.normalize(wh)
    wh = wh * jnp.sign(wh[..., 2:3] + 1e-20)
    dot_o = vecmath.dot(wo, wh)
    dot_i = vecmath.dot(wi, wh)
    valid = (dot_o * dot_i < 0.0) & ~same_hemisphere(wo, wi) & ~degenerate
    F = fr_dielectric(dot_o, jnp.ones_like(eta), eta)
    sqrt_denom = dot_o + eta_p * dot_i
    factor = 1.0 / eta_p
    g_corr = 1.0 / (1.0 + tr_lambda_aniso(wo, ax, ay)
                    + tr_lambda_aniso(wi, ax, ay))
    g_sep = tr_g1_aniso(wo, ax, ay) * tr_g1_aniso(wi, ax, ay)
    G = jnp.where(sep_g, g_sep, g_corr)
    val = ((1.0 - F) * jnp.abs(
        tr_d_aniso(wh, ax, ay) * G * eta_p * eta_p
        * jnp.abs(dot_i) * jnp.abs(dot_o) * factor * factor
        / jnp.maximum(jnp.abs(cos_i * cos_o * sqrt_denom * sqrt_denom),
                      1e-10)))
    return jnp.where(valid[..., None], T * val[..., None], 0.0)


def _mt_pdf_aniso(ax, ay, eta, wo, wi):
    """Anisotropic MicrofacetTransmission::Pdf (reflection.cpp:477-494):
    VNDF pdf(wh) · |dwh/dwi|."""
    cos_o = cos_theta(wo)
    eta_p = jnp.where(cos_o > 0.0, eta, 1.0 / eta)
    wh = wo + wi * eta_p[..., None]
    degenerate = vecmath.length_squared(wh) < 1e-12
    wh = jnp.where(degenerate[..., None],
                   jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), wh.shape),
                   wh)
    wh = vecmath.normalize(wh)
    dot_o = vecmath.dot(wo, wh)
    dot_i = vecmath.dot(wi, wh)
    valid = (dot_o * dot_i < 0.0) & ~same_hemisphere(wo, wi) & ~degenerate
    whu = wh * jnp.sign(wh[..., 2:3] + 1e-20)
    sqrt_denom = dot_o + eta_p * dot_i
    dwh_dwi = jnp.abs((eta_p * eta_p * dot_i)
                      / jnp.maximum(sqrt_denom * sqrt_denom, 1e-10))
    return jnp.where(valid,
                     tr_pdf_wh_aniso(wo, whu, ax, ay) * dwh_dwi, 0.0)


def _disney_cc_pdf(mp: MaterialTable, wo, wi):
    """DisneyClearcoat::Pdf (disney.cpp:307-320): GTR1 D(wh)·|cosθh| /
    (4·(wo·wh))."""
    wh = wo + wi
    wh_ok = vecmath.length_squared(wh) > 1e-12
    wh = jnp.where(wh_ok[..., None],
                   wh, jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]),
                                        wh.shape))
    wh = vecmath.normalize(wh)
    gloss = _disney_cc_gloss(mp)
    d_cc = _gtr1(jnp.abs(wh[..., 2]), gloss)
    pdf = d_cc * jnp.abs(wh[..., 2]) \
        / jnp.maximum(4.0 * jnp.abs(vecmath.dot(wo, wh)), 1e-6)
    return jnp.where(same_hemisphere(wo, wi) & wh_ok, pdf, 0.0)


def _disney_pdf(mp: MaterialTable, wo, wi):
    """BSDF::Pdf over the Disney lobe set: the average of per-lobe pdfs
    (reflection.cpp:637-650 with the uniform lobe weighting), with the
    cosine-sampled diffuse family folded to multiplicity k_diff."""
    k_diff, n_cc, n_mt, n_lt, n, _ = _disney_lobe_counts(mp)
    refl = same_hemisphere(wo, wi)
    cos_pdf = abs_cos_theta(wi) * INV_PI
    ax, ay = _disney_alphas(mp)
    mf_pdf = jnp.where(refl, tr_pdf_wh_aniso(
        wo, vecmath.normalize(wo + wi), ax, ay)
        / jnp.maximum(4.0 * jnp.abs(vecmath.dot(
            wo, vecmath.normalize(wo + wi))), 1e-6), 0.0)
    wh_sum = wo + wi
    mf_pdf = jnp.where(vecmath.length_squared(wh_sum) > 1e-12, mf_pdf, 0.0)
    pdf = k_diff * jnp.where(refl, cos_pdf, 0.0) + mf_pdf
    pdf = pdf + n_cc * _disney_cc_pdf(mp, wo, wi)
    if mp.has_disney_trans:
        axt, ayt = _disney_trans_alphas(mp)
        pdf = pdf + n_mt * _mt_pdf_aniso(axt, ayt, mp.eta, wo, wi)
        pdf = pdf + n_lt * jnp.where(refl, 0.0, cos_pdf)
    return pdf / jnp.maximum(n, 1.0)


@dataclasses.dataclass
class LobeMix:
    """Per-ray description of the effective BSDF as a mixture of primitive
    lobes; weights already include fresnel-independent scales."""
    diff_weight: Array    # (R,C) lambert/oren-nayar weight
    use_oren: Array       # (R,) bool
    gloss_weight: Array   # (R,C) microfacet reflection weight (unit fresnel)
    gloss_fresnel: str
    spec_weight: Array


def _mat_alpha(mp: MaterialTable) -> Array:
    return jnp.maximum(roughness_to_alpha(mp.roughness), 1e-4)


def bsdf_f(mp: MaterialTable, wo: Array, wi: Array, kd_override=None,
           h=None, fourier=None) -> Array:
    """Evaluate the non-delta part of the BSDF: f(wo, wi), (R,C).

    Mirrors BSDF::f dispatch over lobes (reflection.cpp:575+): each
    material type's non-specular lobes are evaluated and masked together.
    ``h`` (R,) is the hair azimuthal offset (curve ribbon v → [−1,1]);
    ``fourier`` is the scene's stacked FourierBSDF tables. Both are only
    consulted when the table's static family flags say the type exists.
    """
    t = mp.mtype
    C = mp.kd.shape[-1]
    refl = same_hemisphere(wo, wi)
    kd = mp.kd if kd_override is None else kd_override
    zero = jnp.zeros(wo.shape[:-1] + (C,))
    out = zero
    alpha = _mat_alpha(mp)
    ndf = mp.ndf if mp.has_beckmann else None
    fres_d = lambda c: fr_dielectric(c, jnp.ones_like(mp.eta),
                                     mp.eta)[..., None] * jnp.ones((1, C))

    if _present(mp, MATTE, PLASTIC, UBER):
        # matte: lambertian or oren-nayar (materials/matte.cpp:55-66)
        lamb = kd * INV_PI
        on = _oren_nayar_f(kd, mp.sigma, wo, wi)
        matte_f = jnp.where((mp.sigma > 0.0)[..., None], on, lamb)
        matte_f = jnp.where(refl[..., None], matte_f, zero)
        if _present(mp, MATTE):
            out = jnp.where((t == MATTE)[..., None], matte_f, out)

    if _present(mp, SSS_EXIT):
        sw = _sss_exit_sw(mp, wi)
        sw = jnp.where(refl[..., None], sw, zero)
        out = jnp.where((t == SSS_EXIT)[..., None], sw, out)

    if _present(mp, PLASTIC, UBER):
        # plastic: lambert + TR microfacet with dielectric fresnel; uber's
        # non-specular lobes coincide (materials/{plastic,uber}.cpp)
        plastic_f = matte_f + jnp.where(
            refl[..., None],
            _microfacet_reflection_f(mp.ks, alpha, fres_d, wo, wi,
                                     ndf=ndf), zero)
        out = jnp.where(((t == PLASTIC) | (t == UBER))[..., None],
                        plastic_f, out)

    if _present(mp, METAL):
        # metal: TR microfacet with conductor fresnel (materials/metal.cpp)
        fres_c = lambda c: fr_conductor(c, mp.metal_eta, mp.metal_k)
        metal_f = jnp.where(refl[..., None],
                            _microfacet_reflection_f(
                                jnp.ones_like(mp.ks), alpha, fres_c, wo,
                                wi, ndf=ndf),
                            zero)
        out = jnp.where((t == METAL)[..., None], metal_f, out)

    if _present(mp, SUBSTRATE):
        # substrate: FresnelBlend (reflection.cpp:327+)
        pow5 = lambda x: x * x * x * x * x
        rd, rs = kd, mp.ks
        diffuse = ((28.0 / (23.0 * jnp.pi)) * rd * (1.0 - rs)
                   * (1.0 - pow5(1.0 - 0.5 * abs_cos_theta(wi)))[..., None]
                   * (1.0 - pow5(1.0 - 0.5 * abs_cos_theta(wo)))[..., None])
        wh = wo + wi
        wh_ok = vecmath.length_squared(wh) > 1e-12
        whn = vecmath.normalize(wh)
        schlick = rs + pow5(
            1.0 - jnp.abs(vecmath.dot(wi, whn)))[..., None] * (1.0 - rs)
        spec = (mf_d(whn, alpha, ndf)
                / jnp.maximum(4.0 * jnp.abs(vecmath.dot(wi, whn))
                              * jnp.maximum(abs_cos_theta(wi),
                                            abs_cos_theta(wo)), 1e-6)
                )[..., None] * schlick
        substrate_f = jnp.where((refl & wh_ok)[..., None], diffuse + spec,
                                zero)
        out = jnp.where((t == SUBSTRATE)[..., None], substrate_f, out)

    if _present(mp, TRANSLUCENT):
        # translucent: lambertian reflection + lambertian transmission
        trans_f = jnp.where(refl[..., None], kd * (0.5 * INV_PI),
                            mp.kt * (0.5 * INV_PI))
        out = jnp.where((t == TRANSLUCENT)[..., None], trans_f, out)

    if _present(mp, GLASS):
        # rough glass (GLASS with roughness>0): microfacet reflection +
        # microfacet transmission (materials/glass.cpp:58-76)
        rough_glass_f = jnp.where(
            refl[..., None],
            _microfacet_reflection_f(mp.kr, alpha, fres_d, wo, wi,
                                     ndf=ndf),
            _microfacet_transmission_f(mp.kt, alpha, mp.eta, wo, wi,
                                       ndf=ndf))
        glass_rough = (t == GLASS) & (mp.roughness > 1e-3)
        out = jnp.where(glass_rough[..., None], rough_glass_f, out)

    if _present(mp, DISNEY):
        out = jnp.where((t == DISNEY)[..., None], _disney_f(mp, kd, wo, wi),
                        out)
    if mp.has_hair:
        from pbrt_tpu.scene import hair as hair_mod
        hh = jnp.zeros(wo.shape[:-1]) if h is None else h
        hf = hair_mod.hair_f(wo, wi, hh, mp.sss_sigma_a,
                             mp.beta_m, mp.beta_n, mp.hair_alpha, mp.eta)
        out = jnp.where((t == HAIR)[..., None], hf, out)
    if mp.has_fourier and fourier is not None:
        from pbrt_tpu.scene import fourier as fourier_mod
        ff = fourier_mod.eval_fourier_set(fourier, mp.fourier_id, wo, wi, C)
        out = jnp.where((t == FOURIER)[..., None], ff, out)
    # MIRROR / smooth GLASS / DISPERSIVE_GLASS are pure-delta: f = 0
    return out


def bsdf_pdf(mp: MaterialTable, wo: Array, wi: Array, h=None,
             fourier=None) -> Array:
    """Solid-angle pdf of bsdf_sample for non-delta materials (R,)."""
    t = mp.mtype
    refl = same_hemisphere(wo, wi)
    cos_pdf = jnp.where(refl, abs_cos_theta(wi) * INV_PI, 0.0)
    alpha = _mat_alpha(mp)
    ndf = mp.ndf if mp.has_beckmann else None
    out = jnp.zeros(wo.shape[:-1])
    if _present(mp, PLASTIC, UBER, SUBSTRATE, METAL, GLASS, DISNEY):
        mf_pdf = _microfacet_reflection_pdf(alpha, wo, wi, ndf=ndf)

    if _present(mp, MATTE):
        out = jnp.where(t == MATTE, cos_pdf, out)
    if _present(mp, SSS_EXIT):
        out = jnp.where(t == SSS_EXIT, cos_pdf, out)
    if _present(mp, PLASTIC, UBER, SUBSTRATE):
        plastic_pdf = 0.5 * (cos_pdf + mf_pdf)
        out = jnp.where((t == PLASTIC) | (t == UBER) | (t == SUBSTRATE),
                        plastic_pdf, out)
    if _present(mp, METAL):
        out = jnp.where(t == METAL, mf_pdf, out)
    if _present(mp, TRANSLUCENT):
        trans_pdf = 0.5 * abs_cos_theta(wi) * INV_PI
        out = jnp.where(t == TRANSLUCENT, trans_pdf, out)
    if _present(mp, GLASS):
        glass_rough = (t == GLASS) & (mp.roughness > 1e-3)
        # two matching lobes → BSDF::Pdf averages them (reflection.cpp:643+);
        # each lobe is zero on the other's hemisphere
        rough_glass_pdf = 0.5 * (
            mf_pdf + _microfacet_transmission_pdf(alpha, mp.eta, wo, wi,
                                                  ndf=ndf))
        out = jnp.where(glass_rough, rough_glass_pdf, out)
    if _present(mp, DISNEY):
        out = jnp.where(t == DISNEY, _disney_pdf(mp, wo, wi), out)
    if mp.has_hair:
        from pbrt_tpu.scene import hair as hair_mod
        hh = jnp.zeros(wo.shape[:-1]) if h is None else h
        hp = hair_mod.hair_pdf(wo, wi, hh, mp.sss_sigma_a,
                               mp.beta_m, mp.beta_n, mp.hair_alpha, mp.eta)
        out = jnp.where(t == HAIR, hp, out)
    if mp.has_fourier:
        # fourier sampling uses a two-sided cosine lobe (see bsdf_sample)
        f_pdf = 0.5 * abs_cos_theta(wi) * INV_PI
        out = jnp.where(t == FOURIER, f_pdf, out)
    return out


def bsdf_sample(mp: MaterialTable, wo: Array, u_lobe: Array, u: Array,
                kd_override=None, eta_override=None, h=None, fourier=None):
    """Sample wi ~ BSDF (BSDF::Sample_f, reflection.cpp:605+).

    Returns (wi, f, pdf, flags) with the convention that for specular lobes
    ``f`` already includes the 1/|cos| factor removed — i.e. the caller
    always computes ``beta *= f * |cos(wi)| / pdf`` (pdf=1 for delta lobes,
    and f = F/|cos| folded), matching pbrt's estimator shape.
    ``eta_override`` (R,) substitutes the dielectric IOR (dispersive glass
    hero-wavelength path, materials/dispersive_glass.cpp:90-122).
    """
    t = mp.mtype
    C = mp.kd.shape[-1]
    R = wo.shape[:-1]
    eta_mat = mp.eta if eta_override is None else eta_override
    kd = mp.kd if kd_override is None else kd_override
    alpha = _mat_alpha(mp)
    ndf = mp.ndf if mp.has_beckmann else None
    need_mf = _present(mp, PLASTIC, UBER, SUBSTRATE, METAL, GLASS)
    need_glass = _present(mp, GLASS, DISPERSIVE_GLASS)

    # --- cosine lobe (matte & the diffuse half of plastic/uber/substrate)
    wi_cos = cosine_sample_hemisphere(u)
    wi_cos = wi_cos * jnp.sign(wo[..., 2:3] + 1e-20)  # same hemisphere as wo

    # --- microfacet reflection lobe
    if need_mf:
        wh = mf_sample_wh(wo, u, alpha, ndf)
        wi_mf = vecmath.reflect(wo, wh)

    # --- perfect mirror
    wi_mirror = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)

    # --- smooth dielectric (glass): choose reflect/refract by fresnel
    if need_glass:
        F = fr_dielectric(cos_theta(wo), jnp.ones_like(eta_mat), eta_mat)
        entering = cos_theta(wo) > 0.0
        eta_ratio = jnp.where(entering, 1.0 / eta_mat, eta_mat)
        n_loc = jnp.where(
            entering[..., None],
            jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), wo.shape),
            jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]), wo.shape))
        wi_refr, refr_ok = vecmath.refract(wo, n_loc, eta_ratio)
        choose_refl = (u_lobe < F) | ~refr_ok
        wi_glass = jnp.where(choose_refl[..., None], wi_mirror, wi_refr)

    # ---------------- per-type combination
    # MATTE
    pdf_matte = abs_cos_theta(wi_cos) * INV_PI
    if _present(mp, MATTE):
        f_matte = bsdf_f(mp, wo, wi_cos, kd_override=kd)

    # PLASTIC/UBER/SUBSTRATE: pick lobe by u_lobe
    if _present(mp, PLASTIC, UBER, SUBSTRATE):
        pick_mf = u_lobe >= 0.5
        wi_pl = jnp.where(pick_mf[..., None], wi_mf, wi_cos)
        # reject microfacet samples below horizon
        pl_ok = same_hemisphere(wo, wi_pl)
        f_pl = bsdf_f(mp, wo, wi_pl, kd_override=kd)
        pdf_pl = 0.5 * (abs_cos_theta(wi_pl) * INV_PI
                        + _microfacet_reflection_pdf(alpha, wo, wi_pl,
                                                     ndf=ndf))
        f_pl = jnp.where(pl_ok[..., None], f_pl, 0.0)
        pdf_pl = jnp.where(pl_ok, pdf_pl, 0.0)

    # METAL
    if _present(mp, METAL):
        metal_ok = same_hemisphere(wo, wi_mf)
        f_metal = bsdf_f(mp, wo, wi_mf, kd_override=kd)
        pdf_metal = _microfacet_reflection_pdf(alpha, wo, wi_mf, ndf=ndf)
        f_metal = jnp.where(metal_ok[..., None], f_metal, 0.0)
        pdf_metal = jnp.where(metal_ok, pdf_metal, 0.0)

    # MIRROR: delta; f = kr * F / |cos| with fresnel noop (mirror.cpp uses
    # FresnelNoOp → F = 1)
    if _present(mp, MIRROR):
        f_mirror = mp.kr / jnp.maximum(abs_cos_theta(wi_mirror),
                                       1e-6)[..., None]

    # GLASS smooth: delta; FresnelSpecular (reflection.cpp:118+)
    # reflect: kr * F / cos ; refract: kt * (1-F) / cos * etaRatio^2
    # (radiance transport scaling)
    if need_glass:
        f_g_refl = mp.kr * (F / jnp.maximum(abs_cos_theta(wi_mirror),
                                            1e-6))[..., None]
        f_g_refr = mp.kt * (((1.0 - F) * eta_ratio * eta_ratio)
                            / jnp.maximum(abs_cos_theta(wi_refr),
                                          1e-6))[..., None]
        f_glass = jnp.where(choose_refl[..., None], f_g_refl, f_g_refr)
        pdf_glass = jnp.where(choose_refl, F, 1.0 - F)
        # normalize the delta estimator: f/pdf handled by caller; here keep
        # pdf as the discrete lobe probability.

    # TRANSLUCENT: reflect or transmit cosine lobe
    if _present(mp, TRANSLUCENT):
        wi_tr = jnp.where((u_lobe < 0.5)[..., None], wi_cos,
                          -wi_cos)
        f_tr = bsdf_f(mp, wo, wi_tr, kd_override=kd)
        pdf_tr = 0.5 * abs_cos_theta(wi_tr) * INV_PI

    # DISNEY: uniform choice among the built lobes (BSDF::Sample_f
    # semantics over disney.cpp:504-589's lobe set): cosine family
    # (multiplicity k_diff) | aniso-GGX specular | GTR1 clearcoat |
    # microfacet transmission | lambertian transmission
    if _present(mp, DISNEY):
        k_diff_d, n_cc_d, n_mt_d, n_lt_d, n_d, n_en_d = \
            _disney_lobe_counts(mp)
        # the BSSRDF entry lobe's 1/n probability mass was already
        # consumed by subsurface_transport (which rewrites entered rows
        # away from DISNEY before this sampler runs), so the direction
        # sampler partitions u_lobe over the SURFACE lobes only; the
        # reported pdf still divides by the full n (below, _disney_pdf),
        # which makes the unconditional sample density exactly pbrt's
        # BSDF::Sample_f density: (n_surf/n)·Σpdf_j/n_surf = Σpdf_j/n
        n_pick_d = jnp.maximum(n_d - n_en_d, 1.0)
        ax_d, ay_d = _disney_alphas(mp)
        wh_d = tr_sample_wh_aniso(wo, u, ax_d, ay_d)
        wi_spec_d = vecmath.reflect(wo, wh_d)
        # clearcoat: exact GTR1 wh inversion (disney.cpp:285-305)
        gloss_d = _disney_cc_gloss(mp)
        a2g = gloss_d * gloss_d
        ct_cc = jnp.sqrt(jnp.maximum(
            0.0, (1.0 - a2g ** (1.0 - u[..., 0])) / (1.0 - a2g)))
        st_cc = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct_cc * ct_cc))
        phi_cc = 2.0 * jnp.pi * u[..., 1]
        wh_cc = jnp.stack([st_cc * jnp.cos(phi_cc),
                           st_cc * jnp.sin(phi_cc), ct_cc], axis=-1)
        wh_cc = wh_cc * jnp.sign(wo[..., 2:3] + 1e-20)
        wi_cc = vecmath.reflect(wo, wh_cc)
        c1_d = k_diff_d / n_pick_d
        c2_d = c1_d + 1.0 / n_pick_d
        c3_d = c2_d + n_cc_d / n_pick_d
        c4_d = c3_d + n_mt_d / n_pick_d
        wi_dis = jnp.where((u_lobe < c1_d)[..., None], wi_cos, wi_spec_d)
        wi_dis = jnp.where(((u_lobe >= c2_d) & (u_lobe < c3_d))[..., None],
                           wi_cc, wi_dis)
        bad_mt_d = jnp.zeros(R, bool)
        if mp.has_disney_trans:
            axt_d, ayt_d = _disney_trans_alphas(mp)
            wh_mt = tr_sample_wh_aniso(wo, u, axt_d, ayt_d)
            wh_mt_o = wh_mt * jnp.sign(vecmath.dot(wh_mt, wo))[..., None]
            eta_r_d = jnp.where(cos_theta(wo) > 0.0, 1.0 / mp.eta, mp.eta)
            wi_mt_d, mt_ok_d = vecmath.refract(wo, wh_mt_o, eta_r_d)
            pick_mt = (u_lobe >= c3_d) & (u_lobe < c4_d)
            wi_dis = jnp.where(pick_mt[..., None], wi_mt_d, wi_dis)
            wi_dis = jnp.where((u_lobe >= c4_d)[..., None], -wi_cos,
                               wi_dis)
            # total internal reflection → failed sample (Sample_f returns
            # 0 when Refract fails, reflection.cpp:470-471)
            bad_mt_d = pick_mt & ~mt_ok_d
        f_dis = _disney_f(mp, kd, wo, wi_dis)
        pdf_dis = _disney_pdf(mp, wo, wi_dis)
        f_dis = jnp.where(bad_mt_d[..., None], 0.0, f_dis)
        pdf_dis = jnp.where(bad_mt_d, 0.0, pdf_dis)

    # rough glass: pick microfacet reflection or transmission lobe with
    # probability 1/2 each (BSDF::Sample_f uniform lobe choice); refract
    # about the sampled visible normal wh
    glass_rough = (t == GLASS) & (mp.roughness > 1e-3)
    if _present(mp, GLASS):
        wh_o = wh * jnp.sign(vecmath.dot(wh, wo))[..., None]
        wi_rgt, rgt_ok = vecmath.refract(wo, wh_o, eta_ratio)
        pick_rg_trans = u_lobe >= 0.5
        wi_rg = jnp.where(pick_rg_trans[..., None], wi_rgt, wi_mf)
        rg_ok = jnp.where(pick_rg_trans,
                          rgt_ok & ~same_hemisphere(wo, wi_rg),
                          same_hemisphere(wo, wi_rg))
        f_rg = jnp.where(
            same_hemisphere(wo, wi_rg)[..., None],
            _microfacet_reflection_f(
                mp.kr, alpha,
                lambda c: fr_dielectric(c, jnp.ones_like(eta_mat),
                                        eta_mat)[..., None]
                * jnp.ones((1, C)), wo, wi_rg, ndf=ndf),
            _microfacet_transmission_f(mp.kt, alpha, eta_mat, wo, wi_rg,
                                       ndf=ndf))
        pdf_rg = 0.5 * (_microfacet_reflection_pdf(alpha, wo, wi_rg,
                                                   ndf=ndf)
                        + _microfacet_transmission_pdf(alpha, eta_mat, wo,
                                                       wi_rg, ndf=ndf))
        f_rg = jnp.where(rg_ok[..., None], f_rg, 0.0)
        pdf_rg = jnp.where(rg_ok, pdf_rg, 0.0)

    # NONE (null material = pure medium interface): the ray passes straight
    # through; f/|cos| folded so beta *= f·|cos|/pdf is exactly 1
    # (GeometricPrimitive::ComputeScatteringFunctions early-out when
    # !material, core/primitive.cpp)
    wi_none = -wo
    f_none = jnp.ones(R + (C,)) \
        / jnp.maximum(abs_cos_theta(wi_none), 1e-6)[..., None]

    # HAIR: exact Ap/Mp/Np importance sampling (hair.cpp Sample_f)
    if mp.has_hair:
        from pbrt_tpu.scene import hair as hair_mod
        hh = jnp.zeros(R) if h is None else h
        wi_hair, f_hair, pdf_hair = hair_mod.hair_sample(
            wo, hh, mp.sss_sigma_a, u_lobe, u[..., 0], u[..., 1],
            beta_m=mp.beta_m, beta_n=mp.beta_n, alpha=mp.hair_alpha,
            eta=mp.eta)

    # FOURIER: two-sided cosine lobe; f from the measured table
    if mp.has_fourier:
        from pbrt_tpu.scene import fourier as fourier_mod
        wi_four = jnp.where((u_lobe < 0.5)[..., None], wi_cos, -wi_cos)
        pdf_four = 0.5 * abs_cos_theta(wi_four) * INV_PI
        if fourier is not None:
            f_four = fourier_mod.eval_fourier_set(
                fourier, mp.fourier_id, wo, wi_four, C)
        else:
            f_four = jnp.zeros(R + (C,))

    # ---------------- select outputs by type
    def sel(vals, default):
        out = default
        for cond, v in vals:
            c = cond
            while c.ndim < v.ndim:
                c = c[..., None]
            out = jnp.where(c, v, out)
        return out

    zeroC = jnp.zeros(R + (C,))
    false_r = jnp.zeros(R, bool)
    wi_rows, f_rows, pdf_rows = [], [], []

    def add(cond, wi_v, f_v, pdf_v):
        wi_rows.append((cond, wi_v))
        f_rows.append((cond, f_v))
        pdf_rows.append((cond, pdf_v))

    if _present(mp, MATTE):
        add((t == MATTE), wi_cos, f_matte, pdf_matte[..., None])
    if _present(mp, SSS_EXIT):
        f_sw_s = jnp.where(same_hemisphere(wo, wi_cos)[..., None],
                           _sss_exit_sw(mp, wi_cos), 0.0)
        add((t == SSS_EXIT), wi_cos, f_sw_s, pdf_matte[..., None])
    if _present(mp, PLASTIC, UBER, SUBSTRATE):
        add((t == PLASTIC) | (t == UBER) | (t == SUBSTRATE), wi_pl, f_pl,
            pdf_pl[..., None])
    if _present(mp, METAL):
        add((t == METAL), wi_mf, f_metal, pdf_metal[..., None])
    if _present(mp, GLASS):
        add(glass_rough, wi_rg, f_rg, pdf_rg[..., None])
    if _present(mp, MIRROR):
        add((t == MIRROR), wi_mirror, f_mirror, jnp.ones(R + (1,)))
    if need_glass:
        add(((t == GLASS) & ~glass_rough) | (t == DISPERSIVE_GLASS),
            wi_glass, f_glass, pdf_glass[..., None])
    if _present(mp, TRANSLUCENT):
        add((t == TRANSLUCENT), wi_tr, f_tr, pdf_tr[..., None])
    if _present(mp, DISNEY):
        add((t == DISNEY), wi_dis, f_dis, pdf_dis[..., None])
    if mp.has_hair:
        add((t == HAIR), wi_hair, f_hair, pdf_hair[..., None])
    if mp.has_fourier:
        add((t == FOURIER), wi_four, f_four, pdf_four[..., None])
    if _present(mp, NONE):
        add((t == NONE), wi_none, f_none, jnp.ones(R + (1,)))
    wi = sel(wi_rows, wi_cos)
    f = sel(f_rows, zeroC)
    pdf = sel(pdf_rows, pdf_matte[..., None])[..., 0]

    is_specular = (t == NONE) if _present(mp, NONE) else false_r
    if _present(mp, MIRROR):
        is_specular = is_specular | (t == MIRROR)
    if need_glass:
        is_specular = is_specular | ((t == GLASS) & ~glass_rough) \
            | (t == DISPERSIVE_GLASS)
    is_transmission = (t == NONE) if _present(mp, NONE) else false_r
    if need_glass:
        is_transmission = is_transmission | (
            (((t == GLASS) & ~glass_rough)
             | (t == DISPERSIVE_GLASS)) & ~choose_refl)
    if _present(mp, TRANSLUCENT):
        is_transmission = is_transmission | (
            (t == TRANSLUCENT) & (u_lobe >= 0.5))
    if _present(mp, GLASS):
        is_transmission = is_transmission | (glass_rough & pick_rg_trans)
    if mp.has_hair:
        is_transmission = is_transmission | \
            ((t == HAIR) & ~same_hemisphere(wo, wi))
    if mp.has_fourier:
        is_transmission = is_transmission | \
            ((t == FOURIER) & ~same_hemisphere(wo, wi))
    flags = (is_specular.astype(jnp.int32) * FLAG_SPECULAR
             | is_transmission.astype(jnp.int32) * FLAG_TRANSMISSION)
    return wi, f, pdf, flags


def cauchy_eta(b: Array, c: Array, wvl_nm: Array) -> Array:
    """Dispersive glass eta(λ) = B + C/λ² with λ in µm
    (materials/dispersive_glass.cpp:62-64, reflection.h:345-380)."""
    lam_um = wvl_nm * 1e-3
    return b + c / (lam_um * lam_um)
