"""Hair BSDF (Marschner/Chiang model).

JAX counterpart of ``materials/hair.{h,cpp}``: longitudinal lobes Mp
(von-Mises-like, hair.cpp:51-61 with the I0/LogI0 Bessel evaluation
:63-83), azimuthal lobes Np via trimmed logistics (:105-129), attenuation
terms Ap for p = R, TT, TRT, and the residual lobe (:85-103), hair-scale
tilt 2^k·alpha rotations (:255-262, :291-312).

Convention (hair.cpp:265-273): the local frame has **x along the fiber**;
sinTheta = w.x, phi = atan2(w.z, w.y). ``h`` ∈ [-1,1] is the azimuthal
offset across the curve width (from the ribbon's v coordinate).

Everything is batched over shading points. ``hair_sample`` importance-samples
the exact model — lobe selection by ApPdf CDF, Mp inversion for theta, and
trimmed-logistic Np inversion for phi (hair.cpp:429-483) — and ``hair_pdf``
returns the matching Σp apPdf·Mp·Np density (hair.cpp:485-521).
"""

from __future__ import annotations

import math
from typing import Any

import jax
import jax.numpy as jnp

from pbrt_tpu.scene.materials import fr_dielectric

Array = Any

P_MAX = 3
SQRT_PI_OVER_8 = 0.626657069


def _sqr(x):
    return x * x


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def i0(x: Array) -> Array:
    """Modified Bessel I0 via the 10-term series (hair.cpp:63-76)."""
    val = jnp.zeros_like(x)
    x2i = jnp.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def log_i0(x: Array) -> Array:
    big = x + 0.5 * (-math.log(2 * math.pi) + jnp.log(
        1.0 / jnp.maximum(x, 1e-9)) + 1.0 / (8.0 * jnp.maximum(x, 1e-9)))
    return jnp.where(x > 12.0, big, jnp.log(jnp.maximum(i0(x), 1e-30)))


def mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering lobe (hair.cpp:51-61)."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small_v = jnp.exp(log_i0(a) - b - 1.0 / v + 0.6931
                      + jnp.log(1.0 / (2.0 * v)))
    big_v = jnp.exp(-b) * i0(a) / (jnp.sinh(1.0 / v) * 2.0 * v)
    return jnp.where(v <= 0.1, small_v, big_v)


def _logistic(x, s):
    x = jnp.abs(x)
    e = jnp.exp(-x / s)
    return e / (s * _sqr(1.0 + e))


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + jnp.exp(-x / s))


def trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _phi_fn(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * math.pi


def np_lobe(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_fn(p, gamma_o, gamma_t)
    dphi = jnp.mod(dphi + math.pi, 2.0 * math.pi) - math.pi
    return trimmed_logistic(dphi, s, -math.pi, math.pi)


def _variances(beta_m):
    v0 = _sqr(0.726 * beta_m + 0.812 * _sqr(beta_m) + 3.7 * beta_m ** 20)
    return [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]


def _azimuthal_s(beta_n):
    return SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * _sqr(beta_n)
                             + 5.372 * beta_n ** 22)


def _alpha_terms(alpha_deg):
    """sin/cos of 2^k·alpha (hair.cpp:255-262). Accepts scalars or (R,)
    arrays (batched per-material alpha when hair is a material-table row)."""
    s0 = jnp.sin(jnp.radians(jnp.asarray(alpha_deg, jnp.float32)))
    c0 = jnp.sqrt(jnp.maximum(0.0, 1.0 - s0 * s0))
    sin2k = [s0]
    cos2k = [c0]
    for _ in range(2):
        sin2k.append(2 * cos2k[-1] * sin2k[-1])
        cos2k.append(_sqr(cos2k[-1]) - _sqr(sin2k[-1]))
    return sin2k, cos2k


def _ap_terms(cos_to, eta, h, T):
    """Attenuation terms Ap for p = R, TT, TRT, residual (hair.cpp:85-103).
    Returns a list of P_MAX+1 (R,C) arrays."""
    cos_go = _safe_sqrt(1.0 - _sqr(h))
    f0 = fr_dielectric(cos_to * cos_go, jnp.ones_like(cos_to),
                       eta * jnp.ones_like(cos_to))
    ap = [f0[..., None] * jnp.ones_like(T)]
    ap.append(_sqr(1.0 - f0)[..., None] * T)
    for p in range(2, P_MAX):
        ap.append(ap[-1] * T * f0[..., None])
    ap.append(ap[P_MAX - 1] * f0[..., None] * T
              / jnp.maximum(1.0 - T * f0[..., None], 1e-4))
    return ap


def _hair_angles(wo, h, eta):
    """Shared angle bookkeeping (hair.cpp:265-290)."""
    sin_to = wo[..., 0]
    cos_to = _safe_sqrt(1.0 - _sqr(sin_to))
    phi_o = jnp.arctan2(wo[..., 2], wo[..., 1])
    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(1.0 - _sqr(sin_tt))
    etap = jnp.sqrt(jnp.maximum(eta * eta - _sqr(sin_to), 1e-9)) \
        / jnp.maximum(cos_to, 1e-6)
    sin_gt = h / etap
    cos_gt = _safe_sqrt(1.0 - _sqr(sin_gt))
    gamma_t = jnp.arcsin(jnp.clip(sin_gt, -1.0, 1.0))
    gamma_o = jnp.arcsin(jnp.clip(h, -1.0, 1.0))
    return (sin_to, cos_to, phi_o, cos_tt, cos_gt, gamma_t, gamma_o)


def _tilted_theta_o(p, sin_to, cos_to, sin2k, cos2k):
    """sinThetaOp/cosThetaOp with the 2^p·alpha scale tilt
    (hair.cpp:291-312); p is a Python int."""
    if p == 0:
        sin_top = sin_to * cos2k[1] - cos_to * sin2k[1]
        cos_top = cos_to * cos2k[1] + sin_to * sin2k[1]
    elif p == 1:
        sin_top = sin_to * cos2k[0] + cos_to * sin2k[0]
        cos_top = cos_to * cos2k[0] - sin_to * sin2k[0]
    else:
        sin_top = sin_to * cos2k[2] + cos_to * sin2k[2]
        cos_top = cos_to * cos2k[2] - sin_to * sin2k[2]
    return sin_top, jnp.abs(cos_top)


def hair_ap_pdf(wo, h, sigma_a, eta):
    """ComputeApPdf (hair.cpp:411-427): (R, P_MAX+1) discrete lobe pdf from
    the mean-channel attenuation."""
    (_, cos_to, _, cos_tt, cos_gt, _, _) = _hair_angles(wo, h, eta)
    T = jnp.exp(-sigma_a * (2.0 * cos_gt
                            / jnp.maximum(cos_tt, 1e-6))[..., None])
    ap = _ap_terms(cos_to, eta, h, T)
    y = jnp.stack([a.mean(-1) for a in ap], axis=-1)  # (R, P_MAX+1)
    return y / jnp.maximum(y.sum(-1, keepdims=True), 1e-12)


def hair_pdf(wo: Array, wi: Array, h: Array, sigma_a: Array,
             beta_m=0.3, beta_n=0.3, alpha=2.0, eta=1.55) -> Array:
    """HairBSDF::Pdf (hair.cpp:485-521): Σp apPdf[p]·Mp·Np. Batched; the
    shape parameters may be scalars or (R,) arrays."""
    (sin_to, cos_to, phi_o, _, _, gamma_t, gamma_o) = \
        _hair_angles(wo, h, eta)
    sin_ti = wi[..., 0]
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))
    phi_i = jnp.arctan2(wi[..., 2], wi[..., 1])
    phi = phi_i - phi_o

    ap_pdf = hair_ap_pdf(wo, h, sigma_a, eta)
    v = _variances(beta_m)
    s = _azimuthal_s(beta_n)
    sin2k, cos2k = _alpha_terms(alpha)

    pdf = jnp.zeros_like(sin_to)
    for p in range(P_MAX):
        sin_top, cos_top = _tilted_theta_o(p, sin_to, cos_to, sin2k, cos2k)
        pdf = pdf + (mp(cos_ti, cos_top, sin_ti, sin_top, v[p])
                     * ap_pdf[..., p] * np_lobe(phi, p, s, gamma_o, gamma_t))
    pdf = pdf + (mp(cos_ti, cos_to, sin_ti, sin_to, v[P_MAX])
                 * ap_pdf[..., P_MAX] / (2.0 * math.pi))
    return pdf


def _sample_trimmed_logistic(u, s, a, b):
    """SampleTrimmedLogistic (hair.cpp:142-148)."""
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    denom = jnp.clip(u * k + _logistic_cdf(a, s), 1e-6, 1.0 - 1e-6)
    x = -s * jnp.log(1.0 / denom - 1.0)
    return jnp.clip(x, a, b)


def hair_sample(wo: Array, h: Array, sigma_a: Array, u_p: Array,
                u_theta: Array, u_phi2: Array, u_phi: Array = None,
                beta_m=0.3, beta_n=0.3, alpha=2.0, eta=1.55):
    """HairBSDF::Sample_f (hair.cpp:429-483) batched.

    u_p selects the lobe p from ApPdf; (u_theta, u_phi2) sample Mp;
    u_phi samples Np — when None it is recovered by rescaling u_p within
    the selected CDF segment (the DemuxFloat role, hair.cpp:433-441).
    Returns (wi, f, pdf)."""
    (sin_to, cos_to, phi_o, _, _, gamma_t, gamma_o) = \
        _hair_angles(wo, h, eta)
    ap_pdf = hair_ap_pdf(wo, h, sigma_a, eta)       # (R, P_MAX+1)
    cdf = jnp.cumsum(ap_pdf, axis=-1)
    p_sel = jnp.clip(jnp.sum(u_p[..., None] > cdf, axis=-1), 0, P_MAX)
    if u_phi is None:
        cdf_prev = jnp.where(
            p_sel > 0,
            jnp.take_along_axis(cdf, jnp.maximum(p_sel - 1, 0)[..., None],
                                axis=-1)[..., 0], 0.0)
        seg = jnp.take_along_axis(ap_pdf, p_sel[..., None], axis=-1)[..., 0]
        u_phi = jnp.clip((u_p - cdf_prev) / jnp.maximum(seg, 1e-9),
                         0.0, 1.0 - 1e-6)

    v = _variances(beta_m)
    sin2k, cos2k = _alpha_terms(alpha)
    s = _azimuthal_s(beta_n)

    # tilted thetaO per candidate p, gathered by p_sel; the residual lobe
    # (p = pMax) samples untilted (hair.cpp:448-459)
    tops = [_tilted_theta_o(p, sin_to, cos_to, sin2k, cos2k)
            for p in range(P_MAX)] + [(sin_to, cos_to)]
    sin_top = jnp.select([p_sel == p for p in range(P_MAX + 1)],
                         [jnp.broadcast_to(t[0], sin_to.shape)
                          for t in tops])
    cos_top = jnp.select([p_sel == p for p in range(P_MAX + 1)],
                         [jnp.broadcast_to(t[1], cos_to.shape)
                          for t in tops])
    v_sel = jnp.select([p_sel == p for p in range(P_MAX + 1)],
                       [jnp.broadcast_to(vv, sin_to.shape) for vv in v])

    # longitudinal: invert Mp (hair.cpp:461-470)
    ut = jnp.maximum(u_theta, 1e-5)
    cos_theta = 1.0 + v_sel * jnp.log(
        ut + (1.0 - ut) * jnp.exp(-2.0 / jnp.maximum(v_sel, 1e-6)))
    sin_theta = _safe_sqrt(1.0 - _sqr(cos_theta))
    cos_phi = jnp.cos(2.0 * math.pi * u_phi2)
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi * cos_top
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))

    # azimuthal (hair.cpp:472-478)
    dphi_lobe = _phi_fn(p_sel, gamma_o, gamma_t) \
        + _sample_trimmed_logistic(u_phi, s, -math.pi, math.pi)
    dphi = jnp.where(p_sel < P_MAX, dphi_lobe, 2.0 * math.pi * u_phi)
    phi_i = phi_o + dphi
    wi = jnp.stack([sin_ti, cos_ti * jnp.cos(phi_i),
                    cos_ti * jnp.sin(phi_i)], axis=-1)

    f = hair_f(wo, wi, h, sigma_a, beta_m, beta_n, alpha, eta)
    pdf = hair_pdf(wo, wi, h, sigma_a, beta_m, beta_n, alpha, eta)
    return wi, f, pdf


def hair_f(wo: Array, wi: Array, h: Array, sigma_a: Array,
           beta_m: float = 0.3, beta_n: float = 0.3, alpha: float = 2.0,
           eta: float = 1.55) -> Array:
    """HairBSDF::f (hair.cpp:264-324) batched. wo, wi: (R,3) local (x along
    fiber); h: (R,); sigma_a: (R,C) absorption. Returns (R,C)."""
    sin_to = wo[..., 0]
    cos_to = _safe_sqrt(1.0 - _sqr(sin_to))
    phi_o = jnp.arctan2(wo[..., 2], wo[..., 1])
    sin_ti = wi[..., 0]
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))
    phi_i = jnp.arctan2(wi[..., 2], wi[..., 1])

    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(1.0 - _sqr(sin_tt))
    etap = jnp.sqrt(jnp.maximum(eta * eta - _sqr(sin_to), 1e-9)) \
        / jnp.maximum(cos_to, 1e-6)
    sin_gt = h / etap
    cos_gt = _safe_sqrt(1.0 - _sqr(sin_gt))
    gamma_t = jnp.arcsin(jnp.clip(sin_gt, -1.0, 1.0))
    gamma_o = jnp.arcsin(jnp.clip(h, -1.0, 1.0))

    T = jnp.exp(-sigma_a * (2.0 * cos_gt
                            / jnp.maximum(cos_tt, 1e-6))[..., None])
    ap = _ap_terms(cos_to, eta, h, T)

    v = _variances(beta_m)
    s = _azimuthal_s(beta_n)
    sin2k, cos2k = _alpha_terms(alpha)
    phi = phi_i - phi_o

    fsum = jnp.zeros_like(T)
    for p in range(P_MAX):
        if p == 0:
            sin_top = sin_to * cos2k[1] - cos_to * sin2k[1]
            cos_top = cos_to * cos2k[1] + sin_to * sin2k[1]
        elif p == 1:
            sin_top = sin_to * cos2k[0] + cos_to * sin2k[0]
            cos_top = cos_to * cos2k[0] - sin_to * sin2k[0]
        else:
            sin_top = sin_to * cos2k[2] + cos_to * sin2k[2]
            cos_top = cos_to * cos2k[2] - sin_to * sin2k[2]
        cos_top = jnp.abs(cos_top)
        fsum = fsum + (mp(cos_ti, cos_top, sin_ti, sin_top, v[p])
                       * np_lobe(phi, p, s, gamma_o, gamma_t))[..., None] \
            * ap[p]
    fsum = fsum + (mp(cos_ti, cos_to, sin_ti, sin_to, v[P_MAX])
                   / (2.0 * math.pi))[..., None] * ap[P_MAX]
    abs_cos_wi = jnp.abs(wi[..., 2])
    return fsum / jnp.maximum(abs_cos_wi, 1e-6)[..., None]


def sigma_a_from_concentration(ce: float, cp: float) -> jnp.ndarray:
    """HairBSDF::SigmaAFromConcentration (hair.cpp): eumelanin/pheomelanin
    concentrations → RGB absorption."""
    eumelanin = jnp.asarray([0.419, 0.697, 1.37])
    pheomelanin = jnp.asarray([0.187, 0.4, 1.05])
    return ce * eumelanin + cp * pheomelanin


def sigma_a_from_reflectance(c: Array, beta_n: float) -> Array:
    """HairBSDF::SigmaAFromReflectance (hair.cpp)."""
    denom = (5.969 - 0.215 * beta_n + 2.532 * _sqr(beta_n)
             - 10.73 * beta_n ** 3 + 5.574 * beta_n ** 4
             + 0.245 * beta_n ** 5)
    return _sqr(jnp.log(jnp.maximum(c, 1e-4)) / denom)
