"""Sampling utilities: distributions, warps, MIS heuristics.

JAX counterpart of ``core/sampling.{h,cpp}`` (Distribution1D
sampling.h:55-107, Distribution2D :124-132, warps, PowerHeuristic) and the
fork's ``core/distr.h`` DiscreteDistribution/SpectralDistribution (:23-112).
CDF tables are plain arrays; sampling is vectorized searchsorted — no classes
with mutable state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

Array = Any

PI = float(jnp.pi)
INV_PI = float(1.0 / jnp.pi)
INV_2PI = float(0.5 / jnp.pi)
INV_4PI = float(0.25 / jnp.pi)
PI_OVER_2 = float(jnp.pi / 2)
PI_OVER_4 = float(jnp.pi / 4)


# ---------------------------------------------------------------------------
# Distribution1D (sampling.h:55-107) — CDF tables as arrays
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Distribution1D:
    """Piecewise-constant 1D distribution.

    ``func``: (..., N) non-negative values; ``cdf``: (..., N+1);
    ``func_int``: (...,) integral of func over [0,1].
    """
    func: Array
    cdf: Array
    func_int: Array

    @property
    def n(self) -> int:
        return self.func.shape[-1]


def make_distribution_1d(f: Array) -> Distribution1D:
    """Build CDF tables. Matches Distribution1D's ctor semantics including the
    all-zero fallback to uniform (sampling.cpp)."""
    f = jnp.asarray(f)
    n = f.shape[-1]
    cdf = jnp.cumsum(f, axis=-1) / n
    func_int = cdf[..., -1]
    zero = func_int == 0.0
    # uniform fallback when the function integrates to zero
    ramp = (jnp.arange(1, n + 1, dtype=f.dtype) / n)
    cdf = jnp.where(zero[..., None], ramp, cdf / jnp.where(
        zero, 1.0, func_int)[..., None])
    cdf = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], axis=-1)
    return Distribution1D(func=f, cdf=cdf, func_int=func_int)


def _take1d(tab: Array, idx: Array) -> Array:
    """tab[idx] for a 1D table shared across all lanes — fastgather path
    (small tables = the per-ray index gathers PROFILE_r03 flags)."""
    from pbrt_tpu.ops import fastgather
    return fastgather.gather_rows(tab, idx)


def _find_interval(cdf: Array, u: Array) -> Array:
    """Index i such that cdf[i] <= u < cdf[i+1]; batched searchsorted."""
    n = cdf.shape[-1] - 1
    if cdf.ndim == 1:
        idx = jnp.searchsorted(cdf, u, side="right") - 1
    else:
        # batched: one distribution per row of u
        idx = jax.vmap(lambda c, uu: jnp.searchsorted(c, uu, side="right"))(
            cdf.reshape(-1, cdf.shape[-1]),
            u.reshape(-1, *u.shape[cdf.ndim - 1:])).reshape(u.shape) - 1
    return jnp.clip(idx, 0, n - 1)


def sample_distribution_1d_continuous(d: Distribution1D, u: Array):
    """SampleContinuous (sampling.h:65-87): returns (x in [0,1), pdf, offset)."""
    off = _find_interval(d.cdf, u)
    c_lo = jnp.take_along_axis(d.cdf, off[..., None], axis=-1)[..., 0] \
        if d.cdf.ndim > 1 else _take1d(d.cdf, off)
    c_hi = jnp.take_along_axis(d.cdf, off[..., None] + 1, axis=-1)[..., 0] \
        if d.cdf.ndim > 1 else _take1d(d.cdf, off + 1)
    du = u - c_lo
    denom = jnp.where(c_hi - c_lo > 0, c_hi - c_lo, 1.0)
    du = du / denom
    f = jnp.take_along_axis(d.func, off[..., None], axis=-1)[..., 0] \
        if d.func.ndim > 1 else _take1d(d.func, off)
    func_int = jnp.where(d.func_int > 0, d.func_int, 1.0)
    pdf = f / func_int
    x = (off.astype(u.dtype) + du) / d.n
    return x, pdf, off


def sample_distribution_1d_discrete(d: Distribution1D, u: Array):
    """SampleDiscrete (sampling.h:89-99): returns (index, pmf)."""
    off = _find_interval(d.cdf, u)
    f = jnp.take_along_axis(d.func, off[..., None], axis=-1)[..., 0] \
        if d.func.ndim > 1 else _take1d(d.func, off)
    func_int = jnp.where(d.func_int > 0, d.func_int, 1.0)
    pmf = f / (func_int * d.n)
    # zero-integral distribution: uniform pmf
    pmf = jnp.where(d.func_int > 0, pmf, 1.0 / d.n)
    return off, pmf


def distribution_1d_discrete_pdf(d: Distribution1D, idx: Array) -> Array:
    f = jnp.take_along_axis(d.func, idx[..., None], axis=-1)[..., 0] \
        if d.func.ndim > 1 else _take1d(d.func, idx)
    func_int = jnp.where(d.func_int > 0, d.func_int, 1.0)
    return jnp.where(d.func_int > 0, f / (func_int * d.n), 1.0 / d.n)


# ---------------------------------------------------------------------------
# Distribution2D (sampling.h:124-132) for env-map importance sampling
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Distribution2D:
    cond: Distribution1D      # (H, W) conditional rows
    marginal: Distribution1D  # (H,) marginal over rows


def make_distribution_2d(f: Array) -> Distribution2D:
    f = jnp.asarray(f)
    cond = make_distribution_1d(f)                     # per-row
    marginal = make_distribution_1d(cond.func_int)     # over rows
    return Distribution2D(cond=cond, marginal=marginal)


def sample_distribution_2d(d: Distribution2D, u: Array):
    """u: (..., 2) → ((u,v) in [0,1)^2, pdf)."""
    v, pdf_m, row = sample_distribution_1d_continuous(d.marginal, u[..., 1])
    # gather the row distribution then sample it
    row_func = d.cond.func[row]
    row_cdf = d.cond.cdf[row]
    row_int = d.cond.func_int[row]
    rd = Distribution1D(func=row_func, cdf=row_cdf, func_int=row_int)
    x, pdf_c, _ = sample_distribution_1d_continuous(rd, u[..., 0])
    return jnp.stack([x, v], axis=-1), pdf_m * pdf_c


def distribution_2d_pdf(d: Distribution2D, uv: Array) -> Array:
    h, w = d.cond.func.shape
    iu = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    iv = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    func_int = jnp.where(d.marginal.func_int > 0, d.marginal.func_int, 1.0)
    return d.cond.func[iv, iu] / func_int


# ---------------------------------------------------------------------------
# Warps (sampling.cpp)
# ---------------------------------------------------------------------------

def uniform_sample_hemisphere(u: Array) -> Array:
    z = u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sample_sphere(u: Array) -> Array:
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def concentric_sample_disk(u: Array) -> Array:
    """Branchless Shirley–Chiu concentric disk mapping (sampling.cpp:113)."""
    uo = 2.0 * u - 1.0
    x, y = uo[..., 0], uo[..., 1]
    zero = (x == 0.0) & (y == 0.0)
    use_x = jnp.abs(x) > jnp.abs(y)
    r = jnp.where(use_x, x, y)
    theta = jnp.where(use_x,
                      PI_OVER_4 * (y / jnp.where(x == 0.0, 1.0, x)),
                      PI_OVER_2 - PI_OVER_4 * (x / jnp.where(y == 0.0, 1.0, y)))
    r = jnp.where(zero, 0.0, r)
    theta = jnp.where(zero, 0.0, theta)
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def cosine_sample_hemisphere(u: Array) -> Array:
    d = concentric_sample_disk(u)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return jnp.concatenate([d, z[..., None]], axis=-1)


def cosine_hemisphere_pdf(cos_theta: Array) -> Array:
    return cos_theta * INV_PI


def uniform_cone_pdf(cos_theta_max: Array) -> Array:
    return 1.0 / (2.0 * PI * (1.0 - cos_theta_max))


def uniform_sample_cone(u: Array, cos_theta_max: Array) -> Array:
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = u[..., 1] * 2.0 * PI
    return jnp.stack([jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta,
                      cos_theta], axis=-1)


def uniform_sample_triangle(u: Array) -> Array:
    su0 = jnp.sqrt(u[..., 0])
    return jnp.stack([1.0 - su0, u[..., 1] * su0], axis=-1)


# ---------------------------------------------------------------------------
# MIS heuristics (sampling.h)
# ---------------------------------------------------------------------------

def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return (nf * f_pdf) / jnp.maximum(nf * f_pdf + ng * g_pdf, 1e-20)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return jnp.where(f_pdf > 0, (f * f) / jnp.maximum(f * f + g * g, 1e-20),
                     0.0)
