"""Film & reconstruction filters.

JAX counterpart of ``core/film.{h,cpp}`` (Film/FilmTile :58-193) and
``src/filters/`` (box, triangle, gaussian, mitchell, sinc).

pbrt splats each sample into every pixel within the filter radius and keeps
per-pixel (contribSum, filterWeightSum) merged under a mutex. Here we use
**filter importance sampling**: each (pixel, sample) draws its film-plane
offset from the normalized |filter| distribution and carries the scalar
weight f(Δ)/p(Δ); the pixel estimate is the mean of w·L. Same expectation as
pbrt's weighted average, no scatter in the hot loop, and negative-lobe
filters (mitchell, sinc) are handled by the sign of f.

A scatter-add splat path (Film::AddSplat, film.h:83-87 — used by BDPT/MLT/
SPPM) is provided via ``splat``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

Array = Any

BOX = 0
TRIANGLE = 1
GAUSSIAN = 2
MITCHELL = 3
SINC = 4

_FILTER_NAMES = {"box": BOX, "triangle": TRIANGLE, "gaussian": GAUSSIAN,
                 "mitchell": MITCHELL, "sinc": SINC}
_N_TAB = 256


def _filter_1d(name: int, x: np.ndarray, radius: float, extra: float
               ) -> np.ndarray:
    """Evaluate the 1D factor of the (separable) filter at offsets x."""
    ax = np.abs(x)
    if name == BOX:
        return (ax <= radius).astype(np.float64)
    if name == TRIANGLE:
        return np.maximum(0.0, radius - ax)
    if name == GAUSSIAN:
        alpha = extra  # filters/gaussian.h: default 2
        return np.maximum(
            0.0, np.exp(-alpha * x * x) - np.exp(-alpha * radius * radius))
    if name == MITCHELL:
        b = c = 1.0 / 3.0
        t = np.abs(2.0 * x / radius)
        f = np.where(
            t > 1,
            ((-b - 6 * c) * t ** 3 + (6 * b + 30 * c) * t ** 2
             + (-12 * b - 48 * c) * t + (8 * b + 24 * c)) / 6.0,
            ((12 - 9 * b - 6 * c) * t ** 3 + (-18 + 12 * b + 6 * c) * t ** 2
             + (6 - 2 * b)) / 6.0)
        return np.where(t <= 2.0, f, 0.0)
    if name == SINC:
        tau = extra if extra > 0 else 3.0
        sinc = lambda v: np.where(np.abs(v) < 1e-5, 1.0,
                                  np.sin(np.pi * v) / (np.pi * v))
        lanczos = sinc(x) * sinc(x / tau)
        return np.where(ax <= radius, lanczos, 0.0)
    raise ValueError(name)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Filter:
    """Tabulated separable filter: inverse-CDF of |f| + value table."""
    radius: Array        # (2,) xwidth, ywidth
    inv_cdf: Array       # (_N_TAB,) maps uniform u → offset in [-r, r] (x)
    inv_cdf_y: Array     # (_N_TAB,)
    # f(Δ)/p(Δ) weight tables aligned with inv_cdf samples
    w_x: Array           # (_N_TAB,)
    w_y: Array           # (_N_TAB,)
    # static: box filter → closed-form inverse CDF (off = (2u−1)·r, w = 1)
    # instead of four per-sample table gathers
    is_box: bool = dataclasses.field(metadata=dict(static=True),
                                     default=False)


def make_filter(name: str = "box", xwidth: float = None, ywidth: float = None,
                alpha: float = 2.0, tau: float = 3.0) -> Filter:
    ftype = _FILTER_NAMES[name]
    defaults = {BOX: 0.5, TRIANGLE: 2.0, GAUSSIAN: 2.0, MITCHELL: 2.0,
                SINC: 4.0}
    rx = float(xwidth) if xwidth is not None else defaults[ftype]
    ry = float(ywidth) if ywidth is not None else defaults[ftype]
    extra = alpha if ftype == GAUSSIAN else tau

    def build(r):
        xs = np.linspace(-r, r, 4096)
        f = _filter_1d(ftype, xs, r, extra)
        p = np.abs(f)
        cdf = np.concatenate([[0.0], np.cumsum(p)])
        cdf /= cdf[-1]
        u = (np.arange(_N_TAB) + 0.5) / _N_TAB
        idx = np.searchsorted(cdf, u) - 1
        idx = np.clip(idx, 0, len(xs) - 1)
        x_samp = xs[idx]
        # pdf at sample = p_i / (sum_p * dx)
        dx = xs[1] - xs[0]
        pdf = p[idx] / (p.sum() * dx)
        # normalize so that E[w] corresponds to pbrt's sum f L / sum f:
        # weight = f / (pdf * integral_f)
        integral_f = f.sum() * dx
        w = f[idx] / np.maximum(pdf * integral_f, 1e-12)
        return x_samp.astype(np.float32), w.astype(np.float32)

    ix, wx = build(rx)
    iy, wy = build(ry)
    return Filter(radius=jnp.asarray([rx, ry], jnp.float32),
                  inv_cdf=jnp.asarray(ix), inv_cdf_y=jnp.asarray(iy),
                  w_x=jnp.asarray(wx), w_y=jnp.asarray(wy),
                  is_box=(ftype == BOX))


def sample_filter_offset(filt: Filter, u: Array):
    """u: (R,2) uniforms → (offset (R,2) in pixels, weight (R,))."""
    if filt.is_box:
        # closed-form box inverse CDF — no table gathers in the hot path
        off = (2.0 * u - 1.0) * filt.radius
        return off, jnp.ones(u.shape[:-1])
    from pbrt_tpu.ops import fastgather
    ix = jnp.clip((u[..., 0] * _N_TAB).astype(jnp.int32), 0, _N_TAB - 1)
    iy = jnp.clip((u[..., 1] * _N_TAB).astype(jnp.int32), 0, _N_TAB - 1)
    off = jnp.stack([fastgather.gather_rows(filt.inv_cdf, ix),
                     fastgather.gather_rows(filt.inv_cdf_y, iy)], axis=-1)
    w = (fastgather.gather_rows(filt.w_x, ix)
         * fastgather.gather_rows(filt.w_y, iy))
    return off, w


def splat(image: Array, p_raster: Array, value: Array, valid: Array) -> Array:
    """Film::AddSplat analogue: scatter-add values at raster positions.
    image: (H,W,C); p_raster: (R,2); value: (R,C)."""
    h, w = image.shape[0], image.shape[1]
    xi = jnp.clip(p_raster[..., 0].astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(p_raster[..., 1].astype(jnp.int32), 0, h - 1)
    value = jnp.where(valid[..., None], value, 0.0)
    return image.at[yi, xi].add(value)
