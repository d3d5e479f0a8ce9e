"""Participating media: homogeneous + heterogeneous density grid.

JAX counterpart of ``src/media/`` (homogeneous.cpp: closed-form
Beer–Lambert Tr + exponential distance sampling; grid.cpp: density grid
with ratio-tracking Tr and delta-tracking distance sampling,
media/grid.h:51,85-87) and the Henyey–Greenstein phase function
(core/medium.h:50-114).

Round-1 scope: one scene-global medium (camera medium) — covers the
volumetric-path capability (BASELINE config 5); per-primitive interior
media attach in a later round.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core import vecmath
from pbrt_tpu.core.sampling import INV_4PI
from pbrt_tpu.core.vecmath import dot, normalize

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Medium:
    sigma_a: Array      # (C,)
    sigma_s: Array      # (C,)
    g: Array            # () HG asymmetry
    density: Array      # (D,H,W) grid density multiplier (1,1,1 = homog.)
    grid_lo: Array      # (3,)
    grid_hi: Array      # (3,)
    max_density: Array  # () majorant multiplier for delta tracking
    is_grid: bool = dataclasses.field(metadata=dict(static=True))

    @property
    def sigma_t(self):
        return self.sigma_a + self.sigma_s


def make_homogeneous(sigma_a, sigma_s, g=0.0, n_channels=3) -> Medium:
    sa = jnp.broadcast_to(jnp.asarray(sigma_a, jnp.float32), (n_channels,))
    ss = jnp.broadcast_to(jnp.asarray(sigma_s, jnp.float32), (n_channels,))
    return Medium(sigma_a=sa, sigma_s=ss, g=jnp.asarray(g, jnp.float32),
                  density=jnp.ones((1, 1, 1)),
                  grid_lo=jnp.zeros(3), grid_hi=jnp.ones(3),
                  max_density=jnp.asarray(1.0), is_grid=False)


def make_grid(sigma_a, sigma_s, density, lo, hi, g=0.0, n_channels=3
              ) -> Medium:
    d = jnp.asarray(density, jnp.float32)
    sa = jnp.broadcast_to(jnp.asarray(sigma_a, jnp.float32), (n_channels,))
    ss = jnp.broadcast_to(jnp.asarray(sigma_s, jnp.float32), (n_channels,))
    return Medium(sigma_a=sa, sigma_s=ss, g=jnp.asarray(g, jnp.float32),
                  density=d, grid_lo=jnp.asarray(lo, jnp.float32),
                  grid_hi=jnp.asarray(hi, jnp.float32),
                  max_density=jnp.max(d), is_grid=True)


def density_at(med: Medium, p: Array) -> Array:
    """Trilinear grid lookup (grid.cpp GridDensityMedium::Density), 0
    outside the grid box; 1 for homogeneous."""
    if not med.is_grid:
        return jnp.ones(p.shape[:-1])
    D, H, W = med.density.shape
    u = (p - med.grid_lo) / jnp.maximum(med.grid_hi - med.grid_lo, 1e-9)
    inside = ((u >= 0.0) & (u <= 1.0)).all(-1)
    g = u * jnp.asarray([W, H, D]) - 0.5
    gi = jnp.floor(g).astype(jnp.int32)
    f = g - gi

    def tap(dx, dy, dz):
        # pbrt's D() returns 0 OUTSIDE the sample lattice (grid.h:61-69
        # InsideExclusive) — clamping instead extends edge density half a
        # cell beyond the samples and measurably over-brightens a lit
        # grid's boundary shell (r4 grid-medium oracle, +8% in-fog)
        x = gi[..., 0] + dx
        y = gi[..., 1] + dy
        z = gi[..., 2] + dz
        ok = ((x >= 0) & (x < W) & (y >= 0) & (y < H)
              & (z >= 0) & (z < D))
        val = med.density[jnp.clip(z, 0, D - 1), jnp.clip(y, 0, H - 1),
                          jnp.clip(x, 0, W - 1)]
        return jnp.where(ok, val, 0.0)

    d00 = tap(0, 0, 0) * (1 - f[..., 0]) + tap(1, 0, 0) * f[..., 0]
    d10 = tap(0, 1, 0) * (1 - f[..., 0]) + tap(1, 1, 0) * f[..., 0]
    d01 = tap(0, 0, 1) * (1 - f[..., 0]) + tap(1, 0, 1) * f[..., 0]
    d11 = tap(0, 1, 1) * (1 - f[..., 0]) + tap(1, 1, 1) * f[..., 0]
    d0 = d00 * (1 - f[..., 1]) + d10 * f[..., 1]
    d1 = d01 * (1 - f[..., 1]) + d11 * f[..., 1]
    return jnp.where(inside, d0 * (1 - f[..., 2]) + d1 * f[..., 2], 0.0)


# ---------------------------------------------------------------------------
# Henyey–Greenstein (medium.h:50-102, medium.cpp HenyeyGreenstein)
# ---------------------------------------------------------------------------

def hg_phase(cos_theta: Array, g: Array) -> Array:
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / jnp.maximum(
        denom * jnp.sqrt(jnp.maximum(denom, 1e-9)), 1e-9)


def sample_hg(wo: Array, u: Array, g: Array):
    """Sample wi ~ HG around -wo... pbrt convention: phase(wo·wi); sampling
    produces wi with cosTheta measured against wo's frame
    (medium.cpp HenyeyGreenstein::Sample_p). Returns (wi, phase_val)."""
    g_safe = jnp.where(jnp.abs(g) > 1e-3, g, 1e-3 * jnp.sign(g + 1e-9))
    sq = (1.0 - g * g) / (1.0 + g - 2.0 * g * u[..., 0])
    cos_theta_g = -(1.0 + g * g - sq * sq) / (2.0 * g_safe)
    cos_theta_iso = 1.0 - 2.0 * u[..., 0]
    cos_theta = jnp.where(jnp.abs(g) < 1e-3, cos_theta_iso, cos_theta_g)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * jnp.pi * u[..., 1]
    v1, v2 = vecmath.coordinate_system(wo)
    wi = (sin_theta * jnp.cos(phi))[..., None] * v1 \
        + (sin_theta * jnp.sin(phi))[..., None] * v2 \
        + cos_theta[..., None] * wo
    return wi, hg_phase(cos_theta, g)


# ---------------------------------------------------------------------------
# transmittance & distance sampling
# ---------------------------------------------------------------------------

_MAX_TRACKING_STEPS = 64


def transmittance(med: Medium, p0: Array, p1: Array, u_seed: Array) -> Array:
    """Tr between two points. Homogeneous: closed-form Beer–Lambert
    (homogeneous.cpp Tr); grid: ratio tracking (grid.cpp:85-87) with a
    hash-seeded tracking RNG. Returns (R,C)."""
    d = p1 - p0
    dist = vecmath.length(d)
    if not med.is_grid:
        tau = med.sigma_t[None, :] * dist[..., None]
        return jnp.exp(-jnp.minimum(tau, 80.0))

    # ratio tracking along the segment
    from pbrt_tpu.core import rng as rng_mod
    sigma_t_bar = jnp.max(med.sigma_t) * med.max_density
    inv_maj = 1.0 / jnp.maximum(sigma_t_bar, 1e-9)
    dn = d / jnp.maximum(dist, 1e-9)[..., None]

    def body(i, carry):
        t, tr, alive = carry
        u = rng_mod.uniform(u_seed, i, 9001)
        t = t - jnp.log(1.0 - u) * inv_maj
        ok = alive & (t < dist)
        dens = density_at(med, p0 + t[..., None] * dn)
        ratio = 1.0 - dens * jnp.max(med.sigma_t) * inv_maj
        tr = jnp.where(ok, tr * jnp.maximum(ratio, 0.0), tr)
        return t, tr, ok

    # carry init derived from `dist` for shard_map varying-type agreement
    # (see the note in sample_distance's loop)
    t0 = dist * 0.0
    tr0 = t0 + 1.0
    _, tr, _ = jax.lax.fori_loop(0, _MAX_TRACKING_STEPS, body,
                                 (t0, tr0, dist >= 0.0))
    # spectral shape via homogeneous ratio of sigma_t channels
    w = med.sigma_t / jnp.maximum(jnp.max(med.sigma_t), 1e-9)
    return jnp.power(jnp.maximum(tr, 1e-9)[..., None], w[None, :])


def sample_distance(med: Medium, o: Array, dn: Array, t_max: Array,
                    u: Array, u_seed: Array):
    """Sample a medium interaction along [0, t_max).

    Homogeneous (homogeneous.cpp Sample): channel-uniform exponential with
    MIS-averaged pdf. Grid: delta tracking (grid.cpp Sample).
    Returns (t (R,), sampled_medium (R,), weight_medium (R,C),
    weight_surface (R,C)) where the weights are beta multipliers:
    sigma_s·Tr/pdf for medium events, Tr/pdf for surface events.
    """
    C = med.sigma_t.shape[0]
    if not med.is_grid:
        ch = jnp.minimum((u * C).astype(jnp.int32), C - 1)
        from pbrt_tpu.ops import fastgather
        sig_ch = fastgather.gather_rows(med.sigma_t, ch)
        u2 = jnp.mod(u * C, 1.0)
        t = -jnp.log(jnp.maximum(1.0 - u2, 1e-9)) / jnp.maximum(sig_ch,
                                                                1e-9)
        sampled = t < t_max
        t_eff = jnp.minimum(t, t_max)
        tr = jnp.exp(-jnp.minimum(
            med.sigma_t[None, :] * t_eff[..., None], 80.0))
        # pdf averaged over channels (homogeneous.cpp:71-76)
        pdf_med = jnp.mean(med.sigma_t[None, :] * tr, axis=-1)
        pdf_surf = jnp.mean(tr, axis=-1)
        w_med = tr * med.sigma_s[None, :] / jnp.maximum(pdf_med,
                                                        1e-20)[..., None]
        w_surf = tr / jnp.maximum(pdf_surf, 1e-20)[..., None]
        return t_eff, sampled, w_med, w_surf

    # delta tracking (grid.cpp:51-84); collapses the spectrum to the
    # majorant channel ratio (spectrally-uniform grids assumed, as in the
    # reference's usage)
    from pbrt_tpu.core import rng as rng_mod
    sigma_t_max = jnp.max(med.sigma_t)
    maj = sigma_t_max * med.max_density
    inv_maj = 1.0 / jnp.maximum(maj, 1e-9)

    def body(i, carry):
        t, done, hit_medium = carry
        u1 = rng_mod.uniform(u_seed, i, 9002)
        u2 = rng_mod.uniform(u_seed, i, 9003)
        t_new = t - jnp.log(1.0 - u1) * inv_maj
        past = t_new >= t_max
        dens = density_at(med, o + t_new[..., None] * dn)
        real = u2 < dens * sigma_t_max * inv_maj
        newly_hit = ~done & ~past & real
        t = jnp.where(done, t, jnp.where(past, t_max, t_new))
        hit_medium = hit_medium | newly_hit
        done = done | past | newly_hit
        return t, done, hit_medium

    # derive the carry init from t_max so its varying-axes type matches
    # the body's output under shard_map (a fresh constant is "unvarying"
    # and lax.fori_loop rejects the mismatched carry — r4, grid volpath
    # through the sharded path)
    t0 = t_max * 0.0
    done0 = t_max < 0.0
    t, _, sampled = jax.lax.fori_loop(
        0, _MAX_TRACKING_STEPS, body, (t0, done0, done0))
    w_med = jnp.broadcast_to((med.sigma_s
                              / jnp.maximum(med.sigma_t, 1e-9))[None, :],
                             t.shape + (C,))
    w_surf = jnp.ones(t.shape + (C,))
    return t, sampled, w_med, w_surf


# ---------------------------------------------------------------------------
# Per-primitive medium sets (MediumInterface, core/medium.h:114 +
# GeometricPrimitive's inside/outside media). Media live in a static tuple
# on the Scene; rays carry a per-lane medium id (−1 = vacuum) and the set
# functions dispatch by masked evaluation over the (small, static) tuple.
# ---------------------------------------------------------------------------

def transmittance_set(media, med_id: Array, p0: Array, p1: Array,
                      u_seed: Array) -> Array:
    """Tr between two points through the per-lane medium ``med_id``
    (−1 → vacuum, Tr = 1). media: static tuple of Medium."""
    C = media[0].sigma_t.shape[0] if media else 3
    out = jnp.ones(p0.shape[:-1] + (C,))
    for k, med in enumerate(media):
        tr_k = transmittance(med, p0, p1, u_seed)
        out = jnp.where((med_id == k)[..., None], tr_k, out)
    return out


def sample_distance_set(media, med_id: Array, o: Array, dn: Array,
                        t_max: Array, u: Array, u_seed: Array):
    """sample_distance dispatched on per-lane medium id; vacuum lanes never
    scatter (sampled=False, weights=1)."""
    C = media[0].sigma_t.shape[0] if media else 3
    R = t_max.shape
    t = jnp.minimum(t_max, t_max)
    sampled = jnp.zeros(R, bool)
    w_med = jnp.ones(R + (C,))
    w_surf = jnp.ones(R + (C,))
    for k, med in enumerate(media):
        t_k, s_k, wm_k, ws_k = sample_distance(med, o, dn, t_max, u, u_seed)
        sel = med_id == k
        t = jnp.where(sel, t_k, t)
        sampled = jnp.where(sel, s_k, sampled)
        w_med = jnp.where(sel[..., None], wm_k, w_med)
        w_surf = jnp.where(sel[..., None], ws_k, w_surf)
    return t, sampled, w_med, w_surf


def phase_g_set(media, med_id: Array) -> Array:
    """Per-lane HG asymmetry g for the lane's current medium (0 in vacuum)."""
    g = jnp.zeros(med_id.shape)
    for k, med in enumerate(media):
        g = jnp.where(med_id == k, med.g, g)
    return g
