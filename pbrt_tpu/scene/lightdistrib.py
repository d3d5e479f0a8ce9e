"""Light-selection distributions: uniform, power, spatial.

JAX counterpart of ``core/lightdistrib.{h,cpp}``:
UniformLightDistribution, PowerLightDistribution, and
SpatialLightDistribution (:69-104) — the spatial one voxelizes the scene
bounds (≤64 voxels/axis, lightdistrib.cpp:106) and Monte-Carlo-estimates
each light's contribution per voxel to build per-voxel CDFs
(lightdistrib.cpp:183-257). pbrt's lock-free on-demand hash table
(:91-117) becomes a dense precomputed (V, L) table — device memory is
cheap, hashing is not.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from pbrt_tpu.core import rng as rng_mod
from pbrt_tpu.core import vecmath
from pbrt_tpu.core.sampling import (Distribution1D, make_distribution_1d,
                                    sample_distribution_1d_discrete)
from pbrt_tpu.scene import lights as lights_mod

Array = Any

MAX_VOXELS_PER_AXIS = 16   # reference uses 64; 16³ is ample at our scenes
N_EST_SAMPLES = 32         # MC samples per (voxel, light) estimate


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SpatialLightDistribution:
    cdf: Array        # (V, L+1) per-voxel CDF
    func: Array       # (V, L)
    func_int: Array   # (V,)
    res: Array        # (3,) int32 voxel grid resolution


def build_spatial_distribution(scene) -> SpatialLightDistribution:
    """Precompute per-voxel light CDFs (SpatialLightDistribution ctor +
    ComputeDistribution, lightdistrib.cpp:106-257)."""
    L = scene.lights.n
    lo = scene.world_lo
    hi = scene.world_hi
    diag = hi - lo
    # fixed cubic voxel grid (static shape; the reference scales per-axis
    # resolution to the bounds, lightdistrib.cpp:97-106 — a uniform 16^3
    # grid keeps the table jit-compatible at equivalent granularity)
    res_np = [MAX_VOXELS_PER_AXIS] * 3
    V = res_np[0] * res_np[1] * res_np[2]

    # voxel centers + jittered sample points
    vox = jnp.arange(V)
    vz = vox % res_np[2]
    vy = (vox // res_np[2]) % res_np[1]
    vx = vox // (res_np[2] * res_np[1])
    vmin = lo + jnp.stack([vx, vy, vz], -1).astype(jnp.float32) \
        / jnp.asarray(res_np, jnp.float32) * diag
    vsize = diag / jnp.asarray(res_np, jnp.float32)

    # estimate each light's contribution from jittered points in the voxel
    # (lightdistrib.cpp:219-247: Sample_Li without visibility)
    func = jnp.zeros((V, L))
    for li in range(L):
        acc = jnp.zeros(V)
        for s in range(N_EST_SAMPLES):
            u = jnp.stack(
                [rng_mod.uniform(vox.astype(jnp.uint32), s, 3 * li + k)
                 for k in range(3)], -1)
            p = vmin + u * vsize
            u2 = jnp.stack(
                [rng_mod.uniform(vox.astype(jnp.uint32), s, 100 + k)
                 for k in range(2)], -1)
            ls = lights_mod.sample_li(
                scene, jnp.full(V, li, jnp.int32), p, u2)
            lum = jnp.sum(ls["li"], -1) / jnp.maximum(ls["pdf"], 1e-9)
            acc = acc + jnp.where(jnp.isfinite(lum), lum, 0.0)
        func = func.at[:, li].set(acc / N_EST_SAMPLES)
    # keep a floor so no light is unreachable (lightdistrib.cpp:249-253)
    fmax = jnp.max(func, axis=-1, keepdims=True)
    func = jnp.maximum(func, 1e-3 * fmax + 1e-12)
    d = make_distribution_1d(func)
    return SpatialLightDistribution(cdf=d.cdf, func=d.func,
                                    func_int=d.func_int,
                                    res=jnp.asarray(res_np, jnp.int32))


def lookup_voxel(dist: SpatialLightDistribution, scene, p: Array) -> Array:
    lo = scene.world_lo
    hi = scene.world_hi
    u = (p - lo) / jnp.maximum(hi - lo, 1e-9)
    res = dist.res
    c = jnp.clip((u * res.astype(jnp.float32)).astype(jnp.int32), 0,
                 res - 1)
    return (c[..., 0] * res[1] + c[..., 1]) * res[2] + c[..., 2]


def sample_spatial(dist: SpatialLightDistribution, scene, p: Array,
                   u: Array):
    """Pick a light per shading point from its voxel's CDF.
    Returns (light_idx, pmf)."""
    vox = lookup_voxel(dist, scene, p)
    d = Distribution1D(func=dist.func[vox], cdf=dist.cdf[vox],
                      func_int=dist.func_int[vox])
    return sample_distribution_1d_discrete(d, u)
