"""Metropolis light transport (primary-sample-space).

JAX counterpart of ``integrators/mlt.cpp``: MLTSampler's
primary-sample vector with large/small mutations (:75-95), bootstrap
normalization b (:177-200), and Markov chains splatting accepted/rejected
proposals (:165-183 onward).

The sequential-chain problem (SURVEY.md §7 hard part #2) is solved by
running thousands of *parallel* chains, one per SIMD lane: every mutation
step is a full wavefront path-trace of all chains at once, and the film
splats are batched scatter-adds. The target function is the path
integrator's radiance driven by an explicit primary-sample vector (the
sampler function reads X[dim] instead of hashing).
"""

from __future__ import annotations

from typing import Any

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core import rng as rng_mod
from pbrt_tpu.core import spectrum as spec_mod
from pbrt_tpu.core import vecmath
from pbrt_tpu.integrators.render import RenderConfig, _INTEGRATORS
from pbrt_tpu.scene import camera as cam_mod
from pbrt_tpu.scene import film as film_mod

Array = Any

SIGMA = 0.01           # mlt.cpp small-step sigma
P_LARGE = 0.3          # large-step probability


def _n_dims(max_depth):
    return 6 + (max_depth + 1) * 10


def _eval_target(scene, cam, X, cfg):
    """Radiance + film position for primary samples X (R, D)."""
    R = X.shape[0]
    res = cam.resolution.astype(jnp.float32)
    p_film = X[:, 0:2] * res[None, :]

    def sfn(pid, sidx, dim, seed=0):
        # integrator dim indices are Python ints → static column slices
        # (zero-cost); a traced dim falls back to a one-hot dot over the
        # D axis rather than take_along_axis's per-ray index gather
        # (the small-table gather strategy of ops/fastgather.py)
        if isinstance(dim, (int, np.integer)):
            return X[:, min(int(dim), X.shape[1] - 1)]
        from pbrt_tpu.ops import fastgather
        d = jnp.broadcast_to(jnp.asarray(dim, jnp.int32), (R,))
        return fastgather.select_along_last(X, d)

    rays = cam_mod.generate_rays(cam, p_film, X[:, 2:4], X[:, 4])
    pid = jnp.zeros(R, jnp.uint32)
    sidx = jnp.zeros(R, jnp.uint32)
    li_fn = _INTEGRATORS[cfg.integrator]
    L = li_fn(scene, rays.o, rays.d, pid, sidx, sfn, cfg, None)
    bad = (~jnp.isfinite(L)).any(-1)
    L = jnp.where(bad[..., None], 0.0, L)
    I = spec_mod.luminance(
        L, spec_mod.RGB if scene.n_channels == 3 else spec_mod.SAMPLED)
    I = jnp.maximum(I, 0.0)
    return L, I, p_film


def _mutate(X, step_key, chain_ids, p_large=P_LARGE):
    """Large-step (fresh uniforms) or small-step (gaussian perturbation
    wrapped to [0,1)) — MLTSampler mutations (mlt.cpp:75-95)."""
    R, D = X.shape
    u_kind = rng_mod.uniform(chain_ids, step_key, 9990)
    is_large = u_kind < p_large
    dims = jnp.arange(D, dtype=jnp.uint32)
    u = rng_mod.u32_to_uniform(rng_mod.pcg4d(
        jnp.broadcast_to(chain_ids[:, None], (R, D)).astype(jnp.uint32),
        jnp.broadcast_to(jnp.uint32(step_key), (R, D)),
        jnp.broadcast_to(dims[None, :], (R, D)),
        jnp.full((R, D), 7, jnp.uint32))[0])
    # small step: inverse-CDF gaussian perturbation
    eps = 1e-6
    g = jnp.sqrt(2.0) * jax.scipy.special.erfinv(
        jnp.clip(2.0 * u - 1.0, -1 + eps, 1 - eps))
    X_small = jnp.mod(X + SIGMA * g, 1.0)
    return jnp.where(is_large[:, None], u, X_small), is_large


@functools.partial(jax.jit, static_argnames=("cfg",))
def _eval_target_jit(scene, cam, X, cfg):
    return _eval_target(scene, cam, X, cfg)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "n_steps", "width", "height"))
def _mlt_chains(scene, cam, X, b, seed, cfg, n_steps, width, height):
    """The whole Markov-chain phase as ONE cached program: n_steps
    Metropolis mutations of all chains with per-step film splats
    (mlt.cpp:212-249). `seed` and the bootstrap normalization `b` are
    TRACED, so re-rendering with a new seed (or refined b) is a cache
    hit — r5: per-seed wall time was ~33 s of recompile because the old
    driver rebuilt per-call jit closures."""
    R = X.shape[0]
    C = scene.n_channels
    chain_ids = jnp.arange(R, dtype=jnp.uint32)

    def chain_step(step, carry):
        X, L_cur, I_cur, p_cur, film = carry
        X_prop, is_large = _mutate(X, step, chain_ids)
        L_prop, I_prop, p_prop = _eval_target(scene, cam, X_prop, cfg)
        a = jnp.minimum(1.0, I_prop / jnp.maximum(I_cur, 1e-12))
        a = jnp.where(I_cur <= 0, 1.0, a)
        # splat weights (mlt.cpp:230-240)
        w_prop = (a + is_large.astype(jnp.float32)) \
            / jnp.maximum(I_prop / b + P_LARGE, 1e-12)
        w_cur = (1.0 - a) / jnp.maximum(I_cur / b + P_LARGE, 1e-12)
        film = film_mod.splat(film, p_prop, L_prop * w_prop[:, None],
                              I_prop > 0)
        film = film_mod.splat(film, p_cur, L_cur * w_cur[:, None],
                              I_cur > 0)
        u_acc = rng_mod.uniform(chain_ids, step, 9992, seed)
        accept = u_acc < a
        X = jnp.where(accept[:, None], X_prop, X)
        L_cur = jnp.where(accept[:, None], L_prop, L_cur)
        I_cur = jnp.where(accept, I_prop, I_cur)
        p_cur = jnp.where(accept[:, None], p_prop, p_cur)
        return X, L_cur, I_cur, p_cur, film

    L0, I0, p0 = _eval_target(scene, cam, X, cfg)
    film = jnp.zeros((height, width, C))
    carry = (X, L0, I0, p0, film)
    carry = jax.lax.fori_loop(0, n_steps, chain_step, carry)
    return carry[4]


def render_mlt(scene, cam, mutations_per_pixel=4, n_chains=4096,
               n_bootstrap=16384, max_depth=5, seed=0,
               integrator="path"):
    """MLTIntegrator::Render (mlt.cpp:165+). The integrator dims read
    static X columns, so `seed` only feeds the counter-RNG streams —
    it is threaded as a TRACED argument and a seed change never
    recompiles (the config/shape tuple keys the jit cache)."""
    res = np.asarray(cam.resolution)
    width, height = int(res[0]), int(res[1])
    C = scene.n_channels
    D = _n_dims(max_depth)
    cfg = RenderConfig(integrator=integrator, max_depth=max_depth, seed=0)
    seed_u = jnp.asarray(seed, jnp.uint32)

    # --- bootstrap: b = E[I] over uniform primary samples (mlt.cpp:177-200)
    boot_ids = jnp.arange(n_bootstrap, dtype=jnp.uint32)
    Xb = rng_mod.u32_to_uniform(rng_mod.pcg4d(
        jnp.broadcast_to(boot_ids[:, None], (n_bootstrap, D)),
        jnp.broadcast_to(jnp.arange(D, dtype=jnp.uint32)[None, :],
                         (n_bootstrap, D)),
        jnp.broadcast_to(seed_u, (n_bootstrap, D)),
        jnp.full((n_bootstrap, D), 11, jnp.uint32))[0])
    _, I_boot, _ = _eval_target_jit(scene, cam, Xb, cfg)
    b = float(jnp.mean(I_boot))
    if b <= 0:
        return jnp.zeros((height, width, C))

    # initial chain states resampled from bootstrap ∝ I (mlt.cpp:204-210)
    from pbrt_tpu.core.sampling import (make_distribution_1d,
                                        sample_distribution_1d_discrete)
    distr = make_distribution_1d(I_boot)
    chain_ids = jnp.arange(n_chains, dtype=jnp.uint32)
    u0 = rng_mod.uniform(chain_ids, 0, 9991, seed_u)
    start_idx, _ = sample_distribution_1d_discrete(distr, u0)
    X = Xb[start_idx]

    n_steps = max(1, (width * height * mutations_per_pixel) // n_chains)
    film = _mlt_chains(scene, cam, X, jnp.asarray(b, jnp.float32),
                       seed_u, cfg, n_steps, width, height)
    total_mutations = n_steps * n_chains
    total_mutations = n_steps * n_chains
    # NOTE: with Kelemen-style MIS weights the 1/b normalization already
    # lives inside w = ·/(I/b + pLarge); the final scale is only
    # mutations→pixel-area (pbrt's b/mpp scale pairs with its simpler
    # L·a/I splat, mlt.cpp:243-249 — multiplying by b here double-counts)
    scale = 1.0 / (total_mutations / (width * height))
    return film * scale
