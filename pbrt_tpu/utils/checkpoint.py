"""Render checkpoint/resume — capability the reference lacks (SURVEY.md §5:
the reference writes the film once at the end; this adds film +
sampler-state checkpointing).

The film accumulator + spp progress + RNG seed are pure data, so a
checkpoint is one npz; resuming continues at the recorded spp offset with
bit-identical sample streams (counter-based RNG keys on absolute sample
index, so resumed renders equal uninterrupted ones).
"""

from __future__ import annotations

import os

import numpy as np


def save_checkpoint(path: str, film_sum: np.ndarray, spp_done: int,
                    seed: int, meta: dict = None):
    tmp = path + ".tmp"
    np.savez_compressed(tmp, film_sum=np.asarray(film_sum),
                        spp_done=spp_done, seed=seed,
                        **{f"meta_{k}": v for k, v in (meta or {}).items()})
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str):
    z = np.load(path, allow_pickle=False)
    meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return dict(film_sum=z["film_sum"], spp_done=int(z["spp_done"]),
                seed=int(z["seed"]), meta=meta)


def render_with_checkpoints(scene, cam, spp, checkpoint_path,
                            every_spp=32, **render_kwargs):
    """Chunked render that persists the film after every `every_spp`
    samples and resumes from an existing checkpoint file."""
    import jax.numpy as jnp

    from pbrt_tpu.integrators.render import (RenderConfig, render_pass)
    from pbrt_tpu.scene import film as film_mod

    res = np.asarray(cam.resolution)
    w, h = int(res[0]), int(res[1])
    filt = film_mod.make_filter(render_kwargs.pop("filter_name", "box"))
    cfg = RenderConfig(
        integrator=render_kwargs.pop("integrator", "path"),
        sampler=render_kwargs.pop("sampler", "independent"),
        max_depth=render_kwargs.pop("max_depth", 5),
        seed=render_kwargs.pop("seed", 0))

    done = 0
    film = np.zeros((h, w, scene.n_channels), np.float32)
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = load_checkpoint(checkpoint_path)
        film = ck["film_sum"]
        done = ck["spp_done"]
    while done < spp:
        c = min(every_spp, spp - done)
        out = render_pass(scene, cam, filt, cfg, w, h, c,
                          jnp.asarray(done, jnp.uint32))
        film = film + np.asarray(out)
        done += c
        if checkpoint_path:
            save_checkpoint(checkpoint_path, film, done, cfg.seed)
    return film / spp
