"""Benchmark: Mrays/s fwd+bwd on the cornell portal scene, on one GPU.

Workload: the cornell-portal scene (__graft_entry__._portal_scene), 256²
pixels × 64 spp in two 32-spp passes of 2,097,152 lanes each, max_depth
4, one jitted value_and_grad of the mean image w.r.t. the material
albedos (kd) and the light's emission — the inverse-rendering step.

Ray accounting: `value` counts the closest-hit sweeps actually traced.
With the fused path-bounce kernel (ops/fused_path.py, dispatched by
render_pass on this scene) each sample traces (max_depth+1) extension
sweeps plus one portal-NEE sweep per non-final bounce, and the backward
pass differentiates the residual replay without tracing again. The
generic wavefront loop traces 3 sweeps per bounce and its VJP traces
them all again (×2).

Times come from the host clock around passes that end in
block_until_ready; compilation is reported apart. The run needs a GPU
and fails without one. Prints ONE JSON line.
"""

from __future__ import annotations

import dataclasses as dc
import json
import os
import subprocess
import sys
import time

METRIC = "Mrays/s/chip fwd+bwd (cornell portal scene, 64spp)"
RES = 256
SPP = 64
CHUNK = 32          # 256²·32 = 2,097,152 lanes per pass
MAX_DEPTH = 4       # bounces = max_depth + 1 loop iterations


def card_info() -> str:
    """`name, power.limit` of the card as nvidia-smi reports it (a child
    process that stays off JAX), or why it could not be read."""
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return p.stdout.strip() or p.stderr.strip()


def device_info() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def setup(res=RES, max_depth=MAX_DEPTH):
    """Bench scene, camera, box filter and path config on the default
    device."""
    import __graft_entry__ as ge
    from pbrt_tpu.integrators.render import RenderConfig
    from pbrt_tpu.scene import film as film_mod
    scene = ge._portal_scene()
    cam = ge._camera((res, res))
    cfg = RenderConfig(integrator="path", max_depth=max_depth)
    return scene, cam, film_mod.make_filter("box"), cfg


def make_step(scene, cam, filt, cfg, res, chunk):
    """jit(value_and_grad) of the mean `chunk`-spp image of render_pass
    w.r.t. (kd, emit); returns ((loss, image), (d_kd, d_emit)) for (kd,
    emit, offset). On the GPU render_pass dispatches the fused kernel for
    a scene with a fused profile; a scene without one
    (``dc.replace(scene, fused_profile=None)``) runs _li_loop on the same
    rays."""
    import jax
    import jax.numpy as jnp
    from pbrt_tpu.integrators.render import render_pass

    def loss(kd, emit, off):
        s = dc.replace(scene,
                       materials=dc.replace(scene.materials, kd=kd),
                       lights=dc.replace(scene.lights, emit=emit))
        img = render_pass(s, cam, filt, cfg, res, res, chunk, off)
        return jnp.mean(img), img

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


def time_fwdbwd(step, kd, emit, spp=SPP, chunk=CHUNK, reps=5):
    """Median seconds for one full `spp` fwd+bwd (spp/chunk passes), each
    repetition ending in block_until_ready."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    offs = [jnp.asarray(i * chunk, jnp.uint32) for i in range(spp // chunk)]
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = [step(kd, emit, off) for off in offs]
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def sweeps_per_sample(fused: bool, mode, max_depth=MAX_DEPTH):
    """Closest-hit sweeps per sample over fwd+bwd (see module doc)."""
    if not fused:
        return 3 * (max_depth + 1) * 2
    # mode 1 (portal, light-only NEE): extensions + one shadow sweep per
    # non-final bounce; mode 0 (area light, two-sample MIS) two
    return (max_depth + 1) + (1 if mode == 1 else 2) * max_depth


def main():
    import jax
    from pbrt_tpu.ops import fused_path
    from pbrt_tpu.utils import compile_cache

    compile_cache.enable()
    dev = device_info()
    if dev["platform"] != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev}")
    card = card_info()
    print(f"card: {card}", file=sys.stderr)

    scene, cam, filt, cfg = setup()
    step = make_step(scene, cam, filt, cfg, RES, CHUNK)
    kd, emit = scene.materials.kd, scene.lights.emit
    t0 = time.perf_counter()
    (v, _), _ = jax.block_until_ready(
        step(kd, emit, jax.numpy.asarray(0, jax.numpy.uint32)))
    t_compile = time.perf_counter() - t0

    t_fwdbwd, ts = time_fwdbwd(step, kd, emit)
    fused_on = fused_path.eligible(scene, cfg)
    sweeps = sweeps_per_sample(fused_on, scene.fused_profile[4])
    rays = RES * RES * SPP * sweeps
    print(json.dumps({
        "metric": METRIC,
        "value": rays / t_fwdbwd / 1e6,
        "unit": "Mrays/s",
        "vs_baseline": None,
        "extra": {
            "t_fwdbwd_s": t_fwdbwd,
            "t_fwdbwd_runs_s": ts,
            "t_compile_s": t_compile,
            "fused_kernel": bool(fused_on),
            "sweeps_per_sample": sweeps,
            "resolution": [RES, RES], "spp": SPP, "chunk": CHUNK,
            "max_depth": MAX_DEPTH,
            "image_mean_first_pass": float(v) / CHUNK,
            "device": dev,
            "card": card,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
        },
    }))


if __name__ == "__main__":
    main()
