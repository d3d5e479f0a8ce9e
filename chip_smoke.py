"""Smoke run of the renderer's main paths on one GPU.

    python chip_smoke.py               # CLI, bench and BVH phases, 1 card
    python chip_smoke.py --four-cards  # only the sharded phase, 4 cards

Phases (each compares the card's result with the repo's plain reference):

- cli: ``pbrt_tpu.utils.cli.main`` on tests/oracle/cornell_dielectric_
  oracle.pbrt (hero_path_mis, 60 spectral bins, dispersive glass) against
  the reference binary's image, by the metric and limits of
  tests/test_oracle.py.
- bench: fwd+bwd of render_pass on the cornell-portal scene at the bench
  size (256² × 32-spp chunk = 2,097,152 lanes, max_depth 4), with the
  fused path kernel compiled for the card (its Triton call checked in
  the compiled step), against _li_loop on the same rays: images and
  kd/emit gradients, then the time of both.
- bvh: a seeded terrain mesh of 50,562 triangles rendered through
  render(), and _traverse_batch's closest hits against _intersect_brute
  on 65,536 rays.
- sharded (--four-cards): render_sharded on a dp=2 × sp=2 mesh against a
  single-device render(), and two make_train_step steps against the
  single-device step.

The phase functions take their sizes (and, where a Pallas kernel runs,
``interpret``) as arguments so the CPU tests can call them at tiny sizes;
``main()`` always runs on the GPU at full size, in this one process. It
exits non-zero, printing no result line, when JAX finds no GPU or any
phase fails. The last line on success is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
"""

from __future__ import annotations

import dataclasses as dc
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(HERE, "tests", "oracle")

# comparison limits (stated with their reasons in PERF.md)
PIX_ATOL = 1e-4       # per-sample mean radiance, absolute
PIX_FRAC = 0.999      # share of pixels that must meet PIX_ATOL
GRAD_RTOL = 1e-4      # max|g - g_ref| / max|g_ref|


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pixel_agreement(img, ref):
    """(share of pixels within PIX_ATOL on every channel, max abs diff)."""
    d = np.abs(np.asarray(img, np.float64) - np.asarray(ref, np.float64))
    d = d.reshape(-1, d.shape[-1]).max(-1)
    return float((d <= PIX_ATOL).mean()), float(d.max())


def _log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_cli(spp=32, md_max=0.05, bl_max=0.20):
    """The CLI in-process on the dielectric oracle scene, compared with
    the reference binary's render (tests/test_oracle.py's metric)."""
    from pbrt_tpu.tools import imgtool
    from pbrt_tpu.utils import cli, imageio

    scene = os.path.join(ORACLE, "cornell_dielectric_oracle.pbrt")
    ref = np.asarray(imageio.read_pfm(
        os.path.join(ORACLE, "cornell_dielectric_ref.pfm")))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell_dielectric.pfm")
        t0 = time.perf_counter()
        cli.main([scene, "--spp", str(spp), "--quiet", "-o", out])
        wall = time.perf_counter() - t0
        img = np.asarray(imageio.read_pfm(out))
    assert img.shape == ref.shape, (img.shape, ref.shape)
    assert np.isfinite(img).all(), "non-finite pixels"
    md = imgtool.mean_delta(img, ref)
    bl = imgtool.block_rel_l1(img, ref, k=16)
    res = {"spp": spp, "mean_delta": md, "mean_delta_max": md_max,
           "block_rel_l1": bl, "block_rel_l1_max": bl_max,
           "wall_s_with_compile": wall}
    assert md < md_max and bl < bl_max, res
    return res


def _fused_calls(hlo_text) -> int:
    """Triton custom calls of the fused path kernel in a compiled step."""
    return sum(1 for ln in hlo_text.splitlines()
               if "__gpu$xla.gpu.triton" in ln and "fused_path" in ln)


def _lane_steps(scene, cam, cfg, res, chunk):
    """The A/B where no card is present, so eligible() keeps render_pass
    off the kernel: li_path_fused in interpret mode against _li_loop on
    the same pixel-centre camera rays, each summed per pixel. Steps have
    bench.make_step's signature and outputs."""
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.integrators.render import _li_loop
    from pbrt_tpu.ops import fused_path
    from pbrt_tpu.samplers import make_sampler
    from pbrt_tpu.scene import camera as cam_mod

    n_pix = res * res
    pid = jnp.tile(jnp.arange(n_pix, dtype=jnp.uint32), chunk)
    sidx = jnp.repeat(jnp.arange(chunk, dtype=jnp.uint32), n_pix)
    p_film = jnp.stack([pid % res, pid // res], -1).astype(jnp.float32)
    rays = cam_mod.generate_rays(cam, p_film + 0.5, jnp.zeros_like(p_film),
                                 jnp.zeros(pid.shape))
    sfn = make_sampler(cfg.sampler, resolution=(res, res))

    def make(li):
        def loss(kd, emit, off):
            s = dc.replace(scene,
                           materials=dc.replace(scene.materials, kd=kd),
                           lights=dc.replace(scene.lights, emit=emit))
            L = li(s, pid, sidx + off)
            img = L.reshape(chunk, n_pix, -1).sum(0).reshape(res, res, -1)
            return jnp.mean(img), img
        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True))

    return {"kernel": make(lambda s, p, i: fused_path.li_path_fused(
                s, rays.o, rays.d, p, i, cfg, interpret=True)),
            "li_loop": make(lambda s, p, i: _li_loop(
                s, rays.o, rays.d, p, i, sfn, cfg, None))}


def phase_bench(res=256, chunk=32, max_depth=4, interpret=False,
                time_reps=0, spp=64):
    """fwd+bwd of the bench step with the fused kernel against _li_loop
    on the same camera rays: image and kd/emit gradients; optionally the
    median time of a full `spp` fwd+bwd on each path, taken in turns.

    On the card both sides are render_pass: the bench scene dispatches
    the kernel, the same scene without its fused profile runs _li_loop,
    and the compiled steps are checked to hold the kernel's Triton call
    and not to hold it. With ``interpret`` (CPU) see _lane_steps."""
    import jax
    import jax.numpy as jnp

    import bench

    scene, cam, filt, cfg = bench.setup(res, max_depth)
    if interpret:
        steps = _lane_steps(scene, cam, cfg, res, chunk)
    else:
        plain = dc.replace(scene, fused_profile=None)
        steps = {name: bench.make_step(s, cam, filt, cfg, res, chunk)
                 for name, s in (("kernel", scene), ("li_loop", plain))}

    kd, emit = scene.materials.kd, scene.lights.emit
    off = jnp.asarray(0, jnp.uint32)
    out = {"lanes": res * res * chunk}
    results = {}
    for name in steps:
        t0 = time.perf_counter()
        compiled = steps[name].lower(kd, emit, off).compile()
        out[f"compile_s_{name}"] = time.perf_counter() - t0
        out[f"memory_{name}"] = str(compiled.memory_analysis())
        out[f"fused_calls_{name}"] = _fused_calls(compiled.as_text())
        steps[name] = compiled
        results[name] = jax.device_get(compiled(kd, emit, off))
    # the A/B compares the kernel with the loop, never the loop with itself
    out["fused_kernel_ran"] = interpret or out["fused_calls_kernel"] >= 1
    assert out["fused_kernel_ran"] and out["fused_calls_li_loop"] == 0, out

    (v_k, img_k), g_k = results["kernel"]
    (v_r, img_r), g_r = results["li_loop"]
    assert np.isfinite(img_k).all() and img_k.shape == (res, res, 3)
    frac, dmax = _pixel_agreement(img_k / chunk, img_r / chunk)
    out.update(image_mean=float(v_k) / chunk,
               pixels_within_atol=frac, pixel_atol=PIX_ATOL,
               pixel_max_abs_diff=dmax,
               grad_kd_rel=_rel(g_k[0], g_r[0]),
               grad_emit_rel=_rel(g_k[1], g_r[1]), grad_rtol=GRAD_RTOL)
    assert float(v_k) > 0, out
    assert np.abs(np.asarray(g_r[0])).max() > 0, out
    assert np.abs(np.asarray(g_r[1])).max() > 0, out
    assert frac >= PIX_FRAC, out
    assert out["grad_kd_rel"] <= GRAD_RTOL, out
    assert out["grad_emit_rel"] <= GRAD_RTOL, out

    if time_reps:
        runs = {"kernel": [], "li_loop": []}
        for name in ("kernel", "li_loop", "kernel", "li_loop"):
            t, _ = bench.time_fwdbwd(steps[name], kd, emit, spp=spp,
                                     chunk=chunk, reps=time_reps)
            runs[name].append(t)
        out["fwdbwd_s_kernel"] = runs["kernel"]
        out["fwdbwd_s_li_loop"] = runs["li_loop"]
        out["fwdbwd_spp"] = spp
    return out


def terrain_scene(n_side=160, seed=0, with_room=True):
    """Seeded heightfield terrain (scene/tessellate.py) of
    2·(n_side-1)² triangles, in the cornell room under a plain area light
    (``with_room``) or alone."""
    from pbrt_tpu.core.spectrum import RGB
    from pbrt_tpu.scene.tessellate import tessellate_heightfield
    from pbrt_tpu.scene.types import SceneBuilder

    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, n_side)
    X, Y = np.meshgrid(g, g)
    h = np.zeros_like(X)
    for _ in range(8):
        fx, fy = rng.uniform(-6.0, 6.0, 2)
        h += rng.uniform(0.2, 1.0) * np.sin(
            2 * np.pi * (fx * X + fy * Y) + rng.uniform(0, 2 * np.pi))
    h = (h - h.min()) / max(np.ptp(h), 1e-9)
    v, f, _ = tessellate_heightfield(n_side, n_side, h)
    world = np.stack([0.05 + 0.9 * v[:, 0], 0.02 + 0.3 * v[:, 2],
                      0.05 + 0.9 * v[:, 1]], -1)

    b = SceneBuilder(RGB)
    white = b.add_material(type=0, kd=(0.73, 0.73, 0.73))
    b.add_mesh(world, f, mat=white)
    if with_room:
        red = b.add_material(type=0, kd=(0.63, 0.065, 0.05))
        green = b.add_material(type=0, kd=(0.14, 0.45, 0.091))
        black = b.add_material(type=0, kd=0.0)
        for verts, m in [
                ([(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)], white),
                ([(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], white),
                ([(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)], red),
                ([(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)], green),
                ([(0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)], white)]:
            b.add_mesh(verts, [(0, 1, 2), (0, 2, 3)], mat=m)
        li = b.add_light(type="area", L=(15.0, 13.0, 9.0), prim=-1)
        pid = b.add_aaplane((0.3, 0.99, 0.35), (0.7, 0.99, 0.65), axis=1,
                            facing_fw=False, mat=black, light=li)
        b.light_rows[li]["prim"] = b.prim_index("pln", pid)
    return b.build(use_bvh="always")


def phase_bvh(n_side=160, n_rays=65536, res=128, spp=4, ray_chunk=2048,
              time_reps=0):
    """Render the terrain through render(); compare _traverse_batch with
    _intersect_brute on n_rays seeded rays; optionally time the
    traversal."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from pbrt_tpu import native
    from pbrt_tpu.integrators.render import render
    from pbrt_tpu.scene import bvh as bvh_mod
    from pbrt_tpu.scene import intersect as isect_mod

    out = {"bvh_builder": "native" if native.load() is not None
           else "numpy fallback"}
    t0 = time.perf_counter()
    room = terrain_scene(n_side, with_room=True)
    mesh = terrain_scene(n_side, with_room=False)
    out["scene_build_s"] = time.perf_counter() - t0
    out["triangles"] = int(mesh.n_tri)
    assert mesh.bvh is not None and room.bvh is not None

    t0 = time.perf_counter()
    img = np.asarray(render(room, ge._camera((res, res)), spp=spp,
                            max_depth=4))
    out["render_s_with_compile"] = time.perf_counter() - t0
    assert img.shape == (res, res, 3) and np.isfinite(img).all()
    out["render_mean"] = float(img.mean())
    assert out["render_mean"] > 0, out

    rng = np.random.default_rng(1)
    o = rng.uniform(0.0, 1.0, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    tmax = jnp.full(n_rays, 1e30, jnp.float32)

    trav = jax.jit(lambda o, d, t: bvh_mod._traverse_batch(
        mesh.bvh, o, d, t, False))

    @jax.jit
    def brute(o, d, t):
        def one(args):
            h = isect_mod._intersect_brute(mesh, *args)
            return jnp.where(h.valid, h.t, jnp.inf), h.prim_id
        n = o.shape[0] // ray_chunk
        tb, pb = jax.lax.map(one, (o.reshape(n, ray_chunk, 3),
                                   d.reshape(n, ray_chunk, 3),
                                   t.reshape(n, ray_chunk)))
        return tb.reshape(-1), pb.reshape(-1)

    t_b, leaf = jax.device_get(trav(o, d, tmax))
    prim_b = np.where(leaf >= 0, np.asarray(mesh.bvh.prim_order)[
        np.maximum(leaf, 0)], -1)
    t_b = np.where(leaf >= 0, t_b, np.inf)
    t_r, prim_r = jax.device_get(brute(o, d, tmax))
    hit_r = prim_r >= 0
    same_hit = (leaf >= 0) == hit_r
    both = (leaf >= 0) & hit_r
    t_err = np.abs(t_b[both] - t_r[both]) / np.maximum(t_r[both], 1e-6)
    out.update(rays=n_rays, hit_share=float(hit_r.mean()),
               hit_miss_agree=float(same_hit.mean()),
               t_rel_err_max=float(t_err.max()) if both.any() else 0.0,
               prim_agree=float((prim_b[both] == prim_r[both]).mean())
               if both.any() else 1.0)
    assert hit_r.mean() > 0.05, out
    assert out["hit_miss_agree"] >= 0.9999, out
    assert out["t_rel_err_max"] <= 1e-5, out

    if time_reps:
        ts = []
        for _ in range(time_reps):
            t0 = time.perf_counter()
            jax.block_until_ready(trav(o, d, tmax))
            ts.append(time.perf_counter() - t0)
        out["traverse_batch_s_median"] = float(np.median(ts))
        out["traverse_batch_mrays_s"] = n_rays / float(np.median(ts)) / 1e6
    return out


def phase_sharded(n_dev=4, res=512, spp=64, train_spp=16, max_depth=4):
    """render_sharded over make_mesh(n_dev) against a single-device
    render(); two make_train_step steps against the 1-device step."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from pbrt_tpu.integrators.render import render
    from pbrt_tpu.parallel import make_mesh, render_sharded
    from pbrt_tpu.parallel.render import make_train_step

    assert len(jax.devices()) >= n_dev, (len(jax.devices()), n_dev)
    mesh = make_mesh(n_dev)
    scene = ge._portal_scene()
    cam = ge._camera((res, res))
    out = {"mesh": dict(mesh.shape)}

    img_s = render_sharded(scene, cam, mesh, spp=spp, max_depth=max_depth)
    img_1 = render(scene, cam, spp=spp, max_depth=max_depth)
    out["result_devices"] = len(img_s.sharding.device_set)
    frac, dmax = _pixel_agreement(np.asarray(img_s), np.asarray(img_1))
    out.update(pixels_within_atol=frac, pixel_max_abs_diff=dmax,
               image_mean=float(np.asarray(img_1).mean()))
    assert out["result_devices"] == n_dev, out
    assert frac >= PIX_FRAC, out

    target = jnp.zeros((res, res, 3))
    params = {"kd": scene.materials.kd, "emit": scene.lights.emit}
    lr = jnp.asarray(0.1, jnp.float32)
    steps = {k: make_train_step(m, spp=train_spp, max_depth=max_depth,
                                resolution=(res, res))
             for k, m in (("sharded", mesh), ("single", make_mesh(1)))}
    p = {"sharded": params, "single": params}
    for i in range(2):
        upd = {}
        for k in steps:
            new, loss = steps[k](scene, cam, p[k], target, lr)
            upd[k] = (jax.tree_util.tree_map(lambda a, b: a - b, p[k],
                                             new), float(loss))
            p[k] = new
        out[f"step{i}_loss"] = [upd["sharded"][1], upd["single"][1]]
        for name in ("kd", "emit"):
            out[f"step{i}_grad_{name}_rel"] = _rel(upd["sharded"][0][name],
                                                   upd["single"][0][name])
            assert out[f"step{i}_grad_{name}_rel"] <= GRAD_RTOL, out
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 1
    import bench
    from pbrt_tpu.utils import compile_cache

    _log(f"card: {bench.card_info()}")
    _log(f"device_kind: {devs[0].device_kind}  count: {len(devs)}")
    _log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    _log(f"compile cache: {compile_cache.enable()}")

    if four:
        phases = [("sharded", lambda: phase_sharded(n_dev=4))]
    else:
        phases = [("cli", phase_cli),
                  ("bench", lambda: phase_bench(time_reps=5)),
                  ("bvh", lambda: phase_bvh(time_reps=5))]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception:          # report every phase, fail at the end
            traceback.print_exc()
            _log(f"phase {name}: FAILED after "
                 f"{time.perf_counter() - t0:.1f}s")
            failed.append(name)
            continue
        _log(f"phase {name}: ok in {time.perf_counter() - t0:.1f}s "
             f"{json.dumps(res)}")
    if failed:
        _log(f"chip_smoke: failed phases {failed}")
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
