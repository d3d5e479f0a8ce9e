"""Fused path-bounce Pallas kernel (ops/fused_path.py) vs the generic
wavefront loop — pixel equality and gradient-replay equality.

The kernel regenerates the exact pcg4d sample streams of the XLA path
(integrators/render.py _li_loop + common.estimate_direct's portal
projection branch, the Render hot loop role of core/integrator.cpp:526-637),
so on its eligible scene class the two paths must agree lane-for-lane to
float tolerance — not just in distribution. Runs in Pallas interpret mode
on the CPU test backend; the GPU compile of the same kernel is exercised
by chip_smoke.py and the ``gpu``-marked tests on the card.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as ge
from pbrt_tpu.integrators.render import RenderConfig, _li_loop, _sample2
from pbrt_tpu.ops import fused_path
from pbrt_tpu.samplers import make_sampler
from pbrt_tpu.scene import camera as cam_mod


def _rays(scene, res=24, chunk=2, max_depth=4):
    cam = ge._camera((res, res))
    n_pix = res * res
    lid = jnp.tile(jnp.arange(n_pix, dtype=jnp.uint32), chunk)
    sidx = jnp.repeat(jnp.arange(chunk, dtype=jnp.uint32), n_pix)
    px = (lid % res).astype(jnp.float32)
    py = (lid // res).astype(jnp.float32)
    pid = py.astype(jnp.uint32) * jnp.uint32(res) + px.astype(jnp.uint32)
    cfg = RenderConfig(integrator="path", max_depth=max_depth)
    sfn = make_sampler("independent")
    u_film = _sample2(sfn, pid, sidx, (0, 1), cfg.seed)
    p_film = jnp.stack([px + 0.5, py + 0.5], -1) + u_film - 0.5
    rays = cam_mod.generate_rays(
        cam, p_film, _sample2(sfn, pid, sidx, (2, 3), cfg.seed),
        sfn(pid, sidx, 4, cfg.seed))
    return rays, pid, sidx, sfn, cfg


def test_fused_profile_detected_on_bench_scene():
    scene = ge._portal_scene()
    assert scene.fused_profile is not None
    ax, pl_facing, portal_facing, n_mat, mode = scene.fused_profile
    assert ax == 1 and n_mat == 4 and mode == 1


def test_fused_pixel_equality_vs_xla_path():
    """Lane-for-lane radiance equality on the bench portal scene (the
    kernel replays the identical sample streams; measured max abs diff
    2e-7 over 2048 lanes × 5 bounces)."""
    scene = ge._portal_scene()
    rays, pid, sidx, sfn, cfg = _rays(scene, res=32, chunk=2)
    L_ref = np.asarray(_li_loop(scene, rays.o, rays.d, pid, sidx, sfn,
                                cfg, None))
    L_fus = np.asarray(fused_path.li_path_fused(
        scene, rays.o, rays.d, pid, sidx, cfg, interpret=True))
    assert L_ref.mean() > 0.01           # scene actually lights up
    np.testing.assert_allclose(L_fus, L_ref, atol=5e-6)


def test_fused_gradient_replay_matches_xla_autodiff():
    """∂mean(L)/∂(kd, emit) through the residual replay equals autodiff
    of the full XLA estimator (incl. the russian-roulette 1/(1-q)
    compensation's kd-dependence)."""
    scene = ge._portal_scene()
    rays, pid, sidx, sfn, cfg = _rays(scene, res=24, chunk=2)

    def loss_xla(kd, emit):
        s = dc.replace(scene,
                       materials=dc.replace(scene.materials, kd=kd),
                       lights=dc.replace(scene.lights, emit=emit))
        return jnp.mean(_li_loop(s, rays.o, rays.d, pid, sidx, sfn, cfg,
                                 None))

    def loss_fused(kd, emit):
        s = dc.replace(scene,
                       materials=dc.replace(scene.materials, kd=kd),
                       lights=dc.replace(scene.lights, emit=emit))
        return jnp.mean(fused_path.li_path_fused(
            s, rays.o, rays.d, pid, sidx, cfg, interpret=True))

    kd, emit = scene.materials.kd, scene.lights.emit
    v1, g1 = jax.value_and_grad(loss_xla, argnums=(0, 1))(kd, emit)
    v2, g2 = jax.value_and_grad(loss_fused, argnums=(0, 1))(kd, emit)
    np.testing.assert_allclose(float(v2), float(v1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g2[0]), np.asarray(g1[0]),
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(g2[1]), np.asarray(g1[1]),
                               atol=1e-8)
    assert np.abs(np.asarray(g1[0])).max() > 1e-3   # non-trivial grads


def test_fused_eligibility_gate(monkeypatch):
    """eligible() is the one dispatch point: True only on the GPU backend
    for a scene + config inside the kernel's profile."""
    scene = ge._portal_scene()
    cfg = RenderConfig(integrator="path", max_depth=4)
    assert jax.default_backend() == "cpu"
    assert not fused_path.eligible(scene, cfg)          # cpu backend
    monkeypatch.setattr(fused_path.jax, "default_backend", lambda: "gpu")
    assert fused_path.eligible(scene, cfg)
    assert not fused_path.eligible(
        scene, RenderConfig(integrator="path", sampler="halton"))
    assert not fused_path.eligible(
        scene, RenderConfig(integrator="path", light_strategy="power"))
    assert not fused_path.eligible(
        scene, RenderConfig(integrator="path", collect_stats=True))
    assert not fused_path.eligible(scene, cfg, time=jnp.zeros(4))
    plain = dc.replace(scene, fused_profile=None)
    assert not fused_path.eligible(plain, cfg)


def _kernel_args(scene, cfg):
    ax, pl_facing, portal_facing, n_mat, mode = scene.fused_profile
    tri, msc, clu, n_clu = fused_path.pack_fused(scene, mode)
    kw = dict(n_tri=scene.n_tri, n_b=cfg.max_depth + 1, ax=ax,
              pl_facing=pl_facing, portal_facing=portal_facing,
              n_mat=n_mat, seed=cfg.seed, rr_threshold=cfg.rr_threshold,
              mode=mode, n_clu=n_clu, interpret=True)
    return (tri, msc, scene.materials.kd, clu), kw


@pytest.mark.parametrize("n_rays", [1000, 100])
def test_fused_wrapper_ragged_batch(n_rays):
    """A ray count that is not a multiple of the block (several blocks, or
    less than one): the wrapper pads the tail and drops it — residuals
    equal those of the same rays inside a block-aligned batch, and the
    radiance still matches _li_loop."""
    scene = ge._portal_scene()
    rays, pid, sidx, sfn, cfg = _rays(scene, res=32, chunk=1)
    block = fused_path.BLOCK
    assert n_rays % block and rays.o.shape[0] % block == 0
    tables, kw = _kernel_args(scene, cfg)
    full = fused_path._impl(*tables, rays.o, rays.d, pid, sidx, **kw)
    part = fused_path._impl(*tables, rays.o[:n_rays], rays.d[:n_rays],
                            pid[:n_rays], sidx[:n_rays], **kw)
    for a, b in zip(part, full):
        assert a.shape == (cfg.max_depth + 1, n_rays)
        np.testing.assert_array_equal(np.asarray(a),
                                      np.asarray(b)[:, :n_rays])
    L = fused_path.replay(scene.materials.kd, scene.lights.emit[0], *part)
    L_ref = _li_loop(scene, rays.o[:n_rays], rays.d[:n_rays], pid[:n_rays],
                     sidx[:n_rays], sfn, cfg, None)
    np.testing.assert_allclose(np.asarray(L), np.asarray(L_ref), atol=5e-6)


@pytest.mark.parametrize("scene_fn", ["portal", "clustered"])
def test_fused_kernel_lowers_to_triton(scene_fn):
    """The kernel lowers for CUDA through Pallas-Triton (flat sweep and
    cluster-culled sweep): every primitive it uses has a Triton rule and
    every block has a power-of-two size. Cross-lowering needs no GPU;
    compiling the Triton IR happens on the card (chip_smoke.py)."""
    scene = (ge._portal_scene() if scene_fn == "portal"
             else _tessellated_cornell(nseg=13))
    cfg = RenderConfig(integrator="path", max_depth=4)
    tables, kw = _kernel_args(scene, cfg)
    kw["interpret"] = False
    R = 4096
    o = jnp.zeros((R, 3))
    d = jnp.ones((R, 3))
    ids = jnp.zeros(R, jnp.uint32)
    exp = jax.export.export(
        jax.jit(lambda o, d: fused_path._impl(*tables, o, d, ids, ids,
                                              **kw)),
        platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(o, d)
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert 'name = "fused_path"' in text


def test_fused_profile_rejects_non_matte_scene():
    """A scene outside the profile (extra sphere → BVH-free but
    non-triangle geometry) must not carry a fused profile."""
    from pbrt_tpu.core.spectrum import RGB
    from pbrt_tpu.scene.types import SceneBuilder
    b = SceneBuilder(RGB)
    m = b.add_material(type=0, kd=(0.5, 0.5, 0.5))
    b.add_mesh([(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
               [(0, 1, 2), (0, 2, 3)], mat=m)
    b.add_sphere((0.5, 0.5, 0.5), 0.2, mat=m)
    li = b.add_light(type="area", L=(5.0, 5.0, 5.0), prim=-1,
                     strategy="projection", two_sided=False,
                     portals=[((0.3, 1.0, 0.3), (0.7, 1.0, 0.7), 1,
                               False)])
    b.add_aaplane((0.3, 1.2, 0.3), (0.7, 1.2, 0.7), axis=1,
                  facing_fw=False, mat=m, light=li)
    scene = b.build()
    assert scene.fused_profile is None


def _plain_cornell():
    """Classic cornell box: plain one-sided diffuse area light (no
    portal) — the r5 mode-0 fused profile (full two-sample-MIS NEE)."""
    from pbrt_tpu.core.spectrum import RGB
    from pbrt_tpu.scene.types import SceneBuilder
    b = SceneBuilder(RGB)
    white = b.add_material(type=0, kd=(0.73, 0.73, 0.73))
    red = b.add_material(type=0, kd=(0.63, 0.065, 0.05))
    green = b.add_material(type=0, kd=(0.14, 0.45, 0.091))
    black = b.add_material(type=0, kd=0.0)
    for verts, m in [
        ([(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)], white),
        ([(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], white),
        ([(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)], red),
        ([(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)], green),
    ]:
        b.add_mesh(verts, [(0, 1, 2), (0, 2, 3)], mat=m)
    b.add_mesh([(0, 1, 0), (1, 1, 0), (1, 1, 0.3), (0, 1, 0.3)],
               [(0, 1, 2), (0, 2, 3)], mat=white)
    b.add_mesh([(0, 1, 0.7), (1, 1, 0.7), (1, 1, 1), (0, 1, 1)],
               [(0, 1, 2), (0, 2, 3)], mat=white)
    li = b.add_light(type="area", L=(15.0, 13.0, 9.0), prim=-1)
    pid_l = b.add_aaplane((0.3, 0.99, 0.35), (0.7, 0.99, 0.65), axis=1,
                          facing_fw=False, mat=black, light=li)
    b.light_rows[li]["prim"] = b.prim_index("pln", pid_l)
    return b.build()


def test_fused_area_mode_profile_and_pixels():
    """Mode 0 (plain diffuse area light, classic cornell): lane-for-lane
    equality with the XLA path except geometry-seam lanes where float
    order flips a hit/miss (measured 1/2048 and 9/36864; the XLA twin's
    continuation ray leaks through the same corner there — both
    estimators are unbiased at seams)."""
    scene = _plain_cornell()
    assert scene.fused_profile is not None
    assert scene.fused_profile[4] == 0          # mode 0 = plain area
    rays, pid, sidx, sfn, cfg = _rays(scene, res=32, chunk=2)
    L_ref = np.asarray(_li_loop(scene, rays.o, rays.d, pid, sidx, sfn,
                                cfg, None))
    L_fus = np.asarray(fused_path.li_path_fused(
        scene, rays.o, rays.d, pid, sidx, cfg, interpret=True))
    assert L_ref.mean() > 0.05
    bad = (np.abs(L_ref - L_fus).max(-1) > 1e-4)
    assert bad.mean() < 1e-3, f"{bad.sum()} mismatched lanes"
    ok = ~bad
    np.testing.assert_allclose(L_fus[ok], L_ref[ok], atol=1.1e-4)
    # image means agree to the seam-lane noise level
    assert abs(L_fus.mean() - L_ref.mean()) / L_ref.mean() < 0.01


def _add_sphere_mesh(b, c, r, m, nseg):
    """Lat-long tessellated sphere as a triangle mesh (2·nseg²−2·nseg
    non-degenerate faces; pole bands emit a single triangle)."""
    th = np.linspace(0, np.pi, nseg + 1)
    ph = np.linspace(0, 2 * np.pi, nseg + 1)
    vs, fs = [], []
    for i in range(nseg + 1):
        for j in range(nseg + 1):
            vs.append((c[0] + r * np.sin(th[i]) * np.cos(ph[j]),
                       c[1] + r * np.cos(th[i]),
                       c[2] + r * np.sin(th[i]) * np.sin(ph[j])))
    for i in range(nseg):
        for j in range(nseg):
            a = i * (nseg + 1) + j
            d = a + nseg + 1
            if i > 0:
                fs.append((a, a + 1, d + 1))
            if i < nseg - 1:
                fs.append((a, d + 1, d))
    b.add_mesh(vs, fs, mat=m)


def _tessellated_cornell(nseg=16):
    """Cornell box + two lat-long tessellated matte spheres as triangle
    meshes (~2·2·nseg² tris) — exercises the cluster-culling
    widening of the fused profile (>255 triangles, BVH built for the
    XLA fallback, kernel culls via contiguous 32-row cluster AABBs)."""
    from pbrt_tpu.core.spectrum import RGB
    from pbrt_tpu.scene.types import SceneBuilder
    b = SceneBuilder(RGB)
    white = b.add_material(type=0, kd=(0.73, 0.73, 0.73))
    red = b.add_material(type=0, kd=(0.63, 0.065, 0.05))
    green = b.add_material(type=0, kd=(0.14, 0.45, 0.091))
    black = b.add_material(type=0, kd=0.0)
    for verts, m in [
        ([(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)], white),
        ([(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], white),
        ([(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)], red),
        ([(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)], green),
    ]:
        b.add_mesh(verts, [(0, 1, 2), (0, 2, 3)], mat=m)
    b.add_mesh([(0, 1, 0), (1, 1, 0), (1, 1, 0.3), (0, 1, 0.3)],
               [(0, 1, 2), (0, 2, 3)], mat=white)
    b.add_mesh([(0, 1, 0.7), (1, 1, 0.7), (1, 1, 1), (0, 1, 1)],
               [(0, 1, 2), (0, 2, 3)], mat=white)

    _add_sphere_mesh(b, (0.32, 0.24, 0.4), 0.24, white, nseg)
    _add_sphere_mesh(b, (0.7, 0.16, 0.72), 0.16, green, nseg)
    li = b.add_light(type="area", L=(15.0, 13.0, 9.0), prim=-1)
    pid_l = b.add_aaplane((0.3, 0.99, 0.35), (0.7, 0.99, 0.65), axis=1,
                          facing_fw=False, mat=black, light=li)
    b.light_rows[li]["prim"] = b.prim_index("pln", pid_l)
    return b.build()


def test_fused_cluster_culling_big_scene():
    """>255-triangle scene (two tessellated spheres, BVH present for the
    XLA path): the widened fused profile qualifies, the cluster-culled
    sweep agrees with the XLA loop lane-for-lane except float-seam
    lanes (clusters are contiguous builder-order runs, culling is
    conservative → same hit results as the flat sweep)."""
    scene = _tessellated_cornell(nseg=13)
    assert scene.n_tri > 255
    assert scene.bvh is not None          # XLA fallback uses it
    assert scene.fused_profile is not None
    assert scene.fused_profile[4] == 0
    from pbrt_tpu.ops.fused_path import pack_fused
    _, _, clu, n_clu = pack_fused(scene, 0)
    assert n_clu >= 8                      # culling actually engaged
    rays, pid, sidx, sfn, cfg = _rays(scene, res=24, chunk=2)
    L_ref = np.asarray(_li_loop(scene, rays.o, rays.d, pid, sidx, sfn,
                                cfg, None))
    L_fus = np.asarray(fused_path.li_path_fused(
        scene, rays.o, rays.d, pid, sidx, cfg, interpret=True))
    assert L_ref.mean() > 0.05
    # the XLA loop traverses scene.bvh (leaf order) while the kernel
    # sweeps builder order → hit TIES at tessellation seams may break
    # differently (measured 2-4/1152 lanes, max diff 4e-4; culled vs
    # flat kernel sweep itself is bit-identical, diff 0.0)
    bad = (np.abs(L_ref - L_fus).max(-1) > 1e-4)
    assert bad.mean() < 6e-3, f"{bad.sum()} mismatched lanes"
    ok = ~bad
    np.testing.assert_allclose(L_fus[ok], L_ref[ok], atol=1.1e-4)
    assert abs(L_fus.mean() - L_ref.mean()) / L_ref.mean() < 0.01


def _tessellated_portal(nseg=13):
    """The graft portal scene (light through a ceiling opening,
    projection strategy — fused mode 1) plus a tessellated sphere, so
    the cluster-culled sweep is exercised on the flagship portal
    profile too (>255 tris)."""
    from pbrt_tpu.core.spectrum import RGB
    from pbrt_tpu.scene.types import SceneBuilder
    b = SceneBuilder(RGB)
    white = b.add_material(type=0, kd=(0.73, 0.73, 0.73))
    red = b.add_material(type=0, kd=(0.63, 0.065, 0.05))
    green = b.add_material(type=0, kd=(0.14, 0.45, 0.091))
    black = b.add_material(type=0, kd=0.0)
    for verts, m in [
        ([(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)], white),
        ([(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], white),
        ([(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)], red),
        ([(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)], green),
    ]:
        b.add_mesh(verts, [(0, 1, 2), (0, 2, 3)], mat=m)
    for lo, hi in [((0.0, 0.0), (0.35, 1.0)), ((0.65, 0.0), (1.0, 1.0)),
                   ((0.35, 0.0), (0.65, 0.35)),
                   ((0.35, 0.65), (0.65, 1.0))]:
        b.add_mesh([(lo[0], 1.0, lo[1]), (hi[0], 1.0, lo[1]),
                    (hi[0], 1.0, hi[1]), (lo[0], 1.0, hi[1])],
                   [(0, 1, 2), (0, 2, 3)], mat=white)
    _add_sphere_mesh(b, (0.35, 0.22, 0.45), 0.22, white, nseg)
    li = b.add_light(type="area", L=(18.4, 15.6, 8.0), prim=-1,
                     strategy="projection", two_sided=False,
                     portals=[((0.35, 1.0, 0.35), (0.65, 1.0, 0.65), 1,
                               False)])
    pid_l = b.add_aaplane((0.3, 1.2, 0.3), (0.7, 1.2, 0.7), axis=1,
                          facing_fw=False, mat=black, light=li)
    b.light_rows[li]["prim"] = b.prim_index("pln", pid_l)
    return b.build()


def test_fused_cluster_portal_mode():
    """Mode-1 (portal projection) variant of the cluster-culled
    widening: >255-tri portal scene agrees with the XLA loop
    lane-for-lane except seam-tie lanes."""
    scene = _tessellated_portal(nseg=13)
    assert scene.n_tri > 255
    assert scene.fused_profile is not None
    assert scene.fused_profile[4] == 1          # portal projection mode
    rays, pid, sidx, sfn, cfg = _rays(scene, res=24, chunk=2)
    L_ref = np.asarray(_li_loop(scene, rays.o, rays.d, pid, sidx, sfn,
                                cfg, None))
    L_fus = np.asarray(fused_path.li_path_fused(
        scene, rays.o, rays.d, pid, sidx, cfg, interpret=True))
    assert L_ref.mean() > 0.01
    bad = (np.abs(L_ref - L_fus).max(-1) > 1e-4)
    assert bad.mean() < 6e-3, f"{bad.sum()} mismatched lanes"
    ok = ~bad
    np.testing.assert_allclose(L_fus[ok], L_ref[ok], atol=1.1e-4)
    assert abs(L_fus.mean() - L_ref.mean()) / L_ref.mean() < 0.01


def test_fused_cluster_gradients_big_scene():
    """Gradient replay on the cluster-culled profile matches autodiff of
    the XLA estimator."""
    scene = _tessellated_cornell(nseg=13)
    rays, pid, sidx, sfn, cfg = _rays(scene, res=12, chunk=2)

    def loss_xla(kd, emit):
        s = dc.replace(scene,
                       materials=dc.replace(scene.materials, kd=kd),
                       lights=dc.replace(scene.lights, emit=emit))
        return jnp.mean(_li_loop(s, rays.o, rays.d, pid, sidx, sfn, cfg,
                                 None))

    def loss_fused(kd, emit):
        s = dc.replace(scene,
                       materials=dc.replace(scene.materials, kd=kd),
                       lights=dc.replace(scene.lights, emit=emit))
        return jnp.mean(fused_path.li_path_fused(
            s, rays.o, rays.d, pid, sidx, cfg, interpret=True))

    kd, emit = scene.materials.kd, scene.lights.emit
    v1, g1 = jax.value_and_grad(loss_xla, argnums=(0, 1))(kd, emit)
    v2, g2 = jax.value_and_grad(loss_fused, argnums=(0, 1))(kd, emit)
    np.testing.assert_allclose(float(v2), float(v1), rtol=5e-3)
    np.testing.assert_allclose(np.asarray(g2[0]), np.asarray(g1[0]),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(g2[1]), np.asarray(g1[1]),
                               atol=2e-5)
    assert np.abs(np.asarray(g1[0])).max() > 1e-3


def test_fused_area_mode_gradients():
    """Mode 0 gradient replay vs autodiff of the XLA path (both MIS
    halves fold into the same kd-linear residual)."""
    scene = _plain_cornell()
    rays, pid, sidx, sfn, cfg = _rays(scene, res=16, chunk=2)

    def loss_xla(kd, emit):
        s = dc.replace(scene,
                       materials=dc.replace(scene.materials, kd=kd),
                       lights=dc.replace(scene.lights, emit=emit))
        return jnp.mean(_li_loop(s, rays.o, rays.d, pid, sidx, sfn, cfg,
                                 None))

    def loss_fused(kd, emit):
        s = dc.replace(scene,
                       materials=dc.replace(scene.materials, kd=kd),
                       lights=dc.replace(scene.lights, emit=emit))
        return jnp.mean(fused_path.li_path_fused(
            s, rays.o, rays.d, pid, sidx, cfg, interpret=True))

    kd, emit = scene.materials.kd, scene.lights.emit
    v1, g1 = jax.value_and_grad(loss_xla, argnums=(0, 1))(kd, emit)
    v2, g2 = jax.value_and_grad(loss_fused, argnums=(0, 1))(kd, emit)
    # seam lanes put a small absolute floor under the agreement
    np.testing.assert_allclose(float(v2), float(v1), rtol=5e-3)
    np.testing.assert_allclose(np.asarray(g2[0]), np.asarray(g1[0]),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(g2[1]), np.asarray(g1[1]),
                               atol=2e-5)
    assert np.abs(np.asarray(g1[0])).max() > 1e-3


def test_fused_kernel_lowers_under_shard_map(monkeypatch):
    """The sharded fwd+bwd (parallel/render.py _pass_shard on a dp=2 ×
    sp=2 mesh) dispatches the kernel as it does on the card and lowers
    for CUDA: the kernel's outputs carry the rays' varying mesh axes."""
    import functools

    from jax.sharding import PartitionSpec as P

    from pbrt_tpu.parallel import make_mesh
    from pbrt_tpu.parallel import render as prender
    from pbrt_tpu.scene import film as film_mod

    monkeypatch.setattr(fused_path.jax, "default_backend", lambda: "gpu")
    scene = ge._portal_scene()
    cam = ge._camera((16, 16))
    cfg = RenderConfig(integrator="path", max_depth=4)
    mesh = make_mesh(4)
    body = functools.partial(prender._pass_shard, cfg=cfg, width=16,
                             height=16, chunk=2, dp_size=2, sp_size=2)
    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(),) * 5,
                       out_specs=P("sp", None, None))

    def loss(kd):
        s = dc.replace(scene, materials=dc.replace(scene.materials, kd=kd))
        return jnp.mean(fn(s, cam, film_mod.make_filter("box"),
                           jnp.asarray(0, jnp.uint32), None))

    exp = jax.export.export(
        jax.jit(jax.value_and_grad(loss)), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(scene.materials.kd)
    assert exp.nr_devices == 4
    assert exp.mlir_module().count("__gpu$xla.gpu.triton") == 1
