"""End-to-end render tests with analytically known answers.

Mirrors the reference's integration-test strategy
(src/tests/analytic_scenes.cpp:54-66: render tiny images, assert mean
radiance within tolerance of the analytic value).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu.core import transform
from pbrt_tpu.core.spectrum import RGB
from pbrt_tpu.integrators import render
from pbrt_tpu.scene import camera as cam_mod
from pbrt_tpu.scene.types import SceneBuilder


def look_at_cam(eye, at, res=(10, 10), fov=60.0):
    return cam_mod.make_perspective(
        transform.look_at(eye, at, (0, 1, 0)), fov, res)


class TestAnalytic:
    def test_env_only(self):
        """Empty scene + constant infinite light: image == L everywhere."""
        b = SceneBuilder(RGB)
        b.add_light(type="infinite", L=(0.7, 0.8, 0.9),
                    env_map=np.ones((1, 1, 3), np.float32))
        scene = b.build()
        cam = look_at_cam((0, 0, 0), (0, 0, 1))
        img = np.asarray(render(scene, cam, spp=4, integrator="path"))
        np.testing.assert_allclose(img.mean((0, 1)), [0.7, 0.8, 0.9],
                                   atol=0.02)

    def test_sphere_furnace(self):
        """Lambertian sphere (rho=0.5) in constant env L=1: the sphere is
        convex so every surface point sees only the env; reflected radiance
        = rho * L = 0.5 (analytic_scenes.cpp sphere furnace)."""
        b = SceneBuilder(RGB)
        m = b.add_material(type=0, kd=0.5, sigma=0.0)
        b.add_sphere((0, 0, 3), 1.0, mat=m)
        b.add_light(type="infinite", L=1.0,
                    env_map=np.ones((1, 1, 3), np.float32))
        scene = b.build()
        # narrow fov so every pixel hits the sphere
        cam = look_at_cam((0, 0, 0), (0, 0, 3), fov=20.0)
        img = np.asarray(render(scene, cam, spp=196, integrator="path",
                                max_depth=2))
        np.testing.assert_allclose(img.mean(), 0.5, atol=0.02)

    def test_point_light_analytic(self):
        """Point light above a lambertian floor: L = kd/pi * I cos/d^2."""
        b = SceneBuilder(RGB)
        m = b.add_material(type=0, kd=0.6)
        # big floor at y=0 (two triangles)
        b.add_mesh([(-50, 0, -50), (50, 0, -50), (50, 0, 50), (-50, 0, 50)],
                   [(0, 1, 2), (0, 2, 3)], mat=m)
        b.add_light(type="point", I=(10.0, 10.0, 10.0), pos=(0, 2, 0))
        scene = b.build()
        # camera looking straight down at origin
        cam = look_at_cam((0, 1, 1e-4), (0, 0, 0), fov=2.0)
        img = np.asarray(render(scene, cam, spp=16, integrator="direct"))
        # at origin: d=2, cos=1 → L = 0.6/pi * 10/4
        expected = 0.6 / np.pi * 10.0 / 4.0
        np.testing.assert_allclose(img.mean(), expected, rtol=0.02)

    def test_area_light_direct_visible(self):
        """Camera ray hitting an emitter sees Le (diffuse.h L())."""
        b = SceneBuilder(RGB)
        m = b.add_material(type=0, kd=0.0)
        li = b.add_light(type="area", L=(3.0, 2.0, 1.0), prim=0)
        b.add_aaplane((-1, -1, 2), (1, 1, 2), axis=2, facing_fw=False,
                      mat=m, light=li)
        scene = b.build()
        cam = look_at_cam((0, 0, 0), (0, 0, 2), fov=10.0)
        for integ in ("path", "direct", "mypath"):
            img = np.asarray(render(scene, cam, spp=4, integrator=integ))
            np.testing.assert_allclose(img.mean((0, 1)), [3.0, 2.0, 1.0],
                                       atol=0.02, err_msg=integ)

    def test_area_light_nee_vs_analytic_disk(self):
        """Lambertian point under a distant small area light ≈ point light:
        NEE estimate matches the point-light approximation."""
        b = SceneBuilder(RGB)
        m = b.add_material(type=0, kd=0.5)
        b.add_mesh([(-50, 0, -50), (50, 0, -50), (50, 0, 50), (-50, 0, 50)],
                   [(0, 1, 2), (0, 2, 3)], mat=m)
        # small emitter (0.2x0.2) at height 5 facing down (-y)
        li = b.add_light(type="area", L=100.0, prim=-1)
        pid = b.add_aaplane((-0.1, 5.0, -0.1), (0.1, 5.0, 0.1), axis=1,
                            facing_fw=False, mat=m, light=li)
        b.light_rows[li]["prim"] = b.prim_index("pln", pid)
        scene = b.build()
        cam = look_at_cam((0, 1, 1e-4), (0, 0, 0), fov=2.0)
        img = np.asarray(render(scene, cam, spp=512, integrator="direct",
                                seed=1))
        # L ≈ kd/pi * Le * area * cos^2 / d^2 (cosL=cosP=1, d=5)
        expected = 0.5 / np.pi * 100.0 * 0.04 / 25.0
        np.testing.assert_allclose(img.mean(), expected, rtol=0.05)

    def test_mirror_reflection(self):
        """Mirror tile reflects the env light exactly (whitted-style)."""
        b = SceneBuilder(RGB)
        m = b.add_material(type=1, kr=1.0)
        b.add_aaplane((-5, -5, 4), (5, 5, 4), axis=2, facing_fw=False,
                      mat=m)
        b.add_light(type="infinite", L=(0.25, 0.5, 0.75),
                    env_map=np.ones((1, 1, 3), np.float32))
        scene = b.build()
        cam = look_at_cam((0, 0, 0), (0, 0, 4), fov=10.0)
        img = np.asarray(render(scene, cam, spp=16, integrator="whitted",
                                max_depth=3))
        np.testing.assert_allclose(img.mean((0, 1)), [0.25, 0.5, 0.75],
                                   atol=0.02)

    def test_determinism(self):
        b = SceneBuilder(RGB)
        m = b.add_material(type=0, kd=0.4)
        b.add_sphere((0, 0, 3), 1.0, mat=m)
        b.add_light(type="point", I=5.0, pos=(2, 2, 0))
        scene = b.build()
        cam = look_at_cam((0, 0, 0), (0, 0, 3))
        i1 = np.asarray(render(scene, cam, spp=4, seed=3))
        i2 = np.asarray(render(scene, cam, spp=4, seed=3))
        np.testing.assert_array_equal(i1, i2)
        i3 = np.asarray(render(scene, cam, spp=4, seed=4))
        assert np.abs(i1 - i3).max() > 0

    @pytest.mark.parametrize("sampler", ["independent", "stratified",
                                         "halton", "sobol"])
    def test_samplers_agree(self, sampler):
        """All samplers converge to the same furnace answer
        (analytic_scenes.cpp runs each scene across samplers)."""
        b = SceneBuilder(RGB)
        m = b.add_material(type=0, kd=0.5)
        b.add_sphere((0, 0, 3), 1.0, mat=m)
        b.add_light(type="infinite", L=1.0,
                    env_map=np.ones((1, 1, 3), np.float32))
        scene = b.build()
        cam = look_at_cam((0, 0, 0), (0, 0, 3), fov=20.0)
        img = np.asarray(render(scene, cam, spp=128, integrator="path",
                                sampler=sampler, max_depth=2))
        np.testing.assert_allclose(img.mean(), 0.5, atol=0.03,
                                   err_msg=sampler)


class TestGonioProjectionLights:
    def test_goniometric_map_modulates(self):
        """Goniometric point light: map scales intensity by direction
        (lights/goniometric.cpp)."""
        from pbrt_tpu.scene.types import SceneBuilder
        from pbrt_tpu.core.spectrum import RGB
        import numpy as np
        # map: bright in the lower hemisphere (toward floor), dark upper
        gm = np.ones((8, 8, 3), np.float32)
        gm[:4] = 0.0   # theta < pi/2 (up) dark
        b = SceneBuilder(RGB)
        m = b.add_material(type=0, kd=0.6)
        b.add_mesh([(-50, 0, -50), (50, 0, -50), (50, 0, 50), (-50, 0, 50)],
                   [(0, 1, 2), (0, 2, 3)], mat=m)
        b.add_light(type="goniometric", I=(10.0, 10.0, 10.0),
                    pos=(0, 2, 0), map=gm)
        scene = b.build()
        cam = look_at_cam((0, 1, 1e-4), (0, 0, 0), fov=2.0)
        img = np.asarray(render(scene, cam, spp=16, integrator="direct"))
        # direction light→floor is -y ⇒ theta=pi (bottom row) ⇒ map=1:
        # same as plain point light
        expected = 0.6 / np.pi * 10.0 / 4.0
        np.testing.assert_allclose(img.mean(), expected, rtol=0.03)

    def test_projection_light_cone(self):
        """Projection light is black outside its fov cone
        (lights/projection.cpp)."""
        from pbrt_tpu.scene.types import SceneBuilder
        from pbrt_tpu.core.spectrum import RGB
        import numpy as np
        b = SceneBuilder(RGB)
        m = b.add_material(type=0, kd=0.6)
        b.add_mesh([(-50, 0, -50), (50, 0, -50), (50, 0, 50), (-50, 0, 50)],
                   [(0, 1, 2), (0, 2, 3)], mat=m)
        # projector at height 2 aiming straight down, narrow fov
        b.add_light(type="projection", I=(10.0, 10.0, 10.0), pos=(0, 2, 0),
                    dir=(0, -1, 0), fov=30.0)
        scene = b.build()
        cam = look_at_cam((0, 3, 6), (0, 0, 0), res=(24, 24), fov=60.0)
        img = np.asarray(render(scene, cam, spp=16, integrator="direct"))
        lit = img.sum(-1) > 1e-4
        # a narrow spotlight-like pool of light: some lit, most dark
        assert lit.any()
        assert lit.mean() < 0.5


class TestAnalyticSceneMatrix:
    """The other half of analytic_scenes.cpp's matrix (:269-416): the same
    analytically-known furnace scene across INTEGRATORS and both camera
    models, mean asserted to the ±0.02-class tolerance (r4 — the suite
    previously crossed samplers only)."""

    def _furnace(self):
        b = SceneBuilder(RGB)
        m = b.add_material(type=0, kd=0.5)
        b.add_sphere((0, 0, 3), 1.0, mat=m)
        b.add_light(type="infinite", L=1.0,
                    env_map=np.ones((1, 1, 3), np.float32))
        return b.build()

    @pytest.mark.parametrize("integrator", ["path", "volpath", "bdpt"])
    def test_integrators_furnace(self, integrator):
        scene = self._furnace()
        cam = look_at_cam((0, 0, 0), (0, 0, 3), fov=20.0)
        img = np.asarray(render(scene, cam, spp=96, integrator=integrator,
                                max_depth=3, seed=5))
        np.testing.assert_allclose(img.mean(), 0.5, atol=0.035,
                                   err_msg=integrator)

    def test_mlt_furnace(self):
        from pbrt_tpu.integrators.mlt import render_mlt
        scene = self._furnace()
        cam = look_at_cam((0, 0, 0), (0, 0, 3), fov=20.0)
        img = np.asarray(render_mlt(scene, cam, mutations_per_pixel=256,
                                    n_chains=2048, n_bootstrap=16384,
                                    max_depth=3, seed=5))
        np.testing.assert_allclose(img.mean(), 0.5, atol=0.06)

    def test_orthographic_furnace(self):
        from pbrt_tpu.core import transform
        from pbrt_tpu.scene import camera as cam_mod
        scene = self._furnace()
        cam = cam_mod.make_orthographic(
            transform.look_at((0, 0, 0.5), (0, 0, 3), (0, 1, 0)),
            (10, 10), screen_window=((-0.5, -0.5), (0.5, 0.5)))
        img = np.asarray(render(scene, cam, spp=96, integrator="path",
                                max_depth=3, seed=6))
        np.testing.assert_allclose(img.mean(), 0.5, atol=0.035)


@pytest.mark.parametrize("spp,cap,want", [(64, 7, 4), (64, 30, 16),
                                          (64, 3, 2), (16, 16, 16),
                                          (7, 5, 5), (13, 4, 4)])
def test_even_chunk_keeps_one_pass_shape(spp, cap, want):
    """render()'s default spp chunk divides spp when that keeps at least
    half the memory-bound pass size (one compiled program), else it is
    the cap itself."""
    from pbrt_tpu.integrators.render import _even_chunk
    assert _even_chunk(spp, cap) == want
