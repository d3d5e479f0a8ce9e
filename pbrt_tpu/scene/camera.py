"""Cameras: perspective (thin lens), orthographic, environment.

JAX counterpart of ``src/cameras/`` + the Camera interface
(core/camera.{h,cpp}). Ray generation is batched: film-plane sample points
(R,2) in raster space → world-space rays. The fork's wavelength generation
(Camera::GenerateWvls, core/camera.cpp:62-76) lives in the hero integrators.

``We``/``Pdf_We``/``Sample_Wi`` (for BDPT light tracing,
cameras/perspective.cpp:120-190) are implemented for the perspective camera.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core import vecmath
from pbrt_tpu.core.sampling import concentric_sample_disk
from pbrt_tpu.core.transform import Transform, look_at
from pbrt_tpu.core.vecmath import Ray, normalize

Array = Any

PERSPECTIVE = 0
ORTHOGRAPHIC = 1
ENVIRONMENT = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Camera:
    """Static camera description (one per scene)."""
    cam_type: Array         # () int32
    cam_to_world: Transform
    # screen-window → camera-space mapping precomputed from fov/aspect
    screen_min: Array       # (2,)  screen window lower corner
    screen_max: Array       # (2,)
    z_scale: Array          # () perspective: 1; used for fov-scaled dirs
    lens_radius: Array      # ()
    focal_distance: Array   # ()
    shutter_open: Array     # ()
    shutter_close: Array    # ()
    fov_scale: Array        # () tan(fov/2)
    resolution: Array       # (2,) int32 (nx, ny)
    # camera motion blur: when set, cam_to_world is replaced per-ray by
    # anim.interpolate(time) (AnimatedTransform, core/api.cpp:814's
    # MakeCamera CameraToWorld AnimatedTransform)
    anim: Any = None        # core.transform.AnimatedTransform | None


def make_perspective(cam_to_world: Transform, fov_deg: float,
                     resolution, lens_radius: float = 0.0,
                     focal_distance: float = 1e6,
                     shutter_open: float = 0.0, shutter_close: float = 1.0,
                     screen_window=None) -> Camera:
    nx, ny = int(resolution[0]), int(resolution[1])
    aspect = nx / ny
    if screen_window is None:
        # core/api.cpp MakeCamera: screen window from aspect
        if aspect > 1.0:
            smin, smax = (-aspect, -1.0), (aspect, 1.0)
        else:
            smin, smax = (-1.0, -1.0 / aspect), (1.0, 1.0 / aspect)
    else:
        smin, smax = screen_window
    return Camera(
        cam_type=jnp.asarray(PERSPECTIVE, jnp.int32),
        cam_to_world=cam_to_world,
        screen_min=jnp.asarray(smin, jnp.float32),
        screen_max=jnp.asarray(smax, jnp.float32),
        z_scale=jnp.asarray(1.0),
        lens_radius=jnp.asarray(lens_radius, jnp.float32),
        focal_distance=jnp.asarray(focal_distance, jnp.float32),
        shutter_open=jnp.asarray(shutter_open, jnp.float32),
        shutter_close=jnp.asarray(shutter_close, jnp.float32),
        fov_scale=jnp.asarray(np.tan(np.radians(fov_deg) / 2.0), jnp.float32),
        resolution=jnp.asarray([nx, ny], jnp.int32),
    )


def make_orthographic(cam_to_world: Transform, resolution,
                      screen_window=None, lens_radius=0.0,
                      focal_distance=1e6) -> Camera:
    cam = make_perspective(cam_to_world, 90.0, resolution, lens_radius,
                           focal_distance, screen_window=screen_window)
    return dataclasses.replace(
        cam, cam_type=jnp.asarray(ORTHOGRAPHIC, jnp.int32),
        fov_scale=jnp.asarray(1.0, jnp.float32))


def make_environment(cam_to_world: Transform, resolution) -> Camera:
    cam = make_perspective(cam_to_world, 90.0, resolution)
    return dataclasses.replace(cam,
                               cam_type=jnp.asarray(ENVIRONMENT, jnp.int32))


def generate_rays(cam: Camera, p_film: Array, u_lens: Array,
                  u_time: Array) -> Ray:
    """p_film: (R,2) raster-space sample positions (pixels, continuous);
    u_lens: (R,2) for depth of field; u_time: (R,) shutter interpolation.

    Mirrors PerspectiveCamera::GenerateRay (cameras/perspective.cpp:63-93),
    OrthographicCamera::GenerateRay and EnvironmentCamera::GenerateRay,
    dispatched branchlessly on cam_type.
    """
    res = cam.resolution.astype(jnp.float32)
    # raster → NDC → screen
    ndc = p_film / res
    screen = cam.screen_min + ndc * (cam.screen_max - cam.screen_min)
    # pbrt's raster-to-screen flips y (film.cpp GetPhysicalExtent)
    sx = screen[..., 0]
    sy = -(cam.screen_min[1] + ndc[..., 1]
           * (cam.screen_max[1] - cam.screen_min[1]))

    # perspective: direction through (sx*tan, sy*tan, 1)
    d_persp = normalize(jnp.stack(
        [sx * cam.fov_scale, sy * cam.fov_scale, jnp.ones_like(sx)], axis=-1))
    o_persp = jnp.zeros_like(d_persp)

    # orthographic: origin on film plane, direction +z
    o_ortho = jnp.stack([sx, sy, jnp.zeros_like(sx)], axis=-1)
    d_ortho = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), d_persp.shape)

    # environment: latitude–longitude over the full sphere
    theta = jnp.pi * ndc[..., 1]
    phi = 2.0 * jnp.pi * ndc[..., 0]
    d_env = jnp.stack([jnp.sin(theta) * jnp.cos(phi), jnp.cos(theta),
                       jnp.sin(theta) * jnp.sin(phi)], axis=-1)

    is_persp = cam.cam_type == PERSPECTIVE
    is_ortho = cam.cam_type == ORTHOGRAPHIC
    o = jnp.where(is_ortho, o_ortho, o_persp)
    d = jnp.where(is_persp, d_persp, jnp.where(is_ortho, d_ortho, d_env))

    # thin-lens depth of field (perspective.cpp:74-86)
    lens_r = cam.lens_radius
    p_lens = lens_r * concentric_sample_disk(u_lens)
    ft = cam.focal_distance / jnp.maximum(jnp.abs(d[..., 2]), 1e-6)
    p_focus = o + ft[..., None] * d
    o_dof = jnp.concatenate([p_lens, jnp.zeros_like(p_lens[..., :1])],
                            axis=-1)
    d_dof = normalize(p_focus - o_dof)
    use_dof = (lens_r > 0.0) & (is_persp | is_ortho)
    o = jnp.where(use_dof, o_dof, o)
    d = jnp.where(use_dof, d_dof, d)

    if cam.anim is not None:
        # camera motion blur: per-ray interpolated camera-to-world
        # (AnimatedTransform::InterpolateRay role, core/camera.cpp
        # GenerateRay's ray.time + CameraToWorld(ray))
        time = cam.shutter_open + u_time * (cam.shutter_close
                                            - cam.shutter_open)
        m = cam.anim.interpolate(time)              # (R,4,4)
        rot = m[..., :3, :3]
        o_w = jnp.einsum("...ij,...j->...i", rot, o,
                         precision=jax.lax.Precision.HIGHEST) + m[..., :3, 3]
        d_w = jnp.einsum("...ij,...j->...i", rot, d,
                         precision=jax.lax.Precision.HIGHEST)
        return vecmath.make_ray(o_w, d_w)
    ray = vecmath.make_ray(cam.cam_to_world.apply_point(o),
                           cam.cam_to_world.apply_vector(d))
    return ray


def camera_pdf_dir(cam: Camera, ray_d_world: Array) -> Array:
    """Directional density of GenerateRay for a perspective camera:
    p(ω) = 1/(A·cos³θ) with A the screen area at z=1
    (PerspectiveCamera::Pdf_We, cameras/perspective.cpp:158-176)."""
    w2c = cam.cam_to_world.inverse()
    d_cam = w2c.apply_vector(ray_d_world)
    cos_theta = jnp.maximum(
        d_cam[..., 2] / jnp.maximum(vecmath.length(d_cam), 1e-9), 1e-4)
    area = ((cam.screen_max[0] - cam.screen_min[0]) * cam.fov_scale
            * (cam.screen_max[1] - cam.screen_min[1]) * cam.fov_scale)
    return 1.0 / (area * cos_theta ** 3)


def camera_we(cam: Camera, ray_o: Array, ray_d: Array):
    """Importance We(ray) + raster position (perspective.cpp:120-155).
    Returns (we (R,), p_raster (R,2), valid (R,)). Perspective only."""
    w2c = cam.cam_to_world.inverse()
    d_cam = w2c.apply_vector(ray_d)
    cos_theta = d_cam[..., 2] / jnp.maximum(
        vecmath.length(d_cam), 1e-9)
    valid = cos_theta > 1e-6
    o_cam = w2c.apply_point(ray_o)
    ft = jnp.where(cam.lens_radius > 0, cam.focal_distance, 1.0)
    p_focus = o_cam + (ft / jnp.maximum(cos_theta, 1e-6))[..., None] \
        * d_cam / jnp.maximum(vecmath.length(d_cam), 1e-9)[..., None]
    sx = p_focus[..., 0] / jnp.maximum(p_focus[..., 2], 1e-6) / cam.fov_scale
    sy = p_focus[..., 1] / jnp.maximum(p_focus[..., 2], 1e-6) / cam.fov_scale
    ndc_x = (sx - cam.screen_min[0]) / (cam.screen_max[0] - cam.screen_min[0])
    ndc_y = (-sy - cam.screen_min[1]) / (cam.screen_max[1]
                                         - cam.screen_min[1])
    res = cam.resolution.astype(jnp.float32)
    p_raster = jnp.stack([ndc_x * res[0], ndc_y * res[1]], axis=-1)
    inside = ((p_raster[..., 0] >= 0) & (p_raster[..., 0] < res[0])
              & (p_raster[..., 1] >= 0) & (p_raster[..., 1] < res[1]))
    valid = valid & inside
    # screen area in camera space at z=1
    area = ((cam.screen_max[0] - cam.screen_min[0]) * cam.fov_scale
            * (cam.screen_max[1] - cam.screen_min[1]) * cam.fov_scale)
    lens_area = jnp.where(cam.lens_radius > 0,
                          jnp.pi * cam.lens_radius ** 2, 1.0)
    c2 = cos_theta * cos_theta
    we = jnp.where(valid, 1.0 / (area * lens_area * c2 * c2), 0.0)
    return we, p_raster, valid
