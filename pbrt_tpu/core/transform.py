"""4x4 transforms (core/transform.{h,cpp}) and quaternions.

A Transform is just a pair of (4,4) matrices (m, m_inv) stored as arrays —
no class hierarchy, composable with ``@``. Applying to batched points /
vectors / normals / rays mirrors transform.h:263-408, including the fork's
wavelength propagation (wvls ride along unchanged on the Ray pytree).

AnimatedTransform (motion blur) is represented by its two endpoint transforms
plus SRT-decomposed interpolation, evaluated per ray time — vectorized.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core import vecmath
from pbrt_tpu.core.vecmath import Ray

Array = Any


def _mm(a: Array, b: Array) -> Array:
    """Matrix product exact to float32: on a GPU a float32 dot may run
    in TF32, and transformed ray origins feed SHADOW_EPS offsets."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Transform:
    m: Array      # (4,4)
    m_inv: Array  # (4,4)

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(_mm(self.m, other.m), _mm(other.m_inv, self.m_inv))

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def apply_point(self, p: Array) -> Array:
        r = _mm(p, self.m[:3, :3].T) + self.m[:3, 3]
        w = _mm(p, self.m[3, :3].T) + self.m[3, 3]
        return jnp.where(w[..., None] == 1.0, r, r / w[..., None])

    def apply_vector(self, v: Array) -> Array:
        return _mm(v, self.m[:3, :3].T)

    def apply_normal(self, n: Array) -> Array:
        # normals transform by the inverse transpose (transform.h:287)
        return _mm(n, self.m_inv[:3, :3])

    def apply_ray(self, ray: Ray) -> Ray:
        return Ray(o=self.apply_point(ray.o), d=self.apply_vector(ray.d),
                   tmax=ray.tmax, wvls=ray.wvls)

    def swaps_handedness(self) -> Array:
        return jnp.linalg.det(self.m[:3, :3]) < 0.0


def identity() -> Transform:
    return Transform(jnp.eye(4), jnp.eye(4))


def from_matrix(m) -> Transform:
    m = np.asarray(m, np.float32).reshape(4, 4)
    return Transform(jnp.asarray(m), jnp.asarray(np.linalg.inv(m)))


def translate(delta) -> Transform:
    d = np.asarray(delta, np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = d
    mi = np.eye(4, dtype=np.float32)
    mi[:3, 3] = -d
    return Transform(jnp.asarray(m), jnp.asarray(mi))


def scale(s) -> Transform:
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    m = np.diag(np.append(s, 1.0).astype(np.float32))
    mi = np.diag(np.append(1.0 / s, 1.0).astype(np.float32))
    return Transform(jnp.asarray(m), jnp.asarray(mi))


def rotate(theta_deg: float, axis) -> Transform:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.radians(theta_deg)), np.cos(np.radians(theta_deg))
    m = np.eye(4)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    m[:3, :3] = c * np.eye(3) + s * K + (1 - c) * np.outer(a, a)
    return Transform(jnp.asarray(m.astype(np.float32)),
                     jnp.asarray(m.T.astype(np.float32)))


def rotate_x(deg):
    return rotate(deg, (1, 0, 0))


def rotate_y(deg):
    return rotate(deg, (0, 1, 0))


def rotate_z(deg):
    return rotate(deg, (0, 0, 1))


def look_at(eye, look, up) -> Transform:
    """transform.cpp LookAt: camera-to-world."""
    eye = np.asarray(eye, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    nr = np.linalg.norm(right)
    if nr < 1e-10:
        # up parallel to viewing direction — pick an arbitrary right
        right = np.cross(np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9
                         else np.array([1.0, 0.0, 0.0]), d)
        nr = np.linalg.norm(right)
    right /= nr
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return Transform(jnp.asarray(m.astype(np.float32)),
                     jnp.asarray(np.linalg.inv(m).astype(np.float32)))


def perspective(fov_deg: float, near: float, far: float) -> Transform:
    """transform.cpp Perspective projection (camera space → NDC-ish)."""
    inv_tan = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    persp = np.array([
        [1, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, far / (far - near), -far * near / (far - near)],
        [0, 0, 1, 0]], np.float64)
    m = np.diag([inv_tan, inv_tan, 1.0, 1.0]) @ persp
    return Transform(jnp.asarray(m.astype(np.float32)),
                     jnp.asarray(np.linalg.inv(m).astype(np.float32)))


def orthographic(znear: float, zfar: float) -> Transform:
    m = np.eye(4)
    m[2, 2] = 1.0 / (zfar - znear)
    m[2, 3] = -znear / (zfar - znear)
    return Transform(jnp.asarray(m.astype(np.float32)),
                     jnp.asarray(np.linalg.inv(m).astype(np.float32)))


# ---------------------------------------------------------------------------
# Quaternions + AnimatedTransform (transform.cpp / quaternion.cpp)
# ---------------------------------------------------------------------------

def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix (3,3) → quaternion (x,y,z,w). Host-side."""
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0)
        w = s / 2.0
        s = 0.5 / s
        return np.array([(m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
                         (m[1, 0] - m[0, 1]) * s, w])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(0.0, m[i, i] - m[j, j] - m[k, k] + 1.0))
    q = np.zeros(4)
    q[i] = s * 0.5
    s = 0.5 / s if s != 0 else 0.0
    q[3] = (m[k, j] - m[j, k]) * s
    q[j] = (m[j, i] + m[i, j]) * s
    q[k] = (m[k, i] + m[i, k]) * s
    return q


def quat_slerp(t: Array, q0: Array, q1: Array) -> Array:
    """quaternion.cpp Slerp, batched over t."""
    cos_theta = jnp.sum(q0 * q1, axis=-1)
    q1 = jnp.where(cos_theta[..., None] < 0.0, -q1, q1)
    cos_theta = jnp.abs(cos_theta)
    theta = jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0))
    sin_theta = jnp.sin(theta)
    near = cos_theta > 0.9995
    w0_l = 1.0 - t
    w1_l = t
    w0_s = jnp.sin((1.0 - t) * theta) / jnp.where(near, 1.0, sin_theta)
    w1_s = jnp.sin(t * theta) / jnp.where(near, 1.0, sin_theta)
    w0 = jnp.where(near, w0_l, w0_s)
    w1 = jnp.where(near, w1_l, w1_s)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_matrix(q: Array) -> Array:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                   2 * (x * z + y * w)], axis=-1),
        jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                   2 * (y * z - x * w)], axis=-1),
        jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                   1 - 2 * (x * x + y * y)], axis=-1)], axis=-2)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AnimatedTransform:
    """SRT-decomposed endpoint transforms (transform.cpp:~Decompose)."""
    t0: Array   # (3,) translations
    t1: Array
    q0: Array   # (4,) rotations
    q1: Array
    s0: Array   # (3,3) scale/shear
    s1: Array
    start_time: Array
    end_time: Array

    def interpolate(self, time: Array) -> Array:
        """Return (..., 4, 4) matrices for batched times."""
        dt = jnp.clip((time - self.start_time)
                      / jnp.maximum(self.end_time - self.start_time, 1e-9),
                      0.0, 1.0)
        trans = vecmath.lerp(dt[..., None], self.t0, self.t1)
        rot = quat_to_matrix(quat_slerp(dt, self.q0, self.q1))
        sc = vecmath.lerp(dt[..., None, None], self.s0, self.s1)
        upper = _mm(rot, sc)
        m = jnp.zeros(dt.shape + (4, 4))
        m = m.at[..., :3, :3].set(upper)
        m = m.at[..., :3, 3].set(trans)
        m = m.at[..., 3, 3].set(1.0)
        return m


def decompose(m: np.ndarray):
    """transform.cpp AnimatedTransform::Decompose (host-side)."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    M = m[:3, :3].copy()
    # polar decomposition by iteration
    R = M.copy()
    for _ in range(100):
        R_next = 0.5 * (R + np.linalg.inv(R.T))
        if np.max(np.abs(R_next - R)) < 1e-8:
            R = R_next
            break
        R = R_next
    S = np.linalg.inv(R) @ M
    return t, quat_from_matrix(R), S


def make_animated(tr0: Transform, tr1: Transform, t_start=0.0, t_end=1.0
                  ) -> AnimatedTransform:
    t0, q0, s0 = decompose(np.asarray(tr0.m))
    t1, q1, s1 = decompose(np.asarray(tr1.m))
    return AnimatedTransform(
        t0=jnp.asarray(t0, jnp.float32), t1=jnp.asarray(t1, jnp.float32),
        q0=jnp.asarray(q0, jnp.float32), q1=jnp.asarray(q1, jnp.float32),
        s0=jnp.asarray(s0, jnp.float32), s1=jnp.asarray(s1, jnp.float32),
        start_time=jnp.asarray(t_start, jnp.float32),
        end_time=jnp.asarray(t_end, jnp.float32))
