"""Scene container: SoA geometry/material/light tables + host-side builder.

JAX counterpart of ``core/scene.{h,cpp}`` + ``core/primitive.h``.
pbrt's Scene owns an aggregate of virtually-dispatched Primitives; here the
scene is a pytree of arrays grouped by shape family, with a *global primitive
index space*:

    [0, nT)              triangles
    [nT, nT+nS)          spheres
    [nT+nS, nT+nS+nP)    aaplanes (fork shapes/plane.cpp)
    [.., +nD)            disks

``prim_mat``/``prim_light`` map global prim index → material row / light row
(−1 = not emissive), replacing GeometricPrimitive's shape+material+arealight
triplet (core/primitive.h:51-119).

Counts are static metadata so jit specializes on scene topology (geometry
*sizes*) while positions/materials stay traced — the whole scene is
differentiable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core import spectrum as spec_mod
from pbrt_tpu.scene.materials import MaterialTable, make_material_table

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Geometry:
    # triangles
    tri_v0: Array   # (T,3)
    tri_v1: Array
    tri_v2: Array
    tri_n0: Array   # (T,3) shading normals
    tri_n1: Array
    tri_n2: Array
    tri_uv0: Array  # (T,2)
    tri_uv1: Array
    tri_uv2: Array
    # spheres
    sph_center: Array  # (S,3)
    sph_radius: Array  # (S,)
    # aaplanes (fork)
    pln_lo: Array      # (P,3)
    pln_hi: Array      # (P,3)
    pln_ax: Array      # (P,) int32
    pln_facing: Array  # (P,) bool
    # disks
    dsk_center: Array  # (D,3)
    dsk_normal: Array  # (D,3)
    dsk_radius: Array  # (D,)
    dsk_inner: Array   # (D,)
    # two-keyframe motion (TransformedPrimitive with AnimatedTransform,
    # core/api.cpp:1414): vertex deltas to the shutter-end positions; None
    # for static scenes. v(t) = tri_v* + t * tri_dv*.
    tri_dv0: Optional[Array] = None   # (T,3)
    tri_dv1: Optional[Array] = None
    tri_dv2: Optional[Array] = None
    # cubic Bézier curves (shapes/curve.cpp), analytic intersection
    crv_cp: Optional[Array] = None    # (Ncrv,4,3) world-space control pts
    crv_w: Optional[Array] = None     # (Ncrv,2) widths at u=0/1
    # ribbon orientation normals at u=0/1 ((0,0,0) rows = flat/cylinder;
    # curve.cpp Ribbon type slerps between them and scales the visible
    # width by |n·d|)
    crv_n: Optional[Array] = None     # (Ncrv,2,3)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Scene:
    geom: Geometry
    prim_mat: Array     # (N,) int32
    prim_light: Array   # (N,) int32 (−1 none)
    materials: MaterialTable
    lights: Any         # LightTable (scene/lights.py; Any to avoid cycle)
    world_lo: Array     # (3,) scene bounds
    world_hi: Array     # (3,)
    bvh: Optional[Any]  # scene/bvh.py FlatBVH or None
    camera_medium: Optional[Any]  # scene/media.py Medium or None
    textures: Optional[Any]  # scene/textures.py TextureTable or None
    n_tri: int = dataclasses.field(metadata=dict(static=True))
    n_sph: int = dataclasses.field(metadata=dict(static=True))
    n_pln: int = dataclasses.field(metadata=dict(static=True))
    n_dsk: int = dataclasses.field(metadata=dict(static=True))
    n_channels: int = dataclasses.field(metadata=dict(static=True))
    n_crv: int = dataclasses.field(metadata=dict(static=True), default=0)
    has_sss: bool = dataclasses.field(metadata=dict(static=True),
                                      default=False)
    # two-keyframe triangle motion present (animated shape transforms)
    has_motion: bool = dataclasses.field(metadata=dict(static=True),
                                         default=False)
    # tuple of scene/fourier.py FourierTables (() = none); material rows
    # reference them by MaterialTable.fourier_id
    fourier: Any = ()
    # per-primitive interior/exterior media (MediumInterface,
    # core/medium.h:114): static tuple of scene/media.py Medium + (N,)
    # int32 ids (−1 = vacuum); camera_med is the camera-side medium id
    media: Any = ()
    prim_med_in: Optional[Array] = None
    prim_med_out: Optional[Array] = None
    camera_med: int = dataclasses.field(metadata=dict(static=True),
                                        default=-1)
    # instancing (TransformedPrimitive role, core/primitive.h:92): shared
    # object-space pool + per-instance transforms; virtual prim ids occupy
    # [n_base_prims, n_base_prims + n_vprims) and prim_mat/prim_light are
    # extended accordingly (scene/instances.py)
    inst: Optional[Any] = None
    n_vprims: int = dataclasses.field(metadata=dict(static=True), default=0)
    # per-(material,channel) beam-diffusion radial tables
    # (scene/bssrdf.py SSSTables; None when no subsurface material).
    # Deliberately outside MaterialTable so gather_materials never
    # gathers (R,C,64) profile blocks
    sss: Optional[Any] = None
    # fused-path kernel profile (ops/fused_path.py): static
    # (axis, plane_facing, portal_facing, n_materials) when the scene is
    # in the all-matte single-portal-light class; None otherwise
    fused_profile: Optional[tuple] = dataclasses.field(
        metadata=dict(static=True), default=None)

    @property
    def n_base_prims(self) -> int:
        return self.n_tri + self.n_sph + self.n_pln + self.n_dsk \
            + self.n_crv

    @property
    def n_prims(self) -> int:
        return self.n_base_prims + self.n_vprims

    def world_radius(self) -> Array:
        return 0.5 * jnp.linalg.norm(self.world_hi - self.world_lo) + 1e-3

    # per-ray primitive-table lookups through the small-table gather path
    # (ops/fastgather.py — one-hot matmul for small scenes, plain take
    # above the threshold); use these instead of prim_mat[idx] in hot code
    def mat_at(self, prim_id: Array) -> Array:
        from pbrt_tpu.ops import fastgather
        return fastgather.gather_rows(self.prim_mat, prim_id)

    def light_at(self, prim_id: Array) -> Array:
        from pbrt_tpu.ops import fastgather
        return fastgather.gather_rows(self.prim_light, prim_id)


class SceneBuilder:
    """Host-side scene construction (numpy lists → device arrays).

    Plays the role of the pbrt* API state machine's world block
    (core/api.cpp:397-886) at the object level; the .pbrt parser frontend
    drives this builder.
    """

    def __init__(self, spectrum_cfg: spec_mod.SpectrumConfig = spec_mod.RGB):
        self.cfg = spectrum_cfg
        self.tris = []        # dicts: v0 v1 v2 [n0 n1 n2 uv0 uv1 uv2] mat light
        self.spheres = []     # center radius mat light
        self.planes = []      # lo hi ax facing mat light
        self.disks = []       # center normal radius inner mat light
        self.curves = []      # cp (4,3), w0, w1, mat
        self.materials = []   # parameter dicts (scene/materials.py)
        self.light_rows = []  # parameter dicts (scene/lights.py)
        self.texture_rows = []  # parameter dicts (scene/textures.py)
        self.images = []      # (H,W,C) numpy arrays for imagemap textures
        self.tex_filtering = "trilinear"  # or "ewa" (textures.py)
        self.fourier_tables = []  # scene/fourier.py FourierTables
        self.media = []       # scene/media.py Medium rows
        self.camera_med = -1  # camera-side medium id (−1 vacuum)
        self.bvh_split = "sah"  # BVH SplitMethod (bvh.h:58)
        # instancing (scene/instances.py): shared-object pool + transforms
        self.instance_objects = []  # dicts {"tris": [(v0,v1,v2,uvs,mat)]}
        self.instance_rows = []     # (obj_id, o2w 4x4)

    def add_instanced_object(self) -> int:
        """pbrtObjectBegin's role: open a shared object; fill it with
        add_object_mesh, then stamp copies with add_instance."""
        self.instance_objects.append({"tris": []})
        return len(self.instance_objects) - 1

    def add_object_mesh(self, obj_id: int, vertices, faces, mat=0,
                        uvs=None, normals=None):
        verts = np.asarray(vertices, np.float32)
        for f in faces:
            tri_uvs = (tuple(tuple(np.asarray(uvs[i], np.float32))
                             for i in f) if uvs is not None else None)
            tri_ns = (tuple(np.asarray(normals[i], np.float32)
                            for i in f) if normals is not None else None)
            self.instance_objects[obj_id]["tris"].append(
                (verts[f[0]], verts[f[1]], verts[f[2]], tri_uvs, tri_ns,
                 mat))

    def add_instance(self, obj_id: int, o2w):
        """pbrtObjectInstance's role: one 4x4, no geometry duplication."""
        self.instance_rows.append(
            (obj_id, np.asarray(o2w, np.float32).reshape(4, 4)))

    def add_medium(self, medium) -> int:
        """Register a participating medium (MakeNamedMedium's role);
        returns the id used by shape med_in/med_out and camera_med."""
        self.media.append(medium)
        return len(self.media) - 1

    def add_fourier_table(self, table_or_path) -> int:
        """Register a measured FourierBSDF table (materials/fourier.cpp);
        returns the id for MaterialTable.fourier_id."""
        if isinstance(table_or_path, str):
            from pbrt_tpu.scene import fourier as fourier_mod
            table_or_path = fourier_mod.read_bsdf(table_or_path)
        self.fourier_tables.append(table_or_path)
        return len(self.fourier_tables) - 1

    def add_texture(self, **params) -> int:
        for key in ("v1", "v2"):
            if key in params:
                params[key] = self._to_spec(params[key])
        self.texture_rows.append(params)
        return len(self.texture_rows) - 1

    def add_image(self, img) -> int:
        img = np.asarray(img, np.float32)
        if img.shape[-1] == 3 and self.cfg.n_channels != 3:
            img = np.asarray(spec_mod.from_rgb(jnp.asarray(img), self.cfg))
        self.images.append(img)
        return len(self.images) - 1

    # -- materials ---------------------------------------------------------
    def add_material(self, **params) -> int:
        for key in ("kd", "ks", "kr", "kt", "metal_eta", "metal_k",
                    "scatter_d"):
            if key in params:
                params[key] = self._to_spec(params[key])
        self.materials.append(params)
        return len(self.materials) - 1

    def _to_spec(self, v):
        v = np.asarray(v, np.float32)
        if v.ndim == 0:
            return np.full(self.cfg.n_channels, float(v), np.float32)
        if v.shape[-1] == 3 and self.cfg.n_channels != 3:
            return np.asarray(spec_mod.from_rgb(jnp.asarray(v), self.cfg))
        if v.shape[-1] == self.cfg.n_channels:
            return v
        raise ValueError(f"bad spectrum shape {v.shape}")

    # -- lights ------------------------------------------------------------
    def add_light(self, **params) -> int:
        for key in ("L", "I", "scale"):
            if key in params:
                params[key] = self._to_spec(params[key])
        self.light_rows.append(params)
        return len(self.light_rows) - 1

    # -- shapes ------------------------------------------------------------
    def add_triangle(self, v0, v1, v2, mat=0, light=-1, n0=None, n1=None,
                     n2=None, uv0=(0, 0), uv1=(1, 0), uv2=(1, 1),
                     med_in=-1, med_out=-1, v0_e=None, v1_e=None,
                     v2_e=None):
        """v*_e = shutter-end positions for two-keyframe motion blur
        (AnimatedTransform shape endpoint, core/api.cpp:1414)."""
        self.tris.append(dict(v0=v0, v1=v1, v2=v2, n0=n0, n1=n1, n2=n2,
                              uv0=uv0, uv1=uv1, uv2=uv2, mat=mat,
                              light=light, med_in=med_in, med_out=med_out,
                              v0_e=v0_e, v1_e=v1_e, v2_e=v2_e))
        return len(self.tris) - 1

    def add_mesh(self, vertices, indices, mat=0, light=-1, normals=None,
                 uvs=None, med_in=-1, med_out=-1, vertices_end=None):
        """trianglemesh: vertices (V,3), indices (F,3); ``vertices_end``
        gives per-vertex shutter-end positions for motion blur."""
        vertices = np.asarray(vertices, np.float32)
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        ve = None if vertices_end is None else np.asarray(vertices_end,
                                                         np.float32)
        ids = []
        for f in indices:
            kw = {}
            if normals is not None:
                kw.update(n0=normals[f[0]], n1=normals[f[1]],
                          n2=normals[f[2]])
            if uvs is not None:
                kw.update(uv0=uvs[f[0]], uv1=uvs[f[1]], uv2=uvs[f[2]])
            if ve is not None:
                kw.update(v0_e=ve[f[0]], v1_e=ve[f[1]], v2_e=ve[f[2]])
            kw.update(med_in=med_in, med_out=med_out)
            ids.append(self.add_triangle(vertices[f[0]], vertices[f[1]],
                                         vertices[f[2]], mat, light, **kw))
        return ids

    def add_sphere(self, center, radius, mat=0, light=-1, med_in=-1,
                   med_out=-1):
        self.spheres.append(dict(center=center, radius=radius, mat=mat,
                                 light=light, med_in=med_in,
                                 med_out=med_out))
        return len(self.spheres) - 1

    def add_aaplane(self, lo, hi, axis, facing_fw=True, mat=0, light=-1,
                    med_in=-1, med_out=-1):
        self.planes.append(dict(lo=lo, hi=hi, ax=axis, facing=facing_fw,
                                mat=mat, light=light, med_in=med_in,
                                med_out=med_out))
        return len(self.planes) - 1

    def add_disk(self, center, normal, radius, inner=0.0, mat=0, light=-1,
                 med_in=-1, med_out=-1):
        self.disks.append(dict(center=center, normal=normal, radius=radius,
                               inner=inner, mat=mat, light=light,
                               med_in=med_in, med_out=med_out))
        return len(self.disks) - 1

    def add_curve(self, cp, width0, width1, mat=0, med_in=-1, med_out=-1,
                  n0=None, n1=None):
        """Cubic Bézier hair/fur segment (shapes/curve.cpp), analytic
        intersection; cp: (4,3) world-space control points. n0/n1: ribbon
        orientation normals at u=0/1 (None = flat/cylinder)."""
        z = np.zeros(3, np.float32)
        self.curves.append(dict(cp=np.asarray(cp, np.float32).reshape(4, 3),
                                w0=float(width0), w1=float(width1), mat=mat,
                                med_in=med_in, med_out=med_out,
                                n0=(z if n0 is None
                                    else np.asarray(n0, np.float32)),
                                n1=(z if n1 is None
                                    else np.asarray(n1, np.float32))))
        return len(self.curves) - 1

    # -- finalize ----------------------------------------------------------
    def prim_index(self, family: str, local_idx: int) -> int:
        """Global primitive index for (family, local index)."""
        nt, ns, npl = len(self.tris), len(self.spheres), len(self.planes)
        base = {"tri": 0, "sph": nt, "pln": nt + ns,
                "dsk": nt + ns + npl}[family]
        return base + local_idx

    def build(self, use_bvh: str = "auto",
              tex_spread: float = 0.0) -> Scene:
        from pbrt_tpu.scene import lights as lights_mod

        ncv = len(self.curves)
        nt, ns, npl, nd = (len(self.tris), len(self.spheres),
                           len(self.planes), len(self.disks))
        f32 = lambda rows, k, shape: (
            np.asarray([np.asarray(r[k], np.float32) if r[k] is not None
                        else np.zeros(shape[1:], np.float32)
                        for r in rows], np.float32).reshape(shape)
            if rows else np.zeros(shape, np.float32))

        tv0 = f32(self.tris, "v0", (max(nt, 1), 3))
        tv1 = f32(self.tris, "v1", (max(nt, 1), 3))
        tv2 = f32(self.tris, "v2", (max(nt, 1), 3))
        # default shading normals = geometric
        gn = np.cross(tv1 - tv0, tv2 - tv0)
        gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                             1e-12)
        tn0 = np.asarray([np.asarray(r["n0"], np.float32)
                          if r["n0"] is not None else gn[i]
                          for i, r in enumerate(self.tris)], np.float32
                         ).reshape(max(nt, 1), 3) if nt else gn
        tn1 = np.asarray([np.asarray(r["n1"], np.float32)
                          if r["n1"] is not None else gn[i]
                          for i, r in enumerate(self.tris)], np.float32
                         ).reshape(max(nt, 1), 3) if nt else gn
        tn2 = np.asarray([np.asarray(r["n2"], np.float32)
                          if r["n2"] is not None else gn[i]
                          for i, r in enumerate(self.tris)], np.float32
                         ).reshape(max(nt, 1), 3) if nt else gn

        # two-keyframe motion deltas (None = static scene)
        has_motion = any(r.get("v0_e") is not None for r in self.tris)
        tdv = {}
        if has_motion:
            for key, base in (("v0", tv0), ("v1", tv1), ("v2", tv2)):
                end = np.asarray(
                    [np.asarray(r[key + "_e"], np.float32)
                     if r.get(key + "_e") is not None
                     else np.asarray(r[key], np.float32)
                     for r in self.tris], np.float32).reshape(max(nt, 1), 3)
                tdv["tri_d" + key] = jnp.asarray(end - base)

        geom = Geometry(
            tri_v0=jnp.asarray(tv0), tri_v1=jnp.asarray(tv1),
            tri_v2=jnp.asarray(tv2), **tdv,
            tri_n0=jnp.asarray(tn0), tri_n1=jnp.asarray(tn1),
            tri_n2=jnp.asarray(tn2),
            tri_uv0=jnp.asarray(f32(self.tris, "uv0", (max(nt, 1), 2))),
            tri_uv1=jnp.asarray(f32(self.tris, "uv1", (max(nt, 1), 2))),
            tri_uv2=jnp.asarray(f32(self.tris, "uv2", (max(nt, 1), 2))),
            sph_center=jnp.asarray(f32(self.spheres, "center",
                                       (max(ns, 1), 3))),
            sph_radius=jnp.asarray(
                np.asarray([r["radius"] for r in self.spheres] or [0.0],
                           np.float32)),
            pln_lo=jnp.asarray(f32(self.planes, "lo", (max(npl, 1), 3))),
            pln_hi=jnp.asarray(f32(self.planes, "hi", (max(npl, 1), 3))),
            pln_ax=jnp.asarray(
                np.asarray([r["ax"] for r in self.planes] or [2], np.int32)),
            pln_facing=jnp.asarray(
                np.asarray([r["facing"] for r in self.planes] or [True],
                           bool)),
            dsk_center=jnp.asarray(f32(self.disks, "center",
                                       (max(nd, 1), 3))),
            dsk_normal=jnp.asarray(f32(self.disks, "normal",
                                       (max(nd, 1), 3))),
            dsk_radius=jnp.asarray(
                np.asarray([r["radius"] for r in self.disks] or [0.0],
                           np.float32)),
            dsk_inner=jnp.asarray(
                np.asarray([r["inner"] for r in self.disks] or [0.0],
                           np.float32)),
            crv_cp=(jnp.asarray(np.stack([r["cp"] for r in self.curves]))
                    if ncv else None),
            crv_w=(jnp.asarray(np.asarray(
                [[r["w0"], r["w1"]] for r in self.curves], np.float32))
                if ncv else None),
            # static specialization: None unless some curve is a ribbon
            # (so flat/cylinder scenes never trace the slerp math)
            crv_n=(jnp.asarray(cn) if ncv and (cn := np.asarray(
                [[r["n0"], r["n1"]] for r in self.curves],
                np.float32)).any() else None),
        )

        def ids(rows, k, default=0):
            return np.asarray([r.get(k, default) for r in rows], np.int32) \
                if rows else np.zeros(0, np.int32)

        prim_mat = np.concatenate([ids(self.tris, "mat"),
                                   ids(self.spheres, "mat"),
                                   ids(self.planes, "mat"),
                                   ids(self.disks, "mat"),
                                   ids(self.curves, "mat")])
        prim_light = np.concatenate([ids(self.tris, "light"),
                                     ids(self.spheres, "light"),
                                     ids(self.planes, "light"),
                                     ids(self.disks, "light"),
                                     -np.ones(ncv, np.int32)])
        med_in = np.concatenate([ids(self.tris, "med_in", -1),
                                 ids(self.spheres, "med_in", -1),
                                 ids(self.planes, "med_in", -1),
                                 ids(self.disks, "med_in", -1),
                                 ids(self.curves, "med_in", -1)])
        med_out = np.concatenate([ids(self.tris, "med_out", -1),
                                  ids(self.spheres, "med_out", -1),
                                  ids(self.planes, "med_out", -1),
                                  ids(self.disks, "med_out", -1),
                                  ids(self.curves, "med_out", -1)])

        # instancing: extend the prim index space with one int entry per
        # (instance, pool triangle) — geometry itself is never duplicated
        inst_table = None
        n_vprims = 0
        inst_pts = []
        if self.instance_rows:
            from pbrt_tpu.scene import instances as inst_mod
            inst_table, vprim_mat = inst_mod.build_instance_table(
                self.instance_objects, self.instance_rows)
            n_vprims = int(inst_table.n_vprims)
            prim_mat = np.concatenate([prim_mat, vprim_mat])
            prim_light = np.concatenate(
                [prim_light, -np.ones(n_vprims, np.int32)])
            med_in = np.concatenate([med_in, -np.ones(n_vprims, np.int32)])
            med_out = np.concatenate([med_out,
                                      -np.ones(n_vprims, np.int32)])
            # world bounds: transformed object bbox corners per instance
            lo_np = np.asarray(inst_table.obj_lo)
            hi_np = np.asarray(inst_table.obj_hi)
            for (obj_id, m) in self.instance_rows:
                lo, hi = lo_np[obj_id], hi_np[obj_id]
                corners = np.array([[lo[0], lo[1], lo[2]],
                                    [hi[0], lo[1], lo[2]],
                                    [lo[0], hi[1], lo[2]],
                                    [hi[0], hi[1], lo[2]],
                                    [lo[0], lo[1], hi[2]],
                                    [hi[0], lo[1], hi[2]],
                                    [lo[0], hi[1], hi[2]],
                                    [hi[0], hi[1], hi[2]]], np.float32)
                inst_pts.append(corners @ m[:3, :3].T + m[:3, 3])

        if prim_mat.size == 0:
            prim_mat = np.zeros(1, np.int32)
            prim_light = -np.ones(1, np.int32)
            med_in = -np.ones(1, np.int32)
            med_out = -np.ones(1, np.int32)

        # world bounds (union over both motion keyframes)
        pts = [tv0[:nt].reshape(-1, 3), tv1[:nt].reshape(-1, 3),
               tv2[:nt].reshape(-1, 3)]
        if has_motion and nt:
            pts += [(tv0[:nt] + np.asarray(tdv["tri_dv0"])[:nt]),
                    (tv1[:nt] + np.asarray(tdv["tri_dv1"])[:nt]),
                    (tv2[:nt] + np.asarray(tdv["tri_dv2"])[:nt])]
        if ns:
            c = f32(self.spheres, "center", (ns, 3))
            r = np.asarray([s["radius"] for s in self.spheres],
                           np.float32)[:, None]
            pts += [c - r, c + r]
        if npl:
            pts += [f32(self.planes, "lo", (npl, 3)),
                    f32(self.planes, "hi", (npl, 3))]
        if nd:
            c = f32(self.disks, "center", (nd, 3))
            r = np.asarray([s["radius"] for s in self.disks],
                           np.float32)[:, None]
            pts += [c - r, c + r]
        if ncv:
            cps = np.stack([r["cp"] for r in self.curves]).reshape(-1, 3)
            wmax = max(max(r["w0"], r["w1"]) for r in self.curves)
            pts += [cps - wmax, cps + wmax]
        pts += inst_pts
        allp = np.concatenate([p for p in pts if p.size]) \
            if any(p.size for p in pts) else np.zeros((1, 3), np.float32)
        world_lo = allp.min(0) - 1e-3
        world_hi = allp.max(0) + 1e-3

        materials = make_material_table(
            self.materials or [dict()], self.cfg.n_channels)
        from pbrt_tpu.scene import materials as mat_mod
        from pbrt_tpu.scene import bssrdf as bssrdf_mod
        has_sss = any(r.get("type") == mat_mod.SUBSURFACE
                      or bssrdf_mod.row_is_disney_sss(r)
                      for r in self.materials)
        sss_tables = None
        if has_sss:
            sss_tables = bssrdf_mod.build_scene_tables(
                self.materials, self.cfg.n_channels)
        scene = Scene(
            geom=geom,
            prim_mat=jnp.asarray(prim_mat),
            prim_light=jnp.asarray(prim_light),
            materials=materials,
            lights=None,
            world_lo=jnp.asarray(world_lo), world_hi=jnp.asarray(world_hi),
            bvh=None, camera_medium=None,
            textures=None,
            n_tri=nt, n_sph=ns, n_pln=npl, n_dsk=nd, n_crv=ncv,
            n_channels=self.cfg.n_channels, has_sss=has_sss,
            has_motion=has_motion,
            fourier=tuple(self.fourier_tables),
            media=tuple(self.media),
            prim_med_in=jnp.asarray(med_in),
            prim_med_out=jnp.asarray(med_out),
            camera_med=self.camera_med,
            inst=inst_table, n_vprims=n_vprims, sss=sss_tables)
        lights = lights_mod.build_light_table(self, scene)
        scene = dataclasses.replace(scene, lights=lights)
        if self.texture_rows:
            from pbrt_tpu.scene import textures as tex_mod
            scene = dataclasses.replace(
                scene, textures=tex_mod.make_texture_table(
                    self.texture_rows, self.images, self.cfg.n_channels,
                    spread=tex_spread, filtering=self.tex_filtering))
        if use_bvh == "always" or (use_bvh == "auto" and nt > 256):
            from pbrt_tpu.scene import bvh as bvh_mod
            scene = dataclasses.replace(
                scene, bvh=bvh_mod.build_bvh(self, scene,
                                             split_method=self.bvh_split))
        prof = self._fused_profile(scene)
        if prof is not None:
            scene = dataclasses.replace(scene, fused_profile=prof)
        return scene

    def _fused_profile(self, scene):
        """Static profile for the fused path-bounce kernel
        (ops/fused_path.py): all-matte triangles + ONE aaplane that is
        the scene's single one-sided area light, either

        - mode 1 ("projection"): a projection-strategy portal light
          (one portal, parallel to the light plane) — the fork's
          light-through-opening scenario, or
        - mode 0 ("area", r5): a plain diffuse area light (the classic
          cornell-box class) with full two-sample-MIS NEE.

        Returns (axis, plane_facing, portal_facing, n_materials, mode)
        or None."""
        if (scene.n_sph or scene.n_dsk or scene.n_crv or scene.n_vprims
                or scene.inst is not None):
            return None
        # A built BVH does not disqualify: the fused kernel reads the
        # builder-order geom arrays directly (build_bvh keeps its own
        # leaf-ordered copies) and culls via its cluster AABBs; the XLA
        # fallback still uses scene.bvh. Cap: the (n_tri, 16) f32 triangle
        # table (64 KB at 1024 rows) is read by broadcast loads from every
        # block, so it has to stay small enough to live in L1/L2.
        if scene.n_pln != 1 or scene.n_tri < 1 or scene.n_tri > 1024:
            return None
        if (scene.has_motion or scene.has_sss or scene.media
                or scene.textures is not None or scene.fourier
                or scene.camera_med != -1):
            return None
        if scene.n_channels != 3 or len(self.materials) > 8:
            return None
        for m in self.materials:
            if set(m) - {"type", "kd", "sigma"}:
                return None
            if int(m.get("type", 0)) != 0:
                return None
            if float(np.max(np.asarray(m.get("sigma", 0.0)))) != 0.0:
                return None
        if len(self.light_rows) != 1:
            return None
        lr = self.light_rows[0]
        if lr.get("type") != "area" or lr.get("two_sided", False):
            return None
        pl = self.planes[0]
        if int(pl.get("med_in", -1)) != -1 or int(pl.get("med_out", -1)) \
                != -1:
            return None
        if any(t["light"] != -1 or t.get("med_in", -1) != -1
               or t.get("med_out", -1) != -1 for t in self.tris):
            return None
        if int(np.asarray(scene.lights.prim_id)[0]) != scene.n_tri:
            return None
        portals = lr.get("portals") or ()
        if not portals:
            if lr.get("strategy") not in (None, "light"):
                return None
            return (int(pl["ax"]), bool(pl["facing"]), False,
                    len(self.materials), 0)
        if lr.get("strategy") != "projection" or len(portals) != 1:
            return None
        pax = int(portals[0][2])
        pfac = bool(portals[0][3])
        if int(pl["ax"]) != pax:       # SampleProj assumes parallel rects
            return None
        return (pax, bool(pl["facing"]), pfac, len(self.materials), 1)
