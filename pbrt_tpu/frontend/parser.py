""".pbrt scene-description parser + scene-build state machine.

JAX counterpart of L5: the tokenizer + recursive parse() of
``core/parser.cpp:98-1080`` and the ~40-call pbrt* API state machine of
``core/api.cpp:367-1752`` (GraphicsState attribute stack, CTM stack,
Make* factories), collapsed into one cold-path Python module that drives
``SceneBuilder``.

Grammar coverage: the directive/parameter subset exercised by the shipped
scenes (scenes/cornell_dielectric.pbrt, scenes/killeroo-simple.pbrt,
scenes/blender/*/out/*.pbrt) — LookAt/Transform/Scale/Translate/Rotate/
ConcatTransform, Camera, Film, Sampler, PixelFilter, Integrator,
Accelerator, WorldBegin/End, AttributeBegin/End, TransformBegin/End,
ObjectBegin/End/Instance, ReverseOrientation, Texture,
Material/MakeNamedMaterial/NamedMaterial, LightSource, AreaLightSource
(incl. the fork's "portal" with portalData s-expressions), Shape
(trianglemesh/plymesh/sphere/disk/aaplane), Include.
"""

from __future__ import annotations

import copy
import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from pbrt_tpu.core import transform as tr
from pbrt_tpu.core import spectrum as spec_mod
from pbrt_tpu.frontend.sexpr import parse_portal_data
from pbrt_tpu.scene import materials as mat_mod
from pbrt_tpu.scene.types import SceneBuilder


# ---------------------------------------------------------------------------
# tokenizer (core/parser.cpp:98-203)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s"\[\]#]+|#[^\n]*')


def tokenize(text: str):
    for m in _TOKEN_RE.finditer(text):
        t = m.group(0)
        if t.startswith("#"):
            continue
        yield t


# ---------------------------------------------------------------------------
# ParamSet parsing (core/paramset.cpp ParseParams)
# ---------------------------------------------------------------------------

_PARAM_TYPES = {"integer", "float", "bool", "string", "point", "point3",
                "point2", "vector", "vector3", "normal", "rgb", "color",
                "spectrum", "texture", "blackbody", "xyz"}


def _convert(ptype: str, vals):
    # tolerate trailing commas in numeric lists (blender-exporter artifact
    # that the reference's std::stof silently accepts, e.g. lamp.pbrt:75)
    vals = [v.rstrip(",") if isinstance(v, str) else v for v in vals]
    if ptype == "integer":
        return np.asarray([int(float(v)) for v in vals], np.int64)
    if ptype in ("float",):
        return np.asarray([float(v) for v in vals], np.float64)
    if ptype == "bool":
        return [v.strip('"') == "true" for v in vals]
    if ptype in ("string", "texture"):
        return [v.strip('"') for v in vals]
    if ptype == "spectrum" and vals and isinstance(vals[0], str) \
            and vals[0].startswith('"'):
        # on-disk SPD: "spectrum Kd" "metal-Cu.spd" (core/floatfile.cpp via
        # paramset.cpp:... ) — keep the filename; resolved in spectrum_rgb
        return [v.strip('"') for v in vals]
    return np.asarray([float(v) for v in vals], np.float64)


class Params(dict):
    """Typed parameter bag (core/paramset.h:53 FindOne* semantics)."""

    def one(self, name, default=None):
        if name not in self:
            return default
        ptype, vals = self[name]
        if ptype in ("string", "texture", "bool"):
            return vals[0]
        if ptype == "integer":
            return int(vals[0])
        if ptype == "float":
            return float(vals[0])
        return vals

    def point(self, name, default=None):
        if name not in self:
            return default
        return tuple(np.asarray(self[name][1], np.float64).reshape(-1)[:3])

    # set by PbrtParser so on-disk SPDs resolve relative to the scene file
    _base_dir = "."

    def spectrum_rgb(self, name, default=None):
        """Resolve any spectrum-typed parameter to linear RGB."""
        if name not in self:
            return default
        ptype, vals = self[name]
        if ptype == "spectrum" and len(vals) and isinstance(vals[0], str):
            # "spectrum X" "file.spd": (λ_nm, value) pairs on disk
            # (core/floatfile.cpp ReadFloatFile)
            import os
            from pbrt_tpu.utils.floatfile import read_float_file
            path = vals[0] if os.path.isabs(vals[0]) \
                else os.path.join(self._base_dir, vals[0])
            vals = np.asarray(read_float_file(path), np.float64)
        a = np.asarray(vals, np.float64).reshape(-1)
        if ptype in ("rgb", "color"):
            return tuple(a[:3])
        if ptype == "spectrum":
            pairs = a.reshape(-1, 2)
            return tuple(spec_mod.spd_from_pairs(pairs[:, 0], pairs[:, 1],
                                                 spec_mod.RGB))
        if ptype == "blackbody":
            lam = spec_mod.bin_centers()
            s = np.asarray(spec_mod.blackbody_normalized(lam, a[0]))
            scale = a[1] if len(a) > 1 else 1.0
            rgb = np.asarray(spec_mod.spectrum_to_rgb(s * scale))
            return tuple(rgb)
        if ptype == "float":
            return (a[0], a[0], a[0])
        if ptype == "xyz":
            return tuple(np.asarray(
                spec_mod.xyz_to_rgb(np.asarray(a[:3]))))
        return tuple(a[:3])


def parse_params(tokens, peeked) -> Params:
    """Consume '"type name" [values...]' pairs until a non-param token."""
    params = Params()
    while True:
        t = peeked[0] if peeked else next(tokens, None)
        peeked.clear()
        if t is None:
            break
        if not (t.startswith('"') and len(t.split()) == 2
                and t.strip('"').split()[0] in _PARAM_TYPES):
            peeked.append(t)
            break
        ptype, name = t.strip('"').split()
        nxt = next(tokens)
        vals = []
        if nxt == "[":
            for v in tokens:
                if v == "]":
                    break
                vals.append(v)
        else:
            vals.append(nxt)
        params[name] = (ptype, _convert(ptype, vals))
    return params


# ---------------------------------------------------------------------------
# graphics state (core/api.cpp:207 GraphicsState + CTM stack)
# ---------------------------------------------------------------------------

@dataclass
class GraphicsState:
    material_id: int = 0
    area_light: Optional[dict] = None
    reverse_orientation: bool = False
    named_materials: dict = field(default_factory=dict)
    textures: dict = field(default_factory=dict)
    # MediumInterface (api.cpp pbrtMediumInterface): medium ids (−1 vacuum)
    medium_in: int = -1
    medium_out: int = -1


class PbrtParser:
    def __init__(self, spectrum_cfg=spec_mod.RGB, base_dir="."):
        self.builder = SceneBuilder(spectrum_cfg)
        self.base_dir = base_dir
        Params._base_dir = base_dir
        self.ctm = np.eye(4)
        self.ctm2 = np.eye(4)          # end-time CTM (TransformSet[1])
        self.active = (True, True)     # pbrtActiveTransformAll default
        self.ctm_stack = []
        self.gs = GraphicsState()
        self.gs_stack = []
        self.world = False
        self.options = {
            "integrator": "path", "integrator_params": Params(),
            "sampler": "halton", "spp": 16,
            "film": {"xres": 640, "yres": 480, "filename": "out.exr"},
            "filter": ("box", {}),
            "camera": ("perspective", Params()),
            "camera_to_world": np.eye(4),
        }
        self.object_defs = {}      # name → recorded shape list
        self.recording = None
        self._instance_obj_ids = {}  # name → builder instanced-object id
        self.named_media = {}      # MakeNamedMedium name → medium id
        # default material (api.cpp: matte)
        self.builder.add_material(type=mat_mod.MATTE, kd=0.5)

    # -- transforms --------------------------------------------------------

    def _apply(self, m):
        # pbrt keeps MaxTransforms=2 CTMs (start/end time, api.cpp
        # TransformSet); ActiveTransform selects which ones directives hit
        if self.active[0]:
            self.ctm = self.ctm @ m
        if self.active[1]:
            self.ctm2 = self.ctm2 @ m

    def _set(self, m):
        if self.active[0]:
            self.ctm = m.copy()
        if self.active[1]:
            self.ctm2 = m.copy()

    @property
    def animated(self) -> bool:
        return not np.allclose(self.ctm, self.ctm2)

    def _xf_point(self, p):
        v = self.ctm @ np.append(np.asarray(p, np.float64), 1.0)
        return tuple(v[:3] / v[3])

    def _xf_point2(self, p):
        v = self.ctm2 @ np.append(np.asarray(p, np.float64), 1.0)
        return tuple(v[:3] / v[3])

    def _xf_vec(self, p):
        return tuple((self.ctm[:3, :3] @ np.asarray(p, np.float64)))

    def _xf_normal(self, n):
        inv = np.linalg.inv(self.ctm[:3, :3])
        return tuple(inv.T @ np.asarray(n, np.float64))

    # -- directive dispatch ------------------------------------------------

    def parse(self, text: str):
        tokens = tokenize(text)
        peeked = []

        def nxt():
            if peeked:
                return peeked.pop()
            return next(tokens, None)

        while True:
            t = nxt()
            if t is None:
                break
            handler = getattr(self, "_d_" + t, None)
            if handler is None:
                # unknown directive: skip (+ any bracketed block)
                continue
            handler(tokens, peeked, nxt)
        return self

    # directives ----------------------------------------------------------

    def _d_Include(self, tokens, peeked, nxt):
        fname = nxt().strip('"')
        path = os.path.join(self.base_dir, fname)
        with open(path) as f:
            sub = PbrtParser.__new__(PbrtParser)
            sub.__dict__ = self.__dict__  # share all state
            sub.parse(f.read())

    def _d_LookAt(self, tokens, peeked, nxt):
        v = [float(nxt()) for _ in range(9)]
        m = np.asarray(tr.look_at(v[0:3], v[3:6], v[6:9]).m)
        # pbrt: CTM *= world-to-camera (api.cpp pbrtLookAt)
        self._apply(np.linalg.inv(np.asarray(m, np.float64)))

    def _d_Translate(self, tokens, peeked, nxt):
        v = [float(nxt()) for _ in range(3)]
        m = np.eye(4)
        m[:3, 3] = v
        self._apply(m)

    def _d_Scale(self, tokens, peeked, nxt):
        v = [float(nxt()) for _ in range(3)]
        self._apply(np.diag(v + [1.0]))

    def _d_Rotate(self, tokens, peeked, nxt):
        ang = float(nxt())
        ax = [float(nxt()) for _ in range(3)]
        self._apply(np.asarray(tr.rotate(ang, ax).m, np.float64))

    def _d_Transform(self, tokens, peeked, nxt):
        vals = self._matrix_vals(tokens, nxt)
        self._set(np.asarray(vals, np.float64).reshape(4, 4).T)

    def _d_ConcatTransform(self, tokens, peeked, nxt):
        vals = self._matrix_vals(tokens, nxt)
        self._apply(np.asarray(vals, np.float64).reshape(4, 4).T)

    def _d_Identity(self, tokens, peeked, nxt):
        self._set(np.eye(4))

    def _d_ActiveTransform(self, tokens, peeked, nxt):
        """pbrtActiveTransform{All,StartTime,EndTime}
        (core/parser.cpp:867-875)."""
        which = nxt().strip('"')
        self.active = {"All": (True, True), "StartTime": (True, False),
                       "EndTime": (False, True)}.get(which, (True, True))

    def _d_TransformTimes(self, tokens, peeked, nxt):
        """pbrtTransformTimes (core/api.cpp: shutter interval the two CTMs
        correspond to)."""
        t0 = float(nxt())
        t1 = float(nxt())
        self.options["transform_times"] = (t0, t1)

    def _matrix_vals(self, tokens, nxt):
        t = nxt()
        vals = []
        if t == "[":
            for v in tokens:
                if v == "]":
                    break
                vals.append(float(v))
        else:
            vals.append(float(t))
            for _ in range(15):
                vals.append(float(next(tokens)))
        return vals

    def _d_Camera(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        params = parse_params(tokens, peeked)
        # camera-to-world = inverse(CTM) (api.cpp pbrtCamera); both time
        # endpoints kept — differing ones make an animated camera
        # (api.cpp:814 MakeCamera's AnimatedTransform)
        self.options["camera"] = (name, params)
        self.options["camera_to_world"] = np.linalg.inv(self.ctm)
        self.options["camera_to_world_end"] = np.linalg.inv(self.ctm2)

    def _d_Film(self, tokens, peeked, nxt):
        nxt()  # "image"
        p = parse_params(tokens, peeked)
        self.options["film"] = {
            "xres": p.one("xresolution", 640),
            "yres": p.one("yresolution", 480),
            "filename": p.one("filename", "out.exr")}
        if "cropwindow" in p:
            cw = np.asarray(p["cropwindow"][1], np.float64).reshape(-1)[:4]
            self.options["film"]["crop"] = tuple(cw)

    def _d_Sampler(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = parse_params(tokens, peeked)
        self.options["sampler"] = name
        self.options["spp"] = p.one("pixelsamples", 16)

    def _d_PixelFilter(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = parse_params(tokens, peeked)
        kw = {}
        if p.one("xwidth") is not None:
            kw["xwidth"] = p.one("xwidth")
        if p.one("ywidth") is not None:
            kw["ywidth"] = p.one("ywidth")
        self.options["filter"] = (name, kw)

    def _d_Integrator(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = parse_params(tokens, peeked)
        self.options["integrator"] = name
        self.options["integrator_params"] = p

    def _d_Accelerator(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = parse_params(tokens, peeked)
        self.options["accelerator"] = name  # "bvh" (default) | "kdtree"
        sm = p.one("splitmethod")
        if sm:
            # BVHAccel "string splitmethod" sah|middle|equal|hlbvh
            self.builder.bvh_split = str(sm).strip('"')

    def _d_WorldBegin(self, tokens, peeked, nxt):
        self.world = True
        self.ctm = np.eye(4)
        self.ctm2 = np.eye(4)
        self.active = (True, True)

    def _d_WorldEnd(self, tokens, peeked, nxt):
        pass

    def _d_AttributeBegin(self, tokens, peeked, nxt):
        self.gs_stack.append(copy.deepcopy(self.gs))
        self.ctm_stack.append((self.ctm.copy(), self.ctm2.copy(),
                               self.active))

    def _d_AttributeEnd(self, tokens, peeked, nxt):
        self.gs = self.gs_stack.pop()
        self.ctm, self.ctm2, self.active = self.ctm_stack.pop()

    def _d_TransformBegin(self, tokens, peeked, nxt):
        # pbrtTransformBegin (api.cpp): saves the CTM ONLY — material /
        # texture / light state set inside the block persists past the End
        self.ctm_stack.append((self.ctm.copy(), self.ctm2.copy(),
                               self.active))

    def _d_TransformEnd(self, tokens, peeked, nxt):
        self.ctm, self.ctm2, self.active = self.ctm_stack.pop()

    def _d_ObjectBegin(self, tokens, peeked, nxt):
        self._d_AttributeBegin(tokens, peeked, nxt)
        self.recording = nxt().strip('"')
        self.object_defs[self.recording] = []

    def _d_ObjectEnd(self, tokens, peeked, nxt):
        self.recording = None
        self._d_AttributeEnd(tokens, peeked, nxt)

    def _d_ObjectInstance(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        entries = self.object_defs.get(name, [])
        # true instancing (TransformedPrimitive, core/primitive.h:92) for
        # pure triangle-mesh objects without area lights/media: geometry
        # goes into the shared pool ONCE; each instance adds only its CTM.
        # Anything else (analytic shapes, emissive, media) falls back to
        # flattened copies.
        if self._instanceable(name, entries):
            if name not in self._instance_obj_ids:
                oid = self.builder.add_instanced_object()
                for entry in entries:
                    p = entry["params"]
                    idx = np.asarray(p["indices"][1], np.int32).reshape(-1,
                                                                        3)
                    pts = np.asarray(p["P"][1], np.float64).reshape(-1, 3)
                    m = entry["ctm"]
                    pts_o = (pts @ m[:3, :3].T + m[:3, 3]).astype(
                        np.float32)
                    uvs = None
                    for uk in ("st", "uv"):
                        if uk in p:
                            uvs = np.asarray(p[uk][1],
                                             np.float64).reshape(-1, 2)
                    normals = None
                    if "N" in p:
                        # normals into object-pool space via the block
                        # CTM's inverse-transpose (core/transform.h
                        # Normal overload)
                        ns = np.asarray(p["N"][1],
                                        np.float64).reshape(-1, 3)
                        mi = np.linalg.inv(m[:3, :3])
                        normals = (ns @ mi).astype(np.float32)
                    self.builder.add_object_mesh(
                        oid, pts_o, idx, mat=entry["gs"].material_id,
                        uvs=uvs, normals=normals)
                self._instance_obj_ids[name] = oid
            self.builder.add_instance(self._instance_obj_ids[name],
                                      self.ctm)
            return
        for entry in entries:
            saved = self.ctm
            self.ctm = self.ctm @ entry["ctm"]
            self._emit_shape(entry["name"], entry["params"], entry["gs"])
            self.ctm = saved

    @staticmethod
    def _instanceable(name, entries) -> bool:
        return bool(entries) and all(
            e["name"] == "trianglemesh" and e["gs"].area_light is None
            and e["gs"].medium_in == -1 and e["gs"].medium_out == -1
            for e in entries)

    def _d_ReverseOrientation(self, tokens, peeked, nxt):
        self.gs.reverse_orientation = not self.gs.reverse_orientation

    def _d_Texture(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        _type = nxt().strip('"')
        klass = nxt().strip('"')
        p = parse_params(tokens, peeked)
        self.gs.textures[name] = (klass, p)

    def _d_MakeNamedMedium(self, tokens, peeked, nxt):
        """MakeNamedMedium (api.cpp pbrtMakeNamedMedium → MakeMedium,
        media/homogeneous.cpp + media/grid.cpp factories)."""
        from pbrt_tpu.scene import media as media_mod
        name = nxt().strip('"')
        p = parse_params(tokens, peeked)
        mtype = p.one("type", "homogeneous")
        C = self.builder.cfg.n_channels
        scale = p.one("scale", 1.0)
        sa = np.asarray(p.spectrum_rgb("sigma_a", (1.0, 1.0, 1.0)),
                        np.float32) * scale
        ss = np.asarray(p.spectrum_rgb("sigma_s", (1.0, 1.0, 1.0)),
                        np.float32) * scale
        g = p.one("g", 0.0)
        if mtype == "heterogeneous" and "density" in p:
            nx, ny, nz = (int(p.one("nx", 1)), int(p.one("ny", 1)),
                          int(p.one("nz", 1)))
            dens = np.asarray(p["density"][1], np.float32
                              ).reshape(nz, ny, nx)
            p0 = self._xf_point(p.point("p0", (0, 0, 0)))
            p1 = self._xf_point(p.point("p1", (1, 1, 1)))
            med = media_mod.make_grid(sa, ss, dens,
                                      np.minimum(p0, p1),
                                      np.maximum(p0, p1), g, C)
        else:
            med = media_mod.make_homogeneous(sa, ss, g, C)
        self.named_media[name] = self.builder.add_medium(med)

    def _d_MediumInterface(self, tokens, peeked, nxt):
        """MediumInterface "inside" ["outside"] (api.cpp
        pbrtMediumInterface); before WorldBegin it sets the camera medium
        (graphicsState.currentInsideMedium → camera)."""
        inside = nxt().strip('"')
        outside = ""
        t = nxt()
        if t is not None and t.startswith('"'):
            outside = t.strip('"')
        elif t is not None:
            peeked.append(t)
        mi = self.named_media.get(inside, -1)
        mo = self.named_media.get(outside, -1)
        if not self.world:
            self.builder.camera_med = mi
        else:
            self.gs.medium_in = mi
            self.gs.medium_out = mo

    def _d_Material(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = parse_params(tokens, peeked)
        self.gs.material_id = self._make_material(name, p)

    def _d_MakeNamedMaterial(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = parse_params(tokens, peeked)
        mtype = p.one("type", "matte")
        self.gs.named_materials[name] = self._make_material(mtype, p)

    def _d_NamedMaterial(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        self.gs.material_id = self.gs.named_materials.get(name, 0)

    def _d_LightSource(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = parse_params(tokens, peeked)
        b = self.builder
        scale = p.spectrum_rgb("scale", (1.0, 1.0, 1.0))
        if name == "point":
            b.add_light(type="point", I=p.spectrum_rgb("I", (1, 1, 1)),
                        scale=scale,
                        pos=self._xf_point(p.point("from", (0, 0, 0))))
        elif name == "spot":
            frm = p.point("from", (0, 0, 0))
            to = p.point("to", (0, 0, 1))
            d = np.asarray(self._xf_point(to)) - np.asarray(
                self._xf_point(frm))
            b.add_light(type="spot", I=p.spectrum_rgb("I", (1, 1, 1)),
                        scale=scale, pos=self._xf_point(frm), dir=tuple(d),
                        cone_angle=p.one("coneangle", 30.0),
                        cone_delta=p.one("conedeltaangle", 5.0))
        elif name == "distant":
            frm = np.asarray(p.point("from", (0, 0, 0)))
            to = np.asarray(p.point("to", (0, 0, 1)))
            d = np.asarray(self._xf_vec(to - frm))
            b.add_light(type="distant", L=p.spectrum_rgb("L", (1, 1, 1)),
                        scale=scale, dir=tuple(d))
        elif name in ("goniometric", "projection"):
            m = None
            if p.one("mapname"):
                from pbrt_tpu.utils import imageio
                try:
                    m = imageio.read_image(
                        os.path.join(self.base_dir, p.one("mapname")))
                except Exception:
                    m = None
            kwl = dict(type=name, I=p.spectrum_rgb("I", (1, 1, 1)),
                       scale=scale, pos=self._xf_point((0, 0, 0)),
                       dir=self._xf_vec((0, 0, 1)))
            if m is not None:
                kwl["map"] = m
            if name == "projection":
                kwl["fov"] = p.one("fov", 45.0)
            b.add_light(**kwl)
        elif name in ("infinite", "exinfinite"):
            env = None
            mapname = p.one("mapname")
            if mapname:
                from pbrt_tpu.utils import imageio
                env = imageio.read_image(
                    os.path.join(self.base_dir, mapname))
            b.add_light(type="infinite", L=p.spectrum_rgb("L", (1, 1, 1)),
                        scale=scale,
                        env_map=env if env is not None
                        else np.ones((1, 1, 3), np.float32))

    def _d_AreaLightSource(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        p = parse_params(tokens, peeked)
        self.gs.area_light = {"kind": name, "params": p}

    def _d_Shape(self, tokens, peeked, nxt):
        name = nxt().strip('"')
        params = parse_params(tokens, peeked)
        if self.recording is not None:
            self.object_defs[self.recording].append(dict(
                name=name, params=params, ctm=self.ctm.copy(),
                gs=copy.deepcopy(self.gs)))
            return
        self._emit_shape(name, params, self.gs)

    # -- construction helpers ---------------------------------------------

    _TEXMAP = {"constant": 0, "scale": 1, "mix": 2, "checkerboard": 3,
               "uv": 4, "dots": 5, "bilerp": 6, "imagemap": 7, "fbm": 8,
               "wrinkled": 9, "windy": 10, "marble": 11}

    def _build_texture(self, name: str) -> int:
        """Instantiate a named texture (Texture directive) into the
        builder's texture table; returns row id (−1 unknown)."""
        if not hasattr(self, "_tex_ids"):
            self._tex_ids = {}
        if name in self._tex_ids:
            return self._tex_ids[name]
        if name not in self.gs.textures:
            return -1
        klass, p = self.gs.textures[name]
        ttype = self._TEXMAP.get(klass, 0)
        kw = dict(type=ttype)
        # protect against self-reference cycles during operand recursion
        self._tex_ids[name] = -1
        for pname, slot, op_slot in (("tex1", "v1", "op1"),
                                     ("tex2", "v2", "op2"),
                                     ("value", "v1", "op1")):
            if pname in p and p[pname][0] == "texture":
                # texture OPERAND (scale.cpp:44-48 GetSpectrumTexture):
                # recursively instantiate the named texture as a row ref
                kw[op_slot] = self._build_texture(p.one(pname))
                continue
            v = p.spectrum_rgb(pname)
            if v is not None:
                kw[slot] = v
        for pname in ("uscale", "vscale", "udelta", "vdelta", "octaves",
                      "omega", "variation"):
            if p.one(pname) is not None:
                kw[pname] = p.one(pname)
        # marble/noise param names (marble.cpp): roughness→omega,
        # scale→3D noise frequency
        if p.one("roughness") is not None:
            kw["omega"] = p.one("roughness")
        if p.one("scale") is not None and klass in ("marble", "fbm",
                                                    "wrinkled", "windy"):
            kw["scale3d"] = p.one("scale")
        if "amount" in p:
            if p["amount"][0] == "texture":
                kw["op3"] = self._build_texture(p.one("amount"))
            else:
                kw["omega"] = p.one("amount")  # amount rides in omega
        if klass == "imagemap" and p.one("filename"):
            from pbrt_tpu.utils import imageio
            try:
                img = imageio.read_image(
                    os.path.join(self.base_dir, p.one("filename")))
                kw["img"] = self.builder.add_image(img)
                # pbrt's imagemap defaults to EWA ("bool trilinear" false,
                # textures/imagemap.cpp); the builder API defaults to
                # trilinear for throughput, so the parser opts in here
                if not p.one("trilinear"):
                    self.builder.tex_filtering = "ewa"
            except Exception:
                kw["type"] = 0
                kw["v1"] = (0.5, 0.5, 0.5)
        tid = self.builder.add_texture(**kw)
        self._tex_ids[name] = tid
        return tid

    def _make_material(self, name: str, p: Params) -> int:
        b = self.builder
        if name == "mix":
            # materials/mixmat.cpp: blend two named materials by `amount`.
            # Resolved at build time: same-type pairs blend exactly
            # parameter-wise (linear in Kd/Ks/...); mixed-type pairs fall
            # back to the dominant material with amount-scaled albedo.
            m1 = self.gs.named_materials.get(p.one("namedmaterial1", ""), 0)
            m2 = self.gs.named_materials.get(p.one("namedmaterial2", ""), 0)
            amt = p.spectrum_rgb("amount", (0.5, 0.5, 0.5))
            amt_s = float(np.mean(amt))
            r1 = dict(b.materials[m1])
            r2 = dict(b.materials[m2])
            if r1.get("type", 0) == r2.get("type", 0):
                out = dict(r1)
                for key in set(r1) | set(r2):
                    v1 = np.asarray(r1.get(key, 0.0), np.float64)
                    v2 = np.asarray(r2.get(key, 0.0), np.float64)
                    if key in ("type", "kd_tex", "sigma_tex", "bump_tex"):
                        continue
                    out[key] = amt_s * v1 + (1 - amt_s) * v2
                return b.add_material(**out)
            dom = r1 if amt_s >= 0.5 else r2
            scale = max(amt_s, 1 - amt_s)
            out = dict(dom)
            if "kd" in out:
                out["kd"] = np.asarray(out["kd"], np.float64) * scale
            return b.add_material(**out)
        tmap = {"matte": mat_mod.MATTE, "mirror": mat_mod.MIRROR,
                "glass": mat_mod.GLASS, "plastic": mat_mod.PLASTIC,
                "metal": mat_mod.METAL,
                "dispersive_glass": mat_mod.DISPERSIVE_GLASS,
                "uber": mat_mod.UBER, "substrate": mat_mod.SUBSTRATE,
                "translucent": mat_mod.TRANSLUCENT,
                "disney": mat_mod.DISNEY,
                "subsurface": mat_mod.SUBSURFACE,
                "kdsubsurface": mat_mod.SUBSURFACE,
                "hair": mat_mod.HAIR, "fourier": mat_mod.FOURIER,
                "none": mat_mod.NONE, "": mat_mod.NONE}
        mtype = tmap.get(name, mat_mod.MATTE)
        kw = dict(type=mtype)
        if "Kd" in p and p["Kd"][0] == "texture":
            kw["kd_tex"] = self._build_texture(p["Kd"][1][0])
        elif p.spectrum_rgb("Kd") is not None:
            kw["kd"] = p.spectrum_rgb("Kd")
        if p.spectrum_rgb("Ks") is not None:
            kw["ks"] = p.spectrum_rgb("Ks")
        if p.spectrum_rgb("Kr") is not None:
            kw["kr"] = p.spectrum_rgb("Kr")
        if p.spectrum_rgb("Kt") is not None:
            kw["kt"] = p.spectrum_rgb("Kt")
        if p.one("sigma") is not None:
            kw["sigma"] = p.one("sigma")
        if p.one("roughness") is not None:
            kw["roughness"] = p.one("roughness")
        elif name == "metal":
            kw["roughness"] = 0.01   # metal.cpp default
        elif name in ("plastic", "substrate", "uber", "disney"):
            kw["roughness"] = 0.1
        # NDF selection (core/microfacet.h:48-105); pbrt's stock materials
        # hard-code TR, so "string distribution" is an extension exposing
        # the Beckmann core component to the scene language
        if str(p.one("distribution") or p.one("microfacetdistribution")
               or "").lower() == "beckmann":
            from pbrt_tpu.scene.materials import NDF_BECKMANN
            kw["ndf"] = NDF_BECKMANN
        if p.one("index") is not None:
            kw["eta"] = p.one("index")
        if p.one("eta") is not None and name == "glass":
            kw["eta"] = p.one("eta")
        if name == "metal":
            if p.spectrum_rgb("eta") is not None:
                kw["metal_eta"] = p.spectrum_rgb("eta")
            if p.spectrum_rgb("k") is not None:
                kw["metal_k"] = p.spectrum_rgb("k")
        if name == "subsurface":
            # materials/subsurface.cpp CreateSubsurfaceMaterial defaults
            # (skin-ish); "sigma_s" is the param name (:120-121)
            scale_p = p.one("scale", 1.0)
            sa = p.spectrum_rgb("sigma_a", (0.0011, 0.0024, 0.014))
            ss = p.spectrum_rgb("sigma_s",
                                p.spectrum_rgb("sigma_prime_s",
                                               (2.55, 3.21, 3.77)))
            kw["sss_sigma_a"] = tuple(np.asarray(sa) * scale_p)
            kw["sss_sigma_s"] = tuple(np.asarray(ss) * scale_p)
            kw["sss_g"] = p.one("g", 0.0)
            kw["eta"] = p.one("eta", 1.33)
        if name == "kdsubsurface":
            # materials/kdsubsurface.cpp: diffuse color + mean free path,
            # inverted through the beam-diffusion table
            # (SubsurfaceFromDiffuse, core/bssrdf.cpp:174-184)
            from pbrt_tpu.scene import bssrdf as bssrdf_mod
            kd_v = np.asarray(p.spectrum_rgb("Kd", (0.5, 0.5, 0.5)))
            # "mfp" is a SPECTRUM texture param (kdsubsurface.cpp:104-105)
            # — pbrt silently ignores a "float mfp"; accept both here but
            # warn on the float form since the reference drops it
            if "mfp" in p and p["mfp"][0] == "float":
                import sys as _sys
                print("pbrt_tpu: warning: \"float mfp\" is honored "
                      "here, but pbrt IGNORES it (mfp is a spectrum "
                      "texture param) — use \"rgb mfp\" for parity",
                      file=_sys.stderr)
            mfp = np.asarray(p.spectrum_rgb("mfp", p.one("mfp", 1.0))) \
                * p.one("scale", 1.0)
            g_p = p.one("g", 0.0)
            eta_p = p.one("eta", 1.33)
            sa, ss = bssrdf_mod.subsurface_from_diffuse(
                np.clip(kd_v, 0.0, 1.0), mfp, g_p, eta_p)
            kw["sss_sigma_a"] = tuple(sa)
            kw["sss_sigma_s"] = tuple(ss)
            kw["sss_g"] = g_p
            kw["eta"] = eta_p
        if name == "disney":
            if p.spectrum_rgb("color") is not None:
                kw["kd"] = p.spectrum_rgb("color")
            for pn, slot in (("metallic", "metallic"),
                             ("speculartint", "spec_tint"),
                             ("sheen", "sheen"),
                             ("sheentint", "sheen_tint"),
                             ("clearcoat", "clearcoat"),
                             ("clearcoatgloss", "clearcoat_gloss"),
                             ("eta", "eta"),
                             ("anisotropic", "anisotropic"),
                             ("spectrans", "spec_trans"),
                             ("difftrans", "diff_trans"),
                             ("flatness", "flatness")):
                if p.one(pn) is not None:
                    kw[slot] = p.one(pn)
            if p.one("thin"):
                kw["thin"] = 1.0
            sd = p.spectrum_rgb("scatterdistance")
            if sd is not None and float(np.max(np.asarray(sd))) > 0:
                # disney.cpp:519-527 swaps the diffuse lobe for a
                # DisneyBSSRDF when scatterdistance is non-black and the
                # surface is not thin (the thin branch at :506-517 wins
                # and pbrt ignores scatterdistance there)
                if not kw.get("thin"):
                    kw["scatter_d"] = tuple(np.asarray(sd, np.float64))
        if name == "hair":
            # materials/hair.cpp CreateHairMaterial: absorption from
            # sigma_a | color | eumelanin/pheomelanin, in that priority
            from pbrt_tpu.scene import hair as hair_mod
            bn = p.one("beta_n", 0.3)
            if p.spectrum_rgb("sigma_a") is not None:
                sa = np.asarray(p.spectrum_rgb("sigma_a"))
            elif p.spectrum_rgb("color") is not None:
                sa = np.asarray(hair_mod.sigma_a_from_reflectance(
                    np.asarray(p.spectrum_rgb("color"), np.float32), bn))
            elif p.one("eumelanin") is not None \
                    or p.one("pheomelanin") is not None:
                sa = np.asarray(hair_mod.sigma_a_from_concentration(
                    p.one("eumelanin", 1.3), p.one("pheomelanin", 0.0)))
            else:
                sa = np.asarray(hair_mod.sigma_a_from_concentration(1.3, 0.0))
            kw["sss_sigma_a"] = tuple(np.asarray(sa, np.float64))
            kw["beta_m"] = p.one("beta_m", 0.3)
            kw["beta_n"] = bn
            kw["hair_alpha"] = p.one("alpha", 2.0)
            kw["eta"] = p.one("eta", 1.55)
        if name == "fourier":
            fn = p.one("bsdffile", "")
            import os as _os
            kw["fourier_id"] = b.add_fourier_table(
                fn if _os.path.isabs(fn)
                else _os.path.join(self.base_dir, fn))
        if name == "dispersive_glass":
            # Cauchy from (etaMin, etaMax) endpoints
            # (materials/dispersive_glass.cpp:62-64)
            eta_min = p.one("etaMin", 1.5)
            eta_max = p.one("etaMax", 1.6)
            l_min = spec_mod.LAMBDA_START * 1e-3
            l_max = spec_mod.LAMBDA_END * 1e-3
            cc = (eta_max - eta_min) / (1.0 / (l_min * l_min)
                                        - 1.0 / (l_max * l_max))
            bb = eta_min - cc / (l_max * l_max)
            kw["cauchy_b"] = bb
            kw["cauchy_c"] = cc
            kw["eta"] = bb + cc / (0.55 * 0.55)
        return b.add_material(**kw)

    def _emit_light_for_shape(self, gs, n_prims_before):
        """Bind an AreaLightSource to the prims just added."""
        al = gs.area_light
        if al is None:
            return -1
        p = al["params"]
        kw = dict(type="area",
                  L=p.spectrum_rgb("L", (1, 1, 1)),
                  scale=p.spectrum_rgb("scale", (1, 1, 1)),
                  two_sided=(p.one("twosided", "false") in (True, "true")),
                  prim=-1)
        if al["kind"] == "portal":
            kw["strategy"] = p.one("strategy", "light")
            pd = p.one("portalData", "")
            kw["portals"] = parse_portal_data(pd) if pd else []
        return self.builder.add_light(**kw)

    def _emit_shape(self, name, p: Params, gs: GraphicsState):
        b = self.builder
        marks = (len(b.tris), len(b.spheres), len(b.planes), len(b.disks))
        self._emit_shape_inner(name, p, gs)
        # stamp the attribute stack's MediumInterface onto every primitive
        # row this shape added (GeometricPrimitive's mediumInterface)
        if gs.medium_in != -1 or gs.medium_out != -1:
            for rows, m in zip((b.tris, b.spheres, b.planes, b.disks),
                               marks):
                for r in rows[m:]:
                    r["med_in"] = gs.medium_in
                    r["med_out"] = gs.medium_out

    def _emit_shape_inner(self, name, p: Params, gs: GraphicsState):
        b = self.builder
        mat = gs.material_id
        if name == "trianglemesh":
            idx = np.asarray(p["indices"][1], np.int32).reshape(-1, 3)
            pts = np.asarray(p["P"][1], np.float64).reshape(-1, 3)
            pts_w = np.stack([self._xf_point(q) for q in pts])
            # animated shape transform → shutter-end vertex positions
            # (TransformedPrimitive + AnimatedTransform, api.cpp:1414)
            pts_w_end = None
            if self.animated:
                pts_w_end = np.stack([self._xf_point2(q) for q in pts])
            normals = None
            if "N" in p:
                ns = np.asarray(p["N"][1], np.float64).reshape(-1, 3)
                normals = np.stack([self._xf_normal(q) for q in ns])
            uvs = None
            for uk in ("st", "uv"):
                if uk in p:
                    uvs = np.asarray(p[uk][1], np.float64).reshape(-1, 2)
            light = -1
            if gs.area_light is not None:
                # one light row per triangle (pbrt: one DiffuseAreaLight
                # per Triangle shape)
                for f in idx:
                    li = self._emit_light_for_shape(gs, 0)
                    tid = b.add_triangle(
                        pts_w[f[0]], pts_w[f[1]], pts_w[f[2]], mat, li,
                        n0=None if normals is None else normals[f[0]],
                        n1=None if normals is None else normals[f[1]],
                        n2=None if normals is None else normals[f[2]],
                        uv0=(0, 0) if uvs is None else tuple(uvs[f[0]]),
                        uv1=(1, 0) if uvs is None else tuple(uvs[f[1]]),
                        uv2=(1, 1) if uvs is None else tuple(uvs[f[2]]))
                    b.light_rows[li]["prim"] = ("tri", tid)
            else:
                b.add_mesh(pts_w, idx, mat=mat, light=-1, normals=normals,
                           uvs=uvs, vertices_end=pts_w_end)
        elif name in ("cylinder", "cone", "paraboloid", "hyperboloid",
                      "heightfield", "nurbs", "curve"):
            from pbrt_tpu.scene import tessellate as tess
            import math
            phimax = math.radians(p.one("phimax", 360.0))
            if name == "cylinder":
                v, fidx, nrm = tess.tessellate_cylinder(
                    p.one("radius", 1.0), p.one("zmin", -1.0),
                    p.one("zmax", 1.0), phimax)
            elif name == "cone":
                v, fidx, nrm = tess.tessellate_cone(
                    p.one("radius", 1.0), p.one("height", 1.0), phimax)
            elif name == "paraboloid":
                v, fidx, nrm = tess.tessellate_paraboloid(
                    p.one("radius", 1.0), p.one("zmin", 0.0),
                    p.one("zmax", 1.0), phimax)
            elif name == "hyperboloid":
                v, fidx, nrm = tess.tessellate_hyperboloid(
                    p.point("p1", (1, 0, 0)), p.point("p2", (1, 0, 1)),
                    phimax)
            elif name == "heightfield":
                v, fidx, nrm = tess.tessellate_heightfield(
                    p.one("nu", 2), p.one("nv", 2),
                    np.asarray(p["Pz"][1], np.float32))
            elif name == "nurbs":
                v, fidx, nrm = tess.tessellate_nurbs(
                    p.one("nu"), p.one("uorder"),
                    np.asarray(p["uknots"][1]), p.one("nv"),
                    p.one("vorder"), np.asarray(p["vknots"][1]),
                    np.asarray(p["P"][1], np.float64).reshape(-1, 3)
                    if "P" in p else
                    np.asarray(p["Pw"][1], np.float64).reshape(-1, 4))
            else:  # curve
                cp = np.asarray(p["P"][1], np.float64).reshape(-1, 3)
                w0 = p.one("width0", p.one("width", 1.0))
                w1 = p.one("width1", p.one("width", 1.0))
                ctype = str(p.one("type") or "flat").strip('"')
                # analytic Bézier intersection (curve.cpp) for all three
                # curve types — control points to world space; width
                # scaled by the CTM's mean linear scale; ribbons carry
                # their u=0/1 orientation normals ("normal N") through
                # the inverse-transpose (curve.cpp:44-58)
                cp_w = np.stack([self._xf_point(q) for q in cp[:4]])
                sc = float(np.mean([np.linalg.norm(self.ctm[:3, k])
                                    for k in range(3)]))
                n0 = n1 = None
                if ctype == "ribbon" and "N" in p:
                    ns = np.asarray(p["N"][1], np.float64).reshape(-1, 3)
                    n0 = self._xf_normal(ns[0])
                    n0 = n0 / max(np.linalg.norm(n0), 1e-12)
                    n1 = self._xf_normal(ns[-1])
                    n1 = n1 / max(np.linalg.norm(n1), 1e-12)
                b.add_curve(cp_w, w0 * sc, w1 * sc, mat=mat, n0=n0, n1=n1)
                return
            pts_w = np.stack([self._xf_point(q) for q in v])
            normals = (np.stack([self._xf_normal(q) for q in nrm])
                       if nrm is not None else None)
            b.add_mesh(pts_w, fidx, mat=mat, normals=normals)
        elif name == "loopsubdiv":
            from pbrt_tpu.frontend.loopsubdiv import loop_subdivide
            idx = np.asarray(p["indices"][1], np.int32).reshape(-1, 3)
            pts = np.asarray(p["P"][1], np.float64).reshape(-1, 3)
            sv, sf = loop_subdivide(pts, idx, p.one("nlevels", 3))
            pts_w = np.stack([self._xf_point(q) for q in sv])
            b.add_mesh(pts_w, sf, mat=mat)
        elif name == "plymesh":
            from pbrt_tpu.frontend.ply import read_ply
            mesh = read_ply(os.path.join(self.base_dir,
                                         p.one("filename")))
            pts_w = np.stack([self._xf_point(q)
                              for q in mesh["vertices"]])
            normals = None
            if "normals" in mesh:
                normals = np.stack([self._xf_normal(q)
                                    for q in mesh["normals"]])
            b.add_mesh(pts_w, mesh["indices"], mat=mat,
                       normals=normals, uvs=mesh.get("uvs"))
        elif name == "sphere":
            r = p.one("radius", 1.0)
            c = self._xf_point((0, 0, 0))
            # uniform scale assumed for spheres (world-space repr)
            s = np.cbrt(abs(np.linalg.det(self.ctm[:3, :3])))
            sid = b.add_sphere(c, r * s, mat=mat)
            if gs.area_light is not None:
                li = self._emit_light_for_shape(gs, 0)
                b.spheres[sid]["light"] = li
                b.light_rows[li]["prim"] = ("sph", sid)
        elif name == "disk":
            r = p.one("radius", 1.0)
            h = p.one("height", 0.0)
            c = self._xf_point((0, 0, h))
            n = np.asarray(self._xf_normal((0, 0, 1)))
            n = n / max(np.linalg.norm(n), 1e-12)
            did = b.add_disk(c, tuple(n), r, p.one("innerradius", 0.0),
                             mat=mat)
            if gs.area_light is not None:
                li = self._emit_light_for_shape(gs, 0)
                b.disks[did]["light"] = li
                b.light_rows[li]["prim"] = ("dsk", did)
        elif name == "aaplane":
            lo = p.point("lo", (0, 0, 0))
            hi = p.point("hi", (0, 0, 0))
            ax = p.one("axis", 2)
            facing = p.one("facingFw", "true") in (True, "true")
            lo_w = self._xf_point(lo)
            hi_w = self._xf_point(hi)
            pid = b.add_aaplane(tuple(np.minimum(lo_w, hi_w)),
                                tuple(np.maximum(lo_w, hi_w)), ax,
                                facing_fw=facing, mat=mat)
            if gs.area_light is not None:
                li = self._emit_light_for_shape(gs, 0)
                b.planes[pid]["light"] = li
                b.light_rows[li]["prim"] = ("pln", pid)
        # unknown shapes: ignored with a note (curve/nurbs/etc → later)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def parse_pbrt_string(text: str, base_dir=".", spectrum_cfg=spec_mod.RGB):
    """Parse scene text → (scene, camera, options dict)."""
    ps = PbrtParser(spectrum_cfg, base_dir)
    ps.parse(text)
    # camera pixel spread drives imagemap mip LOD (MIPMap width from ray
    # differentials, core/camera.cpp GenerateRayDifferential's 1px offset)
    cam_name, cam_p = ps.options["camera"]
    yres = max(1, int(ps.options["film"]["yres"]))
    tex_spread = 0.0
    if cam_name == "perspective":
        tex_spread = float(2.0 * np.tan(np.radians(
            cam_p.one("fov", 90.0)) / 2.0) / yres)
    scene = ps.builder.build(tex_spread=tex_spread)
    # Accelerator "kdtree": swap the aggregate (api.cpp:788-801)
    if (ps.options.get("accelerator") == "kdtree" and scene.n_tri > 256):
        import dataclasses as _dc

        from pbrt_tpu.scene import kdtree as _kd
        scene = _dc.replace(scene, bvh=_kd.build_kdtree(scene))

    from pbrt_tpu.scene import camera as cam_mod
    name, cp = ps.options["camera"]
    c2w_np = np.asarray(ps.options["camera_to_world"], np.float64)
    # pbrt camera space is left-handed (+z forward); our look_at builds the
    # same convention, so use the matrix directly
    import jax.numpy as jnp
    c2w = tr.Transform(jnp.asarray(c2w_np, jnp.float32),
                       jnp.asarray(np.linalg.inv(c2w_np), jnp.float32))
    res = (ps.options["film"]["xres"], ps.options["film"]["yres"])
    shutter = (cp.one("shutteropen", 0.0), cp.one("shutterclose", 1.0))
    if name == "perspective":
        cam = cam_mod.make_perspective(
            c2w, cp.one("fov", 90.0), res,
            lens_radius=cp.one("lensradius", 0.0),
            focal_distance=cp.one("focaldistance", 1e6),
            shutter_open=shutter[0], shutter_close=shutter[1])
    elif name == "orthographic":
        cam = cam_mod.make_orthographic(c2w, res)
    else:
        cam = cam_mod.make_environment(c2w, res)
    # animated camera (api.cpp:814): differing start/end CTMs → per-ray
    # interpolated camera-to-world over [TransformTimes t0, t1]
    c2w_end = np.asarray(ps.options.get("camera_to_world_end", c2w_np),
                         np.float64)
    if not np.allclose(c2w_np, c2w_end):
        import dataclasses as _dc
        tt = ps.options.get("transform_times", (0.0, 1.0))
        c2w_end_t = tr.Transform(jnp.asarray(c2w_end, jnp.float32),
                                 jnp.asarray(np.linalg.inv(c2w_end),
                                             jnp.float32))
        cam = _dc.replace(cam, anim=tr.make_animated(
            c2w, c2w_end_t, t_start=tt[0], t_end=tt[1]))

    imap = {"path": "path", "directlighting": "direct", "whitted": "whitted",
            "ambientocclusion": "ao", "mypath": "mypath",
            "hero_path": "hero_path", "hero_path_mis": "hero_path_mis",
            "volpath": "volpath", "bdpt": "bdpt", "mlt": "mlt",
            "sppm": "sppm", "hero": "hero_path"}
    opts = dict(ps.options)
    opts["integrator"] = imap.get(ps.options["integrator"], "path")
    opts["max_depth"] = ps.options["integrator_params"].one("maxdepth", 5)
    return scene, cam, opts


def load_pbrt(path: str, spectrum_cfg=spec_mod.RGB):
    with open(path) as f:
        text = f.read()
    return parse_pbrt_string(text, base_dir=os.path.dirname(path) or ".",
                             spectrum_cfg=spectrum_cfg)
