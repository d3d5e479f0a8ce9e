"""Scene-description reformatting: the CLI's --cat / --toply modes.

JAX counterpart of the reference's scene-dump paths
(main/pbrt.cpp:66-73 flags; printing hooks throughout core/api.cpp:915-985
and the trianglemesh→PLY conversion of api.cpp:469-520): `cat` re-emits
every directive normalized (one per line, 4-space indent inside
Attribute/Transform/Object blocks, Includes inlined); `toply` additionally
rewrites trianglemeshes with ≥500 index entries as sidecar .ply files
referenced by `Shape "plymesh"`.

Cold-path, host-only text processing — no device code.
"""

from __future__ import annotations

import os
import re

from pbrt_tpu.frontend.parser import tokenize

_BARE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_PARAM_DECL = re.compile(r'^"([a-z][a-z0-9]*)\s+(\S+)"$')

_INDENT_OPEN = {"AttributeBegin", "TransformBegin", "ObjectBegin"}
_INDENT_CLOSE = {"AttributeEnd", "TransformEnd", "ObjectEnd"}


def _fmt_val(v: str) -> str:
    if v.startswith('"'):
        return v
    try:
        f = float(v.rstrip(","))
        return f"{f:.9g}"
    except ValueError:
        return v


def _tokens_with_includes(path: str):
    base = os.path.dirname(path) or "."
    with open(path) as f:
        toks = list(tokenize(f.read()))
    i = 0
    while i < len(toks):
        t = toks[i]
        if t == "Include":
            sub = os.path.join(base, toks[i + 1].strip('"'))
            yield from _tokens_with_includes(sub)
            i += 2
            continue
        yield t
        i += 1


def _group_directives(tok_iter):
    """Group the token stream into (directive, [arg tokens]) — a bare
    identifier starts a directive; everything else (quoted strings,
    numbers, brackets) belongs to the previous one."""
    cur = None
    args = []
    for t in tok_iter:
        if _BARE.match(t) and t not in ("true", "false"):
            if cur is not None:
                yield cur, args
            cur, args = t, []
        else:
            args.append(t)
    if cur is not None:
        yield cur, args


def _split_params(args):
    """Split a directive's arg tokens into (positional, [(type, name,
    values)]) — parameters start at the first '"type name"' declaration."""
    pos = []
    i = 0
    while i < len(args) and not _PARAM_DECL.match(args[i]):
        pos.append(args[i])
        i += 1
    params = []
    while i < len(args):
        m = _PARAM_DECL.match(args[i])
        if not m:          # stray token; keep as positional to not lose it
            pos.append(args[i])
            i += 1
            continue
        ptype, name = m.groups()
        i += 1
        vals = []
        if i < len(args) and args[i] == "[":
            i += 1
            while i < len(args) and args[i] != "]":
                vals.append(args[i])
                i += 1
            i += 1         # skip ']'
        elif i < len(args):
            vals.append(args[i])
            i += 1
        params.append((ptype, name, vals))
    return pos, params


def _emit(directive, pos, params, indent):
    parts = [directive] + [_fmt_val(p) for p in pos]
    line = " " * indent + " ".join(parts)
    out = [line]
    for ptype, name, vals in params:
        v = " ".join(_fmt_val(x) for x in vals)
        out.append(" " * (indent + 4) + f'"{ptype} {name}" [ {v} ]')
    return "\n".join(out)


def _write_ply(fn, params):
    """ASCII PLY from trianglemesh params (api.cpp:469-520 role)."""
    def grab(*names):
        for ptype, name, vals in params:
            if name in names:
                return [float(v.rstrip(",")) for v in vals]
        return None

    P = grab("P")
    N = grab("N")
    uv = grab("uv", "st")
    idx = [int(float(v.rstrip(","))) for v in next(
        vals for ptype, name, vals in params if name == "indices")]
    nv = len(P) // 3
    nf = len(idx) // 3
    with open(fn, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {nv}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if N:
            f.write("property float nx\nproperty float ny\n"
                    "property float nz\n")
        if uv:
            f.write("property float u\nproperty float v\n")
        f.write(f"element face {nf}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i in range(nv):
            row = P[3 * i:3 * i + 3]
            if N:
                row += N[3 * i:3 * i + 3]
            if uv:
                row += uv[2 * i:2 * i + 2]
            f.write(" ".join(f"{x:.9g}" for x in row) + "\n")
        for i in range(nf):
            f.write(f"3 {idx[3 * i]} {idx[3 * i + 1]} {idx[3 * i + 2]}\n")


def reformat(path: str, to_ply: bool = False, ply_prefix: str = None,
             out=None):
    """Print the normalized scene description (pbrt --cat / --toply)."""
    import sys
    out = out or sys.stdout
    if ply_prefix is None:
        ply_prefix = os.environ.get("PLY_PREFIX", "mesh")
    count = [1]
    indent = 0
    for directive, args in _group_directives(_tokens_with_includes(path)):
        if directive in _INDENT_CLOSE:
            indent = max(0, indent - 4)
        pos, params = _split_params(args)
        if (to_ply and directive == "Shape" and pos
                and pos[0] == '"trianglemesh"'):
            n_idx = next((len(v) for t, n, v in params if n == "indices"),
                         0)
            if n_idx >= 500:
                fn = f"{ply_prefix}_{count[0]:05d}.ply"
                count[0] += 1
                _write_ply(fn, params)
                keep = [(t, n, v) for t, n, v in params
                        if n not in ("P", "N", "uv", "st", "indices",
                                     "faceIndices")]
                keep.insert(0, ("string", "filename", [f'"{fn}"']))
                print(_emit("Shape", ['"plymesh"'], keep, indent),
                      file=out)
                continue
        print(_emit(directive, pos, params, indent), file=out)
        if directive in _INDENT_OPEN:
            indent += 4
