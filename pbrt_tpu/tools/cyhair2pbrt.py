"""cyhair2pbrt: Cem Yuksel .hair binaries → pbrt curve shapes.

The framework's counterpart of ``src/tools/cyhair2pbrt.cpp``
(489 LoC): reads the CyHair format (128-byte header: "HAIR" magic,
numStrands/totalPoints/flags u32, default segments/thickness/alpha/color)
and emits cubic-Bézier ``Shape "curve"`` records, converting each strand's
polyline to Bézier segments with Catmull–Rom tangents (the same
interpolation cyhair2pbrt.cpp applies).

Usage: ``python -m pbrt_tpu.tools.cyhair2pbrt hair.hair > hair.pbrt``
"""

from __future__ import annotations

import struct
import sys

import numpy as np

_HAS_SEGMENTS = 1
_HAS_POINTS = 2
_HAS_THICKNESS = 4
_HAS_TRANSPARENCY = 8
_HAS_COLOR = 16


def read_cyhair(path):
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"HAIR":
            raise ValueError(f"{path}: not a CyHair file")
        n_strands, n_points, flags, d_segments = struct.unpack(
            "<IIII", f.read(16))
        d_thickness, d_alpha = struct.unpack("<ff", f.read(8))
        d_color = struct.unpack("<fff", f.read(12))
        f.read(88)  # info string
        if flags & _HAS_SEGMENTS:
            segments = np.frombuffer(f.read(2 * n_strands), "<u2"
                                     ).astype(np.int64)
        else:
            segments = np.full(n_strands, d_segments, np.int64)
        if not flags & _HAS_POINTS:
            raise ValueError("CyHair file without points")
        points = np.frombuffer(f.read(12 * n_points), "<f4"
                               ).reshape(n_points, 3)
        thickness = None
        if flags & _HAS_THICKNESS:
            thickness = np.frombuffer(f.read(4 * n_points), "<f4")
    return segments, points, thickness, d_thickness


def _catmull_rom_to_bezier(p0, p1, p2, p3):
    """One Bézier segment covering [p1, p2] with CR tangents."""
    return (p1, p1 + (p2 - p0) / 6.0, p2 - (p3 - p1) / 6.0, p2)


def convert(path, out=sys.stdout, radius_scale=1.0):
    segments, points, thickness, d_thick = read_cyhair(path)
    w = out.write
    w("# converted by pbrt_tpu cyhair2pbrt\n")
    off = 0
    for s in segments:
        n = int(s) + 1          # points in this strand
        strand = points[off:off + n]
        th = (thickness[off:off + n] if thickness is not None
              else np.full(n, d_thick, np.float32))
        for k in range(n - 1):
            p0 = strand[max(k - 1, 0)]
            p1 = strand[k]
            p2 = strand[k + 1]
            p3 = strand[min(k + 2, n - 1)]
            b = _catmull_rom_to_bezier(p0, p1, p2, p3)
            w('Shape "curve" "string type" "cylinder" "point P" [')
            w(" ".join("%g %g %g" % tuple(q) for q in b))
            w('] "float width0" [%g] "float width1" [%g]\n'
              % (2 * th[k] * radius_scale, 2 * th[k + 1] * radius_scale))
        off += n
    return 0


def main(argv=None):
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: cyhair2pbrt hair.hair [out.pbrt]", file=sys.stderr)
        return 1
    out = open(args[1], "w") if len(args) > 1 else sys.stdout
    convert(args[0], out)
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
