"""Whitespace-separated float-file reader.

JAX counterpart of ``core/floatfile.{h,cpp}`` (ReadFloatFile):
parses files of whitespace-separated numbers with ``#`` comments — the
on-disk SPD format (``"spectrum Kd" "metal-Cu.spd"`` parameters, pairs of
(wavelength_nm, value) rows).
"""

from __future__ import annotations


def read_float_file(path: str) -> list:
    vals = []
    with open(path) as f:
        for line in f:
            hashpos = line.find("#")
            if hashpos >= 0:
                line = line[:hashpos]
            for tok in line.split():
                vals.append(float(tok))
    return vals
