"""Image I/O: EXR, PNG, PFM, TGA — stdlib-only implementations.

JAX counterpart of ``core/imageio.{h,cpp}`` (ReadImage/WriteImage
dispatch by extension, imageio.cpp:60-75) without the OpenEXR/lodepng
dependencies: a minimal OpenEXR v2 scanline codec (NONE + ZIP), a PNG
codec over zlib, and PFM/TGA codecs.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def write_image(path: str, img: np.ndarray):
    """img: (H,W,3) float32 linear RGB. Dispatch by extension
    (imageio.cpp WriteImage)."""
    img = np.asarray(img, np.float32)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        write_exr(path, img)
    elif ext == ".png":
        write_png(path, img)
    elif ext == ".pfm":
        write_pfm(path, img)
    elif ext == ".tga":
        write_tga(path, img)
    else:
        raise ValueError(f"unsupported image extension {ext}")


def read_image(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return read_exr(path)
    if ext == ".pfm":
        return read_pfm(path)
    if ext == ".png":
        return read_png(path)
    raise ValueError(f"unsupported image extension {ext}")


# ---------------------------------------------------------------------------
# sRGB helpers (film.cpp gamma encode for 8-bit outputs)
# ---------------------------------------------------------------------------

def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1.0 / 2.4) - 0.055)


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92,
                    np.power((x + 0.055) / 1.055, 2.4))


# ---------------------------------------------------------------------------
# EXR (minimal OpenEXR 2.0: float32 scanlines, NONE or ZIP compression)
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630


def _exr_attr(name: str, typ: str, data: bytes) -> bytes:
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(data)) + data)


def write_exr(path: str, img: np.ndarray):
    h, w, c = img.shape
    assert c == 3
    chans = b""
    for nm in (b"B", b"G", b"R"):  # alphabetical
        chans += nm + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)  # FLOAT
    chans += b"\0"
    header = b""
    header += _exr_attr("channels", "chlist", chans)
    header += _exr_attr("compression", "compression", bytes([0]))  # NONE
    header += _exr_attr("dataWindow", "box2i",
                        struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _exr_attr("displayWindow", "box2i",
                        struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _exr_attr("lineOrder", "lineOrder", bytes([0]))
    header += _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _exr_attr("screenWindowCenter", "v2f",
                        struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _EXR_MAGIC, 2))
        f.write(header)
        offset_table_pos = f.tell()
        f.write(b"\0" * (8 * h))
        offsets = []
        data = np.ascontiguousarray(img, np.float32)
        for y in range(h):
            offsets.append(f.tell())
            row = np.concatenate([data[y, :, 2], data[y, :, 1],
                                  data[y, :, 0]]).astype("<f4").tobytes()
            f.write(struct.pack("<ii", y, len(row)))
            f.write(row)
        f.seek(offset_table_pos)
        f.write(struct.pack(f"<{h}q", *offsets))


def _exr_read_header(f):
    magic, version = struct.unpack("<ii", f.read(8))
    if magic != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    attrs = {}
    while True:
        name = b""
        ch = f.read(1)
        if ch == b"\0":
            break
        while ch != b"\0":
            name += ch
            ch = f.read(1)
        typ = b""
        ch = f.read(1)
        while ch != b"\0":
            typ += ch
            ch = f.read(1)
        size = struct.unpack("<i", f.read(4))[0]
        attrs[name.decode()] = (typ.decode(), f.read(size))
    return attrs


def _exr_unpredict(raw: bytes) -> bytes:
    """ZIP postprocess: reverse delta predictor (t[i] = t[i-1]+raw[i]-128)
    then de-interleave the two halves (OpenEXR ImfZip::uncompress)."""
    deltas = np.frombuffer(raw, np.uint8).astype(np.int64)
    deltas = deltas.copy()
    deltas[1:] -= 128
    out = (np.cumsum(deltas) % 256).astype(np.uint8)
    # de-interleave: first half = even bytes, second half = odd bytes
    n = len(out)
    half = (n + 1) // 2
    res = np.empty(n, np.uint8)
    res[0::2] = out[:half]
    res[1::2] = out[half:]
    return res.tobytes()


def read_exr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        attrs = _exr_read_header(f)
        typ, cdata = attrs["compression"]
        comp = cdata[0]
        _, dw = attrs["dataWindow"]
        x0, y0, x1, y1 = struct.unpack("<iiii", dw)
        w, h = x1 - x0 + 1, y1 - y0 + 1
        # channels
        chl = attrs["channels"][1]
        chans = []
        i = 0
        while chl[i] != 0:
            j = chl.index(b"\0", i)
            nm = chl[i:j].decode()
            ptype = struct.unpack("<i", chl[j + 1:j + 5])[0]
            chans.append((nm, ptype))
            i = j + 17
        chans.sort()
        nch = len(chans)
        dtype_map = {0: np.uint32, 1: np.float16, 2: np.float32}
        sizes = {0: 4, 1: 2, 2: 4}

        if comp == 0:
            rows_per_block = 1
        elif comp in (2, 3):   # ZIPS / ZIP
            rows_per_block = 1 if comp == 2 else 16
        else:
            raise ValueError(f"unsupported EXR compression {comp}")

        n_blocks = (h + rows_per_block - 1) // rows_per_block
        f.read(8 * n_blocks)  # offset table (read sequentially anyway)
        out = np.zeros((h, w, nch), np.float32)
        for _ in range(n_blocks):
            y, size = struct.unpack("<ii", f.read(8))
            block = f.read(size)
            rows = min(rows_per_block, h - (y - y0))
            expect = rows * w * sum(sizes[p] for _, p in chans)
            if comp in (2, 3) and size < expect:
                block = _exr_unpredict(zlib.decompress(block))
            buf = np.frombuffer(block, np.uint8)
            pos = 0
            for r in range(rows):
                for (nm, ptype) in chans:
                    cnt = w * sizes[ptype]
                    vals = np.frombuffer(
                        buf[pos:pos + cnt].tobytes(),
                        dtype_map[ptype]).astype(np.float32)
                    ci = [c[0] for c in chans].index(nm)
                    out[y - y0 + r, :, ci] = vals
                    pos += cnt
        # reorder to RGB if channels are B,G,R (alphabetic)
        names = [c[0] for c in chans]
        if names == ["B", "G", "R"]:
            out = out[:, :, ::-1]
        elif names == ["A", "B", "G", "R"]:
            out = out[:, :, [3, 2, 1]]
        return out


# ---------------------------------------------------------------------------
# PNG (8-bit sRGB, zlib)
# ---------------------------------------------------------------------------

def write_png(path: str, img: np.ndarray):
    h, w, _ = img.shape
    data8 = (linear_to_srgb(img) * 255.0 + 0.5).astype(np.uint8)
    raw = b"".join(b"\0" + data8[y].tobytes() for y in range(h))
    comp = zlib.compress(raw, 6)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", comp))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        sig = f.read(8)
        assert sig[:4] == b"\x89PNG"
        w = h = bitdepth = ctype = None
        idat = b""
        while True:
            ln = struct.unpack(">I", f.read(4))[0]
            tag = f.read(4)
            payload = f.read(ln)
            f.read(4)
            if tag == b"IHDR":
                w, h, bitdepth, ctype = struct.unpack(">IIBB", payload[:10])
            elif tag == b"IDAT":
                idat += payload
            elif tag == b"IEND":
                break
        assert bitdepth == 8 and ctype in (2, 6), "8-bit RGB(A) only"
        nch = 3 if ctype == 2 else 4
        raw = zlib.decompress(idat)
        stride = w * nch
        out = np.zeros((h, stride), np.uint8)
        prev = np.zeros(stride, np.int32)
        pos = 0
        for y in range(h):
            ft = raw[pos]
            row = np.frombuffer(raw[pos + 1:pos + 1 + stride],
                                np.uint8).astype(np.int32)
            pos += 1 + stride
            if ft == 0:
                cur = row
            elif ft == 1:
                cur = row.copy()
                for i in range(nch, stride):
                    cur[i] = (cur[i] + cur[i - nch]) % 256
            elif ft == 2:
                cur = (row + prev) % 256
            elif ft == 3:
                cur = row.copy()
                for i in range(stride):
                    left = cur[i - nch] if i >= nch else 0
                    cur[i] = (cur[i] + (left + prev[i]) // 2) % 256
            elif ft == 4:
                cur = row.copy()
                for i in range(stride):
                    a = cur[i - nch] if i >= nch else 0
                    b = prev[i]
                    cc = prev[i - nch] if i >= nch else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else cc)
                    cur[i] = (cur[i] + pred) % 256
            else:
                raise ValueError(f"bad PNG filter {ft}")
            out[y] = cur.astype(np.uint8)
            prev = cur
        img = out.reshape(h, w, nch)[:, :, :3].astype(np.float32) / 255.0
        return srgb_to_linear(img)


# ---------------------------------------------------------------------------
# PFM (imageio.cpp WritePFM/ReadPFM) & TGA
# ---------------------------------------------------------------------------

def write_pfm(path: str, img: np.ndarray):
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.000000\n")  # little-endian
        # PFM stores bottom-to-top
        f.write(np.ascontiguousarray(img[::-1], "<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        head = f.readline().strip()
        assert head in (b"PF", b"Pf")
        nch = 3 if head == b"PF" else 1
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        dt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * nch * 4), dt)
        img = data.reshape(h, w, nch)[::-1]
        if nch == 1:
            img = np.repeat(img, 3, axis=-1)
        return np.ascontiguousarray(img.astype(np.float32))


def write_tga(path: str, img: np.ndarray):
    h, w, _ = img.shape
    data8 = (linear_to_srgb(img) * 255.0 + 0.5).astype(np.uint8)
    bgr = data8[::-1, :, ::-1]  # bottom-up, BGR
    with open(path, "wb") as f:
        f.write(struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h,
                            24, 0))
        f.write(np.ascontiguousarray(bgr).tobytes())
