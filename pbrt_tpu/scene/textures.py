"""Textures: constant, scale, mix, checkerboard, uv, dots, bilerp,
imagemap, and Perlin-noise textures (fbm, wrinkled, windy, marble).

JAX counterpart of ``src/textures/`` + Texture<T>/MIPMap
(core/texture.{h,cpp}, core/mipmap.h). Textures are rows of an SoA table
evaluated branchlessly at shading points; image maps live in one padded
image stack holding a full mip pyramid per image (MIPMap trilinear,
core/mipmap.h:63 — level 0 at the left, levels 1.. packed in a right-hand
strip), with an isotropic LOD derived from hit distance × camera pixel
spread / |dpdu| (the reference's ray-differential footprint collapsed to
its isotropic width; EWA's anisotropic filter is approximated by the
trilinear chain).
Perlin noise follows pbrt's Noise() permutation-hash construction
(texture.cpp:316-380) with a pcg-hash lattice instead of the static table.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core import rng as rng_mod

Array = Any

CONSTANT = 0
SCALE = 1
MIX = 2
CHECKERBOARD = 3
UV = 4
DOTS = 5
BILERP = 6
IMAGEMAP = 7
FBM = 8
WRINKLED = 9
WINDY = 10
MARBLE = 11


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TextureTable:
    ttype: Array     # (T,)
    v1: Array        # (T,C) tex1 / constant value
    v2: Array        # (T,C) tex2
    uv_scale: Array  # (T,2)
    uv_delta: Array  # (T,2)
    img_id: Array    # (T,)
    octaves: Array   # (T,) fbm octaves
    omega: Array     # (T,) fbm roughness
    scale3d: Array   # (T,) 3D noise frequency
    variation: Array  # (T,) marble FBm variation (marble.h:64)
    # operand texture rows (−1 = use the constant v1/v2/omega slots):
    # scale/mix tex1 → op1, tex2 → op2, mix amount → op3
    # (textures/scale.cpp:44-48, mix.cpp — arbitrary Texture operands)
    op1: Array       # (T,) int32
    op2: Array       # (T,) int32
    op3: Array       # (T,) int32
    images: Array    # (N, Hm, Wm', C) padded mip-atlas stack
    img_wh: Array    # (N, 2) level-0 (w, h)
    mip_off: Array   # (N, L, 2) per-level atlas (x0, y0)
    mip_wh: Array    # (N, L, 2) per-level (w, h)
    n_levels: Array  # (N,)
    spread: Array    # () camera pixel spread (radians/px); 0 → level 0
    # static: EWA elliptically-weighted-average filtering for imagemaps
    # (MIPMap doTrilinear=false default, core/mipmap.h:63,103). False =
    # isotropic trilinear (cheaper; no anisotropy at grazing angles).
    ewa: bool = dataclasses.field(metadata=dict(static=True), default=False)
    max_aniso: float = dataclasses.field(metadata=dict(static=True),
                                         default=8.0)
    # static max operand-nesting depth (0 = no texture operands anywhere;
    # eval_texture unrolls this many resolution passes)
    nest_depth: int = dataclasses.field(metadata=dict(static=True),
                                        default=0)


def _downsample2(im: np.ndarray) -> np.ndarray:
    """One 2×2 box-filter mip step with edge clamping for odd dims
    (MIPMap pyramid build, core/mipmap.h:63 — resampling to pow2 replaced
    by edge-clamped averaging, same filter support)."""
    h, w = im.shape[:2]
    if h > 1 and h % 2:
        im = np.concatenate([im, im[-1:]], axis=0)
    if w > 1 and w % 2:
        im = np.concatenate([im, im[:, -1:]], axis=1)
    if im.shape[0] > 1:
        im = 0.5 * (im[0::2] + im[1::2])
    if im.shape[1] > 1:
        im = 0.5 * (im[:, 0::2] + im[:, 1::2])
    return im


def _mip_pyramid(im: np.ndarray):
    """Full pyramid down to 1×1: list of (level_img, x0, y0). Level 0 at
    (0, 0); levels 1.. stacked top-to-bottom in a strip at x = W0."""
    levels = [(im, 0, 0)]
    x0 = im.shape[1]
    y0 = 0
    cur = im
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        cur = _downsample2(cur)
        levels.append((cur, x0, y0))
        y0 += cur.shape[0]
    return levels


def make_texture_table(rows, images, n_channels,
                       spread: float = 0.0,
                       filtering: str = "trilinear") -> TextureTable:
    """rows: dicts(type, v1, v2, uscale, vscale, udelta, vdelta, img,
    octaves, omega, scale3d); images: list of (H,W,C) arrays. ``spread`` =
    camera pixel spread angle (rad/px) driving the trilinear mip LOD;
    0 disables mip selection (level-0 bilinear). ``filtering`` = "trilinear"
    or "ewa" (anisotropic, MIPMap doTrilinear=false, core/mipmap.h:63)."""
    t = max(1, len(rows))
    f = lambda k, d: np.asarray([r.get(k, d) for r in rows] or [d],
                                np.float32)
    op_rows = [np.asarray([r.get(k, -1) for r in rows] or [-1], np.int32)
               for k in ("op1", "op2", "op3")]

    def _depth_of(i, seen=()):
        if i in seen:           # cycle guard (malformed scene)
            return 0
        ops = [rows[i].get(k, -1) for k in ("op1", "op2", "op3")]
        sub = [_depth_of(int(o), seen + (i,)) for o in ops if o >= 0]
        return 1 + max(sub) if sub else 0

    nest_depth = max([_depth_of(i) for i in range(len(rows))] or [0])
    nest_depth = min(nest_depth, 4)   # bounded unroll; deeper trees are
                                      # pathological and clamp (surfaced)
    fc = lambda k, d: np.asarray(
        [np.broadcast_to(np.asarray(r.get(k, d), np.float32),
                         (n_channels,)) for r in rows]
        or [np.full(n_channels, d, np.float32)], np.float32)
    if images:
        pyramids = [_mip_pyramid(np.asarray(im, np.float32))
                    for im in images]
        lmax = max(len(p) for p in pyramids)
        hm = max(max(im.shape[0], p[-1][2] + 1) for im, p in
                 zip(images, pyramids))
        wm = max(im.shape[1] + (im.shape[1] + 1) // 2 for im in images)
        stack = np.zeros((len(images), hm, wm, n_channels), np.float32)
        wh = np.zeros((len(images), 2), np.int32)
        mip_off = np.zeros((len(images), lmax, 2), np.int32)
        mip_wh = np.ones((len(images), lmax, 2), np.int32)
        n_levels = np.ones(len(images), np.int32)
        for i, (im, pyr) in enumerate(zip(images, pyramids)):
            wh[i] = (im.shape[1], im.shape[0])
            n_levels[i] = len(pyr)
            for l, (lim, x0, y0) in enumerate(pyr):
                stack[i, y0:y0 + lim.shape[0], x0:x0 + lim.shape[1]] = lim
                mip_off[i, l] = (x0, y0)
                mip_wh[i, l] = (lim.shape[1], lim.shape[0])
            # pad unused level slots with the 1×1 tail
            for l in range(len(pyr), lmax):
                mip_off[i, l] = mip_off[i, len(pyr) - 1]
                mip_wh[i, l] = mip_wh[i, len(pyr) - 1]
    else:
        stack = np.zeros((1, 1, 1, n_channels), np.float32)
        wh = np.ones((1, 2), np.int32)
        mip_off = np.zeros((1, 1, 2), np.int32)
        mip_wh = np.ones((1, 1, 2), np.int32)
        n_levels = np.ones(1, np.int32)
    return TextureTable(
        ttype=jnp.asarray(
            np.asarray([r.get("type", CONSTANT) for r in rows] or [0],
                       np.int32)),
        v1=jnp.asarray(fc("v1", 1.0)), v2=jnp.asarray(fc("v2", 0.0)),
        uv_scale=jnp.asarray(np.stack([f("uscale", 1.0), f("vscale", 1.0)],
                                      -1)),
        uv_delta=jnp.asarray(np.stack([f("udelta", 0.0), f("vdelta", 0.0)],
                                      -1)),
        img_id=jnp.asarray(np.asarray([r.get("img", 0) for r in rows]
                                      or [0], np.int32)),
        octaves=jnp.asarray(f("octaves", 6.0)),
        omega=jnp.asarray(f("omega", 0.5)),
        scale3d=jnp.asarray(f("scale3d", 1.0)),
        variation=jnp.asarray(f("variation", 0.2)),
        op1=jnp.asarray(op_rows[0]), op2=jnp.asarray(op_rows[1]),
        op3=jnp.asarray(op_rows[2]),
        nest_depth=nest_depth,
        images=jnp.asarray(stack), img_wh=jnp.asarray(wh),
        mip_off=jnp.asarray(mip_off), mip_wh=jnp.asarray(mip_wh),
        n_levels=jnp.asarray(n_levels),
        spread=jnp.asarray(spread, jnp.float32),
        ewa=(filtering == "ewa"))


# ---------------------------------------------------------------------------
# Perlin-style gradient noise (texture.cpp Noise(), hash-lattice variant)
# ---------------------------------------------------------------------------

def _grad(ix, iy, iz, dx, dy, dz):
    h = rng_mod.hash_u32(ix.astype(jnp.uint32),
                         iy.astype(jnp.uint32),
                         iz.astype(jnp.uint32), 1337) & jnp.uint32(15)
    u = jnp.where(h < 8, dx, dy)
    v = jnp.where(h < 4, dy, jnp.where((h == 12) | (h == 14), dx, dz))
    return (jnp.where(h & 1, -u, u) + jnp.where(h & 2, -v, v))


def noise3(p: Array) -> Array:
    """Gradient noise in [-1,1], batched over (...,3)."""
    pi = jnp.floor(p)
    pf = p - pi
    ix, iy, iz = (pi[..., 0].astype(jnp.int32), pi[..., 1].astype(jnp.int32),
                  pi[..., 2].astype(jnp.int32))
    dx, dy, dz = pf[..., 0], pf[..., 1], pf[..., 2]
    w = pf * pf * pf * (pf * (pf * 6.0 - 15.0) + 10.0)  # smootherstep

    def g(ox, oy, oz):
        return _grad(ix + ox, iy + oy, iz + oz, dx - ox, dy - oy, dz - oz)

    x00 = g(0, 0, 0) * (1 - w[..., 0]) + g(1, 0, 0) * w[..., 0]
    x10 = g(0, 1, 0) * (1 - w[..., 0]) + g(1, 1, 0) * w[..., 0]
    x01 = g(0, 0, 1) * (1 - w[..., 0]) + g(1, 0, 1) * w[..., 0]
    x11 = g(0, 1, 1) * (1 - w[..., 0]) + g(1, 1, 1) * w[..., 0]
    y0 = x00 * (1 - w[..., 1]) + x10 * w[..., 1]
    y1 = x01 * (1 - w[..., 1]) + x11 * w[..., 1]
    return y0 * (1 - w[..., 2]) + y1 * w[..., 2]


def fbm(p: Array, octaves: Array, omega: Array, max_oct: int = 8) -> Array:
    out = jnp.zeros(p.shape[:-1])
    lam = jnp.ones(p.shape[:-1])
    o = jnp.ones(p.shape[:-1])
    for i in range(max_oct):
        use = i < octaves
        out = out + jnp.where(use, o * noise3(p * lam[..., None]), 0.0)
        lam = lam * 1.99
        o = o * omega
    return out


def turbulence(p: Array, octaves: Array, omega: Array, max_oct: int = 8
               ) -> Array:
    out = jnp.zeros(p.shape[:-1])
    lam = jnp.ones(p.shape[:-1])
    o = jnp.ones(p.shape[:-1])
    for i in range(max_oct):
        use = i < octaves
        out = out + jnp.where(use,
                              o * jnp.abs(noise3(p * lam[..., None])), 0.0)
        lam = lam * 1.99
        o = o * omega
    return out


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _bilinear_image(tt: TextureTable, img_id, uv, level=None):
    """Bilinear tap at one mip level (MIPMap::triangle, core/mipmap.h)."""
    if level is None:
        level = jnp.zeros(jnp.shape(img_id), jnp.int32)
    off = tt.mip_off[img_id, level]
    whl = tt.mip_wh[img_id, level]
    whf = whl.astype(jnp.float32)
    x = uv[..., 0] * whf[..., 0] - 0.5
    y = (1.0 - uv[..., 1]) * whf[..., 1] - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    wmax = tt.images.shape[2] - 1
    hmax = tt.images.shape[1] - 1
    wlim = whl[..., 0] - 1
    hlim = whl[..., 1] - 1

    def tap(ox, oy):
        xi = jnp.clip(jnp.clip(x0 + ox, 0, wlim) + off[..., 0], 0, wmax)
        yi = jnp.clip(jnp.clip(y0 + oy, 0, hlim) + off[..., 1], 0, hmax)
        return tt.images[img_id, yi, xi]

    return ((tap(0, 0) * (1 - fx) + tap(1, 0) * fx) * (1 - fy)
            + (tap(0, 1) * (1 - fx) + tap(1, 1) * fx) * fy)


def _trilinear_image(tt: TextureTable, img_id, uv, width_uv):
    """MIPMap::Lookup (core/mipmap.h:63): isotropic trilinear filtering —
    level = levels-1 + log2(max(width)), lerped between adjacent levels."""
    whf = tt.img_wh[img_id].astype(jnp.float32)
    texels = width_uv * jnp.maximum(whf[..., 0], whf[..., 1])
    lod = jnp.log2(jnp.maximum(texels, 1.0))
    lmax = (tt.n_levels[img_id] - 1).astype(jnp.float32)
    lod = jnp.clip(lod, 0.0, lmax)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, tt.n_levels[img_id] - 1)
    fl = (lod - l0.astype(jnp.float32))[..., None]
    a = _bilinear_image(tt, img_id, uv, l0)
    b = _bilinear_image(tt, img_id, uv, l1)
    return a * (1.0 - fl) + b * fl


_EWA_HALF = 8  # static tap window half-extent (maxAniso=8 → major semi-axis
               # ≤ ~8 texels at the chosen level, mipmap.h:188-199)


def _ewa_one_level(tt: TextureTable, img_id, uv, duv0, duv1, level):
    """MIPMap::EWA at one mip level (core/mipmap.h:137-181 role): Gaussian-
    weighted average over the texel ellipse mapped by (duv0, duv1). The
    reference scans the data-dependent ellipse bbox; here a static
    (2·_EWA_HALF+1)² window with the in-ellipse test makes it one fixed
    gather pattern (taps outside the ellipse weigh 0)."""
    off = tt.mip_off[img_id, level]
    whl = tt.mip_wh[img_id, level]
    whf = whl.astype(jnp.float32)
    # texel coordinates at this level (continuous), v flipped as in bilinear
    sx = uv[..., 0] * whf[..., 0] - 0.5
    sy = (1.0 - uv[..., 1]) * whf[..., 1] - 0.5
    d0x = duv0[..., 0] * whf[..., 0]
    d0y = -duv0[..., 1] * whf[..., 1]
    d1x = duv1[..., 0] * whf[..., 0]
    d1y = -duv1[..., 1] * whf[..., 1]
    # ellipse e(u,v) = A u² + B u v + C v² < 1 (mipmap.h:141-152)
    A = d0y * d0y + d1y * d1y + 1.0
    B = -2.0 * (d0x * d0y + d1x * d1y)
    C = d0x * d0x + d1x * d1x + 1.0
    inv_f = 1.0 / jnp.maximum(A * C - B * B * 0.25, 1e-12)
    A = A * inv_f
    B = B * inv_f
    C = C * inv_f

    cx = jnp.round(sx).astype(jnp.int32)
    cy = jnp.round(sy).astype(jnp.int32)
    wmax = tt.images.shape[2] - 1
    hmax = tt.images.shape[1] - 1
    wlim = whl[..., 0] - 1
    hlim = whl[..., 1] - 1
    acc = jnp.zeros(uv.shape[:-1] + (tt.images.shape[-1],))
    wsum = jnp.zeros(uv.shape[:-1])
    exp_neg2 = float(np.exp(-2.0))
    for oy in range(-_EWA_HALF, _EWA_HALF + 1):
        for ox in range(-_EWA_HALF, _EWA_HALF + 1):
            uu = (cx + ox).astype(jnp.float32) - sx
            vv = (cy + oy).astype(jnp.float32) - sy
            e = A * uu * uu + B * uu * vv + C * vv * vv
            w = jnp.where(e < 1.0, jnp.exp(-2.0 * e) - exp_neg2, 0.0)
            xi = jnp.clip(jnp.clip(cx + ox, 0, wlim) + off[..., 0], 0, wmax)
            yi = jnp.clip(jnp.clip(cy + oy, 0, hlim) + off[..., 1], 0, hmax)
            acc = acc + tt.images[img_id, yi, xi] * w[..., None]
            wsum = wsum + w
    return acc / jnp.maximum(wsum, 1e-9)[..., None]


def _ewa_image(tt: TextureTable, img_id, uv, duv0, duv1):
    """MIPMap::Lookup anisotropic path (core/mipmap.h:103-135): pick the
    level from the minor-axis length, clamp eccentricity to max_aniso by
    lengthening the minor axis, lerp EWA between the two bracketing
    levels."""
    len0 = jnp.sqrt(jnp.sum(duv0 * duv0, -1))
    len1 = jnp.sqrt(jnp.sum(duv1 * duv1, -1))
    swap = len1 > len0
    major = jnp.where(swap[..., None], duv1, duv0)
    minor = jnp.where(swap[..., None], duv0, duv1)
    maj_l = jnp.maximum(len0, len1)
    min_l = jnp.minimum(len0, len1)
    # clamp anisotropy (mipmap.h:121-128)
    scale = jnp.where(min_l * tt.max_aniso < maj_l,
                      maj_l / jnp.maximum(min_l * tt.max_aniso, 1e-12), 1.0)
    minor = minor * scale[..., None]
    min_l = min_l * scale
    # level from minor length (texels at level 0), as _trilinear_image
    whf = tt.img_wh[img_id].astype(jnp.float32)
    texels = min_l * jnp.maximum(whf[..., 0], whf[..., 1])
    lod = jnp.log2(jnp.maximum(texels, 1.0))
    lmax = (tt.n_levels[img_id] - 1).astype(jnp.float32)
    lod = jnp.clip(lod, 0.0, lmax)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, tt.n_levels[img_id] - 1)
    fl = (lod - l0.astype(jnp.float32))[..., None]
    a = _ewa_one_level(tt, img_id, uv, major, minor, l0)
    b = _ewa_one_level(tt, img_id, uv, major, minor, l1)
    return a * (1.0 - fl) + b * fl


def eval_texture(tt: TextureTable, tex_id: Array, uv: Array, p: Array,
                 width_uv: Array = None, duv0: Array = None,
                 duv1: Array = None, _depth: int = None) -> Array:
    """Evaluate texture rows tex_id (R,) at uv (R,2) / world p (R,3) →
    (R,C). ``width_uv`` (R,) = isotropic uv-space filter footprint for
    mip selection (None → level-0 bilinear); ``duv0``/``duv1`` (R,2) =
    anisotropic uv-space footprint axes (used by imagemaps when tt.ewa).

    Texture OPERANDS (scale/mix tex1/tex2/amount as textures —
    textures/scale.cpp:44-48) resolve by static recursion: the table's
    host-computed nest_depth unrolls that many passes, so arbitrary
    operand trees evaluate exactly (r3 limited operands to constants)."""
    if _depth is None:
        _depth = tt.nest_depth
    tid = jnp.clip(tex_id, 0, tt.ttype.shape[0] - 1)
    t = tt.ttype[tid]
    v1 = tt.v1[tid]
    v2 = tt.v2[tid]
    amt = tt.omega[tid][..., None]  # mix amount rides in the omega slot
    if _depth > 0:
        def op_resolve(op, fallback):
            sub = eval_texture(tt, jnp.maximum(op, 0), uv, p, width_uv,
                               duv0, duv1, _depth=_depth - 1)
            return jnp.where((op >= 0)[..., None], sub, fallback)
        v1 = op_resolve(tt.op1[tid], v1)
        v2 = op_resolve(tt.op2[tid], v2)
        amt = op_resolve(tt.op3[tid], amt)[..., 0:1]
    st = uv * tt.uv_scale[tid] + tt.uv_delta[tid]
    C = v1.shape[-1]

    out = v1  # CONSTANT

    # checkerboard (textures/checkerboard.{h,cpp} 2D). Point sample
    # without a footprint; with one, the closed-form box filter
    # (checkerboard.h:75-100): per-axis integrals of the 0/1 square wave
    # via bumpInt, XOR-combined, 0.5 beyond one-period footprints.
    check = ((jnp.floor(st[..., 0]) + jnp.floor(st[..., 1])).astype(
        jnp.int32) % 2) == 0
    if width_uv is not None or duv0 is not None:
        if duv0 is not None and duv1 is not None:
            ds = jnp.maximum(jnp.abs(duv0[..., 0]), jnp.abs(duv1[..., 0])) \
                * tt.uv_scale[tid][..., 0]
            dt_ = jnp.maximum(jnp.abs(duv0[..., 1]), jnp.abs(duv1[..., 1])) \
                * tt.uv_scale[tid][..., 1]
        else:
            ds = width_uv * tt.uv_scale[tid][..., 0]
            dt_ = width_uv * tt.uv_scale[tid][..., 1]
        ds = jnp.maximum(ds, 1e-8)
        dt_ = jnp.maximum(dt_, 1e-8)

        def bump_int(x):
            x2 = x * 0.5
            return jnp.floor(x2) + 2.0 * jnp.maximum(
                x2 - jnp.floor(x2) - 0.5, 0.0)

        s0 = st[..., 0] - ds
        s1 = st[..., 0] + ds
        t0 = st[..., 1] - dt_
        t1 = st[..., 1] + dt_
        sint = (bump_int(s1) - bump_int(s0)) / (2.0 * ds)
        tint = (bump_int(t1) - bump_int(t0)) / (2.0 * dt_)
        area2 = sint + tint - 2.0 * sint * tint
        area2 = jnp.where((ds > 1.0) | (dt_ > 1.0), 0.5, area2)
        inside_one = (jnp.floor(s0) == jnp.floor(s1)) \
            & (jnp.floor(t0) == jnp.floor(t1))
        area2 = jnp.where(inside_one,
                          jnp.where(check, 0.0, 1.0), area2)
        chk_val = (1.0 - area2)[..., None] * v1 + area2[..., None] * v2
    else:
        chk_val = jnp.where(check[..., None], v1, v2)
    out = jnp.where((t == CHECKERBOARD)[..., None], chk_val, out)

    # uv debug texture
    uvc = jnp.zeros_like(v1)
    uvc = uvc.at[..., 0].set(st[..., 0] - jnp.floor(st[..., 0]))
    if C > 1:
        uvc = uvc.at[..., 1].set(st[..., 1] - jnp.floor(st[..., 1]))
    out = jnp.where((t == UV)[..., None], uvc, out)

    # polka dots (textures/dots.cpp)
    cell = jnp.floor(st + 0.5)
    rcenter = jnp.stack(
        [rng_mod.uniform(cell[..., 0].astype(jnp.uint32)
                         + cell[..., 1].astype(jnp.uint32) * 9973, 0, 21),
         rng_mod.uniform(cell[..., 0].astype(jnp.uint32)
                         + cell[..., 1].astype(jnp.uint32) * 9973, 0, 22)],
        -1) * 0.7 - 0.35
    in_dot = jnp.sum((st - cell - rcenter) ** 2, -1) < 0.0625
    out = jnp.where((t == DOTS)[..., None],
                    jnp.where(in_dot[..., None], v1, v2), out)

    # bilerp (textures/bilerp.cpp): corners v00=v1, v11=v2, cross mix
    u_, v_ = st[..., 0:1], st[..., 1:2]
    bl = (1 - u_) * (1 - v_) * v1 + u_ * v_ * v2 \
        + (u_ * (1 - v_) + (1 - u_) * v_) * 0.5 * (v1 + v2)
    out = jnp.where((t == BILERP)[..., None], bl, out)

    # image map (trilinear mip chain when a footprint is supplied; EWA
    # when the table requests it and anisotropic axes are available)
    if tt.ewa and duv0 is not None and duv1 is not None:
        img = _ewa_image(tt, tt.img_id[tid], st - jnp.floor(st),
                         duv0 * tt.uv_scale[tid], duv1 * tt.uv_scale[tid])
    elif width_uv is None:
        img = _bilinear_image(tt, tt.img_id[tid], st - jnp.floor(st))
    else:
        w_st = width_uv * jnp.max(tt.uv_scale[tid], axis=-1)
        img = _trilinear_image(tt, tt.img_id[tid], st - jnp.floor(st),
                               w_st)
    out = jnp.where((t == IMAGEMAP)[..., None], img * v1, out)

    # noise textures over world position (textures/{fbm,wrinkled,windy,
    # marble}.cpp)
    p3 = p * tt.scale3d[tid][..., None]
    f = fbm(p3, tt.octaves[tid], tt.omega[tid])
    out = jnp.where((t == FBM)[..., None], v1 * f[..., None], out)
    w = turbulence(p3, tt.octaves[tid], tt.omega[tid])
    out = jnp.where((t == WRINKLED)[..., None], v1 * w[..., None], out)
    windy = (jnp.abs(fbm(p3 * 0.1, jnp.full_like(tt.octaves[tid], 3.0),
                         tt.omega[tid]))
             * fbm(p3, jnp.full_like(tt.octaves[tid], 6.0),
                   tt.omega[tid]))
    out = jnp.where((t == WINDY)[..., None], v1 * windy[..., None], out)
    # marble (textures/marble.h:59-89): sin-warped FBm through the
    # 9-color Bezier spline, ×1.5 — EXACT port incl. pbrt-v3\'s
    # `min(1, floor(t*NSEG))` segment clamp (only the first two spline
    # segments are reachable in the shipped code; kept for parity)
    marble_val = p3[..., 1] + tt.variation[tid] * fbm(
        p3, tt.octaves[tid], tt.omega[tid])
    mt = 0.5 + 0.5 * jnp.sin(marble_val)
    _MARBLE_C = jnp.asarray(
        [[.58, .58, .6], [.58, .58, .6], [.58, .58, .6],
         [.5, .5, .5], [.6, .59, .58], [.58, .58, .6],
         [.58, .58, .6], [.2, .2, .33], [.58, .58, .6]], jnp.float32)
    if C == 3:
        mc = _MARBLE_C
    else:
        from pbrt_tpu.core import spectrum as spec_mod
        mc = spec_mod.from_rgb(
            _MARBLE_C, spec_mod.SAMPLED if C != 3 else spec_mod.RGB)
    nseg = _MARBLE_C.shape[0] - 3
    first = jnp.minimum(1, jnp.floor(mt * nseg).astype(jnp.int32))
    mt2 = (mt * nseg - first)[..., None]
    c0 = jnp.where(first[..., None] == 0, mc[0], mc[1])
    c1 = jnp.where(first[..., None] == 0, mc[1], mc[2])
    c2 = jnp.where(first[..., None] == 0, mc[2], mc[3])
    c3 = jnp.where(first[..., None] == 0, mc[3], mc[4])
    b0 = (1 - mt2) * c0 + mt2 * c1
    b1 = (1 - mt2) * c1 + mt2 * c2
    b2 = (1 - mt2) * c2 + mt2 * c3
    b0 = (1 - mt2) * b0 + mt2 * b1
    b1 = (1 - mt2) * b1 + mt2 * b2
    marble_rgb = 1.5 * ((1 - mt2) * b0 + mt2 * b1)
    out = jnp.where((t == MARBLE)[..., None], marble_rgb, out)

    # scale / mix (operands already resolved above when textures)
    out = jnp.where((t == SCALE)[..., None], v1 * v2, out)
    out = jnp.where((t == MIX)[..., None], (1 - amt) * v1 + amt * v2, out)
    return out


def resolve_kd(scene, mp, hit, wo=None) -> Array:
    """kd with texture override: materials.kd_tex ≥ 0 → texture lookup.

    Mip footprint: the camera pixel spread (tt.spread, rad/px) grows
    linearly with hit distance; dividing by |∂p/∂u| converts the world
    width into uv space (the reference's ray-differential footprint,
    core/interaction.cpp ComputeDifferentials, collapsed to its isotropic
    width). spread == 0 (default) → level-0 bilinear.

    With ``wo`` (= −ray direction) and an EWA texture table, the screen
    footprint disk is projected onto the tangent plane and solved against
    (dpdu, dpdv) for the anisotropic uv axes — the batched equivalent of
    SurfaceInteraction::ComputeDifferentials (core/interaction.cpp:165+)."""
    tt = getattr(scene, "textures", None)
    if tt is None:
        return mp.kd
    has_tex = mp.kd_tex >= 0
    width_uv = None
    duv0 = duv1 = None
    if getattr(tt, "spread", None) is not None and hit.dpdu is not None:
        from pbrt_tpu.core import vecmath
        world_w = hit.t * tt.spread
        width_uv = world_w / jnp.maximum(vecmath.length(hit.dpdu), 1e-8)
        if tt.ewa and wo is not None and hit.dpdv is not None:
            d = -wo
            e1, e2 = vecmath.coordinate_system(d)
            den = vecmath.dot(d, hit.ng)
            den = jnp.where(jnp.abs(den) > 1e-4, den,
                            jnp.where(den >= 0, 1e-4, -1e-4))
            # footprint axes on the tangent plane (grazing → stretched)
            dpdx = world_w[..., None] * (
                e1 - d * (vecmath.dot(e1, hit.ng) / den)[..., None])
            dpdy = world_w[..., None] * (
                e2 - d * (vecmath.dot(e2, hit.ng) / den)[..., None])
            # Gram solve [du, dv] for each footprint axis
            g11 = vecmath.dot(hit.dpdu, hit.dpdu)
            g12 = vecmath.dot(hit.dpdu, hit.dpdv)
            g22 = vecmath.dot(hit.dpdv, hit.dpdv)
            det = jnp.maximum(g11 * g22 - g12 * g12, 1e-12)

            def solve(dp):
                b1 = vecmath.dot(dp, hit.dpdu)
                b2 = vecmath.dot(dp, hit.dpdv)
                return jnp.stack([(g22 * b1 - g12 * b2) / det,
                                  (g11 * b2 - g12 * b1) / det], axis=-1)

            duv0 = solve(dpdx)
            duv1 = solve(dpdy)
    tex_val = eval_texture(tt, jnp.maximum(mp.kd_tex, 0), hit.uv, hit.p,
                           width_uv=width_uv, duv0=duv0, duv1=duv1)
    return jnp.where(has_tex[..., None], tex_val, mp.kd)
