"""Measured (Fourier-basis) BSDF tables.

JAX counterpart of ``materials/fourier.{h,cpp}`` +
``FourierBSDF::f`` (core/reflection.cpp) + the Catmull–Rom machinery of
``core/interpolation.{h,cpp}``: reads the layerlab 'SCATFUN' v1 binary
format (spline × Fourier isotropic BSDF; header documented at
materials/fourier.cpp:44-90) into dense arrays and evaluates f(wo, wi)
batched over shading points.

The variable-length Fourier series are stored dense-padded to mMax so the
evaluation is a fixed-size masked reduction (fori over mMax) —
vectorizable at the cost of table memory. Integrator wiring (a FOURIER material row type
with cosine-hemisphere importance fallback) lands with measured-data scenes;
no .bsdf assets ship with the reference repo, so this module is validated by
a synthetic write→read→evaluate round trip (tests/test_fourier.py).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FourierTable:
    mu: Array        # (nMu,) elevational grid
    a_dense: Array   # (nMu, nMu, nChannels, mMax) padded coefficients
    m: Array         # (nMu, nMu) series lengths
    cdf: Array       # (nMu, nMu)
    eta: Array       # ()
    n_channels: int = dataclasses.field(metadata=dict(static=True))
    m_max: int = dataclasses.field(metadata=dict(static=True))


def read_bsdf(path: str) -> FourierTable:
    """materials/fourier.cpp FourierBSDFTable::Read."""
    with open(path, "rb") as f:
        header = f.read(8)
        if header != b"SCATFUN\x01":
            raise ValueError(f"{path}: not a SCATFUN v1 file")
        ints = struct.unpack("<9i", f.read(36))
        flags, n_mu, n_coeffs, m_max, n_channels, n_bases = ints[:6]
        eta = struct.unpack("<f", f.read(4))[0]
        f.read(16)  # alpha[2] + unused[2]
        if flags != 1 or n_channels not in (1, 3) or n_bases != 1:
            raise ValueError(f"{path}: unsupported SCATFUN variant")
        mu = np.frombuffer(f.read(4 * n_mu), "<f4")
        cdf = np.frombuffer(f.read(4 * n_mu * n_mu), "<f4").reshape(
            n_mu, n_mu)
        off_len = np.frombuffer(f.read(8 * n_mu * n_mu), "<i4").reshape(
            n_mu, n_mu, 2)
        a = np.frombuffer(f.read(4 * n_coeffs), "<f4")

    # densify to (nMu, nMu, C, mMax); the stored length is the per-channel
    # series length m, channels laid out consecutively (GetAk indexes
    # ap[c*m + k], reflection.cpp)
    dense = np.zeros((n_mu, n_mu, n_channels, m_max), np.float32)
    m_arr = off_len[..., 1].copy()
    for i in range(n_mu):
        for o in range(n_mu):
            off = off_len[i, o, 0]
            mc = off_len[i, o, 1]
            if mc <= 0:
                continue
            for c in range(n_channels):
                dense[i, o, c, :mc] = a[off + c * mc: off + (c + 1) * mc]
    return FourierTable(
        mu=jnp.asarray(mu), a_dense=jnp.asarray(dense),
        m=jnp.asarray(m_arr, jnp.int32), cdf=jnp.asarray(cdf),
        eta=jnp.asarray(eta), n_channels=n_channels, m_max=m_max)


def write_bsdf(path: str, mu: np.ndarray, coeffs, eta=1.0):
    """Write a SCATFUN v1 file (inverse of read_bsdf; the layerlab format)
    — used for synthetic fixtures. ``coeffs[i][o]`` = (C, m) array."""
    n_mu = len(mu)
    n_channels = np.asarray(coeffs[0][0]).shape[0]
    flat = []
    off_len = np.zeros((n_mu, n_mu, 2), np.int32)
    for i in range(n_mu):
        for o in range(n_mu):
            c = np.asarray(coeffs[i][o], np.float32)
            off_len[i, o, 0] = len(flat)
            off_len[i, o, 1] = c.shape[1]
            flat.extend(c.reshape(-1).tolist())
    m_max = int(off_len[..., 1].max())
    with open(path, "wb") as f:
        f.write(b"SCATFUN\x01")
        f.write(struct.pack("<9i", 1, n_mu, len(flat), m_max, n_channels,
                            1, 0, 0, 0))
        f.write(struct.pack("<f", eta))
        f.write(struct.pack("<4f", 0.0, 0.0, 0.0, 0.0))
        f.write(np.asarray(mu, "<f4").tobytes())
        f.write(np.zeros((n_mu, n_mu), "<f4").tobytes())   # cdf (unused)
        f.write(off_len.astype("<i4").tobytes())
        f.write(np.asarray(flat, "<f4").tobytes())


# ---------------------------------------------------------------------------
# Catmull–Rom spline weights (interpolation.cpp CatmullRomWeights)
# ---------------------------------------------------------------------------

def catmull_rom_weights(nodes: Array, x: Array):
    """Batched: returns (offset (R,), weights (R,4)); valid iff x within
    the node range (weights zeroed otherwise)."""
    n = nodes.shape[0]
    valid = (x >= nodes[0]) & (x <= nodes[-1])
    i = jnp.clip(jnp.searchsorted(nodes, x, side="right") - 1, 0, n - 2)
    x0 = nodes[i]
    x1 = nodes[i + 1]
    t = (x - x0) / jnp.maximum(x1 - x0, 1e-12)
    t2 = t * t
    t3 = t2 * t
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    # derivative weights
    w0 = jnp.zeros_like(t)
    w3 = jnp.zeros_like(t)
    d1 = t3 - 2 * t2 + t
    d2 = t3 - t2
    # left endpoint handling
    has_left = i > 0
    x_m1 = nodes[jnp.maximum(i - 1, 0)]
    wl = d1 * (x1 - x0) / jnp.maximum(x1 - x_m1, 1e-12)
    w0 = jnp.where(has_left, -wl, 0.0)
    w2l = jnp.where(has_left, w2 + 0.0, w2)
    w2 = jnp.where(has_left, w2 + wl, w2 + 0.0)
    w1 = jnp.where(has_left, w1, w1 - d1)
    w2 = jnp.where(has_left, w2, w2 + d1)
    # right endpoint
    has_right = i + 2 < n
    x_p2 = nodes[jnp.minimum(i + 2, n - 1)]
    wr = d2 * (x1 - x0) / jnp.maximum(x_p2 - x0, 1e-12)
    w3 = jnp.where(has_right, wr, 0.0)
    w1 = jnp.where(has_right, w1 - wr, w1 - d2)
    w2 = jnp.where(has_right, w2, w2 + d2)
    weights = jnp.stack([w0, w1, w2, w3], -1)
    weights = jnp.where(valid[..., None], weights, 0.0)
    # offset such that weights apply to nodes[offset .. offset+3]
    return i - 1, weights


def fourier_sum(ak: Array, m: Array, cos_phi: Array, m_max: int) -> Array:
    """Σ_k ak[k] cos(kφ) via the Chebyshev recurrence
    cos(kφ) = 2cosφ·cos((k−1)φ) − cos((k−2)φ)
    (interpolation.cpp Fourier), masked to each lane's series length m."""
    def body(k, carry):
        val, c_curr, c_prev = carry       # c_curr = cos(kφ)
        val = val + jnp.where(k < m, ak[..., k] * c_curr, 0.0)
        c_next = 2.0 * cos_phi * c_curr - c_prev
        return val, c_next, c_curr

    val0 = jnp.zeros(cos_phi.shape)
    c0 = jnp.ones_like(cos_phi)           # cos(0φ)
    c_m1 = cos_phi                        # cos(−1·φ) = cos φ → c_1 = cos φ
    val, _, _ = jax.lax.fori_loop(0, m_max, body, (val0, c0, c_m1))
    return val


def eval_fourier_set(tables, fourier_id: Array, wo: Array, wi: Array,
                     n_channels: int) -> Array:
    """Evaluate a tuple of FourierTables, dispatching per-ray on
    ``fourier_id`` (MaterialTable.fourier_id gathered per hit). The table
    count is static and small (one per distinct .bsdf file), so a masked
    Python loop compiles to K fused evaluations — the batched replacement for
    FourierBSDF's per-hit table pointer."""
    out = jnp.zeros(wo.shape[:-1] + (n_channels,))
    for k, tbl in enumerate(tables):
        rgb = eval_fourier(tbl, wo, wi)     # (R,3)
        if n_channels == 3:
            v = rgb
        else:
            # sampled-spectrum build: flat spectrum at the RGB mean (the
            # measured tables are RGB; exact SPD upsampling is out of scope)
            v = jnp.repeat(rgb.mean(-1, keepdims=True), n_channels, -1)
        out = jnp.where((fourier_id == k)[..., None], v, out)
    return out


def eval_fourier(table: FourierTable, wo: Array, wi: Array) -> Array:
    """FourierBSDF::f (reflection.cpp) batched: wo, wi local-frame unit
    vectors (R,3) → (R,3) RGB (or greyscale broadcast)."""
    mu_i = -wi[..., 2]
    mu_o = wo[..., 2]
    # CosDPhi(-wi, wo)
    wix, wiy = -wi[..., 0], -wi[..., 1]
    wox, woy = wo[..., 0], wo[..., 1]
    waxy = wix * wix + wiy * wiy
    wbxy = wox * wox + woy * woy
    cos_phi = jnp.clip(
        (wix * wox + wiy * woy)
        * jax.lax.rsqrt(jnp.maximum(waxy * wbxy, 1e-20)), -1.0, 1.0)
    cos_phi = jnp.where((waxy < 1e-12) | (wbxy < 1e-12), 1.0, cos_phi)

    off_i, w_i = catmull_rom_weights(table.mu, mu_i)
    off_o, w_o = catmull_rom_weights(table.mu, mu_o)
    n_mu = table.mu.shape[0]
    C = table.n_channels
    ak = jnp.zeros(mu_i.shape + (C, table.m_max))
    m_eff = jnp.zeros(mu_i.shape, jnp.int32)
    for b in range(4):
        for a in range(4):
            ii = jnp.clip(off_i + a, 0, n_mu - 1)
            oo = jnp.clip(off_o + b, 0, n_mu - 1)
            w = (w_i[..., a] * w_o[..., b])
            ak = ak + w[..., None, None] * table.a_dense[ii, oo]
            m_here = table.m[ii, oo]
            m_eff = jnp.maximum(m_eff,
                                jnp.where(jnp.abs(w) > 0, m_here, 0))

    Y = jnp.maximum(0.0, fourier_sum(ak[..., 0, :], m_eff, cos_phi,
                                     table.m_max))
    scale = jnp.where(jnp.abs(mu_i) > 1e-9, 1.0 / jnp.abs(mu_i), 0.0)
    # adjoint eta scaling (radiance transport)
    trans = mu_i * mu_o > 0
    eta_sc = jnp.where(mu_i > 0, 1.0 / table.eta, table.eta)
    scale = scale * jnp.where(trans, eta_sc * eta_sc, 1.0)
    if C == 1:
        return jnp.repeat((Y * scale)[..., None], 3, axis=-1)
    R = fourier_sum(ak[..., 1, :], m_eff, cos_phi, table.m_max)
    B = fourier_sum(ak[..., 2, :], m_eff, cos_phi, table.m_max)
    G = 1.39829 * Y - 0.100913 * B - 0.297375 * R
    rgb = jnp.stack([R * scale, G * scale, B * scale], -1)
    return jnp.clip(rgb, 0.0, None)
