"""Spectra: RGB (3ch) and sampled (60 bins, 400–700nm) representations.

JAX counterpart of ``core/spectrum.{h,cpp}`` (CoefficientSpectrum /
RGBSpectrum / SampledSpectrum, spectrum.h:48-51,304) plus the fork's
additions: ``zeroAllBinsBut``/``indexFromWavelength`` (spectrum.h:282-294),
uniform wavelength sampling (spectrum.h:528-534) and ``SpectralDistribution``
(distr.h:85-112).

Instead of a compile-time template switch (PBRT_SAMPLED_SPECTRUM,
CMakeLists.txt:18-22) the channel count is data: spectra are arrays with a
trailing channel axis of size 3 or 60, and a :class:`SpectrumConfig` carries
the mode. Integrators are channel-count agnostic.

CIE matching functions use the Wyman–Sloan–Shirley multi-lobe Gaussian fits
(JCGT 2013) rather than the reference's 471-entry tables — compact, smooth,
differentiable, and accurate to ~1% which is far below Monte Carlo noise.
RGB→spectrum upsampling solves a smoothness-regularized equality-constrained
least-squares problem at import time (exact RGB round-trip by construction).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core.sampling import (Distribution1D, make_distribution_1d,
                                    sample_distribution_1d_continuous)

Array = Any

# spectrum.h:48-51
LAMBDA_START = 400.0
LAMBDA_END = 700.0
LAMBDA_RANGE = LAMBDA_END - LAMBDA_START
N_SPECTRAL_SAMPLES = 60

# CIE Y integral over the visible range (used to normalize radiometric→photometric)
CIE_Y_INTEGRAL = 106.856895


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    mode: str = "rgb"            # "rgb" | "sampled"

    @property
    def n_channels(self) -> int:
        return 3 if self.mode == "rgb" else N_SPECTRAL_SAMPLES


RGB = SpectrumConfig("rgb")
SAMPLED = SpectrumConfig("sampled")


def bin_centers() -> np.ndarray:
    i = np.arange(N_SPECTRAL_SAMPLES)
    return LAMBDA_START + (i + 0.5) * (LAMBDA_RANGE / N_SPECTRAL_SAMPLES)


# ---------------------------------------------------------------------------
# CIE matching functions — analytic piecewise-Gaussian fits
# ---------------------------------------------------------------------------

def _pw_gauss(x, alpha, mu, s1, s2):
    """Piecewise Gaussian: sigma = s1 left of mu, s2 right of mu."""
    t = (x - mu) * np.where(np.asarray(x) < mu, 1.0 / s1, 1.0 / s2) \
        if isinstance(x, np.ndarray) else \
        (x - mu) * jnp.where(x < mu, 1.0 / s1, 1.0 / s2)
    return alpha * (np.exp(-0.5 * t * t) if isinstance(t, np.ndarray)
                    else jnp.exp(-0.5 * t * t))


def cie_x(lam):
    return (_pw_gauss(lam, 1.056, 599.8, 37.9, 31.0)
            + _pw_gauss(lam, 0.362, 442.0, 16.0, 26.7)
            + _pw_gauss(lam, -0.065, 501.1, 20.4, 26.2))


def cie_y(lam):
    return (_pw_gauss(lam, 0.821, 568.8, 46.9, 40.5)
            + _pw_gauss(lam, 0.286, 530.9, 16.3, 31.1))


def cie_z(lam):
    return (_pw_gauss(lam, 1.217, 437.0, 11.8, 36.0)
            + _pw_gauss(lam, 0.681, 459.0, 26.0, 13.8))


def cie_xyz(lam):
    """(..., ) wavelengths → (..., 3) XYZ matching values."""
    return (jnp.stack([cie_x(lam), cie_y(lam), cie_z(lam)], axis=-1)
            if not isinstance(lam, np.ndarray)
            else np.stack([cie_x(lam), cie_y(lam), cie_z(lam)], axis=-1))


# sRGB / Rec.709 primaries, D65 white (matches spectrum.cpp XYZToRGB)
_XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], np.float64)
_RGB_TO_XYZ = np.linalg.inv(_XYZ_TO_RGB)


def _mm(a: Array, b: Array) -> Array:
    """Matrix product exact to float32 (a float32 dot may otherwise run
    in TF32 on a GPU, keeping about three digits)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def xyz_to_rgb(xyz: Array) -> Array:
    return _mm(xyz, jnp.asarray(_XYZ_TO_RGB.T, xyz.dtype))


def rgb_to_xyz(rgb: Array) -> Array:
    return _mm(rgb, jnp.asarray(_RGB_TO_XYZ.T, rgb.dtype))


# ---------------------------------------------------------------------------
# Precomputed conversion tables (host-side, import time)
# ---------------------------------------------------------------------------

@functools.lru_cache()
def _tables():
    lam = bin_centers()
    xyz = np.stack([cie_x(lam), cie_y(lam), cie_z(lam)], axis=-1)  # (60,3)
    dlam = LAMBDA_RANGE / N_SPECTRAL_SAMPLES
    # spectrum (radiance per bin) → XYZ:  sum_i s_i * xyzbar_i * dlam / intY
    spec_to_xyz = xyz.T * dlam / CIE_Y_INTEGRAL                    # (3,60)
    spec_to_rgb = _XYZ_TO_RGB @ spec_to_xyz                        # (3,60)

    # RGB→spectrum basis: minimize ||D b||^2 s.t. spec_to_rgb @ b = e_k.
    n = N_SPECTRAL_SAMPLES
    D = (np.eye(n) - np.eye(n, k=1))[:-1]          # first differences
    K = np.linalg.inv(D.T @ D + 1e-4 * np.eye(n))  # smoothness kernel
    M = spec_to_rgb
    B = K @ M.T @ np.linalg.inv(M @ K @ M.T)       # (60,3), M @ B = I3
    return (lam.astype(np.float32), spec_to_rgb.astype(np.float32),
            B.astype(np.float32))


def spectrum_to_rgb(spec: Array) -> Array:
    """(..., 60) sampled spectrum → (..., 3) linear RGB."""
    _, s2r, _ = _tables()
    return _mm(spec, jnp.asarray(s2r.T))


def spectrum_to_xyz(spec: Array) -> Array:
    lam = jnp.asarray(_tables()[0])
    xyz = cie_xyz(lam)  # (60,3)
    dlam = LAMBDA_RANGE / N_SPECTRAL_SAMPLES
    return _mm(spec, xyz) * (dlam / CIE_Y_INTEGRAL)


def rgb_to_spectrum(rgb: Array) -> Array:
    """(..., 3) linear RGB → (..., 60) smooth spectrum, exact round trip."""
    _, _, B = _tables()
    return _mm(rgb, jnp.asarray(B.T))


def to_rgb(spec: Array, cfg: SpectrumConfig) -> Array:
    return spec if cfg.mode == "rgb" else spectrum_to_rgb(spec)


def from_rgb(rgb: Array, cfg: SpectrumConfig) -> Array:
    return rgb if cfg.mode == "rgb" else rgb_to_spectrum(rgb)


def luminance(spec: Array, cfg: SpectrumConfig = RGB) -> Array:
    """Spectrum::y() — photometric luminance."""
    if cfg.mode == "rgb":
        w = jnp.asarray([0.212671, 0.715160, 0.072169], spec.dtype)
        return _mm(spec, w)
    return spectrum_to_xyz(spec)[..., 1]


# ---------------------------------------------------------------------------
# SPD resampling (spectrum.cpp FromSampled) — host-side scene building
# ---------------------------------------------------------------------------

def spd_from_pairs(lambdas, values, cfg: SpectrumConfig) -> np.ndarray:
    """Piecewise-linear SPD given as (λ, v) pairs → spectrum of cfg's shape.

    Host-side (numpy) — used by the parser for "spectrum L" parameters
    (e.g. scenes/cornell_dielectric.pbrt).
    """
    lambdas = np.asarray(lambdas, np.float64)
    values = np.asarray(values, np.float64)
    order = np.argsort(lambdas)
    lambdas, values = lambdas[order], values[order]
    lam = bin_centers()
    samp = np.interp(lam, lambdas, values)
    if cfg.mode == "sampled":
        return samp.astype(np.float32)
    xyz = np.stack([cie_x(lam), cie_y(lam), cie_z(lam)], axis=-1)
    dlam = LAMBDA_RANGE / N_SPECTRAL_SAMPLES
    XYZ = (samp[:, None] * xyz).sum(0) * dlam / CIE_Y_INTEGRAL
    return (_XYZ_TO_RGB @ XYZ).astype(np.float32)


def blackbody(lambda_nm, temperature):
    """Planck's law, W/(m^2 sr nm) up to scale (spectrum.cpp Blackbody)."""
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    l_m = lambda_nm * 1e-9
    return (2.0 * h * c * c) / (
        l_m ** 5 * (jnp.exp(h * c / (l_m * kb * temperature)) - 1.0))


def blackbody_normalized(lambda_nm, temperature):
    l_max = 2.8977721e-3 / temperature * 1e9
    return blackbody(lambda_nm, temperature) / blackbody(l_max, temperature)


# ---------------------------------------------------------------------------
# HWSS support (fork): bin indexing, wavelength sampling (distr.h:85-112)
# ---------------------------------------------------------------------------

def index_from_wavelength(wvl: Array) -> Array:
    """spectrum.h:291-294 indexFromWavelength."""
    idx = ((wvl - LAMBDA_START)
           * (N_SPECTRAL_SAMPLES / LAMBDA_RANGE)).astype(jnp.int32)
    return jnp.clip(idx, 0, N_SPECTRAL_SAMPLES - 1)


def zero_all_bins_but(spec: Array, idx: Array) -> Array:
    """spectrum.h:287-289 zeroAllBinsBut, batched over leading dims."""
    chan = jnp.arange(spec.shape[-1])
    return jnp.where(chan == idx[..., None], spec, 0.0)


def make_spectral_distribution(spec: Array) -> Distribution1D:
    """distr.h SpectralDistribution: CDF over the 60 bins of ``spec``."""
    return make_distribution_1d(jnp.maximum(spec, 0.0))


def sample_wavelength(d: Distribution1D, u: Array):
    """distr.h:91-112 sampleWavelength: continuous λ + per-bin pdf.

    Returns (λ in nm, bin pdf) — the reference's Pdf is the *discrete* bin
    probability (hero_path_mis.cpp uses spectralDistribution.Pdf(idx)).
    """
    x, pdf_cont, off = sample_distribution_1d_continuous(d, u)
    lam = LAMBDA_START + LAMBDA_RANGE * x
    # discrete bin probability = func[off]/ (func_int * n)
    f = d.func[off] if d.func.ndim == 1 else \
        jnp.take_along_axis(d.func, off[..., None], axis=-1)[..., 0]
    func_int = jnp.where(d.func_int > 0, d.func_int, 1.0)
    pmf = f / (func_int * d.n)
    pmf = jnp.where(d.func_int > 0, pmf, 1.0 / d.n)
    return lam, pmf


def spectral_distribution_pmf(d: Distribution1D, idx: Array) -> Array:
    f = d.func[idx] if d.func.ndim == 1 else \
        jnp.take_along_axis(d.func, idx[..., None], axis=-1)[..., 0]
    func_int = jnp.where(d.func_int > 0, d.func_int, 1.0)
    pmf = f / (func_int * d.n)
    return jnp.where(d.func_int > 0, pmf, 1.0 / d.n)


def rotate_sample(u: Array, i, n=4):
    """West et al. 2020 rotation trick (hero.cpp:46-48): (u + i/n) mod 1."""
    return jnp.mod(u + i / n, 1.0)
