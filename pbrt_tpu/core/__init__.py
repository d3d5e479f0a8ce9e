"""Foundation layer (L0/L1): math, RNG, sampling, spectra.

JAX equivalent of the reference's ``src/core/`` foundation
(geometry.h, rng.h, sampling.h, spectrum.h, distr.h) — everything is
vectorized over a batch axis and jit/vmap/grad-compatible.
"""
