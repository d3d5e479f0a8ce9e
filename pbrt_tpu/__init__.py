"""pbrt_tpu — a JAX-native, differentiable physically-based renderer.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
Jorgeromeu/pbrt-v3-light-portals (pbrt-v3 + light portals + hero-wavelength
spectral sampling).  Not a port: the reference's virtual-dispatch object graph
becomes data-oriented SoA pytrees, its recursive integrators become wavefront
loops under ``jax.jit``, its pthread tile pool becomes ``shard_map`` over a
``jax.sharding.Mesh``, and its mutex film merge becomes ``psum``.

Reference layer map: /root/reference (see SURVEY.md).
"""

__version__ = "0.1.0"

from pbrt_tpu.core import vecmath, sampling, spectrum, rng  # noqa: F401
