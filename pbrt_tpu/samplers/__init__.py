"""Samplers: independent, stratified, Halton, Sobol (0,2)-sequence.

JAX counterpart of ``src/samplers/`` + core/sampler.h:50-128 and the
low-discrepancy machinery of core/lowdiscrepancy.h:50-229. pbrt samplers are
stateful objects walking a dimension counter; here a sampler is a *pure
function* ``u = sample(pixel_id, sample_idx, dim)`` — any ray can evaluate
any dimension independently (shard-invariant, resumable).

When ``make_sampler`` is given the image resolution, ``halton`` and ``sobol``
reproduce pbrt's *GlobalSampler* pixel-enumeration semantics exactly
(samplers/halton.cpp GetIndexForSample / SampleDimension;
lowdiscrepancy.h:229 SobolIntervalToIndex): one global low-discrepancy
sequence tiles the image, each pixel pulls the subsequence landing inside it,
dims 0/1 are the within-pixel offsets and dims >=2 share the pixel's global
index.  Halton dims >=2 use per-dimension random digit permutations
(ScrambledRadicalInverse, lowdiscrepancy.cpp:407); global Sobol is
unscrambled, per the reference.  Without a resolution the older
distribution-level stand-ins remain (Cranley–Patterson-rotated Halton,
per-pixel Owen-scrambled (0,2)).  ``zerotwosequence`` stays the per-pixel
Owen-scrambled (0,2) pair — that is the reference's PixelSampler class.
``maxmindist`` uses the reference's CMaxMinDist generator matrices
(constant published search tables, see samplers/maxmindist.py) for the
first sample pair — x_i = i/spp, y_i = C·i over GF(2), order-shuffled per
pixel (samplers/maxmin.cpp StartPixel) — and the scrambled (0,2) pair for
all later dimensions, exactly the reference's dimension split.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu.core import rng as rng_mod
from pbrt_tpu.samplers.maxmindist import CMAXMIN
from pbrt_tpu.samplers.sobolmatrices import N_SOBOL_DIMS, SOBOL_MATRICES

Array = Any

_PRIMES = np.array([2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47,
                    53, 59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107,
                    109, 113, 127, 131, 137, 139, 149, 151, 157, 163, 167,
                    173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229,
                    233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283,
                    293, 307, 311, 313, 317], np.int32)
_N_PRIMES = len(_PRIMES)
# digits needed so that base^digits >= 2^32
_MAX_DIGITS = np.ceil(32.0 / np.log2(_PRIMES.astype(np.float64))).astype(
    np.int32)


def radical_inverse(base_idx: Array, a: Array) -> Array:
    """RadicalInverse (lowdiscrepancy.h:78-96): a in base prime[base_idx],
    digits mirrored. base_idx: (R,) int32; a: (R,) uint32/int64."""
    base = jnp.asarray(_PRIMES)[jnp.clip(base_idx, 0, _N_PRIMES - 1)]
    basef = base.astype(jnp.float32)
    inv_base = 1.0 / basef

    def body(_, carry):
        a_cur, inv_bn, rev = carry
        next_a = a_cur // base
        digit = a_cur - next_a * base
        rev = rev + digit.astype(jnp.float32) * inv_bn
        return next_a, inv_bn * inv_base, rev

    base = base.astype(jnp.uint32)
    a0 = a.astype(jnp.uint32)
    _, _, rev = jax.lax.fori_loop(
        0, 21, body, (a0, inv_base, jnp.zeros_like(inv_base)))
    return jnp.minimum(rev, rng_mod.ONE_MINUS_EPS)


def _sobol_matrices():
    """Generator matrices for the first two Sobol' dimensions (the classic
    (0,2)-sequence pair; lowdiscrepancy.h SobolSample* / sobolmatrices.cpp
    dims 0-1). Dim 0: identity (van der Corput); dim 1: Pascal-mod-2.
    Kept as numpy at module scope — device placement happens lazily so the
    import never initializes a JAX backend."""
    m0 = np.array([1 << (31 - i) for i in range(32)], np.uint32)
    m1 = np.zeros(32, np.uint32)
    v = np.uint32(1 << 31)
    for i in range(32):
        m1[i] = v
        v ^= v >> 1
    return m0, m1


_SM0, _SM1 = _sobol_matrices()


def _sobol_bits(a: Array, matrix: Array) -> Array:
    """Multiply index bits by a 32x32 GF(2) generator matrix."""
    a = a.astype(jnp.uint32)

    matrix = jnp.asarray(matrix)

    def body(i, acc):
        bit = (a >> i) & jnp.uint32(1)
        return acc ^ (matrix[i] * bit)

    return jax.lax.fori_loop(0, 32, body, jnp.zeros_like(a))


def _owen_hash_scramble(bits: Array, seed: Array) -> Array:
    """Laine–Karras style hash-based Owen scrambling on reversed bits."""
    v = _reverse_bits(bits)
    v = v + seed
    v = v ^ (v * jnp.uint32(0x6c50b47c))
    v = v ^ (v * jnp.uint32(0xb82f1e52))
    v = v ^ (v * jnp.uint32(0xc7afe638))
    v = v ^ (v * jnp.uint32(0x8d22f6e6))
    return _reverse_bits(v)


def _reverse_bits(v: Array) -> Array:
    v = ((v >> 1) & jnp.uint32(0x55555555)) | ((v & jnp.uint32(0x55555555))
                                               << 1)
    v = ((v >> 2) & jnp.uint32(0x33333333)) | ((v & jnp.uint32(0x33333333))
                                               << 2)
    v = ((v >> 4) & jnp.uint32(0x0F0F0F0F)) | ((v & jnp.uint32(0x0F0F0F0F))
                                               << 4)
    v = ((v >> 8) & jnp.uint32(0x00FF00FF)) | ((v & jnp.uint32(0x00FF00FF))
                                               << 8)
    return (v >> 16) | (v << 16)


# ---------------------------------------------------------------------------
# GlobalSampler machinery (pbrt pixel-enumeration semantics)
# ---------------------------------------------------------------------------

_KMAX_RESOLUTION = 128  # samplers/halton.cpp:41


def _mult_inverse(a: int, n: int) -> int:
    """multiplicativeInverse (samplers/halton.cpp:45-62)."""
    return pow(a % n, -1, n)


_MAX_HALTON_DIMS = 256  # perms repeat past this (pbrt hard-errors at 1024)


def _perm_for_dim(dim: int, seed: int) -> np.ndarray:
    """Random digit permutation for prime(dim % len) — the pure-function
    analogue of ComputeRadicalInversePermutations + PermutationForDimension
    (lowdiscrepancy.cpp / halton.h:70-75). Keyed by the *dimension* (mod 256,
    not the base) so wrapped dims sharing a base stay decorrelated."""
    dim = dim % _MAX_HALTON_DIMS
    base = int(_PRIMES[dim % _N_PRIMES])
    rs = np.random.RandomState((dim * 0x9E3779B9 + seed * 0x85EBCA6B)
                               & 0x7FFFFFFF)
    return rs.permutation(base).astype(np.int32)


_PERM_TABLE_CACHE: dict = {}


def _perm_table(seed: int):
    """Flat concatenation of all 256 per-dim permutations + offsets, for
    traced-dim lookups (pbrt's radicalInversePermutations + PrimeSums
    layout, halton.h:58,73)."""
    if seed not in _PERM_TABLE_CACHE:
        perms = [_perm_for_dim(d, seed) for d in range(_MAX_HALTON_DIMS)]
        offs = np.zeros(_MAX_HALTON_DIMS, np.int32)
        acc = 0
        for d, p in enumerate(perms):
            offs[d] = acc
            acc += len(p)
        _PERM_TABLE_CACHE[seed] = (np.concatenate(perms).astype(np.int32),
                                   offs)
    return _PERM_TABLE_CACHE[seed]


def _scrambled_radical_inverse(dim: int, a: Array, seed: int) -> Array:
    """ScrambledRadicalInverse (lowdiscrepancy.cpp:405-424): permuted digits,
    fixed digit count covering 2^32, plus the closed-form tail for the
    infinite leading perm[0] digits."""
    base = int(_PRIMES[dim % _N_PRIMES])
    n_digits = int(_MAX_DIGITS[dim % _N_PRIMES])
    perm_np = _perm_for_dim(dim, seed)
    perm = jnp.asarray(perm_np, jnp.float32)
    inv_base = np.float32(1.0 / base)
    a = a.astype(jnp.uint32)
    val = jnp.zeros(jnp.shape(a), jnp.float32)
    inv_bn = np.float32(1.0)
    for _ in range(n_digits):
        nxt = a // base
        digit = a - nxt * base
        inv_bn = np.float32(inv_bn * inv_base)
        val = val + jnp.take(perm, digit.astype(jnp.int32)) * inv_bn
        a = nxt
    # tail: digits beyond n_digits are all 0 → perm[0] each
    tail = float(perm_np[0]) * inv_bn * inv_base / (1.0 - inv_base)
    return jnp.minimum(val + tail, rng_mod.ONE_MINUS_EPS)


def _radical_inverse_static(base: int, n_digits: int, a: Array) -> Array:
    """RadicalInverse in a static base, unrolled (lowdiscrepancy.cpp:426+)."""
    inv_base = np.float32(1.0 / base)
    a = a.astype(jnp.uint32)
    val = jnp.zeros(jnp.shape(a), jnp.float32)
    inv_bn = np.float32(1.0)
    for _ in range(n_digits):
        nxt = a // base
        digit = a - nxt * base
        inv_bn = np.float32(inv_bn * inv_base)
        val = val + digit.astype(jnp.float32) * inv_bn
        a = nxt
    return jnp.minimum(val, rng_mod.ONE_MINUS_EPS)


def _reverse_digits(v: Array, base: int, n_digits: int) -> Array:
    """InverseRadicalInverse (lowdiscrepancy.h:83-92): mirror the n_digits
    base-`base` digits of v (leading zeros included)."""
    v = v.astype(jnp.uint32)
    out = jnp.zeros(jnp.shape(v), jnp.uint32)
    for _ in range(n_digits):
        nxt = v // base
        out = out * base + (v - nxt * base)
        v = nxt
    return out


def _static_dim(dim, seed):
    try:
        return int(dim), int(seed)
    except (TypeError, jax.errors.TracerIntegerConversionError):
        return None


def _scrambled_radical_inverse_dyn(dim: Array, a: Array, seed: int) -> Array:
    """ScrambledRadicalInverse with a *traced* dimension (dims computed from
    the bounce index inside fori_loop): base and permutation come from
    gathered tables; 32 masked digit steps cover every base."""
    table, offs = _perm_table(seed)
    table = jnp.asarray(table)
    offs = jnp.asarray(offs)
    dim = jnp.asarray(dim, jnp.uint32) % _MAX_HALTON_DIMS
    base = jnp.asarray(_PRIMES, jnp.uint32)[(dim % _N_PRIMES).astype(
        jnp.int32)]
    base = jnp.broadcast_to(base, jnp.shape(a))
    off = jnp.take(offs, dim.astype(jnp.int32))
    off = jnp.broadcast_to(off, jnp.shape(a))
    inv_base = 1.0 / base.astype(jnp.float32)
    perm0 = jnp.take(table, off).astype(jnp.float32)

    def body(_, st):
        a, val, inv_bn = st
        nxt = a // base
        digit = a - nxt * base
        upd = a > 0
        inv_bn = jnp.where(upd, inv_bn * inv_base, inv_bn)
        pv = jnp.take(table, off + digit.astype(jnp.int32)).astype(
            jnp.float32)
        val = val + jnp.where(upd, pv * inv_bn, 0.0)
        return nxt, val, inv_bn

    a = jnp.asarray(a, jnp.uint32)
    _, val, inv_bn = jax.lax.fori_loop(
        0, 32, body, (a, jnp.zeros(jnp.shape(a), jnp.float32),
                      jnp.ones(jnp.shape(a), jnp.float32)))
    tail = perm0 * inv_bn * inv_base / (1.0 - inv_base)
    return jnp.minimum(val + tail, rng_mod.ONE_MINUS_EPS)


def _sobol_bits_dyn(a: Array, dim: Array) -> Array:
    """SobolSample bits with a traced dimension: gather the dim's 32-column
    generator matrix, then the GF(2) product."""
    rows = jnp.asarray(SOBOL_MATRICES)  # (D, 32)
    mat = rows[(jnp.asarray(dim, jnp.uint32) % N_SOBOL_DIMS).astype(
        jnp.int32)]  # (32,) or (R, 32)
    a = jnp.asarray(a, jnp.uint32)
    mat = jnp.broadcast_to(mat, jnp.shape(a) + (32,))

    def body(i, acc):
        return acc ^ (((a >> i) & jnp.uint32(1)) * mat[..., i])

    return jax.lax.fori_loop(0, 32, body, jnp.zeros(jnp.shape(a), jnp.uint32))


def make_halton_global(resolution, spp: int = 16) -> Callable:
    """pbrt HaltonSampler semantics (samplers/halton.cpp:64-127): one global
    Halton sequence; pixel (x,y) owns indices offset(x,y) + j*stride."""
    bs, be = [], []
    for i, base in ((0, 2), (1, 3)):
        scale, exp = 1, 0
        while scale < min(int(resolution[i]), _KMAX_RESOLUTION):
            scale *= base
            exp += 1
        bs.append(scale)
        be.append(exp)
    stride = bs[0] * bs[1]
    minv = (_mult_inverse(bs[1], bs[0]) if bs[0] > 1 else 0,
            _mult_inverse(bs[0], bs[1]) if bs[1] > 1 else 0)
    width = int(resolution[0])

    def index_for(pid: Array, sample_idx: Array) -> Array:
        pid = jnp.asarray(pid, jnp.uint32)
        px = pid % width
        py = pid // width
        dof_x = _reverse_digits(px % bs[0], 2, be[0])
        dof_y = _reverse_digits(py % bs[1], 3, be[1])
        off = (dof_x * ((stride // bs[0]) * minv[0] % stride)
               + dof_y * ((stride // bs[1]) * minv[1] % stride)) % stride
        return off + jnp.asarray(sample_idx, jnp.uint32) * stride

    def sample(pixel_id, sample_idx, dim, seed=0):
        st = _static_dim(dim, seed)
        idx = index_for(pixel_id, sample_idx)
        if st is None:
            # traced dim (bounce-indexed dims inside fori_loop) — always a
            # dim >= 2 in every integrator; seed stays static
            return _scrambled_radical_inverse_dyn(dim, idx, int(seed))
        dim, seed = st
        if dim == 0:
            return _radical_inverse_static(2, 32 - be[0], idx >> be[0])
        if dim == 1:
            return _radical_inverse_static(3, 21, idx // bs[1])
        return _scrambled_radical_inverse(dim, idx, seed)

    sample.index_for = index_for
    sample.base_scales, sample.base_exponents = tuple(bs), tuple(be)
    sample.stride = stride
    return sample


def _sobol_bits_static(a: Array, cols: np.ndarray) -> Array:
    """GF(2) matrix–vector product with a compile-time constant matrix,
    unrolled so each column is an immediate (SobolSampleFloat,
    lowdiscrepancy.h:259-267)."""
    a = a.astype(jnp.uint32)
    acc = jnp.zeros(jnp.shape(a), jnp.uint32)
    for i in range(32):
        c = np.uint32(cols[i])
        if c:
            acc = acc ^ (((a >> i) & jnp.uint32(1)) * c)
    return acc


def make_sobol_global(resolution, spp: int = 16) -> Callable:
    """pbrt SobolSampler semantics (samplers/sobol.cpp + SobolIntervalToIndex,
    lowdiscrepancy.h:229-249): the global Sobol' sequence over a power-of-2
    square covering the image; the per-(pixel, sampleNum) global index is the
    solution of a GF(2) linear system in the low 2m index bits, derived here
    per-resolution by host-side Gaussian elimination (replacing the
    reference's generated VdCSobolMatrices[Inv] tables).  Valid while
    spp << 2^(32-2m); dims 0/1 are rescaled to within-pixel offsets."""
    width, height = int(resolution[0]), int(resolution[1])
    res = 1
    m = 0
    while res < max(width, height):
        res *= 2
        m += 1
    m2 = 2 * m
    if m2 > 26:
        raise ValueError("sobol global sampler supports images up to 8192px")
    c0, c1 = SOBOL_MATRICES[0], SOBOL_MATRICES[1]

    def out_bits(j):  # constrained output bits for index bit j, packed 2m-bit
        return (((int(c0[j]) >> (32 - m)) << m)
                | (int(c1[j]) >> (32 - m))) if m else 0

    # invert the low-bits → pixel-bits map over GF(2)
    cols = [out_bits(j) for j in range(m2)]
    n_frame_bits = min(32 - m2, 24)
    frame_cols = [out_bits(m2 + c) for c in range(n_frame_bits)]
    basis = list(cols)
    inv = [1 << j for j in range(m2)]  # track index-bit combination per col
    # Gaussian elimination (column ops): reduce matrix with columns `basis`
    for bit in range(m2):
        p = next((k for k in range(bit, m2) if (basis[k] >> bit) & 1), None)
        if p is None:
            raise ValueError("Sobol pixel matrix singular (bad matrices)")
        basis[bit], basis[p] = basis[p], basis[bit]
        inv[bit], inv[p] = inv[p], inv[bit]
        for k in range(m2):
            if k != bit and (basis[k] >> bit) & 1:
                basis[k] ^= basis[bit]
                inv[k] ^= inv[bit]
    # now basis[k] == 1<<k, inv[k] = index-bit pattern producing pixel bit k
    ainv = inv

    def index_for(pid: Array, sample_idx: Array) -> Array:
        pid = jnp.asarray(pid, jnp.uint32)
        f = jnp.asarray(sample_idx, jnp.uint32)
        if m == 0:
            return f
        px = pid % width
        py = pid // width
        target = (px << m) | py
        for c in range(n_frame_bits):
            fc = np.uint32(frame_cols[c])
            if fc:
                target = target ^ (((f >> c) & jnp.uint32(1)) * fc)
        low = jnp.zeros(jnp.shape(target), jnp.uint32)
        for t in range(m2):
            at = np.uint32(ainv[t])
            if at:
                low = low ^ (((target >> t) & jnp.uint32(1)) * at)
        return (f << m2) | low

    def sample(pixel_id, sample_idx, dim, seed=0):
        st = _static_dim(dim, seed)
        idx = index_for(pixel_id, sample_idx)
        if st is None:  # traced dim — always >= 2 (no pixel rescale)
            return rng_mod.u32_to_uniform(_sobol_bits_dyn(idx, dim))
        dim, _ = st
        bits = _sobol_bits_static(idx, SOBOL_MATRICES[dim % N_SOBOL_DIMS])
        s = rng_mod.u32_to_uniform(bits)
        if dim < 2 and m > 0:
            pid = jnp.asarray(pixel_id, jnp.uint32)
            pix = (pid % width if dim == 0 else pid // width)
            s = jnp.clip(s * res - pix.astype(jnp.float32), 0.0,
                         rng_mod.ONE_MINUS_EPS)
        return s

    sample.index_for = index_for
    sample.log2_resolution = m
    return sample


def make_sampler(name: str, spp: int = 16, resolution=None) -> Callable:
    """Return sample(pixel_id, sample_idx, dim, seed) → float32 in [0,1).

    With ``resolution=(width, height)``, ``halton`` and ``sobol`` use pbrt's
    GlobalSampler pixel enumeration (see module docstring)."""
    name = name.lower()

    if name == "halton" and resolution is not None:
        return make_halton_global(resolution, spp)
    if name == "sobol" and resolution is not None:
        return make_sobol_global(resolution, spp)
    if name == "halton_cp":
        name = "halton"

    if name in ("independent", "random"):
        def sample(pixel_id, sample_idx, dim, seed=0):
            return rng_mod.uniform(pixel_id, sample_idx, dim, seed)
        return sample

    if name == "stratified":
        # jittered 1D strata over sample index, dim-decorrelated by a
        # per-(pixel,dim) random permutation of strata (samplers/stratified.cpp)
        def sample(pixel_id, sample_idx, dim, seed=0):
            j = rng_mod.uniform(pixel_id, sample_idx, dim, seed ^ 0x5bf03635)
            perm = rng_mod.hash_u32(
                jnp.asarray(pixel_id),
                jnp.broadcast_to(jnp.asarray(dim, jnp.uint32),
                                 jnp.shape(pixel_id)),
                jnp.broadcast_to(jnp.asarray(seed, jnp.uint32),
                                 jnp.shape(pixel_id)), 17)
            idx = (jnp.asarray(sample_idx, jnp.uint32) + perm) % spp
            return (idx.astype(jnp.float32) + j) / spp
        return sample

    if name == "halton":
        # scrambled-rotated Halton: radical inverse in prime(dim) +
        # per-(pixel,dim) Cranley–Patterson rotation (replaces pbrt's
        # pixel-tiling enumeration, samplers/halton.cpp — same
        # distribution-level stratification guarantees)
        def sample(pixel_id, sample_idx, dim, seed=0):
            d = jnp.broadcast_to(jnp.asarray(dim, jnp.int32),
                                 jnp.shape(pixel_id))
            ri = radical_inverse(d % _N_PRIMES,
                                 jnp.asarray(sample_idx, jnp.uint32)
                                 * jnp.ones_like(d, jnp.uint32))
            rot = rng_mod.uniform(pixel_id, 0, dim, seed ^ 0x9e3779b9)
            return jnp.mod(ri + rot, 1.0)
        return sample

    if name == "maxmindist":
        # MaxMinDistSampler (samplers/maxmin.{h,cpp}): the first 2D pair is
        # the max-min-distance construction x_i = i/spp,
        # y_i = CMaxMinDist[log2 spp]·i over GF(2) (same point set at every
        # pixel, per the reference), order-shuffled per pixel (the Shuffle
        # in StartPixel → a stateless invertible bit-mix keyed by pixel);
        # all later dims fall back to the scrambled (0,2) pair, matching
        # the reference's VanDerCorput/Sobol2D split.
        k = max(0, min(16, (max(int(spp), 1) - 1).bit_length()))
        n = 1 << k
        cpix = CMAXMIN[k]
        zt = make_sampler("zerotwosequence", spp=spp)

        def _pixel_shuffle(idx, pixel_id, seed):
            """Invertible mix on the low k index bits, keyed per pixel
            (each step — masked odd multiply, xor-const, xor-shift — is a
            bijection on [0, 2^k))."""
            if k == 0:
                return jnp.zeros_like(idx)
            mask = jnp.uint32(n - 1)
            key = rng_mod.hash_u32(jnp.asarray(pixel_id, jnp.uint32),
                                   jnp.asarray(seed, jnp.uint32),
                                   jnp.uint32(0x6d2d), 11)
            i = idx & mask
            i = (i ^ key) & mask
            i = (i * jnp.uint32(0x9E3779B9 | 1)) & mask
            i = i ^ (i >> max(1, k // 2))
            i = (i ^ (key >> 16)) & mask
            i = (i * jnp.uint32(0x85EBCA6B | 1)) & mask
            return i & mask

        def sample(pixel_id, sample_idx, dim, seed=0):
            st = _static_dim(dim, seed)
            if st is None or st[0] >= 2:
                return zt(pixel_id, sample_idx, dim, seed)
            dim, seed = st
            a = jnp.broadcast_to(jnp.asarray(sample_idx, jnp.uint32),
                                 jnp.shape(pixel_id))
            i = _pixel_shuffle(a, pixel_id, seed)
            if dim == 0:
                return jnp.minimum(i.astype(jnp.float32) / n,
                                   rng_mod.ONE_MINUS_EPS)
            bits = _sobol_bits_static(i, cpix)
            return rng_mod.u32_to_uniform(bits)

        return sample

    if name in ("sobol", "zerotwosequence", "lowdiscrepancy", "02sequence"):
        # Owen-scrambled Sobol' pair for even/odd dims; dim-pairs are
        # decorrelated by the per-(pixel, dim-pair) Owen scramble seed
        # below (the padding role of pbrt's per-pair Shuffle,
        # samplers/zerotwosequence.cpp)
        def sample(pixel_id, sample_idx, dim, seed=0):
            a = jnp.broadcast_to(jnp.asarray(sample_idx, jnp.uint32),
                                 jnp.shape(pixel_id))
            dimv = jnp.broadcast_to(jnp.asarray(dim, jnp.uint32),
                                    jnp.shape(pixel_id))
            pair = dimv >> 1
            use_m1 = (dimv & 1).astype(bool)
            bits0 = _sobol_bits(a, _SM0)
            bits1 = _sobol_bits(a, _SM1)
            bits = jnp.where(use_m1, bits1, bits0)
            sseed = rng_mod.hash_u32(jnp.asarray(pixel_id), pair,
                                     jnp.asarray(seed, jnp.uint32), 29)
            bits = _owen_hash_scramble(bits, sseed)
            return rng_mod.u32_to_uniform(bits)
        return sample

    raise ValueError(f"unknown sampler {name!r}")
