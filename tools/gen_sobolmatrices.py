"""Generate Sobol' generator matrices → pbrt_tpu/samplers/sobolmatrices.py.

JAX counterpart of the reference's generated tables
(src/core/sobolmatrices.{h,cpp}, 27 kLoC): direction numbers for the first
N_DIMS Sobol' dimensions, 32 output bits each, packed MSB-first as uint32
columns (column i is XORed into the output when bit i of the sample index is
set — same convention as SobolSampleFloat, src/core/lowdiscrepancy.h:259-267).

Construction (Bratley–Fox):
 - dim 0: van der Corput (identity matrix → bit-reversal).
 - dim d>=1: primitive polynomial p(x) of degree s over GF(2) with initial
   direction numbers m_1..m_s (odd, m_i < 2^i), extended by the recurrence
     m_k = 2^1 a_1 m_{k-1} ^ ... ^ 2^{s-1} a_{s-1} m_{k-s+1}
           ^ 2^s m_{k-s} ^ m_{k-s}
   and v_i = m_i << (32 - i).

Primitive polynomials are enumerated in increasing degree / lexical order and
verified directly (x generates the multiplicative group of GF(2^s)); initial
m_i come from a deterministic PCG-style hash (valid for any odd choice; the
reference uses the Joe–Kuo optimized values, ours differ in the free choices
but generate the same class of (t,s)-sequences — dims 0,1 are the canonical
(0,2)-pair either way).

Run:  python tools/gen_sobolmatrices.py
"""

import numpy as np

N_DIMS = 128
N_BITS = 32


def polmul2(a, b):
    """Multiply polynomials over GF(2) (ints as coefficient bitmasks)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        b >>= 1
    return r


def polmod2(a, m):
    dm = m.bit_length() - 1
    while a.bit_length() - 1 >= dm:
        a ^= m << (a.bit_length() - 1 - dm)
    return a


def polpowmod2(base, e, m):
    r = 1
    base = polmod2(base, m)
    while e:
        if e & 1:
            r = polmod2(polmul2(r, base), m)
        base = polmod2(polmul2(base, base), m)
        e >>= 1
    return r


def prime_factors(n):
    fs, d = set(), 2
    while d * d <= n:
        while n % d == 0:
            fs.add(d)
            n //= d
        d += 1
    if n > 1:
        fs.add(n)
    return fs


def is_primitive(poly, s):
    """poly (bitmask, degree s, constant term set) primitive over GF(2)?"""
    if not (poly & 1) or poly.bit_length() - 1 != s:
        return False
    order = (1 << s) - 1
    if polpowmod2(2, order, poly) != 1:  # x^order must be 1
        return False
    for q in prime_factors(order):
        if polpowmod2(2, order // q, poly) == 1:
            return False
    return True


def primitive_polys(n):
    """First n primitive polynomials, ascending degree then value."""
    out, s = [], 1
    while len(out) < n:
        for interior in range(1 << max(0, s - 1)):
            poly = (1 << s) | (interior << 1) | 1
            if is_primitive(poly, s):
                out.append((s, interior))
                if len(out) == n:
                    break
        s += 1
    return out


def hash32(x):
    x = np.uint64(x)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return int(x ^ (x >> np.uint64(31))) & 0xFFFFFFFF


def direction_numbers(dim, s, interior):
    """32 direction numbers v_i (uint32, MSB-first fractional bits)."""
    m = [0] * (N_BITS + 1)  # 1-indexed
    for i in range(1, s + 1):
        # deterministic odd m_i < 2^i
        m[i] = (hash32(dim * 97 + i) % (1 << i)) | 1
    for k in range(s + 1, N_BITS + 1):
        acc = m[k - s] ^ (m[k - s] << s)
        for j in range(1, s):
            if (interior >> (j - 1)) & 1:
                acc ^= m[k - j] << j
        m[k] = acc
    return [(m[i] << (N_BITS - i)) & 0xFFFFFFFF for i in range(1, N_BITS + 1)]


def main():
    mats = np.zeros((N_DIMS, N_BITS), np.uint32)
    mats[0] = [1 << (N_BITS - 1 - i) for i in range(N_BITS)]  # van der Corput
    polys = primitive_polys(N_DIMS - 1)
    for d in range(1, N_DIMS):
        s, interior = polys[d - 1]
        mats[d] = direction_numbers(d, s, interior)
    # dim 1 must be the canonical Pascal (0,2)-pair partner: degree-1 poly
    # x+1 with m_1=1 gives it regardless of the hash — force m_1=1 branch.
    m = [0] * (N_BITS + 1)
    m[1] = 1
    for k in range(2, N_BITS + 1):
        m[k] = m[k - 1] ^ (m[k - 1] << 1)
    mats[1] = [(m[i] << (N_BITS - i)) & 0xFFFFFFFF for i in range(1, N_BITS + 1)]

    lines = [
        '"""Generated Sobol\' direction numbers — do not edit.',
        "",
        "Produced by tools/gen_sobolmatrices.py (see there for construction &",
        "reference citations). SOBOL_MATRICES[d][i] is XORed into the output",
        "when bit i of the sample index is set.",
        '"""',
        "",
        "import numpy as np",
        "",
        f"N_SOBOL_DIMS = {N_DIMS}",
        "",
        "SOBOL_MATRICES = np.array([",
    ]
    for d in range(N_DIMS):
        row = ", ".join(f"0x{v:08x}" for v in mats[d])
        lines.append(f"    [{row}],")
    lines.append("], dtype=np.uint32)")
    lines.append("")
    out = "/root/repo/pbrt_tpu/samplers/sobolmatrices.py"
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}: {N_DIMS} dims x {N_BITS} bits")


if __name__ == "__main__":
    main()
