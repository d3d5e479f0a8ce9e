"""bsdftest: numerical BSDF sampling/pdf consistency checker.

The framework's counterpart of ``src/tools/bsdftest.cpp`` (440 LoC):
for each material type it (1) estimates hemispherical-directional
reflectance rho by BSDF importance sampling E[f·|cos|/pdf], (2) checks the
pdf integrates to ≤1 over the sphere by uniform MC, and (3) cross-checks
sample-returned (f, pdf) against re-evaluation — the same three diagnostics
bsdftest.cpp prints per BxDF.

Usage: ``python -m pbrt_tpu.tools.bsdftest [N]``
"""

from __future__ import annotations

import math
import sys


def run(n=200_000, out=sys.stdout):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pbrt_tpu.scene import materials as mat

    cases = [
        ("matte", dict(type=mat.MATTE, kd=0.7)),
        ("oren-nayar", dict(type=mat.MATTE, kd=0.7, sigma=20.0)),
        ("plastic", dict(type=mat.PLASTIC, kd=0.4, ks=0.3, roughness=0.1)),
        ("metal", dict(type=mat.METAL, roughness=0.05)),
        ("substrate", dict(type=mat.SUBSTRATE, kd=0.4, ks=0.2,
                           roughness=0.1)),
        ("translucent", dict(type=mat.TRANSLUCENT, kd=0.3, kt=0.3)),
        ("rough-glass", dict(type=mat.GLASS, roughness=0.2, eta=1.5)),
        ("disney", dict(type=mat.DISNEY, kd=0.5, metallic=0.3,
                        roughness=0.3)),
        ("hair", dict(type=mat.HAIR, sss_sigma_a=(0.1, 0.2, 0.3),
                      beta_m=0.3, beta_n=0.3, hair_alpha=2.0, eta=1.55)),
    ]
    rs = np.random.RandomState(0)
    wo = np.asarray([0.3, 0.4, 0.866])
    wo = wo / np.linalg.norm(wo)
    out.write(f"{'material':<12} {'rho_is':>8} {'pdf_int':>8} "
              f"{'f_match':>8} {'pdf_match':>9}\n")
    failures = 0
    for name, row in cases:
        tbl = mat.make_material_table([row], 3)
        mp = mat.gather_materials(tbl, jnp.zeros(n, jnp.int32))
        wob = jnp.broadcast_to(jnp.asarray(wo, jnp.float32), (n, 3))
        hh = jnp.zeros(n) if name == "hair" else None
        ul = jnp.asarray(rs.rand(n), jnp.float32)
        uu = jnp.asarray(rs.rand(n, 2), jnp.float32)
        wi, f, pdf, _ = mat.bsdf_sample(mp, wob, ul, uu, h=hh)
        ok = pdf > 1e-9
        rho = np.asarray(jnp.where(
            ok[:, None], f * jnp.abs(wi[:, 2:3])
            / jnp.maximum(pdf, 1e-9)[:, None], 0.0).mean(0))
        # uniform-sphere pdf integral
        z = 1 - 2 * rs.rand(n)
        phi = 2 * math.pi * rs.rand(n)
        s = np.sqrt(np.maximum(0, 1 - z * z))
        wiu = jnp.asarray(np.stack([s * np.cos(phi), s * np.sin(phi), z],
                                   -1), jnp.float32)
        pdf_int = float((mat.bsdf_pdf(mp, wob, wiu, h=hh)
                         * 4 * math.pi).mean())
        # sample↔eval cross-check (delta lobes excluded by pdf mask)
        fe = mat.bsdf_f(mp, wob, wi, h=hh)
        pe = mat.bsdf_pdf(mp, wob, wi, h=hh)
        f_match = float(jnp.where(ok[:, None], jnp.abs(fe - f), 0.0).max())
        p_match = float(jnp.where(ok, jnp.abs(pe - pdf), 0.0).max())
        bad = (rho.max() > 1.02) or not (0.0 <= pdf_int <= 1.05)
        failures += bad
        out.write(f"{name:<12} {rho.mean():8.4f} {pdf_int:8.4f} "
                  f"{f_match:8.2e} {p_match:9.2e}"
                  + ("  FAIL\n" if bad else "\n"))
    return failures


def main(argv=None):
    # diagnostics are tiny eager batches: run on the host CPU, where each
    # eager op costs no device launch
    import jax
    jax.config.update("jax_platforms", "cpu")
    args = argv if argv is not None else sys.argv[1:]
    n = int(args[0]) if args else 200_000
    return 1 if run(n) else 0


if __name__ == "__main__":
    sys.exit(main())
