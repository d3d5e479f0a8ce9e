"""CLI entry point: ``python -m pbrt_tpu.utils.cli scene.pbrt [options]``.

JAX counterpart of ``src/main/pbrt.cpp`` (main():76-173 with
--outfile/--quick/--quiet flags; --nthreads becomes the device mesh, which
JAX sizes automatically).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pbrt_tpu", description="JAX-native pbrt-style renderer")
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("--outfile", "-o", default=None,
                    help="override output image path")
    ap.add_argument("--quick", action="store_true",
                    help="quarter sample count (pbrt --quick)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--integrator", default=None)
    ap.add_argument("--spectral", action="store_true",
                    help="use 60-bin sampled spectra (hero integrators)")
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU backend")
    ap.add_argument("--cat", action="store_true",
                    help="print a reformatted version of the scene to "
                         "stdout and exit (pbrt --cat)")
    ap.add_argument("--toply", action="store_true",
                    help="like --cat, but triangle meshes with >=500 "
                         "indices are written as PLY sidecar files "
                         "(pbrt --toply; PLY_PREFIX env overrides the "
                         "'mesh' filename prefix)")
    ap.add_argument("--cropwindow", type=float, nargs=4, default=None,
                    metavar=("X0", "X1", "Y0", "Y1"),
                    help="render a sub-window (NDC fractions, pbrt "
                         "--cropwindow)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="numeric sanitizer: enable jax_debug_nans so the "
                         "first NaN/Inf produced on device raises with a "
                         "traceback into the originating primitive (the "
                         "renderer's release path instead CLAMPS non-finite "
                         "radiance and counts it in --stats). Role of "
                         "pbrt's debug-build FP assertions.")
    args = ap.parse_args(argv)

    if args.cat or args.toply:
        from pbrt_tpu.frontend.catply import reformat
        reformat(args.scene, to_ply=args.toply)
        return 0

    import jax

    from pbrt_tpu.utils import compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    compile_cache.enable()

    import numpy as np

    from pbrt_tpu.core import spectrum as spec_mod
    from pbrt_tpu.frontend import load_pbrt
    from pbrt_tpu.integrators import render
    from pbrt_tpu.utils import imageio

    from pbrt_tpu.utils import stats as stats_mod

    cfg = spec_mod.SAMPLED if args.spectral else spec_mod.RGB
    if not args.quiet:
        print(f"pbrt_tpu: parsing {args.scene}", file=sys.stderr)
    # phase attribution (ProfilePhase / hierarchical report,
    # core/stats.h:142-195 + PrintStats): host-level phases here; on-chip
    # op attribution via stats_mod.jax_trace when profiling
    with stats_mod.profile_phase("Scene parsing and creation"):
        scene, cam, opts = load_pbrt(args.scene, spectrum_cfg=cfg)

    integrator = args.integrator or opts["integrator"]
    if integrator in ("hero_path", "hero_path_mis") and cfg.mode != \
            "sampled":
        scene, cam, opts = load_pbrt(args.scene,
                                     spectrum_cfg=spec_mod.SAMPLED)
    spp = args.spp or opts["spp"]
    if args.quick:
        spp = max(1, spp // 4)
    fname = args.outfile or opts["film"]["filename"]

    if not args.quiet:
        res = np.asarray(cam.resolution)
        print(f"pbrt_tpu: rendering {res[0]}x{res[1]} @ {spp}spp "
              f"({integrator}, sampler {opts['sampler']})", file=sys.stderr)
    t0 = time.time()
    filt_name, filt_kwargs = opts.get("filter", ("box", {}))
    crop = args.cropwindow or opts["film"].get("crop")
    with stats_mod.profile_phase("Integrator rendering"):
        img = render(scene, cam, spp=spp, integrator=integrator,
                     sampler=opts["sampler"], max_depth=opts["max_depth"],
                     filter_name=filt_name, filter_kwargs=filt_kwargs,
                     crop_window=crop,
                     integrator_params=opts.get("integrator_params"))
        img = np.asarray(img)
    if img.shape[-1] != 3:
        img = np.asarray(spec_mod.spectrum_to_rgb(img))
    if not args.quiet:
        print(f"pbrt_tpu: rendered in {time.time() - t0:.1f}s "
              f"(mean {img.mean():.4f})", file=sys.stderr)
    with stats_mod.profile_phase("Film write"):
        imageio.write_image(fname, img)
    if not args.quiet:
        print(f"pbrt_tpu: wrote {fname}", file=sys.stderr)
        stats_mod.counter_add("Camera rays traced",
                              int(np.prod(np.asarray(img.shape[:2]))) * spp)
        stats_mod.print_stats()


if __name__ == "__main__":
    main()
