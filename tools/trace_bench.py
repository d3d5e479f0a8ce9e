"""Where the bench step's device time goes, on one GPU.

    python tools/trace_bench.py [--reps 3] [--out chiprun_out/trace_bench]
    python tools/trace_bench.py --render-chunk 30

Traces `reps` full 64-spp fwd+bwd runs of bench.py's step (after two
warm-up runs) on two paths: the fused path kernel (the bench scene) and
_li_loop (the same scene without its fused profile, on the same rays).
For each path it prints one JSON line: the host window, the device's busy
time (union of the kernel intervals on the GPU stream lines), the idle
share of the window, and the ops with the most device time. The traces
stay under --out for TensorBoard or Perfetto.

With --render-chunk N it also times render() on the bench scene (256²,
64 spp, forward only) at render()'s own spp chunking and at chunk_spp=N:
the first call of each (compiles included), then the median of 5 warm
calls, taken in turns.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _union_ns(intervals) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0)


def device_breakdown(xplane_path, top=12) -> dict:
    """Busy time and per-op device time from a jax.profiler trace."""
    import jax
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    per_op, spans = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for ev in line.events:
                per_op[ev.name] = per_op.get(ev.name, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.end_ns))
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {"device_busy_ms": _union_ns(spans) / 1e6,
            "top_ops_ms": [[name[:90], ns / 1e6] for name, ns in ops]}


def trace_paths(reps, out_dir):
    import jax

    import bench
    scene, cam, filt, cfg = bench.setup()
    kd, emit = scene.materials.kd, scene.lights.emit
    plain = dc.replace(scene, fused_profile=None)
    for name, s in (("kernel", scene), ("li_loop", plain)):
        step = bench.make_step(s, cam, filt, cfg, bench.RES, bench.CHUNK)
        bench.time_fwdbwd(step, kd, emit, reps=2)
        tdir = os.path.join(out_dir, name)
        with jax.profiler.trace(tdir):
            t0 = time.perf_counter()
            bench.time_fwdbwd(step, kd, emit, reps=reps)
            wall = time.perf_counter() - t0
        pb = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                       recursive=True)[0]
        res = {"path": name, "fwdbwd_runs": reps,
               "passes": reps * bench.SPP // bench.CHUNK,
               "window_ms": wall * 1e3, **device_breakdown(pb)}
        res["idle_share"] = 1.0 - res["device_busy_ms"] / res["window_ms"]
        print(json.dumps(res), flush=True)


def time_render_chunks(chunk_spp, reps=5):
    import jax
    import numpy as np

    import __graft_entry__ as ge
    import bench
    from pbrt_tpu.integrators.render import render
    scene = ge._portal_scene()
    cam = ge._camera((bench.RES, bench.RES))
    runs = {"default": None, f"chunk_spp={chunk_spp}": chunk_spp}

    def call(c):
        t0 = time.perf_counter()
        jax.block_until_ready(render(scene, cam, spp=bench.SPP,
                                     max_depth=bench.MAX_DEPTH, chunk_spp=c))
        return time.perf_counter() - t0

    out = {k: {"first_call_s": call(c), "warm_s": []}
           for k, c in runs.items()}
    for _ in range(reps):
        for k, c in runs.items():
            out[k]["warm_s"].append(call(c))
    for v in out.values():
        v["warm_median_s"] = float(np.median(v["warm_s"]))
    print(json.dumps({"render_chunks": out}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/trace_bench")
    ap.add_argument("--render-chunk", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    import bench
    from pbrt_tpu.utils import compile_cache
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"trace_bench.py traces the GPU; JAX found "
                 f"{jax.devices()[0].platform}")
    compile_cache.enable()
    print(f"card: {bench.card_info()}", flush=True)
    trace_paths(args.reps, args.out)
    if args.render_chunk:
        time_render_chunks(args.render_chunk)


if __name__ == "__main__":
    main()
