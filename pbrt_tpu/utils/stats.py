"""Statistics & profiling.

JAX counterpart of ``core/stats.{h,cpp}``: the STAT_* macro registry
(stats.h:54-356) becomes a dict of named counters carried as reduced device
arrays; the SIGPROF sampling profiler (stats.cpp:207-239) maps to
``jax.profiler`` traces (phase attribution comes from XLA op names, which
carry our function names).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax
import numpy as np

_COUNTERS: dict = defaultdict(float)
_DISTRIBUTIONS: dict = defaultdict(list)
_PHASE_TIMES: dict = defaultdict(float)


def counter_add(name: str, value=1):
    """STAT_COUNTER accumulation (host-side; device-side counters should be
    returned from jitted fns as arrays and fed here)."""
    _COUNTERS[name] += float(np.asarray(value))


def report_value(name: str, value):
    """STAT_INT_DISTRIBUTION / STAT_FLOAT_DISTRIBUTION analogue."""
    _DISTRIBUTIONS[name].append(float(np.asarray(value)))


@contextlib.contextmanager
def profile_phase(name: str):
    """ProfilePhase RAII analogue (stats.h:142-195): wall-time attribution
    per phase; nest freely."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _PHASE_TIMES[name] += time.perf_counter() - t0


@contextlib.contextmanager
def jax_trace(log_dir: str):
    """Capture an xplane trace viewable in TensorBoard/XProf (the sampling
    profiler's successor)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def print_stats(file=None):
    """PrintStats (stats.cpp) analogue."""
    import sys
    f = file or sys.stderr
    if _COUNTERS:
        print("Statistics:", file=f)
        for k in sorted(_COUNTERS):
            print(f"    {k:<50} {_COUNTERS[k]:,.0f}", file=f)
    for k in sorted(_DISTRIBUTIONS):
        v = np.asarray(_DISTRIBUTIONS[k])
        print(f"    {k:<50} avg {v.mean():.3f} "
              f"(min {v.min():.3f}, max {v.max():.3f})", file=f)
    if _PHASE_TIMES:
        total = sum(_PHASE_TIMES.values())
        print("  Profile (wall time):", file=f)
        for k, t in sorted(_PHASE_TIMES.items(), key=lambda kv: -kv[1]):
            print(f"    {k:<50} {t:8.2f}s ({100 * t / total:4.1f}%)",
                  file=f)


def clear_stats():
    _COUNTERS.clear()
    _DISTRIBUTIONS.clear()
    _PHASE_TIMES.clear()
