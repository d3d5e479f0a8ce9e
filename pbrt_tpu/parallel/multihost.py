"""Multi-host (multi-process) initialization + mesh construction.

The reference scales with a single-machine thread pool
(core/parallel.cpp); here the scale-out axis is hosts × cards. This
module is the jax.distributed entry point (SURVEY §7 step 7): every
process calls :func:`initialize_multihost` once before touching jax
arrays, then builds a host-aware mesh with :func:`make_multihost_mesh`
and calls the SAME `render_sharded` / `make_train_step` as single-host
code — shard_map and the psum collectives are topology-agnostic.

Mesh recipe (why dp spans hosts):
- The 'dp' (sample-split) axis carries exactly ONE collective per render
  pass — the film psum (a few MB) — so it rides the slower network
  between hosts without hurting step time.
- The 'sp' (row-slab) axis needs no communication in the forward pass at
  all, but its gradient transpose all-gathers per-slab activations, so
  keep it on the cards of one host, which NVLink joins all to all.
Hence: dp = hosts (× any spare local factor), sp = within-host cards.
Within one host every card reaches every other at the same rate, so a
single-host mesh follows the algorithm alone (make_mesh).

The wiring is exercised process-locally: a 1-process
`jax.distributed.initialize` against a local coordinator, then the normal
sharded render on whatever devices exist
(tests/test_parallel.py::test_multihost_*). Nothing on a single machine
tells JAX of a cluster, so give a real multi-host run its
coordinator_address, num_processes and process_id explicitly.
"""

from __future__ import annotations

import numpy as np

_initialized = False


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         local_device_ids=None) -> int:
    """Idempotent `jax.distributed.initialize` wrapper.

    With no arguments, auto-detects the environment (SLURM / Open MPI —
    jax's own detection). Explicit arguments support
    manual rendezvous: a coordinator `host:port`, the process count, and
    this process's id. Returns `jax.process_count()` after init.

    Call ONCE per process, before any jax computation. Safe to call in a
    single-process run (including tests): distributed state then has one
    process and every collective degenerates correctly.
    """
    global _initialized
    import jax
    if _initialized:
        return jax.process_count()
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _initialized = True
    return jax.process_count()


def make_multihost_mesh(axes=("dp", "sp")):
    """Global (dp, sp) mesh with dp spanning hosts and sp the chips
    within a host (the DCN recipe in the module docstring).

    Uses the GLOBAL device list (jax.devices() is identical on every
    process after initialize); single-process runs degenerate to
    `make_mesh` semantics with dp=1×local split.
    """
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n_proc = jax.process_count()
    per_host = len(devs) // max(n_proc, 1)
    # order: process-major (jax.devices is sorted by process_index)
    grid = np.array(devs).reshape(n_proc, per_host)
    if len(axes) == 1:
        return Mesh(grid.reshape(-1), axes)
    return Mesh(grid, axes)


def process_local_rows(height: int, sp_index: int, sp_size: int):
    """The row-slab [start, stop) a given sp shard owns — for host-local
    film IO when each host writes its own slab (large-film path)."""
    rows = -(-height // sp_size)
    start = sp_index * rows
    return start, min(start + rows, height)
