"""Multi-chip rendering: sample/pixel sharding over a device mesh.

JAX counterpart of the reference's *entire* parallel runtime — the
pthread pool + work-stealing tile list of core/parallel.{h,cpp}:45-143 and
the mutex film merge (core/film.h:93). The tile decomposition becomes a
sharded sample-batch axis under ``shard_map``; the film merge becomes a
``psum`` over the mesh; scene arrays are replicated (SURVEY.md §2.9).
"""

from pbrt_tpu.parallel.render import (make_mesh, render_sharded,  # noqa
                                      inverse_render_step)
from pbrt_tpu.parallel.multihost import (initialize_multihost,  # noqa
                                         make_multihost_mesh)
