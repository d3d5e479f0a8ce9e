"""Front-end: .pbrt scene-description parser → SceneBuilder.

JAX counterpart of L5 (core/parser.{h,cpp} tokenizer + recursive
parse(), core/api.{h,cpp} state machine, core/paramset.{h,cpp}) —
cold-path, stays in Python, emits the typed SoA scene pytrees.
"""

from pbrt_tpu.frontend.parser import load_pbrt, parse_pbrt_string  # noqa
