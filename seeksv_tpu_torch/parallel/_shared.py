"""Jax-free access to the JAX package's SPMD host helpers.

``seeksv_tpu/parallel/spmd_pipeline.py`` and ``stream_spmd.py`` import
jax only inside their device functions, so their host helpers (event
encoding, the partitioned MergeJunction, the insert-size columns, the
streaming sinks) are plain numpy.  But ``seeksv_tpu/parallel/__init__.py``
imports ``.sharded``, which imports jax at module level, so a plain
``import seeksv_tpu.parallel.spmd_pipeline`` fails where jax is absent.

``load`` executes each module from its file under its canonical name,
without running the package ``__init__``; a module already imported (by
a JAX test in the same process, say) is reused, so both packages always
see one module object.
"""
from __future__ import annotations

import importlib.util
import os
import sys

import seeksv_tpu

_PARALLEL = os.path.join(os.path.dirname(os.path.abspath(
    seeksv_tpu.__file__)), "parallel")


def load(name: str):
    """seeksv_tpu.parallel.<name>, imported without the package's
    ``__init__``."""
    full = f"seeksv_tpu.parallel.{name}"
    mod = sys.modules.get(full)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            full, os.path.join(_PARALLEL, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[full]
            raise
    return mod


spmd_pipeline = load("spmd_pipeline")
stream_spmd = load("stream_spmd")
