"""seeksv_tpu_torch: the PyTorch and CUDA port of seeksv_tpu.

The ``run`` pipeline with its realignment kernels on a torch device:
anchored extension (ops.extend), and the finalize stage's banded
direction pass and traceback walk (ops.global_device), each a CUDA
kernel for Hopper (csrc/, built by _build at first use) beside its plain
PyTorch version.  The numpy/C++ stages are imported from seeksv_tpu,
never copied; this package never imports jax.
"""

__version__ = "0.1.0"
