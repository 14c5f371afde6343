"""seeksv_tpu_torch: the PyTorch and CUDA port of seeksv_tpu.

The ``run`` pipeline with its realignment kernels on a torch device:
anchored extension (ops.extend), and the finalize stage's banded
direction pass and traceback walk (ops.global_device), each a CUDA
kernel for Hopper (csrc/, built by _build at first use) beside its plain
PyTorch version; the SPMD pipeline on a torch.distributed mesh
(parallel/), with the consensus scan and the discordant-pair count as
kernels too.  The numpy/C++ stages are imported from seeksv_tpu, never
copied; this package never imports jax.
"""

__version__ = "0.1.0"
