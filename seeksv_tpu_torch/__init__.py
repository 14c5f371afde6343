"""seeksv_tpu_torch: the PyTorch and CUDA port of seeksv_tpu.

The ``run`` pipeline with its realignment kernels on a torch device:
anchored extension (ops.extend), and the finalize stage's banded
direction pass and traceback walk (ops.global_device), each a CUDA
kernel for Hopper (csrc/, built by _build at first use) beside its plain
PyTorch version; the SPMD pipeline on a torch.distributed mesh
(parallel/), with the consensus scan and the discordant-pair count as
kernels too.  The package stands on its own: it imports torch, numpy and
the standard library, keeps its own copy of every host module it uses
(io/, align/, pipeline/, utils/simulate, same module and public names as
the reference so a reader finds the counterpart), and builds its native
host library from the repo's C++ source (csrc/seeksv_native.cpp) into
build/seeksv_tpu_torch/native/.  It never imports seeksv_tpu nor jax.
"""

__version__ = "0.1.0"
