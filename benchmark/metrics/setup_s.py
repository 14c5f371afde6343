"""setup_s: CUDA context, native library, kernels, the k-mer index
built into the program's cache, and one warm pass."""


def read(ctx):
    return ctx["setup_s"]
