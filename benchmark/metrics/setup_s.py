"""setup_s: process start to the window's start (imports, the CUDA context,
the kernels from the build directory or their build, the inputs, the warm-up)."""


def read(run):
    return run.setup_s
