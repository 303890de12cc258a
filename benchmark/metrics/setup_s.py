"""End to end: seconds from the process's start to the window's start:
imports, the CUDA context, the kernels' build where the checkout has none
yet, the inputs from the seed, the graph and the warm-up solves."""


def read(run):
    return run.setup_s
