"""Reduced-solve kernel: torch.profiler's device time of ``solve_small``'s
kernels (``solve_small_kernel``, ``solve_small_cluster_kernel``) per
traced solve, in ms."""


def read(run):
    dev = run.kernel_ns("solve_small")
    if not dev or not dev[1]:
        return None
    return dev[0] * 1e-6 / run.traced_solves
