"""Cut kernel: torch.profiler's device time of ``mincut_fused``'s kernels
(``mincut_band_kernel``, ``mincut_stream_kernel``) per traced solve, in
ms."""


def read(run):
    dev = run.kernel_ns("mincut_")
    if not dev or not dev[1]:
        return None
    return dev[0] * 1e-6 / run.traced_solves
