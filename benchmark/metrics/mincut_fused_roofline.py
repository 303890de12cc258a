"""Cut kernel: the least time of a ``mincut_fused`` launch (the frozen
``harness.roofline.mincut_work`` of its field and the PDHG steps it ran,
over the card's peaks) over its device time, in %."""


def read(run):
    return run.roofline_share("mincut_fused", "mincut_")
