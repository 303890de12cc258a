"""Reduced-solve kernel: the least time of a ``solve_small`` launch (the
frozen ``harness.roofline.solve_small_work`` of its shapes and the
iterations it ran, over the card's peaks) over its device time, in %."""


def read(run):
    return run.roofline_share("solve_small", "solve_small")
