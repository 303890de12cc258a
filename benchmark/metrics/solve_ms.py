"""End to end: the window's seconds over the solves it completed, in ms
(all the time of the window, the drawing of each input included, over all
its work)."""


def read(run):
    return run.window_s / run.solves * 1e3 if run.solves else None
