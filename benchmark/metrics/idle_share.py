"""Device: the share of the traced slice in which the card ran no kernel,
copy or memset (the union of torch.profiler's device intervals), in %."""


def read(run):
    p = run.profile
    if p is None or not p["window_ns"]:
        return None
    return 100.0 * (1.0 - p["busy_ns"] / p["window_ns"])
