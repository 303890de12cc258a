"""Cut kernel: the mean PDHG steps of a device cut (the port's
``mincut.steps`` over ``mincut.launches`` counters, the steps read from the
kernel with the cuts' certificates), over the traced slice, from the
port's own records (``utils.monitor.trace_records``)."""


def read(run):
    try:
        from cp_pfdr_graph_d1_tpu_torch.utils.monitor import trace_records
    except ImportError:
        return None
    recs = trace_records()
    if not recs or len(recs) != run.traced_solves:
        return None
    launches = sum(r["counters"].get("mincut.launches", 0) for r in recs)
    steps = sum(r["counters"].get("mincut.steps", 0) for r in recs)
    return steps / launches if launches else None
