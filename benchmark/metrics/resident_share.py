"""Reduced-solve kernel: the share of reduced solves that ran on
``solve_small``'s resident schedule (the port's ``reduced.resident`` over
``reduced.launches`` counters), over the traced slice, in %, from the
port's own records (``utils.monitor.trace_records``).  Nothing to read
where the port has no resident schedule."""


def read(run):
    try:
        from cp_pfdr_graph_d1_tpu_torch.ops import solve_small
        from cp_pfdr_graph_d1_tpu_torch.utils.monitor import trace_records
    except ImportError:
        return None
    if not hasattr(solve_small, "RESIDENT"):
        return None
    recs = trace_records()
    if not recs or len(recs) != run.traced_solves:
        return None
    launches = sum(r["counters"].get("reduced.launches", 0) for r in recs)
    resident = sum(r["counters"].get("reduced.resident", 0) for r in recs)
    return 100.0 * resident / launches if launches else None
