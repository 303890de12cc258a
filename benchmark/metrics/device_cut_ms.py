"""Device cut round: host milliseconds a solve in the device loops' cut
rounds (the port's ``cp.device_cut`` spans: the cut costs, the PDHG cuts
and the read of their certificates, ``solvers/cut_pursuit_device``), over
the traced slice's solves, from the port's own records
(``utils.monitor.trace_records``)."""


def read(run):
    try:
        from cp_pfdr_graph_d1_tpu_torch.utils.monitor import trace_records
    except ImportError:
        return None
    recs = trace_records()
    if not recs or len(recs) != run.traced_solves:
        return None
    ns = [s["total_ns"] for r in recs for s in r["spans"]
          if s["name"] == "cp.device_cut"]
    return sum(ns) * 1e-6 / len(recs) if ns else None
