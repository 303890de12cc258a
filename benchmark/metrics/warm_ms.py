"""Warm partition: host milliseconds a solve in the chained loop's warm
partition (the port's ``cp.warm`` spans:
``solvers/cut_pursuit_chain._warm_partition``, its full-graph PFDR on
``stencil_fused``, the read-back and the threshold-and-components loop),
over the traced slice's solves, from the port's own records
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
          if s["name"] == "cp.warm"]
    return sum(ns) * 1e-6 / len(recs) if ns else None
