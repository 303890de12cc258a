"""Device connected components by min-label propagation with pointer
jumping (counterpart of ``cp_pfdr_graph_d1_tpu.ops.components``), for any
graph container.

The reference finds the components of the inactive-edge subgraph with a
serial DFS (``CP_PFDR_graph_quadratic_d1_l1.cpp:570-596``).  Here each
vertex adopts the smallest label among itself and its neighbours across
unmasked edges, then follows labels of labels (``l <- l[l]``), round after
round until nothing changes.  Labels converge to the smallest vertex index
of each component, which is the reference's DFS numbering after
:func:`compact_labels`.  Stencil graphs have the kernel of
:mod:`.components_fused`; this is the plain route of the other containers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def connected_components_device(graph, edge_mask,
                                it_max: Optional[int] = None):
    """int32 [V] labels: the smallest vertex index reachable from each
    vertex across the edges where ``edge_mask`` (bool [E]) is set.

    ``it_max`` caps the rounds and defaults to V: pointer jumping makes
    typical runs stop after a few rounds, but snake-shaped components at
    high cut densities need more than a logarithmic bound (the JAX
    package's former ``2 log2(V) + 8`` cap under-converged: 560 instead of
    558 components on a 96 x 96 grid at 45 % active edges), and propagation
    alone converges within the component diameter, at most V.
    """
    v = graph.num_vertices
    if it_max is None:
        it_max = v
    lab = torch.arange(v, device=edge_mask.device)
    rounds = 0
    changed = True
    while changed and rounds < it_max:
        lu, lv = graph.gather_endpoints(lab)
        m = torch.where(edge_mask, torch.minimum(lu, lv), v)
        l = torch.minimum(lab, graph.edge_to_vertex_min(m, m, v))
        l = torch.minimum(l, l[l])
        l = torch.minimum(l, l[l])
        changed = bool((l != lab).any())
        lab = l
        rounds += 1
    return lab.to(torch.int32)


def compact_labels(roots) -> tuple[int, np.ndarray]:
    """Renumbers root labels to 0..rV-1 in order of first occurrence (the
    reference's DFS component numbering), on the host."""
    roots = np.asarray(roots)
    v = roots.shape[0]
    # a component's root is its smallest vertex, so ascending root order
    # is first-encounter order over the 0..V-1 vertex scan
    mapping = np.full(v, -1, np.int32)
    firsts = roots == np.arange(v)
    num = int(firsts.sum())
    mapping[firsts] = np.arange(num, dtype=np.int32)
    return num, mapping[roots]
