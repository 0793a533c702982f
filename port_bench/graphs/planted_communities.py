"""The planted-community graph at ogbn-products' sizes, drawn on the
card from a seed.

A torch copy of the JAX package's generator
(``benchmarks/products_pipeline.py:35-56``), which stands in for the
dataset because it cannot be downloaded: every node joins one of
``communities`` communities uniformly; the source of each undirected
edge is uniform over the nodes, except that the first
``hub_source_share`` of the draws take their source from the lowest
``hub_node_share`` of the node ids (hubs); ``intra_share`` of the edges
end inside the source's community, the rest anywhere.  Each undirected
edge is stored in both directions, as OGB stores products, so the edge
list holds ``2 * undirected_edges`` entries, duplicates and self-loops
included: the port coalesces them.

``order`` is ``"drawn"`` (node ids as drawn: communities scattered) or
``"community"`` (nodes relabelled so that each community is contiguous,
in community order: the layout a METIS-style partition and a
permutation give).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def generate(g: torch.Generator, nodes: int, undirected_edges: int,
             params: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(row, col)``: int64 edge lists on ``g``'s device, each of length
    ``2 * undirected_edges``."""
    dev = g.device
    M, E = int(nodes), int(undirected_edges)
    n_comm = int(params["communities"])
    comm = torch.randint(0, n_comm, (M,), generator=g, device=dev)
    order = torch.argsort(comm, stable=True)
    comm_ptr = torch.searchsorted(
        comm[order], torch.arange(n_comm + 1, device=dev))
    src = torch.randint(0, M, (E,), generator=g, device=dev)
    n_hub = int(E * float(params["hub_source_share"]))
    hub_nodes = max(int(M * float(params["hub_node_share"])), 1)
    src[:n_hub] = torch.randint(0, hub_nodes, (n_hub,), generator=g,
                                device=dev)
    intra = torch.rand(E, generator=g, device=dev) < float(
        params["intra_share"])
    c = comm[src[intra]]
    lo, hi = comm_ptr[c], comm_ptr[c + 1]
    # float64 draws, so that the offset stays below the community's size.
    u = torch.rand(lo.shape[0], generator=g, device=dev,
                   dtype=torch.float64)
    dst = torch.randint(0, M, (E,), generator=g, device=dev)
    dst[intra] = order[lo + (u * (hi - lo)).long()]
    del c, lo, hi, u, intra
    order_name = params.get("order", "drawn")
    if order_name == "community":
        relabel = torch.empty_like(order)
        relabel[order] = torch.arange(M, device=dev)
        src, dst = relabel[src], relabel[dst]
    elif order_name != "drawn":
        raise ValueError(f"unknown node order {order_name!r}")
    return torch.cat([src, dst]), torch.cat([dst, src])
