"""Tiny versions of the cells for the CPU tests: the cells' own
configuration and traffic files with the dataset's sizes cut, at which
the clustered graph still takes the block route and the shuffled one
the CSR route."""

import copy

from port_bench import spec

SIZES = {
    "gcn-products.clustered": dict(nodes=6000, undirected_edges=150_000,
                                   communities=20),
    "sage-products.shuffled": dict(nodes=20000, undirected_edges=150_000,
                                   communities=60),
}
CELLS = tuple(SIZES)


def tiny_cell(workload: str):
    c = copy.deepcopy(spec.cell(spec.load_benchmark(), workload))
    s = SIZES[workload]
    ds = c["config"]["dataset"]
    ds.update(nodes=s["nodes"], undirected_edges=s["undirected_edges"],
              train=s["nodes"] // 10, valid=s["nodes"] // 20)
    ds["test"] = s["nodes"] - ds["train"] - ds["valid"]
    c["traffic"]["params"]["communities"] = s["communities"]
    return c
