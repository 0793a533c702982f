"""Host time of the port's typed, temporal, HGT and ego samplers on the
graphs and batches of ``chip_smoke.py``'s phase 20, on the CPU.

The synthetic ogbn-mag of ``chip_smoke.mag_graph`` at ``--scale`` of
OGB's node and edge counts: three batches of 1,024 seed papers through
``hetero_neighbor_sample`` (10 neighbours a relation and hop, two hops)
and ``hgt_sample`` (1,024 nodes a type and hop, four hops), batch 0
through ``hetero_temporal_neighbor_sample`` with the papers' years; and
``ego_k_hop_sample_adj`` (depth 2, 5 neighbours, 512 roots) on the
products graph of ``chip_smoke.products_graph`` at the same scale.  The
seeds are phase 20's for ``--seed``.  Each call is timed whole, outputs
on the CPU; the graphs' builds are not timed.

    python tools/time_typed_samplers.py --scale 0.1

Prints one JSON line: each sampler's ms a batch and the nodes and edges
it sampled.  Keep the scale well under 1 on a shared machine (the
products graph alone takes about 10 GiB of host memory at scale 0.1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scale", type=float, default=0.1,
                   help="share of the graphs' nodes and edges")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    import pytorch_sparse_tpu_torch as pts
    from chip_smoke import (HGT_SAMPLES, MAG_BATCH, MAG_YEARS, SHADOW,
                            mag_graph, products_graph)

    n_nodes, rels = mag_graph(torch, args.scale, args.seed, "cpu")
    colptr = {k: v[0] for k, v in rels.items()}
    row = {k: v[1] for k, v in rels.items()}
    rel_keys, node_types = list(rels), list(n_nodes)
    batch, fanouts, n_batches = MAG_BATCH
    n_hgt, hgt_hops = HGT_SAMPLES
    seeds = np.random.RandomState(args.seed + 22).permutation(
        n_nodes["paper"])[:n_batches * batch].reshape(n_batches, batch)
    years = np.random.RandomState(args.seed + 21).randint(
        MAG_YEARS[0], MAG_YEARS[1] + 1, n_nodes["paper"])
    out = {"scale": args.scale, "nodes": n_nodes,
           "edges": {k: int(v[1].shape[0]) for k, v in rels.items()}}

    def timed(name, fn, n):
        runs = []
        for b in range(n):
            t0 = time.perf_counter()
            nid, rws, _, _ = fn(b)
            runs.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                             nodes=sum(v.numel() for v in nid.values()),
                             edges=sum(v.numel() for v in rws.values())))
        out[name] = runs

    timed("hetero_neighbor_sample", lambda b: pts.hetero_neighbor_sample(
        node_types, rel_keys, colptr, row, {"paper": seeds[b]},
        {k: list(fanouts) for k in rel_keys}, len(fanouts),
        seed=args.seed + 100 + b, device="cpu"), n_batches)
    timed("hgt_sample", lambda b: pts.hgt_sample(
        colptr, row, {"paper": seeds[b]},
        {t: [n_hgt] * hgt_hops for t in node_types}, hgt_hops,
        seed=args.seed + 200 + b, device="cpu"), n_batches)
    timed("hetero_temporal_neighbor_sample",
          lambda b: pts.hetero_temporal_neighbor_sample(
              node_types, rel_keys, colptr, row, {"paper": seeds[b]},
              {k: list(fanouts) for k in rel_keys}, {"paper": years},
              len(fanouts), seed=args.seed + 300 + b, device="cpu"), 1)
    del colptr, row, rels

    M, src, dst = products_graph(args.scale)
    A = pts.SparseTensor(row=src, col=dst, sparse_sizes=(M, M),
                         device="cpu").coalesce("add")
    del src, dst
    A.storage.rowptr()
    n_roots, depth, k = SHADOW
    roots = np.random.RandomState(args.seed + 23).permutation(M)[:n_roots]
    t0 = time.perf_counter()
    adj, n_id, _, _, _ = pts.ego_k_hop_sample_adj(
        A, roots, depth, k, seed=args.seed + 400)
    out["ego_k_hop_sample_adj"] = [dict(
        ms=(time.perf_counter() - t0) * 1e3, nodes=int(n_id.numel()),
        edges=int(adj.nnz()), graph_nnz=int(A.nnz()))]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
