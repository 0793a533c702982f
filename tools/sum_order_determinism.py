"""Repeat the port's sums over repeated indices on a CUDA card and count
the bit patterns each gives.

Usage (from the repo root; one card)::

    python tools/sum_order_determinism.py [--root DIR] [--runs N] [--out FILE]

The cases, each run ``--runs`` times on the card from the same inputs:

* ``coalesce add`` / ``coalesce mean``: ``SparseTensor.coalesce`` of a
  CUDA value that requires grad, 2,000,000 draws over 20,000 positions
  (about 100 duplicates a position); the bits of the summed value and of
  the value's gradient under a fixed output gradient;
* ``halo backward``: the gradient of ``x`` through the flat halo
  schedule (``dist_spmm(..., "halo", "sum")``) on four gloo processes
  sharing the card, on a uniform graph (8,192 nodes, 262,144 edges,
  K=128) in which every row is served to two or three peers; one
  process group, ``--runs`` forward and backward passes, and the bits of
  every rank's gradient;
* ``hier (1, 4) backward`` and ``hier (4, 1) backward``: the same on
  the hierarchical layouts (``dist_spmm_hier``) whose one fabric serves
  a row to up to three peers: ICI on the (1, 4) grid, DCN on the (4, 1)
  one (on a (2, 2) grid each fabric serves a row to one peer);
* ``to_dense``: ``SparseTensor.to_dense`` of the duplicate draws
  (``index_put_`` with ``accumulate=True``), the other float sum over
  repeated indices on a CUDA path.

For each case the script counts the distinct bit patterns over the runs
and the largest error against the CPU's result, relative to max |ref|.
``--root`` is the checkout whose ``pytorch_sparse_tpu_torch`` is
measured (default: this one), so that an older commit unpacked into a
directory that ``.gitignore`` lists can be measured in the same call.
It prints the card's ``nvidia-smi`` name and power limit, then one JSON
object, also written to ``--out``.
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COALESCE = (20_000, 2_000_000)   # positions, draws
DIST = (8_192, 262_144, 128)     # nodes, edges, K
WORLD = 4


def _bits(t) -> str:
    a = t.detach().contiguous().cpu().numpy()
    return hashlib.sha1(a.tobytes()).hexdigest()[:16]


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    scale = b.abs().max().item()
    diff = (a - b).abs().max().item()
    return diff / scale if scale > 0 else diff


def _import(root):
    if root not in sys.path:
        sys.path.insert(0, root)
    import pytorch_sparse_tpu_torch as ts

    if os.path.dirname(ts.__file__) != os.path.join(
            root, "pytorch_sparse_tpu_torch"):
        raise RuntimeError(f"imported {ts.__file__}, not from {root}")
    return ts


def _uniform(M, E, seed):
    rng = np.random.RandomState(seed)
    row, col = rng.randint(0, M, E), rng.randint(0, M, E)
    key = np.unique(row.astype(np.int64) * M + col)
    return key // M, key % M, rng.randn(key.size).astype(np.float32)


def dist_worker(rank, world_size, root, runs, grid, seed):
    """``runs`` forward and backward passes of the halo (``grid`` None)
    or hierarchical ``(S, C)`` sum on this rank's CUDA shard, and the same
    once on the CPU: the bits of each CUDA gradient of ``x``, its error
    against the CPU's, and the most packet slots a served row fills."""
    import torch

    ts = _import(root)
    from pytorch_sparse_tpu_torch import parallel as par

    M, E, K = DIST
    row, col, val = _uniform(M, E, seed)
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(M, K).astype(np.float32)
    gout = rng.randn(M, K).astype(np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        A = ts.SparseTensor(row=row, col=col, value=val,
                            sparse_sizes=(M, M), is_sorted=True,
                            trust_data=True, device=dev)
        if grid is None:
            As = par.ShardedSparseMatrix.from_sparse_tensor(
                A, par.make_mesh(world_size, device=dev))
            serve = As.serve_idx
        else:
            As = par.HierShardedSparseMatrix.from_sparse_tensor(
                A, par.make_mesh_hier(*grid, device=dev))
            serve = torch.cat([As.serve_ici.reshape(-1),
                               As.serve_dcn.reshape(-1)])
        xs = As.shard_dense(torch.from_numpy(x).to(dev))
        gs = As.shard_dense(torch.from_numpy(gout).to(dev))
        grads = []
        for _ in range(runs if dev == "cuda" else 1):
            xr = xs.clone().requires_grad_(True)
            if grid is None:
                out = par.dist_spmm(As, xr, "halo", "sum", "ell")
            else:
                out = par.dist_spmm_hier(As, xr, "sum", "ell")
            out.backward(gs)
            grads.append(xr.grad.detach().cpu())
        res[dev] = grads
        served = serve.reshape(-1).cpu().numpy()
        served = served[served > 0]  # padding slots read row 0
        res["max_slots"] = int(np.bincount(served).max(initial=0))
    cpu = res["cpu"][0]
    return {"bits": [_bits(g) for g in res["cuda"]],
            "max_rel_err_vs_cpu": max(_rel(g, cpu) for g in res["cuda"]),
            "max_slots_a_served_row": res["max_slots"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("sum_order_determinism: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    root = os.path.abspath(args.root)
    ts = _import(root)
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    report = {"root": root, "runs": args.runs, "card": card,
              "kind": torch.cuda.get_device_name(0), "cases": {}}

    def record(name, runs_bits, err, **kw):
        case = {"distinct_bit_patterns": len(set(runs_bits)),
                "max_rel_err_vs_cpu": err, **kw}
        report["cases"][name] = case
        print(json.dumps({"case": name, **case}), flush=True)

    # ---- coalesce of a value that requires grad -------------------------
    n_pos, draws = COALESCE
    rng = np.random.RandomState(7)
    pos = np.sort(rng.randint(0, n_pos, draws))
    side = int(np.ceil(np.sqrt(n_pos)))
    row, col = pos // side, pos % side
    val = rng.randn(draws).astype(np.float32)
    gcoal = None

    def coalesce(dev, reduce):
        nonlocal gcoal
        v = torch.from_numpy(val).to(dev).requires_grad_(True)
        A = ts.SparseTensor(row=row, col=col, sparse_sizes=(side, side),
                            is_sorted=True, trust_data=True, device=dev)
        C = A.set_value(v, layout="coo").coalesce(reduce)
        out = C.storage.value()
        if gcoal is None or gcoal.shape != out.shape:
            gcoal = np.random.RandomState(8).randn(*out.shape).astype(
                np.float32)
        out.backward(torch.from_numpy(gcoal).to(dev))
        return out.detach().cpu(), v.grad.detach().cpu()

    for reduce in ("add", "mean"):
        ref = coalesce("cpu", reduce)
        got = [coalesce("cuda", reduce) for _ in range(args.runs)]
        record(f"coalesce {reduce}", [_bits(o) for o, _ in got],
               max(_rel(o, ref[0]) for o, _ in got),
               value_grad_bit_patterns=len({_bits(gv) for _, gv in got}),
               positions=int(ref[0].shape[0]), draws=draws)

    # ---- to_dense of the duplicate draws (index_put_ accumulate) ---------
    def dense(dev):
        A = ts.SparseTensor(row=row, col=col, value=torch.from_numpy(val),
                            sparse_sizes=(side, side), is_sorted=True,
                            trust_data=True, device=dev)
        return A.to_dense().cpu()

    ref = dense("cpu")
    got = [dense("cuda") for _ in range(args.runs)]
    record("to_dense", [_bits(d) for d in got],
           max(_rel(d, ref) for d in got), draws=draws)

    # ---- the halo and hierarchical backward on four gloo processes -------
    for grid, name in ((None, "halo backward"),
                       ((1, 4), "hier (1, 4) backward"),
                       ((4, 1), "hier (4, 1) backward")):
        ranks = cs.spawn_ranks(
            dist_worker, WORLD, "gloo",
            args=dict(root=root, runs=args.runs, grid=grid, seed=11),
            timeout=900)
        # Run r's bits: every rank's gradient in that run.
        bits = ["/".join(r["bits"][i] for r in ranks)
                for i in range(args.runs)]
        record(name, bits, max(r["max_rel_err_vs_cpu"] for r in ranks),
               ranks=WORLD, nodes=DIST[0], edges=DIST[1], K=DIST[2],
               max_slots_a_served_row=max(r["max_slots_a_served_row"]
                                          for r in ranks))

    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
