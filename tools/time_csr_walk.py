"""Time the CSR walk of ``csr_spmm`` (K1) and ``shard_spmm`` (K11a) on a
CUDA card, with two controls that bracket it.

Usage (from the repo root; one card)::

    python tools/time_csr_walk.py [--root DIR] [--reps N] [--out FILE]

``--root`` is the checkout whose ``pytorch_sparse_tpu_torch`` is
timed (default: this one), so that two commits can be compared in one
call on one card: unpack the other commit into a directory that
``.gitignore`` lists and run the script with each root in turns (parent,
change, change, parent).  Graphs, widths and seeds are
``chip_smoke.py``'s, taken from this checkout; only the public wrappers
are called, so an older tree runs as it is.  Each run prints the card's
``nvidia-smi`` name and power limit, then one JSON object (also written
to ``--out``) with a case per line of ``cases``:

* K1 on the uniform graph (ogbn-arxiv scale) at K = 1, 8, 40, 128 and
  256, on the community hybrid graph at K=128, and ``segment_sum_csr``
  (K1 over identity columns, K=1: ``gcn_norm``'s degree);
* K11a on shard 0 of the community hybrid graph over 4 ranks: the
  interior written and the halo frontier accumulated, at K = 20, 128 and
  256;
* the controls at K=128, for the uniform graph, the community hybrid
  and the K11a interior, on the same ``rowptr``: ``resident`` (every
  column taken modulo 256, so each gathered row stays in L1: the walk's
  instruction floor) and ``scattered`` (an operand of one row per edge,
  each edge its own row through a seeded permutation: no reuse, the
  L2/HBM ceiling).

Each case's ``ms`` is CUDA events around ``--reps`` launches after one
warm-up (the host's launch path where it is slower than the kernel);
``device_ms`` is the walk kernel's own time per call from a
``torch.profiler`` trace of ``TRACE_CALLS`` calls; ``bound_ms`` is the operand-once bound (each input read once,
the output written once, at 3.35 TB/s) and ``row_per_edge_ms`` the bound
that reads one operand row per edge.  Where the tree has
``ops.kernels.csr_spmm.walk_instance``, each case names the instance
that ran (vector width, lanes a row, rows a warp, chunks a lane, column
tiles).
"""

import argparse
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESIDENT_ROWS = 256
TRACE_CALLS = 10
# The walk kernels' names in this tree and in older ones.
WALK_KERNEL = re.compile(r"walk_kernel|csr_spmm_kernel|shard_spmm_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_csr_walk: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import pytorch_sparse_tpu_torch as ts
    from pytorch_sparse_tpu_torch import _build
    from pytorch_sparse_tpu_torch.ops.kernels import csr_spmm, shard_spmm
    from pytorch_sparse_tpu_torch.parallel import ShardedSparseMatrix
    from pytorch_sparse_tpu_torch.segment import segment_sum_csr
    from pytorch_sparse_tpu_torch.testing import community_graph

    if os.path.dirname(ts.__file__) != os.path.join(root,
                                                    "pytorch_sparse_tpu_torch"):
        raise RuntimeError(f"imported {ts.__file__}, not from {root}")
    k1_module = sys.modules[csr_spmm.__module__]
    walk_instance = getattr(k1_module, "walk_instance", None)

    device = torch.device("cuda")
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    res = {"root": root, "card": card, "torch": torch.__version__,
           "reps": args.reps, "cases": []}
    t0 = time.time()
    _build.build(["csr_spmm", "shard_spmm"])
    res["build_s"] = time.time() - t0
    res["ptxas"] = {n: [ln for ln in _build.build_log(n).splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n in ("csr_spmm", "shard_spmm")}

    def timed(fn):
        """(CUDA-event ms a call, the walk kernel's device ms a call)."""
        from torch.profiler import ProfilerActivity, profile

        ms = cs.time_ms(torch, fn, reps=args.reps)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_CALLS):
                fn()
            torch.cuda.synchronize()
        us = sum(_device_us(e) for e in prof.key_averages()
                 if e.device_type.name == "CUDA" and WALK_KERNEL.search(e.key))
        return ms, us / 1e3 / TRACE_CALLS

    def instance(k, *tensors):
        if walk_instance is None:
            return None
        aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
        return walk_instance(k, aligned)._asdict()

    def case(kernel, graph, k, times, R, E, n_read, out_rows, has_value,
             accumulate=False, has_map=False, inst=None, **kw):
        ms, device_ms = times
        bound, by = cs.shard_bounds(R, E, k, n_read, out_rows, has_value,
                                    accumulate, has_map)
        row_per_edge = cs.shard_row_per_edge_ms(R, E, k, out_rows,
                                                accumulate)
        entry = {"kernel": kernel, "graph": graph, "K": k, "ms": ms,
                 "device_ms": device_ms, "bound_ms": bound, "bound_by": by,
                 "row_per_edge_ms": row_per_edge, "rows": R, "edges": E,
                 "instance": inst, **kw}
        res["cases"].append(entry)
        print(json.dumps(entry), flush=True)

    def controls(kernel, graph, rowptr, col, val, call, R, out_rows,
                 accumulate=False, has_map=False):
        """The resident and scattered controls of one walk at K=128:
        ``call(col, x)`` launches it."""
        E = col.shape[0]
        col_r = torch.remainder(col, RESIDENT_ROWS)
        x_r = cs.operand(torch, RESIDENT_ROWS, cs.K, 41, device)
        case(kernel, f"{graph}, control resident", cs.K,
             timed(lambda: call(col_r, x_r)), R, E, RESIDENT_ROWS, out_rows,
             val is not None, accumulate, has_map,
             instance(cs.K, x_r))
        del col_r, x_r
        gen = torch.Generator(device=device).manual_seed(42)
        col_s = torch.randperm(E, generator=gen, device=device).to(
            torch.int32)
        x_s = torch.randn((E, cs.K), generator=gen, device=device)
        case(kernel, f"{graph}, control scattered", cs.K,
             timed(lambda: call(col_s, x_s)), R, E, E, out_rows,
             val is not None, accumulate, has_map, instance(cs.K, x_s))
        del col_s, x_s
        torch.cuda.empty_cache()

    # ---- K1: the uniform graph ------------------------------------------
    Mu, Eu = cs.UNIFORM
    A_u = cs.uniform_graph(ts, Mu, Eu, device)
    rowptr, col, val = A_u.csr()
    n_u = int(torch.unique(col).numel())
    for k in (1, 8, 40, 128, 256):
        x = cs.operand(torch, Mu, k, 2, device)
        case("csr_spmm", "uniform", k,
             timed(lambda: csr_spmm(rowptr, col, val, x)), Mu, Eu, n_u, Mu,
             True, inst=instance(k, x))
        del x
    w = cs.operand(torch, Eu, 1, 3, device).reshape(Eu)
    case("csr_spmm", "uniform, segment_sum_csr (identity columns)", 1,
         timed(lambda: segment_sum_csr(w, rowptr)), Mu, Eu, Eu, Mu, False,
         inst=instance(1, w))
    del w
    controls("csr_spmm", "uniform", rowptr, col, val,
             lambda c, x: csr_spmm(rowptr, c, val, x), Mu, Mu)
    del A_u, rowptr, col, val

    # ---- K1: the community hybrid graph ---------------------------------
    Mh, Eh, nh = cs.HYBRID
    A_h = community_graph(Mh, Eh, n_comm=nh, seed=1, equal_sizes=True,
                          device=device)
    rowptr, col, val = A_h.csr()
    x = cs.operand(torch, Mh, cs.K, 2, device)
    case("csr_spmm", "community hybrid", cs.K,
         timed(lambda: csr_spmm(rowptr, col, val, x)), Mh, A_h.nnz(),
         int(torch.unique(col).numel()), Mh, True, inst=instance(cs.K, x))
    del x
    controls("csr_spmm", "community hybrid", rowptr, col, val,
             lambda c, x: csr_spmm(rowptr, c, val, x), Mh, Mh)
    del rowptr, col, val

    # ---- K11a: shard 0 of the community hybrid graph over 4 ranks -------
    shard0 = ShardedSparseMatrix.from_sparse_tensor(
        A_h, cs.HostMesh(cs.DIST_WORLD, 0, device))
    hl0 = shard0._halo
    it0, fr0 = hl0.interior, hl0.frontier
    Mb0, Nb0, PH0 = shard0.Mb, shard0.Nb, cs.DIST_WORLD * hl0.H
    for k in (20, 128, 256):
        xb0 = cs.operand(torch, Nb0, k, 31, device)
        halo0 = cs.operand(torch, PH0, k, 32, device)
        base = cs.operand(torch, Mb0, k, 33, device)
        for label, grp, buf, acc in (("interior, write", it0, xb0, None),
                                     ("halo frontier, accumulate", fr0,
                                      halo0, base)):
            R_ = grp.rowptr.shape[0] - 1
            out_t = None if acc is None else acc.clone()
            if out_t is None:
                fn = (lambda grp=grp, buf=buf: shard_spmm(
                    grp.rowptr, grp.col, grp.value, buf,
                    row_map=grp.row_map, n_rows=Mb0))
            else:
                fn = (lambda grp=grp, buf=buf, out_t=out_t: shard_spmm(
                    grp.rowptr, grp.col, grp.value, buf, out=out_t,
                    row_map=grp.row_map))
            case("shard_spmm", f"shard 0 {label}", k, timed(fn), R_,
                 grp.nnz, int(torch.unique(grp.col).numel()), R_,
                 grp.value is not None, acc is not None,
                 grp.row_map is not None,
                 inst=instance(k, buf, *(() if out_t is None else (out_t,))))
            del out_t
        del xb0, halo0, base
    grp = it0
    controls("shard_spmm", "shard 0 interior, write", grp.rowptr, grp.col,
             grp.value,
             lambda c, x: shard_spmm(grp.rowptr, c, grp.value, x,
                                     row_map=grp.row_map, n_rows=Mb0),
             grp.rowptr.shape[0] - 1, grp.rowptr.shape[0] - 1,
             has_map=grp.row_map is not None)

    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
