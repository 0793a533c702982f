"""Host time of the port's stable sorts on the keys of ``chip_smoke.py``'s
phases 18 and 19, beside numpy's and torch's stable sorts.

On the products graph of ``chip_smoke.products_graph`` at ``--scale`` of
its size, built and coalesced by the package under ``--root``:

* walls (any root): the graph's construction and ``coalesce``, one
  ``csr2csc`` (the sort phase 18's ``sum(dim=0)`` waits on) and one
  ``permute`` by a seeded permutation (the symmetric gather phase 19's
  partition reorders with), on ``--device``;
* sorts (unless ``--walls-only``): the three key sets those two calls
  sort, ``(col, row)`` of the graph, of its row-permuted copy, and the
  ``(row, col)`` pairs ``index_select`` sorts back to CSR order, each
  sorted by the root's ``lexsort2``, by numpy's stable argsort of the
  combined int64 key and by ``torch.sort(stable=True)`` of that key on
  one thread and on all of torch's threads.  Every permutation must
  equal ``lexsort2``'s; the tool fails otherwise;
* the crossover: random int64 keys of 2**12 to 2**18 entries, each
  sorted by numpy's stable argsort and by ``torch.sort(stable=True)`` on
  all threads (the median of ``--reps`` runs, at least 9).

    python tools/time_host_sorts.py [--scale 0.05] [--reps 3]
        [--root DIR] [--walls-only] [--device cpu|cuda] [--out FILE]

Prints one JSON line.  ``--root`` takes an unpacked older commit, to time
its walls on the same machine (with ``--walls-only``).  Keep the scale
well under 1 on a shared machine: at 1 (106M edges) the graph and its
key sets take about 20 GiB of host memory.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import resource
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _median_s(fn, reps):
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        runs.append(time.perf_counter() - t0)
    return float(np.median(runs)), runs, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scale", type=float, default=0.05,
                   help="share of the products graph's nodes and edges")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--root", default=HERE,
                   help="the checkout whose package is timed")
    p.add_argument("--device", default=None,
                   help="the graph's device (default: cuda if present)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--walls-only", action="store_true",
                   help="time the walls alone (for an older root)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    from chip_smoke import products_graph  # noqa: E402 (same in every root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "pytorch_sparse_tpu_torch"]:
        del sys.modules[name]
    import torch

    import pytorch_sparse_tpu_torch as pts
    from pytorch_sparse_tpu_torch import _build
    from pytorch_sparse_tpu_torch.utils import host_sort

    # The modules (``ops`` rebinds the name ``index_select`` to the op).
    pidx = sys.modules["pytorch_sparse_tpu_torch.ops.index_select"]
    pstorage = sys.modules["pytorch_sparse_tpu_torch.storage"]

    if not pts.__file__.startswith(root):
        raise RuntimeError(f"imported {pts.__file__}, not from {root}")
    dev = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    out = {"root": root, "scale": args.scale, "device": dev,
           "cpu": platform.processor() or platform.machine(),
           "cpu_count": os.cpu_count(), "torch_threads":
           torch.get_num_threads(),
           "openmp": "-fopenmp" in _build.host_flags()}
    if dev == "cuda":
        import subprocess

        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    _build.build(_build.HOST_SOURCES)  # not timed

    M, src, dst = products_graph(args.scale, args.seed)
    t0 = time.perf_counter()
    A = pts.SparseTensor(row=src, col=dst, sparse_sizes=(M, M),
                         device=dev).coalesce("add")
    A.storage.rowptr()
    out["build_s"] = time.perf_counter() - t0
    del src, dst
    out["nodes"], out["nnz"] = M, A.nnz()
    perm = np.random.RandomState(args.seed + 19).permutation(M)

    # The walls, with every lexsort2 call's keys kept for the sort timings.
    keys = []
    real = host_sort.lexsort2

    def keep(primary, secondary, secondary_range=None):
        keys.append((primary.copy(), secondary.copy(), secondary_range))
        return real(primary, secondary, secondary_range)

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    for mod in (pstorage, pidx):
        mod.lexsort2 = keep
    try:
        t0 = time.perf_counter()
        A.storage.csr2csc()
        sync()
        out["csr2csc_s"] = time.perf_counter() - t0
        n_csr2csc = len(keys)
        t0 = time.perf_counter()
        pts.permute(A, perm)
        sync()
        out["permute_s"] = time.perf_counter() - t0
    finally:
        for mod in (pstorage, pidx):
            mod.lexsort2 = real
    out["key_sets"] = {"csr2csc": n_csr2csc,
                       "permute": len(keys) - n_csr2csc}
    if args.walls_only:
        del keys[:]

    sorts = []
    threads = torch.get_num_threads()
    for i, (pk, sk, srange) in enumerate(keys):
        srange = int(sk.max()) + 1 if srange is None else int(srange)
        ref_s, _, ref = _median_s(lambda: host_sort.lexsort2(pk, sk, srange),
                                  args.reps)
        case = {"set": "csr2csc" if i < n_csr2csc else "permute",
                "keys": int(pk.shape[0]),
                "key_bits": int(int(pk.max()) * srange + srange - 1)
                .bit_length(), "lexsort2_s": ref_s}

        def key():
            return pk.astype(np.int64) * srange + sk.astype(np.int64)

        s, _, got = _median_s(lambda: np.argsort(key(), kind="stable"),
                              args.reps)
        case["numpy_argsort_s"], case["numpy_equal"] = s, bool(
            np.array_equal(got, ref))
        for n_threads in (1, threads):
            torch.set_num_threads(n_threads)
            s, _, got = _median_s(lambda: torch.sort(
                torch.from_numpy(key()), stable=True)[1].numpy(), args.reps)
            case[f"torch_sort_{n_threads}t_s"] = s
            case[f"torch_{n_threads}t_equal"] = bool(np.array_equal(got, ref))
        torch.set_num_threads(threads)
        sorts.append(case)
    out["sorts"] = sorts
    cross = []
    rng = np.random.RandomState(args.seed + 7)
    for n in ([] if args.walls_only else [1 << b for b in range(12, 19)]):
        k = rng.randint(0, 1 << 43, n).astype(np.int64)
        np_s, _, a = _median_s(lambda: np.argsort(k, kind="stable"),
                               max(args.reps, 9))
        t_s, _, b = _median_s(lambda: torch.sort(
            torch.from_numpy(k), stable=True)[1].numpy(), max(args.reps, 9))
        cross.append({"keys": n, "numpy_s": np_s, "torch_s": t_s,
                      "equal": bool(np.array_equal(a, b))})
    out["crossover"] = cross
    out["host_peak_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    bad = [c for c in sorts if not all(v for k, v in c.items()
                                       if k.endswith("_equal"))]
    bad += [c for c in cross if not c["equal"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
