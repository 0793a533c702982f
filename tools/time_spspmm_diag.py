"""Host time of ``spspmm_diag(A, A)`` on ``chip_smoke.py``'s phase 21
graph (the JAX package's ``benchmarks/reddit_pipeline.py`` graph), for
the package under ``--root``.

Builds ``chip_smoke.reddit_graph(--scale)``, constructs and coalesces it
with the root's package on ``--device`` (not timed), then times
``spspmm_diag(A, A)`` ``--reps`` times.  Run it once with an older
commit unpacked under ``--root`` and once with this checkout, in one
call, to compare the two on one machine; the diagonal's float64 sum is
printed so that the two runs can be held equal.

    python tools/time_spspmm_diag.py [--scale 0.02] [--reps 2]
        [--root DIR] [--device cpu|cuda] [--out FILE]

Prints one JSON line.  At scale 1 (160M draws, 115M nnz) the graph takes
about 10 GiB of host memory; keep the scale small on a shared machine.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scale", type=float, default=0.02,
                   help="share of the Reddit graph's nodes and draws")
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--root", default=HERE,
                   help="the checkout whose package is timed")
    p.add_argument("--device", default=None,
                   help="the graph's device (default: cuda if present)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    from chip_smoke import reddit_graph  # noqa: E402
    sys.path.insert(0, root)
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "pytorch_sparse_tpu_torch"]:
        del sys.modules[name]
    import torch

    import pytorch_sparse_tpu_torch as pts

    if not pts.__file__.startswith(root):
        raise RuntimeError(f"imported {pts.__file__}, not from {root}")
    dev = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    out = {"root": root, "scale": args.scale, "device": dev,
           "cpu_count": os.cpu_count(),
           "torch_threads": torch.get_num_threads()}
    if dev == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    M, src, dst = reddit_graph(args.scale)
    A = pts.SparseTensor(row=src, col=dst, sparse_sizes=(M, M),
                         device=dev).coalesce("add")
    A.storage.rowptr()
    del src, dst
    out["nodes"], out["nnz"] = M, A.nnz()
    runs = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        d = pts.spspmm_diag(A, A)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    out["spspmm_diag_s"] = runs
    out["diag_sum"] = float(d.double().sum())
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
