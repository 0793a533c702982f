"""Host time of GraphSAGE's one-hop sampler, the port against the JAX
package, on the ogbn-products-scale graph of ``chip_smoke.py``.

Both sides run ``sample_adj(A, frontier, k, replace=False, seed=s)`` per
hop, innermost hop first, with the batches and seeds of
``chip_smoke.py``'s phase 13 (PyG's ``ogbn_products_sage.py``: 1,024
targets, fanouts 15, 10, 5), on the CPU: the port's numpy draw stream
(``pytorch_sparse_tpu_torch.sample``) and the JAX package's default
path, its C++ native library when it loads (else its numpy fallback,
reported as ``jax_path``).  The two must give the same ``n_id`` and the
same sampled edges; the script exits 1 where they differ.  Both graphs
carry the edge ids as values, as phase 13's does.  ``jax_ms`` is the
JAX package's whole call (its jnp work included); ``jax_native_ms`` the
native library's sampler alone, on the same frontier.

    JAX_PLATFORMS=cpu python tools/time_host_samplers.py --scale 0.25

Prints one JSON line: per batch and hop, the frontier, the sampled
edges and both times in ms.  The graph's build is not timed.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH, FANOUTS, BATCHES = 1024, [15, 10, 5], 3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scale", type=float, default=0.25,
                   help="share of the products graph's nodes and edges")
    args = p.parse_args(argv)

    import jax.numpy as jnp
    import torch

    import pytorch_sparse_tpu as jts
    import pytorch_sparse_tpu_torch as pts
    from chip_smoke import products_graph
    from pytorch_sparse_tpu.csrc import bindings

    M, src, dst = products_graph(args.scale)
    P = pts.SparseTensor(row=src, col=dst, sparse_sizes=(M, M),
                         device="cpu").coalesce("add")
    del src, dst
    rowptr = P.storage.numpy_view("rowptr")
    col = P.storage.numpy_view("col")
    E = col.shape[0]
    P = P.set_value(torch.arange(E, dtype=torch.int32), layout="coo")
    J = jts.SparseTensor(rowptr=rowptr, col=col,
                         value=jnp.arange(E, dtype=jnp.int32),
                         sparse_sizes=(M, M), is_sorted=True,
                         trust_data=True)

    rows, same = [], True
    for it in range(BATCHES):
        targets = np.random.RandomState(100_000 + it).choice(
            M, BATCH, replace=False)
        fp, fj = torch.from_numpy(targets), jnp.asarray(targets)
        for h, k in enumerate(FANOUTS):
            seed = 1000 + it * 10 + h
            t0 = time.perf_counter()
            adj_p, fp_next = pts.sample_adj(P, fp, k, replace=False,
                                            seed=seed)
            t1 = time.perf_counter()
            adj_j, fj_next = jts.sample_adj(J, fj, k, replace=False,
                                            seed=seed)
            fj_next = np.asarray(fj_next)
            t2 = time.perf_counter()
            if bindings.available():
                bindings.sample_adj(rowptr, col, np.asarray(fj, np.int64), k,
                                    False, seed)
            t3 = time.perf_counter()
            same &= bool(
                np.array_equal(fp_next.numpy(), fj_next)
                and np.array_equal(adj_p.storage.numpy_view("rowptr"),
                                   adj_j.storage.numpy_view("rowptr"))
                and np.array_equal(adj_p.storage.numpy_view("col"),
                                   adj_j.storage.numpy_view("col"))
                and np.array_equal(adj_p.storage.value().numpy(),
                                   np.asarray(adj_j.storage.value())))
            rows.append(dict(batch=it, hop=h, fanout=k,
                             frontier=int(fp.shape[0]),
                             sampled_edges=int(adj_p.nnz()),
                             port_ms=(t1 - t0) * 1e3,
                             jax_ms=(t2 - t1) * 1e3,
                             jax_native_ms=(t3 - t2) * 1e3))
            fp, fj = fp_next, jnp.asarray(fj_next)

    def per_batch(key):
        return [sum(r[key] for r in rows if r["batch"] == b)
                for b in range(BATCHES)]

    print(json.dumps(dict(
        scale=args.scale, nodes=M, nnz=int(E), batch=BATCH,
        fanouts=FANOUTS,
        jax_path="native" if bindings.available() else "numpy fallback",
        outputs_equal=same, port_ms_per_batch=per_batch("port_ms"),
        jax_ms_per_batch=per_batch("jax_ms"),
        jax_native_ms_per_batch=per_batch("jax_native_ms"),
        host_peak_rss_mb=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024, hops=rows)))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
