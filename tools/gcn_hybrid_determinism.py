"""Repeat the GCN step on a block-aligned hybrid on a CUDA card and say
which intermediate changes from run to run.

Usage (from the repo root; one card)::

    python tools/gcn_hybrid_determinism.py [--root DIR] [--runs N] [--out FILE]

The inputs are those of
``tests/test_torch_kernels_gpu.py::test_model_train_step_matches_cpu
[gcn_hybrid]``: a 4,000-node community graph with N(0, 1) edge values,
``gcn_norm``, a block-aligned hybrid (B=256), a 3-layer GCN (32 -> 48 ->
5) and one Adam step.  The CPU computes the step once; the card computes
it ``--runs`` times, each from a fresh graph, as the test does.  For
each intermediate (the degree as ``index_add_`` sums it, the degree as
``segment_sum_csr`` sums it where the measured checkout has it, the
normalised values, the block store, the loss, every gradient) the
script counts the distinct bit patterns over the runs and the runs equal
to the CPU's bits, and it counts the runs that fail the test's check
(loss and every gradient within 1e-4 of the CPU's, relative to max
|ref|).  ``--root`` is the checkout whose ``pytorch_sparse_tpu_torch``
is measured (default: this one), so that an older commit unpacked into
a directory that ``.gitignore`` lists can be measured in the same call.
It prints one JSON object and writes it to ``--out``.
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, E_DRAWS, N_COMM, B = 4_000, 120_000, 8, 256
WIDTHS = (32, 48, 5, 3)
GATE = 1e-4


def _bits(t) -> str:
    a = t.detach().contiguous().cpu().numpy()
    return hashlib.sha1(a.tobytes()).hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gcn_hybrid_determinism: no CUDA device is available",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import pytorch_sparse_tpu_torch as ts
    from pytorch_sparse_tpu_torch import segment
    from pytorch_sparse_tpu_torch.models import GCN, gcn_norm
    from pytorch_sparse_tpu_torch.ops.diag import fill_diag
    from pytorch_sparse_tpu_torch.ops.kernels import build_hybrid_from_tensor
    from pytorch_sparse_tpu_torch.testing import community_graph, rel_err

    if os.path.dirname(ts.__file__) != os.path.join(root,
                                                    "pytorch_sparse_tpu_torch"):
        raise RuntimeError(f"imported {ts.__file__}, not from {root}")
    has_csr_sum = hasattr(segment, "segment_sum_csr")

    x_np = np.random.RandomState(53).randn(M, WIDTHS[0]).astype(np.float32)
    labels_np = np.random.RandomState(54).randint(0, WIDTHS[2], M)
    partptr = np.linspace(0, M, N_COMM + 1).astype(np.int64)

    def step(dev):
        A = community_graph(M, E_DRAWS, n_comm=N_COMM, seed=2,
                            equal_sizes=True, device=dev)
        row, _, value = fill_diag(A, 1.0).coo()
        mid = {"deg index_add_": segment.segment_sum(value, row, M)}
        if has_csr_sum:
            rowptr = fill_diag(A, 1.0).storage.rowptr()
            mid["deg segment_sum_csr"] = segment.segment_sum_csr(value,
                                                                 rowptr)
        An = gcn_norm(A)
        mid["gcn_norm values"] = An.storage.value()
        adj = build_hybrid_from_tensor(An, B=B, min_density=0.02,
                                       partptr=partptr)
        adj.blocks.requires_grad_(True)
        mid["block store"] = adj.blocks
        model = GCN(*WIDTHS[:3], num_layers=WIDTHS[3],
                    generator=torch.Generator().manual_seed(5), device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        loss = model.loss(adj, torch.from_numpy(x_np).to(dev),
                          torch.from_numpy(labels_np).to(dev))
        loss.backward()
        opt.step()
        mid["loss"] = loss
        grads = [t.grad for t in list(model.parameters()) + [adj.blocks]]
        for i, g in enumerate(grads):
            mid[f"grad {i}"] = g
        return {k: v.detach().cpu() for k, v in mid.items()}

    ref = step("cpu")
    runs = [step("cuda") for _ in range(args.runs)]
    checked = ["loss"] + [k for k in ref if k.startswith("grad ")]
    failing = [i for i, r in enumerate(runs)
               if max(rel_err(r[k], ref[k]) for k in checked) > GATE]
    report = {
        "root": root, "runs": args.runs, "has_segment_sum_csr": has_csr_sum,
        "card": torch.cuda.get_device_name(0),
        "failing_runs": failing, "n_failing": len(failing),
        "cpu_loss": float(ref["loss"]),
        "losses": sorted({float(r["loss"]) for r in runs}),
        "intermediates": {
            k: {"distinct_bit_patterns": len({_bits(r[k]) for r in runs}),
                "runs_equal_to_cpu": sum(_bits(r[k]) == _bits(ref[k])
                                         for r in runs),
                "max_rel_err_vs_cpu": max(rel_err(r[k], ref[k])
                                          for r in runs)}
            for k in ref},
    }
    print(json.dumps(report), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
