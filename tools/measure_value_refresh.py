"""Measure what holding a routed view against its values costs on a CUDA
card: time, a device trace, and peak device memory.

Usage (from the repo root; one card)::

    python tools/measure_value_refresh.py [--root DIR] [--out FILE]

``--root`` is the checkout whose ``pytorch_sparse_tpu_torch`` is
measured (default: this one), so that two commits can be compared in one
run on one card: unpack the other commit into a directory that
``.gitignore`` lists and run the script once with each root.  Graphs,
widths and seeds are ``chip_smoke.py``'s, taken from this checkout.
Each run prints one JSON object (and writes it to ``--out``):

* ``store_bytes``, ``index_and_source_bytes``: the community hybrid
  graph's block store, and what its view keeps beside it to follow
  writes to the values (none before that was added).
* ``leg``: the community hybrid graph's routed forward at K=128 (phase
  4's leg, ``spmm_sum`` under ``inference_mode``): its time by CUDA
  events, and a ``torch.profiler`` trace of ``TRACE_CALLS`` calls, giving
  each device kernel's time per call, the device's busy time per call
  and the host's wall time per call around the same calls.
* ``value_training``: ``VALUE_STEPS`` SGD steps on that graph's edge
  values (and a feature matrix that requires grad), the last step's
  output kept alive through the next forward as a training loop does:
  the time per step and ``torch.cuda.max_memory_allocated`` above what
  was allocated before the steps, beside the block store's bytes.
* ``aligned_gcn``: phase 9's two GCN steps on the block-aligned hybrid,
  the store frozen and then trained, with each step's peak bytes above
  its start.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_CALLS = 10
VALUE_STEPS = 3


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("measure_value_refresh: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.root))
    import pytorch_sparse_tpu_torch as ts
    from pytorch_sparse_tpu_torch import _build
    from pytorch_sparse_tpu_torch.models import GCN, gcn_norm
    from pytorch_sparse_tpu_torch.ops.kernels import build_hybrid_from_tensor
    from pytorch_sparse_tpu_torch.ops.kernels.hybrid import set_store_budget
    from pytorch_sparse_tpu_torch.testing import community_graph

    if os.path.dirname(ts.__file__) != os.path.join(
            os.path.abspath(args.root), "pytorch_sparse_tpu_torch"):
        raise RuntimeError(f"imported {ts.__file__}, not from {args.root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    sync = torch.cuda.synchronize
    res = {"root": os.path.abspath(args.root), "card": cs.nvidia_smi_line(),
           "torch": torch.__version__}
    t0 = time.time()
    _build.build(["csr_spmm", "block_spmm", "edge_dot"])
    res["build_s"] = time.time() - t0

    Mh, Eh, nh = cs.HYBRID
    A_h = community_graph(Mh, Eh, n_comm=nh, seed=1, equal_sizes=True,
                          device=device)
    set_store_budget(0.0)
    h = A_h.storage.hybrid(K_hint=cs.K)
    res["view"] = repr(h)
    res["store_bytes"] = _nbytes(h.blocks)
    index = getattr(h, "index", None)  # what a view keeps to follow writes
    res["index_and_source_bytes"] = 0 if index is None else sum(
        _nbytes(t) for t in [h.source, index.first, index.pos, index.rest,
                             index.rest_t, *(t for d in index.dups
                                             for t in d)])
    del h
    x_h = cs.operand(torch, Mh, cs.K, 2, device)

    # ---- the routed forward leg: time and trace --------------------------
    def leg():
        with torch.inference_mode():
            return ts.spmm_sum(A_h, x_h)

    leg_ms = cs.time_ms(torch, leg)
    from torch.profiler import ProfilerActivity, profile

    leg()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(TRACE_CALLS):
            leg()
        sync()
        wall = (time.perf_counter() - t1) * 1e3 / TRACE_CALLS
    kernels = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type.name == "CUDA":
            kernels[evt.key] = {"ms_per_call": us / 1e3 / TRACE_CALLS,
                                "count_per_call": evt.count / TRACE_CALLS}
    busy = sum(k["ms_per_call"] for k in kernels.values())
    res["leg"] = {"ms": leg_ms, "traced_wall_ms_per_call": wall,
                  "device_busy_ms_per_call": busy,
                  "kernels": dict(sorted(
                      kernels.items(), key=lambda kv: -kv[1]["ms_per_call"]))}

    # ---- value training on the routed graph -----------------------------
    v = A_h.storage.value().detach().clone().requires_grad_(True)
    A_v = A_h.set_value(v, layout="coo")
    x = x_h.detach().clone().requires_grad_(True)
    gout = cs.operand(torch, Mh, cs.K, 21, device)
    opt = torch.optim.SGD([v], lr=1e-3)

    def step():
        opt.zero_grad()
        out_ = ts.spmm_sum(A_v, x)
        (out_ * gout).sum().backward()
        opt.step()
        return out_

    out = step()  # builds the view
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    for _ in range(VALUE_STEPS):
        out = step()
    sync()
    step_ms = (time.perf_counter() - t1) * 1e3 / VALUE_STEPS
    res["value_training"] = {
        "steps": VALUE_STEPS, "ms_per_step": step_ms,
        "base_bytes": base,
        "peak_above_base_bytes": torch.cuda.max_memory_allocated() - base,
        "view": repr(A_v.storage.hybrid(auto=False))}
    del out, v, A_v, x, opt, gout

    # ---- phase 9: the aligned hybrid's GCN steps -------------------------
    in_dim, hid, out_dim, nlayers = cs.GCN_WIDTHS
    A_hn = gcn_norm(A_h.fill_value(1.0))
    import numpy as np

    partptr = np.linspace(0, Mh, nh + 1).astype(np.int64)
    h9 = build_hybrid_from_tensor(A_hn, B=cs.ALIGNED_B, partptr=partptr)
    x_9 = cs.operand(torch, Mh, in_dim, 72, device)
    labels_9 = cs.seeded_labels(torch, x_9, out_dim, 73, device)
    model = GCN(in_dim, hid, out_dim, num_layers=nlayers,
                generator=torch.Generator().manual_seed(0), device=device)
    gopt = torch.optim.Adam(model.parameters(), lr=1e-2)
    steps = {}
    for name, trains in (("warm-up", False), ("store frozen", False),
                         ("store trains", True)):
        h9.blocks.requires_grad_(trains)
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        gopt.zero_grad()
        model.loss(h9, x_9, labels_9).backward()
        gopt.step()
        sync()
        steps[name] = {
            "ms": (time.perf_counter() - t1) * 1e3, "base_bytes": base,
            "peak_above_base_bytes": torch.cuda.max_memory_allocated() - base}
        h9.blocks.requires_grad_(False)
        h9.blocks.grad = None
    steps.pop("warm-up")
    res["aligned_gcn"] = {
        "store_bytes": _nbytes(h9.blocks),
        "steps": steps}

    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
