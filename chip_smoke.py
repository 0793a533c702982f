#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits non-zero and prints no ``ok`` line):

1. Device: the card's name, count, and ``nvidia-smi`` name and power
   limit.  TF32 is set off for matmuls and cuDNN: every f32 route here
   is held to full-f32 results.
2. Build: ``nvcc`` compiles every kernel of ``pytorch_sparse_tpu_torch/
   csrc`` for ``sm_90a`` (one process per source, in parallel).
3. Kernels against their plain PyTorch versions on the card:
   ``csr_spmm`` on the ogbn-arxiv-scale uniform graph (M=169,343,
   E=1,166,243) at K=128, 256 and 40, with values and implicit ones, and
   on a matrix with empty rows; ``block_spmm`` on the community hybrid
   graph with f32 and bf16 stores.  Each is timed with CUDA events
   beside its plain version, a PyTorch library yardstick that the port
   never calls, and its bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s
   FP32 outside the tensor cores for f32 inputs, 989 TFLOP/s dense bf16
   tensor cores for a bf16 store times the split f32 operand).
4. The main path: routed ``spmm_sum`` through the public API, one leg per
   route, each held against a host CSR-walk oracle (head + tail + 512
   random rows): the uniform graph (CSR kernel), a Reddit-10%-density
   community graph (whole-matrix dense route, f32 store at store budget
   0 and bf16 store at 2e-3), and a Reddit-node-count community graph at
   a tenth of Reddit's edges (hybrid route: block kernel + CSR
   remainder).
5. GCN inference at the width of OGB's ogbn-arxiv GCN (3 layers,
   128 -> 256 -> 256 -> 40) on the normalized uniform graph, held
   against the same weights run layer by layer through the plain CSR
   version.

Launch counts are zeroed before the main path (phases 4 and 5, one call
each) and read right after it; every kernel must have launched.  The
script prints a ``kernels`` JSON line, the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

K = 128
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, FP32 without tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
KERNEL_GATE = 1e-5             # kernel vs plain version, relative to max |ref|
GATE_F32 = 1e-5                # route legs vs host oracle, f32 stores
GATE_BF16 = 2e-3               # bf16 dense store at store budget 2e-3

UNIFORM = (169_343, 1_166_243)             # ogbn-arxiv nodes and edges
REDDIT10 = (23_296, 16_000_000, 30)        # nodes, draws, communities
HYBRID = (232_965, 16_000_000, 200)
GCN_WIDTHS = (128, 256, 40, 3)             # in, hidden, out, layers
REPS = 20


class Failure(Exception):
    pass


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=REPS) -> float:
    """Per-call milliseconds: CUDA events around ``reps`` calls after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def errors(got, ref):
    """(max abs error, max abs error / max |ref|) in float64."""
    diff = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return diff, (diff / scale if scale > 0 else diff)


def oracle_check(A, mat, out, gate, seed=7, n_random=512):
    """Host CSR-walk oracle over head + tail + random rows (the rule of
    the JAX package's ``bench.py``).  Returns (ok, max_rel_err)."""
    M = A.sparse_size(0)
    rng = np.random.RandomState(seed)
    rows = np.unique(np.concatenate([
        np.arange(min(256, M)), np.arange(max(0, M - 256), M),
        rng.randint(0, M, n_random)]))
    rp = A.storage.numpy_view("rowptr")
    col = A.storage.numpy_view("col")
    value = A.storage.value()
    mat_np = mat.detach().float().cpu().numpy()
    starts, lens = rp[rows], rp[rows + 1] - rp[rows]
    rix = np.repeat(np.arange(rows.size), lens)
    e = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens) \
        + starts[rix]
    contrib = mat_np[col[e]].astype(np.float64)
    if value is not None:
        contrib = contrib * value.detach().float().cpu().numpy()[e, None]
    ref = np.zeros((rows.size, mat_np.shape[1]), np.float64)
    np.add.at(ref, rix, contrib)
    got = out.detach().float().cpu().numpy()[rows]
    err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))
    return err <= gate, err


def uniform_graph(ts, M, E, device, values=True):
    """The ogbn-arxiv-scale uniform graph of the JAX package's bench.py
    (same seed and draws)."""
    rng = np.random.RandomState(0)
    row = np.sort(rng.randint(0, M, E)).astype(np.int32)
    col = rng.randint(0, M, E).astype(np.int32)
    order = np.lexsort((col, row))
    val = rng.randn(E).astype(np.float32)
    return ts.SparseTensor(
        row=row[order], col=col[order], value=val if values else None,
        sparse_sizes=(M, M), is_sorted=True, trust_data=True, device=device)


def operand(torch, n, k, seed, device):
    x = np.random.RandomState(seed).randn(n, k).astype(np.float32)
    return torch.from_numpy(x).to(device)


def csr_bounds(M, E, K_, ncols, has_value):
    nbytes = 4 * (M + 1) + 4 * E + (4 * E if has_value else 0) \
        + 4 * K_ * ncols + 4 * M * K_
    flops = 2 * E * K_
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def block_bounds(torch, h, K_, ncolblocks, split_parts):
    """The block pass's bound.  f32 blocks price the products at the FP32
    rate; bf16 blocks at the bf16 tensor-core rate, times the bf16 terms
    an f32 operand splits into for the same accuracy (``split_parts``,
    as the bf16 dense store runs)."""
    B, nb, R = h.B, h.nb, h.rb_ptr.shape[0] - 1
    elem = h.blocks.element_size()
    nbytes = nb * B * B * elem + 4 * K_ * B * ncolblocks + 4 * (nb + R + 1) \
        + 4 * R * B * K_
    flops = 2 * nb * B * B * K_
    if h.blocks.dtype == torch.bfloat16:
        t_f = split_parts * flops / BF16_FLOPS_PER_S
    else:
        t_f = flops / FP32_FLOPS_PER_S
    t_b = nbytes / HBM_BYTES_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def route_bound_ms(torch, A, h, K_, split_parts):
    """Least time of one routed SpMM on an H100 SXM: the CSR bound, the
    dense product's bound, or the block pass's plus the remainder's."""
    def csr_of(M, col, has_value):
        return csr_bounds(M, col.shape[0], K_, int(np.unique(col).size),
                          has_value)[0]

    if h is None:
        return csr_of(A.sparse_size(0), A.storage.numpy_view("col"),
                      A.has_value())
    if hasattr(h, "dense"):
        M, N = h.M, h.N
        nbytes = M * N * h.dense.element_size() + 4 * N * K_ + 4 * M * K_
        if h.dense.dtype == torch.bfloat16:
            t_f = 2 * split_parts * M * N * K_ / BF16_FLOPS_PER_S
        else:
            t_f = 2 * M * N * K_ / FP32_FLOPS_PER_S
        return max(nbytes / HBM_BYTES_PER_S, t_f) * 1e3
    ms = block_bounds(torch, h, K_, int(torch.unique(h.slot_col).numel()),
                      split_parts)[0]
    if h.rest is not None:
        ms += csr_of(h.M, h.rest[1].cpu().numpy(), True)
    return ms


def gcn_plain(torch, csr_spmm_plain, model, adj, x):
    """The GCN forward with the same weights, written out layer by layer
    on the plain CSR version: the reference of the kernel run."""
    rowptr, col, value = adj.csr()
    n = len(model.weights)
    for i, (w, b) in enumerate(zip(model.weights, model.biases)):
        x = csr_spmm_plain(rowptr, col, value, x @ w) + b
        if i < n - 1:
            x = torch.relu(x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import pytorch_sparse_tpu_torch as ts
    from pytorch_sparse_tpu_torch import _build
    from pytorch_sparse_tpu_torch.models import GCN, gcn_norm
    from pytorch_sparse_tpu_torch.ops.kernels import (
        block_spmm, block_spmm_plain, csr_spmm, csr_spmm_plain)
    from pytorch_sparse_tpu_torch.ops.kernels.hybrid import (
        _PRECISION_PARTS, HybridFormat, get_block_precision,
        set_store_budget)
    from pytorch_sparse_tpu_torch.testing import community_graph

    device = torch.device("cuda")
    split_parts = _PRECISION_PARTS[get_block_precision()]
    failures = []
    results = {"phases": {}}

    def record(phase, **kw):
        results["phases"].setdefault(phase, []).append(kw)
        print(json.dumps({"phase": phase, **kw}), flush=True)

    def timer(fn):
        return time_ms(torch, fn)

    sync = torch.cuda.synchronize

    # ---- 1. device ----------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(card, flush=True)
    record("device", kind=kind, count=count, card=card,
           torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build -------------------------------------------------------
    t0 = time.time()
    _build.build()
    logs = {n: [ln for ln in _build.build_log(n).splitlines()
                if "registers" in ln or "spill" in ln]
            for n in _build.SOURCES}
    record("build", seconds=round(time.time() - t0, 2), ptxas=logs)

    # ---- graphs (set-up) -------------------------------------------------
    t0 = time.time()
    Mu, Eu = UNIFORM
    A_u = uniform_graph(ts, Mu, Eu, device)
    A_u1 = uniform_graph(ts, Mu, Eu, device, values=False)
    Mr, Er, nr = REDDIT10
    A_r = community_graph(Mr, Er, n_comm=nr, seed=1, equal_sizes=True,
                          device=device)
    Mh, Eh, nh = HYBRID
    A_h = community_graph(Mh, Eh, n_comm=nh, seed=1, equal_sizes=True,
                          device=device)
    set_store_budget(0.0)
    h32 = A_h.storage.hybrid(K_hint=K)
    if not isinstance(h32, HybridFormat):
        raise Failure(f"community hybrid graph routed to {h32!r}")
    record("setup", seconds=round(time.time() - t0, 2),
           uniform_nnz=A_u.nnz(), reddit10_nnz=A_r.nnz(),
           hybrid_nnz=A_h.nnz(), hybrid=repr(h32))

    # ---- 3. kernels against their plain versions -------------------------
    kernels = []
    try:
        rowptr, col, val = A_u.csr()
        ncols = int(np.unique(A_u.storage.numpy_view("col")).size)
        keep = np.flatnonzero(A_u.storage.numpy_view("row") % 3 != 0)
        A_e = ts.SparseTensor(
            row=A_u.storage.numpy_view("row")[keep],
            col=A_u.storage.numpy_view("col")[keep],
            value=val[torch.from_numpy(keep).to(device)],
            sparse_sizes=(Mu, Mu), is_sorted=True, trust_data=True,
            device=device)
        cases = []
        for label, (rp, cl, vv), k in [
            ("values K=128", (rowptr, col, val), 128),
            ("values K=256", (rowptr, col, val), 256),
            ("values K=40", (rowptr, col, val), 40),
            ("ones K=128", (rowptr, col, None), 128),
            ("ones K=40", (rowptr, col, None), 40),
            ("empty rows K=40", A_e.csr(), 40),
        ]:
            x = operand(torch, Mu, k, 2, device)
            got = csr_spmm(rp, cl, vv, x)
            ref = csr_spmm_plain(rp, cl, vv, x)
            sync()
            abs_e, rel_e = errors(got, ref)
            ok = rel_e <= KERNEL_GATE
            case = {"case": label, "max_abs_err": abs_e, "max_rel_err": rel_e,
                    "ok": ok}
            if label == "values K=128":
                csr_t = torch.sparse_csr_tensor(rp, cl, vv, (Mu, Mu))
                case["ms"] = timer(lambda: csr_spmm(rp, cl, vv, x))
                case["plain_ms"] = timer(lambda: csr_spmm_plain(rp, cl, vv, x))
                case["library_ms"] = timer(lambda: csr_t @ x)
                case["bound_ms"], case["bound_by"] = csr_bounds(
                    Mu, Eu, k, ncols, True)
            cases.append(case)
            if not ok:
                failures.append(f"csr_spmm {label}: rel err {rel_e:.3g}")
        head = cases[0]
        kernels.append({
            "name": "csr_spmm", "route": "cuda",
            "source": "pytorch_sparse_tpu_torch/csrc/csr_spmm.cu",
            "replaces": "pytorch_sparse_tpu/ops/kernels/ell.py:309",
            "launches": None,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(c["max_rel_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "torch.sparse_csr_tensor(...) @ x",
            "shape": f"M={Mu} E={Eu} K=128 f32 values", "cases": cases,
        })
        del A_e

        B = h32.B
        C = -(-Mh // B)
        xh = operand(torch, Mh, K, 3, device)
        xb = torch.cat([xh, xh.new_zeros((C * B - Mh, K))])
        ncb = int(torch.unique(h32.slot_col).numel())
        nb = h32.nb
        slot_row = h32.slot_row.long()
        cases = []
        for label, blocks in [("f32 store K=128", h32.blocks),
                              ("bf16 store K=128",
                               h32.blocks.to(torch.bfloat16))]:
            got = block_spmm(blocks, h32.slot_col, h32.rb_ptr, xb)
            ref = block_spmm_plain(blocks, h32.slot_col, h32.rb_ptr, xb)
            sync()
            abs_e, rel_e = errors(got, ref)
            ok = rel_e <= KERNEL_GATE
            del got, ref

            def library():
                tmp = torch.bmm(blocks[:nb].float(),
                                xb.view(C, B, K)[h32.slot_col.long()])
                out = torch.zeros((h32.rb_ptr.shape[0] - 1, B, K),
                                  device=device)
                return out.index_add_(0, slot_row, tmp)

            view = HybridFormat(blocks, h32.slot_row, h32.slot_col, h32.rb_ptr,
                                None, h32.M, h32.N, B, h32.dense_nnz)
            bound_ms, bound_by = block_bounds(torch, view, K, ncb, split_parts)
            case = {
                "case": label, "max_abs_err": abs_e, "max_rel_err": rel_e,
                "ok": ok,
                "ms": timer(lambda: block_spmm(blocks, h32.slot_col,
                                               h32.rb_ptr, xb)),
                "plain_ms": timer(lambda: block_spmm_plain(
                    blocks, h32.slot_col, h32.rb_ptr, xb)),
                "library_ms": timer(library),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            cases.append(case)
            if not ok:
                failures.append(f"block_spmm {label}: rel err {rel_e:.3g}")
            del blocks, view
        head = cases[0]
        kernels.append({
            "name": "block_spmm", "route": "cuda",
            "source": "pytorch_sparse_tpu_torch/csrc/block_spmm.cu",
            "replaces": "pytorch_sparse_tpu/ops/kernels/hybrid.py:553",
            "launches": None,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(c["max_rel_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "torch.bmm of the gathered blocks + index_add_",
            "shape": f"M={Mh} nb={nb} B={B} K={K} f32 store",
            "cases": cases,
        })
        del xb
    except Exception:
        failures.append("phase 3 (kernels): " + traceback.format_exc())

    # ---- 4 + 5. the main path, with launch counts ------------------------
    legs = []
    x_u = operand(torch, Mu, K, 2, device)
    x_r = operand(torch, Mr, K, 2, device)
    x_h = operand(torch, Mh, K, 2, device)
    A_r2 = A_r.set_value(A_r.storage.value(), layout="coo")  # no cached view
    A_g = gcn_norm(A_u1)
    in_dim, hid, out_dim, nlayers = GCN_WIDTHS
    model = GCN(in_dim, hid, out_dim, num_layers=nlayers,
                generator=torch.Generator().manual_seed(0), device=device)
    x_g = operand(torch, Mu, in_dim, 5, device)

    leg_specs = [
        ("uniform (ogbn-arxiv scale)", A_u, x_u, 0.0, GATE_F32, "csr"),
        ("community Reddit-10%, store budget 0", A_r, x_r, 0.0, GATE_F32,
         "dense[torch.float32]"),
        ("community Reddit-10%, store budget 2e-3", A_r2, x_r, 2e-3,
         GATE_BF16, "dense[torch.bfloat16]"),
        ("community hybrid (Reddit nodes, 1/10 edges), store budget 0", A_h,
         x_h, 0.0, GATE_F32, "hybrid[torch.float32]"),
    ]
    csr_spmm.launches = 0
    block_spmm.launches = 0
    outs = []
    with torch.inference_mode():
        for label, A, x, budget, gate, want in leg_specs:
            set_store_budget(budget)
            try:
                outs.append(ts.spmm_sum(A, x))
            except Exception:
                failures.append(f"leg {label}: " + traceback.format_exc())
                outs.append(None)
        set_store_budget(0.0)
        try:
            logits = model(A_g, x_g)
            sync()
        except Exception:
            failures.append("phase 5 (GCN): " + traceback.format_exc())
            logits = None
    launches = {"csr_spmm": csr_spmm.launches,
                "block_spmm": block_spmm.launches}
    for k_ in kernels:
        k_["launches"] = launches[k_["name"]]
    for name, n in launches.items():
        if n == 0:
            failures.append(f"{name} was not launched on the main path")

    with torch.inference_mode():
        for (label, A, x, budget, gate, want), out in zip(leg_specs, outs):
            if out is None:
                continue
            h = A.storage.hybrid(auto=False)
            if h is None:
                route = "csr"
            else:
                store = getattr(h, "blocks", getattr(h, "dense", None))
                route = (f"{type(h).__name__.replace('Format', '').lower()}"
                         f"[{store.dtype}]")
            ok, err = oracle_check(A, x, out, gate)
            finite = bool(torch.isfinite(out).all())
            set_store_budget(budget)
            ms = timer(lambda: ts.spmm_sum(A, x))
            set_store_budget(0.0)
            # The CSR kernel on the same graph: the route the router
            # declined (its constants were priced for a TPU).
            csr_ms = timer(lambda: csr_spmm(*A.csr(), x))
            bound = route_bound_ms(torch, A, h, K,
                                   _PRECISION_PARTS[get_block_precision()])
            leg = {"leg": label, "route": route, "expected_route": want,
                   "nnz": A.nnz(), "oracle_rel_err": err, "gate": gate,
                   "ms": ms, "nnz_per_s": A.nnz() / (ms * 1e-3),
                   "bound_ms": bound, "csr_kernel_ms": csr_ms,
                   "card": card}
            record("route", **leg)
            legs.append(leg)
            if not (ok and finite and route == want):
                failures.append(f"leg {label}: route {route} (want {want}), "
                                f"oracle err {err:.3g} (gate {gate})")
        del outs

        if logits is not None:
            # The plain reference is written for the CSR route only.
            csr_route = A_g.storage.hybrid(auto=False) is None
            ref = gcn_plain(torch, csr_spmm_plain, model, A_g, x_g)
            sync()
            _, rel_e = errors(logits, ref)
            finite = bool(torch.isfinite(logits).all())
            shape_ok = tuple(logits.shape) == (Mu, out_dim)
            ms = timer(lambda: model(A_g, x_g))
            plain_ms = timer(
                lambda: gcn_plain(torch, csr_spmm_plain, model, A_g, x_g))
            record("gcn", layers=nlayers,
                   widths=[in_dim] + [hid] * (nlayers - 1) + [out_dim],
                   nodes=Mu, nnz=A_g.nnz(), csr_route=csr_route,
                   rel_err_vs_plain=rel_e, gate=KERNEL_GATE,
                   ms_per_forward=ms, plain_ms_per_forward=plain_ms,
                   card=card)
            if not (csr_route and finite and shape_ok
                    and rel_e <= KERNEL_GATE):
                failures.append(f"GCN: csr route={csr_route} finite={finite} "
                                f"shape={logits.shape} "
                                f"rel err vs plain {rel_e:.3g}")

    results.update(kernels=kernels, launches=launches, failures=failures,
                   card=card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    for f_ in failures:
        print("FAILED:", f_, file=sys.stderr)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    if failures:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
