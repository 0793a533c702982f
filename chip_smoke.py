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
   on a matrix with empty rows; ``block_spmm`` and ``block_spmm_t`` on
   the community hybrid graph with f32 and bf16 stores; ``edge_dot`` on
   the uniform graph at K=128, 256 and 40, on the empty-rows matrix, and
   at K=128 on the community hybrid and Reddit-10% graphs of phase 4b.
   ``csr_spmm_minmax`` (min and max; ``out`` and ``arg`` must equal the
   plain version's exactly) on the uniform graph at K=128, 256 and 40
   with values and implicit ones, on the empty-rows matrix, on a
   tie-heavy integer operand, with a bf16 operand, and at K=128 on the
   community hybrid and Reddit-10% graphs; ``minmax_edge_dot`` and
   ``minmax_spmm_t`` on the max argout of each f32 case;
   ``edge_softmax`` at 8 heads and 1 on the uniform graph with
   self-loops and on the community hybrid graph.
   Each is timed with CUDA events beside its plain version, a PyTorch
   library yardstick that the port never calls (none computes an
   argout), and its bound on an H100
   SXM (3.35 TB/s; 67 TFLOP/s FP32 outside the tensor cores for f32
   inputs, 989 TFLOP/s dense bf16 tensor cores for a bf16 store times
   the split f32 operand).
4. The main path: routed ``spmm_sum`` through the public API, one leg per
   route, each held against a host CSR-walk oracle (head + tail + 512
   random rows): the uniform graph (CSR kernel), a Reddit-10%-density
   community graph (whole-matrix dense route, f32 store at store budget
   0 and bf16 store at 2e-3), and a Reddit-node-count community graph at
   a tenth of Reddit's edges (hybrid route: block kernel + CSR
   remainder).
4b. Backward legs: on the uniform (CSR), Reddit-10% (dense f32) and
   community hybrid (hybrid f32) graphs, ``spmm_sum(A.set_value(v), x)``
   with ``v`` and ``x`` requiring grad, backpropagated from a seeded
   ``gout``.  ``grad_x`` is held against a float64 host CSC walk (head +
   tail + 512 random columns), ``grad_v`` against a float64 host dot over
   4096 random edges.
4c. Min/max legs: ``spmm_max`` and ``spmm_min`` through the public API
   on the uniform graph and the community hybrid graph (K=128, f32,
   N(0,1) values), with both gradients from a seeded ``gout``.  ``out``
   and ``arg`` are held against a host row walk (head + tail + 512
   random rows; ``arg`` exactly), ``grad_x`` against a float64 host CSC
   walk through the argout and ``grad_v`` against a float64 host dot on
   4096 edges.
5. GCN inference at the width of OGB's ogbn-arxiv GCN (3 layers,
   128 -> 256 -> 256 -> 40) on the normalized uniform graph, held
   against the same weights run layer by layer through the plain CSR
   version.
6. GCN training, same model, graph and seed as phase 5, with seeded
   labels and ``torch.optim.Adam(lr=1e-2)``: one step at dropout 0 whose
   loss and every parameter gradient are held against the same step
   through torch autograd on the plain CSR version (with the kernel
   run's ReLU decisions; the entries where the plain run's own decisions
   differ are counted, and may be at most 1e-5 of the hidden entries),
   then three steps at
   dropout 0.5 from a seeded CUDA generator, whose loss must stay finite
   and fall.  The step needs no value gradient, so it must not launch
   ``edge_dot``.
7. GAT inference at the GAT paper's transductive architecture
   (Velickovic et al., ICLR 2018, section 3.3: 8 heads x 8 features,
   ELU, one output head) at ogbn-arxiv width, 128 -> 8x8 -> 40, on the
   uniform graph with self-loops, held against the same weights run
   through the plain edge-softmax and CSR versions.

The main path is phases 4, 4b, 4c, 5, 6 and 7, each driven once with
every launch count set to 0 just before it and read just after it.  Each
phase must launch the kernels it runs (4: ``csr_spmm`` and
``block_spmm``; 4b: those and ``block_spmm_t`` and ``edge_dot``; 4c:
``csr_spmm_minmax``, ``minmax_edge_dot`` and ``minmax_spmm_t``, and no
block kernel; 5 and 6: ``csr_spmm``; 7: ``edge_softmax`` twice and
``csr_spmm`` once per head plus once), and the ``kernels`` line reports
each kernel's launches summed over them.
The script prints a ``kernels`` JSON line, the ``nvidia-smi`` line, and
as its last line ``{"ok": true, "device": {...}}``.
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
RELU_FLIP_SHARE = 1e-5         # ReLU decisions the GCN reference may differ on

UNIFORM = (169_343, 1_166_243)             # ogbn-arxiv nodes and edges
REDDIT10 = (23_296, 16_000_000, 30)        # nodes, draws, communities
HYBRID = (232_965, 16_000_000, 200)
GCN_WIDTHS = (128, 256, 40, 3)             # in, hidden, out, layers
GAT_WIDTHS = (128, 8, 8, 40)               # in, heads, per-head, out
REPS = 20
PLAIN_REPS = 5                 # the slower plain versions of slice 3


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


def walk_rows(A, n_random, seed):
    """Head + tail + random rows, and for each edge of them: its row's
    position in that list, its edge id."""
    M = A.sparse_size(0)
    rng = np.random.RandomState(seed)
    rows = np.unique(np.concatenate([
        np.arange(min(256, M)), np.arange(max(0, M - 256), M),
        rng.randint(0, M, n_random)]))
    rp = A.storage.numpy_view("rowptr")
    starts, lens = rp[rows], rp[rows + 1] - rp[rows]
    rix = np.repeat(np.arange(rows.size), lens)
    e = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens) \
        + starts[rix]
    return rows, rix, e


def oracle_check(A, mat, out, gate, seed=7, n_random=512):
    """Host CSR-walk oracle over head + tail + random rows (the rule of
    the JAX package's ``bench.py``).  Returns (ok, max_rel_err)."""
    rows, rix, e = walk_rows(A, n_random, seed)
    col = A.storage.numpy_view("col")
    value = A.storage.value()
    mat_np = mat.detach().float().cpu().numpy()
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


def block_bounds(torch, blocks, nb, nout, nsrc, n_index, K_, split_parts):
    """A block pass's bound: ``nb`` blocks of ``blocks``' size and dtype,
    ``nsrc`` source blocks of the operand read and ``nout`` output blocks
    written (``K_`` wide), and ``n_index`` int32 schedule entries.  f32
    blocks price the products at the FP32 rate; bf16 blocks at the bf16
    tensor-core rate, times the bf16 terms an f32 operand splits into
    for the same accuracy (``split_parts``, as the bf16 dense store
    runs)."""
    B = blocks.shape[1]
    elem = blocks.element_size()
    nbytes = nb * B * B * elem + 4 * K_ * B * nsrc + 4 * n_index \
        + 4 * nout * B * K_
    flops = 2 * nb * B * B * K_
    if blocks.dtype == torch.bfloat16:
        t_f = split_parts * flops / BF16_FLOPS_PER_S
    else:
        t_f = flops / FP32_FLOPS_PER_S
    t_b = nbytes / HBM_BYTES_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def forward_block_bounds(torch, h, blocks, K_, split_parts):
    """``block_bounds`` of the forward pass over ``h``'s slots."""
    R = h.rb_ptr.shape[0] - 1
    ncb = int(torch.unique(h.slot_col).numel())
    return block_bounds(torch, blocks, h.nb, R, ncb, h.nb + R + 1, K_,
                        split_parts)


def transpose_block_bounds(torch, h, blocks, K_, split_parts):
    """``block_bounds`` of the transpose pass: rows and columns swap,
    and ``order_t`` joins the schedule."""
    C = h.cb_ptr.shape[0] - 1
    nrb = int(torch.unique(h.slot_row).numel())
    return block_bounds(torch, blocks, h.nb, C, nrb, 2 * h.nb + C + 1, K_,
                        split_parts)


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
    ms = forward_block_bounds(torch, h, h.blocks, K_, split_parts)[0]
    if h.rest is not None:
        ms += csr_of(h.M, h.rest[1].cpu().numpy(), True)
    return ms


def gcn_plain(torch, csr_spmm_plain, model, adj, x, masks=None):
    """The GCN forward with the same weights, written out layer by layer
    on the plain CSR version: the reference of the kernel run.  With
    ``masks`` (one boolean tensor per hidden layer) each ReLU keeps
    exactly the entries its mask marks, so that the reference takes
    another run's ReLU decisions."""
    rowptr, col, value = adj.csr()
    n = len(model.weights)
    for i, (w, b) in enumerate(zip(model.weights, model.biases)):
        x = csr_spmm_plain(rowptr, col, value, x @ w) + b
        if i < n - 1:
            x = torch.relu(x) if masks is None else x * masks[i]
    return x


def plain_loss(torch, csr_spmm_plain, model, adj, x, labels, masks=None):
    """Mean negative log-likelihood of the ``gcn_plain`` logits."""
    logp = torch.log_softmax(
        gcn_plain(torch, csr_spmm_plain, model, adj, x, masks), dim=-1)
    return -logp.gather(-1, labels[:, None])[:, 0].mean()


def relu_masks(torch, spmm, model, adj, x):
    """The ReLU decisions (pre-activation > 0) of each hidden layer of a
    GCN forward whose aggregation is ``spmm(adj, h)``."""
    masks = []
    with torch.no_grad():
        for w, b in list(zip(model.weights, model.biases))[:-1]:
            x = spmm(adj, x @ w) + b
            masks.append(x > 0)
            x = torch.relu(x)
    return masks


def _segment_sums(contrib, lens):
    """Row sums of ``contrib`` over consecutive segments of ``lens``
    rows (empty segments give zero rows), in float64."""
    out = np.zeros((lens.size,) + contrib.shape[1:], np.float64)
    nz = lens > 0
    if contrib.shape[0]:
        starts = np.cumsum(lens) - lens
        out[nz] = np.add.reduceat(contrib, starts[nz], axis=0)
    return out


def grad_x_oracle_check(A, gout, grad_x, gate, arg=None, seed=9,
                        n_random=512):
    """``grad_x = A^T gout`` against a float64 host CSC walk over head +
    tail + random columns; given the argout ``arg`` of a min/max SpMM,
    only the ``(row, k)`` each edge won count.  Returns (ok,
    max_rel_err)."""
    N = A.sparse_size(1)
    rng = np.random.RandomState(seed)
    cols = np.unique(np.concatenate([
        np.arange(min(256, N)), np.arange(max(0, N - 256), N),
        rng.randint(0, N, n_random)]))
    cp = A.storage.numpy_view("colptr")
    perm = A.storage.numpy_view("csr2csc")
    row = A.storage.numpy_view("row")
    value = A.storage.value()
    starts, lens = cp[cols], cp[cols + 1] - cp[cols]
    cix = np.repeat(np.arange(cols.size), lens)
    p = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens) \
        + starts[cix]
    e = perm[p]
    gout_np = gout.detach().float().cpu().numpy()
    contrib = gout_np[row[e]].astype(np.float64)
    if arg is not None:
        contrib[arg.cpu().numpy()[row[e]] != e[:, None]] = 0.0
    if value is not None:
        contrib *= value.detach().float().cpu().numpy()[e, None]
    ref = _segment_sums(contrib, lens)
    got = grad_x.detach().float().cpu().numpy()[cols]
    err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))
    return err <= gate, err


def grad_v_oracle_check(A, x, gout, grad_v, gate, arg=None, seed=10,
                        n_edges=4096):
    """``grad_v[e] = <x[col e], gout[row e]>`` against a float64 host dot
    over random edges; given the argout ``arg`` of a min/max SpMM, only
    the ``k`` each edge won count.  Returns (ok, max_rel_err)."""
    rng = np.random.RandomState(seed)
    e = rng.randint(0, A.nnz(), n_edges)
    row = A.storage.numpy_view("row")[e]
    col = A.storage.numpy_view("col")[e]
    x_np = x.detach().double().cpu().numpy()
    g_np = gout.detach().double().cpu().numpy()
    prod = x_np[col] * g_np[row]
    if arg is not None:
        prod[arg.cpu().numpy()[row] != e[:, None]] = 0.0
    ref = prod.sum(-1)
    got = grad_v.detach().double().cpu().numpy()[e]
    err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))
    return err <= gate, err


def minmax_bounds(M, E, K_, ncols, has_value, elem=4):
    """K6's bound: K1's bytes at the operand's element size, plus the
    (M, K) int32 argout."""
    nbytes = 4 * (M + 1) + 4 * E + (elem * E if has_value else 0) \
        + elem * K_ * ncols + elem * M * K_ + 4 * M * K_
    t_b, t_f = nbytes / HBM_BYTES_PER_S, 2 * E * K_ / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def minmax_bwd_bounds(torch, col, arg, N, has_value):
    """The bounds of K7a and K7b on this argout: each reads arg and the
    structure once; K7a reads only the x entries whose (row, k) some
    edge won (distinct (col, k) pairs) and writes (E,), K7b reads only
    the won g entries and writes (N, K).  Both are bytes-bound (2 flops
    per won entry)."""
    M, K_ = arg.shape
    E = col.shape[0]
    won = arg < E
    n_won = int(won.sum())
    k_idx = torch.arange(K_, device=arg.device).expand(M, K_)[won]
    pairs = col.long()[arg[won].long()] * K_ + k_idx
    n_x = int(torch.unique(pairs).numel())
    common = 4 * M * K_ + 4 * E
    b7a = 4 * (M + 1) + common + 4 * M * K_ + 4 * n_x + 4 * E
    b7b = 4 * (N + 1) + common + 4 * E + (4 * E if has_value else 0) \
        + 4 * n_won + 4 * N * K_
    t_f = 2 * n_won / FP32_FLOPS_PER_S
    out = []
    for nbytes in (b7a, b7b):
        t_b = nbytes / HBM_BYTES_PER_S
        out.append((max(t_b, t_f) * 1e3,
                    "bytes" if t_b >= t_f else "operations"))
    return out


def minmax_oracle_check(A, mat, out, arg, is_min, gate, seed=11,
                        n_random=512):
    """``out`` and ``arg`` of ``spmm_min``/``spmm_max`` against a host row
    walk (head + tail + random rows): each product rounded to float32
    as the contract rounds it to the operand's dtype, compared in
    float64, the first edge kept on ties, the sentinel on empty rows.
    Returns (ok, out_rel_err, arg_mismatches)."""
    rows, rix, e = walk_rows(A, n_random, seed)
    col = A.storage.numpy_view("col")
    E = A.nnz()
    mat_np = mat.detach().float().cpu().numpy()
    h = mat_np[col[e]]
    value = A.storage.value()
    if value is not None:
        h = h * value.detach().float().cpu().numpy()[e, None]  # f32 product
    h = h.astype(np.float64)
    ref = np.zeros((rows.size, mat_np.shape[1]), np.float64)
    ref_arg = np.full(ref.shape, E, np.int64)
    seen = np.zeros(rows.size, bool)
    for i in range(h.shape[0]):          # edges in CSR order
        r = rix[i]
        if not seen[r]:
            ref[r], ref_arg[r], seen[r] = h[i], e[i], True
            continue
        better = h[i] < ref[r] if is_min else h[i] > ref[r]
        ref[r] = np.where(better, h[i], ref[r])
        ref_arg[r] = np.where(better, e[i], ref_arg[r])
    got = out.detach().double().cpu().numpy()[rows]
    mism = int((arg.cpu().numpy()[rows] != ref_arg).sum())
    err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))
    return err <= gate and mism == 0, err, mism


def gat_plain(torch, model, adj, x, edge_softmax_plain, csr_spmm_plain):
    """The GAT forward with the same weights, written out layer by layer
    on the plain edge-softmax and CSR versions: the reference of the
    kernel run."""
    F = torch.nn.functional
    rowptr, col = adj.storage.rowptr(), adj.storage.col()
    row, coll = adj.storage.row().long(), col.long()

    def layer(h, a_src, a_dst):
        logits = F.leaky_relu((h * a_src).sum(-1)[row]
                              + (h * a_dst).sum(-1)[coll], 0.2)
        att = edge_softmax_plain(rowptr, logits)
        return torch.stack([
            csr_spmm_plain(rowptr, col, att[:, i].contiguous(),
                           h[:, i].contiguous())
            for i in range(h.shape[1])], dim=1)

    H, D = model.a1_src.shape
    h = layer((x @ model.w1).reshape(-1, H, D), model.a1_src, model.a1_dst)
    h = F.elu(h).reshape(-1, H * D)
    out_dim = model.w2.shape[1]
    h = layer((h @ model.w2).reshape(-1, 1, out_dim), model.a2_src,
              model.a2_dst)
    return h[:, 0]


def seeded_labels(torch, x, n_classes, seed, device):
    """Class labels the features predict: the arg-max of a seeded random
    projection of ``x``, so that training has a signal to fit."""
    proj = operand(torch, x.shape[1], n_classes, seed, device)
    return (x @ proj).argmax(-1)


def kernel_case(torch, label, got, ref, failures, name, **timing):
    """One compared case of a kernel: its errors against the plain
    version and, for the timed case, its times and bound."""
    abs_e, rel_e = errors(got, ref)
    ok = rel_e <= KERNEL_GATE
    if not ok:
        failures.append(f"{name} {label}: rel err {rel_e:.3g}")
    return {"case": label, "max_abs_err": abs_e, "max_rel_err": rel_e,
            "ok": ok, **timing}


def kernel_entry(name, source, replaces, cases, library, shape):
    """The ``kernels`` line entry of a kernel: the first case's times,
    the largest error over all cases.  ``launches`` is filled in from
    the main path's run."""
    head = cases[0]
    return {
        "name": name, "route": "cuda",
        "source": f"pytorch_sparse_tpu_torch/csrc/{source}",
        "replaces": f"pytorch_sparse_tpu/{replaces}", "launches": None,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_err": max(c["max_rel_err"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "library": library,
        "shape": shape, "cases": cases,
    }


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
    from pytorch_sparse_tpu_torch.models import GAT, GCN, gcn_norm
    from pytorch_sparse_tpu_torch.ops.kernels import (
        block_spmm, block_spmm_plain, block_spmm_t, block_spmm_t_plain,
        csr_spmm, csr_spmm_minmax, csr_spmm_minmax_plain, csr_spmm_plain,
        edge_dot, edge_dot_plain, edge_softmax, edge_softmax_plain,
        minmax_edge_dot, minmax_edge_dot_plain, minmax_spmm_t,
        minmax_spmm_t_plain)
    from pytorch_sparse_tpu_torch.ops.kernels.hybrid import (
        _PRECISION_PARTS, HybridFormat, get_block_precision,
        set_store_budget)
    from pytorch_sparse_tpu_torch.testing import community_graph

    device = torch.device("cuda")
    split_parts = _PRECISION_PARTS[get_block_precision()]
    failures = []
    results = {"phases": {}}
    counted = {"csr_spmm": csr_spmm, "block_spmm": block_spmm,
               "block_spmm_t": block_spmm_t, "edge_dot": edge_dot,
               "csr_spmm_minmax": csr_spmm_minmax,
               "minmax_edge_dot": minmax_edge_dot,
               "minmax_spmm_t": minmax_spmm_t, "edge_softmax": edge_softmax}

    def record(phase, **kw):
        results["phases"].setdefault(phase, []).append(kw)
        print(json.dumps({"phase": phase, **kw}), flush=True)

    def timer(fn):
        return time_ms(torch, fn)

    def plain_timer(fn):
        return time_ms(torch, fn, reps=PLAIN_REPS)

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
    # The uniform graph with self-loops and GCN weights: GCN's adjacency,
    # and GAT's (which reads only its structure).
    A_g = gcn_norm(A_u1)
    for A_ in (A_u, A_u1, A_h, A_r):  # the CSC views of min/max backward
        A_.storage.csc_row()
        A_.storage.colptr()
    record("setup", seconds=round(time.time() - t0, 2),
           uniform_nnz=A_u.nnz(), reddit10_nnz=A_r.nnz(),
           hybrid_nnz=A_h.nnz(), hybrid=repr(h32), gcn_gat_nnz=A_g.nnz())

    # ---- 3. kernels against their plain versions -------------------------
    t0 = time.time()
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
            timing = {}
            if label == "values K=128":
                csr_t = torch.sparse_csr_tensor(rp, cl, vv, (Mu, Mu))
                timing = {
                    "ms": timer(lambda: csr_spmm(rp, cl, vv, x)),
                    "plain_ms": timer(lambda: csr_spmm_plain(rp, cl, vv, x)),
                    "library_ms": timer(lambda: csr_t @ x)}
                timing["bound_ms"], timing["bound_by"] = csr_bounds(
                    Mu, Eu, k, ncols, True)
            cases.append(kernel_case(torch, label, got, ref, failures,
                                     "csr_spmm", **timing))
        kernels.append(kernel_entry(
            "csr_spmm", "csr_spmm.cu", "ops/kernels/ell.py:309", cases,
            "torch.sparse_csr_tensor(...) @ x",
            f"M={Mu} E={Eu} K=128 f32 values"))

        # edge_dot: the grad_value pass, <x[col e], g[row e]> per edge.
        # Besides the uniform graph (about 7 edges a row), the two
        # community graphs whose value gradients phase 4b takes: rows of
        # about 67 and 494 edges run the kernel's 32-edge loop many times.
        cases = []
        for label, A_, k in [
            ("K=128", A_u, 128),
            ("K=256", A_u, 256),
            ("K=40", A_u, 40),
            ("empty rows K=40", A_e, 40),
            ("community hybrid K=128", A_h, 128),
            ("community Reddit-10% K=128", A_r, 128),
        ]:
            rp, cl = A_.csr()[:2]
            n_ = A_.sparse_size(0)
            x = operand(torch, n_, k, 2, device)
            g = operand(torch, n_, k, 4, device)
            got = edge_dot(rp, cl, x, g)
            ref = edge_dot_plain(rp, cl, x, g)
            sync()
            timing = {}
            if label not in ("K=256", "empty rows K=40"):
                # K=40 is the known weak spot.
                timing = {
                    "ms": timer(lambda: edge_dot(rp, cl, x, g)),
                    "plain_ms": timer(lambda: edge_dot_plain(rp, cl, x, g)),
                    "library_ms": None}
                # The SpMM's bytes and flops: the (E,) output takes the
                # place of the values, the (M, K) g that of the output.
                timing["bound_ms"], timing["bound_by"] = csr_bounds(
                    n_, A_.nnz(), k,
                    int(np.unique(A_.storage.numpy_view("col")).size), True)
            if label == "K=128":
                # cuSPARSE's SDDMM: (g @ x^T) sampled at the pattern.
                try:
                    pattern = torch.sparse_csr_tensor(
                        rp, cl, torch.zeros_like(val), (Mu, Mu))
                    xt = x.t().contiguous()
                    lib_out = torch.sparse.sampled_addmm(
                        pattern, g, xt, beta=0.0).values()
                    timing["library_max_abs_err"] = errors(lib_out, ref)[0]
                    timing["library_ms"] = timer(
                        lambda: torch.sparse.sampled_addmm(
                            pattern, g, xt, beta=0.0))
                except (AttributeError, RuntimeError) as exc:
                    timing["library_missing"] = repr(exc)
            cases.append(kernel_case(torch, label, got, ref, failures,
                                     "edge_dot", **timing))
            del got, ref, x, g
        kernels.append(kernel_entry(
            "edge_dot", "edge_dot.cu", "ops/kernels/ell.py:353", cases,
            "torch.sparse.sampled_addmm(csr pattern, g, x^T, beta=0) "
            "(cuSPARSE SDDMM)", f"M={Mu} E={Eu} K=128 f32"))

        B = h32.B
        C = -(-Mh // B)
        R = h32.rb_ptr.shape[0] - 1
        xh = operand(torch, Mh, K, 3, device)
        xb = torch.cat([xh, xh.new_zeros((C * B - Mh, K))])
        gh = operand(torch, Mh, K, 4, device)
        gb = torch.cat([gh, gh.new_zeros((R * B - Mh, K))])
        nb = h32.nb
        slot_row = h32.slot_row.long()
        order_t = h32.order_t.long()
        col_t = h32.slot_col.long()[order_t]
        row_t = slot_row[order_t]
        fwd_cases, t_cases = [], []
        for label, blocks in [("f32 store K=128", h32.blocks),
                              ("bf16 store K=128",
                               h32.blocks.to(torch.bfloat16))]:
            fwd = (blocks, h32.slot_col, h32.rb_ptr, xb)
            got = block_spmm(*fwd)
            ref = block_spmm_plain(*fwd)
            sync()

            def library():
                tmp = torch.bmm(blocks[:nb].float(),
                                xb.view(C, B, K)[h32.slot_col.long()])
                out = torch.zeros((R, B, K), device=device)
                return out.index_add_(0, slot_row, tmp)

            bound_ms, bound_by = forward_block_bounds(torch, h32, blocks, K,
                                                      split_parts)
            fwd_cases.append(kernel_case(
                torch, label, got, ref, failures, "block_spmm",
                ms=timer(lambda: block_spmm(*fwd)),
                plain_ms=timer(lambda: block_spmm_plain(*fwd)),
                library_ms=timer(library), bound_ms=bound_ms,
                bound_by=bound_by))
            del got, ref

            tr = (blocks, h32.slot_row, h32.order_t, h32.cb_ptr, gb)
            got = block_spmm_t(*tr)
            ref = block_spmm_t_plain(*tr)
            sync()

            def library_t():
                tmp = torch.bmm(blocks[order_t].float().transpose(1, 2),
                                gb.view(R, B, K)[row_t])
                out = torch.zeros((C, B, K), device=device)
                return out.index_add_(0, col_t, tmp)

            bound_ms, bound_by = transpose_block_bounds(torch, h32, blocks,
                                                        K, split_parts)
            t_cases.append(kernel_case(
                torch, label, got, ref, failures, "block_spmm_t",
                ms=timer(lambda: block_spmm_t(*tr)),
                plain_ms=timer(lambda: block_spmm_t_plain(*tr)),
                library_ms=timer(library_t), bound_ms=bound_ms,
                bound_by=bound_by))
            del got, ref, blocks, fwd, tr
        shape = f"M={Mh} nb={nb} B={B} K={K} f32 store"
        kernels.append(kernel_entry(
            "block_spmm", "block_spmm.cu", "ops/kernels/hybrid.py:553",
            fwd_cases, "torch.bmm of the gathered blocks + index_add_",
            shape))
        kernels.append(kernel_entry(
            "block_spmm_t", "block_spmm.cu", "ops/kernels/hybrid.py:763",
            t_cases, "torch.bmm of the gathered transposed blocks + "
            "index_add_", shape))
        del xb, gb
    except Exception:
        failures.append("phase 3 (kernels): " + traceback.format_exc())

    # csr_spmm_minmax (K6, min and max) and its backward halves (K7a
    # minmax_edge_dot and K7b minmax_spmm_t, on the max argout).  K6's
    # out and arg must equal the plain version's exactly; K7a and K7b
    # sum in another order (KERNEL_GATE).  No single PyTorch call
    # computes an argout, so these have no library time.
    no_library = "none: no single PyTorch call computes the argout"
    try:
        int_x = torch.from_numpy(np.random.RandomState(14).randint(
            -2, 3, (Mu, K)).astype(np.float32)).to(device)
        k6_cases, k7a_cases, k7b_cases = [], [], []
        for label, A_, k, x_, dtype in [
            ("values K=128", A_u, 128, None, torch.float32),
            ("values K=256", A_u, 256, None, torch.float32),
            ("values K=40", A_u, 40, None, torch.float32),
            ("ones K=128", A_u1, 128, None, torch.float32),
            ("ones K=256", A_u1, 256, None, torch.float32),
            ("ones K=40", A_u1, 40, None, torch.float32),
            ("empty rows K=40", A_e, 40, None, torch.float32),
            ("ties: integer operand, ones K=128", A_u1, 128, int_x,
             torch.float32),
            ("values K=128 bf16", A_u, 128, None, torch.bfloat16),
            ("community hybrid K=128", A_h, 128, None, torch.float32),
            ("community Reddit-10% K=128", A_r, 128, None, torch.float32),
        ]:
            st_ = A_.storage
            rp, cl, vv = A_.csr()
            m_, n_ = A_.sparse_sizes()
            x = operand(torch, n_, k, 2, device) if x_ is None else x_
            x = x.to(dtype)
            ncols = int(np.unique(st_.numpy_view("col")).size)
            bound_ms, bound_by = minmax_bounds(m_, A_.nnz(), k, ncols,
                                               vv is not None,
                                               x.element_size())
            arg_by_min = {}
            for is_min in (False, True):
                name = f"{'min' if is_min else 'max'} {label}"
                got, arg = csr_spmm_minmax(rp, cl, vv, x, is_min)
                ref, ref_arg = csr_spmm_minmax_plain(rp, cl, vv, x, is_min)
                sync()
                abs_e, rel_e = errors(got, ref)
                mism = int((arg != ref_arg).sum())
                ok = mism == 0 and abs_e == 0.0
                if not ok:
                    failures.append(f"csr_spmm_minmax {name}: {mism} arg "
                                    f"mismatches, out abs err {abs_e:.3g}")
                k6_cases.append({
                    "case": name, "max_abs_err": abs_e, "max_rel_err": rel_e,
                    "arg_mismatches": mism, "ok": ok,
                    "ms": timer(lambda: csr_spmm_minmax(rp, cl, vv, x,
                                                        is_min)),
                    "plain_ms": plain_timer(lambda: csr_spmm_minmax_plain(
                        rp, cl, vv, x, is_min)),
                    "library_ms": None, "bound_ms": bound_ms,
                    "bound_by": bound_by})
                arg_by_min[is_min] = arg
                del got, ref, ref_arg
            if dtype != torch.float32:
                continue  # the backward kernels take f32
            arg = arg_by_min[False]
            g = operand(torch, m_, k, 4, device)
            (b7a, by7a), (b7b, by7b) = minmax_bwd_bounds(
                torch, cl, arg, n_, vv is not None)
            got = minmax_edge_dot(rp, cl, x, g, arg)
            ref = minmax_edge_dot_plain(rp, cl, x, g, arg)
            sync()
            k7a_cases.append(kernel_case(
                torch, label, got, ref, failures, "minmax_edge_dot",
                ms=timer(lambda: minmax_edge_dot(rp, cl, x, g, arg)),
                plain_ms=plain_timer(
                    lambda: minmax_edge_dot_plain(rp, cl, x, g, arg)),
                library_ms=None, bound_ms=b7a, bound_by=by7a))
            t_args = (st_.colptr(), st_.csc_row(), st_.csr2csc(), vv, g, arg)
            got = minmax_spmm_t(*t_args)
            ref = minmax_spmm_t_plain(*t_args)
            sync()
            k7b_cases.append(kernel_case(
                torch, label, got, ref, failures, "minmax_spmm_t",
                ms=timer(lambda: minmax_spmm_t(*t_args)),
                plain_ms=plain_timer(lambda: minmax_spmm_t_plain(*t_args)),
                library_ms=None, bound_ms=b7b, bound_by=by7b))
            del got, ref, arg_by_min, arg, g, x, t_args
        shape = f"M={Mu} E={Eu} K=128 f32 values, max"
        kernels.append(kernel_entry(
            "csr_spmm_minmax", "spmm_minmax.cu", "ops/kernels/ell.py:496",
            k6_cases, no_library, shape))
        kernels.append(kernel_entry(
            "minmax_edge_dot", "spmm_minmax.cu", "ops/kernels/ell.py:383",
            k7a_cases, no_library, shape))
        kernels.append(kernel_entry(
            "minmax_spmm_t", "spmm_minmax.cu", "ops/kernels/ell.py:383",
            k7b_cases, no_library, shape))
        del A_e, int_x

        # edge_softmax (K8) on GAT's graph (the uniform graph with
        # self-loops) and the community hybrid graph, at 8 heads and 1;
        # the library yardstick is torch.sparse.softmax over the (M, N, H)
        # hybrid COO tensor.
        sm_cases = []
        for label, A_, H in [("uniform + self-loops H=8", A_g, 8),
                             ("uniform + self-loops H=1", A_g, 1),
                             ("community hybrid H=8", A_h, 8),
                             ("community hybrid H=1", A_h, 1)]:
            rp = A_.storage.rowptr()
            m_, n_ = A_.sparse_sizes()
            logits = operand(torch, A_.nnz(), H, 15, device) * 2.0
            got = edge_softmax(rp, logits)
            ref = edge_softmax_plain(rp, logits)
            sync()
            nbytes = 4 * (m_ + 1) + 8 * A_.nnz() * H
            timing = {"ms": timer(lambda: edge_softmax(rp, logits)),
                      "plain_ms": plain_timer(
                          lambda: edge_softmax_plain(rp, logits)),
                      "library_ms": None,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes"}
            try:
                S = torch.sparse_coo_tensor(
                    torch.stack([A_.storage.row().long(),
                                 A_.storage.col().long()]),
                    logits, (m_, n_, H)).coalesce()
                lib_out = torch.sparse.softmax(S, 1)
                if S._nnz() == A_.nnz():  # same edges in the same order
                    timing["library_max_abs_err"] = errors(
                        lib_out.values(), ref)[0]
                timing["library_ms"] = timer(
                    lambda: torch.sparse.softmax(S, 1))
                del S, lib_out
            except (RuntimeError, NotImplementedError) as exc:
                timing["library_missing"] = repr(exc)
            sm_cases.append(kernel_case(torch, label, got, ref, failures,
                                        "edge_softmax", **timing))
            del got, ref, logits
        kernels.append(kernel_entry(
            "edge_softmax", "edge_softmax.cu", "ops/kernels/ell.py:462",
            sm_cases, "torch.sparse.softmax over the (M, N, H) hybrid COO "
            "tensor", f"M={Mu} E={A_g.nnz()} H=8 f32"))
    except Exception:
        failures.append("phase 3 (min/max and softmax kernels): "
                        + traceback.format_exc())
    record("kernel_phase", seconds=round(time.time() - t0, 2))

    # ---- 4, 4b, 5 and 6: the main path, with launch counts ---------------
    t0 = time.time()
    x_u = operand(torch, Mu, K, 2, device)
    x_r = operand(torch, Mr, K, 2, device)
    x_h = operand(torch, Mh, K, 2, device)
    A_r2 = A_r.set_value(A_r.storage.value(), layout="coo")  # no cached view
    in_dim, hid, out_dim, nlayers = GCN_WIDTHS
    x_g = operand(torch, Mu, in_dim, 5, device)
    labels = seeded_labels(torch, x_g, out_dim, 6, device)

    def make_gcn():
        return GCN(in_dim, hid, out_dim, num_layers=nlayers,
                   generator=torch.Generator().manual_seed(0), device=device)

    model = make_gcn()
    leg_specs = [
        ("uniform (ogbn-arxiv scale)", A_u, x_u, 0.0, GATE_F32, "csr"),
        ("community Reddit-10%, store budget 0", A_r, x_r, 0.0, GATE_F32,
         "dense[torch.float32]"),
        ("community Reddit-10%, store budget 2e-3", A_r2, x_r, 2e-3,
         GATE_BF16, "dense[torch.bfloat16]"),
        ("community hybrid (Reddit nodes, 1/10 edges), store budget 0", A_h,
         x_h, 0.0, GATE_F32, "hybrid[torch.float32]"),
    ]
    # Backward legs: a fresh leaf value per graph, so that the router
    # builds the view of a value that requires grad.
    bwd_specs = []
    for label, A, x, want in [
            ("uniform (ogbn-arxiv scale)", A_u, x_u, "csr"),
            ("community Reddit-10%, store budget 0", A_r, x_r,
             "dense[torch.float32]"),
            ("community hybrid (Reddit nodes, 1/10 edges), store budget 0",
             A_h, x_h, "hybrid[torch.float32]")]:
        v = A.storage.value().detach().clone().requires_grad_(True)
        bwd_specs.append((label, A.set_value(v, layout="coo"), v,
                          x.detach().clone().requires_grad_(True),
                          operand(torch, A.sparse_size(0), K, 8, device),
                          want))
    # Min/max legs: the same kind of leaf value, on the uniform graph and
    # the community hybrid graph (whose hybrid view min/max bypasses).
    mm_specs = []
    for label, A, x in [
            ("uniform (ogbn-arxiv scale)", A_u, x_u),
            ("community hybrid (Reddit nodes, 1/10 edges)", A_h, x_h)]:
        v = A.storage.value().detach().clone().requires_grad_(True)
        mm_specs.append((label, A.set_value(v, layout="coo"), v,
                         x.detach().clone().requires_grad_(True),
                         operand(torch, A.sparse_size(0), K, 16, device)))
    gat_in, gat_heads, gat_hid, gat_out = GAT_WIDTHS
    gat_model = GAT(gat_in, gat_hid, gat_out, heads=gat_heads,
                    generator=torch.Generator().manual_seed(0), device=device)

    # Each phase of the main path runs with every launch count set to 0
    # just before it and read just after it, and must launch the kernels
    # listed here.  The train steps need no value gradient, so phase 6
    # must launch no edge dot; min/max bypasses the router, so phase 4c
    # must launch no block kernel.
    must_launch = {
        "4 forward legs": ("csr_spmm", "block_spmm"),
        "4b backward legs": ("csr_spmm", "block_spmm", "block_spmm_t",
                             "edge_dot"),
        "4c min/max legs": ("csr_spmm_minmax", "minmax_edge_dot",
                            "minmax_spmm_t"),
        "5 GCN inference": ("csr_spmm",),
        "6 GCN training": ("csr_spmm",),
        "7 GAT inference": ("edge_softmax", "csr_spmm"),
    }
    phase_launches = {}

    def drive(phase, fn):
        for f in counted.values():
            f.launches = 0
        try:
            out = fn()
            sync()
        except Exception:
            failures.append(f"phase {phase}: " + traceback.format_exc())
            out = None
        phase_launches[phase] = {n: f.launches for n, f in counted.items()}
        return out

    def forward_legs():
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
        return outs

    def backward_legs():
        grads = []
        for label, A, v, x, gout, want in bwd_specs:
            try:
                grads.append(torch.autograd.grad(ts.spmm_sum(A, x), (v, x),
                                                 gout))
            except Exception:
                failures.append(f"backward leg {label}: "
                                + traceback.format_exc())
                grads.append(None)
        return grads

    def minmax_legs():
        res = []
        for label, A, v, x, gout in mm_specs:
            for reduce in ("max", "min"):
                fn = ts.spmm_max if reduce == "max" else ts.spmm_min
                try:
                    out, arg = fn(A, x)
                    gv, gx = torch.autograd.grad(out, (v, x), gout)
                    res.append((label, reduce, out.detach(), arg, gv, gx))
                except Exception:
                    failures.append(f"min/max leg {label} {reduce}: "
                                    + traceback.format_exc())
        return res

    def gat_inference():
        with torch.inference_mode():
            return gat_model(A_g, x_g)

    def gcn_inference():
        with torch.inference_mode():
            return model(A_g, x_g)

    def gcn_training():
        tmodel = make_gcn()
        opt = torch.optim.Adam(tmodel.parameters(), lr=1e-2)
        opt.zero_grad()
        loss0 = tmodel.loss(A_g, x_g, labels)
        loss0.backward()
        grads0 = [p.grad.detach().clone() for p in tmodel.parameters()]
        opt.step()
        gen = torch.Generator(device=device).manual_seed(0)
        losses = []
        for _ in range(3):
            opt.zero_grad()
            loss = tmodel.loss(A_g, x_g, labels, dropout_rate=0.5,
                               generator=gen)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        return loss0.item(), grads0, losses, opt, tmodel, gen

    outs = drive("4 forward legs", forward_legs) or []
    bwd_grads = drive("4b backward legs", backward_legs) or []
    mm_res = drive("4c min/max legs", minmax_legs) or []
    logits = drive("5 GCN inference", gcn_inference)
    train = drive("6 GCN training", gcn_training)
    gat_logits = drive("7 GAT inference", gat_inference)
    launches = {n: sum(c[n] for c in phase_launches.values())
                for n in counted}
    record("main_path", seconds=round(time.time() - t0, 2),
           launches=launches, launches_by_phase=phase_launches)
    for k_ in kernels:
        k_["launches"] = launches[k_["name"]]
    for phase, names in must_launch.items():
        for name in names:
            if phase_launches[phase][name] == 0:
                failures.append(f"{name} was not launched in phase {phase}")
    if phase_launches["6 GCN training"]["edge_dot"]:
        failures.append("the GCN train steps launched edge_dot (no value "
                        "gradient is needed)")
    if (phase_launches["4c min/max legs"]["block_spmm"]
            or phase_launches["4c min/max legs"]["block_spmm_t"]):
        failures.append("the min/max legs launched a block kernel")
    gat_counts = {n: phase_launches["7 GAT inference"][n]
                  for n in ("edge_softmax", "csr_spmm")}
    if gat_counts != {"edge_softmax": 2, "csr_spmm": gat_heads + 1}:
        failures.append(f"GAT launched {gat_counts} (want edge_softmax 2, "
                        f"csr_spmm {gat_heads + 1})")

    def route_of(A):
        h = A.storage.hybrid(auto=False)
        if h is None:
            return "csr", h
        store = getattr(h, "blocks", getattr(h, "dense", None))
        return (f"{type(h).__name__.replace('Format', '').lower()}"
                f"[{store.dtype}]"), h

    with torch.inference_mode():
        for (label, A, x, budget, gate, want), out in zip(leg_specs, outs):
            if out is None:
                continue
            route, h = route_of(A)
            ok, err = oracle_check(A, x, out, gate)
            finite = bool(torch.isfinite(out).all())
            set_store_budget(budget)
            ms = timer(lambda: ts.spmm_sum(A, x))
            set_store_budget(0.0)
            # The CSR kernel on the same graph: the route the router
            # declined (its constants were priced for a TPU).
            csr_ms = timer(lambda: csr_spmm(*A.csr(), x))
            bound = route_bound_ms(torch, A, h, K, split_parts)
            leg = {"leg": label, "route": route, "expected_route": want,
                   "nnz": A.nnz(), "oracle_rel_err": err, "gate": gate,
                   "ms": ms, "nnz_per_s": A.nnz() / (ms * 1e-3),
                   "bound_ms": bound, "csr_kernel_ms": csr_ms,
                   "card": card}
            record("route", **leg)
            if not (ok and finite and route == want):
                failures.append(f"leg {label}: route {route} (want {want}), "
                                f"oracle err {err:.3g} (gate {gate})")
        del outs

    # ---- 4b. backward legs: checks and times -----------------------------
    for (label, A, v, x, gout, want), grads in zip(bwd_specs, bwd_grads):
        if grads is None:
            continue
        gv, gx = grads
        route, _ = route_of(A)
        ok_x, err_x = grad_x_oracle_check(A, gout, gx, GATE_F32)
        ok_v, err_v = grad_v_oracle_check(A, x, gout, gv, GATE_F32)
        finite = bool(torch.isfinite(gx).all() and torch.isfinite(gv).all())
        ms = timer(lambda: torch.autograd.grad(ts.spmm_sum(A, x), (v, x),
                                               gout))
        fwd_ms = timer(lambda: ts.spmm_sum(A, x.detach()))
        record("backward", leg=label, route=route, expected_route=want,
               nnz=A.nnz(), grad_x_rel_err=err_x, grad_v_rel_err=err_v,
               gate=GATE_F32, ms_forward_backward=ms, ms_forward=fwd_ms,
               card=card)
        if not (ok_x and ok_v and finite and route == want):
            failures.append(f"backward leg {label}: route {route} (want "
                            f"{want}), grad_x err {err_x:.3g}, grad_v err "
                            f"{err_v:.3g} (gate {GATE_F32}), finite {finite}")
    del bwd_specs, bwd_grads

    # ---- 4c. min/max legs: checks and times ------------------------------
    specs_by_label = {sp[0]: sp for sp in mm_specs}
    for label, reduce, out, arg, gv, gx in mm_res:
        _, A, v, x, gout = specs_by_label[label]
        is_min = reduce == "min"
        fn = ts.spmm_min if is_min else ts.spmm_max
        ok_o, err_o, mism = minmax_oracle_check(A, x, out, arg, is_min,
                                                GATE_F32)
        ok_x, err_x = grad_x_oracle_check(A, gout, gx, GATE_F32, arg=arg)
        ok_v, err_v = grad_v_oracle_check(A, x, gout, gv, GATE_F32, arg=arg)
        finite = bool(torch.isfinite(out).all() and torch.isfinite(gx).all()
                      and torch.isfinite(gv).all())
        shape_ok = tuple(out.shape) == (A.sparse_size(0), K)
        ms = timer(lambda: fn(A, x.detach()))
        ms_fb = timer(lambda: torch.autograd.grad(fn(A, x)[0], (v, x), gout))
        record("minmax", leg=label, reduce=reduce, nnz=A.nnz(),
               out_rel_err=err_o, arg_mismatches=mism, grad_x_rel_err=err_x,
               grad_v_rel_err=err_v, gate=GATE_F32, ms_forward=ms,
               ms_forward_backward=ms_fb, card=card)
        if not (ok_o and ok_x and ok_v and finite and shape_ok):
            failures.append(f"min/max leg {label} {reduce}: out err "
                            f"{err_o:.3g}, {mism} arg mismatches, grad_x err "
                            f"{err_x:.3g}, grad_v err {err_v:.3g} (gate "
                            f"{GATE_F32}), finite {finite}")
    del mm_specs, mm_res

    # ---- 5. GCN inference: checks and times ------------------------------
    with torch.inference_mode():
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

    # ---- 6. GCN training: checks and times -------------------------------
    if train is not None:
        loss0, grads0, losses, opt, tmodel, gen = train
        # The same first step through torch autograd on the plain CSR
        # version (index_select + index_add_, no custom backward).  A
        # ReLU input within rounding of 0 can fall on either side in the
        # two runs, whose sums run in different orders, and its gradient
        # term is then kept in one and dropped in the other.  So the
        # reference takes the kernel run's ReLU decisions, and the
        # entries where the plain run's own decisions differ are counted.
        rmodel = make_gcn()
        kmasks = relu_masks(torch, ts.spmm_sum, rmodel, A_g, x_g)
        pmasks = relu_masks(
            torch, lambda a, h: csr_spmm_plain(*a.csr(), h), rmodel, A_g,
            x_g)
        flips = sum(int((k_ != p_).sum()) for k_, p_ in zip(kmasks, pmasks))
        ref_loss = plain_loss(torch, csr_spmm_plain, rmodel, A_g, x_g, labels,
                              kmasks)
        ref_loss.backward()
        del kmasks, pmasks
        grad_errs = [errors(g, p.grad)[1]
                     for g, p in zip(grads0, rmodel.parameters())]
        loss_err = abs(loss0 - ref_loss.item()) / abs(ref_loss.item())

        def step(m, o, lossfn):
            o.zero_grad()
            lossfn(m).backward()
            o.step()

        ms = timer(lambda: step(tmodel, opt, lambda m: m.loss(
            A_g, x_g, labels, dropout_rate=0.5, generator=gen)))
        ms_nodrop = timer(lambda: step(tmodel, opt, lambda m: m.loss(
            A_g, x_g, labels)))
        ropt = torch.optim.Adam(rmodel.parameters(), lr=1e-2)
        plain_ms = timer(lambda: step(rmodel, ropt, lambda m: plain_loss(
            torch, csr_spmm_plain, m, A_g, x_g, labels)))
        falls = all(np.isfinite(losses)) and losses[2] < losses[0]
        # The masks may absorb ties only: more flips than a small share
        # of the hidden entries is a fault of the kernel run.
        max_flips = int(RELU_FLIP_SHARE * Mu * hid * (nlayers - 1))
        record("gcn_train", layers=nlayers, nodes=Mu, nnz=A_g.nnz(),
               loss_step1=loss0, loss_rel_err_vs_plain=loss_err,
               grad_rel_errs_vs_plain=grad_errs, relu_flips=flips,
               max_relu_flips=max_flips, gate=KERNEL_GATE,
               dropout_losses=losses, ms_per_step=ms,
               ms_per_step_no_dropout=ms_nodrop,
               plain_ms_per_step_no_dropout=plain_ms, card=card)
        if not (np.isfinite(loss0) and loss_err <= KERNEL_GATE
                and max(grad_errs) <= KERNEL_GATE and falls
                and flips <= max_flips):
            failures.append(f"GCN training: loss err {loss_err:.3g}, grad "
                            f"errs {max(grad_errs):.3g} (gate "
                            f"{KERNEL_GATE}), ReLU flips {flips} (at most "
                            f"{max_flips}), dropout losses {losses}")

    # ---- 7. GAT inference: checks and times ------------------------------
    with torch.inference_mode():
        if gat_logits is not None:
            ref = gat_plain(torch, gat_model, A_g, x_g, edge_softmax_plain,
                            csr_spmm_plain)
            sync()
            _, rel_e = errors(gat_logits, ref)
            finite = bool(torch.isfinite(gat_logits).all())
            shape_ok = tuple(gat_logits.shape) == (Mu, gat_out)
            ms = timer(lambda: gat_model(A_g, x_g))
            plain_ms = timer(lambda: gat_plain(
                torch, gat_model, A_g, x_g, edge_softmax_plain,
                csr_spmm_plain))
            record("gat", widths=[gat_in, f"{gat_heads}x{gat_hid}", gat_out],
                   nodes=Mu, nnz=A_g.nnz(), launches=gat_counts,
                   rel_err_vs_plain=rel_e, gate=KERNEL_GATE,
                   ms_per_forward=ms, plain_ms_per_forward=plain_ms,
                   card=card)
            if not (finite and shape_ok and rel_e <= KERNEL_GATE):
                failures.append(f"GAT: finite={finite} shape="
                                f"{gat_logits.shape} rel err vs plain "
                                f"{rel_e:.3g}")

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
