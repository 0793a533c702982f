"""Worker functions of the port's distributed tests, and :func:`spawn`,
which runs one on several processes that form a process group.

``tests/test_torch_dist.py``, ``tests/test_torch_dist_gcn.py`` and
``tests/test_torch_dist_gpu.py`` run them on several gloo (or NCCL)
processes.  The spawned processes import this module and nothing of the
test modules, so it imports neither JAX nor the JAX package (nor the
``conftest``).  The graph builders are numpy only, and the tests hand
the same arrays to the JAX package.
"""

import datetime
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu_torch.models import DistGCN
from pytorch_sparse_tpu_torch.parallel import (
    ShardedSparseMatrix, dist_spmm, make_mesh)
from pytorch_sparse_tpu_torch.parallel import _comm

def _rank_main(rank, fn, world_size, backend, workdir, timeout, threads,
               args):
    if threads:
        torch.set_num_threads(threads)
    tdist.init_process_group(
        backend, init_method=f"file://{workdir}/rdzv", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout))
    try:
        torch.save(fn(rank, world_size, **args),
                   os.path.join(workdir, f"result_{rank}.pt"))
    finally:
        tdist.destroy_process_group()
    # The result is saved.  Leave without the interpreter's teardown,
    # which a gloo group's threads can abort now and then under load.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn(fn, world_size, backend, args, timeout=600.0, threads=None):
    """Run ``fn(rank, world_size, **args)`` on ``world_size`` fresh
    processes (``torch.multiprocessing``, start method "spawn") joined in
    one ``backend`` group through a rendezvous file in a new temporary
    directory, so concurrent runs share no address; return each rank's
    result in rank order (tensors, numbers or containers of them).  A
    failed rank raises with its exit code or traceback and the others
    are stopped; so are all of them when the time runs out."""
    workdir = tempfile.mkdtemp(prefix="pst_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main,
            (fn, world_size, backend, workdir, timeout, threads, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(
                    f"{world_size} ranks of {fn.__name__} timed out after "
                    f"{timeout} s")
        return [torch.load(os.path.join(workdir, f"result_{r}.pt"),
                           weights_only=True) for r in range(world_size)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def rank_or_raise(rank, world_size, bad):
    """Return ``(rank, world_size)``, or raise on rank ``bad``: the
    launcher's own check."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return (rank, world_size)


SCHEDULES = [("allgather", "ell"), ("ring", "ell"), ("halo", "ell"),
             ("halo", "hybrid")]
REDUCES = ("sum", "mean", "min", "max")


def community_coo(M, n_comm, e_intra, e_inter, seed, empty_every=0):
    """A coalesced, CSR-sorted ``(row, col, value)`` of ``M`` nodes in
    ``n_comm`` contiguous communities: ``e_intra`` draws inside a
    community, ``e_inter`` anywhere, N(0, 1) float32 values (duplicate
    draws add).  With ``empty_every``, rows ``r % empty_every == 1``
    lose their edges."""
    rng = np.random.RandomState(seed)
    cp = np.linspace(0, M, n_comm + 1).astype(np.int64)
    c = rng.randint(0, n_comm, e_intra)
    lo, hi = cp[c], cp[c + 1]
    r1 = lo + (rng.rand(e_intra) * (hi - lo)).astype(np.int64)
    c1 = lo + (rng.rand(e_intra) * (hi - lo)).astype(np.int64)
    r2, c2 = rng.randint(0, M, e_inter), rng.randint(0, M, e_inter)
    row = np.concatenate([r1, r2]).astype(np.int64)
    col = np.concatenate([c1, c2]).astype(np.int64)
    val = rng.randn(row.size).astype(np.float32)
    if empty_every:
        keep = row % empty_every != 1
        row, col, val = row[keep], col[keep], val[keep]
    key = row * M + col
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.zeros(uniq.size, np.float64)
    np.add.at(summed, inv, val)
    return uniq // M, uniq % M, summed.astype(np.float32)


def gcn_norm_coo(row, col, M):
    """``D^-1/2 (A + I) D^-1/2`` of the 0/1 pattern ``(row, col)`` in
    float32: the diagonal is set to 1, as ``gcn_norm`` does."""
    off = row != col
    row = np.concatenate([row[off], np.arange(M)])
    col = np.concatenate([col[off], np.arange(M)])
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    val = np.ones(row.size, np.float32)
    deg = np.bincount(row, weights=val, minlength=M).astype(np.float32)
    dinv = (1.0 / np.sqrt(deg)).astype(np.float32)
    return row, col, (dinv[row] * val * dinv[col]).astype(np.float32)


def operand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def tie_operand(seed, *shape):
    """Small integers: many candidates of a row are equal."""
    return np.random.RandomState(seed).randint(-2, 3, shape).astype(
        np.float32)


def _tensor(row, col, val, M):
    return pts.SparseTensor(row=row, col=col, value=torch.from_numpy(val),
                            sparse_sizes=(M, M), device="cpu")


def _run_case(A, mesh, x_np, gout_np, value_np, schedule, fmt, reduce):
    """Forward and both gradients on every rank; rank results gathered
    (outputs, x gradient) or all-reduced (value gradient), on the
    host."""
    x = A.shard_dense(torch.from_numpy(x_np)).requires_grad_(True)
    gout = A.shard_dense(torch.from_numpy(gout_np))
    v = (None if value_np is None else
         torch.from_numpy(value_np).to(mesh.device).requires_grad_(True))
    res = dist_spmm(A, x, schedule, reduce, fmt, v)
    out, arg = res if reduce in ("min", "max") else (res, None)
    inputs = [x] + ([] if v is None else [v])
    grads = torch.autograd.grad(out, inputs, gout)
    got = {"out": A.unshard_dense(out.detach()),
           "gx": A.unshard_dense(grads[0])}
    if arg is not None:
        got["arg"] = A.unshard_dense(arg)
    if v is not None:
        got["gv"] = _comm.all_reduce_sum(mesh, grads[1])
    return {k: t.cpu() for k, t in got.items()}


def _structure(A, mesh):
    hy = A.has_interior_blocks()
    return {"Mb": A.Mb, "Nb": A.Nb, "H": A.halo_width,
            "serve": _comm.all_gather(mesh, A.serve_idx).view(
                A.P, A.P, -1).cpu(),
            "rowcount": _comm.all_gather(mesh, A.rowcount).cpu(),
            "has_interior_blocks": hy,
            "has_frontier_dense": A.has_frontier_dense()}


def run_schedules(rank, world_size, M, K, graph, block_B, seed,
                  device="cpu"):
    """Every schedule x reduce, forward and both gradients, on the
    graph ``community_coo(M, *graph)``; the dense-frontier build; the
    tie-heavy min/max; the value-length check.  Rank 0 returns the
    results."""
    mesh = make_mesh(world_size, device=device)
    row, col, val = community_coo(M, *graph)
    A = ShardedSparseMatrix.from_sparse_tensor(_tensor(row, col, val, M),
                                               mesh, block_B=block_B)
    x_np, gout_np = operand(seed, M, K), operand(seed + 1, M, K)
    res = {"structure": _structure(A, mesh)}
    for schedule, fmt in SCHEDULES:
        for reduce in REDUCES:
            if fmt == "hybrid" and reduce in ("min", "max"):
                continue
            value = None if fmt == "hybrid" else val
            res[f"{schedule}-{fmt}-{reduce}"] = _run_case(
                A, mesh, x_np, gout_np, value, schedule, fmt, reduce)
    # Ties: +-1 values and small-integer operands.
    x_tie, v_tie = tie_operand(seed + 2, M, K), np.sign(val)
    for schedule, fmt in SCHEDULES[:3]:
        for reduce in ("min", "max"):
            res[f"ties-{schedule}-{reduce}"] = _run_case(
                A, mesh, x_tie, gout_np, v_tie, schedule, fmt, reduce)
    # The dense frontier, forced.
    Afr = ShardedSparseMatrix.from_sparse_tensor(
        _tensor(row, col, val, M), mesh, block_B=block_B,
        frontier_dense="always")
    res["frontier_dense_structure"] = _structure(Afr, mesh)
    for reduce in ("sum", "mean"):
        res[f"frontier_dense-{reduce}"] = _run_case(
            Afr, mesh, x_np, gout_np, None, "halo", "hybrid", reduce)
    # A value vector of the wrong length raises.
    try:
        dist_spmm(A, A.shard_dense(torch.from_numpy(x_np)), "ring", "sum",
                  value=torch.ones(A.nnz + 1, device=mesh.device))
        res["value_length_raises"] = False
    except ValueError:
        res["value_length_raises"] = True
    res["staged_bytes"] = mesh.staged_bytes
    return res if rank == 0 else {}


def run_dist_gcn(rank, world_size, M, graph, layers, n_classes, seed,
                 schedules, lr):
    """One ``DistGCN.train_step`` (Adam) from the given parameters on
    ``gcn_norm`` of ``community_coo(M, *graph)``'s pattern, per
    schedule: the global loss, the all-reduced gradients and the
    parameters after the step, from every rank."""
    mesh = make_mesh(world_size, device="cpu")
    row, col, _ = community_coo(M, *graph)
    row, col, val = gcn_norm_coo(row, col, M)
    A = ShardedSparseMatrix.from_sparse_tensor(_tensor(row, col, val, M),
                                               mesh, block_B=8)
    params = {"layers": [{"w": w.numpy(), "b": b.numpy()}
                         for w, b in layers]}
    in_dim = layers[0][0].shape[0]
    x = A.shard_dense(torch.from_numpy(operand(seed, M, in_dim)))
    rng = np.random.RandomState(seed + 1)
    labels = A.shard_dense(torch.from_numpy(rng.randint(0, n_classes, M)))
    mask = A.shard_dense(torch.from_numpy(
        (rng.rand(M) < 0.6).astype(np.float32)))
    res = {}
    for schedule, fmt in schedules:
        model = DistGCN.from_jax_params(params, device="cpu")
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        loss = model.train_step(opt, A, x, labels, mask, schedule, fmt)
        res[f"{schedule}-{fmt}"] = {
            "loss": loss,
            "grads": [p.grad.detach().clone() for p in model.parameters()],
            "params": [p.detach().clone() for p in model.parameters()]}
    res["has_interior_blocks"] = A.has_interior_blocks()
    return res
