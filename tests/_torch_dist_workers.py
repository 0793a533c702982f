"""Worker functions of the port's distributed tests, and :func:`spawn`,
which runs one on several processes that form a process group.

``tests/test_torch_dist.py``, ``tests/test_torch_dist_gcn.py``,
``tests/test_torch_hier.py``, ``tests/test_torch_dist2d.py``,
``tests/test_torch_examples.py`` and ``tests/test_torch_dist_gpu.py``
run them on several gloo (or NCCL)
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
    HierShardedSparseMatrix, ShardedSparseMatrix, dist_spmm, dist_spmm_hier,
    make_mesh, make_mesh2d, make_mesh_hier)
from pytorch_sparse_tpu_torch.parallel import _comm

def join_group(backend, workdir, rank, world_size, timeout):
    """Join the ``backend`` group through the rendezvous file in
    ``workdir``, then wait on the file's store until every rank has
    joined.  ``init_process_group`` ends without a barrier (torch dropped
    it in 2.3), so without this wait a rank whose gloo connect finished
    first could run its function, tear its group down and exit while a
    slower rank was still reading that rank's side of the handshake: the
    slower rank then failed in ``connectFullMesh`` with "Connection
    closed by peer"."""
    limit = datetime.timedelta(seconds=timeout)
    store = tdist.FileStore(os.path.join(workdir, "rdzv"), world_size)
    store.set_timeout(limit)
    tdist.init_process_group(backend, store=store, rank=rank,
                             world_size=world_size, timeout=limit)
    if store.add("joined", 1) == world_size:
        store.set("all_joined", "1")
    store.wait(["all_joined"])


def _rank_main(rank, fn, world_size, backend, workdir, timeout, threads,
               args):
    if threads:
        torch.set_num_threads(threads)
    join_group(backend, workdir, rank, world_size, timeout)
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
    (outputs, x gradient) or all-reduced over every process of the
    layout (value gradient), on the host.  ``schedule`` "hier" runs
    ``dist_spmm_hier``."""
    x = A.shard_dense(torch.from_numpy(x_np)).requires_grad_(True)
    gout = A.shard_dense(torch.from_numpy(gout_np))
    v = (None if value_np is None else
         torch.from_numpy(value_np).to(mesh.device).requires_grad_(True))
    if schedule == "hier":
        res = dist_spmm_hier(A, x, reduce, fmt, v)
    else:
        res = dist_spmm(A, x, schedule, reduce, fmt, v)
    out, arg = res if reduce in ("min", "max") else (res, None)
    inputs = [x] + ([] if v is None else [v])
    grads = torch.autograd.grad(out, inputs, gout)
    got = {"out": A.unshard_dense(out.detach()),
           "gx": A.unshard_dense(grads[0])}
    if arg is not None:
        got["arg"] = A.unshard_dense(arg)
    if v is not None:
        got["gv"] = _comm.all_reduce_sum(A.world, grads[1])
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
                 schedules, lr, hier=None):
    """One ``DistGCN.train_step`` (Adam) from the given parameters on
    ``gcn_norm`` of ``community_coo(M, *graph)``'s pattern, per
    schedule: the global loss, the all-reduced gradients and the
    parameters after the step, from every rank.  With ``hier = (S,
    C)`` the layout is hierarchical."""
    row, col, _ = community_coo(M, *graph)
    row, col, val = gcn_norm_coo(row, col, M)
    if hier is None:
        A = ShardedSparseMatrix.from_sparse_tensor(
            _tensor(row, col, val, M), make_mesh(world_size, device="cpu"),
            block_B=8)
    else:
        A = HierShardedSparseMatrix.from_sparse_tensor(
            _tensor(row, col, val, M), make_mesh_hier(*hier, device="cpu"),
            block_B=8)
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
        res[f"{schedule or 'default'}-{fmt}"] = {
            "loss": loss,
            "grads": [p.grad.detach().clone() for p in model.parameters()],
            "params": [p.detach().clone() for p in model.parameters()]}
    res["has_interior_blocks"] = A.has_interior_blocks()
    return res


HIER_FORMATS = ("ell", "auto")


def _hier_structure(A, grid):
    """The hierarchical layout's global decisions (every rank's served
    rows gathered) and this rank's buffer layout: the global id, tier and
    buffer row of each of its edges."""
    t = A._tables
    hyb = A._hybrid
    return {"Mb": A.Mb, "Nb": A.Nb, "Hi": A.Hi, "Hx": A.Hx,
            "serve_ici": _comm.all_gather(grid.mesh, A.serve_ici[None]).cpu(),
            "serve_dcn": _comm.all_gather(grid.mesh, A.serve_dcn[None]).cpu(),
            "rowcount": _comm.all_gather(grid.mesh, A.rowcount).cpu(),
            "wire_stats": dict(A.wire_stats),
            "wire_report": A.wire_report(K=8),
            "has_interior_blocks": hyb is not None,
            "fi_dense": A.fi_dense is not None,
            "fx_dense": A.fx_dense is not None,
            "edges": [(torch.from_numpy(A.e0 + t.pos[i]),
                       torch.from_numpy(t.edges(i)[1])) for i in (1, 2)]}


def run_hier(rank, world_size, S, C, M, K, graph, block_B, seed,
             device="cpu"):
    """The hierarchical schedule on an ``(S, C)`` grid: every reduce x
    {ell, auto}, forward and both gradients (``value=`` on "ell"), the
    tie-heavy min/max, the hybrid with the frontier groups
    (``frontier_dense="never"``), the structure; every rank returns its
    structure, rank 0 also the results."""
    grid = make_mesh_hier(S, C, device=device)
    row, col, val = community_coo(M, *graph)
    A = HierShardedSparseMatrix.from_sparse_tensor(
        _tensor(row, col, val, M), grid, block_B=block_B)
    x_np, gout_np = operand(seed, M, K), operand(seed + 1, M, K)
    res = {"structure": _hier_structure(A, grid)}
    for fmt in HIER_FORMATS:
        for reduce in REDUCES:
            value = val if fmt == "ell" else None
            res[f"hier-{fmt}-{reduce}"] = _run_case(
                A, grid.mesh, x_np, gout_np, value, "hier", fmt, reduce)
    x_tie, v_tie = tie_operand(seed + 2, M, K), np.sign(val)
    for reduce in ("min", "max"):
        res[f"ties-{reduce}"] = _run_case(A, grid.mesh, x_tie, gout_np,
                                          v_tie, "hier", "ell", reduce)
    try:
        dist_spmm_hier(A, A.shard_dense(torch.from_numpy(x_np)), "max",
                       "hybrid")
        res["hybrid_max_raises"] = False
    except ValueError:
        res["hybrid_max_raises"] = True
    # The interior blocks with the frontier groups (no dense tier).
    Ang = HierShardedSparseMatrix.from_sparse_tensor(
        _tensor(row, col, val, M), grid, block_B=block_B,
        frontier_dense="never")
    res["never_structure"] = _hier_structure(Ang, grid)
    for reduce in ("sum", "mean"):
        res[f"never-{reduce}"] = _run_case(
            Ang, grid.mesh, x_np, gout_np, None, "hier", "hybrid", reduce)
    res["staged_bytes"] = grid.staged_bytes
    return res if rank == 0 else {"structure": res["structure"]}


def run_2d(rank, world_size, P, Pf, M, K, graph, block_B, seed,
           device="cpu"):
    """Every flat schedule x reduce on a ``(P, Pf)`` data x feature
    grid, forward and both gradients; the indivisible-``K`` check and
    the structure.  Rank 0 returns the results."""
    grid = make_mesh2d(P, Pf, device=device)
    row, col, val = community_coo(M, *graph)
    A = ShardedSparseMatrix.from_sparse_tensor(_tensor(row, col, val, M),
                                               grid, block_B=block_B)
    x_np, gout_np = operand(seed, M, K), operand(seed + 1, M, K)
    res = {"structure": _structure(A, A.mesh), "Pf": A.Pf,
           "x_cols": A.shard_dense(torch.from_numpy(x_np)).shape[1]}
    for schedule, fmt in SCHEDULES:
        for reduce in REDUCES:
            if fmt == "hybrid" and reduce in ("min", "max"):
                continue
            value = None if fmt == "hybrid" else val
            res[f"{schedule}-{fmt}-{reduce}"] = _run_case(
                A, grid.mesh, x_np, gout_np, value, schedule, fmt, reduce)
    try:
        A.shard_dense(torch.zeros(M, Pf * 2 + 1))
        res["indivisible_raises"] = False
    except ValueError as e:
        res["indivisible_raises"] = "divisible" in str(e)
    res["staged_bytes"] = grid.staged_bytes
    return res if rank == 0 else {}


def uniform_coo(M, E, seed):
    """A coalesced, CSR-sorted uniform random ``(row, col, value)``:
    ``E`` draws over ``M`` nodes, N(0, 1) float32 values.  At a few dozen
    draws a node, every row is read by rows of every other block, so the
    halo and hierarchical layouts serve it to several peers."""
    rng = np.random.RandomState(seed)
    key = np.unique(rng.randint(0, M, E).astype(np.int64) * M
                    + rng.randint(0, M, E))
    return key // M, key % M, rng.randn(key.size).astype(np.float32)


def run_served_backward(rank, world_size, M, K, E, seed, grid=None,
                        device="cpu", runs=1):
    """The gradient of ``x`` through the sum ``A @ x`` of the flat halo
    schedule (``grid`` None) or the hierarchical one on an ``(S, C)``
    grid, on ``uniform_coo(M, E, seed)``, under the output gradient
    ``operand(seed + 2, M, K)``: ``runs`` passes, each the whole ``(M,
    K)`` gradient gathered on the host."""
    row, col, val = uniform_coo(M, E, seed)
    if grid is None:
        mesh = make_mesh(world_size, device=device)
        A = ShardedSparseMatrix.from_sparse_tensor(_tensor(row, col, val, M),
                                                   mesh)
    else:
        hier = make_mesh_hier(*grid, device=device)
        A = HierShardedSparseMatrix.from_sparse_tensor(
            _tensor(row, col, val, M), hier)
    x = A.shard_dense(torch.from_numpy(operand(seed + 1, M, K)))
    gout = A.shard_dense(torch.from_numpy(operand(seed + 2, M, K)))
    grads = []
    for _ in range(runs):
        xr = x.clone().requires_grad_(True)
        if grid is None:
            out = dist_spmm(A, xr, "halo", "sum", "ell")
        else:
            out = dist_spmm_hier(A, xr, "sum", "ell")
        (gx,) = torch.autograd.grad(out, xr, gout)
        grads.append(A.unshard_dense(gx).cpu())
    return grads


def run_train_gcn(rank, world_size, argv, layers, slices):
    """The distributed GCN recipe (``examples.train_gcn --distributed``
    with ``argv``) on the spawned group, from the given parameters: flat
    (the ring schedule), then on the hierarchical layout of each
    ``--slices`` of ``slices``.  Each run's losses a step, its accuracy
    and its ``shard_spmm`` launches (0 on the CPU), from every rank."""
    from pytorch_sparse_tpu_torch.examples import train_gcn
    from pytorch_sparse_tpu_torch.ops.kernels import shard_spmm

    params = {"layers": [{"w": w.numpy(), "b": b.numpy()}
                         for w, b in layers]}
    out = {}
    for s in (1,) + tuple(slices):
        args = train_gcn.parse_args(list(argv) + ["--slices", str(s)])
        shard_spmm.launches = 0
        res = train_gcn.train_distributed(
            args, make=lambda d: DistGCN.from_jax_params(params, device=d))
        out[res["schedule"]] = {"losses": torch.tensor(res["losses"]),
                                "accuracy": res["accuracy"],
                                "shard_spmm_launches": shard_spmm.launches}
    return out
