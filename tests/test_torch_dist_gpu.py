"""The shard kernels K11a/K11b against their plain versions on the
card, and the distributed schedules on CUDA shards against the same
schedules on CPU shards (plain versions): the flat schedules at world
size 1 on NCCL and on 4 processes sharing one card on gloo, which stages
every collective through the host; the hierarchical schedule on a (1,
1) grid on NCCL and a (2, 2) grid on gloo; the flat schedules on a (2,
2) data x feature grid on gloo, and one ``DistGCN`` Adam step on it.

These tests need an NVIDIA GPU and ``nvcc`` and skip without them; they
import neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_dist_gpu.py
"""

import numpy as np
import pytest
import torch

from pytorch_sparse_tpu_torch.ops.kernels import (
    csr_spmm, shard_spmm, shard_spmm_minmax, shard_spmm_minmax_plain,
    shard_spmm_plain)
from pytorch_sparse_tpu_torch.ops.kernels.csr_spmm import walk_instance
from pytorch_sparse_tpu_torch.testing import rel_err

import _torch_dist_workers as W


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no "
                    "CPU mode)")


def _group(seed, n_rows, n_buf, E, dev):
    """A compact group (rows with edges only) in CSR order, with
    positions, and a CSR slice of the same edges (rowptr not from 0)."""
    rng = np.random.RandomState(seed)
    r = np.sort(rng.randint(0, n_rows, E))
    c = rng.randint(0, n_buf, E)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    keep, counts = np.unique(r, return_counts=True)
    i32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32)).to(dev)
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    full_ptr = np.searchsorted(r, np.arange(n_rows + 1))
    v = torch.from_numpy(np.sign(rng.randn(E)).astype(np.float32)).to(dev)
    pos = np.sort(rng.choice(2 * E, E, replace=False))
    return dict(rowptr=i32(rowptr), col=i32(c), value=v, pos=i32(pos),
                row_map=i32(keep), full_ptr=i32(full_ptr))


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 3, 8, 20, 40, 47, 128, 256, 300])
def test_shard_spmm_matches_plain_on_gpu(K):
    _need_gpu()
    n_rows, n_buf = 3000, 2500
    g = _group(7, n_rows, n_buf, 40_000, "cuda")
    buf = torch.from_numpy(W.operand(8, n_buf, K)).cuda()
    base = torch.from_numpy(W.operand(9, n_rows, K)).cuda()
    for value in (g["value"], None):
        args = (g["rowptr"], g["col"], value, buf)
        got = shard_spmm(*args, row_map=g["row_map"], n_rows=n_rows)
        ref = shard_spmm_plain(*args, row_map=g["row_map"], n_rows=n_rows)
        assert rel_err(got, ref) <= 1e-5
        got = shard_spmm(*args, out=base.clone(), row_map=g["row_map"])
        ref = shard_spmm_plain(*args, out=base.clone(),
                               row_map=g["row_map"])
        assert rel_err(got, ref) <= 1e-5
    # A row range of a larger pointer (the transposed groups).
    lo, hi = 1000, 2200
    args = (g["full_ptr"][lo:hi + 1], g["col"], g["value"], buf)
    assert rel_err(shard_spmm(*args), shard_spmm_plain(*args)) <= 1e-5


def _degree_group(seed, n_rows, n_buf, degrees, dev):
    """A compact group whose rows have the given degrees (0 included),
    sent to scattered shard rows, as a slice of a pointer that does not
    start at 0."""
    rng = np.random.RandomState(seed)
    degrees = np.asarray(degrees)
    lead = 37  # edges before the group in its col and value arrays
    rowptr = lead + np.concatenate([[0], np.cumsum(degrees)])
    E = lead + int(degrees.sum())
    i32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32)).to(dev)
    return dict(rowptr=i32(rowptr), col=i32(rng.randint(0, n_buf, E)),
                value=torch.from_numpy(rng.randn(E).astype(np.float32)).to(
                    dev),
                row_map=i32(np.sort(rng.choice(n_rows, degrees.size,
                                               replace=False))))


# Degrees around the walk's 8 edges in flight and its 32-edge index loads,
# a long row, and empty rows between them.
WALK_DEGREES = [0, 1, 7, 8, 9, 0, 31, 32, 33, 2000, 0, 15, 17, 63, 65, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 3, 8, 20, 40, 47, 128, 256, 300])
def test_shard_spmm_row_degrees_and_alignment_on_gpu(K):
    """Rows of degree 0, 1, one below and above the edges in flight, and
    2,000, written and accumulated, with the buffer and the accumulated
    output aligned (float4 instance where K % 4 == 0) and 4 bytes off a
    16-byte boundary (the scalar instance, the same bits)."""
    _need_gpu()
    n_rows, n_buf = 1200, 800
    g = _degree_group(15, n_rows, n_buf, WALK_DEGREES * 10, "cuda")
    flat = torch.from_numpy(W.operand(16, 1, n_buf * K + 1)).cuda()[0]
    buf_off = flat[1:].view(n_buf, K)
    buf = buf_off.clone()
    base_flat = torch.from_numpy(W.operand(17, 1, n_rows * K + 1)).cuda()[0]
    base_off = base_flat[1:].view(n_rows, K)
    base = base_off.clone()
    for value in (g["value"], None):
        args = (g["rowptr"], g["col"], value)
        got = shard_spmm(*args, buf, row_map=g["row_map"], n_rows=n_rows)
        assert shard_spmm.last_instance == walk_instance(K, True)
        ref = shard_spmm_plain(*args, buf, row_map=g["row_map"],
                               n_rows=n_rows)
        assert rel_err(got, ref) <= 1e-5
        assert torch.equal(shard_spmm(*args, buf_off, row_map=g["row_map"],
                                      n_rows=n_rows), got)
        assert shard_spmm.last_instance == walk_instance(K, False)
        acc = shard_spmm(*args, buf, out=base.clone(), row_map=g["row_map"])
        ref = shard_spmm_plain(*args, buf, out=base.clone(),
                               row_map=g["row_map"])
        assert rel_err(acc, ref) <= 1e-5
        out_off = base_flat.clone()[1:].view(n_rows, K)
        shard_spmm(*args, buf_off, out=out_off, row_map=g["row_map"])
        assert shard_spmm.last_instance.vec == 1
        assert torch.equal(out_off, acc)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 8, 20, 40, 128, 256, 300])
def test_shard_spmm_without_row_map_equals_csr_spmm_bits_on_gpu(K):
    """K11a written with no row_map is K1 on the same CSR, bit for bit,
    and two launches of either give the same bits."""
    _need_gpu()
    n_rows, n_buf = 3000, 2500
    g = _group(18, n_rows, n_buf, 40_000, "cuda")
    buf = torch.from_numpy(W.operand(19, n_buf, K)).cuda()
    for value in (g["value"], None):
        args = (g["full_ptr"], g["col"], value, buf)
        k11a = shard_spmm(*args)
        assert torch.equal(k11a, csr_spmm(*args))
        assert torch.equal(k11a, shard_spmm(*args))
        base = torch.from_numpy(W.operand(20, n_rows, K)).cuda()
        once = shard_spmm(*args, out=base.clone())
        assert torch.equal(once, shard_spmm(*args, out=base.clone()))
        assert torch.equal(once, base + k11a)


@pytest.mark.gpu
@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("K", [1, 4, 8, 20, 40, 128, 256, 300])
def test_shard_spmm_minmax_matches_plain_exactly_on_gpu(K, is_min):
    _need_gpu()
    n_rows, n_buf, e0 = 3000, 2500, 123_456
    g = _group(11, n_rows, n_buf, 40_000, "cuda")
    buf = torch.from_numpy(W.tie_operand(12, n_buf, K)).cuda()
    buf[5, :] = float("nan")
    run = torch.from_numpy(W.tie_operand(13, n_rows, K)).cuda()
    run_arg = torch.from_numpy(np.random.RandomState(14).randint(
        e0, e0 + 80_000, (n_rows, K)).astype(np.int32)).cuda()
    for value in (g["value"], None):
        args = (g["rowptr"], g["col"], value, buf, is_min, e0)
        for out, arg in ((None, None), (run, run_arg)):
            kw = dict(pos=g["pos"], row_map=g["row_map"], n_rows=n_rows)
            if out is not None:
                kw.update(out=out.clone(), arg=arg.clone())
            got = shard_spmm_minmax(*args, **kw)
            if out is not None:
                kw.update(out=out.clone(), arg=arg.clone())
            ref = shard_spmm_minmax_plain(*args, **kw)
            assert torch.equal(got[1], ref[1])
            torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0,
                                       equal_nan=True)
    full = (g["full_ptr"], g["col"], g["value"], buf, is_min, e0)
    got = shard_spmm_minmax(*full, pos=g["pos"])
    ref = shard_spmm_minmax_plain(*full, pos=g["pos"])
    assert torch.equal(got[1], ref[1])


def _same_pair(got, ref):
    """out and arg exactly (NaN where the plain version has NaN)."""
    assert torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("K", [1, 4, 8, 20, 40, 128, 256, 300])
def test_shard_spmm_minmax_row_degrees_and_alignment_on_gpu(K, is_min):
    """K11b's walk at every instance the choice takes: rows of degree 0,
    1, around the 8 edges in flight and the 32-edge index loads, and
    2,000, as a slice of a pointer that does not start at 0, sent to
    scattered rows, with positions and an edge base; a tie-heavy
    integer operand with -inf and +inf rows (the sentinel itself) and
    NaN entries; written and combined into a running pair; with buf,
    out and arg aligned (float4 chunks where K % 4 == 0) and with buf 4
    bytes off a 16-byte boundary (the scalar instance).  out and arg
    equal the plain version's exactly."""
    _need_gpu()
    n_rows, n_buf, e0 = 1200, 800, 5_000
    g = _degree_group(21, n_rows, n_buf, WALK_DEGREES * 10, "cuda")
    E = g["col"].shape[0]
    pos = torch.from_numpy(np.random.RandomState(22).permutation(
        3 * E)[:E].astype(np.int32)).cuda()
    ops = W.tie_operand(23, n_buf, K)
    ops[::9] = -np.inf
    ops[4::9] = np.inf
    ops[2::17, ::3] = np.nan
    flat = torch.from_numpy(np.concatenate([[0.0], ops.ravel()]).astype(
        np.float32)).cuda()
    buf_off = flat[1:].view(n_buf, K)
    assert buf_off.data_ptr() % 16 == 4
    buf = buf_off.clone()
    run = torch.from_numpy(W.tie_operand(24, n_rows, K)).cuda()
    run_arg = torch.from_numpy(np.random.RandomState(25).randint(
        e0, e0 + 3 * E, (n_rows, K)).astype(np.int32)).cuda()
    for value in (g["value"], None):
        args = (g["rowptr"], g["col"], value)
        for b, aligned in ((buf, True), (buf_off, False)):
            kw = dict(pos=pos, row_map=g["row_map"])
            got = shard_spmm_minmax(*args, b, is_min, e0, n_rows=n_rows,
                                    **kw)
            assert shard_spmm_minmax.last_instance == \
                walk_instance(K, aligned)
            _same_pair(got, shard_spmm_minmax_plain(
                *args, b, is_min, e0, n_rows=n_rows, **kw))
            got = shard_spmm_minmax(*args, b, is_min, e0, out=run.clone(),
                                    arg=run_arg.clone(), **kw)
            _same_pair(got, shard_spmm_minmax_plain(
                *args, b, is_min, e0, out=run.clone(), arg=run_arg.clone(),
                **kw))
    # An output and an argout off a 16-byte boundary run the scalar
    # instance too, with the same bits.
    out_flat = torch.zeros(n_rows * K + 1, device="cuda")
    arg_flat = torch.zeros(n_rows * K + 1, dtype=torch.int32, device="cuda")
    out_off = out_flat[1:].view(n_rows, K)
    arg_off = arg_flat[1:].view(n_rows, K)
    out_off.copy_(run)
    arg_off.copy_(run_arg)
    args = (g["rowptr"], g["col"], g["value"], buf, is_min, e0)
    got = shard_spmm_minmax(*args, pos=pos, out=out_off, arg=arg_off,
                            row_map=g["row_map"])
    assert shard_spmm_minmax.last_instance.vec == 1
    _same_pair(got, shard_spmm_minmax(*args, pos=pos, out=run.clone(),
                                      arg=run_arg.clone(),
                                      row_map=g["row_map"]))


def _schedules(ws, backend, device):
    return W.spawn(W.run_schedules, ws, backend,
                   args=dict(M=118, K=40, graph=(12, 1600, 150, 3, 7),
                             block_B=8, seed=5, device=device),
                   timeout=300)[0]


def _compare(got, ref):
    """Every case of a CUDA run against the CPU run: ``arg`` and the
    min/max ``out`` exactly, sums and gradients to 1e-5."""
    cases = 0
    for key, r in ref.items():
        if not (isinstance(r, dict) and "out" in r):
            continue
        g = got[key]
        if "arg" in r:
            assert torch.equal(g["arg"], r["arg"]), key
            assert torch.equal(g["out"], r["out"]), key
        else:
            assert rel_err(g["out"], r["out"]) <= 1e-5, key
        assert rel_err(g["gx"], r["gx"]) <= 1e-5, key
        if "gv" in r:
            assert rel_err(g["gv"], r["gv"]) <= 1e-5, key
        cases += 1
    assert cases


@pytest.mark.gpu
@pytest.mark.parametrize("ws,backend", [(1, "nccl"), (4, "gloo")])
def test_schedules_on_cuda_match_the_cpu(ws, backend):
    _need_gpu()
    got = _schedules(ws, backend, "cuda")
    ref = _schedules(ws, "gloo", "cpu")
    assert got["value_length_raises"]
    assert (got["staged_bytes"] > 0) == (backend == "gloo")
    _compare(got, ref)


def _grid_run(fn, grid, backend, device, **kw):
    return W.spawn(fn, grid[0] * grid[1], backend,
                   args=dict(M=118, K=40, graph=(12, 1600, 150, 3, 7),
                             block_B=8, seed=5, device=device, **kw),
                   timeout=300)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("grid,backend", [((1, 1), "nccl"), ((2, 2), "gloo")])
def test_hier_on_cuda_matches_the_cpu(grid, backend):
    """The hierarchical schedule on CUDA shards (sub-group collectives on
    NCCL at one process, host-staged gloo on four) against the CPU."""
    _need_gpu()
    kw = dict(S=grid[0], C=grid[1])
    got = _grid_run(W.run_hier, grid, backend, "cuda", **kw)
    ref = _grid_run(W.run_hier, grid, "gloo", "cpu", **kw)
    assert got["hybrid_max_raises"]
    assert (got["staged_bytes"] > 0) == (backend == "gloo")
    _compare(got, ref)


@pytest.mark.gpu
def test_2d_on_cuda_matches_the_cpu():
    """The row schedules on a (2, 2) data x feature grid at K=40, so each
    feature rank runs the shard kernels on 20 columns."""
    _need_gpu()
    kw = dict(P=2, Pf=2)
    got = _grid_run(W.run_2d, (2, 2), "gloo", "cuda", **kw)
    ref = _grid_run(W.run_2d, (2, 2), "gloo", "cpu", **kw)
    assert got["indivisible_raises"] and got["x_cols"] == 20
    _compare(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [None, (1, 4), (4, 1)],
                         ids=["halo", "hier-1x4", "hier-4x1"])
def test_served_backward_is_deterministic_on_gpu(grid):
    """Four gloo processes on the card: the gradient of ``x`` through the
    halo (or hierarchical) sum, where rows are served to several peers,
    is the same bits in two passes and within 1e-5 of the CPU's."""
    _need_gpu()
    kw = dict(M=2048, K=64, E=60_000, seed=29, grid=grid)
    got = W.spawn(W.run_served_backward, 4, "gloo",
                  args=dict(kw, device="cuda", runs=2), timeout=300)[0]
    ref = W.spawn(W.run_served_backward, 4, "gloo",
                  args=dict(kw, device="cpu"), timeout=300)[0]
    assert torch.equal(got[0], got[1])
    assert rel_err(got[0], ref[0]) <= 1e-5


@pytest.mark.gpu
def test_dist_gcn2d_on_cuda_matches_the_cpu():
    """One ``DistGCN`` Adam step on a (2, 2) data x feature grid of four
    gloo processes on the card (8 -> 16 -> 4, 3 layers: each feature rank
    projects and aggregates half of a layer's columns) against the same
    step on CPU shards: the logits, the loss, the all-reduced gradients
    and the parameters after the step to 1e-5, and the parameters the
    same bits on every rank."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.models import GCN

    model = GCN(8, 16, 4, num_layers=3, device="cpu")
    layers = [(w.detach().clone(), b.detach().clone())
              for w, b in zip(model.weights, model.biases)]
    cases = [("ring", "ell"), ("halo", "auto")]

    def run(device):
        return W.spawn(W.run_dist_gcn2d, 4, "gloo",
                       args=dict(P=2, Pf=2, M=118,
                                 graph=(12, 1600, 150, 3, 0), layers=layers,
                                 n_classes=4, seed=11, schedules=cases,
                                 lr=1e-2, narrow_out=3, device=device),
                       timeout=300)

    got, ref = run("cuda"), run("cpu")
    assert all(r["narrow_raises"] for r in got)
    assert got[0]["staged_bytes"] > 0
    for s, f in cases:
        g, r = got[0][f"{s}-{f}"], ref[0][f"{s}-{f}"]
        assert rel_err(g["logits"], r["logits"]) <= 1e-5
        assert abs(float(g["loss"]) - float(r["loss"])) <= 1e-5 * abs(
            float(r["loss"]))
        for a, b in zip(g["grads"] + g["params"], r["grads"] + r["params"]):
            assert rel_err(a, b) <= 1e-5
        for rank in range(1, 4):
            for a, b in zip(g["params"], got[rank][f"{s}-{f}"]["params"]):
                assert torch.equal(a, b)
