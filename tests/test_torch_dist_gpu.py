"""The shard kernels K11a/K11b against their plain versions on the
card, and the distributed schedules on CUDA shards against the same
schedules on CPU shards (plain versions): world size 1 on NCCL, and 4
processes sharing one card on gloo, which stages every collective
through the host.

These tests need an NVIDIA GPU and ``nvcc`` and skip without them; they
import neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_dist_gpu.py
"""

import numpy as np
import pytest
import torch

from pytorch_sparse_tpu_torch.ops.kernels import (
    shard_spmm, shard_spmm_minmax, shard_spmm_minmax_plain, shard_spmm_plain)
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
@pytest.mark.parametrize("K", [1, 40, 128, 256, 300])
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


@pytest.mark.gpu
@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("K", [1, 40, 128, 300])
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


def _schedules(ws, backend, device):
    return W.spawn(W.run_schedules, ws, backend,
                   args=dict(M=118, K=40, graph=(12, 1600, 150, 3, 7),
                             block_B=8, seed=5, device=device),
                   timeout=300)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("ws,backend", [(1, "nccl"), (4, "gloo")])
def test_schedules_on_cuda_match_the_cpu(ws, backend):
    _need_gpu()
    got = _schedules(ws, backend, "cuda")
    ref = _schedules(ws, "gloo", "cpu")
    assert got["value_length_raises"]
    assert (got["staged_bytes"] > 0) == (backend == "gloo")
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
