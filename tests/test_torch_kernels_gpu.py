"""The CUDA kernels against their plain versions on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip without them; they
import neither JAX nor the JAX package, so they also run where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu_torch.ops.kernels import (
    block_spmm, block_spmm_plain, block_spmm_t, block_spmm_t_plain, csr_spmm,
    csr_spmm_plain, edge_dot, edge_dot_plain)
from pytorch_sparse_tpu_torch.ops.kernels import hybrid as phyb
from pytorch_sparse_tpu_torch.testing import rel_err


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no "
                    "CPU mode)")


def _t_args(h, M, K, seed):
    """The transpose pass's arguments: the schedule and a padded g."""
    R = h.rb_ptr.shape[0] - 1
    g = torch.from_numpy(_x(seed, M, K)).cuda()
    gb = torch.cat([g, g.new_zeros((R * h.B - M, K))])
    return h.slot_row, h.order_t, h.cb_ptr, gb


@pytest.mark.gpu
@pytest.mark.parametrize("K", [40, 128, 256, 300])
def test_kernels_match_plain_versions_on_gpu(K):
    _need_gpu()
    rng = np.random.RandomState(18)
    M = N = 3000
    row, col = rng.randint(0, M, 40_000), rng.randint(0, N, 40_000)
    B = pts.SparseTensor(row=row, col=col, value=rng.randn(40_000).astype(
        np.float32), sparse_sizes=(M, N))
    rowptr, c, v = B.csr()
    x = torch.from_numpy(_x(19, N, K)).cuda()
    for vv in (v, None):
        assert rel_err(csr_spmm(rowptr, c, vv, x),
                       csr_spmm_plain(rowptr, c, vv, x)) <= 1e-5
    h = phyb.build_hybrid(B.storage.numpy_view("row"),
                          B.storage.numpy_view("col"),
                          B.storage.value().cpu().numpy(), M, N, B=128,
                          min_density=0.0, device="cuda")
    xb = torch.cat([x, x.new_zeros((24 * 128 - N, K))])
    t_args = _t_args(h, M, K, 23)
    for blocks in (h.blocks, h.blocks.to(torch.bfloat16)):
        assert rel_err(block_spmm(blocks, h.slot_col, h.rb_ptr, xb),
                       block_spmm_plain(blocks, h.slot_col, h.rb_ptr, xb)
                       ) <= 1e-5
        assert rel_err(block_spmm_t(blocks, *t_args),
                       block_spmm_t_plain(blocks, *t_args)) <= 1e-5
    g = torch.from_numpy(_x(24, M, K)).cuda()
    got = edge_dot(rowptr, c, x, g)
    assert got.shape == (40_000,)
    assert rel_err(got, edge_dot_plain(rowptr, c, x, g)) <= 1e-5


@pytest.mark.gpu
def test_block_kernel_masks_ragged_tiles():
    _need_gpu()
    rng = np.random.RandomState(20)
    M, B_blk = 450, 100  # B not a multiple of the 128-row tile
    row, col = rng.randint(0, M, 30_000), rng.randint(0, M, 30_000)
    val = rng.randn(30_000).astype(np.float32)
    h = phyb.build_hybrid(row, col, val, M, M, B=B_blk, min_density=0.0,
                          device="cuda")
    x = torch.from_numpy(_x(21, 5 * B_blk, 70)).cuda()
    assert rel_err(block_spmm(h.blocks, h.slot_col, h.rb_ptr, x),
                   block_spmm_plain(h.blocks, h.slot_col, h.rb_ptr, x)) <= 1e-5
    t_args = _t_args(h, M, 70, 25)
    assert rel_err(block_spmm_t(h.blocks, *t_args),
                   block_spmm_t_plain(h.blocks, *t_args)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("M,budget,route", [
    (3_000, 0.0, None), (8_192, 0.0, "HybridFormat"),
    (2_048, 0.0, "DenseFormat"), (2_048, 2e-3, "DenseFormat")])
def test_routed_grads_match_cpu(M, budget, route):
    """Both gradients of the routed SpMM on the card against the CPU's
    plain versions: the CSR route at M=3000, the hybrid route at M=8192,
    and the dense route at M=2048 with an f32 store (budget 0) and a bf16
    store (budget 2e-3)."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.testing import community_graph

    phyb.set_store_budget(budget)
    try:
        grads = []
        for dev in ("cpu", "cuda"):
            if route is None:
                rng = np.random.RandomState(26)
                A = pts.SparseTensor(
                    row=rng.randint(0, M, 40_000),
                    col=rng.randint(0, M, 40_000),
                    value=rng.randn(40_000).astype(np.float32),
                    sparse_sizes=(M, M), device=dev)
            else:
                A = community_graph(M, 300_000, n_comm=8, seed=1,
                                    equal_sizes=True, device=dev)
            v = A.storage.value().clone().requires_grad_(True)
            A = A.set_value(v, layout="coo")
            x = torch.from_numpy(_x(27, M, 64)).to(dev).requires_grad_(True)
            gout = torch.from_numpy(_x(28, M, 64)).to(dev)
            out = pts.spmm_sum(A, x)
            h = A.storage.hybrid(auto=False)
            assert (None if h is None else type(h).__name__) == route
            grads.append([t.cpu() for t in torch.autograd.grad(
                out, (v, x), gout)])
    finally:
        phyb.set_store_budget(0.0)
    for got, ref in zip(grads[1], grads[0]):
        assert rel_err(got, ref) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [0.0, 2e-3])
@pytest.mark.parametrize("M", [2_048, 8_192])
def test_routed_spmm_matches_cpu(M, budget):
    _need_gpu()
    from pytorch_sparse_tpu_torch.testing import community_graph

    phyb.set_store_budget(budget)
    try:
        outs = []
        for dev in ("cpu", "cuda"):
            A = community_graph(M, 300_000, n_comm=8, seed=1,
                                equal_sizes=True, device=dev)
            x = torch.from_numpy(_x(22, M, 64)).to(dev)
            outs.append(pts.spmm_sum(A, x).cpu())
            assert A.storage.has_hybrid()
    finally:
        phyb.set_store_budget(0.0)
    assert rel_err(outs[1], outs[0]) <= 1e-5
