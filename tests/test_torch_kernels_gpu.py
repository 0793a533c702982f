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
    block_spmm, block_spmm_plain, csr_spmm, csr_spmm_plain)
from pytorch_sparse_tpu_torch.ops.kernels import hybrid as phyb
from pytorch_sparse_tpu_torch.testing import rel_err


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no "
                    "CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("K", [40, 128, 300])
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
    for blocks in (h.blocks, h.blocks.to(torch.bfloat16)):
        assert rel_err(block_spmm(blocks, h.slot_col, h.rb_ptr, xb),
                       block_spmm_plain(blocks, h.slot_col, h.rb_ptr, xb)
                       ) <= 1e-5


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
