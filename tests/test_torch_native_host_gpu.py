"""The host Gustavson SpGEMM, the host sorts and coalesce with a card.

These tests need an NVIDIA GPU and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_native_host_gpu.py

``spspmm_native`` and the index sorts run on the host, so a card's
outputs equal the CPU's bit for bit: values on the card are pulled once,
and the results land on the operands' device.  Products past the plan's
limit and streams of operands on the card take the plan (``plan_numeric``
on the card), and coalesce sums card values there (``csr_spmm``).
"""

import numpy as np
import pytest
import torch

import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu_torch.ops import spgemm as pspgemm
from pytorch_sparse_tpu_torch.ops.kernels import (
    block_spgemm_window, csr_spmm, plan_numeric)
from pytorch_sparse_tpu_torch.testing import community_graph
from pytorch_sparse_tpu_torch.utils import _native
from pytorch_sparse_tpu_torch.utils.host_sort import _TORCH_MIN


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no "
                    "CPU mode)")


def _pair(dev, dtype, seed=60, M=900, N=800, P=850):
    rng = np.random.RandomState(seed)
    mats = []
    for (m, n), E in (((M, N), 40_000), ((N, P), 35_000)):
        v = torch.from_numpy(rng.randn(E).astype(np.float32)).to(dtype)
        mats.append(pts.SparseTensor(
            row=rng.randint(0, m, E), col=rng.randint(0, n, E),
            value=v.to(dev), sparse_sizes=(m, n), device=dev).coalesce())
    return mats


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spspmm_native_on_card_values_equals_the_cpu(dtype, monkeypatch):
    """Card-resident values are pulled once each; the product lands on
    the card with the CPU's bits, and no kernel runs."""
    _need_gpu()
    res = []
    for dev in ("cpu", "cuda"):
        A, B = _pair(dev, dtype)
        pulls = []
        real = pspgemm._to_numpy
        monkeypatch.setattr(pspgemm, "_to_numpy",
                            lambda t: pulls.append(t.device.type) or real(t))
        plan_numeric.launches = 0
        C = pts.spspmm_native(A, B)
        monkeypatch.setattr(pspgemm, "_to_numpy", real)
        assert pulls == [dev, dev] and plan_numeric.launches == 0
        assert C.device().type == dev and C.storage.value().dtype == dtype
        res.append([C.storage.numpy_view("rowptr"), C.storage.numpy_view(
            "col"), C.storage.value().cpu().view(
                torch.int16 if dtype == torch.bfloat16 else torch.int32)])
    for a, b in zip(*res):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
@pytest.mark.parametrize("E", [_TORCH_MIN - 1, 200_000])
def test_construction_of_card_tensors_equals_the_cpu(E):
    """Unsorted card tensors on both sides of the crossover: the CPU's
    indices, values and ``csr2csc``, and ``coalesce`` sums with the
    CPU's bits, past the crossover on the card (``csr_spmm``)."""
    _need_gpu()
    rng = np.random.RandomState(61)
    row, col = rng.randint(0, 3000, E), rng.randint(0, 2000, E)
    val = torch.from_numpy(rng.randn(E).astype(np.float32))
    out = []
    for dev in ("cpu", "cuda"):
        A = pts.SparseTensor(row=torch.from_numpy(row).to(dev),
                             col=torch.from_numpy(col).to(dev),
                             value=val.to(dev), sparse_sizes=(3000, 2000),
                             device=dev)
        assert A.device().type == dev
        csr_spmm.launches = 0
        C = A.coalesce()
        assert (csr_spmm.launches > 0) == (dev == "cuda" and E >= _TORCH_MIN)
        out.append([A.storage.numpy_view("row"), A.storage.numpy_view("col"),
                    A.storage.numpy_view("csr2csc"),
                    A.storage.value().cpu().numpy(),
                    C.storage.numpy_view("col"),
                    C.storage.value().cpu().numpy()])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype ==
                                      np.float32 else a,
                                      b.view(np.int32) if b.dtype ==
                                      np.float32 else b)


@pytest.mark.gpu
def test_coalesce_negative_zero_runs_on_the_card_equal_the_cpu():
    """Past the crossover a run whose every value is -0.0 sums to -0.0 on
    the card too (``csr_spmm`` adds from 0; the second ``Runs`` pass
    restores the sign), and a mixed run to +0.0: the CPU's bits."""
    _need_gpu()
    rng = np.random.RandomState(62)
    E = 60_000
    row, col = rng.randint(0, 40, E), rng.randint(0, 30, E)
    val = rng.randn(E).astype(np.float32)
    key = (row * 30 + col) % 7
    val[key == 0] = -0.0
    val[key == 1] = np.where(np.arange(E)[key == 1] % 2, 0.0, -0.0)
    bits = []
    for dev in ("cpu", "cuda"):
        csr_spmm.launches = 0
        A = pts.SparseTensor(row=row, col=col, value=torch.from_numpy(
            val).to(dev), sparse_sizes=(40, 30), device=dev).coalesce()
        v = A.storage.value()
        assert v.device.type == dev
        assert csr_spmm.launches == (2 if dev == "cuda" else 0)
        bits.append(v.cpu().view(torch.int32).numpy())
    zeros = np.signbit(bits[0].view(np.float32)[bits[0].view(np.float32)
                                                == 0])
    assert zeros.any() and not zeros.all()
    np.testing.assert_array_equal(bits[0], bits[1])


@pytest.mark.gpu
@pytest.mark.parametrize("grad", [False, True])
def test_large_products_of_card_operands_take_the_plan(grad, monkeypatch):
    """Past ``PLAN_MAX_TERMS``, operands on the card take the chunked
    plan whether or not a value requires grad: ``plan_numeric`` runs and
    the host Gustavson does not; the CPU's native product agrees."""
    _need_gpu()
    calls = []
    real = _native.spgemm
    monkeypatch.setattr(_native, "spgemm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(pspgemm, "PLAN_MAX_TERMS", 200_000)
    out = []
    for dev in ("cpu", "cuda"):
        A, B = _pair(dev, torch.float32)
        if grad:
            A = A.set_value(A.storage.value().requires_grad_(True),
                            layout="coo")
        plan_numeric.launches = 0
        calls.clear()
        assert pts.expansion_terms(A, B) > 200_000
        C = A @ B
        assert C.device().type == dev
        if dev == "cuda":
            assert plan_numeric.launches > 0 and not calls
        else:
            assert bool(calls) != grad
        out.append(C)
    for key in ("rowptr", "col"):
        np.testing.assert_array_equal(out[0].storage.numpy_view(key),
                                      out[1].storage.numpy_view(key))
    torch.testing.assert_close(out[1].storage.value().detach().cpu(),
                               out[0].storage.value().detach(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_stream_device_cross_terms_run_plan_numeric():
    """``spspmm_stream_device`` in the manner of ``chip_smoke.py``'s phase
    8c: ``block_spgemm_window`` for the block pairs, the plan's
    ``plan_numeric`` for the cross terms (no host Gustavson), and the
    pieces add up to scipy's product."""
    _need_gpu()
    sp = pytest.importorskip("scipy.sparse")
    A = community_graph(2048, 300_000, 16, seed=62, equal_sizes=True,
                        device="cuda")
    plan_numeric.launches = block_spgemm_window.launches = 0
    pieces = list(pts.spspmm_stream_device(A, A, Bb=128, min_density=0.05))
    torch.cuda.synchronize()
    assert plan_numeric.launches > 0 and block_spgemm_window.launches > 0
    kinds = {p[0] for p in pieces}
    assert kinds == {"blocks", "coo"}
    assert sum(p[3].nnz() for p in pieces if p[0] == "coo") > 0
    dense = np.zeros((2048, 2048))
    for p in pieces:
        if p[0] == "blocks":
            _, rows, cols, blk = p
            for r, c, b in zip(rows, cols, blk):
                dense[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] += \
                    b.double().cpu().numpy()
        else:
            _, lo, hi, blk = p
            assert blk.device().type == "cuda"
            dense[lo:hi] += blk.to_dense().double().cpu().numpy()
    r, c, v = (t.cpu().numpy() for t in A.coo())
    S = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=(2048, 2048))
    ref = (S @ S).toarray()
    assert np.abs(dense - ref).max() <= 1e-5 * np.abs(ref).max()
