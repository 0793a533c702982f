"""The structural op set and the tensor API on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip without them; they
import neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_structural_gpu.py

The row and column sums and the legacy tuple ``spmm`` add in a fixed
order through the CSR kernel (``csr_spmm`` over the identity columns):
two runs give the same bits, and so does the CPU.  Every op leaves its
output on the card, and value gradients equal the CPU's.
"""

import numpy as np
import pytest
import torch

import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu_torch.ops.kernels import csr_spmm


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no "
                    "CPU mode)")


def _graph(dev, seed=70, M=3000, N=2500, E=60_000, width=None,
           dtype=torch.float32):
    rng = np.random.RandomState(seed)
    row, col = rng.randint(0, M, E), rng.randint(0, N, E)
    shape = (E,) if width is None else (E, width)
    v = torch.from_numpy((rng.randn(*shape) * 1e3).astype(np.float32))
    A = pts.SparseTensor(row=row, col=col, value=v.to(dtype),
                         sparse_sizes=(M, N), device=dev)
    return A.coalesce("add")


def _on(dev_type, *tensors):
    for t in tensors:
        if isinstance(t, pts.SparseTensor):
            st = t.storage
            tensors_ = [st._row, st._rowptr, st._col, st._value,
                        st._rowcount, st._colptr, st._colcount, st._csr2csc,
                        st._csc2csr]
            _on(dev_type, *[x for x in tensors_ if x is not None])
        elif isinstance(t, torch.Tensor):
            assert t.device.type == dev_type, t.device
        else:
            _on(dev_type, *t)


@pytest.mark.gpu
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("width,dtype", [(None, torch.float32),
                                         (8, torch.float32),
                                         (None, torch.bfloat16)])
@pytest.mark.parametrize("dim", [0, 1])
def test_row_and_column_sums_equal_cpu_bits(dim, width, dtype, reduce):
    _need_gpu()
    A, C = _graph("cuda", width=width, dtype=dtype), \
        _graph("cpu", width=width, dtype=dtype)
    before = csr_spmm.launches
    a = pts.reduction(A, dim, reduce)
    b = pts.reduction(A, dim, reduce)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert csr_spmm.launches == before + 2
    assert a.device.type == "cuda"
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), pts.reduction(C, dim, reduce))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2500, 16), (2500, 1), (3, 2500, 8)])
def test_legacy_spmm_equals_cpu_bits_and_launches_k1(shape):
    _need_gpu()
    rng = np.random.RandomState(71)
    E = 50_000
    index = torch.from_numpy(np.stack([rng.randint(0, 3000, E),
                                       rng.randint(0, 2500, E)]))
    value = torch.from_numpy(rng.randn(E).astype(np.float32))
    mat = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    before = csr_spmm.launches
    a = pts.spmm(index.cuda(), value.cuda(), 3000, 2500, mat.cuda())
    b = pts.spmm(index.cuda(), value.cuda(), 3000, 2500, mat.cuda())
    torch.cuda.synchronize()
    assert csr_spmm.launches == before + 2
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), pts.spmm(index, value, 3000, 2500, mat))


@pytest.mark.gpu
def test_every_op_leaves_its_output_on_the_card():
    _need_gpu()
    A = _graph("cuda", M=2000, N=2000, E=20_000)
    B = _graph("cuda", seed=72, M=2000, N=2000, E=20_000)
    idx = torch.randperm(2000, generator=torch.Generator().manual_seed(0))
    mask = torch.rand(2000, generator=torch.Generator().manual_seed(1)) > .5
    d = torch.rand(2000, device="cuda")
    outs = [
        A.index_select(0, idx[:300]), A.index_select(1, idx[:300]),
        A.index_select_nnz(torch.arange(0, 900, 3), layout="coo"),
        A.masked_select(0, mask), A.masked_select(1, mask.cuda()),
        A.masked_select_nnz(torch.rand(A.nnz()) > .5, layout="coo"),
        A.narrow(0, 10, 500), A.narrow(1, 10, 500), A.select(0, 3),
        A[idx[:100], mask], A[5:70, ::1], A.permute(idx),
        pts.cat([A, B], dim=0), pts.cat([A, B], dim=1),
        pts.cat([A, B], dim=(0, 1)),
        pts.cat([A, B], dim=(0, 1)).__narrow_diag__((2000, 2000),
                                                    (2000, 2000)),
        A * B, A.mul(d.view(-1, 1)), A.mul(d.view(1, -1)),
        A.mul_nnz(torch.ones(A.nnz(), device="cuda"), layout="coo"),
        A.to_symmetric(), A.reverse_cuthill_mckee()[0],
        A.sparse_resize((2100, 2200)), A.sparse_reshape(4000, 1000),
        A.fill_diag(1.0), A.astype(torch.float16), A.half(), A.detach(),
        pts.SparseTensor.eye(5, fill_cache=True),
        pts.SparseTensor.from_scipy(A.to_scipy(layout="csc")),
        pts.SparseTensor.from_edge_index(torch.stack(A.coo()[:2])),
        pts.SparseTensor.from_torch_sparse_coo_tensor(
            A.to_torch_sparse_coo_tensor()),
        pts.SparseTensor.from_torch_sparse_csr_tensor(
            A.to_torch_sparse_csr_tensor()),
        pts.SparseTensor.from_dense(A.to_dense()).to_device("cuda"),
    ]
    for X in outs:
        X.fill_cache_()
    _on("cuda", outs)
    for dim in (None, 0, 1):
        for reduce in ("sum", "mean", "min", "max"):
            _on("cuda", [pts.reduction(A, dim, reduce)])
    _on("cuda", [pts.eye(4), pts.from_scipy(A.to_scipy()),
                 pts.non_diag_mask(A.storage.row(), A.storage.col(), 2000,
                                   2000, 0),
                 A.reverse_cuthill_mckee()[1]])
    assert A.cpu().device().type == "cpu" and A.cpu().cuda().is_cuda
    pinned = A.cpu().pin_memory()
    assert pinned.is_pinned() and pinned == A.cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["index_select0", "index_select1", "narrow",
                                "mul_row", "mul_col", "masked_select",
                                "index_select_repeats"])
def test_value_gradients_equal_cpu(op):
    """The value's gradient bit for bit; the broadcast operand's (sums
    over each row's or column's edges) to 1e-5 of max |ref|."""
    _need_gpu()
    # distinct indices: each value gets at most one gradient term
    idx = np.random.RandomState(73).permutation(2500)[:700]
    mask = np.random.RandomState(74).rand(3000) < 0.4
    reps = np.random.RandomState(78).randint(0, 40, 3000)
    fns = {"index_select0": lambda A, o: A.index_select(0, idx),
           "index_select1": lambda A, o: A.index_select(1, idx),
           "narrow": lambda A, o: A.narrow(0, 100, 1500),
           "mul_row": lambda A, o: A.mul(o.unsqueeze(1)),       # (M, 1, 4)
           "mul_col": lambda A, o: A.mul(o[:2500].unsqueeze(0)),  # (1, N, 4)
           "masked_select": lambda A, o: A.masked_select(0, mask),
           # repeated rows: each value's terms added in a fixed order
           "index_select_repeats": lambda A, o: A.index_select(0, reps)}

    def grads(dev):
        A = _graph(dev, width=4)
        v = A.storage.value().detach().clone().requires_grad_(True)
        o = torch.from_numpy(np.random.RandomState(75).randn(
            3000, 4).astype(np.float32)).to(dev).requires_grad_(True)
        out = fns[op](A.set_value(v, layout="coo"), o).storage.value()
        w = torch.from_numpy(np.random.RandomState(76).randn(
            *out.shape).astype(np.float32)).to(dev)
        gv, go = torch.autograd.grad((out * w).sum(), (v, o),
                                     allow_unused=True)
        return gv, go

    (gv, go), (cv, co) = grads("cuda"), grads("cpu")
    assert gv.device.type == "cuda"
    assert torch.equal(gv.cpu(), cv)
    if co is not None:  # the operand's: sums over edges, 1e-5 of max |ref|
        assert float((go.cpu() - co).abs().max() / co.abs().max()) <= 1e-5


@pytest.mark.gpu
def test_torch_sparse_csr_product_agrees_with_k1():
    _need_gpu()
    A = _graph("cuda")
    x = torch.from_numpy(np.random.RandomState(77).randn(
        2500, 128).astype(np.float32)).cuda()
    got = A.to_torch_sparse_csr_tensor() @ x
    want = csr_spmm(*A.csr(), x)
    assert got.device.type == "cuda"
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-5
