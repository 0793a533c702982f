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
    block_spgemm_window, block_spgemm_window_plain, block_spmm,
    block_spmm_dblocks, block_spmm_dblocks_plain, block_spmm_plain,
    block_spmm_t, block_spmm_t_plain, csr_spmm, csr_spmm_minmax,
    csr_spmm_minmax_plain, csr_spmm_plain, edge_dot, edge_dot_plain,
    edge_softmax, edge_softmax_bwd, edge_softmax_bwd_plain,
    edge_softmax_plain, minmax_edge_dot, minmax_edge_dot_plain,
    minmax_spmm_t, minmax_spmm_t_plain, plan_numeric, plan_numeric_plain)
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
@pytest.mark.parametrize("B", [100, 128, 512])
@pytest.mark.parametrize("K", [40, 47, 70, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("integer", [False, True])
def test_block_kernel_masks_ragged_tiles(B, K, dtype, integer):
    """K2 and K5 against their plain versions (1e-5 of max |ref|) at
    ragged and whole block sizes (B=100 is not a multiple of the 128-row
    tile, and its bf16 rows are not 16 bytes: the store is padded at
    build) and odd widths (47, 70: the operand's rows are padded for
    TMA), with f32 and bf16 stores, on 5 row blocks of which the last is
    ragged, the second has no slot (its rows of the forward must be zero)
    and the third column block has none (its rows of the transpose must
    be zero).  Integer-valued inputs make every sum exact, so that a
    layout fault cannot hide in rounding: those must be equal."""
    _need_gpu()
    rng = np.random.RandomState(20)
    M = 4 * B + B // 2
    row, col = rng.randint(0, M, 30_000), rng.randint(0, M, 30_000)
    row = np.where((row >= B) & (row < 2 * B), row + B, row)
    col = np.where((col >= 2 * B) & (col < 3 * B), col + B, col)
    val = (rng.randint(-3, 4, 30_000) if integer
           else rng.randn(30_000)).astype(np.float32)
    h = phyb.build_hybrid(row, col, val, M, M, B=B, min_density=0.0,
                          device="cuda", block_dtype=dtype)
    assert int(h.rb_ptr[1]) == int(h.rb_ptr[2])  # row block 1: no slot
    assert int(h.cb_ptr[2]) == int(h.cb_ptr[3])  # column block 2: none
    C = h.cb_ptr.shape[0] - 1
    if integer:
        x = torch.from_numpy(rng.randint(-3, 4, (C * B, K)).astype(
            np.float32)).cuda()
    else:
        x = torch.from_numpy(_x(21, C * B, K)).cuda()
    tol = 0.0 if integer else 1e-5
    got = block_spmm(h.blocks, h.slot_col, h.rb_ptr, x)
    assert rel_err(got, block_spmm_plain(h.blocks, h.slot_col, h.rb_ptr,
                                         x)) <= tol
    assert not bool(got[B:2 * B].any())
    t_args = _t_args(h, M, K, 25)
    if integer:
        t_args = t_args[:3] + (t_args[3].round(),)
    got = block_spmm_t(h.blocks, *t_args)
    assert rel_err(got, block_spmm_t_plain(h.blocks, *t_args)) <= tol
    assert not bool(got[2 * B:3 * B].any())


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
@pytest.mark.parametrize("M,route", [(8_192, "HybridFormat"),
                                     (2_048, "DenseFormat")])
def test_value_write_reaches_the_routed_product_on_gpu(M, route):
    """After a write through ``.data`` (no version counter moves), the
    routed product on the card, forward and ``grad_x``, equals the CPU's
    on the new values, and the view keeps its structure."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.testing import community_graph

    res = []
    for dev in ("cpu", "cuda"):
        A = community_graph(M, 300_000, n_comm=8, seed=1, equal_sizes=True,
                            device=dev)
        x = torch.from_numpy(_x(29, M, 64)).to(dev).requires_grad_(True)
        gout = torch.from_numpy(_x(30, M, 64)).to(dev)
        pts.spmm_sum(A, x.detach())
        h0 = A.storage.hybrid(auto=False)
        assert type(h0).__name__ == route
        v = A.storage.value()
        v.data.copy_(torch.from_numpy(_x(31, v.shape[0])).to(dev))
        out = pts.spmm_sum(A, x)
        h1 = A.storage.hybrid(auto=False)
        assert h1 is not h0 and h1.index is h0.index
        res.append([out.detach().cpu()] + [
            g.cpu() for g in torch.autograd.grad(out, (x,), gout)])
    for got, ref in zip(res[1], res[0]):
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


def _minmax_case(case, M, N, K, seed):
    """A CUDA matrix and operand for the min/max kernels: ``random``
    (N(0, 1)), ``ties`` (small integers, so most extremes tie),
    ``inf`` (a fifth of the operand -inf, some +inf), ``nan`` (2% NaN)
    and ``empty`` (half the rows empty)."""
    rng = np.random.RandomState(seed)
    E = 8 * M
    row = rng.randint(0, M // 2 if case == "empty" else M, E)
    col = rng.randint(0, N, E)
    x = rng.randn(N, K).astype(np.float32)
    val = rng.randn(E).astype(np.float32)
    if case == "ties":
        x = rng.randint(-2, 3, (N, K)).astype(np.float32)
        val = rng.randint(-2, 3, E).astype(np.float32)
    elif case == "inf":
        x[rng.rand(N, K) < 0.2] = -np.inf
        x[rng.rand(N, K) < 0.02] = np.inf
    elif case == "nan":
        x[rng.rand(N, K) < 0.02] = np.nan
    A = pts.SparseTensor(row=row, col=col, value=val, sparse_sizes=(M, N))
    return A, torch.from_numpy(x).cuda()


def _same(got, ref, rtol=0.0):
    torch.testing.assert_close(got, ref, rtol=rtol, atol=0.0 if rtol == 0
                               else rtol * float(ref.nan_to_num(
                                   0.0, 0.0, 0.0).abs().max()),
                               equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "ties", "inf", "nan", "empty"])
@pytest.mark.parametrize("K", [40, 128, 300])
def test_minmax_kernels_match_plain_versions_on_gpu(case, K):
    """K6 (out and arg exactly) and both backward kernels (to 1e-5 of
    max |ref|, NaN where the plain version has NaN) against their plain
    versions, with values and implicit ones, min and max."""
    _need_gpu()
    M, N = 2000, 1500
    A, x = _minmax_case(case, M, N, K, 30)
    rowptr, col, val = A.csr()
    st = A.storage
    g = torch.from_numpy(_x(31, M, K)).cuda()
    for vv in (val, None):
        for is_min in (True, False):
            out, arg = csr_spmm_minmax(rowptr, col, vv, x, is_min)
            ref_out, ref_arg = csr_spmm_minmax_plain(rowptr, col, vv, x,
                                                     is_min)
            assert torch.equal(arg, ref_arg)
            _same(out, ref_out)
            _same(minmax_edge_dot(rowptr, col, x, g, arg),
                  minmax_edge_dot_plain(rowptr, col, x, g, arg), 1e-5)
            t_args = (st.colptr(), st.csc_row(), st.csr2csc(), vv, g, arg)
            _same(minmax_spmm_t(*t_args), minmax_spmm_t_plain(*t_args), 1e-5)
    if case == "empty":
        assert bool((arg[M // 2:] == A.nnz()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_minmax_kernel_half_operands_on_gpu(dtype, case):
    """Half operands compare in their own dtype: out and arg equal the
    plain version's exactly."""
    _need_gpu()
    A, x = _minmax_case(case, 1000, 800, 72, 32)
    rowptr, col, val = A.csr()
    xh = x.to(dtype)
    for is_min in (True, False):
        out, arg = csr_spmm_minmax(rowptr, col, val, xh, is_min)
        ref_out, ref_arg = csr_spmm_minmax_plain(rowptr, col, val, xh, is_min)
        assert out.dtype == dtype and torch.equal(arg, ref_arg)
        assert torch.equal(out, ref_out)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 3, 8, 32, 40])
def test_edge_softmax_matches_plain_on_gpu(H):
    """K8 and K8b against their plain versions (1e-5 of max |ref|; NaN on
    a row-head whose logits are all -inf, in both), on a matrix with
    empty rows and one row of 3,000 edges; a CUDA logits that requires
    grad gets its gradient from one K8b launch."""
    _need_gpu()
    rng = np.random.RandomState(33)
    M, E = 3000, 24_000
    row = np.concatenate([rng.randint(0, M // 2, E), np.full(3000, 7)])
    col = rng.randint(0, M, E + 3000)
    A = pts.SparseTensor(row=row, col=col, sparse_sizes=(M, M))
    rowptr = A.storage.rowptr()
    logits = rng.randn(E + 3000, H).astype(np.float32) * 4
    logits[rng.rand(E + 3000, H) < 0.1] = -np.inf
    logits = torch.from_numpy(logits).cuda()
    got = edge_softmax(rowptr, logits)
    _same(got, edge_softmax_plain(rowptr, logits), 1e-5)
    g = torch.from_numpy(_x(39, E + 3000, H)).cuda()
    _same(edge_softmax_bwd(rowptr, got, g),
          edge_softmax_bwd_plain(rowptr, got, g), 1e-5)
    finite = torch.where(torch.isinf(logits), -30.0, logits)
    lt = finite.clone().requires_grad_(True)
    edge_softmax_bwd.launches = 0
    (edge_softmax(rowptr, lt) * g).sum().backward()
    assert edge_softmax_bwd.launches == 1
    p = edge_softmax_plain(rowptr, finite)
    _same(lt.grad, edge_softmax_bwd_plain(rowptr, p, g), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("reduce", ["min", "max"])
def test_minmax_api_matches_cpu(reduce):
    """The public ``spmm_min``/``spmm_max`` and both gradients on the card
    against the CPU's plain versions, for a 2-D and a 3-D operand."""
    _need_gpu()
    fn = pts.spmm_min if reduce == "min" else pts.spmm_max
    for shape in ((1500, 48), (3, 1500, 20)):
        res = []
        for dev in ("cpu", "cuda"):
            rng = np.random.RandomState(34)
            A = pts.SparseTensor(row=rng.randint(0, 2000, 16_000),
                                 col=rng.randint(0, 1500, 16_000),
                                 value=rng.randn(16_000).astype(np.float32),
                                 sparse_sizes=(2000, 1500), device=dev)
            v = A.storage.value().clone().requires_grad_(True)
            x = torch.from_numpy(_x(35, *shape)).to(dev).requires_grad_(True)
            out, arg = fn(A.set_value(v, layout="coo"), x)
            gout = torch.from_numpy(_x(36, *out.shape)).to(dev)
            gv, gx = torch.autograd.grad(out, (v, x), gout)
            res.append([t.detach().cpu() for t in (out, arg, gv, gx)])
        (o0, a0, gv0, gx0), (o1, a1, gv1, gx1) = res
        assert torch.equal(a1, a0) and torch.equal(o1, o0)
        assert rel_err(gv1, gv0) <= 1e-5 and rel_err(gx1, gx0) <= 1e-5


@pytest.mark.gpu
def test_gat_inference_matches_cpu():
    """GAT inference on the card (edge_softmax twice, csr_spmm once per
    head and once for the output layer) against the CPU."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.models import GAT

    rng = np.random.RandomState(37)
    row, col = rng.randint(0, 2500, 20_000), rng.randint(0, 2500, 20_000)
    x = _x(38, 2500, 32)
    outs = []
    for dev in ("cpu", "cuda"):
        A = pts.SparseTensor(row=row, col=col, sparse_sizes=(2500, 2500),
                             device=dev)
        model = GAT(32, 8, 7, heads=8,
                    generator=torch.Generator().manual_seed(1), device=dev)
        edge_softmax.launches = csr_spmm.launches = 0
        with torch.no_grad():
            outs.append(model(A, torch.from_numpy(x).to(dev)).cpu())
    assert (edge_softmax.launches, csr_spmm.launches) == (2, 9)
    assert rel_err(outs[1], outs[0]) <= 1e-5


def _spgemm_pair(dev, seed=40, values=(True, True), M=700, N=600, P=650):
    rng = np.random.RandomState(seed)
    A = pts.SparseTensor(row=rng.randint(0, M, 9_000),
                         col=rng.randint(0, N, 9_000),
                         value=rng.randn(9_000).astype(np.float32)
                         if values[0] else None,
                         sparse_sizes=(M, N), device=dev)
    B = pts.SparseTensor(row=rng.randint(0, N, 8_000),
                         col=rng.randint(0, P, 8_000),
                         value=rng.randn(8_000).astype(np.float32)
                         if values[1] else None,
                         sparse_sizes=(N, P), device=dev)
    return A.coalesce(), B.coalesce()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_numeric_matches_plain_on_gpu(dtype):
    """K9 against its plain version: the forward plan with both values,
    with one side implicit ones, and both backward orderings (the terms
    re-sorted by A entry and by B entry); an empty plan and outputs with
    no terms."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.matmul import _Plan

    A, B = _spgemm_pair("cuda")
    plan = _Plan(A, B)
    va, vb = (A.storage.value().to(dtype), B.storage.value().to(dtype))
    a_pos, b_pos, t_ptr = (plan.dev(n) for n in ("a_pos", "b_pos", "t_ptr"))
    for args in ((va, a_pos, vb, b_pos, t_ptr), (va, a_pos, None, None, t_ptr),
                 (vb, b_pos, None, None, t_ptr)):
        got = plan_numeric(*args)
        assert got.dtype == dtype and got.shape == (plan.n_out,)
        assert rel_err(got, plan_numeric_plain(*args)) <= 1e-5
    grad = torch.from_numpy(_x(41, plan.n_out)).cuda().to(dtype)
    for side, other in (("a", vb), ("b", va)):
        out_id, pos, ptr = plan._by(side)
        args = (grad, out_id, other, pos, ptr)
        assert rel_err(plan_numeric(*args), plan_numeric_plain(*args)) <= 1e-5
    i32 = dict(dtype=torch.int32, device="cuda")
    e = torch.zeros(0, **i32)
    assert plan_numeric(va, e, vb, e, torch.zeros(1, **i32)).shape == (0,)
    gaps = torch.tensor([0, 0, 2, 2, 3], **i32)  # outputs 0 and 2: no terms
    idx = torch.tensor([5, 7, 9], **i32)
    assert torch.equal(plan_numeric(va, idx, vb, idx, gaps),
                       plan_numeric_plain(va, idx, vb, idx, gaps))


@pytest.mark.gpu
@pytest.mark.parametrize("values", [(True, True), (True, False),
                                    (False, False)])
def test_spspmm_and_grads_match_cpu(values):
    """``A @ B`` and both value gradients on the card (K9 forward and
    backward) against the CPU's plain versions."""
    _need_gpu()
    res = []
    for dev in ("cpu", "cuda"):
        A, B = _spgemm_pair(dev, values=values)
        leaves = []
        if values[0]:
            A = A.set_value(A.storage.value().clone().requires_grad_(True),
                            layout="coo")
            leaves.append(A.storage.value())
        if values[1]:
            B = B.set_value(B.storage.value().clone().requires_grad_(True),
                            layout="coo")
            leaves.append(B.storage.value())
        plan_numeric.launches = 0
        C = A @ B
        row, col, v = C.coo()
        out = [row.cpu(), col.cpu()]
        if v is not None:
            gout = torch.from_numpy(_x(42, C.nnz())).to(dev)
            out += [v.detach().cpu()] + [g.cpu() for g in torch.autograd.grad(
                v, leaves, gout)]
        if dev == "cuda":
            assert plan_numeric.launches == (0 if v is None
                                             else 1 + len(leaves))
        res.append(out)
    assert torch.equal(res[1][0], res[0][0])
    assert torch.equal(res[1][1], res[0][1])
    for got, ref in zip(res[1][2:], res[0][2:]):
        assert rel_err(got, ref) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("Bb", [100, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_block_spgemm_window_matches_plain_on_gpu(Bb, dtype, integer,
                                                  padded):
    """K10 against its plain version (1e-5 of max |ref|; integer-valued
    blocks, whose sums are exact, equal): uneven pair runs (3, 0, 1 and 5
    pairs, so output block 1 has no pair and must be zero), a block size
    that is not a multiple of the 128-wide tile (and whose bf16 rows are
    not 16 bytes), f32 and bf16 stores, stores laid out padded once
    (``padded_store``, as the block split makes them) or plain (padded
    by the wrapper), and an empty window."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels.block_spmm import padded_store

    rng = np.random.RandomState(43)

    def store(seed, n):
        vals = (np.random.RandomState(seed).randint(-3, 4, (n, Bb, Bb))
                .astype(np.float32) if integer else _x(seed, n, Bb, Bb))
        t = torch.from_numpy(vals).cuda().to(dtype)
        return padded_store(n, Bb, dtype, "cuda").copy_(t) if padded else t

    blocksA, blocksB = store(44, 6), store(45, 5)
    i32 = dict(dtype=torch.int32, device="cuda")
    a_idx = torch.from_numpy(rng.randint(0, 6, 9)).cuda().int()
    b_idx = torch.from_numpy(rng.randint(0, 5, 9)).cuda().int()
    seg_ptr = torch.tensor([0, 3, 3, 4, 9], **i32)
    args = (blocksA, blocksB, a_idx, b_idx, seg_ptr, 4)
    got = block_spgemm_window(*args)
    assert got.dtype == torch.float32 and got.shape == (4, Bb, Bb)
    assert rel_err(got, block_spgemm_window_plain(*args)) <= (
        0.0 if integer else 1e-5)
    assert bool((got[1] == 0).all())
    e = torch.zeros(0, **i32)
    assert block_spgemm_window(blocksA, blocksB, e, e,
                               torch.zeros(1, **i32), 0).shape == (0, Bb, Bb)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_raw_runs_plan_numeric_on_gpu(dtype):
    """``spspmm_stream(raw=True)`` computes its values with K9 on the card,
    one launch a chunk, and pulls host triples equal to the CPU's."""
    _need_gpu()
    res = []
    for dev in ("cpu", "cuda"):
        A, B = _spgemm_pair(dev)
        A = A.set_value(A.storage.value().to(dtype), layout="coo")
        B = B.set_value(B.storage.value().to(dtype), layout="coo")
        plan_numeric.launches = 0
        res.append(list(pts.spspmm_stream(A, B, max_terms=40_000, raw=True)))
        if dev == "cuda":
            assert plan_numeric.launches == len(res[-1]) > 1
    for (lo, hi, (rp, col, v)), (lo_c, hi_c, (rp_c, col_c, v_c)) in zip(*res):
        assert (lo, hi) == (lo_c, hi_c)
        np.testing.assert_array_equal(rp, rp_c)
        np.testing.assert_array_equal(col, col_c)
        assert isinstance(v, np.ndarray) and v.dtype == np.float32
        assert rel_err(torch.from_numpy(v), torch.from_numpy(v_c)) <= (
            1e-5 if dtype == torch.float32 else 1e-2)


def _slots(rng, R, C, nb):
    keys = np.sort(rng.choice(R * C, nb, replace=False))
    return [torch.from_numpy(a.astype(np.int32)).cuda()
            for a in (keys // C, keys % C)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,K", [(128, 40), (128, 256), (100, 70), (512, 40),
                                 (512, 47)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_dblocks_matches_plain_on_gpu(B, K, dtype):
    """K5b against its plain version (1e-5 of max |ref| before the final
    cast; a bf16 store within one bf16 step): both forms, which differ
    only in their operands, ragged B and K, and the zero trailing slot."""
    _need_gpu()
    rng = np.random.RandomState(46)
    R, C, nb = 6, 5, 17
    slot_row, slot_col = _slots(rng, R, C, nb)
    # The forward's (grad_out, x) and the transpose's (g, grad_out): row
    # blocks of one operand against column blocks of the other.
    for seeds in ((47, 48), (57, 58)):
        args = (torch.from_numpy(_x(seeds[0], R * B, K)).cuda(),
                torch.from_numpy(_x(seeds[1], C * B, K)).cuda())
        got = block_spmm_dblocks(*args, slot_row, slot_col, B, dtype)
        ref = block_spmm_dblocks_plain(*args, slot_row, slot_col, B,
                                       torch.float32)
        assert got.dtype == dtype and got.shape == (nb + 1, B, B)
        assert bool((got[nb] == 0).all())
        if dtype == torch.float32:
            assert rel_err(got, ref) <= 1e-5
        else:
            step = ref.abs() * 2.0 ** -7 + 1e-5 * float(ref.abs().max())
            assert bool(((got.float() - ref).abs() <= step).all())


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("store", [None, torch.bfloat16])
def test_hybrid_spmm_grads_match_cpu(store, aligned):
    """C.1: on the card ``hybrid_spmm`` and ``hybrid_spmm_t`` return
    tensors with a ``grad_fn``, and their gradients for the operand and
    the block store equal the CPU's, on an unaligned and a block-aligned
    hybrid of a community graph."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.testing import community_graph

    M, n_comm = 6_000, 8
    partptr = np.linspace(0, M, n_comm + 1).astype(np.int64)
    res = []
    for dev in ("cpu", "cuda"):
        A = community_graph(M, 200_000, n_comm=n_comm, seed=1,
                            equal_sizes=True, device=dev)
        h = phyb.build_hybrid_from_tensor(
            A, B=256, min_density=0.02, block_dtype=store,
            partptr=partptr if aligned else None)
        h.blocks.requires_grad_(True)
        grads = []
        for fn in (phyb.hybrid_spmm, phyb.hybrid_spmm_t):
            x = torch.from_numpy(_x(49, M, 64)).to(dev).requires_grad_(True)
            gout = torch.from_numpy(_x(50, M, 64)).to(dev)
            block_spmm_dblocks.launches = 0
            out = fn(h, x)
            assert out.grad_fn is not None
            gb, gx = torch.autograd.grad(out, (h.blocks, x), gout)
            if dev == "cuda":
                assert block_spmm_dblocks.launches == 1
            grads += [out.detach().cpu(), gx.cpu(), gb.float().cpu()]
        res.append(grads)
    for i, (got, ref) in enumerate(zip(res[1], res[0])):
        if store is not None and i % 3 == 2:  # bf16 store gradient
            step = ref.abs() * 2.0 ** -7 + 1e-5 * float(ref.abs().max())
            assert bool(((got - ref).abs() <= step).all())
        else:
            assert rel_err(got, ref) <= 1e-5


@pytest.mark.gpu
def test_gat_train_step_matches_cpu():
    """One GAT Adam step (lr 5e-3) on the card against the CPU: the loss,
    every gradient and the stepped weights; the step launches the
    edge-softmax kernels twice each, csr_spmm once per head and output
    layer in each direction and edge_dot as often."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.models import GAT

    rng = np.random.RandomState(51)
    row, col = rng.randint(0, 2500, 20_000), rng.randint(0, 2500, 20_000)
    x = _x(52, 2500, 32)
    labels = torch.from_numpy(rng.randint(0, 7, 2500))
    res = []
    for dev in ("cpu", "cuda"):
        A = pts.SparseTensor(row=row, col=col, sparse_sizes=(2500, 2500),
                             device=dev).set_diag()
        model = GAT(32, 8, 7, heads=8,
                    generator=torch.Generator().manual_seed(1), device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=5e-3)
        for f in (edge_softmax, edge_softmax_bwd, csr_spmm, edge_dot):
            f.launches = 0
        loss = model.loss(A, torch.from_numpy(x).to(dev), labels.to(dev))
        loss.backward()
        grads = [p.grad.cpu() for p in model.parameters()]
        opt.step()
        if dev == "cuda":
            assert (edge_softmax.launches, edge_softmax_bwd.launches,
                    csr_spmm.launches, edge_dot.launches) == (2, 2, 18, 9)
        res.append([loss.detach().cpu()] + grads
                   + [p.detach().cpu() for p in model.parameters()])
    for got, ref in zip(res[1], res[0]):
        assert rel_err(got, ref) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gcn_hybrid", "sage", "gin"])
def test_model_train_step_matches_cpu(kind):
    """One Adam step of GCN on a block-aligned prebuilt hybrid (its
    blocks requiring grad), GraphSAGE and GIN on the card against the
    CPU: the loss and every gradient, to 1e-4 of each gradient's largest
    entry.  The bias and ``eps`` gradients are means over the nodes of
    terms that cancel to a tenth of their size (softmax minus one-hot at
    a random init), which amplifies the two devices' summation orders
    past 1e-5 (1.2e-5 seen for GCN's output bias)."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.models import GCN, GIN, GraphSAGE, gcn_norm
    from pytorch_sparse_tpu_torch.testing import community_graph

    M = 4_000
    x = _x(53, M, 32)
    labels = torch.from_numpy(np.random.RandomState(54).randint(0, 5, M))
    res = []
    for dev in ("cpu", "cuda"):
        A = community_graph(M, 120_000, n_comm=8, seed=2, equal_sizes=True,
                            device=dev)
        gen = torch.Generator().manual_seed(5)
        extra = []
        if kind == "gcn_hybrid":
            adj = phyb.build_hybrid_from_tensor(
                gcn_norm(A), B=256, min_density=0.02,
                partptr=np.linspace(0, M, 9).astype(np.int64))
            adj.blocks.requires_grad_(True)
            extra = [adj.blocks]
            model = GCN(32, 48, 5, num_layers=3, generator=gen, device=dev)
        else:
            adj = A
            cls = GraphSAGE if kind == "sage" else GIN
            model = cls(32, 48, 5, num_layers=3, generator=gen, device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        loss = model.loss(adj, torch.from_numpy(x).to(dev), labels.to(dev))
        loss.backward()
        opt.step()
        res.append([loss.detach().cpu()] + [
            t.grad.cpu() for t in list(model.parameters()) + extra])
    for got, ref in zip(res[1], res[0]):
        assert rel_err(got, ref) <= 1e-4


def _walk_case(M, E, with_sinks, seed):
    """A CSR graph on the card, with rows of degree 0 when
    ``with_sinks`` (a fifth of the nodes have no out-edges)."""
    rng = np.random.RandomState(seed)
    hi = M - M // 5 if with_sinks else M
    A = pts.SparseTensor(row=rng.randint(0, hi, E), col=rng.randint(0, M, E),
                         sparse_sizes=(M, M))
    return A.csr()[:2]


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3, 20])
@pytest.mark.parametrize("with_sinks", [False, True])
def test_random_walk_matches_plain_on_gpu(L, with_sinks):
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels import (
        random_walk, random_walk_plain)

    rowptr, col = _walk_case(5000, 60_000, with_sinks, 30 + L)
    n = 20_000
    start = torch.from_numpy(
        np.random.RandomState(31).randint(0, 5000, n).astype(np.int32)).cuda()
    rand = torch.rand((n, L), generator=torch.Generator(
        device="cuda").manual_seed(L), device="cuda")
    got = random_walk(rowptr, col, start, rand)
    want = random_walk_plain(rowptr, col, start, rand)
    torch.cuda.synchronize()
    assert got.shape == (n, L + 1) and got.dtype == torch.int32
    assert torch.equal(got, want)
    if with_sinks:  # walks that reach a sink stay there
        sink = got[:, :-1] >= 4000
        assert torch.equal(got[:, 1:][sink], got[:, :-1][sink])


@pytest.mark.gpu
def test_random_walk_launches_and_checks_rand_on_gpu():
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels import random_walk

    rng = np.random.RandomState(32)
    A = pts.SparseTensor(row=rng.randint(0, 500, 4000),
                         col=rng.randint(0, 500, 4000), sparse_sizes=(500, 500))
    before = random_walk.launches
    walks = pts.random_walk(A, torch.arange(500), 7)
    torch.cuda.synchronize()
    assert random_walk.launches == before + 1
    assert walks.is_cuda and walks.shape == (500, 8)
    rp, c, _ = A.csr()
    start = torch.arange(500, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        random_walk(rp, c, start, torch.rand((500, 7), dtype=torch.float64,
                                             device="cuda"))
    with pytest.raises(ValueError, match="shape"):
        random_walk(rp, c, start, torch.rand((499, 7), device="cuda"))
    with pytest.raises(ValueError, match="shape"):
        pts.random_walk(A, torch.arange(500), 7,
                        rand=torch.rand((500, 6), device="cuda"))
    assert random_walk.launches == before + 1


@pytest.mark.gpu
def test_random_walk_rejects_out_of_range_inputs_on_gpu():
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels import random_walk

    rng = np.random.RandomState(33)
    A = pts.SparseTensor(row=rng.randint(0, 500, 4000),
                         col=rng.randint(0, 500, 4000), sparse_sizes=(500, 500))
    before = random_walk.launches
    for start in ([0, -1, 7], [499, 500], [10**7]):
        with pytest.raises(ValueError, match="start nodes"):
            pts.random_walk(A, torch.tensor(start, device="cuda"), 4)
    rand = torch.rand((3, 4), device="cuda")
    rand[1, 2] = 1.0
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        pts.random_walk(A, torch.arange(3), 4, rand=rand)
    assert random_walk.launches == before
    # The context is intact: a valid walk still launches and finishes.
    pts.random_walk(A, torch.arange(3), 4)
    torch.cuda.synchronize()
    assert random_walk.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("T,K", [(2048, 128), (8, 128), (100, 40), (5, 1)])
def test_smem_gather_matches_plain_on_gpu(T, K):
    """K13a against ``index_select``, exactly, and counted."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels import (
        smem_gather, smem_gather_plain)

    rng = np.random.RandomState(60 + T)
    table = torch.from_numpy(_x(61, T, K)).cuda()
    idx = torch.from_numpy(rng.randint(0, T, 3 * T).astype(np.int32)).cuda()
    before = smem_gather.launches
    got = smem_gather(idx, table)
    torch.cuda.synchronize()
    assert smem_gather.launches == before + 1
    assert torch.equal(got, smem_gather_plain(idx, table))
    with pytest.raises(TypeError, match="float32"):
        smem_gather(idx, table.double())


@pytest.mark.gpu
@pytest.mark.parametrize("T,K", [(2048, 128), (129, 33), (1, 5)])
@pytest.mark.parametrize("R", [1, 3, 8])
def test_edge_scan_loop_matches_plain_on_gpu(T, K, R):
    """K13b against the loop of ``torch.cumsum``: the scan adds in
    another order, within 1e-5 of max |ref|."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels import (
        edge_scan_loop, edge_scan_loop_plain)

    h = torch.from_numpy(_x(62 + R, T, K)).cuda()
    before = edge_scan_loop.launches
    got = edge_scan_loop(h, R)
    torch.cuda.synchronize()
    assert edge_scan_loop.launches == before + 1
    assert rel_err(got, edge_scan_loop_plain(h, R)) <= 1e-5
    with pytest.raises(ValueError, match="at least 1"):
        edge_scan_loop(h, 0)


def _tiled_case(kind, M, E, seed):
    """A CSR matrix on the card: ``uniform`` (column-sorted rows),
    ``community`` (most edges near the diagonal), or ``unsorted`` (the
    uniform rows' columns shuffled within each row)."""
    from pytorch_sparse_tpu_torch.testing import community_graph

    rng = np.random.RandomState(seed)
    if kind == "community":
        return community_graph(M, E, n_comm=6, seed=seed, equal_sizes=True,
                               device="cuda").csr()
    row = np.sort(rng.randint(0, M, E))
    col = rng.randint(0, M, E)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    if kind == "unsorted":
        for r in range(M):
            a, b = np.searchsorted(row, [r, r + 1])
            col[a:b] = rng.permutation(col[a:b])
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=M))])
    as_i32 = lambda a: torch.from_numpy(a.astype(np.int32)).cuda()  # noqa
    return (as_i32(rowptr), as_i32(col),
            torch.from_numpy(rng.randn(E).astype(np.float32)).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "community", "unsorted"])
@pytest.mark.parametrize("T,stage_min", [(64, 0), (512, None), (256, 10**9)])
@pytest.mark.parametrize("K", [128, 40])
def test_tiled_spmm_matches_plain_and_csr_on_gpu(kind, T, stage_min, K):
    """K13c against its plain version (within 1e-5 of max |ref|) and
    the CSR kernel K1 (bit for bit: both sum each output in CSR order
    with one fmaf chain), with values and implicit ones, every pair,
    some or no pair staged, and columns out of order within rows."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels import (
        tiled_spmm, tiled_spmm_plain, tiled_spmm_plan)

    M = 1500
    rowptr, col, val = _tiled_case(kind, M, 30_000, 63)
    x = torch.from_numpy(_x(64, M, K)).cuda()
    plan = tiled_spmm_plan(rowptr, col, M, T=T, stage_min=stage_min)
    if stage_min == 0:  # 24 tiles of 64 rows fit in shared memory
        assert plan.n_staged == plan.n_pairs > 0
    for v in (val, None):
        before = tiled_spmm.launches
        got = tiled_spmm(rowptr, col, v, x, plan)
        torch.cuda.synchronize()
        assert tiled_spmm.launches == before + 1
        assert torch.equal(got, csr_spmm(rowptr, col, v, x))
        assert rel_err(got, tiled_spmm_plain(rowptr, col, v, x, plan)) \
            <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(), (3,)])
def test_segment_sum_csr_on_gpu_equals_cpu_bits(shape):
    """The card's ordered segment sum equals the CPU's bit for bit, with
    empty segments, where ``index_add_`` on the card may not."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.segment import segment_sum_csr

    rng = np.random.RandomState(65)
    counts = rng.randint(0, 40, 2000)
    counts[::7] = 0
    rowptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    data = torch.from_numpy(
        (rng.randn(int(counts.sum()), *shape) * 1e3).astype(np.float32))
    before = csr_spmm.launches
    got = segment_sum_csr(data.cuda(), rowptr.cuda())
    torch.cuda.synchronize()
    assert csr_spmm.launches == before + 1
    assert torch.equal(got.cpu(), segment_sum_csr(data, rowptr))


@pytest.mark.gpu
def test_gcn_hybrid_train_step_is_deterministic_on_gpu():
    """The graph and step of ``test_model_train_step_matches_cpu
    [gcn_hybrid]`` (N(0, 1) edge values, whose degrees may nearly
    cancel), 20 times on the card from a fresh graph: the loss and every
    gradient are the same bits each time."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.models import GCN, gcn_norm
    from pytorch_sparse_tpu_torch.testing import community_graph

    M = 4_000
    x = torch.from_numpy(_x(53, M, 32)).cuda()
    labels = torch.from_numpy(
        np.random.RandomState(54).randint(0, 5, M)).cuda()
    runs = []
    for _ in range(20):
        A = community_graph(M, 120_000, n_comm=8, seed=2, equal_sizes=True,
                            device="cuda")
        adj = phyb.build_hybrid_from_tensor(
            gcn_norm(A), B=256, min_density=0.02,
            partptr=np.linspace(0, M, 9).astype(np.int64))
        adj.blocks.requires_grad_(True)
        model = GCN(32, 48, 5, num_layers=3,
                    generator=torch.Generator().manual_seed(5), device="cuda")
        loss = model.loss(adj, x, labels)
        loss.backward()
        runs.append([loss.detach().cpu()] + [
            t.grad.cpu() for t in list(model.parameters()) + [adj.blocks]])
    for run in runs[1:]:
        for got, ref in zip(run, runs[0]):
            assert torch.equal(got, ref)
