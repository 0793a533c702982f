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
from pytorch_sparse_tpu_torch.ops.kernels.csr_spmm import (
    kernel_walk_instance, walk_instance)
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
@pytest.mark.parametrize("K", [1, 3, 8, 20, 40, 47, 128, 256, 300])
def test_kernels_match_plain_versions_on_gpu(K):
    """K1 at every width class of the CSR walk (scalar and float4
    chunks, 1 to 32 lanes a row, column tiles past 256); the block and
    edge-dot kernels at the widths of the model layers."""
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
        assert csr_spmm.last_instance == walk_instance(K, True)
    if K not in (40, 128, 256, 300):
        return
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
@pytest.mark.parametrize("case", ["ragged", "one row", "wide table",
                                  "long table", "K % 4", "offset view",
                                  "out of range"])
def test_smem_gather_edges_on_gpu(case):
    """K13a's edges, exactly: a row count that is no multiple of 4, one
    row, a table of 250 column slabs (on gridDim.y), a table too long
    for float4 slabs (one column a block), a width that is no multiple
    of 4, a table 4 bytes off a 16-byte boundary (the scalar copies),
    and indices outside [0, T) (a NaN row, the other rows exact)."""
    _need_gpu()
    import importlib

    from pytorch_sparse_tpu_torch.ops.kernels import (
        smem_gather, smem_gather_plain)
    sg = importlib.import_module(
        "pytorch_sparse_tpu_torch.ops.kernels.smem_gather")

    T, K = {"ragged": (2047, 128), "one row": (1, 128),
            "wide table": (1000, 1000), "long table": (20_000, 8),
            "K % 4": (300, 33), "offset view": (2048, 128),
            "out of range": (2048, 128)}[case]
    rng = np.random.RandomState(66)
    if case == "offset view":
        buf = torch.from_numpy(_x(67, T * K + 1)).cuda()
        table = buf[1:].view(T, K)
        assert table.data_ptr() % 16 == 4
    else:
        table = torch.from_numpy(_x(67, T, K)).cuda()
    n = 2 * T + 3
    idx_np = rng.randint(0, T, n).astype(np.int32)
    if case == "out of range":
        idx_np[[0, 5, n - 1]] = [-1, T, 2**31 - 1]
    idx = torch.from_numpy(idx_np).cuda()
    shape = sg.gather_shape(T, K, n, table.data_ptr() % 16 == 0)
    if case == "wide table":
        assert shape.col_tiles == 250
    if case in ("long table", "K % 4", "offset view"):
        assert shape.vec == 1
    before = smem_gather.launches
    got = smem_gather(idx, table)
    torch.cuda.synchronize()
    assert smem_gather.launches == before + 1
    bad = torch.from_numpy((idx_np < 0) | (idx_np >= T)).cuda()
    assert bool(got[bad].isnan().all())
    ok = ~bad
    assert torch.equal(got[ok], smem_gather_plain(idx[ok], table))
    empty = smem_gather(idx[:0], table)
    assert empty.shape == (0, K) and smem_gather.launches == before + 1


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
    if stage_min == 0:
        # Each row block stages every pair it holds, up to the 14 of its
        # 24 tiles that fit in its 113 KB.
        rb = np.repeat(np.arange(M), np.diff(rowptr.cpu().numpy())) // 256
        pairs = np.unique(rb * 24 + col.cpu().numpy() // T)
        assert plan.n_staged == np.minimum(
            np.bincount(pairs // 24), 14).sum() > 0
    for v in (val, None):
        before = tiled_spmm.launches
        got = tiled_spmm(rowptr, col, v, x, plan)
        torch.cuda.synchronize()
        assert tiled_spmm.launches == before + 1
        assert torch.equal(got, csr_spmm(rowptr, col, v, x))
        assert rel_err(got, tiled_spmm_plain(rowptr, col, v, x, plan)) \
            <= 1e-5


def _straddle_case(M, seed):
    """A CSR matrix on the card whose first rows hold community edges
    (pairs that stage) and a few far ones (rows that straddle staged and
    unstaged tiles), whose last row block holds only scattered edges (a
    block that stages nothing), and whose every seventh row is empty."""
    rng = np.random.RandomState(seed)
    rows, cols = [], []
    for r in range(M):
        if r % 7 == 3:
            continue
        if r < 1024:
            base = (r // 256) * 256
            c = np.concatenate([base + rng.randint(0, 256, 40),
                                rng.randint(0, M, 3)])
        else:
            c = rng.randint(0, M, 5)
        rows.append(np.full(c.size, r))
        cols.append(np.sort(c))
    row, col = np.concatenate(rows), np.concatenate(cols)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=M))])
    as_i32 = lambda a: torch.from_numpy(a.astype(np.int32)).cuda()  # noqa
    return (as_i32(rowptr), as_i32(col),
            torch.from_numpy(rng.randn(col.size).astype(np.float32)).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("T", [64, 256])
@pytest.mark.parametrize("K", [1, 8, 40, 128, 256])
def test_tiled_spmm_edges_equal_csr_on_gpu(K, T):
    """K13c bit for bit against K1 at every width class, with tiles of
    64 and of 256 rows, values and ones: empty rows, rows whose edges
    straddle staged and unstaged tiles, a block that stages nothing; at
    K=128 also an operand 4 bytes off a 16-byte boundary (the scalar
    instance).  Each launch is counted and keeps the instance it ran."""
    _need_gpu()
    import importlib

    from pytorch_sparse_tpu_torch.ops.kernels import (
        tiled_spmm, tiled_spmm_plan)
    sg = importlib.import_module(
        "pytorch_sparse_tpu_torch.ops.kernels.smem_gather")

    M = 1500
    rowptr, col, val = _straddle_case(M, 68)
    plan = tiled_spmm_plan(rowptr, col, M, T=T, stage_min=100 * T // 64)
    per_block = plan.stage_ptr.diff().tolist()
    assert per_block[-1] == 0 and max(per_block) > 0
    assert 0 < plan.staged_edges < col.shape[0]
    xs = [torch.from_numpy(_x(69, M, K)).cuda()]
    if K == 128:
        buf = torch.from_numpy(_x(70, M * K + 1)).cuda()
        xs.append(buf[1:].view(M, K))
    for x in xs:
        aligned = x.data_ptr() % 16 == 0
        for v in (val, None):
            before = tiled_spmm.launches
            got = tiled_spmm(rowptr, col, v, x, plan)
            torch.cuda.synchronize()
            assert tiled_spmm.launches == before + 1
            assert tiled_spmm.last_instance == sg.tiled_instance(K, aligned)
            assert torch.equal(got, csr_spmm(rowptr, col, v, x.contiguous()))
            assert not got[3::7].any()


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


def _degree_csr(degrees, N, seed):
    """A CSR matrix on the card whose rows have the given degrees."""
    rng = np.random.RandomState(seed)
    degrees = np.asarray(degrees)
    rowptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    E = int(rowptr[-1])
    col = rng.randint(0, N, E).astype(np.int32)
    val = rng.randn(E).astype(np.float32)
    return (torch.from_numpy(rowptr).cuda(), torch.from_numpy(col).cuda(),
            torch.from_numpy(val).cuda())


# Degrees around the walk's 8 edges in flight and its 32-edge index loads,
# a long row, and empty rows between them.
WALK_DEGREES = [0, 1, 7, 8, 9, 0, 31, 32, 33, 2000, 0, 15, 17, 63, 65, 1]


@pytest.mark.gpu
def test_walk_instance_matches_the_kernels_choice_on_gpu():
    """The Python choice of instance and the C code's agree at every
    width the walk runs in one tile or two, aligned or not."""
    _need_gpu()
    for K in range(1, 301):
        for aligned in (True, False):
            assert kernel_walk_instance(K, aligned) == \
                walk_instance(K, aligned), (K, aligned)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 3, 8, 20, 40, 47, 128, 256, 300])
def test_csr_spmm_row_degrees_on_gpu(K):
    """Rows of degree 0, 1, one below and above the edges in flight, and
    2,000: with implicit ones each output is the CPU's sequential sum
    bit for bit (fmaf(1, x, acc) is acc + x), with values within 1e-5."""
    _need_gpu()
    N = 700
    rowptr, col, val = _degree_csr(WALK_DEGREES * 20, N, 66)
    x = torch.from_numpy(_x(67, N, K)).cuda()
    got = csr_spmm(rowptr, col, None, x)
    assert torch.equal(got.cpu(), csr_spmm_plain(
        rowptr.cpu(), col.cpu(), None, x.cpu()))
    assert rel_err(csr_spmm(rowptr, col, val, x),
                   csr_spmm_plain(rowptr, col, val, x)) <= 1e-5
    assert not got[rowptr[1:] == rowptr[:-1]].any()


@pytest.mark.gpu
@pytest.mark.parametrize("K", [8, 20, 128, 256, 300])
def test_csr_spmm_misaligned_operand_runs_the_scalar_instance_on_gpu(K):
    """An operand whose base is 4 bytes off a 16-byte boundary runs the
    scalar instance of the walk, with the same sums bit for bit as the
    float4 instance on an aligned copy."""
    _need_gpu()
    N = 900
    rowptr, col, val = _degree_csr(WALK_DEGREES * 30, N, 68)
    flat = torch.from_numpy(_x(69, N * K + 1)).cuda()
    x_off = flat[1:].view(N, K)
    assert x_off.data_ptr() % 16 == 4
    x = x_off.clone()
    for v in (val, None):
        aligned = csr_spmm(rowptr, col, v, x)
        assert csr_spmm.last_instance.vec == 4
        got = csr_spmm(rowptr, col, v, x_off)
        assert csr_spmm.last_instance == walk_instance(K, False)
        assert csr_spmm.last_instance.vec == 1
        assert torch.equal(got, aligned)
        assert rel_err(got, csr_spmm_plain(rowptr, col, v, x_off)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 8, 40, 128, 256])
def test_csr_spmm_two_launches_give_identical_bits_on_gpu(K):
    _need_gpu()
    N = 2000
    rowptr, col, val = _degree_csr(
        np.random.RandomState(70).randint(0, 60, 3000), N, 71)
    x = torch.from_numpy(_x(72, N, K)).cuda()
    for v in (val, None):
        assert torch.equal(csr_spmm(rowptr, col, v, x),
                           csr_spmm(rowptr, col, v, x))


def _column_degree_matrix(degrees, M, seed):
    """A CUDA SparseTensor (M, len(degrees)) whose columns have the given
    degrees (no duplicate entry), with N(0, 1) values."""
    rng = np.random.RandomState(seed)
    rows, cols = [], []
    for c, d in enumerate(degrees):
        rows.append(rng.choice(M, d, replace=False))
        cols.append(np.full(d, c))
    row, col = np.concatenate(rows), np.concatenate(cols)
    val = rng.randn(row.size).astype(np.float32)
    return pts.SparseTensor(row=row, col=col, value=val,
                            sparse_sizes=(M, len(degrees)), device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 4, 8, 20, 40, 128, 256, 300])
def test_minmax_spmm_t_walk_on_gpu(K):
    """K7b at every instance the walk's choice takes: columns of degree
    0, 1, around the 8 edges in flight and the 32-edge index loads, and
    2,000; values and implicit ones; a max argout over an operand with
    -inf entries and empty rows (arg = E); g NaN or inf where no edge
    won (the empty rows) and values inf or NaN on edges that won nothing,
    which must add exactly nothing.  Against the plain version to 1e-5
    of max |ref|; with g and arg 4 bytes off a 16-byte boundary (the
    scalar instance) the same bits."""
    _need_gpu()
    M = 20_000
    A = _column_degree_matrix(WALK_DEGREES * 6, M, 73)
    rowptr, col, val = A.csr()
    st = A.storage
    N, E = A.sparse_sizes()[1], A.nnz()
    x = _x(74, N, K)
    x[::5, ::2] = -np.inf
    x = torch.from_numpy(x).cuda()
    _, arg = csr_spmm_minmax(rowptr, col, val, x, False)
    empty = arg == E
    assert bool(empty.any()) and not bool(empty.all())
    g = torch.from_numpy(_x(75, M, K)).cuda()
    g[empty] = torch.where(torch.arange(int(empty.sum()), device="cuda")
                           % 2 == 0, float("nan"), float("inf"))
    won = torch.zeros(E + 1, dtype=torch.bool, device="cuda")
    won[arg.long().flatten()] = True
    lost = ~won[:E]
    assert bool(lost.any()) or K > 8
    v = val.clone()
    v[lost] = torch.where(torch.arange(int(lost.sum()), device="cuda") % 2
                          == 0, float("inf"), float("nan"))
    flat_g = torch.zeros(M * K + 1, device="cuda")
    flat_a = torch.zeros(M * K + 1, dtype=torch.int32, device="cuda")
    g_off, arg_off = flat_g[1:].view(M, K), flat_a[1:].view(M, K)
    g_off.copy_(g)
    arg_off.copy_(arg)
    for vv in (v, None):
        t_args = (st.colptr(), st.csc_row(), st.csr2csc(), vv, g, arg)
        got = minmax_spmm_t(*t_args)
        assert minmax_spmm_t.last_instance == walk_instance(K, True)
        ref = minmax_spmm_t_plain(*t_args)
        assert bool(torch.isfinite(got).all())
        _same(got, ref, 1e-5)
        off = minmax_spmm_t(*t_args[:4], g_off, arg_off)
        assert minmax_spmm_t.last_instance == walk_instance(K, False)
        assert torch.equal(off, got)
    assert not bool(got[st.colptr()[1:] == st.colptr()[:-1]].any())


# ----------------------------------------------------------------------
# The per-edge walk (edge_walk.cuh): K4 edge_dot and K7a minmax_edge_dot
# ----------------------------------------------------------------------

EDGE_WIDTHS = [1, 8, 40, 47, 128, 256, 300]


def _edge_walk_inputs(K, seed, case="random"):
    """A CUDA CSR with rows of degree 0 to 2,000 (WALK_DEGREES), x and g,
    and the max argout of x (``csr_spmm_minmax``): ``random`` N(0, 1),
    ``ties`` small integers, ``inf`` a fifth of x -inf and some +inf,
    ``nan`` 2% NaN."""
    N, M = 900, len(WALK_DEGREES) * 12
    rowptr, col, val = _degree_csr(WALK_DEGREES * 12, N, seed)
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(N, K).astype(np.float32)
    if case == "ties":
        x = rng.randint(-2, 3, (N, K)).astype(np.float32)
    elif case == "inf":
        x[rng.rand(N, K) < 0.2] = -np.inf
        x[rng.rand(N, K) < 0.02] = np.inf
    elif case == "nan":
        x[rng.rand(N, K) < 0.02] = np.nan
    x = torch.from_numpy(x).cuda()
    g = torch.from_numpy(_x(seed + 2, M, K)).cuda()
    _, arg = csr_spmm_minmax(rowptr, col, val, x, False)
    return rowptr, col, x, g, arg


def _bits_equal(a, b):
    """Equal bit for bit (NaN included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _off(t):
    """A copy of ``t`` 4 bytes off a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    off = flat[1:].view(t.shape)
    off.copy_(t)
    assert off.data_ptr() % 16 == 4
    return off


@pytest.mark.gpu
@pytest.mark.parametrize("K", EDGE_WIDTHS)
def test_edge_dot_walk_matches_plain_on_gpu(K):
    """K4 on rows of degree 0 to 2,000 at every instance class: within
    1e-5 of the plain version, bit-equal across launches, the instance
    the Python mirror chooses; x or g off 16 bytes runs the scalar
    instance, within 1e-5 too."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels.edge_dot import edge_instance

    rowptr, col, x, g, _ = _edge_walk_inputs(K, 80)
    ref = edge_dot_plain(rowptr, col, x, g)
    before = edge_dot.launches
    got = edge_dot(rowptr, col, x, g)
    assert edge_dot.launches == before + 1
    assert edge_dot.last_instance == edge_instance(K, True)
    _same(got, ref, 1e-5)
    assert _bits_equal(edge_dot(rowptr, col, x, g), got)
    for xo, go in ((_off(x), g), (x, _off(g))):
        off = edge_dot(rowptr, col, xo, go)
        assert edge_dot.last_instance == edge_instance(K, False)
        _same(off, ref, 1e-5)
        assert _bits_equal(edge_dot(rowptr, col, xo, go), off)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "ties", "inf", "nan", "empty"])
@pytest.mark.parametrize("K", EDGE_WIDTHS)
def test_minmax_edge_dot_walk_matches_plain_on_gpu(case, K):
    """K7a on the max argout, rows of degree 0 to 2,000, at every
    instance class and in the random, ties, inf and nan cases (``empty``:
    the argout of rows that lost all their edges, E, and g NaN there):
    within 1e-5 of the plain version (NaN where it has NaN), bit-equal
    across launches, the Python mirror's instance; arg off 16 bytes runs
    the scalar instance."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels.edge_dot import edge_instance

    rowptr, col, x, g, arg = _edge_walk_inputs(
        K, 81, "random" if case == "empty" else case)
    E = col.shape[0]
    if case == "empty":
        lost = torch.arange(arg.shape[0], device="cuda") % 3 == 0
        arg[lost] = E
        g[lost] = float("nan")
    ref = minmax_edge_dot_plain(rowptr, col, x, g, arg)
    before = minmax_edge_dot.launches
    got = minmax_edge_dot(rowptr, col, x, g, arg)
    assert minmax_edge_dot.launches == before + 1
    assert minmax_edge_dot.last_instance == edge_instance(K, True)
    _same(got, ref, 1e-5)
    assert _bits_equal(minmax_edge_dot(rowptr, col, x, g, arg), got)
    if case == "empty":
        assert bool(torch.isfinite(got).all())
    off = minmax_edge_dot(rowptr, col, x, g, _off(arg))
    assert minmax_edge_dot.last_instance == edge_instance(K, False)
    _same(off, ref, 1e-5)


@pytest.mark.gpu
def test_edge_instance_matches_the_kernels_choice_on_gpu():
    """The Python choice of the edge walk's instance and the C code's
    (``edge_walk_instance``, exported by both libraries) agree at every
    width of one or two passes, aligned or not."""
    _need_gpu()
    from pytorch_sparse_tpu_torch import _build
    from pytorch_sparse_tpu_torch.ops.kernels.edge_dot import (
        edge_instance, kernel_edge_instance)

    import ctypes

    mm = _build.load("spmm_minmax")
    mm.edge_walk_instance.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)]
    for K in range(1, 513):
        for aligned in (True, False):
            want = edge_instance(K, aligned)
            assert kernel_edge_instance(K, aligned) == want, (K, aligned)
            arr = (ctypes.c_int * 5)()
            mm.edge_walk_instance(K, int(aligned), arr)
            assert tuple(arr) == (want.vec, want.lanes, want.chunks,
                                  want.passes, want.edges_in_flight)


@pytest.mark.gpu
def test_edge_walks_at_zero_width_launch_nothing_on_gpu():
    _need_gpu()
    rowptr, col, _ = _degree_csr([0, 3, 5], 10, 82)
    x = torch.zeros((10, 0), device="cuda")
    g = torch.zeros((3, 0), device="cuda")
    arg = torch.zeros((3, 0), dtype=torch.int32, device="cuda")
    before = (edge_dot.launches, minmax_edge_dot.launches)
    assert torch.equal(edge_dot(rowptr, col, x, g),
                       torch.zeros(8, device="cuda"))
    assert torch.equal(minmax_edge_dot(rowptr, col, x, g, arg),
                       torch.zeros(8, device="cuda"))
    assert (edge_dot.launches, minmax_edge_dot.launches) == before


# ----------------------------------------------------------------------
# Sums over repeated indices in a fixed order (coalesce, to_dense)
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reduce", ["add", "mean"])
def test_coalesce_of_a_grad_value_is_deterministic_on_gpu(reduce, dtype):
    """Duplicates (about 100 a position) of a CUDA value that requires
    grad sum in edge order: two runs give the same bits, the CPU's bits,
    and the value's gradient."""
    _need_gpu()
    rng = np.random.RandomState(83)
    pos = np.sort(rng.randint(0, 4000, 400_000))
    row, col = pos // 64, pos % 64
    val = rng.randn(pos.size)

    def run(dev):
        v = torch.from_numpy(val).to(dev, dtype).requires_grad_(True)
        A = pts.SparseTensor(row=row, col=col, sparse_sizes=(64, 64),
                             is_sorted=True, trust_data=True, device=dev)
        out = A.set_value(v, layout="coo").coalesce(reduce).storage.value()
        (grad,) = torch.autograd.grad(out, v, torch.ones_like(out))
        return out.detach().cpu(), grad.cpu()

    a, b, cpu = run("cuda"), run("cuda"), run("cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0], cpu[0]) and torch.equal(a[1], cpu[1])


@pytest.mark.gpu
def test_to_dense_of_duplicates_is_deterministic_on_gpu():
    _need_gpu()
    rng = np.random.RandomState(84)
    row, col = rng.randint(0, 50, 300_000), rng.randint(0, 40, 300_000)
    val = rng.randn(row.size).astype(np.float32)

    def run(dev):
        return pts.SparseTensor(row=row, col=col, value=val,
                                sparse_sizes=(50, 40),
                                device=dev).to_dense().cpu()

    a, b = run("cuda"), run("cuda")
    assert torch.equal(a, b) and torch.equal(a, run("cpu"))


# ----------------------------------------------------------------------
# K6 csr_spmm_minmax on the min/max walk (minmax_walk.cuh)
# ----------------------------------------------------------------------

HALF_TYPES = [torch.float32, torch.float16, torch.bfloat16]


def _bits(t):
    """``t``'s bits as integers of its element size (NaN included)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _off_elements(t, k):
    """A copy of ``t`` ``k`` elements off its allocation's start."""
    flat = torch.zeros(t.numel() + k, dtype=t.dtype, device=t.device)
    off = flat[k:].view(t.shape)
    off.copy_(t)
    return off


def _tie_operand(N, K, seed, dtype):
    """Small integers (ties), with -inf and +inf rows and NaN entries,
    exact in every half type."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-3, 4, (N, K)).astype(np.float32)
    x[::7] = -np.inf
    x[3::7] = np.inf
    x[5::11, ::3] = np.nan
    return torch.from_numpy(x).cuda().to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF_TYPES)
@pytest.mark.parametrize("K", [1, 4, 8, 20, 40, 47, 128, 256, 300])
def test_csr_spmm_minmax_walk_on_gpu(K, dtype):
    """K6 on rows of degree 0 to 2,000 (empty rows give (0, E)), with
    small-integer values and operand (ties), +-inf rows and NaN entries:
    out and arg exactly the plain version's, bit-equal across two
    launches, the instance the Python mirror and the C code choose; x 4
    bytes off its chunk boundary runs the scalar instance with the same
    bits."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels.csr_spmm import (
        launch_instance)
    from pytorch_sparse_tpu_torch.ops.kernels.spmm_minmax import (
        kernel_minmax_instance)

    N = 700
    rowptr, col, _ = _degree_csr(WALK_DEGREES * 6, N, 90)
    E = col.shape[0]
    val = torch.from_numpy(np.random.RandomState(91).randint(
        -2, 3, E).astype(np.float32)).cuda()
    x = _tie_operand(N, K, 92, dtype)
    x_off = _off_elements(x, 4 // x.element_size())  # 4 bytes off
    empty = (rowptr[1:] == rowptr[:-1]).nonzero().flatten()
    for vv in (val, None):
        for is_min in (True, False):
            ref, ref_arg = csr_spmm_minmax_plain(rowptr, col, vv, x, is_min)
            before = csr_spmm_minmax.launches
            out, arg = csr_spmm_minmax(rowptr, col, vv, x, is_min)
            assert csr_spmm_minmax.launches == before + 1
            inst = csr_spmm_minmax.last_instance
            assert inst == launch_instance(K, x, out, arg) == \
                walk_instance(K, True)
            assert kernel_minmax_instance(K, x, out, arg) == inst
            assert out.dtype == dtype and torch.equal(arg, ref_arg)
            _same(out, ref)
            assert bool((arg[empty] == E).all())
            assert not bool(out[empty].any())
            out2, arg2 = csr_spmm_minmax(rowptr, col, vv, x, is_min)
            assert torch.equal(_bits(out2), _bits(out))
            assert torch.equal(arg2, arg)
            o_off, a_off = csr_spmm_minmax(rowptr, col, vv, x_off, is_min)
            assert csr_spmm_minmax.last_instance == walk_instance(K, False)
            assert kernel_minmax_instance(K, x_off, o_off, a_off) == \
                walk_instance(K, False)
            assert torch.equal(_bits(o_off), _bits(out))
            assert torch.equal(a_off, arg)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF_TYPES)
def test_minmax_instance_matches_the_kernels_choice_on_gpu(dtype):
    """K6's instance, as the C code chooses it from the pointers, equals
    ``launch_instance(K, x, out, arg)`` at every width of one or two
    tiles, with x, out or arg off their chunk boundaries."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels.csr_spmm import (
        launch_instance)
    from pytorch_sparse_tpu_torch.ops.kernels.spmm_minmax import (
        kernel_minmax_instance)

    base = torch.zeros(4096, dtype=dtype, device="cuda")
    ints = torch.zeros(4096, dtype=torch.int32, device="cuda")
    for K in range(1, 301):
        for dx, do, da in ((0, 0, 0), (1, 0, 0), (2, 0, 0), (0, 2, 0),
                           (0, 0, 1), (0, 0, 2)):
            x, o = base[dx:dx + K], base[8 + do:8 + do + K]
            a = ints[da:da + K]
            want = launch_instance(K, x, o, a)
            assert kernel_minmax_instance(K, x, o, a) == want, (K, dx, do,
                                                                da)


# ----------------------------------------------------------------------
# K8 edge_softmax: a sub-warp a row, one read of the slab
# ----------------------------------------------------------------------

SOFTMAX_HEADS = [1, 2, 3, 4, 8, 16, 32]


def _softmax_graphs():
    """Two CUDA rowptrs: rows of degree 0 to 2,000 (WALK_DEGREES: a
    mean of 143 edges, so the 2,000-edge row sweeps) and short rows of
    0 to 16 edges with one of 300 (a mean near 8, as GAT's graph)."""
    long_rows = _degree_csr(WALK_DEGREES * 8, 10, 93)[0]
    deg = np.random.RandomState(94).randint(0, 17, 600)
    deg[311] = 300
    return {"walk degrees": long_rows,
            "short rows": _degree_csr(deg, 10, 95)[0]}


def _softmax_logits(E, H, seed):
    """N(0, 4) logits with a tenth -inf, every head of every 13th edge
    -inf, 0.1% NaN and 0.05% +inf (its row-head is NaN throughout, as
    JAX's clamp keeps a NaN sum)."""
    rng = np.random.RandomState(seed)
    lg = rng.randn(E, H).astype(np.float32) * 4
    lg[rng.rand(E, H) < 0.1] = -np.inf
    lg[::13] = -np.inf
    lg[rng.rand(E, H) < 0.001] = np.nan
    lg[rng.rand(E, H) < 0.0005] = np.inf
    return torch.from_numpy(lg).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("H", SOFTMAX_HEADS)
@pytest.mark.parametrize("graph", ["walk degrees", "short rows"])
def test_edge_softmax_sweep_on_gpu(graph, H):
    """K8 on rows of 0 to 2,000 edges (rows past the register cap sweep),
    with -inf, all -inf row-heads (NaN), NaN and +inf logits: within 1e-5 of
    max |ref| of the plain version (NaN where it has NaN), bit-equal
    across two launches, the instance the Python mirror and the C code
    choose; logits 4 bytes off a 16-byte boundary run the edges
    instance, within the gate too."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels.edge_softmax import (
        kernel_sweep_instance, sweep_instance)

    rowptr = _softmax_graphs()[graph]
    M, E = rowptr.shape[0] - 1, int(rowptr[-1])
    logits = _softmax_logits(E, H, 96)
    ref = edge_softmax_plain(rowptr, logits)
    assert bool(torch.isnan(ref).any())
    before = edge_softmax.launches
    got = edge_softmax(rowptr, logits)
    assert edge_softmax.launches == before + 1
    want = sweep_instance(M, E, H, True)
    assert edge_softmax.last_instance == want
    assert kernel_sweep_instance(M, E, H, True) == want
    assert want.vec == (4 if 32 % H == 0 else 1)
    _same(got, ref, 1e-5)
    assert torch.equal(_bits(edge_softmax(rowptr, logits)), _bits(got))
    off = _off_elements(logits, 1)
    got_off = edge_softmax(rowptr, off)
    assert edge_softmax.last_instance == sweep_instance(M, E, H, False)
    assert edge_softmax.last_instance.vec == 1
    _same(got_off, ref, 1e-5)
    assert torch.equal(_bits(edge_softmax(rowptr, off)), _bits(got_off))


@pytest.mark.gpu
def test_sweep_instance_matches_the_kernels_choice_on_gpu():
    """The Python choice of K8's instance and the C code's agree over
    heads, mean degrees from 0 to 2,000 and both alignments."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels.edge_softmax import (
        kernel_sweep_instance, sweep_instance)

    for H in range(1, 41):
        for M, E in ((0, 0), (1, 0), (100, 0), (100, 37), (169_343,
                                                          1_335_586),
                     (232_965, 15_623_351), (10, 20_000), (7, 100)):
            for aligned in (True, False):
                assert kernel_sweep_instance(M, E, H, aligned) == \
                    sweep_instance(M, E, H, aligned), (H, M, E, aligned)


# ----------------------------------------------------------------------
# K12's staged walk and K13b's on-chip scan
# ----------------------------------------------------------------------

WALK_LENGTHS = [1, 3, 20, 33, 400]   # 400: past the staged rows, unstaged


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("L", WALK_LENGTHS)
def test_random_walk_staged_matches_plain_on_gpu(L, offset):
    """K12 on a graph with degree-0 sinks, for a number of walks that no
    block's share divides, with ``rand`` a contiguous slice ``offset``
    words past a 16-byte boundary: every walk equal to the plain
    version's, and bit-equal across two launches."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels import (
        random_walk, random_walk_plain)

    rowptr, col = _walk_case(3000, 30_000, True, 40 + L)
    n = 5003
    start = torch.from_numpy(np.random.RandomState(41).randint(
        0, 3000, n).astype(np.int32)).cuda()
    flat = torch.rand(n * L + offset, generator=torch.Generator(
        device="cuda").manual_seed(L + 7 * offset), device="cuda")
    rand = flat[offset:].view(n, L)
    assert rand.is_contiguous() and rand.data_ptr() % 16 == 4 * offset
    before = random_walk.launches
    got = random_walk(rowptr, col, start, rand)
    again = random_walk(rowptr, col, start, rand)
    want = random_walk_plain(rowptr, col, start, rand)
    torch.cuda.synchronize()
    assert random_walk.launches == before + 2
    assert got.shape == (n, L + 1) and got.dtype == torch.int32
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    sink = got[:, :-1] >= 2400  # a fifth of the nodes have no out-edges
    assert bool(sink.any())
    assert torch.equal(got[:, 1:][sink], got[:, :-1][sink])


@pytest.mark.gpu
@pytest.mark.parametrize("L", [3, 20, 400])
def test_random_walk_with_rowptr_off_8_bytes_on_gpu(L):
    """K12 with ``rowptr`` 4 bytes past an 8-byte boundary, where the
    kernel loads each of a step's two rowptr entries alone: the walks
    equal the plain version's and those from an aligned ``rowptr``."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels import (
        random_walk, random_walk_plain)

    rowptr, col = _walk_case(3000, 30_000, True, 50 + L)
    buf = torch.empty(rowptr.shape[0] + 1, dtype=rowptr.dtype,
                      device="cuda")
    buf[1:] = rowptr
    shifted = buf[1:]
    assert shifted.data_ptr() % 8 == 4
    n = 4099
    start = torch.from_numpy(np.random.RandomState(51).randint(
        0, 3000, n).astype(np.int32)).cuda()
    rand = torch.rand((n, L), generator=torch.Generator(
        device="cuda").manual_seed(L), device="cuda")
    got = random_walk(shifted, col, start, rand)
    torch.cuda.synchronize()
    assert torch.equal(got, random_walk_plain(rowptr, col, start, rand))
    assert torch.equal(got, random_walk(rowptr, col, start, rand))


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 8, 40])
@pytest.mark.parametrize("K", [1, 3, 128, 130])
@pytest.mark.parametrize("T", [1, 8, 255, 2048, 2049])
def test_edge_scan_loop_on_chip_matches_plain_on_gpu(T, K, R):
    """K13b in the wrapper's instance against the loop of
    ``torch.cumsum``, within 1e-5 of max |ref|, and bit-equal across two
    launches."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels import (
        edge_scan_loop, edge_scan_loop_plain)
    from pytorch_sparse_tpu_torch.ops.kernels.smem_gather import (
        scan_instance)

    h = torch.from_numpy(_x(70 + R, T, K)).cuda()
    before = edge_scan_loop.launches
    got = edge_scan_loop(h, R)
    again = edge_scan_loop(h, R)
    torch.cuda.synchronize()
    assert edge_scan_loop.launches == before + 2
    assert edge_scan_loop.last_instance == scan_instance(T, K, True)
    assert rel_err(got, edge_scan_loop_plain(h, R)) <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("vec", [1, 4])
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("T", [1, 2048, 4096, 4097])
def test_edge_scan_loop_every_instance_on_gpu(T, streaming, vec):
    """Every instance the launcher takes against the plain version at K
    = 128; the on-chip scan past 4,096 rows, or with slabs of 2 columns,
    raises."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels import edge_scan_loop_plain
    from pytorch_sparse_tpu_torch.ops.kernels.smem_gather import (
        ScanInstance, launch_scan_instance)

    K, R = 128, 8
    h = torch.from_numpy(_x(80, T, K)).cuda()
    if not streaming:
        with pytest.raises(RuntimeError, match="edge_scan_loop launch"):
            launch_scan_instance(h, R, ScanInstance(False, 2))
    if not streaming and T > 4096:
        with pytest.raises(RuntimeError, match="edge_scan_loop launch"):
            launch_scan_instance(h, R, ScanInstance(streaming, vec))
        return
    got = launch_scan_instance(h, R, ScanInstance(streaming, vec))
    torch.cuda.synchronize()
    assert rel_err(got, edge_scan_loop_plain(h, R)) <= 1e-5


@pytest.mark.gpu
def test_edge_scan_loop_unaligned_long_and_refused_inputs_on_gpu():
    """``h`` 4 bytes past a 16-byte boundary takes the scalar slabs; T
    past the on-chip rows takes the streaming kernel; what the wrapper
    refuses raises before a launch."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.ops.kernels import (
        edge_scan_loop, edge_scan_loop_plain)

    T, K = 300, 128
    flat = torch.from_numpy(_x(81, T * K + 1).ravel()).cuda()
    h = flat[1:].view(T, K)
    got = edge_scan_loop(h, 8)
    assert edge_scan_loop.last_instance.vec == 1
    assert rel_err(got, edge_scan_loop_plain(h, 8)) <= 1e-5
    h = torch.from_numpy(_x(82, 40_000, 3)).cuda()
    got = edge_scan_loop(h, 2)
    assert edge_scan_loop.last_instance.streaming
    assert rel_err(got, edge_scan_loop_plain(h, 2)) <= 1e-5
    h = torch.from_numpy(_x(84, 9000, 8)).cuda()
    got = edge_scan_loop(h, 8)
    assert edge_scan_loop.last_instance.streaming
    assert rel_err(got, edge_scan_loop_plain(h, 8)) <= 1e-5
    before = edge_scan_loop.launches
    h = torch.from_numpy(_x(83, 64, 8)).cuda()
    with pytest.raises(ValueError, match="contiguous"):
        edge_scan_loop(h.t(), 2)
    with pytest.raises(TypeError, match="float32"):
        edge_scan_loop(h.double(), 2)
    with pytest.raises(ValueError, match="at least 1"):
        edge_scan_loop(h, 0)
    with pytest.raises(ValueError, match=r"\(T, K\)"):
        edge_scan_loop(h.reshape(-1), 2)
    assert edge_scan_loop.launches == before
