"""The port's block-aligned hybrid format and its differentiable
``hybrid_spmm``/``hybrid_spmm_t`` against the JAX package on the same
numpy inputs (CPU, where each kernel runs its plain version).

JAX's block passes run at ``Precision.HIGHEST`` here (set in-process
with ``monkeypatch``): its default ``HIGH`` emulates f32 products with
bf16 terms and is about 1e-5 off exact fp32, where the port's products
are exact.  Tolerances (max |diff| / max |ref|): 1e-6 for f32 stores
(summation order), 1e-4 for bf16 stores (JAX splits the f32 operand or
cotangent into bf16 terms, the port multiplies it exactly).  The
gradient of a bf16 store is itself bf16: both sides round f32 sums that
agree to about 1e-7, so an entry whose sum lies at a rounding midpoint
may differ by one bf16 step (at most 2^-7 of the entry); at most 1%
may.  Structure
(``slot_row``, ``slot_col``, ``order_t``, ``row_map``, ``M_pad``) is
compared exactly.  Gradients with respect to the JAX format are taken
for the whole ``HybridFormat`` pytree and only its ``blocks`` field is
compared: the port gives the remainder's CSR values no gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_sparse_tpu.models import GCN as JGCN
from pytorch_sparse_tpu.models import gcn_norm as jgcn_norm
from pytorch_sparse_tpu.ops.kernels import hybrid as jhyb
from pytorch_sparse_tpu.testing import community_graph as jcommunity
from pytorch_sparse_tpu_torch.models import GCN, gcn_norm
from pytorch_sparse_tpu_torch.ops.kernels import (
    block_spmm_dblocks, block_spmm_dblocks_plain)
from pytorch_sparse_tpu_torch.ops.kernels import hybrid as phyb
from pytorch_sparse_tpu_torch.testing import community_graph as pcommunity
from pytorch_sparse_tpu_torch.testing import rel_err

M, B_BLK, N_COMM = 300, 64, 5
STORES = {"float32": (None, None, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-4)}


@pytest.fixture(autouse=True)
def _highest(monkeypatch):
    monkeypatch.setattr(jhyb, "_BLOCK_PRECISION", jax.lax.Precision.HIGHEST)
    monkeypatch.setattr(phyb, "_BLOCK_PRECISION", "highest")


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _graphs(norm=False):
    """The same community graph (5 equal communities of 60 nodes) in both
    packages, and its community boundaries."""
    A = jcommunity(M, 6000, n_comm=N_COMM, seed=1, equal_sizes=True)
    P = pcommunity(M, 6000, n_comm=N_COMM, seed=1, equal_sizes=True,
                   device="cpu")
    if norm:
        A, P = jgcn_norm(A), gcn_norm(P)
    return A, P, np.linspace(0, M, N_COMM + 1).astype(np.int64)


def _pair(store, aligned, norm=False):
    A, P, pp = _graphs(norm)
    jdt, pdt, tol = STORES[store]
    partptr = pp if aligned else None
    hj = jhyb.build_hybrid_from_tensor(A, B=B_BLK, min_density=0.05,
                                       block_dtype=jdt, partptr=partptr)
    hp = phyb.build_hybrid_from_tensor(P, B=B_BLK, min_density=0.05,
                                       block_dtype=pdt, partptr=partptr)
    return A, P, hj, hp, tol


def _assert_store_grad(got, ref, tol):
    """The store gradient ``got`` (in the store dtype) against JAX's."""
    got = got.float().numpy()
    if tol >= 1e-4:  # a bf16 store: each entry within one rounding step
        diff = np.abs(got - ref)
        step = np.abs(ref) * 2.0 ** -7
        assert np.all(diff <= 1e-4 * np.abs(ref).max() + step)
        assert (diff > 1e-4 * np.abs(ref).max()).mean() <= 0.01
    else:
        assert rel_err(got, ref) <= tol


def _with_blocks(h, blocks):
    """``h`` with its block store replaced (for a leaf that requires
    grad)."""
    return phyb.HybridFormat(blocks, h.slot_row, h.slot_col, h.rb_ptr,
                             h.order_t, h.cb_ptr, h.rest, h.rest_t, h.M, h.N,
                             h.B, h.dense_nnz, h.row_map, h.M_pad)


def test_align_to_blocks_matches_jax():
    """Ragged parts (one empty, one a whole block, one past two blocks):
    the same renumbering as JAX, strictly increasing, each part at a
    block boundary."""
    rng = np.random.RandomState(0)
    pp = np.array([0, 10, 10, 26, 59, 90])
    row, col = rng.randint(0, 90, 400), rng.randint(0, 90, 400)
    got = phyb._align_to_blocks(row, col, pp, 16)
    ref = jhyb._align_to_blocks(row, col, pp, 16)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    row_map, M_pad = got[3], got[2]
    assert M_pad == 16 + 0 + 16 + 48 + 32
    assert np.all(np.diff(row_map) > 0)
    assert np.all(row_map[pp[:-1][np.diff(pp) > 0]] % 16 == 0)


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("store", list(STORES))
def test_build_hybrid_from_tensor_matches_jax(store, aligned):
    _, _, hj, hp, _ = _pair(store, aligned)
    assert (hp.M, hp.N, hp.B, hp.nb, hp.M_pad, hp.dense_nnz) == (
        hj.M, hj.N, hj.B, hj.nb, hj.M_pad, hj.dense_nnz)
    assert 0 < hp.dense_nnz and hp.rest is not None
    for name in ("slot_row", "slot_col", "order_t"):
        np.testing.assert_array_equal(getattr(hp, name).numpy(),
                                      np.asarray(getattr(hj, name)))
    np.testing.assert_array_equal(hp.blocks.float().numpy(),
                                  np.asarray(hj.blocks.astype(jnp.float32)))
    if aligned:
        assert hp.row_map.dtype == torch.int32 and hp.M_pad == 320
        np.testing.assert_array_equal(hp.row_map.numpy(),
                                      np.asarray(hj.row_map))
        # Aligned communities fill whole blocks: fewer of them.
        assert hp.nb < _pair(store, False)[3].nb
    else:
        assert hp.row_map is None and hj.row_map is None


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("store", list(STORES))
def test_hybrid_spmm_and_grads_match_jax(store, aligned, transpose):
    """Output and both gradients (operand and block store) of
    ``<hybrid_spmm(h, x), gout>`` (or of ``hybrid_spmm_t``) against
    ``jax.grad`` of the JAX function."""
    _, _, hj, hp, tol = _pair(store, aligned)
    fj = jhyb.hybrid_spmm_t if transpose else jhyb.hybrid_spmm
    fp = phyb.hybrid_spmm_t if transpose else phyb.hybrid_spmm
    x, gout = _x(2, M, 24), _x(3, M, 24)
    out_j = fj(hj, jnp.asarray(x))
    gh, gx = jax.grad(lambda h, xx: (fj(h, xx) * gout).sum(), argnums=(0, 1),
                      allow_int=True)(hj, jnp.asarray(x))
    blocks = hp.blocks.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out_p = fp(_with_blocks(hp, blocks), xt)
    assert out_p.shape == (M, 24) and out_p.grad_fn is not None
    assert rel_err(out_p, np.asarray(out_j)) <= tol
    (out_p * torch.from_numpy(gout)).sum().backward()
    assert rel_err(xt.grad, np.asarray(gx)) <= tol
    assert blocks.grad.dtype == blocks.dtype
    _assert_store_grad(blocks.grad, np.asarray(gh.blocks.astype(jnp.float32)),
                       tol)
    assert bool((blocks.grad[-1] == 0).all())  # the zero slot: no gradient
    if aligned:
        # Padded node positions carry nothing: their block columns (rows
        # of the operand side) get exactly zero gradient.
        pad = np.setdiff1d(np.arange(hp.M_pad), hp.row_map.numpy())
        cols = torch.from_numpy(pad % B_BLK)
        slots = hp.slot_row if transpose else hp.slot_col
        for s in range(hp.nb):
            owned = pad // B_BLK == int(slots[s])
            idx = cols[torch.from_numpy(owned)]
            side = blocks.grad[s][idx] if transpose else blocks.grad[s][:, idx]
            assert bool((side == 0).all())


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("store", list(STORES))
def test_dense_spmm_and_grads_match_jax(store, transpose):
    """The dense route: the output and the store's gradient against
    ``jax.grad`` of JAX's ``dense_spmm``/``dense_spmm_t`` (which
    differentiate ``jnp.matmul``), the operand's gradient against JAX's
    product in the other direction, which its routed VJP runs.  Autodiff
    through JAX's bf16 split rounds the cotangents to bf16, so with a
    bf16 store JAX's store gradient is one bf16 pass accurate (1e-2);
    the port's is the float64 product rounded once to bf16."""
    A, P, _ = _graphs()
    jdt, pdt, tol = STORES[store]
    r, c = P.storage.numpy_view("row"), P.storage.numpy_view("col")
    v = P.storage.value().numpy()
    dj = jhyb.build_dense(r, c, v, M, M, dtype=jdt)
    dp = phyb.build_dense(r, c, v, M, M, dtype=pdt, device="cpu")
    fj, fj_other = ((jhyb.dense_spmm_t, jhyb.dense_spmm) if transpose
                    else (jhyb.dense_spmm, jhyb.dense_spmm_t))
    fp = phyb.dense_spmm_t if transpose else phyb.dense_spmm
    x, gout = _x(4, M, 12), _x(5, M, 12)
    gd = jax.grad(lambda d: (fj(d, jnp.asarray(x)) * gout).sum())(dj)
    gx = fj_other(dj, jnp.asarray(gout))
    dense = dp.dense.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fp(phyb.DenseFormat(dense, M, M), xt)
    assert rel_err(out, np.asarray(fj(dj, jnp.asarray(x)))) <= tol
    (out * torch.from_numpy(gout)).sum().backward()
    assert rel_err(xt.grad, np.asarray(gx)) <= tol
    assert dense.grad.dtype == dense.dtype
    gd = np.asarray(gd.dense.astype(jnp.float32))
    if store == "float32":
        assert rel_err(dense.grad, gd) <= tol
        return
    assert rel_err(dense.grad.float(), gd) <= 1e-2
    rows, cols = (x, gout) if transpose else (gout, x)
    exact = rows.astype(np.float64) @ cols.astype(np.float64).T
    rounded = torch.from_numpy(exact).to(torch.bfloat16).float().numpy()
    _assert_store_grad(dense.grad, rounded, tol)


def test_store_gradient_runs_only_when_asked(monkeypatch):
    """The block-store gradient runs only for a store that requires
    grad; the operand's gradient only for an operand that does."""
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return block_spmm_dblocks(*a, **kw)

    monkeypatch.setattr(phyb, "block_spmm_dblocks", counted)
    _, _, _, hp, _ = _pair("float32", False)
    x = torch.from_numpy(_x(6, M, 8)).requires_grad_(True)
    phyb.hybrid_spmm(hp, x).sum().backward()
    assert calls == [] and x.grad is not None
    blocks = hp.blocks.clone().requires_grad_(True)
    out = phyb.hybrid_spmm(_with_blocks(hp, blocks), x.detach())
    assert out.grad_fn.saved_tensors[0] is not None  # x kept for blocks
    out.sum().backward()
    assert calls == [1] and blocks.grad is not None
    with torch.no_grad():
        assert phyb.hybrid_spmm(_with_blocks(hp, blocks), x).grad_fn is None


@pytest.mark.parametrize("store", list(STORES))
def test_gcn_on_prebuilt_hybrid_matches_jax(store):
    """GCN on a block-aligned prebuilt hybrid of the normalised graph:
    the loss and the gradients of every parameter and of ``h.blocks``
    against ``jax.grad`` of JAX's ``GCN.loss``."""
    _, _, hj, hp, tol = _pair(store, True, norm=True)
    params = JGCN.init(jax.random.PRNGKey(7), 16, 32, 6, num_layers=3)
    x = _x(8, M, 16)
    labels = np.random.RandomState(9).randint(0, 6, M)
    mask = (np.random.RandomState(10).rand(M) < 0.5).astype(np.float32)
    loss_j, (gp, gh) = jax.value_and_grad(
        lambda p, h: JGCN.loss(p, h, jnp.asarray(x), jnp.asarray(labels),
                               jnp.asarray(mask)),
        argnums=(0, 1), allow_int=True)(params, hj)
    model = GCN.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    blocks = hp.blocks.clone().requires_grad_(True)
    loss_p = model.loss(_with_blocks(hp, blocks), torch.from_numpy(x),
                        torch.from_numpy(labels), torch.from_numpy(mask))
    loss_p.backward()
    assert abs(loss_p.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for i, layer in enumerate(gp["layers"]):
        assert rel_err(model.weights[i].grad, np.asarray(layer["w"])) <= 1e-5
        assert rel_err(model.biases[i].grad, np.asarray(layer["b"])) <= 1e-5
    _assert_store_grad(blocks.grad, np.asarray(gh.blocks.astype(jnp.float32)),
                       max(tol, 1e-5))


def test_gcn_on_prebuilt_dense_matches_routed_csr():
    """A prebuilt DenseFormat aggregates as the routed SpMM does."""
    _, P, _ = _graphs(norm=True)
    r, c = P.storage.numpy_view("row"), P.storage.numpy_view("col")
    d = phyb.build_dense(r, c, P.storage.value().numpy(), M, M, device="cpu")
    model = GCN(16, 32, 6, num_layers=2, device="cpu")
    x = torch.from_numpy(_x(11, M, 16))
    with torch.no_grad():
        assert rel_err(model(d, x), model(P, x)) <= 1e-5


@pytest.mark.parametrize("B,K", [(8, 5), (100, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dblocks_plain_version_matches_oracle(B, K, dtype):
    """``p[slot_row[s]] @ q[slot_col[s]]^T`` per slot against float64,
    with block and K sizes that are not multiples of the kernel's tiles;
    the trailing slot is zero."""
    rng = np.random.RandomState(12)
    R, C, nb = 3, 4, 7
    keys = np.sort(rng.choice(R * C, nb, replace=False))
    slot_row, slot_col = keys // C, keys % C
    p, q = _x(13, R * B, K), _x(14, C * B, K)
    i32 = [torch.from_numpy(a.astype(np.int32)) for a in (slot_row, slot_col)]
    before = block_spmm_dblocks.launches
    out = block_spmm_dblocks(torch.from_numpy(p), torch.from_numpy(q), *i32,
                             B, dtype)
    assert block_spmm_dblocks.launches == before  # the CPU runs the plain
    assert out.shape == (nb + 1, B, B) and out.dtype == dtype
    pv = p.reshape(R, B, K).astype(np.float64)
    qv = q.reshape(C, B, K).astype(np.float64)
    ref = np.einsum("sbk,sck->sbc", pv[slot_row], qv[slot_col])
    assert rel_err(out[:nb].float(), ref) <= (1e-6 if dtype == torch.float32
                                              else 4e-3)
    assert bool((out[nb] == 0).all())
    assert torch.equal(out, block_spmm_dblocks_plain(
        torch.from_numpy(p), torch.from_numpy(q), *i32, B, dtype))


def test_dblocks_raises_off_cpu_without_a_kernel():
    i32 = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        block_spmm_dblocks(torch.empty(4, 3, device="meta"),
                           torch.empty(4, 3, device="meta"), i32, i32, 4,
                           torch.float32)
    cpu_i32 = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):  # p is not whole blocks
        block_spmm_dblocks(torch.empty(5, 3), torch.empty(4, 3), cpu_i32,
                           cpu_i32, 4, torch.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("kind", ["normal", "ones", "empty", "zeros"])
def test_quantization_rel_err_matches_jax(dtype, kind):
    """The router's bf16 rule on numpy and on a tensor equals the JAX
    package's (1e-12 relative: float64 means in another order)."""
    rng = np.random.RandomState(3)
    v = {"normal": rng.randn(5000), "ones": np.ones(100),
         "empty": np.zeros(0), "zeros": np.zeros(10)}[kind].astype(dtype)
    want = jhyb.quantization_rel_err(v)
    for got in (phyb.quantization_rel_err(v),
                phyb.quantization_rel_err(torch.from_numpy(v))):
        assert abs(got - want) <= 1e-12 * max(want, 1e-30)
    assert (want > 0) == (kind == "normal")
