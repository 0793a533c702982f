"""The port's edge softmax (forward and backward) and GAT inference and
training against the JAX package on the same numpy inputs and weights
(CPU, where each kernel runs its plain version).

Tolerances (max |diff| / max |ref|, float32): 1e-6 for the edge softmax
and its gradient (the exp and the sums run in another order), 1e-5 for
GAT logits and their gradients (two layers of projections and sums).
One Adam step agrees with ``optax.adam`` to 1e-4 of the largest
parameter magnitude, as for GCN (``test_torch_grad.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.models.gat import GAT as JGAT
from pytorch_sparse_tpu.models.gat import edge_softmax as jedge_softmax
from pytorch_sparse_tpu.ops.kernels.ell import ell_edge_softmax
from pytorch_sparse_tpu_torch.models import GAT
from pytorch_sparse_tpu_torch.ops.kernels import (
    edge_softmax, edge_softmax_bwd, edge_softmax_bwd_plain, edge_softmax_plain)
from pytorch_sparse_tpu_torch.testing import rel_err


def _adj(seed, M, E, empty_rows=False):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, M // 2 if empty_rows else M, E)
    col = rng.randint(0, M, E)
    A = jts.SparseTensor(row=row, col=col, sparse_sizes=(M, M)).coalesce()
    B = pts.SparseTensor(row=row, col=col, sparse_sizes=(M, M),
                         device="cpu").coalesce()
    return A, B


@pytest.mark.parametrize("H", [1, 3, 8])
def test_edge_softmax_plain_matches_jax(H):
    """The plain version against both JAX forms: the ELL kernel
    ``ell_edge_softmax`` and the segment form ``gat.edge_softmax``."""
    A, B = _adj(0, 70, 500, empty_rows=True)
    logits = (np.random.RandomState(1).randn(B.nnz(), H) * 3).astype(
        np.float32)
    got = edge_softmax_plain(B.storage.rowptr(), torch.from_numpy(logits))
    lj = jnp.asarray(logits)
    ref_ell = np.asarray(ell_edge_softmax(A.storage.ell(), lj))
    ref_seg = np.asarray(jedge_softmax(A.storage.row(), lj, 70))
    assert rel_err(got, ref_ell) <= 1e-6 and rel_err(got, ref_seg) <= 1e-6
    # Each row-head sums to 1.
    row = B.storage.row().long()
    sums = torch.zeros(70, H).index_add_(0, row, got)
    np.testing.assert_allclose(sums[row.unique()].numpy(), 1.0, rtol=1e-6)


def _jax_params(seed, in_dim, hid, out_dim, heads):
    params = JGAT.init(jax.random.PRNGKey(seed), in_dim, hid, out_dim,
                       heads=heads)
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("heads,hid", [(3, 4), (1, 6), (8, 8)])
def test_gat_logits_match_jax(heads, hid):
    """``GAT.from_jax_params`` gives JAX ``GAT.apply``'s logits (run
    eagerly, on its ELL path), and the router is never consulted: the
    attention enters as per-call values."""
    A, B = _adj(2, 60, 400)
    params, np_params = _jax_params(3, 16, hid, 5, heads)
    x = np.random.RandomState(4).randn(60, 16).astype(np.float32)
    ref = np.asarray(JGAT.apply(params, A, jnp.asarray(x)))
    model = GAT.from_jax_params(np_params, device="cpu")
    with torch.no_grad():
        out = model(B, torch.from_numpy(x))
    assert out.shape == (60, 5)
    assert rel_err(out, ref) <= 1e-5
    assert not B.storage.has_hybrid() and B.storage._hybrid_skip is None


def test_gat_grads_match_jax_on_cpu():
    """On the CPU the plain edge softmax is differentiable, so every
    parameter gets ``jax.grad``'s gradient."""
    A, B = _adj(5, 40, 250, empty_rows=True)
    params, np_params = _jax_params(6, 12, 4, 3, 2)
    x = np.random.RandomState(7).randn(40, 12).astype(np.float32)
    ref = jax.grad(lambda p: JGAT.apply(p, A, jnp.asarray(x)).sum())(params)
    model = GAT.from_jax_params(np_params, device="cpu")
    model(B, torch.from_numpy(x)).sum().backward()
    for name, g in ref.items():
        assert rel_err(getattr(model, name).grad, np.asarray(g)) <= 1e-5, name


def test_gat_init_is_seeded_with_jax_shapes():
    a = GAT(12, 4, 3, heads=5, generator=torch.Generator().manual_seed(8),
            device="cpu")
    b = GAT(12, 4, 3, heads=5, generator=torch.Generator().manual_seed(8),
            device="cpu")
    shapes = {name: tuple(p.shape) for name, p in a.named_parameters()}
    assert shapes == {"w1": (12, 20), "a1_src": (5, 4), "a1_dst": (5, 4),
                      "w2": (20, 3), "a2_src": (1, 3), "a2_dst": (1, 3)}
    ref = JGAT.init(jax.random.PRNGKey(0), 12, 4, 3, heads=5)
    assert {k: v.shape for k, v in ref.items()} == shapes
    for (_, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb)
    bound = float(np.sqrt(6.0 / (12 + 20)))
    assert float(a.w1.detach().abs().max()) <= bound


def test_gat_from_jax_params_rejects_unchained_shapes():
    _, np_params = _jax_params(9, 8, 4, 3, 2)
    np_params["a1_dst"] = np_params["a1_dst"][:, :3]
    with pytest.raises(ValueError, match="a1_dst"):
        GAT.from_jax_params(np_params, device="cpu")


@pytest.mark.parametrize("H", [1, 3, 8])
def test_edge_softmax_backward_matches_jax(H):
    """The logits' gradient of ``<edge_softmax(l), gout>`` (the autograd
    function, whose backward is ``edge_softmax_bwd``) against
    ``jax.grad`` of both JAX forms, on a matrix with empty rows."""
    A, B = _adj(10, 70, 500, empty_rows=True)
    rng = np.random.RandomState(11)
    logits = (rng.randn(B.nnz(), H) * 3).astype(np.float32)
    gout = rng.randn(B.nnz(), H).astype(np.float32)
    lj, gj = jnp.asarray(logits), jnp.asarray(gout)
    ell = A.storage.ell()
    ref_ell = np.asarray(jax.grad(lambda lg: (ell_edge_softmax(
        ell, lg) * gj).sum())(lj))
    ref_seg = np.asarray(jax.grad(lambda lg: (jedge_softmax(
        A.storage.row(), lg, 70) * gj).sum())(lj))
    rowptr = B.storage.rowptr()
    lt = torch.from_numpy(logits).requires_grad_(True)
    p = edge_softmax(rowptr, lt)
    assert p.grad_fn is not None
    (p * torch.from_numpy(gout)).sum().backward()
    assert rel_err(lt.grad, ref_ell) <= 1e-6
    assert rel_err(lt.grad, ref_seg) <= 1e-6
    before = edge_softmax_bwd.launches
    direct = edge_softmax_bwd(rowptr, p.detach(), torch.from_numpy(gout))
    assert edge_softmax_bwd.launches == before  # the CPU runs the plain
    assert torch.equal(direct, lt.grad)
    assert torch.equal(direct, edge_softmax_bwd_plain(
        rowptr, p.detach(), torch.from_numpy(gout)))
    # Each row-head's gradient sums to 0: softmax ignores a shift.
    row = B.storage.row().long()
    sums = torch.zeros(70, H).index_add_(0, row, lt.grad)
    assert float(sums.abs().max()) <= 1e-5


def test_edge_softmax_backward_raises_off_cpu_without_a_kernel():
    rowptr = torch.tensor([0, 1, 2], dtype=torch.int32, device="meta")
    p = torch.empty(2, 3, device="meta")
    with pytest.raises(NotImplementedError):
        edge_softmax_bwd(rowptr, p, torch.empty(2, 3, device="meta"))
    with pytest.raises(ValueError):  # g's shape differs from p's
        edge_softmax_bwd(torch.tensor([0, 1, 2], dtype=torch.int32),
                         torch.zeros(2, 3), torch.zeros(2, 4))


def _jax_nll(logits, labels, mask=None):
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / jnp.maximum(mask.sum(), 1)


@pytest.mark.parametrize("use_mask", [False, True])
def test_gat_adam_step_matches_optax(use_mask):
    """``GAT.loss`` and one ``Adam(lr=5e-3)`` step (the JAX package's
    ``examples/train_gat.py``) against ``jax.value_and_grad`` and
    ``optax.adam(5e-3)``, on a graph with self-loops."""
    A, B = _adj(12, 50, 300)
    A, B = A.set_diag(), B.set_diag()
    assert A.nnz() == B.nnz()
    params, np_params = _jax_params(13, 10, 4, 3, 2)
    x = np.random.RandomState(14).randn(50, 10).astype(np.float32)
    labels = np.random.RandomState(15).randint(0, 3, 50)
    mask = (np.random.RandomState(16).rand(50) < 0.5).astype(np.float32)
    mj = jnp.asarray(mask) if use_mask else None
    loss_j, grads = jax.value_and_grad(lambda p: _jax_nll(
        JGAT.apply(p, A, jnp.asarray(x)), jnp.asarray(labels), mj))(params)
    opt = optax.adam(5e-3)
    updates, _ = opt.update(grads, opt.init(params), params)
    new_params = optax.apply_updates(params, updates)

    model = GAT.from_jax_params(np_params, device="cpu")
    adam = torch.optim.Adam(model.parameters(), lr=5e-3)
    loss_p = model.loss(B, torch.from_numpy(x), torch.from_numpy(labels),
                        torch.from_numpy(mask) if use_mask else None)
    loss_p.backward()
    assert abs(loss_p.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for name, g in grads.items():
        assert rel_err(getattr(model, name).grad, np.asarray(g)) <= 1e-5
    adam.step()
    for name, q in new_params.items():
        q = np.asarray(q)
        got = getattr(model, name).detach().numpy()
        assert np.abs(got - q).max() <= 1e-4 * np.abs(q).max(), name
