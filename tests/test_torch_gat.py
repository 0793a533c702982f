"""The port's edge softmax and GAT inference against the JAX package on
the same numpy inputs and weights (CPU, where each kernel runs its plain
version).

Tolerances (max |diff| / max |ref|, float32): 1e-6 for the edge softmax
(the exp and the sums run in another order), 1e-5 for GAT logits and
their gradients (two layers of projections and sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.models.gat import GAT as JGAT
from pytorch_sparse_tpu.models.gat import edge_softmax as jedge_softmax
from pytorch_sparse_tpu.ops.kernels.ell import ell_edge_softmax
from pytorch_sparse_tpu_torch.models import GAT
from pytorch_sparse_tpu_torch.ops.kernels import edge_softmax_plain
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
