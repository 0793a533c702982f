"""The port's GCN inference against the JAX package's on the same numpy
inputs and weights (CPU).  Logits agree to 1e-5 of their largest
magnitude (float32; summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.models import GCN as JGCN
from pytorch_sparse_tpu.models import gcn_norm as jgcn_norm
from pytorch_sparse_tpu_torch.models import GCN, gcn_norm
from pytorch_sparse_tpu_torch.testing import rel_err


def _adj(seed, M, E, values):
    rng = np.random.RandomState(seed)
    row, col = rng.randint(0, M, E), rng.randint(0, M, E)
    val = rng.uniform(0.5, 2.0, E).astype(np.float32) if values else None
    A = jts.SparseTensor(row=row, col=col, sparse_sizes=(M, M),
                         value=None if val is None else jnp.asarray(val))
    B = pts.SparseTensor(row=row, col=col, sparse_sizes=(M, M), device="cpu",
                         value=None if val is None else torch.from_numpy(val))
    return A.coalesce(), B.coalesce()


@pytest.mark.parametrize("values", [True, False])
@pytest.mark.parametrize("self_loops", [True, False])
def test_gcn_norm_matches_jax(values, self_loops):
    A, B = _adj(0, 70, 400, values)
    An, Bn = jgcn_norm(A, self_loops), gcn_norm(B, self_loops)
    for a, b in zip(An.coo()[:2], Bn.coo()[:2]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert rel_err(Bn.storage.value(), np.asarray(An.storage.value())) <= 1e-6


def _jax_params(seed, in_dim, hid, out_dim, layers):
    params = JGCN.init(jax.random.PRNGKey(seed), in_dim, hid, out_dim,
                       num_layers=layers)
    # Non-zero biases so that the carried-over bias is exercised too.
    rng = np.random.RandomState(seed)
    for layer in params["layers"]:
        layer["b"] = jnp.asarray(
            rng.randn(*layer["b"].shape).astype(np.float32))
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("layers,widths", [(2, (24, 32, 7)),
                                           (3, (16, 40, 5))])
def test_gcn_logits_match_jax(layers, widths):
    A, B = _adj(1, 90, 600, values=False)
    An, Bn = jgcn_norm(A), gcn_norm(B)
    params, np_params = _jax_params(2, *widths, layers)
    x = np.random.RandomState(3).randn(90, widths[0]).astype(np.float32)
    ref = np.asarray(JGCN.apply(params, An, jnp.asarray(x)))
    model = GCN.from_jax_params(np_params, device="cpu")
    assert len(model.weights) == layers
    with torch.no_grad():
        out = model(Bn, torch.from_numpy(x))
    assert out.shape == (90, widths[-1])
    assert rel_err(out, ref) <= 1e-5


def test_gcn_init_is_seeded_and_glorot_bounded():
    a = GCN(12, 20, 4, num_layers=3,
            generator=torch.Generator().manual_seed(5), device="cpu")
    b = GCN(12, 20, 4, num_layers=3,
            generator=torch.Generator().manual_seed(5), device="cpu")
    assert [tuple(w.shape) for w in a.weights] == [(12, 20), (20, 20),
                                                    (20, 4)]
    for wa, wb in zip(a.weights, b.weights):
        assert torch.equal(wa, wb)
        bound = float(np.sqrt(6.0 / sum(wa.shape)))
        assert float(wa.detach().abs().max()) <= bound
    assert all(float(bias.detach().abs().max()) == 0.0 for bias in a.biases)


def test_gcn_forward_with_grad_raises():
    """A forward under autograd no longer raises: it gives every
    parameter the gradient ``jax.grad`` gives the JAX model."""
    A, B = _adj(4, 30, 120, values=False)
    params, np_params = _jax_params(5, 8, 8, 3, 2)
    x = np.random.RandomState(6).randn(30, 8).astype(np.float32)
    ref = jax.grad(lambda p: JGCN.apply(p, jgcn_norm(A),
                                        jnp.asarray(x)).sum())(params)
    model = GCN.from_jax_params(np_params, device="cpu")
    model(gcn_norm(B), torch.from_numpy(x)).sum().backward()
    for i, layer in enumerate(ref["layers"]):
        assert rel_err(model.weights[i].grad, np.asarray(layer["w"])) <= 1e-5
        assert rel_err(model.biases[i].grad, np.asarray(layer["b"])) <= 1e-5
