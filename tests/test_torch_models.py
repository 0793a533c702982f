"""The port's GraphSAGE and GIN against the JAX package's on the same
numpy inputs and weights (CPU, where each kernel runs its plain
version): logits, ``jax.grad`` of the masked mean negative
log-likelihood for every parameter, and one Adam step against
``optax.adam``.

Tolerances (max |diff| / max |ref|, float32): 1e-5 for logits, losses
and gradients (projections and sums run in another order); one Adam step
agrees to 1e-4 of the largest parameter magnitude, as for GCN
(``test_torch_grad.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.models import GIN as JGIN
from pytorch_sparse_tpu.models import GraphSAGE as JSAGE
from pytorch_sparse_tpu_torch.models import GIN, GraphSAGE
from pytorch_sparse_tpu_torch.testing import rel_err

MODELS = {"sage": (JSAGE, GraphSAGE, ("w_self", "w_neigh", "b")),
          "gin": (JGIN, GIN, ("w1", "w2", "b1", "b2"))}


def _adj(seed, M, E, empty_rows=False):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, M // 2 if empty_rows else M, E)
    col = rng.randint(0, M, E)
    A = jts.SparseTensor(row=row, col=col, sparse_sizes=(M, M)).coalesce()
    B = pts.SparseTensor(row=row, col=col, sparse_sizes=(M, M),
                         device="cpu").coalesce()
    return A, B


def _setup(kind, layers, seed=1, M=60, widths=(12, 16, 5)):
    A, B = _adj(seed, M, 400, empty_rows=True)
    J, _, names = MODELS[kind]
    params = J.init(jax.random.PRNGKey(seed), *widths, num_layers=layers)
    rng = np.random.RandomState(seed)
    for layer in params["layers"]:  # non-zero biases get gradients too
        for name in names:
            if name.startswith("b"):
                layer[name] = jnp.asarray(rng.randn(
                    *layer[name].shape).astype(np.float32) * 0.1)
    if kind == "gin":
        params["eps"] = jnp.asarray(rng.randn(layers).astype(
            np.float32) * 0.1)
    x = rng.randn(M, widths[0]).astype(np.float32)
    labels = rng.randint(0, widths[-1], M)
    mask = (rng.rand(M) < 0.5).astype(np.float32)
    return A, B, params, x, labels, mask


def _jax_loss(J, params, A, x, labels, mask):
    logp = jax.nn.log_softmax(J.apply(params, A, x), axis=-1)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    return (nll * mask).sum() / jnp.maximum(mask.sum(), 1)


def _pairs(kind, model, tree):
    """``(port parameter, JAX leaf)`` pairs in the JAX package's order."""
    names = MODELS[kind][2]
    out = [(getattr(model, n)[i], layer[n])
           for i, layer in enumerate(tree["layers"]) for n in names]
    if kind == "gin":
        out.append((model.eps, tree["eps"]))
    return out


@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("kind", list(MODELS))
def test_logits_and_grads_match_jax(kind, layers):
    A, B, params, x, labels, mask = _setup(kind, layers)
    J, P, _ = MODELS[kind]
    model = P.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    with torch.no_grad():
        out = model(B, torch.from_numpy(x))
    assert out.shape == (60, 5)
    assert rel_err(out, np.asarray(J.apply(params, A, jnp.asarray(x)))) <= 1e-5
    assert not B.storage.has_hybrid()
    loss_j, grads = jax.value_and_grad(_jax_loss, argnums=1)(
        J, params, A, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask))
    loss_p = model.loss(B, torch.from_numpy(x), torch.from_numpy(labels),
                        torch.from_numpy(mask))
    loss_p.backward()
    assert abs(loss_p.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    pairs = _pairs(kind, model, grads)
    assert len(pairs) == len(list(model.parameters()))
    for p, g in pairs:
        assert p.grad.shape == g.shape
        assert rel_err(p.grad, np.asarray(g)) <= 1e-5


@pytest.mark.parametrize("kind", list(MODELS))
def test_adam_step_matches_optax(kind):
    A, B, params, x, labels, mask = _setup(kind, 3, seed=2)
    J, P, _ = MODELS[kind]
    model = P.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    grads = jax.grad(_jax_loss, argnums=1)(
        J, params, A, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask))
    opt = optax.adam(1e-2)
    updates, _ = opt.update(grads, opt.init(params), params)
    new_params = optax.apply_updates(params, updates)
    adam = torch.optim.Adam(model.parameters(), lr=1e-2)
    model.loss(B, torch.from_numpy(x), torch.from_numpy(labels),
               torch.from_numpy(mask)).backward()
    adam.step()
    for p, q in _pairs(kind, model, new_params):
        q = np.asarray(q)
        assert np.abs(p.detach().numpy() - q).max() <= 1e-4 * np.abs(q).max()


@pytest.mark.parametrize("kind", list(MODELS))
def test_init_is_seeded_with_jax_shapes(kind):
    J, P, _ = MODELS[kind]
    a = P(12, 16, 5, num_layers=3, generator=torch.Generator().manual_seed(3),
          device="cpu")
    b = P(12, 16, 5, num_layers=3, generator=torch.Generator().manual_seed(3),
          device="cpu")
    ref = J.init(jax.random.PRNGKey(0), 12, 16, 5, num_layers=3)
    for p, q in _pairs(kind, a, ref):
        assert tuple(p.shape) == q.shape and p.dtype == torch.float32
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    w = a.w_self[0] if kind == "sage" else a.w2[0]
    assert float(w.detach().abs().max()) <= float(np.sqrt(6.0 / (12 + 16)))
    assert float(w.detach().abs().max()) > 0


@pytest.mark.parametrize("kind", list(MODELS))
def test_from_jax_params_rejects_unchained_shapes(kind):
    J, P, names = MODELS[kind]
    params = jax.tree_util.tree_map(
        np.asarray, J.init(jax.random.PRNGKey(4), 8, 6, 3, num_layers=2))
    params["layers"][1][names[-1]] = params["layers"][1][names[-1]][:2]
    with pytest.raises(ValueError, match=names[-1]):
        P.from_jax_params(params, device="cpu")
