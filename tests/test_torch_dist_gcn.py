"""The port's ``DistGCN`` against the JAX package on the same numpy
inputs: one Adam step on 1, 3 and 4 gloo processes on the CPU (workers
in ``_torch_dist_workers.py``), on every flat schedule and on the halo
schedule's hybrid local format.

The global loss, every all-reduced parameter gradient and the
parameters after ``torch.optim.Adam``'s step are held against JAX's
single-device ``GCN`` loss, ``jax.grad`` and ``optax.adam`` (1e-5 of max
|ref|: summation order differs), and once against JAX's own
``DistGCN.train_step`` (a ``shard_map`` program on the virtual 4-device
mesh).  Every rank must hold the same parameters after the step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pytorch_sparse_tpu as jts
from pytorch_sparse_tpu.models import GCN as JGCN
from pytorch_sparse_tpu.models.dist_gcn import DistGCN as JDistGCN
from pytorch_sparse_tpu.parallel import ShardedSparseMatrix as JSharded
from pytorch_sparse_tpu.parallel import make_mesh as jmake_mesh
from pytorch_sparse_tpu_torch.models import DistGCN, GCN
from pytorch_sparse_tpu_torch.testing import rel_err

import _torch_dist_workers as W

M, SEED, N_CLASSES, LR = 118, 11, 4, 1e-2
GRAPH = (12, 1600, 150, 3, 0)
WIDTHS = (8, 16, N_CLASSES, 3)         # in, hidden, out, layers
SCHEDULES = [("ring", "ell"), ("allgather", "ell"), ("halo", "ell"),
             ("halo", "auto")]
WORLD_SIZES = (1, 3, 4)


@pytest.fixture(scope="module")
def jax_params():
    p = JGCN.init(jax.random.PRNGKey(3), WIDTHS[0], WIDTHS[1], WIDTHS[2],
                  num_layers=WIDTHS[3])
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def inputs():
    row, col, _ = W.community_coo(M, *GRAPH)
    row, col, val = W.gcn_norm_coo(row, col, M)
    A = jts.SparseTensor(row=jnp.asarray(row.astype(np.int32)),
                         col=jnp.asarray(col.astype(np.int32)),
                         value=jnp.asarray(val), sparse_sizes=(M, M))
    x = W.operand(SEED, M, WIDTHS[0])
    rng = np.random.RandomState(SEED + 1)
    labels = rng.randint(0, N_CLASSES, M)
    mask = (rng.rand(M) < 0.6).astype(np.float32)
    return A, x, labels, mask


@pytest.fixture(scope="module")
def port(jax_params):
    cache = {}
    layers = [(torch.from_numpy(np.array(layer["w"])),
               torch.from_numpy(np.array(layer["b"])))
              for layer in jax_params["layers"]]

    def get(ws):
        if ws not in cache:
            cache[ws] = W.spawn(
                W.run_dist_gcn, ws, "gloo",
                args=dict(M=M, graph=GRAPH, layers=layers,
                          n_classes=N_CLASSES, seed=SEED,
                          schedules=SCHEDULES, lr=LR),
                threads=1)
        return cache[ws]
    return get


def _flat(tree):
    """JAX's per-layer ``(w, b)`` in the port's parameter order (every
    weight, then every bias)."""
    layers = tree["layers"]
    return ([np.asarray(layer["w"]) for layer in layers]
            + [np.asarray(layer["b"]) for layer in layers])


@pytest.fixture(scope="module")
def reference(jax_params, inputs):
    """JAX's single-device loss, gradients and Adam step."""
    A, x, labels, mask = inputs
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    loss, grads = jax.value_and_grad(JGCN.loss)(
        params, A, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask))
    opt = optax.adam(LR)
    updates, _ = opt.update(grads, opt.init(params), params)
    new = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    return float(loss), _flat(grads), _flat(new)


def _check(got, loss, grads, params):
    assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
    for g, r in zip(got["grads"], grads):
        assert rel_err(g, r) <= 1e-5
    for p, r in zip(got["params"], params):
        assert rel_err(p, r) <= 1e-5


@pytest.mark.parametrize("schedule,fmt", SCHEDULES,
                         ids=["-".join(s) for s in SCHEDULES])
@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_dist_gcn_step_matches_jax_gcn(port, reference, ws, schedule, fmt):
    res = port(ws)
    _check(res[0][f"{schedule}-{fmt}"], *reference)
    if ws > 1:  # halo-auto takes the interior blocks
        assert res[0]["has_interior_blocks"]


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_parameters_stay_identical_on_every_rank(port, ws):
    res = port(ws)
    for key in [f"{s}-{f}" for s, f in SCHEDULES]:
        for rank in range(1, ws):
            for p, q in zip(res[0][key]["params"], res[rank][key]["params"]):
                assert torch.equal(p, q)
            assert torch.equal(res[0][key]["loss"], res[rank][key]["loss"])


def test_dist_gcn_step_matches_jax_dist_gcn_train_step(port, jax_params,
                                                       inputs):
    """JAX's own ``DistGCN.train_step`` (ring schedule, ``optax.adam``)
    on the 4-device mesh against the port's at world size 4."""
    A, x, labels, mask = inputs
    J = JSharded.from_sparse_tensor(A, jmake_mesh(4), block_B=8)
    pad = J.P * J.Nb - M

    def stack(a):
        return jnp.asarray(np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)]).reshape(
                J.P, J.Nb, *a.shape[1:]))

    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    opt = optax.adam(LR)
    new, _, loss = JDistGCN.train_step(
        params, opt.init(params), J, J.shard_dense(jnp.asarray(x)),
        stack(labels), stack(mask), opt, "ring")
    got = port(4)[0]["ring-ell"]
    assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    for p, r in zip(got["params"], _flat(new)):
        assert rel_err(p, r) <= 1e-5


def test_dist_gcn_shares_gcn_parameters(jax_params):
    """``DistGCN`` is a ``GCN`` with the same parameters and the same
    ``from_jax_params``; it refuses an adjacency it cannot run."""
    d = DistGCN.from_jax_params(jax_params, device="cpu")
    g = GCN.from_jax_params(jax_params, device="cpu")
    assert isinstance(d, GCN)
    for p, q in zip(d.parameters(), g.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(TypeError):
        d(object(), torch.zeros(3, WIDTHS[0]))
