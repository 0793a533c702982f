"""The port's ``DistGCN`` on a 2-D ``(data, feat)`` grid
(``make_mesh2d``) against the JAX package on the same numpy inputs: one
Adam step on (2, 2) and (1, 2) grids of gloo processes on the CPU, each
spawned once (worker ``run_dist_gcn2d`` in ``_torch_dist_workers.py``,
which imports no JAX), on every flat schedule and on the halo schedule's
hybrid local format.

The graph and widths are ``tests/test_torch_dist_gcn.py``'s (118 nodes,
8 -> 16 -> 4, 3 layers), which divide by 2.  The logits, the global
loss, every all-reduced parameter gradient and the parameters after
``torch.optim.Adam``'s step are held against JAX's single-device ``GCN``
forward, loss, ``jax.grad`` and ``optax.adam`` (1e-5 of max |ref|:
summation order differs), and once a grid against JAX's own 2-D
``DistGCN.train_step`` (a ``shard_map`` program on ``make_mesh2d`` of
the virtual 8-device mesh, under ``jax.jit``).  Every rank must hold the
same parameters after the step.  An output width that does not divide
by the feature axis raises ``ValueError`` in both packages, and on
every rank of the port without a hang.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_sparse_tpu.models import GCN as JGCN
from pytorch_sparse_tpu.models.dist_gcn import DistGCN as JDistGCN
from pytorch_sparse_tpu.parallel import ShardedSparseMatrix as JSharded
from pytorch_sparse_tpu.parallel import make_mesh2d as jmake_mesh2d
from pytorch_sparse_tpu_torch.testing import rel_err

import _torch_dist_workers as W
from test_torch_dist_gcn import (  # noqa: F401 (fixtures)
    GRAPH, LR, M, N_CLASSES, SCHEDULES, SEED, WIDTHS, _check, _flat,
    inputs, jax_params, reference)

GRIDS = [(2, 2), (1, 2)]
GRID_IDS = [f"P{p}F{f}" for p, f in GRIDS]
NARROW_OUT = 3          # an output width that 2 does not divide
# JAX's own 2-D step, once a grid: each schedule compiles for seconds.
JAX_2D_SCHEDULES = {(2, 2): ("ring", "ell"), (1, 2): ("halo", "auto")}


@pytest.fixture(scope="module")
def port(jax_params):
    cache = {}
    layers = [(torch.from_numpy(np.array(layer["w"])),
               torch.from_numpy(np.array(layer["b"])))
              for layer in jax_params["layers"]]

    def get(grid):
        if grid not in cache:
            cache[grid] = W.spawn(
                W.run_dist_gcn2d, grid[0] * grid[1], "gloo",
                args=dict(P=grid[0], Pf=grid[1], M=M, graph=GRAPH,
                          layers=layers, n_classes=N_CLASSES, seed=SEED,
                          schedules=SCHEDULES, lr=LR,
                          narrow_out=NARROW_OUT),
                timeout=300, threads=1)
        return cache[grid]
    return get


@pytest.fixture(scope="module")
def logits_ref(jax_params, inputs):
    """JAX's single-device GCN logits of the initial parameters."""
    A, x, _, _ = inputs
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    return np.asarray(JGCN.apply(params, A, jnp.asarray(x)))


def _jax_2d(inputs, grid):
    """JAX's sharded matrix on ``make_mesh2d(*grid)``, ``x`` as its
    ``(P, Nb, K)`` feature-sharded operand, and ``labels``/``mask`` as
    ``(P, Nb)`` (``shard_dense`` of a width-1 array raises on a grid)."""
    A, x, labels, mask = inputs
    J = JSharded.from_sparse_tensor(A, jmake_mesh2d(*grid), block_B=8)
    pad = J.P * J.Nb - M

    def stack(a):
        return jnp.asarray(np.concatenate(
            [a, np.zeros(pad, a.dtype)]).reshape(J.P, J.Nb))

    return J, J.shard_dense(jnp.asarray(x)), stack(labels), stack(mask)


@pytest.mark.parametrize("schedule,fmt", SCHEDULES,
                         ids=["-".join(s) for s in SCHEDULES])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_dist_gcn2d_step_matches_jax_gcn(port, reference, logits_ref, grid,
                                         schedule, fmt):
    """Each rank runs its ``in/Pf`` feature columns; the gathered logits,
    the loss, the gradients and the parameters after the step are JAX's
    single-device GCN step's."""
    res = port(grid)[0]
    assert res["x_cols"] == WIDTHS[0] // grid[1]
    got = res[f"{schedule}-{fmt}"]
    assert rel_err(got["logits"], logits_ref) <= 1e-5
    _check(got, *reference)
    if grid[0] > 1:  # halo-auto takes the interior blocks
        assert res["has_interior_blocks"]


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_dist_gcn2d_parameters_stay_identical_on_every_rank(port, grid):
    res = port(grid)
    for key in [f"{s}-{f}" for s, f in SCHEDULES]:
        for rank in range(1, grid[0] * grid[1]):
            for p, q in zip(res[0][key]["params"], res[rank][key]["params"]):
                assert torch.equal(p, q)
            assert torch.equal(res[0][key]["loss"], res[rank][key]["loss"])


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_dist_gcn2d_step_matches_jax_dist_gcn_train_step(port, jax_params,
                                                         inputs, grid):
    """JAX's own ``DistGCN.train_step`` (``optax.adam``) on
    ``make_mesh2d`` against the port's on the same grid."""
    schedule, fmt = JAX_2D_SCHEDULES[grid]
    J, xs, labels, mask = _jax_2d(inputs, grid)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    opt = optax.adam(LR)
    step = jax.jit(lambda p, s, a, x_, y, m: JDistGCN.train_step(
        p, s, a, x_, y, m, opt, schedule))
    new, _, loss = step(params, opt.init(params), J, xs, labels, mask)
    got = port(grid)[0][f"{schedule}-{fmt}"]
    assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    for p, r in zip(got["params"], _flat(new)):
        assert rel_err(p, r) <= 1e-5


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_dist_gcn2d_indivisible_width_raises(port, jax_params, inputs, grid):
    """An output width of 3 on two feature blocks: ``ValueError`` from
    JAX's ``shard_map`` and, before any collective, on every rank of the
    port (the spawn returns, so no rank waits in a collective)."""
    assert all(r["narrow_raises"] for r in port(grid))
    J, xs, _, _ = _jax_2d(inputs, grid)
    layers = jax_params["layers"]
    narrow = {"layers": layers[:-1] + [
        {"w": layers[-1]["w"][:, :NARROW_OUT],
         "b": layers[-1]["b"][:NARROW_OUT]}]}
    with pytest.raises(ValueError, match="divisible"):
        jax.eval_shape(lambda p: JDistGCN.apply(p, J, xs, "ring"),
                       jax.tree_util.tree_map(jnp.asarray, narrow))
