"""The port's training recipes (``pytorch_sparse_tpu_torch.examples``)
against the JAX package's (``examples/train_*.py``) at the tiny sizes of
``tests/test_examples.py``, on the CPU.

Each recipe's graph must equal the JAX recipe's, and from JAX's initial
parameters (carried across by the models' ``from_jax_params``) the loss
of each of its first steps must equal the JAX recipe's step (its own
functions, the JAX package's models and ``optax.adam``) to 1e-5
relative.  The JAX recipes pad to static shapes for ``jit`` (SAGE's
scratch target row, Cluster-GCN's padded blocks and mask); the port's
unpadded hops and parts must give the same mean aggregation and the
same masked loss.  The distributed recipe runs on 3 gloo processes
(``_torch_dist_workers.run_train_gcn``), flat and hierarchical.  Each
``main`` also runs with ``--device cpu`` and prints the JAX recipe's
result phrase.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pytorch_sparse_tpu as jts
from pytorch_sparse_tpu.models import GAT as JGAT
from pytorch_sparse_tpu.models import GCN as JGCN
from pytorch_sparse_tpu.models import GraphSAGE as JSAGE
from pytorch_sparse_tpu_torch.examples import (
    train_cluster_gcn, train_gat, train_gcn, train_sage_minibatch)
from pytorch_sparse_tpu_torch.examples._common import step
from pytorch_sparse_tpu_torch.models import GAT, GCN, GraphSAGE
from pytorch_sparse_tpu_torch.ops.matmul import spmm_mean

import _torch_dist_workers as W

ROOT = pathlib.Path(__file__).resolve().parents[1]
GATE = 1e-5


def _jax_recipe(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_losses(loss_fn, params, lr, batches):
    """The JAX recipes' jitted step (``value_and_grad``, ``optax.adam``)
    over ``batches`` (the argument tuples after ``params``)."""
    opt = optax.adam(lr)

    @jax.jit
    def jstep(params, state, *args):
        loss, grads = jax.value_and_grad(loss_fn)(params, *args)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    state = opt.init(params)
    losses = []
    for args in batches:
        params, state, loss = jstep(params, state, *args)
        losses.append(float(loss))
    return losses


def _assert_losses(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=GATE,
                               atol=0)


def _same_csr(P, J):
    """Equal structure; values (``gcn_norm``'s) within 1e-6."""
    np.testing.assert_array_equal(P.storage.numpy_view("rowptr"),
                                  np.asarray(J.storage.rowptr()))
    np.testing.assert_array_equal(P.storage.numpy_view("col"),
                                  np.asarray(J.storage.col()))
    if J.storage.value() is not None:
        np.testing.assert_allclose(P.storage.value().numpy(),
                                   np.asarray(J.storage.value()), rtol=1e-6,
                                   atol=0)


# ---------------------------------------------------------------------
# GCN, single device and distributed
# ---------------------------------------------------------------------

GCN_ARGV = ["--nodes", "128", "--edges", "600", "--features", "16",
            "--hidden", "8", "--epochs", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def gcn_reference():
    """The JAX recipe's graph, ``GCN.init(PRNGKey(0))`` and the losses of
    its first three steps."""
    J = _jax_recipe("train_gcn")
    args = train_gcn.parse_args(GCN_ARGV)
    adj, x, labels = J.synthetic_graph(args.nodes, args.edges,
                                       args.features, args.classes)
    params = JGCN.init(jax.random.PRNGKey(0), args.features, args.hidden,
                       args.classes)
    losses = _jax_losses(JGCN.loss, params, 1e-2,
                         [(adj, x, labels)] * args.epochs)
    return args, (adj, x, labels), _np_params(params), losses


def test_gcn_steps_equal_the_jax_recipe(gcn_reference):
    args, (jadj, jx, jlabels), params, want = gcn_reference
    adj, x, labels = train_gcn.synthetic_graph(
        args.nodes, args.edges, args.features, args.classes, device="cpu")
    _same_csr(adj, jadj)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    model = GCN.from_jax_params(params, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    _assert_losses([step(model, opt, adj, x, labels).item()
                    for _ in range(args.epochs)], want)


def test_gcn_distributed_recipe_on_three_ranks(gcn_reference):
    """Ring on a flat layout and the hierarchical schedule on (3, 1): each
    rank's losses equal the JAX recipe's single-device steps (the
    distributed loss is the same masked mean), and every rank the
    same."""
    args, _, params, want = gcn_reference
    layers = [(torch.from_numpy(np.array(layer["w"])),
               torch.from_numpy(np.array(layer["b"])))
              for layer in params["layers"]]
    ranks = W.spawn(W.run_train_gcn, 3, "gloo",
                    args=dict(argv=GCN_ARGV + ["--distributed"],
                              layers=layers, slices=(3,)),
                    timeout=300.0, threads=1)
    for sched in ("ring", "hier"):
        _assert_losses(ranks[0][sched]["losses"].numpy(), want)
        for r in ranks[1:]:
            assert torch.equal(r[sched]["losses"], ranks[0][sched]["losses"])
            assert r[sched]["accuracy"] == ranks[0][sched]["accuracy"]


# ---------------------------------------------------------------------
# GAT
# ---------------------------------------------------------------------

def test_gat_steps_equal_the_jax_recipe():
    args = train_gat.parse_args(
        ["--nodes", "200", "--edges", "1200", "--features", "16",
         "--hidden", "8", "--classes", "3", "--heads", "2", "--epochs", "3",
         "--device", "cpu"])
    # The JAX recipe's graph, as its main() builds it.
    rng = np.random.RandomState(0)
    M, E = args.nodes, args.edges
    jadj = jts.SparseTensor(row=rng.randint(0, M, E),
                            col=rng.randint(0, M, E),
                            sparse_sizes=(M, M)).coalesce("add").set_diag()
    jx = jnp.asarray(rng.randn(M, args.features).astype(np.float32))
    jlabels = jnp.asarray(rng.randint(0, args.classes, M).astype(np.int32))
    params = JGAT.init(jax.random.PRNGKey(0), args.features, args.hidden,
                       args.classes, heads=args.heads)

    def loss_fn(params, adj, x, labels):
        logp = jax.nn.log_softmax(JGAT.apply(params, adj, x), axis=-1)
        return -jnp.take_along_axis(logp, labels[:, None], axis=-1).mean()

    want = _jax_losses(loss_fn, params, 5e-3,
                       [(jadj, jx, jlabels)] * args.epochs)
    adj, x, labels = train_gat.synthetic_graph(
        M, E, args.features, args.classes, device="cpu")
    _same_csr(adj, jadj)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    model = GAT.from_jax_params(_np_params(params), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    _assert_losses([step(model, opt, adj, x, labels).item()
                    for _ in range(args.epochs)], want)


# ---------------------------------------------------------------------
# Mini-batch GraphSAGE
# ---------------------------------------------------------------------

SAGE_ARGV = ["--steps", "3", "--nodes", "400", "--edges", "3000",
             "--features", "16", "--hidden", "8", "--batch", "32",
             "--fanouts", "4", "3", "--device", "cpu"]


def test_sage_batches_and_steps_equal_the_jax_recipe():
    """The JAX recipe's batches (``sample_adj`` per hop, its seeds) equal
    the port's hop for hop; its padded batches (scratch target row,
    padded node lists) give the port's unpadded mean aggregation and
    loss; and the steps' losses agree."""
    J = _jax_recipe("train_sage_minibatch")
    args = train_sage_minibatch.parse_args(SAGE_ARGV)
    M, E = args.nodes, args.edges
    # The JAX recipe's graph and batches, as its main() builds them.
    rng = np.random.RandomState(0)
    jA = jts.SparseTensor(
        row=jnp.asarray(rng.randint(0, M, E).astype(np.int32)),
        col=jnp.asarray(rng.randint(0, M, E).astype(np.int32)),
        sparse_sizes=(M, M)).coalesce("add")
    jfeats = rng.randn(M, args.features).astype(np.float32)
    jlabels = rng.randint(0, args.classes, M).astype(np.int32)
    A, feats, labels = train_sage_minibatch.synthetic_graph(
        M, E, args.features, args.classes, device="cpu")
    _same_csr(A.set_value(None), jA)
    np.testing.assert_array_equal(feats.numpy(), jfeats)
    params = JSAGE.init(jax.random.PRNGKey(0), args.features, args.hidden,
                        args.classes, num_layers=len(args.fanouts))
    model = GraphSAGE.from_jax_params(_np_params(params), device="cpu")
    probe = GraphSAGE.from_jax_params(_np_params(params), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    jbatches, got = [], []
    for it in range(args.steps):
        brng = np.random.RandomState(100_000 + it)
        targets = jnp.asarray(brng.choice(M, args.batch, replace=False)
                              .astype(np.int64))
        hops, frontier = [], targets
        for h, k in enumerate(args.fanouts):
            adj, n_id = jts.sample_adj(jA, frontier, k, replace=False,
                                       seed=1000 + it * 10 + h)
            hops.append((adj, n_id))
            frontier = n_id
        batch = train_sage_minibatch.make_batch(
            A, feats, labels, args.batch, args.fanouts, it)
        np.testing.assert_array_equal(batch["targets"], np.asarray(targets))
        for (jadj, jn), pn, padj, e_id in zip(hops, batch["n_id"],
                                              batch["adjs"], batch["e_id"]):
            np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
            _same_csr(padj, jadj)
            np.testing.assert_array_equal(  # the sampled edges' ids
                A.storage.numpy_view("col")[e_id.numpy()],
                pn.numpy()[padj.storage.numpy_view("col")])
        padded = J.pad_batch(hops, args.batch, args.fanouts)
        x_src = jnp.asarray(jfeats[np.asarray(padded[-1][1])])
        y = jnp.asarray(jlabels[np.asarray(targets)])
        # Padded and unpadded: the same mean over every hop's exact rows.
        for (jP, _), padj, pn in zip(padded, batch["adjs"], batch["n_id"]):
            xs = jfeats[pn.numpy()]
            n_src = xs.shape[0]
            xpad = np.zeros((jP.sparse_size(1), xs.shape[1]), np.float32)
            xpad[:n_src] = xs
            want_mean = np.asarray(jP.spmm(jnp.asarray(xpad), "mean"))[
                :padj.sparse_size(0)]
            np.testing.assert_allclose(
                spmm_mean(padj, torch.from_numpy(xs)).numpy(), want_mean,
                rtol=1e-6, atol=1e-7)
        with torch.no_grad():
            logits = train_sage_minibatch.sage_forward(probe, batch["adjs"],
                                                       batch["x"])
        np.testing.assert_allclose(
            logits.numpy(),
            np.asarray(J.sage_bipartite_apply(params, padded, x_src)),
            rtol=1e-5, atol=1e-6)
        jbatches.append((padded, x_src, y))
        got.append(train_sage_minibatch.step(model, opt, batch).item())

    def loss_fn(params, padded, x_src, y):
        logits = J.sage_bipartite_apply(params, padded, x_src)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    _assert_losses(got, _jax_losses(loss_fn, params, 1e-3, jbatches))


def test_sage_main_batches_at_0_and_4_workers(capsys):
    """``main`` synchronously and with ``--workers 4``: the same batches
    (targets, and each hop's ``n_id``, ``e_id`` and ``rowptr``) and the
    same losses, and the JAX recipe's result phrase."""
    sync = train_sage_minibatch.main(SAGE_ARGV)
    pre = train_sage_minibatch.main(SAGE_ARGV + ["--workers", "4"])
    assert capsys.readouterr().out.count("minibatch SAGE") == 2
    assert sync["losses"] == pre["losses"]
    for a, b in zip(sync["batches"], pre["batches"]):
        assert np.array_equal(a["targets"], b["targets"])
        for key in ("n_id", "e_id", "rowptr"):
            for x, y in zip(a[key], b[key]):
                assert np.array_equal(np.asarray(x), np.asarray(y))
    assert 0.0 <= sync["accuracy"] <= 1.0


# ---------------------------------------------------------------------
# Cluster-GCN
# ---------------------------------------------------------------------

def test_cluster_gcn_partition_and_steps_equal_the_jax_recipe():
    """The same partition (``partptr``, ``perm``), each part's block equal
    to the real rows of the JAX recipe's padded block, and the losses of
    the first three part steps: the port's unpadded parts against JAX's
    padded, masked ones."""
    J = _jax_recipe("train_cluster_gcn")
    args = train_cluster_gcn.parse_args(
        ["--nodes", "300", "--edges", "2400", "--features", "16",
         "--hidden", "8", "--classes", "4", "--parts", "4", "--epochs", "1",
         "--device", "cpu"])
    n_comm = args.parts * 4
    jadj, jx, jlabels = J.synthetic_community_graph(
        args.nodes, args.edges, args.features, args.classes, n_comm)
    adj, x, labels = train_cluster_gcn.synthetic_community_graph(
        args.nodes, args.edges, args.features, args.classes, n_comm,
        device="cpu")
    _same_csr(adj, jadj)
    np.testing.assert_array_equal(x, jx)
    _, jpp, jperm = jadj.partition(args.parts)
    jbatches = J.cluster_batches(jadj, jx, jlabels, args.parts)
    batches, pp, perm = train_cluster_gcn.cluster_batches(adj, x, labels,
                                                          args.parts)
    np.testing.assert_array_equal(pp, np.asarray(jpp))
    np.testing.assert_array_equal(perm, np.asarray(jperm))
    for (blk, xb, yb), (jblk, jxb, jyb, jmask) in zip(batches, jbatches):
        n = blk.sparse_size(0)
        assert int(np.asarray(jmask).sum()) == n
        jrp = np.asarray(jblk.storage.rowptr())[:n + 1]
        np.testing.assert_array_equal(blk.storage.numpy_view("rowptr"), jrp)
        np.testing.assert_array_equal(blk.storage.numpy_view("col"),
                                      np.asarray(jblk.storage.col())[
                                          :jrp[-1]])
        np.testing.assert_allclose(blk.storage.value().numpy(),
                                   np.asarray(jblk.storage.value())[
                                       :jrp[-1]], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(xb.numpy(), np.asarray(jxb)[:n])
        np.testing.assert_array_equal(yb.numpy(), np.asarray(jyb)[:n])
    params = JGCN.init(jax.random.PRNGKey(0), args.features, args.hidden,
                       args.classes)
    # The padded blocks without their prebuilt ELL views (the same
    # matrices; compiling the step over those views takes 10 s more).
    want = _jax_losses(JGCN.loss, params, 1e-2, [
        (jts.SparseTensor(rowptr=b.storage.rowptr(), col=b.storage.col(),
                          value=b.storage.value(),
                          sparse_sizes=b.sparse_sizes(), is_sorted=True,
                          trust_data=True), *rest)
        for b, *rest in jbatches[:3]])
    model = GCN.from_jax_params(_np_params(params), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    _assert_losses([step(model, opt, *b).item() for b in batches[:3]], want)


# ---------------------------------------------------------------------
# The entry points on the CPU
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name,argv,phrase", [
    ("train_gcn", GCN_ARGV, "loss="),
    ("train_gat", ["--epochs", "3", "--nodes", "200", "--edges", "1200",
                   "--features", "16", "--hidden", "8", "--classes", "3",
                   "--heads", "2", "--device", "cpu"], "train accuracy"),
    ("train_cluster_gcn", ["--epochs", "2", "--nodes", "300", "--edges",
                           "2400", "--features", "16", "--hidden", "8",
                           "--classes", "4", "--parts", "4", "--device",
                           "cpu"], "full-graph train accuracy"),
])
def test_main_runs_on_the_cpu(name, argv, phrase, capsys):
    """``main(argv)`` trains with the recipe's own weights, prints the JAX
    recipe's phrase and returns the loss of each step, the accuracy and
    the ms a step, every loss finite."""
    mod = {"train_gcn": train_gcn, "train_gat": train_gat,
           "train_cluster_gcn": train_cluster_gcn}[name]
    res = mod.main(argv)
    assert phrase in capsys.readouterr().out
    assert res["losses"] and np.isfinite(res["losses"]).all()
    assert 0.0 <= res["accuracy"] <= 1.0 and res["ms_per_step"] > 0
    assert res["device"] == "cpu"


def test_the_recipes_run_on_the_card_unless_asked():
    """``--device`` defaults to ``cuda``, which raises without a card
    rather than training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for mod in (train_gcn, train_gat, train_sage_minibatch,
                train_cluster_gcn):
        assert mod.parse_args([]).device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(["--epochs", "1"] if mod is not train_sage_minibatch
                     else ["--steps", "1"])
