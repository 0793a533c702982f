"""The typed, temporal, HGT and ego samplers with a card.

These tests need an NVIDIA GPU and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_hetero_sample_gpu.py

The samplers run on the host (the port's host library), so a card's
outputs equal the CPU's bit for bit; they land on ``cuda`` unless the
caller asks for the CPU.  A small typed batch's ``to_hetero`` GraphSAGE
step (the model of ``chip_smoke.py``'s phase 20) runs the CSR kernel and
agrees with the plain version to 1e-5 of max |ref|.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu_torch import _build
from pytorch_sparse_tpu_torch.ops.kernels import csr_spmm, csr_spmm_plain

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no "
                    "CPU mode)")


def _csc(rng, n_dst, n_src, E):
    col = np.sort(rng.randint(0, n_dst, E))
    cp = np.zeros(n_dst + 1, np.int64)
    np.add.at(cp, col + 1, 1)
    return np.cumsum(cp), rng.randint(0, n_src, E).astype(np.int64)


def _typed(seed=0):
    """Three types, five relations (one a type's own), each type the
    destination of one, with years."""
    rng = np.random.RandomState(seed)
    n = {"paper": 3000, "author": 2500, "topic": 200}
    colptr, row = {}, {}
    for s, r, d, E in (("author", "writes", "paper", 9000),
                       ("paper", "rev_writes", "author", 9000),
                       ("paper", "cites", "paper", 12000),
                       ("topic", "rev_has", "paper", 6000),
                       ("paper", "has", "topic", 6000)):
        colptr[f"{s}__{r}__{d}"], row[f"{s}__{r}__{d}"] = _csc(
            rng, n[d], n[s], E)
    years = rng.randint(2010, 2020, n["paper"])
    seeds = rng.choice(n["paper"], 256, replace=False)
    return n, colptr, row, years, seeds


def _calls(device):
    n, colptr, row, years, seeds = _typed()
    rels = list(colptr)
    types = list(n)
    nn = {k: [5, 5] for k in rels}
    kw = {} if device is None else {"device": device}
    return {
        "hetero": pts.hetero_neighbor_sample(
            types, rels, colptr, row, {"paper": seeds}, nn, 2, seed=3, **kw),
        "temporal": pts.hetero_temporal_neighbor_sample(
            types, rels, colptr, row, {"paper": seeds}, nn,
            {"paper": years}, 2, seed=4, **kw),
        "hgt": pts.hgt_sample(colptr, row, {"paper": seeds},
                              {t: [64, 64] for t in types}, 2, seed=5,
                              **kw),
    }


@pytest.mark.gpu
def test_typed_outputs_land_on_the_card_by_default():
    _need_gpu()
    gpu, cpu = _calls(None), _calls("cpu")
    for name in gpu:
        for dg, dc in zip(gpu[name], cpu[name]):
            assert set(dg) == set(dc)
            for k in dg:
                assert dg[k].device.type == "cuda", (name, k)
                assert dc[k].device.type == "cpu", (name, k)
                assert dg[k].dtype == dc[k].dtype == torch.int64
                assert torch.equal(dg[k].cpu(), dc[k]), (name, k)


@pytest.mark.gpu
def test_ego_outputs_follow_the_graph_or_the_device_asked_for():
    _need_gpu()
    rng = np.random.RandomState(1)
    M = 2000
    key = np.unique(rng.randint(0, M, 20000) * M + rng.randint(0, M, 20000))
    val = torch.from_numpy(rng.rand(key.size).astype(np.float32))
    outs = {}
    for dev, ask in (("cuda", None), ("cuda", "cpu"), ("cpu", None)):
        A = pts.SparseTensor(row=key // M, col=key % M, value=val,
                             sparse_sizes=(M, M), device=dev)
        outs[(dev, ask)] = pts.ego_k_hop_sample_adj(
            A, np.arange(0, M, 13), 2, 5, seed=6, device=ask)
    for (dev, ask), (adj, *rest) in outs.items():
        where = ask or dev
        assert adj.storage.col().device.type == where
        assert adj.storage.value().device.type == where
        assert all(t.device.type == where and t.dtype == torch.int64
                   for t in rest)
    ref_adj, *ref = outs[("cpu", None)]
    for adj, *rest in (outs[("cuda", None)], outs[("cuda", "cpu")]):
        assert all(torch.equal(a.cpu(), b) for a, b in zip(rest, ref))
        assert torch.equal(adj.storage.value().cpu(),
                           ref_adj.storage.value())
        assert np.array_equal(adj.storage.numpy_view("col"),
                              ref_adj.storage.numpy_view("col"))


@pytest.mark.gpu
def test_typed_sage_step_on_the_card_equals_the_plain_version():
    """A forward and backward of ``to_hetero`` GraphSAGE (128 -> 32 -> 10) on
    a sampled typed batch: the kernel run's logits, loss and every
    gradient against the plain CSR version with the kernel run's ReLU
    decisions, to 1e-5 of max |ref|."""
    _need_gpu()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import hetero_sage, hetero_sage_forward

    n, colptr, row, _, seeds = _typed(2)
    rels, types = list(colptr), list(n)
    nid, rws, cls, _ = pts.hetero_neighbor_sample(
        types, rels, colptr, row, {"paper": seeds},
        {k: [5, 5] for k in rels}, 2, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(8)
    xs = {t: torch.randn((n[t], 128), device="cuda", generator=gen)[nid[t]]
          for t in types}
    adjs = {}
    for rel in rels:
        s, _, d = rel.split("__")
        adjs[rel] = pts.SparseTensor(row=cls[rel], col=rws[rel],
                                     sparse_sizes=(nid[d].numel(),
                                                   nid[s].numel()))
    y = torch.randint(0, 10, (seeds.size,), device="cuda", generator=gen)

    def plain_mean(adj, h):
        deg = adj.storage.rowcount().clamp_min(1).float()[:, None]
        return csr_spmm_plain(adj.storage.rowptr(), adj.storage.col(), None,
                              h) / deg

    def run(agg, relu):
        m = hetero_sage(torch, rels, (128, 32, 10), 0, "cuda")
        logits = hetero_sage_forward(m, rels, 2, adjs, xs, agg,
                                     relu)["paper"][:seeds.size]
        loss = torch.nn.functional.cross_entropy(logits, y)
        loss.backward()
        return logits.detach(), loss.item(), [
            None if p.grad is None else p.grad for p in m.parameters()]

    masks = []

    def record(h):
        masks.append(h > 0)
        return torch.relu(h)

    before = csr_spmm.launches
    k_logits, k_loss, k_grads = run(
        lambda a, h: pts.matmul(a, h, reduce="mean"), record)
    assert csr_spmm.launches > before
    replay = iter(list(masks))
    p_logits, p_loss, p_grads = run(plain_mean, lambda h: h * next(replay))

    def rel_err(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    assert rel_err(k_logits, p_logits) <= 1e-5
    assert abs(k_loss - p_loss) <= 1e-5 * abs(p_loss)
    for g, q in zip(k_grads, p_grads):
        assert (g is None) == (q is None)
        if g is not None:
            assert rel_err(g, q) <= 1e-5


@pytest.mark.gpu
def test_host_library_builds_from_the_sources(tmp_path, monkeypatch):
    """The sampling library builds from ``csrc/host_sample.cpp`` alone
    into an empty build directory, under a hashed name."""
    _need_gpu()
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    path = _build.build(["host_sample"])["host_sample"]
    assert path.exists() and path.name.startswith("host_sample-")
    assert path.parent == tmp_path / "build"
    _, colptr, row, _, seeds = _typed(3)
    out = pts.hgt_sample(colptr, row, {"paper": seeds}, {"author": [16]}, 1,
                         seed=9)
    assert out[0]["paper"].device.type == "cuda"
