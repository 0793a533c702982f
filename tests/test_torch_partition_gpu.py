"""The partitioner, ``save_npz``/``load_npz`` and the profiler hooks on
the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip without them; they
import neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_partition_gpu.py

The partitioner runs on the host, so a CUDA tensor's partition equals
the CPU's bit for bit, with every output on the card.  A routed view
saved from the card serves the same bits after the load (the block and
CSR kernels run on it), and a trace of a product holds the card's
kernel events.
"""

import json
import os

import numpy as np
import pytest
import torch

import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu_torch.ops.kernels import csr_spmm
from pytorch_sparse_tpu_torch.ops.kernels import hybrid as phybrid
from pytorch_sparse_tpu_torch.utils import annotate, trace


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no "
                    "CPU mode)")


def _community(dev, seed=0, M=4096, E=60_000, n_comm=48, value=True):
    rng = np.random.RandomState(seed)
    comm = rng.randint(0, n_comm, M)
    src, dst = rng.randint(0, M, E), rng.randint(0, M, E)
    intra = rng.rand(E) < 0.85
    for c in range(n_comm):
        members = np.flatnonzero(comm == c)
        sel = intra & (comm[src] == c)
        dst[sel] = members[rng.randint(0, members.size, int(sel.sum()))]
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    v = torch.from_numpy(rng.rand(src.size).astype(np.float32) + 0.1)
    return pts.SparseTensor(row=src, col=dst, value=v if value else None,
                            sparse_sizes=(M, M), device=dev).coalesce("add")


def _equal(gpu_out, cpu_out):
    (ga, gpp, gperm), (ca, cpp, cperm) = gpu_out, cpu_out
    for t in (gpp, gperm, ga.storage.col(), ga.storage.rowptr()):
        assert t.device.type == "cuda"
    assert torch.equal(gpp.cpu(), cpp) and torch.equal(gperm.cpu(), cperm)
    for view in ("row", "col"):
        assert np.array_equal(ga.storage.numpy_view(view),
                              ca.storage.numpy_view(view))
    gv, cv = ga.storage.value(), ca.storage.value()
    assert (gv is None) == (cv is None)
    if gv is not None:
        assert gv.device.type == "cuda" and torch.equal(gv.cpu(), cv)


@pytest.mark.gpu
@pytest.mark.parametrize("call", [
    dict(fn="partition", num_parts=8),
    dict(fn="partition", num_parts=4, weighted=True),
    dict(fn="partition_fine", num_parts=4, fine_parts=64),
    dict(fn="partition_fine", num_parts=4, fine_parts=300),
    dict(fn="partition_fine", num_parts=8, fine_parts=256,
         grouping="within"),
])
def test_partition_of_a_cuda_tensor_equals_the_cpu(call):
    _need_gpu()
    kw = dict(call)
    fn = getattr(pts, kw.pop("fn"))
    A_gpu = _community("cuda")
    A_cpu = _community("cpu")
    _equal(fn(A_gpu, **kw), fn(A_cpu, **kw))


@pytest.mark.gpu
def test_partitioned_blocks_train_like_the_cpu():
    """A Cluster-GCN step on one part of a CUDA partition: the diagonal
    block, ``gcn_norm`` and ``spmm_sum`` on the card agree with the CPU's
    to 1e-5 of max |ref|."""
    _need_gpu()
    from pytorch_sparse_tpu_torch.models import gcn_norm

    outs = {}
    for dev in ("cuda", "cpu"):
        padj, pp, perm = pts.partition(_community(dev, value=False), 4)
        lo, hi = int(pp[1]), int(pp[2])
        blk = gcn_norm(padj.narrow(0, lo, hi - lo).narrow(1, lo, hi - lo))
        x = torch.from_numpy(np.random.RandomState(1).randn(
            hi - lo, 100).astype(np.float32)).to(dev)
        outs[dev] = pts.spmm_sum(blk, x).cpu()
    ref = outs["cpu"]
    assert (outs["cuda"] - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("store", [None, torch.bfloat16])
def test_saved_hybrid_view_serves_the_same_bits_on_the_card(tmp_path, store):
    _need_gpu()
    A = _community("cuda")
    padj, pp, _ = pts.partition_fine(A, 4, fine_parts=64, grouping="within")
    h = phybrid.build_hybrid_from_tensor(padj, B=64, min_density=0.05,
                                         block_dtype=store)
    assert h.nb > 0
    padj.storage.set_hybrid_(h)
    x = torch.randn(padj.size(0), 128, device="cuda")
    want = pts.spmm_sum(padj, x)
    path = str(tmp_path / "h.npz")
    pts.save_npz(path, padj)
    B = pts.load_npz(path)
    h2 = B.storage.hybrid(auto=False)
    assert h2.blocks.device.type == "cuda"
    assert torch.equal(pts.spmm_sum(B, x), want)
    assert B.storage.hybrid(auto=False) is h2
    xa = x.clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    pts.spmm_sum(padj, xa).sum().backward()
    pts.spmm_sum(B, xb).sum().backward()
    assert torch.equal(xa.grad, xb.grad)


@pytest.mark.gpu
def test_trace_records_the_cards_kernels(tmp_path):
    _need_gpu()
    A = _community("cuda")
    x = torch.randn(A.size(0), 64, device="cuda")
    pts.spmm_sum(A, x)  # built and warmed outside the trace
    before = csr_spmm.launches
    with trace(str(tmp_path)):
        with annotate("partition-gpu-spmm"):
            pts.spmm_sum(A.set_value(A.storage.value(), layout="coo"), x)
    assert csr_spmm.launches > before
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "partition-gpu-spmm" for e in events)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels, "the trace holds no kernel event"
