"""Package-level contract of the PyTorch port: what it may import, where
its entry points run, what raises, and how its kernels are built."""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu_torch import _build
from pytorch_sparse_tpu_torch.models import GCN, DistGCN
from pytorch_sparse_tpu_torch.parallel import (
    HierShardedSparseMatrix, make_mesh2d, make_mesh_hier)
from pytorch_sparse_tpu_torch.ops.matmul import spmm
from pytorch_sparse_tpu_torch.testing import community_graph

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "pytorch_sparse_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "pytorch_sparse_tpu"), (
            f"{path.name} imports {mod}")
    text = path.read_text()
    assert "libsparse_tpu_native" not in text
    assert "import_module(\"jax" not in text


def test_port_exports_the_jax_names():
    for name in pts.__all__:
        assert hasattr(pts, name)
        if name not in ("DenseFormat", "build_dense", "dense_spmm",
                        "build_hybrid", "__version__"):
            assert hasattr(jts, name), name


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pts.SparseTensor(row=[0, 1], col=[1, 0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GCN(4, 4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        community_graph(50, 200, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pts.SparseTensor.from_dense(torch.eye(3))
    A = pts.SparseTensor(row=[0, 1], col=[1, 0], device="cpu")
    assert A.device().type == "cpu"


@pytest.fixture
def one_process_group(tmp_path):
    """A gloo group of this process alone (file rendezvous), destroyed
    after the test."""
    import torch.distributed as tdist

    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                             rank=0, world_size=1)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def test_grids_raise_without_cuda(monkeypatch, one_process_group):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_mesh2d, make_mesh_hier):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(1, 1)
        grid = make(1, 1, device="cpu")
        assert grid.device.type == "cpu" and grid.mesh.size == 1
    with pytest.raises(ValueError, match="processes"):
        make_mesh_hier(2, 1, device="cpu")


def test_dist_gcn_rejects_a_flat_schedule_on_the_hier_layout(
        one_process_group):
    """As the JAX package's ``DistGCN.apply``: a hierarchical matrix runs
    its own schedule, and another name raises ``ValueError``."""
    A = pts.SparseTensor(row=[0, 1, 2], col=[1, 2, 0], device="cpu")
    adj = HierShardedSparseMatrix.from_sparse_tensor(
        A, make_mesh_hier(1, 1, device="cpu"))
    model = DistGCN(4, 4, 2, num_layers=2, device="cpu")
    x = adj.shard_dense(torch.randn(3, 4))
    for schedule in ("ring", "halo", "allgather"):
        with pytest.raises(ValueError, match="HierShardedSparseMatrix"):
            model(adj, x, schedule)
    assert model(adj, x, "hier").shape == model(adj, x).shape == (3, 2)


def test_spmm_refuses_grad_inputs():
    """Inputs that require grad are taken, not refused: the value and
    the operand get the JAX package's gradients."""
    import jax
    import jax.numpy as jnp

    from pytorch_sparse_tpu.ops.matmul import spmm as jspmm

    x_np = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    A = pts.SparseTensor(row=[0, 1, 1], col=[1, 0, 1],
                         value=torch.ones(3, requires_grad=True),
                         device="cpu")
    x = torch.from_numpy(x_np).requires_grad_(True)
    pts.spmm_sum(A, x.detach()).sum().backward()  # value requires grad
    B = A.set_value(torch.ones(3), layout="coo")
    pts.spmm_mean(B, x).sum().backward()
    Aj = jts.SparseTensor(row=np.array([0, 1, 1]), col=np.array([1, 0, 1]))
    gv = jax.grad(lambda v: jspmm(Aj.set_value(v, layout="coo"),
                                  jnp.asarray(x_np), "sum").sum())(
        jnp.ones(3))
    gx = jax.grad(lambda xx: jspmm(Aj.set_value(jnp.ones(3), layout="coo"),
                                   xx, "mean").sum())(jnp.asarray(x_np))
    np.testing.assert_allclose(A.storage.value().grad.numpy(),
                               np.asarray(gv), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=1e-6)
    with torch.no_grad():
        assert pts.spmm_sum(A, x).shape == (2, 4)


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_minmax_and_spspmm_not_ported_yet(reduce):
    """min/max return the extreme, and ``A @ A`` the sparse product (both
    ported); SpSpMM has no min/max reduce mode."""
    A = pts.SparseTensor(row=[0, 1, 1], col=[1, 0, 1], device="cpu")
    x = torch.tensor([[1.0, -2.0], [3.0, 4.0]])
    want = {"min": [[3.0, 4.0], [1.0, -2.0]],
            "max": [[3.0, 4.0], [3.0, 4.0]]}[reduce]
    assert torch.equal(spmm(A, x, reduce), torch.tensor(want))
    C = A @ A  # [[0, 1], [1, 1]] squared, with implicit ones
    assert C.sparse_sizes() == (2, 2) and not C.has_value()
    assert C.storage.row().tolist() == [0, 0, 1, 1]
    assert C.storage.col().tolist() == [0, 1, 0, 1]
    W = A.set_value(torch.tensor([1.0, 2.0, 3.0]), layout="coo")
    assert torch.equal((W @ W).to_dense(),
                       W.to_dense() @ W.to_dense())
    with pytest.raises(ValueError, match="reduce mode"):
        pts.matmul(A, A, reduce)


def test_operand_checks():
    A = pts.SparseTensor(row=[0, 1], col=[1, 2], sparse_sizes=(2, 3),
                         device="cpu")
    with pytest.raises(ValueError):
        pts.spmm_sum(A, torch.randn(2, 4))  # wrong row count
    with pytest.raises(ValueError):
        pts.spmm_sum(A, torch.randn(3))     # 1-D operand
    assert torch.equal(A @ torch.eye(3), A.to_dense())


def test_kernel_sources_carry_their_notes():
    for name in _build.SOURCES:
        src = (PORT / "csrc" / f"{name}.cu").read_text()
        # What it replaces: a routine of the JAX package's kernels,
        # samplers or distributed schedules.
        assert re.search(r"pytorch_sparse_tpu/(ops/kernels|sample|parallel)/",
                         src)
        assert "bounds it on an H100" in src
        assert "extern \"C\"" in src and "cudaGetLastError" in src


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_library_name_tracks_the_source():
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert path.parent.name == "build"


def test_build_log_is_empty_before_a_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    assert _build.build_log("csr_spmm") == ""


def test_storage_device_and_repr():
    A = pts.SparseTensor(row=np.array([2, 0]), col=np.array([1, 1]),
                         value=np.array([1.0, 2.0], np.float32), device="cpu")
    assert A.sparse_sizes() == (3, 2)
    assert "device=cpu" in repr(A) and "nnz=2" in repr(A.storage)
    np.testing.assert_array_equal(A.storage.value().numpy(), [2.0, 1.0])
