"""The port's torch-style methods (``ops/torch_compat.py``): dtype casts,
device moves, pinned and shared memory, ``detach``/``requires_grad_``,
``avg_bandwidth`` and the ``torch.sparse`` conversions, with the cases of
the JAX package's ``tests/test_torch_compat.py`` and against the JAX
package on the same seeded inputs (CPU); values exactly, the mean
bandwidth to 1e-6."""

import numpy as np
import pytest
import torch

import _torch_parity as T
import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts


def _pair(seed=0):
    return T.pair(seed, M=20, N=20, E=60)


def test_dtype_casts():
    J, P = _pair()
    for name, want in (("double", torch.float64), ("bfloat16", torch.bfloat16),
                       ("half", torch.float16), ("int", torch.int32),
                       ("float", torch.float32), ("long", torch.int64),
                       ("short", torch.int16), ("byte", torch.uint8),
                       ("char", torch.int8), ("bool", torch.bool)):
        assert getattr(P, name)().dtype() == want, name
    T.assert_values(J.half().storage.value(), P.half().storage.value())
    assert P.is_floating_point() and not P.int().is_floating_point()
    assert not P.set_value(None).is_floating_point()
    assert P.type_as(P.bfloat16()).dtype() == torch.bfloat16
    assert P.type_as(torch.zeros(1, dtype=torch.float16)).dtype() \
        == torch.float16
    assert P.type() == torch.float32 and P.float() is P
    assert P.storage.type() == torch.float32
    assert P.storage.type(torch.float16).value().dtype == torch.float16
    assert P.storage.type_as(P.half().storage).value().dtype == torch.float16


def test_device_and_memory_api(monkeypatch):
    _, P = _pair()
    P.fill_cache_()
    B = P.cpu()
    assert B.device().type == "cpu" and not B.is_cuda
    assert B.storage.cached_keys() == P.storage.cached_keys()
    assert P.to(torch.bfloat16).dtype() == torch.bfloat16
    C = P.to("cpu", torch.float16)
    assert C.dtype() == torch.float16 and C.device().type == "cpu"
    assert P.to(device="cpu", dtype=torch.float64).dtype() == torch.float64
    assert P.device_as(torch.zeros(1)).device().type == "cpu"
    assert P.storage.device_as(P).device.type == "cpu"
    with pytest.raises(TypeError):
        P.to(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.storage.cuda()


def test_pinned_and_shared_memory_call_the_tensor_methods():
    _, P = _pair()
    P.fill_cache_()
    assert not P.is_pinned() and not P.storage.is_pinned()
    if torch.cuda.is_available():
        pinned = P.pin_memory()
        assert pinned.is_pinned() and pinned == P
    else:  # pinning needs the CUDA runtime
        with pytest.raises(RuntimeError):
            P.pin_memory()
    assert not P.is_shared()
    assert P.share_memory_() is P and P.is_shared()
    assert P.storage.is_shared()


def test_detach_and_requires_grad():
    J, P = _pair()
    v = P.storage.value().clone().requires_grad_(True)
    A = P.set_value(v, layout="coo")
    D = A.detach()
    assert not D.requires_grad() and A.requires_grad()
    T.assert_values(J.detach().storage.value(), D.storage.value())
    assert A.detach_().storage.value().requires_grad is False
    B = P.requires_grad_()
    assert B is P and P.requires_grad()
    assert P.requires_grad_(False) is P and not P.requires_grad()
    N = P.set_value(None)
    assert N.requires_grad_() is N and not N.requires_grad()


def test_avg_bandwidth():
    J, P = _pair()
    assert P.avg_bandwidth() == pytest.approx(J.avg_bandwidth(), rel=1e-6)
    row, col, _ = P.coo()
    assert P.avg_bandwidth() == pytest.approx(
        float((row - col).abs().double().mean()))
    assert pts.SparseTensor.eye(3, device="cpu").avg_bandwidth() == 0.0


@pytest.mark.parametrize("has_value", [True, False])
def test_torch_sparse_roundtrip(has_value):
    """The JAX package's ``test_torch_sparse_roundtrip``, here against
    its exports on the same values, and back through the port."""
    J, P = T.pair(1, M=20, N=20, E=60, has_value=has_value)
    dense = P.to_dense()
    for name in ("coo", "csr", "csc"):
        got = getattr(P, f"to_torch_sparse_{name}_tensor")()
        want = getattr(J, f"to_torch_sparse_{name}_tensor")()
        assert got.layout == want.layout
        assert torch.equal(got.to_dense(), want.to_dense())
        assert torch.equal(got.to_dense(), dense)
    B = pts.SparseTensor.from_torch_sparse_coo_tensor(
        P.to_torch_sparse_coo_tensor())
    C = pts.SparseTensor.from_torch_sparse_csr_tensor(
        P.to_torch_sparse_csr_tensor())
    JB = jts.SparseTensor.from_torch_sparse_coo_tensor(
        J.to_torch_sparse_coo_tensor())
    T.assert_same(JB, B)
    assert B.device().type == C.device().type == "cpu"
    assert torch.equal(B.to_dense(), P.to_dense(torch.float32))
    assert torch.equal(C.to_dense(), P.to_dense(torch.float32))
    assert C.set_value(None) == P.set_value(None)
    x = torch.from_numpy(np.random.RandomState(2).randn(20, 8).astype(
        np.float32))
    torch.testing.assert_close(P.to_torch_sparse_csr_tensor() @ x,
                               P.to_dense(torch.float32) @ x)
    assert P.to_torch_sparse_coo_tensor(dtype=torch.float64).dtype == (
        torch.float32 if has_value else torch.float64)


def test_from_torch_sparse_resolves_the_device(monkeypatch):
    A = torch.eye(3).to_sparse()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pts.SparseTensor.from_torch_sparse_coo_tensor(A).device().type \
        == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pts.SparseTensor.from_torch_sparse_coo_tensor(A, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pts.SparseTensor.from_torch_sparse_csr_tensor(
            A.to_sparse_csr(), device="cuda")
