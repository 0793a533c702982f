"""torch-style dtype, device, memory and autograd methods and the
``torch.sparse`` conversions (counterpart of
``pytorch_sparse_tpu/ops/torch_compat.py``; reference
``torch_sparse/tensor.py`` and ``storage.py``).

Casts change the value's dtype (indices stay int32); ``cpu``, ``cuda``
and ``to`` move every tensor of the storage; ``detach`` and
``requires_grad_`` act on the value; ``pin_memory``, ``is_pinned``,
``share_memory_`` and ``is_shared`` call the tensor method of the same
name on each tensor the storage holds (where the JAX package, which has
no such notion, returns ``self`` or ``False``).  The ``torch.sparse``
conversions keep the matrix's device.
"""

from __future__ import annotations

import torch

from ..storage import SparseStorage
from ..tensor import SparseTensor
from ..typing import DeviceLike, input_device, resolve_device

# ----------------------------------------------------------------------
# dtype casts
# ----------------------------------------------------------------------

_CASTS = {
    "float": torch.float32,
    "double": torch.float64,
    "half": torch.float16,
    "bfloat16": torch.bfloat16,
    "int": torch.int32,
    "long": torch.int64,
    "short": torch.int16,
    "byte": torch.uint8,
    "char": torch.int8,
    "bool": torch.bool,
}


def _make_cast(dtype):
    def cast(self: SparseTensor) -> SparseTensor:
        return type(self, dtype)

    return cast


for _name, _dtype in _CASTS.items():
    setattr(SparseTensor, _name, _make_cast(_dtype))


def is_floating_point(self: SparseTensor) -> bool:
    value = self.storage.value()
    return value is not None and value.is_floating_point()


def type(self: SparseTensor, dtype=None, non_blocking: bool = False):
    """The value's dtype without ``dtype``, else the tensor cast to it."""
    if dtype is None:
        return self.dtype()
    value = self.storage.value()
    if value is None or value.dtype == dtype:
        return self
    return self.from_storage(self.storage.astype_value(dtype))


def type_as(self: SparseTensor, other) -> SparseTensor:
    dtype = getattr(other, "dtype", None)
    return type(self, dtype() if callable(dtype) else dtype)


SparseTensor.is_floating_point = is_floating_point
SparseTensor.type = type
SparseTensor.type_as = type_as


# ----------------------------------------------------------------------
# device moves
# ----------------------------------------------------------------------

def _other_device(other) -> torch.device:
    dev = getattr(other, "device", None)
    return dev() if callable(dev) else dev


def cpu(self: SparseTensor) -> SparseTensor:
    return self.to_device("cpu")


def cuda(self: SparseTensor, device: DeviceLike = None,
         non_blocking: bool = False) -> SparseTensor:
    return self.to_device(resolve_device(device or "cuda"))


def device_as(self: SparseTensor, other,
              non_blocking: bool = False) -> SparseTensor:
    return self.to_device(_other_device(other))


def is_cuda(self: SparseTensor) -> bool:
    return self.device().type == "cuda"


def to(self: SparseTensor, *args, **kwargs) -> SparseTensor:
    """Cast and/or move, torch-style: a ``torch.dtype`` casts the value,
    a device (or its name) moves the tensors."""
    out = self
    for arg in list(args) + list(kwargs.values()):
        if isinstance(arg, torch.dtype):
            out = type(out, arg)
        elif isinstance(arg, (torch.device, str)):
            out = out.to_device(arg)
        elif arg not in (None, True, False):
            raise TypeError(f"cannot move or cast to {arg!r}")
    return out


SparseTensor.cpu = cpu
SparseTensor.cuda = cuda
SparseTensor.device_as = device_as
SparseTensor.is_cuda = property(is_cuda)
SparseTensor.to = to


# ----------------------------------------------------------------------
# pinned and shared memory: the tensor methods on every tensor held
# ----------------------------------------------------------------------

def _tensors(st: SparseStorage):
    return [t for t in (st._row, st._rowptr, st._col, st._value,
                        st._rowcount, st._colptr, st._colcount, st._csr2csc,
                        st._csc2csr, st._csc_row) if t is not None]


def _st_pin_memory(self: SparseStorage) -> SparseStorage:
    return self.apply(lambda t: t.pin_memory())


def _st_is_pinned(self: SparseStorage) -> bool:
    return all(t.is_pinned() for t in _tensors(self))


def _st_share_memory_(self: SparseStorage) -> SparseStorage:
    for t in _tensors(self):
        t.share_memory_()
    return self


def _st_is_shared(self: SparseStorage) -> bool:
    return all(t.is_shared() for t in _tensors(self))


SparseStorage.pin_memory = _st_pin_memory
SparseStorage.is_pinned = _st_is_pinned
SparseStorage.share_memory_ = _st_share_memory_
SparseStorage.is_shared = _st_is_shared
SparseTensor.pin_memory = lambda self: self.from_storage(
    self.storage.pin_memory())
SparseTensor.is_pinned = lambda self: self.storage.is_pinned()


def share_memory_(self: SparseTensor) -> SparseTensor:
    self.storage.share_memory_()
    return self


SparseTensor.share_memory_ = share_memory_
SparseTensor.is_shared = lambda self: self.storage.is_shared()


# ----------------------------------------------------------------------
# autograd handles
# ----------------------------------------------------------------------

def detach(self: SparseTensor) -> SparseTensor:
    value = self.storage.value()
    if value is None:
        return self
    return self.set_value(value.detach(), layout="coo")


def requires_grad_(self: SparseTensor, requires_grad: bool = True,
                   dtype=None) -> SparseTensor:
    """Set the value's ``requires_grad`` in place (a tensor without a
    value has nothing to track)."""
    value = self.storage.value()
    if value is not None:
        value.requires_grad_(requires_grad)
    return self


SparseTensor.detach = detach
SparseTensor.detach_ = detach
SparseTensor.requires_grad_ = requires_grad_


# ----------------------------------------------------------------------
# structure metrics
# ----------------------------------------------------------------------

def avg_bandwidth(self: SparseTensor) -> float:
    """The mean ``|row - col|`` of the nonzeros."""
    return float(self._offsets().mean()) if self.nnz() else 0.0


SparseTensor.avg_bandwidth = avg_bandwidth


# ----------------------------------------------------------------------
# torch.sparse interop, on the matrix's device
# ----------------------------------------------------------------------

def _value_or_ones(self: SparseTensor, n: int, dtype) -> torch.Tensor:
    value = self.storage.value()
    if value is None:
        value = torch.ones(n, dtype=dtype or torch.float32,
                           device=self.device())
    return value


def to_torch_sparse_coo_tensor(self: SparseTensor, dtype=None
                               ) -> torch.Tensor:
    row, col, _ = self.coo()
    value = _value_or_ones(self, self.nnz(), dtype)
    return torch.sparse_coo_tensor(
        torch.stack([row, col]).long(), value,
        self.sparse_sizes() + tuple(value.shape[1:]))


def to_torch_sparse_csr_tensor(self: SparseTensor, dtype=None
                               ) -> torch.Tensor:
    rowptr, col, _ = self.csr()
    value = _value_or_ones(self, self.nnz(), dtype)
    return torch.sparse_csr_tensor(rowptr.long(), col.long(), value,
                                   self.sparse_sizes())


def to_torch_sparse_csc_tensor(self: SparseTensor, dtype=None
                               ) -> torch.Tensor:
    colptr, row, value = self.csc()
    if value is None:
        value = _value_or_ones(self, self.nnz(), dtype)
    return torch.sparse_csc_tensor(colptr.long(), row.long(), value,
                                   self.sparse_sizes())


def from_torch_sparse_coo_tensor(mat: torch.Tensor, has_value: bool = True,
                                 device: DeviceLike = None) -> SparseTensor:
    """From a ``torch.sparse_coo_tensor`` (coalesced first), on its device
    unless ``device`` is given."""
    mat = mat.coalesce()
    index = mat.indices()
    return SparseTensor(row=index[0], col=index[1],
                        value=mat.values() if has_value else None,
                        sparse_sizes=(mat.size(0), mat.size(1)),
                        device=input_device(mat, device))


def from_torch_sparse_csr_tensor(mat: torch.Tensor, has_value: bool = True,
                                 device: DeviceLike = None) -> SparseTensor:
    """From a ``torch.sparse_csr_tensor`` (taken as sorted), on its device
    unless ``device`` is given."""
    return SparseTensor(rowptr=mat.crow_indices(), col=mat.col_indices(),
                        value=mat.values() if has_value else None,
                        sparse_sizes=(mat.size(0), mat.size(1)),
                        is_sorted=True, trust_data=True,
                        device=input_device(mat, device))


SparseTensor.to_torch_sparse_coo_tensor = to_torch_sparse_coo_tensor
SparseTensor.to_torch_sparse_csr_tensor = to_torch_sparse_csr_tensor
SparseTensor.to_torch_sparse_csc_tensor = to_torch_sparse_csc_tensor
SparseTensor.from_torch_sparse_coo_tensor = staticmethod(
    from_torch_sparse_coo_tensor)
SparseTensor.from_torch_sparse_csr_tensor = staticmethod(
    from_torch_sparse_csr_tensor)


# ----------------------------------------------------------------------
# SparseStorage counterparts
# ----------------------------------------------------------------------

def _st_cuda(self: SparseStorage, device: DeviceLike = None,
             non_blocking: bool = False) -> SparseStorage:
    return self.to_device(resolve_device(device or "cuda"))


def _st_type(self: SparseStorage, dtype=None, non_blocking: bool = False):
    if dtype is None:
        value = self.value()
        return None if value is None else value.dtype
    return self.astype_value(dtype)


def _st_type_as(self: SparseStorage, other) -> SparseStorage:
    value = other.value() if hasattr(other, "value") else None
    return self if value is None else self.astype_value(value.dtype)


def _st_device_as(self: SparseStorage, other,
                  non_blocking: bool = False) -> SparseStorage:
    return self.to_device(_other_device(other))


SparseStorage.cuda = _st_cuda
SparseStorage.type = _st_type
SparseStorage.type_as = _st_type_as
SparseStorage.device_as = _st_device_as
