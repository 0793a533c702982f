"""CSR row-gather SpMM: ``out[r] = sum_{e in row r} value[e] * x[col[e]]``.

Replaces the JAX package's gather route (``pytorch_sparse_tpu/ops/
kernels/ell.py``: ``ell_spmm`` and ``_bucket_sum``).  The CUDA kernel
(``csrc/csr_spmm.cu``) reads CSR directly with one warp per row and sums
each row in CSR edge order; the ELL padding and degree buckets of the
TPU version are gone.

:func:`csr_spmm` launches the kernel for CUDA tensors and runs
:func:`csr_spmm_plain`, the plain PyTorch version of the same function,
for CPU tensors.  Other devices raise.  ``csr_spmm.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build
from ...utils.convert import INDEX_DTYPE, ptr2ind

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("csr_spmm")
        lib.csr_spmm_f32.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.csr_spmm_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_args(rowptr, col, value, x) -> None:
    if rowptr.dtype != INDEX_DTYPE or col.dtype != INDEX_DTYPE:
        raise TypeError("rowptr and col must be int32")
    if rowptr.dim() != 1 or col.dim() != 1 or x.dim() != 2:
        raise ValueError("expected rowptr (M+1,), col (E,) and x (N, K)")
    if value is not None and value.shape != col.shape:
        raise ValueError("value must have the shape of col")
    devs = {t.device for t in (rowptr, col, value, x) if t is not None}
    if len(devs) != 1:
        raise ValueError("csr_spmm operands lie on different devices")


def csr_spmm_plain(rowptr: torch.Tensor, col: torch.Tensor,
                   value: Optional[torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather ``x[col]``, scale, and
    ``index_add_`` into the rows (in CSR order on the CPU)."""
    _check_args(rowptr, col, value, x)
    M = rowptr.shape[0] - 1
    E = col.shape[0]
    h = x.index_select(0, col)
    if value is not None:
        h = h * value.to(h.dtype)[:, None]
    out = x.new_zeros((M, x.shape[1]))
    return out.index_add_(0, ptr2ind(rowptr, E), h)


def csr_spmm(rowptr: torch.Tensor, col: torch.Tensor,
             value: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``(M, K)`` float32 SpMM of the CSR matrix ``(rowptr, col, value)``
    (``value=None`` means implicit ones) with ``x`` ``(N, K)``.

    CUDA tensors run the hand-written kernel: ``x`` and ``value`` must be
    float32 and ``x`` row-major contiguous.  CPU tensors run
    :func:`csr_spmm_plain`."""
    _check_args(rowptr, col, value, x)
    dev = x.device
    if dev.type == "cpu":
        return csr_spmm_plain(rowptr, col, value, x)
    if dev.type != "cuda":
        raise NotImplementedError(f"csr_spmm has no kernel for {dev.type}")
    if x.dtype != torch.float32 or (
            value is not None and value.dtype != torch.float32):
        raise TypeError("the csr_spmm kernel takes float32 x and value")
    if col.shape[0] >= 2**31:
        raise ValueError("csr_spmm indexes edges with int32")
    for t in (rowptr, col, value, x):
        if t is not None and not t.is_contiguous():
            raise ValueError("csr_spmm operands must be contiguous")
    M, K = rowptr.shape[0] - 1, x.shape[1]
    out = torch.empty((M, K), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    rc = lib.csr_spmm_f32(
        dev.index, rowptr.data_ptr(), col.data_ptr(),
        None if value is None else value.data_ptr(), x.data_ptr(),
        out.data_ptr(), M, K, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "csr_spmm launch")
    csr_spmm.launches += 1
    return out


csr_spmm.launches = 0
