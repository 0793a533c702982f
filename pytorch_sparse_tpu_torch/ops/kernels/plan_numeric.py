"""Segmented product sum over a SpGEMM plan:
``out[s] = sum_{t in [t_ptr[s], t_ptr[s+1])} x[i[t]] * y[j[t]]``.

This is the numeric pass of SpSpMM.  It replaces the JAX package's
``pytorch_sparse_tpu/ops/matmul.py: _plan_numeric``, which sums each
output entry's terms through term-count bucket tables (``t_tabs``/
``inv``) to keep XLA on the TPU scatter-free.  The structure pass sorts
the terms by (row, col), so each output entry's terms are one
contiguous run, and the port keeps a term pointer ``t_ptr`` instead.
The CUDA kernel (``csrc/plan_numeric.cu``) gives each output entry to
one thread, which adds its products in term order in float32.

The same function serves the forward (``x = valueA``, ``i = a_pos``,
``y = valueB``, ``j = b_pos``) and both value gradients (the terms
re-sorted by ``a_pos`` or ``b_pos``, with ``x = grad_C`` gathered
through each term's output entry).  ``y=None`` means implicit ones.

Products and sums run in float32 (float64 on the CPU for float64
operands), in term order; the result has the promoted dtype of ``x``
and ``y``.  :func:`plan_numeric` launches the kernel for CUDA tensors
and runs :func:`plan_numeric_plain`, the plain PyTorch version, for CPU
tensors.  Other devices raise.  ``plan_numeric.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build
from ...segment import segment_sum
from ...utils.convert import INDEX_DTYPE, ptr2ind

_lib = None
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("plan_numeric")
        lib.plan_numeric.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.plan_numeric.restype = ctypes.c_int
        _lib = lib
    return _lib


def out_dtype(x: torch.Tensor, y: Optional[torch.Tensor]) -> torch.dtype:
    """The result dtype: ``x``'s, promoted with ``y``'s when given."""
    return x.dtype if y is None else torch.promote_types(x.dtype, y.dtype)


def _check_args(x, i, y, j, t_ptr) -> None:
    if x.dim() != 1 or i.dim() != 1 or t_ptr.dim() != 1:
        raise ValueError("expected x (nx,), i (T,) and t_ptr (n_out+1,)")
    if i.dtype != INDEX_DTYPE or t_ptr.dtype != INDEX_DTYPE:
        raise TypeError("i and t_ptr must be int32")
    if t_ptr.shape[0] < 1:
        raise ValueError("t_ptr needs at least one entry")
    if y is not None:
        if y.dim() != 1 or j is None or j.shape != i.shape:
            raise ValueError("y must be 1-D and j must have the shape of i")
        if j.dtype != INDEX_DTYPE:
            raise TypeError("j must be int32")
    devs = {t.device for t in (x, i, y, j, t_ptr) if t is not None}
    if len(devs) != 1:
        raise ValueError("plan_numeric operands lie on different devices")


def plan_numeric_plain(x: torch.Tensor, i: torch.Tensor,
                       y: Optional[torch.Tensor], j: Optional[torch.Tensor],
                       t_ptr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``index_select`` the two factors of every
    term, multiply in float32 (float64 for float64 operands), and
    ``segment_sum`` the terms into their output entries."""
    _check_args(x, i, y, j, t_ptr)
    dt = out_dtype(x, y)
    acc = torch.promote_types(dt, torch.float32)
    terms = x.index_select(0, i).to(acc)
    if y is not None:
        terms = terms * y.index_select(0, j).to(acc)
    n_out = t_ptr.shape[0] - 1
    seg = ptr2ind(t_ptr, i.shape[0])
    return segment_sum(terms, seg, n_out).to(dt)


def plan_numeric(x: torch.Tensor, i: torch.Tensor,
                 y: Optional[torch.Tensor], j: Optional[torch.Tensor],
                 t_ptr: torch.Tensor) -> torch.Tensor:
    """``(n_out,)`` segmented sum of ``x[i[t]] * y[j[t]]`` over the term
    runs of ``t_ptr`` (``y=None``: implicit ones, ``j`` unused), in the
    promoted dtype of ``x`` and ``y``.

    CUDA tensors run the hand-written kernel: the promoted dtype must be
    float32, float16 or bfloat16 (both operands are cast to it first).
    CPU tensors run :func:`plan_numeric_plain`."""
    _check_args(x, i, y, j, t_ptr)
    dev = x.device
    if dev.type == "cpu":
        return plan_numeric_plain(x, i, y, j, t_ptr)
    if dev.type != "cuda":
        raise NotImplementedError(
            f"plan_numeric has no kernel for {dev.type}")
    dt = out_dtype(x, y)
    if dt not in _DTYPE_CODES:
        raise TypeError("the plan_numeric kernel takes float32, float16 or "
                        f"bfloat16 values, not {dt}")
    if i.shape[0] >= 2**31 or max(x.shape[0], 0 if y is None
                                  else y.shape[0]) >= 2**31:
        raise ValueError("plan_numeric indexes terms and values with int32")
    x = x.to(dt).contiguous()
    if y is not None:
        y = y.to(dt).contiguous()
    for t in (i, j, t_ptr):
        if t is not None and not t.is_contiguous():
            raise ValueError("plan_numeric index operands must be "
                             "contiguous")
    n_out = t_ptr.shape[0] - 1
    out = torch.empty(n_out, dtype=dt, device=dev)
    lib = _kernel_lib()
    rc = lib.plan_numeric(
        dev.index, _DTYPE_CODES[dt], x.data_ptr(), i.data_ptr(),
        None if y is None else y.data_ptr(),
        None if y is None else j.data_ptr(), t_ptr.data_ptr(),
        out.data_ptr(), n_out, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "plan_numeric launch")
    plan_numeric.launches += 1
    return out


plan_numeric.launches = 0
