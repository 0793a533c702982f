"""Edge softmax over a CSR matrix: for every row and head, the softmax of
that row's per-edge logits, ``exp(l - max) / max(sum exp(l - max),
1e-16)``.

Replaces the JAX package's ``pytorch_sparse_tpu/ops/kernels/ell.py:
ell_edge_softmax`` (ELL buckets with the row max and sum broadcast back
through ``edge_slot``).  The CUDA kernel (``csrc/edge_softmax.cu``) gives
each row to one warp, which sweeps the row's contiguous ``deg * H`` slab
of logits; with ``H`` dividing 32 each lane stays on one head and the
per-head max and sum reduce across the warp.

:func:`edge_softmax` is differentiable: one autograd function runs the
forward and keeps its output ``p``, and its backward is
:func:`edge_softmax_bwd`, ``grad_l = p * (g - sum_row p * g)`` per head,
the gradient JAX takes by autodiff (a second kernel of the same source,
one warp per row).  Each wrapper launches its kernel for CUDA tensors and
runs its plain PyTorch version (:func:`edge_softmax_plain`, the segment
form of the JAX package's ``models/gat.py: edge_softmax``, and
:func:`edge_softmax_bwd_plain`) for CPU tensors.  Other devices raise.
``edge_softmax.launches`` and ``edge_softmax_bwd.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ... import _build
from ...segment import segment_max, segment_sum
from ...utils.convert import INDEX_DTYPE, ptr2ind

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("edge_softmax")
        lib.edge_softmax_f32.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.edge_softmax_f32.restype = ctypes.c_int
        lib.edge_softmax_bwd_f32.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.edge_softmax_bwd_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_args(rowptr, logits) -> None:
    if rowptr.dtype != INDEX_DTYPE or rowptr.dim() != 1:
        raise TypeError("rowptr must be 1-D int32")
    if logits.dim() != 2:
        raise ValueError("logits must be (E, H)")
    if rowptr.device != logits.device:
        raise ValueError("edge_softmax operands lie on different devices")


def edge_softmax_plain(rowptr: torch.Tensor,
                       logits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: segment max, ``exp``, segment sum, divide
    (differentiable by autograd)."""
    _check_args(rowptr, logits)
    M = rowptr.shape[0] - 1
    row = ptr2ind(rowptr, logits.shape[0]).long()
    mx = segment_max(logits, row, M)
    ex = torch.exp(logits - mx[row])
    denom = segment_sum(ex, row, M)
    return ex / torch.clamp_min(denom[row], 1e-16)


def _check_kernel_args(name, rowptr, *arrays) -> None:
    if any(a.dtype != torch.float32 for a in arrays):
        raise TypeError(f"the {name} kernel takes float32 arrays")
    if arrays[0].shape[0] >= 2**31:
        raise ValueError(f"{name} indexes edges with int32")
    if not all(t.is_contiguous() for t in (rowptr,) + arrays):
        raise ValueError(f"{name} operands must be contiguous")


def _forward(rowptr: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    dev = logits.device
    if dev.type == "cpu":
        return edge_softmax_plain(rowptr, logits)
    if dev.type != "cuda":
        raise NotImplementedError(f"edge_softmax has no kernel for {dev.type}")
    _check_kernel_args("edge_softmax", rowptr, logits)
    M, H = rowptr.shape[0] - 1, logits.shape[1]
    out = torch.empty_like(logits)
    lib = _kernel_lib()
    rc = lib.edge_softmax_f32(
        dev.index, rowptr.data_ptr(), logits.data_ptr(), out.data_ptr(), M, H,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "edge_softmax launch")
    edge_softmax.launches += 1
    return out


class _EdgeSoftmax(torch.autograd.Function):
    """The kernel's forward, keeping ``p`` for :func:`edge_softmax_bwd`."""

    @staticmethod
    def forward(ctx, rowptr, logits):
        p = _forward(rowptr, logits)
        ctx.save_for_backward(rowptr, p)
        return p

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        rowptr, p = ctx.saved_tensors
        return None, edge_softmax_bwd(rowptr, p, grad.contiguous())


def edge_softmax(rowptr: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``(E, H)`` softmax of ``logits`` ``(E, H)`` (CSR edge order) over
    each row's edges, per head; differentiable in ``logits``.

    CUDA tensors run the hand-written kernels: ``logits`` float32,
    row-major contiguous.  CPU tensors run :func:`edge_softmax_plain`
    and :func:`edge_softmax_bwd_plain`."""
    _check_args(rowptr, logits)
    return _EdgeSoftmax.apply(rowptr, logits)


edge_softmax.launches = 0


def edge_softmax_bwd_plain(rowptr: torch.Tensor, p: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: segment sum of ``p * g``,
    then ``p * (g - sum[row])``."""
    _check_args(rowptr, p)
    M = rowptr.shape[0] - 1
    row = ptr2ind(rowptr, p.shape[0]).long()
    dot = segment_sum(p * g, row, M)
    return p * (g - dot[row])


def edge_softmax_bwd(rowptr: torch.Tensor, p: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """``(E, H)`` gradient of the logits of :func:`edge_softmax` whose
    output is ``p`` ``(E, H)``, for the output gradient ``g`` ``(E,
    H)``: ``p * (g - sum over the row of p * g)`` per head.

    CUDA tensors run the hand-written kernel (float32, contiguous); CPU
    tensors run :func:`edge_softmax_bwd_plain`."""
    _check_args(rowptr, p)
    if g.shape != p.shape or g.device != p.device:
        raise ValueError("g must be (E, H) on p's device")
    dev = p.device
    if dev.type == "cpu":
        return edge_softmax_bwd_plain(rowptr, p, g)
    if dev.type != "cuda":
        raise NotImplementedError(
            f"edge_softmax_bwd has no kernel for {dev.type}")
    _check_kernel_args("edge_softmax_bwd", rowptr, p, g)
    M, H = rowptr.shape[0] - 1, p.shape[1]
    out = torch.empty_like(p)
    lib = _kernel_lib()
    rc = lib.edge_softmax_bwd_f32(
        dev.index, rowptr.data_ptr(), p.data_ptr(), g.data_ptr(),
        out.data_ptr(), M, H, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "edge_softmax_bwd launch")
    edge_softmax_bwd.launches += 1
    return out


edge_softmax_bwd.launches = 0
