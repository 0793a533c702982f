"""Edge softmax over a CSR matrix: for every row and head, the softmax of
that row's per-edge logits, ``exp(l - max) / max(sum exp(l - max),
1e-16)``.

Replaces the JAX package's ``pytorch_sparse_tpu/ops/kernels/ell.py:
ell_edge_softmax`` (ELL buckets with the row max and sum broadcast back
through ``edge_slot``).  The CUDA kernel (``csrc/edge_softmax.cu``) gives
each row to one warp, which sweeps the row's contiguous ``deg * H`` slab
of logits; with ``H`` dividing 32 each lane stays on one head and the
per-head max and sum reduce across the warp.

:func:`edge_softmax` launches the kernel for CUDA tensors and runs
:func:`edge_softmax_plain`, the segment form of the JAX package's
``models/gat.py: edge_softmax``, for CPU tensors.  Other devices raise.
The kernel has no backward yet: a CUDA ``logits`` that requires grad
raises.  ``edge_softmax.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

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


def edge_softmax(rowptr: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``(E, H)`` softmax of ``logits`` ``(E, H)`` (CSR edge order) over
    each row's edges, per head.

    CUDA tensors run the hand-written kernel: ``logits`` float32,
    row-major contiguous, not requiring grad.  CPU tensors run
    :func:`edge_softmax_plain`."""
    _check_args(rowptr, logits)
    dev = logits.device
    if dev.type == "cpu":
        return edge_softmax_plain(rowptr, logits)
    if dev.type != "cuda":
        raise NotImplementedError(f"edge_softmax has no kernel for {dev.type}")
    if logits.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the edge_softmax kernel has no backward yet (ROADMAP.md, A.9): "
            "run GAT on CUDA under torch.no_grad() or inference_mode()")
    if logits.dtype != torch.float32:
        raise TypeError("the edge_softmax kernel takes float32 logits")
    if logits.shape[0] >= 2**31:
        raise ValueError("edge_softmax indexes edges with int32")
    if not (rowptr.is_contiguous() and logits.is_contiguous()):
        raise ValueError("edge_softmax operands must be contiguous")
    M, H = rowptr.shape[0] - 1, logits.shape[1]
    out = torch.empty_like(logits)
    lib = _kernel_lib()
    rc = lib.edge_softmax_f32(
        dev.index, rowptr.data_ptr(), logits.data_ptr(), out.data_ptr(), M, H,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "edge_softmax launch")
    edge_softmax.launches += 1
    return out


edge_softmax.launches = 0
