"""Per-edge dot product over a CSR matrix:
``out[e] = <x[col[e]], g[row(e)]>`` for every edge ``e`` in CSR order.

This is the ``grad_value`` pass of SpMM-sum.  It replaces the JAX
package's ``pytorch_sparse_tpu/ops/kernels/ell.py: ell_edge_dot`` (ELL
layout) and ``pytorch_sparse_tpu/ops/matmul.py: _edge_dot_chunked`` (the
``lax.scan``-chunked two-gather form of the hybrid route).  The CUDA
kernel (``csrc/edge_dot.cu``) gives each CSR row to one warp, which
keeps ``g[row]`` in registers and reduces each edge's dot across the
warp; there is no padding and no atomic.

:func:`edge_dot` launches the kernel for CUDA tensors and runs
:func:`edge_dot_plain`, the plain PyTorch version of the same function,
for CPU tensors.  Other devices raise.  ``edge_dot.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils.convert import INDEX_DTYPE, ptr2ind

_lib = None
# Bound on the elements of each (chunk, K) temporary of the plain
# version, as the JAX package bounds its gathers.
_PLAIN_CHUNK_ELEMS = 1 << 24


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("edge_dot")
        lib.edge_dot_f32.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.edge_dot_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_args(rowptr, col, x, g) -> None:
    if rowptr.dtype != INDEX_DTYPE or col.dtype != INDEX_DTYPE:
        raise TypeError("rowptr and col must be int32")
    if rowptr.dim() != 1 or col.dim() != 1 or x.dim() != 2 or g.dim() != 2:
        raise ValueError("expected rowptr (M+1,), col (E,), x (N, K) and "
                         "g (M, K)")
    if g.shape[0] != rowptr.shape[0] - 1 or g.shape[1] != x.shape[1]:
        raise ValueError("g must be (M, K) for rowptr (M+1,) and x (N, K)")
    devs = {t.device for t in (rowptr, col, x, g)}
    if len(devs) != 1:
        raise ValueError("edge_dot operands lie on different devices")


def edge_dot_plain(rowptr: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(x[col] * g[row]).sum(-1)``, in chunks of
    edges so that the ``(E, K)`` temporaries stay bounded."""
    _check_args(rowptr, col, x, g)
    E, K = col.shape[0], x.shape[1]
    row = ptr2ind(rowptr, E)
    out = torch.empty(E, dtype=torch.promote_types(x.dtype, g.dtype),
                      device=x.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(K, 1))
    for s in range(0, E, step):
        e = min(s + step, E)
        out[s:e] = (x.index_select(0, col[s:e])
                    * g.index_select(0, row[s:e])).sum(-1)
    return out


def edge_dot(rowptr: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    """``(E,)`` float32 per-edge dot of ``x`` ``(N, K)`` and ``g``
    ``(M, K)`` over the CSR structure ``(rowptr, col)``.

    CUDA tensors run the hand-written kernel: ``x`` and ``g`` must be
    float32 and row-major contiguous.  CPU tensors run
    :func:`edge_dot_plain`."""
    _check_args(rowptr, col, x, g)
    dev = x.device
    if dev.type == "cpu":
        return edge_dot_plain(rowptr, col, x, g)
    if dev.type != "cuda":
        raise NotImplementedError(f"edge_dot has no kernel for {dev.type}")
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("the edge_dot kernel takes float32 x and g")
    if col.shape[0] >= 2**31:
        raise ValueError("edge_dot indexes edges with int32")
    for t in (rowptr, col, x, g):
        if not t.is_contiguous():
            raise ValueError("edge_dot operands must be contiguous")
    M, K = rowptr.shape[0] - 1, x.shape[1]
    out = torch.empty(col.shape[0], dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    rc = lib.edge_dot_f32(
        dev.index, rowptr.data_ptr(), col.data_ptr(), x.data_ptr(),
        g.data_ptr(), out.data_ptr(), M, K,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "edge_dot launch")
    edge_dot.launches += 1
    return out


edge_dot.launches = 0
