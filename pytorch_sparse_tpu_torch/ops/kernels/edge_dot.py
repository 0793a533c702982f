"""Per-edge dot product over a CSR matrix:
``out[e] = <x[col[e]], g[row(e)]>`` for every edge ``e`` in CSR order.

This is the ``grad_value`` pass of SpMM-sum.  It replaces the JAX
package's ``pytorch_sparse_tpu/ops/kernels/ell.py: ell_edge_dot`` (ELL
layout) and ``pytorch_sparse_tpu/ops/matmul.py: _edge_dot_chunked`` (the
``lax.scan``-chunked two-gather form of the hybrid route).  The CUDA
kernel (``csrc/edge_dot.cu``) is the per-edge walk of ``csrc/
edge_walk.cuh``, which ``minmax_edge_dot`` (K7a) shares: the lanes ``K``
needs keep 16-byte chunks of ``g[row]`` in registers, take 8 edges' rows
of ``x`` at a time and sum the lanes' partial dots with one transposing
butterfly a batch; there is no padding and no atomic.

:func:`edge_instance` is the walk's choice of instance for a width and
an alignment (the C code makes the same choice); each launch keeps the
instance it ran in ``edge_dot.last_instance``.

:func:`edge_dot` launches the kernel for CUDA tensors and runs
:func:`edge_dot_plain`, the plain PyTorch version of the same function,
for CPU tensors.  Other devices raise.  ``edge_dot.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ... import _build
from ...utils.convert import INDEX_DTYPE, ptr2ind
from .csr_spmm import walk_instance

# csr_walk.cuh's edges in flight, which the edge walk keeps (U).
EDGES_IN_FLIGHT = 8


class EdgeInstance(NamedTuple):
    """One instance of the per-edge walk: the CSR walk's ``vec`` columns a
    chunk (4: float4 loads, 1: scalar), ``lanes`` a row,
    ``rows_per_warp`` and ``chunks`` a lane, its column tiles taken as
    ``passes`` inside the lane, and ``edges_in_flight`` (U).  Lane ``s``
    of a row owns, in pass ``p``, the columns ``p * lanes * vec * chunks
    + (s + lanes * j) * vec + q`` for ``j < chunks``, ``q < vec``, and
    after a batch's butterfly holds the dots of edges ``(s * U) // lanes
    + i`` of the batch, ``i < max(1, U // lanes)``."""
    vec: int
    lanes: int
    rows_per_warp: int
    chunks: int
    passes: int
    edges_in_flight: int


@functools.lru_cache(maxsize=None)
def edge_instance(K: int, aligned: bool) -> EdgeInstance:
    """The instance the per-edge walk runs at width ``K`` (``K >= 1``)
    when ``x`` and ``g`` (and ``arg`` for ``minmax_edge_dot``) start on
    16-byte boundaries (``aligned``) or not: the CSR walk's instance
    (:func:`.csr_spmm.walk_instance`), its column tiles as passes.
    Cached: each launch asks for it."""
    w = walk_instance(K, aligned)
    return EdgeInstance(w.vec, w.lanes, w.rows_per_warp, w.chunks,
                        w.col_tiles, EDGES_IN_FLIGHT)


def launch_edge_instance(K: int, *tensors: torch.Tensor) -> EdgeInstance:
    """The instance a launch over the row-major ``(rows, K)`` operands
    ``tensors`` runs (``x`` and ``g``; ``arg`` too for
    ``minmax_edge_dot``): float4 chunks only where every one starts on a
    16-byte boundary."""
    return edge_instance(K, all(t.data_ptr() % 16 == 0 for t in tensors))


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
        lib.edge_walk_instance.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.edge_walk_instance.restype = ctypes.c_int
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
    float32 and row-major contiguous.  The instance that runs is
    ``launch_edge_instance(K, x, g)`` (kept in ``edge_dot.last_instance``);
    at ``K == 0`` every dot is 0 and nothing is launched.  CPU tensors
    run :func:`edge_dot_plain`."""
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
    if K == 0:
        return torch.zeros(col.shape[0], dtype=torch.float32, device=dev)
    out = torch.empty(col.shape[0], dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    rc = lib.edge_dot_f32(
        dev.index, rowptr.data_ptr(), col.data_ptr(), x.data_ptr(),
        g.data_ptr(), out.data_ptr(), M, K,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "edge_dot launch")
    edge_dot.launches += 1
    edge_dot.last_instance = launch_edge_instance(K, x, g)
    return out


edge_dot.launches = 0
edge_dot.last_instance = None


def kernel_edge_instance(K: int, aligned: bool) -> EdgeInstance:
    """The C code's choice of instance (``edge_walk_instance``), built and
    loaded on first use: the GPU tests hold it against
    :func:`edge_instance`."""
    arr = (ctypes.c_int * 5)()
    _kernel_lib().edge_walk_instance(int(K), int(bool(aligned)), arr)
    vec, lanes, chunks, passes, u = arr
    return EdgeInstance(vec, lanes, 32 // lanes, chunks, passes, u)
