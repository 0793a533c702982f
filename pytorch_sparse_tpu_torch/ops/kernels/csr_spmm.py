"""CSR row-gather SpMM: ``out[r] = sum_{e in row r} value[e] * x[col[e]]``.

Replaces the JAX package's gather route (``pytorch_sparse_tpu/ops/
kernels/ell.py``: ``ell_spmm`` and ``_bucket_sum``).  The CUDA kernel
(``csrc/csr_spmm.cu``, an instance of the CSR walk in ``csrc/
csr_walk.cuh`` that ``shard_spmm`` shares, and whose instances the
min/max walks of K6, K11b and K7b run too) reads CSR directly and sums
each output element in CSR edge order; the ELL padding and degree
buckets of the TPU version are gone.

:func:`walk_instance` is the walk's choice of instance for a width and
an alignment (the C code makes the same choice), and
:func:`launch_instance` the one a launch over given tensors runs; each
launch keeps the instance it ran in ``csr_spmm.last_instance``.

:func:`csr_spmm` launches the kernel for CUDA tensors and runs
:func:`csr_spmm_plain`, the plain PyTorch version of the same function,
for CPU tensors.  Other devices raise.  ``csr_spmm.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ... import _build
from ...utils.convert import INDEX_DTYPE, ptr2ind

_lib = None

TILE_COLUMNS = 256   # a column tile's width at most (csr_walk.cuh)


class WalkInstance(NamedTuple):
    """One instance of the CSR walk: ``vec`` columns a chunk (4: float4
    loads, 1: scalar), ``lanes`` a row, ``rows_per_warp``, ``chunks`` a
    lane, and ``col_tiles`` column tiles (``gridDim.y``).  Lane ``s`` of a
    row owns, in tile ``t``, the columns ``t * lanes * vec * chunks +
    (s + lanes * j) * vec + q`` for ``j < chunks``, ``q < vec``."""
    vec: int
    lanes: int
    rows_per_warp: int
    chunks: int
    col_tiles: int


def _next_pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


@functools.lru_cache(maxsize=None)
def walk_instance(K: int, aligned: bool) -> WalkInstance:
    """The instance the walk runs at width ``K`` (``K >= 1``) when the
    operand and the output start on 16-byte boundaries (``aligned``) or
    not: float4 chunks where ``K % 4 == 0`` and aligned, else scalar
    ones; the lanes ``K`` needs at 4 columns a lane, as a power of two up
    to 32; chunks a lane up to a 256-column tile; more tiles beyond.
    Cached: each launch asks for it."""
    vec = 4 if aligned and K % 4 == 0 else 1
    lanes = min(32, _next_pow2(-(-K // 4)))
    chunks = min(TILE_COLUMNS // (32 * vec),
                 _next_pow2(-(-(-(-K // vec)) // lanes)))
    tile = lanes * vec * chunks
    return WalkInstance(vec, lanes, 32 // lanes, chunks, -(-K // tile))


def launch_instance(K: int, *tensors: torch.Tensor) -> WalkInstance:
    """The instance a launch runs whose row-major ``(rows, K)`` operands
    and outputs are ``tensors`` (K1: ``x`` and ``out``; K11b: ``buf``,
    ``out`` and ``arg``; K7b: ``g``, ``arg`` and ``out``; K6: ``x``,
    ``out`` and ``arg``): chunks of 4 elements (float4 for 4-byte
    elements, 8 bytes for float16 and bfloat16) only where every one
    starts on a boundary of 4 of its elements."""
    return walk_instance(K, all(t.data_ptr() % (4 * t.element_size()) == 0
                                for t in tensors))


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
        lib.csr_walk_instance.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.csr_walk_instance.restype = ctypes.c_int
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
    float32 and ``x`` row-major contiguous.  The instance that runs is
    ``launch_instance(K, x, out)``: float4 loads where ``K % 4 == 0`` and
    ``x`` starts on a 16-byte boundary (the output is a new tensor, which
    does), else the scalar instance of the same walk.  CPU tensors run
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
    csr_spmm.last_instance = launch_instance(K, x, out)
    return out


csr_spmm.launches = 0
csr_spmm.last_instance = None


def kernel_walk_instance(K: int, aligned: bool) -> WalkInstance:
    """The C code's choice of instance (``csr_walk_instance``), built and
    loaded on first use: the GPU tests hold it against
    :func:`walk_instance`."""
    arr = (ctypes.c_int * 4)()
    _kernel_lib().csr_walk_instance(int(K), int(bool(aligned)), arr)
    vec, lanes, chunks, tiles = arr
    return WalkInstance(vec, lanes, 32 // lanes, chunks, tiles)
