"""SpMM min/max with argout, and the two halves of its backward.

* :func:`csr_spmm_minmax`: ``out[r, k]`` is the min or max over the
  edges ``e`` of row ``r`` of ``value[e] * x[col e, k]``, and
  ``arg[r, k]`` the edge that gave it.
* :func:`minmax_edge_dot`: the ``grad_value`` half of the backward,
  ``grad_value[e] = sum_k [arg[row e, k] == e] * g[row e, k] *
  x[col e, k]``.
* :func:`minmax_spmm_t`: the ``grad_mat`` half over the CSC view,
  ``grad_mat[c, k] = sum_{e in column c} [arg[row e, k] == e] *
  value[e] * g[row e, k]``.

They replace the JAX package's ``pytorch_sparse_tpu/ops/kernels/ell.py``:
``ell_spmm_minmax`` (forward) and ``ell_minmax_bwd`` (both backward
halves), which run over the ELL view and its transpose.  The CUDA
kernels (``csrc/spmm_minmax.cu``) read CSR and the cached CSC view
directly: the forward the min/max walk of ``csrc/minmax_walk.cuh``
(``shard_spmm_minmax``'s, for float32, float16 and bfloat16),
``minmax_edge_dot`` the per-edge walk of ``csrc/edge_walk.cuh``
(``edge_dot``'s), ``minmax_spmm_t`` the CSR walk of ``csrc/
csr_walk.cuh`` over the CSC view's columns.

The argout contract is the JAX ELL path's (``ts.spmm_max`` run eagerly):
strict comparison, so ties keep the first CSR edge; the running best
starts from the row's first edge, so an all ``-inf`` row (max) gives
``-inf`` and its first edge; a NaN wins over a non-NaN best and the
first NaN wins among NaNs; an empty row gives ``out = 0`` and
``arg = E``.  float16/bfloat16 operands compute in their own dtype:
``value`` is cast to ``x``'s dtype and each product is rounded to it
before it is compared.  The backward masks before it multiplies, so an
edge that did not win ``(r, k)`` contributes exactly 0 even where ``x``
or ``value`` is not finite (JAX's ``tmp * x[col]`` makes such an entry
NaN).

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (``*_plain``) for CPU tensors.  Other devices raise.
``csr_spmm_minmax.launches``, ``minmax_edge_dot.launches`` and
``minmax_spmm_t.launches`` count kernel launches;
``csr_spmm_minmax.last_instance``, ``minmax_edge_dot.last_instance`` and
``minmax_spmm_t.last_instance`` keep the instance of the walk each last
ran.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ... import _build
from ...segment import segment_max, segment_min, segment_sum
from ...utils.convert import INDEX_DTYPE, ptr2ind
from .csr_spmm import WalkInstance, launch_instance
from .edge_dot import launch_edge_instance

_lib = None
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# Bound on the elements of each (edges, K) temporary of the plain
# versions.
_PLAIN_CHUNK_ELEMS = 1 << 24


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("spmm_minmax")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.csr_spmm_minmax.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i, p]
        lib.csr_spmm_minmax.restype = i
        lib.csr_spmm_minmax_instance.argtypes = [
            i, i, p, p, p, ctypes.POINTER(i)]
        lib.csr_spmm_minmax_instance.restype = i
        lib.minmax_edge_dot_f32.argtypes = [i, p, p, p, p, p, p, i, i, p]
        lib.minmax_edge_dot_f32.restype = i
        lib.minmax_spmm_t_f32.argtypes = [i, p, p, p, p, p, p, p, i, i, p]
        lib.minmax_spmm_t_f32.restype = i
        _lib = lib
    return _lib


def _same_device(name, *tensors) -> torch.device:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name} operands lie on different devices")
    return devs.pop()


def _kernel_device(name, dev: torch.device, tensors) -> None:
    """Checks shared by the CUDA paths."""
    if dev.type != "cuda":
        raise NotImplementedError(f"{name} has no kernel for {dev.type}")
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")


def _check_index(*tensors) -> None:
    if any(t.dtype != INDEX_DTYPE or t.dim() != 1 for t in tensors):
        raise TypeError("index arrays must be 1-D int32")


def _check_arg(arg, M, K) -> None:
    if arg.dtype != INDEX_DTYPE or tuple(arg.shape) != (M, K):
        raise ValueError(f"arg must be int32 ({M}, {K})")


def _edge_step(K: int) -> int:
    return max(1, _PLAIN_CHUNK_ELEMS // max(K, 1))


def _row_chunks(rowptr: torch.Tensor, K: int):
    """Row ranges ``(r0, r1, e0, e1)`` whose edges stay near the plain
    versions' element budget (a row longer than it is one range)."""
    rp = rowptr.cpu().numpy().astype(np.int64)
    M, step = rp.shape[0] - 1, _edge_step(K)
    r0 = 0
    while r0 < M:
        r1 = int(np.searchsorted(rp, rp[r0] + step, side="right")) - 1
        r1 = min(max(r1, r0 + 1), M)
        yield r0, r1, int(rp[r0]), int(rp[r1])
        r0 = r1


# ----------------------------------------------------------------------
# Forward: csr_spmm_minmax
# ----------------------------------------------------------------------

def _check_forward(rowptr, col, value, x) -> None:
    _check_index(rowptr, col)
    if x.dim() != 2:
        raise ValueError("x must be (N, K)")
    if value is not None and value.shape != col.shape:
        raise ValueError("value must have the shape of col")
    _same_device("csr_spmm_minmax", rowptr, col, value, x)


def csr_spmm_minmax_plain(rowptr: torch.Tensor, col: torch.Tensor,
                          value: Optional[torch.Tensor], x: torch.Tensor,
                          is_min: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: per chunk of rows, the products in ``x``'s
    dtype, their segment extremes with NaN set aside, and the first edge
    that reaches the extreme (or the first NaN where a row-column has
    one) as ``arg``; ``out`` is that edge's product."""
    _check_forward(rowptr, col, value, x)
    M, E, K = rowptr.shape[0] - 1, col.shape[0], x.shape[1]
    out = x.new_zeros((M, K))
    arg = torch.full((M, K), E, dtype=INDEX_DTYPE, device=x.device)
    v = None if value is None else value.to(x.dtype)
    seg = segment_min if is_min else segment_max
    for r0, r1, e0, e1 in _row_chunks(rowptr, K):
        if e0 == e1:
            continue
        nr, ne = r1 - r0, e1 - e0
        h = x.index_select(0, col[e0:e1])
        if v is not None:
            h = h * v[e0:e1, None]  # rounded to x's dtype
        rows = ptr2ind(rowptr[r0:r1 + 1] - e0, ne).long()
        nan = torch.isnan(h)
        h_num = h.masked_fill(nan, float("inf") if is_min else float("-inf"))
        ext = seg(h_num, rows, nr)
        has_nan = segment_sum(nan.to(INDEX_DTYPE), rows, nr) > 0
        hit = torch.where(has_nan[rows], nan, h_num == ext[rows])
        eid = torch.arange(e0, e1, dtype=INDEX_DTYPE, device=x.device)
        cand = torch.where(hit, eid[:, None], E)
        a = torch.full((nr, K), E, dtype=INDEX_DTYPE, device=x.device)
        a.scatter_reduce_(0, rows[:, None].expand(ne, K), cand, "amin")
        arg[r0:r1] = a
        local = torch.where(a == E, ne, a - e0).long()
        out[r0:r1] = torch.cat([h, h.new_zeros((1, K))]).gather(0, local)
    return out, arg


def csr_spmm_minmax(rowptr: torch.Tensor, col: torch.Tensor,
                    value: Optional[torch.Tensor], x: torch.Tensor,
                    is_min: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, arg)``: the ``(M, K)`` min (``is_min``) or max SpMM of the
    CSR matrix ``(rowptr, col, value)`` (``value=None`` means implicit
    ones) with ``x`` ``(N, K)``, in ``x``'s dtype, and its ``(M, K)``
    int32 argout.

    CUDA tensors run the hand-written kernel: ``x`` float32, float16 or
    bfloat16, row-major contiguous.  The instance is
    ``csr_spmm.launch_instance(K, x, out, arg)`` (chunks of 4 elements
    where ``K % 4 == 0`` and ``x`` and ``out`` start on a boundary of 4
    of their elements, 16 bytes for float32 and 8 for a half type, and
    ``arg`` on 16 bytes; else scalar ones), kept in
    ``csr_spmm_minmax.last_instance``.  CPU tensors run
    :func:`csr_spmm_minmax_plain`."""
    _check_forward(rowptr, col, value, x)
    dev = x.device
    if dev.type == "cpu":
        return csr_spmm_minmax_plain(rowptr, col, value, x, is_min)
    _kernel_device("csr_spmm_minmax", dev, (rowptr, col, x))
    if x.dtype not in _DTYPE_CODES:
        raise TypeError("the csr_spmm_minmax kernel takes float32, float16 "
                        "or bfloat16 x")
    if col.shape[0] >= 2**31:
        raise ValueError("csr_spmm_minmax indexes edges with int32")
    v = None if value is None else value.to(x.dtype).contiguous()
    M, E, K = rowptr.shape[0] - 1, col.shape[0], x.shape[1]
    out = torch.empty((M, K), dtype=x.dtype, device=dev)
    arg = torch.empty((M, K), dtype=INDEX_DTYPE, device=dev)
    lib = _kernel_lib()
    rc = lib.csr_spmm_minmax(
        dev.index, _DTYPE_CODES[x.dtype], int(bool(is_min)),
        rowptr.data_ptr(), col.data_ptr(), None if v is None else v.data_ptr(),
        x.data_ptr(), out.data_ptr(), arg.data_ptr(), M, K, E,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "csr_spmm_minmax launch")
    csr_spmm_minmax.launches += 1
    csr_spmm_minmax.last_instance = launch_instance(K, x, out, arg)
    return out, arg


csr_spmm_minmax.launches = 0
csr_spmm_minmax.last_instance = None


def kernel_minmax_instance(K: int, x: torch.Tensor, out: torch.Tensor,
                           arg: torch.Tensor) -> WalkInstance:
    """The C code's choice of K6's instance for these tensors
    (``csr_spmm_minmax_instance``), built and loaded on first use: the
    GPU tests hold it against ``launch_instance(K, x, out, arg)``."""
    arr = (ctypes.c_int * 4)()
    _kernel_lib().csr_spmm_minmax_instance(
        _DTYPE_CODES[x.dtype], int(K), x.data_ptr(), out.data_ptr(),
        arg.data_ptr(), arr)
    vec, lanes, chunks, tiles = arr
    return WalkInstance(vec, lanes, 32 // lanes, chunks, tiles)


# ----------------------------------------------------------------------
# Backward, grad_value half: minmax_edge_dot
# ----------------------------------------------------------------------

def _check_edge_dot(rowptr, col, x, g, arg) -> None:
    _check_index(rowptr, col)
    if x.dim() != 2 or g.dim() != 2:
        raise ValueError("expected x (N, K) and g (M, K)")
    M = rowptr.shape[0] - 1
    if g.shape[0] != M or g.shape[1] != x.shape[1]:
        raise ValueError("g must be (M, K) for rowptr (M+1,) and x (N, K)")
    _check_arg(arg, M, x.shape[1])
    _same_device("minmax_edge_dot", rowptr, col, x, g, arg)


def minmax_edge_dot_plain(rowptr: torch.Tensor, col: torch.Tensor,
                          x: torch.Tensor, g: torch.Tensor,
                          arg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: per chunk of edges, ``x[col] * g[row]``
    masked to the ``(row, k)`` each edge won, summed over ``k``."""
    _check_edge_dot(rowptr, col, x, g, arg)
    E = col.shape[0]
    row = ptr2ind(rowptr, E)
    out = torch.empty(E, dtype=torch.promote_types(x.dtype, g.dtype),
                      device=x.device)
    step = _edge_step(x.shape[1])
    for s in range(0, E, step):
        e = min(s + step, E)
        r = row[s:e]
        eid = torch.arange(s, e, dtype=INDEX_DTYPE, device=x.device)
        hit = arg.index_select(0, r) == eid[:, None]
        prod = x.index_select(0, col[s:e]) * g.index_select(0, r)
        out[s:e] = torch.where(hit, prod, 0.0).sum(-1)
    return out


def minmax_edge_dot(rowptr: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
                    g: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
    """``(E,)`` float32 ``grad_value`` of the min/max SpMM: ``x`` ``(N,
    K)``, ``g`` ``(M, K)`` the output's gradient, ``arg`` ``(M, K)`` the
    forward's argout.

    CUDA tensors run the hand-written kernel: ``x`` and ``g`` float32,
    row-major contiguous.  The instance is ``edge_dot.
    launch_edge_instance(K, x, g, arg)`` (kept in
    ``minmax_edge_dot.last_instance``); at ``K == 0`` every entry is 0 and
    nothing is launched.  CPU tensors run :func:`minmax_edge_dot_plain`.
    """
    _check_edge_dot(rowptr, col, x, g, arg)
    dev = x.device
    if dev.type == "cpu":
        return minmax_edge_dot_plain(rowptr, col, x, g, arg)
    _kernel_device("minmax_edge_dot", dev, (rowptr, col, x, g, arg))
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("the minmax_edge_dot kernel takes float32 x and g")
    if col.shape[0] >= 2**31:
        raise ValueError("minmax_edge_dot indexes edges with int32")
    M, K = rowptr.shape[0] - 1, x.shape[1]
    if K == 0:
        return torch.zeros(col.shape[0], dtype=torch.float32, device=dev)
    out = torch.empty(col.shape[0], dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    rc = lib.minmax_edge_dot_f32(
        dev.index, rowptr.data_ptr(), col.data_ptr(), x.data_ptr(),
        g.data_ptr(), arg.data_ptr(), out.data_ptr(), M, K,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "minmax_edge_dot launch")
    minmax_edge_dot.launches += 1
    minmax_edge_dot.last_instance = launch_edge_instance(K, x, g, arg)
    return out


minmax_edge_dot.launches = 0
minmax_edge_dot.last_instance = None


# ----------------------------------------------------------------------
# Backward, grad_mat half: minmax_spmm_t
# ----------------------------------------------------------------------

def _check_spmm_t(colptr, csc_row, csr2csc, value, g, arg) -> None:
    _check_index(colptr, csc_row, csr2csc)
    if csc_row.shape != csr2csc.shape:
        raise ValueError("csc_row and csr2csc differ in length")
    if value is not None and value.shape != csc_row.shape:
        raise ValueError("value must have one entry per edge")
    if g.dim() != 2:
        raise ValueError("g must be (M, K)")
    _check_arg(arg, g.shape[0], g.shape[1])
    _same_device("minmax_spmm_t", colptr, csc_row, csr2csc, value, g, arg)


def minmax_spmm_t_plain(colptr: torch.Tensor, csc_row: torch.Tensor,
                        csr2csc: torch.Tensor, value: Optional[torch.Tensor],
                        g: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: per chunk of CSC positions, ``value[e] *
    g[row e]`` masked to the ``(row, k)`` each edge won, added into its
    column with ``index_add_``."""
    _check_spmm_t(colptr, csc_row, csr2csc, value, g, arg)
    N, E = colptr.shape[0] - 1, csc_row.shape[0]
    ccol = ptr2ind(colptr, E)
    dtype = g.dtype if value is None else torch.promote_types(g.dtype,
                                                              value.dtype)
    out = torch.zeros((N, g.shape[1]), dtype=dtype, device=g.device)
    step = _edge_step(g.shape[1])
    for s in range(0, E, step):
        e = min(s + step, E)
        r, eids = csc_row[s:e], csr2csc[s:e]
        hit = arg.index_select(0, r) == eids[:, None]
        contrib = g.index_select(0, r).to(dtype)
        if value is not None:
            contrib = contrib * value.index_select(0, eids)[:, None]
        out.index_add_(0, ccol[s:e], torch.where(hit, contrib, 0.0))
    return out


def minmax_spmm_t(colptr: torch.Tensor, csc_row: torch.Tensor,
                  csr2csc: torch.Tensor, value: Optional[torch.Tensor],
                  g: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
    """``(N, K)`` float32 ``grad_mat`` of the min/max SpMM over the CSC
    view: ``colptr`` ``(N+1,)``, ``csc_row`` and ``csr2csc`` ``(E,)`` in
    CSC order, ``value`` ``(E,)`` in CSR order (None for implicit ones),
    ``g`` ``(M, K)`` the output's gradient, ``arg`` the forward's argout.

    CUDA tensors run the hand-written kernel: ``value`` and ``g``
    float32, row-major contiguous.  The instance is
    ``csr_spmm.launch_instance(K, g, arg, out)`` (float4 and int4 chunks
    where ``K % 4 == 0`` and all three start on 16-byte boundaries, else
    scalar ones; kept in ``minmax_spmm_t.last_instance``).  CPU tensors
    run :func:`minmax_spmm_t_plain`."""
    _check_spmm_t(colptr, csc_row, csr2csc, value, g, arg)
    dev = g.device
    if dev.type == "cpu":
        return minmax_spmm_t_plain(colptr, csc_row, csr2csc, value, g, arg)
    _kernel_device("minmax_spmm_t", dev,
                   (colptr, csc_row, csr2csc, value, g, arg))
    if g.dtype != torch.float32 or (
            value is not None and value.dtype != torch.float32):
        raise TypeError("the minmax_spmm_t kernel takes float32 value and g")
    if csc_row.shape[0] >= 2**31:
        raise ValueError("minmax_spmm_t indexes edges with int32")
    N, K = colptr.shape[0] - 1, g.shape[1]
    out = torch.empty((N, K), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    rc = lib.minmax_spmm_t_f32(
        dev.index, colptr.data_ptr(), csc_row.data_ptr(), csr2csc.data_ptr(),
        None if value is None else value.data_ptr(), g.data_ptr(),
        arg.data_ptr(), out.data_ptr(), N, K,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "minmax_spmm_t launch")
    minmax_spmm_t.launches += 1
    minmax_spmm_t.last_instance = launch_instance(K, g, arg, out)
    return out


minmax_spmm_t.launches = 0
minmax_spmm_t.last_instance = None
