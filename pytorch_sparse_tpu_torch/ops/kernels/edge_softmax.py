"""Edge softmax over a CSR matrix: for every row and head, the softmax of
that row's per-edge logits, ``exp(l - max) / max(sum exp(l - max),
1e-16)``.

Replaces the JAX package's ``pytorch_sparse_tpu/ops/kernels/ell.py:
ell_edge_softmax`` (ELL buckets with the row max and sum broadcast back
through ``edge_slot``).  The CUDA kernel (``csrc/edge_softmax.cu``) gives
each row to a sub-warp of ``lanes`` lanes, which reads the row's
contiguous ``deg * H`` slab of logits once and keeps it in registers
from the max through the write: with ``H`` dividing 32 and the logits
on 16-byte boundaries as float4 chunks whose positions keep their heads
(the ``chunks`` instance), else as a lane's edges, four heads a pass
(the ``edges`` instance).  :func:`sweep_instance` is the choice of
instance (the C code makes the same one), and each launch keeps it in
``edge_softmax.last_instance``.

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
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ... import _build
from ...segment import segment_max, segment_sum
from ...utils.convert import INDEX_DTYPE, ptr2ind

_lib = None

# csrc/edge_softmax.cu's constants: a lane's chunks (edges) at the mean
# row, the chunks (edges) a lane keeps in registers (or twice that), and
# the edges instance's heads a pass.
CHUNKS_AT_MEAN = 2
LANE_CHUNKS = 4
HEADS_A_PASS = 4


class SweepInstance(NamedTuple):
    """One instance of the forward kernel: ``vec`` 4 (16-byte chunks of
    the slab, heads fixed by position) or 1 (a lane's edges, any H),
    ``lanes`` a row, ``rows_per_warp``, and ``chunks`` (vec 4) or edges
    (vec 1) a lane keeps in registers: a row beyond ``lanes * chunks``
    of them sweeps its slab three times instead."""
    vec: int
    lanes: int
    rows_per_warp: int
    chunks: int


@functools.lru_cache(maxsize=None)
def sweep_instance(M: int, E: int, H: int, aligned: bool) -> SweepInstance:
    """The instance the forward runs for ``M`` rows, ``E`` edges and
    ``H`` heads, with the logits and the output on 16-byte boundaries
    (``aligned``) or not: float4 chunks where ``H`` divides 32 and
    aligned, else a lane's edges; the lanes the mean row needs at
    ``CHUNKS_AT_MEAN`` chunks (edges) a lane, as a power of two up to 32
    and at least ``H / 4``; ``LANE_CHUNKS`` chunks a lane, twice that
    where 32 lanes of ``LANE_CHUNKS`` hold less than twice the mean row.
    Cached: each launch asks for it."""
    M = max(M, 1)
    vec = 4 if aligned and 0 < H <= 32 and 32 % H == 0 else 1
    least = 1
    if vec == 4:
        units = -(-E * H // (4 * M)) + (H < 4)
        least = max(1, H // 4)
    else:
        units = -(-E // M)
    lanes = 1
    while lanes < 32 and lanes * CHUNKS_AT_MEAN < units:
        lanes *= 2
    lanes = max(lanes, least)
    chunks = LANE_CHUNKS if lanes * LANE_CHUNKS >= 2 * units \
        else 2 * LANE_CHUNKS
    return SweepInstance(vec, lanes, 32 // lanes, chunks)


def launch_sweep_instance(M: int, logits: torch.Tensor,
                          out: torch.Tensor) -> SweepInstance:
    """The instance a launch over ``M`` rows on ``logits`` ``(E, H)``
    into ``out`` runs: float4 chunks only where both start on 16-byte
    boundaries."""
    E, H = logits.shape
    aligned = logits.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return sweep_instance(M, E, H, aligned)


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("edge_softmax")
        lib.edge_softmax_f32.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.edge_softmax_f32.restype = ctypes.c_int
        lib.edge_softmax_instance.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.edge_softmax_instance.restype = ctypes.c_int
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
    M, (E, H) = rowptr.shape[0] - 1, logits.shape
    out = torch.empty_like(logits)
    lib = _kernel_lib()
    rc = lib.edge_softmax_f32(
        dev.index, rowptr.data_ptr(), logits.data_ptr(), out.data_ptr(), M,
        E, H, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "edge_softmax launch")
    edge_softmax.launches += 1
    edge_softmax.last_instance = launch_sweep_instance(M, logits, out)
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
    row-major contiguous; the forward's instance is
    ``launch_sweep_instance(M, logits, out)``, kept in
    ``edge_softmax.last_instance``.  CPU tensors run
    :func:`edge_softmax_plain` and :func:`edge_softmax_bwd_plain`."""
    _check_args(rowptr, logits)
    return _EdgeSoftmax.apply(rowptr, logits)


edge_softmax.launches = 0
edge_softmax.last_instance = None


def kernel_sweep_instance(M: int, E: int, H: int,
                          aligned: bool) -> SweepInstance:
    """The C code's choice of the forward's instance
    (``edge_softmax_instance``), built and loaded on first use: the GPU
    tests hold it against :func:`sweep_instance`."""
    arr = (ctypes.c_int * 3)()
    _kernel_lib().edge_softmax_instance(int(M), int(E), int(H),
                                        int(bool(aligned)), arr)
    vec, lanes, chunks = arr
    return SweepInstance(vec, lanes, 32 // lanes, chunks)


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
