"""Per-shard local SpMM of the distributed schedules (``parallel/dist.py``).

* :func:`shard_spmm` (K11a): one edge group's sum SpMM against a buffer,
  ``g[r] = sum_{e in row r} value[e] * buf[col[e]]``, written to
  ``out[row_map[r]]`` or added to it once (``out = a + (e1 + e2 + ...)``).
* :func:`shard_spmm_minmax` (K11b): the group's min or max with its
  argout in GLOBAL edge ids (``eid_base + pos[e]``), written, or
  combined into a running ``(out, arg)``: strictly better, or equal with
  a lower edge id.

They replace the JAX package's ``pytorch_sparse_tpu/parallel/dist.py``:
``_group_ell_apply`` with the sums around it (the ring's ``out + step``,
the halo's ``interior + frontier``) and ``_group_ell_minmax`` with
``_combine_minmax``.  There, a group was a padded, degree-bucketed ELL
table because XLA on the TPU scatters slowly; here it is a CSR whose rows
keep the global CSR edge order (``csrc/shard_spmm.cu``: K11a is the CSR
walk of ``csrc/csr_walk.cuh`` that ``csr_spmm`` shares, K11b the min/max
walk of ``csrc/minmax_walk.cuh`` on the same instances).

A group is ``(rowptr, col, value)``: ``rowptr`` ``(R+1,)`` int32 may be a
slice of a larger pointer (its first entry need not be 0), ``col`` and
``value`` are indexed by its entries, ``value=None`` means implicit
ones.  ``row_map`` ``(R,)`` int32 sends group row ``r`` to output row
``row_map[r]`` (None: row ``r``).  Passing ``out`` (and ``arg``)
accumulates or combines into it in place; without it a new output of
``n_rows`` rows (default ``R``) is made, whose rows outside the group
hold 0 (sum) or JAX's pad ``(+-inf, 2**31 - 1)`` (min/max).

Min/max within a group follow ``_group_ell_minmax``: strict comparison
from the row's first edge (ties keep the first CSR edge), a NaN wins
over a non-NaN best and the first NaN wins among NaNs.

Each wrapper launches its kernel for CUDA tensors (float32 ``buf`` and
``value``) and runs its plain PyTorch version (``*_plain``) for CPU
tensors.  Other devices raise.  ``shard_spmm.launches`` and
``shard_spmm_minmax.launches`` count kernel launches, and
``.last_instance`` keeps the instance of the walk each last ran.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ... import _build
from ...utils.convert import INDEX_DTYPE, ptr2ind
from .csr_spmm import launch_instance
from .spmm_minmax import csr_spmm_minmax_plain

NO_EDGE = 2**31 - 1   # JAX's int32-max pad arg of a row with no edge

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("shard_spmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.shard_spmm_f32.argtypes = [i, p, p, p, p, p, p, i, i, i, p]
        lib.shard_spmm_f32.restype = i
        lib.shard_spmm_minmax_f32.argtypes = [i, i, p, p, p, p, p, p, p, p,
                                              i, i, i, i, p]
        lib.shard_spmm_minmax_f32.restype = i
        _lib = lib
    return _lib


def _check_group(name, rowptr, col, value, buf, row_map, pos=None) -> None:
    for t in (rowptr, col, row_map, pos):
        if t is not None and (t.dtype != INDEX_DTYPE or t.dim() != 1):
            raise TypeError(f"{name}: index arrays must be 1-D int32")
    if buf.dim() != 2:
        raise ValueError(f"{name}: buf must be (n, K)")
    if value is not None and value.shape != col.shape:
        raise ValueError(f"{name}: value must have the shape of col")
    if pos is not None and pos.shape != col.shape:
        raise ValueError(f"{name}: pos must have the shape of col")
    R = rowptr.shape[0] - 1
    if row_map is not None and row_map.shape[0] != R:
        raise ValueError(f"{name}: row_map must have one entry per row")
    devs = {t.device for t in (rowptr, col, value, buf, row_map, pos)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name} operands lie on different devices")


def _out_rows(R: int, row_map, n_rows: Optional[int]) -> int:
    n = R if n_rows is None else int(n_rows)
    if row_map is None and n != R:
        raise ValueError("without row_map the output has one row per "
                         "group row")
    return n


def _check_out(name, out, K, dtype, device) -> None:
    if out.dim() != 2 or out.shape[1] != K or out.dtype != dtype:
        raise ValueError(f"{name}: out must be (rows, {K}) {dtype}")
    if out.device != device:
        raise ValueError(f"{name} operands lie on different devices")


def _kernel_checks(name, dev, tensors, floats) -> None:
    if dev.type != "cuda":
        raise NotImplementedError(f"{name} has no kernel for {dev.type}")
    if any(t is not None and t.dtype != torch.float32 for t in floats):
        raise TypeError(f"the {name} kernel takes float32 buf, value and out")
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")


def _edges(rowptr: torch.Tensor):
    """``(e_lo, e_hi, rows)``: the group's edge range and each edge's
    group row."""
    e_lo, e_hi = int(rowptr[0]), int(rowptr[-1])
    return e_lo, e_hi, ptr2ind(rowptr - e_lo, e_hi - e_lo)


# ----------------------------------------------------------------------
# K11a: shard_spmm
# ----------------------------------------------------------------------

def shard_spmm_plain(rowptr: torch.Tensor, col: torch.Tensor,
                     value: Optional[torch.Tensor], buf: torch.Tensor,
                     out: Optional[torch.Tensor] = None,
                     row_map: Optional[torch.Tensor] = None,
                     n_rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the group's row sums by ``index_add_`` (in
    edge order on the CPU), then one write or one add per row."""
    _check_group("shard_spmm", rowptr, col, value, buf, row_map)
    R, K = rowptr.shape[0] - 1, buf.shape[1]
    e_lo, e_hi, rows = _edges(rowptr)
    h = buf.index_select(0, col[e_lo:e_hi])
    if value is not None:
        h = h * value[e_lo:e_hi].to(h.dtype)[:, None]
    g = buf.new_zeros((R, K)).index_add_(0, rows, h)
    target = (torch.arange(R, device=buf.device) if row_map is None
              else row_map.long())
    if out is None:
        out = buf.new_zeros((_out_rows(R, row_map, n_rows), K))
        out[target] = g
        return out
    _check_out("shard_spmm", out, K, buf.dtype, buf.device)
    out[target] = out[target] + g
    return out


def shard_spmm(rowptr: torch.Tensor, col: torch.Tensor,
               value: Optional[torch.Tensor], buf: torch.Tensor,
               out: Optional[torch.Tensor] = None,
               row_map: Optional[torch.Tensor] = None,
               n_rows: Optional[int] = None) -> torch.Tensor:
    """K11a: the group ``(rowptr, col, value)`` times ``buf`` ``(n, K)``,
    written to a new ``(n_rows, K)`` output or, with ``out``, added to
    ``out`` in place (one add per row of the group's sum).  Returns the
    output.

    CUDA tensors run the hand-written kernel, the instance
    ``csr_spmm.launch_instance(K, buf, out)`` of the CSR walk (float4
    loads where ``K % 4 == 0`` and ``buf`` and ``out`` start on 16-byte
    boundaries, else scalar ones; kept in ``shard_spmm.last_instance``).
    CPU tensors run :func:`shard_spmm_plain`."""
    _check_group("shard_spmm", rowptr, col, value, buf, row_map)
    dev = buf.device
    if dev.type == "cpu":
        return shard_spmm_plain(rowptr, col, value, buf, out, row_map,
                                n_rows)
    _kernel_checks("shard_spmm", dev, (rowptr, col, value, buf, row_map,
                                       out), (buf, value, out))
    if col.shape[0] >= 2**31:
        raise ValueError("shard_spmm indexes edges with int32")
    R, K = rowptr.shape[0] - 1, buf.shape[1]
    accumulate = out is not None
    if accumulate:
        _check_out("shard_spmm", out, K, buf.dtype, dev)
    else:
        n = _out_rows(R, row_map, n_rows)
        out = (torch.empty((n, K), dtype=torch.float32, device=dev)
               if row_map is None else
               torch.zeros((n, K), dtype=torch.float32, device=dev))
    lib = _kernel_lib()
    rc = lib.shard_spmm_f32(
        dev.index, rowptr.data_ptr(), col.data_ptr(),
        None if value is None else value.data_ptr(), buf.data_ptr(),
        None if row_map is None else row_map.data_ptr(), out.data_ptr(),
        R, K, int(accumulate), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "shard_spmm launch")
    shard_spmm.launches += 1
    shard_spmm.last_instance = launch_instance(K, buf, out)
    return out


shard_spmm.launches = 0
shard_spmm.last_instance = None


# ----------------------------------------------------------------------
# K11b: shard_spmm_minmax
# ----------------------------------------------------------------------

def _extreme(is_min: bool) -> float:
    return float("inf") if is_min else float("-inf")


def combine_minmax(out: torch.Tensor, arg: torch.Tensor, ext: torch.Tensor,
                   eid: torch.Tensor, is_min: bool) -> None:
    """``_combine_minmax`` in place: take ``(ext, eid)`` where it is
    strictly better than ``(out, arg)``, or equal with a lower edge id."""
    better = (ext < out) if is_min else (ext > out)
    better |= (ext == out) & (eid < arg)
    out.copy_(torch.where(better, ext, out))
    arg.copy_(torch.where(better, eid, arg))


def shard_spmm_minmax_plain(
        rowptr: torch.Tensor, col: torch.Tensor,
        value: Optional[torch.Tensor], buf: torch.Tensor, is_min: bool,
        eid_base: int = 0, pos: Optional[torch.Tensor] = None,
        out: Optional[torch.Tensor] = None, arg: Optional[torch.Tensor] = None,
        row_map: Optional[torch.Tensor] = None,
        n_rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the group's extremes by
    ``csr_spmm_minmax_plain`` over its rebased CSR, its positions mapped
    to global ids, then a write or a :func:`combine_minmax`."""
    _check_group("shard_spmm_minmax", rowptr, col, value, buf, row_map, pos)
    R, K = rowptr.shape[0] - 1, buf.shape[1]
    e_lo, e_hi = int(rowptr[0]), int(rowptr[-1])
    ext, a = csr_spmm_minmax_plain(
        rowptr - e_lo, col[e_lo:e_hi],
        None if value is None else value[e_lo:e_hi], buf, is_min)
    E_g = e_hi - e_lo
    empty = a == E_g
    local = torch.where(empty, 0, a).long() + e_lo
    gid = (local if pos is None else pos[local].long()) + int(eid_base)
    gid = torch.where(empty, NO_EDGE, gid).to(INDEX_DTYPE)
    ext = torch.where(empty, _extreme(is_min), ext)
    target = (torch.arange(R, device=buf.device) if row_map is None
              else row_map.long())
    if out is None:
        n = _out_rows(R, row_map, n_rows)
        out = torch.full((n, K), _extreme(is_min),
                         dtype=buf.dtype, device=buf.device)
        arg = torch.full((n, K), NO_EDGE, dtype=INDEX_DTYPE,
                         device=buf.device)
        out[target], arg[target] = ext, gid
        return out, arg
    _check_out("shard_spmm_minmax", out, K, buf.dtype, buf.device)
    o, g_arg = out[target], arg[target]
    combine_minmax(o, g_arg, ext, gid, is_min)
    out[target], arg[target] = o, g_arg
    return out, arg


def shard_spmm_minmax(
        rowptr: torch.Tensor, col: torch.Tensor,
        value: Optional[torch.Tensor], buf: torch.Tensor, is_min: bool,
        eid_base: int = 0, pos: Optional[torch.Tensor] = None,
        out: Optional[torch.Tensor] = None, arg: Optional[torch.Tensor] = None,
        row_map: Optional[torch.Tensor] = None,
        n_rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11b: the group's min (``is_min``) or max against ``buf`` and its
    argout, the global edge id ``eid_base + pos[e]`` (``pos=None``: the
    edge's own index ``e``), written to a new ``(n_rows, K)`` pair or,
    with ``out`` and ``arg``, combined into them in place.  Returns
    ``(out, arg)``.

    CUDA tensors run the hand-written kernel, the instance
    ``csr_spmm.launch_instance(K, buf, out, arg)`` of the min/max walk
    (float4 chunks where ``K % 4 == 0`` and all three start on 16-byte
    boundaries, else scalar ones; kept in
    ``shard_spmm_minmax.last_instance``).  CPU tensors run
    :func:`shard_spmm_minmax_plain`."""
    _check_group("shard_spmm_minmax", rowptr, col, value, buf, row_map, pos)
    if (out is None) != (arg is None):
        raise ValueError("shard_spmm_minmax combines into out and arg "
                         "together")
    dev = buf.device
    if dev.type == "cpu":
        return shard_spmm_minmax_plain(rowptr, col, value, buf, is_min,
                                       eid_base, pos, out, arg, row_map,
                                       n_rows)
    _kernel_checks("shard_spmm_minmax", dev,
                   (rowptr, col, value, buf, pos, row_map, out, arg),
                   (buf, value, out))
    if col.shape[0] >= 2**31 or int(eid_base) + col.shape[0] >= NO_EDGE:
        raise ValueError("shard_spmm_minmax numbers edges with int32")
    R, K = rowptr.shape[0] - 1, buf.shape[1]
    combine = out is not None
    if combine:
        _check_out("shard_spmm_minmax", out, K, torch.float32, dev)
        if arg.shape != out.shape or arg.dtype != INDEX_DTYPE:
            raise ValueError("arg must be int32 of out's shape")
    else:
        n = _out_rows(R, row_map, n_rows)
        if row_map is None:
            out = torch.empty((n, K), dtype=torch.float32, device=dev)
            arg = torch.empty((n, K), dtype=INDEX_DTYPE, device=dev)
        else:
            out = torch.full((n, K), _extreme(is_min),
                             dtype=torch.float32, device=dev)
            arg = torch.full((n, K), NO_EDGE, dtype=INDEX_DTYPE, device=dev)
    lib = _kernel_lib()
    rc = lib.shard_spmm_minmax_f32(
        dev.index, int(bool(is_min)), rowptr.data_ptr(), col.data_ptr(),
        None if value is None else value.data_ptr(), buf.data_ptr(),
        None if pos is None else pos.data_ptr(),
        None if row_map is None else row_map.data_ptr(), out.data_ptr(),
        arg.data_ptr(), R, K, int(eid_base), int(combine),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "shard_spmm_minmax launch")
    shard_spmm_minmax.launches += 1
    shard_spmm_minmax.last_instance = launch_instance(K, buf, out, arg)
    return out, arg


shard_spmm_minmax.launches = 0
shard_spmm_minmax.last_instance = None
