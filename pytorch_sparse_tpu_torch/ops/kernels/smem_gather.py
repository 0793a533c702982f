"""The on-chip gather probe's kernels (``csrc/smem_gather.cu``).

They replace the JAX package's one ``pl.pallas_call``,
``benchmarks/probe_vmem_gather.py:45 _call``, and the design its probe
judged:

* :func:`smem_gather` (K13a): ``table[idx]``, a row gather from a table
  held in shared memory (the probe's ``gather_kernel`` at T = 2048 and
  ``gather8_kernel`` at T = 8, ``take_along_axis`` on a VMEM table).
* :func:`edge_scan_loop` (K13b): ``sum_{i<R} cumsum(h + i, dim=0)``,
  the edge-axis scan a segment reduce is built from, ``R`` passes in one
  launch (the probe's ``_loop_time`` kernel with ``c_body``).
* :func:`tiled_spmm` (K13c): the CSR SpMM of ``csr_spmm`` (K1), with
  X's row tiles staged in shared memory for the (row block, tile) pairs
  that :func:`tiled_spmm_plan` picks, and each edge of such a pair
  gathered from its tile.  It sums each output in CSR edge order with
  the same ``fmaf`` chain as K1, so the two agree bit for bit.  It is
  used by the probe only; no route takes it.

Each wrapper launches its kernel for CUDA tensors (float32 data, int32
indices, contiguous) and runs its plain PyTorch version (``*_plain``)
for CPU tensors.  Other devices raise.  ``<wrapper>.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from ... import _build
from ...utils.convert import INDEX_DTYPE, ptr2ind

ROWS_PER_BLOCK = 256       # K13c: a block's rows (16 warps of 16)
SLAB = 32                  # K13c: a block's columns, one a lane
MAX_SMEM = 232_448         # a block's shared memory on sm_90 (227 KB)

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("smem_gather")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smem_gather_f32.argtypes = [i, p, p, p, i, i, i, i, p]
        lib.edge_scan_loop_f32.argtypes = [i, p, p, i, i, i, p]
        lib.tiled_spmm_f32.argtypes = [i, p, p, p, p, p, p, i, p, i, i, i,
                                       i, p]
        for fn in (lib.smem_gather_f32, lib.edge_scan_loop_f32,
                   lib.tiled_spmm_f32):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _device(name: str, *tensors) -> torch.device:
    """The one device of ``tensors``: "cpu" or "cuda" (others raise)."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name} operands lie on different devices")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name} has no kernel for {dev.type}")
    return dev


def _check_cuda(name: str, floats, ints) -> None:
    for t in floats:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"the {name} kernel takes float32 data, got "
                            f"{t.dtype}")
    for t in ints:
        if t is not None and t.dtype != INDEX_DTYPE:
            raise TypeError(f"the {name} kernel takes int32 indices")
    for t in (*floats, *ints):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")


# ---- K13a --------------------------------------------------------------------

def _check_gather(idx, table) -> None:
    if idx.dim() != 1 or table.dim() != 2:
        raise ValueError("expected idx (n,) and table (T, K)")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError("idx must be an integer tensor")


def _gather_slab(T: int, K: int) -> int:
    """K13a's columns a block: as many as fit ``T`` rows in a block's
    shared memory, at most 32."""
    kc = min(32, K, MAX_SMEM // (4 * T))
    if kc < 1:
        raise ValueError(f"a {T}-row table does not fit in shared memory")
    return kc


def smem_gather_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``table.index_select(0, idx)``."""
    _check_gather(idx, table)
    return table.index_select(0, idx)


def smem_gather(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``(n, K)`` rows ``table[idx]`` of the ``(T, K)`` table.

    On the card the table is staged in shared memory in slabs of
    :func:`_gather_slab` columns (``T`` up to 58,112 rows); ``idx`` must
    lie in ``[0, T)`` (an index outside it gives a NaN row there, and
    raises on the CPU)."""
    _check_gather(idx, table)
    dev = _device("smem_gather", idx, table)
    if dev.type == "cpu":
        return smem_gather_plain(idx, table)
    _check_cuda("smem_gather", [table], [idx])
    (n,), (T, K) = idx.shape, table.shape
    if n and not T:
        raise IndexError("smem_gather: indices into an empty table")
    kc = _gather_slab(T, K) if T else 1
    out = torch.empty((n, K), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    rc = lib.smem_gather_f32(
        dev.index, idx.data_ptr(), table.data_ptr(), out.data_ptr(), n, T, K,
        kc, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "smem_gather launch")
    smem_gather.launches += 1
    return out


smem_gather.launches = 0


# ---- K13b --------------------------------------------------------------------

def _check_scan(h, R) -> None:
    if h.dim() != 2:
        raise ValueError("expected h (T, K)")
    if int(R) < 1:
        raise ValueError(f"R must be at least 1, got {R}")


def edge_scan_loop_plain(h: torch.Tensor, R: int) -> torch.Tensor:
    """Plain PyTorch version: the same loop of ``torch.cumsum``."""
    _check_scan(h, R)
    acc = torch.zeros_like(h)
    for i in range(int(R)):
        acc = acc + torch.cumsum(h + i, dim=0)
    return acc


def edge_scan_loop(h: torch.Tensor, R: int) -> torch.Tensor:
    """``sum_{i<R} cumsum(h + i, dim=0)`` of the ``(T, K)`` float32
    ``h``, the ``R`` passes accumulated in that order inside one launch
    on the card."""
    _check_scan(h, R)
    dev = _device("edge_scan_loop", h)
    if dev.type == "cpu":
        return edge_scan_loop_plain(h, R)
    _check_cuda("edge_scan_loop", [h], [])
    T, K = h.shape
    out = torch.empty_like(h)
    lib = _kernel_lib()
    rc = lib.edge_scan_loop_f32(
        dev.index, h.data_ptr(), out.data_ptr(), T, K, int(R),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "edge_scan_loop launch")
    edge_scan_loop.launches += 1
    return out


edge_scan_loop.launches = 0


# ---- K13c --------------------------------------------------------------------

@dataclass(frozen=True)
class TilePlan:
    """Which (row block, tile) pairs K13c stages: X's rows cut into tiles
    of ``T``, the matrix's rows into blocks of :data:`ROWS_PER_BLOCK`.
    ``stage_ptr`` ``(n_row_blocks + 1,)`` and ``stage_tile`` ``(n_staged,)``
    (int32, on the matrix's device) list each row block's staged tiles
    in ascending order, at most ``max_staged`` a block.  The counts
    describe the matrix it was made for: ``n_pairs`` pairs hold edges;
    the ``n_staged`` staged ones hold ``staged_edges`` edges and
    ``staged_rows`` tile rows in all."""

    T: int
    stage_min: int
    n_rows: int
    n_cols: int
    n_edges: int
    stage_ptr: torch.Tensor
    stage_tile: torch.Tensor
    max_staged: int
    n_pairs: int
    n_staged: int
    staged_edges: int
    staged_rows: int

    def staged_bytes(self, K: int) -> int:
        """Bytes of X the staged tiles read at width ``K`` (float32)."""
        return 4 * K * self.staged_rows

    def smem_bytes(self) -> int:
        """The kernel's shared memory a block: the slot table and the
        most tiles a block stages."""
        return _slot_bytes(self.n_cols, self.T) \
            + 4 * SLAB * self.T * self.max_staged


def _slot_bytes(n_cols: int, T: int) -> int:
    return -(-2 * max(1, -(-n_cols // T)) // 16) * 16


def tiled_spmm_plan(rowptr: torch.Tensor, col: torch.Tensor, n_cols: int,
                    T: int = 256, stage_min: Optional[int] = None
                    ) -> TilePlan:
    """K13c's plan for the CSR structure ``(rowptr, col)`` with
    ``n_cols`` columns and tiles of ``T`` rows (a power of two from 32 to
    1024): a (row block, tile) pair is staged when it holds at least
    ``stage_min`` edges (default ``T``: as many edges as the tile has
    rows, where staging starts to read fewer bytes than gathering), and
    a row block stages at most as many tiles as fit in a block's shared
    memory, those with the most edges.  Pairs without edges are never
    staged; ``stage_min=0`` stages every other one that fits.  Torch glue
    on the structure's device."""
    if T < 32 or T > 1024 or T & (T - 1):
        raise ValueError(f"T must be a power of two in [32, 1024], got {T}")
    stage_min = T if stage_min is None else int(stage_min)
    if rowptr.dtype != INDEX_DTYPE or col.dtype != INDEX_DTYPE:
        raise TypeError("rowptr and col must be int32")
    M, E = rowptr.shape[0] - 1, col.shape[0]
    n_rb = -(-M // ROWS_PER_BLOCK)
    n_t = max(1, -(-n_cols // T))
    if n_t > 32767:
        raise ValueError(f"{n_t} tiles of {T} rows: at most 32767")
    cap = (MAX_SMEM - _slot_bytes(n_cols, T)) // (4 * SLAB * T)
    if E and not 0 <= int(col.min()) <= int(col.max()) < n_cols:
        raise ValueError(f"a column of col lies outside [0, {n_cols})")
    dev = rowptr.device
    row = ptr2ind(rowptr, E).long()
    key = (row // ROWS_PER_BLOCK) * n_t + col.long() // T
    counts = torch.bincount(key, minlength=n_rb * n_t)
    pairs = ((counts > 0) & (counts >= stage_min)).nonzero().squeeze(1)
    # Keep the ``cap`` pairs of each row block with the most edges: order
    # by (row block, count descending), rank within the row block.
    rb = pairs // n_t
    order = torch.argsort(rb * (E + 1) + (E - counts[pairs]), stable=True)
    pairs, rb = pairs[order], rb[order]
    per_rb = torch.bincount(rb, minlength=n_rb)
    first = per_rb.cumsum(0) - per_rb
    rank = torch.arange(pairs.numel(), device=dev) - first[rb]
    pairs = pairs[rank < cap].sort().values
    rb = pairs // n_t
    tile = pairs % n_t
    per_rb = torch.bincount(rb, minlength=n_rb)
    stage_ptr = torch.zeros(n_rb + 1, dtype=torch.long, device=dev)
    stage_ptr[1:] = per_rb.cumsum(0)
    rows = (n_cols - tile * T).clamp(max=T)
    return TilePlan(
        T=T, stage_min=stage_min, n_rows=M, n_cols=n_cols, n_edges=E,
        stage_ptr=stage_ptr.to(INDEX_DTYPE),
        stage_tile=tile.to(INDEX_DTYPE).contiguous(),
        max_staged=int(per_rb.max()) if n_rb else 0,
        n_pairs=int((counts > 0).sum()), n_staged=int(pairs.numel()),
        staged_edges=int(counts[pairs].sum()), staged_rows=int(rows.sum()))


def _check_tiled(rowptr, col, value, x, plan) -> None:
    if rowptr.dtype != INDEX_DTYPE or col.dtype != INDEX_DTYPE:
        raise TypeError("rowptr and col must be int32")
    if rowptr.dim() != 1 or col.dim() != 1 or x.dim() != 2:
        raise ValueError("expected rowptr (M+1,), col (E,) and x (N, K)")
    if value is not None and value.shape != col.shape:
        raise ValueError("value must have the shape of col")
    if (plan.n_rows, plan.n_cols, plan.n_edges) != (
            rowptr.shape[0] - 1, x.shape[0], col.shape[0]):
        raise ValueError(
            f"the plan was made for {plan.n_rows} rows, {plan.n_cols} "
            f"columns and {plan.n_edges} edges, not {rowptr.shape[0] - 1}, "
            f"{x.shape[0]} and {col.shape[0]}")


def tiled_spmm_plain(rowptr: torch.Tensor, col: torch.Tensor,
                     value: Optional[torch.Tensor], x: torch.Tensor,
                     plan: TilePlan) -> torch.Tensor:
    """Plain PyTorch version, tile by tile in ascending order: gather
    each edge's row from its tile ``x[t*T:(t+1)*T]``, scale, and
    ``index_add_`` into the rows.  On the CPU, with columns sorted within
    each row, each output is then summed in CSR order, as
    ``csr_spmm_plain`` sums it."""
    _check_tiled(rowptr, col, value, x, plan)
    _device("tiled_spmm", rowptr, col, value, x)
    M, E, T = rowptr.shape[0] - 1, col.shape[0], plan.T
    row = ptr2ind(rowptr, E)
    tile = col.long() // T
    order = torch.argsort(tile, stable=True)
    counts = torch.bincount(tile, minlength=max(1, -(-x.shape[0] // T)))
    out = x.new_zeros((M, x.shape[1]))
    start = 0
    for t, n in enumerate(counts.tolist()):
        if not n:
            continue
        e = order[start:start + n]
        start += n
        h = x[t * T:(t + 1) * T].index_select(0, col[e].long() - t * T)
        if value is not None:
            h = h * value[e].to(h.dtype)[:, None]
        out.index_add_(0, row[e], h)
    return out


def tiled_spmm(rowptr: torch.Tensor, col: torch.Tensor,
               value: Optional[torch.Tensor], x: torch.Tensor,
               plan: TilePlan) -> torch.Tensor:
    """``(M, K)`` float32 SpMM of the CSR matrix ``(rowptr, col, value)``
    (``value=None``: implicit ones) with ``x`` ``(N, K)``, what
    ``csr_spmm`` computes, staging the tiles of ``plan``
    (:func:`tiled_spmm_plan` of the same structure)."""
    _check_tiled(rowptr, col, value, x, plan)
    dev = _device("tiled_spmm", rowptr, col, value, x)
    if dev.type == "cpu":
        return tiled_spmm_plain(rowptr, col, value, x, plan)
    _check_cuda("tiled_spmm", [value, x],
                [rowptr, col, plan.stage_ptr, plan.stage_tile])
    if plan.stage_ptr.device != dev:
        raise ValueError("the plan lies on another device")
    M, (N, K) = rowptr.shape[0] - 1, x.shape
    out = torch.empty((M, K), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    rc = lib.tiled_spmm_f32(
        dev.index, rowptr.data_ptr(), col.data_ptr(),
        None if value is None else value.data_ptr(), x.data_ptr(),
        plan.stage_ptr.data_ptr(), plan.stage_tile.data_ptr(),
        plan.max_staged, out.data_ptr(), M, N, K, plan.T.bit_length() - 1,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "tiled_spmm launch")
    tiled_spmm.launches += 1
    return out


tiled_spmm.launches = 0
