"""The on-chip gather probe's kernels (``csrc/smem_gather.cu``).

They replace the JAX package's one ``pl.pallas_call``,
``benchmarks/probe_vmem_gather.py:45 _call``, and the design its probe
judged:

* :func:`smem_gather` (K13a): ``table[idx]``, a row gather from a table
  held in shared memory (the probe's ``gather_kernel`` at T = 2048 and
  ``gather8_kernel`` at T = 8, ``take_along_axis`` on a VMEM table),
  each block holding a float4-wide column slab of every row
  (:func:`gather_shape`).
* :func:`edge_scan_loop` (K13b): ``sum_{i<R} cumsum(h + i, dim=0)``,
  the edge-axis scan a segment reduce is built from, ``R`` passes in one
  launch (the probe's ``_loop_time`` kernel with ``c_body``), with ``h``
  and the running sum held on chip for all ``R`` passes
  (:func:`scan_instance`).
* :func:`tiled_spmm` (K13c): the CSR SpMM of ``csr_spmm`` (K1), with
  X's row tiles staged in shared memory for the (row block, tile) pairs
  that :func:`tiled_spmm_plan` picks, and each edge of such a pair
  gathered from its tile.  It walks as K1 does, over column slabs
  (:func:`tiled_instance`), and sums each output in CSR edge order with
  the same ``fmaf`` chain, so the two agree bit for bit.  It is used by
  the probe only; no route takes it.

Each wrapper launches its kernel for CUDA tensors (float32 data, int32
indices, contiguous) and runs its plain PyTorch version (``*_plain``)
for CPU tensors.  Other devices raise.  ``<wrapper>.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ... import _build
from ...utils.convert import INDEX_DTYPE, ptr2ind

ROWS_PER_BLOCK = 256       # K13c: a block's rows
SLAB = 32                  # K13c: a block's column slab (16 was slower)
MAX_SMEM = 232_448         # a block's shared memory on sm_90 (227 KB)
# K13c's budget a block: two blocks and their 1 KB reserves fill an SM's
# 228 KB, so that one block's staging overlaps another's walk.
BLOCK_SMEM = 115_712
SMS = 132                  # an H100 SXM's SMs: K13a's grids fill them
SLAB_ROWS = 64             # K13a: output rows a block, at least

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("smem_gather")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smem_gather_f32.argtypes = [p, p, p, p, p]
        lib.edge_scan_loop_f32.argtypes = [i, p, p, i, i, i, i, i, p]
        lib.tiled_spmm_f32.argtypes = [i, p, p, p, p, p, p, i, p, i, i, i,
                                       i, i, i, p]
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


_raw_stream = None


def _stream(index: int) -> int:
    """The raw handle of card ``index``'s current stream, without building
    a ``torch.cuda.Stream`` (a microsecond a call, where K13a's kernel
    takes about as long).  ``torch._C._cuda_getCurrentRawStream`` is
    private; where a build lacks it, the public handle serves."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(index)


# ---- K13a --------------------------------------------------------------------

class GatherShape(NamedTuple):
    """K13a's launch: ``vec`` columns a block's slab (4: 16-byte copies,
    1: scalar), ``col_tiles`` slabs on ``gridDim.y`` and ``grid_x``
    blocks on ``gridDim.x``, which split the output rows."""
    vec: int
    col_tiles: int
    grid_x: int


@functools.lru_cache(maxsize=64)
def gather_shape(T: int, K: int, n: int, aligned: bool) -> GatherShape:
    """K13a's launch for ``n`` rows of a ``(T, K)`` table, whose table and
    output start on 16-byte boundaries (``aligned``) or not: a float4-wide
    slab of all ``T`` rows a block (a one-column slab past 14,528 rows,
    up to 58,112), and as many row chunks as keep the grid within one
    wave of :data:`SMS` blocks, at :data:`SLAB_ROWS` output rows a chunk
    at least.  Cached: each launch asks for it."""
    vec = 4 if aligned and K % 4 == 0 and 16 * T <= MAX_SMEM else 1
    if 4 * T > MAX_SMEM:
        raise ValueError(f"a {T}-row column does not fit in a block's "
                         "shared memory")
    tiles = K // vec
    return GatherShape(vec, tiles,
                       max(1, min(SMS // tiles, -(-n // SLAB_ROWS))))


def _check_gather(idx, table) -> None:
    if idx.dim() != 1 or table.dim() != 2:
        raise ValueError("expected idx (n,) and table (T, K)")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError("idx must be an integer tensor")


def smem_gather_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``table.index_select(0, idx)``."""
    _check_gather(idx, table)
    return table.index_select(0, idx)


@functools.lru_cache(maxsize=64)
def _gather_args(device: int, T: int, K: int, n: int, aligned: bool):
    """The launch's constant arguments packed as the C entry reads them
    (``device, n, T, K, vec, grid_x``): one pointer a call where six
    ``int`` conversions would take microseconds.  Returns ``(address,
    array)``; the array lives while the cache or a caller holds it."""
    sh = gather_shape(T, K, n, aligned)
    arr = (ctypes.c_int * 6)(device, n, T, K, sh.vec, sh.grid_x)
    return ctypes.addressof(arr), arr


_gather_launch = None


def smem_gather(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``(n, K)`` rows ``table[idx]`` of the ``(T, K)`` table.

    On the card the table is staged in shared memory
    (:func:`gather_shape`); ``idx`` must lie in ``[0, T)`` (an index
    outside it gives a NaN row there, and raises on the CPU).  At the
    probe's sizes the call's host path takes longer than the kernel, so
    the card's path makes only O(1) checks, takes the launch's arguments
    from a cache, and passes five pointers to C."""
    global _gather_launch
    _check_gather(idx, table)
    if not table.is_cuda:
        _device("smem_gather", idx, table)
        return smem_gather_plain(idx, table)
    if idx.dtype != INDEX_DTYPE:
        raise TypeError("the smem_gather kernel takes int32 indices")
    if table.dtype != torch.float32:
        raise TypeError(f"the smem_gather kernel takes float32 data, got "
                        f"{table.dtype}")
    dev = table.get_device()
    if idx.get_device() != dev:
        raise ValueError("smem_gather operands lie on different devices")
    if not (idx.is_contiguous() and table.is_contiguous()):
        raise ValueError("smem_gather operands must be contiguous")
    n = idx.shape[0]
    T, K = table.shape
    out = table.new_empty(n, K)  # two ints parse faster than a tuple
    if n == 0 or K == 0:
        return out
    if T == 0:
        raise IndexError("smem_gather: indices into an empty table")
    tp, op = table.data_ptr(), out.data_ptr()
    # ``arr`` keeps the arguments alive should the cache drop them.
    args, arr = _gather_args(dev, T, K, n, (tp | op) % 16 == 0)
    if _gather_launch is None:
        _gather_launch = _kernel_lib().smem_gather_f32
    rc = _gather_launch(args, idx.data_ptr(), tp, op, _stream(dev))
    if rc:
        _build.check(_kernel_lib(), rc, "smem_gather launch")
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


SCAN_ROWS = 8              # K13b: rows a thread (kScanRows)
SCAN_MAX_ROWS = SCAN_ROWS * 512   # K13b: rows of the on-chip scan's block


class ScanInstance(NamedTuple):
    """K13b's launch: the streaming kernel (``streaming``: ``h`` re-read
    and ``out`` updated every pass), or the on-chip scan over slabs of
    ``vec`` columns (4: 16-byte loads and stores)."""
    streaming: bool
    vec: int


@functools.lru_cache(maxsize=256)
def scan_instance(T: int, K: int, aligned: bool) -> ScanInstance:
    """The on-chip scan for ``(T, K)`` up to ``SCAN_MAX_ROWS`` rows, else
    the streaming kernel.  ``vec`` is 4 where K % 4 == 0 and ``h`` and
    ``out`` lie on 16-byte boundaries (``aligned``), else 1."""
    if T > SCAN_MAX_ROWS:
        return ScanInstance(True, 1)
    return ScanInstance(False, 4 if K % 4 == 0 and aligned else 1)


def launch_scan_instance(h: torch.Tensor, R: int, inst: ScanInstance
                         ) -> torch.Tensor:
    """K13b on the card in the instance ``inst`` (the wrapper's own
    choice, or another for a measurement)."""
    T, K = h.shape
    out = torch.empty_like(h)
    lib = _kernel_lib()
    rc = lib.edge_scan_loop_f32(
        h.device.index, h.data_ptr(), out.data_ptr(), T, K, int(R),
        int(inst.streaming), inst.vec, _stream(h.device.index))
    _build.check(lib, rc, f"edge_scan_loop launch ({inst})")
    return out


def edge_scan_loop(h: torch.Tensor, R: int) -> torch.Tensor:
    """``sum_{i<R} cumsum(h + i, dim=0)`` of the ``(T, K)`` float32
    ``h``, the ``R`` passes accumulated in that order inside one launch
    on the card, in :func:`scan_instance`'s instance (kept in
    ``edge_scan_loop.last_instance``)."""
    _check_scan(h, R)
    dev = _device("edge_scan_loop", h)
    if dev.type == "cpu":
        return edge_scan_loop_plain(h, R)
    _check_cuda("edge_scan_loop", [h], [])
    T, K = h.shape
    inst = scan_instance(T, K, h.data_ptr() % 16 == 0)
    out = launch_scan_instance(h, R, inst)
    edge_scan_loop.last_instance = inst
    edge_scan_loop.launches += 1
    return out


edge_scan_loop.launches = 0
edge_scan_loop.last_instance = None


# ---- K13c --------------------------------------------------------------------

class TiledInstance(NamedTuple):
    """One instance of K13c's walk: ``vec`` columns a chunk (4: float4
    loads, 1: scalar), ``lanes`` a row, ``rows_per_warp`` rows a warp at
    once, a slab of ``width = vec * lanes`` columns a block, and
    ``col_tiles`` slabs (``gridDim.y``).  Lane ``s`` of a row owns, in
    slab ``t``, the columns ``t * width + s * vec + q`` for ``q < vec``."""
    vec: int
    lanes: int
    rows_per_warp: int
    width: int
    col_tiles: int


def _next_pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


@functools.lru_cache(maxsize=64)
def tiled_instance(K: int, aligned: bool) -> TiledInstance:
    """The instance K13c runs at width ``K`` (``K >= 1``) when ``x`` and
    the output start on 16-byte boundaries (``aligned``) or not: float4
    chunks where ``K % 4 == 0`` and aligned, else scalar ones; a slab of
    :data:`SLAB` columns, narrowed to the power of two ``K`` needs; the
    lanes that cover it at ``vec`` columns a lane."""
    vec = 4 if aligned and K % 4 == 0 else 1
    width = min(SLAB, max(vec, _next_pow2(K)))
    lanes = width // vec
    return TiledInstance(vec, lanes, 32 // lanes, width, -(-K // width))


def tile_cap(n_cols: int, T: int) -> int:
    """The most tiles of ``T`` rows a block of K13c stages, each
    :data:`SLAB` columns wide: what fits in :data:`BLOCK_SMEM` beside the
    slot table."""
    return (BLOCK_SMEM - _slot_bytes(n_cols, T)) // (4 * SLAB * T)


@dataclass(frozen=True)
class TilePlan:
    """Which (row block, tile) pairs K13c stages: X's rows cut into tiles
    of ``T``, the matrix's rows into blocks of :data:`ROWS_PER_BLOCK`.
    ``stage_ptr`` ``(n_row_blocks + 1,)`` and ``stage_tile`` ``(n_staged,)``
    (int32, on the matrix's device) list each row block's staged tiles
    in ascending order, at most ``max_staged`` a block, each
    :data:`SLAB` columns wide in shared memory.  The counts
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
        most tiles a block stages (at most :data:`BLOCK_SMEM`)."""
        if not self.max_staged:
            return 0
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
    a row block stages at most :func:`tile_cap` tiles, those with the
    most edges.  Pairs without edges are never staged; ``stage_min=0``
    stages every other one that fits.  Torch glue on the structure's
    device."""
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
    cap = tile_cap(n_cols, T)
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
    (:func:`tiled_spmm_plan` of the same structure).  On the card the
    instance is ``tiled_instance(K, aligned)``, kept in
    ``tiled_spmm.last_instance``."""
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
    if M == 0 or K == 0:
        return out
    inst = tiled_instance(K, (x.data_ptr() | out.data_ptr()) % 16 == 0)
    lib = _kernel_lib()
    rc = lib.tiled_spmm_f32(
        dev.index, rowptr.data_ptr(), col.data_ptr(),
        None if value is None else value.data_ptr(), x.data_ptr(),
        plan.stage_ptr.data_ptr(), plan.stage_tile.data_ptr(),
        plan.max_staged, out.data_ptr(), M, N, K, plan.T.bit_length() - 1,
        inst.vec, inst.lanes, _stream(dev.index))
    _build.check(lib, rc, "tiled_spmm launch")
    tiled_spmm.launches += 1
    tiled_spmm.last_instance = inst
    return out


tiled_spmm.launches = 0
tiled_spmm.last_instance = None
