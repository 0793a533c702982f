"""Large-scale SpGEMM paths: chunked, streaming, diagonal-only, and
the device block split (counterpart of
``pytorch_sparse_tpu/ops/spgemm.py``).

The single-shot plan (``ops/matmul.py: _spspmm_structure``) holds every
product term on the host: O(terms) memory and an O(terms log terms)
sort.  Past ``PLAN_MAX_TERMS`` terms:

* :func:`spspmm_chunked` splits A's rows into chunks of bounded
  expansion, runs the plan per chunk and concatenates; the values stay
  on the device and the product stays differentiable.
* :func:`spspmm_native` runs the Gustavson row merge of the port's host
  library (``csrc/host_spgemm.cpp``, a copy of the JAX package's
  ``native.cpp`` SpGEMM): O(terms) time, O(P) scratch a thread, no sort
  of the term list, each entry summed in float64.  Its values are
  computed off the autograd graph.
* :func:`spspmm_large` is what ``spspmm_sum`` calls past the limit:
  for operands on the CPU :func:`spspmm_native`, unless a value
  requires grad while grad is enabled (the JAX package takes its native
  library for concrete values and the chunked plan under ``jax.grad``);
  otherwise, and for operands on the card, the chunked plan, whose
  numeric pass is the ``plan_numeric`` kernel there.
* :func:`spspmm_stream` yields C in row blocks for products whose
  output need not be held at once, by the same rule.
* :func:`spspmm_diag` computes ``diag(A @ B)`` without forming C.
* :func:`spspmm_stream_device` splits both operands into dense (Bb, Bb)
  blocks and a remainder, computes the block x block share with the
  ``block_spgemm_window`` kernel and the cross terms through
  :func:`spspmm_stream`.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..storage import _to_numpy
from ..tensor import SparseTensor
from ..utils import _native
from ..utils.host_sort import stable_argsort
from .kernels.block_spgemm import block_spgemm_stream
from .kernels.block_spmm import padded_store, store_pitch
from .kernels.hybrid import StoreIndex, _block_store
from .matmul import _expansion_degrees, _Plan, check_pair

# Most product terms the single-shot plan holds on the host (~64M terms,
# about 1.5 GB of transient index arrays), as in the JAX package.
PLAN_MAX_TERMS = 1 << 26


def expansion_terms(A: SparseTensor, B: SparseTensor) -> int:
    """Exact number of product terms of ``A @ B``."""
    return int(_expansion_degrees(A.storage.numpy_view("col"),
                                  B.storage.numpy_view("rowptr")).sum())


def _row_chunks(A: SparseTensor, B: SparseTensor,
                max_terms: int) -> Tuple[np.ndarray, list]:
    """Split A's rows into ``[lo, hi)`` chunks of at most ``max_terms``
    expansion terms each (a row that alone exceeds it gets its own
    chunk)."""
    rowptrA = A.storage.numpy_view("rowptr")
    cum = np.concatenate([[0], np.cumsum(_expansion_degrees(
        A.storage.numpy_view("col"), B.storage.numpy_view("rowptr")))])
    row_cum = cum[rowptrA]  # expansion terms before each row
    M = rowptrA.shape[0] - 1
    chunks = []
    lo = 0
    while lo < M:
        hi = int(np.searchsorted(row_cum, row_cum[lo] + max_terms,
                                 side="right")) - 1
        hi = min(max(hi, lo + 1), M)
        chunks.append((lo, hi))
        lo = hi
    return rowptrA, chunks


def _value_dtype(A: SparseTensor, B: SparseTensor) -> Optional[torch.dtype]:
    """The product's value dtype: None when both values are implicit
    ones, else the promoted dtype of the values present."""
    va, vb = A.storage.value(), B.storage.value()
    if va is None and vb is None:
        return None
    if va is None:
        return vb.dtype
    if vb is None:
        return va.dtype
    return torch.promote_types(va.dtype, vb.dtype)


def spspmm_chunked(A: SparseTensor, B: SparseTensor,
                   max_terms: int = PLAN_MAX_TERMS) -> SparseTensor:
    """Differentiable chunked SpGEMM; host memory bounded by
    ``max_terms`` terms a chunk."""
    check_pair(A, B)
    M, P = A.sparse_size(0), B.sparse_size(1)
    valueA, valueB = A.storage.value(), B.storage.value()
    rowptrA, chunks = _row_chunks(A, B, max_terms)
    rows, cols, vals = [], [], []
    for lo, hi in chunks:
        plan = _Plan(A, B, int(rowptrA[lo]), int(rowptrA[hi]))
        rows.append(plan.rowC)
        cols.append(plan.colC)
        v = plan.numeric(valueA, valueB)
        if v is not None:
            vals.append(v)
    dtype = _value_dtype(A, B)
    value = None
    if vals:
        value = torch.cat(vals)
    elif dtype is not None:
        value = torch.zeros(0, dtype=dtype, device=A.device())
    empty = np.zeros(0, np.int64)
    return SparseTensor(
        row=np.concatenate(rows) if rows else empty,
        col=np.concatenate(cols) if cols else empty, value=value,
        sparse_sizes=(M, P), is_sorted=True, trust_data=True,
        device=A.device())


def _host_f64(value: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    """One host float64 copy of a value array (one pull from the card)."""
    return None if value is None else _to_numpy(value).astype(np.float64)


def _takes_native(A: SparseTensor, B: SparseTensor) -> bool:
    """The host Gustavson serves a product of operands on the CPU unless
    a value requires grad while grad is enabled (its values are computed
    off the graph).  Operands on the card take the plan, whose numeric
    pass is the ``plan_numeric`` kernel."""
    grad = torch.is_grad_enabled() and any(
        v is not None and v.requires_grad
        for v in (A.storage.value(), B.storage.value()))
    return A.device().type == "cpu" and not grad


def _native_value(valC: Optional[np.ndarray], dtype: Optional[torch.dtype],
                  device) -> Optional[torch.Tensor]:
    """The float64 sums cast to the product's dtype, on ``device``
    (torch rounds float64 to bfloat16 and float16 through float32, as
    numpy's ``astype`` does in the JAX package)."""
    if valC is None:
        return None
    return torch.from_numpy(valC).to(dtype).to(device)


def spspmm_native(A: SparseTensor, B: SparseTensor) -> SparseTensor:
    """``A @ B`` by the host library's Gustavson SpGEMM: values are
    pulled once as float64 host copies and each output entry is summed
    in float64 in A's row order, then cast to the product's dtype.  The
    result lies on ``A``'s device; its values carry no gradient.
    :func:`spspmm_large` calls it for operands on the CPU only."""
    check_pair(A, B)
    M, P = A.sparse_size(0), B.sparse_size(1)
    rowptrC, colC, valC = _native.spgemm(
        A.storage.numpy_view("rowptr"), A.storage.numpy_view("col"),
        _host_f64(A.storage.value()),
        B.storage.numpy_view("rowptr"), B.storage.numpy_view("col"),
        _host_f64(B.storage.value()), P)
    return SparseTensor(
        rowptr=rowptrC, col=colC,
        value=_native_value(valC, _value_dtype(A, B), A.device()),
        sparse_sizes=(M, P), is_sorted=True, trust_data=True,
        device=A.device())


def spspmm_large(A: SparseTensor, B: SparseTensor) -> SparseTensor:
    """Products above ``PLAN_MAX_TERMS``: :func:`spspmm_native` or the
    chunked plan, as :func:`_takes_native` chooses."""
    if _takes_native(A, B):
        return spspmm_native(A, B)
    return spspmm_chunked(A, B)


def spspmm_stream(
    A: SparseTensor, B: SparseTensor, max_terms: int = PLAN_MAX_TERMS,
    raw: bool = False,
) -> Iterator[Tuple[int, int, object]]:
    """Yield ``(row_lo, row_hi, C[row_lo:row_hi])`` blocks of
    ``C = A @ B``, each a ``(row_hi - row_lo, P)`` SparseTensor with
    local row ids on the operands' device, holding at most ``max_terms``
    expansion terms.

    The blocks come from the host Gustavson or from the plan (the
    ``plan_numeric`` kernel on CUDA), as :func:`spspmm_large` chooses.
    ``raw=True`` yields ``(lo, hi, (rowptr, col, value))`` host numpy
    arrays instead, detached from autograd: int64 indices, and values in
    the product's promoted dtype (numpy has no bfloat16: a bfloat16
    product comes as float32 holding the bfloat16 values), or None for
    implicit ones."""
    check_pair(A, B)
    P = B.sparse_size(1)
    valueA, valueB = A.storage.value(), B.storage.value()
    native = _takes_native(A, B)
    if raw:
        valueA = None if valueA is None else valueA.detach()
        valueB = None if valueB is None else valueB.detach()
    rowptrA, chunks = _row_chunks(A, B, max_terms)
    if native:
        dtype = _value_dtype(A, B)
        colA, va = A.storage.numpy_view("col"), _host_f64(valueA)
        rowptrB, colB = (B.storage.numpy_view("rowptr"),
                         B.storage.numpy_view("col"))
        vb = _host_f64(valueB)
    for lo, hi in chunks:
        if native:
            rp, col, valC = _native.spgemm(rowptrA, colA, va, rowptrB, colB,
                                           vb, P, row_lo=lo, row_hi=hi)
            value = _native_value(valC, dtype, A.device())
        else:
            plan = _Plan(A, B, int(rowptrA[lo]), int(rowptrA[hi]))
            value = plan.numeric(valueA, valueB)
            col = plan.colC
            rp = np.searchsorted(plan.rowC - lo, np.arange(hi - lo + 1))
        if raw:
            yield lo, hi, (rp, col,
                           None if value is None else _to_numpy(value))
            continue
        yield lo, hi, SparseTensor(
            rowptr=rp, col=col, value=value, sparse_sizes=(hi - lo, P),
            is_sorted=True, trust_data=True, device=A.device())


def spspmm_diag(A: SparseTensor, B: SparseTensor) -> torch.Tensor:
    """``diag(A @ B)`` without forming the product: for each A entry
    (i, k), find B[k, i] by binary search in B's sorted (row, col) keys
    and add valA * valB (in float64) into ``diag[i]``, in A's order.
    Host work, O(nnz(A) log nnz(B)); the result lies on the operands'
    device in the product's dtype (float32 for implicit ones)."""
    check_pair(A, B)
    M, P = A.sparse_size(0), B.sparse_size(1)
    D = min(M, P)
    dev = A.device()
    rowA = A.storage.numpy_view("row")
    colA = A.storage.numpy_view("col")
    rowB = B.storage.numpy_view("row")
    colB = B.storage.numpy_view("col")
    dtype = _value_dtype(A, B)
    out_dtype = torch.float32 if dtype is None else dtype
    if rowB.shape[0] == 0 or rowA.shape[0] == 0:
        return torch.zeros(D, dtype=out_dtype, device=dev)
    keyB = rowB * P + colB  # sorted ascending (COO invariant)
    sel = rowA < P  # only (i, k) with i a valid B column reach the diagonal
    q = colA[sel] * P + rowA[sel]
    # The searches run in ascending order of the queries (one stable
    # sort): the positions a search in A's order finds, without the cache
    # misses of random probes (on phase 21's 115M-edge graph 24-26 s
    # against 221-222 s on an H100 machine's host, including the sort;
    # ``tools/time_spspmm_diag.py``).
    order = stable_argsort(q)
    pos = np.empty_like(q)
    pos[order] = np.searchsorted(keyB, q[order])
    pos_c = np.minimum(pos, keyB.shape[0] - 1)
    hit = (pos < keyB.shape[0]) & (keyB[pos_c] == q)
    va, vb = A.storage.value(), B.storage.value()
    ta = (np.ones(q.shape[0]) if va is None
          else _to_numpy(va).astype(np.float64)[sel])
    tb = (np.ones(q.shape[0]) if vb is None
          else _to_numpy(vb).astype(np.float64)[pos_c])
    diag = np.zeros(D, np.float64)
    np.add.at(diag, rowA[sel][hit], (ta * tb)[hit])
    return torch.from_numpy(diag).to(device=dev, dtype=out_dtype)


# ----------------------------------------------------------------------
# Device block SpGEMM: the dense-block x dense-block share of the product
# runs on the block_spgemm_window kernel; the cross terms stream through
# the plan path.
# ----------------------------------------------------------------------

def _block_split(T: SparseTensor, Bb: int, min_density: float,
                 block_dtype: Optional[torch.dtype] = None):
    """Split ``T`` into dense (Bb, Bb) blocks and a COO remainder.

    Returns ``(blocks, srow, scol, remainder, dense_nnz, mask)``:
    ``blocks`` a ``(nb, Bb, Bb)`` tensor on ``T``'s device (float32, or
    ``block_dtype``, written there with rows padded to 16 bytes for
    the block kernels, ``block_spmm.padded_store``; None when no block
    holds at least ``min_density * Bb^2`` edges, and at least 2), the
    host block coordinates ``srow``/
    ``scol``, the SparseTensor of every edge outside the blocks (``T``
    itself when there are none), the number of edges inside, and the
    host boolean ``mask`` of those edges in ``T``'s order.  Implicit
    values densify as 1.0; duplicate edges add up."""
    M, N = T.sparse_sizes()
    row = T.storage.numpy_view("row")
    col = T.storage.numpy_view("col")
    v = T.storage.value()
    nbc = -(-N // Bb)
    bid = (row // Bb) * nbc + col // Bb
    ub, cnt = np.unique(bid, return_counts=True)
    dense_ids = ub[cnt >= max(min_density * Bb * Bb, 2.0)]
    if dense_ids.size == 0:
        return None, None, None, T, 0, np.zeros(row.shape[0], bool)
    mask = np.isin(bid, dense_ids)
    ids = np.flatnonzero(mask)
    slot = np.searchsorted(dense_ids, bid[ids])
    store = torch.float32 if block_dtype is None else block_dtype
    # Flat offsets (slot*Bb + r)*Bp + c, in the padded buffer, reach past
    # int32 at real sizes.
    index = StoreIndex((slot * Bb + row[ids] % Bb) * store_pitch(Bb, store)
                       + col[ids] % Bb, ids, row.shape[0], T.device())
    blocks = _block_store(index, None if v is None else v.detach().float(),
                          dense_ids.size, Bb, store, T.device())
    rest = ~mask
    remainder = SparseTensor(
        row=row[rest], col=col[rest],
        value=None if v is None else v[torch.from_numpy(
            np.flatnonzero(rest)).to(v.device)],
        sparse_sizes=(M, N), is_sorted=True, trust_data=True,
        device=T.device())
    return (blocks, dense_ids // nbc, dense_ids % nbc, remainder,
            int(ids.size), mask)


def _dense_part(T: SparseTensor, mask: np.ndarray) -> SparseTensor:
    """``T``'s edges inside the dense blocks of a split: the complement
    of its remainder, taken from the split's own mask."""
    v = T.storage.value()
    return SparseTensor(
        row=T.storage.numpy_view("row")[mask],
        col=T.storage.numpy_view("col")[mask],
        value=None if v is None else v[torch.from_numpy(
            np.flatnonzero(mask)).to(v.device)],
        sparse_sizes=T.sparse_sizes(), is_sorted=True, trust_data=True,
        device=T.device())


def spspmm_stream_device(
    A: SparseTensor, B: SparseTensor, Bb: int = 512,
    min_density: float = 0.05, max_out_blocks: int = 2048,
    max_terms: int = PLAN_MAX_TERMS, split_A=None, split_B=None,
    raw_coo: bool = False, block_dtype: Optional[torch.dtype] = None,
):
    """Yield ``C = A @ B`` as pieces that add up to it:

    * ``("blocks", rows, cols, Cblk)``: dense ``(n, Bb, Bb)`` float32
      output blocks at host block coordinates ``rows``/``cols`` (the
      dense-block x dense-block share, ``block_spgemm_window``);
    * ``("coo", lo, hi, block)``: a row block of cross terms from
      :func:`spspmm_stream` (a SparseTensor, or host triples with
      ``raw_coo=True``).

    With ``D``/``R`` the dense and remainder parts of each operand, the
    pieces are ``D_A @ D_B``, ``A @ R_B`` and ``R_A @ D_B``, which
    partition the product's terms exactly.  ``split_A``/``split_B`` are
    :func:`_block_split` results to reuse (for ``A @ A`` pass one for
    both); ``D_B`` is always taken from ``B``'s split itself, so a split
    built with other parameters keeps the partition exact (the JAX
    package rebuilds it from this call's ``Bb``/``min_density``, which
    then disagrees).  Both splits must use one ``Bb``.  Operands with no
    dense block stream through :func:`spspmm_stream` alone."""
    check_pair(A, B)
    if split_A is None:
        split_A = _block_split(A, Bb, min_density, block_dtype)
    if split_B is None:
        split_B = (split_A if B is A
                   else _block_split(B, Bb, min_density, block_dtype))
    blkA, srA, scA, remA, _, _ = split_A
    blkB, srB, scB, remB, _, maskB = split_B
    if blkA is None or blkB is None:
        for lo, hi, blk in spspmm_stream(A, B, max_terms, raw=raw_coo):
            yield ("coo", lo, hi, blk)
        return
    if blkA.shape[1] != blkB.shape[1]:
        raise ValueError(f"the splits use block sizes {blkA.shape[1]} and "
                         f"{blkB.shape[1]}; the block product needs one")
    if blkA.dtype != blkB.dtype:
        blkB = padded_store(blkB.shape[0], blkB.shape[1], blkA.dtype,
                            blkB.device).copy_(blkB)
    for rows, cols, cblk in block_spgemm_stream(
            blkA, srA, scA, blkB, srB, scB, max_out_blocks=max_out_blocks):
        yield ("blocks", rows, cols, cblk)
    for lo, hi, blk in spspmm_stream(A, remB, max_terms, raw=raw_coo):
        yield ("coo", lo, hi, blk)
    DB = _dense_part(B, maskB)
    if DB.nnz() > 0:
        for lo, hi, blk in spspmm_stream(remA, DB, max_terms, raw=raw_coo):
            yield ("coo", lo, hi, blk)
