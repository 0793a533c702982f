"""Hybrid block-dense + CSR SpMM, and the whole-matrix dense route.

PyTorch counterpart of ``pytorch_sparse_tpu/ops/kernels/hybrid.py``.  On
community graphs laid out community-contiguously, most edges fall into
a few (B, B) blocks that are dense enough to store densely; their SpMM
becomes block products (``block_spmm``) and the remaining edges run
through the CSR kernel (``csr_spmm``).  When the whole matrix clears the
densify threshold, :class:`DenseFormat` stores it as one dense matrix
and the SpMM is one matrix product.

Format (structure built host-side; values written on the device):

* ``blocks``   (nb+1, B, B) dense block values in (row-block, col-block)
  order; slot ``nb`` is an all-zero block, kept as in the JAX format.
  Where a row of B values is not 16 bytes, ``blocks`` is the (nb+1, B,
  B) view of a buffer with padded rows (``block_spmm.padded_store``),
  which the block kernels read without a copy.
* ``slot_row`` / ``slot_col`` (nb,) int32 block coordinates of each
  slot, sorted by row-block; ``rb_ptr`` (R+1,) int32 points into them
  per row-block.
* ``order_t`` (nb,) int32, the transpose schedule: the slots stably
  sorted by column block, as the JAX format's ``order_t``; ``cb_ptr``
  (C+1,) int32 points into it per column block.
* ``rest`` — the edges outside dense blocks as a CSR
  ``(rowptr, col, value)`` in CSR edge order, or None; ``rest_t`` the
  same edges as a CSC ``(colptr, row, value)`` sorted by (col, row), or
  None.

* ``row_map`` / ``M_pad``: on a block-aligned layout
  (:func:`build_hybrid_from_tensor` with a ``partptr``), node ``i`` lives
  at padded position ``row_map[i]`` of the ``(M_pad, M_pad)`` internal
  matrix, so that every part starts on a block boundary; else None / 0.

Forward (:func:`hybrid_spmm`) and transpose (:func:`hybrid_spmm_t`, the
``grad_mat`` pass)::

    out = block_spmm(blocks, slot_col, rb_ptr, pad(x))[:M]
    out = out + csr_spmm(rest, x)          # remainder added after
    out_t = block_spmm_t(blocks, slot_row, order_t, cb_ptr, pad(g))[:N]
    out_t = out_t + csr_spmm(rest_t, g)

Both are differentiable in the operand and in the store (``blocks``, or
``dense`` of a :class:`DenseFormat`), as the JAX package's custom VJP
``_mxu_einsum`` is: each direction's operand gradient is the other
direction, and the store's gradient is the ``block_spmm_dblocks`` kernel
(a matrix product for the dense store), run only when the store
requires grad.  The remainder's CSR values get no gradient.

The block and dense stores hold copies of the values.  Each view keeps
a :class:`StoreIndex` on its device (where every edge's value lands in
the store and in the remainder) and ``source``, a copy of the values it
holds.  :func:`refresh_plan` compares a storage's current values with
``source`` (one pass over the values, bit for bit, on the device) and,
where they differ, writes a new store from them there: duplicates added
in edge order, a bf16 store rounded once, no host work.  So a write to
``value`` of any kind, an optimizer step or a write through ``.data``,
reaches the next routed product.  The storage layer calls it on every
routed call, and drops the view on ``set_value``.  The host waits for
the compare's result, so a routed call cannot be captured in a CUDA
graph.  Autograd nodes save a view's store with ``save_for_backward``
(and keep the rest of the view), so that it is freed after the
backward and a refresh in a training loop holds one store at a time.

The densify break-even (:func:`block_break_even`) and the router that
uses it keep the JAX package's rule and constants, which were priced
for a TPU v5e; they are unchanged here so that both packages route a
graph alike, and have not been re-priced for this port's GPU.
"""

from __future__ import annotations

import copy
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ...typing import DeviceLike, resolve_device
from ...utils.host_sort import lexsort2, stable_argsort
from .block_spmm import (
    block_spmm, block_spmm_dblocks, block_spmm_t, padded_store, store_layout,
    store_pitch)
from .csr_spmm import csr_spmm

# ----------------------------------------------------------------------
# Precision of the bf16-store dense route.  "high" splits an f32
# operand into two bf16 terms, "highest" into three, "default" casts it
# to bf16 once, as the JAX package's Precision.HIGH/HIGHEST/DEFAULT do
# in ``_dense_matmul``.  The block kernel and the f32 routes compute in
# full fp32 at every setting.
# ----------------------------------------------------------------------

_PRECISION_PARTS = {"default": 1, "high": 2, "highest": 3}
_BLOCK_PRECISION = "high"


def set_block_precision(precision: str) -> None:
    """Set the split of the bf16-store dense route: ``"default"``,
    ``"high"`` (the library default) or ``"highest"``."""
    global _BLOCK_PRECISION
    if precision not in _PRECISION_PARTS:
        raise ValueError(f"precision must be one of {list(_PRECISION_PARTS)}")
    _BLOCK_PRECISION = precision


def get_block_precision() -> str:
    return _BLOCK_PRECISION


# ----------------------------------------------------------------------
# Store dtype rule: bf16 when the values' measured quantization error
# fits the declared budget (default 0.0: lossless only).
# ----------------------------------------------------------------------

_STORE_BUDGET = 0.0


def set_store_budget(rel_err: float) -> None:
    """Declare the acceptable relative output error from storing dense
    blocks in bf16.  Default 0.0: bf16 only when values round-trip
    exactly (e.g. implicit ones)."""
    global _STORE_BUDGET
    _STORE_BUDGET = float(rel_err)


def get_store_budget() -> float:
    return _STORE_BUDGET


def quantization_rel_err(values) -> float:
    """RMS relative error of storing ``values`` (a tensor on any device,
    or numpy) in bf16.  ``None`` (implicit ones) is exact.  Rounds with
    ``torch.bfloat16`` (round-to-nearest-even)."""
    if values is None:
        return 0.0
    t = (values.detach() if isinstance(values, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(values)))
    if not t.is_floating_point() or t.numel() == 0:
        return 0.0
    t = t.double()
    denom = float(t.square().mean().sqrt())
    if denom == 0.0:
        return 0.0
    d = t - t.to(torch.bfloat16).double()
    return float(d.square().mean().sqrt()) / denom


# The JAX package's break-even constants, measured on a TPU v5e
# (pytorch_sparse_tpu/ops/kernels/hybrid.py:174-177).  They decide the
# route only; no time in this package is derived from them.
_HBM_BW = 819e9
_MXU_BF16 = 197e12
_ELL_NS_PER_NNZ = 2.9


def block_break_even(B: int, K_hint: int = 128, elem: int = 4,
                     passes: float = 3.0) -> float:
    """Minimum block density at which the JAX package's cost model
    prefers a dense block to per-edge gathers."""
    t_block = (
        passes * (B * B * elem + 3 * B * K_hint * 4) / _HBM_BW
        + 2.0 * B * B * K_hint / _MXU_BF16
    )
    ell_ns = _ELL_NS_PER_NNZ * (0.7 + 0.3 * K_hint / 128.0)
    edges = t_block / (ell_ns * 1e-9)
    return min(edges / (B * B), 1.0)


_Csr = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class HybridFormat:
    def __init__(self, blocks, slot_row, slot_col, rb_ptr, order_t, cb_ptr,
                 rest: _Csr, rest_t: _Csr, M: int, N: int, B: int,
                 dense_nnz: int, row_map: Optional[torch.Tensor] = None,
                 M_pad: int = 0, index: Optional["StoreIndex"] = None,
                 source: Optional[torch.Tensor] = None):
        self.blocks = blocks
        self.slot_row = slot_row
        self.slot_col = slot_col
        self.rb_ptr = rb_ptr
        self.order_t = order_t
        self.cb_ptr = cb_ptr
        self.rest = rest
        self.rest_t = rest_t
        self.M, self.N, self.B = M, N, B
        self.dense_nnz = dense_nnz
        self.row_map = row_map
        self.M_pad = M_pad
        self.index = index
        self.source = source

    @property
    def nb(self) -> int:
        return int(self.slot_col.shape[0])

    def __repr__(self) -> str:
        return (f"HybridFormat(M={self.M}, N={self.N}, B={self.B}, "
                f"blocks={self.nb}, dense_nnz={self.dense_nnz}, "
                f"dtype={self.blocks.dtype})")


class DenseFormat:
    """Whole-matrix dense store: the degenerate hybrid for matrices whose
    overall density clears the densify break-even."""

    def __init__(self, dense, M: int, N: int,
                 index: Optional["StoreIndex"] = None,
                 source: Optional[torch.Tensor] = None):
        self.dense = dense
        self.M, self.N = M, N
        self.index = index
        self.source = source

    def __repr__(self) -> str:
        return f"DenseFormat(M={self.M}, N={self.N}, dtype={self.dense.dtype})"


def _idx(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


class StoreIndex:
    """Where the values of a matrix's edges land in a view, kept on the
    view's device so that new values are written there.

    * ``first`` (n,) int32 edge ids: the first edge at each distinct
      store position; ``pos`` (n,) those positions, ascending, in the
      store's flat buffer (padded rows counted), int32 where they fit;
    * ``dups``: one ``(runs, edges)`` pair a pass d = 1, 2, ...: the runs
      (indices into ``first``) of more than d edges at one position, and
      the edge at place d of each, so that duplicates add up left to
      right in edge order;
    * ``rest``/``rest_t``: the edge ids of a hybrid's CSR remainder in
      its CSR and CSC orders, or None;
    * ``n_edges``: the edges of the matrix; ``bf16_budget``: the store
      budget under which the router chose a bf16 store for values that
      fit it, or None (a new value is held to it again)."""

    def __init__(self, flat: np.ndarray, edge_ids: np.ndarray,
                 n_edges: int, device: torch.device):
        order = np.argsort(flat, kind="stable")
        fs, ids = flat[order], edge_ids[order]
        n = fs.size
        starts = (np.flatnonzero(np.concatenate([[True], fs[1:] != fs[:-1]]))
                  if n else np.zeros(0, np.int64))
        self.first = _idx(ids[starts], device)
        pos = fs[starts]
        self.pos = torch.from_numpy(np.ascontiguousarray(
            pos, np.int32 if pos.size == 0 or pos[-1] < 2**31
            else np.int64)).to(device)
        # Place of each edge in its run; passes d >= 1 take place d.
        lens = np.diff(np.concatenate([starts, [n]]))
        run = np.repeat(np.arange(starts.size), lens)
        place = np.arange(n) - starts[run] if n else np.zeros(0, np.int64)
        later = np.flatnonzero(place > 0)
        later = later[np.argsort(place[later], kind="stable")]
        bounds = np.searchsorted(place[later],
                                 np.arange(1, int(lens.max(initial=1)) + 1))
        self.dups = [(_idx(run[later[a:b]], device), _idx(ids[later[a:b]],
                                                          device))
                     for a, b in zip(bounds[:-1], bounds[1:])]
        self.rest = self.rest_t = None
        self.n_edges = int(n_edges)
        self.bf16_budget: Optional[float] = None

    def sums(self, values: Optional[torch.Tensor],
             device: torch.device) -> torch.Tensor:
        """The value at each of ``pos``: its edges' values added left to
        right in float32 (float64 for float64 values); implicit ones when
        ``values`` is None."""
        if values is None:
            values = torch.ones(self.n_edges, device=device)
        v = values.detach()
        acc = torch.promote_types(v.dtype, torch.float32)
        out = v.index_select(0, self.first).to(acc)
        for runs, edges in self.dups:
            out.index_add_(0, runs, v.index_select(0, edges).to(acc))
        return out


def _edge_values(value, E: int, dev: torch.device) -> Optional[torch.Tensor]:
    """A fresh floating copy of the edge values on ``dev`` (a numpy array
    or a tensor), or None for implicit ones."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        v = value.detach().to(dev, copy=True)
    else:
        v = torch.from_numpy(np.array(value)).to(dev)
    if v.shape[0] != E:
        raise ValueError("`value` must have one entry per edge")
    return v if v.is_floating_point() else v.float()


def _acc_dtype(vals: Optional[torch.Tensor]) -> torch.dtype:
    return (torch.float64 if vals is not None and vals.dtype == torch.float64
            else torch.float32)


def _dense_store(index: StoreIndex, vals, M: int, N: int,
                 dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    dense = torch.zeros((M, N), dtype=dtype, device=dev)
    dense.view(-1)[index.pos] = index.sums(vals, dev).to(dtype)
    return dense


def _block_store(index: StoreIndex, vals, n: int, B: int,
                 dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """The ``(n, B, B)`` store of ``vals``, a :func:`padded_store` (whose
    buffer :func:`store_layout` gives without a copy); ``index`` counts
    positions in that buffer, rows :func:`store_pitch` apart."""
    blocks = padded_store(n, B, dtype, dev)
    store_layout(blocks).view(-1)[index.pos] = index.sums(vals, dev).to(dtype)
    return blocks


def _remainder(index: StoreIndex, vals, rest, rest_t, dev):
    """The remainder's CSR and CSC with their values taken from
    ``vals``."""
    if rest is None:
        return None, None
    if vals is None:
        vals = torch.ones(index.n_edges, device=dev)
    return ((rest[0], rest[1], vals.index_select(0, index.rest)),
            (rest_t[0], rest_t[1], vals.index_select(0, index.rest_t)))


def build_dense(row: np.ndarray, col: np.ndarray, value, M: int, N: int,
                dtype: Optional[torch.dtype] = None,
                device: DeviceLike = None) -> DenseFormat:
    """The full (M, N) matrix (duplicate edges accumulate), stored in
    ``dtype`` (default float32, float64 for float64 values) on
    ``device``.  ``value`` (numpy or a tensor, in the edges' order, or
    None for ones) is copied to the device and scattered there."""
    dev = resolve_device(device)
    row = np.asarray(row, np.int64)
    vals = _edge_values(value, row.shape[0], dev)
    flat = row * N + np.asarray(col, np.int64)
    index = StoreIndex(flat, np.arange(flat.size), flat.size, dev)
    store = _acc_dtype(vals) if dtype is None else dtype
    return DenseFormat(_dense_store(index, vals, M, N, store, dev), M, N,
                       index=index, source=vals)


def dense_fraction(row: np.ndarray, col: np.ndarray, M: int, N: int,
                   B: int = 512, min_density: Optional[float] = None,
                   K_hint: int = 128) -> Tuple[float, int]:
    """Fraction of edges in (B, B) blocks of at least ``min_density``,
    and the number of such blocks."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    if row.size == 0:
        return 0.0, 0
    if min_density is None:
        min_density = block_break_even(B, K_hint)
    C = -(-N // B)
    bkey = (row // B) * C + col // B
    _, counts = np.unique(bkey, return_counts=True)
    thresh = max(int(min_density * B * B), 1)
    dense = counts[counts >= thresh]
    return float(dense.sum()) / row.size, int(dense.size)


def build_hybrid(
    row: np.ndarray, col: np.ndarray, value,
    M: int, N: int, B: int = 512, min_density: Optional[float] = None,
    K_hint: int = 128, block_dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
) -> HybridFormat:
    """Split edges into dense (B, B) blocks and a CSR remainder
    (host-side), then write the values on the device.  ``value`` (numpy
    or a tensor, in the edges' order, or None for ones) is copied there;
    ``block_dtype`` (default float32, float64 for float64 values) is the
    store dtype, a bf16 store rounded once from the f32 sums."""
    dev = resolve_device(device)
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    E = row.shape[0]
    vals = _edge_values(value, E, dev)
    if min_density is None:
        min_density = block_break_even(B, K_hint)

    R = -(-M // B)
    C = -(-N // B)
    bkey = (row // B) * C + col // B
    if E:
        occ_keys, inv_key, occ_counts = np.unique(
            bkey, return_inverse=True, return_counts=True)
    else:
        occ_keys = inv_key = occ_counts = np.zeros(0, np.int64)
    thresh = max(int(min_density * B * B), 1)
    occ_is_dense = occ_counts >= thresh
    dense_sel = occ_is_dense[inv_key] if E else np.zeros(0, bool)

    dsel = np.flatnonzero(dense_sel)
    dense_keys = occ_keys[occ_is_dense]  # sorted: row-block major
    nb = dense_keys.size
    occ_slot = np.full(occ_keys.size, nb, np.int64)
    occ_slot[occ_is_dense] = np.arange(nb)
    store = _acc_dtype(vals) if block_dtype is None else block_dtype
    # Flat offsets (slot*B + r)*Bp + c, in the padded buffer, reach past
    # int32 at real sizes.
    flat = ((occ_slot[inv_key[dsel]] * B + row[dsel] % B)
            * store_pitch(B, store) + col[dsel] % B)
    index = StoreIndex(flat, dsel, E, dev)
    slot_row = dense_keys // C
    slot_col = dense_keys % C
    rb_ptr = np.searchsorted(slot_row, np.arange(R + 1))
    order_t = stable_argsort(slot_col)  # transpose schedule
    cb_ptr = np.searchsorted(slot_col[order_t], np.arange(C + 1))

    rest = rest_t = None
    rest_ids = np.flatnonzero(~dense_sel)
    if rest_ids.size:
        rr = rest_ids[stable_argsort(row[rest_ids])]
        rows_r, cols_r = row[rr], col[rr]
        rest = (_idx(np.searchsorted(rows_r, np.arange(M + 1)), dev),
                _idx(cols_r, dev))
        # The remainder's CSC, in (col, row) order as the JAX format's
        # ell_t: the grad_mat pass runs the CSR kernel over it.
        perm = lexsort2(cols_r, rows_r, M)
        rest_t = (_idx(np.searchsorted(cols_r[perm], np.arange(N + 1)), dev),
                  _idx(rows_r[perm], dev))
        index.rest, index.rest_t = _idx(rr, dev), _idx(rr[perm], dev)
        rest, rest_t = _remainder(index, vals, rest, rest_t, dev)

    return HybridFormat(
        _block_store(index, vals, nb + 1, B, store, dev),
        _idx(slot_row, dev),
        _idx(slot_col, dev), _idx(rb_ptr, dev), _idx(order_t, dev),
        _idx(cb_ptr, dev), rest, rest_t, M, N, B, int(dsel.size),
        index=index, source=vals)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` hold the same words (NaNs and signed zeros
    alike)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    word = _WORDS[a.element_size()]
    return torch.equal(a.contiguous().view(word), b.contiguous().view(word))


_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def store_of(h) -> Optional[torch.Tensor]:
    """The store of a view: ``blocks`` or ``dense``."""
    return h.dense if isinstance(h, DenseFormat) else h.blocks


def with_store(h, store: Optional[torch.Tensor]):
    """A shallow copy of the view ``h`` whose store is ``store``.  An
    autograd node keeps ``with_store(h, None)`` and saves the store
    itself, which autograd then frees after the backward."""
    out = copy.copy(h)
    if isinstance(h, DenseFormat):
        out.dense = store
    else:
        out.blocks = store
    return out


def refresh_plan(h, value: Optional[torch.Tensor]):
    """How the view ``h`` of a storage whose values are now ``value``
    follows them.

    * None: ``h`` serves them as it is.  It holds these values (one
      compare on the device, whose result the host waits for), or its
      store is its own trainable tensor (``requires_grad``), which is
      never overwritten from ``value``.
    * False: a bf16 store that the router chose because the values fit
      the store budget no longer fits them; the router decides afresh.
    * Else a function of no arguments that returns a new view over the
      same structure, its store written on the device from ``value`` and
      the remainder's values gathered from it.  The function holds no
      reference to ``h``'s store: a caller that drops ``h`` first frees
      that store before the new one is allocated, unless a pending
      backward saved it, which then computes with the old values.

    A view without a :class:`StoreIndex` cannot follow a write to
    ``value`` and raises."""
    store = store_of(h)
    if store.requires_grad:
        return None
    index = getattr(h, "index", None)
    if index is None:
        raise RuntimeError(
            f"{type(h).__name__} has no StoreIndex, so writes to the "
            "storage's values cannot reach it; build it with build_hybrid, "
            "build_dense or build_hybrid_from_tensor")
    if value is None:
        if h.source is None:
            return None
    elif h.source is not None and _same_bits(value, h.source):
        return None
    if value is not None and value.shape[0] != index.n_edges:
        raise ValueError("the view was built for another number of edges")
    if (index.bf16_budget is not None
            and quantization_rel_err(value) > index.bf16_budget):
        return False
    shell = with_store(h, None)
    shell.source = None
    return functools.partial(_rewritten, shell, value, store.dtype,
                             store.device)


def _rewritten(shell, value: Optional[torch.Tensor], dtype: torch.dtype,
               dev: torch.device):
    """``shell``'s structure with a store of ``value`` in ``dtype``."""
    index = shell.index
    vals = None if value is None else value.detach().clone()
    if isinstance(shell, DenseFormat):
        return DenseFormat(
            _dense_store(index, vals, shell.M, shell.N, dtype, dev),
            shell.M, shell.N, index=index, source=vals)
    rest, rest_t = _remainder(index, vals, shell.rest, shell.rest_t, dev)
    h = with_store(shell, _block_store(index, vals, shell.nb + 1, shell.B,
                                       dtype, dev))
    h.rest, h.rest_t, h.source = rest, rest_t, vals
    return h


def _pad_to_blocks(a: torch.Tensor, B: int) -> torch.Tensor:
    """``a`` with zero rows appended up to a whole number of ``B``-row
    blocks, the operand layout of the block passes."""
    pad = -a.shape[0] % B
    return torch.cat([a, a.new_zeros((pad, a.shape[1]))]) if pad else a


def _align_to_blocks(row: np.ndarray, col: np.ndarray, partptr,
                     B: int) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Renumber nodes so that every part of ``partptr`` starts on a
    block boundary: each part keeps its order and is padded to a
    multiple of ``B`` (the map is strictly increasing).  Returns
    ``(row', col', M_pad, row_map)``."""
    pp = np.asarray(partptr, np.int64)
    sizes = np.diff(pp)
    padded = -(-sizes // B) * B
    new_starts = np.concatenate([[0], np.cumsum(padded)])
    M_pad = int(new_starts[-1])
    part_of = np.repeat(np.arange(sizes.size), sizes)
    offset_in_part = np.arange(pp[-1]) - np.repeat(pp[:-1], sizes)
    row_map = new_starts[part_of] + offset_in_part
    return row_map[row], row_map[col], M_pad, row_map


def _inner(h: HybridFormat) -> HybridFormat:
    """The padded-space view of a block-aligned format."""
    return HybridFormat(h.blocks, h.slot_row, h.slot_col, h.rb_ptr,
                        h.order_t, h.cb_ptr, h.rest, h.rest_t, h.M_pad,
                        h.M_pad, h.B, h.dense_nnz)


def build_hybrid_from_tensor(A, B: int = 512,
                             min_density: Optional[float] = None,
                             K_hint: int = 128,
                             block_dtype: Optional[torch.dtype] = None,
                             partptr=None) -> HybridFormat:
    """The hybrid view of a :class:`SparseTensor`'s values, on its
    device.  With ``partptr`` (the part boundaries of a community- or
    partition-ordered square matrix) the layout is block-aligned: each
    part starts on a block boundary, so that communities fill whole
    blocks; :func:`hybrid_spmm` maps the operand and the result through
    ``row_map``."""
    val = A.storage.value()
    row = A.storage.numpy_view("row")
    col = A.storage.numpy_view("col")
    M, N = A.sparse_sizes()
    kw = dict(B=B, min_density=min_density, K_hint=K_hint,
              block_dtype=block_dtype, device=A.device())
    if partptr is None:
        return build_hybrid(row, col, val, M, N, **kw)
    assert M == N, "block alignment assumes a square (symmetric-layout) matrix"
    row2, col2, M_pad, row_map = _align_to_blocks(row, col, partptr, B)
    h = build_hybrid(row2, col2, val, M_pad, M_pad, **kw)
    h.row_map = torch.from_numpy(row_map.astype(np.int32)).to(A.device())
    h.M_pad = M_pad
    return h


def _product(h, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    """``A @ x`` (or ``A^T @ x``) in padded space on the kernels, in
    ``x``'s dtype; half precision operands compute in float32."""
    if isinstance(h, DenseFormat):
        a = h.dense.t() if transpose else h.dense
        return _dense_matmul(a, x).to(x.dtype)
    xa = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous()
    xb = _pad_to_blocks(xa, h.B)
    if transpose:
        out = block_spmm_t(h.blocks, h.slot_row, h.order_t, h.cb_ptr, xb)
        out, rest = out[:h.N].to(x.dtype), h.rest_t
    else:
        out = block_spmm(h.blocks, h.slot_col, h.rb_ptr, xb)
        out, rest = out[:h.M].to(x.dtype), h.rest
    if rest is not None:
        ptr, idx, val = rest
        out = out + csr_spmm(ptr, idx, val.to(xa.dtype), xa).to(x.dtype)
    return out


def _store_grad(h, x: torch.Tensor, grad: torch.Tensor,
                transpose: bool) -> torch.Tensor:
    """Gradient of the store of ``_product(h, x, transpose)`` for the
    output gradient ``grad``, in the store's dtype: the row-side operand
    times the column-side one transposed (``grad`` and ``x`` forward,
    ``x`` and ``grad`` for the transpose), block by block on the
    ``block_spmm_dblocks`` kernel, or one matrix product for the dense
    store."""
    acc = torch.promote_types(x.dtype, torch.float32)
    rows, cols = (x, grad) if transpose else (grad, x)
    if isinstance(h, DenseFormat):
        dt = torch.promote_types(acc, h.dense.dtype)
        return torch.mm(rows.to(dt), cols.to(dt).t()).to(h.dense.dtype)
    p = _pad_to_blocks(rows.to(acc).contiguous(), h.B)
    q = _pad_to_blocks(cols.to(acc).contiguous(), h.B)
    return block_spmm_dblocks(p, q, h.slot_row, h.slot_col, h.B,
                              h.blocks.dtype)


class _StoreProduct(torch.autograd.Function):
    """``A @ x`` (``transpose`` False) or ``A^T @ x`` (True) through a
    padded-space :class:`HybridFormat` or a :class:`DenseFormat`, with
    ``store`` (``h.blocks`` or ``h.dense``) as an input so that autograd
    can give it its gradient.  Backward: the operand's gradient is the
    other direction (``block_spmm_t`` or ``block_spmm`` plus the CSR
    remainder's other view); the store's is :func:`_store_grad`, run
    only when the store requires grad.  The remainder's values get no
    gradient.  ``x`` is kept only for the store's gradient."""

    @staticmethod
    def forward(ctx, h, store, x, transpose: bool):
        ctx.h, ctx.transpose = with_store(h, None), transpose
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, store)
        return _product(h, x, transpose)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, store = ctx.saved_tensors
        h = with_store(ctx.h, store)
        grad = grad.contiguous()  # autograd gives it the output's dtype
        grad_store = grad_x = None
        if ctx.needs_input_grad[1]:
            grad_store = _store_grad(h, x, grad, ctx.transpose)
        if ctx.needs_input_grad[2]:
            grad_x = _product(h, grad, not ctx.transpose)
        return None, grad_store, grad_x, None


def _spmm(h, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    if isinstance(h, DenseFormat):
        return _StoreProduct.apply(h, h.dense, x, transpose)
    if h.row_map is not None:
        # Block-aligned layout: scatter x into its padded positions (the
        # padding rows stay exactly zero), run, gather back; autograd
        # carries both.
        rm = h.row_map.long()
        xp = x.new_zeros((h.M_pad, x.shape[1])).index_copy(0, rm, x)
        return _spmm(_inner(h), xp, transpose)[rm]
    return _StoreProduct.apply(h, h.blocks, x, transpose)


def hybrid_spmm(h, x: torch.Tensor) -> torch.Tensor:
    """``out = A @ x`` through a :class:`HybridFormat` or
    :class:`DenseFormat`; (N, K) -> (M, K) in ``x``'s dtype.  Half
    precision operands compute in float32.  Differentiable in ``x`` and
    in ``h.blocks``/``h.dense`` (when it requires grad); the remainder's
    CSR values (``h.rest``, ``h.rest_t``) get no gradient."""
    return _spmm(h, x, False)


def hybrid_spmm_t(h, g: torch.Tensor) -> torch.Tensor:
    """``out = A^T @ g`` through a :class:`HybridFormat` (the transpose
    schedule ``order_t`` and the remainder's CSC) or a
    :class:`DenseFormat`; (M, K) -> (N, K) in ``g``'s dtype.  It backs
    ``grad_mat`` of the routed SpMM.  Half precision operands compute in
    float32.  Differentiable as :func:`hybrid_spmm` is."""
    return _spmm(h, g, True)


def _split_bf16(x: torch.Tensor, parts: int):
    """``parts`` bf16 terms summing to about ``x``: the head, then
    successive residuals."""
    comps = []
    r = x
    for _ in range(parts - 1):
        c = r.to(torch.bfloat16)
        comps.append(c)
        r = r - c.float()
    comps.append(r.to(torch.bfloat16))
    return comps


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 matrices, accumulated and returned in
    float32 (on the CPU, which lacks that product, in exact f32
    arithmetic on the widened operands)."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _dense_matmul(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` with the store-dtype rules of the JAX package: a bf16
    store times an f32 operand splits the operand into bf16 terms that
    ride one widened product (the store is read once); other mixes cast
    the operand to the store dtype.  f32 products run with TF32 off
    (PyTorch's default)."""
    if a.dtype == torch.bfloat16:
        if x.dtype == torch.float32:
            parts = _PRECISION_PARTS[_BLOCK_PRECISION]
            k = x.shape[1]
            o = _mm_f32(a, torch.cat(_split_bf16(x, parts), dim=1))
            out = o[:, :k]
            for i in range(1, parts):
                out = out + o[:, i * k:(i + 1) * k]
            return out
        return _mm_f32(a, x.to(torch.bfloat16))
    return torch.mm(a, x.to(a.dtype))


def dense_spmm(d: DenseFormat, x: torch.Tensor) -> torch.Tensor:
    """``d @ x``, differentiable in ``x`` and in ``d.dense``."""
    return _spmm(d, x, False)


def dense_spmm_t(d: DenseFormat, g: torch.Tensor) -> torch.Tensor:
    """``d^T @ g``: the transpose product of the dense route, with the
    same store-dtype rules and gradients as :func:`dense_spmm`."""
    return _spmm(d, g, True)
