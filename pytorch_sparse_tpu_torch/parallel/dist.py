"""Row-partitioned distributed SpMM over ``torch.distributed``
(counterpart of ``pytorch_sparse_tpu/parallel/dist.py``).

Each process of a :class:`~.mesh.Mesh` holds one row shard: rows
``[p*Mb, (p+1)*Mb)`` of ``A`` and rows ``[p*Nb, (p+1)*Nb)`` of the dense
operand (``shard_dense``), padded with zero rows past ``M`` and ``N``.
Three schedules compute the shard's rows of ``A @ x``:

* ``dist_spmm_allgather``: all-gather ``x``, then one local SpMM over the
  shard's edges with global columns.
* ``dist_spmm_ring``: ``x``'s row blocks rotate around the ring while the
  shard consumes the edge group whose columns fall in the block it
  holds; the rotation for step ``s + 1`` is posted before step ``s``'s
  compute, so the two overlap.  Peak memory: one extra block of ``x``.
* ``dist_spmm_halo``: each shard sends only the rows of its block that
  other shards reference (the halo) in one ``all_to_all`` of fixed-width
  packets, computes its interior (own-block columns) while they move,
  then its frontier over the received buffer.  ``local_format="hybrid"``
  runs the interior's dense ``(B, B)`` blocks on the block kernel
  (``block_spmm``) and, when built, the frontier as one dense product.

On a ``(data, feat)`` :class:`~.mesh.Grid` (``make_mesh2d``) the row
block is the data coordinate's, and each process runs the same
schedules over its data sub-mesh on its ``K/Pf`` columns of the operand;
the processes of one feature coordinate hold the same tables.  The
halo schedule and the hierarchical one (``hier.py``) are both exchange
schedules: the shard's edges split into tiers by the buffer each reads
(:class:`_Tiers`), and one ``autograd.Function`` (:class:`_ExchangeSpmm`,
:class:`_ExchangeHybridSpmm`) runs the tiers as their buffers arrive.

Each schedule takes ``reduce`` of sum, mean, min or max (min/max also
return the argout, a global edge id in CSR order, ``nnz`` on empty
rows) and an optional edge-space ``value`` override whose gradient comes
back in original edge ids.  Each is one ``torch.autograd.Function`` per
rank whose backward runs the transposed collectives: reduce-scatter for
the all-gather, the reverse rotation for the ring (each gradient block
travels back to its owner), the reverse ``all_to_all`` and, for the
halo, a sum at the served rows in a fixed order (``_Served``).

Gradients follow ``torch.distributed``'s data-parallel convention.  The
gradient of a rank's shard ``x`` is that of the sum of every rank's
objective (the backward collectives carry the other ranks' parts); the
gradient of the replicated ``value`` is this rank's share, nonzero on
its own edges only (on a grid, from its own columns): all-reduce it with
SUM over every process of the layout (``A.world``), as for any
replicated parameter, to get the gradient of the sum.  Every rank must run the same
schedules, forward and backward, in the same order.

Local compute runs on the shard kernels K11a/K11b (``shard_spmm``,
``shard_spmm_minmax``).  Each group of edges is a CSR whose rows keep the
global CSR edge order; the JAX package's padded, degree-bucketed ELL
tables were a TPU workaround and are gone.  Each rank builds only its own
shard's groups, and a schedule's tables only when it first runs; every
global decision (the halo width ``H``, whether interior blocks and the
dense frontier are built, the store dtype) is made from the whole
matrix, which every rank holds on the host, exactly as the JAX package
makes it.  Those decisions keep the JAX package's TPU-priced constants
(``block_break_even``, ``_HBM_BW``, ``_ELL_NS_PER_NNZ``) so that both
packages build the same structure; they have not been re-priced for a
GPU.
"""

from __future__ import annotations

import warnings
from functools import cached_property
from typing import List, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..ops.kernels.block_spmm import block_spmm, block_spmm_t, store_pitch
from ..ops.kernels.edge_dot import edge_dot
from ..ops.kernels.hybrid import (
    _ELL_NS_PER_NNZ, _HBM_BW, StoreIndex, _block_store, _dense_matmul,
    _dense_store, _pad_to_blocks, block_break_even, get_store_budget,
    quantization_rel_err)
from ..ops.kernels.shard_spmm import NO_EDGE, shard_spmm, shard_spmm_minmax
from ..ops.kernels.spmm_minmax import minmax_edge_dot, minmax_spmm_t
from ..segment import Runs
from ..utils.convert import INDEX_DTYPE
from ..utils.host_sort import lexsort2, stable_argsort
from . import _comm
from .mesh import Grid, Mesh, data_axis, feat_axis

# Per-shard dense frontier store cap, as the JAX package's
# ``_FR_DENSE_SHARD_CAP`` (the boundary itself is excluded).
_FR_DENSE_SHARD_CAP = 1 << 30


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _extract_coo(A):
    """``(row, col, value_f32, E)`` host arrays of ``A`` in CSR order;
    missing values become implicit ones, as in the JAX package."""
    row = A.storage.numpy_view("row").astype(np.int64, copy=False)
    col = A.storage.numpy_view("col").astype(np.int64, copy=False)
    value = A.storage.value()
    value_np = (np.ones(row.shape, np.float32) if value is None
                else value.detach().cpu().numpy().astype(np.float32,
                                                         copy=False))
    return row, col, value_np, row.shape[0]


def _idx(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


class _Group:
    """One edge group of this rank's shard as a CSR.  ``rowptr`` may be
    a slice of a larger pointer; ``pos`` holds each edge's position in
    the shard's CSR (its global id less the shard's first), ``row_map``
    the shard row of each group row (None: group row ``r`` is shard row
    ``r``)."""

    def __init__(self, rowptr, col, value, pos=None, row_map=None):
        self.rowptr, self.col, self.value = rowptr, col, value
        self.pos, self.row_map = pos, row_map

    @classmethod
    def build(cls, rows, cols, vals, pos, n_rows, compact, device):
        """From host arrays whose ``rows`` do not decrease; ``compact``
        keeps only the rows that have edges, with a ``row_map``."""
        if compact:
            keep, counts = np.unique(rows, return_counts=True)
            rowptr = np.concatenate([[0], np.cumsum(counts)])
            row_map = _idx(keep, device)
        else:
            rowptr = np.searchsorted(rows, np.arange(n_rows + 1))
            row_map = None
        return cls(_idx(rowptr, device), _idx(cols, device),
                   _f32(vals, device),
                   None if pos is None else _idx(pos, device), row_map)

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def values(self, v_loc: Optional[torch.Tensor]):
        """The group's values: baked, or taken from the shard's slice of
        an edge-space override."""
        if v_loc is None:
            return self.value
        return v_loc if self.pos is None else v_loc[self.pos]

    def rows(self, lo: int, hi: int) -> "_Group":
        """Rows ``[lo, hi)`` of a group without ``row_map``."""
        return _Group(self.rowptr[lo:hi + 1], self.col, self.value, self.pos)


class _Csc:
    """The transpose of some of the shard's edges: ``colptr`` over
    ``n_cols`` buffer rows, ``row`` the shard row of each edge, ``perm``
    its position in the shard's CSR (``pos[perm]`` when the edges are
    the subset ``pos``; for a whole view, its ``csr2csc``), ``value``
    the baked values in CSC order."""

    def __init__(self, rows, cols, vals, n_cols, device, pos=None):
        perm = lexsort2(cols, rows)
        self.colptr = _idx(np.searchsorted(cols[perm],
                                           np.arange(n_cols + 1)), device)
        self.row = _idx(rows[perm], device)
        self.perm = _idx(perm if pos is None else pos[perm], device)
        self.value = _f32(vals[perm], device)

    def group(self, v_loc: Optional[torch.Tensor]) -> _Group:
        """The transpose as a group for ``shard_spmm``: one row per
        buffer row, values baked or from an override's shard slice."""
        value = self.value if v_loc is None else v_loc[self.perm]
        return _Group(self.colptr, self.row, value)


class _View:
    """The shard's whole CSR with its columns ``cols`` (host) into one
    buffer of ``n_cols`` rows: as one group, and its transpose (built at
    first use).  A schedule's backward reads it (min/max, the value
    gradient, the transposed sum); the all-gather runs its group."""

    def __init__(self, A, cols, n_cols):
        self._A, self._cols, self.n_cols = A, cols, n_cols
        self.rowptr = A._rowptr
        self.col = _idx(cols, A.device)

    @cached_property
    def group(self) -> _Group:
        return _Group(self.rowptr, self.col, self._A._values)

    @cached_property
    def csc(self) -> _Csc:
        A = self._A
        return _Csc(A._r, self._cols, A._v, self.n_cols, A.device)


class _Tiers:
    """The shard's edges split by the buffer each reads.  Tier 0 reads
    ``x``; tier ``i > 0`` reads the ``sizes[i]``-row buffer that an
    exchange delivers.  ``cols`` (host) are the shard's columns into the
    merged buffer ``[x ; buf_1 ; buf_2 ...]``, where tier ``i`` starts at
    ``offsets[i]``.  The groups (tier 0 over every shard row, the others
    over the rows they touch), their transposes and the merged view are
    built at first use.

    A subclass says how the buffers move: :meth:`exchange` posts the
    forward collectives and returns one waiter per tier ``i > 0``, to be
    called in tier order; :meth:`exchange_back` posts the transposed
    collectives of the buffers' gradients and returns the function that
    adds what comes back into ``grad_x``."""

    def __init__(self, A, cols, tier, sizes):
        self._A, self.cols, self.sizes = A, cols, tuple(sizes)
        self.offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.pos = [np.flatnonzero(tier == i) for i in range(len(sizes))]
        self._groups, self._transposes = {}, {}

    def edges(self, i):
        """Tier ``i``'s ``(shard rows, buffer rows, values)`` on the
        host."""
        A, pos = self._A, self.pos[i]
        return A._r[pos], self.cols[pos] - self.offsets[i], A._v[pos]

    def group(self, i) -> _Group:
        if i not in self._groups:
            A = self._A
            self._groups[i] = _Group.build(*self.edges(i), self.pos[i], A.Mb,
                                           i > 0, A.device)
        return self._groups[i]

    def transpose(self, i) -> _Csc:
        if i not in self._transposes:
            self._transposes[i] = _Csc(*self.edges(i), self.sizes[i],
                                       self._A.device, self.pos[i])
        return self._transposes[i]

    @cached_property
    def view(self) -> _View:
        return _View(self._A, self.cols, int(sum(self.sizes)))


class _Served:
    """The rows a rank serves on one fabric, as packets of ``H`` slots:
    ``index`` ``(n*H,)``, the local row of each slot (a padding slot reads
    row 0), and the sum of the gradients that come back.  A row served to
    several peers fills several slots; ``add_into`` sums each row's
    gradients in slot order (``Runs`` over the live slots sorted stably
    by row) and adds the sum once at the row, so that the card gives the
    same bits on every run."""

    def __init__(self, ukey: np.ndarray, starts: np.ndarray, keys, H: int,
                 Nb: int, device):
        """The packets of the local rows listed under each of ``keys`` in
        the sorted ``key * Nb + row`` array ``ukey`` (key ``k``'s rows at
        ``starts[k]:starts[k + 1]``), zero-padded to ``H``."""
        keys = list(keys)
        serve = np.zeros((len(keys), H), np.int64)
        live = np.zeros((len(keys), H), bool)
        for j, k in enumerate(keys):
            lo, hi = starts[k], starts[k + 1]
            serve[j, :hi - lo] = ukey[lo:hi] % Nb
            live[j, :hi - lo] = True
        serve, live = serve.reshape(-1), live.reshape(-1)
        self.index = torch.from_numpy(serve).to(device)
        slots = np.flatnonzero(live)
        slots = slots[np.argsort(serve[slots], kind="stable")]
        rows, first = np.unique(serve[slots], return_index=True)
        self._slots = torch.from_numpy(slots).to(device)
        self._rows = torch.from_numpy(rows).to(device)
        self._runs = Runs(np.append(first, slots.size), device)

    def add_into(self, grad_x: torch.Tensor, back: torch.Tensor) -> None:
        """``grad_x[row] += (the sum of back[slot] over the row's slots)``,
        ``back`` ``(n*H, K)`` in slot order."""
        if self._rows.numel():
            sums = self._runs.sum(back.index_select(0, self._slots))
            grad_x.index_add_(0, self._rows, sums.to(grad_x.dtype))


class _HaloTables(_Tiers):
    """The flat halo: the halo width ``H``, the rows this rank serves
    (``served``; ``serve`` its ``(P*H,)`` index: ``P`` packets of ``H``
    local rows) and one buffer tier, the received ``(P*H, K)`` halo."""

    def __init__(self, A, H, served: _Served, cols):
        super().__init__(A, cols, (A._c // A.Nb != A.rank).astype(np.int8),
                         (A.Nb, A.P * H))
        self.H, self.served, self.serve = H, served, served.index

    @property
    def interior(self) -> _Group:
        return self.group(0)

    @property
    def frontier(self) -> _Group:
        return self.group(1)

    def exchange(self, x: torch.Tensor):
        pending = _comm.all_to_all(self._A.mesh, x.index_select(0, self.serve),
                                   async_op=True)
        return [pending.wait]

    def exchange_back(self, gbufs):
        pending = _comm.all_to_all(self._A.mesh, gbufs[0].contiguous(),
                                   async_op=True)

        def finish(grad_x):
            self.served.add_into(grad_x, pending.wait())
        return finish


class _Hybrid:
    """The interior's dense blocks and their remainder group, and one
    dense frontier store (or None) per buffer tier, ``fr_dense[i - 1]``
    for tier ``i``."""

    def __init__(self, blocks, slot_row, slot_col, rb_ptr, order_t, cb_ptr,
                 rest, rest_t, fr_dense=()):
        self.blocks, self.slot_row, self.slot_col = blocks, slot_row, slot_col
        self.rb_ptr, self.order_t, self.cb_ptr = rb_ptr, order_t, cb_ptr
        self.rest, self.rest_t, self.fr_dense = rest, rest_t, fr_dense


def _build_frontier_dense(mode: str, worst: int, vals: np.ndarray, Mb: int,
                          L: int, edges, device) -> Optional[torch.Tensor]:
    """The JAX package's ``_build_frontier_dense``: the ``(Mb, L)`` dense
    store of one buffer tier against its ``L``-row buffer, or None.
    ``worst`` is the most tier edges any shard holds and ``vals`` every
    shard's tier values (the store dtype's rule); ``edges`` this rank's
    ``(shard rows, buffer rows, values)``.  ``mode`` "always" still
    builds nothing for an empty tier or a store at the 1 GiB cap."""
    if mode == "never" or worst == 0 or Mb * L == 0:
        return None
    store_bf16 = quantization_rel_err(vals) <= get_store_budget()
    elem = 2 if store_bf16 else 4
    passes = 1.0 if store_bf16 else 3.0
    if Mb * L * elem >= _FR_DENSE_SHARD_CAP:
        return None
    if mode != "always":
        t_dense = passes * Mb * L * elem / _HBM_BW
        t_ell = worst * _ELL_NS_PER_NNZ * 1e-9
        if t_dense >= t_ell:
            return None
    r, c, v = edges
    flat = np.asarray(r, np.int64) * L + np.asarray(c, np.int64)
    index = StoreIndex(flat, np.arange(flat.size), flat.size, device)
    return _dense_store(index, _f32(v, device), Mb, L,
                        torch.bfloat16 if store_bf16 else torch.float32,
                        device)


def _worst(owner: np.ndarray, P: int) -> int:
    """The most edges any shard holds, given each edge's owner."""
    return int(np.bincount(owner, minlength=P).max()) if owner.size else 0


class _RowShard:
    """This rank's row block ``p`` of ``P`` of a sparse matrix: rows
    ``[p*Mb, (p+1)*Mb)`` of ``A`` and of the dense operand's ``[p*Nb,
    (p+1)*Nb)``, with ``Mb, Nb = ceil(M/P), ceil(N/P)``.  ``nnz`` is the
    matrix's edge count, ``e0`` the global id of the shard's first edge
    (edges are numbered in CSR order, so the shard's edges are ``[e0,
    e0 + E_p)``), ``rowcount`` ``(Mb,)`` int32 the shard's row lengths.
    Every layout builds its tables from these host arrays and the whole
    matrix's COO, which every rank holds."""

    def __init__(self, A, P: int, rank: int, device, interior_blocks: str,
                 block_B: int, frontier_dense: str):
        self.P, self.rank, self.device = P, rank, device
        self.M, self.N = A.sparse_sizes()
        self.Mb, self.Nb = _cdiv(self.M, self.P), _cdiv(self.N, self.P)
        self.block_B = block_B
        self._interior_blocks, self._frontier_dense = (interior_blocks,
                                                       frontier_dense)
        row, col, val, E = _extract_coo(A)
        self.nnz = E
        self._coo = (row, col, val)
        rowptr = A.storage.numpy_view("rowptr")
        lo = min(self.rank * self.Mb, self.M)
        hi = min((self.rank + 1) * self.Mb, self.M)
        self.e0, e1 = int(rowptr[lo]), int(rowptr[hi])
        self._r = row[self.e0:e1] - self.rank * self.Mb   # local rows
        self._c, self._v = col[self.e0:e1], val[self.e0:e1]
        local_ptr = np.full(self.Mb + 1, e1 - self.e0, np.int64)
        local_ptr[:hi - lo + 1] = rowptr[lo:hi + 1] - self.e0
        self._rowptr = _idx(local_ptr, self.device)
        self.rowcount = _idx(np.diff(local_ptr), self.device)

    @cached_property
    def _values(self) -> torch.Tensor:
        """The shard's baked values in CSR order, on the device."""
        return _f32(self._v, self.device)

    def has_interior_blocks(self) -> bool:
        return self._hybrid is not None

    def _build_interior_blocks(self) -> Optional[_Hybrid]:
        """The JAX package's ``_build_interior_blocks``, deciding from
        every shard's interior (own-block columns) and this rank building
        only its own blocks and remainder; no frontier store yet."""
        P, me, Mb, Nb, B = self.P, self.rank, self.Mb, self.Nb, self.block_B
        row, col, val = self._coo
        owner = row // Mb
        inter = owner == col // Nb
        tot = int(inter.sum())
        if tot == 0 or min(Mb, Nb) < 2 * B:
            return None
        store_bf16 = quantization_rel_err(val[inter]) <= get_store_budget()
        be = block_break_even(B, elem=2 if store_bf16 else 4,
                              passes=1.0 if store_bf16 else 3.0)
        thresh = max(int(be * B * B), 1)
        Rb, Cb = _cdiv(Mb, B), _cdiv(Nb, B)
        RC = Rb * Cb
        o_i = owner[inter]
        gkey = (o_i * RC + ((row[inter] - o_i * Mb) // B) * Cb
                + (col[inter] - o_i * Nb) // B)
        keys, counts = np.unique(gkey, return_counts=True)
        dense = counts >= thresh
        nbm = int(np.bincount(keys[dense] // RC, minlength=P).max())
        if nbm == 0 or counts[dense].sum() / tot < 0.3:
            return None
        # This rank's blocks and remainder.
        own_keys = keys[dense & (keys // RC == me)] - me * RC
        ipos = np.flatnonzero(self._c // Nb == me)
        r, c, v = self._r[ipos], self._c[ipos] - me * Nb, self._v[ipos]
        bkey = (r // B) * Cb + c // B
        slot = np.searchsorted(own_keys, bkey)
        dmask = slot < own_keys.size
        dmask[dmask] = own_keys[slot[dmask]] == bkey[dmask]
        nb = own_keys.size
        dev = self.device
        store = torch.bfloat16 if store_bf16 else torch.float32
        d = np.flatnonzero(dmask)
        index = StoreIndex((slot[d] * B + r[d] % B) * store_pitch(B, store)
                           + c[d] % B, d, v.size, dev)
        blocks = _block_store(index, _f32(v, dev), nb + 1, B, store, dev)
        slot_row, slot_col = own_keys // Cb, own_keys % Cb
        order_t = stable_argsort(slot_col)
        rest = np.flatnonzero(~dmask)
        rest_g = rest_t = None
        if rest.size:
            rest_g = _Group.build(r[rest], c[rest], v[rest], None, Mb, False,
                                  dev)
            rest_t = _Csc(r[rest], c[rest], v[rest], Nb, dev).group(None)
        return _Hybrid(
            blocks, _idx(slot_row, dev), _idx(slot_col, dev),
            _idx(np.searchsorted(slot_row, np.arange(Rb + 1)), dev),
            _idx(order_t, dev),
            _idx(np.searchsorted(slot_col[order_t], np.arange(Cb + 1)), dev),
            rest_g, rest_t)

    def _shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's ``(Nb, ...)`` rows of ``x``, zero rows past ``N``,
        on the mesh's device."""
        lo = self.rank * self.Nb
        blk = x[lo:lo + self.Nb].to(self.device)
        pad = self.Nb - blk.shape[0]
        if pad:
            blk = torch.cat([blk, blk.new_zeros((pad, *blk.shape[1:]))])
        return blk.contiguous()


class ShardedSparseMatrix(_RowShard):
    """This rank's row shard of a sparse matrix on a :class:`Mesh` (one
    row shard a process) or on a ``(data, feat)`` :class:`Grid`
    (:func:`make_mesh2d`).

    On a grid, ``P`` and the row block come from the data axis: the
    ``Pf`` processes of data shard ``d`` hold the same tables, as the
    JAX package replicates them over ``"f"``, and each runs the row
    schedules on its own ``K/Pf`` columns of the operand over its data
    sub-mesh.  ``mesh`` is the mesh the schedules' collectives run on
    (the data sub-mesh on a grid), ``world`` the mesh over every process
    of the layout.  ``halo_width`` and ``serve_idx`` (``(P, H)``: row
    ``p`` lists the local rows of this rank's block that rank ``p``
    reads, padded with 0) build the halo tables on first use.
    """

    def __init__(self, A, mesh, interior_blocks: str = "auto",
                 block_B: int = 512, frontier_dense: str = "auto"):
        if isinstance(mesh, Grid):
            if set(mesh.names) != {data_axis, feat_axis}:
                raise ValueError("a ShardedSparseMatrix takes a 1-D mesh or "
                                 "a (data, feat) grid (make_mesh2d)")
            self.grid, self.world = mesh, mesh.mesh
            self.Pf, self.f = mesh.shape[feat_axis], mesh.coords[1]
            mesh = mesh.axis(data_axis)
        else:
            self.grid, self.world, self.Pf, self.f = None, mesh, 1, 0
        self.mesh = mesh
        super().__init__(A, mesh.size, mesh.rank, mesh.device,
                         interior_blocks, block_B, frontier_dense)

    @classmethod
    def from_sparse_tensor(cls, A, mesh, interior_blocks: str = "auto",
                           block_B: int = 512,
                           frontier_dense: str = "auto"
                           ) -> "ShardedSparseMatrix":
        """Partition ``A``'s rows into contiguous blocks of
        ``ceil(M/P)``; this rank keeps block ``mesh.rank`` (on a grid,
        its data coordinate).  Every rank passes the same ``A`` (host
        arrays are read; ``A`` may lie on any device).  For a low-cut
        layout permute ``A`` first so that block boundaries match
        cluster boundaries.  ``interior_blocks`` ("auto"/"never") and
        ``frontier_dense`` ("auto"/"never"/"always") decide the hybrid
        local format as the JAX package does."""
        return cls(A, mesh, interior_blocks, block_B, frontier_dense)

    # ------------------------------------------------------------------
    # Tables, built at first use
    # ------------------------------------------------------------------
    @cached_property
    def _flat(self) -> _View:
        """The shard's CSR over the all-gathered ``x`` (global
        columns): the all-gather schedule's tables, and the ring's
        backward."""
        return _View(self, self._c, self.P * self.Nb)

    @cached_property
    def _ring(self) -> List[_Group]:
        """One group per column block ``q``: the shard's edges whose
        column falls in block ``q``, columns local to the block."""
        block = self._c // self.Nb
        groups = []
        for q in range(self.P):
            pos = np.flatnonzero(block == q)
            groups.append(_Group.build(
                self._r[pos], self._c[pos] - q * self.Nb, self._v[pos], pos,
                self.Mb, True, self.device))
        return groups

    @cached_property
    def _halo(self) -> _HaloTables:
        """The halo width, the rows this rank serves and the shard's
        columns into ``[x ; halo]``, decided from the whole matrix."""
        P, me, Mb, Nb = self.P, self.rank, self.Mb, self.Nb
        row, col, _ = self._coo
        owner, block = row // Mb, col // Nb
        fr = owner != block
        # Distinct (client, server, server-local column) triples.
        ukey = np.unique((owner[fr] * P + block[fr]) * Nb + col[fr] % Nb)
        counts = np.bincount(ukey // Nb, minlength=P * P)
        H = max(1, int(counts.max()) if counts.size else 1)
        starts = np.concatenate([[0], np.cumsum(counts)])
        # Key p*P + me lists the rows this rank serves to client p.
        served = _Served(ukey, starts, range(me, P * P, P), H, Nb,
                         self.device)
        qb = self._c // Nb
        own = qb == me
        cols = np.where(own, self._c - me * Nb, 0)
        fpos = np.flatnonzero(~own)
        q, local = qb[fpos], self._c[fpos] % Nb
        slot = np.searchsorted(ukey, (me * P + q) * Nb + local)
        cols[fpos] = Nb + q * H + slot - starts[me * P + q]
        return _HaloTables(self, H, served, cols)

    @property
    def halo_width(self) -> int:
        return self._halo.H

    @property
    def serve_idx(self) -> torch.Tensor:
        return self._halo.serve.view(self.P, -1)

    @cached_property
    def _hybrid(self) -> Optional[_Hybrid]:
        """The interior's dense blocks and the dense frontier, or None
        when the JAX package's rule does not build them."""
        hyb = None
        if self._interior_blocks != "never":
            hyb = self._build_interior_blocks()
        if hyb is not None:
            # The dense frontier only pays once the interior is off the
            # gather path: it is built alongside the blocks.
            row, col, val = self._coo
            owner = row // self.Mb
            fr = owner != col // self.Nb
            hl = self._halo
            hyb.fr_dense = (_build_frontier_dense(
                self._frontier_dense, _worst(owner[fr], self.P), val[fr],
                self.Mb, self.P * hl.H, hl.edges(1), self.device),)
        if self._frontier_dense == "always" and (
                hyb is None or hyb.fr_dense[0] is None):
            warnings.warn(
                "frontier_dense='always' not honored: the dense frontier "
                "is gated on the interior blocks clearing their break-even "
                "(interior_blocks != 'never' and the shards dense enough) "
                "and on the per-shard store staying under the 1 GiB cap; "
                "this matrix keeps the frontier group.")
        return hyb

    def has_frontier_dense(self) -> bool:
        return (self._hybrid is not None
                and self._hybrid.fr_dense[0] is not None)

    # ------------------------------------------------------------------
    # Dense operands
    # ------------------------------------------------------------------
    def shard_dense(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's ``(Nb, K)`` block of the ``(N, K)`` operand ``x``,
        zero rows past ``N``, on the mesh's device.  On a ``(data,
        feat)`` grid, columns ``[f*K/Pf, (f+1)*K/Pf)`` of it; ``K`` must
        divide by ``Pf``."""
        if self.Pf > 1 and x.dim() > 1:
            K = x.shape[1]
            if K % self.Pf:
                raise ValueError(
                    f"K={K} must be divisible by the feature-axis size "
                    f"{self.Pf}; pad the feature dimension.")
            Kf = K // self.Pf
            x = x[:, self.f * Kf:(self.f + 1) * Kf]
        return self._shard_rows(x)

    def unshard_dense(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(Mb, K)`` block gathered into the ``(M, K)``
        result (a collective: every rank calls it); on a grid, with
        every feature rank's columns."""
        y = _comm.all_gather(self.mesh, y)[:self.M]
        if self.Pf > 1 and y.dim() > 1:
            parts = _comm.all_gather(self.grid.axis(feat_axis), y)
            y = parts.view(self.Pf, self.M, -1).transpose(0, 1).reshape(
                self.M, -1)
        return y

    def __repr__(self) -> str:
        return (f"ShardedSparseMatrix(M={self.M}, N={self.N}, nnz={self.nnz}"
                f", P={self.P}, Pf={self.Pf}, rank={self.rank}, "
                f"Mb={self.Mb}, Nb={self.Nb})")


# ----------------------------------------------------------------------
# Schedules
# ----------------------------------------------------------------------

def _is_min_of(reduce: str):
    if reduce in ("sum", "add", "mean"):
        return None
    if reduce == "min":
        return True
    if reduce == "max":
        return False
    raise ValueError(f"Unknown reduce mode: {reduce!r}")


def _local_values(A: _RowShard,
                  value: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This shard's slice of an edge-space override.  Unlike the JAX
    package's ``_vtabs_from_value`` (which clamps silently), a value
    vector of the wrong length raises."""
    if value is None:
        return None
    if value.dim() != 1:
        raise ValueError("edge-space value override must be 1-D (nnz,)")
    if value.shape[0] != A.nnz:
        raise ValueError(f"edge-space value override has {value.shape[0]} "
                         f"entries; the matrix has nnz={A.nnz}")
    if value.device != A.device:
        raise ValueError("value lies on another device than the mesh's")
    return value[A.e0:A.e0 + A._r.shape[0]]


def _check_x(A: _RowShard, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != A.Nb:
        raise ValueError(f"x must be this rank's ({A.Nb}, K) block "
                         "(the layout's shard_dense)")
    if x.device != A.device:
        raise ValueError("x lies on another device than the mesh's")


def _arg_local(A: _RowShard, arg: torch.Tensor) -> torch.Tensor:
    """Global argout -> positions in the shard's CSR (rows without a
    winner map past every position)."""
    return (arg - A.e0).contiguous()


def _value_grad(A, view: _View, buf, g, arg):
    """The edge-space value gradient over a view's buffer ``buf``: this
    shard's share, in original edge ids."""
    local = (edge_dot(view.rowptr, view.col, buf, g) if arg is None else
             minmax_edge_dot(view.rowptr, view.col, buf, g,
                             _arg_local(A, arg)))
    grad = local.new_zeros(A.nnz)
    grad[A.e0:A.e0 + local.shape[0]] = local
    return grad


def _minmax_grad_buf(A, view: _View, v_loc, g, arg) -> torch.Tensor:
    """The min/max ``grad_mat`` over a view's buffer rows."""
    csc = view.csc
    value = A._values if v_loc is None else v_loc
    return minmax_spmm_t(csc.colptr, csc.row, csc.perm, value, g,
                         _arg_local(A, arg))


def _outputs(ctx, out, arg):
    if arg is None:
        return out
    ctx.mark_non_differentiable(arg)
    return out, arg


class _AllgatherSpmm(torch.autograd.Function):
    """All-gather ``x``; one local SpMM over global columns.  Backward:
    the transposed SpMM over the whole gathered space, reduce-scattered
    back to the owners."""

    @staticmethod
    def forward(ctx, A, is_min, x, value):
        view = A._flat
        v_loc = _local_values(A, value)
        x_full = _comm.all_gather(A.mesh, x)
        grp = view.group
        if is_min is None:
            out = shard_spmm(grp.rowptr, grp.col, grp.values(v_loc), x_full)
            arg = None
        else:
            out, arg = shard_spmm_minmax(grp.rowptr, grp.col,
                                         grp.values(v_loc), x_full, is_min,
                                         A.e0)
        ctx.A, ctx.is_min = A, is_min
        ctx.save_for_backward(
            x_full if ctx.needs_input_grad[3] else None, v_loc, arg)
        return _outputs(ctx, out, arg)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _garg=None):
        A, view = ctx.A, ctx.A._flat
        x_full, v_loc, arg = ctx.saved_tensors
        g = g.contiguous()
        grad_x = grad_v = None
        if ctx.needs_input_grad[2]:
            if ctx.is_min is None:
                t = view.csc.group(v_loc)
                gbuf = shard_spmm(t.rowptr, t.col, t.value, g)
            else:
                gbuf = _minmax_grad_buf(A, view, v_loc, g, arg)
            grad_x = _comm.reduce_scatter(A.mesh, gbuf)
        if ctx.needs_input_grad[3]:
            grad_v = _value_grad(A, view, x_full, g, arg)
        return None, None, grad_x, grad_v


def _ring_reverse(mesh: Mesh, contrib) -> torch.Tensor:
    """The transpose of the forward ring: the gradient of block ``q``
    travels the ring the other way, each rank adding ``contrib(q)`` for
    the block it handled at that step, and arrives at its owner.  The
    next transfer is posted as soon as a step's sum is ready, and each
    step's contribution is computed while the previous sum travels."""
    P, me = mesh.size, mesh.rank
    pending = None
    for s in range(P - 1, -1, -1):
        c = contrib((me + s) % P)
        if pending is not None:
            c = c + pending.wait()
        if s == 0:
            return c
        pending = _comm.rotate(mesh, c, -1)


class _RingSpmm(torch.autograd.Function):
    """Rotate ``x``'s blocks around the ring; at step ``s`` consume the
    group of block ``(rank + s) % P`` while block ``s + 1`` moves.
    Backward: the reverse rotation (:func:`_ring_reverse`) of the
    transposed groups, which are row ranges of the shard's CSC."""

    @staticmethod
    def forward(ctx, A, is_min, x, value):
        mesh, P, me, Nb = A.mesh, A.P, A.rank, A.Nb
        groups = A._ring
        v_loc = _local_values(A, value)
        keep = ctx.needs_input_grad[3]
        x_full = x.new_empty((P * Nb, x.shape[1])) if keep else None
        K = x.shape[1]
        if is_min is None:
            out, arg = x.new_zeros((A.Mb, K)), None
        else:
            out = x.new_full((A.Mb, K), float("inf") if is_min
                             else float("-inf"))
            arg = torch.full((A.Mb, K), NO_EDGE, dtype=INDEX_DTYPE,
                             device=x.device)
        xblk = x
        for s in range(P):
            q = (me + s) % P
            pending = _comm.rotate(mesh, xblk, 1) if s < P - 1 else None
            grp = groups[q]
            if grp.nnz:
                if is_min is None:
                    shard_spmm(grp.rowptr, grp.col, grp.values(v_loc), xblk,
                               out=out, row_map=grp.row_map)
                else:
                    shard_spmm_minmax(grp.rowptr, grp.col, grp.values(v_loc),
                                      xblk, is_min, A.e0, pos=grp.pos,
                                      out=out, arg=arg, row_map=grp.row_map)
            if keep:
                x_full[q * Nb:(q + 1) * Nb] = xblk
            if pending is not None:
                xblk = pending.wait()
        ctx.A, ctx.is_min = A, is_min
        ctx.save_for_backward(x_full, v_loc, arg)
        return _outputs(ctx, out, arg)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _garg=None):
        A, view, Nb = ctx.A, ctx.A._flat, ctx.A.Nb
        x_full, v_loc, arg = ctx.saved_tensors
        g = g.contiguous()
        grad_x = grad_v = None
        if ctx.needs_input_grad[2]:
            if ctx.is_min is None:
                t = view.csc.group(v_loc)

                def contrib(q):
                    blk = t.rows(q * Nb, (q + 1) * Nb)
                    return shard_spmm(blk.rowptr, blk.col, blk.value, g)
            else:
                gbuf = _minmax_grad_buf(A, view, v_loc, g, arg)

                def contrib(q):
                    return gbuf[q * Nb:(q + 1) * Nb]
            grad_x = _ring_reverse(A.mesh, contrib)
        if ctx.needs_input_grad[3]:
            grad_v = _value_grad(A, view, x_full, g, arg)
        return None, None, grad_x, grad_v


def _run_group(A, grp: _Group, buf, is_min, v_loc, out=None, arg=None):
    """K11a (sum) or K11b (min/max) of one group against ``buf``:
    written when ``out`` is None (a group over every shard row), else
    accumulated or combined into ``out`` (and ``arg``) in place.
    Returns ``(out, arg)``, ``arg`` None for a sum."""
    value = grp.values(v_loc)
    if out is None:
        if is_min is None:
            return shard_spmm(grp.rowptr, grp.col, value, buf), None
        return shard_spmm_minmax(grp.rowptr, grp.col, value, buf, is_min,
                                 A.e0, pos=grp.pos)
    if grp.nnz:
        if is_min is None:
            shard_spmm(grp.rowptr, grp.col, value, buf, out=out,
                       row_map=grp.row_map)
        else:
            shard_spmm_minmax(grp.rowptr, grp.col, value, buf, is_min, A.e0,
                              pos=grp.pos, out=out, arg=arg,
                              row_map=grp.row_map)
    return out, arg


class _ExchangeSpmm(torch.autograd.Function):
    """A schedule of exchanged buffers (the flat halo, the hierarchical
    ICI halo and DCN union) over the shard's tiers: the exchanges are
    posted, the interior runs against ``x`` while they move, then each
    buffer tier is accumulated (or combined for min/max) as its buffer
    arrives, in tier order.  Backward: the transpose over the merged
    view ``[x ; buffers]``; the buffers' gradients ride the transposed
    collectives back to the serving ranks, which add them at their
    served rows."""

    @staticmethod
    def forward(ctx, A, tables, is_min, x, value):
        v_loc = _local_values(A, value)
        waiters = tables.exchange(x)
        out, arg = _run_group(A, tables.group(0), x, is_min, v_loc)
        bufs = [x]
        for i, wait in enumerate(waiters, 1):
            bufs.append(wait())
            out, arg = _run_group(A, tables.group(i), bufs[i], is_min, v_loc,
                                  out, arg)
        ctx.A, ctx.tables, ctx.is_min = A, tables, is_min
        buf = torch.cat(bufs) if ctx.needs_input_grad[4] else None
        ctx.save_for_backward(buf, v_loc, arg)
        return _outputs(ctx, out, arg)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _garg=None):
        A, tables = ctx.A, ctx.tables
        buf, v_loc, arg = ctx.saved_tensors
        g = g.contiguous()
        grad_x = grad_v = None
        if ctx.needs_input_grad[3]:
            n = len(tables.sizes)
            if ctx.is_min is None:
                def gbuf(i):
                    t = tables.transpose(i).group(v_loc)
                    return shard_spmm(t.rowptr, t.col, t.value, g)
                finish = tables.exchange_back([gbuf(i) for i in range(1, n)])
                grad_x = gbuf(0)
            else:
                full = _minmax_grad_buf(A, tables.view, v_loc, g, arg)
                parts = full.split(tables.sizes)
                finish = tables.exchange_back(parts[1:])
                grad_x = parts[0].contiguous()
            finish(grad_x)
        if ctx.needs_input_grad[4]:
            grad_v = _value_grad(A, tables.view, buf, g, arg)
        return None, None, None, grad_x, grad_v


class _ExchangeHybridSpmm(torch.autograd.Function):
    """An exchange schedule with the hybrid local format (sum only;
    values are baked): the interior's dense blocks on ``block_spmm``
    plus the remainder group, then each buffer tier as its group or, when
    its store is built, one dense product against the buffer.  Backward:
    ``block_spmm_t`` plus the remainder's transpose, and each tier's
    transpose sent back through the transposed collectives."""

    @staticmethod
    def forward(ctx, A, tables, hy, x):
        waiters = tables.exchange(x)
        xb = _pad_to_blocks(x, A.block_B)
        out = block_spmm(hy.blocks, hy.slot_col, hy.rb_ptr, xb)[:A.Mb]
        out = out.to(x.dtype).contiguous()
        if hy.rest is not None:
            r = hy.rest
            shard_spmm(r.rowptr, r.col, r.value, x, out=out)
        for i, wait in enumerate(waiters, 1):
            buf = wait()
            store = hy.fr_dense[i - 1]
            if store is not None:
                out = out + _dense_matmul(store, buf).to(x.dtype)
            else:
                out, _ = _run_group(A, tables.group(i), buf, None, None, out)
        ctx.A, ctx.tables, ctx.hy = A, tables, hy
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        A, tables, hy = ctx.A, ctx.tables, ctx.hy
        g = g.contiguous()
        gbufs = []
        for i in range(1, len(tables.sizes)):
            store = hy.fr_dense[i - 1]
            if store is not None:
                gbufs.append(_dense_matmul(store.t(), g).to(g.dtype))
            else:  # the exchange runs on every rank all the same
                t = tables.transpose(i).group(None)
                gbufs.append(shard_spmm(t.rowptr, t.col, t.value, g))
        finish = tables.exchange_back(gbufs)
        gb = _pad_to_blocks(g, A.block_B)
        grad_x = block_spmm_t(hy.blocks, hy.slot_row, hy.order_t, hy.cb_ptr,
                              gb)[:A.Nb].to(g.dtype).contiguous()
        if hy.rest_t is not None:
            r = hy.rest_t
            shard_spmm(r.rowptr, r.col, r.value, g, out=grad_x)
        finish(grad_x)
        return None, None, None, grad_x


def _postprocess(A: _RowShard, res, reduce: str):
    """Empty-row and mean fix-up from the shard's rowcount: mean divides
    by ``max(count, 1)``; min/max write 0 and the sentinel ``arg ==
    nnz`` on empty rows."""
    rc = A.rowcount
    if reduce == "mean":
        return res / rc.clamp_min(1).to(res.dtype)[:, None]
    if reduce in ("min", "max"):
        out, arg = res
        empty = (rc == 0)[:, None]
        out = torch.where(empty, torch.zeros((), dtype=out.dtype,
                                             device=out.device), out)
        arg = torch.where(empty, A.nnz, arg).to(INDEX_DTYPE)
        return out, arg
    return res


def dist_spmm_allgather(A: ShardedSparseMatrix, x: torch.Tensor,
                        reduce: str = "sum",
                        value: Optional[torch.Tensor] = None):
    """``x``: this rank's ``(Nb, K)`` block (:meth:`shard_dense`).
    Returns this rank's ``(Mb, K)`` rows; min/max also the argout.
    ``value``: an optional edge-space override ``(nnz,)`` in original
    edge ids (see the module docstring for its gradient)."""
    _check_x(A, x)
    is_min = _is_min_of(reduce)
    return _postprocess(A, _AllgatherSpmm.apply(A, is_min, x, value), reduce)


def dist_spmm_ring(A: ShardedSparseMatrix, x: torch.Tensor,
                   reduce: str = "sum", value: Optional[torch.Tensor] = None):
    """Ring-rotated SpMM with overlapped block rotation; arguments and
    results as :func:`dist_spmm_allgather`."""
    _check_x(A, x)
    is_min = _is_min_of(reduce)
    return _postprocess(A, _RingSpmm.apply(A, is_min, x, value), reduce)


def dist_spmm_halo(A: ShardedSparseMatrix, x: torch.Tensor,
                   reduce: str = "sum", local_format: str = "ell",
                   value: Optional[torch.Tensor] = None):
    """Halo-exchange SpMM; arguments and results as
    :func:`dist_spmm_allgather`.

    ``local_format``: ``"ell"`` (the groups, every reduce, value
    gradients), ``"hybrid"`` (interior dense blocks; sum/mean only and
    no ``value`` override, since the blocks bake the values; raises
    where it cannot apply) or ``"auto"`` (hybrid where built and
    applicable).  The name ``"ell"`` is the JAX package's; here it
    means the CSR groups."""
    _check_x(A, x)
    is_min = _is_min_of(reduce)
    if local_format not in ("ell", "hybrid", "auto"):
        raise ValueError(f"Unknown local_format: {local_format!r}")
    use_hyb = (local_format in ("hybrid", "auto") and is_min is None
               and value is None and A.has_interior_blocks())
    if local_format == "hybrid" and not use_hyb:
        raise ValueError(
            "local_format='hybrid' needs interior blocks (built by "
            "from_sparse_tensor(interior_blocks='auto') when the density "
            "stats clear the break-even), reduce in sum/mean, and no "
            "edge-space value override (blocks bake values); use 'auto' "
            "to fall back silently")
    if use_hyb:
        return _postprocess(A, _ExchangeHybridSpmm.apply(A, A._halo,
                                                         A._hybrid, x),
                            reduce)
    return _postprocess(A, _ExchangeSpmm.apply(A, A._halo, is_min, x, value),
                        reduce)


def dist_spmm(A: ShardedSparseMatrix, x: torch.Tensor,
              schedule: str = "ring", reduce: str = "sum",
              local_format: str = "ell",
              value: Optional[torch.Tensor] = None):
    """Reduce-aware distributed SpMM: ``sum``/``mean`` return this
    rank's ``(Mb, K)`` rows, ``min``/``max`` also the argout.
    ``schedule`` is ``"ring"``, ``"allgather"`` or ``"halo"``;
    ``local_format`` selects the halo schedule's local compute."""
    if schedule == "ring":
        return dist_spmm_ring(A, x, reduce, value)
    if schedule == "allgather":
        return dist_spmm_allgather(A, x, reduce, value)
    if schedule == "halo":
        return dist_spmm_halo(A, x, reduce, local_format, value)
    raise ValueError(f"Unknown schedule: {schedule!r}")
