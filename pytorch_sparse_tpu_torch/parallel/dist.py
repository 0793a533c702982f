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

Each schedule takes ``reduce`` of sum, mean, min or max (min/max also
return the argout, a global edge id in CSR order, ``nnz`` on empty
rows) and an optional edge-space ``value`` override whose gradient comes
back in original edge ids.  Each is one ``torch.autograd.Function`` per
rank whose backward runs the transposed collectives: reduce-scatter for
the all-gather, the reverse rotation for the ring (each gradient block
travels back to its owner), the reverse ``all_to_all`` and an
``index_add_`` at the served rows for the halo.

Gradients follow ``torch.distributed``'s data-parallel convention.  The
gradient of a rank's shard ``x`` is that of the sum of every rank's
objective (the backward collectives carry the other ranks' parts); the
gradient of the replicated ``value`` is this rank's share, nonzero on
its own edges only: all-reduce it with SUM, as for any replicated
parameter, to get the gradient of the sum.  Every rank must run the same
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

from ..ops.kernels.block_spmm import block_spmm, block_spmm_t
from ..ops.kernels.edge_dot import edge_dot
from ..ops.kernels.hybrid import (
    _ELL_NS_PER_NNZ, _HBM_BW, _dense_matmul, _pad_to_blocks, _upload,
    block_break_even, get_store_budget, quantization_rel_err)
from ..ops.kernels.shard_spmm import NO_EDGE, shard_spmm, shard_spmm_minmax
from ..ops.kernels.spmm_minmax import minmax_edge_dot, minmax_spmm_t
from ..utils.convert import INDEX_DTYPE
from ..utils.host_sort import lexsort2, stable_argsort
from . import _comm
from .mesh import Mesh

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


class _HaloTables:
    """The halo width ``H``, the rows this rank serves (``serve``,
    ``(P*H,)``: ``P`` packets of ``H`` local rows) and the shard's
    columns into ``[x ; halo]`` (``cols``, host; the frontier's past
    ``Nb``).  The groups, their transposes and the merged view are built
    at first use."""

    def __init__(self, A, H, serve, cols):
        self.H, self.serve, self.cols = H, serve, cols
        self._A = A
        own = A._c // A.Nb == A.rank
        self._ipos, self._fpos = np.flatnonzero(own), np.flatnonzero(~own)

    def _edges(self, pos, shift):
        A = self._A
        return A._r[pos], self.cols[pos] - shift, A._v[pos]

    @cached_property
    def interior(self) -> _Group:
        return _Group.build(*self._edges(self._ipos, 0), self._ipos,
                            self._A.Mb, False, self._A.device)

    @cached_property
    def frontier(self) -> _Group:
        return _Group.build(*self._edges(self._fpos, self._A.Nb), self._fpos,
                            self._A.Mb, True, self._A.device)

    @cached_property
    def interior_t(self) -> _Csc:
        A = self._A
        return _Csc(*self._edges(self._ipos, 0), A.Nb, A.device, self._ipos)

    @cached_property
    def frontier_t(self) -> _Csc:
        A = self._A
        return _Csc(*self._edges(self._fpos, A.Nb), A.P * self.H, A.device,
                    self._fpos)

    @cached_property
    def view(self) -> _View:
        return _View(self._A, self.cols, self._A.Nb + self._A.P * self.H)


class _Hybrid:
    def __init__(self, blocks, slot_row, slot_col, rb_ptr, order_t, cb_ptr,
                 rest, rest_t, fr_dense):
        self.blocks, self.slot_row, self.slot_col = blocks, slot_row, slot_col
        self.rb_ptr, self.order_t, self.cb_ptr = rb_ptr, order_t, cb_ptr
        self.rest, self.rest_t, self.fr_dense = rest, rest_t, fr_dense


class ShardedSparseMatrix:
    """This rank's row shard of a sparse matrix on a :class:`Mesh`.

    ``M, N`` the matrix size, ``Mb, Nb = ceil(M/P), ceil(N/P)`` the row
    and column block sizes, ``nnz`` the matrix's edge count, ``e0`` the
    global id of the shard's first edge (edges are numbered in CSR
    order, so the shard's edges are ``[e0, e0 + E_p)``), ``rowcount``
    ``(Mb,)`` int32 the shard's row lengths.  ``halo_width`` and
    ``serve_idx`` (``(P, H)``: row ``p`` lists the local rows of this
    rank's block that rank ``p`` reads, padded with 0) build the halo
    tables on first use.
    """

    def __init__(self, A, mesh: Mesh, interior_blocks: str = "auto",
                 block_B: int = 512, frontier_dense: str = "auto"):
        self.mesh = mesh
        self.P, self.rank, self.device = mesh.size, mesh.rank, mesh.device
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

    @classmethod
    def from_sparse_tensor(cls, A, mesh: Mesh, interior_blocks: str = "auto",
                           block_B: int = 512,
                           frontier_dense: str = "auto"
                           ) -> "ShardedSparseMatrix":
        """Partition ``A``'s rows into contiguous blocks of
        ``ceil(M/P)``; this rank keeps block ``mesh.rank``.  Every rank
        passes the same ``A`` (host arrays are read; ``A`` may lie on any
        device).  For a low-cut layout permute ``A`` first so that block
        boundaries match cluster boundaries.  ``interior_blocks``
        ("auto"/"never") and ``frontier_dense`` ("auto"/"never"/
        "always") decide the hybrid local format as the JAX package
        does."""
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
        serve = np.zeros((P, H), np.int64)
        for p in range(P):
            s, e = starts[p * P + me], starts[p * P + me + 1]
            serve[p, :e - s] = ukey[s:e] % Nb
        qb = self._c // Nb
        own = qb == me
        cols = np.where(own, self._c - me * Nb, 0)
        fpos = np.flatnonzero(~own)
        q, local = qb[fpos], self._c[fpos] % Nb
        slot = np.searchsorted(ukey, (me * P + q) * Nb + local)
        cols[fpos] = Nb + q * H + slot - starts[me * P + q]
        return _HaloTables(self, H, torch.from_numpy(serve.reshape(-1)).to(
            self.device), cols)

    @property
    def halo_width(self) -> int:
        return self._halo.H

    @property
    def serve_idx(self) -> torch.Tensor:
        return self._halo.serve.view(self.P, -1)

    @cached_property
    def _hybrid(self) -> Optional[_Hybrid]:
        """The interior's dense blocks (and the dense frontier), or None
        when the JAX package's rule does not build them."""
        hyb = None
        if self._interior_blocks != "never":
            hyb = self._build_hybrid()
        if self._frontier_dense == "always" and (
                hyb is None or hyb.fr_dense is None):
            warnings.warn(
                "frontier_dense='always' not honored: the dense frontier "
                "is gated on the interior blocks clearing their break-even "
                "(interior_blocks != 'never' and the shards dense enough) "
                "and on the per-shard store staying under the 1 GiB cap; "
                "this matrix keeps the frontier group.")
        return hyb

    def has_interior_blocks(self) -> bool:
        return self._hybrid is not None

    def has_frontier_dense(self) -> bool:
        return self._hybrid is not None and self._hybrid.fr_dense is not None

    def _build_hybrid(self) -> Optional[_Hybrid]:
        """``_build_interior_blocks`` and ``_build_frontier_dense`` of
        the JAX package, deciding from every shard's interior and this
        rank building only its own blocks."""
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
        blocks = np.zeros((nb + 1) * B * B, np.float32)
        d = np.flatnonzero(dmask)
        np.add.at(blocks, (slot[d] * B + r[d] % B) * B + c[d] % B, v[d])
        slot_row, slot_col = own_keys // Cb, own_keys % Cb
        order_t = stable_argsort(slot_col)
        dev = self.device
        rest = np.flatnonzero(~dmask)
        rest_g = rest_t = None
        if rest.size:
            rest_g = _Group.build(r[rest], c[rest], v[rest], None, Mb, False,
                                  dev)
            rest_t = _Csc(r[rest], c[rest], v[rest], Nb, dev).group(None)
        return _Hybrid(
            _upload(blocks.reshape(nb + 1, B, B), dev,
                    torch.bfloat16 if store_bf16 else torch.float32),
            _idx(slot_row, dev), _idx(slot_col, dev),
            _idx(np.searchsorted(slot_row, np.arange(Rb + 1)), dev),
            _idx(order_t, dev),
            _idx(np.searchsorted(slot_col[order_t], np.arange(Cb + 1)), dev),
            rest_g, rest_t, self._build_frontier_dense(owner, inter))

    def _build_frontier_dense(self, owner, inter) -> Optional[torch.Tensor]:
        if self._frontier_dense == "never":
            return None
        P, Mb = self.P, self.Mb
        halo = self._halo
        PH = P * halo.H
        worst = int(np.bincount(owner[~inter], minlength=P).max()) if (
            ~inter).any() else 0
        if worst == 0 or Mb * PH == 0:
            return None
        store_bf16 = (quantization_rel_err(self._coo[2][~inter])
                      <= get_store_budget())
        elem = 2 if store_bf16 else 4
        passes = 1.0 if store_bf16 else 3.0
        if Mb * PH * elem >= _FR_DENSE_SHARD_CAP:
            return None
        if self._frontier_dense != "always":
            t_dense = passes * Mb * PH * elem / _HBM_BW
            t_ell = worst * _ELL_NS_PER_NNZ * 1e-9
            if t_dense >= t_ell:
                return None
        fpos = halo._fpos
        slab = np.zeros(Mb * PH, np.float32)
        np.add.at(slab, self._r[fpos] * PH + halo.cols[fpos] - self.Nb,
                  self._v[fpos])
        return _upload(slab.reshape(Mb, PH), self.device,
                       torch.bfloat16 if store_bf16 else torch.float32)

    @cached_property
    def _values(self) -> torch.Tensor:
        """The shard's baked values in CSR order, on the device."""
        return _f32(self._v, self.device)

    # ------------------------------------------------------------------
    # Dense operands
    # ------------------------------------------------------------------
    def shard_dense(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's ``(Nb, K)`` block of the ``(N, K)`` operand ``x``,
        zero rows past ``N``, on the mesh's device."""
        lo = self.rank * self.Nb
        blk = x[lo:lo + self.Nb].to(self.device)
        pad = self.Nb - blk.shape[0]
        if pad:
            blk = torch.cat([blk, blk.new_zeros((pad, *blk.shape[1:]))])
        return blk.contiguous()

    def unshard_dense(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(Mb, K)`` block gathered into the ``(M, K)``
        result (a collective: every rank calls it)."""
        return _comm.all_gather(self.mesh, y)[:self.M]

    def __repr__(self) -> str:
        return (f"ShardedSparseMatrix(M={self.M}, N={self.N}, nnz={self.nnz}"
                f", P={self.P}, rank={self.rank}, Mb={self.Mb}, Nb={self.Nb})")


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


def _local_values(A: ShardedSparseMatrix,
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


def _check_x(A: ShardedSparseMatrix, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != A.Nb:
        raise ValueError(f"x must be this rank's ({A.Nb}, K) block "
                         "(ShardedSparseMatrix.shard_dense)")
    if x.device != A.device:
        raise ValueError("x lies on another device than the mesh's")


def _arg_local(A: ShardedSparseMatrix, arg: torch.Tensor) -> torch.Tensor:
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


def _serve(A, x: torch.Tensor):
    """Post the halo exchange: the rows each client reads from this
    rank's block, one ``(H, K)`` packet per client."""
    halo = A._halo
    return _comm.all_to_all(A.mesh, x.index_select(0, halo.serve),
                            async_op=True)


def _unserve(A, grad_buf: torch.Tensor):
    """Post the reverse halo exchange: each received packet's gradient
    goes back to the rank that served it."""
    return _comm.all_to_all(A.mesh, grad_buf.contiguous(), async_op=True)


class _HaloSpmm(torch.autograd.Function):
    """The halo schedule over the shard's groups: the interior against
    ``x`` while the halo packets move, then the frontier against the
    received buffer (accumulated, or combined for min/max).  Backward:
    the transpose over the merged view ``[x ; halo]``; the halo rows'
    gradient rides the reverse ``all_to_all`` to the serving rank, which
    adds it at its served rows."""

    @staticmethod
    def forward(ctx, A, is_min, x, value):
        hl = A._halo
        v_loc = _local_values(A, value)
        pending = _serve(A, x)
        it, fr = hl.interior, hl.frontier
        if is_min is None:
            out = shard_spmm(it.rowptr, it.col, it.values(v_loc), x)
            arg = None
        else:
            out, arg = shard_spmm_minmax(it.rowptr, it.col, it.values(v_loc),
                                         x, is_min, A.e0, pos=it.pos)
        halo = pending.wait()
        if fr.nnz:
            if is_min is None:
                shard_spmm(fr.rowptr, fr.col, fr.values(v_loc), halo,
                           out=out, row_map=fr.row_map)
            else:
                shard_spmm_minmax(fr.rowptr, fr.col, fr.values(v_loc), halo,
                                  is_min, A.e0, pos=fr.pos, out=out, arg=arg,
                                  row_map=fr.row_map)
        ctx.A, ctx.is_min = A, is_min
        buf = torch.cat([x, halo]) if ctx.needs_input_grad[3] else None
        ctx.save_for_backward(buf, v_loc, arg)
        return _outputs(ctx, out, arg)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _garg=None):
        A, Nb = ctx.A, ctx.A.Nb
        hl = A._halo
        buf, v_loc, arg = ctx.saved_tensors
        g = g.contiguous()
        grad_x = grad_v = None
        if ctx.needs_input_grad[2]:
            if ctx.is_min is None:
                fr = hl.frontier_t.group(v_loc)
                pending = _unserve(A, shard_spmm(fr.rowptr, fr.col, fr.value,
                                                 g))
                it = hl.interior_t.group(v_loc)
                grad_x = shard_spmm(it.rowptr, it.col, it.value, g)
            else:
                gbuf = _minmax_grad_buf(A, hl.view, v_loc, g, arg)
                pending = _unserve(A, gbuf[Nb:])
                grad_x = gbuf[:Nb].contiguous()
            grad_x.index_add_(0, hl.serve, pending.wait())
        if ctx.needs_input_grad[3]:
            grad_v = _value_grad(A, hl.view, buf, g, arg)
        return None, None, grad_x, grad_v


class _HaloHybridSpmm(torch.autograd.Function):
    """The halo schedule with the hybrid local format (sum only; values
    are baked): the interior's dense blocks on ``block_spmm`` plus the
    remainder group, then the frontier group or the dense frontier
    product over the received buffer.  Backward: ``block_spmm_t`` plus
    the remainder's transpose, and the frontier's transpose sent back
    through the reverse ``all_to_all``."""

    @staticmethod
    def forward(ctx, A, x):
        hl, hy = A._halo, A._hybrid
        pending = _serve(A, x)
        B = A.block_B
        xb = _pad_to_blocks(x, B)
        out = block_spmm(hy.blocks, hy.slot_col, hy.rb_ptr, xb)[:A.Mb]
        out = out.to(x.dtype).contiguous()
        if hy.rest is not None:
            r = hy.rest
            shard_spmm(r.rowptr, r.col, r.value, x, out=out)
        halo = pending.wait()
        if hy.fr_dense is not None:
            out = out + _dense_matmul(hy.fr_dense, halo).to(x.dtype)
        elif hl.frontier.nnz:
            fr = hl.frontier
            shard_spmm(fr.rowptr, fr.col, fr.value, halo, out=out,
                       row_map=fr.row_map)
        ctx.A = A
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        A, Nb = ctx.A, ctx.A.Nb
        hl, hy = A._halo, A._hybrid
        g = g.contiguous()
        if hy.fr_dense is not None:
            g_halo = _dense_matmul(hy.fr_dense.t(), g).to(g.dtype)
        elif hl.frontier.nnz:
            fr = hl.frontier_t.group(None)
            g_halo = shard_spmm(fr.rowptr, fr.col, fr.value, g)
        else:  # the exchange runs on every rank all the same
            g_halo = g.new_zeros((A.P * hl.H, g.shape[1]))
        pending = _unserve(A, g_halo)
        gb = _pad_to_blocks(g, A.block_B)
        grad_x = block_spmm_t(hy.blocks, hy.slot_row, hy.order_t, hy.cb_ptr,
                              gb)[:Nb].to(g.dtype).contiguous()
        if hy.rest_t is not None:
            r = hy.rest_t
            shard_spmm(r.rowptr, r.col, r.value, g, out=grad_x)
        grad_x.index_add_(0, hl.serve, pending.wait())
        return None, grad_x


def _postprocess(A: ShardedSparseMatrix, res, reduce: str):
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
        return _postprocess(A, _HaloHybridSpmm.apply(A, x), reduce)
    return _postprocess(A, _HaloSpmm.apply(A, is_min, x, value), reduce)


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
