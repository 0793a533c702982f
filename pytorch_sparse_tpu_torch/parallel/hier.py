"""Hierarchical (DCN x ICI) distributed SpMM (counterpart of
``pytorch_sparse_tpu/parallel/hier.py``).

A two-tier fabric (cards of one host on NVLink, hosts on the network;
ICI and DCN in the JAX package's TPU terms) makes the flat halo schedule
send most of its traffic over the slow tier, and the same remote row
once per requesting process.  On a ``(dcn, ici)`` grid
(:func:`~.mesh.make_mesh_hier`) of ``S`` slices of ``C`` chips, row block
``p = s*C + c`` lives on chip ``c`` of slice ``s``, and each shard splits
its edges three ways:

* interior: columns in its own block, against ``x``;
* intra-slice frontier: columns in another block of its slice, against
  the ``(C*Hi, K)`` halo that one ``all_to_all`` over the ``ici``
  sub-mesh delivers (``Hi`` rows from each chip of the slice);
* cross-slice frontier: columns in other slices, against the ``(C*S*Hx,
  K)`` union buffer.  Each server block sends, once per client slice,
  the union of the rows any chip of that slice reads (one
  ``all_to_all`` over the ``dcn`` sub-mesh), and the slice's chips
  all-gather what they received over ``ici``: row block ``c'*S + s'`` of
  the union holds block ``(s', c')``'s rows.

The interior runs on the shard kernel K11a (K11b for min/max) while both
exchanges move; each frontier is accumulated (or combined) as its buffer
arrives, so the sum is ``interior + intra + cross`` and min/max ties go
to the lower global edge id across the three groups.  Backward runs the
transposes: the union's gradient is reduce-scattered over ``ici`` and
sent back over ``dcn``, the halo's back over ``ici``, and each server
adds what returns at its served rows, each row's returns summed in a
fixed order (``dist._Served``).  ``local_format="hybrid"`` runs
the interior's dense blocks on the block kernel and each frontier tier,
when its dense store is built, as one dense product.

Every global quantity (``Hi``, ``Hx``, the served rows, the buffer
layout, the wire statistics and the interior-block and per-tier
dense-frontier decisions, which keep the JAX package's TPU-priced
constants) is decided from the whole matrix, which every rank holds on
the host, exactly as the JAX package decides it; each rank builds only
its own tables, at first use.  Gradients follow the convention of
``parallel/dist.py``.
"""

from __future__ import annotations

from functools import cached_property
from typing import Dict, Optional

import numpy as np
import torch

from . import _comm
from .dist import (
    _ExchangeHybridSpmm, _ExchangeSpmm, _Hybrid, _RowShard, _Served, _Tiers,
    _build_frontier_dense, _check_x, _is_min_of, _postprocess, _worst)
from .mesh import data_axis, dcn_axis


class _HierTables(_Tiers):
    """The three tiers (``x``, the ``(C*Hi, K)`` ICI halo, the
    ``(C*S*Hx, K)`` DCN union) and the rows this rank serves on each
    fabric (``served_ici``, ``served_dcn``): ``serve_ici`` ``(C*Hi,)``
    (``Hi`` rows for each chip of its slice) and ``serve_dcn``
    ``(S*Hx,)`` (the union each slice reads)."""

    def __init__(self, A, cols, tier, Hi, Hx, served_ici: _Served,
                 served_dcn: _Served, wire_stats):
        S, C = A.S, A.C
        super().__init__(A, cols, tier, (A.Nb, C * Hi, C * S * Hx))
        self.Hi, self.Hx = Hi, Hx
        self.served_ici, self.served_dcn = served_ici, served_dcn
        self.serve_ici, self.serve_dcn = served_ici.index, served_dcn.index
        self.wire_stats = wire_stats

    def exchange(self, x: torch.Tensor):
        A = self._A
        dcn, ici = A.grid.axis(dcn_axis), A.grid.axis(data_axis)
        # The cross-slice leg first: it is the slower fabric.
        to_dcn = _comm.all_to_all(dcn, x.index_select(0, self.serve_dcn),
                                  async_op=True)
        to_ici = _comm.all_to_all(ici, x.index_select(0, self.serve_ici),
                                  async_op=True)
        return [to_ici.wait, lambda: _comm.all_gather(ici, to_dcn.wait())]

    def exchange_back(self, gbufs):
        A = self._A
        dcn, ici = A.grid.axis(dcn_axis), A.grid.axis(data_axis)
        g_halo, g_union = gbufs
        back_ici = _comm.all_to_all(ici, g_halo.contiguous(), async_op=True)
        back_dcn = _comm.all_to_all(
            dcn, _comm.reduce_scatter(ici, g_union.contiguous()),
            async_op=True)

        def finish(grad_x):
            self.served_ici.add_into(grad_x, back_ici.wait())
            self.served_dcn.add_into(grad_x, back_dcn.wait())
        return finish


class HierShardedSparseMatrix(_RowShard):
    """This rank's row shard of a sparse matrix on a ``(dcn, ici)``
    :class:`~.mesh.Grid` (:func:`~.mesh.make_mesh_hier`): block ``p =
    s*C + c`` of ``P = S*C``, ``p`` the rank in the default group.
    ``mesh`` spans the whole grid (``unshard_dense``, the model's
    all-reduce); ``world`` is the same mesh.  ``Hi``, ``Hx``,
    ``serve_ici`` ``(C, Hi)``, ``serve_dcn`` ``(S, Hx)`` (this rank's
    rows of the JAX package's ``(P, C, Hi)`` and ``(P, S, Hx)``),
    ``wire_stats`` and the dense stores ``fi_dense``/``fx_dense`` build
    at first use."""

    def __init__(self, A, grid, interior_blocks: str = "auto",
                 block_B: int = 512, frontier_dense: str = "auto"):
        if tuple(getattr(grid, "names", ())) != (dcn_axis, data_axis):
            raise ValueError("a HierShardedSparseMatrix takes a (dcn, ici) "
                             "grid (make_mesh_hier)")
        self.grid = grid
        self.mesh = self.world = grid.mesh
        self.S, self.C = grid.shape[dcn_axis], grid.shape[data_axis]
        super().__init__(A, self.S * self.C, grid.mesh.rank, grid.device,
                         interior_blocks, block_B, frontier_dense)
        self.s, self.c = divmod(self.rank, self.C)

    @classmethod
    def from_sparse_tensor(cls, A, grid, interior_blocks: str = "auto",
                           block_B: int = 512, frontier_dense: str = "auto"
                           ) -> "HierShardedSparseMatrix":
        """Partition ``A``'s rows into ``S*C`` contiguous blocks; slice
        ``s`` owns blocks ``[s*C, (s+1)*C)``.  Every rank passes the same
        ``A``.  Permute ``A`` first so that both tiers see
        community-aligned cuts.  ``interior_blocks`` and
        ``frontier_dense`` as for
        :meth:`~.dist.ShardedSparseMatrix.from_sparse_tensor`; the dense
        frontier is decided per tier."""
        return cls(A, grid, interior_blocks, block_B, frontier_dense)

    def _tier_of(self, owner: np.ndarray, block: np.ndarray) -> np.ndarray:
        """0 interior, 1 intra-slice, 2 cross-slice, for each edge of
        owner block ``owner`` and column block ``block``."""
        C = self.C
        return np.where(block == owner, 0,
                        np.where(block // C == owner // C, 1, 2)).astype(
                            np.int8)

    @cached_property
    def _tables(self) -> _HierTables:
        S, C, Pn, Mb, Nb, me = self.S, self.C, self.P, self.Mb, self.Nb, \
            self.rank
        row, col, _ = self._coo
        owner, block = row // Mb, col // Nb
        local = col - block * Nb
        tier = self._tier_of(owner, block)
        ici, dcn = tier == 1, tier == 2
        # The distinct local rows each server block q sends to each chip
        # c' of its slice (key q*C + c'), and the union it sends to each
        # client slice s' (key q*S + s').
        ukey_i = np.unique((block[ici] * C + owner[ici] % C) * Nb
                           + local[ici])
        ukey_x = np.unique((block[dcn] * S + owner[dcn] // C) * Nb
                           + local[dcn])
        cnt_i = np.bincount(ukey_i // Nb, minlength=Pn * C)
        cnt_x = np.bincount(ukey_x // Nb, minlength=Pn * S)
        Hi, Hx = max(1, int(cnt_i.max())), max(1, int(cnt_x.max()))
        st_i = np.concatenate([[0], np.cumsum(cnt_i)])
        st_x = np.concatenate([[0], np.cumsum(cnt_x)])
        flat_cross = np.unique((owner[dcn] * Pn + block[dcn]) * Nb
                               + local[dcn]).size
        wire_stats = {
            # real distinct rows crossing DCN per step, with and without
            # the slice-level union
            "dcn_rows_hier": int(ukey_x.size),
            "dcn_rows_flat": int(flat_cross),
            "ici_rows": int(ukey_i.size),
            # padded row slots the collectives move
            "dcn_row_slots": Pn * S * Hx,
            "ici_row_slots": Pn * C * Hi + Pn * (C * S * Hx),
        }
        dev = self.device
        served_ici = _Served(ukey_i, st_i, range(me * C, me * C + C), Hi,
                             Nb, dev)
        served_dcn = _Served(ukey_x, st_x, range(me * S, me * S + S), Hx,
                             Nb, dev)
        # This shard's columns into [x ; halo (C*Hi) ; union (C*S*Hx)].
        s, c = self.s, self.c
        qb = self._c // Nb
        lc = self._c - qb * Nb
        my_tier = self._tier_of(np.full_like(qb, me), qb)
        cols = np.where(my_tier == 0, lc, 0)
        m = my_tier == 1
        k = qb[m] * C + c
        cols[m] = (Nb + (qb[m] % C) * Hi
                   + np.searchsorted(ukey_i, k * Nb + lc[m]) - st_i[k])
        m = my_tier == 2
        k = qb[m] * S + s
        sq, cq = qb[m] // C, qb[m] % C
        cols[m] = (Nb + C * Hi + (cq * S + sq) * Hx
                   + np.searchsorted(ukey_x, k * Nb + lc[m]) - st_x[k])
        return _HierTables(self, cols, my_tier, Hi, Hx, served_ici,
                           served_dcn, wire_stats)

    @property
    def Hi(self) -> int:
        return self._tables.Hi

    @property
    def Hx(self) -> int:
        return self._tables.Hx

    @property
    def serve_ici(self) -> torch.Tensor:
        return self._tables.serve_ici.view(self.C, -1)

    @property
    def serve_dcn(self) -> torch.Tensor:
        return self._tables.serve_dcn.view(self.S, -1)

    @property
    def wire_stats(self) -> Dict[str, int]:
        return self._tables.wire_stats

    @cached_property
    def _hybrid(self) -> Optional[_Hybrid]:
        """The interior's dense blocks and, decided per tier by the same
        rule, the intra-slice ``(Mb, C*Hi)`` and cross-slice ``(Mb,
        C*S*Hx)`` dense frontier stores; None when the blocks are not
        built (the JAX package then builds neither store)."""
        if self._interior_blocks == "never":
            return None
        hyb = self._build_interior_blocks()
        if hyb is None:
            return None
        row, col, val = self._coo
        owner = row // self.Mb
        tier = self._tier_of(owner, col // self.Nb)
        t = self._tables
        hyb.fr_dense = tuple(
            _build_frontier_dense(
                self._frontier_dense, _worst(owner[tier == i], self.P),
                val[tier == i], self.Mb, t.sizes[i], t.edges(i), self.device)
            for i in (1, 2))
        return hyb

    @property
    def fi_dense(self) -> Optional[torch.Tensor]:
        """The intra-slice dense frontier store, or None."""
        return None if self._hybrid is None else self._hybrid.fr_dense[0]

    @property
    def fx_dense(self) -> Optional[torch.Tensor]:
        """The cross-slice dense frontier store, or None."""
        return None if self._hybrid is None else self._hybrid.fr_dense[1]

    def shard_dense(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's ``(Nb, K)`` rows of the ``(N, K)`` operand, zero
        rows past ``N``, on the grid's device."""
        return self._shard_rows(x)

    def unshard_dense(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(Mb, K)`` block gathered into the ``(M, K)``
        result (a collective: every rank calls it)."""
        return _comm.all_gather(self.mesh, y)[:self.M]

    def wire_report(self, K: int = 128, itemsize: int = 4) -> Dict:
        """Fabric bytes a step (real rows x ``K`` x ``itemsize``): the
        flat halo schedule's cross-slice traffic against this schedule's
        slice-deduplicated DCN traffic, and the whole ICI leg (the
        intra-slice halos and the all-gather that spreads each received
        union row to the slice's other ``C - 1`` chips)."""
        w = self.wire_stats
        ici_rows = w["ici_rows"] + (self.C - 1) * w["dcn_rows_hier"]
        return {
            "dcn_bytes_flat": w["dcn_rows_flat"] * K * itemsize,
            "dcn_bytes_hier": w["dcn_rows_hier"] * K * itemsize,
            "dcn_dedup_factor": (w["dcn_rows_flat"] / w["dcn_rows_hier"]
                                 if w["dcn_rows_hier"] else 1.0),
            "ici_bytes": ici_rows * K * itemsize,
        }

    def __repr__(self) -> str:
        return (f"HierShardedSparseMatrix(M={self.M}, N={self.N}, "
                f"nnz={self.nnz}, S={self.S}, C={self.C}, rank={self.rank}, "
                f"Mb={self.Mb}, Nb={self.Nb})")


def dist_spmm_hier(A: HierShardedSparseMatrix, x: torch.Tensor,
                   reduce: str = "sum", local_format: str = "ell",
                   value: Optional[torch.Tensor] = None):
    """Hierarchy-aware SpMM: ``x`` is this rank's ``(Nb, K)`` block
    (:meth:`HierShardedSparseMatrix.shard_dense`); returns its ``(Mb,
    K)`` rows of ``A @ x`` for sum and mean, and the argout too for min
    and max (a global edge id in CSR order, ``nnz`` on empty rows).

    ``local_format``: ``"ell"`` (the CSR groups, every reduce, value
    gradients), ``"hybrid"`` (the interior's dense blocks and the built
    dense frontier stores; sum/mean only and no ``value``, since the
    stores bake the values; raises where it cannot apply) or ``"auto"``
    (hybrid where built and applicable).  ``value``: an optional
    edge-space override ``(nnz,)`` in original edge ids, whose gradient
    is this rank's share (all-reduce it with SUM)."""
    _check_x(A, x)
    is_min = _is_min_of(reduce)
    if local_format not in ("ell", "hybrid", "auto"):
        raise ValueError(f"Unknown local_format: {local_format!r}")
    use_hyb = (local_format in ("hybrid", "auto") and is_min is None
               and value is None and A.has_interior_blocks())
    if local_format == "hybrid" and not use_hyb:
        raise ValueError(
            "local_format='hybrid' needs interior blocks, reduce in "
            "sum/mean, and no edge-space value override; use 'auto' to "
            "fall back silently")
    if use_hyb:
        return _postprocess(A, _ExchangeHybridSpmm.apply(A, A._tables,
                                                         A._hybrid, x),
                            reduce)
    return _postprocess(A, _ExchangeSpmm.apply(A, A._tables, is_min, x,
                                               value), reduce)
