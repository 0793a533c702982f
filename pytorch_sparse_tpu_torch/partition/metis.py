"""Graph partitioning (counterpart of ``pytorch_sparse_tpu/partition/
metis.py``; reference ``torch_sparse/metis.py``).

The reference's ``partition`` contract: ``(permuted adjacency, partptr,
perm)``.  The partitioner is the port's host library
(``csrc/host_partition.cpp``, built with the host C++ compiler at first
use): heavy-edge matching, greedy region growing with restarts and
boundary refinement at every level, the same code and seed as the JAX
package's native partitioner, so both give the same clusters.
``refine=False`` chunks the reverse Cuthill-McKee order instead.

The host math runs on the storage's numpy copies; the permuted matrix
comes from :func:`~pytorch_sparse_tpu_torch.ops.permute.permute`, and
``partptr``/``perm`` are int64 tensors on the source's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.permute import permute
from ..tensor import SparseTensor
from ..typing import DeviceLike, input_device
from ..utils.host_sort import stable_argsort
from . import _native


def _host(x) -> np.ndarray:
    """A host numpy copy of a tensor (bf16 widened to f32) or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _weight2metis_np(weight) -> Optional[np.ndarray]:
    """Host-side weight mapping (see :func:`weight2metis`)."""
    w = np.asarray(_host(weight), np.float64)
    sorted_w = np.sort(w)
    diff = sorted_w[1:] - sorted_w[:-1]
    if diff.sum() == 0:
        return None
    min_diff = diff[diff > 0].min()
    ratio = np.rint((w - sorted_w[0]) / min_diff).astype(np.float64) + 1.0
    # Capped below int32, as the JAX package caps it (its devices hold
    # int32), so that both packages give the partitioner the same
    # weights; the partitioner sums them into int64 gains.
    cap = float((1 << 31) - 1)
    if ratio.max() > cap:
        ratio = np.maximum(ratio * (cap / ratio.max()), 1.0)
    return ratio.astype(np.int64)


def weight2metis(weight, device: DeviceLike = None
                 ) -> Optional[torch.Tensor]:
    """Map float weights to positive integer ratios for the partitioner.

    The reference's contract (``metis.py:10-21``): None when all weights
    are equal, else integer weights that keep their relative magnitude.
    The mapping is the JAX package's: the smallest positive gap between
    two weights is one integer step, capped below int32.  Returns an
    int64 tensor on ``weight``'s device (a tensor), else on ``device``
    (default ``"cuda"``)."""
    dev = input_device(weight, device)
    ratio = _weight2metis_np(weight)
    return None if ratio is None else torch.from_numpy(ratio).to(dev)


def _rcm_order(rowptr, col, n) -> np.ndarray:
    import scipy.sparse as sp
    import scipy.sparse.csgraph  # noqa: F401

    data = np.ones(col.shape[0], np.int8)
    A = sp.csr_matrix((data, col, rowptr), (n, n))
    A = A + A.T
    return sp.csgraph.reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True)


def partition_fn(
    rowptr: np.ndarray,
    col: np.ndarray,
    num_parts: int,
    node_weight: Optional[np.ndarray] = None,
    refine: bool = True,
    edge_weight: Optional[np.ndarray] = None,
    num_workers: int = 0,
) -> np.ndarray:
    """The part of each node (the native-op analogue of
    ``torch_sparse::partition``/``partition2``, ``metis_cpu.cpp:13-62``).

    ``refine=True`` with ``num_parts > 1`` runs the multilevel
    partitioner (threaded when ``num_workers > 0``, the mt-metis
    analogue); ``edge_weight`` is METIS's adjwgt.  Otherwise the reverse
    Cuthill-McKee order is cut into ``num_parts`` contiguous chunks of
    equal weight.  The JAX package refines such chunks only when its
    native library is missing; the port's library is built, not
    optional, so it has no such branch."""
    n = rowptr.shape[0] - 1
    if refine and num_parts > 1:
        cluster, _cut = _native.multilevel_partition(
            rowptr, col, num_parts,
            node_weight.astype(np.float64)
            if node_weight is not None else None,
            edge_weight=edge_weight, num_workers=num_workers,
        )
        return cluster

    order = _rcm_order(rowptr, col, n).astype(np.int64)
    w = (node_weight.astype(np.float64) if node_weight is not None
         else np.ones(n, np.float64))
    # Contiguous chunking of the RCM order, balanced by cumulative weight.
    cum = np.cumsum(w[order])
    total = cum[-1]
    bounds = total * (np.arange(1, num_parts) / num_parts)
    split_at = np.searchsorted(cum, bounds, side="left")
    cluster_in_order = np.zeros(n, np.int64)
    for i, s in enumerate(split_at):
        cluster_in_order[s:] = i + 1
    cluster = np.empty(n, np.int64)
    cluster[order] = cluster_in_order
    return cluster


def _index(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.int64)).to(device)


def _edge_weights(src: SparseTensor, weighted: bool
                  ) -> Optional[np.ndarray]:
    """METIS edge weights of ``src``'s values: float values through
    :func:`weight2metis`'s mapping, integer ones as they are; None when
    not ``weighted`` or without 1-D values."""
    value = src.storage.value()
    if not weighted or value is None or value.dim() != 1:
        return None
    if value.is_floating_point():
        return _weight2metis_np(value)
    return _host(value).astype(np.int64)


def partition(
    src: SparseTensor,
    num_parts: int,
    recursive: bool = False,
    weighted: bool = False,
    node_weight=None,
    balance_edge: bool = False,
    num_workers: int = 0,
) -> Tuple[SparseTensor, torch.Tensor, torch.Tensor]:
    """The reference's ``metis.py:24-75`` contract: the row- and
    column-permuted adjacency, ``partptr`` delimiting each part's node
    range, and the permutation ``perm`` (new position -> old node).
    ``weighted`` takes the values as edge weights; ``node_weight`` and
    ``balance_edge`` (each node weighed by its column count) balance the
    parts by weight.  ``recursive`` is accepted and ignored, as in the
    JAX package."""
    assert num_parts >= 1
    dev = src.device()
    M = src.sparse_size(0)
    if num_parts == 1:
        return (src, _index(np.asarray([0, M]), dev),
                _index(np.arange(M), dev))
    del recursive
    cluster = _clusters(src, num_parts, weighted, node_weight, balance_edge,
                        num_workers)
    perm_np = stable_argsort(cluster)
    out = permute(src, perm_np)
    partptr_np = np.searchsorted(cluster[perm_np], np.arange(num_parts + 1))
    return out, _index(partptr_np, dev), _index(perm_np, dev)


def _clusters(src: SparseTensor, num_parts: int, weighted: bool,
              node_weight, balance_edge: bool, num_workers: int
              ) -> np.ndarray:
    """The part of each node of :func:`partition`'s call."""
    M = src.sparse_size(0)
    if num_parts == 1:
        return np.zeros(M, np.int64)
    if balance_edge and node_weight is not None:
        raise ValueError(
            "Cannot set 'balance_edge' and 'node_weight' at the same time"
        )
    col_np = src.storage.numpy_view("col")
    nw = None
    if balance_edge:
        nw = np.bincount(col_np, minlength=M).astype(np.float64)
    elif node_weight is not None:
        nw = np.asarray(_host(node_weight), np.float64)
    return partition_fn(src.storage.numpy_view("rowptr"), col_np, num_parts,
                        nw, edge_weight=_edge_weights(src, weighted),
                        num_workers=num_workers)


def partition_fine(
    src: SparseTensor,
    num_parts: int,
    fine_parts: int = 0,
    num_workers: int = 0,
    weighted: bool = False,
    node_weight=None,
    fine_method: str = "auto",
    grouping: str = "quotient",
) -> Tuple[SparseTensor, torch.Tensor, torch.Tensor]:
    """Two-level partition: a FINE ``fine_parts``-way reorder grouped
    into ``num_parts`` coarse parts, with :func:`partition`'s contract.
    The node order inside each coarse part runs through whole fine
    clusters, so that communities far smaller than a part lie
    contiguously, which the hybrid router's (B, B) blocks need.

    ``fine_parts`` defaults to one cluster per 512-row block
    (``max(M // 512, num_parts)``); at most ``num_parts`` falls back to
    :func:`partition`.

    ``fine_method`` finds the fine clusters:

    * ``"partition"``: the k-way multilevel partitioner (best cut; its
      cost grows with ``fine_parts``);
    * ``"coarsen"``: the coarsening hierarchy alone (the host library's
      ``coarsen_clusters``): matching levels until about ``fine_parts``
      clusters remain, O(E) a level whatever ``fine_parts``;
    * ``"auto"``: ``"coarsen"`` from 256 fine parts on, else
      ``"partition"``.

    ``grouping`` composes the fine order and the coarse parts:

    * ``"quotient"``: the fine clusters first, then a ``num_parts``-way
      partition of the cluster graph (edge weights: crossing edge counts,
      or crossing value sums when ``weighted``; node weights: cluster
      sizes, or sums of ``node_weight``) groups whole clusters;
    * ``"within"``: the direct ``num_parts``-way partition first (its
      cut untouched), then each part's interior reordered by coarsening
      clusters of the part's own subgraph; the layout for per-part
      compute (Cluster-GCN).

    ``weighted``/``node_weight`` reach the fine level as they are and
    are summed for the quotient level."""
    M = src.sparse_size(0)
    dev = src.device()
    Kf = fine_parts if fine_parts > 0 else max(M // 512, num_parts)
    if Kf <= num_parts:
        return partition(src, num_parts, weighted=weighted,
                         node_weight=node_weight, num_workers=num_workers)
    if grouping == "within":
        return _partition_fine_within(
            src, num_parts, Kf, num_workers, weighted, node_weight)
    if grouping != "quotient":
        raise ValueError(f"unknown grouping: {grouping!r}")
    method = fine_method
    if method == "auto":
        method = "coarsen" if Kf >= 256 else "partition"
    if method == "coarsen":
        cluster_f, Kf = _native.coarsen_clusters(
            src.storage.numpy_view("rowptr"), src.storage.numpy_view("col"),
            Kf, edge_weight=_edge_weights(src, weighted))
        perm = stable_argsort(cluster_f)
        padj = permute(src, perm)
        fp = np.searchsorted(cluster_f[perm], np.arange(Kf + 1))
    else:
        padj, fineptr, perm_t = partition(src, Kf, weighted=weighted,
                                          node_weight=node_weight,
                                          num_workers=num_workers)
        fp = fineptr.cpu().numpy()
        perm = perm_t.cpu().numpy()
    prow = padj.storage.numpy_view("row")
    pcol = padj.storage.numpy_view("col")
    fpart = np.searchsorted(fp, np.arange(M), side="right") - 1
    pr, pc = fpart[prow], fpart[pcol]
    offd = pr != pc
    key = pr[offd] * Kf + pc[offd]
    pvalue = padj.storage.value()
    if weighted and pvalue is not None and pvalue.dim() == 1:
        # Quotient edge weight = total crossing edge weight, the
        # aggregate METIS's own coarsening would form.
        uk, inv = np.unique(key, return_inverse=True)
        wv = _host(pvalue)[offd].astype(np.float64)
        wsum = np.bincount(inv, weights=wv, minlength=uk.size)
        ew = _weight2metis_np(wsum)
    else:
        uk, cnt = np.unique(key, return_counts=True)
        ew = cnt.astype(np.int64)
    qrow, qcol = uk // Kf, uk % Kf
    qrowptr = np.searchsorted(qrow, np.arange(Kf + 1)).astype(np.int64)
    if node_weight is not None:
        # node_weight is in the original node order: map it through perm
        # into the fine order before summing per cluster.
        nw_perm = np.asarray(_host(node_weight), np.float64)[perm]
        qnw = np.bincount(fpart, weights=nw_perm, minlength=Kf)
    else:
        qnw = np.diff(fp).astype(np.float64)
    cluster = partition_fn(qrowptr, qcol.astype(np.int64), num_parts,
                           node_weight=qnw, edge_weight=ew,
                           num_workers=num_workers)
    forder = stable_argsort(cluster)
    node_order = np.concatenate(
        [np.arange(fp[f], fp[f + 1]) for f in forder]).astype(np.int64)
    out = permute(padj, node_order)
    gsizes = np.zeros(num_parts, np.int64)
    np.add.at(gsizes, cluster, np.diff(fp))
    partptr_np = np.concatenate([[0], np.cumsum(gsizes)])
    return (out, _index(partptr_np, dev),
            _index(np.asarray(perm)[node_order], dev))


def _partition_fine_within(
    src: SparseTensor,
    num_parts: int,
    Kf: int,
    num_workers: int,
    weighted: bool,
    node_weight,
) -> Tuple[SparseTensor, torch.Tensor, torch.Tensor]:
    """``grouping="within"``: the direct coarse partition, then each
    part's interior reordered by coarsening clusters of the part's own
    subgraph (one O(E_part) pass a part).

    The JAX package permutes by the partition and then by the reorder;
    the port permutes once, by their composition, which gives the same
    matrix.  It reads each part's subgraph from ``src`` itself: a part
    lists its nodes in ascending id (a stable sort of the clusters), so
    the local ids keep the original ids' order and every row's columns
    stay sorted, as in the partition's permuted matrix."""
    M = src.sparse_size(0)
    cluster = _clusters(src, num_parts, weighted, node_weight, False,
                        num_workers)
    perm = stable_argsort(cluster)
    pp = np.searchsorted(cluster[perm], np.arange(num_parts + 1))
    local = np.empty(M, np.int64)
    local[perm] = np.arange(M) - np.repeat(pp[:-1], np.diff(pp))
    rowptr = src.storage.numpy_view("rowptr")
    col = src.storage.numpy_view("col")
    node_order = np.empty(M, np.int64)
    for p in range(num_parts):
        lo, hi = int(pp[p]), int(pp[p + 1])
        n = hi - lo
        if n <= 1:
            node_order[lo:hi] = np.arange(lo, hi)
            continue
        # The part's rows, in its order, and the edges inside it.
        nodes = perm[lo:hi]
        counts = rowptr[nodes + 1] - rowptr[nodes]
        starts = np.repeat(rowptr[nodes] - np.cumsum(counts) + counts, counts)
        cols = col[starts + np.arange(starts.size)]
        keep = cluster[cols] == p
        sub_col = local[cols[keep]]
        cnt = np.bincount(np.repeat(np.arange(n), counts)[keep], minlength=n)
        sub_rowptr = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
        target = max(n * Kf // max(M, 1), 1)
        if sub_col.size:
            cl, _nc = _native.coarsen_clusters(sub_rowptr, sub_col, target)
        else:
            cl = np.zeros(n, np.int64)
        node_order[lo:hi] = lo + stable_argsort(cl)
    perm_np = perm[node_order]
    dev = src.device()
    return permute(src, perm_np), _index(pp, dev), _index(perm_np, dev)


def mt_partition(
    src: SparseTensor,
    num_parts: int,
    recursive: bool = False,
    weighted: bool = False,
    node_weight=None,
    num_workers: int = 8,
) -> Tuple[SparseTensor, torch.Tensor, torch.Tensor]:
    """Threaded partition, the reference's mt-metis entry
    (``csrc/metis.cpp:49-69``): :func:`partition`'s contract on the
    OpenMP pipeline, nondeterministic under real concurrency, like
    mt-metis."""
    return partition(src, num_parts, recursive, weighted, node_weight,
                     num_workers=max(int(num_workers), 1))


SparseTensor.partition = (
    lambda self, num_parts, recursive=False, weighted=False,
    node_weight=None, balance_edge=False, num_workers=0: partition(
        self, num_parts, recursive, weighted, node_weight, balance_edge,
        num_workers)
)
SparseTensor.mt_partition = (
    lambda self, num_parts, recursive=False, weighted=False,
    node_weight=None, num_workers=8: mt_partition(
        self, num_parts, recursive, weighted, node_weight, num_workers)
)
SparseTensor.partition_fine = (
    lambda self, num_parts, fine_parts=0, num_workers=0, weighted=False,
    node_weight=None, fine_method="auto", grouping="quotient":
    partition_fine(
        self, num_parts, fine_parts, num_workers, weighted, node_weight,
        fine_method, grouping)
)
