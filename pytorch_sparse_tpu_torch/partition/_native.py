"""``ctypes`` wrappers over the port's host library
(``csrc/host_partition.cpp``): the counterparts of the partitioner's
wrappers in ``pytorch_sparse_tpu/csrc/bindings.py`` (``:44-113``), with
the same defaults and argument handling.  The library is built with the
host C++ compiler at first use (``_build.load``); without a
compiler they raise."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .. import _build

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64, _u64 = ctypes.c_int64, ctypes.c_uint64
# rowptr, col, n, node_w, edge_w, num_parts, seed, imbalance
_PARTITION = [_i64p, _i64p, _i64, _f64p, _i64p, _i64, _u64, ctypes.c_double]
_SIGNATURES = {
    "multilevel_partition_ew": _PARTITION + [_i64p],
    "multilevel_partition_mt": _PARTITION + [_i64, _i64p],
    # rowptr, col, n, edge_w, target_clusters, seed, cluster_out
    "coarsen_clusters": [_i64p, _i64p, _i64, _i64p, _i64, _u64, _i64p],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("host_partition")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int64
    return lib


def _p(a: Optional[np.ndarray], ptype=_i64p):
    return None if a is None else a.ctypes.data_as(ptype)


def _graph(rowptr, col, edge_weight):
    """int64 contiguous ``(rowptr, col, edge_weight)``, checked to be a
    CSR graph of ``n < 2**31`` nodes whose columns lie in ``[0, n)``:
    the library trusts its input."""
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    col = np.ascontiguousarray(col, np.int64)
    n = rowptr.shape[0] - 1
    if n < 0 or n >= 2**31 or rowptr[0] != 0 or rowptr[-1] != col.shape[0]:
        raise ValueError("not a CSR graph of fewer than 2**31 nodes")
    if col.size and (col.min() < 0 or col.max() >= n):
        raise ValueError("`col` holds a node outside [0, n)")
    ew = None
    if edge_weight is not None:
        ew = np.ascontiguousarray(edge_weight, np.int64)
        if ew.shape != col.shape:
            raise ValueError("`edge_weight` needs one weight per edge")
    return rowptr, col, ew, n


def multilevel_partition(
    rowptr: np.ndarray, col: np.ndarray, num_parts: int,
    node_weight: Optional[np.ndarray] = None, seed: int = 1,
    imbalance: float = 0.05, edge_weight: Optional[np.ndarray] = None,
    num_workers: int = 0,
) -> Tuple[np.ndarray, int]:
    """METIS-style multilevel k-way partition; returns ``(cluster,
    cut)``, the part of each node (int64) and the edge cut.

    ``edge_weight`` (int64, one per edge) weighs heavy-edge matching and
    the refinement gains (METIS's adjwgt).  ``num_workers > 0`` runs the
    threaded entry (the mt-metis analogue): OpenMP streaming phases and
    compare-and-swap matching, nondeterministic under real concurrency;
    0 runs the deterministic serial entry."""
    lib = _lib()
    rowptr, col, ew, n = _graph(rowptr, col, edge_weight)
    nw = None
    if node_weight is not None:
        nw = np.ascontiguousarray(node_weight, np.float64)
        if nw.shape != (n,):
            raise ValueError("`node_weight` needs one weight per node")
    cluster = np.empty(n, np.int64)
    common = (_p(rowptr), _p(col), n, _p(nw, _f64p), _p(ew), num_parts,
              seed, imbalance)
    if num_workers > 0:
        cut = lib.multilevel_partition_mt(*common, num_workers, _p(cluster))
    else:
        cut = lib.multilevel_partition_ew(*common, _p(cluster))
    return cluster, int(cut)


def coarsen_clusters(
    rowptr: np.ndarray, col: np.ndarray, target_clusters: int,
    seed: int = 1, edge_weight: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int]:
    """Fine clusters from the coarsening hierarchy alone: heavy-edge
    matching levels until about ``target_clusters`` coarse nodes remain.
    Returns ``(cluster of each node, number of clusters)``; one O(E)
    pass a level, whatever the target."""
    lib = _lib()
    rowptr, col, ew, n = _graph(rowptr, col, edge_weight)
    cluster = np.empty(n, np.int64)
    nc = lib.coarsen_clusters(_p(rowptr), _p(col), n, _p(ew),
                              int(target_clusters), seed, _p(cluster))
    return cluster, int(nc)
