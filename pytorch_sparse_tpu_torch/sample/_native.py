"""``ctypes`` wrappers over the port's sampling host library
(``csrc/host_sample.cpp``): the counterparts of the samplers' wrappers
in ``pytorch_sparse_tpu/csrc/bindings.py`` (``:115-430``), with the same
flattened encodings and output sizes.  The homogeneous ``sample_adj``
and ``relabel_one_hop`` fill buffers sized exactly from the degrees;
every other entry runs the library's two phases: a count pass with null
outputs, then a fill pass into buffers of those sizes.  The library is
built with the host C++ compiler at first use (``_build.load``); without
a compiler they raise.  Its calls are ``ctypes`` foreign calls, which
release the interpreter lock while the library runs.

The callers check the inputs (node ids within the graph, valid
pointers): the library indexes with them unchecked.  Relations are
``'src__rel__dst'`` keys.  Relation ``r``'s ``colptr`` and ``row`` are
concatenated at ``colptr_off[r]`` and ``row_off[r]``, its per-hop
budgets at ``r * num_hops + hop``, each type's inputs (and node times)
at its offset in type order.  Outputs are numpy int64 arrays: the
homogeneous samplers' arrays as their plain versions give them,
``(samples per type, rows, cols, eids per relation)`` for the typed
samplers, the stitched arrays for ``ego_k_hop``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import _build

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64, _i32, _u64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64
# n_types, n_rels, num_hops, rel_src, rel_dst, colptr_cat, colptr_off,
# row_cat, row_off, inputs_cat, inputs_off
_TYPED = [_i64, _i64, _i64] + [_i64p] * 8
_OUT = [_i64p] * 5  # counts, nodes, rows, cols, eids
_SIGNATURES = {
    # rowptr, col, n_nodes, idx, n_idx, num_neighbors, replace, seed,
    # out_rowptr, out_col, out_eid, n_id
    "sample_adj": [_i64p, _i64p, _i64, _i64p, _i64, _i64, _i32, _u64]
    + [_i64p] * 4,
    # colptr, row, n_nodes, input_node, n_input, num_neighbors, num_hops,
    # replace, directed, seed, counts, nodes, rows, cols, edges
    "neighbor_sample": [_i64p, _i64p, _i64, _i64p, _i64, _i64p, _i64, _i32,
                        _i32, _u64] + [_i64p] * 5,
    # rowptr, col, n_nodes, idx, n_idx, counts, row, col, eid
    "saint_subgraph": [_i64p, _i64p, _i64, _i64p, _i64] + [_i64p] * 4,
    # rowptr, col, idx, n_idx, out_rowptr, out_col, out_eid, n_id
    "relabel_one_hop": [_i64p, _i64p, _i64p, _i64] + [_i64p] * 4,
    "hetero_neighbor_sample": _TYPED + [_i64p, _i32, _i32, _u64] + _OUT,
    "hetero_temporal_neighbor_sample": (
        _TYPED + [_i64p, _i64p, _i64p, _i32p, _i32, _i32, _u64] + _OUT),
    "hgt_sample": _TYPED + [_i64p, _u64] + _OUT,
    # rowptr, col, n_nodes, seeds, n_seeds, depth, num_neighbors,
    # replace, seed, counts, row, col, eid, nid, ptr, root
    "ego_k_hop": [_i64p, _i64p, _i64, _i64p, _i64, _i64, _i64, _i32,
                  _u64] + [_i64p] * 7,
}

# The entries that return a count (the others return nothing).
_RESTYPES = {"sample_adj": _i64, "relabel_one_hop": _i64}

Typed = Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
              Dict[str, np.ndarray], Dict[str, np.ndarray]]


def _lib() -> ctypes.CDLL:
    lib = _build.load("host_sample")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _RESTYPES.get(name)
    return lib


def _p(a: np.ndarray, ptype=_i64p):
    return a.ctypes.data_as(ptype)


def _i64_array(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def _cat(parts: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def _relations(node_types: Sequence[str], edge_types: Sequence[str],
               colptr_dict, row_dict) -> list:
    """The relation arguments: ``rel_src``, ``rel_dst``, ``colptr_cat``,
    ``colptr_off``, ``row_cat``, ``row_off``."""
    tindex = {t: i for i, t in enumerate(node_types)}
    R = len(edge_types)
    rel_src, rel_dst = np.empty(R, np.int64), np.empty(R, np.int64)
    colptr_off, row_off = np.zeros(R + 1, np.int64), np.zeros(R + 1, np.int64)
    cps, rws = [], []
    for r, rel in enumerate(edge_types):
        src_t, _, dst_t = rel.split("__")
        rel_src[r], rel_dst[r] = tindex[src_t], tindex[dst_t]
        cps.append(_i64_array(colptr_dict[rel]))
        rws.append(_i64_array(row_dict[rel]))
        colptr_off[r + 1] = colptr_off[r] + cps[-1].shape[0]
        row_off[r + 1] = row_off[r] + rws[-1].shape[0]
    return [rel_src, rel_dst, _cat(cps), colptr_off, _cat(rws), row_off]


def _per_type(node_types: Sequence[str], arrays) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """Each type's array of ``arrays`` (empty where absent) concatenated in
    type order, and the offsets."""
    off = np.zeros(len(node_types) + 1, np.int64)
    parts = []
    for t, nt in enumerate(node_types):
        a = arrays.get(nt)
        parts.append(np.zeros(0, np.int64) if a is None else _i64_array(a))
        off[t + 1] = off[t] + parts[-1].shape[0]
    return _cat(parts), off


def _budgets(edge_types: Sequence[str], budget_dict, num_hops: int
             ) -> np.ndarray:
    budgets = np.empty(len(edge_types) * num_hops, np.int64)
    for r, rel in enumerate(edge_types):
        budgets[r * num_hops:(r + 1) * num_hops] = budget_dict[rel]
    return budgets


def _two_phase(fn, args: list, node_types: Sequence[str],
               edge_types: Sequence[str]) -> Typed:
    """Run ``fn``'s count pass and fill pass and split the concatenated
    outputs per type and relation."""
    T, R = len(node_types), len(edge_types)
    counts = np.zeros(T + R, np.int64)
    ptrs = [a if not isinstance(a, np.ndarray)
            else _p(a, _i32p if a.dtype == np.int32 else _i64p)
            for a in args]
    fn(*ptrs, _p(counts), None, None, None, None)
    n_total, e_total = int(counts[:T].sum()), int(counts[T:].sum())
    nodes = np.empty(n_total, np.int64)
    rows, cols, eids = (np.empty(e_total, np.int64) for _ in range(3))
    fn(*ptrs, _p(counts), _p(nodes), _p(rows), _p(cols), _p(eids))
    n_split = np.cumsum(counts[:T])[:-1]
    e_split = np.cumsum(counts[T:])[:-1]
    return ({nt: a for nt, a in zip(node_types, np.split(nodes, n_split))},
            *({rel: a for rel, a in zip(edge_types, np.split(out, e_split))}
              for out in (rows, cols, eids)))


def hetero_neighbor_sample(node_types, edge_types, colptr_dict, row_dict,
                           input_dict, budget_dict, num_hops: int,
                           replace: bool, directed: bool, seed: int
                           ) -> Typed:
    """Typed-graph multi-hop sampling (``native.cpp:1305``), one
    sequential stream from ``seed`` (a ``uint64``)."""
    inputs, inputs_off = _per_type(node_types, input_dict)
    args = [len(node_types), len(edge_types), num_hops,
            *_relations(node_types, edge_types, colptr_dict, row_dict),
            inputs, inputs_off, _budgets(edge_types, budget_dict, num_hops),
            int(replace), int(directed), seed]
    return _two_phase(_lib().hetero_neighbor_sample, args, node_types,
                      edge_types)


def hetero_temporal_neighbor_sample(node_types, edge_types, colptr_dict,
                                    row_dict, input_dict, budget_dict,
                                    time_dict, num_hops: int, replace: bool,
                                    directed: bool, seed: int) -> Typed:
    """Temporal typed sampling (``native.cpp:1433``): a type without
    times (absent or empty in ``time_dict``) has ``has_time = 0``."""
    inputs, inputs_off = _per_type(node_types, input_dict)
    times, time_off = _per_type(node_types, time_dict)
    has_time = (np.diff(time_off) > 0).astype(np.int32)
    args = [len(node_types), len(edge_types), num_hops,
            *_relations(node_types, edge_types, colptr_dict, row_dict),
            inputs, inputs_off, _budgets(edge_types, budget_dict, num_hops),
            times, time_off, has_time, int(replace), int(directed), seed]
    return _two_phase(_lib().hetero_temporal_neighbor_sample, args,
                      node_types, edge_types)


def hgt_sample(node_types, edge_types, colptr_dict, row_dict, input_dict,
               num_samples_dict, num_hops: int, seed: int) -> Typed:
    """HGT layer-wise importance sampling (``native.cpp:1050``);
    ``num_samples_dict`` per node type, 0 where absent."""
    inputs, inputs_off = _per_type(node_types, input_dict)
    num_samples = np.zeros(len(node_types) * num_hops, np.int64)
    for t, nt in enumerate(node_types):
        num_samples[t * num_hops:(t + 1) * num_hops] = num_samples_dict.get(
            nt, [0] * num_hops)
    args = [len(node_types), len(edge_types), num_hops,
            *_relations(node_types, edge_types, colptr_dict, row_dict),
            inputs, inputs_off, num_samples, seed]
    return _two_phase(_lib().hgt_sample, args, node_types, edge_types)


def ego_k_hop(rowptr: np.ndarray, col: np.ndarray, seeds: np.ndarray,
              depth: int, num_neighbors: int, replace: bool, seed: int
              ) -> Tuple[np.ndarray, ...]:
    """Per-seed k-hop ego nets stitched block-diagonally
    (``native.cpp:1194``): ``(row, col, e_id, n_id, ptr, root)``."""
    lib = _lib()
    rowptr, col, seeds = _i64_array(rowptr), _i64_array(col), _i64_array(
        seeds)
    counts = np.zeros(2, np.int64)
    args = (_p(rowptr), _p(col), rowptr.shape[0] - 1, _p(seeds),
            seeds.shape[0], depth, num_neighbors, int(replace), seed)
    lib.ego_k_hop(*args, _p(counts), None, None, None, None, None, None)
    row, colc, e_id = (np.empty(counts[1], np.int64) for _ in range(3))
    n_id = np.empty(counts[0], np.int64)
    ptr = np.empty(seeds.shape[0] + 1, np.int64)
    root = np.empty(seeds.shape[0], np.int64)
    lib.ego_k_hop(*args, _p(counts), _p(row), _p(colc), _p(e_id), _p(n_id),
                  _p(ptr), _p(root))
    return row, colc, e_id, n_id, ptr, root


def sample_adj(rowptr: np.ndarray, col: np.ndarray, idx: np.ndarray,
               num_neighbors: int, replace: bool, seed: int
               ) -> Tuple[np.ndarray, ...]:
    """One-hop sampling of the rows ``idx`` (``native.cpp:151``):
    ``(rowptr, local col, e_id, n_id)`` of the bipartite adjacency, each
    frontier row drawn from stream 0 at its position."""
    lib = _lib()
    rowptr, col, idx = _i64_array(rowptr), _i64_array(col), _i64_array(idx)
    deg = rowptr[idx + 1] - rowptr[idx]
    if num_neighbors < 0:
        e_out = int(deg.sum())
    elif replace:
        e_out = int(num_neighbors * (deg > 0).sum())
    else:
        e_out = int(np.minimum(deg, num_neighbors).sum())
    out_rowptr = np.empty(idx.shape[0] + 1, np.int64)
    out_col, out_eid = np.empty(e_out, np.int64), np.empty(e_out, np.int64)
    n_id = np.empty(idx.shape[0] + e_out, np.int64)
    n = lib.sample_adj(_p(rowptr), _p(col), rowptr.shape[0] - 1, _p(idx),
                       idx.shape[0], num_neighbors, int(replace), seed,
                       _p(out_rowptr), _p(out_col), _p(out_eid), _p(n_id))
    return out_rowptr, out_col, out_eid, n_id[:n]


def neighbor_sample(colptr: np.ndarray, row: np.ndarray,
                    input_node: np.ndarray, num_neighbors: Sequence[int],
                    replace: bool, directed: bool, seed: int
                    ) -> Tuple[np.ndarray, ...]:
    """Homogeneous multi-hop sampling over a CSC graph
    (``native.cpp:215``), hop ``h`` on stream ``h + 1``: ``(nodes, rows,
    cols, edges)``."""
    lib = _lib()
    colptr, row = _i64_array(colptr), _i64_array(row)
    input_node = _i64_array(input_node)
    nums = _i64_array(list(num_neighbors))
    counts = np.zeros(2, np.int64)
    args = (_p(colptr), _p(row), colptr.shape[0] - 1, _p(input_node),
            input_node.shape[0], _p(nums), nums.shape[0], int(replace),
            int(directed), seed, _p(counts))
    lib.neighbor_sample(*args, None, None, None, None)
    nodes = np.empty(counts[0], np.int64)
    rows, cols, edges = (np.empty(counts[1], np.int64) for _ in range(3))
    lib.neighbor_sample(*args, _p(nodes), _p(rows), _p(cols), _p(edges))
    return nodes, rows, cols, edges


def saint_subgraph(rowptr: np.ndarray, col: np.ndarray, idx: np.ndarray,
                   n_nodes: int) -> Tuple[np.ndarray, ...]:
    """The edges among the nodes ``idx`` (``native.cpp:294``), relabelled
    by position, in the order the rows of ``idx`` are walked: ``(row,
    col, e_id)``.  ``n_nodes`` bounds every node id of ``col``."""
    lib = _lib()
    rowptr, col, idx = _i64_array(rowptr), _i64_array(col), _i64_array(idx)
    counts = np.zeros(1, np.int64)
    args = (_p(rowptr), _p(col), n_nodes, _p(idx), idx.shape[0],
            _p(counts))
    lib.saint_subgraph(*args, None, None, None)
    out_row, out_col, out_eid = (np.empty(counts[0], np.int64)
                                 for _ in range(3))
    lib.saint_subgraph(*args, _p(out_row), _p(out_col), _p(out_eid))
    return out_row, out_col, out_eid


def relabel_one_hop(rowptr: np.ndarray, col: np.ndarray, idx: np.ndarray
                    ) -> Tuple[np.ndarray, ...]:
    """The whole one-hop neighbourhood of ``idx``, relabelled in
    first-seen order (``native.cpp:324``): ``(rowptr, local col,
    positions, n_id)``."""
    lib = _lib()
    rowptr, col, idx = _i64_array(rowptr), _i64_array(col), _i64_array(idx)
    e_out = int((rowptr[idx + 1] - rowptr[idx]).sum())
    out_rowptr = np.empty(idx.shape[0] + 1, np.int64)
    out_col, out_eid = np.empty(e_out, np.int64), np.empty(e_out, np.int64)
    n_id = np.empty(idx.shape[0] + e_out, np.int64)
    n = lib.relabel_one_hop(_p(rowptr), _p(col), _p(idx), idx.shape[0],
                            _p(out_rowptr), _p(out_col), _p(out_eid),
                            _p(n_id))
    return out_rowptr, out_col, out_eid, n_id[:n]
