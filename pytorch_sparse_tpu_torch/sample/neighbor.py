"""Multi-hop neighbour sampling, CSC-driven (counterpart of
``pytorch_sparse_tpu/sample/neighbor.py``): the loader primitives behind
PyG's ``NeighborLoader``.  An edge (src -> dst) is stored with
``colptr`` over dst and ``row`` holding src, so sampling walks the
incoming edges of the frontier.

* ``neighbor_sample`` (homogeneous) runs on the port's host library
  (``csrc/host_sample.cpp``, a copy of the JAX package's native
  ``neighbor_sample``).  Each hop draws the frontier's edges from stream
  ``hop + 1`` and appends unseen sources in the order they are drawn;
  :func:`neighbor_sample_plain` is its plain version in numpy
  (``_draws``).
* ``hetero_neighbor_sample`` (typed nodes and relations, per-relation
  budgets) and ``hetero_temporal_neighbor_sample`` (sources no later
  than their root, one computation tree a root) run the port's host
  library (``csrc/host_sample.cpp``): their draws come from one
  sequential stream whose length depends on the data, as in the JAX
  package's native library.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..typing import DeviceLike, resolve_device
from ._common import (check_nodes, check_pointer, expand_ranges, host_index,
                      to_index)
from . import _native
from ._draws import draw_candidates, native_seed


def _cat(parts) -> np.ndarray:
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def neighbor_sample(colptr, row, input_node, num_neighbors: List[int],
                    replace: bool = False, directed: bool = True,
                    seed: Optional[int] = None, device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Returns ``(node_id, row_local, col_local, edge_id)`` on ``device``.

    ``node_id`` starts with ``input_node`` (distinct nodes), then the
    sampled sources in the order they were first drawn.  With
    ``directed=True`` the edges are the sampled ones (a source's local
    id, its target's local id, the edge id); with ``directed=False`` they
    are every edge between sampled nodes.  The draws are those of the
    JAX package's native sampler for ``seed`` (an ``int``; None means
    0).  ``colptr`` must run from 0 to ``len(row)`` without falling, and
    ``row`` and ``input_node`` hold nodes of ``[0, len(colptr) - 1)``;
    others raise ``ValueError``."""
    seed = native_seed(seed)
    dev = resolve_device(device)
    colptr_np, row_np = host_index(colptr), host_index(row)
    inp = host_index(input_node)
    n = colptr_np.shape[0] - 1
    check_pointer(colptr_np, row_np.shape[0], "colptr")
    check_nodes(row_np, n, "row")
    check_nodes(inp, n, "input_node")
    out = _native.neighbor_sample(colptr_np, row_np, inp,
                                  [int(k) for k in num_neighbors], replace,
                                  directed, seed)
    return tuple(to_index(a, dev) for a in out)


def neighbor_sample_plain(colptr: np.ndarray, row: np.ndarray,
                          inp: np.ndarray, num_neighbors: List[int],
                          replace: bool, directed: bool, seed: int
                          ) -> Tuple[np.ndarray, ...]:
    """The plain version of the library's ``neighbor_sample``, in numpy:
    ``(nodes, rows, cols, edges)`` host int64 arrays, equal to
    ``_native.neighbor_sample``'s for the same ``uint64`` ``seed``.  The
    tests hold the library against it; no sampler calls it."""
    local_of = np.full(colptr.shape[0] - 1, -1, np.int64)
    local_of[inp] = np.arange(inp.shape[0])
    samples = [inp]
    n_samples = inp.shape[0]
    rows_l, cols_l, edges_l = [], [], []
    frontier, frontier_base = inp, 0
    for hop, num in enumerate(num_neighbors):
        starts = colptr[frontier]
        rix, edges = draw_candidates(starts, colptr[frontier + 1] - starts,
                                     int(num), replace, seed, stream=hop + 1)
        v = row[edges]
        vi = v[local_of[v] < 0]
        uniq, first = np.unique(vi, return_index=True)
        new_nodes = uniq[np.argsort(first, kind="stable")]
        local_of[new_nodes] = n_samples + np.arange(new_nodes.shape[0])
        samples.append(new_nodes)
        if directed:
            rows_l.append(local_of[v])
            cols_l.append(frontier_base + rix)
            edges_l.append(edges)
        frontier_base = n_samples
        n_samples += new_nodes.shape[0]
        frontier = new_nodes

    all_samples = _cat(samples)
    if not directed:
        starts = colptr[all_samples]
        rix, edges = expand_ranges(starts, colptr[all_samples + 1] - starts)
        v = row[edges]
        keep = local_of[v] >= 0
        rows_l, cols_l, edges_l = ([local_of[v[keep]]], [rix[keep]],
                                   [edges[keep]])
    return all_samples, _cat(rows_l), _cat(cols_l), _cat(edges_l)


def rel_key(edge_type) -> str:
    """The ``'src__rel__dst'`` key of an ``(src, rel, dst)`` edge type."""
    if isinstance(edge_type, str):
        return edge_type
    return "__".join(edge_type)


def by_rel(d: dict) -> dict:
    """``d`` keyed by ``'src__rel__dst'`` strings (tuple keys joined)."""
    return {rel_key(k): v for k, v in d.items()}


def typed_graph(colptr_dict: Dict, row_dict: Dict, input_node_dict: Dict,
                rels: Optional[List[str]] = None, times: Optional[Dict] = None):
    """``(colptr, row, inputs)``: host int64 arrays keyed by relation key
    and by type, checked where the host library would read out of
    bounds, which raises ``ValueError``: a relation of ``rels`` (default
    all) whose ``colptr`` does not run within ``[0, len(row)]`` from 0
    to ``len(row)``, or a node (an input or a ``row`` entry) of a type
    past the ``colptr`` of a relation into that type or past the type's
    ``times``."""
    colptr = {k: host_index(v) for k, v in by_rel(colptr_dict).items()}
    row = {k: host_index(v) for k, v in by_rel(row_dict).items()}
    inputs = {nt: host_index(v) for nt, v in input_node_dict.items()}
    rels = list(colptr) if rels is None else rels
    bound = {}
    for rel in rels:
        dst = rel.split("__")[2]
        bound[dst] = min(bound.get(dst, colptr[rel].shape[0] - 1),
                         colptr[rel].shape[0] - 1)
    for nt, tm in (times or {}).items():
        if tm.size:
            bound[nt] = min(bound.get(nt, tm.size), tm.size)

    def check(nodes, nt, what):
        if nodes.size and (nodes.min() < 0 or nodes.max() >= bound.get(
                nt, np.iinfo(np.int64).max)):
            raise ValueError(f"{what} holds a node of type {nt!r} outside "
                             "its relations' colptr or its times")

    for rel in rels:
        cp, n_edges = colptr[rel], row[rel].shape[0]
        if (cp.shape[0] < 1 or cp[0] != 0 or cp[-1] != n_edges
                or cp.min() < 0 or cp.max() > n_edges):
            raise ValueError(f"colptr of {rel!r} does not run from 0 to "
                             "the relation's edge count")
        check(row[rel], rel.split("__")[0], f"row of {rel!r}")
    for nt, arr in inputs.items():
        check(arr, nt, "input_node_dict")
    return colptr, row, inputs


def typed_outputs(out, device) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The library's numpy dicts as int64 tensors on ``device``."""
    return tuple({k: torch.from_numpy(v).to(device) for k, v in d.items()}
                 for d in out)


def hetero_neighbor_sample(
    node_types: List[str], edge_types: List, colptr_dict: Dict,
    row_dict: Dict, input_node_dict: Dict, num_neighbors_dict: Dict,
    num_hops: int, replace: bool = False, directed: bool = True,
    seed: Optional[int] = None, device: DeviceLike = None,
) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Typed multi-hop sampling.  Returns ``(node_id, row, col, edge_id)``
    dicts of int64 tensors on ``device``: ``node_id`` per node type (its
    inputs first, then sources in the order they were drawn), the
    others per relation key ``'src__rel__dst'`` (a source's local id, its
    target's local id, the edge's position in the relation's ``row``).

    Edge types are ``(src, rel, dst)`` tuples or their keys; the dicts
    of relations may be keyed either way.  Relations are visited in the
    order of ``edge_types`` each hop, node types in the order of
    ``node_types``: that order fixes the draws, which equal the JAX
    package's native sampler's for ``seed`` (an ``int``; None means 0).
    With ``directed=False`` the edges are every edge between sampled
    nodes."""
    seed = native_seed(seed)
    dev = resolve_device(device)
    rels = [rel_key(et) for et in edge_types]
    colptr, row, inputs = typed_graph(colptr_dict, row_dict,
                                      input_node_dict, rels)
    budgets = by_rel(num_neighbors_dict)
    out = _native.hetero_neighbor_sample(
        list(node_types), rels, colptr, row, inputs,
        {k: list(budgets[k]) for k in rels}, num_hops, replace, directed,
        seed)
    return typed_outputs(out, dev)


def hetero_temporal_neighbor_sample(
    node_types: List[str], edge_types: List, colptr_dict: Dict,
    row_dict: Dict, input_node_dict: Dict, num_neighbors_dict: Dict,
    node_time_dict: Dict, num_hops: int, replace: bool = False,
    directed: bool = True, seed: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The temporal variant of :func:`hetero_neighbor_sample`: a sampled
    source must satisfy ``time[src] <= time[root]`` (types absent from
    ``node_time_dict`` carry no time and always pass), and the trees of
    different roots stay disjoint, so a node appears once per root that
    reaches it.  Roots are numbered over all input nodes in type order.
    With ``directed=False`` no edge is returned, as in the JAX package
    (its temporal sampler keeps sampled edges only when directed)."""
    seed = native_seed(seed)
    dev = resolve_device(device)
    rels = [rel_key(et) for et in edge_types]
    times = {nt: host_index(v) for nt, v in node_time_dict.items()}
    colptr, row, inputs = typed_graph(colptr_dict, row_dict,
                                      input_node_dict, rels, times)
    budgets = by_rel(num_neighbors_dict)
    out = _native.hetero_temporal_neighbor_sample(
        list(node_types), rels, colptr, row, inputs,
        {k: list(budgets[k]) for k in rels}, times, num_hops, replace,
        directed, seed)
    return typed_outputs(out, dev)
