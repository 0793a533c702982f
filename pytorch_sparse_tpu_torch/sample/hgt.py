"""Heterogeneous Graph Transformer layer-wise importance sampling
(counterpart of ``pytorch_sparse_tpu/sample/hgt.py``; reference
``csrc/cpu/hgt_sample_cpu.cpp``): per-type budgets of inverse-degree
scores (neighbour cap 50), weighted node sampling proportional to
budget^2 without replacement, then the induced typed adjacency over the
sampled node sets.

It runs the port's host library (``csrc/host_sample.cpp``): the keys
are drawn from one sequential stream while the budget's hash map is
walked, so the map's iteration order is part of the result, as in the
JAX package's native library.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..typing import DeviceLike, resolve_device
from . import _native
from ._draws import native_seed
from .neighbor import typed_graph, typed_outputs


def hgt_sample(
    colptr_dict: Dict, row_dict: Dict, input_node_dict: Dict,
    num_samples_dict: Dict[str, List[int]], num_hops: int,
    seed: Optional[int] = None, device: DeviceLike = None,
) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Returns ``(node_id, row, col, edge_id)`` dicts of int64 tensors on
    ``device``: ``node_id`` per node type (its inputs, then each hop's
    samples), the induced edges per relation key ``'src__rel__dst'``.

    Relations are ``colptr_dict``'s keys (``(src, rel, dst)`` tuples or
    their keys); node types those of the relations and of
    ``input_node_dict``.  Both are visited in sorted order, as the JAX
    package passes them, and ``num_samples_dict`` gives each type's
    samples a hop (0 where absent).  The draws equal the JAX package's
    native sampler's for ``seed`` (an ``int``; None means 0)."""
    seed = native_seed(seed)
    dev = resolve_device(device)
    colptr, row, inputs = typed_graph(colptr_dict, row_dict,
                                      input_node_dict)
    node_types = set(inputs)
    for rel in colptr:
        src_t, _, dst_t = rel.split("__")
        node_types.update((src_t, dst_t))
    nts, rels = sorted(node_types), sorted(colptr)
    out = _native.hgt_sample(
        nts, rels, colptr, row, inputs,
        {nt: list(num_samples_dict.get(nt, [0] * num_hops)) for nt in nts},
        num_hops, seed)
    return typed_outputs(out, dev)
