"""Graph sampling (counterpart of ``pytorch_sparse_tpu/sample``).

Two tiers, as in the JAX package:

* Device tier (torch on the graph's device, over a pre-drawn uniform
  matrix): ``random_walk`` (the ``random_walk`` CUDA kernel) and the
  with-replacement ``sample``.
* Host tier: the samplers whose output sizes depend on the data run
  the port's host C++ library (``csrc/host_sample.cpp``, a copy of the
  JAX package's native samplers, built at first use; a failed build
  raises, nothing falls back): ``sample_adj``, ``saint_subgraph``,
  ``relabel_one_hop``, the homogeneous ``neighbor_sample``,
  ``hetero_neighbor_sample``, ``hetero_temporal_neighbor_sample``,
  ``hgt_sample`` and ``ego_k_hop_sample_adj``.  Every host sampler's
  draws equal the JAX package's native sampler's for the same ``seed``
  (an ``int``; other types raise ``TypeError``); the outputs go to the
  device.  ``relabel`` is numpy.  The homogeneous samplers keep plain
  versions in numpy (``sample_adj_plain``, ``neighbor_sample_plain``,
  ``saint_subgraph_plain``, ``relabel_one_hop_plain``), whose per-row
  streams (``_draws``) reproduce the library's draws; the tests hold the
  library against them.

Importing this package attaches ``random_walk``, ``sample``,
``sample_adj`` and ``saint_subgraph`` to ``SparseTensor``.
"""

from .rw import random_walk  # noqa
from .sample import sample, sample_adj  # noqa
from .saint import saint_subgraph  # noqa
from .relabel import relabel, relabel_one_hop  # noqa
from .ego import ego_k_hop_sample_adj  # noqa
from .neighbor import (  # noqa
    neighbor_sample, hetero_neighbor_sample,
    hetero_temporal_neighbor_sample,
)
from .hgt import hgt_sample  # noqa
from .loader import MinibatchPrefetcher  # noqa
