"""Graph sampling (counterpart of ``pytorch_sparse_tpu/sample``).

Two tiers, as in the JAX package:

* Device tier (torch on the graph's device, over a pre-drawn uniform
  matrix): ``random_walk`` (the ``random_walk`` CUDA kernel) and the
  with-replacement ``sample``.
* Host tier (numpy, by design): the samplers whose output sizes depend on
  the data, ``sample_adj``, ``saint_subgraph``, ``relabel``,
  ``relabel_one_hop`` and the homogeneous ``neighbor_sample``.  Their
  draws equal the JAX package's native sampler's for the same ``seed``;
  their outputs go to the device.

Importing this package attaches ``random_walk``, ``sample``,
``sample_adj`` and ``saint_subgraph`` to ``SparseTensor``.
"""

from .rw import random_walk  # noqa
from .sample import sample, sample_adj  # noqa
from .saint import saint_subgraph  # noqa
from .relabel import relabel, relabel_one_hop  # noqa
from .neighbor import neighbor_sample  # noqa
from .loader import MinibatchPrefetcher  # noqa
