"""Graph partitioning on the port's host library (counterpart of
``pytorch_sparse_tpu/partition``)."""

from .metis import (  # noqa
    mt_partition, partition, partition_fine, partition_fn, weight2metis,
)
