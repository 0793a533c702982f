"""The benchmark of ``pytorch_sparse_tpu_torch`` (the PyTorch and CUDA
port) on one NVIDIA H100.

One command runs one cell once::

    python3 -m port_bench.run --workload gcn-products.clustered \\
        --seed 7 --seconds 40 --trace 0

``BENCHMARK.json`` at the repository's root names the cells and metrics.
Everything that belongs to one configuration, traffic mix, model or
per-layer metric sits in a file of its own, found by its name:

- ``configs/<config>.json``: a model configuration (widths, layers,
  dropout, optimizer, the dataset sizes it stands for);
- ``traffic/<mix>.json``: a traffic mix (graph generator and its
  parameters, node order, the loop);
- ``graphs/<generator>.py``: a graph generator, drawing on the card from
  the seed;
- ``models/<model>.py``: how the port builds and trains the model, and
  the model's operation count;
- ``reference/<model>.py``: the plain PyTorch reference of the model,
  which imports nothing of the port;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``cells/<workload>.json``: the limits of the numbers that decide
  ``correct`` in one cell, with the readings they were set from.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``pytorch_sparse_tpu``.
"""
