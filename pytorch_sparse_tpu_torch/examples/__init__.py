"""The port's training recipes: the counterparts of the JAX package's
``examples/train_{gcn,gat,sage_minibatch,cluster_gcn}.py``, with their
flags, defaults and printed results, plus ``--device`` (``cuda`` by
default; ``cpu`` only when asked).  Each runs as

    python -m pytorch_sparse_tpu_torch.examples.<name> [flags]

and exposes ``main(argv=None) -> dict`` (the loss of each step, the
accuracy, the ms a step), its graph builder and its step.  They train
unpadded batches eagerly: no static shapes, scratch rows or ``jit``,
which the JAX recipes need on a TPU.
"""
