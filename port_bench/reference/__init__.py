"""The plain PyTorch reference: one module per model
(``reference/<model>.py``: ``leaf_shapes``, ``adjacency``,
``forward``), and the pieces they share (``common.py``).  It imports
nothing of the port and nothing the port made: it works the adjacency
out again from the edge list the benchmark draws."""
