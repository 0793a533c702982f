"""``spmm_roofline``: the share of its roofline that the port's public
SpMM reaches on the cell's adjacency: for each SpMM of the model's
forward (at its width and reduction) and, where the epoch needs it, its
backward, the least time the card could take (``_work.spmm_min_seconds``
from nnz, the sizes and the width) summed, over the CUDA-event times of
the same calls summed."""

from . import _work


def read(ctx):
    calls = ctx.get("spmm")
    if not calls:
        return None
    bound, measured = [], []
    for c in calls:
        t, _ = _work.spmm_min_seconds(c["nnz"], c["M"], c["N"], c["K"],
                                      c["valued"])
        bound.append(t)
        measured.append(c["fwd_s"])
        if c.get("bwd_s") is not None:
            t, _ = _work.spmm_min_seconds(c["nnz"], c["N"], c["M"], c["K"],
                                          c["valued"])
            bound.append(t)
            measured.append(c["bwd_s"])
    return _work.share_pct(bound, measured)
