"""``train_fwd_ms``: milliseconds on the card of ``model.loss(...)``
(the training forward and the loss), CUDA events on either side, the
mean over the traced epochs."""

import statistics


def read(ctx):
    ms = ctx.get("fwd_ms")
    return statistics.fmean(ms) if ms else None
