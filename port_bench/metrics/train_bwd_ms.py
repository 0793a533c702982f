"""``train_bwd_ms``: milliseconds on the card of ``loss.backward()``,
CUDA events on either side, the mean over the traced epochs."""

import statistics


def read(ctx):
    ms = ctx.get("bwd_ms")
    return statistics.fmean(ms) if ms else None
