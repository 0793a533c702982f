"""``epoch_mfu_pct``: the whole epoch's share of the card's FP32 peak:
the model's operations an epoch (``models/<model>.py``'s
``epoch_flops``, from the widths, the nodes and nnz) over the mean
host-clock time of the traced run's epochs outside the profiled
stretch, over 67 TFLOP/s."""

import statistics

from . import _work


def read(ctx):
    times = ctx.get("epoch_s_untraced")
    flops = ctx.get("epoch_flops")
    if not times or not flops:
        return None
    return 100.0 * flops / statistics.fmean(times) / _work.PEAK_FP32_FLOPS
