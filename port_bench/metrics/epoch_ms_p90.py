"""``epoch_ms_p90``: the 90th percentile of the host-clock times of all
the window's epochs (``statistics.quantiles``, inclusive), which a
stall of the host, a sync or the allocator's growth moves."""

import statistics


def read(ctx):
    times = (ctx.get("window") or {}).get("times") or []
    if len(times) < 2:
        return 1e3 * times[0] if times else None
    return 1e3 * statistics.quantiles(times, n=10, method="inclusive")[8]
