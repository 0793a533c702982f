"""``device_idle_pct``: the share of the profiled stretch in which no
kernel, copy or set ran on the card (``trace.reduce_events``)."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("stretch_s") or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["stretch_s"])
