"""``launches_per_epoch``: the CUDA runtime and driver launch calls in
the profiled stretch (distinct by correlation id), per epoch."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("epochs") or not tr.get("launches"):
        return None
    return tr["launches"] / tr["epochs"]
