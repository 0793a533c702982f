"""``epoch_ms``: the window's host-clock wall time over the epochs it
completed (every epoch ends in a read-back of its loss and
accuracies, so the card has finished it)."""


def read(ctx):
    w = ctx.get("window") or {}
    if not w.get("epochs"):
        return None
    return 1e3 * w["window_s"] / w["epochs"]
