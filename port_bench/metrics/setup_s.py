"""``setup_s``: host-clock seconds from the process's start to the first
epoch of the window: CUDA's start, the port's import and kernel loads
(their builds where the checkout has none yet), the draws, the port's
construction and router, and the checked epochs that warm every
shape."""


def read(ctx):
    return ctx.get("setup_s")
