"""``peak_device_gib``: the CUDA caching allocator's peak of allocated
bytes (``torch.cuda.max_memory_allocated``) over set-up and the window,
read by the benchmark once the window has closed, in GiB."""


def read(ctx):
    peak = ctx.get("peak_bytes")
    return peak / 2**30 if peak else None
