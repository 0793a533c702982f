"""Tracing and timing hooks on ``torch.profiler`` (counterpart of
``pytorch_sparse_tpu/utils/profile.py``, which wraps ``jax.profiler``).

    with trace("traces/"):            # a Chrome trace of the region
        with annotate("spmm"):        # a named range in it
            out = spmm_sum(A, x)
    seconds, out = timed(spmm_sum, A, x)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch

from ..typing import DeviceLike, resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device: DeviceLike = None
          ) -> Iterator[torch.profiler.profile]:
    """Profile the region with ``torch.profiler`` and write a Chrome trace
    (``trace-<pid>-<ns>.json``, viewable in Perfetto or
    ``chrome://tracing``) into ``log_dir``.  On ``device`` (default
    ``"cuda"``) the card's kernels are traced too; ``device="cpu"``
    traces the host alone.  A profiler that cannot start raises."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """A named range on the profiler's timeline:
    ``with annotate("spmm"): ...``."""
    return torch.profiler.record_function(name)


def _sync() -> None:
    # Nothing was queued on a card if CUDA was never initialised.
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kwargs):
    """Wall-clock seconds a call of ``fn(*args, **kwargs)`` and its last
    result: ``warmup`` calls, then ``iters`` calls between two waits for
    the card (``torch.cuda.synchronize``)."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    _sync()
    return (time.perf_counter() - t0) / iters, result
