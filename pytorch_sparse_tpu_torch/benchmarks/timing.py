"""Seconds per call of a chained step, as the slope between two chain
lengths (counterpart of the JAX package's ``benchmarks/timing.py``).

Fixed costs (a launch queue filling, a first allocation, the clock
itself) cancel in the slope.  On a CUDA device the chain is timed with
CUDA events on the current stream; on the CPU with ``perf_counter``.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _device_of(*trees) -> torch.device:
    for t in trees:
        if isinstance(t, torch.Tensor):
            return t.device
        if isinstance(t, (tuple, list)):
            for u in t:
                if isinstance(u, torch.Tensor):
                    return u.device
    return torch.device("cpu")


def device_time(step: Callable, init_carry, *args, n_lo: int = 4,
                n_hi: int = 24, repeats: int = 3) -> float:
    """Seconds per invocation of ``step(carry, *args) -> carry``.

    The device is that of the first tensor in ``init_carry`` or
    ``args`` (the CPU when there is none).  Each chain length runs once
    to warm up, then ``repeats`` times; the best of each is kept."""
    dev = _device_of(init_carry, args)
    cuda = dev.type == "cuda"

    def chain(n):
        carry = init_carry
        for _ in range(n):
            carry = step(carry, *args)
        return carry

    def run(n):
        best = float("inf")
        for _ in range(repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                stream = torch.cuda.current_stream(dev)
                start.record(stream)
                chain(n)
                end.record(stream)
                end.synchronize()
                t = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                chain(n)
                t = time.perf_counter() - t0
            best = min(best, t)
        return best

    for n in (n_lo, n_hi):
        chain(n)
    if cuda:
        torch.cuda.synchronize(dev)
    t_lo, t_hi = run(n_lo), run(n_hi)
    return max((t_hi - t_lo) / (n_hi - n_lo), 1e-9)
