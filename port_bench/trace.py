"""The traced stretch: ``torch.profiler`` over a few steady epochs, and
its reduction to device time, idle gaps and launches.

Each profiled epoch runs inside a ``port_bench.epoch`` range on the
host; the stretch runs from the first range's start to the last one's
end (every epoch ends in a read-back, so the card is done by then).
Busy time is the union of the kernel, copy and set intervals on the
card inside the stretch; an idle gap is named by the innermost host
event that covers its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

EPOCH_RANGE = "port_bench.epoch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10
NAME_CHARS = 160  # enough to tell one kernel's template instances apart


@contextlib.contextmanager
def profiled(device: torch.device, out: Dict) -> Iterator[None]:
    """Profile the block; on exit, ``out`` holds :func:`reduce_events`
    of its trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out.update(reduce_events(events))


def epoch_range():
    return torch.profiler.record_function(EPOCH_RANGE)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def short_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments and
    parameters."""
    s = name[5:] if name.startswith("void ") else name
    for stop in ("<", "("):
        i = s.find(stop)
        if i > 0:
            s = s[:i]
    return s


def reduce_events(events: List[Dict]) -> Dict:
    """Stretch, busy seconds, epochs, launches, the device operations that
    took most time and the idle gaps by what the host was doing."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    epochs = [e for e in xs if e.get("name") == EPOCH_RANGE
              and e.get("cat") == "user_annotation"]
    if not epochs:
        return {"epochs": 0}
    t0 = min(float(e["ts"]) for e in epochs)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in epochs)

    ops: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    busy: List[Tuple[float, float]] = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        busy.append((a, b))
        ops[e["name"][:NAME_CHARS]] += (b - a) * 1e-6
        if e.get("cat") == "kernel":
            counts[short_name(e["name"])] += 1
    merged = _merge(busy)
    busy_us = sum(b - a for a, b in merged)

    launch_ids, launches_no_id = set(), 0
    threads: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    for e in xs:
        if e.get("cat") not in HOST_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        if b < t0 or a > t1:
            continue
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and (
                "Launch" in e.get("name", "")):
            cid = (e.get("args") or {}).get("correlation")
            if cid is None:
                launches_no_id += 1
            else:
                launch_ids.add(cid)
        if e.get("name") != EPOCH_RANGE:
            threads[(e.get("pid"), e.get("tid"))].append(
                (a, b, e.get("name", "?")))

    # Events of one thread nest, so the innermost one covering a point is
    # the latest-starting one that still covers it (the shorter first
    # where two start together).  Across threads (the autograd engine
    # runs the backward on a thread of its own) the shortest one wins.
    index = []
    for evs in threads.values():
        evs.sort(key=lambda h: (h[0], -h[1]))
        reach, top_end = [], float("-inf")
        for h in evs:
            top_end = max(top_end, h[1])
            reach.append(top_end)
        index.append(([h[0] for h in evs], evs, reach))

    def innermost(t: float) -> str:
        best = None
        for starts, evs, reach in index:
            for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
                if reach[i] < t:  # nothing this early reaches t
                    break
                if evs[i][1] >= t:
                    if best is None or (evs[i][1] - evs[i][0]
                                        < best[1] - best[0]):
                        best = evs[i]
                    break
        return "host" if best is None else best[2]

    gaps: Dict[str, float] = defaultdict(float)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[innermost(0.5 * (a + b))] += (b - a) * 1e-6

    def top(d: Dict[str, float]) -> List[List]:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return {
        "epochs": len(epochs),
        "stretch_s": (t1 - t0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "launches": len(launch_ids) + launches_no_id,
        "device_ops": top(ops),
        "idle_gaps": top(gaps),
        "kernel_counts": dict(counts),
    }
