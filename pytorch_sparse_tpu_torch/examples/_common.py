"""What the recipes share: the ``--device`` flag, the train step and its
timer, the accuracy and the route a graph takes."""

from __future__ import annotations

import argparse
import time
from typing import Callable, List

import torch


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (the default: the card) or cpu (the plain versions of "
             "the kernels)")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step(model, opt: torch.optim.Optimizer, adj, x: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    """One step on a whole graph or part: ``model.loss`` (the mean
    negative log-likelihood of every row; no dropout, no mask), backward,
    the optimizer.  Returns the loss."""
    opt.zero_grad()
    loss = model.loss(adj, x, labels)
    loss.backward()
    opt.step()
    return loss.detach()


def timed_steps(step: Callable[[int], torch.Tensor], n: int,
                device: torch.device) -> tuple:
    """Run ``step(0..n-1)``; return each step's loss and its wall ms (the
    host clock around the step and the read of its loss, which waits for
    the card)."""
    losses: List[float] = []
    ms: List[float] = []
    for i in range(n):
        t0 = time.perf_counter()
        loss = step(i).item()
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    return losses, ms


def steady_ms(ms: List[float]) -> float:
    """The mean ms a step past the first (which also builds the graph's
    views and loads the kernels), as the JAX recipes leave out their
    compile step."""
    rest = ms[1:] or ms
    return sum(rest) / len(rest)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> float:
    return float((logits.argmax(-1) == labels.long()).float().mean())


def route_name(h) -> str:
    """The route a view takes: ``csr`` (no view), ``hybrid[dtype]`` or
    ``dense[dtype]`` of its store."""
    if h is None:
        return "csr"
    store = getattr(h, "blocks", getattr(h, "dense", None))
    return f"{type(h).__name__.replace('Format', '').lower()}[{store.dtype}]"


def route(adj) -> str:
    """The route the routed SpMM took for ``adj`` (its cached view)."""
    return route_name(adj.storage.hybrid(auto=False))
