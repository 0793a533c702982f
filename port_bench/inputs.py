"""The inputs of one run, made on the device from the run's seed: the
graph's edge list, the node features, labels and split masks, the
model's initial parameters and the dropout generator's seed.  The
program and the reference are handed the same inputs; the reference
makes them again from the seed after the program's state is freed.

Each kind of input draws from a generator of its own, seeded from the
run's seed and the kind's name, so that every seed gives the same sizes
and the same order of draws.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import spec


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for the draw ``stream`` of run ``seed`` (any whole
    number, negative or past 64 bits too)."""
    digest = hashlib.blake2b(f"{int(seed)}/{stream}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def edges(cfg: Dict, traffic: Dict, seed: int, device,
          root=spec.ROOT) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edge list ``(row, col)`` the traffic mix draws for ``cfg``'s
    dataset sizes."""
    gen = spec.load_module("graphs", traffic["graph"], root)
    ds = cfg["dataset"]
    return gen.generate(generator(seed, "graph", device), ds["nodes"],
                        ds["undirected_edges"], traffic["params"])


def nodes(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Features ``x`` (N(0,1), float32), labels ``y`` (uniform, int64)
    and the split masks (bool; OGB's split sizes over a random
    permutation)."""
    ds = cfg["dataset"]
    M = int(ds["nodes"])
    x = torch.randn((M, int(ds["features"])),
                    generator=generator(seed, "features", device),
                    device=device)
    y = torch.randint(0, int(ds["classes"]), (M,),
                      generator=generator(seed, "labels", device),
                      device=device)
    perm = torch.randperm(M, generator=generator(seed, "split", device),
                          device=device)
    out = {"x": x, "y": y}
    lo = 0
    for split in ("train", "valid", "test"):
        n = int(ds[split])
        mask = torch.zeros(M, dtype=torch.bool, device=device)
        mask[perm[lo:lo + n]] = True
        out[f"{split}_mask"] = mask
        lo += n
    if lo != M:
        raise ValueError(f"split sizes add up to {lo}, not {M} nodes")
    return out


def glorot_params(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """Initial parameters in one draw: 2-D leaves glorot uniform
    (``U(-a, a)``, ``a = sqrt(6 / (fan_in + fan_out))``), 1-D leaves
    zero."""
    total = sum(int(np.prod(s)) for _, s in shapes if len(s) == 2)
    u = torch.rand(total, generator=generator(seed, "params", device),
                   device=device)
    out, lo = {}, 0
    for name, shape in shapes:
        if len(shape) == 2:
            n = shape[0] * shape[1]
            a = float(np.sqrt(6.0 / (shape[0] + shape[1])))
            out[name] = ((u[lo:lo + n] * 2.0 - 1.0) * a).view(shape).clone()
            lo += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def dropout_seed(seed: int) -> int:
    return stream_seed(seed, "dropout")
