"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: a
``device`` of ``None`` means ``"cuda"``, and asking for ``"cuda"`` on a
machine without one raises instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``).  Raises
    ``RuntimeError`` for CUDA when no GPU is visible, and ``ValueError``
    for device types other than ``cuda`` and ``cpu``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def input_device(x, device: DeviceLike = None) -> torch.device:
    """The device of an entry point that takes ``x``: ``device`` when it
    is given, else ``x``'s own when ``x`` is a tensor (a CUDA input stays
    on its card), else ``"cuda"`` (numpy, scipy and list inputs)."""
    if device is not None or not isinstance(x, torch.Tensor):
        return resolve_device(device)
    return x.device
