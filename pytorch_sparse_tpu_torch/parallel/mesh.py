"""The process mesh of the distributed schedules (counterpart of
``pytorch_sparse_tpu/parallel/mesh.py``).

A :class:`Mesh` is one ``torch.distributed`` process group laid out as the
single data axis ``"x"``: this process's rank among ``P``, the group's
backend, and the device its shard lives on.  Each process holds one row
shard.  The caller starts the processes and calls
``torch.distributed.init_process_group`` with an explicit address, world
size and rank (on one host, for example, ``torch.multiprocessing.spawn``
and a ``file://`` rendezvous).
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from ..typing import DeviceLike, resolve_device

data_axis = "x"


class Mesh:
    """A 1-D mesh over ``group`` (the default group when None) with this
    process's shard on ``device`` (default ``"cuda"``).

    ``staged_bytes`` counts the bytes the collectives copied between the
    device and the host: a gloo group moves host tensors only, so a
    gloo mesh on a CUDA device stages every collective through the host
    (see ``parallel/_comm.py``).
    """

    axis_name = data_axis

    def __init__(self, group=None, device: DeviceLike = None):
        if not dist.is_initialized():
            raise RuntimeError("call torch.distributed.init_process_group "
                               "before making a mesh")
        self.group = dist.group.WORLD if group is None else group
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.backend = str(dist.get_backend(self.group))
        self.device = resolve_device(device)
        self.staged_bytes = 0

    @property
    def stages(self) -> bool:
        """True when collectives go through the host: a gloo group with
        its shards on a CUDA device."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this group's ``rank``."""
        if self.group is dist.group.WORLD:
            return rank
        return dist.get_global_rank(self.group, rank)

    def __repr__(self) -> str:
        return (f"Mesh({data_axis}={self.size}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")


def make_mesh(n_devices: Optional[int] = None, group=None,
              device: DeviceLike = None) -> Mesh:
    """The :class:`Mesh` of ``group``.  ``n_devices``, when given, must
    equal the group's size (each process holds one shard)."""
    mesh = Mesh(group, device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"requested {n_devices} shards but the process "
                         f"group has {mesh.size} processes")
    return mesh
