"""The process meshes of the distributed schedules (counterpart of
``pytorch_sparse_tpu/parallel/mesh.py`` and ``make_mesh_hier`` of
``pytorch_sparse_tpu/parallel/hier.py``).

A :class:`Mesh` is one ``torch.distributed`` process group laid out as
one axis: this process's rank among ``size``, the group's backend, and
the device its shard lives on.  Each process holds one shard.  The
caller starts the processes and calls
``torch.distributed.init_process_group`` with an explicit address, world
size and rank (on one host, for example, ``torch.multiprocessing.spawn``
and a ``file://`` rendezvous).

A :class:`Grid` lays the default group out as a 2-D process grid,
row-major as JAX reshapes its devices: the process of default rank ``r``
sits at ``divmod(r, n1)``.  It holds the whole grid's mesh and, for each
axis, the sub-mesh of the processes that share this process's other
coordinate.  :func:`make_mesh2d` makes the ``(data, feat)`` grid: rows
shard over ``"x"`` and the dense operand's columns over ``"f"``.
:func:`make_mesh_hier` makes the ``(dcn, ici)`` grid of the hierarchical
schedule: slice ``s`` holds the chips of default ranks ``[s*C, (s+1)*C)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch.distributed as dist

from ..typing import DeviceLike, resolve_device

data_axis = "x"
feat_axis = "f"
dcn_axis = "d"


class Mesh:
    """A 1-D mesh over ``group`` (the default group when None) with this
    process's shard on ``device`` (default ``"cuda"``), named
    ``axis_name``.

    ``staged_bytes`` counts the bytes the collectives copied between the
    device and the host: a gloo group moves host tensors only, so a
    gloo mesh on a CUDA device stages every collective through the host
    (see ``parallel/_comm.py``).
    """

    def __init__(self, group=None, device: DeviceLike = None,
                 axis_name: str = data_axis):
        self.device = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError("call torch.distributed.init_process_group "
                               "before making a mesh")
        self.group = dist.group.WORLD if group is None else group
        self.axis_name = axis_name
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.backend = str(dist.get_backend(self.group))
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
        return (f"Mesh({self.axis_name}={self.size}, rank={self.rank}, "
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


class Grid:
    """The default group as an ``(n0, n1)`` process grid with axes
    ``names``: ``mesh`` spans the whole grid (the model's loss and
    parameter all-reduce), ``axis(name)`` is this process's sub-mesh
    along one axis, ``coords`` its ``(i0, i1)`` and ``shape`` maps each
    axis name to its size, as a JAX mesh's ``shape`` does.

    Making one is collective: ``torch.distributed.new_group`` must be
    called by every process for every group in the same order, so each
    process creates all ``n0 + n1`` sub-groups, also those it is not in.
    """

    def __init__(self, n0: int, n1: int, names: Tuple[str, str],
                 device: DeviceLike = None):
        self.mesh = Mesh(None, device, axis_name="".join(names))
        if n0 < 1 or n1 < 1 or n0 * n1 != self.mesh.size:
            raise ValueError(f"a ({n0}, {n1}) grid needs {n0 * n1} "
                             f"processes; the default group has "
                             f"{self.mesh.size}")
        self.shape: Dict[str, int] = dict(zip(names, (n0, n1)))
        self.names = names
        i0, i1 = self.coords = divmod(self.mesh.rank, n1)
        device = self.mesh.device
        self._axes = {}
        # Axis 0: the processes of one column (fixed i1); axis 1: those of
        # one row (fixed i0).  Every process makes every group.
        for j in range(n1):
            g = dist.new_group([i * n1 + j for i in range(n0)])
            if j == i1:
                self._axes[names[0]] = Mesh(g, device, names[0])
        for i in range(n0):
            g = dist.new_group([i * n1 + j for j in range(n1)])
            if i == i0:
                self._axes[names[1]] = Mesh(g, device, names[1])

    @property
    def device(self):
        return self.mesh.device

    def axis(self, name: str) -> Mesh:
        return self._axes[name]

    @property
    def staged_bytes(self) -> int:
        """Bytes staged through the host by the collectives of the whole
        grid's mesh and of both sub-meshes."""
        return self.mesh.staged_bytes + sum(m.staged_bytes
                                            for m in self._axes.values())

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return (f"Grid({dims}, coords={self.coords}, "
                f"backend={self.mesh.backend}, device={self.device})")


def make_mesh2d(n_data: int, n_feat: int,
                device: DeviceLike = None) -> Grid:
    """The ``(data, feat)`` grid: ``n_data`` row shards (axis ``"x"``)
    times ``n_feat`` column shards of the dense operand (axis ``"f"``);
    the process of default rank ``d * n_feat + f`` holds row block ``d``
    and column block ``f``."""
    return Grid(n_data, n_feat, (data_axis, feat_axis), device)


def make_mesh_hier(n_slices: int, n_chips: int,
                   device: DeviceLike = None) -> Grid:
    """The ``(dcn, ici)`` grid of the hierarchical schedule: axis ``"d"``
    crosses slices, axis ``"x"`` stays inside one; the process of default
    rank ``s * n_chips + c`` is chip ``c`` of slice ``s`` and holds row
    block ``s * n_chips + c``.  Start the processes so that default ranks
    are slice-major."""
    return Grid(n_slices, n_chips, (dcn_axis, data_axis), device)
