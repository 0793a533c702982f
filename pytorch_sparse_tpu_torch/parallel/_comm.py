"""The collectives of the distributed schedules and their transposes
(counterpart of the ``lax`` collectives that
``pytorch_sparse_tpu/parallel/dist.py`` calls inside ``shard_map``).

* :func:`all_gather` (``lax.all_gather(tiled=True)``), whose transpose
  is :func:`reduce_scatter`, written as ``all_to_all_single`` followed
  by a sum over the sources in rank order (gloo has no reduce-scatter on
  every PyTorch version; the sum order is fixed).
* :func:`rotate` (``lax.ppermute`` around the ring): one
  ``batch_isend_irecv`` into a fresh buffer, returned unfinished so that
  the caller computes on the block it holds while the next one moves.
  Its transpose is the rotation the other way.
* :func:`all_to_all` (``lax.all_to_all`` of the halo packets), which is
  its own transpose: the reverse exchange sends each received packet's
  gradient back, and the server adds it at its ``serve`` rows.
* :func:`all_reduce_sum`, for the model's loss and parameter gradients.

A gloo group moves host tensors only.  When the mesh's shards live on a
CUDA device and its backend is gloo (``mesh.stages``), each collective
copies its input to the host and its output back, and adds the bytes to
``mesh.staged_bytes``.  NCCL groups and CPU shards move tensors where
they lie.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist

from .mesh import Mesh


class Pending:
    """An unfinished collective: :meth:`wait` returns its output on the
    mesh's device."""

    def __init__(self, works: List, out: torch.Tensor, finish: Callable,
                 keep=()):
        self._works, self._out, self._finish = works, out, finish
        self._keep = keep  # buffers the transfer reads until it completes

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._keep = ()
        return self._finish(self._out)


def _to_wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if mesh.stages:
        mesh.staged_bytes += t.numel() * t.element_size()
        return t.cpu()
    return t


def _from_wire(mesh: Mesh) -> Callable:
    def finish(t: torch.Tensor) -> torch.Tensor:
        if mesh.stages:
            mesh.staged_bytes += t.numel() * t.element_size()
            return t.to(mesh.device)
        return t
    return finish


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape), concatenated along dim 0
    in rank order."""
    src = _to_wire(mesh, t)
    out = src.new_empty((mesh.size * src.shape[0], *src.shape[1:]))
    dist.all_gather(list(out.split(src.shape[0])), src, group=mesh.group)
    return _from_wire(mesh)(out)


def all_to_all(mesh: Mesh, t: torch.Tensor, async_op: bool = False):
    """Split ``t`` into ``P`` equal chunks along dim 0 and send chunk
    ``q`` to rank ``q``; the result's chunk ``q`` came from rank ``q``.
    With ``async_op`` a :class:`Pending`."""
    src = _to_wire(mesh, t)
    out = torch.empty_like(src)
    work = dist.all_to_all_single(out, src, group=mesh.group,
                                  async_op=async_op)
    pending = Pending([work] if async_op else [], out, _from_wire(mesh),
                      keep=(src,))
    return pending if async_op else pending.wait()


def reduce_scatter(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The transpose of :func:`all_gather`: chunk ``rank`` of the sum of
    every rank's ``t``, added over the sources in rank order."""
    got = all_to_all(mesh, t)
    return got.view(mesh.size, -1, *got.shape[1:]).sum(0)


def rotate(mesh: Mesh, t: torch.Tensor, shift: int) -> Pending:
    """Start the ring step that sends ``t`` to rank ``rank - shift`` and
    receives the block of rank ``rank + shift``.  ``shift=1`` is the
    forward ring (rank ``i`` receives from ``i + 1``), ``shift=-1`` its
    transpose."""
    src = _to_wire(mesh, t)
    out = torch.empty_like(src)
    P, me = mesh.size, mesh.rank
    ops = [dist.P2POp(dist.isend, src, mesh.global_rank((me - shift) % P),
                      group=mesh.group),
           dist.P2POp(dist.irecv, out, mesh.global_rank((me + shift) % P),
                      group=mesh.group)]
    return Pending(dist.batch_isend_irecv(ops), out, _from_wire(mesh),
                   keep=(src,))


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t``, as a new tensor."""
    src = _to_wire(mesh, t).clone()
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=mesh.group)
    return _from_wire(mesh)(src)
