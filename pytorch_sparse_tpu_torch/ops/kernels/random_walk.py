"""Uniform random walks over a CSR graph from pre-drawn uniforms.

Replaces the JAX package's walk (``pytorch_sparse_tpu/sample/rw.py:21
_walk``): step ``l`` of walk ``i`` moves from ``cur`` to
``col[rowptr[cur] + trunc(rand[i, l] * deg)]``, the product taken in
float32, and a node of degree 0 stays put.  The CUDA kernel
(``csrc/random_walk.cu``) gives a block consecutive walks: it stages
their uniforms in shared memory with 16-byte loads, walks from there a
thread a walk, and writes the walks back with 16-byte stores (walks
longer than 191 steps run unstaged).

:func:`random_walk` launches the kernel for CUDA tensors and runs
:func:`random_walk_plain`, the plain PyTorch version (a loop of
gathers, the counterpart of the ``lax.scan``), for CPU tensors.  Other
devices raise.  ``random_walk.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils.convert import INDEX_DTYPE

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("random_walk")
        lib.random_walk_i32.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.random_walk_i32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_args(rowptr, col, start, rand) -> None:
    if (rowptr.dtype != INDEX_DTYPE or col.dtype != INDEX_DTYPE
            or start.dtype != INDEX_DTYPE):
        raise TypeError("rowptr, col and start must be int32")
    if rand.dtype != torch.float32:
        raise TypeError(f"rand must be float32, got {rand.dtype}")
    if rowptr.dim() != 1 or col.dim() != 1 or start.dim() != 1:
        raise ValueError("expected rowptr (M+1,), col (E,) and start (n,)")
    if rand.dim() != 2 or rand.shape[0] != start.shape[0]:
        raise ValueError(f"rand must have shape (len(start), walk_length), "
                         f"got {tuple(rand.shape)} for {start.shape[0]} "
                         "walks")
    if len({t.device for t in (rowptr, col, start, rand)}) != 1:
        raise ValueError("random_walk operands lie on different devices")


def random_walk_plain(rowptr: torch.Tensor, col: torch.Tensor,
                      start: torch.Tensor, rand: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version: ``L`` steps of two gathers each."""
    _check_args(rowptr, col, start, rand)
    steps = [start]
    cur = start
    for r in rand.t():
        lo = rowptr[cur.long()]
        deg = rowptr[cur.long() + 1] - lo
        has = deg > 0
        if col.shape[0]:
            e = lo + (r * deg.to(torch.float32)).to(INDEX_DTYPE)
            nxt = col[torch.where(has, e, torch.zeros_like(e)).long()]
            cur = torch.where(has, nxt, cur)
        steps.append(cur)
    return torch.stack(steps, dim=1)


def random_walk(rowptr: torch.Tensor, col: torch.Tensor, start: torch.Tensor,
                rand: torch.Tensor) -> torch.Tensor:
    """``(n, L+1)`` int32 walks from the ``n`` nodes of ``start`` over the
    CSR graph ``(rowptr, col)``, stepping with the ``(n, L)`` float32
    uniforms ``rand``; column 0 holds ``start``.

    CUDA tensors run the hand-written kernel (all operands contiguous);
    CPU tensors run :func:`random_walk_plain`.  Neither checks that
    ``start`` lies in ``[0, M)`` or ``rand`` in ``[0, 1)``: the kernel
    would read out of bounds.  The entry point ``sample.rw.random_walk``
    checks ``start`` and any ``rand`` it is given."""
    _check_args(rowptr, col, start, rand)
    dev = rand.device
    if dev.type == "cpu":
        return random_walk_plain(rowptr, col, start, rand)
    if dev.type != "cuda":
        raise NotImplementedError(f"random_walk has no kernel for {dev.type}")
    for t in (rowptr, col, start, rand):
        if not t.is_contiguous():
            raise ValueError("random_walk operands must be contiguous")
    n, L = rand.shape
    out = torch.empty((n, L + 1), dtype=INDEX_DTYPE, device=dev)
    lib = _kernel_lib()
    rc = lib.random_walk_i32(
        dev.index, rowptr.data_ptr(), col.data_ptr(), start.data_ptr(),
        rand.data_ptr(), out.data_ptr(), n, L,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "random_walk launch")
    random_walk.launches += 1
    return out


random_walk.launches = 0
