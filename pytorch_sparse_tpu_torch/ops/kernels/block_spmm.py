"""Block-dense SpMM pass over a row-block-sorted slot list:
``out[slot_row[s]] += blocks[s] @ xb[slot_col[s]]`` for every slot ``s``.

Replaces the forward of the JAX package's block-dense route
(``pytorch_sparse_tpu/ops/kernels/hybrid.py``: ``_block_pass``,
``_scan_block_pass`` and the ``"sbc,sck->sbk"`` equation of
``_mxu_einsum_impl``).  The CUDA kernel (``csrc/block_spmm.cu``) gives
each row-block's output to one set of thread blocks, which walk that
row-block's slots in order and accumulate in fp32 registers; there is
no segment-sum and no atomic.

:func:`block_spmm` launches the kernel for CUDA tensors and runs
:func:`block_spmm_plain`, the plain PyTorch version of the same
function, for CPU tensors.  Other devices raise.
``block_spmm.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils.convert import INDEX_DTYPE, ptr2ind

_lib = None
_STORE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Bound on the (slots, B, K) temporaries of the plain version.
_PLAIN_CHUNK_BYTES = 256 << 20


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("block_spmm")
        lib.block_spmm.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.block_spmm.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_args(blocks, slot_col, rb_ptr, xb) -> None:
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError("blocks must be (nb+1, B, B)")
    if slot_col.dtype != INDEX_DTYPE or rb_ptr.dtype != INDEX_DTYPE:
        raise TypeError("slot_col and rb_ptr must be int32")
    B = blocks.shape[1]
    if xb.dim() != 2 or xb.shape[0] % B:
        raise ValueError("xb must be (C*B, K)")
    if slot_col.shape[0] >= blocks.shape[0]:
        raise ValueError("blocks must hold one block per slot plus one")
    devs = {t.device for t in (blocks, slot_col, rb_ptr, xb)}
    if len(devs) != 1:
        raise ValueError("block_spmm operands lie on different devices")


def block_spmm_plain(blocks: torch.Tensor, slot_col: torch.Tensor,
                     rb_ptr: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather each slot's column block of ``xb``,
    multiply with ``torch.bmm`` in the accumulation dtype, and
    ``index_add_`` the products into their row blocks, in chunks of
    slots."""
    _check_args(blocks, slot_col, rb_ptr, xb)
    B = blocks.shape[1]
    K = xb.shape[1]
    R = rb_ptr.shape[0] - 1
    nb = slot_col.shape[0]
    acc = torch.promote_types(xb.dtype, torch.float32)
    slot_row = ptr2ind(rb_ptr, nb)
    xv = xb.reshape(-1, B, K).to(acc)
    out = torch.zeros((R, B, K), dtype=acc, device=xb.device)
    step = max(1, _PLAIN_CHUNK_BYTES // max(B * max(B, K) * 4, 1))
    for s in range(0, nb, step):
        e = min(s + step, nb)
        tmp = torch.bmm(blocks[s:e].to(acc), xv[slot_col[s:e].long()])
        out.index_add_(0, slot_row[s:e], tmp)
    return out.reshape(R * B, K)


def block_spmm(blocks: torch.Tensor, slot_col: torch.Tensor,
               rb_ptr: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """``(R*B, K)`` float32 block pass.  ``blocks`` ``(nb+1, B, B)``
    float32 or bfloat16, ``slot_col`` ``(nb,)`` int32, ``rb_ptr``
    ``(R+1,)`` int32 pointer of the row-block-sorted slots, ``xb``
    ``(C*B, K)`` float32, the operand padded to whole column blocks.

    CUDA tensors run the hand-written kernel; CPU tensors run
    :func:`block_spmm_plain`."""
    _check_args(blocks, slot_col, rb_ptr, xb)
    dev = xb.device
    if dev.type == "cpu":
        return block_spmm_plain(blocks, slot_col, rb_ptr, xb)
    if dev.type != "cuda":
        raise NotImplementedError(f"block_spmm has no kernel for {dev.type}")
    if blocks.dtype not in _STORE_CODES or xb.dtype != torch.float32:
        raise TypeError("the block_spmm kernel takes float32 or bfloat16 "
                        "blocks and a float32 operand")
    for t in (blocks, slot_col, rb_ptr, xb):
        if not t.is_contiguous():
            raise ValueError("block_spmm operands must be contiguous")
    B, K = blocks.shape[1], xb.shape[1]
    R = rb_ptr.shape[0] - 1
    out = torch.empty((R * B, K), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    rc = lib.block_spmm(
        dev.index, _STORE_CODES[blocks.dtype], blocks.data_ptr(),
        slot_col.data_ptr(), rb_ptr.data_ptr(), xb.data_ptr(),
        out.data_ptr(), R, B, K, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "block_spmm launch")
    block_spmm.launches += 1
    return out


block_spmm.launches = 0
