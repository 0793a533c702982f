"""Block-dense SpMM passes over a slot list of dense (B, B) blocks.

* :func:`block_spmm`, the forward over the row-block-sorted slots:
  ``out[slot_row[s]] += blocks[s] @ xb[slot_col[s]]`` for every slot.
* :func:`block_spmm_t`, the transpose over the column-block schedule
  ``order_t``: ``out[slot_col[s]] += blocks[s]^T @ gb[slot_row[s]]``.
* :func:`block_spmm_dblocks`, the gradient of the block store:
  ``out[s] = p[slot_row[s]] @ q[slot_col[s]]^T`` for every slot, cast
  to the store dtype, and an all-zero trailing block.

They replace the JAX package's block-dense route
(``pytorch_sparse_tpu/ops/kernels/hybrid.py``: ``_block_pass``,
``_scan_block_pass`` with the ``"sbc,sck->sbk"`` and ``"sbc,sbk->sck"``
equations of ``_mxu_einsum_impl``, the block pass of ``hybrid_spmm_t``,
and the ``_mxu_einsum_bwd`` contractions).  One CUDA source
(``csrc/block_spmm.cu``, on the template of ``csrc/block_tc.cuh``)
serves all three, on the tensor cores: TF32 ``wgmma`` with a 3xTF32
split for f32 accuracy, operands brought by TMA.  Each CTA owns a tile of
one output block and walks its slots (the forward, the transpose) or K
(the gradient) in a fixed order.  There is no segment-sum and no atomic.

TMA reads only rows of a multiple of 16 bytes.  A block store whose rows
are not (B not a multiple of 4 for f32, of 8 for bf16) is kept in a
buffer with padded rows, ``(n, B, Bp)``, and handed around as its
``(n, B, B)`` view: :func:`padded_store` allocates one, and the builders
of ``hybrid.py`` and ``ops/spgemm.py`` make their stores so, once.
:func:`store_layout` recovers the buffer from such a view without a
copy (and pads any other store, a copy).  The operands are padded to a
multiple of 4 columns: :func:`forward_operands` (store and ``x``; the
transpose's ``g`` alike) and :func:`dblocks_operands` (P and Q).  The
padding is zeros, and is a copy only where a width needs it.

Each wrapper launches the kernel for CUDA tensors and runs its plain
PyTorch version (:func:`block_spmm_plain`, :func:`block_spmm_t_plain`,
:func:`block_spmm_dblocks_plain`) for CPU tensors.  Other devices
raise.  ``block_spmm.launches``, ``block_spmm_t.launches`` and
``block_spmm_dblocks.launches`` count kernel launches.
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
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.block_spmm.restype = ctypes.c_int
        lib.block_spmm_t.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.block_spmm_t.restype = ctypes.c_int
        lib.block_spmm_dblocks.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.block_spmm_dblocks.restype = ctypes.c_int
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


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and at a 16-byte aligned address (TMA's rule for
    the base of a tensor map), copied if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_columns(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with its last dimension padded with zeros to ``width``."""
    extra = width - t.shape[-1]
    return t if extra == 0 else torch.nn.functional.pad(t, (0, extra))


def store_pitch(B: int, dtype: torch.dtype) -> int:
    """The row pitch of a block store that TMA reads: ``B`` rounded up
    to 16 bytes (4 f32 or 8 bf16 columns)."""
    return _round_up(B, 128 // torch.finfo(dtype).bits)


def padded_store(n: int, B: int, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """A zero ``(n, B, B)`` block store whose rows lie
    :func:`store_pitch` elements apart: a view of an ``(n, B, Bp)``
    buffer when ``B`` rows are not 16 bytes, else the buffer itself."""
    Bp = store_pitch(B, dtype)
    buf = torch.zeros((n, B, Bp), dtype=dtype, device=device)
    return buf if Bp == B else buf[:, :, :B]


def store_layout(blocks: torch.Tensor) -> torch.Tensor:
    """``blocks`` as the ``(n, B, Bp)`` store the kernels read, 16-byte
    aligned with rows of a multiple of 16 bytes.  A view made by
    :func:`padded_store` (or any store already so laid out) gives its
    buffer without a copy, the padding as it is (the kernels never read
    it); any other store is copied with zero padding."""
    n, B = blocks.shape[0], blocks.shape[1]
    Bp = store_pitch(B, blocks.dtype)
    if (blocks.stride() == (B * Bp, Bp, 1) and blocks.data_ptr() % 16 == 0
            and blocks.storage_offset() + n * B * Bp
            <= blocks.untyped_storage().nbytes() // blocks.element_size()):
        return blocks.as_strided((n, B, Bp), (B * Bp, Bp, 1))
    return _aligned(_pad_columns(blocks, Bp))


def forward_operands(blocks: torch.Tensor, xb: torch.Tensor):
    """The forward kernel's operands: ``(store, x4)``.

    ``store`` is :func:`store_layout` of ``blocks``, ``(nb+1, B, Bp)``,
    and ``x4`` is ``xb`` as ``(C*B, K4)`` with ``K4`` = ``K`` rounded up
    to 4 and the columns past ``K`` zero.  The transpose pass takes its
    ``g`` likewise."""
    return (store_layout(blocks),
            _aligned(_pad_columns(xb, _round_up(xb.shape[1], 4))))


def dblocks_operands(p: torch.Tensor, q: torch.Tensor):
    """The gradient kernel's operands: ``p`` and ``q`` with their columns
    padded with zeros to a multiple of 4 (16-byte rows)."""
    K4 = _round_up(p.shape[1], 4)
    return _aligned(_pad_columns(p, K4)), _aligned(_pad_columns(q, K4))


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
    for t in (slot_col, rb_ptr, xb):
        if not t.is_contiguous():
            raise ValueError("block_spmm operands must be contiguous")
    B, K = blocks.shape[1], xb.shape[1]
    R = rb_ptr.shape[0] - 1
    nb = slot_col.shape[0]
    if nb == 0 or R == 0 or K == 0:  # no product to take
        return torch.zeros((R * B, K), dtype=torch.float32, device=dev)
    store, x4 = forward_operands(blocks, xb)
    out = torch.empty((R * B, K), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    rc = lib.block_spmm(
        dev.index, _STORE_CODES[blocks.dtype], store.data_ptr(),
        slot_col.data_ptr(), rb_ptr.data_ptr(), x4.data_ptr(),
        out.data_ptr(), store.shape[0] - 1, R, xb.shape[0] // B, B, K,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "block_spmm launch")
    block_spmm.launches += 1
    return out


block_spmm.launches = 0


def _check_args_t(blocks, slot_row, order_t, cb_ptr, gb) -> None:
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError("blocks must be (nb+1, B, B)")
    if any(t.dtype != INDEX_DTYPE for t in (slot_row, order_t, cb_ptr)):
        raise TypeError("slot_row, order_t and cb_ptr must be int32")
    B = blocks.shape[1]
    if gb.dim() != 2 or gb.shape[0] % B:
        raise ValueError("gb must be (R*B, K)")
    if (slot_row.shape != order_t.shape
            or order_t.shape[0] >= blocks.shape[0]):
        raise ValueError("blocks must hold one block per slot plus one, "
                         "and order_t one entry per slot")
    devs = {t.device for t in (blocks, slot_row, order_t, cb_ptr, gb)}
    if len(devs) != 1:
        raise ValueError("block_spmm_t operands lie on different devices")


def block_spmm_t_plain(blocks: torch.Tensor, slot_row: torch.Tensor,
                       order_t: torch.Tensor, cb_ptr: torch.Tensor,
                       gb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the transpose pass: in ``order_t``
    order, gather each slot's row block of ``gb``, multiply with
    ``torch.bmm`` by the transposed blocks in the accumulation dtype, and
    ``index_add_`` the products into their column blocks, in chunks of
    slots."""
    _check_args_t(blocks, slot_row, order_t, cb_ptr, gb)
    B = blocks.shape[1]
    K = gb.shape[1]
    C = cb_ptr.shape[0] - 1
    nb = order_t.shape[0]
    acc = torch.promote_types(gb.dtype, torch.float32)
    slot_col = ptr2ind(cb_ptr, nb)  # column block of each scheduled slot
    gv = gb.reshape(-1, B, K).to(acc)
    out = torch.zeros((C, B, K), dtype=acc, device=gb.device)
    step = max(1, _PLAIN_CHUNK_BYTES // max(B * max(B, K) * 4, 1))
    for p in range(0, nb, step):
        e = min(p + step, nb)
        slots = order_t[p:e].long()
        tmp = torch.bmm(blocks[slots].to(acc).transpose(1, 2),
                        gv[slot_row[slots].long()])
        out.index_add_(0, slot_col[p:e], tmp)
    return out.reshape(C * B, K)


def block_spmm_t(blocks: torch.Tensor, slot_row: torch.Tensor,
                 order_t: torch.Tensor, cb_ptr: torch.Tensor,
                 gb: torch.Tensor) -> torch.Tensor:
    """``(C*B, K)`` float32 transpose block pass, ``A_blocks^T @ g``.
    ``blocks`` ``(nb+1, B, B)`` float32 or bfloat16, ``slot_row`` ``(nb,)``
    int32, ``order_t`` ``(nb,)`` int32 (the slots stably sorted by column
    block), ``cb_ptr`` ``(C+1,)`` int32 pointer over ``slot_col[order_t]``,
    ``gb`` ``(R*B, K)`` float32, the operand padded to whole row blocks.

    CUDA tensors run the hand-written kernel; CPU tensors run
    :func:`block_spmm_t_plain`."""
    _check_args_t(blocks, slot_row, order_t, cb_ptr, gb)
    dev = gb.device
    if dev.type == "cpu":
        return block_spmm_t_plain(blocks, slot_row, order_t, cb_ptr, gb)
    if dev.type != "cuda":
        raise NotImplementedError(
            f"block_spmm_t has no kernel for {dev.type}")
    if blocks.dtype not in _STORE_CODES or gb.dtype != torch.float32:
        raise TypeError("the block_spmm_t kernel takes float32 or bfloat16 "
                        "blocks and a float32 operand")
    for t in (slot_row, order_t, cb_ptr, gb):
        if not t.is_contiguous():
            raise ValueError("block_spmm_t operands must be contiguous")
    B, K = blocks.shape[1], gb.shape[1]
    C = cb_ptr.shape[0] - 1
    nb, R = order_t.shape[0], gb.shape[0] // B
    if nb == 0 or R == 0 or C == 0 or K == 0:  # no product to take
        return torch.zeros((C * B, K), dtype=torch.float32, device=dev)
    store, g4 = forward_operands(blocks, gb)
    out = torch.empty((C * B, K), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    rc = lib.block_spmm_t(
        dev.index, _STORE_CODES[blocks.dtype], store.data_ptr(),
        slot_row.data_ptr(), order_t.data_ptr(), cb_ptr.data_ptr(),
        g4.data_ptr(), out.data_ptr(), store.shape[0] - 1, R, C, B, K,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "block_spmm_t launch")
    block_spmm_t.launches += 1
    return out


block_spmm_t.launches = 0


def _check_args_d(p, q, slot_row, slot_col, B) -> None:
    if slot_row.dtype != INDEX_DTYPE or slot_col.dtype != INDEX_DTYPE:
        raise TypeError("slot_row and slot_col must be int32")
    if slot_row.shape != slot_col.shape or slot_row.dim() != 1:
        raise ValueError("slot_row and slot_col must be (nb,)")
    if (p.dim() != 2 or q.dim() != 2 or p.shape[1] != q.shape[1]
            or p.shape[0] % B or q.shape[0] % B):
        raise ValueError("p must be (R*B, K) and q (C*B, K)")
    devs = {t.device for t in (p, q, slot_row, slot_col)}
    if len(devs) != 1:
        raise ValueError("block_spmm_dblocks operands lie on different "
                         "devices")


def block_spmm_dblocks_plain(p: torch.Tensor, q: torch.Tensor,
                             slot_row: torch.Tensor, slot_col: torch.Tensor,
                             B: int, dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version: gather each slot's row block of ``p`` and
    column block of ``q``, multiply with ``torch.bmm`` in the
    accumulation dtype, in chunks of slots, and cast to ``dtype``."""
    _check_args_d(p, q, slot_row, slot_col, B)
    K = p.shape[1]
    nb = slot_row.shape[0]
    acc = torch.promote_types(p.dtype, torch.float32)
    pv = p.reshape(-1, B, K).to(acc)
    qv = q.reshape(-1, B, K).to(acc)
    out = torch.zeros((nb + 1, B, B), dtype=dtype, device=p.device)
    step = max(1, _PLAIN_CHUNK_BYTES // max(B * max(B, K) * 4, 1))
    for s in range(0, nb, step):
        e = min(s + step, nb)
        out[s:e] = torch.bmm(pv[slot_row[s:e].long()],
                             qv[slot_col[s:e].long()].transpose(1, 2))
    return out


def block_spmm_dblocks(p: torch.Tensor, q: torch.Tensor,
                       slot_row: torch.Tensor, slot_col: torch.Tensor,
                       B: int, dtype: torch.dtype) -> torch.Tensor:
    """``(nb+1, B, B)`` gradient of a block store in ``dtype`` (float32
    or bfloat16): ``out[s] = p[slot_row[s]] @ q[slot_col[s]]^T`` summed
    in fp32, and ``out[nb] = 0``.  ``p`` ``(R*B, K)`` and ``q``
    ``(C*B, K)`` float32, the row-block and column-block operands padded
    to whole blocks; ``slot_row``/``slot_col`` ``(nb,)`` int32.

    CUDA tensors run the hand-written kernel; CPU tensors run
    :func:`block_spmm_dblocks_plain`."""
    _check_args_d(p, q, slot_row, slot_col, B)
    dev = p.device
    if dev.type == "cpu":
        return block_spmm_dblocks_plain(p, q, slot_row, slot_col, B, dtype)
    if dev.type != "cuda":
        raise NotImplementedError(
            f"block_spmm_dblocks has no kernel for {dev.type}")
    if (dtype not in _STORE_CODES or p.dtype != torch.float32
            or q.dtype != torch.float32):
        raise TypeError("the block_spmm_dblocks kernel takes float32 "
                        "operands and writes a float32 or bfloat16 store")
    for t in (p, q, slot_row, slot_col):
        if not t.is_contiguous():
            raise ValueError("block_spmm_dblocks operands must be contiguous")
    nb, K = slot_row.shape[0], p.shape[1]
    if nb == 0 or K == 0:  # no product to take
        return torch.zeros((nb + 1, B, B), dtype=dtype, device=dev)
    p4, q4 = dblocks_operands(p, q)
    out = torch.empty((nb + 1, B, B), dtype=dtype, device=dev)
    lib = _kernel_lib()
    rc = lib.block_spmm_dblocks(
        dev.index, _STORE_CODES[dtype], p4.data_ptr(), q4.data_ptr(),
        slot_row.data_ptr(), slot_col.data_ptr(), out.data_ptr(), nb,
        p.shape[0] // B, q.shape[0] // B, B, K,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "block_spmm_dblocks launch")
    block_spmm_dblocks.launches += 1
    return out


block_spmm_dblocks.launches = 0
