"""Block-pair SpGEMM: the dense-block x dense-block share of a sparse
product, as sums of (Bb, Bb) @ (Bb, Bb) block products.

Counterpart of ``pytorch_sparse_tpu/ops/kernels/block_spgemm.py``.

* :func:`block_spgemm_plan` pairs the dense blocks of A and B on their
  shared block index and groups the pairs by output block (host numpy,
  unchanged from the JAX package).
* :func:`block_spgemm_window` computes one window of output blocks:
  ``out[o] = sum of blocksA[a_idx[p]] @ blocksB[b_idx[p]]`` over the
  pairs ``p`` in ``[seg_ptr[o], seg_ptr[o+1])``.  It replaces the JAX
  function of the same name, which padded the pairs to a power-of-two
  number of chunks and walked them in a ``lax.scan`` with a segment-sum;
  the CUDA kernel (``csrc/block_spgemm.cu``, on the tensor-core template
  of ``csrc/block_tc.cuh``: TF32 ``wgmma`` fed by TMA, 3xTF32 for f32
  stores) gives each output tile to one CTA, which walks that tile's
  pairs and adds each 32-wide step into fp32 sums: no padding, no scan,
  no atomic.  Block stores whose rows are not 16 bytes are read through
  :func:`~.block_spmm.store_layout`: the ``_block_split`` path of
  ``ops/spgemm.py`` pads them once, at the split; any other such store
  is padded at each call.
* :func:`block_spgemm_windows` cuts a plan into windows of at most
  ``max_out_blocks`` complete output blocks, and
  :func:`block_spgemm_stream` streams the whole block product through
  them.

:func:`block_spgemm_window` launches the kernel for CUDA tensors and
runs :func:`block_spgemm_window_plain` (chunked ``torch.bmm`` +
``index_add_``) for CPU tensors.  Other devices raise.
``block_spgemm_window.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, List, Tuple

import numpy as np
import torch

from ... import _build
from ...utils.convert import INDEX_DTYPE, ptr2ind
from .block_spmm import store_layout

_lib = None
_STORE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Bound on the (pairs, Bb, Bb) temporaries of the plain version, as the
# JAX package bounds its chunks (256 pairs of 512^2 f32).
_PAIR_CHUNK_BYTES = 256 << 20


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("block_spgemm")
        lib.block_spgemm_window.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.block_spgemm_window.restype = ctypes.c_int
        _lib = lib
    return _lib


def block_spgemm_plan(
    srowA: np.ndarray, scolA: np.ndarray,
    srowB: np.ndarray, scolB: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host pairing pass: all (a, b) block pairs with ``scolA[a] ==
    srowB[b]``, grouped by output block.

    Returns ``(a_idx, b_idx, out_seg, out_row, out_col)``: pair operand
    indices sorted by output block, the output-block segment id of each
    pair, and each output block's (row, col) block coordinates."""
    orderB = np.argsort(srowB, kind="stable")
    sb = srowB[orderB]
    n_k = int(max(sb.max() + 1 if sb.size else 1,
                  scolA.max() + 1 if scolA.size else 1))
    startB = np.searchsorted(sb, np.arange(n_k))
    endB = np.searchsorted(sb, np.arange(n_k), side="right")
    deg = endB[scolA] - startB[scolA]
    a_idx = np.repeat(np.arange(srowA.shape[0], dtype=np.int64), deg)
    total = int(deg.sum())
    run = np.concatenate([[0], np.cumsum(deg)[:-1]])
    off = np.arange(total, dtype=np.int64) - run[a_idx]
    b_idx = orderB[startB[scolA[a_idx]] + off]
    ncb = int(scolB.max() + 1) if scolB.size else 1
    key = srowA[a_idx].astype(np.int64) * ncb + scolB[b_idx]
    order = np.argsort(key, kind="stable")
    a_idx, b_idx, key = a_idx[order], b_idx[order], key[order]
    out_keys, out_seg = np.unique(key, return_inverse=True)
    return (a_idx, b_idx, out_seg.astype(np.int64),
            (out_keys // ncb).astype(np.int64),
            (out_keys % ncb).astype(np.int64))


def _check_args(blocksA, blocksB, a_idx, b_idx, seg_ptr, n_out) -> None:
    if (blocksA.dim() != 3 or blocksB.dim() != 3
            or blocksA.shape[1:] != blocksB.shape[1:]
            or blocksA.shape[1] != blocksA.shape[2]):
        raise ValueError("blocksA and blocksB must be (nb, Bb, Bb) with one "
                         "Bb")
    if blocksA.dtype != blocksB.dtype:
        raise TypeError("blocksA and blocksB must share a dtype")
    if any(t.dtype != INDEX_DTYPE for t in (a_idx, b_idx, seg_ptr)):
        raise TypeError("a_idx, b_idx and seg_ptr must be int32")
    if a_idx.dim() != 1 or a_idx.shape != b_idx.shape:
        raise ValueError("a_idx and b_idx must be 1-D of one length")
    if seg_ptr.dim() != 1 or seg_ptr.shape[0] != n_out + 1:
        raise ValueError(f"seg_ptr must have n_out + 1 = {n_out + 1} entries")
    devs = {t.device for t in (blocksA, blocksB, a_idx, b_idx, seg_ptr)}
    if len(devs) != 1:
        raise ValueError("block_spgemm operands lie on different devices")


def block_spgemm_window_plain(blocksA: torch.Tensor, blocksB: torch.Tensor,
                              a_idx: torch.Tensor, b_idx: torch.Tensor,
                              seg_ptr: torch.Tensor,
                              n_out: int) -> torch.Tensor:
    """Plain PyTorch version: gather each pair's two blocks, multiply
    with ``torch.bmm`` in float32, and ``index_add_`` the products into
    their output blocks, in chunks of pairs."""
    _check_args(blocksA, blocksB, a_idx, b_idx, seg_ptr, n_out)
    Bb = blocksA.shape[1]
    npairs = a_idx.shape[0]
    out = torch.zeros((n_out, Bb, Bb), dtype=torch.float32,
                      device=blocksA.device)
    seg = ptr2ind(seg_ptr, npairs)
    step = max(1, _PAIR_CHUNK_BYTES // max(Bb * Bb * 4, 1))
    for s in range(0, npairs, step):
        e = min(s + step, npairs)
        prod = torch.bmm(blocksA[a_idx[s:e].long()].float(),
                         blocksB[b_idx[s:e].long()].float())
        out.index_add_(0, seg[s:e], prod)
    return out


def block_spgemm_window(blocksA: torch.Tensor, blocksB: torch.Tensor,
                        a_idx: torch.Tensor, b_idx: torch.Tensor,
                        seg_ptr: torch.Tensor, n_out: int) -> torch.Tensor:
    """``(n_out, Bb, Bb)`` float32 output blocks of one window:
    ``out[o] = sum of blocksA[a_idx[p]] @ blocksB[b_idx[p]]`` over ``p``
    in ``[seg_ptr[o], seg_ptr[o+1])``.  ``blocksA`` ``(nbA, Bb, Bb)`` and
    ``blocksB`` ``(nbB, Bb, Bb)`` share a float32 or bfloat16 store;
    ``a_idx``/``b_idx`` ``(npairs,)`` int32 hold the pairs sorted by
    output block and ``seg_ptr`` ``(n_out+1,)`` int32 points into them.

    CUDA tensors run the hand-written kernel; CPU tensors run
    :func:`block_spgemm_window_plain`."""
    _check_args(blocksA, blocksB, a_idx, b_idx, seg_ptr, n_out)
    dev = blocksA.device
    if dev.type == "cpu":
        return block_spgemm_window_plain(blocksA, blocksB, a_idx, b_idx,
                                         seg_ptr, n_out)
    if dev.type != "cuda":
        raise NotImplementedError(
            f"block_spgemm_window has no kernel for {dev.type}")
    if blocksA.dtype not in _STORE_CODES:
        raise TypeError("the block_spgemm_window kernel takes float32 or "
                        "bfloat16 blocks")
    for t in (a_idx, b_idx, seg_ptr):
        if not t.is_contiguous():
            raise ValueError("block_spgemm_window operands must be "
                             "contiguous")
    Bb = blocksA.shape[1]
    if a_idx.shape[0] == 0 or n_out == 0:  # no product to take
        return torch.zeros((n_out, Bb, Bb), dtype=torch.float32, device=dev)
    sa = store_layout(blocksA)
    sb = sa if blocksB is blocksA else store_layout(blocksB)
    out = torch.empty((n_out, Bb, Bb), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    rc = lib.block_spgemm_window(
        dev.index, _STORE_CODES[blocksA.dtype], sa.data_ptr(),
        sb.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(),
        seg_ptr.data_ptr(), out.data_ptr(), sa.shape[0], sb.shape[0], n_out,
        Bb, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "block_spgemm_window launch")
    block_spgemm_window.launches += 1
    return out


block_spgemm_window.launches = 0


def block_spgemm_windows(
    plan: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    max_out_blocks: int, device,
) -> List[Tuple[int, int, torch.Tensor, torch.Tensor, torch.Tensor, int]]:
    """Cut a :func:`block_spgemm_plan` into windows of at most
    ``max_out_blocks`` complete output blocks.

    Returns ``(lo, hi, a_idx, b_idx, seg_ptr, n_out)`` per window: the
    output blocks ``[lo, hi)`` and the int32 :func:`block_spgemm_window`
    arguments on ``device``."""
    a_idx, b_idx, out_seg, out_row, _ = plan
    n_total = out_row.shape[0]
    seg_ptr = np.searchsorted(out_seg, np.arange(n_total + 1))
    ai = torch.from_numpy(a_idx.astype(np.int32)).to(device)
    bi = torch.from_numpy(b_idx.astype(np.int32)).to(device)
    wins = []
    for lo in range(0, n_total, max_out_blocks):
        hi = min(lo + max_out_blocks, n_total)
        p0, p1 = int(seg_ptr[lo]), int(seg_ptr[hi])
        sp = torch.from_numpy(
            (seg_ptr[lo:hi + 1] - p0).astype(np.int32)).to(device)
        wins.append((lo, hi, ai[p0:p1], bi[p0:p1], sp, hi - lo))
    return wins


def block_spgemm_stream(
    blocksA: torch.Tensor, srowA: np.ndarray, scolA: np.ndarray,
    blocksB: torch.Tensor, srowB: np.ndarray, scolB: np.ndarray,
    max_out_blocks: int = 2048,
) -> Iterator[Tuple[np.ndarray, np.ndarray, torch.Tensor]]:
    """Stream ``C = A_blocks @ B_blocks`` as dense-block windows.

    Yields ``(out_rows, out_cols, C_blocks)`` with ``C_blocks``
    ``(n, Bb, Bb)`` float32 on the blocks' device and ``n <=
    max_out_blocks``; windows cut on output-block boundaries, so every
    yielded block is complete (all its pairs summed)."""
    plan = block_spgemm_plan(srowA, scolA, srowB, scolB)
    out_row, out_col = plan[3], plan[4]
    for lo, hi, ai, bi, sp, n in block_spgemm_windows(
            plan, max_out_blocks, blocksA.device):
        yield (out_row[lo:hi], out_col[lo:hi],
               block_spgemm_window(blocksA, blocksB, ai, bi, sp, n))
