"""The operand layouts that the block kernels' wrappers prepare for TMA.

The forward (``block_spmm``) and the store gradient
(``block_spmm_dblocks``) run on the card only, but the layouts their
wrappers hand them are made in Python: a block store with rows padded to
16 bytes, the operand and P/Q padded to a multiple of 4 columns, every
base 16-byte aligned.  Here, on the CPU, the plain products over the
prepared operands, read as the kernels read them (zeros past each
tensor's extent), equal the plain products over the original operands.
Integer-valued data keep every sum exact, so the comparisons are exact.
"""

import importlib

import numpy as np
import pytest
import torch

from pytorch_sparse_tpu_torch.ops.kernels import (
    block_spmm_dblocks_plain, block_spmm_plain)

bs = importlib.import_module("pytorch_sparse_tpu_torch.ops.kernels.block_spmm")


def _ints(seed, *shape):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(-3, 4, shape).astype(np.float32))


def _schedule(R, C, nb, seed):
    """``nb`` distinct row-block-sorted slots of an ``R x C`` grid, row
    block 1 left without a slot: (slot_row, slot_col, rb_ptr)."""
    rng = np.random.RandomState(seed)
    keys = np.array([k for k in range(R * C) if k // C != 1])
    keys = np.sort(rng.choice(keys, nb, replace=False))
    rows, cols = keys // C, keys % C
    rb_ptr = np.searchsorted(rows, np.arange(R + 1))
    return [torch.from_numpy(a.astype(np.int32)) for a in (rows, cols, rb_ptr)]


def _offset_view(t):
    """``t``'s values in a tensor whose data start 4 bytes past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


def _forward_as_kernel(store, x4, slot_col, rb_ptr, B, K):
    """The forward as the kernel reads its prepared operands: each slot's
    (B, Bp) block of the store times its column block of ``x4`` read as
    (Bp, K4), with zeros past the B rows that ``x4`` has a block."""
    Bp, K4 = store.shape[2], x4.shape[1]
    C = x4.shape[0] // B
    xv = torch.zeros((C, Bp, K4))
    xv[:, :B] = x4.view(C, B, K4)
    R = rb_ptr.shape[0] - 1
    out = torch.zeros((R, B, K4))
    slot_row = torch.repeat_interleave(torch.arange(R),
                                       (rb_ptr[1:] - rb_ptr[:-1]).long())
    nb = slot_col.shape[0]
    prod = torch.bmm(store[:nb].float(), xv[slot_col.long()])
    out.index_add_(0, slot_row, prod)
    return out.reshape(R * B, K4)[:, :K]


@pytest.mark.parametrize("B,K,dtype", [
    (100, 47, torch.float32), (100, 70, torch.bfloat16),
    (128, 40, torch.float32), (128, 128, torch.bfloat16),
    (6, 5, torch.float32), (6, 3, torch.bfloat16)])
@pytest.mark.parametrize("offset", [False, True])
def test_forward_operands_keep_the_product(B, K, dtype, offset):
    R, C, nb = 4, 3, 7
    _, slot_col, rb_ptr = _schedule(R, C, nb, seed=B + K)
    blocks = _ints(1, nb + 1, B, B).to(dtype)
    xb = _ints(2, C * B, K)
    if offset:
        blocks, xb = _offset_view(blocks), _offset_view(xb)
    store, x4 = bs.forward_operands(blocks, xb)
    elem = blocks.element_size()
    Bp = -(-B * elem // 16) * 16 // elem
    K4 = -(-K // 4) * 4
    assert store.shape == (nb + 1, B, Bp) and store.dtype == dtype
    assert x4.shape == (C * B, K4) and x4.dtype == torch.float32
    for t in (store, x4):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert t.shape[-1] * t.element_size() % 16 == 0
    assert not bool(store[:, :, B:].any()) and not bool(x4[:, K:].any())
    assert torch.equal(store[:, :, :B], blocks)
    assert torch.equal(x4[:, :K], xb)
    want = block_spmm_plain(blocks, slot_col, rb_ptr, xb)
    got = _forward_as_kernel(store, x4, slot_col, rb_ptr, B, K)
    assert torch.equal(got, want)
    assert not bool(want[B:2 * B].any())  # row block 1 has no slot


@pytest.mark.parametrize("B,K", [(100, 70), (128, 47), (8, 3), (64, 256)])
@pytest.mark.parametrize("offset", [False, True])
def test_dblocks_operands_keep_the_product(B, K, offset):
    R, C, nb = 3, 4, 6
    slot_row, slot_col, _ = _schedule(R, C, nb, seed=B * K)
    p, q = _ints(3, R * B, K), _ints(4, C * B, K)
    if offset:
        p, q = _offset_view(p), _offset_view(q)
    p4, q4 = bs.dblocks_operands(p, q)
    K4 = -(-K // 4) * 4
    assert p4.shape == (R * B, K4) and q4.shape == (C * B, K4)
    for t in (p4, q4):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
    assert not bool(p4[:, K:].any()) and not bool(q4[:, K:].any())
    for dtype in (torch.float32, torch.bfloat16):
        want = block_spmm_dblocks_plain(p, q, slot_row, slot_col, B, dtype)
        got = block_spmm_dblocks_plain(p4, q4, slot_row, slot_col, B, dtype)
        assert torch.equal(got, want)
        assert not bool(got[nb].any())  # the trailing zero slot


def test_widths_already_whole_are_not_copied():
    """Where every width is already whole, the prepared operands are the
    originals themselves (no copy on the main path's shapes)."""
    blocks = torch.zeros(3, 512, 512)
    xb = torch.zeros(4 * 512, 128)
    store, x4 = bs.forward_operands(blocks, xb)
    assert store.data_ptr() == blocks.data_ptr()
    assert x4.data_ptr() == xb.data_ptr()
    p, q = torch.zeros(1024, 256), torch.zeros(512, 256)
    p4, q4 = bs.dblocks_operands(p, q)
    assert p4.data_ptr() == p.data_ptr() and q4.data_ptr() == q.data_ptr()
