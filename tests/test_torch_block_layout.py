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


@pytest.mark.parametrize("B,dtype", [(100, torch.float32),
                                     (100, torch.bfloat16),
                                     (6, torch.float32), (6, torch.bfloat16),
                                     (512, torch.bfloat16)])
def test_padded_store_is_read_without_a_copy(B, dtype):
    """A store made by ``padded_store`` is the ``(n, B, B)`` view of a
    buffer whose rows are 16 bytes apart; ``store_layout`` (what K2, K5
    and K10 read) gives that buffer back, and the prepared store of the
    forward is it, not a copy.  Whatever lies in the padding, the
    kernels' maps end at B columns."""
    n = 5
    blocks = bs.padded_store(n, B, dtype, "cpu")
    Bp = bs.store_pitch(B, dtype)
    assert Bp * blocks.element_size() % 16 == 0 and 0 <= Bp - B < 8
    assert blocks.shape == (n, B, B) and blocks.stride() == (B * Bp, Bp, 1)
    assert blocks.is_contiguous() == (Bp == B)
    blocks.copy_(_ints(5, n, B, B).to(dtype))
    buf = bs.store_layout(blocks)
    assert buf.shape == (n, B, Bp) and buf.is_contiguous()
    assert buf.data_ptr() == blocks.data_ptr()
    assert torch.equal(buf[:, :, :B], blocks)
    assert not bool(buf[:, :, B:].any())
    store, _ = bs.forward_operands(blocks, _ints(6, 2 * B, 3))
    assert store.data_ptr() == blocks.data_ptr()
    # An unpadded store of the same values is copied once, padded.
    flat = blocks.contiguous()
    if Bp != B:
        assert bs.store_layout(flat).data_ptr() != flat.data_ptr()
    assert torch.equal(bs.store_layout(flat), buf)


@pytest.mark.parametrize("B,dtype", [(100, torch.bfloat16), (6, torch.float32),
                                     (16, torch.float32)])
def test_builders_pad_the_store_once(B, dtype):
    """The hybrid builder and the SpGEMM block split lay their stores
    out padded at build, so no product copies them; the transpose pass
    over the padded store equals it over a plain copy."""
    from pytorch_sparse_tpu_torch import SparseTensor
    from pytorch_sparse_tpu_torch.ops.kernels import (
        block_spmm_t_plain, hybrid)
    from pytorch_sparse_tpu_torch.ops.spgemm import _block_split

    rng = np.random.RandomState(B)
    M = 4 * B
    row, col = rng.randint(0, M, 8 * M), rng.randint(0, M, 8 * M)
    val = rng.randint(-3, 4, 8 * M).astype(np.float32)
    h = hybrid.build_hybrid(row, col, val, M, M, B=B, min_density=0.0,
                            block_dtype=dtype, device="cpu")
    Bp = bs.store_pitch(B, dtype)
    assert h.blocks.stride() == (B * Bp, Bp, 1)
    assert bs.store_layout(h.blocks).data_ptr() == h.blocks.data_ptr()
    g = _ints(7, (h.rb_ptr.shape[0] - 1) * B, 5)
    t_args = (h.slot_row, h.order_t, h.cb_ptr, g)
    assert torch.equal(block_spmm_t_plain(h.blocks, *t_args),
                       block_spmm_t_plain(h.blocks.contiguous(), *t_args))
    A = SparseTensor(row=row, col=col, value=val, sparse_sizes=(M, M),
                     device="cpu")
    blocks = _block_split(A, B, 0.0, dtype)[0]
    assert blocks.dtype == dtype and blocks.stride() == (B * Bp, Bp, 1)
    assert bs.store_layout(blocks).data_ptr() == blocks.data_ptr()


@pytest.mark.parametrize("B,dtype,values", [
    (100, torch.bfloat16, True), (6, torch.float32, True),
    (16, torch.float32, False)])
def test_block_split_sums_duplicates_on_the_device(B, dtype, values):
    """The SpGEMM block split writes its store on the device: each
    entry the sum of its edges (integers, so the sums are exact in any
    order; implicit values count as ones), the padding zero."""
    from pytorch_sparse_tpu_torch import SparseTensor
    from pytorch_sparse_tpu_torch.ops.spgemm import _block_split

    rng = np.random.RandomState(B + 1)
    M = 3 * B
    E = 6 * M
    row, col = rng.randint(0, M, E), rng.randint(0, M, E)
    row[:E // 3], col[:E // 3] = row[E // 3:2 * E // 3], col[E // 3:2 * E // 3]
    val = rng.randint(-3, 4, E).astype(np.float32) if values else None
    A = SparseTensor(row=row, col=col, value=val, sparse_sizes=(M, M),
                     device="cpu")
    blocks, srow, scol, _, n_in, mask = _block_split(A, B, 0.0, dtype)
    r, c = A.storage.numpy_view("row"), A.storage.numpy_view("col")
    w = (np.ones(E) if val is None
         else A.storage.value().double().numpy())
    key = (r // B) * (-(-M // B)) + c // B
    slot = np.searchsorted(srow * (-(-M // B)) + scol, key)
    want = np.zeros((srow.size, B, B))
    np.add.at(want, (slot, r % B, c % B), w)
    assert n_in == E and mask.all()
    assert torch.equal(blocks.double(), torch.from_numpy(want))
    assert not bool(bs.store_layout(blocks)[:, :, B:].any())
