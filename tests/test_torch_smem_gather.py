"""The launch shapes of the gather probe's kernels, on the CPU: K13a's
(``gather_shape``: chunk width, column slabs and grid) and K13c's
(``tiled_instance``: chunk width, lanes and slab; ``tile_cap``: the
tiles a block stages), each held to a table and to the rules the CUDA
source relies on, and the argument block that the K13a wrapper hands to
the C entry.  The kernels run only on the card
(``tests/test_torch_kernels_gpu.py``); their parity with the JAX probe
is in ``test_torch_probe_gather.py``."""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_sparse_tpu_torch.ops.kernels import (
    smem_gather, smem_gather_plain, tiled_spmm, tiled_spmm_plan)

sg = importlib.import_module("pytorch_sparse_tpu_torch.ops.kernels.smem_gather")
SOURCE = (Path(__file__).resolve().parents[1] / "pytorch_sparse_tpu_torch"
          / "csrc" / "smem_gather.cu").read_text()


@pytest.mark.parametrize("args,want", [
    # (T, K, n, aligned) -> (vec, col_tiles, grid_x)
    ((2048, 128, 2048, True), (4, 32, 4)),
    ((8, 128, 8, True), (4, 32, 1)),
    ((2047, 128, 4097, True), (4, 32, 4)),
    ((1, 128, 1, True), (4, 32, 1)),
    ((300, 33, 603, True), (1, 33, 4)),
    ((2048, 128, 2048, False), (1, 128, 1)),
    ((100, 256, 64, True), (4, 64, 1)),
    ((100, 1000, 5000, True), (4, 250, 1)),
    ((2048, 4, 100_000, True), (4, 1, 132)),
    ((14_528, 4, 10_000, True), (4, 1, 132)),
    ((14_529, 4, 10_000, True), (1, 4, 33)),
    ((20_000, 8, 100, True), (1, 8, 2)),
    ((58_112, 1, 100, True), (1, 1, 2)),
])
def test_gather_shape_table(args, want):
    assert tuple(sg.gather_shape(*args)) == want


@pytest.mark.parametrize("aligned", [True, False])
def test_gather_shape_refuses_a_table_past_its_domain(aligned):
    """A one-column slab of 58,112 rows fills a block's shared memory."""
    assert sg.gather_shape(58_112, 4, 10, aligned).vec == 1
    with pytest.raises(ValueError, match="does not fit"):
        sg.gather_shape(58_113, 4, 10, aligned)


@pytest.mark.parametrize("aligned", [True, False])
def test_every_gather_shape_keeps_the_kernels_rules(aligned):
    """Over random tables: each block's slab of every row fits in a
    block's shared memory, the slabs cover every column once, the grid
    stays within one wave, with a block for each ``SLAB_ROWS`` output rows
    at most, and 16-byte copies only where the width and the bases allow
    them."""
    rng = np.random.RandomState(80 + aligned)
    for _ in range(400):
        T = int(rng.choice([1, 7, 8, 300, 2047, 2048, 9000, 14_529,
                            40_000]))
        K = int(rng.choice([1, 3, 4, 33, 128, 256, 1000]))
        n = int(rng.randint(1, 5000))
        sh = sg.gather_shape(T, K, n, aligned)
        assert 4 * T * sh.vec <= sg.MAX_SMEM
        assert sh.col_tiles * sh.vec == K
        assert sh.vec == 1 or (aligned and K % 4 == 0)
        assert sh.grid_x * sh.col_tiles <= max(sg.SMS, sh.col_tiles)
        assert sh.grid_x <= -(-n // sg.SLAB_ROWS)


def test_gather_arguments_are_packed_in_the_c_entrys_order():
    """``smem_gather_f32`` reads {device, n, T, K, vec, grid_x} from one
    int array."""
    addr, arr = sg._gather_args(1, 2048, 128, 4096, True)
    assert addr and list(arr) == [1, 4096, 2048, 128, 4, 4]
    _, arr = sg._gather_args(0, 8, 128, 8, False)
    assert list(arr) == [0, 8, 8, 128, 1, 1]
    m = re.search(r"int smem_gather_f32\(const int\* args.*?grid_x = args\[5\]",
                  SOURCE, re.S)
    names = re.findall(r"(\w+) = args\[(\d)\]", m.group(0))
    assert [n for n, _ in sorted(names, key=lambda p: int(p[1]))] == [
        "device", "n", "T", "K", "vec", "grid_x"]
    assert sg.gather_shape.cache_info().maxsize is not None
    assert sg._gather_args.cache_info().maxsize is not None


def test_smem_gather_on_the_cpu_is_index_select_and_checks_operands():
    table = torch.randn(30, 6)
    idx = torch.tensor([3, 0, 29, 3], dtype=torch.int32)
    assert torch.equal(smem_gather(idx, table), smem_gather_plain(idx, table))
    assert torch.equal(smem_gather(idx.long(), table), table[idx.long()])
    with pytest.raises(TypeError, match="integer"):
        smem_gather(idx.float(), table)
    with pytest.raises(ValueError, match="expected"):
        smem_gather(idx[:, None], table)
    with pytest.raises(ValueError, match="different devices"):
        smem_gather(idx.to("meta"), table)
    with pytest.raises(IndexError):
        smem_gather(torch.tensor([30], dtype=torch.int32), table)


def _columns(K, inst):
    """The columns each (slab, lane) writes, by the kernel's rule: lane
    ``s`` of slab ``t`` owns ``t * width + s * vec`` and the ``vec - 1``
    after it, when that first column is below K."""
    cols = []
    for t in range(inst.col_tiles):
        for s in range(inst.lanes):
            first = t * inst.width + s * inst.vec
            if first < K:
                cols.extend(range(first, first + inst.vec))
    return cols


def _c_instances():
    return {tuple(map(int, m)) for m in
            re.findall(r"TILED_CASE\((\d+), (\d+)\)\n", SOURCE)}


@pytest.mark.parametrize("aligned", [True, False])
def test_every_width_is_covered_once_by_an_instance_the_source_has(aligned):
    table = _c_instances()
    assert len(table) == 10
    for K in range(1, 301):
        inst = sg.tiled_instance(K, aligned)
        assert sorted(_columns(K, inst)) == list(range(K)), (K, inst)
        assert (inst.vec, inst.lanes) in table
        assert inst.width == inst.vec * inst.lanes <= sg.SLAB
        assert inst.lanes * inst.rows_per_warp == 32
        assert inst.vec == (4 if aligned and K % 4 == 0 else 1)


@pytest.mark.parametrize("K,aligned,want", [
    # -> (vec, lanes, rows_per_warp, width, col_tiles)
    (1, True, (1, 1, 32, 1, 1)),
    (2, True, (1, 2, 16, 2, 1)),
    (4, True, (4, 1, 32, 4, 1)),
    (8, True, (4, 2, 16, 8, 1)),
    (16, True, (4, 4, 8, 16, 1)),
    (40, True, (4, 8, 4, 32, 2)),
    (128, True, (4, 8, 4, 32, 4)),
    (128, False, (1, 32, 1, 32, 4)),
    (256, True, (4, 8, 4, 32, 8)),
    (33, True, (1, 32, 1, 32, 2)),
    (64, False, (1, 32, 1, 32, 2)),
])
def test_tiled_instance_table(K, aligned, want):
    assert tuple(sg.tiled_instance(K, aligned)) == want


@pytest.mark.parametrize("n_cols,T,cap", [
    (232_965, 1024, 0), (232_965, 512, 1), (232_965, 256, 3),
    (232_965, 128, 6), (232_965, 64, 13),
    (1500, 64, 14), (768, 64, 14), (3000, 512, 1),
    (169_343, 32, 25),
])
def test_tile_cap_table(n_cols, T, cap):
    """What fits beside the slot table in the 113 KB that lets two blocks
    share an SM."""
    assert sg.tile_cap(n_cols, T) == cap
    used = sg._slot_bytes(n_cols, T) + 4 * sg.SLAB * T * cap
    assert used <= sg.BLOCK_SMEM < used + 4 * sg.SLAB * T
    assert 2 * (sg.BLOCK_SMEM + 1024) <= 228 * 1024


def test_a_plan_stages_at_most_its_cap():
    rng = np.random.RandomState(81)
    M = 2000
    row = np.sort(rng.randint(0, M, 60_000))
    col = rng.randint(0, M, row.size)   # every row block reaches all tiles
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(row, minlength=M))]).astype(np.int32))
    col_t = torch.from_numpy(col.astype(np.int32))
    x = torch.from_numpy(rng.randn(M, 12).astype(np.float32))
    plan = tiled_spmm_plan(rowptr, col_t, M, T=64, stage_min=1)
    assert plan.max_staged == sg.tile_cap(M, 64) < plan.n_pairs
    assert plan.n_staged == plan.max_staged * (plan.stage_ptr.numel() - 1)
    assert plan.smem_bytes() <= sg.BLOCK_SMEM
    assert torch.equal(tiled_spmm(rowptr, col_t, None, x, plan),
                       tiled_spmm(rowptr, col_t, None, x, tiled_spmm_plan(
                           rowptr, col_t, M, T=64, stage_min=None)))
