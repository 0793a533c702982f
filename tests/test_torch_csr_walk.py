"""The CSR walk's choice of instance (``walk_instance`` in
``ops/kernels/csr_spmm.py``), which ``csr_spmm`` (K1) and ``shard_spmm``
(K11a) share: every width maps to an instance whose lanes cover each
column exactly once, a misaligned base selects the scalar instance, and
every instance chosen is one the CUDA source instantiates.  The kernel
itself runs only on the card (``tests/test_torch_kernels_gpu.py``); the
CPU wrappers' parity with the JAX package is in ``test_torch_spmm.py``
and ``test_torch_dist.py``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_sparse_tpu_torch.ops.kernels import (
    csr_spmm, csr_spmm_plain, shard_spmm)
from pytorch_sparse_tpu_torch.ops.kernels.csr_spmm import (
    TILE_COLUMNS, launch_instance, walk_instance)

HEADER = (Path(__file__).resolve().parents[1] / "pytorch_sparse_tpu_torch"
          / "csrc" / "csr_walk.cuh")


def _columns(K, inst):
    """The columns each (tile, lane, chunk) writes, by the kernel's rule:
    a chunk is live when its first column is below K, and then all of its
    ``vec`` columns are read and written."""
    tile = inst.lanes * inst.vec * inst.chunks
    cols = []
    for t in range(inst.col_tiles):
        for s in range(inst.lanes):
            for j in range(inst.chunks):
                first = t * tile + (s + inst.lanes * j) * inst.vec
                if first < K:
                    cols.extend(range(first, first + inst.vec))
    return cols


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lo,hi", [(1, 40), (41, 100), (101, 200),
                                   (201, 300)])
def test_every_width_is_covered_exactly_once(lo, hi, aligned):
    for K in range(lo, hi + 1):
        inst = walk_instance(K, aligned)
        cols = _columns(K, inst)
        assert sorted(cols) == list(range(K)), (K, inst)
        tile = inst.lanes * inst.vec * inst.chunks
        assert tile <= TILE_COLUMNS
        assert (inst.col_tiles - 1) * tile < K <= inst.col_tiles * tile
        assert inst.lanes * inst.rows_per_warp == 32
        assert inst.lanes & (inst.lanes - 1) == 0
        assert inst.vec == (4 if aligned and K % 4 == 0 else 1)


@pytest.mark.parametrize("K", [4, 8, 20, 40, 128, 256, 300])
def test_a_misaligned_base_selects_the_scalar_instance(K):
    assert walk_instance(K, True).vec == 4
    assert walk_instance(K, False).vec == 1
    N = 6
    x_off = torch.zeros(N * K + 1)[1:].view(N, K)
    out = torch.empty(3, K)
    assert x_off.data_ptr() % 16 != 0
    assert launch_instance(K, x_off, out) == walk_instance(K, False)
    assert launch_instance(K, x_off.clone(), out) == walk_instance(K, True)
    out_off = torch.zeros(3 * K + 1)[1:].view(3, K)
    assert launch_instance(K, x_off.clone(), out_off).vec == 1


@pytest.mark.parametrize("K,rows", [(1, 32), (3, 32), (8, 16), (20, 4),
                                    (32, 4), (40, 2), (47, 2), (64, 2),
                                    (128, 1), (256, 1)])
def test_narrow_widths_walk_several_rows_a_warp(K, rows):
    """Lanes a row are the lanes K needs at 4 columns a lane, as a power
    of two: 32 rows a warp at K=1 (``gcn_norm``'s degree), 16 at K=8
    (GAT's heads), 2 at K=40 and 47 (the last layers)."""
    aligned = walk_instance(K, True)
    assert aligned.rows_per_warp == rows
    assert walk_instance(K, False).rows_per_warp == rows


def test_every_chosen_instance_is_instantiated():
    """The C dispatch launches only the instances its table lists; every
    choice of ``walk_instance`` must be one of them."""
    cases = set(tuple(int(v) for v in m) for m in re.findall(
        r"CSR_WALK_CASE\((\d+), (\d+), (\d+)\)", HEADER.read_text()))
    assert len(cases) == 16
    chosen = {(i.vec, i.lanes, i.chunks)
              for K in range(1, 1025) for aligned in (True, False)
              for i in [walk_instance(K, aligned)]}
    assert chosen == cases


@pytest.mark.parametrize("K", [1, 8, 128])
def test_cpu_tensors_run_the_plain_versions(K):
    """On the CPU the wrappers run their plain versions: no launch and
    no instance."""
    rng = np.random.RandomState(80)
    rowptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    col = torch.from_numpy(rng.randint(0, 4, 5).astype(np.int32))
    x = torch.from_numpy(rng.randn(4, K).astype(np.float32))
    before = (csr_spmm.launches, shard_spmm.launches,
              csr_spmm.last_instance, shard_spmm.last_instance)
    out = csr_spmm(rowptr, col, None, x)
    torch.testing.assert_close(out, csr_spmm_plain(rowptr, col, None, x),
                               rtol=0, atol=0)
    torch.testing.assert_close(shard_spmm(rowptr, col, None, x), out,
                               rtol=0, atol=0)
    assert (csr_spmm.launches, shard_spmm.launches, csr_spmm.last_instance,
            shard_spmm.last_instance) == before
