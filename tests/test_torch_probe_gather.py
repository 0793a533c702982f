"""The port's on-chip gather probe against the JAX package's
(``benchmarks/probe_vmem_gather.py``), on the CPU.

The JAX probe's Pallas kernels run in interpret mode: the probe module is
loaded from its file with a stub ``timing`` module (its own sets a
compile cache) and a ``pl`` whose ``pallas_call`` interprets, and its
``_call`` and ``device_time`` are wrapped to keep each kernel's output.
Nothing in the JAX package changes.  The same seeded numpy inputs then
go through the port's plain versions (what the CPU runs):

* K13a ``smem_gather``: equal to ``gather_kernel`` (T = 2048) and
  ``gather8_kernel`` (T = 8) exactly;
* K13b ``edge_scan_loop``: within 1e-6 of max |ref| of the looped
  cumsum at R = 1, 3 and 8 (both sum in float32, in other orders);
* K13c ``tiled_spmm``: equal to ``csr_spmm_plain`` (the same products
  added in the same order) and within 1e-5 of the JAX package's
  ``matmul`` (another summation order);
* ``segment_sum_csr``: within 1e-6 of JAX's sorted ``segment_sum``.
"""

import functools
import importlib.util
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu_torch.benchmarks import probe_vmem_gather as probe
from pytorch_sparse_tpu_torch.benchmarks.timing import device_time
from pytorch_sparse_tpu_torch.ops.kernels import (
    csr_spmm_plain, edge_scan_loop, smem_gather,
    smem_gather_plain, tiled_spmm, tiled_spmm_plain, tiled_spmm_plan)
from pytorch_sparse_tpu_torch.segment import segment_sum_csr
from pytorch_sparse_tpu_torch.testing import rel_err

sg = importlib.import_module(
    "pytorch_sparse_tpu_torch.ops.kernels.smem_gather")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCAN_REPS = (1, 3, 8)


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX probe's kernel outputs: ``{"gather_kernel": (args, out),
    "gather8_kernel": ..., "scan": {R: out}}``."""
    outputs = {"scan": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "path", list(sys.path))

        def device_time_stub(fn, *args, **kw):
            fn(*args)  # the wrapped _call keeps the output
            return float(len(outputs["scan"]) + 1)

        stub = types.ModuleType("timing")
        stub.device_time = device_time_stub
        mp.setitem(sys.modules, "timing", stub)
        spec = importlib.util.spec_from_file_location(
            "jax_probe_vmem_gather", ROOT / "benchmarks" /
            "probe_vmem_gather.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mp.setattr(mod, "pl", types.SimpleNamespace(
            pallas_call=functools.partial(pl.pallas_call, interpret=True),
            BlockSpec=pl.BlockSpec))

        call = mod._call
        scan_r = []

        def recording_call(kernel, out_shape, *args):
            out = call(kernel, out_shape, *args)
            name = kernel.__name__
            if name == "kernel":  # _loop_time's, at the R being timed
                outputs["scan"][scan_r.pop(0)] = np.asarray(out)
                return out
            outputs[name] = ([np.asarray(a) for a in args], np.asarray(out))
            if name == "gather_kernel":
                # Take the probe's branch for a refused big-table gather,
                # so that it runs the 8-row gather too.
                raise RuntimeError("Multiple source vregs along gather "
                                   "dimension")
            return out

        mp.setattr(mod, "_call", recording_call)
        loop_time = mod._loop_time

        def loop_time_at(make_body, label, *args, reps=None):
            for pair in ((SCAN_REPS[0], SCAN_REPS[1]), (SCAN_REPS[2], 1)):
                scan_r.extend(pair)
                loop_time(make_body, label, *args, reps=pair)

        mp.setattr(mod, "_loop_time", loop_time_at)
        mod.main()
    return outputs


@pytest.mark.parametrize("kernel,T", [("gather_kernel", 2048),
                                      ("gather8_kernel", 8)])
def test_smem_gather_equals_the_jax_gather_kernels(jax_probe, kernel, T):
    (idx_j, x_j), out_j = jax_probe[kernel]
    idx, table = probe.gather_inputs("cpu")[0 if T == 2048 else 1]
    np.testing.assert_array_equal(idx.numpy(), idx_j[:, 0])
    np.testing.assert_array_equal(table.numpy(), x_j)
    got = smem_gather(idx, table)
    np.testing.assert_array_equal(got.numpy(), out_j)
    np.testing.assert_array_equal(smem_gather_plain(idx.long(), table).numpy(),
                                  out_j)


def _gather_model(idx, table, sh):
    """A numpy model of K13a's launch ``sh``: the output rows split over
    the ``grid_x`` blocks of each column slab; a block holds its slab's
    ``vec`` columns of every row of the table and copies each of its
    output rows from there, NaN outside [0, T)."""
    T, K = table.shape
    n = idx.size
    per = -(-n // sh.grid_x)
    assert (n - 1) // per < sh.grid_x          # every row has a block
    out = np.full((n, K), np.nan, np.float32)
    for t in range(sh.col_tiles):
        k0 = t * sh.vec
        slab = table[:, k0:k0 + sh.vec].copy()   # the block's shared memory
        for b in range(sh.grid_x):
            for i in range(b * per, min(n, (b + 1) * per)):
                if 0 <= idx[i] < T:
                    out[i, k0:k0 + sh.vec] = slab[idx[i]]
    return out


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("kernel,T", [("gather_kernel", 2048),
                                      ("gather8_kernel", 8)])
def test_gather_split_model_equals_the_jax_gather_kernels(jax_probe, kernel,
                                                          T, aligned):
    """K13a's split of the JAX probe's tables (which block and column slab
    writes each output element), with 16-byte and with scalar copies,
    gives the JAX kernels' rows exactly; an index outside the table gives
    a NaN row."""
    (idx_j, x_j), out_j = jax_probe[kernel]
    sh = sg.gather_shape(T, x_j.shape[1], idx_j.shape[0], aligned)
    assert sh.vec == (4 if aligned else 1)
    np.testing.assert_array_equal(_gather_model(idx_j[:, 0], x_j, sh), out_j)
    bad = np.array([-1, T, 0], np.int64)
    got = _gather_model(bad, x_j, sh)
    assert np.isnan(got[:2]).all()
    np.testing.assert_array_equal(got[2], x_j[0])


@pytest.mark.parametrize("R", SCAN_REPS)
def test_edge_scan_loop_matches_the_jax_loop(jax_probe, R):
    h = probe.scan_input("cpu")
    got = edge_scan_loop(h, R)
    assert rel_err(got, jax_probe["scan"][R]) <= 1e-6


def _jax_and_port(kind, M, E, seed, values):
    rng = np.random.RandomState(seed)
    if kind == "community":
        A = pts.testing.community_graph(M, E, n_comm=5, seed=seed,
                                        equal_sizes=True, device="cpu")
        row, col, val = (t.numpy() for t in A.coo())
    else:
        row, col = rng.randint(0, M, E), rng.randint(0, M, E)
        val = rng.randn(E).astype(np.float32)
    val = val if values else None
    J = jts.SparseTensor(row=row, col=col,
                         value=None if val is None else jnp.asarray(val),
                         sparse_sizes=(M, M))
    P = pts.SparseTensor(row=row, col=col,
                         value=None if val is None else torch.from_numpy(val),
                         sparse_sizes=(M, M), device="cpu")
    return J, P


@pytest.mark.parametrize("kind", ["uniform", "community"])
@pytest.mark.parametrize("T,stage_min", [(64, 0), (128, None), (256, 10**9)])
@pytest.mark.parametrize("values", [True, False])
def test_tiled_spmm_matches_csr_and_jax(kind, T, stage_min, values):
    J, P = _jax_and_port(kind, 1500, 30_000, 70, values)
    x = np.random.RandomState(71).randn(1500, 24).astype(np.float32)
    rowptr, col, val = P.csr()
    xt = torch.from_numpy(x)
    plan = tiled_spmm_plan(rowptr, col, 1500, T=T, stage_min=stage_min)
    if stage_min == 0:
        # Each row block stages every pair it holds, up to the 14 of its
        # 24 tiles that fit in its 113 KB.
        rb = np.repeat(np.arange(1500), np.diff(rowptr.numpy())) // 256
        pairs = np.unique(rb * 24 + col.numpy() // T)
        per_rb = np.bincount(pairs // 24)
        assert sg.tile_cap(1500, T) == 14
        assert plan.n_staged == np.minimum(per_rb, 14).sum() > 0
    elif stage_min is not None:
        assert plan.n_staged == 0
    got = tiled_spmm(rowptr, col, val, xt, plan)
    assert torch.equal(got, csr_spmm_plain(rowptr, col, val, xt))
    assert torch.equal(got, tiled_spmm_plain(rowptr, col, val, xt, plan))
    ref = np.asarray(jts.matmul(J, jnp.asarray(x)))
    assert rel_err(got, ref) <= 1e-5


def test_tiled_spmm_plan_counts_and_checks():
    # Two row blocks; tiles of 128 columns over 300 (the last of 44).
    rowptr = torch.tensor([0, 3, 3] + [5] * 254 + [7], dtype=torch.int32)
    col = torch.tensor([1, 2, 260, 5, 130, 270, 299], dtype=torch.int32)
    plan = tiled_spmm_plan(rowptr, col, 300, T=128, stage_min=2)
    assert (plan.n_pairs, plan.n_staged, plan.staged_edges) == (4, 2, 5)
    assert plan.stage_ptr.tolist() == [0, 1, 2]
    assert plan.stage_tile.tolist() == [0, 2]
    assert plan.max_staged == 1
    assert plan.staged_rows == 172 and plan.staged_bytes(8) == 4 * 8 * 172
    x = torch.randn(300, 8)
    with pytest.raises(ValueError, match="plan was made"):
        tiled_spmm(rowptr, col, None, x[:200], plan)
    with pytest.raises(ValueError, match="outside"):
        tiled_spmm_plan(rowptr, col, 280, T=128)
    for T in (16, 100, 2048):
        with pytest.raises(ValueError, match="power of two"):
            tiled_spmm_plan(rowptr, col, 300, T=T)


def test_tiled_spmm_plan_keeps_the_fullest_tiles_that_fit():
    """Tiles of 512 rows: one fits in a block's 113 KB with the slot
    table, so each row block keeps its pair with the most edges (the
    lower tile on a tie); a tile of 1024 rows does not fit."""
    rowptr = torch.tensor([0, 8] + [8] * 255 + [12], dtype=torch.int32)
    col = torch.tensor([1, 2, 1100, 1101, 1102, 2050, 2051, 2052,
                        10, 1030, 1031, 2999], dtype=torch.int32)
    wide = tiled_spmm_plan(rowptr, col, 3000, T=1024, stage_min=1)
    assert wide.n_pairs == 6 and wide.n_staged == wide.max_staged == 0
    assert wide.smem_bytes() == 0
    plan = tiled_spmm_plan(rowptr, col, 3000, T=512, stage_min=1)
    assert plan.n_pairs == 6 and plan.max_staged == 1
    assert plan.stage_tile.tolist() == [2, 2]
    assert plan.staged_edges == 3 + 2
    x = torch.randn(3000, 5)
    assert torch.equal(tiled_spmm(rowptr, col, None, x, plan),
                       csr_spmm_plain(rowptr, col, None, x))


@pytest.mark.parametrize("shape", [(), (3,)])
def test_segment_sum_csr_matches_jax_sorted_segment_sum(shape):
    rng = np.random.RandomState(72)
    counts = rng.randint(0, 6, 300)
    counts[::5] = 0                       # empty segments
    row = np.repeat(np.arange(300), counts)
    data = rng.randn(row.size, *shape).astype(np.float32)
    rowptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    ref = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(row), 300,
                              indices_are_sorted=True)
    d = torch.from_numpy(data).requires_grad_(True)
    got = segment_sum_csr(d, rowptr)
    assert got.shape == (300,) + shape
    assert rel_err(got, np.asarray(ref)) <= 1e-6
    assert not got[torch.from_numpy(counts == 0)].any()
    g = rng.randn(300, *shape).astype(np.float32)
    (grad,) = torch.autograd.grad(got, d, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda v: jax.ops.segment_sum(
        v, jnp.asarray(row), 300, indices_are_sorted=True), jnp.asarray(data))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(vjp(g)[0]))
    with pytest.raises(ValueError, match="rowptr"):
        segment_sum_csr(d[:-1], rowptr)


def test_device_time_returns_a_positive_slope_on_cpu():
    x = torch.randn(64, 64)
    per = device_time(lambda c, w: c @ w, x, x, n_lo=2, n_hi=6, repeats=2)
    assert per > 0


def test_probe_runs_on_cpu_with_its_checks():
    """``run`` end to end on small graphs (the plain versions): every
    check passes, and the verdict names each graph."""
    g = {"uniform": pts.testing.community_graph(
            600, 6000, n_comm=1, intra_p=0.0, seed=73, device="cpu"),
         "community hybrid": pts.testing.community_graph(
            800, 20_000, n_comm=4, seed=74, equal_sizes=True, device="cpu")}
    res = probe.run("cpu", g, repeats=1)
    assert res["failures"] == []
    assert res["verdict"]["big_table_gather"]
    assert set(res["verdict"]["graphs"]) == set(g)
    assert all(c["equal_k1"] for c in res["tiled"])
    assert [c["R"] for c in res["scan"]] == [1, 8, 40]


def test_probe_verdict_judges_only_staged_cases_and_calls_close_times_ties():
    """The verdict's staged SpMM is the fastest case that stages some
    edges (a faster case that stages none does not count), the walk with
    nothing staged is reported apart, and two times within ``TIE`` of the
    larger are a tie."""
    assert probe.compare(1.0, 1.0 + probe.TIE) == "ties with"
    assert probe.compare(1.0, 1.1) == "beats"
    assert probe.compare(1.1, 1.0) == "loses to"
    assert probe.compare(None, 1.0) is None
    lib = [1.0, 1.1, 1.0, 1.2, 1.0, 1.1, 1.0, 1.0, 1.1, 1.0]
    assert probe.compare_pairs([t - 0.3 for t in lib], lib) == "beats"
    assert probe.compare_pairs([t + 0.3 for t in lib], lib) == "loses to"
    assert probe.compare_pairs([t - 0.01 for t in lib], lib) == "ties with"
    assert probe.compare_pairs(lib[::-1], lib) == "ties with"

    def case(T, share, dev_ms, no_staging=False, values=True):
        return {"graph": "g", "T": T, "slab": 32, "values": values,
                "no_staging": no_staging, "staged_edge_share": share,
                "ms": dev_ms + 0.1, "device_ms": dev_ms, "k1_ms": 0.8,
                "k1_device_ms": 0.7, "library_ms": 1.2,
                "library_device_ms": 1.1, "smem_floor_ms": 0.1 * share}

    gather = [{"T": probe.T, "exact": True, "ms": 0.0140,
               "device_ms": 0.0043, "library_ms": 0.0138,
               "library_device_ms": 0.0025, "pairs_won": 4,
               "rounds_ms": [0.014] * 10,
               "library_rounds_ms": [0.0138, 0.0141] * 5}]
    tiled = [case(512, 0.0, 0.60), case(256, 0.4, 0.82),
             case(128, 0.6, 0.90), case(256, 0.4, 0.50, values=False),
             case(128, 0.0, 0.71, no_staging=True)]
    v = probe.verdict({"gather": gather, "tiled": tiled}, ["g"])
    g = v["graphs"]["g"]
    assert g["staged"]["T"] == 256 and g["staged"]["k1_device"] == "loses to"
    assert g["no_staging"]["k1_device"] == "ties with"
    assert g["no_staging"]["library_device"] == "beats"
    assert v["gather"]["library"] == "ties with"
    assert v["gather"]["library_device"] == "loses to"
    line = probe.verdict_line("card", v)
    assert "won 4" in line and "nothing staged" in line
    v = probe.verdict({"gather": gather, "tiled": [tiled[0], tiled[-1]]},
                      ["g"])
    assert v["graphs"]["g"]["staged"] is None
    assert "stages no edge" in probe.verdict_line("card", v)


@pytest.mark.parametrize("fn", ["smem_gather", "edge_scan_loop",
                                "tiled_spmm"])
def test_wrappers_raise_off_cpu_and_cuda(fn):
    meta = torch.device("meta")
    h = torch.empty((8, 4), device=meta)
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        if fn == "smem_gather":
            smem_gather(torch.zeros(3, dtype=torch.int32, device=meta), h)
        elif fn == "edge_scan_loop":
            edge_scan_loop(h, 2)
        else:
            rowptr = torch.zeros(9, dtype=torch.int32)
            col = torch.zeros(0, dtype=torch.int32)
            plan = tiled_spmm_plan(rowptr, col, 8, T=32)
            tiled_spmm(rowptr.to(meta), col.to(meta), None, h, plan)
