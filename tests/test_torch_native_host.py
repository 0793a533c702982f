"""The port's host Gustavson SpGEMM (``csrc/host_spgemm.cpp``), its host
sorts (torch's stable sort past 32,768 keys) and its coalesce against
the JAX package's native library, whose ``bindings`` load by default
here.

Every output is held equal bit for bit: the SpGEMM (each entry summed in
float64 in the same order, then cast; at 1 and 4 OpenMP threads and from
a build without OpenMP), the sorts (stable, so also equal to numpy's)
and the storage paths built on them (construction, ``is_coalesced``,
``coalesce``, ``add``, whose sums follow the library's left-to-right
order), on both sides of the 32,768-edge crossover.  The JAX package is
steered only in-process (``monkeypatch``).
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.csrc import bindings as jb
from pytorch_sparse_tpu.ops import spgemm as jspgemm
from pytorch_sparse_tpu.utils import host_sort as jhs
from pytorch_sparse_tpu_torch import _build
from pytorch_sparse_tpu_torch import storage as pstorage
from pytorch_sparse_tpu_torch.ops import spgemm as pspgemm
from pytorch_sparse_tpu_torch.testing import community_graph
from pytorch_sparse_tpu_torch.utils import _native as pn
from pytorch_sparse_tpu_torch.utils import host_sort as phs

ROOT = Path(__file__).resolve().parents[1]
CROSS = phs._TORCH_MIN
assert CROSS == pstorage._ORDERED_SUM_MIN == jhs._NATIVE_MIN
JDT = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}
PDT = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def _bits(a) -> np.ndarray:
    """The raw bits of a float array (numpy, JAX or torch)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        a = a.numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.itemsize])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _dup_coo(E, M=40, N=30, seed=0, shape=(), dtype=np.float32):
    """E edges on an M x N grid (about E / (M N) duplicates a key)."""
    rng = np.random.RandomState(seed)
    val = rng.randn(E, *shape).astype(dtype)
    return rng.randint(0, M, E), rng.randint(0, N, E), val


# ---------------------------------------------------------------------
# Coalesce and add: JAX's summation order
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(), (3,)])
@pytest.mark.parametrize("E", [20_000, 60_000])
@pytest.mark.parametrize("reduce", ["add", "sum", "mean", "min", "max"])
def test_coalesce_bits_equal_jax(reduce, E, shape, dtype):
    """``coalesce`` reduces host float values as the JAX package does:
    from 32,768 edges up its library's left-to-right sweep (about 16-50
    duplicates a key here), numpy's ``reduceat`` below."""
    row, col, val = _dup_coo(E, shape=shape, dtype=dtype)
    if reduce in ("min", "max"):
        val[::97] = np.nan
    with jax.enable_x64(dtype == np.float64):
        Jc = jts.SparseTensor(row=row, col=col, value=val,
                              sparse_sizes=(40, 30)).coalesce(reduce)
        jv = np.asarray(Jc.storage.value())
    P = pts.SparseTensor(row=row, col=col, value=torch.from_numpy(val),
                         sparse_sizes=(40, 30), device="cpu")
    Pc = P.coalesce(reduce)
    np.testing.assert_array_equal(Pc.storage.numpy_view("row"),
                                  np.asarray(Jc.storage.row()))
    np.testing.assert_array_equal(Pc.storage.numpy_view("col"),
                                  np.asarray(Jc.storage.col()))
    assert jv.dtype == dtype
    assert Pc.storage.value().shape == jv.shape == (1200,) + shape
    np.testing.assert_array_equal(_bits(Pc.storage.value()), _bits(jv))


@pytest.mark.parametrize("E", [2_000, 60_000])
def test_coalesce_bfloat16_sums_once_reference_defect(E):
    """bfloat16 duplicates: the JAX package's numpy ``reduceat`` rounds
    every partial sum to bfloat16 (both sides of the crossover: its
    library takes float32/float64 only); the port sums in float32 and
    rounds once, which is nearer the float64 sum."""
    row, col, val = _dup_coo(E, seed=5)
    vb = torch.from_numpy(val).to(torch.bfloat16)
    jv = np.asarray(jts.SparseTensor(
        row=row, col=col, value=jnp.asarray(val).astype(jnp.bfloat16),
        sparse_sizes=(40, 30)).coalesce().storage.value()).astype(np.float64)
    P = pts.SparseTensor(row=row, col=col, value=vb, sparse_sizes=(40, 30),
                         device="cpu").coalesce()
    pv = P.storage.value().double().numpy()
    key = row * 30 + col
    exact = np.bincount(key, weights=vb.double().numpy(),
                        minlength=1200)[np.unique(key)]
    once = torch.from_numpy(exact.astype(np.float32)).to(
        torch.bfloat16).double().numpy()
    np.testing.assert_array_equal(pv, once)
    assert (jv != pv).sum() > 10
    assert np.abs(pv - exact).sum() < np.abs(jv - exact).sum()


@pytest.mark.parametrize("E", [20_000, 40_000])
def test_add_bits_equal_jax(E):
    """``add(A, B)`` concatenates and coalesces: its sums follow JAX's."""
    row, col, val = _dup_coo(2 * E, seed=1)
    sides = [slice(0, E), slice(E, 2 * E)]
    J = [jts.SparseTensor(row=row[s], col=col[s], value=val[s],
                          sparse_sizes=(40, 30)) for s in sides]
    P = [pts.SparseTensor(row=row[s], col=col[s],
                          value=torch.from_numpy(val[s]),
                          sparse_sizes=(40, 30), device="cpu") for s in sides]
    got, want = pts.add(*P), jts.add(*J)
    np.testing.assert_array_equal(got.storage.numpy_view("col"),
                                  np.asarray(want.storage.col()))
    np.testing.assert_array_equal(_bits(got.storage.value()),
                                  _bits(want.storage.value()))


def _negative_zero_coo(E=60_000, seed=8, shape=()):
    """``_dup_coo`` float32 edges whose runs of duplicates are, by key,
    all -0.0 (a seventh of the keys), -0.0 and +0.0 mixed (another
    seventh), or random normals."""
    row, col, val = _dup_coo(E, seed=seed, shape=shape)
    key = (row * 30 + col) % 7
    val[key == 0] = -0.0
    mixed = key == 1
    val[mixed] = np.where(np.arange(E)[mixed] % 2, 0.0, -0.0)[
        (slice(None),) + (None,) * len(shape)]
    return row, col, val


@pytest.mark.parametrize("shape", [(), (3,)])
def test_coalesce_negative_zero_runs_equal_jax(shape):
    """A run of duplicates whose every value is -0.0 sums to -0.0, as in
    the JAX package's library (each sum starts from the run's first
    value); a run that mixes -0.0 and +0.0 sums to +0.0 in both."""
    row, col, val = _negative_zero_coo(shape=shape)
    jv = np.asarray(jts.SparseTensor(
        row=row, col=col, value=val,
        sparse_sizes=(40, 30)).coalesce().storage.value())
    pv = pts.SparseTensor(row=row, col=col, value=torch.from_numpy(val),
                          sparse_sizes=(40, 30),
                          device="cpu").coalesce().storage.value()
    zeros = np.signbit(jv[jv == 0])
    assert zeros.any() and not zeros.all()
    np.testing.assert_array_equal(_bits(pv), _bits(jv))


def test_add_negative_zero_runs_equal_jax():
    """``add(A, B)`` of two halves of those edges: JAX's bits, -0.0 runs
    included."""
    row, col, val = _negative_zero_coo(E=2 * 30_000, seed=9)
    sides = [slice(0, 30_000), slice(30_000, 60_000)]
    J = [jts.SparseTensor(row=row[s], col=col[s], value=val[s],
                          sparse_sizes=(40, 30)) for s in sides]
    P = [pts.SparseTensor(row=row[s], col=col[s],
                          value=torch.from_numpy(val[s]),
                          sparse_sizes=(40, 30), device="cpu") for s in sides]
    got, want = pts.add(*P), jts.add(*J)
    wv = np.asarray(want.storage.value())
    assert np.signbit(wv[wv == 0]).any()
    np.testing.assert_array_equal(_bits(got.storage.value()),
                                  _bits(want.storage.value()))


@pytest.mark.parametrize("reduce", ["add", "mean", "min", "max"])
def test_coalesce_grad_values_past_the_crossover(reduce):
    """Values that require grad reduce on the device past the crossover
    too (Runs for sums, ``segment_min``/``segment_max``) and keep their
    gradient."""
    row, col, val = _dup_coo(50_000, seed=2)
    v = torch.from_numpy(val).requires_grad_(True)
    P = pts.SparseTensor(row=row, col=col, value=v, sparse_sizes=(40, 30),
                         device="cpu")
    out = P.coalesce(reduce).storage.value()
    plain = P.set_value(P.storage.value().detach(),
                        layout="coo").coalesce(reduce)
    assert out.requires_grad
    torch.testing.assert_close(out.detach(), plain.storage.value(),
                               rtol=1e-5, atol=1e-5)
    (g,) = torch.autograd.grad(out.sum(), v)
    assert g.shape == v.shape and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("E", [20_000, 60_000])
def test_is_coalesced_matches_jax(E):
    row, col, val = _dup_coo(E, M=400, N=300, seed=3)
    J = jts.SparseTensor(row=row, col=col, sparse_sizes=(400, 300))
    P = pts.SparseTensor(row=row, col=col, sparse_sizes=(400, 300),
                         device="cpu")
    assert P.is_coalesced() == J.is_coalesced() is False
    assert P.coalesce().is_coalesced() and J.coalesce().is_coalesced()


# ---------------------------------------------------------------------
# Construction: torch's sort past the crossover
# ---------------------------------------------------------------------

@pytest.mark.parametrize("value", ["none", "f32", "f64", "f16", "tensor",
                                   "grad", "2d"])
@pytest.mark.parametrize("E", [1_000, 50_000])
def test_construction_matches_jax(value, E):
    """The canonical sort gives JAX's indices, values and ``csr2csc``;
    values are gathered by its permutation (a tensor keeps its
    gradient)."""
    rng = np.random.RandomState(4)
    M, N = 700, 500
    row, col = rng.randint(0, M, E), rng.randint(0, N, E)
    base = rng.randn(E, *((2,) if value == "2d" else ())).astype(np.float32)
    vals = {"none": (None, None), "f32": (base, base),
            "f64": (base.astype(np.float64),) * 2,
            "f16": (base.astype(np.float16),) * 2, "2d": (base, base),
            "tensor": (torch.from_numpy(base), base),
            "grad": (torch.from_numpy(base).requires_grad_(True), base)}
    pv, jv = vals[value]
    P = pts.SparseTensor(row=row, col=col, value=pv, sparse_sizes=(M, N),
                         device="cpu")
    with jax.enable_x64(value == "f64"):
        J = jts.SparseTensor(row=row, col=col, value=jv, sparse_sizes=(M, N))
        jvalue = None if jv is None else np.asarray(J.storage.value())
    np.testing.assert_array_equal(P.storage.numpy_view("row"),
                                  np.asarray(J.storage.row()))
    np.testing.assert_array_equal(P.storage.numpy_view("col"),
                                  np.asarray(J.storage.col()))
    np.testing.assert_array_equal(P.storage.numpy_view("csr2csc"),
                                  np.asarray(J.storage.csr2csc()))
    if pv is None:
        assert P.storage.value() is None
        return
    got = P.storage.value()
    assert got.requires_grad == (value == "grad")
    assert _host(got).dtype == jvalue.dtype
    np.testing.assert_array_equal(_bits(got), _bits(jvalue))


def _spy_torch_sort(monkeypatch):
    calls = []
    real = phs.index_sort
    monkeypatch.setattr(phs, "index_sort",
                        lambda t: calls.append(t.shape[0]) or real(t))
    return calls


def test_construction_takes_torch_sort_only_past_the_crossover(monkeypatch):
    calls = _spy_torch_sort(monkeypatch)
    rng = np.random.RandomState(5)
    for E in (CROSS - 1, CROSS):
        pts.SparseTensor(row=rng.randint(0, 90, E), col=rng.randint(0, 90, E),
                         device="cpu")
        pts.SparseTensor(row=rng.randint(0, 90, E), col=rng.randint(0, 90, E),
                         trust_data=True, device="cpu")
    assert calls == [CROSS, CROSS]


# ---------------------------------------------------------------------
# The sorts: numpy's order, JAX's dispatch
# ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 1000, CROSS, 200_001])
@pytest.mark.parametrize("hi", [1, 3, 2**17, 2**34, 2**63])
def test_stable_argsort_matches_numpy_and_jax(n, hi):
    rng = np.random.RandomState(n % 7 + hi % 5)
    keys = rng.randint(0, hi, n, dtype=np.int64)
    want = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(phs.stable_argsort(keys), want)
    np.testing.assert_array_equal(jhs.stable_argsort(keys), want)


@pytest.mark.parametrize("keys", ["uint64", "negative", "int32"])
def test_stable_argsort_dtypes(keys):
    rng = np.random.RandomState(6)
    k = {"uint64": rng.randint(0, 2**63, 50_000, dtype=np.int64)
         .astype(np.uint64) * np.uint64(2),
         "negative": np.array([3, -1, 2, -5] * 20_000, np.int64),
         "int32": rng.randint(0, 1000, 50_000).astype(np.int32)}[keys]
    want = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(phs.stable_argsort(k), want)
    np.testing.assert_array_equal(jhs.stable_argsort(k), want)


@pytest.mark.parametrize("n", [0, 1, 1000, 40_000, 150_000])
@pytest.mark.parametrize("m", [1, 2, 97, 100_000])
@pytest.mark.parametrize("hint", [False, True])
def test_lexsort2_matches_numpy_and_jax(n, m, hint):
    rng = np.random.RandomState(3)
    row = rng.randint(0, m, n).astype(np.int64)
    col = rng.randint(0, m, n).astype(np.int64)
    rng_ = m if hint else None
    want = np.lexsort((col, row))
    np.testing.assert_array_equal(phs.lexsort2(row, col, rng_), want)
    np.testing.assert_array_equal(jhs.lexsort2(row, col, rng_), want)
    perm, rs, cs = phs.lexsort2_decode(row, col, rng_)
    jperm, jrs, jcs = jhs.lexsort2_decode(row, col, rng_)
    for a, b in ((perm, want), (rs, row[want]), (cs, col[want]),
                 (jperm, want), (jrs, rs), (jcs, cs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["past_2_63", "past_2_64", "int32",
                                  "uint64", "all_ties"])
def test_lexsort2_key_ranges(case, monkeypatch):
    """A combined key past 2**63 takes numpy's lexsort (torch sorts int64
    keys; the JAX package's library takes keys to 2**64); the others
    torch's sort; int32 pairs decode to int32."""
    rng = np.random.RandomState(7)
    n = 50_000
    if case == "past_2_63":
        row = rng.randint(0, 2**40, n)
        row[0] = 2**40 - 1
        col, srange = rng.randint(0, 2**23, n), 2**24
    elif case == "past_2_64":
        row, col, srange = rng.randint(0, 2**41, n), rng.randint(0, 2**23, n), \
            2**24
        row[0] = 2**41 - 1
    elif case == "int32":
        row = rng.randint(0, 40, n).astype(np.int32)
        col, srange = rng.randint(0, 40, n).astype(np.int32), None
    elif case == "uint64":
        row = rng.randint(0, 2**40, n).astype(np.uint64)
        col, srange = rng.randint(0, 2**20, n).astype(np.uint64), 2**20
    else:
        row, col, srange = np.zeros(n, np.int64), np.zeros(n, np.int64), None
    calls = _spy_torch_sort(monkeypatch)
    want = np.lexsort((col, row))
    perm, rs, cs = phs.lexsort2_decode(row, col, srange)
    assert len(calls) == (0 if case.startswith("past") else 1)
    np.testing.assert_array_equal(perm, want)
    np.testing.assert_array_equal(rs, row[want])
    np.testing.assert_array_equal(cs, col[want])
    assert rs.dtype == row.dtype and cs.dtype == col.dtype
    np.testing.assert_array_equal(jhs.lexsort2(row, col, srange), want)


@pytest.mark.parametrize("idx", [np.int64, np.int32, "mixed"])
@pytest.mark.parametrize("n,m", [(0, 5), (1, 5), (1000, 9), (50_000, 40),
                                 (200_001, 300)])
def test_coalesce_equals_the_jax_sweeps(n, m, idx):
    """The port's ``is_coalesced`` and ``coalesce`` of sorted COO against
    the JAX package's sweeps: ``sorted_has_dup``, the indices of
    ``coalesce_fill`` and, past the crossover, the bits of
    ``segment_reduce_val`` in every mode (min/max keeping a NaN)."""
    rng = np.random.RandomState(n % 13 + m % 7)
    row = np.sort(rng.randint(0, m, n))
    col = rng.randint(0, m, n)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    if idx == "mixed":
        row = row.astype(np.int32)
    else:
        row, col = row.astype(idx), col.astype(idx)
    row_j, col_j, starts, _ = jb.coalesce_fill(row, col)
    for mode in ("sum", "add", "mean", "min", "max"):
        for shape, dt in (((), np.float32), ((4,), np.float64)):
            v = rng.randn(n, *shape).astype(dt)
            v[::31] = np.nan if mode in ("min", "max") else v[::31]
            P = pts.SparseTensor(row=row, col=col, value=torch.from_numpy(v),
                                 sparse_sizes=(m, m), device="cpu")
            assert P.is_coalesced() == (not jb.sorted_has_dup(row, col))
            C = P.coalesce(mode)
            np.testing.assert_array_equal(C.storage.numpy_view("row"), row_j)
            np.testing.assert_array_equal(C.storage.numpy_view("col"), col_j)
            if n >= CROSS:
                np.testing.assert_array_equal(
                    _bits(C.storage.value()),
                    _bits(jb.segment_reduce_val(v, starts, mode)))


# ---------------------------------------------------------------------
# The Gustavson SpGEMM
# ---------------------------------------------------------------------

def _sp_pair(case, seed=1):
    """(M, N, P, coo A, coo B, dtype, values of A, values of B)."""
    rng = np.random.RandomState(seed)
    M, N, P = 70, 60, 55
    # Unique keys: the two packages coalesce bfloat16 duplicates in other
    # precisions, which is not what these cases hold.
    ka = np.unique(rng.randint(0, M * N, 700))
    kb = np.unique(rng.randint(0, N * P, 500))
    ra, ca = ka // N, ka % N
    rb, cb = kb // P, kb % P
    if case == "empty_rows":
        keep = ra % 3 != 0
        ra, ca = ra[keep], ca[keep]
        keep = rb % 4 != 1
        rb, cb = rb[keep], cb[keep]
    va = rng.randn(ra.shape[0]).astype(np.float32)
    vb = rng.randn(rb.shape[0]).astype(np.float32)
    dt = {"f64": "f64", "bf16": "bf16"}.get(case, "f32")
    if case == "a_ones":
        va = None
    if case == "b_ones":
        vb = None
    if case == "ones":
        va = vb = None
    return (M, N, P, (ra, ca), (rb, cb), dt, va, vb)


def _both(M, N, coo, v, dt):
    """A JAX and a port SparseTensor of one matrix (unique keys)."""
    with jax.enable_x64(dt == "f64"):
        J = jts.SparseTensor(
            row=coo[0], col=coo[1], sparse_sizes=(M, N),
            value=None if v is None else jnp.asarray(v).astype(JDT[dt]))
    P = pts.SparseTensor(
        row=coo[0], col=coo[1], sparse_sizes=(M, N), device="cpu",
        value=None if v is None else torch.from_numpy(v).to(PDT[dt]))
    return J, P


@pytest.mark.parametrize("case", ["f32", "f64", "bf16", "a_ones", "b_ones",
                                  "ones", "empty_rows"])
def test_spspmm_native_bits_equal_jax(case):
    M, N, P, ca, cb, dt, va, vb = _sp_pair(case)
    Ja, Pa = _both(M, N, ca, va, dt)
    Jb, Pb = _both(N, P, cb, vb, dt)
    C = pts.spspmm_native(Pa, Pb)
    with jax.enable_x64(dt == "f64"):
        Jc = jts.spspmm_native(Ja, Jb)
        jv = None if case == "ones" else np.asarray(Jc.storage.value())
    np.testing.assert_array_equal(C.storage.numpy_view("rowptr"),
                                  np.asarray(Jc.storage.rowptr()))
    np.testing.assert_array_equal(C.storage.numpy_view("col"),
                                  np.asarray(Jc.storage.col()))
    if case == "ones":
        assert C.storage.value() is None and Jc.storage.value() is None
        return
    got = C.storage.value()
    assert got.dtype == PDT[dt] and not got.requires_grad
    np.testing.assert_array_equal(_bits(got), _bits(jv))


def test_spspmm_native_community_square_takes_both_fill_branches():
    """A community graph squared has dense product rows (``cnt * 12 >=
    P``, the ordered scan) beside sparse ones (the sorted columns)."""
    A = community_graph(600, 6000, 3, seed=9, device="cpu")
    # A chain over 100 more nodes: its product rows hold one entry each.
    row = np.concatenate([A.storage.numpy_view("row"), np.arange(600, 699)])
    col = np.concatenate([A.storage.numpy_view("col"), np.arange(601, 700)])
    v = np.random.RandomState(10).rand(row.size).astype(np.float32)
    Pa = pts.SparseTensor(row=row, col=col, value=torch.from_numpy(v),
                          sparse_sizes=(700, 700), device="cpu")
    Ja = jts.SparseTensor(row=row, col=col, value=v, sparse_sizes=(700, 700))
    C = pts.spspmm_native(Pa, Pa)
    Jc = jts.spspmm_native(Ja, Ja)
    cnt = np.diff(C.storage.numpy_view("rowptr"))
    assert (cnt * 12 >= 700).sum() > 100
    assert ((cnt > 0) & (cnt * 12 < 700)).sum() >= 98
    np.testing.assert_array_equal(C.storage.numpy_view("col"),
                                  np.asarray(Jc.storage.col()))
    np.testing.assert_array_equal(_bits(C.storage.value()),
                                  _bits(Jc.storage.value()))


@pytest.mark.parametrize("count_only", [False, True])
@pytest.mark.parametrize("rows", [(0, None), (5, 40), (69, 70), (30, 30)])
def test_spgemm_row_ranges_equal_jax(rows, count_only):
    M, N, P, ca, cb, dt, va, vb = _sp_pair("empty_rows", seed=2)
    _, Pa = _both(M, N, ca, va, dt)
    _, Pb = _both(N, P, cb, vb, dt)
    args = (Pa.storage.numpy_view("rowptr"), Pa.storage.numpy_view("col"),
            Pa.storage.value().numpy(), Pb.storage.numpy_view("rowptr"),
            Pb.storage.numpy_view("col"), Pb.storage.value().numpy(), P)
    got = pn.spgemm(*args, row_lo=rows[0], row_hi=rows[1],
                    count_only=count_only)
    want = jb.spgemm(*args, row_lo=rows[0], row_hi=rows[1],
                     count_only=count_only)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        np.testing.assert_array_equal(_bits(a) if a.dtype.kind == "f" else a,
                                      _bits(b) if b.dtype.kind == "f" else b)


def test_spgemm_checks_its_arguments():
    rp, col = np.array([0, 1, 2]), np.array([1, 0])
    with pytest.raises(ValueError):
        pn.spgemm(rp, col, None, rp, col, None, 2, row_lo=1, row_hi=3)
    with pytest.raises(ValueError):
        pn.spgemm(rp, np.array([1, 5]), None, rp, col, None, 2)
    with pytest.raises(ValueError):
        pn.spgemm(np.array([0, 1, 3]), col, None, rp, col, None, 2)
    with pytest.raises(ValueError):
        pn.spgemm(rp, col, np.ones(3), rp, col, None, 2)


def test_float64_to_bfloat16_rounds_as_ml_dtypes():
    """The product's float64 sums reach bfloat16 through torch's cast, as
    they reach it through ml_dtypes' ``astype`` in the JAX package: both
    round through float32, so a sum just above a bfloat16 midpoint rounds
    to even, not up."""
    rng = np.random.RandomState(11)
    b = rng.randn(50_000).astype(ml_dtypes.bfloat16)
    up = (b.view(np.uint16) + 1).view(ml_dtypes.bfloat16)
    mid = (b.astype(np.float64) + up.astype(np.float64)) / 2
    for x in (mid, mid * (1 + 2.0**-40), mid * (1 - 2.0**-40), rng.randn(999)):
        np.testing.assert_array_equal(
            _bits(torch.from_numpy(x).to(torch.bfloat16)),
            _bits(x.astype(ml_dtypes.bfloat16)))


def test_spspmm_native_int32_rowptr_reference_defect(monkeypatch):
    """The JAX package casts the library's ``rowptrC`` and ``colC`` to
    int32 (``ops/spgemm.py:144-146``), which wraps past 2**31 entries; the
    port keeps the library's int64 host arrays.  A library result of
    2**31 + 1 entries in row 0 (faked: no host holds one here) shows
    both."""
    fake = (np.array([0, 2**31 + 1, 2**31 + 1]), np.array([0, 1]), None)
    monkeypatch.setattr(jb, "spgemm", lambda *a, **k: fake)
    monkeypatch.setattr(pn, "spgemm", lambda *a, **k: fake)
    J = jts.SparseTensor(row=np.array([0, 1]), col=np.array([1, 0]),
                         sparse_sizes=(2, 2))
    P = pts.SparseTensor(row=np.array([0, 1]), col=np.array([1, 0]),
                         sparse_sizes=(2, 2), device="cpu")
    jrp = np.asarray(jts.spspmm_native(J, J).storage.rowptr())
    assert jrp.dtype == np.int32 and jrp[1] == -(2**31) + 1
    prp = pts.spspmm_native(P, P).storage.numpy_view("rowptr")
    assert prp.dtype == np.int64 and prp[1] == 2**31 + 1


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("shape", [(3000, 2500, 2800), (2800, 2500, 3000)])
def test_spspmm_diag_past_the_crossover_equals_jax(shape, weighted):
    """``spspmm_diag`` searches its queries in sorted order (torch's sort
    past the crossover): JAX's hits, sums and bits."""
    M, N, P = shape
    rng = np.random.RandomState(17)
    coo = []
    for (m, n), e in (((M, N), 60_000), ((N, P), 50_000)):
        keys = np.unique(rng.randint(0, m * n, e))
        coo.append((keys // n, keys % n))
    # Reciprocate a third of A's entries in B so that the diagonal fills.
    ra, ca = coo[0]
    back = (ca < N) & (ra < P)
    coo[1] = (np.concatenate([coo[1][0], ca[back][::3]]),
              np.concatenate([coo[1][1], ra[back][::3]]))
    mats = []
    for (m, n), (r, c) in zip(((M, N), (N, P)), coo):
        k = np.unique(r * n + c)
        v = (rng.randn(k.size).astype(np.float32) if weighted else None)
        mats.append(_both(m, n, (k // n, k % n), v, "f32"))
    (Ja, Pa), (Jb, Pb) = mats
    assert Pa.nnz() >= CROSS
    got = pts.spspmm_diag(Pa, Pb)
    want = np.asarray(jts.spspmm_diag(Ja, Jb))
    assert got.shape == want.shape == (min(M, P),) and (want != 0).sum() > 1000
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_reddit_graph_is_the_pipeline_graph():
    """``chip_smoke.reddit_graph`` (phase 21's graph) draws what the JAX
    package's ``benchmarks/reddit_pipeline.py`` ``build_graph`` draws."""
    import importlib.util

    sys.path.insert(0, str(ROOT))
    from chip_smoke import reddit_graph

    spec = importlib.util.spec_from_file_location(
        "reddit_pipeline", ROOT / "benchmarks" / "reddit_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for got, want in zip(reddit_graph(0.01), mod.build_graph(0.01)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------
# Dispatch: spspmm_large and spspmm_stream
# ---------------------------------------------------------------------

def _spy(monkeypatch):
    calls = []
    real = pn.spgemm
    monkeypatch.setattr(pn, "spgemm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("mode", ["values", "grad", "no_grad", "ones"])
def test_large_dispatch_rule(mode, monkeypatch):
    """Native unless a value requires grad while grad is enabled; then
    the chunked plan, whose product is differentiable."""
    M, N, P, ca, cb, dt, va, vb = _sp_pair("ones" if mode == "ones"
                                           else "f32", seed=3)
    Ja, Pa = _both(M, N, ca, va, dt)
    Jb, Pb = _both(N, P, cb, vb, dt)
    if mode in ("grad", "no_grad"):
        Pa = Pa.set_value(Pa.storage.value().clone().requires_grad_(True),
                          layout="coo")
    calls = _spy(monkeypatch)
    monkeypatch.setattr(pspgemm, "PLAN_MAX_TERMS", 100)
    monkeypatch.setattr(jspgemm, "PLAN_MAX_TERMS", 100)
    if mode == "no_grad":
        with torch.no_grad():
            C = Pa @ Pb
    else:
        C = Pa @ Pb
    Jc = Ja @ Jb
    assert len(calls) == (0 if mode == "grad" else 1)
    np.testing.assert_array_equal(C.storage.numpy_view("col"),
                                  np.asarray(Jc.storage.col()))
    if mode == "ones":
        assert C.storage.value() is None
        return
    assert C.storage.value().requires_grad == (mode == "grad")
    if mode != "grad":
        np.testing.assert_array_equal(_bits(C.storage.value()),
                                      _bits(Jc.storage.value()))


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("case", ["f32", "bf16", "a_ones", "ones"])
def test_stream_native_branch_equals_jax(case, raw, monkeypatch):
    """The stream's native blocks equal JAX's; raw triples carry the
    promoted dtype (float32 for bfloat16) where JAX's carry float64 (the
    rule the plan branch keeps), holding JAX's sums cast to it."""
    M, N, P, ca, cb, dt, va, vb = _sp_pair(case, seed=4)
    Ja, Pa = _both(M, N, ca, va, dt)
    Jb, Pb = _both(N, P, cb, vb, dt)
    calls = _spy(monkeypatch)
    got = list(pts.spspmm_stream(Pa, Pb, max_terms=300, raw=raw))
    want = list(jts.spspmm_stream(Ja, Jb, max_terms=300, raw=raw))
    assert len(got) == len(want) == len(calls) > 1
    for (lo, hi, g), (jlo, jhi, w) in zip(got, want):
        assert (lo, hi) == (jlo, jhi)
        if raw:
            (rp, col, v), (jrp, jcol, jv) = g, w
            np.testing.assert_array_equal(rp, jrp)
            np.testing.assert_array_equal(col, jcol)
            if case == "ones":
                assert v is None and jv is None
                continue
            assert jv.dtype == np.float64 and v.dtype == np.float32
            cast = torch.from_numpy(jv).to(PDT[dt]).float().numpy()
            np.testing.assert_array_equal(_bits(v), _bits(cast))
            continue
        np.testing.assert_array_equal(g.storage.numpy_view("rowptr"),
                                      np.asarray(w.storage.rowptr()))
        np.testing.assert_array_equal(g.storage.numpy_view("col"),
                                      np.asarray(w.storage.col()))
        if case == "ones":
            assert g.storage.value() is None
        else:
            np.testing.assert_array_equal(_bits(g.storage.value()),
                                          _bits(w.storage.value()))


def test_stream_takes_the_plan_for_values_that_require_grad(monkeypatch):
    M, N, P, ca, cb, dt, va, vb = _sp_pair("f32", seed=5)
    _, Pa = _both(M, N, ca, va, dt)
    _, Pb = _both(N, P, cb, vb, dt)
    Pg = Pa.set_value(Pa.storage.value().clone().requires_grad_(True),
                      layout="coo")
    calls = _spy(monkeypatch)
    plan = list(pts.spspmm_stream(Pg, Pb, max_terms=300))
    assert not calls and plan[0][2].storage.value().requires_grad
    native = list(pts.spspmm_stream(Pa, Pb, max_terms=300))
    assert len(calls) == len(native) == len(plan)
    for (_, _, a), (_, _, b) in zip(plan, native):
        np.testing.assert_array_equal(a.storage.numpy_view("col"),
                                      b.storage.numpy_view("col"))
        torch.testing.assert_close(a.storage.value().detach(),
                                   b.storage.value(), rtol=1e-6, atol=1e-6)


def test_stream_device_cross_terms_take_native(monkeypatch):
    """``spspmm_stream_device`` reaches the native branch for its cross
    terms through ``spspmm_stream``, and its pieces still add up to the
    product."""
    A = community_graph(512, 40_000, 8, seed=12, equal_sizes=True,
                        device="cpu")
    A = A.set_value(torch.from_numpy(np.random.RandomState(13).rand(
        A.nnz()).astype(np.float32)), layout="coo")
    calls = _spy(monkeypatch)
    pieces = list(pts.spspmm_stream_device(A, A, Bb=64, min_density=0.05))
    kinds = [p[0] for p in pieces]
    assert "blocks" in kinds and "coo" in kinds and calls
    assert sum(p[3].nnz() for p in pieces if p[0] == "coo") > 0
    dense = np.zeros((512, 512))
    for p in pieces:
        if p[0] == "blocks":
            _, rows, cols, blk = p
            for r, c, b in zip(rows, cols, blk):
                dense[r * 64:(r + 1) * 64, c * 64:(c + 1) * 64] += \
                    b.double().numpy()
        else:
            _, lo, hi, blk = p
            dense[lo:hi] += blk.to_dense().double().numpy()
    S = A.to_scipy(layout="csr").astype(np.float64)
    ref = (S @ S).toarray()
    assert np.abs(dense - ref).max() <= 1e-5 * np.abs(ref).max()


# ---------------------------------------------------------------------
# Thread counts and the build without OpenMP
# ---------------------------------------------------------------------

_SUITE = (
    "import numpy as np, sys\n"
    "from pytorch_sparse_tpu_torch.utils import _native as pn\n"
    "d = np.load(sys.argv[1])\n"
    "np.savez(sys.argv[2], *[pn.spgemm(d['rp'], d['ci'], d['vv'], d['rp'],\n"
    "                                  d['ci'], d['vv'], 600)[i]\n"
    "                        for i in range(3)])\n")


def _suite_inputs():
    A = community_graph(600, 30_000, 3, seed=15, device="cpu")
    return dict(rp=A.storage.numpy_view("rowptr"),
                ci=A.storage.numpy_view("col"),
                vv=np.random.RandomState(14).rand(A.nnz()))


def _jax_suite(d):
    return list(jb.spgemm(d["rp"], d["ci"], d["vv"], d["rp"], d["ci"],
                          d["vv"], 600))


def test_outputs_do_not_depend_on_the_thread_count():
    """The SpGEMM gives JAX's bits at 1 and at 4 OpenMP threads."""
    d = _suite_inputs()
    want = _jax_suite(d)
    _build.build(["host_spgemm"])
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.npz")
        np.savez(src, **d)
        for threads in ("1", "4"):
            dst = os.path.join(tmp, f"out{threads}.npz")
            env = dict(os.environ, OMP_NUM_THREADS=threads,
                       PYTHONPATH=str(ROOT))
            subprocess.run([sys.executable, "-c", _SUITE, src, dst],
                           env=env, cwd=ROOT, check=True)
            with np.load(dst) as f:
                got = [f[f"arr_{i}"] for i in range(len(f.files))]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(_bits(a) if a.dtype.kind == "f"
                                              else a,
                                              _bits(b) if b.dtype.kind == "f"
                                              else b)


def test_host_libraries_build_without_openmp(monkeypatch, tmp_path):
    """A compiler that cannot build OpenMP code builds the SpGEMM without
    ``-fopenmp``: the serial rows give JAX's bits."""
    cxx = tmp_path / "c++-without-openmp"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do\n  if [ "$a" = -fopenmp ]; '
                   'then echo "cannot read spec file libgomp.spec" >&2; '
                   'exit 1; fi\ndone\nexec c++ "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    _build.host_flags.cache_clear()
    try:
        assert "-fopenmp" not in _build.host_flags()
        d = _suite_inputs()
        got = list(pn.spgemm(d["rp"], d["ci"], d["vv"], d["rp"], d["ci"],
                             d["vv"], 600))
        for a, b in zip(got, _jax_suite(d)):
            np.testing.assert_array_equal(_bits(a) if a.dtype.kind == "f"
                                          else a,
                                          _bits(b) if b.dtype.kind == "f"
                                          else b)
        assert list((tmp_path / "build").glob("host_spgemm-*.so"))
    finally:
        _build.host_flags.cache_clear()


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """No numpy fallback: without a compiler ``spspmm_native`` and the
    products past the plan's limit raise; the sorts need no compiler."""
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(pspgemm, "PLAN_MAX_TERMS", 100)
    keys = np.arange(CROSS, dtype=np.int64)[::-1].copy()
    np.testing.assert_array_equal(phs.stable_argsort(keys), keys)
    M, N, P, ca, cb, dt, va, vb = _sp_pair("f32", seed=6)
    _, Pa = _both(M, N, ca, va, dt)
    _, Pb = _both(N, P, cb, vb, dt)
    with pytest.raises(RuntimeError, match="compiler"):
        pts.spspmm_native(Pa, Pb)
    with pytest.raises(RuntimeError, match="compiler"):
        Pa @ Pb
