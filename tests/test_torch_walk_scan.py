"""K12 (``random_walk``) and K13b (``edge_scan_loop``) on the CPU.

The kernels run only on the card (``tests/test_torch_kernels_gpu.py``).
Here: the plain walk against the JAX package's walk on the same
uniforms, ``rand`` given as a contiguous slice at any 4-byte offset (as
the staged kernel reads it); the staged walk's block size from the
source's constants; K13b's instance rule and the launcher's instances
in the source; and a numpy model of the on-chip scan's sum order (each
thread's rows, the warp's shuffle scan, the warps' totals, the
butterfly over lanes) held against the JAX package's loop of ``cumsum``
within 1e-5 of max |ref|.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu_torch.ops.kernels import (
    edge_scan_loop, edge_scan_loop_plain, random_walk)

_scan_mod = importlib.import_module(
    "pytorch_sparse_tpu_torch.ops.kernels.smem_gather")

CSRC = Path(pts.__file__).resolve().parent / "csrc"
WALK_SRC = (CSRC / "random_walk.cu").read_text()
SCAN_SRC = (CSRC / "smem_gather.cu").read_text()
GATE = 1e-5


def _constant(src, name):
    m = re.search(rf"constexpr (?:int|bool) {name} = ([^;]+);", src)
    assert m, name
    return eval(m.group(1).replace("true", "True").replace("false", "False"),
                {})


# ---- K12 ---------------------------------------------------------------------

def _walk_graph(M=400, seed=3):
    """A graph whose last fifth of nodes has no out-edges (sinks)."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, M - M // 5, 3000)
    col = rng.randint(0, M, 3000)
    key = np.unique(row * M + col)
    return M, key // M, key % M


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("L", [1, 3, 20, 33])
def test_random_walk_on_a_rand_slice_equals_jax(L, offset):
    """The wrapper on a ``rand`` that starts ``offset`` words into its
    buffer gives the JAX package's walks on the same uniforms."""
    M, row, col = _walk_graph()
    J = jts.SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                         sparse_sizes=(M, M))
    P = pts.SparseTensor(row=row, col=col, sparse_sizes=(M, M), device="cpu")
    start = np.random.RandomState(L).randint(0, M, 777).astype(np.int32)
    key = jax.random.PRNGKey(100 + L)
    want = np.asarray(jts.random_walk(J, jnp.asarray(start), L, key))
    uniforms = np.asarray(jax.random.uniform(key, (start.size, L)))
    flat = np.zeros(start.size * L + offset, np.float32)
    flat[offset:] = uniforms.ravel()
    rand = torch.from_numpy(flat)[offset:].view(start.size, L)
    assert rand.is_contiguous() and rand.storage_offset() == offset
    rowptr, c, _ = P.csr()
    got = random_walk(rowptr, c, torch.from_numpy(start), rand)
    np.testing.assert_array_equal(got.numpy(), want)
    sink = got[:, :-1] >= M - M // 5
    assert bool(sink.any())
    assert torch.equal(got[:, 1:][sink], got[:, :-1][sink])


def _staged_walks(L):
    """The staged kernel's walks a block (``staged_walks`` in
    ``csrc/random_walk.cu``), from the source's constants."""
    stage = eval(re.search(r"constexpr int kStageBytes = ([^;]+);",
                           WALK_SRC).group(1))
    threads = _constant(WALK_SRC, "kThreads")
    least = _constant(WALK_SRC, "kMinWalks")
    if L > stage:
        return 0
    w = min(stage // (4 * ((L | 1) + ((L + 1) | 1))), threads)
    w -= w % 32
    return 0 if w < least else w


@pytest.mark.parametrize("L,walks", [(0, 256), (1, 256), (3, 256), (20, 256),
                                     (23, 256), (24, 224), (33, 160),
                                     (80, 64), (191, 32), (192, 0),
                                     (10**6, 0)])
def test_staged_walks_a_block(L, walks):
    """A block stages 256 walks up to L = 23 (at L = 20: 43,008 bytes),
    fewer beyond, and none past L = 191, where the unstaged kernel
    runs."""
    nbytes = walks * 4 * ((L | 1) + ((L + 1) | 1))
    assert _staged_walks(L) == walks
    assert nbytes <= 48 * 1024
    if L == 20:
        assert nbytes == 43_008


def test_staged_walk_source_keeps_the_step_and_the_odd_strides():
    """The step is the JAX package's (one f32 product, truncated), the
    staged rows sit at odd word strides (conflict-free banks), and the
    entry keeps its signature."""
    assert "lo + (int)__fmul_rn(r, __int2float_rn(deg))" in WALK_SRC
    assert "const int Lr = odd(L), Lo = odd(L + 1);" in WALK_SRC
    assert "cur = step<PAIR>(rowptr, col, cur, rs[t * Lr + l]);\n" \
        "      os[t * Lo + l + 1] = cur;" in WALK_SRC
    assert "int random_walk_i32(int device, const void* rowptr" in WALK_SRC


# ---- K13b --------------------------------------------------------------------

SCAN_TS = [1, 8, 31, 255, 256, 2048, 2049, 4096, 4097, 9000, 32768, 32769,
           10**6]


@pytest.mark.parametrize("T", SCAN_TS)
def test_scan_instance_holds_every_row_in_one_block(T):
    """The on-chip scan up to one block of 512 threads of ``SCAN_ROWS``
    rows, the streaming kernel past it."""
    inst = _scan_mod.scan_instance(T, 128, True)
    assert inst.streaming == (T > 512 * _scan_mod.SCAN_ROWS)
    assert inst.vec == (1 if inst.streaming else 4)


@pytest.mark.parametrize("K,aligned,vec", [(128, True, 4), (4, True, 4),
                                           (128, False, 1), (130, True, 1),
                                           (3, True, 1), (1, True, 1)])
def test_scan_instance_slab_width(K, aligned, vec):
    assert _scan_mod.scan_instance(2048, K, aligned).vec == vec


def test_scan_launcher_has_every_instance_the_rule_takes():
    """The C launcher's rows a thread and most rows equal the Python
    rule's, and it has the streaming kernel and both slab widths."""
    rows = _constant(SCAN_SRC, "kScanRows")
    assert rows == _scan_mod.SCAN_ROWS
    assert rows * _constant(SCAN_SRC, "kScanMaxThreads") == \
        _scan_mod.SCAN_MAX_ROWS
    assert "T > kScanRows * kScanMaxThreads" in SCAN_SRC
    assert "edge_scan_kernel<<<" in SCAN_SRC
    assert "edge_scan_onchip_kernel<4><<<K / 4, threads" in SCAN_SRC
    assert "edge_scan_onchip_kernel<1><<<K, threads" in SCAN_SRC


def scan_model(h, R, rows):
    """The on-chip scan's float32 arithmetic, in its order: thread t
    holds rows t * rows + q; each pass scans each thread's rows,
    Hillis-Steele over the warp's lanes, takes the warp's exclusive
    prefix from lane - 1, sums the lanes' shares of the totals of the
    warps above with an xor butterfly, and adds ``base + v`` into the
    running sum."""
    T, K = h.shape
    f = np.float32
    threads = -(-(-(-T // rows)) // 32) * 32
    nw = threads // 32
    t = np.arange(threads)[:, None]
    q = np.arange(rows)[None, :]
    r = t * rows + q
    valid = r < T
    hv = np.where(valid[..., None], h[np.minimum(r, T - 1)], f(0))
    acc = np.zeros_like(hv)
    lane = np.arange(32)
    for i in range(R):
        x = np.where(valid[..., None], (hv + f(i)).astype(f), f(0))
        v = np.cumsum(x, axis=1, dtype=f)
        incl = v[:, -1, :].reshape(nw, 32, K)
        for d in (1, 2, 4, 8, 16):
            up = np.concatenate([incl[:, :d], incl[:, :-d]], axis=1)
            incl = np.where((lane >= d)[None, :, None],
                            (incl + up).astype(f), incl)
        base = np.concatenate([np.zeros_like(incl[:, :1]), incl[:, :-1]],
                              axis=1)
        tot = incl[:, 31, :]                              # (nw, K)
        part = np.zeros((nw, 32, K), f)
        for w in range(nw):
            for ln in range(min(w, 32)):
                part[w, ln] = tot[ln]
        for m in (16, 8, 4, 2, 1):
            part = (part + part[:, lane ^ m]).astype(f)
        base = (base + part).astype(f).reshape(threads, 1, K)
        acc = (acc + (base + v).astype(f)).astype(f)
    out = np.zeros((T, K), f)
    out[r[valid]] = acc[valid]
    return out


def _jax_scan_loop(h, R):
    """The JAX probe's kernel body, ``sum_{i<R} cumsum(h + i, axis=0)``
    (``benchmarks/probe_vmem_gather.py:107 _loop_time``, ``:136
    c_body``), outside Pallas."""
    hj = jnp.asarray(h)
    acc = jnp.zeros_like(hj)
    for i in range(R):
        acc = acc + jnp.cumsum(hj + i, axis=0)
    return np.asarray(acc)


@pytest.mark.parametrize("T,K,R", [
    (1, 3, 8), (8, 4, 3), (255, 3, 8), (2049, 4, 8), (2048, 4, 40),
    (1000, 3, 8), (1000, 4, 1), (1023, 3, 3), (4095, 2, 8), (4096, 3, 8)])
def test_scan_model_equals_jax(T, K, R):
    """The kernel's order of float32 sums is a scan: within 1e-5 of max
    |ref| of the JAX package's loop, and of the plain version."""
    h = np.random.RandomState(T + K + R).randn(T, K).astype(np.float32)
    got = scan_model(h, R, _scan_mod.SCAN_ROWS)
    want = _jax_scan_loop(h, R)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= GATE * scale
    plain = edge_scan_loop_plain(torch.from_numpy(h), R).numpy()
    assert np.abs(got - plain).max() <= GATE * scale


def test_edge_scan_loop_on_the_cpu_is_the_plain_version():
    h = torch.from_numpy(np.random.RandomState(5).randn(300, 7).astype(
        np.float32))
    before = edge_scan_loop.launches
    assert torch.equal(edge_scan_loop(h, 4), edge_scan_loop_plain(h, 4))
    assert edge_scan_loop.launches == before
