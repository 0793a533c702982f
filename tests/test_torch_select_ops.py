"""The port's selection and concatenation ops (``index_select``,
``index_select_nnz``, ``masked_select``, ``masked_select_nnz``,
``narrow``, ``__narrow_diag__``, ``select``, ``permute``, ``cat`` in
every form, ``reverse_cuthill_mckee``) against the JAX package on the
same seeded numpy inputs (CPU).  Structure, permutations and
``cached_keys()`` agree exactly, and so do the values (these ops only
gather); the value gradients (``jax.grad`` against ``torch.autograd``)
to 1e-6 of max |ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as T
import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts


def _idx(seed, n, k=12, unique=False):
    rng = np.random.RandomState(seed)
    return (rng.permutation(n)[:k] if unique else rng.randint(0, n, k))


@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("dt,width", [("f32", None), ("bf16", None),
                                      ("i32", None), ("f32", 3),
                                      (None, None)])
@pytest.mark.parametrize("dim", [0, 1])
def test_index_select_matches_jax(dim, dt, width, prefill):
    J, P = T.pair(11, dt=dt or "f32", has_value=dt is not None,
                  width=width, prefill=prefill)
    idx = _idx(12, J.sparse_size(dim))
    T.assert_same(J.index_select(dim, idx), P.index_select(dim, idx))
    T.assert_same(J.index_select(dim, idx),
                  P.index_select(dim, torch.from_numpy(idx)))


def test_index_select_dense_dim_and_nnz():
    J, P = T.pair(13, width=4)
    T.assert_same(J.index_select(2, [3, 0]), P.index_select(2, [3, 0]))
    T.assert_same(J.index_select(-1, [1]), P.index_select(-1, [1]))
    for layout in ("coo", "csc"):
        idx = _idx(14, J.nnz(), 20)
        # Kept in the order given (sorted or not), as in the JAX package.
        for a, b in zip(J.index_select_nnz(idx, layout).coo(),
                        P.index_select_nnz(idx, layout).coo()):
            T.assert_values(a, b)
    idx = np.sort(idx)  # CSR positions in order: a sorted result
    T.assert_same(J.index_select_nnz(idx, "coo"),
                  P.index_select_nnz(idx, "coo"))
    with pytest.raises(ValueError):
        T.pair(13, has_value=False)[1].index_select(2, [0])


@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("dt,width", [("f32", None), ("f16", None),
                                      ("f32", 2), (None, None)])
@pytest.mark.parametrize("dim", [0, 1])
def test_masked_select_matches_jax(dim, dt, width, prefill):
    J, P = T.pair(15, dt=dt or "f32", has_value=dt is not None,
                  width=width, prefill=prefill)
    mask = np.random.RandomState(16).rand(J.sparse_size(dim)) < 0.5
    T.assert_same(J.masked_select(dim, mask), P.masked_select(dim, mask))
    T.assert_same(J.masked_select(dim, mask),
                  P.masked_select(dim, torch.from_numpy(mask)))
    dense = P.to_dense().numpy()
    want = dense[mask] if dim == 0 else dense[:, mask]
    np.testing.assert_array_equal(
        P.masked_select(dim, mask).to_dense().numpy(), want)


def test_masked_select_nnz_dense_dim_and_empty():
    J, P = T.pair(17, width=3)
    mask = np.random.RandomState(18).rand(J.nnz()) < 0.6
    for layout in ("coo", "csc"):
        T.assert_same(J.masked_select_nnz(jnp.asarray(mask), layout),
                      P.masked_select_nnz(torch.from_numpy(mask), layout))
    T.assert_same(J.masked_select(2, [True, False, True]),
                  P.masked_select(2, [True, False, True]))
    out = P.masked_select(0, np.zeros(P.sparse_size(0), bool))
    assert out.nnz() == 0 and out.sparse_size(0) == 0


@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("dim,start,length", [(0, 3, 10), (0, -8, 5),
                                              (0, 0, 30), (1, 4, 9),
                                              (1, -5, 5), (0, 7, 0)])
def test_narrow_matches_jax(dim, start, length, prefill):
    J, P = T.pair(19, prefill=prefill)
    T.assert_same(J.narrow(dim, start, length), P.narrow(dim, start, length))
    # select is a narrow of length 1
    T.assert_same(J.select(dim, start), P.select(dim, start))


def test_narrow_keeps_rowcount_only_where_filled():
    J, P = T.pair(20)
    J.storage.rowcount()
    P.storage.rowcount()
    T.assert_same(J.narrow(0, 2, 9), P.narrow(0, 2, 9))
    Jw, Pw = T.pair(20, width=5)
    T.assert_same(Jw.narrow(2, 1, 3), Pw.narrow(-1, 1, 3))
    assert P.narrow(0, 2, 9).storage.cached_keys() == ["rowcount"]


@pytest.mark.parametrize("prefill", [False, True])
def test_cat_diag_and_narrow_diag_match_jax(prefill):
    blocks = [T.pair(21 + b, M=8 + b, N=6 + 2 * b, E=30, prefill=prefill)
              for b in range(3)]
    J = jts.cat([j for j, _ in blocks], dim=(0, 1))
    P = pts.cat([p for _, p in blocks], dim=(0, 1))
    T.assert_same(J, P)
    r = c = 0
    for (jb, pb) in blocks:
        M, N = pb.sparse_sizes()
        Jn = J.__narrow_diag__((r, c), (M, N))
        Pn = P.__narrow_diag__((r, c), (M, N))
        T.assert_same(Jn, Pn)
        assert Pn == pb
        r, c = r + M, c + N


@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("dim", [0, 1, -1, (0, 1)])
def test_cat_matches_jax(dim, prefill):
    pairs = [T.pair(31 + b, M=10 + b, N=7 + b, E=40, width=2,
                    prefill=prefill or b == 1) for b in range(3)]
    if dim == -1:  # a dense dim: one structure, other values
        J0, P0 = pairs[0]
        v = np.random.RandomState(34).randn(J0.nnz(), 3).astype(np.float32)
        pairs = [pairs[0], (J0.set_value(jnp.asarray(v), layout="coo"),
                            P0.set_value(torch.from_numpy(v), layout="coo"))]
    J = jts.cat([j for j, _ in pairs], dim=dim)
    P = pts.cat([p for _, p in pairs], dim=dim)
    T.assert_same(J, P)


def test_cat():
    """The JAX package's ``tests/test_cat.py``."""
    m1 = pts.SparseTensor(row=[0, 0, 1], col=[0, 1, 2], device="cpu")
    m1.fill_cache_()
    m2 = pts.SparseTensor(row=[0, 0, 1, 2], col=[0, 1, 1, 0], device="cpu")
    m2.fill_cache_()
    out = pts.cat([m1, m2], dim=0)
    assert out.to_dense().tolist() == [[1, 1, 0], [0, 0, 1], [1, 1, 0],
                                       [0, 1, 0], [1, 0, 0]]
    assert out.storage.has_row() and out.storage.has_rowptr()
    assert out.storage.has_rowcount()
    assert out.storage.num_cached_keys() == 1
    out = pts.cat([m1, m2], dim=1)
    assert out.to_dense().tolist() == [[1, 1, 0, 1, 1], [0, 0, 1, 0, 1],
                                       [0, 0, 0, 1, 0]]
    assert out.storage.has_row() and not out.storage.has_rowptr()
    assert out.storage.num_cached_keys() == 2
    out = pts.cat([m1, m2], dim=(0, 1))
    assert out.to_dense().tolist() == [[1, 1, 0, 0, 0], [0, 0, 1, 0, 0],
                                       [0, 0, 0, 1, 1], [0, 0, 0, 0, 1],
                                       [0, 0, 0, 1, 0]]
    assert out.storage.has_row() and out.storage.has_rowptr()
    assert out.storage.num_cached_keys() == 5
    m1 = m1.set_value(torch.randn(m1.nnz(), 4), layout="coo")
    out = pts.cat([m1, m1], dim=-1)
    assert out.storage.value().shape == (m1.nnz(), 8)
    assert out.storage.has_row() and out.storage.has_rowptr()
    assert out.storage.num_cached_keys() == 5
    with pytest.raises(IndexError):
        pts.cat([m1, m1], dim=3)


def test_narrow_blocks_cat_back_equal():
    """The chip phase's round trip at a small size: 4 row blocks by
    ``narrow``, ``cat`` back, ``==`` the original."""
    _, P = T.pair(41, M=37, N=29, E=300)
    cuts = np.linspace(0, 37, 5).astype(int)
    parts = [P.narrow(0, a, b - a) for a, b in zip(cuts[:-1], cuts[1:])]
    assert pts.cat(parts, dim=0) == P


def test_permute():
    """The JAX package's ``tests/test_permute.py``, then a random matrix
    against JAX."""
    adj = pts.SparseTensor(row=[0, 0, 1, 2, 2], col=[0, 1, 0, 1, 2],
                           value=torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]),
                           device="cpu")
    row, col, value = adj.permute(torch.tensor([1, 0, 2])).coo()
    assert row.tolist() == [0, 1, 1, 2, 2]
    assert col.tolist() == [1, 0, 1, 0, 2]
    assert value.tolist() == [3, 2, 1, 4, 5]
    J, P = T.pair(42, M=25, N=25, E=120)
    perm = np.random.RandomState(43).permutation(25)
    T.assert_same(J.permute(perm), P.permute(perm))
    with pytest.raises(ValueError):
        T.pair(42)[1].permute(perm)


@pytest.mark.parametrize("symmetric", [True, False])
def test_reverse_cuthill_mckee_matches_jax(symmetric):
    J, P = T.pair(44, M=40, N=40, E=160)
    if symmetric:
        J, P = J.to_symmetric(), P.to_symmetric()
    Jo, jperm = J.reverse_cuthill_mckee()
    Po, pperm = P.reverse_cuthill_mckee()
    np.testing.assert_array_equal(pperm.numpy(), np.asarray(jperm))
    assert pperm.dtype == torch.int32
    T.assert_same(Jo, Po, exact=symmetric)
    assert Po.bandwidth() <= P.to_symmetric().bandwidth()


def _weights(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("op", ["index_select0", "index_select1",
                                "masked_select0", "masked_select1",
                                "narrow0", "narrow1", "getitem"])
def test_value_gradients_match_jax(op):
    """``d sum(w * out.value) / d value`` through each op, ``jax.grad``
    against ``torch.autograd``, to 1e-6 of max |ref|."""
    J, P = T.pair(45, width=2)
    idx = _idx(46, 20)
    mask = np.random.RandomState(47).rand(30) < 0.5
    fns = {"index_select0": lambda A: A.index_select(0, idx),
           "index_select1": lambda A: A.index_select(1, idx),
           "masked_select0": lambda A: A.masked_select(0, mask),
           "masked_select1": lambda A: A.masked_select(1, mask[:20]),
           "narrow0": lambda A: A.narrow(0, 4, 17),
           "narrow1": lambda A: A.narrow(1, 3, 11),
           "getitem": lambda A: A[idx[:6], mask[:20]]}
    fn = fns[op]
    v = T.np_(P.storage.value())
    w = _weights(48, (fn(P).nnz(), 2))

    def jloss(jv):
        return jnp.sum(fn(J.set_value(jv, layout="coo")).storage.value()
                       * jnp.asarray(w))

    jg = jax.grad(jloss)(jnp.asarray(v))
    pv = torch.from_numpy(v).requires_grad_(True)
    out = fn(P.set_value(pv, layout="coo")).storage.value()
    (out * torch.from_numpy(w)).sum().backward()
    T.assert_values(jg, pv.grad, exact=False)
