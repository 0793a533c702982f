"""Shared helpers of the CPU parity tests of the port's tensor API and
structural ops: the same seeded numpy inputs built as a JAX-package
``SparseTensor`` and as the port's (on the CPU), and comparisons of
their structure, caches and values."""

import jax.numpy as jnp
import numpy as np
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts

VIEWS = ["row", "rowptr", "col"]
CACHES = ["rowcount", "colptr", "colcount", "csr2csc", "csc2csr"]
JDT = {"f32": jnp.float32, "f16": jnp.float16, "bf16": jnp.bfloat16,
       "i32": jnp.int32}
PDT = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16,
       "i32": torch.int32}
# Values that no sum touches must agree exactly; gradients and sums to
# this bound, relative to max |ref| (float32).
REL = 1e-6


def np_(x):
    """Host float/int numpy copy of a JAX array or torch tensor (bf16
    widened to f32)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def values(rng, n, dt="f32", width=None):
    shape = (n,) if width is None else (n, width)
    v = rng.randint(-4, 5, shape) if dt == "i32" else rng.randn(*shape)
    return v.astype(np.float32)


def jval(v, dt="f32"):
    return None if v is None else jnp.asarray(v).astype(JDT[dt])


def pval(v, dt="f32"):
    return None if v is None else torch.from_numpy(v).to(PDT[dt])


def pair(seed, M=30, N=20, E=150, dt="f32", has_value=True, width=None,
         coalesced=True, prefill=False, unique=True):
    """A random ``(M, N)`` matrix of ``E`` draws in both packages: at
    ``E`` distinct positions (in random order) when ``unique``, so that
    no sum touches the values, else with duplicates."""
    rng = np.random.RandomState(seed)
    if unique:
        pos = rng.choice(M * N, E, replace=False)
        row, col = pos // N, pos % N
    else:
        row, col = rng.randint(0, M, E), rng.randint(0, N, E)
    v = values(rng, E, dt, width) if has_value else None
    J = jts.SparseTensor(row=row, col=col, value=jval(v, dt),
                         sparse_sizes=(M, N))
    P = pts.SparseTensor(row=row, col=col, value=pval(v, dt),
                         sparse_sizes=(M, N), device="cpu")
    if coalesced:
        J, P = J.coalesce("add"), P.coalesce("add")
    if prefill:
        J.fill_cache_()
        P.fill_cache_()
    return J, P


def assert_keys(J, P):
    assert P.storage.cached_keys() == J.storage.cached_keys()


def assert_same(J, P, caches=True, exact=True, rel=REL):
    """Same sizes, views, cached keys and (with ``caches``) caches; the
    values equal, or within ``rel`` of max |ref| unless ``exact``.
    Filling the views after the cache keys are compared."""
    assert J.sparse_sizes() == P.sparse_sizes()
    assert_keys(J, P)
    for name in VIEWS + (CACHES if caches else []):
        np.testing.assert_array_equal(np_(getattr(J.storage, name)()),
                                      np_(getattr(P.storage, name)()),
                                      err_msg=name)
    assert_values(J.storage.value(), P.storage.value(), exact, rel)


def assert_values(jv, pv, exact=True, rel=REL):
    if jv is None:
        assert pv is None
        return
    jv, pv = np_(jv), np_(pv)
    assert jv.shape == pv.shape
    if exact:
        np.testing.assert_array_equal(pv, jv)
    else:
        scale = max(float(np.abs(jv).max(initial=0)), 1e-30)
        assert float(np.abs(pv.astype(np.float64) - jv).max(initial=0)) \
            <= rel * scale
